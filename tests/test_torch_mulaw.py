"""The port's µ-law codec (music_tpu_torch.ops.mulaw) held against
music_tpu.ops.mulaw.mu_law_encode / mu_law_decode."""

import numpy as np
import jax.numpy as jnp
import torch

from music_tpu.ops import mulaw as jmulaw
from music_tpu_torch.ops import mulaw as tmulaw


def test_encode_bit_equal_dense_sweep():
    # tolerance: none — both encode in float32 with the same op order and
    # truncate, so every code must be identical
    audio = np.linspace(-1.2, 1.2, 100_001, dtype=np.float32)
    ref = np.asarray(jmulaw.mu_law_encode(jnp.asarray(audio)))
    ours = tmulaw.mu_law_encode(torch.from_numpy(audio)).numpy()
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)


def test_decode_bit_equal_all_256_codes():
    # tolerance: none — both gather from the committed Q=256 table
    codes = np.arange(256, dtype=np.int32)
    ref = np.asarray(jmulaw.mu_law_decode(jnp.asarray(codes)))
    ours = tmulaw.mu_law_decode(torch.from_numpy(codes)).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_decode_other_q_analytic():
    # tolerance 2 ulp-scale (rtol 1e-6): the analytic formula goes through
    # pow, whose last bit differs between XLA and torch
    codes = np.arange(64, dtype=np.int32)
    ref = np.asarray(jmulaw.mu_law_decode(jnp.asarray(codes), 64))
    ours = tmulaw.mu_law_decode(torch.from_numpy(codes), 64).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


def test_roundtrip_error_bounded():
    # tolerance: the 256-level quantization step near full scale (as the
    # JAX package's own round-trip test)
    audio = np.random.default_rng(0).uniform(-1, 1, 10_000).astype(np.float32)
    rec = tmulaw.mu_law_decode(tmulaw.mu_law_encode(torch.from_numpy(audio))).numpy()
    assert np.max(np.abs(rec - audio)) < 0.06
    assert np.mean(np.abs(rec - audio)) < 0.01
