"""The port's WaveNet autoencoder (music_tpu_torch.models.wavenet_ae) held
against music_tpu.models.wavenet_ae on the same weights: encoder, decoder,
forward, loss and the plain step decoder."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_tpu.models import wavenet_ae as jae
from music_tpu_torch.models import wavenet_ae as tae
from music_tpu_torch.utils.parity import tie_aware_check
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

TINY_JSON = dict(
    filter_width=2, dilations=[1, 2, 4, 8, 1, 2, 4, 8], en_residual_channel=8,
    en_dilation_channel=8, de_residual_channel=8, de_dilation_channel=8, de_skip_channel=16,
    en_bottleneck_width=12, en_pool_kernel_size=16, quantization_channel=32, use_bias=False,
)
JTINY = jae.WaveNetAEConfig.from_json(TINY_JSON)
TTINY = tae.WaveNetAEConfig.from_json(TINY_JSON)
# float32 on both sides; sums in another order (XLA vs torch), so logits
# agree to a few ulps of their O(0.1-1) size
TOL = 1e-5


def _params(seed):
    jp = jae.init_params(jax.random.PRNGKey(seed), JTINY)
    return jp, tae.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, cfg=TTINY)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 32, shape).astype(np.int32)


def test_config_from_json_and_receptive_field():
    assert TTINY == tae.WaveNetAEConfig(**{**TINY_JSON, "dilations": tuple(TINY_JSON["dilations"])})
    assert TTINY.receptive_field == JTINY.receptive_field == 32
    assert TTINY.n_blocks == 8
    assert tae.WaveNetAEConfig() == tae.WaveNetAEConfig.from_json(
        {f: getattr(jae.WaveNetAEConfig(), f) for f in TINY_JSON})


def test_init_params_shapes_and_bounds():
    jp = jae.init_params(jax.random.PRNGKey(0), JTINY)
    tp = tae.init_params(TTINY, torch.Generator().manual_seed(0))
    assert set(tp) == set(jp)
    fan_in = tae._fan_in(TTINY)
    for k, v in tp.items():
        assert tuple(v.shape) == tuple(jp[k].shape), k
        assert float(v.abs().max()) <= 1.0 / np.sqrt(fan_in[k]) + 1e-7, k
        # uniform on the same interval: the largest draw is near the bound
        assert float(v.abs().max()) > 0.5 / np.sqrt(fan_in[k]), k
    back = tae.params_to_numpy(tae.params_from_numpy(tae.params_to_numpy(tp)))
    for k, v in tp.items():
        np.testing.assert_array_equal(back[k], v.numpy())


def test_params_from_numpy_checks_shapes():
    jp, _ = _params(0)
    arrays = {k: np.asarray(v) for k, v in jp.items()}
    with pytest.raises(KeyError, match="cond_post"):
        tae.params_from_numpy({k: v for k, v in arrays.items() if k != "cond_post"}, cfg=TTINY)
    with pytest.raises(ValueError, match="conn1"):
        tae.params_from_numpy({**arrays, "conn1": np.zeros((3, 3), np.float32)}, cfg=TTINY)


@pytest.mark.parametrize("T", [300, 257])
def test_encode_matches_jax(T):
    """AvgPool drops the tail: 300 - 31 = 269 -> 16 frames, 257 - 31 -> 14."""
    jp, tp = _params(1)
    toks = _tokens(T, (2, T))
    ref = np.asarray(jae.encode(jp, jnp.asarray(toks), JTINY))
    ours = tae.encode(tp, torch.from_numpy(toks), TTINY).numpy()
    assert ours.shape == ref.shape == (2, (T - 31) // 16, 12)
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def test_forward_and_decode_match_jax():
    jp, tp = _params(2)
    toks = _tokens(2, (2, 200))
    ref = np.asarray(jae.forward(jp, jnp.asarray(toks), JTINY))
    ours = tae.forward(tp, torch.from_numpy(toks), TTINY).numpy()
    assert ours.shape == ref.shape == (2, 200 - 32 + 1, 32)
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
    # decode on its own, with an encoding whose frame count does not divide
    # the length (the ratio-based upsample)
    enc = np.random.default_rng(3).normal(size=(2, 7, 12)).astype(np.float32) * 0.3
    ref = np.asarray(jae.decode(jp, jnp.asarray(toks), jnp.asarray(enc), JTINY, 50))
    ours = tae.decode(tp, torch.from_numpy(toks), torch.from_numpy(enc), TTINY, 50).numpy()
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def test_forward_too_short_raises():
    _, tp = _params(0)
    with pytest.raises(ValueError, match="receptive field"):
        tae.forward(tp, torch.zeros((1, 31), dtype=torch.int32), TTINY)


def test_loss_matches_jax():
    jp, tp = _params(4)
    toks = _tokens(4, (3, 150))
    ref = float(jae.loss_fn(jp, jnp.asarray(toks), JTINY))
    ours = float(tae.loss_fn(tp, torch.from_numpy(toks), TTINY))
    assert abs(ours - ref) < TOL * max(1.0, abs(ref))


def test_gate_split_is_swapped():
    """tanh of the second half times sigmoid of the first, unlike WaveNet."""
    fg = torch.tensor([[2.0, -1.0, 0.5, 3.0]])
    np.testing.assert_allclose(
        tae.gate(fg, 2).numpy(),
        (torch.tanh(fg[:, 2:]) * torch.sigmoid(fg[:, :2])).numpy())
    assert not torch.allclose(tae.gate(fg, 2), torch.tanh(fg[:, :2]) * torch.sigmoid(fg[:, 2:]))


def test_decode_step_matches_jax():
    """One step of the plain step decoder from a filled cache: the same
    logits and ring."""
    jp, tp = _params(5)
    rng = np.random.default_rng(5)
    B = 3
    ring = rng.normal(size=(8, 8, B, 8)).astype(np.float32)
    tok, prev = rng.integers(0, 32, B).astype(np.int32), rng.integers(0, 32, B).astype(np.int32)
    cfg_t = rng.normal(size=(B, 8, 16)).astype(np.float32) * 0.1
    cpost = rng.normal(size=(B, 16)).astype(np.float32) * 0.1
    jcache = {"ring": jnp.asarray(ring), "prev_token": jnp.asarray(prev), "t": jnp.int32(13)}
    jc, jl = jae.decode_step(jp, jcache, jnp.asarray(tok), jnp.asarray(cfg_t),
                             jnp.asarray(cpost), JTINY)
    tcache = {"ring": torch.from_numpy(ring.copy()), "prev_token": torch.from_numpy(prev).long(),
              "t": 13}
    tc, tl = tae.decode_step(tp, tcache, torch.from_numpy(tok), torch.from_numpy(cfg_t),
                             torch.from_numpy(cpost), TTINY)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tc["ring"].numpy(), np.asarray(jc["ring"]), rtol=TOL, atol=TOL)
    assert tc["t"] == 14


def test_generate_tokens_matches_jax_scan():
    """The plain step decoder against JAX generate_tokens (argmax): tokens
    tie-aware at 1e-5 on the JAX step decoder's teacher-forced logits;
    exact equality is printed."""
    jp, tp = _params(6)
    rng = np.random.default_rng(6)
    B, P, n, F = 2, 40, 90, 9
    prime = rng.integers(0, 32, (B, P)).astype(np.int32)
    enc = (rng.normal(size=(B, F, 12)) * 0.3).astype(np.float32)
    ref = np.asarray(jae.generate_tokens(jp, jnp.asarray(enc), jnp.asarray(prime),
                                         jax.random.PRNGKey(0), cfg=JTINY, n_steps=n))
    ours = tae.generate_tokens(tp, torch.from_numpy(enc), torch.from_numpy(prime),
                               cfg=TTINY, n_steps=n).numpy()
    assert ours.shape == (B, n) and ours.dtype == np.int32
    step = jax.jit(functools.partial(jae.decode_step, cfg=JTINY))
    cond_fg = np.einsum("bfw,lwc->bflc", enc, np.asarray(jp["cond_fg"]))
    cond_post = np.einsum("bfw,wc->bfc", enc, np.asarray(jp["cond_post"]))

    def logits_fn(tokens):
        seq = np.concatenate([prime, np.asarray(tokens)[:, :-1]], axis=1)
        cache, out = jae.init_cache(JTINY, B), []
        for i in range(seq.shape[1]):
            f = min(i // 16, F - 1)
            cache, logits = step(jp, cache, jnp.asarray(seq[:, i]), jnp.asarray(cond_fg[:, f]),
                                 jnp.asarray(cond_post[:, f]))
            if i >= P - 1:
                out.append(np.asarray(logits))
        return np.stack(out, axis=1)

    report = tie_aware_check(ours, logits_fn, TOL)
    assert report["ok"], report
    print("exact equality with JAX generate_tokens:", float((ours == ref).mean()), report)


def test_generate_tokens_categorical_reproducible():
    _, tp = _params(7)
    rng = np.random.default_rng(7)
    prime = torch.from_numpy(rng.integers(0, 32, (2, 35)).astype(np.int32))
    enc = torch.from_numpy((rng.normal(size=(2, 5, 12)) * 0.3).astype(np.float32))
    kw = dict(cfg=TTINY, n_steps=30, sample_mode="categorical", temperature=0.8)
    a = tae.generate_tokens(tp, enc, prime, torch.Generator().manual_seed(1), **kw)
    b = tae.generate_tokens(tp, enc, prime, torch.Generator().manual_seed(1), **kw)
    c = tae.generate_tokens(tp, enc, prime, torch.Generator().manual_seed(2), **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 32
    with pytest.raises(ValueError, match="sample_mode"):
        tae.generate_tokens(tp, enc, prime, cfg=TTINY, n_steps=3, sample_mode="top_k")
