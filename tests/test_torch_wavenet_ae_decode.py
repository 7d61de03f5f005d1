"""The port's conditioned fused decode (music_tpu_torch.kernels.
wavenet_ae_decode) held against music_tpu.kernels.wavenet_ae_decode:
its _collect_prime_state, and generate_tokens_fused with the Pallas kernel
in interpret mode on the CPU.  On the CPU the wrapper runs the kernel's
plain version, decode_reference; the CUDA kernel itself is checked against
it on the card by chip_smoke.py."""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_tpu.kernels import wavenet_ae_decode as jk
from music_tpu.models import wavenet_ae as jae
from music_tpu_torch.kernels import wavenet_ae_decode as tk
from music_tpu_torch.models import wavenet_ae as tae
from music_tpu_torch.utils.parity import (
    ae_reference_scores, ae_teacher_forced_scores, tie_aware_check,
)
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

TINY_JSON = dict(
    filter_width=2, dilations=[1, 2, 4, 8, 1, 2, 4, 8], en_residual_channel=8,
    en_dilation_channel=8, de_residual_channel=8, de_dilation_channel=8, de_skip_channel=16,
    en_bottleneck_width=12, en_pool_kernel_size=16, quantization_channel=32, use_bias=False,
)
JTINY = jae.WaveNetAEConfig.from_json(TINY_JSON)
TTINY = tae.WaveNetAEConfig.from_json(TINY_JSON)
PRIME_LEN = TTINY.receptive_field + max(TTINY.dilations)  # 40
POOL = TTINY.en_pool_kernel_size
# float32 on both sides, sums in another order: logits of O(0.1-1) agree
# to a few ulps
TOL = 1e-5


def _params(seed):
    jp = jae.init_params(jax.random.PRNGKey(seed), JTINY)
    return jp, tae.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, cfg=TTINY)


def _inputs(seed, rows, n_frames, prime_len=PRIME_LEN):
    """Seeded primes ``[rows, prime_len]``, encodings ``[rows, F, W]`` and
    per-stream clocks ``[rows]`` (streams cross frame boundaries at
    different steps)."""
    rng = np.random.default_rng(seed)
    prime = rng.integers(0, 32, (rows, prime_len)).astype(np.int32)
    enc = (rng.normal(size=(rows, n_frames, 12)) * 0.3).astype(np.float32)
    pos = rng.integers(0, 40, rows).astype(np.int32)
    pos[0] = 0
    return prime, enc, pos


def _jax_step_scores(jp, enc, prime, pos):
    """Teacher-forced scores of the JAX plain step decoder
    (music_tpu.models.wavenet_ae.decode_step), each stream conditioned on
    its own clock: the token at time ``pos + i`` takes frame ``min((pos +
    i) // pool, F - 1)``."""
    step = jax.jit(functools.partial(jae.decode_step, cfg=JTINY))
    B, F, P = enc.shape[0], enc.shape[1], prime.shape[1]
    cond_fg = np.einsum("bfw,lwc->bflc", enc, np.asarray(jp["cond_fg"]))
    cond_post = np.einsum("bfw,wc->bfc", enc, np.asarray(jp["cond_post"]))
    rows = np.arange(B)

    def logits_fn(tokens):
        seq = np.concatenate([prime, np.asarray(tokens)[:, :-1]], axis=1)
        cache, out = jae.init_cache(JTINY, B), []
        for i in range(seq.shape[1]):
            f = np.minimum((pos + i) // POOL, F - 1)
            cache, logits = step(jp, cache, jnp.asarray(seq[:, i]),
                                 jnp.asarray(cond_fg[rows, f]), jnp.asarray(cond_post[rows, f]))
            if i >= P - 1:
                out.append(np.asarray(logits))
        return np.stack(out, axis=1)

    return logits_fn


def test_prime_state_matches_jax():
    """Rings and s0 of the conditioned prime with per-stream clocks and
    frames that clamp (F=4 ends at time 64 < 49 + 40): rings to 1e-5 (the
    same float32 convs, sums in another order), s0 and prev0 exactly."""
    jp, tp = _params(1)
    prime, enc, pos = _inputs(1, 5, 4, PRIME_LEN + 9)
    prime_state = jax.jit(functools.partial(jk._collect_prime_state, cfg=JTINY))
    init, _, _, js0 = prime_state(jp, jnp.asarray(prime), jnp.asarray(enc),
                                  pos_offset=jnp.asarray(pos))
    ring, s0, prev0 = tk._collect_prime_state(tp, torch.from_numpy(prime), torch.from_numpy(enc),
                                              TTINY, torch.from_numpy(pos).long())
    groups, lane_of_layer = jk._grouping(JTINY)
    offs, ring_len = tk.ring_offsets(TTINY)
    assert tuple(ring.shape) == (5, ring_len, 8)
    init = np.asarray(init)  # [tiles, S, 128]: group tiles, layers side by side in lanes
    base = 0
    for d, layers in groups:
        for i in layers:
            lane = lane_of_layer[i]
            want = np.swapaxes(init[base : base + d, :, lane : lane + 8], 0, 1)
            np.testing.assert_allclose(ring[:, offs[i] : offs[i] + d].numpy(), want,
                                       rtol=TOL, atol=1e-6)
        base += d
    np.testing.assert_array_equal(s0.numpy(), np.asarray(js0))
    np.testing.assert_array_equal(prev0.numpy(), prime[:, -1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cond_tables_match_jax(dtype):
    """The kernel's tables: the JAX wrapper's einsums in float32 (to 1e-6),
    then cast to the working dtype."""
    jp, tp = _params(2)
    _, enc, _ = _inputs(2, 3, 7)
    cond_fg, cond_post = tk.build_cond_tables(tp, torch.from_numpy(enc), TTINY, dtype)
    want_fg = np.einsum("bfw,lwc->bflc", enc, np.asarray(jp["cond_fg"])).reshape(3, 7, -1)
    want_post = np.einsum("bfw,wc->bfc", enc, np.asarray(jp["cond_post"]))
    assert cond_fg.dtype == cond_post.dtype == dtype
    assert tuple(cond_fg.shape) == (3, 7, 8 * 16) and tuple(cond_post.shape) == (3, 7, 16)
    for ours, want in ((cond_fg, want_fg), (cond_post, want_post)):
        want = torch.from_numpy(want).to(dtype).float().numpy()
        np.testing.assert_allclose(ours.float().numpy(), want, rtol=1e-6, atol=1e-6)


FUSED_CASES = [  # (label, rows, streams per block, groups, dtype)
    ("f32 2 streams", 2, 8, 1, torch.float32),
    ("f32 11 streams over 2 groups", 11, 8, 2, torch.float32),
    ("bf16 16 streams", 16, 16, 1, torch.bfloat16),
]


@pytest.mark.parametrize("label,rows,S,G,dtype", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_fused_vs_jax_interpret(label, rows, S, G, dtype):
    """generate_tokens_fused on the CPU against the Pallas kernel in
    interpret mode, 100 steps with per-stream clocks and frames that clamp
    (F=8 ends at time 128).  float32: the port's tokens tie-aware at 1e-5
    on the JAX step decoder's teacher-forced scores.  bfloat16: the same
    first token, and the Pallas kernel's tokens tie-aware at 1e-5 on the
    port's bf16 plain version teacher-forced (the same rounding points).
    Exact equality with the Pallas kernel is printed."""
    n_steps = 100
    jp, tp = _params(rows)
    prime, enc, pos = _inputs(rows, rows, 8)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(jk.generate_tokens_fused(
        jp, jnp.asarray(enc), jnp.asarray(prime), cfg=JTINY, n_steps=n_steps, interpret=True,
        dtype=jdtype, pos_offset=jnp.asarray(pos), n_stream_groups=G, n_streams=S))
    kw = dict(cfg=TTINY, n_streams=S, n_stream_groups=G, dtype=dtype,
              pos_offset=torch.from_numpy(pos))
    ours = tk.generate_tokens_fused(tp, torch.from_numpy(enc), torch.from_numpy(prime),
                                    n_steps=n_steps, **kw).numpy()
    assert ours.shape == ref.shape == (rows, n_steps) and ours.dtype == np.int32
    if dtype == torch.float32:
        report = tie_aware_check(ours, _jax_step_scores(jp, enc, prime, pos), TOL)
    else:
        np.testing.assert_array_equal(ours[:, 0], ref[:, 0])
        inputs = tk.prepare(tp, torch.from_numpy(enc), torch.from_numpy(prime), **kw)
        report = tie_aware_check(ref[:, 1:], lambda t: ae_reference_scores(
            inputs, torch.tensor(ref), TTINY, dtype=dtype), TOL)
    assert report["ok"], report
    print(f"{label}: exact token equality with the Pallas kernel "
          f"{float((ours == ref).mean()):.4f}", report)


def test_reference_forced_matches_teacher_forced_scores():
    """decode_reference teacher-forced (``forced=``) in float32 gives the
    logits of the parallel absolute-time forward
    (utils.parity.ae_teacher_forced_scores) to 1e-5, which gives the JAX
    step decoder's to 1e-5; its own tokens score exactly, and tokens it
    would not draw are caught."""
    jp, tp = _params(3)
    prime, enc, pos = _inputs(3, 5, 6)
    pos_t = torch.from_numpy(pos)
    inputs = tk.prepare(tp, torch.from_numpy(enc), torch.from_numpy(prime), cfg=TTINY,
                        n_streams=5, pos_offset=pos_t)
    toks = tk.decode_reference(*inputs, cfg=TTINY, n_steps=60)
    scores = ae_reference_scores(inputs, toks, TTINY, dtype=torch.float32)
    tf = ae_teacher_forced_scores(tp, torch.from_numpy(enc), torch.from_numpy(prime), toks,
                                  TTINY, pos_offset=pos_t)
    assert tuple(scores.shape) == (5, 59, 32) and tuple(tf.shape) == (5, 60, 32)
    np.testing.assert_allclose(scores.numpy(), tf[:, 1:].numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tf.numpy(), _jax_step_scores(jp, enc, prime, pos)(toks.numpy()),
                               rtol=TOL, atol=TOL)
    report = tie_aware_check(toks[:, 1:], lambda t: scores, tol=0.0)
    assert report["ok"] and report["exact"] == report["n"], report
    worst = scores.argmin(dim=-1).to(torch.int32)
    assert not tie_aware_check(worst, lambda t: scores, tol=1e-3)["ok"]


@pytest.mark.parametrize("seed", range(5))
def test_bf16_plain_vs_f32_model(seed):
    """bf16 decode_reference against the f32 model, teacher-forced along
    the bf16 tokens.  Its logit error was measured at 1.34e-3 to 1.85e-3
    over these five seeds (the conditioning tables are bf16 too; printed
    with ``-s``) and 1.49e-3 on the card (chip_smoke.py phase 6); it must
    stay under 4e-3, half chip_smoke.py's TOL_AE_BF16."""
    _, tp = _params(10 + seed)
    prime, enc, pos = _inputs(10 + seed, 16, 12)
    prime, enc, pos = (torch.from_numpy(a) for a in (prime, enc, pos))
    inputs = tk.prepare(tp, enc, prime, cfg=TTINY, n_streams=16, dtype=torch.bfloat16,
                        pos_offset=pos)
    toks = tk.decode_reference(*inputs, cfg=TTINY, n_steps=150, dtype=torch.bfloat16)
    plain = ae_reference_scores(inputs, toks, TTINY, dtype=torch.bfloat16)
    f32 = ae_teacher_forced_scores(tp, enc, prime, toks, TTINY, pos_offset=pos)[:, 1:]
    err = float((plain - f32).abs().max())
    print(f"seed {seed}: bf16 plain vs f32 model, max logit error {err:.3g}")
    assert err < 4e-3, err
    report = tie_aware_check(toks, lambda t: ae_teacher_forced_scores(
        tp, enc, prime, t, TTINY, pos_offset=pos), tol=2 * err)
    assert report["ok"], report


def test_rows_pad_with_the_last_row():
    """3 rows in one block of 4: the padding row copies the last row's
    prime, encoding and clock, and each row decodes as it does alone."""
    _, tp = _params(4)
    prime, enc, pos = (torch.from_numpy(a) for a in _inputs(4, 3, 6))
    kw = dict(cfg=TTINY, n_steps=40)
    w, ring, s0, prev0, cond_fg, cond_post, pos0 = tk.prepare(
        tp, enc, prime, cfg=TTINY, n_streams=4, pos_offset=pos)
    assert ring.shape[0] == s0.shape[0] == cond_fg.shape[0] == pos0.shape[0] == 4
    assert torch.equal(ring[3], ring[2]) and torch.equal(cond_post[3], cond_post[2])
    assert pos0.tolist() == (pos + PRIME_LEN).tolist() + [int(pos[2]) + PRIME_LEN]
    together = tk.generate_tokens_fused(tp, enc, prime, n_streams=4, pos_offset=pos, **kw)
    for i in range(3):
        alone = tk.generate_tokens_fused(tp, enc[i : i + 1], prime[i : i + 1], n_streams=1,
                                         pos_offset=int(pos[i]), **kw)
        assert torch.equal(together[i], alone[0]), i


def test_cpu_wrapper_launches_no_kernel():
    _, tp = _params(5)
    prime, enc, _ = (torch.from_numpy(a) for a in _inputs(5, 2, 6))
    before = tk.LAUNCHES
    out = tk.generate_tokens_fused(tp, enc, prime, cfg=TTINY, n_steps=5, n_streams=2)
    assert out.shape == (2, 5) and out.dtype == torch.int32
    assert tk.LAUNCHES == before
    # the CUDA wrapper refuses CPU tensors before building anything
    inputs = tk.prepare(tp, enc, prime, cfg=TTINY, n_streams=1, n_stream_groups=2)
    with pytest.raises(ValueError, match="CUDA"):
        tk.decode_cuda(*inputs, cfg=TTINY, n_steps=5, n_streams=1)
    with pytest.raises(ValueError, match="n_streams"):
        tk.decode_cuda(*inputs, cfg=TTINY, n_steps=5, n_streams=3)
    assert tk.LAUNCHES == before
    with pytest.raises(ValueError, match="device"):
        tk.generate_tokens_fused(tp, enc.to("meta"), prime.to("meta"), cfg=TTINY, n_steps=5,
                                 n_streams=2)


def test_unsupported_inputs_raise():
    _, tp = _params(6)
    prime, enc, _ = (torch.from_numpy(a) for a in _inputs(6, 2, 6, PRIME_LEN - 1))
    with pytest.raises(ValueError, match="prime length"):
        tk.generate_tokens_fused(tp, enc, prime, cfg=TTINY, n_steps=5, n_streams=2)
    prime, enc, _ = (torch.from_numpy(a) for a in _inputs(6, 3, 6))
    with pytest.raises(ValueError, match="at most 2 streams"):
        tk.generate_tokens_fused(tp, enc, prime, cfg=TTINY, n_steps=5, n_streams=2)
    with pytest.raises(ValueError, match="encoding has 2 rows"):
        tk.generate_tokens_fused(tp, enc[:2], prime, cfg=TTINY, n_steps=5, n_streams=4)
    wide = tae.WaveNetAEConfig(**{**TINY_JSON, "dilations": tuple(TINY_JSON["dilations"]),
                                  "filter_width": 3})
    with pytest.raises(NotImplementedError, match="filter_width"):
        tk.generate_tokens_fused(tp, enc, prime, cfg=wide, n_steps=5, n_streams=4)


def _ae_cfg(**widths):
    from music_tpu_torch.core.config import load_params_dir

    params_dir = Path(tk.__file__).parents[1] / "params" / "wavenet_autoencoder"
    shipped = tae.WaveNetAEConfig.from_json(load_params_dir(params_dir)["model_params"])
    return dataclasses.replace(shipped, **widths)


@pytest.mark.parametrize("widths,dtype,want", [
    ({}, torch.float32, 16), ({}, torch.bfloat16, 16),
    (None, torch.float32, 16), (None, torch.bfloat16, 16),
    ({"de_residual_channel": 64, "de_dilation_channel": 64, "de_skip_channel": 1024},
     torch.float32, 2),
    ({"de_residual_channel": 64, "de_dilation_channel": 64, "de_skip_channel": 1024},
     torch.bfloat16, 4),
    ({"de_skip_channel": 1024}, torch.float32, 8),
], ids=["shipped-f32", "shipped-bf16", "tiny-f32", "tiny-bf16", "scaled-f32", "scaled-bf16",
        "skip1024-f32"])
def test_max_streams(widths, dtype, want):
    """The most streams a block whose carve (conditioning rows in the
    stages) fits, and that the next tile up does not."""
    from music_tpu_torch.kernels import wavenet_decode as tdec

    cfg = TTINY if widths is None else _ae_cfg(**widths)
    dims = (cfg.n_blocks, cfg.de_residual_channel, cfg.de_dilation_channel,
            cfg.de_skip_channel, cfg.quantization_channel)
    assert tk.max_streams(cfg, dtype) == want
    assert tdec.smem_layout(*dims, want, dtype, ae=True)[1] <= tk.SMEM_LIMIT
    if want < tk.SUPPORTED_STREAMS[-1]:
        assert tdec.smem_layout(*dims, 2 * want, dtype, ae=True)[1] > tk.SMEM_LIMIT
    # the conditioning rows make the AE's stages larger than WaveNet's
    assert (tdec.smem_layout(*dims, want, dtype, ae=True)[0][5]
            > tdec.smem_layout(*dims, want, dtype)[0][5])


def test_generate_tiles_by_max_streams_and_oversized_tile_raises(monkeypatch):
    """The reconstruct path hands stream_tiling B3's max_streams for its
    config and dtype; decode_cuda refuses a tile the carve does not fit
    before it looks for a card."""
    from music_tpu_torch.generate import wavenet_ae_generate as ag

    big = _ae_cfg(de_skip_channel=1024)
    seen = {}

    def tiling(n, device, max_streams=16):
        seen["max_streams"] = max_streams
        return 1, n

    monkeypatch.setattr(ag, "stream_tiling", tiling)
    monkeypatch.setattr(tk, "generate_tokens_fused", lambda *a, **k: None)
    prime_len = big.receptive_field + max(big.dilations)
    codes = torch.zeros((3, prime_len), dtype=torch.int32)
    from music_tpu_torch.kernels.wavenet_ae_decode_hbm import DECODER_KEYS

    ag._decode({k: torch.zeros(1) for k in DECODER_KEYS}, None, codes, big, 4, backend="fused",
               sample_mode="argmax", seed=0, dtype=torch.bfloat16)
    assert seen["max_streams"] == tk.max_streams(big, torch.bfloat16) == 8
    before = tk.LAUNCHES
    ring = torch.empty((16, 1, 1))
    with pytest.raises(ValueError, match="max_streams"):
        tk.decode_cuda({}, ring, None, None, torch.empty((16, 1, 1)), None, None, cfg=big,
                       n_steps=3, n_streams=16)
    assert tk.LAUNCHES == before
