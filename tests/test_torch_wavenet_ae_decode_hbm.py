"""The port's weight-streaming conditioned decode (music_tpu_torch.kernels.
wavenet_ae_decode_hbm) held against music_tpu: the shared clock,
per-stream clocks that cross and clamp frames, bf16 with 16 streams and
int8 weight-only.  Tokens are scored on the JAX autoencoder's plain step
decoder, teacher-forced (music_tpu.models.wavenet_ae.decode_step, on
music_tpu's dequantized_params for int8 weights), and so are the tokens of
music_tpu.kernels.wavenet_ae_decode_hbm (Pallas, in interpret mode on the
CPU) in the same mode.  On the CPU the wrapper runs the kernel's plain
version, decode_reference; chip_smoke.py holds the CUDA kernel against it
on the card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_tpu.kernels import wavenet_ae_decode_hbm as jh
from music_tpu.models import wavenet_ae as jae
from music_tpu_torch.kernels import wavenet_ae_decode_hbm as th
from music_tpu_torch.models import wavenet_ae as tae
from music_tpu_torch.utils.parity import tie_aware_check

TINY_JSON = dict(
    filter_width=2, dilations=[1, 2, 4, 8, 1, 2, 4, 8], en_residual_channel=8,
    en_dilation_channel=8, de_residual_channel=8, de_dilation_channel=8, de_skip_channel=16,
    en_bottleneck_width=12, en_pool_kernel_size=16, quantization_channel=32, use_bias=False,
)
JTINY = jae.WaveNetAEConfig.from_json(TINY_JSON)
TTINY = tae.WaveNetAEConfig.from_json(TINY_JSON)
PRIME_LEN = TTINY.receptive_field + max(TTINY.dilations)  # 40
POOL = TTINY.en_pool_kernel_size
TOL = 1e-5  # float32 on both sides, sums in another order
# bf16 against the f32 model: the AE's measured bf16 logit error is up to
# 1.85e-3 (tests/test_torch_wavenet_ae_decode.py), so twice it, times 2
TOL_BF16 = 8e-3


def _params(seed):
    jp = jae.init_params(jax.random.PRNGKey(seed), JTINY)
    return jp, tae.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, cfg=TTINY)


def _inputs(seed, rows, n_frames):
    rng = np.random.default_rng(seed)
    prime = rng.integers(0, 32, (rows, PRIME_LEN)).astype(np.int32)
    enc = (rng.normal(size=(rows, n_frames, 12)) * 0.3).astype(np.float32)
    return prime, enc


def _run_both(jp, tp, prime, enc, n_steps, pos, S, G, **kw):
    """The Pallas kernel (interpret) and the port's plain version on the
    same inputs; ``pos`` an int (shared clock) or a ``[B]`` array."""
    jpos = jnp.asarray(pos) if np.ndim(pos) else pos
    jkw = {k: (jnp.int8 if v is torch.int8 else jnp.bfloat16 if v is torch.bfloat16 else v)
           for k, v in kw.items()}
    ref = np.asarray(jh.generate_tokens_fused_hbm(
        jp, jnp.asarray(enc), jnp.asarray(prime), cfg=JTINY, n_steps=n_steps, interpret=True,
        pos_offset=jpos, n_streams=S, n_stream_groups=G, **jkw))
    tpos = torch.from_numpy(np.asarray(pos)) if np.ndim(pos) else pos
    ours = th.generate_tokens_fused_hbm(
        tp, torch.from_numpy(enc), torch.from_numpy(prime), cfg=TTINY, n_steps=n_steps,
        n_streams=S, n_stream_groups=G, pos_offset=tpos, **kw)
    return ref, ours


def _jax_step_scores(jp, enc, prime, pos):
    """Teacher-forced logits of the JAX plain step decoder
    (music_tpu.models.wavenet_ae.decode_step), each stream conditioned on
    its own clock: the token at time ``pos + i`` (``pos`` the time of
    ``prime[:, 0]``) takes frame ``min((pos + i) // pool, F - 1)``."""
    step = jax.jit(functools.partial(jae.decode_step, cfg=JTINY))
    B, F, P = enc.shape[0], enc.shape[1], prime.shape[1]
    pos = np.broadcast_to(np.asarray(pos), (B,))
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


def _model_check(jp, enc, prime, pos, toks, tol, label, ref):
    """The port's tokens and the Pallas kernel's, tie-aware on the JAX
    model's scores; their exact equality is printed."""
    scores = _jax_step_scores(jp, enc, prime, pos)
    reports = {name: tie_aware_check(t, scores, tol)
               for name, t in (("port", toks), ("Pallas", ref))}
    assert all(r["ok"] for r in reports.values()), reports
    print(f"{label}: exact equality with the Pallas kernel "
          f"{float((np.asarray(toks) == ref).mean())}", reports)


def test_shared_clock_vs_jax():
    """Two streams on the shared clock (scalar pos_offset), f32, 100 steps."""
    jp, tp = _params(0)
    prime, enc = _inputs(1, 2, 12)
    ref, ours = _run_both(jp, tp, prime, enc, 100, 0, 8, 1)
    assert ours.shape == (2, 100) and ours.dtype == torch.int32
    _model_check(jp, enc, prime, 0, ours, TOL, "shared clock", ref)


def test_per_stream_clocks_cross_and_clamp_vs_jax():
    """Nine streams over two blocks of 8, each on its own clock; with 8
    frames (time 128) every stream clamps at the last frame within the 110
    steps, at different steps."""
    jp, tp = _params(20)
    prime, enc = _inputs(21, 9, 8)
    pos = np.array([0, 3, 17, 30, 5, 11, 24, 2, 40], np.int32)
    ref, ours = _run_both(jp, tp, prime, enc, 110, pos, 8, 2)
    frames = tae.frame_of(torch.from_numpy(pos + PRIME_LEN)[:, None] + torch.arange(110), POOL, 8)
    assert bool((frames[:, -1] == 7).all()) and len(set(frames[:, 0].tolist())) > 2
    _model_check(jp, enc, prime, pos, ours, TOL, "per-stream clocks", ref)


@pytest.mark.parametrize("pos", [0, 5, 15, 16, 31, 100])
def test_clock_equals_jax_rebased_clock(pos):
    """music_tpu's per-stream path rebases each stream's table by its base
    frame ``(pos + P) // pool`` and reads row ``w`` or ``w + 1`` of the
    rebased table (``w = t // pool``, crossing at ``t % pool >= pool - r``,
    r the phase), clipped to the last frame (wavenet_ae_decode_hbm.py
    :779-793, :355-374).  The port's clock ``min((pos + P + t) // pool,
    F - 1)`` names the same frame at every step, clamping included."""
    F, P = 9, PRIME_LEN
    abs0 = pos + P
    base, r = abs0 // POOL, abs0 % POOL
    fidx = np.clip(np.arange(F) + base, 0, F - 1)
    for t in range(200):
        w = t // POOL
        row = w + int(t % POOL >= POOL - r and r > 0)
        rebased = fidx[min(row, F - 1)]
        assert rebased == int(tae.frame_of(torch.tensor(abs0 + t), POOL, F)), (t, rebased)


def test_bf16_16_streams_vs_jax():
    """bf16 activations and tables, 16 streams per block with per-stream
    clocks: the port's and the Pallas kernel's tokens tie-aware within 8e-3
    of the JAX f32 AE model."""
    jp, tp = _params(31)
    prime, enc = _inputs(32, 16, 30)
    pos = (np.random.default_rng(33).integers(0, 4, 16) * 16 + 3).astype(np.int32)
    ref, ours = _run_both(jp, tp, prime, enc, 64, pos, 16, 1, dtype=torch.bfloat16)
    _model_check(jp, enc, prime, pos, ours, TOL_BF16, "bf16 16 streams", ref)


def test_int8_vs_jax_and_dequantized_step_loop():
    """int8 weight-only: the port's dequantized_params equals JAX's (the
    conditioning projections and the encoder unchanged); the port's and the
    Pallas int8 kernel's tokens, and the port's plain AE step loop on
    dequantized_params, are tie-aware at 1e-5 on the JAX step decoder run
    on JAX's dequantized_params."""
    jp, tp = _params(40)
    prime, enc = _inputs(41, 2, 12)
    dq_t, dq_j = th.dequantized_params(tp, TTINY), jh.dequantized_params(jp, JTINY)
    # primed from the dequantized parameters: requantizing them gives the same packs
    ref, ours = _run_both(dq_j, dq_t, prime, enc, 100, 0, 8, 1, weight_dtype=torch.int8)
    for k in tp:
        np.testing.assert_array_equal(dq_t[k].numpy(), np.asarray(dq_j[k]), err_msg=k)
    for k in ("cond_fg", "cond_post", "en_causal", "de_causal", "bottleneck"):
        assert torch.equal(dq_t[k], tp[k])
    assert not torch.equal(dq_t["conn1"], tp["conn1"])
    _model_check(dq_j, enc, prime, 0, ours, TOL, "int8", ref)
    step = tae.generate_tokens(dq_t, torch.from_numpy(enc), torch.from_numpy(prime), cfg=TTINY,
                               n_steps=100)
    report = tie_aware_check(step, _jax_step_scores(dq_j, enc, prime, 0), TOL)
    assert report["ok"], ("the port's plain step loop on dequantized_params", report)
    print("int8: exact equality with the port's step loop on dequantized_params",
          float((ours == step).float().mean()))


def test_max_streams_refusals_and_no_launch_on_cpu():
    """The scaled decoder takes 4 streams a block in the working dtype (the
    resident carve with per-layer skip and the conditioning rows in its
    stages) and 16 with int8 weights; a tile the carve does not fit, CPU
    tensors and a bad weight dtype are refused before any launch; the CPU
    path launches nothing."""
    scaled = tae.WaveNetAEConfig(de_residual_channel=64, de_dilation_channel=64,
                                 de_skip_channel=1024)
    assert th.max_streams(scaled) == th.max_streams(scaled, torch.bfloat16) == 4
    assert th.max_streams(scaled, mode=1) == 16
    big = tae.WaveNetAEConfig.from_json({**TINY_JSON, "de_skip_channel": 4096})
    assert th.max_streams(big) == 4
    tp = tae.init_params(big, torch.Generator().manual_seed(0))
    prime, enc = _inputs(5, 8, 10)
    before = th.LAUNCHES
    inputs = th.prepare(tp, torch.from_numpy(enc), torch.from_numpy(prime), cfg=big,
                        n_streams=8)
    assert th.decode_reference(*inputs, cfg=big, n_steps=3).shape == (8, 3)
    with pytest.raises(ValueError, match="max_streams"):
        th.decode_cuda(*inputs, cfg=big, n_steps=3, n_streams=8)
    with pytest.raises(ValueError, match="CUDA"):
        th.decode_cuda(*inputs, cfg=big, n_steps=3, n_streams=4)
    with pytest.raises(NotImplementedError, match="int8"):
        th.prepare(tp, torch.from_numpy(enc), torch.from_numpy(prime), cfg=big, n_streams=8,
                   weight_dtype=torch.float16)
    assert th.LAUNCHES == before


@pytest.mark.parametrize("dtype,fits8", [(torch.float32, False), (torch.bfloat16, True)])
def test_mode0_carve_holds_the_conditioning_rows(dtype, fits8):
    """At the scaled decoder width the working-dtype carve is the resident
    AE carve with per-layer skip: 16-byte aligned offsets, every stream's
    conditioning row in each stage (a stage larger than WaveNet's by 2Cd a
    stream), 4 streams a block, and 8 not compiled whether or not its carve
    would fit."""
    want = 4
    from music_tpu_torch.kernels import wavenet_decode as tdec
    from music_tpu_torch.kernels import wavenet_decode_hbm as tw

    cfg = tae.WaveNetAEConfig(de_residual_channel=64, de_dilation_channel=64,
                              de_skip_channel=1024)
    dims = (cfg.n_blocks, 64, 64, 1024, cfg.quantization_channel)
    assert th.max_streams(cfg, dtype) == want
    offsets, nbytes = th.smem_layout(*dims, want, dtype, 0, ae=True)
    assert nbytes <= th.SMEM_LIMIT and all(o % 4 == 0 for i, o in enumerate(offsets) if i != 6)
    assert (offsets, nbytes) == tdec.smem_layout(*dims, want, dtype, ae=True, layer_skip=True)
    esize = torch.tensor([], dtype=dtype).element_size()
    assert offsets[5] - th.smem_layout(*dims, want, dtype, 0)[0][5] == want * 2 * 64 * esize // 4
    assert 2 * want not in tw.LAYER_SKIP_STREAMS
    assert (th.smem_layout(*dims, 2 * want, dtype, 0, ae=True)[1] <= th.SMEM_LIMIT) is fits8


def test_prepare_chain_packs():
    """prepare in the working dtype adds the chain packs (fg and dense
    transposed, padded by 16 bytes) for the kernel; the plain version reads
    the untransposed packs, so its tokens do not change."""
    _, tp = _params(12)
    prime, enc = _inputs(12, 3, 6)
    w, *state = th.prepare(tp, torch.from_numpy(enc), torch.from_numpy(prime), cfg=TTINY,
                           n_streams=4)
    L, Cr, Cd = TTINY.n_blocks, TTINY.de_residual_channel, TTINY.de_dilation_channel
    assert torch.equal(w["fg_t"][..., :2 * Cr], w["fg"].transpose(1, 2))
    assert torch.equal(w["dense_t"][..., :Cd], w["dense"].transpose(1, 2))
    assert w["fg_t"].shape == (L, 2 * Cd, 2 * Cr + 4) and w["dense_t"].shape == (L, Cr, Cd + 4)
    plain = {k: v for k, v in w.items() if k not in ("fg_t", "dense_t")}
    assert torch.equal(th.decode_reference(w, *state, cfg=TTINY, n_steps=6),
                       th.decode_reference(plain, *state, cfg=TTINY, n_steps=6))
