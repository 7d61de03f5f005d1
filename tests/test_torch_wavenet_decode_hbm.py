"""The port's weight-streaming decode (music_tpu_torch.kernels.
wavenet_decode_hbm) held against music_tpu: the f32, bf16, int8
weight-only, int8-matmul and categorical modes, the int8 packs,
dequantized_params and calibrate_act_scales.  Tokens are scored on the JAX
model's teacher-forced logits (music_tpu.models.wavenet.forward, on
music_tpu's dequantized_params for int8 weights), and so are the tokens of
music_tpu.kernels.wavenet_decode_hbm (Pallas, in interpret mode on the
CPU) in the same mode.  On the CPU the wrapper runs the kernel's plain
version, decode_reference; chip_smoke.py holds the CUDA kernel against it
on the card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_tpu.kernels import wavenet_decode_hbm as jh
from music_tpu.models import wavenet as jwn
from music_tpu_torch.kernels import wavenet_decode_hbm as th
from music_tpu_torch.models import wavenet as twn
from music_tpu_torch.utils.parity import tie_aware_check, with_decode_noise

TINY_JSON = dict(
    filter_width=2, dilations=[1, 2, 4, 8, 1, 2, 4, 8], dilation_channels=8,
    residual_channels=8, skip_channels=16, quantization_channels=32, use_bias=False,
)
# 9 layers per dilation group x 16 residual channels: wider than one TPU ring row
WIDE_JSON = dict(TINY_JSON, dilations=[1, 2] * 9, residual_channels=16)
CFGS = {
    "tiny": (jwn.WaveNetConfig.from_json(TINY_JSON), twn.WaveNetConfig.from_json(TINY_JSON)),
    "wide": (jwn.WaveNetConfig.from_json(WIDE_JSON), twn.WaveNetConfig.from_json(WIDE_JSON)),
}
TOL = 1e-5  # float32 on both sides, sums in another order
TOL_BF16 = 2e-3  # bf16 against the f32 model (test_torch_wavenet_decode.py)


def _params(name, seed):
    jcfg, tcfg = CFGS[name]
    jp = jwn.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, twn.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, cfg=tcfg)


def _prime(name, rows, seed, extra=0):
    _, tcfg = CFGS[name]
    P = tcfg.receptive_field + max(tcfg.dilations) + extra
    return np.random.default_rng(seed).integers(0, 32, (rows, P)).astype(np.int32)


def _jax_logits_fn(jp, jcfg, prime, **sampling):
    """Teacher-forced logits of the JAX model (music_tpu.models.wavenet.forward);
    with categorical ``sampling`` plus the fused decode's Philox noise."""
    fwd = jax.jit(functools.partial(jwn.forward, cfg=jcfg))

    def logits_fn(tokens):
        seq = np.concatenate([prime, np.asarray(tokens)[:, :-1]], axis=1)
        logits = np.asarray(fwd(jp, jnp.asarray(seq[:, prime.shape[1] - jcfg.receptive_field:])))
        if not sampling:
            return logits
        return with_decode_noise(torch.tensor(logits), 0, **sampling)

    return logits_fn


def _check_both(ours, ref, logits_fn, tol, label):
    """Tie-aware check of the port's tokens and of the Pallas kernel's on
    the same JAX scores; their exact equality is printed."""
    reports = {name: tie_aware_check(toks, logits_fn, tol)
               for name, toks in (("port", ours), ("Pallas", ref))}
    assert all(r["ok"] for r in reports.values()), reports
    print(f"{label}: exact token equality with the Pallas kernel "
          f"{float((np.asarray(ours) == ref).mean())}", reports)


@pytest.mark.parametrize("name,rows,groups,n_steps", [
    ("tiny", 1, 1, 100), ("wide", 2, 1, 40), ("tiny", 10, 2, 100)])
def test_f32_vs_jax_hbm_interpret(name, rows, groups, n_steps):
    """Argmax, f32: one stream; the wide config with two; 10 rows over two
    blocks of 8.  The port's and the Pallas kernel's tokens tie-aware at
    1e-5 on the JAX model's teacher-forced logits."""
    jcfg, tcfg = CFGS[name]
    jp, tp = _params(name, rows)
    prime = _prime(name, rows, rows, extra=4)
    ref = np.asarray(jh.generate_tokens_fused_hbm(
        jp, jnp.asarray(prime), cfg=jcfg, n_steps=n_steps, interpret=True,
        n_stream_groups=groups))
    ours = th.generate_tokens_fused_hbm(
        tp, torch.from_numpy(prime), cfg=tcfg, n_steps=n_steps, n_streams=8,
        n_stream_groups=groups).numpy()
    assert ours.shape == ref.shape == (rows, n_steps) and ours.dtype == np.int32
    _check_both(ours, ref, _jax_logits_fn(jp, jcfg, prime), TOL, name)


@pytest.mark.parametrize("weight_dtype", [None, torch.int8])
def test_bf16_16_streams(weight_dtype):
    """bf16 activations with 16 streams per block, weights in bf16 or int8:
    the port's and the Pallas kernel's tokens tie-aware within 2e-3 of the
    JAX f32 model (on music_tpu's dequantized_params for int8)."""
    jcfg, tcfg = CFGS["tiny"]
    jp, tp = _params("tiny", 7)
    prime = _prime("tiny", 16, 8)
    jwd = None if weight_dtype is None else jnp.int8
    ref = np.asarray(jh.generate_tokens_fused_hbm(
        jp, jnp.asarray(prime), cfg=jcfg, n_steps=64, interpret=True, n_streams=16,
        dtype=jnp.bfloat16, weight_dtype=jwd))
    ours = th.generate_tokens_fused_hbm(
        tp, torch.from_numpy(prime), cfg=tcfg, n_steps=64, n_streams=16,
        dtype=torch.bfloat16, weight_dtype=weight_dtype).numpy()
    jmodel = jp if weight_dtype is None else jh.dequantized_params(jp, jcfg)
    _check_both(ours, ref, _jax_logits_fn(jmodel, jcfg, prime), TOL_BF16, f"bf16 {weight_dtype}")


def test_int8_weight_only_f32_vs_jax():
    """int8 weights, f32 activations: the port's and the Pallas int8
    kernel's tokens tie-aware at 1e-5 on the JAX model run on JAX's
    dequantized_params (the exact reference of the mode)."""
    jcfg, tcfg = CFGS["tiny"]
    jp, tp = _params("tiny", 0)
    prime = _prime("tiny", 1, 1, extra=16)
    jdq = jh.dequantized_params(jp, jcfg)
    ref = np.asarray(jh.generate_tokens_fused_hbm(
        jdq, jnp.asarray(prime), cfg=jcfg, n_steps=100, interpret=True, weight_dtype=jnp.int8))
    # primed from the dequantized parameters too: requantizing them gives the same packs
    ours = th.generate_tokens_fused_hbm(th.dequantized_params(tp, tcfg), torch.from_numpy(prime),
                                        cfg=tcfg, n_steps=100, n_streams=1,
                                        weight_dtype=torch.int8).numpy()
    _check_both(ours, ref, _jax_logits_fn(jdq, jcfg, prime), TOL, "int8 f32")


@pytest.mark.parametrize("name", ["tiny", "wide"])
def test_int8_packs_equal_jax(name):
    """The port's unpadded int8 packs and scales are the JAX packs' after
    unpadding (codes may differ by at most one where the two divisions
    round differently; they are counted), dequantized_params equals JAX's,
    and requantizing the dequantized parameters reproduces the packs."""
    jcfg, tcfg = CFGS[name]
    jp, tp = _params(name, 3)
    jw = jh._build_hbm_weights(jp, jcfg, weight_dtype=jnp.int8)
    tw = th._build_hbm_weights(tp, tcfg, weight_dtype=torch.int8)
    L, Cr, Cd, Cs = jcfg.n_blocks, jcfg.residual_channels, jcfg.dilation_channels, \
        jcfg.skip_channels
    W = jh._row_lanes(jcfg)
    _, lane = jh._grouping(jcfg, W)
    gate, proj, post = (np.asarray(jw[k]) for k in ("gate", "proj", "post"))
    Crp = proj.shape[2] - Cs
    want = {
        "fg": np.stack([np.concatenate([gate[i, lane[i]:lane[i] + Cr, :2 * Cd],
                                        gate[i, W:W + Cr, :2 * Cd]]) for i in range(L)]),
        "dense": proj[:, :, :Cr], "skip": proj[:, :, Crp:],
        "post1": post[:, :Cs], "post2": post[:, Cs:],
    }
    scales = {
        "fg": np.asarray(jw["gate_scale"])[:, 0, :2 * Cd],
        "dense": np.asarray(jw["proj_scale_dense"])[:, 0],
        "skip": np.asarray(jw["proj_scale_skip"])[:, 0],
        "post1": np.asarray(jw["post_scale_blocks"]).reshape(-1)[:Cs],
        "post2": np.asarray(jw["post_scale_blocks"]).reshape(-1)[Cs:],
    }
    differ = 0
    for k in th.WEIGHT_KEYS:
        q = tw[k].numpy().astype(np.int32)
        assert q.shape == want[k].shape
        assert np.abs(q - want[k]).max() <= 1, k
        differ += int((q != want[k]).sum())
        np.testing.assert_array_equal(tw[f"{k}_scale"].numpy(), scales[k])
    print(f"{name}: {differ} int8 codes differ from JAX's")
    dq_j, dq_t = jh.dequantized_params(jp, jcfg), th.dequantized_params(tp, tcfg)
    for k in ("fg", "dense", "skip", "post1", "post2", "causal"):
        np.testing.assert_allclose(dq_t[k].numpy(), np.asarray(dq_j[k]), rtol=0,
                                   atol=float(np.abs(np.asarray(dq_j[k])).max()) / 127 * differ)
    assert not np.allclose(dq_t["fg"].numpy(), tp["fg"].numpy())  # quantization coarsens
    again = th._build_hbm_weights(dq_t, tcfg, weight_dtype=torch.int8)
    for k in th.WEIGHT_KEYS:
        assert torch.equal(again[k], tw[k]), k


def _train_tiny():
    """TINY trained in JAX with optax Adam on a repeating pattern to loss
    < 0.1 (tests/test_pallas_hbm_decode.py's recipe), carried to the port."""
    jcfg, tcfg = CFGS["tiny"]
    params = jwn.init_params(jax.random.PRNGKey(0), jcfg)
    pat = np.tile(np.arange(8).repeat(3), 400)[: jcfg.receptive_field + 256]
    toks = jnp.asarray(pat, jnp.int32)[None]
    tx = optax.adam(1e-2)
    opt = tx.init(params)

    @jax.jit
    def step(p, o):
        loss, g = jax.value_and_grad(jwn.loss_fn)(p, toks, jcfg)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, loss

    for _ in range(120):
        params, opt, loss = step(params, opt)
    assert float(loss) < 0.1, float(loss)
    tp = twn.params_from_numpy({k: np.asarray(v) for k, v in params.items()}, cfg=tcfg)
    return params, tp, pat


def test_int8_matmul_trained_model_agreement():
    """int8 products quantize activations, so the statement is behavioural:
    on a trained model the dynamic-scale and the calibrated-scale modes
    reproduce >= 99% of the f32 model's tokens (JAX's scan decoder), and
    the port's calibrated scales equal JAX's to 1e-6 relative."""
    jcfg, tcfg = CFGS["tiny"]
    jp, tp, pat = _train_tiny()
    P = tcfg.receptive_field + max(tcfg.dilations) + 16
    prime = pat[:P].astype(np.int32)[None]
    full = np.asarray(jwn.generate_tokens(jp, jnp.asarray(prime), jax.random.PRNGKey(0),
                                          cfg=jcfg, n_steps=150, prime_len=P))
    jscales = jh.calibrate_act_scales(jp, jcfg, jnp.asarray(pat, jnp.int32)[None])
    tscales = th.calibrate_act_scales(tp, tcfg, torch.from_numpy(pat.astype(np.int64))[None])
    np.testing.assert_allclose(tscales, jscales, rtol=1e-6)
    for scales in (None, tscales):
        q8 = th.generate_tokens_fused_hbm(
            tp, torch.from_numpy(prime), cfg=tcfg, n_steps=150, n_streams=1,
            weight_dtype=torch.int8, int8_matmul=True, act_scales=scales).numpy()
        agreement = float((q8 == full).mean())
        assert agreement >= 0.99, (scales is not None, agreement)


def test_categorical_teacher_forced():
    """Categorical draws (Philox, as the kernel's; the TPU's own random bits
    cannot be reproduced) are the argmax of the JAX f32 model's
    teacher-forced logits over the temperature plus the same noise (1e-5)."""
    jcfg, tcfg = CFGS["tiny"]
    jp, tp = _params("tiny", 10)
    prime = _prime("tiny", 5, 10)
    kw = dict(sample_mode="categorical", temperature=0.8, seed=3)
    toks = th.generate_tokens_fused_hbm(tp, torch.from_numpy(prime), cfg=tcfg, n_steps=60,
                                        n_streams=8, **kw)
    report = tie_aware_check(toks, _jax_logits_fn(jp, jcfg, prime, **kw), TOL)
    assert report["ok"], report


@pytest.mark.parametrize("kw,err", [
    (dict(int8_matmul=True), "int8_matmul requires"),
    (dict(weight_dtype=torch.int8, act_scales=(0.1,) * 8), "act_scales requires"),
    (dict(weight_dtype=torch.int8, int8_matmul=True, act_scales=(0.1,) * 3), "one act scale"),
])
def test_bad_mode_combinations_raise(kw, err):
    _, tcfg = CFGS["tiny"]
    _, tp = _params("tiny", 1)
    with pytest.raises(ValueError, match=err):
        th.generate_tokens_fused_hbm(tp, torch.from_numpy(_prime("tiny", 1, 1)), cfg=tcfg,
                                     n_steps=4, n_streams=1, **kw)


def test_use_bias_raises():
    cfg = twn.WaveNetConfig.from_json({**TINY_JSON, "use_bias": True})
    tp = twn.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="use_bias"):
        th.generate_tokens_fused_hbm(tp, torch.from_numpy(_prime("tiny", 1, 1)), cfg=cfg,
                                     n_steps=4, n_streams=1)


def test_max_streams_and_oversized_tile_raises():
    """The scaled model takes 4 streams a block in the working dtype (the
    resident carve with per-layer skip, whose 8-stream tile is not
    compiled) and 16 in the int8 modes; a tile the carve does not fit is
    refused by the wrapper before any launch, and the CPU path launches
    nothing."""
    scaled = twn.WaveNetConfig(dilation_channels=64, residual_channels=64, skip_channels=1024)
    assert th.max_streams(scaled) == th.max_streams(scaled, torch.bfloat16) == 4
    assert th.max_streams(scaled, mode=1) == th.max_streams(scaled, mode=2) == 16
    big = twn.WaveNetConfig.from_json({**TINY_JSON, "skip_channels": 4096})
    assert th.max_streams(big) == 4
    tp = twn.init_params(big, torch.Generator().manual_seed(0))
    prime = torch.from_numpy(_prime("tiny", 8, 2))
    before = th.LAUNCHES
    inputs = th.prepare(tp, prime, cfg=big, n_streams=8)
    out = th.decode_reference(*inputs, cfg=big, n_steps=3)
    assert out.shape == (8, 3) and th.LAUNCHES == before
    with pytest.raises(ValueError, match="max_streams"):
        th.decode_cuda(*inputs, cfg=big, n_steps=3, n_streams=8)
    with pytest.raises(ValueError, match="CUDA"):
        th.decode_cuda(*inputs, cfg=big, n_steps=3, n_streams=4)
    assert th.LAUNCHES == before


# the widths of the tiny config, the shipped model and the 4.4x-scaled one
WIDTHS = {"tiny": CFGS["tiny"][1], "shipped": twn.WaveNetConfig(),
          "scaled": twn.WaveNetConfig(dilation_channels=64, residual_channels=64,
                                      skip_channels=1024)}


@pytest.mark.parametrize("name,dtype,want,fits8", [
    ("tiny", torch.float32, 4, True), ("tiny", torch.bfloat16, 4, True),
    ("shipped", torch.float32, 4, True), ("shipped", torch.bfloat16, 4, True),
    ("scaled", torch.float32, 4, False), ("scaled", torch.bfloat16, 4, True),
])
def test_mode0_carve(name, dtype, want, fits8):
    """The working-dtype mode's carve (the resident body's, with two layers'
    z and skip_acc in place of z of all layers): max_streams by dtype, every
    offset 16-byte aligned, 2 to MAX_STAGES stages, and the next tile up
    not compiled (LAYER_SKIP_STREAMS stops at 4), whether or not its carve
    would fit (at the scaled width 8 f32 streams would not)."""
    from music_tpu_torch.kernels import wavenet_decode as tdec

    cfg = WIDTHS[name]
    dims = (cfg.n_blocks, cfg.residual_channels, cfg.dilation_channels, cfg.skip_channels,
            cfg.quantization_channels)
    assert th.max_streams(cfg, dtype) == want
    offsets, nbytes = th.smem_layout(*dims, want, dtype)
    assert nbytes <= th.SMEM_LIMIT and 2 <= offsets[6] <= tdec.MAX_STAGES
    assert all(o % 4 == 0 for i, o in enumerate(offsets) if i != 6)  # floats: 16 bytes
    # two layers of z, not L: the carve is the resident one's with layer_skip
    assert offsets[1] - offsets[0] == 4 * ((2 * want * cfg.dilation_channels + 3) // 4)
    assert (offsets, nbytes) == tdec.smem_layout(*dims, want, dtype, layer_skip=True)
    assert 2 * want not in th.streams_of(0)
    assert (th.smem_layout(*dims, 2 * want, dtype)[1] <= th.SMEM_LIMIT) is fits8


@pytest.mark.parametrize("dtype,n_streams", [(torch.float32, 8), (torch.bfloat16, 8)])
def test_mode0_tile_past_max_streams_refused(dtype, n_streams):
    """At the scaled width a tile past max_streams in the working dtype (8
    streams a block: not compiled) is refused on the CPU before any launch,
    with or without a card."""
    cfg = WIDTHS["scaled"]
    L, Cr, Cd, Cs, Q = (cfg.n_blocks, cfg.residual_channels, cfg.dilation_channels,
                        cfg.skip_channels, cfg.quantization_channels)
    w = {"fg": torch.zeros(1, dtype=dtype)}
    ring = torch.zeros((n_streams, 1, Cr), dtype=dtype)
    tok = torch.zeros(n_streams, dtype=torch.int32)
    before = th.LAUNCHES
    with pytest.raises(ValueError, match="max_streams"):
        th.decode_cuda(w, ring, tok, tok, cfg=cfg, n_steps=3, n_streams=n_streams, dtype=dtype)
    assert th.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prepare_chain_packs(dtype):
    """In the working dtype prepare also returns the chain packs the kernel
    stages: fg and dense transposed to one row per output column and padded
    by 16 bytes; the int8 modes have none.  The plain version reads the
    untransposed packs, so its tokens do not change."""
    _, tcfg = CFGS["wide"]
    _, tp = _params("wide", 3)
    prime = torch.from_numpy(_prime("wide", 2, 3))
    w, ring, s0, prev0 = th.prepare(tp, prime, cfg=tcfg, n_streams=2, dtype=dtype)
    pad = 16 // w["fg"].element_size()
    L, Cr, Cd = tcfg.n_blocks, tcfg.residual_channels, tcfg.dilation_channels
    assert w["fg_t"].shape == (L, 2 * Cd, 2 * Cr + pad) and w["fg_t"].dtype == dtype
    assert w["dense_t"].shape == (L, Cr, Cd + pad) and w["dense_t"].is_contiguous()
    assert torch.equal(w["fg_t"][..., :2 * Cr], w["fg"].transpose(1, 2))
    assert torch.equal(w["dense_t"][..., :Cd], w["dense"].transpose(1, 2))
    assert not w["fg_t"][..., 2 * Cr:].any() and not w["dense_t"][..., Cd:].any()
    plain = {k: v for k, v in w.items() if k not in ("fg_t", "dense_t")}
    kw = dict(cfg=tcfg, n_steps=6, dtype=dtype)
    assert torch.equal(th.decode_reference(w, ring, s0, prev0, **kw),
                       th.decode_reference(plain, ring, s0, prev0, **kw))
    wq, *_ = th.prepare(tp, prime, cfg=tcfg, n_streams=2, weight_dtype=torch.int8)
    assert "fg_t" not in wq and "dense_t" not in wq
