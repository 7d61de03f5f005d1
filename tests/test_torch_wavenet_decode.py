"""The port's fused decode (music_tpu_torch.kernels.wavenet_decode) held
against music_tpu.kernels.wavenet_decode.generate_tokens_fused (Pallas, in
interpret mode on the CPU) and its _collect_prime_state.  On the CPU the
wrapper runs the kernel's plain version, decode_reference; the CUDA kernel
itself is checked against it on the card by chip_smoke.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from music_tpu.kernels import wavenet_decode as jdec
from music_tpu.models import wavenet as jwn
from music_tpu_torch.kernels import wavenet_decode as tdec
from music_tpu_torch.models import wavenet as twn
from music_tpu_torch.ops import philox
from music_tpu_torch.utils.parity import reference_scores, teacher_forced_scores, tie_aware_check
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

TINY_JSON = dict(
    filter_width=2, dilations=[1, 2, 4, 8, 1, 2, 4, 8], dilation_channels=8,
    residual_channels=8, skip_channels=16, quantization_channels=32, use_bias=False,
)
JTINY = jwn.WaveNetConfig.from_json(TINY_JSON)
TTINY = twn.WaveNetConfig.from_json(TINY_JSON)
PRIME_LEN = TTINY.receptive_field + max(TTINY.dilations)


def _params(seed):
    jp = jwn.init_params(jax.random.PRNGKey(seed), JTINY)
    return jp, twn.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, cfg=TTINY)


def _jax_logits_fn(jp, prime):
    """Teacher-forced scores of the JAX model (music_tpu.models.wavenet.forward)."""
    fwd = jax.jit(functools.partial(jwn.forward, cfg=JTINY))

    def logits_fn(tokens):
        seq = np.concatenate([prime, np.asarray(tokens)[:, :-1]], axis=1)
        return np.asarray(fwd(jp, jnp.asarray(seq[:, prime.shape[1] - JTINY.receptive_field:])))

    return logits_fn


@pytest.mark.parametrize("n_rows,n_groups,n_steps", [(1, 1, 150), (11, 2, 37)])
def test_decode_reference_vs_jax_fused_interpret(n_rows, n_groups, n_steps):
    """Argmax, f32: 1 stream, and 11 streams over 2 tiles of 8; step counts
    not multiples of 128.  Tie-aware tolerance 1e-5 on the JAX model's
    teacher-forced logits (float32 order differences only); exact equality
    with the Pallas kernel is reported too."""
    jp, tp = _params(seed=n_rows)
    prime = np.random.default_rng(n_rows).integers(0, 32, (n_rows, PRIME_LEN + 3))
    prime = prime.astype(np.int32)
    ref = np.asarray(jdec.generate_tokens_fused(
        jp, jnp.asarray(prime), cfg=JTINY, n_steps=n_steps, interpret=True,
        n_stream_groups=n_groups))
    ours = tdec.generate_tokens_fused(
        tp, torch.from_numpy(prime), cfg=TTINY, n_steps=n_steps, n_streams=8,
        n_stream_groups=n_groups).numpy()
    assert ours.shape == ref.shape == (n_rows, n_steps) and ours.dtype == np.int32
    report = tie_aware_check(ours, _jax_logits_fn(jp, prime), tol=1e-5)
    assert report["ok"], report
    exact = float((ours == ref).mean())
    print(f"exact token equality with the Pallas kernel: {exact:.4f}", report)


def test_prime_state_matches_jax():
    # tolerance 1e-5: the same float32 prime conv, sums in another order;
    # s0 and prev0 exactly
    jp, tp = _params(seed=7)
    prime = np.random.default_rng(7).integers(0, 32, (5, PRIME_LEN + 9)).astype(np.int32)
    prime_state = jax.jit(functools.partial(jdec._collect_prime_state, cfg=JTINY))
    init, _, _, js0 = prime_state(jp, jnp.asarray(prime))
    ring, s0, prev0 = tdec._collect_prime_state(tp, torch.from_numpy(prime), TTINY)
    groups, lane_of_layer = jdec._grouping(JTINY)
    offs, ring_len = tdec.ring_offsets(TTINY)
    assert tuple(ring.shape) == (5, ring_len, 8)
    init = np.asarray(init)  # [tiles, S, 128]: group tiles, layers side by side in lanes
    base = 0
    for d, layers in groups:
        for i in layers:
            lane = lane_of_layer[i]
            want = np.swapaxes(init[base : base + d, :, lane : lane + 8], 0, 1)
            np.testing.assert_allclose(ring[:, offs[i] : offs[i] + d].numpy(), want,
                                       rtol=1e-5, atol=1e-6)
        base += d
    np.testing.assert_array_equal(s0.numpy(), np.asarray(js0))
    np.testing.assert_array_equal(prev0.numpy(), prime[:, -1])


def test_bf16_plain_vs_f32_plain():
    """bf16 decode_reference against the f32 model, teacher-forced.
    Its logit error was measured at 2.3e-4 to 3.8e-4 on this config (three
    seeds) and 4.5e-4 at the shipped width; it must stay under 1e-3, and a
    token's deficit (at most twice the logit error) under 2e-3."""
    _, tp = _params(seed=8)
    prime = torch.from_numpy(
        np.random.default_rng(8).integers(0, 32, (16, PRIME_LEN)).astype(np.int32))
    toks = tdec.generate_tokens_fused(tp, prime, cfg=TTINY, n_steps=120, n_streams=16,
                                      dtype=torch.bfloat16)
    report = tie_aware_check(
        toks, lambda t: teacher_forced_scores(tp, prime, t, TTINY), tol=2e-3)
    assert report["ok"], report
    inputs = tdec.prepare(tp, prime, cfg=TTINY, n_streams=16, dtype=torch.bfloat16)
    bf16_logits = reference_scores(inputs, toks, TTINY, dtype=torch.bfloat16)
    err = float((bf16_logits - teacher_forced_scores(tp, prime, toks, TTINY)[:, 1:]).abs().max())
    assert err < 1e-3, err
    f32 = tdec.generate_tokens_fused(tp, prime, cfg=TTINY, n_steps=120, n_streams=16)
    print("bf16 vs f32 exact tokens:", (toks == f32).float().mean().item(), report, err)


@pytest.mark.parametrize("dtype,mode", [(torch.float32, "argmax"),
                                        (torch.bfloat16, "categorical")])
def test_reference_scores_teacher_forced(dtype, mode):
    """decode_reference fed its own tokens (``forced``) gives logits whose
    scores pick exactly those tokens (tolerance 0: the same computation),
    and tokens it would not draw are caught."""
    _, tp = _params(seed=14)
    prime = torch.from_numpy(
        np.random.default_rng(14).integers(0, 32, (4, PRIME_LEN)).astype(np.int32))
    sampling = dict(sample_mode=mode, temperature=0.7, seed=5)
    inputs = tdec.prepare(tp, prime, cfg=TTINY, n_streams=4, dtype=dtype, **sampling)
    toks = tdec.decode_reference(*inputs, cfg=TTINY, n_steps=40, dtype=dtype, **sampling)
    scores = reference_scores(inputs, toks, TTINY, dtype=dtype, **sampling)
    assert tuple(scores.shape) == (4, 39, 32)
    report = tie_aware_check(toks[:, 1:], lambda t: scores, tol=0.0)
    assert report["ok"] and report["exact"] == report["n"], report
    worst = scores.argmin(dim=-1).to(torch.int32)
    assert not tie_aware_check(worst, lambda t: scores, tol=1e-3)["ok"]


@pytest.mark.parametrize("ctr,key,want", [
    ([0, 0, 0, 0], [0, 0], "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2, "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344], [0xA4093822, 0x299F31D0],
     "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(ctr, key, want):
    out = philox.philox4x32(torch.tensor(ctr), torch.tensor(key))
    assert " ".join(f"{int(v):08x}" for v in out) == want


def test_philox_uniforms_range():
    u = philox.decode_uniforms(9, torch.arange(64), 3, 256)
    assert u.shape == (64, 256) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # 16384 uniforms: mean within 5 sigma (sigma = 0.29/128)
    assert abs(float(u.mean()) - 0.5) < 0.012


def test_categorical_reproducible_and_teacher_forced():
    """Same seed, same tokens; another seed, other tokens; and every token
    is the argmax of the teacher-forced scores with the same Philox noise
    (tolerance 1e-5: float32 order differences only)."""
    _, tp = _params(seed=10)
    prime = torch.from_numpy(
        np.random.default_rng(10).integers(0, 32, (5, PRIME_LEN)).astype(np.int32))
    kw = dict(cfg=TTINY, n_steps=60, n_streams=8, sample_mode="categorical",
              temperature=0.8)
    a = tdec.generate_tokens_fused(tp, prime, seed=3, **kw)
    b = tdec.generate_tokens_fused(tp, prime, seed=3, **kw)
    c = tdec.generate_tokens_fused(tp, prime, seed=4, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    report = tie_aware_check(a, lambda t: teacher_forced_scores(
        tp, prime, t, TTINY, sample_mode="categorical", temperature=0.8, seed=3), tol=1e-5)
    assert report["ok"], report


def test_categorical_first_step_histogram_chi_square():
    """The decode loop's first draw over 6000 stream rows (one shared prime
    and first token, independent Philox keys) follows softmax(logits / T):
    chi-square p > 1e-4 after pooling bins expected below 5."""
    _, tp = _params(seed=11)
    T = 0.25
    rows = 6000
    prime = torch.full((rows, PRIME_LEN), 16, dtype=torch.int32)
    w, ring, s0, prev0 = tdec.prepare(tp, prime, cfg=TTINY, n_streams=rows,
                                      sample_mode="categorical", temperature=T, seed=1)
    s0 = torch.full_like(s0, 5)
    out = tdec.decode_reference(w, ring, s0, prev0, cfg=TTINY, n_steps=2,
                                sample_mode="categorical", temperature=T, seed=1)
    logits = teacher_forced_scores(tp, prime[:1], out[:1], TTINY)[0, 1]
    probs = torch.softmax(logits / T, dim=-1).numpy().astype(np.float64)
    counts = np.bincount(out[:, 1].numpy(), minlength=32)
    expected = probs * rows
    keep = expected >= 5
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.append(expected[keep], expected[~keep].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    assert keep.sum() >= 4  # the test has bins to compare
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    assert stats.chi2.sf(chi2, len(obs) - 1) > 1e-4, (chi2, obs, exp)


def test_use_bias_raises_on_kernel_path():
    cfg = twn.WaveNetConfig.from_json({**TINY_JSON, "use_bias": True})
    tp = twn.init_params(cfg, torch.Generator().manual_seed(0))
    prime = torch.full((1, PRIME_LEN), 16, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="use_bias"):
        tdec.generate_tokens_fused(tp, prime, cfg=cfg, n_steps=10, n_streams=1)


def test_cpu_wrapper_launches_no_kernel():
    _, tp = _params(seed=12)
    prime = torch.full((2, PRIME_LEN), 16, dtype=torch.int32)
    before = tdec.LAUNCHES
    out = tdec.generate_tokens_fused(tp, prime, cfg=TTINY, n_steps=5, n_streams=2)
    assert out.shape == (2, 5)
    assert tdec.LAUNCHES == before
    # the CUDA wrapper refuses CPU tensors before building anything
    w, ring, s0, prev0 = tdec.prepare(tp, prime, cfg=TTINY, n_streams=1, n_stream_groups=2)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_cuda(w, ring, s0, prev0, cfg=TTINY, n_steps=5, n_streams=1)
    assert tdec.LAUNCHES == before


def test_prime_too_short_raises():
    _, tp = _params(seed=13)
    prime = torch.full((1, PRIME_LEN - 1), 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="prime length"):
        tdec.generate_tokens_fused(tp, prime, cfg=TTINY, n_steps=5, n_streams=1)


# the scaled model (bench.py's 4.4x widths) and ROADMAP C1's model: the
# shipped widths with Cs = 1024, 11.4 MB of f32 weights, so on B1's route
SCALED = twn.WaveNetConfig(dilation_channels=64, residual_channels=64, skip_channels=1024)
C1_MODEL = twn.WaveNetConfig(skip_channels=1024)


@pytest.mark.parametrize("cfg,dtype,want", [
    (twn.WaveNetConfig(), torch.float32, 16), (twn.WaveNetConfig(), torch.bfloat16, 16),
    (TTINY, torch.float32, 16), (TTINY, torch.bfloat16, 16),
    (SCALED, torch.float32, 2), (SCALED, torch.bfloat16, 4),
    (C1_MODEL, torch.float32, 8), (C1_MODEL, torch.bfloat16, 8),
], ids=["shipped-f32", "shipped-bf16", "tiny-f32", "tiny-bf16", "scaled-f32", "scaled-bf16",
        "c1-f32", "c1-bf16"])
def test_max_streams(cfg, dtype, want):
    """The most streams a block whose carve fits, and that the carve of the
    next tile up does not; every fitting carve has 2 to MAX_STAGES stages."""
    dims = (cfg.n_blocks, cfg.residual_channels, cfg.dilation_channels, cfg.skip_channels,
            cfg.quantization_channels)
    assert tdec.max_streams(cfg, dtype) == want
    offsets, nbytes = tdec.smem_layout(*dims, want, dtype)
    assert nbytes <= tdec.SMEM_LIMIT and 2 <= offsets[6] <= tdec.MAX_STAGES
    if want < tdec.SUPPORTED_STREAMS[-1]:
        assert tdec.smem_layout(*dims, 2 * want, dtype)[1] > tdec.SMEM_LIMIT


def test_c1_model_tiles_by_its_carve(monkeypatch):
    """ROADMAP C1: 1100 streams of the Cs = 1024 model on a 132-SM card.
    Capped by the default 16 the tiling asks for a tile whose carve does not
    fit; capped by max_streams it takes 8 a block, in a second wave."""
    from types import SimpleNamespace

    from music_tpu_torch.generate import wavenet_generate as wg
    from music_tpu_torch.kernels import wavenet_decode_hbm as thbm

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(multi_processor_count=132))
    cuda = torch.device("cuda")
    dims = (40, 32, 32, 1024, 256)
    # B1's route: the weight-streaming carve holds no more streams a block
    assert not wg.streams_weights(1100, cuda, tdec, thbm, C1_MODEL, torch.float32)
    S, G = wg.stream_tiling(1100, cuda)
    assert tdec.smem_layout(*dims, S, torch.float32)[1] > tdec.SMEM_LIMIT
    S, G = wg.stream_tiling(1100, cuda, tdec.max_streams(C1_MODEL, torch.float32))
    assert (S, G) == (8, 138)
    assert tdec.smem_layout(*dims, S, torch.float32)[1] <= tdec.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generate_tiles_by_max_streams(monkeypatch, dtype):
    """The generate path hands stream_tiling the kernel's max_streams for its
    config and dtype."""
    from music_tpu_torch.generate import wavenet_generate as wg

    seen = {}

    def tiling(n, device, max_streams=16):
        seen["max_streams"] = max_streams
        return 1, n

    monkeypatch.setattr(wg, "stream_tiling", tiling)
    monkeypatch.setattr(tdec, "generate_tokens_fused", lambda *a, **k: None)
    prime = torch.zeros((3, 5), dtype=torch.int32)
    wg._fused_decode({"w": torch.zeros(1)}, prime, C1_MODEL, 4, dtype, "argmax", 1.0, 0)
    assert seen["max_streams"] == tdec.max_streams(C1_MODEL, dtype) == 8


def test_oversized_tile_raises_before_any_launch():
    """decode_cuda refuses a tile its carve does not fit, or widths its
    16-byte copies cannot take, before it looks for a card or a library."""
    before = tdec.LAUNCHES
    ring = torch.empty((16, 1, 1))
    with pytest.raises(ValueError, match="max_streams"):
        tdec.decode_cuda({}, ring, None, None, cfg=C1_MODEL, n_steps=3, n_streams=16)
    narrow = twn.WaveNetConfig.from_json({**TINY_JSON, "residual_channels": 4})
    with pytest.raises(ValueError, match="multiples of 8"):
        tdec.decode_cuda({}, ring, None, None, cfg=narrow, n_steps=3, n_streams=16)
    assert tdec.LAUNCHES == before
