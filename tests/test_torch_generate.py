"""The port's generation entry points (music_tpu_torch.generate.
wavenet_generate.generate / generate_batch and the CLI) held against
music_tpu.models.wavenet.generate_tokens from the same silence prime."""

import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_tpu.data import wavio
from music_tpu.models import wavenet as jwn
from music_tpu_torch.core import checkpoint as tckpt
from music_tpu_torch.generate import wavenet_generate as tgen
from music_tpu_torch.models import wavenet as twn
from music_tpu_torch.ops.mulaw import mu_law_decode
from music_tpu_torch.utils.parity import teacher_forced_scores, tie_aware_check

REPO = Path(__file__).resolve().parents[1]
TINY_JSON = dict(
    filter_width=2, dilations=[1, 2, 4, 8, 1, 2, 4, 8], dilation_channels=8,
    residual_channels=8, skip_channels=16, quantization_channels=32, use_bias=False,
)
JTINY = jwn.WaveNetConfig.from_json(TINY_JSON)
TTINY = twn.WaveNetConfig.from_json(TINY_JSON)
PRIME_LEN = TTINY.receptive_field + max(TTINY.dilations)
SR, DURATION = 1000, 0.12  # 120 samples


def _params(seed=0):
    jp = jwn.init_params(jax.random.PRNGKey(seed), JTINY)
    return jp, twn.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, cfg=TTINY)


def _codes_of(audio):
    """Invert the µ-law decode (every Q=32 level is distinct)."""
    levels = mu_law_decode(torch.arange(32), 32).numpy()
    codes = np.abs(np.asarray(audio)[..., None] - levels).argmin(-1)
    np.testing.assert_array_equal(levels[codes], audio)
    return codes


def _check_against_jax(jp, codes):
    """Tie-aware check (tolerance 1e-5: float32 order differences) of the
    port's codes against the JAX model teacher-forced from the silence
    prime; exact equality with JAX generate_tokens is reported."""
    n = codes.shape[0]
    prime = np.full((n, PRIME_LEN), 16, np.int32)
    fwd = jax.jit(functools.partial(jwn.forward, cfg=JTINY))

    def logits_fn(tokens):
        seq = np.concatenate([prime, np.asarray(tokens)[:, :-1]], axis=1)
        return np.asarray(fwd(jp, jnp.asarray(seq[:, PRIME_LEN - JTINY.receptive_field:])))

    report = tie_aware_check(codes, logits_fn, tol=1e-5)
    assert report["ok"], report
    ref = np.asarray(jwn.generate_tokens(
        jp, jnp.asarray(prime), jax.random.PRNGKey(0), cfg=JTINY,
        n_steps=codes.shape[1], prime_len=PRIME_LEN))
    print("exact equality with JAX generate_tokens:", (codes == ref).mean(), report)


def test_generate_cpu_writes_wav(tmp_path):
    jp, tp = _params(0)
    out = tmp_path / "one.wav"
    audio = tgen.generate(cfg=TTINY, params=tp, out_path=out, sr=SR, duration=DURATION,
                          device="cpu")
    wav, sr = wavio.read_wav(out)
    assert sr == SR and wav.shape == audio.shape == (int(DURATION * SR),)
    _check_against_jax(jp, _codes_of(audio)[None])


def test_generate_batch_cpu_writes_wavs(tmp_path):
    jp, tp = _params(1)
    audio = tgen.generate_batch(cfg=TTINY, params=tp, n=3, out_dir=tmp_path, sr=SR,
                                duration=DURATION, sample_mode="argmax",
                                dtype=torch.float32, device="cpu")
    assert audio.shape == (3, int(DURATION * SR))
    for i in range(3):
        wav, _ = wavio.read_wav(tmp_path / f"gen_{i:03d}.wav")
        assert wav.shape == (int(DURATION * SR),)
    _check_against_jax(jp, _codes_of(audio))


def test_generate_batch_categorical_bf16_cpu(tmp_path):
    """Serving defaults (categorical, bf16): streams are distinct and every
    code is the argmax of the f32 teacher-forced scores carrying the same
    Philox noise, within the bf16 tolerance 2e-3 (measured bound, see
    test_torch_wavenet_decode.test_bf16_plain_vs_f32_plain)."""
    _, tp = _params(2)
    audio = tgen.generate_batch(cfg=TTINY, params=tp, n=3, sr=SR, duration=DURATION,
                                seed=7, device="cpu")
    codes = torch.from_numpy(_codes_of(audio))
    assert len({tuple(r) for r in codes.tolist()}) == 3
    prime = torch.full((3, PRIME_LEN), 16, dtype=torch.int32)
    report = tie_aware_check(codes, lambda t: teacher_forced_scores(
        tp, prime, t, TTINY, sample_mode="categorical", seed=7), tol=2e-3)
    assert report["ok"], report


def test_generate_short_prime_cpu_plain_loop(tmp_path):
    """A start_piece shorter than receptive_field + max dilation goes
    through the plain step loop on the CPU, as the JAX generate() sends it
    to its scan: tie-aware (tolerance 1e-5, float32 order differences) on
    the JAX decode_step's teacher-forced logits from the same prime."""
    jp, tp = _params(4)
    prime = np.random.default_rng(4).integers(0, 32, 10).astype(np.int32)
    audio = tgen.generate(cfg=TTINY, params=tp, out_path=tmp_path / "short.wav",
                          start_piece=prime, sr=SR, duration=DURATION, device="cpu")
    codes = _codes_of(audio)[None]
    step = jax.jit(functools.partial(jwn.decode_step, cfg=JTINY))

    def logits_fn(tokens):
        seq = np.concatenate([prime, np.asarray(tokens)[0, :-1]])
        cache, out = jwn.init_cache(JTINY, 1), []
        for i, tok in enumerate(seq):
            cache, logits = step(jp, cache, jnp.asarray([tok]))
            if i >= len(prime) - 1:
                out.append(np.asarray(logits[0]))
        return np.stack(out)[None]

    report = tie_aware_check(codes, logits_fn, tol=1e-5)
    assert report["ok"] and report["n"] == int(DURATION * SR), report


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tp = _params(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgen.generate(cfg=TTINY, params=tp, out_path=tmp_path / "x.wav", sr=SR,
                      duration=DURATION, device="cuda")
    assert tgen.stream_tiling(5, torch.device("cpu")) == (5, 1)


@dataclasses.dataclass
class _TrainState:
    params: dict
    step: int


def test_cli_subprocess_imports_no_jax(tmp_path):
    """The CLI on a TINY checkpoint, in a fresh process (this one has jax):
    it writes the wavs and leaves jax out of sys.modules."""
    params_dir = tmp_path / "params"
    params_dir.mkdir()
    (params_dir / "wavenet_params.json").write_text(json.dumps(TINY_JSON))
    _, tp = _params(3)
    tckpt.save(tmp_path / "ckpt", 5, _TrainState(params=tp, step=5))
    script = (
        "import sys\n"
        "import music_tpu_torch\n"
        "from music_tpu_torch.cli import main\n"
        "common = ['--checkpoint', 'ckpt', '--params-dir', 'params', '--duration', '0.004',"
        " '--device', 'cpu']\n"
        "main(['wavenet', 'generate', '--out', 'one.wav'] + common)\n"
        "main(['wavenet', 'generate', '--out', 'many.wav', '--num', '2',"
        " '--sample-mode', 'categorical'] + common)\n"
        "print('JAX_LOADED', 'jax' in sys.modules)\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_LOADED False" in proc.stdout
    assert wavio.read_wav(tmp_path / "one.wav")[0].shape == (64,)
    for i in range(2):
        assert wavio.read_wav(tmp_path / "many" / f"gen_{i:03d}.wav")[0].shape == (64,)


WIDE_JSON = dict(TINY_JSON, dilations=[1, 2] * 9, residual_channels=16)


def _card(monkeypatch, sms=132):
    """A CUDA device of ``sms`` SMs as far as stream_tiling asks."""
    from types import SimpleNamespace

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(multi_processor_count=sms))
    return torch.device("cuda")


@pytest.mark.parametrize("widths,streaming", [
    ({}, False), (dict(residual_channels=64, dilation_channels=64, skip_channels=1024), True)])
def test_routing_rule_shipped_and_scaled(monkeypatch, widths, streaming):
    """The rule as measured on the card (PERF.md, section 6): the resident
    kernel while its carve holds the tile with its helper warp (3 stages),
    else the weight-streaming kernel if its carve holds more.  The shipped
    model (5.08 MB of f32 weights) stays resident at every count; the
    4.4x-scaled one (19.1 MB) goes to the weight-streaming kernel in f32 at
    every count (the resident carve has 2 stages even for one stream) and
    stays resident in bf16 (4 streams a block with 3 or more stages, the
    weight-streaming kernel's most)."""
    from music_tpu_torch.core.config import load_params_dir
    from music_tpu_torch.kernels import wavenet_decode, wavenet_decode_hbm

    shipped = load_params_dir(REPO / "music_tpu_torch" / "params" / "wavenet")["wavenet_params"]
    cfg = twn.WaveNetConfig.from_json({**shipped, **widths})
    nbytes = 4 * sum(int(np.prod(s)) for s in twn.param_shapes(cfg).values())
    assert nbytes == (19_136_512 if streaming else 5_079_040)
    cuda = _card(monkeypatch)
    for dtype in (torch.float32, torch.bfloat16):
        caps = (wavenet_decode.max_streams(cfg, dtype, min_stages=tgen.HELPER_STAGES),
                wavenet_decode_hbm.max_streams(cfg, dtype))
        if streaming:
            assert caps == ((0, 4) if dtype == torch.float32 else (4, 4))
        want = streaming and dtype == torch.float32
        for device, counts in ((cuda, (1, 32, 264, 265, 529, 3000)), (torch.device("cpu"), (1,))):
            for n in counts:
                got = tgen.streams_weights(n, device, wavenet_decode, wavenet_decode_hbm, cfg,
                                           dtype)
                assert got is want, (dtype, device, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths,streaming", [
    ({}, False), (dict(residual_channels=64, dilation_channels=64, skip_channels=1024), True)])
def test_fused_decode_routes_and_tiles_by_the_chosen_kernel(monkeypatch, widths, streaming,
                                                             dtype):
    """The generate path on a 132-SM card, 32 and 600 streams: the scaled
    model in f32 on the weight-streaming kernel, tiled by its max_streams
    (1 and 4 a block); the scaled model in bf16 and the shipped one on the
    resident kernel, tiled by its own (scaled bf16: 1 and 4; shipped: 1
    and 8)."""
    from types import SimpleNamespace

    from music_tpu_torch.core.config import load_params_dir
    from music_tpu_torch.kernels import wavenet_decode, wavenet_decode_hbm

    shipped = load_params_dir(REPO / "music_tpu_torch" / "params" / "wavenet")["wavenet_params"]
    cfg = twn.WaveNetConfig.from_json({**shipped, **widths})
    params = {k: torch.empty(shape, device="meta") for k, shape in twn.param_shapes(cfg).items()}
    cuda = _card(monkeypatch)
    seen = []
    monkeypatch.setattr(wavenet_decode, "generate_tokens_fused",
                        lambda *a, **k: seen.append(("resident", k["n_streams"])))
    monkeypatch.setattr(wavenet_decode_hbm, "generate_tokens_fused_hbm",
                        lambda *a, **k: seen.append(("streaming", k["n_streams"])))
    for n in (32, 600):
        prime = SimpleNamespace(shape=(n, 5), device=cuda)
        tgen._fused_decode(params, prime, cfg, 4, dtype, "argmax", 1.0, 0)
    kernel = "streaming" if streaming and dtype == torch.float32 else "resident"
    assert seen == [(kernel, 1), (kernel, 4 if streaming else 8)]


def test_generate_on_streaming_kernel_matches_jax_generate(tmp_path, monkeypatch):
    """With a resident carve that holds no stream the port's generate() on
    the wide config decodes through the weight-streaming kernel's wrapper
    (and not the resident one's), as JAX's generate() takes its HBM kernel
    on this config: tie-aware at 1e-5 on the JAX model; exact equality
    printed."""
    from music_tpu.generate import wavenet_generate as jgen
    from music_tpu_torch.kernels import wavenet_decode, wavenet_decode_hbm

    jcfg, tcfg = jwn.WaveNetConfig.from_json(WIDE_JSON), twn.WaveNetConfig.from_json(WIDE_JSON)
    jp = jwn.init_params(jax.random.PRNGKey(11), jcfg)
    tp = twn.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, cfg=tcfg)
    calls = []
    streaming = wavenet_decode_hbm.generate_tokens_fused_hbm
    monkeypatch.setattr(wavenet_decode, "max_streams", lambda *a, **k: 0)
    monkeypatch.setattr(wavenet_decode_hbm, "generate_tokens_fused_hbm",
                        lambda *a, **k: calls.append(k["n_streams"]) or streaming(*a, **k))
    monkeypatch.setattr(wavenet_decode, "generate_tokens_fused",
                        lambda *a, **k: pytest.fail("the resident kernel was chosen"))
    ours = tgen.generate(cfg=tcfg, params=tp, out_path=tmp_path / "port.wav", sr=SR,
                         duration=0.04, device="cpu")
    ref = jgen.generate(cfg=jcfg, params=jp, out_path=tmp_path / "jax.wav", sr=SR,
                        duration=0.04)
    assert calls == [1] and ours.shape == ref.shape == (40,)
    P = tcfg.receptive_field + max(tcfg.dilations)
    prime = np.full((1, P), 16, np.int32)
    fwd = jax.jit(functools.partial(jwn.forward, cfg=jcfg))

    def logits_fn(tokens):
        seq = np.concatenate([prime, np.asarray(tokens)[:, :-1]], axis=1)
        return np.asarray(fwd(jp, jnp.asarray(seq[:, P - jcfg.receptive_field:])))

    codes = _codes_of(ours)[None]
    report = tie_aware_check(codes, logits_fn, tol=1e-5)
    assert report["ok"], report
    print("exact equality with JAX generate:", (codes == _codes_of(ref)[None]).mean(), report)


def test_scan_backend(tmp_path):
    """backend="scan" runs the plain step loop on the requested device for
    generate and generate_batch (the same tokens as models.wavenet.
    generate_tokens); a short start_piece on a device other than the CPU
    is refused with a message naming backend='scan'; an unknown backend
    raises."""
    _, tp = _params(5)
    prime = np.full((1, PRIME_LEN), 16, np.int32)
    want = twn.generate_tokens(tp, torch.from_numpy(prime), torch.Generator().manual_seed(0),
                               cfg=TTINY, n_steps=int(DURATION * SR), prime_len=PRIME_LEN)
    one = tgen.generate(cfg=TTINY, params=tp, out_path=tmp_path / "s.wav", sr=SR,
                        duration=DURATION, backend="scan", device="cpu")
    np.testing.assert_array_equal(_codes_of(one), want[0].numpy())
    many = tgen.generate_batch(cfg=TTINY, params=tp, n=2, sr=SR, duration=DURATION,
                               sample_mode="argmax", backend="scan", device="cpu")
    np.testing.assert_array_equal(_codes_of(many[1]), want[0].numpy())
    with pytest.raises(ValueError, match="backend='scan'"):
        tgen.generate(cfg=TTINY, params=tp, out_path=tmp_path / "x.wav", sr=SR,
                      duration=DURATION, start_piece=prime[0, :10], device="meta")
    with pytest.raises(ValueError, match="backend"):
        tgen.generate(cfg=TTINY, params=tp, out_path=tmp_path / "x.wav", sr=SR,
                      duration=DURATION, backend="pallas", device="cpu")
