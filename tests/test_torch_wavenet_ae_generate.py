"""The port's reconstruction entry points (music_tpu_torch.generate.
wavenet_ae_generate.generate / generate_batch and the ``wavenet-ae
generate`` CLI) held against music_tpu's generate and its fused decode
(the Pallas kernel in interpret mode on the CPU) on the same sources."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_tpu.data import wavio as jwavio
from music_tpu.data.audio import mu_law_encode_np
from music_tpu.generate import wavenet_ae_generate as jgen
from music_tpu.kernels import wavenet_ae_decode as jk
from music_tpu.models import wavenet_ae as jae
from music_tpu_torch.core import checkpoint as tckpt
from music_tpu_torch.data import wavio
from music_tpu_torch.generate import wavenet_ae_generate as tgen
from music_tpu_torch.models import wavenet_ae as tae
from music_tpu_torch.ops.mulaw import mu_law_decode, mu_law_encode
from music_tpu_torch.utils.parity import ae_teacher_forced_scores, tie_aware_check
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
TINY_JSON = dict(
    filter_width=2, dilations=[1, 2, 4, 8, 1, 2, 4, 8], en_residual_channel=8,
    en_dilation_channel=8, de_residual_channel=8, de_dilation_channel=8, de_skip_channel=16,
    en_bottleneck_width=12, en_pool_kernel_size=16, quantization_channel=32, use_bias=False,
)
JTINY = jae.WaveNetAEConfig.from_json(TINY_JSON)
TTINY = tae.WaveNetAEConfig.from_json(TINY_JSON)
PRIME_LEN = TTINY.receptive_field + max(TTINY.dilations)  # 40
SR = 1000
TOL = 1e-5  # float32 on both sides, sums in another order


@dataclasses.dataclass
class _TrainState:
    params: dict
    step: int


def _params(seed):
    jp = jae.init_params(jax.random.PRNGKey(seed), JTINY)
    return jp, tae.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, cfg=TTINY)


def _clips(seed, n, length):
    """Seeded sine mixtures ``[n, length]`` in [-0.9, 0.9]."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / SR
    out = []
    for _ in range(n):
        f, a, p = rng.uniform(5, 200, 3), rng.uniform(0.1, 0.3, 3), rng.uniform(0, 6.3, 3)
        out.append(sum(a[k] * np.sin(2 * np.pi * f[k] * t + p[k]) for k in range(3)))
    return np.stack(out).astype(np.float32)


def _codes_of(audio):
    """Invert the µ-law decode (every Q=32 level is distinct)."""
    levels = mu_law_decode(torch.arange(32), 32).numpy()
    return np.abs(np.asarray(audio)[..., None] - levels).argmin(-1).astype(np.int32)


def _check(tp, source, tokens, label, ref):
    """Tie-aware check (tolerance 1e-5) of the reconstruction ``tokens``
    against the plain f32 decoder teacher-forced on the absolute-time clock,
    primed with the first receptive_field + max(d) codes of ``source``;
    exact equality with the JAX tokens ``ref`` is printed."""
    codes = mu_law_encode(torch.from_numpy(source), 32)
    enc = tae.encode(tp, codes, TTINY)
    report = tie_aware_check(tokens, lambda t: ae_teacher_forced_scores(
        tp, enc, codes[:, :PRIME_LEN], torch.as_tensor(t), TTINY), TOL)
    assert report["ok"], report
    print(f"{label}: exact token equality with JAX {float((tokens == ref).mean()):.4f}", report)


def test_generate_matches_jax_generate(tmp_path):
    """One clip, written at 2 kHz and resampled to 1 kHz by both packages,
    from one checkpoint: the port's generate on the CPU against JAX
    generate (its Pallas kernel interpreted), 120 steps."""
    jp, tp = _params(0)
    tckpt.save(tmp_path / "ckpt", 3, _TrainState(params=tp, step=3))
    src = tmp_path / "src.wav"
    wavio.write_wav(src, _clips(0, 1, 240)[0], 2 * SR)
    kw = dict(checkpoint_dir=tmp_path / "ckpt", source_path=src, sr=SR)
    ref = jgen.generate(cfg=JTINY, out_path=tmp_path / "jax.wav", **kw)
    ours = tgen.generate(cfg=TTINY, out_path=tmp_path / "port.wav", device="cpu", **kw)
    assert ours.shape == ref.shape == (120,) and ours.dtype == np.float32
    wav, sr = wavio.read_wav(tmp_path / "port.wav")
    assert sr == SR and wav.shape == (120,)
    source = wavio.resample(*wavio.read_wav(src), SR)
    # the JAX package encodes on the host (native C++), the port in torch
    np.testing.assert_array_equal(mu_law_encode(torch.from_numpy(source), 32).numpy(),
                                  mu_law_encode_np(source, 32))
    _check(tp, source[None], _codes_of(ours)[None], "generate", _codes_of(ref)[None])


def test_generate_batch_matches_jax_fused(tmp_path):
    """Three clips through the port's generate_batch on the CPU against the
    JAX fused decode (interpret mode) on the same primes and encodings,
    90 steps (``duration``); one recon wav per clip."""
    jp, tp = _params(1)
    src = _clips(1, 3, 100)
    ours = tgen.generate_batch(cfg=TTINY, params=tp, source_audios=src, out_dir=tmp_path,
                               sr=SR, duration=0.09, device="cpu")
    assert ours.shape == (3, 90)
    for i in range(3):
        wav, _ = wavio.read_wav(tmp_path / f"recon_{i:03d}.wav")
        np.testing.assert_array_equal(_codes_of(wav), _codes_of(ours[i]))
    tokens = jnp.asarray(np.stack([mu_law_encode_np(r, 32) for r in src]))
    ref = np.asarray(jk.generate_tokens_fused(
        jp, jae.encode(jp, tokens, JTINY), tokens[:, :PRIME_LEN], cfg=JTINY, n_steps=90,
        interpret=True))
    _check(tp, src, _codes_of(ours), "generate_batch", ref)


def test_scan_backend_matches_jax_scan(tmp_path):
    """backend="scan": the plain step loop from a receptive_field prime,
    against JAX generate's scan backend, 30 steps."""
    jp, tp = _params(2)
    src = _clips(2, 1, 100)[0]
    kw = dict(source_audio=src, sr=SR, duration=0.03, backend="scan")
    ref = jgen.generate(cfg=JTINY, params=jp, out_path=tmp_path / "jax.wav", **kw)
    ours = tgen.generate(cfg=TTINY, params=tp, out_path=tmp_path / "port.wav", device="cpu",
                         **kw)
    assert ours.shape == (30,)
    codes = mu_law_encode(torch.from_numpy(src)[None], 32)
    enc = tae.encode(tp, codes, TTINY)
    want = tae.generate_tokens(tp, enc, codes[:, :TTINY.receptive_field], cfg=TTINY, n_steps=30)
    np.testing.assert_array_equal(_codes_of(ours), want[0].numpy())
    print("scan: exact token equality with JAX",
          float((_codes_of(ours) == _codes_of(ref)).mean()))
    # generate_batch takes the same backend; its first row is this clip
    batch = tgen.generate_batch(cfg=TTINY, params=tp, source_audios=np.stack([src, -src]),
                                sr=SR, duration=0.03, backend="scan", device="cpu")
    np.testing.assert_array_equal(_codes_of(batch[0]), want[0].numpy())


def test_fused_refuses_what_it_cannot_take(tmp_path):
    """Categorical sampling and sources shorter than the prime raise and
    name backend="scan"; nothing falls back."""
    _, tp = _params(3)
    kw = dict(cfg=TTINY, params=tp, out_path=tmp_path / "x.wav", sr=SR, device="cpu")
    with pytest.raises(ValueError, match="backend='scan'"):
        tgen.generate(source_audio=_clips(3, 1, 100)[0], sample_mode="categorical", **kw)
    with pytest.raises(ValueError, match="backend='scan'"):
        tgen.generate(source_audio=_clips(3, 1, PRIME_LEN - 1)[0], **kw)
    with pytest.raises(ValueError, match="backend"):
        tgen.generate(source_audio=_clips(3, 1, 100)[0], backend="pallas", **kw)
    with pytest.raises(ValueError, match=r"\[n, T\]"):
        tgen.generate_batch(cfg=TTINY, params=tp, source_audios=_clips(3, 1, 100)[0],
                            device="cpu")


def test_cli_file_and_directory_subprocess(tmp_path):
    """``wavenet-ae generate`` on a file and on a directory, ``--device
    cpu``, in a fresh process: the params JSON in the reference's
    missing-comma dialect is read, directory clips are resampled to 16 kHz
    and trimmed to the shortest, the wavs equal the library calls', and
    neither jax nor music_tpu is imported."""
    params_dir = tmp_path / "params"
    params_dir.mkdir()
    text = "{\n" + "\n".join(f'  "{k}": {json.dumps(v)}' for k, v in TINY_JSON.items()) + "\n}"
    with pytest.raises(json.JSONDecodeError):
        json.loads(text)
    (params_dir / "model_params.json").write_text(text)
    _, tp = _params(4)
    tckpt.save(tmp_path / "ckpt", 5, _TrainState(params=tp, step=5))
    clips = _clips(4, 2, 200)
    wavio.write_wav(tmp_path / "one.wav", clips[0][:80], 8000)
    (tmp_path / "dir").mkdir()
    wavio.write_wav(tmp_path / "dir" / "a.wav", clips[0][:80], 8000)  # 160 samples at 16 kHz
    wavio.write_wav(tmp_path / "dir" / "b.wav", clips[1], 16000)
    script = (
        "import sys\n"
        "from music_tpu_torch.cli import main\n"
        "common = ['generate', '--checkpoint', 'ckpt', '--params-dir', 'params',"
        " '--duration', '0.006', '--device', 'cpu']\n"
        "main(['wavenet-ae', *common, '--source', 'one.wav', '--out', 'rec.wav'])\n"
        "main(['wavenet-ae', *common, '--source', 'dir', '--out', 'many.wav'])\n"
        "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'music_tpu')))\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout
    one = wavio.read_wav(tmp_path / "rec.wav")[0]
    want = tgen.generate(cfg=TTINY, params=tp, source_path=tmp_path / "one.wav",
                         out_path=tmp_path / "lib.wav", duration=0.006, device="cpu")
    np.testing.assert_array_equal(_codes_of(one), _codes_of(want))
    rows = [wavio.resample(*wavio.read_wav(tmp_path / "dir" / n), 16000) for n in ("a.wav", "b.wav")]
    assert [len(r) for r in rows] == [160, 200]
    want = tgen.generate_batch(cfg=TTINY, params=tp, source_audios=np.stack([r[:160] for r in rows]),
                               duration=0.006, device="cpu")
    for i in range(2):
        got = wavio.read_wav(tmp_path / "many" / f"recon_{i:03d}.wav")[0]
        assert got.shape == (96,)
        np.testing.assert_array_equal(_codes_of(got), _codes_of(want[i]))
    # the JAX package reads the port's wavs as its own
    np.testing.assert_array_equal(jwavio.read_wav(tmp_path / "rec.wav")[0], one)


@pytest.mark.parametrize("widths,streaming", [
    ({}, False), (dict(de_residual_channel=64, de_dilation_channel=64, de_skip_channel=1024),
                  True)])
def test_routing_rule_shipped_and_scaled_decoder(monkeypatch, widths, streaming):
    """The rule as measured on the card (PERF.md, section 6): the resident
    kernel while its carve holds the tile with its helper warp.  The
    shipped AE decoder (5.08 MB of kernel weights in f32) stays resident at
    every count; the scaled one (19.1 MB), whose resident carve has 2
    stages even for one clip in f32, goes to the weight-streaming kernel at
    every count."""
    from types import SimpleNamespace

    from music_tpu_torch.core.config import load_params_dir
    from music_tpu_torch.generate.wavenet_generate import HELPER_STAGES, streams_weights
    from music_tpu_torch.kernels import wavenet_ae_decode, wavenet_ae_decode_hbm

    shipped = load_params_dir(REPO / "music_tpu_torch" / "params" / "wavenet_autoencoder")
    cfg = tae.WaveNetAEConfig.from_json({**shipped["model_params"], **widths})
    shapes = tae.param_shapes(cfg)
    nbytes = 4 * sum(int(np.prod(shapes[k])) for k in wavenet_ae_decode_hbm.DECODER_KEYS)
    assert nbytes == (19_136_512 if streaming else 5_079_040)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(multi_processor_count=132))
    cuda = torch.device("cuda")
    caps = (wavenet_ae_decode.max_streams(cfg, min_stages=HELPER_STAGES),
            wavenet_ae_decode_hbm.max_streams(cfg))
    assert caps == (0, 4) if streaming else caps[0] == 8
    for n in (1, 32, 264, 265, 3000):
        got = streams_weights(n, cuda, wavenet_ae_decode, wavenet_ae_decode_hbm, cfg,
                              torch.float32)
        assert got is streaming, n


@pytest.mark.parametrize("widths,streaming", [
    ({}, False), (dict(de_residual_channel=64, de_dilation_channel=64, de_skip_channel=1024),
                  True)])
def test_decode_routes_and_tiles_by_the_chosen_kernel(monkeypatch, widths, streaming):
    """The reconstruct path on a 132-SM card, 32 and 300 clips: the scaled
    decoder on the weight-streaming kernel, tiled by its max_streams (1 and
    4 a block), the shipped one on the resident kernel (1 and 4 a block)."""
    from types import SimpleNamespace

    from music_tpu_torch.core.config import load_params_dir
    from music_tpu_torch.kernels import wavenet_ae_decode, wavenet_ae_decode_hbm

    shipped = load_params_dir(REPO / "music_tpu_torch" / "params" / "wavenet_autoencoder")
    cfg = tae.WaveNetAEConfig.from_json({**shipped["model_params"], **widths})
    params = {k: torch.empty(shape, device="meta") for k, shape in tae.param_shapes(cfg).items()}
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(multi_processor_count=132))
    seen = []
    monkeypatch.setattr(wavenet_ae_decode, "generate_tokens_fused",
                        lambda *a, **k: seen.append(("resident", k["n_streams"])))
    monkeypatch.setattr(wavenet_ae_decode_hbm, "generate_tokens_fused_hbm",
                        lambda *a, **k: seen.append(("streaming", k["n_streams"])))
    prime_len = cfg.receptive_field + max(cfg.dilations)

    class Codes:  # what _decode reads of the source codes on a card
        def __init__(self, n):
            self.shape, self.device = (n, prime_len), torch.device("cuda")

        def __getitem__(self, index):
            return self

    for n in (32, 300):
        tgen._decode(params, None, Codes(n), cfg, 4, backend="fused", sample_mode="argmax",
                     seed=0, dtype=torch.float32)
    kernel = "streaming" if streaming else "resident"
    assert seen == [(kernel, 1), (kernel, 4)]


def test_generate_batch_on_streaming_kernel_matches_jax(monkeypatch):
    """With a resident carve that holds no stream, generate_batch decodes through the
    weight-streaming kernel's wrapper (and not the resident one's):
    tie-aware at 1e-5 on the plain f32 decoder; exact equality with the
    JAX weight-streaming kernel (interpret mode) printed."""
    from music_tpu.kernels import wavenet_ae_decode_hbm as jh
    from music_tpu_torch.generate import wavenet_generate
    from music_tpu_torch.kernels import wavenet_ae_decode, wavenet_ae_decode_hbm

    jp, tp = _params(6)
    src = _clips(6, 3, 100)
    calls = []
    streaming = wavenet_ae_decode_hbm.generate_tokens_fused_hbm
    monkeypatch.setattr(wavenet_ae_decode, "max_streams", lambda *a, **k: 0)
    monkeypatch.setattr(wavenet_ae_decode_hbm, "generate_tokens_fused_hbm",
                        lambda *a, **k: calls.append(k["n_streams"]) or streaming(*a, **k))
    monkeypatch.setattr(wavenet_ae_decode, "generate_tokens_fused",
                        lambda *a, **k: pytest.fail("the resident kernel was chosen"))
    ours = tgen.generate_batch(cfg=TTINY, params=tp, source_audios=src, sr=SR, duration=0.08,
                               device="cpu")
    assert calls == [3] and ours.shape == (3, 80)
    tokens = jnp.asarray(np.stack([mu_law_encode_np(r, 32) for r in src]))
    ref = np.asarray(jh.generate_tokens_fused_hbm(
        jp, jae.encode(jp, tokens, JTINY), tokens[:, :PRIME_LEN], cfg=JTINY, n_steps=80,
        interpret=True))
    _check(tp, src, _codes_of(ours), "generate_batch on the streaming kernel", ref)
