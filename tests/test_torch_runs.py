"""The port's end-to-end runs (music_tpu_torch.runs) against the JAX
package's scripts (benchmarks/*): the corpus and spectrum helpers equal
theirs, the chord protocol's losses equal the JAX trainer's at TINY on the
same parameters and windows, and each run's ``main`` at a tiny size on the
CPU prints one JSON line with the JAX script's keys plus the card's."""

import json

import jax
import numpy as np
import optax
import torch

from benchmarks import wavenet_ae_quality_run as jae_run
from benchmarks import wavenet_poly_quality_run as jpoly
from music_tpu.data.audio import AudioWindows as JWindows
from music_tpu.data.audio import mu_law_encode_np as jencode
from music_tpu.models import wavenet as jwn
from music_tpu.parallel.mesh import MeshSpec, make_mesh
from music_tpu.train import wavenet_train as jtrain
from music_tpu_torch.data.audio import AudioWindows, mu_law_encode_np
from music_tpu_torch.generate.wavenet_generate import streams_weights
from music_tpu_torch.kernels import wavenet_decode, wavenet_decode_hbm
from music_tpu_torch.models import wavenet as twn
from music_tpu_torch.runs import cli_journey_run, wavenet_ae_quality_run, wavenet_poly_quality_run
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

CARD_KEYS = {"device", "card", "wall_s"}
POLY_KEYS = {"metric", "chord_hz", "corpus_peaks_hz", "generated_peaks_hz", "max_peak_error_hz",
             "fft_bin_hz", "chord_reproduced", "first_loss", "final_loss", "train_steps",
             "gen_rms", "corpus_rms", "wall_s", "backend"}
AE_KEYS = {"metric", "steps", "loss_first", "loss_last", "reconstructions",
           "bottleneck_conditions_decoder", "wall_s"}
JOURNEY_KEYS = {"metric", "workdir", "dataset_pieces", "train_steps_logged", "loss_first",
                "loss_last", "loss_min", "checkpoints", "generated_wavs", "generated_frames",
                "unique_codes_per_wav", "dominant_hz_per_wav", "ok", "wall_s"}


def _last_json(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_corpus_and_spectrum_helpers_equal_jax():
    ours, theirs = wavenet_poly_quality_run.make_chord_corpus(), jpoly.make_chord_corpus()
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    short = wavenet_poly_quality_run.make_chord_corpus(n_clips=2, secs=0.7, seed=3)
    for a, b in zip(short, jpoly.make_chord_corpus(n_clips=2, secs=0.7, seed=3)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(11)
    for audio in (ours[0][:20_000], rng.normal(size=9_000).astype(np.float32)):
        assert wavenet_poly_quality_run.spectrum_peaks(audio) == jpoly.spectrum_peaks(audio)
        assert (wavenet_poly_quality_run.spectrum_peaks(audio, 5, 100.0)
                == jpoly.spectrum_peaks(audio, 5, 100.0))
        assert (wavenet_ae_quality_run.dominant_freq(audio)
                == jae_run.dominant_freq(audio) == jae_run.dominant_freq(audio, 16000))
    assert wavenet_poly_quality_run.CHORD_HZ == jpoly.CHORD_HZ
    assert cli_journey_run.TONES_HZ == (220.0, 277.2, 330.0, 440.0)  # the JAX journey's tones


def test_chord_protocol_losses_equal_jax_at_tiny():
    """Three f32 steps of the chord protocol (Adam 1e-3, batches of 8 from
    ``default_rng(1)``) from the same parameters: JAX's trainer step on a
    1x1x1 mesh and the port's give the same losses within 1e-5."""
    cfg = wavenet_poly_quality_run.config("tiny")
    jcfg = jwn.WaveNetConfig(**{f: getattr(cfg, f) for f in (
        "filter_width", "dilations", "dilation_channels", "residual_channels",
        "skip_channels", "quantization_channels", "use_bias")})
    WL, B, q = 512, 8, cfg.quantization_channels
    clips = wavenet_poly_quality_run.make_chord_corpus(secs=0.6)
    codes = [mu_law_encode_np(c, q) for c in clips]
    for ours, c in zip(codes, clips):
        np.testing.assert_array_equal(ours, jencode(c, q))
    windows = AudioWindows(codes, cfg.receptive_field, WL)
    jwindows = JWindows(codes, receptive_field=cfg.receptive_field, window_length=WL)
    assert len(windows) == len(jwindows) > B

    params = jwn.init_params(jax.random.PRNGKey(0), jcfg)
    mesh = make_mesh(MeshSpec(data=1, seq=1, model=1), devices=jax.devices()[:1])
    tx = optax.adam(1e-3)
    state = jtrain.TrainState(params, tx.init(params), jax.numpy.zeros((), jax.numpy.int32))
    step_fn, _ = jtrain.make_train_step(jcfg, tx, mesh, WL)
    rng = np.random.default_rng(1)
    jlosses = []
    for _ in range(3):
        state, loss = step_fn(state, jax.numpy.asarray(jwindows.gather(
            rng.integers(0, len(jwindows), B))))
        jlosses.append(float(loss))

    tparams = twn.params_from_numpy({k: np.asarray(v) for k, v in params.items()}, cfg=cfg)
    _, losses = wavenet_poly_quality_run.train_chord(tparams, cfg, windows, steps=3, batch=B,
                                                     compute_dtype=None, log_every=1)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]


def test_scaled_config_routes_its_f32_decode_to_the_streaming_kernel():
    cpu = torch.device("cpu")
    scaled = wavenet_poly_quality_run.config("scaled")
    assert (scaled.residual_channels, scaled.dilation_channels, scaled.skip_channels,
            scaled.n_blocks, scaled.use_bias) == (64, 64, 1024, 40, False)
    assert streams_weights(1, cpu, wavenet_decode, wavenet_decode_hbm, scaled, torch.float32)
    assert not streams_weights(1, cpu, wavenet_decode, wavenet_decode_hbm,
                               wavenet_poly_quality_run.config("shipped"), torch.float32)


def test_poly_run_main_prints_jax_keys_on_the_cpu(capsys, tmp_path):
    code = wavenet_poly_quality_run.main([
        "--config", "tiny", "--steps", "3", "--window", "256", "--batch", "2",
        "--clip-secs", "0.5", "--decode-steps", "2200", "--out", str(tmp_path),
        "--device", "cpu"])
    out = _last_json(capsys)
    assert POLY_KEYS | CARD_KEYS <= set(out)
    assert (out["device"], out["card"], out["backend"]) == ("cpu", None, "cpu")
    assert out["tokens_tie_aware"]["n"] == 2200 and out["tokens_tie_aware"]["ok"]
    assert out["decode_kernel"] == "wavenet_decode" and out["native_data_path"]
    assert code == (0 if out["chord_reproduced"] else 1)
    assert (tmp_path / "chord_gen.wav").exists()


def test_ae_run_main_prints_jax_keys_on_the_cpu(capsys, tmp_path):
    code = wavenet_ae_quality_run.main([
        "--config", "tiny", "--steps", "2", "--window", "64", "--secs", "1",
        "--decode-samples", "512", "--out", str(tmp_path), "--device", "cpu"])
    out = _last_json(capsys)
    assert AE_KEYS | CARD_KEYS <= set(out)
    assert [r["source_hz"] for r in out["reconstructions"]] == [220.0, 330.0]
    assert code == (0 if out["bottleneck_conditions_decoder"] else 1)
    assert sorted(p.name for p in tmp_path.glob("*.wav")) == ["recon_220hz.wav",
                                                              "recon_330hz.wav"]


def test_cli_journey_runs_its_hops_on_the_cpu(capsys, tmp_path):
    """Every hop a subprocess of ``python -m music_tpu_torch``, at a tiny
    model: the dataset, rotating checkpoints, a falling loss, 4 wavs and
    the loss plot."""
    params = tmp_path / "tiny.json"
    params.write_text(json.dumps({
        "filter_width": 2, "quantization_channels": 256, "dilations": [1, 2, 4, 8],
        "residual_channels": 4, "dilation_channels": 4, "skip_channels": 8,
        "use_bias": False}))
    code = cli_journey_run.main([
        "--workdir", str(tmp_path / "w"), "--epochs", "4", "--duration", "0.05",
        "--wavenet-params", str(params), "--piece-secs", "1", "--window", "2000",
        "--print-every", "2", "--device", "cpu"])
    out = _last_json(capsys)
    assert JOURNEY_KEYS | CARD_KEYS <= set(out)
    assert code == 0 and out["ok"]
    assert out["dataset_pieces"] == 8 and out["generated_wavs"] == 4
    assert len(out["checkpoints"]) == 3  # 4 epochs saved, 3 kept
    assert out["loss_last"] < out["loss_first"]
    assert json.loads((tmp_path / "w" / "cli_journey.json").read_text()) == out
