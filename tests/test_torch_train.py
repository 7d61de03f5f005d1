"""The port's trainers and their data and core modules against the JAX
package's, at TINY configs on the CPU: the dataset build and the µ-law
pickle, the training windows and their order, the loss trajectory of
``train()`` resumed from one JAX checkpoint, checkpoints crossing packages
in both directions, the text logs, and the refusals."""

import json
import pickle
import shutil
import threading
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_tpu.core import checkpoint as jck
from music_tpu.core.metrics import MetricsLogger as JMetricsLogger
from music_tpu.core.optim import from_config as jfrom_config
from music_tpu.data import audio as jaudio
from music_tpu.generate import wavenet_generate as jgen
from music_tpu.models import wavenet as jwn
from music_tpu.models import wavenet_ae as jae
from music_tpu.train import wavenet_ae_train as jaetrain
from music_tpu.train import wavenet_train as jtrain
from music_tpu_torch import cli
from music_tpu_torch.core import checkpoint as tck
from music_tpu_torch.core.metrics import MetricsLogger
from music_tpu_torch.core.prng import KeySeq
from music_tpu_torch.data import audio as taudio
from music_tpu_torch.data.prefetch import PrefetchBatches
from music_tpu_torch.generate import wavenet_generate as tgen
from music_tpu_torch.models import wavenet as twn
from music_tpu_torch.train import wavenet_ae_train as taetrain
from music_tpu_torch.train import wavenet_train as ttrain

# losses are O(3.5) means over 8 x 32 positions; the JAX run reduces its
# batch over 8 CPU devices, in another order than the port's one mean
LOSS_RTOL = 1e-4
# after 8 Adam steps of lr 1e-3 from the same weights (measured: <= 3e-8)
PARAM_ATOL = 1e-6

TINY_WN = {"filter_width": 2, "dilations": [1, 2, 4, 8], "dilation_channels": 4,
           "residual_channels": 4, "skip_channels": 8, "quantization_channels": 32,
           "use_bias": False}
TINY_AE = {"filter_width": 2, "dilations": [1, 2, 4, 8], "en_residual_channel": 4,
           "en_dilation_channel": 4, "de_residual_channel": 4, "de_dilation_channel": 4,
           "de_skip_channel": 8, "en_bottleneck_width": 6, "en_pool_kernel_size": 4,
           "quantization_channel": 32}


def _pickle_clips(path, n_clips=3, length=400, q=32, seed=0):
    rng = np.random.default_rng(seed)
    clips = [rng.integers(0, q, (length,)).astype(np.int32) for _ in range(n_clips)]
    with open(path, "wb") as f:
        pickle.dump(clips, f)
    return path


def _losses(log_dir):
    return [json.loads(line)["loss"] for line in (log_dir / "metrics.jsonl").open()
            if '"kind": "loss"' in line]


def _jax_step0(path, cfg_json, train_params, family="wavenet"):
    """A JAX TrainState at step 0 (params from a PRNG key, fresh optimizer
    state) saved as ``path/step_0``, and its copy for the port."""
    tx = jfrom_config(train_params)
    if family == "wavenet":
        state = jtrain.init_state(jax.random.PRNGKey(3), jwn.WaveNetConfig.from_json(cfg_json), tx)
    else:
        params = jae.init_params(jax.random.PRNGKey(3), jae.WaveNetAEConfig.from_json(cfg_json))
        state = jtrain.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    jck.save(path / "jax", 0, state)
    shutil.copytree(path / "jax", path / "torch")
    return state


def _assert_same_run(tmp_path, jstate, tstate):
    lj, lt = _losses(tmp_path / "logs_jax"), _losses(tmp_path / "logs_torch")
    assert len(lj) == len(lt) > 0
    np.testing.assert_allclose(lt, lj, rtol=LOSS_RTOL)
    assert int(tstate.step) == int(jstate.step)
    for k, v in jstate.params.items():
        np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(v), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def _run(train_fn, tmp_path, which, **kw):
    tp = dict(kw.pop("train_params"), log_dir=str(tmp_path / f"logs_{which}"),
              restore_dir=str(tmp_path / which))
    if which == "torch":
        kw["device"] = "cpu"
    return train_fn(train_params=tp, **kw)


def test_wavenet_train_matches_jax_from_one_checkpoint(tmp_path):
    """JAX's and the port's train() resume from copies of one step-0 JAX
    checkpoint on one pickle: every logged loss within LOSS_RTOL, the final
    params within PARAM_ATOL, the same text log and checkpoint layout."""
    ds = {"audio_path": str(_pickle_clips(tmp_path / "np_audio.pkl")), "window_length": 32,
          "batch_size": 8}
    tp = {"optimizer": "adam", "learning_rate": 1e-3, "num_epochs": 2, "print_every": 2,
          "seed": 0, "max_check_points": 1}
    _jax_step0(tmp_path, TINY_WN, tp)
    js = _run(jtrain.train, tmp_path, "jax", wavenet_params=TINY_WN, dataset_params=ds,
              train_params=tp)
    ts = _run(ttrain.train, tmp_path, "torch", wavenet_params=TINY_WN, dataset_params=ds,
              train_params=tp)
    _assert_same_run(tmp_path, js, ts)

    # the text log: same lines, tokens and steps (losses to LOSS_RTOL)
    lines = [(tmp_path / f"logs_{w}" / "loss_log.log").read_text().splitlines()
             for w in ("jax", "torch")]
    assert len(lines[0]) == len(lines[1]) == 4
    for a, b in zip(*lines):
        assert a.rsplit(" ", 1)[0] == b.rsplit(" ", 1)[0]
        assert float(b.rsplit(" ", 1)[1]) == pytest.approx(float(a.rsplit(" ", 1)[1]),
                                                           rel=LOSS_RTOL)
    assert (MetricsLogger(tmp_path / "logs_torch").last_step()
            == JMetricsLogger(tmp_path / "logs_jax").last_step() == 8)
    # rotation kept one checkpoint each, with the same leaves
    assert tck.all_steps(tmp_path / "torch") == jck.all_steps(tmp_path / "jax") == [8]
    manifests = [json.loads((tmp_path / w / "step_8" / "manifest.json").read_text())
                 for w in ("jax", "torch")]
    assert ([(l["path"], l["dtype"]) for l in manifests[0]["leaves"]]
            == [(l["path"], l["dtype"]) for l in manifests[1]["leaves"]])


def test_checkpoints_cross_packages_mid_run(tmp_path):
    """A JAX checkpoint taken mid-run (params and Adam state) resumes in the
    port as it does in JAX; the port's checkpoint loads in JAX's restore
    and decodes in JAX's generate."""
    ds = {"audio_path": str(_pickle_clips(tmp_path / "np_audio.pkl")), "window_length": 32,
          "batch_size": 8}
    tp = {"optimizer": "adam", "learning_rate": 1e-3, "num_epochs": 1, "print_every": 1,
          "seed": 0}
    _run(jtrain.train, tmp_path, "jax", wavenet_params=TINY_WN, dataset_params=ds,
         train_params=tp)
    shutil.copytree(tmp_path / "jax", tmp_path / "torch")
    shutil.copytree(tmp_path / "logs_jax", tmp_path / "logs_torch")
    tp = dict(tp, seed=1)
    js = _run(jtrain.train, tmp_path, "jax", wavenet_params=TINY_WN, dataset_params=ds,
              train_params=tp)
    ts = _run(ttrain.train, tmp_path, "torch", wavenet_params=TINY_WN, dataset_params=ds,
              train_params=tp)
    assert int(ts.step) == 8 and float(ts.opt_state[0].count) == 8
    _assert_same_run(tmp_path, js, ts)

    cfg = jwn.WaveNetConfig.from_json(TINY_WN)
    example = jtrain.init_state(jax.random.PRNGKey(0), cfg, jfrom_config(tp))
    restored = jck.restore(tmp_path / "torch", example)
    assert int(restored.step) == 8
    np.testing.assert_array_equal(np.asarray(restored.opt_state[0].mu["fg"]),
                                  ts.opt_state[0].mu["fg"].numpy())
    n = 48
    jaudio_ = jgen.generate(cfg=cfg, checkpoint_dir=tmp_path / "torch",
                            out_path=tmp_path / "jax.wav", duration=n / 16000, backend="scan")
    taudio_ = tgen.generate(cfg=twn.WaveNetConfig.from_json(TINY_WN),
                            checkpoint_dir=tmp_path / "torch", out_path=tmp_path / "torch.wav",
                            duration=n / 16000, backend="scan", device="cpu")
    assert jaudio_.shape == taudio_.shape == (n,)
    with wave.open(str(tmp_path / "jax.wav")) as f:
        assert f.getnframes() == n


def test_wavenet_ae_train_matches_jax_from_one_checkpoint(tmp_path):
    ds = {"audio_path": str(_pickle_clips(tmp_path / "np_audio.pkl", length=300)),
          "window_length": 24, "batch_size": 8}
    tp = {"optimizer": "adam", "learning_rate": 1e-3, "num_epochs": 2, "print_every": 1,
          "seed": 0}
    _jax_step0(tmp_path, TINY_AE, tp, family="ae")
    js = _run(jaetrain.train, tmp_path, "jax", model_params=TINY_AE, dataset_params=ds,
              train_params=tp)
    ts = _run(taetrain.train, tmp_path, "torch", model_params=TINY_AE, dataset_params=ds,
              train_params=tp)
    _assert_same_run(tmp_path, js, ts)


def test_bf16_compute_dtype_tracks_jax(tmp_path):
    """``compute_dtype: bfloat16`` casts the params inside the loss on both
    sides; bf16 rounding differs between XLA and torch, so the losses are
    held to 1e-2 (bf16 has 8 bits of mantissa)."""
    ds = {"audio_path": str(_pickle_clips(tmp_path / "np_audio.pkl")), "window_length": 32,
          "batch_size": 8}
    tp = {"optimizer": "adam", "learning_rate": 1e-3, "num_epochs": 1, "print_every": 1,
          "seed": 0, "compute_dtype": "bfloat16"}
    _jax_step0(tmp_path, TINY_WN, tp)
    _run(jtrain.train, tmp_path, "jax", wavenet_params=TINY_WN, dataset_params=ds,
         train_params=tp)
    ts = _run(ttrain.train, tmp_path, "torch", wavenet_params=TINY_WN, dataset_params=ds,
              train_params=tp)
    np.testing.assert_allclose(_losses(tmp_path / "logs_torch"), _losses(tmp_path / "logs_jax"),
                               rtol=1e-2)
    assert ts.params["fg"].dtype == torch.float32  # the master weights stay f32


def test_filter_width_3_trains(tmp_path):
    """A filter width the decode kernels refuse still trains, as in JAX: the
    port's fused-taps loss equals JAX's loss and its one-hot forward."""
    cfg_json = dict(TINY_WN, filter_width=3)
    jcfg, tcfg = jwn.WaveNetConfig.from_json(cfg_json), twn.WaveNetConfig.from_json(cfg_json)
    params = jwn.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = twn.params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    tokens = np.random.default_rng(0).integers(0, 32, (2, tcfg.receptive_field + 20))
    want = float(jax.jit(jwn.loss_fn, static_argnums=2)(params, jnp.asarray(tokens), jcfg))
    got = float(twn.loss_fn(tparams, torch.from_numpy(tokens), tcfg, fuse_taps=True))
    assert got == pytest.approx(want, rel=1e-5)
    onehot = np.eye(32, dtype=np.float32)[tokens]
    np.testing.assert_allclose(
        twn.forward_onehot(tparams, torch.from_numpy(onehot), tcfg).numpy(),
        np.asarray(jax.jit(jwn.forward_onehot, static_argnums=2)(params, jnp.asarray(onehot),
                                                                 jcfg)), atol=1e-5)
    ds = {"audio_path": str(_pickle_clips(tmp_path / "np_audio.pkl")), "window_length": 32,
          "batch_size": 8}
    state = ttrain.train(wavenet_params=cfg_json, dataset_params=ds, device="cpu",
                         train_params={"num_epochs": 1, "restore_dir": str(tmp_path / "c"),
                                       "log_dir": str(tmp_path / "l")})
    assert int(state.step) > 0


def test_train_refusals(tmp_path):
    """Out-of-range codes raise before any step; multi-process raises and
    names ROADMAP; without ``device`` (or ``--device``) training asks for
    CUDA and raises on a host without it."""
    ds = {"audio_path": str(_pickle_clips(tmp_path / "np_audio.pkl", q=256)),
          "window_length": 32, "batch_size": 8}
    tp = {"log_dir": str(tmp_path / "logs"), "restore_dir": str(tmp_path / "ckpt")}
    with pytest.raises(ValueError, match="quantization_channels=32"):
        ttrain.train(wavenet_params=TINY_WN, dataset_params=ds, train_params=tp, device="cpu")
    with pytest.raises(ValueError, match="quantization_channels=32"):
        taetrain.train(model_params=TINY_AE, dataset_params=ds, train_params=tp, device="cpu")
    assert not (tmp_path / "ckpt").exists()
    with pytest.raises(NotImplementedError, match="A11"):
        ttrain.train(wavenet_params=TINY_WN, dataset_params=ds, device="cpu",
                     train_params=dict(tp, coordinator="localhost:1234", num_processes=2))
    if torch.cuda.is_available():
        return
    for call in (lambda: ttrain.train(wavenet_params=TINY_WN, dataset_params=ds, train_params=tp),
                 lambda: taetrain.train(model_params=TINY_AE, dataset_params=ds,
                                        train_params=tp),
                 lambda: cli.main(["wavenet", "train"]),
                 lambda: cli.main(["wavenet-ae", "train"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def _write_songs(audio_dir, sr, n=3):
    rng = np.random.default_rng(5)
    for i in range(n):
        t = np.arange(int((1.3 + i) * sr)) / sr
        song = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 900) * t) * (t > 0.2)
        jaudio.wavio.write_wav(audio_dir / f"song_{i}.wav", song.astype(np.float32), sr)


@pytest.mark.parametrize("silence_threshold", [None, 0.01])
def test_dataset_build_and_pickle_match_jax(tmp_path, silence_threshold):
    """build_dataset writes the JAX package's pieces byte for byte (with and
    without silence trimming), wavs_to_pickle its codes array for array,
    and the CLI's ``dataset build-audio`` does both."""
    songs = tmp_path / "songs"
    _write_songs(songs, 8000)
    kw = dict(duration=1, sample_rate=16000, silence_threshold=silence_threshold)
    jp = jaudio.build_dataset(songs, tmp_path / "jax", **kw)
    tp = taudio.build_dataset(songs, tmp_path / "torch", **kw)
    assert [p.name for p in tp] == [p.name for p in jp] and len(tp) >= 3
    for a, b in zip(jp, tp):
        assert a.read_bytes() == b.read_bytes()
    for q in (256, 32):
        jaudio.wavs_to_pickle(tmp_path / "jax", tmp_path / f"j{q}.pkl", q)
        taudio.wavs_to_pickle(tmp_path / "torch", tmp_path / f"t{q}.pkl", q)
        ja, ta = (pickle.loads((tmp_path / f"{w}{q}.pkl").read_bytes()) for w in "jt")
        assert len(ja) == len(ta)
        for a, b in zip(ja, ta):
            assert b.dtype == np.int32
            np.testing.assert_array_equal(b, a)
    if silence_threshold is None:
        cli.main(["dataset", "build-audio", "--audio-dir", str(songs), "--out-dir",
                  str(tmp_path / "cli"), "--duration", "1"])
        ours = pickle.loads((tmp_path / "cli" / "np_audio.pkl").read_bytes())
        theirs = pickle.loads((tmp_path / "j256.pkl").read_bytes())
        for a, b in zip(theirs, ours):
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("shuffle", [True, False])
def test_audio_windows_yield_jax_windows_in_jax_order(tmp_path, shuffle):
    rng = np.random.default_rng(3)
    clips = [rng.integers(0, 256, n).astype(np.int32) for n in (500, 37, 260, 333)]
    jw, tw = jaudio.AudioWindows(clips, 20, 16), taudio.AudioWindows(clips, 20, 16)
    np.testing.assert_array_equal(tw.starts, jw.starts)
    assert len(tw) == len(jw) > 0 and tw.max_code == jw.max_code
    for drop in (True, False):
        kw = dict(shuffle=shuffle, seed=7, drop_remainder=drop, epochs=2)
        ours, theirs = list(tw.batches(5, **kw)), list(jw.batches(5, **kw))
        assert len(ours) == len(theirs)
        for a, b in zip(theirs, ours):
            np.testing.assert_array_equal(b, a)


def test_metrics_logs_match_jax(tmp_path):
    ours, theirs = MetricsLogger(tmp_path / "t", echo=False), JMetricsLogger(tmp_path / "j",
                                                                            echo=False)
    assert ours.last_step() == theirs.last_step() == 0
    for step, loss in ((100, 5.25), (200, np.float32(4.125)), (300, 3.0)):
        ours.log_loss(0, step, loss)
        theirs.log_loss(0, step, loss)
    assert ((tmp_path / "t" / "loss_log.log").read_bytes()
            == (tmp_path / "j" / "loss_log.log").read_bytes())
    assert ours.last_step() == theirs.last_step() == 300


def test_prefetch_keeps_order_and_reraises():
    assert list(PrefetchBatches(range(50), depth=3)) == list(range(50))

    def failing():
        yield 1
        raise OSError("disk gone")

    it = PrefetchBatches(failing())
    assert next(it) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    stopped = PrefetchBatches(iter(range(10**6)), depth=1)
    next(stopped)
    stopped.close()
    stopped._thread.join(timeout=5)
    assert not stopped._thread.is_alive()
    assert threading.active_count() >= 1


def test_keyseq_is_reproducible():
    a, b = KeySeq(5), KeySeq(5)
    draws = [torch.rand(3, generator=g) for g in a.take(3)]
    again = [torch.rand(3, generator=next(b)) for _ in range(3)]
    for x, y in zip(draws, again):
        assert torch.equal(x, y)
    assert not torch.equal(draws[0], draws[1])
    assert KeySeq(6).next_seed() != KeySeq(5).next_seed()
