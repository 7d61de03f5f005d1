"""The port stands on its own: it imports neither jax nor anything of
music_tpu, its copies of the JAX package's jax-free pieces (params JSONs,
the µ-law table, the token-corpus, MIDI-scraper and loss-plot modules,
JSON loading, wav I/O) equal the originals, its host
µ-law encode matches the JAX package's, and its entry points run on CUDA
unless the caller asks for the CPU.

Also the home of :func:`one_torch_thread`, the module fixture every
``test_torch_*`` file imports."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from music_tpu.core import config as jconfig
from music_tpu.data import wavio as jwavio
from music_tpu.data.audio import mu_law_encode_np
from music_tpu_torch import cli
from music_tpu_torch.core import config as tconfig
from music_tpu_torch.data import wavio as twavio
from music_tpu_torch.generate import crnngan_generate as cggen
from music_tpu_torch.generate import wavenet_ae_generate as aegen
from music_tpu_torch.generate import wavenet_generate as wngen
from music_tpu_torch.models import crnngan as cg
from music_tpu_torch.models import wavenet as wn
from music_tpu_torch.models import wavenet_ae as ae
from music_tpu_torch.generate import serving
from music_tpu_torch.ops.mulaw import mu_law_encode
from music_tpu_torch.parallel import mesh as pmesh
from music_tpu_torch.parallel import multihost
from music_tpu_torch.runs import cli_journey_run as journey_run
from music_tpu_torch.runs import crnngan_quality_run as crnngan_run
from music_tpu_torch.runs import leakgan_oracle_run as leakgan_run
from music_tpu_torch.runs import seqgan_quality_run as seqgan_run
from music_tpu_torch.runs import wavenet_ae_quality_run as ae_run
from music_tpu_torch.runs import wavenet_poly_quality_run as poly_run
from music_tpu_torch.train import crnngan_train as cgtrain
from music_tpu_torch.train import leakgan_train as lgtrain
from music_tpu_torch.train import seqgan_train as sgtrain
from music_tpu_torch.train import wavenet_train as wtrain

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "music_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's torch ops on one intra-op thread, and the
    processes it starts with ``OMP_NUM_THREADS=1``; both restored after.
    The suite runs in several worker processes on a host's cores, next to
    the JAX tests' XLA threads; torch's default of one OpenMP thread a core
    makes every parallel op wait at its barrier for threads that other
    processes hold off their cores (a 4 s test took 151 s so).  Each
    ``test_torch_*`` module imports this fixture, which takes effect there
    by its ``autouse``."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env
COPIES = sorted(
    str(p.relative_to(PORT))
    for p in [*PORT.glob("params/**/*.json"), *PORT.glob("ops/*.npy"),
              PORT / "data" / "tokens.py", PORT / "data" / "midi_scraper.py",
              PORT / "utils" / "visualize.py", PORT / "csrc" / "datapath.cc"]
)
ORIGINALS = {"csrc/datapath.cc": REPO / "native" / "datapath.cc"}
"""Copies whose original is not at the same path under music_tpu/."""


def test_port_imports_nothing_of_jax_or_music_tpu():
    """Every module of the port (but ``__main__``, which runs the CLI) and
    chip_smoke.py, imported in a fresh process, leave no jax and no
    music_tpu module in sys.modules."""
    script = (
        "import importlib, pkgutil, sys\n"
        "import music_tpu_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(music_tpu_torch.__path__,"
        " 'music_tpu_torch.') if not m.name.endswith('__main__')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print('IMPORTED', len(names))\n"
        "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'music_tpu', 'benchmarks', 'native')))\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
    n = int(re.search(r"IMPORTED (\d+)", proc.stdout).group(1))
    assert n >= 20, proc.stdout  # every subpackage and module was reached
    for name in ("native", "runs.common", "runs.wavenet_poly_quality_run",
                 "runs.wavenet_ae_quality_run", "runs.cli_journey_run",
                 "runs.crnngan_quality_run", "runs.seqgan_quality_run",
                 "runs.leakgan_oracle_run"):
        assert (PORT / f"{name.replace('.', '/')}.py").exists(), name  # walked above


def test_no_import_statement_of_jax_or_music_tpu():
    """No line of the port's sources (``native.py`` and ``runs/*`` too) or
    chip_smoke.py imports jax, music_tpu, the JAX package's ``native`` or
    its ``benchmarks`` (docstrings may name their counterparts)."""
    pattern = re.compile(r"^\s*(import|from)\s+(music_tpu|jax|native|benchmarks)(\.|\s|$)")
    offending = [
        f"{path.relative_to(REPO)}:{i}"
        for path in [*sorted(PORT.rglob("*.py")), REPO / "chip_smoke.py"]
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if pattern.match(line)
    ]
    assert offending == []


@pytest.mark.parametrize("rel", COPIES)
def test_copied_file_equals_the_jax_packages(rel):
    original = ORIGINALS.get(rel, REPO / "music_tpu" / rel)
    assert (PORT / rel).read_bytes() == original.read_bytes()


def test_copies_cover_the_ported_families():
    assert COPIES == [
        "csrc/datapath.cc",
        "data/midi_scraper.py",
        "data/tokens.py",
        "ops/_mulaw_decode_q256.npy",
        "params/c_rnn_gan/crnngan_params.json",
        "params/c_rnn_gan/dataset_params.json",
        "params/c_rnn_gan/midi_sources.json",
        "params/c_rnn_gan/train_params.json",
        "params/leak_gan/leak_gan_params.json",
        "params/leak_gan/train_params.json",
        "params/seqgan/params.json",
        "params/wavenet/dataset_params.json",
        "params/wavenet/train_params.json",
        "params/wavenet/wavenet_params.json",
        "params/wavenet_autoencoder/dataset_params.json",
        "params/wavenet_autoencoder/model_params.json",
        "params/wavenet_autoencoder/train_params.json",
        "utils/visualize.py",
    ]


@pytest.mark.parametrize("family", ["wavenet", "wavenet_autoencoder", "seqgan", "leak_gan",
                                    "c_rnn_gan"])
def test_load_params_dir_matches_jax(family):
    ours = tconfig.load_params_dir(PORT / "params" / family)
    assert ours == jconfig.load_params_dir(REPO / "music_tpu" / "params" / family)
    assert ours  # the directory holds configs


def test_load_json_repairs_missing_commas(tmp_path):
    """The reference's dialect: no comma between a value and the next key."""
    path = tmp_path / "model_params.json"
    path.write_text('{\n  "a": 1\n  "b": [1, 2]\n  "c": "x"\n  "d": {"e": true}\n}\n')
    assert tconfig.load_json(path) == jconfig.load_json(path) == {
        "a": 1, "b": [1, 2], "c": "x", "d": {"e": True}}
    path.write_text("{\n  \"a\": \n}")
    with pytest.raises(tconfig.ConfigError):
        tconfig.load_json(path)


def test_wavio_matches_jax(tmp_path):
    """Written by one package, read by the other, the same samples; the
    same resampling."""
    audio = np.random.default_rng(0).uniform(-1.1, 1.1, 999).astype(np.float32)
    twavio.write_wav(tmp_path / "t.wav", audio, 8000)
    jwavio.write_wav(tmp_path / "j.wav", audio, 8000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    ours, sr = twavio.read_wav(tmp_path / "j.wav")
    ref, jsr = jwavio.read_wav(tmp_path / "t.wav")
    assert sr == jsr == 8000
    np.testing.assert_array_equal(ours, ref)
    for sr_out in (8000, 16000, 11025):
        np.testing.assert_array_equal(twavio.resample(ours, 8000, sr_out),
                                      jwavio.resample(ref, 8000, sr_out))


def _code_boundaries(q):
    """The float32 values next to each µ-law code boundary, both sides."""
    mu = q - 1
    s = 2 * (np.arange(q + 1) - 0.5) / mu - 1
    b = (np.sign(s) * ((1 + mu) ** np.abs(s) - 1) / mu).astype(np.float32)
    return np.concatenate([b, np.nextafter(b, np.float32(2)), np.nextafter(b, np.float32(-2))])


@pytest.mark.parametrize("q", [256, 32])
def test_mulaw_encode_matches_the_host_encode(q):
    """The port's torch encode against the JAX package's host encode
    (music_tpu.data.audio.mu_law_encode_np, native C++ when built): equal
    on a seeded clip, on -1, 0, 1 and values beyond them, and on every
    16-bit PCM value (what a wav holds).  On the float32 values next to a
    code boundary the two may differ by one code: log1p rounds differently
    in C++, numpy and torch (measured: 34 of 771 such values at Q=256 and
    20 of 99 at Q=32 against the C++ encode, 8 and 3 against its numpy
    fallback).  The JAX package's own jitted encode agrees with the port
    everywhere (tests/test_torch_mulaw.py)."""
    def both(x):
        x = np.ascontiguousarray(x, np.float32)
        return mu_law_encode(torch.from_numpy(x), q).numpy(), mu_law_encode_np(x, q)

    clip = np.random.default_rng(q).uniform(-1, 1, 100_000).astype(np.float32)
    edges = np.array([-1.5, -1.0, -0.0, 0.0, 1.0, 1.5], np.float32)
    pcm = np.arange(-32768, 32768).astype(np.float32) / 32768.0
    for x in (clip, edges, pcm):
        ours, ref = both(x)
        np.testing.assert_array_equal(ours, ref)
    ours, ref = both(_code_boundaries(q))
    assert np.abs(ours.astype(np.int64) - ref).max() <= 1
    assert int((ours != ref).sum()) <= len(ref) // 4


ENTRY_POINTS = {
    "wavenet generate": lambda tmp: wngen.generate(
        cfg=wn.WaveNetConfig(), params={}, out_path=tmp / "x.wav"),
    "wavenet generate_batch": lambda tmp: wngen.generate_batch(
        cfg=wn.WaveNetConfig(), params={}, n=2),
    "wavenet-ae generate": lambda tmp: aegen.generate(
        cfg=ae.WaveNetAEConfig(), params={}, source_audio=np.zeros(8000, np.float32),
        out_path=tmp / "x.wav"),
    "wavenet-ae generate_batch": lambda tmp: aegen.generate_batch(
        cfg=ae.WaveNetAEConfig(), params={}, source_audios=np.zeros((2, 8000), np.float32)),
    "CLI wavenet": lambda tmp: cli.main(
        ["wavenet", "generate", "--checkpoint", str(tmp / "none"), "--out", str(tmp / "x.wav")]),
    "CLI wavenet-ae": lambda tmp: cli.main(
        ["wavenet-ae", "generate", "--checkpoint", str(tmp / "none"), "--source",
         str(tmp / "x.wav"), "--out", str(tmp / "y.wav")]),
    "SeqGanTrainer": lambda tmp: sgtrain.SeqGanTrainer(sgtrain.SeqGanConfig()),
    "LeakGanTrainer": lambda tmp: lgtrain.LeakGanTrainer(lgtrain.LeakGanTrainConfig()),
    "CLI seqgan": lambda tmp: cli.main(["seqgan", "train"]),
    "CLI leakgan": lambda tmp: cli.main(
        ["leakgan", "train", "--corpus", str(_corpus(tmp)), "--checkpoint", str(tmp / "ck")]),
    "CRnnGanTrainer": lambda tmp: cgtrain.CRnnGanTrainer(cgtrain.CRnnGanTrainConfig()),
    "crnngan generate": lambda tmp: cggen.generate(
        cg.init_generator(torch.Generator().manual_seed(0), cg.CRnnGanConfig()),
        cg.CRnnGanConfig(), tmp / "x.mid"),
    "CLI crnngan train": lambda tmp: cli.main(
        ["crnngan", "train", "--midi-dir", str(_midi_dir(tmp)), "--checkpoint", str(tmp / "ck")]),
    "CLI crnngan generate": lambda tmp: cli.main(
        ["crnngan", "generate", "--checkpoint", str(tmp / "none"), "--out", str(tmp / "x.mid")]),
    "runs wavenet_poly_quality_run": lambda tmp: poly_run.main(["--out", str(tmp / "ck")]),
    "runs wavenet_ae_quality_run": lambda tmp: ae_run.main(["--out", str(tmp / "ck")]),
    "runs cli_journey_run": lambda tmp: journey_run.main(["--workdir", str(tmp / "ck")]),
    "runs crnngan_quality_run": lambda tmp: crnngan_run.main(["--out", str(tmp / "ck")]),
    "runs seqgan_quality_run": lambda tmp: seqgan_run.main(["--out", str(tmp / "ck")]),
    "runs leakgan_oracle_run": lambda tmp: leakgan_run.main(["--out", str(tmp / "ck")]),
    "make_mesh": lambda tmp: pmesh.make_mesh(pmesh.MeshSpec()),
    "wavenet train(mesh)": lambda tmp: wtrain.train(
        wavenet_params={}, dataset_params={}, train_params={},
        mesh=pmesh.make_mesh(pmesh.MeshSpec(data=-1))),
    "wavenet train(coordinator)": lambda tmp: wtrain.train(
        wavenet_params={}, dataset_params={},
        train_params={"coordinator": "127.0.0.1:1", "num_processes": 1, "process_id": 0}),
    "wavenet generate_batch(mesh)": lambda tmp: wngen.generate_batch(
        cfg=wn.WaveNetConfig(), params={}, n=2, mesh=pmesh.make_mesh()),
    "DecodeSession(mesh)": lambda tmp: serving.DecodeSession(
        wn.WaveNetConfig(), {}, mesh=pmesh.make_mesh()),
    "multihost.initialize": lambda tmp: multihost.initialize("127.0.0.1:1", 1, 0),
    "SeqGanTrainer(mesh)": lambda tmp: sgtrain.SeqGanTrainer(
        sgtrain.SeqGanConfig(), mesh=pmesh.make_mesh(pmesh.MeshSpec(data=-1))),
    "LeakGanTrainer(mesh)": lambda tmp: lgtrain.LeakGanTrainer(
        lgtrain.LeakGanTrainConfig(), mesh=pmesh.make_mesh(pmesh.MeshSpec(data=-1))),
    "CRnnGanTrainer(mesh)": lambda tmp: cgtrain.CRnnGanTrainer(
        cgtrain.CRnnGanTrainConfig(), mesh=pmesh.make_mesh(pmesh.MeshSpec(data=-1))),
    "CLI wavenet train --coordinator": lambda tmp: cli.main(
        ["wavenet", "train", "--coordinator", "127.0.0.1:1", "--num-processes", "1",
         "--process-id", "0"]),
}


def _corpus(tmp):
    np.save(tmp / "corpus.npy", np.ones((64, 20), np.int64))
    return tmp / "corpus.npy"


def _midi_dir(tmp):
    from music_tpu_torch.data.midi import events_to_midi

    events_to_midi(np.array([[0, 96, 440.0, 80]] * 8, np.float32), tmp / "midi" / "g" / "c" /
                   "a.mid")
    return tmp / "midi"


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_cuda(name, tmp_path):
    """Without ``device`` / ``--device`` every entry point asks for CUDA,
    and on a host without it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name](tmp_path)
    assert not any((tmp_path / name).exists() for name in ("x.wav", "x.mid", "ck"))
