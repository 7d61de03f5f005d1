"""The port stands on its own: it imports neither jax nor anything of
music_tpu, its copies of the JAX package's jax-free pieces (params JSONs,
the µ-law table, the token-corpus module, JSON loading, wav I/O) equal the
originals, its host
µ-law encode matches the JAX package's, and its entry points run on CUDA
unless the caller asks for the CPU."""

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
from music_tpu_torch.generate import wavenet_ae_generate as aegen
from music_tpu_torch.generate import wavenet_generate as wngen
from music_tpu_torch.models import wavenet as wn
from music_tpu_torch.models import wavenet_ae as ae
from music_tpu_torch.ops.mulaw import mu_law_encode
from music_tpu_torch.train import leakgan_train as lgtrain
from music_tpu_torch.train import seqgan_train as sgtrain

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "music_tpu_torch"
COPIES = sorted(
    str(p.relative_to(PORT))
    for p in [*PORT.glob("params/**/*.json"), *PORT.glob("ops/*.npy"),
              PORT / "data" / "tokens.py"]
)


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
        " ('jax', 'jaxlib', 'music_tpu')))\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
    n = int(re.search(r"IMPORTED (\d+)", proc.stdout).group(1))
    assert n >= 20, proc.stdout  # every subpackage and module was reached


def test_no_import_statement_of_jax_or_music_tpu():
    """No line of the port's sources or chip_smoke.py imports jax or
    music_tpu (docstrings may name their counterparts)."""
    pattern = re.compile(r"^\s*(import|from)\s+(music_tpu|jax)(\.|\s|$)")
    offending = [
        f"{path.relative_to(REPO)}:{i}"
        for path in [*sorted(PORT.rglob("*.py")), REPO / "chip_smoke.py"]
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if pattern.match(line)
    ]
    assert offending == []


@pytest.mark.parametrize("rel", COPIES)
def test_copied_file_equals_the_jax_packages(rel):
    assert (PORT / rel).read_bytes() == (REPO / "music_tpu" / rel).read_bytes()


def test_copies_cover_the_ported_families():
    assert COPIES == [
        "data/tokens.py",
        "ops/_mulaw_decode_q256.npy",
        "params/leak_gan/leak_gan_params.json",
        "params/leak_gan/train_params.json",
        "params/seqgan/params.json",
        "params/wavenet/dataset_params.json",
        "params/wavenet/train_params.json",
        "params/wavenet/wavenet_params.json",
        "params/wavenet_autoencoder/dataset_params.json",
        "params/wavenet_autoencoder/model_params.json",
        "params/wavenet_autoencoder/train_params.json",
    ]


@pytest.mark.parametrize("family", ["wavenet", "wavenet_autoencoder", "seqgan", "leak_gan"])
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
}


def _corpus(tmp):
    np.save(tmp / "corpus.npy", np.ones((64, 20), np.int64))
    return tmp / "corpus.npy"


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_cuda(name, tmp_path):
    """Without ``device`` / ``--device`` every entry point asks for CUDA,
    and on a host without it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name](tmp_path)
    assert not (tmp_path / "x.wav").exists() and not (tmp_path / "ck").exists()
