"""The port's C++ host data path (music_tpu_torch.native) against the JAX
package's (music_tpu.native): the port builds its own library from its
copy of the source, under build/, and its µ-law encode, window gather,
PCM conversions and MIDI event parser give the JAX package's results
exactly; the port's host encode (data/audio.mu_law_encode_np) now equals
JAX's on every float32 value tested, code boundaries included."""

import numpy as np
import pytest

from music_tpu import native as jnative
from music_tpu.data import midi as jmidi
from music_tpu.data.audio import mu_law_encode_np as jax_host_encode
from music_tpu_torch import native
from music_tpu_torch.data import midi as tmidi
from music_tpu_torch.data.audio import mu_law_encode_np
from test_torch_port import REPO, _code_boundaries
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)


def _inputs(kind: str, q: int) -> np.ndarray:
    if kind == "uniform":
        return np.random.default_rng(q).uniform(-1.3, 1.3, 200_000).astype(np.float32)
    if kind == "boundaries":
        return _code_boundaries(q)
    return np.arange(-32768, 32768).astype(np.float32) / 32768.0  # every 16-bit PCM value


def test_library_builds_under_build_from_the_ports_source():
    assert native.available()
    lib = native.library_path()
    assert lib.exists()
    assert lib.parent == REPO / "build" / "native"
    assert native.SOURCE == REPO / "music_tpu_torch" / "csrc" / "datapath.cc"
    assert jnative.available()  # the comparisons below are C++ against C++
    assert not str(lib).startswith(str(REPO / "native"))


@pytest.mark.parametrize("q", [256, 32])
@pytest.mark.parametrize("kind", ["uniform", "boundaries", "pcm16"])
def test_mulaw_encode_equals_jax_native(kind, q):
    x = _inputs(kind, q)
    ours = native.mulaw_encode(x, q)
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, jnative.mulaw_encode(x, q))


@pytest.mark.parametrize("q", [256, 32])
@pytest.mark.parametrize("kind", ["uniform", "boundaries", "pcm16"])
def test_host_encode_equals_jax_host_encode(kind, q):
    """The port's host encode was numpy's (34 of 771 boundary values at
    Q = 256 one code off JAX's); through the C++ path it is exact."""
    x = _inputs(kind, q)
    np.testing.assert_array_equal(mu_law_encode_np(x, q), jax_host_encode(x, q))


def test_gather_windows_and_pcm_equal_jax():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 50_000).astype(np.int32)
    starts = rng.integers(0, len(data) - 333, 17)
    ours = native.gather_windows(data, starts, 333)
    np.testing.assert_array_equal(ours, jnative.gather_windows(data, starts, 333))
    np.testing.assert_array_equal(ours, data[starts[:, None] + np.arange(333)[None, :]])
    audio = rng.uniform(-1.2, 1.2, 40_000).astype(np.float32)
    pcm = native.float_to_pcm16(audio)
    assert pcm.dtype == np.int16
    np.testing.assert_array_equal(pcm, jnative.float_to_pcm16(audio))
    every = np.arange(-32768, 32768).astype(np.int16)
    back = native.pcm16_to_float(every)
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, jnative.pcm16_to_float(every))


def test_numpy_path_without_the_library(monkeypatch):
    """A host without g++: every entry point runs the JAX package's numpy
    formulas, and the parser declines (the Python parser takes over)."""
    monkeypatch.setattr(native._Library, "tried", True)
    monkeypatch.setattr(native._Library, "lib", None)
    assert not native.available()
    x = _inputs("pcm16", 256)
    np.testing.assert_array_equal(native.mulaw_encode(x), jnative.mulaw_encode(x))
    data = np.arange(100, dtype=np.int32)
    np.testing.assert_array_equal(native.gather_windows(data, np.array([3, 50]), 5),
                                  [np.arange(3, 8), np.arange(50, 55)])
    audio = np.array([-2.0, -1.0, -0.5, 0.0, 0.25, 1.0, 3.0], np.float32)
    np.testing.assert_array_equal(native.float_to_pcm16(audio), jnative.float_to_pcm16(audio))
    assert native.parse_smf_events(b"MThd", 384) is None


def _events(seed: int, n: int = 60) -> np.ndarray:
    rng = np.random.default_rng(seed)
    events = np.zeros((n, 4), np.float64)
    events[:, 0] = rng.integers(0, 200, n)
    events[:, 1] = rng.integers(10, 500, n)
    events[:, 2] = [jmidi.tone_to_freq(int(t)) for t in rng.integers(40, 90, n)]
    events[:, 3] = rng.integers(1, 127, n)
    return events


@pytest.mark.parametrize("tpq", [480, 384, 96])
def test_parse_smf_events_equals_jax_and_the_python_parser(tpq, tmp_path):
    path = tmp_path / "t.mid"
    jmidi.events_to_midi(_events(tpq), path, ticks_per_quarter_note=tpq)
    raw = path.read_bytes()
    ours = native.parse_smf_events(raw, 384)
    assert ours is not None, "the C++ parser declined a valid file"
    np.testing.assert_array_equal(ours, jnative.parse_smf_events(raw, 384))
    python = tmidi.midi_to_song_data(path, 384, use_native=False)
    np.testing.assert_allclose(ours, np.asarray(python, np.float64), rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(tmidi.midi_to_song_data(path, 384)), ours)
    bad = tmp_path / "bad.mid"
    bad.write_bytes(b"not a midi file....")
    assert native.parse_smf_events(bad.read_bytes(), 384) is None
    with pytest.raises(ValueError):  # declined by C++, raised by the Python parser
        tmidi.midi_to_song_data(bad)
