"""The port's MIDI pipeline (music_tpu_torch.data.midi), MIDI scraper
(data.midi_scraper, ``dataset scrape-midi``), loss plots (utils.visualize,
``vis loss``) and profiling utilities (utils.profiling) against music_tpu's,
on the CPU.  Every MIDI file is written from seeded events; the scraper
fetches through an injected ``fetch`` only, never the network."""

import json
import struct
import time

import numpy as np
import pytest
import torch

from music_tpu.data import midi as jmidi
from music_tpu.data import midi_scraper as jscraper
from music_tpu.utils import visualize as jvis
from music_tpu_torch import cli
from music_tpu_torch.core import optim
from music_tpu_torch.core.metrics import MetricsLogger
from music_tpu_torch.data import midi as tmidi
from music_tpu_torch.data import midi_scraper as tscraper
from music_tpu_torch.utils import profiling
from music_tpu_torch.utils import visualize as tvis
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)


def seeded_events(seed: int, n: int = 40) -> np.ndarray:
    """``[n, 4]`` events with fractional ticks, chords (zero deltas),
    out-of-range pitches and velocities (the writer clamps them)."""
    rng = np.random.default_rng(seed)
    deltas = rng.choice([0.0, 0.5, 24.0, 96.25, 191.5], n) * rng.integers(0, 3, n)
    return np.stack([deltas, rng.uniform(0.2, 400, n),
                     [tmidi.tone_to_freq(t) for t in rng.integers(-3, 131, n)],
                     rng.uniform(-5, 140, n)], axis=1).astype(np.float32)


def smf_format1(ticks_per_beat: int = 96) -> bytes:
    """A hand-built format-1 file of two tracks: running status, a
    velocity-0 note_on as note_off, a program change, sysex and meta events,
    a note never closed."""
    def track(body: bytes) -> bytes:
        return b"MTrk" + struct.pack(">I", len(body)) + body

    t1 = bytes([0x00, 0xFF, 0x51, 0x03, 0x07, 0xA1, 0x20,  # tempo
                0x00, 0x90, 60, 90, 0x30, 64, 80,  # note_on 60; running status: 64
                0x30, 60, 0,  # velocity 0 closes 60
                0x00, 0xC0, 5,  # program change (one data byte)
                0x10, 0xF0, 0x02, 0x01, 0xF7,  # sysex
                0x81, 0x00, 0x80, 64, 0,  # note_off 64 after 128 ticks
                0x00, 0xFF, 0x2F, 0x00])
    t2 = bytes([0x20, 0x91, 72, 100,  # never closed
                0x00, 0xFF, 0x2F, 0x00])
    return (b"MThd" + struct.pack(">IHHH", 6, 1, 2, ticks_per_beat) + track(t1) + track(t2))


def test_tone_and_freq_conversions_equal_jax():
    for tone in range(-3, 131):
        assert tmidi.tone_to_freq(tone) == jmidi.tone_to_freq(tone)
    for freq in [-1.0, 0.0, 8.18, 100.0, 439.9, 440.0, 12543.85, 20000.0]:
        assert tmidi.freq_to_tone(freq) == jmidi.freq_to_tone(freq)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_events_to_midi_writes_jax_bytes(seed, tmp_path):
    ev = seeded_events(seed)
    tmidi.events_to_midi(ev, tmp_path / "t" / "a.mid", ticks_per_quarter_note=480,
                         tempo_us_per_quarter=400_000)
    jmidi.events_to_midi(ev, tmp_path / "j" / "a.mid", ticks_per_quarter_note=480,
                         tempo_us_per_quarter=400_000)
    assert (tmp_path / "t" / "a.mid").read_bytes() == (tmp_path / "j" / "a.mid").read_bytes()


def test_midi_round_trip(tmp_path):
    """Whole-tick events with no overlapping notes come back as written."""
    rng = np.random.default_rng(3)
    deltas = np.concatenate([[0], rng.integers(50, 200, 29)]).astype(np.float32)
    ev = np.stack([deltas, rng.integers(1, 50, 30), [tmidi.tone_to_freq(t) for t in
                   rng.integers(30, 100, 30)], rng.integers(1, 128, 30)], axis=1)
    tmidi.events_to_midi(ev, tmp_path / "a.mid")
    song = tmidi.midi_to_song_data(tmp_path / "a.mid")
    back = tmidi.song_to_tensor(song, 30)
    np.testing.assert_allclose(back, ev.astype(np.float32), rtol=1e-6)


@pytest.mark.parametrize("use_native", [True, False])
def test_midi_to_song_data_equals_jax(use_native, tmp_path):
    """The port's Python parser against JAX's native parser and its Python
    one, on seeded files, a format-1 file at another resolution, and
    ``read_midi`` itself."""
    paths = []
    for seed in range(3):
        paths.append(tmp_path / f"s{seed}.mid")
        jmidi.events_to_midi(seeded_events(seed), paths[-1], ticks_per_quarter_note=192)
    paths.append(tmp_path / "f1.mid")
    paths[-1].write_bytes(smf_format1())
    for path in paths:
        for ticks in (384, 100):
            ours = tmidi.midi_to_song_data(path, ticks)
            theirs = jmidi.midi_to_song_data(path, ticks, use_native=use_native)
            np.testing.assert_array_equal(np.asarray(ours, np.float64),
                                          np.asarray(theirs, np.float64), err_msg=str(path))
        assert tmidi.read_midi(path) == jmidi.read_midi(path)
    assert len(tmidi.midi_to_song_data(paths[-1])) == 3
    (tmp_path / "bad.mid").write_bytes(b"RIFF....")
    with pytest.raises(ValueError, match="not a MIDI file"):
        tmidi.midi_to_song_data(tmp_path / "bad.mid")


def test_song_to_tensor_equals_jax():
    song = [list(map(float, row)) for row in np.cumsum(seeded_events(4, 60), axis=0)]
    for length in (10, 59, 60, 80):
        ours = tmidi.song_to_tensor(song, length, np.random.default_rng(5))
        theirs = jmidi.song_to_tensor(song, length, np.random.default_rng(5))
        assert ours.shape == (length, 4) and ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)


def test_load_midi_dataset_and_meta_equal_jax(tmp_path):
    """``root/genre/composer/*.mid`` (a stray file at the root, a corrupt
    file skipped): the same tensor, metadata and one-hot rows as JAX's."""
    for i in range(6):
        tmidi.events_to_midi(seeded_events(10 + i, 20 + 7 * i),
                             tmp_path / f"g{i % 2}" / f"c{i % 3}" / f"s{i}.mid")
    tmidi.events_to_midi(seeded_events(20, 5), tmp_path / "loose.mid")
    (tmp_path / "g0" / "c0" / "corrupt.mid").write_bytes(b"MThd\x00\x00\x00\x06\x00")
    ours, t_metas = tmidi.load_midi_dataset(tmp_path, song_length=16, seed=3)
    theirs, j_metas = jmidi.load_midi_dataset(tmp_path, song_length=16, seed=3)
    assert ours.shape == (7, 16, 4)
    np.testing.assert_array_equal(ours, theirs)
    assert t_metas == j_metas
    t_meta, t_genres, t_composers = tmidi.build_meta_onehots(t_metas)
    j_meta, j_genres, j_composers = jmidi.build_meta_onehots(j_metas)
    np.testing.assert_array_equal(t_meta, j_meta)
    assert (t_genres, t_composers) == (j_genres, j_composers) == (
        ["g0", "g1", "unknown"], ["c0", "c1", "c2", "unknown"])
    empty, metas = tmidi.load_midi_dataset(tmp_path / "none", song_length=16)
    assert empty.shape == (0, 16, 4) and metas == []


def _site(tmp_path):
    """Index pages and MIDI payloads of a fake archive, and a ``fetch``
    that serves them (and fails on anything else, as a dead link does)."""
    payloads = {}
    for i in range(4):
        tmidi.events_to_midi(seeded_events(30 + i, 8), tmp_path / "src" / f"{i}.mid")
        payloads[i] = (tmp_path / "src" / f"{i}.mid").read_bytes()
    pages = {
        "http://x/bach.htm": (b'<a href="m/bwv1.mid">1</a><a href="/m/bwv2.MID">2</a>'
                              b'<a href="notes.txt">n</a><a href="m/gone.mid">dead</a>'
                              b'<a href="http://y/z/bwv3.midi">3</a>'),
        "http://x/m/bwv1.mid": payloads[0], "http://x/m/bwv2.MID": payloads[1],
        "http://y/z/bwv3.midi": payloads[2],
        "http://x/chopin.htm": b'<a href="op9.mid">op9</a>',
        "http://x/op9.mid": payloads[3],
    }

    def fetch(url):
        if url not in pages:
            raise OSError(f"404 {url}")
        return pages[url]

    sources = {"baroque/bach": ["http://x/bach.htm", "http://x/missing.htm"],
               "romantic/chopin": ["http://x/chopin.htm"]}
    return pages, fetch, sources


def test_midi_scraper_matches_jax(tmp_path):
    """With the same injected ``fetch``: the same links, files, ledger and
    split lists as JAX's scraper; a second crawl skips the ledger's links;
    the per-source cap holds."""
    pages, fetch, sources = _site(tmp_path)
    html = pages["http://x/bach.htm"].decode()
    assert (tscraper.extract_midi_links(html, "http://x/bach.htm")
            == jscraper.extract_midi_links(html, "http://x/bach.htm"))
    trees = {}
    for name, mod in (("t", tscraper), ("j", jscraper)):
        root = tmp_path / name
        written = mod.download(root, sources, fetch=fetch, delay_seconds=0)
        assert mod.download(root, sources, fetch=fetch, delay_seconds=0) == []
        splits = mod.write_split_lists(root, validation_fraction=0.3, test_fraction=0.3, seed=2)
        trees[name] = ([p.relative_to(root) for p in written], splits, {
            str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()})
    assert trees["t"] == trees["j"]
    assert len(trees["t"][0]) == 4 and "downloaded.txt" in trees["t"][2]
    capped = tscraper.download(tmp_path / "cap", sources, fetch=fetch, delay_seconds=0,
                               max_files_per_source=1)
    assert [p.name for p in capped] == ["bwv1.mid", "op9.mid"]
    files = [f"a/b/{i}.mid" for i in range(50)]
    assert tscraper.split_files(files, seed=4) == jscraper.split_files(files, seed=4)
    assert tscraper.DEFAULT_SOURCES.read_bytes() == jscraper.DEFAULT_SOURCES.read_bytes()


def test_cli_scrape_midi(tmp_path, monkeypatch, capsys):
    """``dataset scrape-midi`` with a sources file (the shipped file's
    schema: ``sources`` and ``splits``), fetching through the injected
    ``fetch``: the files and split lists JAX's functions write."""
    _, fetch, sources = _site(tmp_path)
    (tmp_path / "sources.json").write_text(json.dumps(
        {"sources": sources, "splits": {"validation_fraction": 0.25, "test_fraction": 0.25,
                                        "seed": 1}}))
    download = tscraper.download
    monkeypatch.setattr(tscraper, "download", lambda *a, **k: download(
        *a, fetch=fetch, delay_seconds=0, **k))
    cli.main(["dataset", "scrape-midi", "--out-dir", str(tmp_path / "out"), "--sources",
              str(tmp_path / "sources.json")])
    assert "4 new files; splits: train=" in capsys.readouterr().out
    jscraper.download(tmp_path / "ref", sources, fetch=fetch, delay_seconds=0)
    want = jscraper.write_split_lists(tmp_path / "ref", validation_fraction=0.25,
                                      test_fraction=0.25, seed=1)
    for split, paths in want.items():
        assert (tmp_path / "out" / f"{split}_files.txt").read_text().split() == paths
    with pytest.raises(SystemExit, match="build-audio requires --audio-dir"):
        cli.main(["dataset", "build-audio", "--out-dir", str(tmp_path / "x")])


def test_loss_logs_read_as_jax_reads_them(tmp_path):
    """``get_loss`` (the reference's text log) and ``get_loss_jsonl`` (the
    structured log) equal JAX's on the logs the port's trainers write."""
    logger = MetricsLogger(tmp_path, echo=False)
    for step, loss in [(100, 3.25), (200, 2.9), (300, 2.5)]:
        logger.log_loss(0, step, loss)
    logger.log_event("resumed")
    for fn in ("get_loss", "get_loss_jsonl"):
        path = tmp_path / ("loss_log.log" if fn == "get_loss" else "metrics.jsonl")
        ours, theirs = getattr(tvis, fn)(path), getattr(jvis, fn)(path)
        assert ours == theirs and ours[0] == [100, 200, 300]


@pytest.mark.parametrize("log", ["loss_log.log", "metrics.jsonl"])
def test_cli_vis_loss_writes_a_png(log, tmp_path, capsys):
    logger = MetricsLogger(tmp_path, echo=False)
    for step, loss in [(10, 1.5), (20, 1.2)]:
        logger.log_loss(0, step, loss)
    cli.main(["vis", "loss", "--log", str(tmp_path / log), "--out", str(tmp_path / "l.png")])
    assert (tmp_path / "l.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert f"wrote {tmp_path / 'l.png'}" in capsys.readouterr().out


def _regression():
    params = {"w": torch.ones((8, 4)), "b": torch.zeros(4)}
    batch = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32))
    return (lambda p, x: ((x @ p["w"] + p["b"]) ** 2).mean()), params, batch


def test_phase_fractions_sum_to_one():
    loss_fn, params, batch = _regression()
    tx = optim.chain(optim.clip_by_global_norm(5.0), optim.adam(1e-3))
    opt_state = tx.init(params)
    fr = profiling.phase_fractions(loss_fn, params, batch, tx, opt_state, n_iters=3)
    assert abs(fr["forward_frac"] + fr["backward_frac"] + fr["optimizer_frac"] - 1) < 1e-9
    assert min(fr.values()) > 0
    assert int(opt_state[1][0].count) == 0 and float(params["w"].sum()) == 32.0  # unchanged


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` on the CPU writes a Chrome trace holding the program's
    span beside the profiler's own events."""
    loss_fn, params, batch = _regression()
    with profiling.trace(tmp_path / "prof") as prof:
        with profiling.span("regression_loss"):
            loss_fn(params, batch)
    assert prof is not None
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    ours = [e for e in events if e.get("name") == "regression_loss"]
    assert len(ours) == 1 and ours[0]["cat"] == "program_span" and ours[0]["dur"] > 0
    assert any(e.get("cat") != "program_span" and e.get("ph") == "X" for e in events)


def test_span_records_nothing_while_recording_is_off():
    with profiling.recording():
        pass
    with profiling.span("off"):
        pass
    assert profiling.summary() == {}


def test_span_nesting_parents_and_self_time():
    """A child's host time is taken out of its parent's self time; each
    span names the span that opened it."""
    with profiling.recording():
        with profiling.span("outer"):
            time.sleep(0.002)
            for _ in range(2):
                with profiling.span("inner"):
                    time.sleep(0.002)
    s = profiling.summary()
    assert (s["outer"]["count"], s["inner"]["count"]) == (1, 2)
    assert s["outer"]["parents"] == [None] and s["inner"]["parents"] == ["outer"]
    assert s["inner"]["host_ms"] >= 4.0 and s["outer"]["host_ms"] >= 6.0
    assert s["outer"]["self_ms"] == pytest.approx(s["outer"]["host_ms"] - s["inner"]["host_ms"])
    assert s["inner"]["self_ms"] == pytest.approx(s["inner"]["host_ms"])
    (a, b), = s["outer"]["intervals"]
    assert all(a <= c < d <= b for c, d in s["inner"]["intervals"])


def test_summary_on_the_cpu_gives_device_ms_as_host_ms():
    with profiling.recording():
        with profiling.span("work"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    e = profiling.summary()["work"]
    assert set(e) == {"count", "host_ms", "self_ms", "device_ms", "parents", "intervals"}
    assert e["device_ms"] == e["host_ms"] == e["self_ms"] > 0
    assert e["intervals"][0][1] - e["intervals"][0][0] == pytest.approx(e["host_ms"] * 1e6)


def test_decode_session_step_records_its_spans_once_a_call():
    """A session call on the CPU: the pack, the re-prime, the decode, the
    codes' fetch and the tail loop, once each, in that order, at the top."""
    from music_tpu_torch.generate.serving import DecodeSession
    from music_tpu_torch.models import wavenet as wn

    cfg = wn.WaveNetConfig(dilations=(1, 2, 1, 2), dilation_channels=4, residual_channels=4,
                           skip_channels=8, quantization_channels=16)
    params = wn.init_params(cfg, torch.Generator().manual_seed(0))
    sess = DecodeSession(cfg, params, capacity=2, dtype=torch.float32, device="cpu",
                         steps_per_call=3)
    sess.add()
    sess.add()
    with profiling.recording():
        for _ in range(2):
            assert len(sess.step()) == 2
    s = profiling.summary()
    order = ["session.pack", "decode.prepare", "decode.launch", "session.fetch",
             "session.tails"]
    assert sorted(s) == sorted(order)
    assert all(s[n]["count"] == 2 and s[n]["parents"] == [None] for n in order)
    starts = [s[n]["intervals"][0][0] for n in order]
    assert starts == sorted(starts)


def test_grad_update_records_forward_backward_and_update_once():
    loss_fn, params, batch = _regression()
    tx = optim.adam(1e-3)
    with profiling.recording():
        optim.grad_update(tx, params, tx.init(params), lambda p: loss_fn(p, batch))
    s = profiling.summary()
    assert sorted(s) == ["step.backward", "step.forward", "step.update"]
    assert all(e["count"] == 1 and e["parents"] == [None] for e in s.values())
    assert (s["step.forward"]["intervals"][0][1] <= s["step.backward"]["intervals"][0][0]
            and s["step.backward"]["intervals"][0][1] <= s["step.update"]["intervals"][0][0])


def test_union_ns_counts_overlaps_once():
    assert profiling.union_ns([(0, 10), (5, 15), (20, 30), (22, 25)]) == 25
    assert profiling.union_ns([]) == 0
