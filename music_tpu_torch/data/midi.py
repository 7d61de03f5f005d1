"""Standard MIDI File I/O + the C-RNN-GAN event pipeline, dependency-free
(counterpart of :mod:`music_tpu.data.midi`: :func:`midi_to_song_data`
parses with the C++ data path, :mod:`music_tpu_torch.native`, when its
library builds, and with the Python parser for any file the C++ parser
declines or when asked with ``use_native=False``).

Replaces the reference's mido-based parser (c-rnn-gan/data.py:100-174) and
tone/frequency conversions (c-rnn-gan/utils.py:4-23), and adds the event ->
MIDI writer the reference never finished (c-rnn-gan/generate.py is an empty
file).  Pure stdlib: SMF format 0/1, variable-length deltas, note on/off.

Event representation (c-rnn-gan/data.py constants): each note is
``[ticks_from_prev_start, length, freq, velocity]`` — tick values
normalized to ``output_ticks_per_quarter_note`` resolution, frequency in Hz
via the MIDI tuning standard.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path

import numpy as np

# feature indices (c-rnn-gan/data.py:8-13)
BEGIN_TICK, LENGTH, FREQ, VELOCITY = 0, 1, 2, 3
NUM_SONG_FEATURES = 4


def tone_to_freq(tone: float) -> float:
    """MIDI note number -> Hz (c-rnn-gan/utils.py:4-12)."""
    return 440.0 * (2.0 ** ((float(tone) - 69.0) / 12.0))


def freq_to_tone(freq: float) -> int:
    """Hz -> nearest MIDI note number (c-rnn-gan/utils.py:15-23)."""
    if freq <= 0:
        return 0
    return int(round(69.0 + 12.0 * math.log(freq / 440.0, 2)))


# ---------------------------------------------------------------------------
# SMF reading
# ---------------------------------------------------------------------------


def _read_varlen(data: bytes, i: int) -> tuple[int, int]:
    value = 0
    while True:
        b = data[i]
        i += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, i


def read_midi(path: str | Path) -> dict:
    """Parse an SMF file -> {ticks_per_beat, tracks: [[(delta, status, data...)]]}.

    Only channel note events matter downstream; everything else is carried
    or skipped correctly (running status, sysex, meta events).
    """
    raw = Path(path).read_bytes()
    if raw[:4] != b"MThd":
        raise ValueError(f"{path}: not a MIDI file")
    hlen = struct.unpack(">I", raw[4:8])[0]
    fmt, ntrk, division = struct.unpack(">HHH", raw[8:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division unsupported")
    i = 8 + hlen
    tracks = []
    for _ in range(ntrk):
        if raw[i : i + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        tlen = struct.unpack(">I", raw[i + 4 : i + 8])[0]
        data = raw[i + 8 : i + 8 + tlen]
        i += 8 + tlen
        events = []
        j = 0
        status = 0
        while j < len(data):
            delta, j = _read_varlen(data, j)
            b = data[j]
            if b & 0x80:
                status = b
                j += 1
            if status == 0xFF:  # meta
                mtype = data[j]
                mlen, j2 = _read_varlen(data, j + 1)
                events.append((delta, 0xFF, mtype, data[j2 : j2 + mlen]))
                j = j2 + mlen
            elif status in (0xF0, 0xF7):  # sysex
                mlen, j2 = _read_varlen(data, j)
                j = j2 + mlen
                events.append((delta, status, None, b""))
            else:
                kind = status & 0xF0
                n_data = 1 if kind in (0xC0, 0xD0) else 2
                args = tuple(data[j : j + n_data])
                j += n_data
                events.append((delta, status, args, b""))
        tracks.append(events)
    return {"ticks_per_beat": division, "format": fmt, "tracks": tracks}


def midi_to_song_data(
    path: str | Path, output_ticks_per_quarter_note: int = 384,
    use_native: bool = True,
) -> list[list[float]]:
    """MIDI file -> sorted note-event list, reference semantics
    (c-rnn-gan/data.py:100-143): note_on opens an event, matching note_off
    (or velocity-0 note_on) closes it; ticks normalized to the output
    resolution; never-closed events get a quarter-note length.

    With ``use_native`` the C++ parser
    (:func:`music_tpu_torch.native.parse_smf_events`) walks the bytes; a
    file it declines, or a host without its library, goes through the
    Python parser below."""
    if use_native:
        from music_tpu_torch import native

        events = native.parse_smf_events(Path(path).read_bytes(),
                                         output_ticks_per_quarter_note)
        if events is not None:
            return [list(row) for row in events]
    mid = read_midi(path)
    scale = mid["ticks_per_beat"] / output_ticks_per_quarter_note
    song = []
    for track in mid["tracks"]:
        last_tick = 0
        open_events: list[list[float]] = []
        for delta, status, args, _meta in track:
            kind = status & 0xF0 if status < 0xF0 else status
            if kind == 0x80 or (kind == 0x90 and args and args[1] == 0):
                note = args[0]
                freq = tone_to_freq(note)
                kept = []
                for ev in open_events:
                    if ev[FREQ] == freq:
                        abs_tick = (last_tick + delta) / scale
                        ev[LENGTH] = abs_tick - ev[BEGIN_TICK]
                        song.append(ev)
                    else:
                        kept.append(ev)
                open_events = kept
            elif kind == 0x90:
                ev = [0.0] * NUM_SONG_FEATURES
                ev[BEGIN_TICK] = (last_tick + delta) / scale
                ev[FREQ] = tone_to_freq(args[0])
                ev[VELOCITY] = float(args[1])
                open_events.append(ev)
            last_tick += delta
        for ev in open_events:
            ev[LENGTH] = float(output_ticks_per_quarter_note)
            song.append(ev)
    song.sort(key=lambda e: e[BEGIN_TICK])
    return song


def song_to_tensor(
    song: list[list[float]],
    song_length: int,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Random song_length window + begin-tick -> delta-from-previous-event
    (c-rnn-gan/data.py:145-174).  Short songs are zero-padded."""
    arr = np.asarray(song, np.float32).reshape(-1, NUM_SONG_FEATURES)
    if len(arr) > song_length:
        rng = rng or np.random.default_rng()
        start = int(rng.integers(0, len(arr) - song_length))
        arr = arr[start : start + song_length]
    arr = arr.copy()
    if len(arr) > 0:
        deltas = np.diff(arr[:, BEGIN_TICK], prepend=arr[0, BEGIN_TICK])
        arr[:, BEGIN_TICK] = deltas
    if len(arr) < song_length:
        arr = np.concatenate(
            [arr, np.zeros((song_length - len(arr), NUM_SONG_FEATURES), np.float32)]
        )
    return arr


# ---------------------------------------------------------------------------
# SMF writing (events -> .mid) — the missing c-rnn-gan/generate.py capability
# ---------------------------------------------------------------------------


def _varlen(value: int) -> bytes:
    value = max(0, int(value))
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


def events_to_midi(
    events: np.ndarray,
    path: str | Path,
    ticks_per_quarter_note: int = 384,
    tempo_us_per_quarter: int = 500_000,
):
    """Write ``[N, 4]`` events (delta_tick, length, freq, velocity) as a
    single-track MIDI file."""
    events = np.asarray(events, np.float64).reshape(-1, NUM_SONG_FEATURES)
    # absolute on/off times
    ons = np.cumsum(np.maximum(events[:, BEGIN_TICK], 0.0))
    msgs = []  # (abs_tick, order, status, note, velocity)
    for i, ev in enumerate(events):
        note = min(max(freq_to_tone(ev[FREQ]), 0), 127)
        vel = min(max(int(round(ev[VELOCITY])), 1), 127)
        length = max(ev[LENGTH], 1.0)
        msgs.append((ons[i], 1, 0x90, note, vel))
        msgs.append((ons[i] + length, 0, 0x80, note, 0))
    msgs.sort(key=lambda m: (m[0], m[1]))

    body = bytearray()
    body += _varlen(0) + bytes([0xFF, 0x51, 0x03]) + struct.pack(">I", tempo_us_per_quarter)[1:]
    last = 0.0
    for abs_tick, _, status, note, vel in msgs:
        body += _varlen(int(round(abs_tick - last))) + bytes([status, note, vel])
        last = abs_tick
    body += _varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track

    out = bytearray()
    out += b"MThd" + struct.pack(">IHHH", 6, 0, 1, ticks_per_quarter_note)
    out += b"MTrk" + struct.pack(">I", len(body)) + bytes(body)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(bytes(out))


def load_midi_dataset(
    root_dir: str | Path,
    song_length: int = 100,
    output_ticks_per_quarter_note: int = 384,
    seed: int = 0,
) -> tuple[np.ndarray, list[dict]]:
    """Walk ``root/genre/composer/*.mid`` (c-rnn-gan/data.py:16-98 layout)
    -> ([N, song_length, 4] tensor, per-song metadata dicts)."""
    root = Path(root_dir)
    rng = np.random.default_rng(seed)
    tensors, metas = [], []
    for mid_path in sorted(root.rglob("*.mid")):
        rel = mid_path.relative_to(root).parts
        genre = rel[-3] if len(rel) >= 3 else "unknown"
        composer = rel[-2] if len(rel) >= 2 else "unknown"
        try:
            song = midi_to_song_data(mid_path, output_ticks_per_quarter_note)
        except (ValueError, IndexError, struct.error):
            continue
        if not song:
            continue
        tensors.append(song_to_tensor(song, song_length, rng))
        metas.append({"genre": genre, "composer": composer, "path": str(mid_path)})
    if not tensors:
        return np.zeros((0, song_length, NUM_SONG_FEATURES), np.float32), []
    return np.stack(tensors), metas


def build_meta_onehots(
    metas: list[dict],
) -> tuple[np.ndarray, list[str], list[str]]:
    """Per-song conditioning tensor: one-hot(genre) ++ one-hot(composer)
    (c-rnn-gan/data.py:151-157) -> ([N, n_genres + n_composers] float32,
    genre vocab, composer vocab).  Vocabs are sorted for determinism; the
    trainer feeds this into the generator input (the reference built the
    tensor but its stub train loop never consumed it)."""
    genres = sorted({m["genre"] for m in metas})
    composers = sorted({m["composer"] for m in metas})
    g_index = {g: i for i, g in enumerate(genres)}
    c_index = {c: len(genres) + i for i, c in enumerate(composers)}
    meta = np.zeros((len(metas), len(genres) + len(composers)), np.float32)
    for i, m in enumerate(metas):
        meta[i, g_index[m["genre"]]] = 1.0
        meta[i, c_index[m["composer"]]] = 1.0
    return meta, genres, composers
