"""Raw-audio dataset pipeline: wav files -> µ-law pickle -> training windows.

Counterpart of :mod:`music_tpu.data.audio`:

- :func:`build_dataset` splits every song into ``duration``-second 16 kHz
  mono pieces, amplitude-normalized, optionally silence-trimmed;
- :func:`wavs_to_pickle` writes the ``np_audio.pkl`` artifact, a pickled
  list of int32 µ-law code arrays (the JAX package reads it unchanged);
- :class:`AudioWindows` slices ``[RF + WL]`` training windows from the
  concatenated codes, with the same window starts and, from the same seed,
  the same batch order as the JAX package's.

Host-side numpy throughout; the windows go to the device as int32 tokens
and the model embeds them there.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Iterator

import numpy as np

from music_tpu_torch.data import wavio


def mu_law_encode_np(audio: np.ndarray, quantization_channels: int = 256) -> np.ndarray:
    """Host µ-law encode in numpy float32 arithmetic: the JAX package's
    host formula, which gives its codes on every 16-bit PCM value."""
    audio = np.ascontiguousarray(audio, np.float32)
    mu = np.float32(quantization_channels - 1)
    safe_abs = np.abs(np.clip(audio, -1.0, 1.0))
    magnitude = np.log1p(mu * safe_abs) / np.log1p(mu)
    signal = np.sign(audio) * magnitude
    return ((signal + 1) / 2 * mu + 0.5).astype(np.int32)


def build_dataset(
    audio_dir: str | Path,
    out_dir: str | Path,
    *,
    suffix: str = ".wav",
    duration: int = 20,
    sample_rate: int = 16000,
    avg_amplitude: float = 0.05,
    silence_threshold: float | None = None,
) -> list[Path]:
    """Split every song under ``audio_dir`` into ``duration``-second pieces
    (the tail shorter than one piece is dropped), normalize, optionally trim
    silence, and write them as ``piece_00000.wav ...``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for song in sorted(Path(audio_dir).rglob(f"*{suffix}")):
        audio, sr = wavio.read_wav(song)
        audio = wavio.resample(audio, sr, sample_rate)
        audio = wavio.normalize_amplitude(audio, avg_amplitude)
        if silence_threshold is not None:
            audio = wavio.trim_silence(audio, silence_threshold)
        piece_len = duration * sample_rate
        for start in range(0, len(audio) - piece_len + 1, piece_len):
            path = out_dir / f"piece_{len(written):05d}.wav"
            wavio.write_wav(path, audio[start : start + piece_len], sample_rate)
            written.append(path)
    return written


def wavs_to_pickle(
    wav_dir: str | Path,
    out_path: str | Path,
    quantization_channels: int = 256,
) -> Path:
    """Encode every wav of ``wav_dir`` (sorted by name) to µ-law codes and
    pickle the list of arrays as ``out_path``."""
    arrays = []
    for path in sorted(Path(wav_dir).glob("*.wav")):
        audio, _ = wavio.read_wav(path)
        arrays.append(mu_law_encode_np(audio, quantization_channels))
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with out_path.open("wb") as f:
        pickle.dump(arrays, f)
    return out_path


class AudioWindows:
    """Training windows over µ-law code sequences.

    One ``[RF + WL]`` int32 array per example: positions ``[:-1]`` are the
    model input, ``[RF:]`` the targets.  Windows start every ``WL`` codes
    within a clip and never cross a clip boundary; a tail shorter than a
    full window is dropped."""

    def __init__(self, clips: list[np.ndarray], receptive_field: int, window_length: int):
        self.receptive_field = receptive_field
        self.window_length = window_length
        self.window = receptive_field + window_length
        starts, chunks, offset = [], [], 0
        for clip in clips:
            clip = np.asarray(clip, np.int32)
            n = (len(clip) - receptive_field) // window_length
            for i in range(max(n, 0)):
                s = offset + i * window_length
                if s + self.window <= offset + len(clip):
                    starts.append(s)
            chunks.append(clip)
            offset += len(clip)
        self.data = np.concatenate(chunks) if chunks else np.zeros((0,), np.int32)
        self.starts = np.asarray(starts, np.int64)
        if self.starts.size and (self.starts.min() < 0
                                 or self.starts.max() + self.window > self.data.size):
            raise ValueError("a window start lies outside the concatenated codes")
        self.max_code = int(self.data.max(initial=0))

    def check_vocab(self, quantization_channels: int) -> None:
        """Raise when the codes exceed the model's µ-law range (e.g. a
        256-level pickle fed to a Q=64 model), which would otherwise give
        out-of-range embeddings and labels."""
        if self.max_code >= quantization_channels:
            raise ValueError(
                f"dataset contains code {self.max_code} but the model has "
                f"quantization_channels={quantization_channels}; re-encode "
                f"the dataset (wavs_to_pickle(..., quantization_channels="
                f"{quantization_channels}))"
            )

    @classmethod
    def from_pickle(cls, path: str | Path, receptive_field: int, window_length: int):
        with Path(path).open("rb") as f:
            clips = pickle.load(f)
        return cls([np.asarray(c) for c in clips], receptive_field, window_length)

    def __len__(self) -> int:
        return len(self.starts)

    def gather(self, idx: np.ndarray) -> np.ndarray:
        """Windows ``[len(idx), RF + WL]`` int32 of the starts ``idx``."""
        pos = self.starts[idx][:, None] + np.arange(self.window)[None, :]
        return self.data[pos]

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        epochs: int | None = 1,
    ) -> Iterator[np.ndarray]:
        """Yield ``[B, RF + WL]`` batches in the order of
        ``np.random.default_rng(seed).permutation``, one permutation per
        epoch (``epochs=None``: forever)."""
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self.starts)) if shuffle else np.arange(len(self.starts))
            end = len(order) - (len(order) % batch_size) if drop_remainder else len(order)
            for i in range(0, end, batch_size):
                yield self.gather(order[i : i + batch_size])
            epoch += 1
