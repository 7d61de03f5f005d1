"""WAV file I/O, resampling, amplitude normalization and silence trimming
on numpy and the stdlib ``wave`` module (counterpart of
:mod:`music_tpu.data.wavio`)."""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a PCM WAV file -> (float32 mono audio in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as f:
        n_channels = f.getnchannels()
        sampwidth = f.getsampwidth()
        sr = f.getframerate()
        raw = f.readframes(f.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {sampwidth}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, sr


def write_wav(path: str | Path, audio: np.ndarray, sr: int = 16000):
    """Write float audio in [-1, 1] as 16-bit PCM mono WAV."""
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm = (audio * 32767.0).astype("<i2")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampling."""
    if sr_in == sr_out:
        return audio
    n_out = int(round(len(audio) * sr_out / sr_in))
    t_out = np.arange(n_out) * (sr_in / sr_out)
    return np.interp(t_out, np.arange(len(audio)), audio).astype(np.float32)


def normalize_amplitude(audio: np.ndarray, target_avg: float) -> np.ndarray:
    """Scale so mean |amplitude| == target."""
    avg = float(np.mean(np.abs(audio)))
    if avg == 0.0:
        return audio
    return (audio * (target_avg / avg)).astype(np.float32)


def rms_energy(audio: np.ndarray, frame_length: int = 2048, hop_length: int = 512) -> np.ndarray:
    """Per-frame RMS energy over centered frames."""
    pad = frame_length // 2
    x = np.pad(audio.astype(np.float64), (pad, pad))
    n_frames = 1 + (len(x) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = x[idx]
    return np.sqrt(np.mean(frames**2, axis=1)).astype(np.float32)


def trim_silence(audio: np.ndarray, threshold: float, frame_length: int = 2048) -> np.ndarray:
    """Trim leading and trailing frames whose RMS is at or below
    ``threshold`` (empty when everything is silent)."""
    if audio.size < frame_length:
        frame_length = max(int(audio.size), 1)
    hop = 512
    energy = rms_energy(audio, frame_length, hop)
    frames = np.nonzero(energy > threshold)[0]
    if frames.size == 0:
        return audio[0:0]
    start = frames[0] * hop
    end = min(frames[-1] * hop, audio.size)
    return audio[start:end]
