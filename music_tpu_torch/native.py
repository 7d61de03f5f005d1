"""The C++ host data path (counterpart of :mod:`music_tpu.native`).

``csrc/datapath.cc`` (a byte copy of the JAX package's
``native/datapath.cc``) is compiled with ``g++ -O3 -shared -fPIC`` on first
use into ``build/native/`` at the root of the checkout, named by a hash of
its source, and bound with ctypes.  The port never loads the JAX package's
build and never writes next to the source.

The host's µ-law encode, window gather and PCM conversions go through it,
as the JAX package's do: the C++ ``log1p`` rounds differently from numpy's
next to a code boundary, so the two packages encode the same float32 audio
to the same codes only when both run the C++ encode.  Every entry point
keeps the JAX package's numpy path for a host without ``g++``;
:func:`available` says which one runs.

API: ``available()``, ``mulaw_encode(audio, q)``, ``gather_windows(data,
starts, width)``, ``float_to_pcm16(audio)``, ``pcm16_to_float(pcm)``,
``parse_smf_events(raw, tpq)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "datapath.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
ABI_VERSION = 2


class _Library:
    """The loaded library, or ``None`` once a build or load failed."""

    lib: ctypes.CDLL | None = None
    tried = False


def library_path() -> Path:
    """Where the library built from :data:`SOURCE` lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdatapath_{h.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    tmp.rename(lib_path)
    return True


def _bind(lib: ctypes.CDLL) -> None:
    i16, i32, i64 = ctypes.c_int16, ctypes.c_int32, ctypes.c_int64
    ptr = ctypes.POINTER
    lib.datapath_abi_version.argtypes = []
    lib.datapath_abi_version.restype = i32
    lib.mulaw_encode.argtypes = [ptr(ctypes.c_float), ptr(i32), i64, i32]
    lib.mulaw_encode.restype = None
    lib.gather_windows.argtypes = [ptr(i32), ptr(i64), ptr(i32), i64, i64]
    lib.gather_windows.restype = None
    lib.float_to_pcm16.argtypes = [ptr(ctypes.c_float), ptr(i16), i64]
    lib.float_to_pcm16.restype = None
    lib.pcm16_to_float.argtypes = [ptr(i16), ptr(ctypes.c_float), i64]
    lib.pcm16_to_float.restype = None
    lib.parse_smf_events.argtypes = [ptr(ctypes.c_uint8), i64, i32, ptr(ctypes.c_double), i64]
    lib.parse_smf_events.restype = i64


def _load() -> ctypes.CDLL | None:
    if _Library.tried:
        return _Library.lib
    _Library.tried = True
    lib_path = library_path()
    if not lib_path.exists() and not _build(lib_path):
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None
    _bind(lib)
    if lib.datapath_abi_version() != ABI_VERSION:
        return None
    _Library.lib = lib
    return lib


def available() -> bool:
    """Whether the C++ library is built and loaded (else numpy runs)."""
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def mulaw_encode(audio: np.ndarray, quantization_channels: int = 256) -> np.ndarray:
    """µ-law codes ``int32`` of float audio, in float32 arithmetic."""
    lib = _load()
    audio = np.ascontiguousarray(audio, np.float32)
    if lib is not None:
        out = np.empty(audio.shape, np.int32)
        lib.mulaw_encode(_ptr(audio, ctypes.c_float), _ptr(out, ctypes.c_int32), audio.size,
                         quantization_channels)
        return out
    mu = np.float32(quantization_channels - 1)
    safe_abs = np.abs(np.clip(audio, -1.0, 1.0))
    magnitude = np.log1p(mu * safe_abs) / np.log1p(mu)
    signal = np.sign(audio) * magnitude
    return ((signal + 1) / 2 * mu + 0.5).astype(np.int32)


def gather_windows(data: np.ndarray, starts: np.ndarray, width: int) -> np.ndarray:
    """``[len(starts), width]`` int32 windows ``data[s : s + width]``; the
    caller guarantees every window lies inside ``data``."""
    lib = _load()
    data = np.ascontiguousarray(data, np.int32)
    starts = np.ascontiguousarray(starts, np.int64)
    if lib is not None:
        out = np.empty((len(starts), width), np.int32)
        lib.gather_windows(_ptr(data, ctypes.c_int32), _ptr(starts, ctypes.c_int64),
                           _ptr(out, ctypes.c_int32), len(starts), width)
        return out
    pos = starts[:, None] + np.arange(width)[None, :]
    return data[pos].astype(np.int32)


def float_to_pcm16(audio: np.ndarray) -> np.ndarray:
    lib = _load()
    audio = np.ascontiguousarray(audio, np.float32)
    if lib is not None:
        out = np.empty(audio.shape, np.int16)
        lib.float_to_pcm16(_ptr(audio, ctypes.c_float), _ptr(out, ctypes.c_int16), audio.size)
        return out
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")


def pcm16_to_float(pcm: np.ndarray) -> np.ndarray:
    lib = _load()
    pcm = np.ascontiguousarray(pcm, np.int16)
    if lib is not None:
        out = np.empty(pcm.shape, np.float32)
        lib.pcm16_to_float(_ptr(pcm, ctypes.c_int16), _ptr(out, ctypes.c_float), pcm.size)
        return out
    return pcm.astype(np.float32) / 32768.0


def parse_smf_events(raw: bytes, output_ticks_per_quarter_note: int) -> np.ndarray | None:
    """``[N, 4]`` float64 note events (begin_tick, length, freq, velocity)
    of raw SMF bytes by the C++ parser; ``None`` without the library or
    when the parser declines the file (a structural error, SMPTE
    division), and the caller then runs the Python parser."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(raw, np.uint8)
    cap = max(len(raw), 16)
    out = np.empty((cap, 4), np.float64)
    n = lib.parse_smf_events(_ptr(buf, ctypes.c_uint8), len(raw),
                             output_ticks_per_quarter_note, _ptr(out, ctypes.c_double), cap)
    if n < 0:
        return None
    return out[:n].copy()
