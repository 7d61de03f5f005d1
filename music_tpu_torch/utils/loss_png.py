"""A loss curve drawn as a PNG with numpy and the standard library, for
``vis loss`` on a host without matplotlib (:mod:`.visualize` draws it with
matplotlib where it is installed): the curve in blue inside a black frame
on white, no labels."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from music_tpu_torch.utils.visualize import get_loss, get_loss_jsonl

WIDTH, HEIGHT, MARGIN = 640, 360, 24


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """8-bit RGB PNG bytes of ``rgb [H, W, 3]`` uint8."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 9))
            + _chunk(b"IEND", b""))


def draw_curve(xs, ys) -> np.ndarray:
    """``[HEIGHT, WIDTH, 3]`` uint8: the polyline through ``(xs, ys)``
    scaled to the frame."""
    img = np.full((HEIGHT, WIDTH, 3), 255, np.uint8)
    x0, x1, y0, y1 = MARGIN, WIDTH - MARGIN, MARGIN, HEIGHT - MARGIN
    img[[y0, y1], x0:x1 + 1] = 0
    img[y0:y1 + 1, [x0, x1]] = 0
    xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    if xs.size == 0:
        return img

    def scale(v, lo, hi):
        span = v.max() - v.min()
        return lo + (v - v.min()) / span * (hi - lo) if span > 0 else np.full_like(v, (lo + hi) / 2)

    px, py = scale(xs, x0 + 2, x1 - 2), scale(-ys, y0 + 2, y1 - 2)
    for i in range(max(len(px) - 1, 1)):
        j = min(i + 1, len(px) - 1)
        n = int(max(abs(px[j] - px[i]), abs(py[j] - py[i]))) + 1
        cols = np.rint(np.linspace(px[i], px[j], n)).astype(int)
        rows = np.rint(np.linspace(py[i], py[j], n)).astype(int)
        img[rows, cols] = (31, 119, 180)
    return img


def plot_loss_png(log_path: str | Path, out_path: str | Path = "loss.png") -> Path:
    """The loss curve of a ``loss_log.log`` or ``metrics.jsonl``, as
    :func:`~music_tpu_torch.utils.visualize.plot_loss` reads them."""
    log_path = Path(log_path)
    steps, losses = (get_loss_jsonl if log_path.suffix == ".jsonl" else get_loss)(log_path)
    Path(out_path).write_bytes(encode_png(draw_curve(steps, losses)))
    return Path(out_path)
