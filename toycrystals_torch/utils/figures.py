"""Sample grids as PNG files, written with zlib and struct alone.

Counterpart of toycrystals_tpu/utils/figures.py:save_image_grid, with one
deliberate difference: the JAX package draws a matplotlib figure (axes, a
title, resampling to the figure's dpi), and the card machine has no
matplotlib. This writes the pixels themselves, as
toycrystals_tpu/serve.py:raw_png_bytes does: tiles on a white canvas with
2-px gaps, each pixel quantised to 8 bits as round(x * 255) with no
resampling, in one 8-bit grayscale PNG. toycrystals_tpu/utils/fidelity.py
recovers the tiles from such a grid. There is no loss-curve figure.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def quantize_u8(x) -> np.ndarray:
    """Images in [0, 1] as uint8: round(x * 255), clipped."""
    return np.clip(np.asarray(x, np.float32) * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def _grid_png(images, nrows: int = 6, ncols: int = 6, pad: int = 2) -> bytes:
    """The first nrows x ncols images of [N, H, W(, 1)] in [0, 1], row by
    row, as the bytes of an 8-bit grayscale PNG; cells without an image and
    the `pad`-px gaps are white."""
    x = np.asarray(images, np.float32)
    if x.ndim == 4:
        x = x[..., 0]
    n, h, w = x.shape
    canvas = np.full((nrows * (h + pad) + pad, ncols * (w + pad) + pad), 255, np.uint8)
    for i in range(min(n, nrows * ncols)):
        r, c = divmod(i, ncols)
        y0, x0 = pad + r * (h + pad), pad + c * (w + pad)
        canvas[y0:y0 + h, x0:x0 + w] = quantize_u8(x[i])
    hh, ww = canvas.shape
    # one filter byte (0, None) before each scanline
    scan = np.concatenate([np.zeros((hh, 1), np.uint8), canvas], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", ww, hh, 8, 0, 0, 0, 0)  # 8-bit grayscale
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(scan, 6)) + _chunk(b"IEND", b""))


def save_image_grid(images, out_path: str | Path, nrows: int = 6, ncols: int = 6,
                    pad: int = 2) -> None:
    """Write `_grid_png(images, nrows, ncols, pad)` to `out_path`."""
    p = Path(out_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(_grid_png(images, nrows, ncols, pad))
