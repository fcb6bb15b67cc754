"""Sample grids as PNG files, written with zlib and struct alone.

Counterpart of toycrystals_tpu/utils/figures.py:save_image_grid, with one
deliberate difference: the JAX package draws a matplotlib figure (axes, a
title, resampling to the figure's dpi), and the card machine has no
matplotlib. This writes the pixels themselves, as
toycrystals_tpu/serve.py:raw_png_bytes does: tiles on a white canvas with
2-px gaps, each pixel quantised to 8 bits as round(x * 255) with no
resampling, in one 8-bit grayscale PNG. toycrystals_tpu/utils/fidelity.py
recovers the tiles from such a grid. There is no loss-curve figure.

`read_png` decodes what both packages' grids are stored as (8-bit,
non-interlaced gray, RGB or RGBA, filter types 0-4) into floats value / 255,
as `matplotlib.pyplot.imread` does for a PNG.
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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _png_chunks(data: bytes, path) -> tuple[tuple[int, ...], bytes]:
    """(IHDR fields, concatenated IDAT bytes) of a PNG file's bytes; every
    chunk's CRC is checked."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(tag + body):
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    return header, b"".join(idat)


def _unfilter(filt: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Undo the PNG scanline filters. filt [H, W, C] uint8 (C bytes per
    pixel), types [H] in 0..4 -> the raw samples [H, W, C] uint8.

    Each pixel depends on its left, upper and upper-left neighbours, so the
    pixels of one anti-diagonal (y + x = k) are independent of each other:
    H + W - 1 vector steps decode every filter type at once."""
    h, w, c = filt.shape
    if types.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(types.max())} is not one of 0-4")
    out = np.zeros((h + 1, w + 1, c), np.int32)  # row 0 and column 0: the zero border
    f32 = filt.astype(np.int32)
    for k in range(h + w - 1):
        ys = np.arange(max(0, k - w + 1), min(h, k + 1))
        xs = k - ys
        a, b, cc = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]  # left, up, upper-left
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        t = types[ys][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (f32[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str | Path) -> np.ndarray:
    """An 8-bit, non-interlaced PNG as float32 value / 255, shaped as
    `plt.imread` returns it: [H, W] for gray, [H, W, 3] for RGB, [H, W, 4]
    for RGBA. Other bit depths and colour types (palettes, gray with alpha)
    and interlaced files raise ValueError."""
    header, idat = _png_chunks(Path(path).read_bytes(), path)
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"{path}: bit depth {depth}, colour type {colour}, interlace "
                         f"{interlace}; only 8-bit non-interlaced gray/RGB/RGBA is read")
    c = _PNG_CHANNELS[colour]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    if rows.size != h * (1 + w * c):
        raise ValueError(f"{path}: {rows.size} decompressed bytes, expected {h * (1 + w * c)}")
    rows = rows.reshape(h, 1 + w * c)
    px = _unfilter(rows[:, 1:].reshape(h, w, c), rows[:, 0])
    img = px.astype(np.float32) / 255.0
    return img[..., 0] if c == 1 else img
