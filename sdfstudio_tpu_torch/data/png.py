"""A PNG reader and writer from the standard library and numpy.

The JAX package reads images with PIL (``data/dataparsers/base.py:57``
``load_image``); the card's machine has no PIL, so the port keeps its own
decoder: ``zlib`` for the deflate stream, numpy for the None, Sub and Up
filters, and a byte loop for Average and Paeth, whose every byte depends on
its reconstructed left neighbour. It reads non-interlaced 8-bit greyscale, grey + alpha, RGB and RGBA images with
the five filter types (None, Sub, Up, Average, Paeth) and raises on every
other format (palette, 1/2/4/16-bit, interlaced); it never falls back.
``write_png`` writes the same 8-bit formats, every row with filter None,
where the JAX package writes with PIL (``Image.fromarray(...).save``): the
files differ, their pixels do not.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    """Undo the Paeth filter in place (PNG spec 9.4): each byte depends on
    its reconstructed left neighbour, so the row is a sequential loop."""
    for i in range(bpp):  # no left neighbour: a = c = 0, the predictor is b
        cur[i] = (cur[i] + prev[i]) & 0xFF
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], prev[i], prev[i - bpp]
        pa, pb = abs(b - c), abs(a - c)  # |p - a|, |p - b| for p = a + b - c
        pc = abs(a + b - c - c)
        if pa <= pb and pa <= pc:
            cur[i] = (cur[i] + a) & 0xFF
        elif pb <= pc:
            cur[i] = (cur[i] + b) & 0xFF
        else:
            cur[i] = (cur[i] + c) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def read_png(path: Union[str, Path]) -> np.ndarray:
    """uint8 [H, W] for greyscale, [H, W, C] otherwise, as PIL's
    ``np.asarray(Image.open(path))`` gives them."""
    data = Path(path).read_bytes()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind == b"PLTE":
            raise ValueError(f"{path}: palette PNGs are not supported")
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in CHANNELS or comp != 0 or filt != 0 or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}); only 8-bit non-interlaced grey/RGB(A) is read"
        )
    bpp = CHANNELS[ctype]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    types = rows[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown filter type {int(types.max())}")
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        f = rows[y, 1:]
        t = types[y]
        if t == 0:
            cur = f.copy()
        elif t == 1:
            # each byte adds the reconstructed byte bpp to its left: a running
            # sum per channel, modulo 256 (uint8 wraps)
            cur = np.cumsum(f.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif t == 2:
            cur = f + prev
        else:
            buf = bytearray(f.tobytes())
            (_average_row if t == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        out[y] = cur
        prev = out[y]
    return out.reshape(height, width) if bpp == 1 else out.reshape(height, width, bpp)


def load_image(path: Union[str, Path]) -> np.ndarray:
    """uint8 image file -> float32 [H, W, C] in [0, 1] (base.py:57-63)."""
    img = read_png(path).astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[..., None]
    return img


COLOUR_TYPES = {c: t for t, c in CHANNELS.items()}  # samples per pixel -> colour type


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: Union[str, Path], image: np.ndarray) -> None:
    """uint8 [H, W] (greyscale) or [H, W, C] with C in 1-4 -> a non-interlaced
    8-bit PNG (PNG spec 11.2: IHDR, one IDAT, IEND)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[-1] not in COLOUR_TYPES):
        raise ValueError(f"write_png takes [H, W] or [H, W, 1-4], got {img.shape}")
    height, width = img.shape[:2]
    ctype = COLOUR_TYPES[1 if img.ndim == 2 else img.shape[-1]]
    rows = np.ascontiguousarray(img).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)  # filter byte 0 a row
    header = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    Path(path).write_bytes(SIGNATURE + _chunk(b"IHDR", header)
                           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))
