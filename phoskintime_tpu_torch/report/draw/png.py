"""PNG encoding of an RGB canvas: the signature, IHDR, pHYs (the dpi),
one zlib-compressed IDAT of filter-0 scanlines and IEND, each chunk with
its CRC-32."""

from __future__ import annotations

import binascii
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
LEVEL = 1


def chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", binascii.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray, dpi: float | None = None) -> bytes:
    """An (h, w, 3) or (h, w, 4) uint8 array as PNG bytes (8-bit RGB or
    RGBA); ``dpi`` goes into pHYs as pixels a metre."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] not in (3, 4):
        raise ValueError(f"expected an (h, w, 3|4) array, got {rgb.shape}")
    h, w, c = rgb.shape
    raw = np.zeros((h, 1 + w * c), np.uint8)
    raw[:, 1:] = rgb.reshape(h, w * c)
    out = [SIGNATURE, chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6,
                                                 0, 0, 0))]
    if dpi is not None:
        ppm = int(round(dpi / 0.0254))
        out.append(chunk(b"pHYs", struct.pack(">IIB", ppm, ppm, 1)))
    out += [chunk(b"IDAT", zlib.compress(raw.tobytes(), LEVEL)), chunk(b"IEND", b"")]
    return b"".join(out)


def write_png(path, rgb: np.ndarray, dpi: float | None = None) -> str:
    with open(path, "wb") as fh:
        fh.write(encode_png(rgb, dpi))
    return str(path)
