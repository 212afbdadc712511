"""Animated GIF encoding: RGB frames on one fixed 256-colour palette,
LZW-compressed, each shown for a fixed delay, looping forever (the
NETSCAPE2.0 block), as matplotlib's pillow writer writes an animation.

The palette is a 6 x 6 x 6 colour cube (216 colours) and 40 greys; a
pixel whose channels differ by less than :data:`GREY_TOL` takes the
nearest grey, any other the nearest cube colour (no dithering).
"""

from __future__ import annotations

import struct

import numpy as np

CUBE = np.arange(6) * 51                       # the cube's levels, 0..255
GREYS = np.round(np.linspace(0, 255, 42)[1:-1]).astype(int)     # 40 greys strictly inside
GREY_TOL = 10
MIN_CODE = 8
MAX_CODES = 4096


def palette() -> np.ndarray:
    """The (256, 3) uint8 palette: the cube (index r*36 + g*6 + b), then
    the greys."""
    r, g, b = np.meshgrid(CUBE, CUBE, CUBE, indexing="ij")
    cube = np.column_stack([r.ravel(), g.ravel(), b.ravel()])
    return np.vstack([cube, np.repeat(GREYS[:, None], 3, axis=1)]).astype(np.uint8)


def quantize(rgb: np.ndarray) -> np.ndarray:
    """An (h, w, 3) uint8 frame as palette indices (h, w) uint8."""
    c = rgb.astype(np.int16)
    q = np.clip((c + 25) // 51, 0, 5)
    idx = q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]
    grey = (c.max(axis=-1) - c.min(axis=-1)) < GREY_TOL
    mean = c.sum(axis=-1) / 3.0
    gi = np.clip(np.rint(mean * (len(GREYS) + 1) / 255.0) - 1, 0, len(GREYS) - 1).astype(int)
    cube_err = np.abs(mean - q[..., 0] * 51)
    use_grey = grey & (np.abs(mean - GREYS[gi]) < cube_err)
    return np.where(use_grey, 216 + gi, idx).astype(np.uint8)


def lzw(indices: bytes) -> bytes:
    """GIF's variable-width LZW of 8-bit indices, packed LSB first and cut
    into sub-blocks of at most 255 bytes (terminator included)."""
    clear, eoi = 1 << MIN_CODE, (1 << MIN_CODE) + 1
    codes, sizes = [clear], [MIN_CODE + 1]
    table: dict = {}
    nxt, size = eoi + 1, MIN_CODE + 1
    it = iter(indices)
    w = next(it, None)
    if w is not None:
        for c in it:
            key = (w << 8) | c
            hit = table.get(key)
            if hit is not None:
                w = hit
                continue
            codes.append(w)
            sizes.append(size)
            if nxt < MAX_CODES:
                table[key] = nxt
                nxt += 1
                if nxt > (1 << size) and size < 12:
                    size += 1
            else:
                codes.append(clear)
                sizes.append(size)
                table.clear()
                nxt, size = eoi + 1, MIN_CODE + 1
            w = c
        codes.append(w)
        sizes.append(size)
    codes.append(eoi)
    sizes.append(size)
    codes_a, sizes_a = np.asarray(codes, np.int64), np.asarray(sizes, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes_a)[:-1]])
    bits = np.zeros(int(sizes_a.sum()) + 7, np.uint8)
    for b in range(12):
        on = sizes_a > b
        bits[starts[on] + b] = (codes_a[on] >> b) & 1
    data = np.packbits(bits[: int(sizes_a.sum())], bitorder="little").tobytes()
    blocks = [bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)]
    return b"".join(blocks) + b"\x00"


def encode_gif(frames, delay_cs: int) -> bytes:
    """Equal-sized (h, w, 3) uint8 frames as an animated GIF that shows
    each for ``delay_cs`` hundredths of a second and loops forever."""
    frames = list(frames)
    if not frames:
        raise ValueError("an animation needs at least one frame")
    h, w = frames[0].shape[:2]
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for f in frames:
        if f.shape[:2] != (h, w):
            raise ValueError(f"frame of {f.shape[:2]} in an animation of {(h, w)}")
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(bytes([MIN_CODE]) + lzw(quantize(f).tobytes()))
    out.append(b"\x3b")
    return b"".join(out)


def write_gif(path, frames, fps: float) -> str:
    """The frames as an animated GIF at ``fps`` frames a second (a delay
    of 1/fps, in whole hundredths)."""
    with open(path, "wb") as fh:
        fh.write(encode_gif(frames, int(round(100.0 / fps))))
    return str(path)
