"""The PDF back end: display lists as vector pages of one PDF 1.4 file.

A page is the figure's size in points. Strokes and fills are paths,
markers paths (a disc as four Bézier arcs), images XObjects (RGB, with a
soft mask where a cell is transparent) drawn cell by cell without
interpolation; alpha goes through ExtGState entries. Every stream is
FlateDecode-compressed, and the cross-reference table holds each object's
exact byte offset.
"""

from __future__ import annotations

import zlib

import numpy as np

from phoskintime_tpu_torch.report.draw.display import Fill, Marks, Picture, Stroke, marker_polygon

KAPPA = 0.5522847498     # a quarter circle as one cubic Bézier


def _n(v: float) -> str:
    text = f"{v:.3f}".rstrip("0").rstrip(".")
    return "0" if text in ("-0", "") else text


class _Page:
    """One page's content stream and the resources it names."""

    def __init__(self, height: float):
        self.height = height
        self.out: list[str] = []
        self.alphas: dict[float, str] = {}
        self.images: list[np.ndarray] = []

    def xy(self, p) -> str:
        return f"{_n(p[0])} {_n(self.height - p[1])}"

    def begin(self, clip, color, alpha_ops: str) -> None:
        self.out.append("q")
        if clip is not None:
            x0, y0, x1, y1 = clip
            self.out.append(f"{_n(x0)} {_n(self.height - y1)} {_n(x1 - x0)} {_n(y1 - y0)} "
                            "re W n")
        a = float(color[3])
        if a < 1.0:
            name = self.alphas.setdefault(a, f"A{len(self.alphas)}")
            self.out.append(f"/{name} gs")
        self.out.append(" ".join(_n(c) for c in color[:3]) + " " + alpha_ops)

    def path(self, pts, close: bool) -> None:
        self.out.append(self.xy(pts[0]) + " m")
        for p in (pts[1:] if len(pts) > 1 else pts):
            self.out.append(self.xy(p) + " l")
        if close:
            self.out.append("h")

    def disc(self, c, r: float) -> None:
        x, y = c[0], self.height - c[1]
        k = KAPPA * r
        pts = [(x + r, y), (x + r, y + k, x + k, y + r, x, y + r),
               (x - k, y + r, x - r, y + k, x - r, y), (x - r, y - k, x - k, y - r, x, y - r),
               (x + k, y - r, x + r, y - k, x + r, y)]
        self.out.append(f"{_n(pts[0][0])} {_n(pts[0][1])} m")
        self.out += [" ".join(_n(v) for v in seg) + " c" for seg in pts[1:]]
        self.out.append("h")

    def paint(self, op) -> None:
        if isinstance(op, Stroke):
            self.begin(op.clip, op.color, "RG")
            self.out.append(f"{_n(op.width)} w 1 J 1 j")
            if op.dash is not None:
                self.out.append(f"[{_n(op.dash[0])} {_n(op.dash[1])}] 0 d")
            for p in op.lines:
                if len(p):
                    self.path(p, close=False)
            self.out += ["S", "Q"]
        elif isinstance(op, Fill):
            self.begin(op.clip, op.color, "rg")
            for p in op.polys:
                if len(p) >= 3:
                    self.path(p, close=True)
            self.out += ["f*", "Q"]
        elif isinstance(op, Marks):
            self.begin(op.clip, op.color, "rg")
            shape = None if op.shape == "o" else marker_polygon(op.shape, op.size)
            for c in op.centers:
                if not np.isfinite(c).all():
                    continue
                if shape is None:
                    self.disc(c, op.size / 2)
                else:
                    self.path(shape + c, close=True)
            self.out += ["f", "Q"]
        elif isinstance(op, Picture):
            self.begin(op.clip, (0.0, 0.0, 0.0, 1.0), "rg")
            x0, y0, x1, y1 = op.rect
            self.out.append(f"{_n(x1 - x0)} 0 0 {_n(y1 - y0)} {_n(x0)} {_n(self.height - y1)} cm")
            self.out += [f"/Im{len(self.images)} Do", "Q"]
            self.images.append(op.rgba)
        else:
            raise TypeError(f"not a display-list primitive: {op!r}")


class PdfDocument:
    """Pages added one by one (:meth:`add_page`), written by :meth:`save`."""

    def __init__(self):
        self.pages: list[tuple[float, float, list]] = []

    def add_page(self, ops, width: float, height: float) -> None:
        self.pages.append((float(width), float(height), list(ops)))

    def to_bytes(self) -> bytes:
        objects: list[bytes] = []

        def add(body: bytes) -> int:
            objects.append(body)
            return len(objects)

        def stream(meta: str, data: bytes) -> bytes:
            z = zlib.compress(data)
            return (f"<< {meta} /Filter /FlateDecode /Length {len(z)} >>\nstream\n".encode()
                    + z + b"\nendstream")

        add(b"<< /Type /Catalog /Pages 2 0 R >>")
        add(b"")                                   # the page tree, filled in below
        kids = []
        for width, height, ops in self.pages:
            page = _Page(height)
            for op in ops:
                page.paint(op)
            content = add(stream("", "\n".join(page.out).encode()))
            xobjects = []
            for rgba in page.images:
                h, w = rgba.shape[:2]
                meta = (f"/Type /XObject /Subtype /Image /Width {w} /Height {h} "
                        "/BitsPerComponent 8 /Interpolate false")
                smask = ""
                if (rgba[..., 3] < 255).any():
                    s = add(stream(meta + " /ColorSpace /DeviceGray",
                                   np.ascontiguousarray(rgba[..., 3]).tobytes()))
                    smask = f" /SMask {s} 0 R"
                xobjects.append(add(stream(meta + " /ColorSpace /DeviceRGB" + smask,
                                           np.ascontiguousarray(rgba[..., :3]).tobytes())))
            res = " ".join(f"/Im{i} {o} 0 R" for i, o in enumerate(xobjects))
            gs = " ".join(f"/{name} << /Type /ExtGState /CA {_n(a)} /ca {_n(a)} >>"
                          for a, name in page.alphas.items())
            kids.append(add(
                f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {_n(width)} {_n(height)}] "
                f"/Contents {content} 0 R /Resources << /XObject << {res} >> "
                f"/ExtGState << {gs} >> >> >>".encode()))
        objects[1] = (f"<< /Type /Pages /Kids [{' '.join(f'{k} 0 R' for k in kids)}] "
                      f"/Count {len(kids)} >>").encode()

        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = []
        for i, body in enumerate(objects, start=1):
            offsets.append(len(out))
            out += f"{i} 0 obj\n".encode() + body + b"\nendobj\n"
        xref = len(out)
        out += f"xref\n0 {len(objects) + 1}\n0000000000 65535 f \n".encode()
        out += b"".join(f"{o:010d} 00000 n \n".encode() for o in offsets)
        out += (f"trailer\n<< /Size {len(objects) + 1} /Root 1 0 R >>\nstartxref\n{xref}\n"
                "%%EOF\n").encode()
        return bytes(out)

    def save(self, path) -> str:
        with open(path, "wb") as fh:
            fh.write(self.to_bytes())
        return str(path)
