"""Font resources: TTF rasterization, glyph atlas, text metrics
(≙ reference src/renderer/font.{h,cpp} — FontResource + FontAtlas baked with
FreeType; here PIL's FreeType binding rasterizes into a numpy atlas).

The atlas and metrics are HOST data: text layout is a CPU job in the
reference too (Draw2D emits per-glyph quads; the GPU only samples the atlas).
`Font.layout` returns per-glyph quads + UVs ready for the Draw2D payload /
draw stream; `rasterize_text` composites a whole string for the headless
viewer and tests.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

DEFAULT_FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
_PRINTABLE = [chr(c) for c in range(32, 127)]


@dataclass
class Glyph:
    uv: Tuple[int, int, int, int]   # x0,y0,x1,y1 in atlas pixels
    advance: float
    bearing_x: float
    bearing_y: float                # offset from baseline to glyph top (px, +up)
    size: Tuple[int, int]           # w,h of the bitmap


class Font:
    """One (face, size) — atlas of ASCII glyphs + metrics. `path` None is
    the default face: DEFAULT_FONT, or on a host that lacks it the FreeType
    face PIL ships (``ImageFont.load_default``)."""

    def __init__(self, path: Optional[str] = None, size: int = 24):
        from PIL import ImageFont

        self.size = int(size)
        if path is None and not os.path.exists(DEFAULT_FONT):
            self.path = None
            self._pil = ImageFont.load_default(self.size)
        else:
            self.path = path or DEFAULT_FONT
            self._pil = ImageFont.truetype(self.path, self.size)
        ascent, descent = self._pil.getmetrics()
        self.ascent = float(ascent)
        self.descent = float(descent)
        self.line_height = float(ascent + descent)
        self.glyphs: Dict[str, Glyph] = {}
        self.atlas = self._bake()

    def _bake(self) -> np.ndarray:
        from PIL import Image, ImageDraw

        pad = 1
        # measure all glyphs first
        boxes = {}
        for ch in _PRINTABLE:
            l, t, r, b = self._pil.getbbox(ch)
            boxes[ch] = (l, t, r, b)
        cell_w = max(r - l for l, t, r, b in boxes.values()) + 2 * pad
        cell_h = max(b - t for l, t, r, b in boxes.values()) + 2 * pad
        cols = 16
        rows = (len(_PRINTABLE) + cols - 1) // cols
        W, H = cols * cell_w, rows * cell_h
        img = Image.new("L", (W, H), 0)
        draw = ImageDraw.Draw(img)
        for i, ch in enumerate(_PRINTABLE):
            l, t, r, b = boxes[ch]
            cx = (i % cols) * cell_w + pad
            cy = (i // cols) * cell_h + pad
            # draw at (cx - l, cy - t) so the ink lands at the cell origin
            draw.text((cx - l, cy - t), ch, fill=255, font=self._pil)
            self.glyphs[ch] = Glyph(
                uv=(cx, cy, cx + (r - l), cy + (b - t)),
                advance=float(self._pil.getlength(ch)),
                bearing_x=float(l),
                bearing_y=float(self.ascent - t),
                size=(r - l, b - t),
            )
        return np.asarray(img, np.uint8)

    # -- metrics (≙ font.cpp measureText) ----------------------------------

    def text_width(self, text: str) -> float:
        return float(self._pil.getlength(text))

    def text_extents(self, text: str) -> Tuple[float, float]:
        lines = text.split("\n") or [""]
        w = max((self.text_width(ln) for ln in lines), default=0.0)
        return w, self.line_height * len(lines)

    def caret_x(self, text: str, index: int) -> float:
        """Pixel x of the caret before character `index` (InputField)."""
        return self.text_width(text[: max(0, index)])

    def index_at(self, text: str, x: float) -> int:
        """Caret index closest to pixel offset x (click-to-place caret)."""
        best, best_d = 0, abs(x)
        for i in range(1, len(text) + 1):
            d = abs(self.text_width(text[:i]) - x)
            if d < best_d:
                best, best_d = i, d
        return best

    # -- layout (≙ Draw2D::addText emitting per-glyph quads) ---------------

    def layout(self, text: str, x: float = 0.0, y: float = 0.0
               ) -> List[Tuple[float, float, float, float, int, int, int, int]]:
        """Per-glyph quads: (x0,y0,x1,y1, u0,v0,u1,v1). y is the TOP of the
        first line (GUI rect convention); baseline = y + ascent."""
        out = []
        pen_x, pen_y = x, y
        for ch in text:
            if ch == "\n":
                pen_x = x
                pen_y += self.line_height
                continue
            g = self.glyphs.get(ch) or self.glyphs.get("?")
            if g is None:
                continue
            gx0 = pen_x + g.bearing_x
            gy0 = pen_y + self.ascent - g.bearing_y
            out.append((gx0, gy0, gx0 + g.size[0], gy0 + g.size[1], *g.uv))
            pen_x += g.advance
        return out

    def rasterize_text(self, text: str) -> np.ndarray:
        """Composite a string into a u8 grayscale image (viewer/tests)."""
        w, h = self.text_extents(text)
        img = np.zeros((int(np.ceil(h)) + 2, int(np.ceil(w)) + 2), np.uint8)
        for x0, y0, x1, y1, u0, v0, u1, v1 in self.layout(text):
            src = self.atlas[v0:v1, u0:u1]
            yi, xi = int(round(y0)), int(round(x0))
            if yi < 0 or xi < 0:
                continue
            hh, ww = src.shape
            dst = img[yi:yi + hh, xi:xi + ww]
            if dst.shape == src.shape:
                np.maximum(dst, src, out=dst)
        return img


class FontSystem:
    """Font registry keyed by (path, size) (≙ FontManager in the reference);
    fonts are immutable once baked, so sharing is safe."""

    def __init__(self):
        self._fonts: Dict[Tuple[Optional[str], int], Font] = {}

    def load(self, path: Optional[str] = None, size: int = 24) -> Font:
        key = (path, int(size))
        if key not in self._fonts:
            self._fonts[key] = Font(path, size)
        return self._fonts[key]
