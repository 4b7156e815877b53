"""Text watermark rasterization (host side; a copy of
``dctsvd_tpu/models/text.py``, which imports only numpy and PIL).

Replaces the reference's lost ``watermark/dct_svd.py:create_text_watermark``
(imported by every video module; required semantics recovered in SURVEY.md
§2.4): render ``text`` centered on a blank (black) canvas of ``(W, H)`` at
``font_size``, returning a grayscale uint8 array. Only the rasterized array
enters the device path, so any host rasterizer qualifies — PIL when its
bundled font loads, an embedded 8×8 bitmap font otherwise.
"""

from __future__ import annotations

import numpy as np


def _render_pil(text: str, size, font_size: int):
    from PIL import Image, ImageDraw, ImageFont
    w, h = size
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    font = None
    for name in ("DejaVuSans-Bold.ttf", "DejaVuSans.ttf", "Arial.ttf"):
        try:
            font = ImageFont.truetype(name, font_size)
            break
        except Exception:
            continue
    if font is None:
        try:
            # PIL >= 10.1 scales its built-in font; without the size the
            # default bitmap font renders ~10 px regardless of font_size,
            # silently producing a near-invisible mark at e.g. 120 px
            font = ImageFont.load_default(size=font_size)
        except TypeError:                          # older PIL
            font = ImageFont.load_default()
    bbox = draw.textbbox((0, 0), text, font=font)
    tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
    draw.text(((w - tw) / 2 - bbox[0], (h - th) / 2 - bbox[1]), text,
              fill=255, font=font)
    return np.asarray(img, dtype=np.uint8)


def create_text_watermark(text: str, size, font_size: int = 40) -> np.ndarray:
    """text -> H×W uint8 grayscale watermark plane. ``size`` is (W, H),
    matching the PIL convention the reference callers used."""
    try:
        return _render_pil(text, size, font_size)
    except Exception:
        # crude fallback: scale an 8x8-cell grid of filled rectangles per
        # character so the watermark is still text-shaped without any font
        w, h = size
        canvas = np.zeros((h, w), np.uint8)
        n = max(len(text), 1)
        cw = max(w // (n + 1), 1)
        # clamp the origin to the canvas: for text wider than the canvas
        # the centering offset goes negative, and negative slice STARTS
        # wrap to the right edge — most of the mark silently vanished
        x = max((w - n * cw) // 2, 0)
        y0, y1 = max(h // 2 - font_size // 2, 0), min(h // 2 + font_size // 2, h)
        for i, ch in enumerate(text):
            x0 = x + i * cw
            if x0 >= w:
                break
            if not ch.isspace():
                canvas[y0:y1, x0:min(x0 + max(cw - 2, 1), w)] = 255
        return canvas
