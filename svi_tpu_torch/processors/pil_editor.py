"""Contrast and sharpness editors, port of svi_tpu/processors/pil_editor.py:
Pillow's `ImageEnhance.Contrast` and `ImageEnhance.Sharpness` computed in
numpy with Pillow's arithmetic (the same f32 operations in the same order,
the same truncations), so they need no Pillow and give its bytes.
"""

from __future__ import annotations

import numpy as np

from .base import VideoProcessor


def _blend(degenerate: np.ndarray, image: np.ndarray, factor: float) -> np.ndarray:
    """Pillow's Image.blend on uint8: in1 + alpha * (in2 - in1) in f32 with
    alpha rounded to f32, clipped to [0, 255] and truncated."""
    a = np.float32(factor)
    d1 = degenerate.astype(np.float32)
    out = d1 + a * (image.astype(np.float32) - d1)
    return np.clip(out, 0, 255).astype(np.uint8)


def contrast(image, factor: float) -> np.ndarray:
    """Blend towards a grey frame at the rounded mean of Pillow's luma
    (L = (19595 R + 38470 G + 7471 B + 2^15) >> 16)."""
    img = np.asarray(image, np.uint8)
    rgb = img.astype(np.int64)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16
    mean = int(luma.sum() / luma.size + 0.5)
    return _blend(np.full_like(img, mean), img, factor)


def _smooth(img: np.ndarray) -> np.ndarray:
    """Pillow's ImageFilter.SMOOTH (3x3, centre 5, the rest 1, over 13) on
    the interior, the rows below, at and above each pixel summed in that
    order; the border rows and columns are copied."""
    k = np.float32(1) / np.float32(13)
    kc = np.float32(5) / np.float32(13)
    f = img.astype(np.float32)
    out = img.copy()

    def row(r, centre):  # a kernel row over columns x - 1, x, x + 1 of row r
        return (r[:, :-2] * k + r[:, 1:-1] * centre) + r[:, 2:] * k

    ss = np.float32(0) + row(f[2:], k)
    ss = ss + row(f[1:-1], kc)
    ss = ss + row(f[:-2], k)
    # clipped, then rounded half up (truncation of ss + 0.5)
    out[1:-1, 1:-1] = np.where(ss <= 0, 0, np.where(ss >= 255, 255, ss + np.float32(0.5))
                               ).astype(np.uint8)
    return out


def sharpness(image, factor: float) -> np.ndarray:
    img = np.asarray(image, np.uint8)
    return _blend(_smooth(img), img, factor)


class ContrastEditor(VideoProcessor):
    def __init__(self, rate=1.5):
        self.rate = rate

    @staticmethod
    def from_model_manager(model_manager, **kwargs):
        return ContrastEditor(**kwargs)

    def __call__(self, rendered_frames, **kwargs):
        return [contrast(f, self.rate) for f in rendered_frames]


class SharpnessEditor(VideoProcessor):
    def __init__(self, rate=1.5):
        self.rate = rate

    @staticmethod
    def from_model_manager(model_manager, **kwargs):
        return SharpnessEditor(**kwargs)

    def __call__(self, rendered_frames, **kwargs):
        return [sharpness(f, self.rate) for f in rendered_frames]
