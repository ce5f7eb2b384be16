"""Reference images and pose frames (port of svi_tpu/utils/image_process.py:
`calculate_dimensions`, `find_reference_image`, `resize_and_pad_to_target`),
and `resize_uint8`, Pillow's default resize in numpy.

A `.npy` file holding an (H, W, 3) uint8 image is read with numpy, so that a
machine without Pillow (the card's) can run the driver; Pillow is imported
only to open a `.jpg` / `.png`, and only it resizes a reference image."""

from __future__ import annotations

import os

import numpy as np


def _is_npy(path) -> bool:
    return isinstance(path, (str, os.PathLike)) and os.fspath(path).endswith(".npy")


def _open_pil(path):
    from PIL import Image

    return Image.open(path)


def _image_size(image_input) -> tuple[int, int]:
    """(width, height) of a PIL image, an (H, W, C) array or an image file."""
    if isinstance(image_input, np.ndarray):
        return image_input.shape[1], image_input.shape[0]
    if _is_npy(image_input):
        shape = np.load(image_input, mmap_mode="r").shape
        return shape[1], shape[0]
    if isinstance(image_input, (str, os.PathLike)):
        image_input = _open_pil(image_input)
    return image_input.size  # a PIL image


def calculate_dimensions(image_input, max_width: int = 640):
    """Aspect-preserving (height, width) rounded DOWN to multiples of 16."""
    ow, oh = _image_size(image_input)
    if ow <= max_width:
        width, height = ow, oh
    else:
        width = max_width
        height = int(width * (oh / ow))
    return (height // 16) * 16, (width // 16) * 16


def find_reference_image(ref_image_root: str) -> str:
    """frame.jpg > frame.png > first jpg > first png."""
    for name in ("frame.jpg", "frame.png"):
        p = os.path.join(ref_image_root, name)
        if os.path.exists(p):
            return p
    files = sorted(os.listdir(ref_image_root))
    for exts in ((".jpg", ".jpeg"), (".png",)):
        for f in files:
            if f.lower().endswith(exts):
                return os.path.join(ref_image_root, f)
    raise FileNotFoundError(f"No reference image (jpg/png) found in {ref_image_root}")


def load_reference_image(path: str, height: int, width: int) -> np.ndarray:
    """The reference image as an (height, width, 3) uint8 array: a `.npy`
    must already have that size; a `.jpg` / `.png` is converted to RGB and
    resized by Pillow (bicubic, Pillow's default, as the JAX driver does)."""
    if _is_npy(path):
        img = np.load(path)
        if img.shape != (height, width, 3) or img.dtype != np.uint8:
            raise ValueError(f"{path}: {img.shape} {img.dtype}, expected ({height}, {width}, 3) "
                             "uint8 (a .npy image is not resized)")
        return img
    return np.array(_open_pil(path).convert("RGB").resize((width, height)))


def resize_and_pad_to_target(frames: np.ndarray, target_size, pad_value=0.0) -> np.ndarray:
    """(b, c, h, w) -> an aspect-preserving nearest-neighbour resize, padded
    with pad_value around the centre to target_size (th, tw)."""
    th, tw = target_size
    b, c, h, w = frames.shape
    scale = min(th / h, tw / w)
    nh, nw = int(h * scale), int(w * scale)
    yi = (np.arange(nh) * (h / nh)).astype(np.int64).clip(0, h - 1)
    xi = (np.arange(nw) * (w / nw)).astype(np.int64).clip(0, w - 1)
    out = np.full((b, c, th, tw), pad_value, frames.dtype)
    top, left = (th - nh) // 2, (tw - nw) // 2
    out[:, :, top:top + nh, left:left + nw] = frames[:, :, yi][:, :, :, xi]
    return out



_PRECISION_BITS = 22  # Pillow's fixed point for 8-bit resampling


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (a = -0.5)."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _box(x: np.ndarray) -> np.ndarray:
    """Pillow's box filter: 1 on (-0.5, 0.5]."""
    return np.where((x > -0.5) & (x <= 0.5), 1.0, 0.0)


def _triangle(x: np.ndarray) -> np.ndarray:
    """Pillow's bilinear filter: 1 - |x| on (-1, 1)."""
    return np.maximum(1.0 - np.abs(x), 0.0)


# Pillow's filters and their supports
_FILTERS = {"bicubic": (_bicubic, 2.0), "box": (_box, 0.5), "bilinear": (_triangle, 1.0)}


def _resample_coeffs(in_size: int, out_size: int, resample: str = "bicubic"):
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc` for one axis:
    (out_size, taps) source indices and fixed-point weights (0 past a
    window's end)."""
    kernel, support = _FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    taps = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, taps), np.int64)
    kk = np.zeros((out_size, taps), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = kernel((np.arange(xmax) + xmin - center + 0.5) / filterscale)
        ww = w.sum()
        if ww != 0:
            w = w / ww
        fixed = w * (1 << _PRECISION_BITS)
        kk[xx, :xmax] = np.where(w < 0, (-0.5 + fixed).astype(np.int64),
                                 (0.5 + fixed).astype(np.int64))
        idx[xx, :xmax] = np.arange(xmax) + xmin
    return idx, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   resample: str = "bicubic") -> np.ndarray:
    """One 8-bit pass: fixed-point sums, rounded, clipped to uint8."""
    idx, kk = _resample_coeffs(img.shape[axis], out_size, resample)
    x = np.moveaxis(img, axis, -1).astype(np.int64)
    acc = np.full(x.shape[:-1] + (out_size,), 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(idx.shape[1]):
        acc += x[..., idx[:, t]] * kk[:, t]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def resize_uint8(image, width: int, height: int, resample: str = "bicubic") -> np.ndarray:
    """An (H, W, 3) uint8 frame (or a PIL image) resized to (height, width, 3)
    as Pillow's `Image.resize` does, byte for byte: bicubic (a = -0.5, its
    default), bilinear or box, the support widened by the shrink factor, the
    horizontal pass first, each pass in Pillow's 22-bit fixed point rounded
    to uint8."""
    arr = np.asarray(image)
    if arr.shape[1] != width:
        arr = _resample_axis(arr, width, 1, resample)
    if arr.shape[0] != height:
        arr = _resample_axis(arr, height, 0, resample)
    return np.array(arr)


def resize_nearest_uint8(image, width: int, height: int) -> np.ndarray:
    """An (H, W, C) uint8 frame (or a PIL image) resized to (height, width) as
    Pillow's `Image.resize(..., resample=NEAREST)`: each output pixel takes
    the source pixel under its centre, floor((x + 0.5) * in / out)."""
    arr = np.asarray(image)
    rows = np.minimum(((np.arange(height) + 0.5) * arr.shape[0] / height).astype(np.int64),
                      arr.shape[0] - 1)
    cols = np.minimum(((np.arange(width) + 0.5) * arr.shape[1] / width).astype(np.int64),
                      arr.shape[1] - 1)
    return np.ascontiguousarray(arr[rows][:, cols])
