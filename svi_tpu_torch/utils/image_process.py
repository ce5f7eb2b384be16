"""Reference images (port of svi_tpu/utils/image_process.py:
`calculate_dimensions`, `find_reference_image`).

A `.npy` file holding an (H, W, 3) uint8 image is read with numpy, so that a
machine without Pillow (the card's) can run the driver; Pillow is imported
only to open a `.jpg` / `.png`, and only it resizes."""

from __future__ import annotations

import os

import numpy as np


def _is_npy(path) -> bool:
    return isinstance(path, (str, os.PathLike)) and os.fspath(path).endswith(".npy")


def _open_pil(path):
    from PIL import Image

    return Image.open(path)


def _image_size(image_input) -> tuple[int, int]:
    """(width, height) of a PIL image or an image file."""
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
