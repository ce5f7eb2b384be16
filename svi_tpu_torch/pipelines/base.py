"""Host helpers of the pipelines, copied from svi_tpu/pipelines/base.py.

They are copied rather than imported: importing any `svi_tpu` submodule
imports JAX, and the port never does. Pillow is imported only by the
train-time first-frame augmentation (`apply_augmentation`), which is Pillow
code in the JAX package too; without Pillow it raises. Elsewhere a PIL image
handed in is read through `np.asarray`.
"""

from __future__ import annotations

import numpy as np
import torch


def check_resize_height_width(height: int, width: int, factor: int = 16):
    """Round up to the division factor (Wan uses 16)."""
    if height % factor != 0:
        height = (height + factor - 1) // factor * factor
    if width % factor != 0:
        width = (width + factor - 1) // factor * factor
    return height, width


def preprocess_image(image, use_aug: bool = False, rng=None) -> np.ndarray:
    """PIL.Image or (H, W, 3) uint8 array -> (1, 3, H, W) float32 in [-1, 1].
    use_aug applies the train-time first-frame augmentation first, drawing
    from the numpy Generator `rng` (a fresh unseeded one when None)."""
    if use_aug:
        image = apply_augmentation(image, rng=rng)
    arr = np.array(image, dtype=np.float32) * (2 / 255) - 1
    return arr.transpose(2, 0, 1)[None]


def apply_augmentation(image, rng=None):
    """Train-time condition-frame augmentation, the JAX package's: w.p. 0.7
    ColorJitter (brightness, contrast and saturation factors U[0.7, 1.3],
    hue shift U[-0.1, 0.1] of the HSV circle) in a random order, w.p. 0.5
    GaussianBlur (sigma U[0.1, 2]), w.p. 0.5 sharpness 2x; Pillow code with
    the same `rng` draws in the same order. Returns a PIL image."""
    try:
        from PIL import Image, ImageEnhance, ImageFilter
    except ImportError as err:
        raise RuntimeError("use_first_aug needs Pillow (the augmentation is Pillow's "
                           "ColorJitter, blur and sharpness), which is not installed; "
                           "train without --use_first_aug") from err

    rng = rng or np.random.default_rng()
    if isinstance(image, np.ndarray):
        image = Image.fromarray(image.astype(np.uint8))

    if rng.random() < 0.7:
        # torchvision's ColorJitter applies the four jitters in a random order
        ops = [
            ("brightness", lambda im, f: ImageEnhance.Brightness(im).enhance(f),
             1 + rng.uniform(-0.3, 0.3)),
            ("contrast", lambda im, f: ImageEnhance.Contrast(im).enhance(f),
             1 + rng.uniform(-0.3, 0.3)),
            ("saturation", lambda im, f: ImageEnhance.Color(im).enhance(f),
             1 + rng.uniform(-0.3, 0.3)),
            ("hue", None, rng.uniform(-0.1, 0.1)),
        ]
        for i in rng.permutation(4):
            name, fn, factor = ops[i]
            if name == "hue":
                hsv = np.array(image.convert("HSV"), dtype=np.int16)
                hsv[..., 0] = (hsv[..., 0] + int(factor * 255)) % 256
                image = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
            else:
                image = fn(image, factor)
    if rng.random() < 0.5:
        sigma = rng.uniform(0.1, 2.0)  # torchvision GaussianBlur's sigma range
        image = image.filter(ImageFilter.GaussianBlur(radius=sigma))
    if rng.random() < 0.5:
        image = ImageEnhance.Sharpness(image).enhance(2.0)
    return image


def generate_noise(shape, seed=None) -> torch.Tensor:
    """Seeded gaussian noise from torch.randn on a CPU generator: bit-identical
    to the JAX package's noise and to the reference's."""
    gen = None if seed is None else torch.Generator("cpu").manual_seed(int(seed))
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def frames_from_uint8(video_u8: np.ndarray) -> list[np.ndarray]:
    """(3, T, H, W) uint8 -> list of T (H, W, 3) uint8 frames."""
    return list(np.ascontiguousarray(np.transpose(video_u8, (1, 2, 3, 0))))
