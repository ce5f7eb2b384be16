"""Host helpers of the pipelines, copied from svi_tpu/pipelines/base.py, and
the regional-prompt merge (`merge_latents`, `control_noise_via_local_prompts`,
`extend_prompt`) on torch tensors.

They are copied rather than imported: importing any `svi_tpu` submodule
imports JAX, and the port never does. Pillow is imported only by the
train-time first-frame augmentation (`apply_augmentation`), which is Pillow
code in the JAX package too; without Pillow it raises. Elsewhere a PIL image
handed in is read through `np.asarray`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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


def generate_noise(shape, seed=None, dtype=torch.float32) -> torch.Tensor:
    """Seeded gaussian noise from torch.randn on a CPU generator: bit-identical
    to the JAX package's noise and to the reference's; drawn in f32, then
    cast to dtype."""
    gen = None if seed is None else torch.Generator("cpu").manual_seed(int(seed))
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(dtype)


def tensor_to_frames(video) -> list[np.ndarray]:
    """(3, T, H, W) in about [-1, 1] (a tensor on any device, or an array) ->
    T (H, W, 3) uint8 frames (svi_tpu's returns PIL images)."""
    arr = video.float().cpu().numpy() if isinstance(video, torch.Tensor) else np.asarray(video)
    frames = ((np.transpose(arr, (1, 2, 3, 0)) + 1) * 127.5).clip(0, 255).astype(np.uint8)
    return list(frames)


def frames_from_uint8(video_u8: np.ndarray) -> list[np.ndarray]:
    """(3, T, H, W) uint8 -> list of T (H, W, 3) uint8 frames."""
    return list(np.ascontiguousarray(np.transpose(video_u8, (1, 2, 3, 0))))


# -- regional prompts -----------------------------------------------------------


def _gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    """torchvision's `_get_gaussian_kernel1d`: a symmetric normalized gaussian."""
    lim = (kernel_size - 1) / 2
    x = np.linspace(-lim, lim, kernel_size)
    pdf = np.exp(-0.5 * (x / sigma) ** 2)
    return (pdf / pdf.sum()).astype(np.float32)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """numpy's 'reflect' padding of a length-n axis by pad on each side as
    indices (reflected again where pad >= n, which torch's pad refuses)."""
    i = np.arange(-pad, n + pad)
    if n > 1:
        i = np.abs(i) % (2 * (n - 1))
        i = np.where(i > n - 1, 2 * (n - 1) - i, i)
    else:
        i = np.zeros_like(i)
    return torch.from_numpy(i).to(device)


def gaussian_blur(x: torch.Tensor, kernel_size: int = 33, sigma: float = 10.0) -> torch.Tensor:
    """torchvision's GaussianBlur on (B, C, H, W) f32: a separable,
    reflect-padded convolution (in f32: `ops.conv.conv_f32`)."""
    from ..ops.conv import conv_f32

    c, h, w = x.shape[1:]
    k = torch.from_numpy(_gaussian_kernel1d(kernel_size, sigma)).to(x.device)
    pad = kernel_size // 2
    x = x.float().index_select(2, _reflect_index(h, pad, x.device))
    x = conv_f32(F.conv2d, x, k.view(1, 1, -1, 1).expand(c, 1, -1, 1).contiguous(), groups=c)
    x = x.index_select(3, _reflect_index(w, pad, x.device))
    return conv_f32(F.conv2d, x, k.view(1, 1, 1, -1).expand(c, 1, 1, -1).contiguous(), groups=c)


def merge_latents(value, latents, masks, scales, blur_kernel_size=33, blur_sigma=10.0):
    """The global prediction averaged with the regional ones, each weighted
    by its feathered mask times its scale. value, latents: (B, C, h, w)
    tensors; masks: (H, W, 3) uint8 frames (or PIL images) resized to (h, w),
    a region where their mean is above mid-grey."""
    from ..utils.image_process import resize_uint8

    value = value.float().clone()
    if len(latents) > 0:
        height, width = value.shape[-2:]
        weight = torch.ones_like(value)
        for latent, mask, scale in zip(latents, masks, scales):
            m = torch.from_numpy(preprocess_image(resize_uint8(mask, width, height))).to(
                value.device)
            m = (m.mean(dim=1, keepdim=True) > 0).float().repeat(1, value.shape[1], 1, 1)
            m = gaussian_blur(m, blur_kernel_size, blur_sigma)
            value += latent.float() * m * scale
            weight += m * scale
        value /= weight
    return value


def control_noise_via_local_prompts(prompt_emb_global, prompt_emb_locals, masks, mask_scales,
                                    inference_callback, special_kwargs=None,
                                    special_local_kwargs_list=None):
    """The model once on the global prompt and once per regional prompt,
    merged by `merge_latents`."""
    if special_kwargs is None:
        noise_pred_global = inference_callback(prompt_emb_global)
    else:
        noise_pred_global = inference_callback(prompt_emb_global, special_kwargs)
    if special_local_kwargs_list is None:
        noise_pred_locals = [inference_callback(e) for e in prompt_emb_locals]
    else:
        noise_pred_locals = [inference_callback(e, kw)
                             for e, kw in zip(prompt_emb_locals, special_local_kwargs_list)]
    return merge_latents(noise_pred_global, noise_pred_locals, masks, mask_scales)


def extend_prompt(prompter, prompt, local_prompts, masks, mask_scales):
    """The prompter's extended regions (scale 100 each) added to the user's."""
    local_prompts = list(local_prompts or [])
    masks = list(masks or [])
    mask_scales = list(mask_scales or [])
    extend = getattr(prompter, "extend_prompt", None)
    extended = extend(prompt) if extend is not None else {"prompt": prompt}
    prompt = extended.get("prompt", prompt)
    local_prompts += extended.get("prompts", [])
    masks += extended.get("masks", [])
    mask_scales += [100.0] * len(extended.get("masks", []))
    return prompt, local_prompts, masks, mask_scales
