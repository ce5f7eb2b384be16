"""SD 1.5 text- and image-to-image pipeline, port of svi_tpu/pipelines/sd_image.py:
CFG denoising through EnhancedDDIMScheduler, img2img by `add_noise` at the
first timestep, regional prompts merged by feathered masks.

CFG runs the positive and negative branches as one UNet batch of two, their
contexts padded to the same number of 77-token chunks by repeating the last
chunk, as the JAX package pads them; with regional prompts the branches run
apart, so that only the positive one is merged. Models are the port's
`ParamTree`s (`models.sd`), cast to the pipeline's dtype (f32 by default)
and used on the device they lie on. Images are (H, W, 3) uint8 arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import sd
from ..prompters.sd_prompter import SDPrompter
from ..schedulers.ddim import EnhancedDDIMScheduler
from .base import (check_resize_height_width, control_noise_via_local_prompts, extend_prompt,
                   generate_noise, preprocess_image)


def cast_model(model, dtype):
    """A model in `dtype` (the model itself when it is already)."""
    if model is None:
        return None
    if any(p.dtype != dtype for p in model.parameters()):
        model = model.to(dtype)
    return model


def model_device(*models) -> torch.device:
    for m in models:
        if m is not None:
            return next(m.parameters()).device
    raise ValueError("no model given")


def vae_output_to_frames(vae_output: torch.Tensor) -> list[np.ndarray]:
    """(B, 3, H, W) in about [-1, 1] -> B (H, W, 3) uint8 frames."""
    arr = vae_output.float().permute(0, 2, 3, 1).cpu().numpy()
    return list(((arr / 2 + 0.5).clip(0, 1) * 255).astype(np.uint8))


class SDImagePipeline:
    def __init__(self, unet, text_encoder=None, vae_encoder=None, vae_decoder=None,
                 tokenizer=None, dtype=torch.float32):
        self.scheduler = EnhancedDDIMScheduler()
        self.prompter = SDPrompter(tokenizer)
        self.unet = cast_model(unet, dtype)
        self.text_encoder = cast_model(text_encoder, dtype)
        self.vae_encoder = cast_model(vae_encoder, dtype)
        self.vae_decoder = cast_model(vae_decoder, dtype)
        self.dtype = dtype
        self.device = model_device(self.unet)

    def _cfg_unet(self, latents, timestep, emb_posi, emb_nega, cfg_scale, **tiler_kwargs):
        """Both CFG branches in one UNet pass."""
        pred = sd.sd_unet_forward(self.unet, torch.cat([latents, latents]),
                                  torch.cat([timestep, timestep]),
                                  torch.cat([emb_posi, emb_nega]), **tiler_kwargs)
        posi, nega = pred.chunk(2)
        return nega + cfg_scale * (posi - nega)

    def encode_prompt(self, prompt, clip_skip=1, positive=True):
        return self.prompter.encode_prompt(self.text_encoder, prompt, clip_skip,
                                           positive=positive).to(self.dtype)

    def vae_output_to_image(self, vae_output) -> np.ndarray:
        return vae_output_to_frames(vae_output[:1])[0]

    @torch.no_grad()
    def __call__(self, prompt, negative_prompt="", cfg_scale=7.5, clip_skip=1, input_image=None,
                 denoising_strength=1.0, height=512, width=512, num_inference_steps=20,
                 seed=None, prompt_emb_posi=None, prompt_emb_nega=None, tiled=False,
                 tile_size=64, tile_stride=32, local_prompts=None, masks=None,
                 mask_scales=None):
        height, width = check_resize_height_width(height, width, factor=64)
        prompt, local_prompts, masks, mask_scales = extend_prompt(
            self.prompter, prompt, local_prompts, masks, mask_scales)
        tiler_kwargs = {"tiled": tiled, "tile_size": tile_size, "tile_stride": tile_stride}
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength)
        dev, dt = self.device, self.dtype

        noise = generate_noise((1, 4, height // 8, width // 8), seed).to(dev, dt)
        if input_image is not None:
            image = torch.from_numpy(preprocess_image(input_image)).to(dev, dt)
            latents = sd.sd_vae_encode(self.vae_encoder, image, **tiler_kwargs)
            latents = self.scheduler.add_noise(latents, noise,
                                               timestep=self.scheduler.timesteps[0]).to(dt)
        else:
            latents = noise

        if prompt_emb_posi is None:
            prompt_emb_posi = self.encode_prompt(prompt, clip_skip)
        if prompt_emb_nega is None:
            prompt_emb_nega = self.encode_prompt(negative_prompt, clip_skip, positive=False)
        prompt_emb_posi = torch.as_tensor(prompt_emb_posi).to(dev, dt)
        prompt_emb_nega = torch.as_tensor(prompt_emb_nega).to(dev, dt)
        prompt_emb_locals = [self.encode_prompt(pl, clip_skip) for pl in local_prompts]
        # equal-length contexts for the batched pass: the shorter one padded
        # with repeats of its last 77-token chunk (a full padding chunk)
        n = max(prompt_emb_posi.shape[1], prompt_emb_nega.shape[1])

        def _pad(e):
            while e.shape[1] < n:
                e = torch.cat([e, e[:, -77:]], dim=1)
            return e

        prompt_emb_posi, prompt_emb_nega = _pad(prompt_emb_posi), _pad(prompt_emb_nega)

        for timestep in self.scheduler.timesteps:
            t = torch.tensor([float(timestep)], dtype=dt, device=dev)
            if local_prompts:
                def cb(emb):
                    return sd.sd_unet_forward(self.unet, latents, t, emb, **tiler_kwargs).float()

                posi = control_noise_via_local_prompts(prompt_emb_posi, prompt_emb_locals, masks,
                                                       mask_scales, cb)
                nega = cb(prompt_emb_nega)
                noise_pred = nega + float(cfg_scale) * (posi - nega)
            else:
                noise_pred = self._cfg_unet(latents, t, prompt_emb_posi, prompt_emb_nega,
                                            float(cfg_scale), **tiler_kwargs)
            latents = self.scheduler.step(noise_pred.float(), timestep, latents.float()).to(dt)

        return self.vae_output_to_image(sd.sd_vae_decode(self.vae_decoder, latents,
                                                         **tiler_kwargs))
