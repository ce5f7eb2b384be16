"""SDXL text- and image-to-image pipeline, port of
svi_tpu/pipelines/sdxl_image.py: the two text encoders' prompt embedding
(`SDXLPrompter`), CFG as one UNet batch of two with the add-time ids
(h, w, 0, 0, h, w), img2img by `add_noise` at the first timestep, regional
prompts merged by feathered masks, tiled VAE and UNet transformers.

Models are the port's `ParamTree`s in the pipeline's dtype (f32 by default)
on the device they lie on; images are (H, W, 3) uint8 arrays. Passing
`chatglm_params` (a `models.kolors` ChatGLM3) switches to Kolors: the
prompter becomes `KolorsPrompter` and the scheduler
`EnhancedDDIMScheduler(beta_end=0.014, num_train_timesteps=1100)`; the UNet's
weights carry Kolors' `text_intermediate_proj` and 5632-wide add embedding.
"""

from __future__ import annotations

import torch

from ..models import sdxl
from ..prompters.kolors_prompter import KolorsPrompter
from ..prompters.sdxl_prompter import SDXLPrompter
from ..schedulers.ddim import EnhancedDDIMScheduler
from .base import (check_resize_height_width, control_noise_via_local_prompts, extend_prompt,
                   generate_noise, preprocess_image)
from .sd_image import cast_model, model_device, vae_output_to_frames


def add_time_ids(height: int, width: int, device) -> torch.Tensor:
    """SDXL's micro-conditioning: original size, crop origin, target size."""
    return torch.tensor([[height, width, 0, 0, height, width]], dtype=torch.float32,
                        device=device)


class SDXLImagePipeline:
    def __init__(self, unet, text_encoder=None, text_encoder_2=None, vae_encoder=None,
                 vae_decoder=None, tokenizer=None, tokenizer_2=None, chatglm_params=None,
                 dtype=torch.float32):
        if chatglm_params is not None:
            self.scheduler = EnhancedDDIMScheduler(beta_end=0.014, num_train_timesteps=1100)
            self.prompter = KolorsPrompter(tokenizer)
            text_encoder = chatglm_params
        else:
            self.scheduler = EnhancedDDIMScheduler()
            self.prompter = SDXLPrompter(tokenizer, tokenizer_2)
        self.unet = cast_model(unet, dtype)
        self.text_encoder = cast_model(text_encoder, dtype)
        self.text_encoder_2 = cast_model(text_encoder_2, dtype)
        self.vae_encoder = cast_model(vae_encoder, dtype)
        self.vae_decoder = cast_model(vae_decoder, dtype)
        self.dtype = dtype
        self.device = model_device(self.unet)

    def encode_prompt(self, prompt, clip_skip=1, clip_skip_2=2):
        pooled, emb = self.prompter.encode_prompt(self.text_encoder, self.text_encoder_2,
                                                  prompt, clip_skip, clip_skip_2)
        return pooled.to(self.dtype), emb.to(self.dtype)

    def _unet(self, latents, t, emb, pooled, add_time_id, **tiler_kwargs):
        b = latents.shape[0]
        return sdxl.sdxl_unet_forward(self.unet, latents, t, emb, add_time_id.repeat(b, 1),
                                      pooled, **tiler_kwargs)

    def vae_output_to_image(self, vae_output):
        return vae_output_to_frames(vae_output[:1])[0]

    @torch.no_grad()
    def __call__(self, prompt, negative_prompt="", cfg_scale=7.5, clip_skip=1, clip_skip_2=2,
                 input_image=None, denoising_strength=1.0, height=1024, width=1024,
                 num_inference_steps=20, seed=None, prompt_emb_posi=None, prompt_emb_nega=None,
                 tiled=False, tile_size=64, tile_stride=32, local_prompts=None, masks=None,
                 mask_scales=None):
        height, width = check_resize_height_width(height, width, factor=64)
        prompt, local_prompts, masks, mask_scales = extend_prompt(
            self.prompter, prompt, local_prompts, masks, mask_scales)
        tiler_kwargs = {"tiled": tiled, "tile_size": tile_size, "tile_stride": tile_stride}
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength)
        dev, dt = self.device, self.dtype

        if input_image is not None:
            image = torch.from_numpy(preprocess_image(input_image)).to(dev, dt)
            latents = sdxl.sdxl_vae_encode(self.vae_encoder, image, **tiler_kwargs)
            noise = generate_noise((1, 4, height // 8, width // 8), seed).to(dev, dt)
            latents = self.scheduler.add_noise(latents, noise,
                                               timestep=self.scheduler.timesteps[0]).to(dt)
        else:
            latents = generate_noise((1, 4, height // 8, width // 8), seed).to(dev, dt)

        if prompt_emb_posi is None:
            prompt_emb_posi = self.encode_prompt(prompt, clip_skip, clip_skip_2)
        if prompt_emb_nega is None and cfg_scale != 1.0:
            prompt_emb_nega = self.encode_prompt(negative_prompt, clip_skip, clip_skip_2)
        prompt_emb_locals = [self.encode_prompt(p, clip_skip, clip_skip_2) for p in local_prompts]
        pooled_posi, emb_posi = prompt_emb_posi
        add_time_id = add_time_ids(height, width, dev)
        if cfg_scale != 1.0:
            pooled_nega, emb_nega = prompt_emb_nega
            n = max(emb_posi.shape[1], emb_nega.shape[1])

            def _pad(e):
                while e.shape[1] < n:
                    e = torch.cat([e, e[:, -77:]], dim=1)
                return e

            emb_posi, emb_nega = _pad(emb_posi), _pad(emb_nega)

        for timestep in self.scheduler.timesteps:
            t = torch.tensor([float(timestep)], dtype=dt, device=dev)
            if local_prompts:
                def cb(pe):
                    return self._unet(latents, t, pe[1], pe[0], add_time_id,
                                      **tiler_kwargs).float()

                posi = control_noise_via_local_prompts((pooled_posi, emb_posi), prompt_emb_locals,
                                                       masks, mask_scales, cb)
                if cfg_scale != 1.0:
                    nega = cb((pooled_nega, emb_nega))
                    noise_pred = nega + float(cfg_scale) * (posi - nega)
                else:
                    noise_pred = posi
            elif cfg_scale != 1.0:
                pred = self._unet(torch.cat([latents, latents]), torch.cat([t, t]),
                                  torch.cat([emb_posi, emb_nega]),
                                  torch.cat([pooled_posi, pooled_nega]), add_time_id,
                                  **tiler_kwargs)
                posi, nega = pred.chunk(2)
                noise_pred = nega + float(cfg_scale) * (posi - nega)
            else:
                noise_pred = self._unet(latents, t, emb_posi, pooled_posi, add_time_id,
                                        **tiler_kwargs)
            latents = self.scheduler.step(noise_pred.float(), timestep, latents.float()).to(dt)

        return self.vae_output_to_image(sdxl.sdxl_vae_decode(self.vae_decoder, latents,
                                                             **tiler_kwargs))
