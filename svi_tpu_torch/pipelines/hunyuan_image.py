"""Hunyuan-DiT text- and image-to-image pipeline, port of
svi_tpu/pipelines/hunyuan_image.py: DDIM with v-prediction (beta_end 0.03),
the SDXL VAE (tiled or not), the image-size manager's rotary tables and
size embedding, CFG as two DiT passes, regional prompts merged into the
positive branch by feathered masks.

Models are the port's `ParamTree`s in the pipeline's dtype (f32 by default)
on the device they lie on: the DiT (`models.hunyuan_dit`) and the SDXL VAE
halves (`models.sdxl`). The text encoders are the caller's
(`HunyuanTextEncoderWrapper`, the prompter), or precomputed embeddings
(text_emb, mask, text_emb_t5, mask_t5) are passed as prompt_emb_posi /
prompt_emb_nega. Images are (H, W, 3) uint8 arrays; the call returns one.
"""

from __future__ import annotations

import torch

from ..models import hunyuan_dit as hy
from ..models import sdxl
from ..prompters.hunyuan_dit_prompter import HunyuanDiTPrompter
from ..schedulers.ddim import EnhancedDDIMScheduler
from .base import (check_resize_height_width, control_noise_via_local_prompts, extend_prompt,
                   generate_noise, preprocess_image)
from .sd_image import cast_model, model_device, vae_output_to_frames

# the pipeline-facing name of the prompter
HunyuanTextEncoderWrapper = HunyuanDiTPrompter


class HunyuanDiTImagePipeline:
    def __init__(self, dit_params, text_encoder=None, vae_encoder_params=None,
                 vae_decoder_params=None, dtype=torch.float32, num_layers_down=21):
        self.scheduler = EnhancedDDIMScheduler(prediction_type="v_prediction",
                                               beta_start=0.00085, beta_end=0.03)
        self.text_encoder = text_encoder  # HunyuanTextEncoderWrapper or None
        self.dit_params = cast_model(dit_params, dtype)
        self.vae_encoder_params = cast_model(vae_encoder_params, dtype)
        self.vae_decoder_params = cast_model(vae_decoder_params, dtype)
        self.dtype = dtype
        self.num_layers_down = num_layers_down
        self.device = model_device(self.dit_params)

    def _dit(self, latents, timestep, emb, size_emb, freqs, **tiler_kwargs):
        text_emb, mask, text_emb_t5, mask_t5 = emb
        dev, dt = self.device, self.dtype
        return hy.hunyuan_dit_forward(
            self.dit_params, latents, torch.as_tensor(text_emb).to(dev, dt),
            torch.as_tensor(text_emb_t5).to(dev, dt), torch.as_tensor(mask).to(dev),
            torch.as_tensor(mask_t5).to(dev), timestep, size_emb, freqs,
            num_layers_down=self.num_layers_down, **tiler_kwargs)

    def _cfg_dit(self, latents, timestep, posi, nega, size_emb, freqs, cfg_scale,
                 **tiler_kwargs):
        pred_posi = self._dit(latents, timestep, posi, size_emb, freqs, **tiler_kwargs)
        if cfg_scale == 1.0 or nega is None:
            return pred_posi
        pred_nega = self._dit(latents, timestep, nega, size_emb, freqs, **tiler_kwargs)
        return pred_nega + cfg_scale * (pred_posi - pred_nega)

    def vae_output_to_image(self, vae_output):
        return vae_output_to_frames(vae_output[:1])[0]

    @torch.no_grad()
    def __call__(self, prompt, negative_prompt="", cfg_scale=7.5, clip_skip=1, clip_skip_2=1,
                 input_image=None, denoising_strength=1.0, height=1024, width=1024,
                 num_inference_steps=20, seed=None, prompt_emb_posi=None, prompt_emb_nega=None,
                 tiled=False, tile_size=64, tile_stride=32, local_prompts=None, masks=None,
                 mask_scales=None):
        height, width = check_resize_height_width(height, width, factor=16)
        prompter = getattr(self.text_encoder, "prompter", None)
        prompt, local_prompts, masks, mask_scales = extend_prompt(
            prompter, prompt, local_prompts, masks, mask_scales)
        tiler_kwargs = {"tiled": tiled, "tile_size": tile_size, "tile_stride": tile_stride}
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength)
        dev, dt = self.device, self.dtype

        noise = generate_noise((1, 4, height // 8, width // 8), seed).to(dev, dt)
        if input_image is not None:
            image = torch.from_numpy(preprocess_image(input_image)).to(dev, dt)
            latents = sdxl.sdxl_vae_encode(self.vae_encoder_params, image, **tiler_kwargs)
            latents = self.scheduler.add_noise(latents, noise,
                                               timestep=self.scheduler.timesteps[0]).to(dt)
        else:
            latents = noise

        if prompt_emb_posi is None:
            prompt_emb_posi = self.text_encoder(prompt, clip_skip, clip_skip_2)
        if prompt_emb_nega is None and cfg_scale != 1.0:
            prompt_emb_nega = self.text_encoder(negative_prompt, clip_skip, clip_skip_2)
        prompt_emb_locals = [self.text_encoder(p, clip_skip, clip_skip_2)
                             for p in (local_prompts or [])]

        # tiled: the size embedding and the rotary tables describe one tile
        rh, rw = (tile_size * 16, tile_size * 16) if tiled else (height, width)
        size_emb = torch.tensor([[rw, rh, rw, rh, 0, 0]], dtype=torch.float32, device=dev)
        freqs = hy._tables(hy.calc_rope(rh, rw), dev)

        for timestep in self.scheduler.timesteps:
            t = torch.tensor([float(timestep)], dtype=dt, device=dev)
            if local_prompts:
                def cb(emb):
                    return self._cfg_dit(latents, t, emb, None, size_emb, freqs, 1.0,
                                         **tiler_kwargs).float()

                posi = control_noise_via_local_prompts(prompt_emb_posi, prompt_emb_locals,
                                                       masks, mask_scales, cb)
                if cfg_scale != 1.0:
                    nega = cb(prompt_emb_nega)
                    noise_pred = nega + float(cfg_scale) * (posi - nega)
                else:
                    noise_pred = posi
            else:
                noise_pred = self._cfg_dit(latents, t, prompt_emb_posi, prompt_emb_nega,
                                           size_emb, freqs, float(cfg_scale), **tiler_kwargs)
            latents = self.scheduler.step(noise_pred.float(), timestep, latents.float()).to(dt)

        return self.vae_output_to_image(sdxl.sdxl_vae_decode(self.vae_decoder_params, latents,
                                                             **tiler_kwargs))
