"""SD3 / SD3.5 text- and image-to-image pipeline, port of
svi_tpu/pipelines/sd3_image.py: the flow-match scheduler at shift 3, CFG as
one MMDiT batch of two (positive, negative), image-to-image by `add_noise` at
the first timestep, regional prompts merged by feathered masks, tiled MMDiT
and VAE.

Models are the port's `ParamTree`s in the pipeline's dtype (f32 by default)
on the device they lie on; `t5` is None or a (T5Encoder, cfg, tokenizer)
triple (the encoder keeps its own dtype); images are (H, W, 3) uint8 arrays.
"""

from __future__ import annotations

import torch

from ..models import sd3
from ..prompters.sd3_prompter import SD3Prompter
from ..schedulers.flow_match import FlowMatchScheduler
from .base import (check_resize_height_width, control_noise_via_local_prompts, extend_prompt,
                   generate_noise, preprocess_image)
from .sd_image import cast_model, model_device, vae_output_to_frames


class SD3ImagePipeline:
    def __init__(self, dit_params, text_encoder_1_params=None, text_encoder_2_params=None,
                 t5=None, vae_encoder_params=None, vae_decoder_params=None, tokenizer=None,
                 dtype=torch.float32):
        self.scheduler = FlowMatchScheduler(shift=3.0)
        self.prompter = SD3Prompter(tokenizer)
        self.dit_params = cast_model(dit_params, dtype)
        self.text_encoder_1_params = cast_model(text_encoder_1_params, dtype)
        self.text_encoder_2_params = cast_model(text_encoder_2_params, dtype)
        self.t5 = t5
        self.vae_encoder_params = cast_model(vae_encoder_params, dtype)
        self.vae_decoder_params = cast_model(vae_decoder_params, dtype)
        self.dtype = dtype
        self.device = model_device(self.dit_params)

    def _cfg_dit(self, latents, timestep, emb_posi, emb_nega, pooled_posi, pooled_nega,
                 cfg_scale, **tiler_kwargs):
        """Both CFG branches in one MMDiT pass."""
        pred = sd3.sd3_dit_forward(self.dit_params, torch.cat([latents, latents]),
                                   torch.cat([timestep, timestep]),
                                   torch.cat([emb_posi, emb_nega]),
                                   torch.cat([pooled_posi, pooled_nega]), **tiler_kwargs)
        posi, nega = pred.chunk(2)
        return nega + cfg_scale * (posi - nega)

    def encode_prompt(self, prompt, t5_sequence_length=77):
        emb, pooled = self.prompter.encode_prompt(
            self.text_encoder_1_params, self.text_encoder_2_params, self.t5, prompt,
            t5_sequence_length)
        return emb.to(self.dtype), pooled.to(self.dtype)

    def vae_output_to_image(self, vae_output):
        return vae_output_to_frames(vae_output[:1])[0]

    @torch.no_grad()
    def __call__(self, prompt, negative_prompt="", cfg_scale=7.5, input_image=None,
                 denoising_strength=1.0, height=1024, width=1024, num_inference_steps=28,
                 t5_sequence_length=77, seed=None, prompt_emb_posi=None, prompt_emb_nega=None,
                 tiled=False, tile_size=128, tile_stride=64, local_prompts=None, masks=None,
                 mask_scales=None):
        height, width = check_resize_height_width(height, width, factor=64)
        prompt, local_prompts, masks, mask_scales = extend_prompt(
            self.prompter, prompt, local_prompts, masks, mask_scales)
        tiler_kwargs = {"tiled": tiled, "tile_size": tile_size, "tile_stride": tile_stride}
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength)
        dev, dt = self.device, self.dtype

        noise = generate_noise((1, 16, height // 8, width // 8), seed).to(dev, dt)
        if input_image is not None:
            image = torch.from_numpy(preprocess_image(input_image)).to(dev, dt)
            latents = sd3.sd3_vae_encode(self.vae_encoder_params, image, **tiler_kwargs)
            latents = self.scheduler.add_noise(latents, noise,
                                               timestep=self.scheduler.timesteps[0]).to(dt)
        else:
            latents = noise

        if prompt_emb_posi is None:
            prompt_emb_posi = self.encode_prompt(prompt, t5_sequence_length)
        if prompt_emb_nega is None:
            prompt_emb_nega = self.encode_prompt(negative_prompt, t5_sequence_length)
        emb_posi, pooled_posi = prompt_emb_posi
        emb_nega, pooled_nega = prompt_emb_nega
        prompt_emb_locals = [self.encode_prompt(p, t5_sequence_length) for p in local_prompts]

        for timestep in self.scheduler.timesteps:
            t = torch.tensor([float(timestep)], dtype=dt, device=dev)
            if local_prompts:
                def cb(pe):
                    return sd3.sd3_dit_forward(self.dit_params, latents, t, pe[0], pe[1],
                                               **tiler_kwargs).float()

                posi = control_noise_via_local_prompts((emb_posi, pooled_posi),
                                                       prompt_emb_locals, masks, mask_scales, cb)
                nega = cb((emb_nega, pooled_nega))
                noise_pred = nega + float(cfg_scale) * (posi - nega)
            else:
                noise_pred = self._cfg_dit(latents, t, emb_posi, emb_nega, pooled_posi,
                                           pooled_nega, float(cfg_scale), **tiler_kwargs)
            latents = self.scheduler.step(noise_pred.float(), timestep, latents.float()).to(dt)

        return self.vae_output_to_image(sd3.sd3_vae_decode(self.vae_decoder_params, latents,
                                                           **tiler_kwargs))
