"""HunyuanVideo text-to-video pipeline, port of
svi_tpu/pipelines/hunyuan_video.py: the flow-match scheduler (shift 7,
sigma_min 0, one extra step), embedded guidance (6.0 by default) with
optional true CFG as a second DiT pass, latents (1, 16, (F - 1) / 4 + 1,
H / 8, W / 8), the causal VAE's decode.

Models are the port's `ParamTree`s in the pipeline's dtype (bf16 by
default) on the device they lie on (`models.hunyuan_video`). The text
encoder is the caller's callable prompt -> (prompt_emb, text_mask, pooled),
or those are passed as prompt_emb_posi / prompt_emb_nega. The call returns
the video as a list of (H, W, 3) uint8 frames.
"""

from __future__ import annotations

import torch

from ..models import hunyuan_video as hv
from ..schedulers.flow_match import FlowMatchScheduler
from .base import check_resize_height_width, generate_noise, tensor_to_frames
from .sd_image import cast_model, model_device


class HunyuanVideoPipeline:
    def __init__(self, dit_params, text_encoder=None, vae_encoder_params=None,
                 vae_decoder_params=None, dtype=torch.bfloat16):
        self.scheduler = FlowMatchScheduler(shift=7.0, sigma_min=0.0, extra_one_step=True)
        self.text_encoder = text_encoder
        self.dit_params = cast_model(dit_params, dtype)
        self.vae_encoder_params = cast_model(vae_encoder_params, dtype)
        self.vae_decoder_params = cast_model(vae_decoder_params, dtype)
        self.dtype = dtype
        self.device = model_device(self.dit_params)

    @torch.no_grad()
    def __call__(self, prompt, negative_prompt="", cfg_scale=1.0, embedded_guidance=6.0,
                 denoising_strength=1.0, height=720, width=1280, num_frames=129,
                 num_inference_steps=30, seed=None, prompt_emb_posi=None, prompt_emb_nega=None):
        height, width = check_resize_height_width(height, width, factor=16)
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength)
        dev, dt = self.device, self.dtype

        lat_t = (num_frames - 1) // 4 + 1
        latents = generate_noise((1, 16, lat_t, height // 8, width // 8), seed).to(dev, dt)

        if prompt_emb_posi is None:
            prompt_emb_posi = self.text_encoder(prompt)
        if prompt_emb_nega is None and cfg_scale != 1.0:
            prompt_emb_nega = self.text_encoder(negative_prompt)

        freqs = hv._tables(hv.prepare_rope_tables(lat_t, height // 16, width // 16), dev)
        guidance = torch.tensor([embedded_guidance], dtype=dt, device=dev)

        def run(emb_pack, t):
            emb, mask, pooled = emb_pack
            return hv.hunyuan_video_dit_forward(
                self.dit_params, latents, t, torch.as_tensor(emb).to(dev, dt),
                torch.as_tensor(mask).to(dev), torch.as_tensor(pooled).to(dev, dt),
                guidance=guidance, freqs=freqs)

        for timestep in self.scheduler.timesteps:
            t = torch.tensor([float(timestep)], dtype=dt, device=dev)
            noise_pred = run(prompt_emb_posi, t)
            if cfg_scale != 1.0:
                noise_pred_nega = run(prompt_emb_nega, t)
                noise_pred = noise_pred_nega + cfg_scale * (noise_pred - noise_pred_nega)
            latents = self.scheduler.step(noise_pred.float(), timestep, latents.float()).to(dt)

        video = hv.hunyuan_video_vae_decode(self.vae_decoder_params, latents)
        return tensor_to_frames(video[0])
