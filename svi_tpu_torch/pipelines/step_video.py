"""StepVideo text-to-video pipeline, port of svi_tpu/pipelines/step_video.py:
the flow-match scheduler (sigma_min 0, one extra step, shift 13, reversed
sigmas, num_train_timesteps 1), latents (1, max(F // 17 * 3, 1), 64, H / 16,
W / 16), CFG as two B=1 DiT calls a step (positive, then negative), then the
VAE's tiled (default) or chunked decode in f32.

The DiT is the port's `ParamTree` in the pipeline's dtype (bf16 by default)
on the device it lies on; the VAE stays f32. Prompts go through the
caller's `StepVideoPrompter` (its CLIP encoder and tokenizer are callables),
or their embeddings are passed as prompt_emb_posi / prompt_emb_nega
((clip (B, 77, 1024), llm (B, 320, 6144), mask (B, 397)) each). The call
returns the video as a list of (H, W, 3) uint8 frames (svi_tpu's are PIL
images).
"""

from __future__ import annotations

import torch

from ..models import stepvideo as sv
from ..models import stepvideo_vae as svae
from ..schedulers.flow_match import FlowMatchScheduler
from .base import generate_noise, tensor_to_frames
from .sd_image import cast_model, model_device


class StepVideoPipeline:
    def __init__(self, dit_params, vae_params=None, prompter=None, dtype=torch.bfloat16,
                 num_heads=None, head_dim=128):
        self.scheduler = FlowMatchScheduler(sigma_min=0.0, extra_one_step=True, shift=13.0,
                                            reverse_sigmas=True, num_train_timesteps=1)
        self.dit_params = cast_model(dit_params, dtype)
        self.vae_params = vae_params
        self.prompter = prompter
        self.dtype = dtype
        self.device = model_device(self.dit_params)
        # head_dim is pinned at 128 by the RoPE's channel split (64, 32, 32)
        self.head_dim = head_dim
        self.num_heads = num_heads or self.dit_params["pos_embed"]["w"].shape[0] // head_dim

    def _embeddings(self, emb):
        clip, llm, mask = emb
        return (torch.as_tensor(clip).to(self.device, self.dtype),
                torch.as_tensor(llm).to(self.device, self.dtype),
                torch.as_tensor(mask).to(self.device))

    def _denoise_step(self, latents, timestep, posi, nega, cfg_scale, rope_tables):
        def run(emb):
            clip, llm, mask = emb
            return sv.stepvideo_dit_forward(
                self.dit_params, latents, llm, mask, timestep, encoder_hidden_states_2=clip,
                rope_tables=rope_tables, num_heads=self.num_heads, head_dim=self.head_dim)

        noise_pred_posi = run(posi)
        if nega is None:
            return noise_pred_posi
        noise_pred_nega = run(nega)
        return noise_pred_nega + cfg_scale * (noise_pred_posi - noise_pred_nega)

    @torch.no_grad()
    def __call__(self, prompt, negative_prompt="", seed=None, height=544, width=992,
                 num_frames=204, cfg_scale=9.0, num_inference_steps=30, denoising_strength=1.0,
                 tiled=True, tile_size=(34, 34), tile_stride=(16, 16), smooth_scale=0.6,
                 prompt_emb_posi=None, prompt_emb_nega=None, progress_bar_cmd=lambda x: x):
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength)
        dev, dt = self.device, self.dtype

        latent_ch = self.dit_params["pos_embed"]["w"].shape[1]
        latents = generate_noise((1, max(num_frames // 17 * 3, 1), latent_ch, height // 16,
                                  width // 16), seed=seed).to(dev, dt)

        if prompt_emb_posi is None:
            prompt_emb_posi = self.prompter(prompt)
        posi = self._embeddings(prompt_emb_posi)
        nega = None
        if cfg_scale != 1.0:
            if prompt_emb_nega is None:
                prompt_emb_nega = self.prompter(negative_prompt)
            nega = self._embeddings(prompt_emb_nega)

        rope_tables = tuple(torch.from_numpy(t).to(dev) for t in sv.prepare_stepvideo_rope(
            latents.shape[1], height // 16, width // 16))

        for progress_id, timestep in enumerate(progress_bar_cmd(self.scheduler.timesteps)):
            t = torch.tensor([float(timestep)], dtype=torch.float32, device=dev)
            noise_pred = self._denoise_step(latents, t, posi, nega, cfg_scale, rope_tables)
            latents = self.scheduler.step(noise_pred, self.scheduler.timesteps[progress_id],
                                          latents).to(dt)

        def decode(z):
            return svae.stepvideo_vae_decode_chunk(self.vae_params, z)

        if tiled:
            video = svae.stepvideo_vae_tiled_decode(
                self.vae_params, latents.float(), tile_size=tile_size, tile_stride=tile_stride,
                smooth_scale=smooth_scale, decode_chunk_fn=decode)
        else:
            video = svae.stepvideo_vae_decode(self.vae_params, latents.float(),
                                              smooth_scale=smooth_scale, decode_chunk_fn=decode)
        # (B, T, C, H, W) -> (C, T, H, W) frames
        return tensor_to_frames(video[0].transpose(0, 1))
