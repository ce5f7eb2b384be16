"""CogVideoX text- and video-to-video pipeline, port of
svi_tpu/pipelines/cog_video.py: zero-terminal-SNR DDIM with v-prediction,
T5 prompts of 226 tokens (`CogPrompter`), latents (1, 16, F / 4 + 1, H / 8,
W / 8), CFG as one DiT batch of two (positive, negative) or, tiled, as two
passes over feathered tiles; video-to-video by encoding `input_video` ((H, W, 3) uint8 frames or a
(1, 3, T, H, W) array in [-1, 1]) and `add_noise` at the first timestep;
tiled VAE encode and decode.

Models are the port's `ParamTree`s in the pipeline's dtype (bf16 by
default) on the device they lie on (`models.cog`); `t5` is a (T5Encoder,
cfg, tokenizer) triple or None when prompt embeddings are given. Frames
are (H, W, 3) uint8 arrays; the call returns a list of them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import cog
from ..prompters.cog_prompter import CogPrompter
from ..schedulers.ddim import EnhancedDDIMScheduler
from .base import check_resize_height_width, generate_noise, tensor_to_frames
from .sd_image import cast_model, model_device


class CogVideoPipeline:
    def __init__(self, dit_params, t5=None, vae_encoder_params=None, vae_decoder_params=None,
                 dtype=torch.bfloat16):
        self.scheduler = EnhancedDDIMScheduler(rescale_zero_terminal_snr=True,
                                               prediction_type="v_prediction")
        self.dit_params = cast_model(dit_params, dtype)
        self.t5 = t5
        self.prompter = CogPrompter(t5)
        self.vae_encoder_params = cast_model(vae_encoder_params, dtype)
        self.vae_decoder_params = cast_model(vae_decoder_params, dtype)
        self.dtype = dtype
        self.device = model_device(self.dit_params)

    def _cfg_dit(self, latents, timestep, emb_posi, emb_nega, freqs, cfg_scale):
        """Both CFG branches in one DiT batch of two."""
        pred = cog.cog_dit_forward(self.dit_params, torch.cat([latents, latents]),
                                   torch.cat([timestep, timestep]),
                                   torch.cat([emb_posi, emb_nega]), freqs)
        posi, nega = pred.chunk(2)
        return nega + cfg_scale * (posi - nega)

    def encode_prompt(self, prompt, max_length=226, positive=True):
        if self.prompter.t5 is None:
            self.prompter.fetch_models(self.t5)
        return self.prompter.encode_prompt(prompt, positive=positive, max_length=max_length,
                                           dtype=self.dtype)

    @torch.no_grad()
    def __call__(self, prompt, negative_prompt="", input_video=None, cfg_scale=7.0,
                 denoising_strength=1.0, num_frames=49, height=480, width=720,
                 num_inference_steps=20, seed=None, prompt_emb_posi=None, prompt_emb_nega=None,
                 tiled=False, tile_size=(60, 90), tile_stride=(30, 45)):
        height, width = check_resize_height_width(height, width, factor=16)
        tiler_kwargs = {"tiled": tiled, "tile_size": tuple(tile_size),
                        "tile_stride": tuple(tile_stride)}
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength)
        dev, dt = self.device, self.dtype

        noise = generate_noise((1, 16, num_frames // 4 + 1, height // 8, width // 8),
                               seed).to(dev, dt)
        if denoising_strength == 1.0:
            latents = noise
        else:
            if isinstance(input_video, (list, tuple)):  # (H, W, 3) uint8 frames -> (1, 3, T, H, W)
                video = np.stack([np.asarray(f, np.float32) * (2 / 255) - 1 for f in input_video]
                                 ).transpose(3, 0, 1, 2)[None]
            else:  # (1, 3, T, H, W) in [-1, 1]
                video = input_video
            video = torch.as_tensor(video).to(dev, dt)
            latents = cog.cog_vae_encode_video(self.vae_encoder_params, video, **tiler_kwargs)
            latents = self.scheduler.add_noise(latents, noise, self.scheduler.timesteps[0]).to(dt)

        if prompt_emb_posi is None:
            prompt_emb_posi = self.encode_prompt(prompt)
        if prompt_emb_nega is None and cfg_scale != 1.0:
            prompt_emb_nega = self.encode_prompt(negative_prompt)
        emb_posi = torch.as_tensor(prompt_emb_posi).to(dev, dt)
        emb_nega = None if prompt_emb_nega is None else torch.as_tensor(prompt_emb_nega).to(dev, dt)

        freqs = cog._tables(cog.prepare_rope_tables(height // 8, width // 8,
                                                    num_frames // 4 + 1), dev)

        for timestep in self.scheduler.timesteps:
            t = torch.tensor([float(timestep)], dtype=dt, device=dev)
            if tiled:
                # the DiT makes each tile's RoPE tables
                posi = cog.cog_dit_forward(self.dit_params, latents, t, emb_posi, **tiler_kwargs)
                if cfg_scale != 1.0:
                    nega = cog.cog_dit_forward(self.dit_params, latents, t, emb_nega,
                                               **tiler_kwargs)
                    noise_pred = nega + cfg_scale * (posi - nega)
                else:
                    noise_pred = posi
            elif cfg_scale != 1.0:
                noise_pred = self._cfg_dit(latents, t, emb_posi, emb_nega, freqs,
                                           float(cfg_scale))
            else:
                noise_pred = cog.cog_dit_forward(self.dit_params, latents, t, emb_posi, freqs)
            latents = self.scheduler.step(noise_pred.float(), timestep, latents.float()).to(dt)

        video = cog.cog_vae_decode_video(self.vae_decoder_params, latents, **tiler_kwargs)
        return tensor_to_frames(video[0])
