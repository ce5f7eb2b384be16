"""AnimateDiff-style SD 1.5 video pipeline and the long-video window blend,
port of svi_tpu/pipelines/sd_video.py.

Frames ride the UNet's batch axis. `denoise_long_video` runs 16-frame
windows at stride 8 and blends each frame's predictions by a triangle bias.
With motion modules the DDIM betas are linear (original AnimateDiff). Per
step: the ControlNet residuals and the UNet (with the motion hooks) per
window, the positive and the negative branch as two passes, then optionally
the smoother: the frames the step would end at are decoded, smoothed,
encoded again and turned back into a noise prediction
(`return_to_timestep`). The VAE runs one frame a call. Models are
`ParamTree`s in the pipeline's dtype (f32 by default); frames are
(H, W, 3) uint8 arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import motion as mo
from ..models import sd as sd_models
from ..prompters.sd_prompter import SDPrompter
from ..schedulers.ddim import EnhancedDDIMScheduler
from .base import check_resize_height_width, generate_noise, preprocess_image
from .sd_image import cast_model, model_device, vae_output_to_frames


def denoise_long_video(run_window, latents, window=16, stride=8):
    """run_window(lo, hi) -> the noise prediction of frames [lo, hi); the
    windows' outputs blended per frame with the triangle bias, in f32."""
    num_frames = latents.shape[0]
    acc = torch.zeros(latents.shape, dtype=torch.float32, device=latents.device)
    weight = [0.0] * num_frames
    for lo in range(0, num_frames, stride):
        hi = min(lo + window, num_frames)
        out = run_window(lo, hi).float()
        for i in range(lo, hi):
            bias = max(1 - abs(i - (lo + hi - 1) / 2) / ((hi - lo - 1 + 1e-2) / 2), 1e-2)
            wt = np.float32(weight[i])
            b32 = np.float32(bias)
            acc[i] = acc[i] * float(wt / (wt + b32)) + out[i - lo] * float(b32 / (wt + b32))
            weight[i] = float(wt + b32)
        if hi == num_frames:
            break
    return acc


class SDVideoPipeline:
    def __init__(self, unet, motion=None, text_encoder=None, vae_encoder=None,
                 vae_decoder=None, tokenizer=None, dtype=torch.float32,
                 use_original_animatediff=True, controlnet=None):
        beta = "linear" if (motion is not None and use_original_animatediff) \
            else "scaled_linear"
        self.scheduler = EnhancedDDIMScheduler(beta_schedule=beta)
        self.prompter = SDPrompter(tokenizer)
        self.unet = cast_model(unet, dtype)
        self.motion = cast_model(motion, dtype)
        self.text_encoder = cast_model(text_encoder, dtype)
        self.vae_encoder = cast_model(vae_encoder, dtype)
        self.vae_decoder = cast_model(vae_decoder, dtype)
        self.controlnet = controlnet  # a MultiControlNetManager or None
        if controlnet is not None:
            controlnet.units = [(fn, cast_model(p, dtype), *rest)
                                for fn, p, *rest in controlnet.units]
        self.dtype = dtype
        self.device = model_device(self.unet)

    @staticmethod
    def from_model_manager(model_manager, controlnet_config_units=(),
                           prompt_refiner_classes=(), **kwargs):
        """The UNet, motion modules, text encoder and VAE from a ModelManager;
        one ControlNet per config unit, loaded from its file onto the
        manager's device."""
        from ..models import controlnets as cn
        from ..models import model_io

        units, processors = [], []
        for cfg_unit in controlnet_config_units:
            cn_params = cn.sd_controlnet_params_from_torch(
                model_io.load_state_dict(cfg_unit.model_path), device=model_manager.device)
            units.append((cn.sd_controlnet_forward, cn_params, cfg_unit.scale))
            processors.append(cn.Annotator(cfg_unit.processor_id,
                                           skip_processor=cfg_unit.skip_processor))
        controlnet = cn.MultiControlNetManager(units, processors) if units else None
        pipe = SDVideoPipeline(
            model_manager.fetch_model("sd_unet"),
            motion=model_manager.fetch_model("sd_motion_modules"),
            text_encoder=model_manager.fetch_model("sd_text_encoder"),
            vae_encoder=model_manager.fetch_model("sd_vae_encoder"),
            vae_decoder=model_manager.fetch_model("sd_vae_decoder"),
            controlnet=controlnet, **kwargs)
        pipe.prompter.load_prompt_refiners(model_manager, prompt_refiner_classes)
        return pipe

    def encode_prompt(self, prompt, clip_skip=1):
        return self.prompter.encode_prompt(self.text_encoder, prompt, clip_skip).to(self.dtype)

    def _unet_window(self, latents, t, emb, ipadapter_kwargs_list=None, controlnet_res=None,
                     tiled=False, tile_size=64, tile_stride=32):
        hooks = None if self.motion is None else mo.motion_hooks(self.motion, batch_size=1)
        return sd_models.sd_unet_forward(
            self.unet, latents, t, emb, controlnet_res=controlnet_res,
            ipadapter_kwargs_list=ipadapter_kwargs_list, motion=hooks, tiled=tiled,
            tile_size=tile_size, tile_stride=tile_stride)

    def decode_video(self, latents, tiled=False, tile_size=64, tile_stride=32):
        """(F, 4, h, w) latents -> F (8h, 8w, 3) uint8 frames, one frame a call."""
        return vae_output_to_frames(torch.cat([
            sd_models.sd_vae_decode(self.vae_decoder, latents[i:i + 1], tiled=tiled,
                                    tile_size=tile_size, tile_stride=tile_stride)
            for i in range(latents.shape[0])]))

    def encode_video(self, frames, tiled=False, tile_size=64, tile_stride=32):
        lat = []
        for f in frames:
            img = torch.from_numpy(preprocess_image(f)).to(self.device, self.dtype)
            lat.append(sd_models.sd_vae_encode(self.vae_encoder, img, tiled=tiled,
                                               tile_size=tile_size, tile_stride=tile_stride))
        return torch.cat(lat)

    def _prepare_controlnet_frames(self, controlnet_frames):
        """Frame streams -> (num_units, F, 3, H, W) conditioning: one stream
        per unit, or one stream annotated by every unit."""
        if controlnet_frames is None:
            return None
        if isinstance(controlnet_frames[0], list):
            cond = np.stack([np.stack([self.controlnet.process_image(f, processor_id=pid)[0]
                                       for f in stream]) for pid, stream
                             in enumerate(controlnet_frames)])
        else:
            cond = np.stack([self.controlnet.process_image(f) for f in controlnet_frames],
                            axis=1)
        return torch.from_numpy(cond).to(self.device, self.dtype)

    @torch.no_grad()
    def __call__(self, prompt, negative_prompt="", cfg_scale=7.5, clip_skip=1, num_frames=None,
                 input_frames=None, denoising_strength=1.0, height=512, width=512,
                 num_inference_steps=20, animatediff_batch_size=16, animatediff_stride=8,
                 controlnet_frames=None, smoother=None, smoother_progress_ids=(), seed=None,
                 prompt_emb_posi=None, prompt_emb_nega=None, tiled=False, tile_size=64,
                 tile_stride=32):
        height, width = check_resize_height_width(height, width, factor=64)
        tiler_kwargs = {"tiled": tiled, "tile_size": tile_size, "tile_stride": tile_stride}
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength)
        dev, dt = self.device, self.dtype
        controlnet_cond = self._prepare_controlnet_frames(controlnet_frames)

        if self.motion is None:
            noise = generate_noise((1, 4, height // 8, width // 8), seed).repeat(
                num_frames, 1, 1, 1)
        else:
            noise = generate_noise((num_frames, 4, height // 8, width // 8), seed)
        noise = noise.to(dev, dt)
        if input_frames is None or denoising_strength == 1.0:
            latents = noise
        else:
            latents = self.encode_video(input_frames, **tiler_kwargs)
            latents = self.scheduler.add_noise(latents, noise,
                                               timestep=self.scheduler.timesteps[0]).to(dt)

        if prompt_emb_posi is None:
            prompt_emb_posi = self.encode_prompt(prompt, clip_skip)
        if prompt_emb_nega is None:
            prompt_emb_nega = self.encode_prompt(negative_prompt, clip_skip)
        prompt_emb_posi = torch.as_tensor(prompt_emb_posi).to(dev, dt)
        prompt_emb_nega = torch.as_tensor(prompt_emb_nega).to(dev, dt)

        for progress_id, timestep in enumerate(self.scheduler.timesteps):
            t = torch.tensor([float(timestep)], dtype=dt, device=dev)

            def run(emb):
                def run_window(lo, hi):
                    e = emb if emb.shape[0] == 1 else emb[lo:hi]
                    res = None
                    if self.controlnet is not None and controlnet_cond is not None:
                        res = self.controlnet(latents[lo:hi], t, e, controlnet_cond[:, lo:hi])
                    return self._unet_window(latents[lo:hi], t, e, controlnet_res=res,
                                             **tiler_kwargs)
                return denoise_long_video(run_window, latents, animatediff_batch_size,
                                          animatediff_stride)

            noise_pred = run(prompt_emb_posi)
            if cfg_scale != 1.0:
                nega = run(prompt_emb_nega)
                noise_pred = nega + cfg_scale * (noise_pred - nega)
            if smoother is not None and progress_id in smoother_progress_ids:
                rendered = self.scheduler.step(noise_pred, timestep, latents.float(),
                                               to_final=True)
                frames = self.decode_video(rendered.to(dt))
                frames = smoother(frames, original_frames=input_frames)
                target = self.encode_video(frames).float()
                noise_pred = self.scheduler.return_to_timestep(timestep, latents.float(), target)
            latents = self.scheduler.step(noise_pred.float(), timestep, latents.float()).to(dt)

        frames = self.decode_video(latents, **tiler_kwargs)
        if smoother is not None and (num_inference_steps in smoother_progress_ids
                                     or -1 in smoother_progress_ids):
            frames = smoother(frames, original_frames=input_frames)
        return frames
