"""Stable Video Diffusion image-to-video pipeline, port of
svi_tpu/pipelines/svd_video.py: the continuous ODE scheduler (Karras
sigmas, EDM Euler steps), the CLIP image embedding and the noise-augmented
VAE latent of the input image as conditions (the latent concatenated on the
channel axis), CFG as two UNet passes with a per-frame linear scale from
min_cfg_scale to max_cfg_scale, optional mask frames re-noised at every
step, and the latents post-normalized and contrast-enhanced before the
decode.

Models are the port's `ParamTree`s in the pipeline's dtype (f32 by default)
on the device they lie on: the SVD UNet and VAE decoder (`models.svd`), the
SD VAE encoder (`models.sd`) and the CLIP ViT-H image encoder
(`models.ipadapter`). Images are (H, W, 3) uint8 arrays (a PIL image is
read through `np.asarray`); the CLIP input is resized to 224 x 224 as
Pillow's bicubic resize does, without Pillow. The call returns the video as
a list of (H, W, 3) uint8 frames.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import svd
from ..models.ipadapter import clip_image_encoder_forward
from ..models.sd import sd_vae_encode
from ..schedulers.continuous_ode import ContinuousODEScheduler
from ..utils.image_process import resize_uint8
from .base import check_resize_height_width, generate_noise, preprocess_image, tensor_to_frames
from .sd_image import cast_model, model_device

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class SVDVideoPipeline:
    """image_encoder_params: the CLIP vision tower (`models.ipadapter`'s
    image encoder)."""

    def __init__(self, unet_params, image_encoder_params=None, vae_encoder_params=None,
                 vae_decoder_params=None, dtype=torch.float32):
        self.scheduler = ContinuousODEScheduler()
        self.unet_params = cast_model(unet_params, dtype)
        self.image_encoder_params = cast_model(image_encoder_params, dtype)
        self.vae_encoder_params = cast_model(vae_encoder_params, dtype)
        self.vae_decoder_params = cast_model(vae_decoder_params, dtype)
        self.dtype = dtype
        self.device = model_device(self.unet_params)

    def _to(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device, self.dtype)

    def encode_image_with_clip(self, image):
        """Bicubic 224 x 224 resize, CLIP normalization -> (1, 1, 1024)."""
        arr = resize_uint8(np.asarray(image).astype(np.uint8), 224, 224).astype(np.float32)
        arr = (arr / 255.0 - CLIP_MEAN) / CLIP_STD
        pixels = self._to(arr.transpose(2, 0, 1)[None])
        return clip_image_encoder_forward(self.image_encoder_params, pixels)[None]

    def encode_image_with_vae(self, image, noise_aug_strength, seed=None):
        """The noise-augmented, unscaled VAE latent (1, 4, H/8, W/8)."""
        img = preprocess_image(image)
        noise = generate_noise(img.shape, seed).numpy()
        img = self._to(img + noise_aug_strength * noise)
        return sd_vae_encode(self.vae_encoder_params, img, scaling_factor=1.0)

    def encode_video_with_vae(self, video):
        return torch.cat([sd_vae_encode(self.vae_encoder_params,
                                        self._to(preprocess_image(f)), scaling_factor=1.0)
                          for f in video])

    def tensor2video(self, frames) -> list[np.ndarray]:
        """(3, T, H, W) in about [-1, 1] -> T (H, W, 3) uint8 frames."""
        return tensor_to_frames(frames)

    def post_process_latents(self, latents, post_normalize=True, contrast_enhance_scale=1.2):
        """Each frame's latent normalized to the clip's mean and std, then
        scaled by the contrast factor (f32)."""
        lat = latents.float()
        if post_normalize:
            mean, std = lat.mean(), lat.std(correction=0)
            lat = (lat - lat.mean(dim=(1, 2, 3), keepdim=True)) \
                / lat.std(dim=(1, 2, 3), keepdim=True, correction=0) * std + mean
        return lat * contrast_enhance_scale

    @torch.no_grad()
    def __call__(self, input_image=None, input_video=None, mask_frames=(), mask_frame_ids=(),
                 min_cfg_scale=1.0, max_cfg_scale=3.0, denoising_strength=1.0, num_frames=25,
                 height=576, width=1024, fps=7, motion_bucket_id=127, noise_aug_strength=0.02,
                 num_inference_steps=20, post_normalize=True, contrast_enhance_scale=1.2,
                 seed=None):
        height, width = check_resize_height_width(height, width, factor=64)
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength=denoising_strength)
        dev, dt = self.device, self.dtype

        noise = generate_noise((num_frames, 4, height // 8, width // 8), seed).to(dev, dt)
        if denoising_strength == 1.0:
            latents = noise.clone()  # the mask frames below write into it
        else:
            latents = self.encode_video_with_vae(input_video)
            latents = self.scheduler.add_noise(latents, noise,
                                               self.scheduler.timesteps[0]).to(dt)
        if len(mask_frames) > 0:
            mask_latents = self.encode_video_with_vae(mask_frames)

        clip_posi = self.encode_image_with_clip(input_image)
        clip_nega = torch.zeros_like(clip_posi)
        vae_posi = self.encode_image_with_vae(input_image, noise_aug_strength,
                                              seed=seed).repeat(num_frames, 1, 1, 1)
        vae_nega = torch.zeros_like(vae_posi)

        cfg = torch.from_numpy(np.linspace(min_cfg_scale, max_cfg_scale, num_frames)
                               .reshape(num_frames, 1, 1, 1)).to(dev, dt)
        add_time_id = torch.tensor([fps - 1, motion_bucket_id, noise_aug_strength],
                                   dtype=torch.float32, device=dev)

        for timestep in self.scheduler.timesteps:
            for fid, mid in enumerate(mask_frame_ids):
                renoised = self.scheduler.add_noise(mask_latents[fid], noise[mid], timestep)
                latents[mid] = renoised.to(dt)
            t = torch.tensor([float(timestep)], dtype=dt, device=dev)
            posi = svd.svd_unet_forward(self.unet_params, torch.cat([latents, vae_posi], 1), t,
                                        clip_posi[0], add_time_id)
            nega = svd.svd_unet_forward(self.unet_params, torch.cat([latents, vae_nega], 1), t,
                                        clip_nega[0], add_time_id)
            noise_pred = nega + cfg * (posi - nega)
            latents = self.scheduler.step(noise_pred.float(), timestep, latents.float()).to(dt)

        lat = self.post_process_latents(latents, post_normalize, contrast_enhance_scale)
        video = svd.svd_vae_decode(self.vae_decoder_params, lat.transpose(0, 1).to(dt))
        return self.tensor2video(video)
