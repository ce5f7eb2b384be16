"""OmniGen image pipeline, port of svi_tpu/pipelines/omnigen_image.py: the
flow-match scheduler (num_train_timesteps 1, shift 1, inverse timesteps,
sigmas from 0 to 1), the SDXL VAE (`models.sdxl`; its mid-block attention is
the f32 D512 kernel on the card), separate-CFG denoising over [cond, uncond]
or [cond, uncond, img_cond] branches with `image_cfg_scale`, and the
condition KV cache: step 0 runs each branch's whole sequence and keeps its
condition K / V, later steps run only the time and noise suffix with the
position ids and mask rows cut to it.

The transformer and the VAE halves are the port's `ParamTree`s on the
device they lie on, in the pipeline's dtype (f32 by default). The prompter
is an `OmniGenPrompter` (its tokenizer the caller's callable), or its
output is passed as prompt_inputs. Reference and input images are (H, W, 3)
uint8 arrays. The call returns an (H, W, 3) uint8 array (svi_tpu's is a PIL
image).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import omnigen as og
from ..models import sdxl
from ..schedulers.flow_match import FlowMatchScheduler
from .base import check_resize_height_width, generate_noise, preprocess_image
from .sd_image import cast_model, model_device


class OmnigenImagePipeline:
    def __init__(self, transformer_params, vae_encoder_params=None, vae_decoder_params=None,
                 prompter=None, dtype=torch.float32, num_heads=32, num_kv_heads=None,
                 rope_cfg=og.OMNIGEN_ROPE):
        self.scheduler = FlowMatchScheduler(num_train_timesteps=1, shift=1,
                                            inverse_timesteps=True, sigma_min=0, sigma_max=1)
        self.transformer_params = cast_model(transformer_params, dtype)
        self.vae_encoder_params = cast_model(vae_encoder_params, dtype)
        self.vae_decoder_params = cast_model(vae_decoder_params, dtype)
        self.prompter = prompter
        self.dtype = dtype
        self.device = model_device(self.transformer_params)
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.rope_cfg = rope_cfg

    def vae_output_to_image(self, vae_output):
        """(1, 3, H, W) in about [-1, 1] -> an (H, W, 3) uint8 array."""
        arr = vae_output[0].float().permute(1, 2, 0).cpu().numpy()
        return ((arr / 2 + 0.5).clip(0, 1) * 255).astype(np.uint8)

    @torch.no_grad()
    def __call__(self, prompt, reference_images=[], cfg_scale=2.0, image_cfg_scale=2.0,
                 use_kv_cache=True, input_image=None, denoising_strength=1.0, height=1024,
                 width=1024, num_inference_steps=20, seed=None, prompt_inputs=None, tiled=False,
                 tile_size=64, tile_stride=32, progress_bar_cmd=lambda x: x):
        height, width = check_resize_height_width(height, width)
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

        if prompt_inputs is None:
            prompt_inputs = self.prompter(prompt, reference_images or None, height=height,
                                          width=width)
        n_branches = len(prompt_inputs["input_ids"])

        # each branch's reference images through the VAE encoder
        ref_latents = [[sdxl.sdxl_vae_encode(self.vae_encoder_params,
                                             torch.as_tensor(px).to(dev, dt), **tiler_kwargs)
                        for px in pix] for pix in prompt_inputs["input_pixel_values"]]

        num_img_tokens = latents.shape[-1] * latents.shape[-2] // 4
        caches = [None] * n_branches
        branch_inputs = [
            dict(input_ids=torch.as_tensor(prompt_inputs["input_ids"][i]).to(dev),
                 attention_mask=torch.as_tensor(prompt_inputs["attention_mask"][i],
                                                dtype=torch.float32).to(dev),
                 position_ids=torch.as_tensor(prompt_inputs["position_ids"][i]).to(dev),
                 input_image_sizes=prompt_inputs["input_image_sizes"][i])
            for i in range(n_branches)]

        for progress_id, timestep in enumerate(progress_bar_cmd(self.scheduler.timesteps)):
            t = torch.tensor([float(timestep)], dtype=dt, device=dev)
            outs = []
            for i in range(n_branches):
                bi = branch_inputs[i]
                out, kv = og.omnigen_forward(
                    self.transformer_params, latents, t, bi["input_ids"], ref_latents[i],
                    bi["input_image_sizes"], bi["attention_mask"], bi["position_ids"],
                    num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
                    rope_cfg=self.rope_cfg, kv_cache=caches[i],
                    return_kv=use_kv_cache and caches[i] is None)
                if use_kv_cache and caches[i] is None:
                    caches[i] = kv
                outs.append(out)

            if n_branches == 3:
                cond, uncond, img_cond = outs
                noise_pred = (uncond + image_cfg_scale * (img_cond - uncond)
                              + cfg_scale * (cond - img_cond))
            else:
                cond, uncond = outs
                noise_pred = uncond + cfg_scale * (cond - uncond)

            latents = self.scheduler.step(noise_pred.float(),
                                          self.scheduler.timesteps[progress_id],
                                          latents.float()).to(dt)

            if progress_id == 0 and use_kv_cache:
                # later steps: the time and noise suffix only
                for i in range(n_branches):
                    bi = branch_inputs[i]
                    bi["input_ids"] = None
                    bi["position_ids"] = bi["position_ids"][:, -(num_img_tokens + 1):]
                    bi["attention_mask"] = bi["attention_mask"][:, -(num_img_tokens + 1):, :]
                    bi["input_image_sizes"] = ()
                    ref_latents[i] = []

        return self.vae_output_to_image(
            sdxl.sdxl_vae_decode(self.vae_decoder_params, latents, **tiler_kwargs))
