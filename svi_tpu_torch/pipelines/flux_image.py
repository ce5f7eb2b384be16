"""FLUX.1 text- and image-to-image pipeline, port of
svi_tpu/pipelines/flux_image.py: the flow-match scheduler at shift 3,
embedded guidance (3.5 by default) with optional true CFG (one DiT batch of
two when nothing conditions only the positive branch), ControlNet units, an
IP-Adapter from a precomputed SigLIP embedding, regional prompts, tiled
denoising with each tile's ControlNet conditioning sliced to it, EliGen
entity prompts (on the negative branch too, and inpainting), and TeaCache.

`controlnet_units`: (params, conditioning, scale, processor_id_index), the
conditioning an (H, W, 3) uint8 image (VAE-encoded here) or ready
(1, 16, h/8, w/8) latents. Models are the port's `ParamTree`s cast to the
pipeline's dtype (bf16 by default), the VAE too, as svi_tpu casts them, on
the device they lie on (the VAE mid-block's one head of 512 runs the bf16
kernel on the card); `t5` is a (T5Encoder, cfg, tokenizer) triple; images
and entity masks are (H, W, 3) uint8 arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import flux
from ..prompters.flux_prompter import FluxPrompter
from ..schedulers.flow_match import FlowMatchScheduler
from ..utils.image_process import resize_nearest_uint8
from .base import (check_resize_height_width, control_noise_via_local_prompts, extend_prompt,
                   generate_noise, preprocess_image)
from .sd_image import cast_model, model_device, vae_output_to_frames


class FluxTeaCache:
    """Step skipping: the relative L1 change of the first block's modulated
    input, rescaled by FLUX's polynomial, accumulates over steps; below the
    threshold the block stacks are skipped and their last residual reused.
    The first and the last step always compute. Decided in f32 on the
    device, on the positive branch only."""

    COEFFS = [4.98651651e+02, -2.83781631e+02, 5.58554382e+01, -3.82021401e+00,
              2.64230861e-01]

    def __init__(self, num_inference_steps, rel_l1_thresh):
        self.num_inference_steps = num_inference_steps
        self.step = 0
        self.accumulated_rel_l1_distance = 0.0
        self.previous_modulated_input = None
        self.rel_l1_thresh = rel_l1_thresh
        self.previous_residual = None

    def check(self, modulated_inp) -> bool:
        """True: reuse the stored residual (skip the blocks)."""
        modulated_inp = torch.as_tensor(modulated_inp).float()
        if self.step == 0 or self.step == self.num_inference_steps - 1:
            should_calc = True
            self.accumulated_rel_l1_distance = 0.0
        else:
            prev = self.previous_modulated_input
            rel = float((modulated_inp - prev).abs().mean() / prev.abs().mean())
            self.accumulated_rel_l1_distance += float(np.polyval(self.COEFFS, rel))
            should_calc = self.accumulated_rel_l1_distance >= self.rel_l1_thresh
            if should_calc:
                self.accumulated_rel_l1_distance = 0.0
        self.previous_modulated_input = modulated_inp
        self.step += 1
        if self.step == self.num_inference_steps:
            self.step = 0
        return not should_calc

    def store(self, pre_tokens, post_tokens):
        self.previous_residual = post_tokens.float() - pre_tokens.float()

    def update(self, pre_tokens):
        return pre_tokens.float() + self.previous_residual


class FluxImagePipeline:
    def __init__(self, dit_params, text_encoder_1_params=None, t5=None, vae_encoder_params=None,
                 vae_decoder_params=None, tokenizer=None, dtype=torch.bfloat16):
        self.scheduler = FlowMatchScheduler(shift=3.0)
        self.prompter = FluxPrompter(tokenizer)
        self.dit_params = cast_model(dit_params, dtype)
        self.text_encoder_1_params = cast_model(text_encoder_1_params, dtype)
        self.t5 = t5
        self.vae_encoder_params = cast_model(vae_encoder_params, dtype)
        self.vae_decoder_params = cast_model(vae_decoder_params, dtype)
        self.dtype = dtype
        self.device = model_device(self.dit_params)

    def _dit(self, latents, timestep, emb, pooled, guidance, controlnet_res=None,
             ipadapter=None, entity_prompt_emb=None, entity_masks=None):
        return flux.flux_dit_forward(self.dit_params, latents, timestep, emb, pooled,
                                     guidance=guidance, controlnet_res=controlnet_res,
                                     ipadapter=ipadapter, entity_prompt_emb=entity_prompt_emb,
                                     entity_masks=entity_masks)

    def _cfg_dit(self, latents, timestep, emb_posi, emb_nega, pooled_posi, pooled_nega,
                 guidance, cfg_scale):
        """Both CFG branches in one DiT pass."""
        pred = flux.flux_dit_forward(
            self.dit_params, torch.cat([latents, latents]), torch.cat([timestep, timestep]),
            torch.cat([emb_posi, emb_nega]), torch.cat([pooled_posi, pooled_nega]),
            guidance=torch.cat([guidance, guidance]))
        posi, nega = pred.chunk(2)
        return nega + cfg_scale * (posi - nega)

    def _vae_encode(self, image, **tiler_kwargs):
        """An (H, W, 3) uint8 image -> latents in the pipeline's dtype."""
        return flux.flux_vae_encode(
            self.vae_encoder_params,
            torch.from_numpy(preprocess_image(image)).to(self.device, self.dtype),
            **tiler_kwargs).to(self.dtype)

    def encode_prompt(self, prompt, t5_sequence_length=512):
        emb, pooled = self.prompter.encode_prompt(self.text_encoder_1_params, self.t5, prompt,
                                                  t5_sequence_length)
        return emb.to(self.device, self.dtype), pooled.to(self.dtype)

    def vae_output_to_image(self, vae_output):
        return vae_output_to_frames(vae_output[:1])[0]

    @torch.no_grad()
    def __call__(self, prompt, negative_prompt="", cfg_scale=1.0, embedded_guidance=3.5,
                 t5_sequence_length=512, input_image=None, denoising_strength=1.0, height=1024,
                 width=1024, num_inference_steps=30, seed=None, prompt_emb_posi=None,
                 prompt_emb_nega=None, controlnet_units=(), ipadapter_params=None,
                 ipadapter_image_emb=None, ipadapter_scale=1.0, tiled=False, tile_size=128,
                 tile_stride=64, local_prompts=None, masks=None, mask_scales=None,
                 eligen_entity_prompts=None, eligen_entity_masks=None,
                 enable_eligen_on_negative=False, enable_eligen_inpaint=False,
                 tea_cache_l1_thresh=None):
        """ipadapter_image_emb: the (1, 1152) SigLIP pooled embedding of the
        IP image. tiled: feathered latent tiles of the whole denoise
        forward (each tile's ControlNet conditioning sliced to it) and the
        tiled VAE."""
        height, width = check_resize_height_width(height, width, factor=16)
        prompt, local_prompts, masks, mask_scales = extend_prompt(
            self.prompter, prompt, local_prompts, masks, mask_scales)
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength)
        dev, dt = self.device, self.dtype
        vae_tiler = {"tiled": tiled, "tile_size": tile_size, "tile_stride": tile_stride}

        noise = generate_noise((1, 16, height // 8, width // 8), seed).to(dev, dt)
        if input_image is not None:
            latents = self._vae_encode(input_image, **vae_tiler)
            latents = self.scheduler.add_noise(latents, noise,
                                               timestep=self.scheduler.timesteps[0]).to(dt)
        else:
            latents = noise

        if prompt_emb_posi is None:
            prompt_emb_posi = self.encode_prompt(prompt, t5_sequence_length)
        emb_posi, pooled_posi = prompt_emb_posi
        prompt_emb_locals = [self.encode_prompt(p, t5_sequence_length) for p in local_prompts]
        emb_nega = pooled_nega = None
        if cfg_scale != 1.0:
            if prompt_emb_nega is None:
                prompt_emb_nega = self.encode_prompt(negative_prompt, t5_sequence_length)
            emb_nega, pooled_nega = prompt_emb_nega
        guidance = torch.tensor([embedded_guidance], dtype=dt, device=dev)

        cn_units = []
        for cn_params, cond, scale, proc_idx in controlnet_units:
            if np.ndim(cond) != 4:  # an image, not latents
                cond = self._vae_encode(cond)
            cn_units.append((cn_params, torch.as_tensor(cond).to(dev, dt), float(scale),
                             proc_idx))

        ent_posi = ent_nega = ent_masks = fg_mask = input_latents = None
        if eligen_entity_masks is not None:
            lat_masks = []
            for m in eligen_entity_masks:
                arr = preprocess_image(resize_nearest_uint8(m, width // 8, height // 8))
                lat_masks.append((arr.mean(axis=1, keepdims=True) > 0).astype(np.float32))
            ent_masks = torch.from_numpy(np.stack(lat_masks, axis=1)).to(dev)  # (1, N, 1, h, w)
            ent_posi = torch.stack([self.encode_prompt(p, t5_sequence_length)[0]
                                    for p in eligen_entity_prompts], dim=1)
            if enable_eligen_on_negative and cfg_scale != 1.0:
                ent_nega = emb_nega[:, None].repeat(1, ent_masks.shape[1], 1, 1)
            if enable_eligen_inpaint:
                assert input_image is not None, "eligen inpaint needs input_image"
                fg = np.stack(lat_masks).sum(axis=0) > 0  # (1, 1, h, w)
                fg_mask = torch.from_numpy(np.repeat(fg, 16, axis=1)).to(dev)
                input_latents = self._vae_encode(input_image).float()

        ipadapter = None
        if ipadapter_params is not None and ipadapter_image_emb is not None:
            ip_k, ip_v, _ = flux.flux_ipadapter_forward(
                ipadapter_params, torch.as_tensor(ipadapter_image_emb).to(dev, dt))
            ipadapter = (ip_k, ip_v, float(ipadapter_scale))

        n_joint = len(self.dit_params["blocks"])
        n_single = len(self.dit_params["single_blocks"])
        tea_cache = (FluxTeaCache(num_inference_steps, tea_cache_l1_thresh)
                     if tea_cache_l1_thresh is not None else None)

        def predict_posi_teacache(latents, t):
            h, w = latents.shape[-2:]
            xa, ctx, temb, cos, sin, am = flux.flux_dit_prelude(
                self.dit_params, latents, t, emb_posi, pooled_posi, guidance=guidance,
                entity_prompt_emb=ent_posi, entity_masks=ent_masks)
            if tea_cache.check(flux.flux_teacache_modulated(self.dit_params, xa, temb)):
                xa_out = tea_cache.update(xa).to(xa.dtype)
            else:
                xa_out = flux.flux_dit_blocks(self.dit_params, xa, ctx, temb, cos, sin,
                                              attn_mask=am)
                tea_cache.store(xa, xa_out)
            return flux.flux_dit_head(self.dit_params, xa_out, temb, h, w)

        def predict(latents, t, cn_units, ent_p=None, ent_m=None):
            controlnet_res = None
            if cn_units:
                joint = single = 0.0
                for cn_params, cond, scale, proc_idx in cn_units:
                    j_, s_ = flux.flux_controlnet_forward(
                        cn_params, latents, cond, t, emb_posi, pooled_posi, guidance,
                        processor_id_index=proc_idx)
                    joint, single = joint + j_ * scale, single + s_ * scale
                controlnet_res = (joint[:n_joint], single[:n_single])
            if cfg_scale != 1.0 and controlnet_res is None and ipadapter is None \
                    and ent_p is None and ent_nega is None:
                return self._cfg_dit(latents, t, emb_posi, emb_nega, pooled_posi, pooled_nega,
                                     guidance, cfg_scale)
            posi = self._dit(latents, t, emb_posi, pooled_posi, guidance,
                             controlnet_res=controlnet_res, ipadapter=ipadapter,
                             entity_prompt_emb=ent_p, entity_masks=ent_m)
            if cfg_scale == 1.0:
                return posi
            # the extras condition the positive branch only; EliGen joins the
            # negative with enable_eligen_on_negative
            nega = self._dit(latents, t, emb_nega, pooled_nega, guidance,
                             entity_prompt_emb=ent_nega,
                             entity_masks=ent_m if ent_nega is not None else None)
            return nega + cfg_scale * (posi - nega)

        for i, timestep in enumerate(self.scheduler.timesteps):
            t = torch.tensor([float(timestep)], dtype=dt, device=dev)
            if tea_cache is not None:
                posi = predict_posi_teacache(latents, t)
                if cfg_scale != 1.0:
                    nega = self._dit(latents, t, emb_nega, pooled_nega, guidance,
                                     entity_prompt_emb=ent_nega,
                                     entity_masks=ent_masks if ent_nega is not None else None)
                    noise_pred = nega + cfg_scale * (posi - nega)
                else:
                    noise_pred = posi
            elif local_prompts:
                # the regions run without ControlNet or IP-Adapter
                def cb(pe):
                    return self._dit(latents, t, pe[0], pe[1], guidance).float()

                posi = control_noise_via_local_prompts((emb_posi, pooled_posi),
                                                       prompt_emb_locals, masks, mask_scales, cb)
                if cfg_scale != 1.0:
                    nega = cb((emb_nega, pooled_nega))
                    noise_pred = nega + float(cfg_scale) * (posi - nega)
                else:
                    noise_pred = posi
            elif tiled:
                from ..models.tiler import fast_tiled_forward

                def tile_fn(hl, hr, wl, wr):
                    sl = latents[:, :, hl:hr, wl:wr]
                    cn_sl = [(cp, cond[:, :, hl:hr, wl:wr], sc, pi)
                             for cp, cond, sc, pi in cn_units]
                    return predict(sl, t, cn_sl).permute(0, 2, 3, 1)

                noise_pred = fast_tiled_forward(tile_fn, latents.permute(0, 2, 3, 1), tile_size,
                                                tile_stride).permute(0, 3, 1, 2)
            else:
                noise_pred = predict(latents, t, cn_units, ent_p=ent_posi, ent_m=ent_masks)
            if enable_eligen_inpaint and input_latents is not None:
                sig = float(self.scheduler.sigmas[i])
                inp = (latents.float() - input_latents) / sig
                noise_pred = torch.where(fg_mask, noise_pred.float(), inp)
            latents = self.scheduler.step(noise_pred.float(), timestep, latents.float()).to(dt)

        return self.vae_output_to_image(flux.flux_vae_decode(
            self.vae_decoder_params, latents.to(self.dtype), **vae_tiler))
