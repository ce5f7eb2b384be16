"""AnimateDiff-SDXL video pipeline, port of svi_tpu/pipelines/sdxl_video.py.

Frames ride the SDXL UNet's batch axis and every frame goes through one UNet
call a branch and step, the AnimateDiff-SDXL motion modules attending across
all of them (`motion.SDXL_MOTION_CALL_MAP`). Without motion modules every
frame shares one noise tensor. The DDIM betas are linear with motion modules
(original AnimateDiff), scaled-linear without. IP-Adapter images condition
the positive branch through extra K/V (a zero image embedding on the
negative one), optionally in instant style; ControlNet Union residuals come
from the frames' conditioning. CFG runs two passes. A smoother may render
the frames a step would end at, smooth them, and turn them back into a noise
prediction. The VAE runs one frame a call.

Models are `ParamTree`s in the pipeline's dtype (f32 by default); frames are
(H, W, 3) uint8 arrays. Passing `chatglm_params` (or a Kolors text encoder
in the model manager) switches the prompter to Kolors; without motion
modules the scheduler is then Kolors' own (beta_end 0.014, 1100 training
timesteps), with them AnimateDiff's betas as above.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import ipadapter as ip
from ..models import motion as mo
from ..models import sdxl
from ..prompters.kolors_prompter import KolorsPrompter
from ..prompters.sdxl_prompter import SDXLPrompter
from ..schedulers.ddim import EnhancedDDIMScheduler
from ..utils.image_process import resize_uint8
from .base import check_resize_height_width, generate_noise, preprocess_image
from .sd_image import cast_model, model_device, vae_output_to_frames
from .sdxl_image import add_time_ids


class SDXLVideoPipeline:
    def __init__(self, unet, motion=None, text_encoder=None, text_encoder_2=None,
                 vae_encoder=None, vae_decoder=None, tokenizer=None, tokenizer_2=None,
                 chatglm_params=None, ipadapter=None, ipadapter_image_encoder=None,
                 controlnet=None, dtype=torch.float32, use_original_animatediff=True):
        beta = "linear" if (motion is not None and use_original_animatediff) \
            else "scaled_linear"
        if chatglm_params is not None:
            self.prompter = KolorsPrompter(tokenizer)
            text_encoder = chatglm_params
            if motion is None:  # Kolors alone keeps its own schedule
                self.scheduler = EnhancedDDIMScheduler(beta_end=0.014, num_train_timesteps=1100)
            else:  # AnimateDiff's betas (the JAX package's choice with motion)
                self.scheduler = EnhancedDDIMScheduler(beta_schedule=beta)
        else:
            self.prompter = SDXLPrompter(tokenizer, tokenizer_2)
            self.scheduler = EnhancedDDIMScheduler(beta_schedule=beta)
        self.unet = cast_model(unet, dtype)
        self.motion = cast_model(motion, dtype)
        self.text_encoder = cast_model(text_encoder, dtype)
        self.text_encoder_2 = cast_model(text_encoder_2, dtype)
        self.vae_encoder = cast_model(vae_encoder, dtype)
        self.vae_decoder = cast_model(vae_decoder, dtype)
        self.ipadapter = cast_model(ipadapter, dtype)
        self.ipadapter_image_encoder = cast_model(ipadapter_image_encoder, dtype)
        self.controlnet = controlnet  # a MultiControlNetManager or None
        if controlnet is not None:
            controlnet.units = [(fn, cast_model(p, dtype), *rest)
                                for fn, p, *rest in controlnet.units]
        self.dtype = dtype
        self.device = model_device(self.unet)

    @staticmethod
    def from_model_manager(model_manager, controlnet_config_units=(), prompt_refiner_classes=(),
                           **kwargs):
        """The SDXL models from a ModelManager; one ControlNet Union per
        config unit, loaded from its file onto the manager's device (the
        refiner classes are not read, as in the JAX package)."""
        from ..models import controlnets as cn
        from ..models import model_io

        units, processors = [], []
        for unit in controlnet_config_units:
            params = cn.sdxl_controlnet_params_from_torch(
                model_io.load_state_dict(unit.model_path), device=model_manager.device)

            def fwd(p, s, t, e, c, _pid=unit.processor_id, **kw):
                return cn.sdxl_controlnet_forward(p, s, t, e, c, _pid, **kw)

            units.append((fwd, params, unit.scale))
            processors.append(cn.Annotator(unit.processor_id,
                                           skip_processor=unit.skip_processor))
        fetch = model_manager.fetch_model
        return SDXLVideoPipeline(
            fetch("sdxl_unet"), motion=fetch("sdxl_motion_modules"),
            text_encoder=fetch("sdxl_text_encoder"), text_encoder_2=fetch("sdxl_text_encoder_2"),
            chatglm_params=fetch("kolors_text_encoder"),
            vae_encoder=fetch("sdxl_vae_encoder"), vae_decoder=fetch("sdxl_vae_decoder"),
            ipadapter=fetch("sdxl_ipadapter"),
            ipadapter_image_encoder=fetch("sdxl_ipadapter_clip_image_encoder"),
            controlnet=cn.MultiControlNetManager(units, processors) if units else None,
            **kwargs)

    def encode_prompt(self, prompt, clip_skip=1, clip_skip_2=2):
        pooled, emb = self.prompter.encode_prompt(self.text_encoder, self.text_encoder_2,
                                                  prompt, clip_skip, clip_skip_2)
        return pooled.to(self.dtype), emb.to(self.dtype)

    def _unet_all_frames(self, latents, t, emb, pooled, add_time_id, ipadapter_kwargs_list=None,
                         controlnet_res=None, tiled=False, tile_size=64, tile_stride=32):
        """Every frame in one UNet call, the motion modules across them."""
        hooks = None if self.motion is None else mo.motion_hooks(
            self.motion, call_map=mo.SDXL_MOTION_CALL_MAP, batch_size=1)
        f = latents.shape[0]
        emb = emb.repeat(f, 1, 1) if emb.shape[0] == 1 else emb
        pooled = pooled.repeat(f, 1) if pooled.shape[0] == 1 else pooled
        ids = add_time_id.repeat(f, 1) if add_time_id.shape[0] == 1 else add_time_id
        return sdxl.sdxl_unet_forward(self.unet, latents, t, emb, ids, pooled,
                                      controlnet_res=controlnet_res,
                                      ipadapter_kwargs_list=ipadapter_kwargs_list, motion=hooks,
                                      tiled=tiled, tile_size=tile_size, tile_stride=tile_stride)

    def decode_video(self, latents, tiled=False, tile_size=64, tile_stride=32):
        """(F, 4, h, w) latents -> F (8h, 8w, 3) uint8 frames, one frame a call."""
        return vae_output_to_frames(torch.cat([
            sdxl.sdxl_vae_decode(self.vae_decoder, latents[i:i + 1], tiled=tiled,
                                 tile_size=tile_size, tile_stride=tile_stride)
            for i in range(latents.shape[0])]))

    def encode_video(self, frames, tiled=False, tile_size=64, tile_stride=32):
        lat = []
        for f in frames:
            img = torch.from_numpy(preprocess_image(f)).to(self.device, self.dtype)
            lat.append(sdxl.sdxl_vae_encode(self.vae_encoder, img, tiled=tiled,
                                            tile_size=tile_size, tile_stride=tile_stride))
        return torch.cat(lat)

    def _prepare_controlnet_frames(self, controlnet_frames):
        """Frame streams -> (num_units, F, 3, H, W) conditioning: one stream
        per unit, or one stream annotated by every unit."""
        if controlnet_frames is None or self.controlnet is None:
            return None
        if isinstance(controlnet_frames[0], list):
            cond = np.stack([np.stack([self.controlnet.process_image(f, processor_id=pid)[0]
                                       for f in stream]) for pid, stream
                             in enumerate(controlnet_frames)])
        else:
            cond = np.stack([self.controlnet.process_image(f) for f in controlnet_frames],
                            axis=1)
        return torch.from_numpy(cond).to(self.device, self.dtype)

    def encode_ipadapter_images(self, images) -> torch.Tensor:
        """Frames resized to 224x224 (Pillow's bicubic), in [-1, 1] as the
        JAX package feeds them, through the image encoder: (n, proj)."""
        px = np.concatenate([preprocess_image(resize_uint8(im, 224, 224)) for im in images])
        return ip.clip_image_encoder_forward(self.ipadapter_image_encoder,
                                             torch.from_numpy(px).to(self.device, self.dtype))

    @torch.no_grad()
    def __call__(self, prompt, negative_prompt="", cfg_scale=7.5, clip_skip=1, clip_skip_2=2,
                 num_frames=None, input_frames=None, ipadapter_images=None, ipadapter_scale=1.0,
                 ipadapter_use_instant_style=False, controlnet_frames=None,
                 denoising_strength=1.0, height=512, width=512, num_inference_steps=20,
                 smoother=None, smoother_progress_ids=(), tiled=False, tile_size=64,
                 tile_stride=32, seed=None, prompt_emb_posi=None, prompt_emb_nega=None,
                 ipadapter_image_emb=None):
        height, width = check_resize_height_width(height, width, factor=64)
        tiler_kwargs = {"tiled": tiled, "tile_size": tile_size, "tile_stride": tile_stride}
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength)
        dev, dt = self.device, self.dtype

        if self.motion is None:  # one noise tensor shared by every frame
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
            prompt_emb_posi = self.encode_prompt(prompt, clip_skip, clip_skip_2)
        if prompt_emb_nega is None:
            prompt_emb_nega = self.encode_prompt(negative_prompt, clip_skip, clip_skip_2)
        pooled_posi, emb_posi = (torch.as_tensor(x).to(dev, dt) for x in prompt_emb_posi)
        pooled_nega, emb_nega = (torch.as_tensor(x).to(dev, dt) for x in prompt_emb_nega)

        ip_posi = ip_nega = None
        if self.ipadapter is not None and (ipadapter_images is not None
                                           or ipadapter_image_emb is not None):
            if ipadapter_image_emb is None:
                ipadapter_image_emb = self.encode_ipadapter_images(ipadapter_images)
            emb_img = torch.as_tensor(ipadapter_image_emb).to(dev, dt)
            ip_posi = ip.sdxl_ipadapter_kv(self.ipadapter, emb_img, scale=float(ipadapter_scale),
                                           use_instant_style=ipadapter_use_instant_style)
            ip_nega = ip.sdxl_ipadapter_kv(self.ipadapter, torch.zeros_like(emb_img),
                                           use_instant_style=ipadapter_use_instant_style)

        controlnet_cond = self._prepare_controlnet_frames(controlnet_frames)
        add_time_id = add_time_ids(height, width, dev)

        for progress_id, timestep in enumerate(self.scheduler.timesteps):
            t = torch.tensor([float(timestep)], dtype=dt, device=dev)

            def run(emb, pooled, ipkw):
                res = None
                if controlnet_cond is not None:
                    f = latents.shape[0]
                    res = self.controlnet(
                        latents, t, emb.repeat(f, 1, 1) if emb.shape[0] == 1 else emb,
                        controlnet_cond, add_time_id=add_time_id.repeat(f, 1),
                        add_text_embeds=pooled.repeat(f, 1) if pooled.shape[0] == 1 else pooled)
                return self._unet_all_frames(latents, t, emb, pooled, add_time_id,
                                             ipadapter_kwargs_list=ipkw, controlnet_res=res,
                                             **tiler_kwargs)

            noise_pred = run(emb_posi, pooled_posi, ip_posi)
            if cfg_scale != 1.0:
                nega = run(emb_nega, pooled_nega, ip_nega)
                noise_pred = nega + cfg_scale * (noise_pred - nega)
            if smoother is not None and progress_id in smoother_progress_ids:
                rendered = self.scheduler.step(noise_pred.float(), timestep, latents.float(),
                                               to_final=True)
                frames = smoother(self.decode_video(rendered.to(dt)),
                                  original_frames=input_frames)
                target = self.encode_video(frames).float()
                noise_pred = self.scheduler.return_to_timestep(timestep, latents.float(), target)
            latents = self.scheduler.step(noise_pred.float(), timestep, latents.float()).to(dt)

        frames = self.decode_video(latents, **tiler_kwargs)
        if smoother is not None and (num_inference_steps in smoother_progress_ids
                                     or -1 in smoother_progress_ids):
            frames = smoother(frames, original_frames=input_frames)
        return frames
