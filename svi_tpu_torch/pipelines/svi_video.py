"""SVI per-clip image-to-video pipeline (shot / film variants).

Port of svi_tpu/pipelines/svi_video.py: `SVIVideoPipeline.__call__` with
its prompts (the umT5 prompter), `encode_images_adaptive` (temporal mask +
VAE latent of [condition frames | padding] + CLIP features), video-to-video
(`input_video` + `denoising_strength`), `last_latent` and `y_extra`, the
batched classifier-free-guidance denoise loop and its TeaCache variant, and
the decode to uint8 frames, tiled by default as in the JAX pipeline; and
`from_model_manager` (models.model_io.ModelManager).

`add_condition` (pose tokens, SVI-Dance) goes to the DiT's patch tokens as a
(cond, uncond) pair: the uncond branch takes zeros where the pair's second
is None. The dance and talk pipelines (svi_video_dance.py, svi_video_talk.py)
build on this one.

Differences from the JAX pipeline: frames come back as (H, W, 3) uint8 numpy
arrays instead of PIL images. Everything runs under `torch.inference_mode()`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..prompters.wan_prompter import WanPrompter
from ..schedulers.flow_match import FlowMatchScheduler
from . import base


class TeaCache:
    """Step-skipping cache: a polynomial rescale of the relative L1 change of
    t_mod decides whether to reuse the previous block-stack residual.
    Decisions depend only on the timestep, so one cache serves the batched
    cond/uncond pair."""

    COEFFICIENTS = {
        "Wan2.1-T2V-1.3B": [-5.21862437e04, 9.23041404e03, -5.28275948e02, 1.36987616e01, -4.99875664e-02],
        "Wan2.1-T2V-14B": [-3.03318725e05, 4.90537029e04, -2.65530556e03, 5.87365115e01, -3.15583525e-01],
        "Wan2.1-I2V-14B-480P": [2.57151496e05, -3.54229917e04, 1.40286849e03, -1.35890334e01, 1.32517977e-01],
        "Wan2.1-I2V-14B-720P": [8.10705460e03, 2.13393892e03, -3.72934672e02, 1.66203073e01, -4.17769401e-02],
    }

    def __init__(self, num_inference_steps, rel_l1_thresh, model_id):
        if model_id not in self.COEFFICIENTS:
            supported = ", ".join(self.COEFFICIENTS)
            raise ValueError(
                f"{model_id} is not a supported TeaCache model id. Please choose a valid model id in ({supported})."
            )
        self.num_inference_steps = num_inference_steps
        self.step = 0
        self.accumulated_rel_l1_distance = 0.0
        self.previous_modulated_input = None
        self.rel_l1_thresh = rel_l1_thresh
        self.previous_residual = None
        self.previous_hidden_states = None
        self.coefficients = self.COEFFICIENTS[model_id]
        self.skipped_steps = 0  # block-stack evaluations saved

    def check(self, x_tokens, t_mod) -> bool:
        """Returns True if the block stack can be SKIPPED this step."""
        modulated = t_mod.float().cpu().numpy()
        if self.step == 0 or self.step == self.num_inference_steps - 1:
            should_calc = True
            self.accumulated_rel_l1_distance = 0.0
        else:
            rescale = np.poly1d(self.coefficients)
            prev = self.previous_modulated_input
            rel = np.abs(modulated - prev).mean() / np.abs(prev).mean()
            self.accumulated_rel_l1_distance += float(rescale(rel))
            if self.accumulated_rel_l1_distance < self.rel_l1_thresh:
                should_calc = False
            else:
                should_calc = True
                self.accumulated_rel_l1_distance = 0.0
        self.previous_modulated_input = modulated
        self.step += 1
        if self.step == self.num_inference_steps:
            self.step = 0
        if should_calc:
            self.previous_hidden_states = x_tokens
        else:
            self.skipped_steps += 1
        return not should_calc

    def store(self, hidden_states):
        self.previous_residual = hidden_states - self.previous_hidden_states
        self.previous_hidden_states = None

    def update(self, hidden_states):
        return hidden_states + self.previous_residual


def _prep(img, height: int, width: int, aug: bool = False) -> np.ndarray:
    """A PIL image (resized as the JAX pipeline does) or an (H, W, 3) uint8
    array of the target size -> (1, 3, H, W) f32 in [-1, 1]; aug applies the
    train-time first-frame augmentation (Pillow)."""
    if not isinstance(img, np.ndarray) and hasattr(img, "resize"):
        img = img.resize((width, height))  # PIL, as handed in
    elif np.asarray(img).shape[:2] != (height, width):
        raise ValueError(f"frame of shape {np.asarray(img).shape} must be ({height}, {width}, 3); "
                         "pass a PIL image to have it resized")
    return base.preprocess_image(img, use_aug=aug)


class SVIVideoPipeline:
    """Per-clip I2V generation with motion-frame conditioning. Its models
    (`dit`: models.wan_dit.WanDiT, `vae`: models.wan_vae.WanVAE,
    `image_encoder`: models.clip_vision.ClipVision, `text_encoder`:
    models.t5.T5Encoder) live on `device`: set them, or take them from a
    ModelManager with `from_model_manager`."""

    def __init__(self, device="cuda", torch_dtype=torch.bfloat16, tokenizer_path=None,
                 num_train_timesteps=1000):
        self.device = torch.device(device)
        self.dtype = torch_dtype
        self.scheduler = FlowMatchScheduler(
            shift=5, sigma_min=0.0, extra_one_step=True, num_train_timesteps=num_train_timesteps,
        )
        self.prompter = WanPrompter(tokenizer_path=tokenizer_path)
        self.text_encoder = None
        self.dit = None
        self.vae = None
        self.image_encoder = None
        self.last_tea_cache = None  # the last clip's TeaCache (skip count), if any
        # USP (the reference's use_usp): the DiT runs sequence-parallel over sp_mesh
        self.use_unified_sequence_parallel = False
        self.sp_mesh = None

    # -- construction -----------------------------------------------------------

    def fetch_models(self, model_manager):
        """Take the four models from a ModelManager; the tokenizer from
        google/umt5-xxl beside the text encoder's checkpoint, where it is."""
        res = model_manager.fetch_model("wan_video_text_encoder", require_model_path=True)
        if res is not None:
            self.text_encoder, path = res
            self.prompter.fetch_models(self.text_encoder)
            if path:
                cand = os.path.join(os.path.dirname(path if isinstance(path, str) else path[0]),
                                    "google/umt5-xxl")
                if os.path.isdir(cand):
                    self.prompter.fetch_tokenizer(cand)
        self.dit = model_manager.fetch_model("wan_video_dit")
        self.vae = model_manager.fetch_model("wan_video_vae")
        self.image_encoder = model_manager.fetch_model("wan_video_image_encoder")
        return self

    @staticmethod
    def from_model_manager(model_manager, torch_dtype=None, device="cuda", use_usp=False,
                           num_train_timesteps=1000):
        """use_usp: every rank of the process group runs the pipeline, and the
        DiT forward runs sequence-parallel over all of them (`enable_usp`)."""
        pipe = SVIVideoPipeline(device=device, torch_dtype=torch_dtype or model_manager.dtype,
                                num_train_timesteps=num_train_timesteps)
        return pipe.fetch_models(model_manager).enable_usp(use_usp)

    def enable_usp(self, use_usp: bool = True):
        """With use_usp, the DiT forward of the denoise loop goes through
        parallel.sequence_parallel.forward_sp over every rank
        (`make_sp_mesh`; the reference's use_usp, svi_video.py:265-273);
        the TeaCache loop keeps the single-device forward, as in the JAX
        package."""
        if use_usp:
            from ..parallel.mesh import make_sp_mesh

            self.sp_mesh = make_sp_mesh()
            self.use_unified_sequence_parallel = True
        return self

    def _dit_forward(self, x, t, ctx, clip_feature, y, add_condition):
        if self.use_unified_sequence_parallel and self.sp_mesh is not None:
            from ..parallel.sequence_parallel import forward_sp

            return forward_sp(self.dit, x, t, ctx, clip_feature, y, add_condition,
                              mesh=self.sp_mesh)
        return self.dit(x, t, ctx, clip_feature, y, add_condition)

    def enable_vram_management(self, num_persistent_param_in_dit=None):
        """The reference's layer offload is a VRAM workaround; the 14B DiT fits
        the card, so this is a no-op kept for the API (as in the JAX package)."""
        self.vram_budget = num_persistent_param_in_dit

    # -- prompts and video <-> latents --------------------------------------------

    def encode_prompt(self, prompt, positive=True) -> dict:
        return {"context": self.prompter.encode_prompt(prompt, positive=positive)}

    def encode_video(self, input_video, tiled=True, tile_size=(34, 34), tile_stride=(18, 16)):
        """(1, 3, T, H, W) in [-1, 1] -> latents in the pipeline's dtype; tile
        sizes in latent units (x8 pixels)."""
        v = torch.as_tensor(input_video).to(self.device, torch.float32)
        if tiled:
            lat = self.vae.tiled_encode(v, tile_size=(tile_size[0] * 8, tile_size[1] * 8),
                                        tile_stride=(tile_stride[0] * 8, tile_stride[1] * 8))
        else:
            lat = self.vae.encode(v)
        return lat.to(self.dtype)

    def decode_video(self, latents, tiled=True, tile_size=(34, 34), tile_stride=(18, 16)):
        """latents -> (b, 3, T, H, W) f32 video in [-1, 1]; tile sizes in latent
        units."""
        z = torch.as_tensor(latents).to(self.device, torch.float32)
        if tiled:
            return self.vae.tiled_decode(z, tile_size=tile_size, tile_stride=tile_stride)
        return self.vae.decode(z)

    # -- conditioning -----------------------------------------------------------

    def encode_images_adaptive(self, first_frames, random_ref_frame, num_frames, height, width,
                               use_first_aug=False, ref_pad_cfg=False, ref_pad_num=None):
        """`y` = (4-ch temporal mask | VAE latent of [condition frames |
        padding]) and the CLIP features of the first frame, all encoded in f32.
        use_first_aug applies scripts/train_svi.py's first-frame augmentation
        (`base.apply_augmentation`, Pillow; it raises without Pillow) to the
        VAE's condition frames only, never to the CLIP input or the anchor."""
        if not isinstance(first_frames, (list, tuple)):
            first_frames = [first_frames]
        n_cond = len(first_frames)
        remaining = num_frames - n_cond
        dev = self.device

        first = torch.from_numpy(_prep(first_frames[0], height, width)).to(dev)
        clip_context = self.image_encoder.encode_image(first)

        # temporal mask: (4, T_lat, h, w)
        lh, lw = height // 8, width // 8
        msk = np.ones((1, num_frames, lh, lw), np.float32)
        if ref_pad_cfg:
            msk[:, n_cond:] = 0
        else:
            msk[:, 1:] = 0
        msk = np.concatenate([np.repeat(msk[:, 0:1], 4, axis=1), msk[:, 1:]], axis=1)
        msk = msk.reshape(1, msk.shape[1] // 4, 4, lh, lw)
        msk = torch.from_numpy(np.transpose(msk, (0, 2, 1, 3, 4))[0]).to(dev)

        # VAE input: condition frames | padding, built on the device
        cond = np.concatenate([_prep(f, height, width, aug=use_first_aug) for f in first_frames],
                              axis=0)
        cond = torch.from_numpy(np.transpose(cond, (1, 0, 2, 3))).to(dev)  # (3, n, H, W)
        ref_t = torch.from_numpy(_prep(random_ref_frame, height, width)).to(dev).transpose(0, 1)
        zeros = lambda n: torch.zeros((3, n, height, width), dtype=torch.float32, device=dev)  # noqa: E731
        if ref_pad_num == 0:
            pad = zeros(remaining)
        elif ref_pad_num is not None and ref_pad_num > 0:
            pieces = [ref_t.repeat(1, min(ref_pad_num, remaining), 1, 1)]
            if remaining > ref_pad_num:
                pieces.append(zeros(remaining - ref_pad_num))
            pad = torch.cat(pieces, dim=1)
        elif ref_pad_num == -1:
            pad = ref_t.repeat(1, remaining, 1, 1)
        else:
            raise ValueError(f"ref_pad_num must be set (got {ref_pad_num})")
        y_lat = self.vae.encode(torch.cat([cond, pad], dim=1)[None])
        y = torch.cat([msk[None], y_lat.float()], dim=1)
        return {"clip_feature": clip_context.to(self.dtype), "y": y.to(self.dtype)}

    # -- denoising --------------------------------------------------------------

    @staticmethod
    def _cfg_inputs(cfg_scale, ctx_pos, ctx_neg, clip_feature=None, y=None,
                    add_condition=None):
        """The inputs of `_denoise_step`: with cfg_scale != 1 the [cond,
        uncond] batch (ctx = [pos; neg]; clip_feature and y twice; the
        add_condition pair (cond, uncond) stacked, zeros standing in for an
        uncond of None); with cfg_scale == 1 the conditional ones. Returns
        (ctx, clip_feature, y, add_condition)."""
        use_cfg = cfg_scale != 1.0
        nb = 2 if use_cfg else 1

        def batched(t):
            return None if t is None else torch.cat([t] * nb, dim=0)

        ac_cond, ac_uncond = add_condition if add_condition is not None else (None, None)
        ac_in = ac_cond
        if ac_cond is not None and use_cfg:
            ac_in = torch.cat([ac_cond, ac_uncond if ac_uncond is not None
                               else torch.zeros_like(ac_cond)], dim=0)
        ctx = torch.cat([ctx_pos, ctx_neg], dim=0) if use_cfg else ctx_pos
        return ctx, batched(clip_feature), batched(y), ac_in

    @staticmethod
    def _euler(latents, pred, sigma, sigma_next):
        """The flow-match Euler update of latents by the prediction, in f32,
        cast back."""
        return (latents.float() + pred.float() * (sigma_next - sigma)).to(latents.dtype)

    def _denoise_step(self, latents, t, sigma, sigma_next, ctx, clip_feature, y, cfg_scale,
                      add_condition=None, forward=None):
        """One Euler flow-match step on inputs from `_cfg_inputs`. With
        cfg_scale != 1 the [cond, uncond] pair runs as one batch-2 forward;
        pred = uncond + s * (cond - uncond). With cfg_scale == 1, one forward
        and pred = its output. forward(x, t, ctx, clip_feature, y,
        add_condition) is the DiT's (`_dit_forward`) unless `_sample` gives
        its TeaCache forward."""
        forward = forward or self._dit_forward
        b = latents.shape[0]
        if cfg_scale != 1.0:
            out = forward(torch.cat([latents, latents], dim=0), t, ctx, clip_feature, y,
                          add_condition)
            pred = out[b:].float() + cfg_scale * (out[:b] - out[b:]).float()
        else:
            pred = forward(latents, t, ctx, clip_feature, y, add_condition)
        return self._euler(latents, pred, sigma, sigma_next)

    def _sample(self, latents, ctx_pos, ctx_neg, image_emb, cfg_scale, tea_cache=None,
                progress_bar_cmd=None, add_condition=None):
        """Euler flow-match loop of `_denoise_step`s (batched CFG when
        cfg_scale != 1). progress_bar_cmd (e.g. tqdm) wraps the range of
        steps. add_condition: None, or a (cond, uncond) pair of tokens
        (b, S, dim) added to the patch tokens, zeros standing in for an
        uncond of None. With tea_cache the block stack is skipped on the
        steps it picks."""
        dit = self.dit
        sigmas = self.scheduler.sigmas.to(self.device)
        timesteps = self.scheduler.timesteps.to(self.device)
        n = len(timesteps)
        clip_feature = image_emb.get("clip_feature")
        ctx, clip_in, y_in, ac_in = self._cfg_inputs(cfg_scale, ctx_pos, ctx_neg, clip_feature,
                                                     image_emb.get("y"), add_condition)
        n_img = clip_feature.shape[1] if (dit.cfg.has_image_input
                                          and clip_feature is not None) else 257

        def tea_forward(xin, t, ctx, clip_in, y_in, ac_in):
            tokens, ctx_emb, t_emb, t_mod, grid = dit.forward_prelude(
                xin, t, ctx, clip_in, y_in, ac_in)
            if tea_cache.check(tokens, t_mod):
                tokens = tea_cache.update(tokens)
            else:
                tokens = dit.forward_blocks(tokens, ctx_emb, t_mod, grid, num_img_tokens=n_img)
                tea_cache.store(tokens)
            return dit.forward_head(tokens, t_emb, grid)

        forward = None if tea_cache is None else tea_forward
        for i in (progress_bar_cmd or iter)(range(n)):
            sig_next = sigmas[i + 1] if i + 1 < n else torch.zeros((), device=self.device)
            latents = self._denoise_step(latents, timesteps[i:i + 1], sigmas[i], sig_next, ctx,
                                         clip_in, y_in, cfg_scale, ac_in, forward)
        return latents

    # -- main entry ---------------------------------------------------------------

    @torch.inference_mode()
    def __call__(
        self,
        prompt=None,
        negative_prompt="",
        input_image=None,
        input_video=None,
        denoising_strength=1.0,
        seed=None,
        height=480,
        width=832,
        num_frames=81,
        cfg_scale=5.0,
        num_inference_steps=50,
        sigma_shift=5.0,
        tiled=True,
        tile_size=(30, 52),
        tile_stride=(15, 26),
        tea_cache_l1_thresh=None,
        tea_cache_model_id="",
        progress_bar_cmd=None,
        random_ref_frame=None,
        args=None,
        last_latent=None,
        prompt_emb_posi=None,
        prompt_emb_nega=None,
        ref_pad_cfg=None,
        ref_pad_num=None,
        return_latents=False,
        add_condition=None,
        y_extra=None,
    ):
        """Generate one clip. Returns a list of (H, W, 3) uint8 frames; with
        return_latents=True, (frames, final latents); else with
        args.sequential_cfg == 'latent', (frames, the latents' last channel),
        as the JAX pipeline does. Prompts come as text (`prompt`,
        `negative_prompt`: tokenized and encoded by umT5) unless
        `prompt_emb_posi` / `prompt_emb_nega` are given. tile_size /
        tile_stride in latent units, for the encode of `input_video` and the
        decode. add_condition: tokens (1, S, dim) for the cond branch, or a
        (cond, uncond) pair (`_sample`)."""
        height, width = base.check_resize_height_width(height, width)
        if num_frames % 4 != 1:
            num_frames = (num_frames + 2) // 4 * 4 + 1
        if isinstance(cfg_scale, dict):  # the clip-loop driver passes dict(text=...)
            cfg_scale = cfg_scale["text"]
        if ref_pad_cfg is None:
            ref_pad_cfg = getattr(args, "ref_pad_cfg", False) if args is not None else False
        if ref_pad_num is None:
            ref_pad_num = getattr(args, "ref_pad_num", None) if args is not None else None
        tiler = dict(tiled=tiled, tile_size=tile_size, tile_stride=tile_stride)
        dev, dtype = self.device, self.dtype
        if add_condition is not None:
            pair = add_condition if isinstance(add_condition, tuple) else (add_condition, None)
            add_condition = tuple(None if a is None else torch.as_tensor(a).to(dev, dtype)
                                  for a in pair)
        self.scheduler.set_timesteps(num_inference_steps, denoising_strength=denoising_strength,
                                     shift=sigma_shift)

        lt = (num_frames - 1) // 4 + 1
        z_dim = self.vae.cfg.z_dim
        noise = base.generate_noise((1, z_dim, lt, height // 8, width // 8), seed=seed)
        noise = noise.to(dev, dtype)
        if input_video is not None:
            frames_chw = np.concatenate([base.preprocess_image(f) for f in input_video], axis=0)
            vid = torch.from_numpy(np.ascontiguousarray(np.transpose(frames_chw, (1, 0, 2, 3))))
            latents = self.encode_video(vid[None], **tiler)
            latents = self.scheduler.add_noise(latents, noise, self.scheduler.timesteps[0])
        else:
            latents = noise

        if prompt_emb_posi is None:
            prompt_emb_posi = self.encode_prompt(prompt, positive=True)["context"]
        if prompt_emb_nega is None:
            prompt_emb_nega = self.encode_prompt(negative_prompt, positive=False)["context"]
        ctx_pos = torch.as_tensor(prompt_emb_posi).to(dev, dtype)
        ctx_neg = torch.as_tensor(prompt_emb_nega).to(dev, dtype)

        if input_image is not None and self.image_encoder is not None:
            ref_img = random_ref_frame
            if isinstance(ref_img, torch.Tensor):
                ref_img = ref_img.cpu().numpy()
            image_emb = self.encode_images_adaptive(
                input_image, ref_img, num_frames, height, width,
                ref_pad_cfg=ref_pad_cfg, ref_pad_num=ref_pad_num,
            )
            if last_latent is not None:
                image_emb["y"][:, 0] = torch.as_tensor(last_latent).to(dev, dtype)
            if y_extra is not None:  # additive conditioning on the y grid
                image_emb["y"] = image_emb["y"] + torch.as_tensor(y_extra).to(dev, dtype)
        else:
            image_emb = {}

        tea_cache = (TeaCache(num_inference_steps, rel_l1_thresh=tea_cache_l1_thresh,
                              model_id=tea_cache_model_id)
                     if tea_cache_l1_thresh is not None else None)
        self.last_tea_cache = tea_cache
        latents = self._sample(latents, ctx_pos, ctx_neg, image_emb, cfg_scale, tea_cache,
                               progress_bar_cmd, add_condition)

        video = self.decode_video(latents, **tiler)
        frames_u8 = ((video + 1) * 127.5).clamp(0, 255).to(torch.uint8)
        frames = base.frames_from_uint8(frames_u8[0].cpu().numpy())
        if return_latents:
            return frames, latents
        if args is not None and getattr(args, "sequential_cfg", None) == "latent":
            return frames, latents[:, -1, ...]
        return frames
