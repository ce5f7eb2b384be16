"""The plain Wan 2.1 video pipeline family: upstream I2V / T2V and UniAnimate.

Port of svi_tpu/pipelines/wan_video.py:

  * WanVideoPipeline: the pipeline SVI derives from. Upstream I2V is the
    ref_pad_num=0 case of SVI's `encode_images_adaptive` (first frame and
    zero padding, the mask on frame 0 only), with the input image as the
    reference frame unless one is given; T2V passes no input_image.
  * WanUniAnimateVideoPipeline: pose-driven animation. The dwpose_embedding
    stack (models/pose_embedding.py) turns the skeleton video into tokens
    added to the patch tokens of the conditional CFG branch only, and
    randomref_embedding_pose (models/unianimate.py) adds the reference pose
    to the 20-channel `y` grid (`y_extra`).
  * WanUniAnimateLongVideoPipeline: long pose videos denoised in
    overlapping context windows (`context_scheduler`): every step runs one
    batched-CFG `_denoise_step` per window (inputs from `_cfg_inputs`), each
    window carries its first two latent frames across steps, and the
    overlapping predictions are averaged with a counter.
  * WanRepalceAnyoneVideoPipeline (the reference's spelling): masked-region
    replacement: the conditional branch's latents get
    learn_in_embedding(masked video ‖ mask) + inpaint_embedding(VAE(masked
    video)); two batch-1 forwards a step, as the JAX package runs them.

Where the JAX package behaves oddly, this one matches it (ROADMAP's quirk
list): the long pipeline rounds num_frames down to 4k+1 and replace-anyone
rounds it up; a latent frame that no window keeps gets a counter of 0 and
becomes NaN. The side stacks' weights come from the model manager's side
modules (`state_dict_new_module`: dwpose_embedding.*,
randomref_embedding_pose.*, learn_in_embedding.*, inpaint_embedding.*).
Frames come back as (H, W, 3) uint8 arrays, as from the port's base
pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import pose_embedding, unianimate
from . import base
from .svi_video import SVIVideoPipeline


def _from_model_manager(cls, model_manager, torch_dtype=None, device="cuda", use_usp=False,
                        is_test=False, num_train_timesteps=1000):
    """A pipeline of class `cls` on `device` with the manager's models (and
    side modules); use_usp runs the DiT sequence-parallel over every rank
    (`enable_usp`). is_test is kept on the pipeline, as the JAX package
    keeps it."""
    pipe = cls(device=device, torch_dtype=torch_dtype or model_manager.dtype,
               num_train_timesteps=num_train_timesteps)
    pipe.is_test = is_test
    return pipe.fetch_models(model_manager).enable_usp(use_usp)


def _first_image(input_image):
    return input_image[0] if isinstance(input_image, list) else input_image


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.float32)


class WanVideoPipeline(SVIVideoPipeline):
    from_model_manager = classmethod(_from_model_manager)

    def __call__(self, *args, ref_pad_num=None, random_ref_frame=None, input_image=None,
                 **kwargs):
        if input_image is not None and random_ref_frame is None:
            # upstream I2V has no anchor frame; reuse the input image
            random_ref_frame = np.array(_first_image(input_image))
        return super().__call__(*args, input_image=input_image, random_ref_frame=random_ref_frame,
                                ref_pad_num=0 if ref_pad_num is None else ref_pad_num, **kwargs)


# ---------------------------------------------------------------------------
# UniAnimate
# ---------------------------------------------------------------------------


def ordered_halving(val: int) -> float:
    """Bit-reversed fraction in [0, 1): the 64-bit reversal of val over 2^64."""
    return int(f"{val:064b}"[::-1], 2) / (1 << 64)


def context_scheduler(step, num_steps, num_frames, context_size, context_stride=3,
                      context_overlap=4, closed_loop=False):
    """Overlapping context windows over latent frames (lists of frame
    indices, wrapping modulo num_frames)."""
    if num_frames <= context_size:
        yield list(range(num_frames))
        return
    context_stride = min(context_stride, int(np.ceil(np.log2(num_frames / context_size))) + 1)
    for context_step in 1 << np.arange(context_stride):
        pad = int(round(num_frames * ordered_halving(step)))
        for j in range(int(ordered_halving(step) * context_step) + pad,
                       num_frames + pad + (0 if closed_loop else -context_overlap),
                       (context_size * context_step - context_overlap)):
            yield [e % num_frames for e in range(j, j + context_size * context_step, context_step)]


class WanUniAnimateVideoPipeline(SVIVideoPipeline):
    """Pose-driven I2V animation: the pose tokens ride the conditional CFG
    branch only (the uncond branch gets zeros), the reference pose adds to
    `y`."""

    from_model_manager = classmethod(_from_model_manager)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.dwpose_embedding = None  # models.pose_embedding.PoseEmbedding, f32
        self.randomref_embedding_pose = None  # models.unianimate.RandomRefEmbedding, f32

    def fetch_models(self, model_manager):
        super().fetch_models(model_manager)
        side = model_manager.state_dict_new_module
        dw = {k: v for k, v in side.items() if "dwpose_embedding" in k}
        if dw:
            self.dwpose_embedding = pose_embedding.params_from_torch_state_dict(
                dw, device=self.device)
        rr = {k: v for k, v in side.items() if "randomref_embedding_pose" in k}
        if rr:
            self.randomref_embedding_pose = unianimate.params_from_torch_state_dict(
                "randomref", rr, device=self.device)
        return self

    def _pose_tokens(self, pose_video: np.ndarray) -> torch.Tensor:
        """(3, F, H, W) in [0, 255] -> add_condition tokens (1, S, dim)."""
        pose = torch.from_numpy(np.ascontiguousarray(pose_video))[None].to(self.device)
        return self.dwpose_embedding(pose).to(self.dtype)

    def _ref_pose_term(self, random_ref_dwpose) -> torch.Tensor:
        """Reference pose (H, W, 3) in [0, 255] -> the additive y term."""
        ref = torch.from_numpy(_host_f32(random_ref_dwpose))[None].to(self.device)
        return self.randomref_embedding_pose(ref).to(self.dtype)

    def _pose_inputs(self, dwpose_data, random_ref_dwpose):
        return self._pose_tokens(_host_f32(dwpose_data)), self._ref_pose_term(random_ref_dwpose)

    @torch.inference_mode()
    def __call__(self, *args, dwpose_data=None, random_ref_dwpose=None, input_image=None,
                 random_ref_frame=None, ref_pad_num=None, **kwargs):
        add_condition = None
        y_extra = None
        if dwpose_data is not None:
            cond, y_extra = self._pose_inputs(dwpose_data, random_ref_dwpose)
            add_condition = (cond, None)  # the conditional branch only
        if input_image is not None and random_ref_frame is None:
            random_ref_frame = np.array(_first_image(input_image))
        return super().__call__(*args, input_image=input_image, random_ref_frame=random_ref_frame,
                                ref_pad_num=0 if ref_pad_num is None else ref_pad_num,
                                add_condition=add_condition, y_extra=y_extra, **kwargs)

    def _start(self, height, width, num_frames, num_inference_steps, sigma_shift, seed, prompt,
               negative_prompt, prompt_emb_posi, prompt_emb_nega):
        """The set-up both long and replace-anyone share: timesteps, the
        seeded noise latents and the prompt states."""
        self.scheduler.set_timesteps(num_inference_steps, shift=sigma_shift)
        lt = (num_frames - 1) // 4 + 1
        z_dim = self.vae.cfg.z_dim if self.vae is not None else 16
        latents = base.generate_noise((1, z_dim, lt, height // 8, width // 8), seed=seed)
        latents = latents.to(self.device, self.dtype)
        if prompt_emb_posi is None:
            prompt_emb_posi = self.encode_prompt(prompt, positive=True)["context"]
        if prompt_emb_nega is None:
            prompt_emb_nega = self.encode_prompt(negative_prompt, positive=False)["context"]
        ctx_pos = torch.as_tensor(prompt_emb_posi).to(self.device, self.dtype)
        ctx_neg = torch.as_tensor(prompt_emb_nega).to(self.device, self.dtype)
        return latents, ctx_pos, ctx_neg

    def _steps(self):
        """(timestep (1,), sigma, next sigma) per step, on the device."""
        sigmas = self.scheduler.sigmas.to(self.device)
        timesteps = self.scheduler.timesteps.to(self.device)
        n = len(timesteps)
        zero = torch.zeros((), device=self.device)
        return [(timesteps[i:i + 1], sigmas[i], sigmas[i + 1] if i + 1 < n else zero)
                for i in range(n)]

    def _frames(self, latents, tiler: dict) -> list:
        video = self.decode_video(latents, **tiler)
        frames_u8 = ((video + 1) * 127.5).clamp(0, 255).to(torch.uint8)
        return base.frames_from_uint8(frames_u8[0].cpu().numpy())


class WanUniAnimateLongVideoPipeline(WanUniAnimateVideoPipeline):
    """Long pose-driven videos in overlapping context windows: each step runs
    the DiT once per window (batched CFG), carries the first two latent
    frames of each window across steps and averages the overlapping
    predictions with a counter."""

    @torch.inference_mode()
    def __call__(self, prompt=None, negative_prompt="", input_image=None, seed=None, height=480,
                 width=832, num_frames=81, cfg_scale=5.0, num_inference_steps=50,
                 sigma_shift=5.0, tiled=True, tile_size=(30, 52), tile_stride=(15, 26),
                 dwpose_data=None, random_ref_dwpose=None, context_size=21, context_overlap=4,
                 prompt_emb_posi=None, prompt_emb_nega=None, **kwargs):
        height, width = base.check_resize_height_width(height, width)
        if num_frames % 4 != 1:  # rounded down here (replace-anyone rounds up)
            num_frames = (num_frames - 1) // 4 * 4 + 1
        if isinstance(cfg_scale, dict):
            cfg_scale = cfg_scale["text"]
        tiler = dict(tiled=tiled, tile_size=tile_size, tile_stride=tile_stride)
        latents, ctx_pos, ctx_neg = self._start(height, width, num_frames, num_inference_steps,
                                                sigma_shift, seed, prompt, negative_prompt,
                                                prompt_emb_posi, prompt_emb_nega)
        lt = latents.shape[2]
        z_dim = latents.shape[1]

        # the step-0 window schedule, the tail window pinned to the end
        context_queue = list(context_scheduler(0, 31, lt, context_size=context_size,
                                               context_stride=1, context_overlap=context_overlap))
        context_step = min(1, int(np.ceil(np.log2(lt / context_size))) + 1)
        context_queue[-1] = [e % lt for e in range(lt - context_size * context_step, lt,
                                                   context_step)]

        # image conditioning at the window's length
        img = _first_image(input_image)
        image_emb = self.encode_images_adaptive([img], np.array(img), context_size * 4 - 3,
                                                height, width, ref_pad_num=0)

        # per-window pose tokens and carried frames, drawn in the JAX order
        dwpose_data = _host_f32(dwpose_data)
        conds, first_feature = [], []
        rng = np.random.default_rng(seed)
        for win in context_queue:
            conds.append(self._pose_tokens(dwpose_data[:, win[0] * 4:win[-1] * 4 + 1]))
            first_feature.append(torch.from_numpy(
                rng.standard_normal((1, z_dim, 2, height // 8, width // 8))).to(self.device,
                                                                                  self.dtype))
        if random_ref_dwpose is not None:
            image_emb["y"] = image_emb["y"] + self._ref_pose_term(random_ref_dwpose)

        ctx, clip_in, y_in, _ = self._cfg_inputs(cfg_scale, ctx_pos, ctx_neg,
                                                 image_emb["clip_feature"], image_emb["y"])
        acs = [self._cfg_inputs(cfg_scale, ctx_pos, ctx_neg, add_condition=(c, None))[3]
               for c in conds]
        windows = [torch.tensor(win, device=self.device) for win in context_queue]
        for t, sigma, sigma_next in self._steps():
            counter = np.zeros((lt,), np.float32)
            out_acc = torch.zeros_like(latents)
            for w_idx, win in enumerate(context_queue):
                lat_in = latents.index_select(2, windows[w_idx])
                lat_in[:, :, :2] = first_feature[w_idx]
                stepped = self._denoise_step(lat_in, t, sigma, sigma_next, ctx, clip_in, y_in,
                                             cfg_scale, acs[w_idx])
                first_feature[w_idx] = stepped[:, :, :2]
                # aggregate, skipping each later window's carried 2 frames
                keep = windows[w_idx] if w_idx == 0 else windows[w_idx][2:]
                out_acc.index_add_(2, keep, stepped if w_idx == 0 else stepped[:, :, 2:])
                for c in (win if w_idx == 0 else win[2:]):
                    counter[c] += 1
            # a frame no window keeps has counter 0: 0 / 0, as in the JAX package
            latents = out_acc / torch.from_numpy(counter).to(self.device, out_acc.dtype)[
                None, None, :, None, None]
        return self._frames(latents, tiler)


class WanRepalceAnyoneVideoPipeline(WanUniAnimateVideoPipeline):
    """Masked-region replacement: the conditional branch's latents are
    augmented with learn_in_embedding(masked video ‖ mask) +
    inpaint_embedding(VAE(masked video)); the class name keeps the
    reference's spelling."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.learn_in_embedding = None  # models.unianimate.LearnInEmbedding, f32
        self.inpaint_embedding = None  # models.unianimate.InpaintEmbedding, f32

    def fetch_models(self, model_manager):
        super().fetch_models(model_manager)
        side = model_manager.state_dict_new_module
        for kind, attr in (("learn_in", "learn_in_embedding"), ("inpaint", "inpaint_embedding")):
            sd = {k: v for k, v in side.items() if attr in k}
            if sd:
                setattr(self, attr, unianimate.params_from_torch_state_dict(
                    kind, sd, device=self.device))
        return self

    @torch.inference_mode()
    def __call__(self, prompt=None, negative_prompt="", input_image=None, seed=None, height=480,
                 width=832, num_frames=81, cfg_scale=5.0, num_inference_steps=50,
                 sigma_shift=5.0, tiled=True, tile_size=(30, 52), tile_stride=(15, 26),
                 dwpose_data=None, random_ref_dwpose=None, batch=None, prompt_emb_posi=None,
                 prompt_emb_nega=None, **kwargs):
        height, width = base.check_resize_height_width(height, width)
        if num_frames % 4 != 1:  # rounded up here (the long pipeline rounds down)
            num_frames = (num_frames + 2) // 4 * 4 + 1
        if isinstance(cfg_scale, dict):
            cfg_scale = cfg_scale["text"]
        tiler = dict(tiled=tiled, tile_size=tile_size, tile_stride=tile_stride)
        latents, ctx_pos, ctx_neg = self._start(height, width, num_frames, num_inference_steps,
                                                sigma_shift, seed, prompt, negative_prompt,
                                                prompt_emb_posi, prompt_emb_nega)
        img = _first_image(input_image)
        image_emb = self.encode_images_adaptive([img], np.array(img), num_frames, height, width,
                                                ref_pad_num=0)
        cond, y_extra = self._pose_inputs(dwpose_data, random_ref_dwpose)
        image_emb["y"] = image_emb["y"] + y_extra

        # the masked-video features
        video = _host_f32(batch["video"])[None]  # (1, 3, F, H, W) in [-1, 1]
        seg = _host_f32(batch["segmentation_data"]) / 255.0 > 0  # (F, H, W)
        keep = (~seg).astype(np.float32)[None, None]
        masked = video * keep
        masked_4ch = torch.from_numpy(np.concatenate([masked, keep], axis=1)).to(self.device,
                                                                                   self.dtype)
        lat_masked = self.encode_video(torch.from_numpy(masked), **tiler)
        masked_feat = self.learn_in_embedding(masked_4ch).to(self.dtype)
        inpaint_feat = self.inpaint_embedding(lat_masked.to(self.dtype)).to(self.dtype)

        clip_feature, y = image_emb["clip_feature"], image_emb["y"]
        for t, sigma, sigma_next in self._steps():
            # two batch-1 forwards and their CFG mix: the conditional one
            # with the features and the pose, the unconditional one with
            # neither
            pos = self._dit_forward(latents + masked_feat + inpaint_feat, t, ctx_pos,
                                    clip_feature, y, cond)
            neg = self._dit_forward(latents, t, ctx_neg, clip_feature, y, None)
            pred = neg.float() + cfg_scale * (pos.float() - neg.float())
            latents = self._euler(latents, pred, sigma, sigma_next)
        return self._frames(latents, tiler)
