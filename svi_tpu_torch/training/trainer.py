"""Error-Recycling LoRA trainer (port of svi_tpu/training/trainer.py;
behavioral ref: train_svi.py:627-1304).

  * `ErrorRecyclingTrainer.train_step`: forward of the frozen bf16 DiT with
    f32 LoRA adapters (rematerialised per block), weighted flow-match MSE,
    backward through the hand-written attention backward kernels, global-norm
    clip + AdamW, and the one-step bidirectional error extraction, all on
    the device;
  * `training_step`: the host side, copied from the JAX package so that the
    same seed draws the same timesteps, noise, injections and buffer updates
    (error_recycling.ErrorBuffers, `random.Random`, numpy noise).

Not ported yet (ROADMAP): customtalk and pose training, audio conditioning,
a mesh with sharded optimizer state, the save-attention and host-offload
remat variants, and the orbax / safetensors checkpoints.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

import numpy as np
import torch

from ..models import wan_dit
from ..schedulers import flow_match as fm
from . import lora as lora_mod
from .error_recycling import ErrorBuffers


@dataclasses.dataclass
class TrainerConfig:
    """The JAX package's TrainerConfig: the same fields and defaults."""

    # optimization (train_svi.py defaults / scripts/train/svi_shot.sh)
    learning_rate: float = 1e-4
    weight_decay: float = 1e-2
    gradient_clip_val: float = 1.0
    lora_rank: int = 128
    lora_alpha: float = 128.0
    lora_targets: tuple = lora_mod.DEFAULT_TARGETS
    use_gradient_checkpointing: bool = True
    # blocks per outer checkpoint group (sqrt-remat): 1 = per-block remat,
    # 0 = auto (divisor of num_layers nearest sqrt(L)), n > 1 = explicit
    remat_granularity: int = 1
    save_attention_activations: bool = False  # not ported: raises
    use_gradient_checkpointing_offload: bool = False  # not ported: raises
    shard_optimizer_state: bool = False  # not ported (needs a mesh): raises
    # error recycling (ref :684-712)
    use_error_recycling: bool = True
    error_buffer_k: int = 500
    buffer_replacement_strategy: str = "random"
    buffer_warmup_iter: int = 50
    num_grids: int = 40
    error_modulate_factor: float = 0.2
    noise_prob: float = 0.99
    y_prob: float = 0.99
    latent_prob: float = 0.99
    clean_prob: float = 0.1
    clean_buffer_update_prob: float = 0.5
    y_error_num: int = 1
    use_last_y_error: bool = False
    y_error_sample_from_all_grids: bool = False
    y_error_sample_range: Optional[tuple[int, int]] = None
    num_train_timesteps: int = 1000
    sigma_shift: float = 5.0
    seed: int = 0
    # variants (only "lora" without pose is ported)
    train_architecture: str = "lora"
    train_pose: bool = False
    pose_drop_prob1: float = 0.05
    pose_drop_prob2: float = 0.1
    cond_drop_prob: float = 0.1
    audio_drop_prob: float = 0.1


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), f32."""
    return torch.sqrt(torch.stack([(t.float() ** 2).sum() for t in tensors]).sum())


class ClippedAdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(lr, weight_decay=wd)).

    The clip follows optax's rule: gradients become g / |g| * max_norm only
    when |g| >= max_norm (torch's clip_grad_norm_ divides by |g| + 1e-6 and
    would differ). AdamW is torch's, with optax's defaults (betas 0.9, 0.999,
    eps 1e-8) and the same decoupled weight decay."""

    def __init__(self, params, cfg: TrainerConfig):
        self.params = [p for p in params if p.requires_grad]
        self.max_norm = float(cfg.gradient_clip_val)
        self.opt = torch.optim.AdamW(self.params, lr=cfg.learning_rate, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=cfg.weight_decay)

    def step(self) -> torch.Tensor:
        """Clip and apply the gradients in `.grad`; returns the unclipped norm."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if not bool(norm < self.max_norm):
            for g in grads:
                g.div_(norm).mul_(self.max_norm)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        return norm


def make_optimizer(params, cfg: TrainerConfig) -> ClippedAdamW:
    return ClippedAdamW(params, cfg)


class ErrorRecyclingTrainer:
    """Host-side orchestration of one training run (ref training_step
    :989-1199). `dit` is a `WanDiT` on `device` (its weights stay frozen);
    the adapters are made on `device` from a generator seeded with
    `config.seed` (assign `trainer.lora` to start from others)."""

    def __init__(self, dit: wan_dit.WanDiT, config: TrainerConfig | None = None, mesh=None,
                 device="cuda"):
        self.cfg = c = config or TrainerConfig()
        if c.train_architecture != "lora" or c.train_pose:
            raise NotImplementedError(
                "customtalk and pose training are not ported yet (ROADMAP Slice D)")
        if mesh is not None or c.shard_optimizer_state:
            raise NotImplementedError("training on a mesh is not ported yet (ROADMAP Slice E)")
        if c.save_attention_activations or c.use_gradient_checkpointing_offload:
            raise NotImplementedError(
                "save_attention and offloaded carries are not ported yet (ROADMAP)")
        self.dit = dit
        self.dit_cfg = dit.cfg
        self.device = torch.device(device)
        self.rng = random.Random(c.seed)
        self.schedule = fm.make_schedule(c.num_train_timesteps, shift=c.sigma_shift,
                                         sigma_min=0.0, extra_one_step=True, training=True)
        self.sigmas = self.schedule.sigmas.to(self.device)
        self.weights = self.schedule.training_weights.to(self.device)
        self.lora_scale = lora_mod.lora_scale(c.lora_rank, c.lora_alpha)
        self.remat_group = (wan_dit.pick_remat_group(dit.cfg.num_layers)
                            if c.remat_granularity == 0 else c.remat_granularity)
        gen = torch.Generator(device=self.device).manual_seed(c.seed)
        self.lora = lora_mod.init_lora_params(dit.cfg, rank=c.lora_rank, targets=c.lora_targets,
                                              generator=gen, device=self.device)
        self.buffers = ErrorBuffers(
            num_grids=c.num_grids,
            buffer_size=c.error_buffer_k,
            replacement_strategy=c.buffer_replacement_strategy,
            error_modulate_factor=c.error_modulate_factor,
            shift=c.sigma_shift,
            y_error_sample_from_all_grids=c.y_error_sample_from_all_grids,
            y_error_sample_range=c.y_error_sample_range,
            rng=self.rng,
        )
        self.iteration_count = 0

    @property
    def lora(self):
        return self._lora

    @lora.setter
    def lora(self, value):
        """New adapters start with fresh optimizer state (as loading a LoRA does)."""
        self._lora = value
        self.optimizer = make_optimizer(value.parameters(), self.cfg)

    # -- the device step --------------------------------------------------------

    def train_step(self, batch: dict) -> dict:
        """`loss_fn` + `train_step` of the JAX package on device tensors:
        latents, noise_w_error, latents_w_error (b, 16, f, h, w) f32, timestep
        (b,) f32, timestep_id (b,) int, context, clip_feature, y in the DiT's
        dtype. Returns loss, the unclipped grad_norm, and the f32 one-step
        errors noise_error = (pred - target)(1 - sigma), y_error =
        (pred - target)(-sigma)."""
        tid = batch["timestep_id"]
        sigma = self.sigmas[tid][:, None, None, None, None]
        noisy = (1 - sigma) * batch["latents_w_error"].float() \
            + sigma * batch["noise_w_error"].float()
        # self-corrected velocity target: noise_w_error - CLEAN latents (ref :1139)
        target = batch["noise_w_error"].float() - batch["latents"].float()
        pred = self.dit(noisy.to(self.dit_cfg.dtype), batch["timestep"], batch["context"],
                        batch.get("clip_feature"), batch.get("y"), lora=self.lora,
                        lora_scale=self.lora_scale,
                        use_remat=self.cfg.use_gradient_checkpointing,
                        remat_granularity=self.remat_group).float()
        loss = (((pred - target) ** 2).mean(dim=(1, 2, 3, 4)) * self.weights[tid]).mean()
        loss.backward()
        grad_norm = self.optimizer.step()
        with torch.no_grad():
            diff = pred.detach() - target
            return {"loss": loss.detach(), "grad_norm": grad_norm,
                    "noise_error": diff * (1.0 - sigma), "y_error": diff * (0.0 - sigma)}

    # -- input corruption (host side, ref :1052-1135) ------------------------

    def sample_timestep(self):
        tid = self.rng.randint(0, self.cfg.num_train_timesteps - 1)
        return tid, float(self.schedule.timesteps[tid])

    def corrupt_inputs(self, latents: np.ndarray, y: Optional[np.ndarray], timestep: float):
        """Apply error injection with the reference's probability structure.
        Returns (noise_w_error, latents_w_error, y, used_clean_input)."""
        c = self.cfg
        noise = np.random.default_rng(self.rng.randint(0, 2**31 - 1)).standard_normal(
            latents.shape
        ).astype(np.float32)

        add_noise_err = self.rng.random() < c.noise_prob
        add_y_err = self.rng.random() < c.y_prob
        add_latent_err = self.rng.random() < c.latent_prob
        use_clean = self.rng.random() < c.clean_prob
        if use_clean:
            add_noise_err = add_y_err = add_latent_err = False

        noise_w_error = noise
        latents_w_error = latents
        if add_noise_err and self.buffers.has_latent_data(timestep):
            noise_w_error = noise + self.buffers.sample_noise_error(latents.shape, timestep)
        if add_y_err and y is not None and self.buffers.has_y_data(timestep):
            err = self.buffers.sample_y_error(latents.shape, timestep)
            max_start = max(0, err.shape[2] - c.y_error_num)
            start = max_start if c.use_last_y_error else self.rng.randint(0, max_start)
            piece = err[:, :, start : start + c.y_error_num]
            y = y.copy()
            y[:, 4:, : c.y_error_num] = y[:, 4:, : c.y_error_num] + piece
        if add_latent_err and self.buffers.has_latent_data(timestep):
            latents_w_error = latents + self.buffers.sample_latent_error(latents.shape, timestep)
        return noise_w_error.astype(np.float32), latents_w_error, y, use_clean

    # -- one full step --------------------------------------------------------

    def training_step(self, latents, context, y=None, clip_feature=None, pose=None,
                      audio_tuple=None):
        """latents (b,16,f,h,w); context (b,L,4096); y (b,20,f,h,w) or None;
        clip_feature (b,257,1280) or None, as host arrays. Returns the metrics
        dict of the JAX package."""
        if pose is not None or audio_tuple is not None:
            raise NotImplementedError(
                "pose and audio conditioning are not ported yet (ROADMAP Slice D)")
        c = self.cfg
        latents = np.asarray(latents, np.float32)
        y_np = None if y is None else np.asarray(y, np.float32)
        clip_np = None if clip_feature is None else np.asarray(clip_feature, np.float32)
        self.iteration_count += 1

        tid, timestep = self.sample_timestep()
        noise_w_error, latents_w_error, y_np, use_clean = self.corrupt_inputs(
            latents, y_np, timestep
        )

        dev, dtype = self.device, self.dit_cfg.dtype
        b = latents.shape[0]

        def host(a, to=torch.float32):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, to)

        batch = {
            "latents": host(latents),
            "noise_w_error": host(noise_w_error),
            "latents_w_error": host(latents_w_error),
            "timestep": torch.full((b,), timestep, dtype=torch.float32, device=dev),
            "timestep_id": torch.full((b,), tid, dtype=torch.long, device=dev),
            "context": torch.as_tensor(np.asarray(context, np.float32)).to(dev, dtype),
            "clip_feature": None if clip_np is None else host(clip_np, dtype),
            "y": None if y_np is None else host(y_np, dtype),
        }
        metrics = self.train_step(batch)

        if c.use_error_recycling:
            # warmup phase banks every batch entry; afterwards too (in one
            # process the full batch is the gather)
            update = True
            if use_clean:
                update = self.rng.random() < c.clean_buffer_update_prob
            if update:
                noise_err = metrics["noise_error"].cpu().numpy()
                y_err = metrics["y_error"].cpu().numpy()
                for i in range(noise_err.shape[0]):
                    self.buffers.add_latent_error(noise_err[i : i + 1], timestep)
                    self.buffers.add_y_error(y_err[i : i + 1], timestep)

        out = {
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "timestep": timestep,
            "grid": self.buffers.grid_index(timestep),
            "used_clean_input": use_clean,
            "warmup": self.iteration_count <= c.buffer_warmup_iter,
        }
        out.update({f"buffer_{k}": v for k, v in self.buffers.stats().items()
                    if not isinstance(v, dict)})
        return out
