"""Error-Recycling LoRA trainer (port of svi_tpu/training/trainer.py;
behavioral ref: train_svi.py:627-1304, train_svi_dance.py, train_svi_talk.py).

  * `ErrorRecyclingTrainer.train_step`: forward of the frozen DiT (bf16, or
    a quantized base through the straight-through backward) with the
    trainables (f32 LoRA adapters, or the customtalk FFNs; with train_pose
    also a PoseEmbedding), rematerialised per block or in groups (optionally
    keeping the self-attention's out / lse, or with the carries in host
    memory), weighted flow-match MSE, backward through the hand-written
    attention backward kernels, one global-norm clip + AdamW over every
    trainable together, and the one-step bidirectional error extraction,
    all on the device;
  * `training_step`: the host side, copied from the JAX package so that the
    same seed draws the same timesteps, noise, injections, pose / condition
    / audio dropouts and buffer updates (error_recycling.ErrorBuffers,
    `random.Random`, numpy noise);
  * the files a run leaves: the LoRA export in peft naming (with the
    customtalk FFNs and the pose convs in the reference's naming), and a
    resumable checkpoint (`torch.save` of the trainables and the optimizer
    state in place of orbax, plus the JAX package's host pickle);
  * with a mesh (parallel.mesh, 'data' x 'sp'): every rank runs the host
    side on the whole global batch (the same seed draws the same numbers,
    so the buffers stay equal on every rank, banked in the JAX host
    readback's order), the forward goes through
    parallel.sequence_parallel.forward_sp (each 'data' rank's rows, each
    'sp' rank's tokens; every rank gets the global prediction, so the loss
    is the JAX package's mean over the global batch), and the ranks' partial
    parameter gradients are summed over the mesh before the clip. With
    shard_optimizer_state (ZeRO-1) each 'data' rank keeps the AdamW moments
    of its share of the trainables, steps those, and sends them to the other
    'data' ranks. Only global rank 0 writes files.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import random
from typing import Optional

import numpy as np
import torch

from ..models import pose_embedding, wan_dit
from ..parallel import collectives
from ..parallel.mesh import is_main_rank
from ..parallel.sequence_parallel import forward_sp
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
    # keep each block's self-attention (out, lse) from the forward, so the
    # backward's recompute skips K1 (+S x dim of activations a block)
    save_attention_activations: bool = False
    # the checkpoints' block carries in pinned host memory (save_on_cpu)
    use_gradient_checkpointing_offload: bool = False
    # ZeRO-1 (the reference's deepspeed_stage_2, train_svi.py:156-161): the
    # AdamW moments sharded over the mesh's 'data' axis; nothing without a mesh
    shard_optimizer_state: bool = False
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
    # variants
    train_architecture: str = "lora"  # lora | customtalk (ref train_svi.py:659-676)
    train_pose: bool = False  # SVI-Dance: a trainable pose embedding
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
    eps 1e-8) and the same decoupled weight decay.

    With a mesh the ranks' gradients are summed over every rank of it first
    (each rank's are its share of the global loss's); the clip then runs on
    the whole gradient on every rank. With cfg.shard_optimizer_state
    (ZeRO-1) each parameter has one owner among the 'data' ranks (the
    largest first, each to the least loaded rank): only the owner keeps its
    moments and steps it, then each rank sends what it owns to the others of
    its 'data' line. `state_dict` is the single-device one either way."""

    def __init__(self, params, cfg: TrainerConfig, mesh=None):
        self.params = [p for p in params if p.requires_grad]
        self.max_norm = float(cfg.gradient_clip_val)
        self.mesh = mesh
        self.owner = None
        mine = self.params
        if mesh is not None and cfg.shard_optimizer_state:
            data = mesh["data"]
            self.owner = _partition([p.numel() for p in self.params], data.size)
            mine = [p for p, o in zip(self.params, self.owner) if o == data.index]
        self.opt = torch.optim.AdamW(mine, lr=cfg.learning_rate, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=cfg.weight_decay)

    def step(self) -> torch.Tensor:
        """Clip and apply the gradients in `.grad`; returns the unclipped norm."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.mesh is not None:
            flat = torch.cat([g.reshape(-1).float() for g in grads])
            collectives.all_reduce_(flat, self.mesh.world)
            _unflatten_into(flat, grads)
        norm = global_norm(grads)
        if not bool(norm < self.max_norm):
            for g in grads:
                g.div_(norm).mul_(self.max_norm)
        self.opt.step()
        if self.owner is not None:
            data = self.mesh["data"]
            with torch.no_grad():
                for o in range(data.size):
                    owned = [p for p, w in zip(self.params, self.owner) if w == o]
                    flat = torch.cat([p.reshape(-1).float() for p in owned])
                    _unflatten_into(collectives.broadcast_(flat, o, data), owned)
        for p in self.params:
            p.grad = None
        return norm

    def state_dict(self) -> dict:
        """torch AdamW's state dict over every parameter (under ZeRO-1 the
        owners' moments gathered: every 'data' rank must call it)."""
        if self.owner is None:
            return self.opt.state_dict()
        local = self.opt.state_dict()
        local["state"] = {j: {k: v.cpu() for k, v in st.items()}
                          for j, st in local["state"].items()}
        every = collectives.all_gather_object(local, self.mesh["data"])
        state, seen = {}, [0] * len(every)
        for i, o in enumerate(self.owner):
            if seen[o] in every[o]["state"]:
                state[i] = every[o]["state"][seen[o]]
            seen[o] += 1
        group = dict(every[0]["param_groups"][0], params=list(range(len(self.params))))
        return {"state": state, "param_groups": [group]}

    def load_state_dict(self, state: dict) -> None:
        if self.owner is not None:
            mine = [i for i, o in enumerate(self.owner) if o == self.mesh["data"].index]
            state = {"state": {j: state["state"][i] for j, i in enumerate(mine)
                               if i in state["state"]},
                     "param_groups": [dict(state["param_groups"][0],
                                           params=list(range(len(mine))))]}
        self.opt.load_state_dict(state)


def _partition(sizes: list[int], n: int) -> list[int]:
    """Owner of each item: the largest first, each to the least loaded of n."""
    owner, load = [0] * len(sizes), [0] * n
    for i in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
        owner[i] = min(range(n), key=load.__getitem__)
        load[owner[i]] += sizes[i]
    return owner


def _unflatten_into(flat: torch.Tensor, tensors) -> None:
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))


def make_optimizer(params, cfg: TrainerConfig, mesh=None) -> ClippedAdamW:
    return ClippedAdamW(params, cfg, mesh)


CUSTOMTALK_FFNS = ("customtalk_context_pre_ffns", "customtalk_audio_pre_ffns")


def customtalk_params(dit: wan_dit.WanDiT) -> dict[str, torch.Tensor]:
    """The customtalk FFNs of every block (`split_customtalk_params`: the
    leaves whose names hold 'customtalk', ref train_svi.py:670-676) by their
    names in the DiT, made trainable in place; the rest of the DiT stays
    frozen."""
    out = {}
    for i, blk in enumerate(dit["blocks"]):
        for name in CUSTOMTALK_FFNS:
            for idx in ("0", "2"):
                leaf = blk[name][idx]
                if "w" not in leaf:
                    raise ValueError(f"{name}.{idx} is quantized: customtalk training needs its "
                                     "FFNs in a float dtype")
                for key in ("w", "b"):
                    out[f"blocks.{i}.{name}.{idx}.{key}"] = leaf[key].requires_grad_(True)
    return out


class ErrorRecyclingTrainer:
    """Host-side orchestration of one training run (ref training_step
    :989-1199). `dit` is a `WanDiT` on `device`: its weights stay frozen,
    except the customtalk FFNs when config.train_architecture is
    "customtalk". The LoRA adapters are made on `device` from a generator
    seeded with `config.seed`, the pose embedding (train_pose) from
    `config.seed + 1`; assign `trainer.lora` / `trainer.pose_params` to start
    from others (the optimizer then starts afresh, as loading a LoRA does).
    `mesh`: a parallel.mesh.Mesh ('data', 'sp') that every rank passes, or
    None (one device; config.shard_optimizer_state then changes nothing, as
    in the JAX package)."""

    def __init__(self, dit: wan_dit.WanDiT, config: TrainerConfig | None = None, mesh=None,
                 device="cuda"):
        self.cfg = c = config or TrainerConfig()
        self.mesh = mesh
        if c.train_architecture not in ("lora", "customtalk"):
            raise ValueError(f"train_architecture={c.train_architecture!r}: expected 'lora' or "
                             "'customtalk'")
        if dit.cfg.attention_quant != "none":
            # the int8 attention forward's lse is that of the centred logits,
            # so a flash backward through it would give wrong gradients
            raise ValueError("attention_quant is inference-only: train with "
                             "attention_quant='none'")
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
        self.trainable: dict = {}
        if c.train_architecture == "customtalk":
            if not dit.cfg.enable_customtalk:
                raise ValueError("customtalk training needs a customtalk DiT")
            self.trainable["customtalk"] = customtalk_params(dit)
        else:
            gen = torch.Generator(device=self.device).manual_seed(c.seed)
            self.trainable["lora"] = lora_mod.init_lora_params(
                dit.cfg, rank=c.lora_rank, targets=c.lora_targets, generator=gen,
                device=self.device)
        if c.train_pose:
            self.trainable["pose"] = pose_embedding.init_params(
                dit.cfg.dim, seed=c.seed + 1, device=self.device).requires_grad_(True)
        self.reset_optimizer()
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

    def named_trainables(self) -> dict[str, torch.Tensor]:
        """Every trainable tensor under a stable name: the optimizer's
        parameters, in its order, and the checkpoint's keys."""
        out = {}
        for kind, tree in self.trainable.items():
            named = tree.items() if kind == "customtalk" else tree.named_parameters()
            out.update({f"{kind}.{name}": p for name, p in named})
        return out

    def reset_optimizer(self) -> None:
        """A fresh optimizer over every trainable together (one clip, one
        AdamW, as the JAX package's single `trainable` tree)."""
        self.optimizer = make_optimizer(self.named_trainables().values(), self.cfg, self.mesh)

    @property
    def lora(self):
        return self.trainable.get("lora")

    @lora.setter
    def lora(self, value):
        """New adapters start with fresh optimizer state (as loading a LoRA does)."""
        self.trainable["lora"] = value
        self.reset_optimizer()

    @property
    def pose_params(self):
        return self.trainable.get("pose")

    @pose_params.setter
    def pose_params(self, value):
        self.trainable["pose"] = value.requires_grad_(True)
        self.reset_optimizer()

    # -- the device step --------------------------------------------------------

    def train_step(self, batch: dict) -> dict:
        """`loss_fn` + `train_step` of the JAX package on device tensors (the
        global batch on every rank of a mesh): latents, noise_w_error,
        latents_w_error (b, 16, f, h, w) f32, timestep (b,) f32, timestep_id (b,) int, context, clip_feature, y in the DiT's
        dtype; with train_pose, pose (b, 3, F, H, W) f32 in [0, 255] (or None)
        and pose_keep (b, 1, 1), which zeroes the embedded condition; for an
        audio DiT, audio_first and audio_vf in the DiT's dtype. Returns loss,
        the unclipped grad_norm, and the f32 one-step errors noise_error =
        (pred - target)(1 - sigma), y_error = (pred - target)(-sigma)."""
        c, dtype = self.cfg, self.dit_cfg.dtype
        tid = batch["timestep_id"]
        sigma = self.sigmas[tid][:, None, None, None, None]
        noisy = (1 - sigma) * batch["latents_w_error"].float() \
            + sigma * batch["noise_w_error"].float()
        # self-corrected velocity target: noise_w_error - CLEAN latents (ref :1139)
        target = batch["noise_w_error"].float() - batch["latents"].float()
        add_condition = None
        if c.train_pose and batch.get("pose") is not None:
            # the trainable embedding; pose_keep gates the embedded condition,
            # not the raw pose (train_svi_dance.py:1045-1048)
            cond = self.pose_params(batch["pose"])
            add_condition = cond.to(dtype) * batch["pose_keep"].to(dtype)
        audio = None
        if batch.get("audio_first") is not None:
            audio = (batch["audio_first"], batch["audio_vf"])
        forward = self.dit
        if self.mesh is not None:
            forward = functools.partial(forward_sp, self.dit, mesh=self.mesh)
        pred = forward(noisy.to(dtype), batch["timestep"], batch["context"],
                       batch.get("clip_feature"), batch.get("y"), add_condition=add_condition,
                       lora=self.lora, lora_scale=self.lora_scale,
                       use_remat=c.use_gradient_checkpointing,
                       remat_granularity=self.remat_group,
                       save_attention=c.save_attention_activations,
                       offload_carries=c.use_gradient_checkpointing_offload,
                       audio_embed_tuple=audio).float()
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
        clip_feature (b,257,1280) or None; pose (b,3,F,H,W) raw [0, 255]
        (dance); audio_tuple ((b,1,5,12,768), (b,n_t-1,8,12,768)) (talk), as
        host arrays. Returns the metrics dict of the JAX package."""
        c = self.cfg
        latents = np.asarray(latents, np.float32)
        y_np = None if y is None else np.asarray(y, np.float32)
        clip_np = None if clip_feature is None else np.asarray(clip_feature, np.float32)
        self.iteration_count += 1

        tid, timestep = self.sample_timestep()
        noise_w_error, latents_w_error, y_np, use_clean = self.corrupt_inputs(
            latents, y_np, timestep
        )

        # variant dropouts (dance :1045-1062, talk :969-973)
        pose_keep = 1.0
        if pose is not None:
            if self.rng.random() < c.pose_drop_prob1 or self.rng.random() < c.pose_drop_prob2:
                pose_keep = 0.0
            if self.rng.random() < c.cond_drop_prob:
                if clip_np is not None:
                    clip_np = np.zeros_like(clip_np)
                if y_np is not None:
                    y_np = np.zeros_like(y_np)
        if audio_tuple is not None and self.rng.random() < c.audio_drop_prob:
            audio_tuple = (np.zeros_like(np.asarray(audio_tuple[0])),
                           np.zeros_like(np.asarray(audio_tuple[1])))

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
        if c.train_pose:
            batch["pose"] = None if pose is None else host(pose)
            batch["pose_keep"] = torch.full((b, 1, 1), pose_keep, dtype=torch.float32,
                                            device=dev)
        if audio_tuple is not None:
            batch["audio_first"] = host(audio_tuple[0], dtype)
            batch["audio_vf"] = host(audio_tuple[1], dtype)
        metrics = self.train_step(batch)

        if c.use_error_recycling:
            # every entry of the global batch, in its order, on every rank
            # (the JAX host readback of the gathered errors)
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

    # -- the files a run leaves ---------------------------------------------------

    def save_lora_safetensors(self, path: str, side_modules: Optional[dict] = None):
        """LoRA-only export (the analog of Lightning's stripped
        on_save_checkpoint :1294-1304 + utils/extract_lora.py), f32, written
        by the port's own safetensors writer: the adapters in peft naming, the
        customtalk FFNs as blocks.{i}.{ffn}.{0,2}.{weight,bias} ((out, in),
        fusable by the loaders), the pose convs as
        dwpose_embedding.{0,2,...}.{weight,bias} (a Sequential's numbering,
        (out, in, kt, kh, kw)), then side_modules. Written by global rank 0
        only."""
        from ..utils.safetensors_io import save_file

        if not is_main_rank():
            return
        sd = {}
        if self.lora is not None:
            sd.update({k: torch.from_numpy(v)
                       for k, v in lora_mod.to_peft_state_dict(self.lora).items()})
        for name, p in self.trainable.get("customtalk", {}).items():
            key = name.rsplit(".", 1)[0] + (".weight" if name.endswith(".w") else ".bias")
            sd[key] = p.detach().float().cpu()
        if self.cfg.train_pose and self.pose_params is not None:
            sd.update({k: v.float().cpu() for k, v in
                       pose_embedding.torch_state_dict_from_params(self.pose_params).items()})
        if side_modules:
            sd.update({k: torch.as_tensor(v).detach().float().cpu()
                       for k, v in side_modules.items()})
        save_file(sd, path)

    def load_lora_safetensors(self, path: str):
        """Adapters (and, with train_pose, the pose embedding) from a peft
        LoRA file; the optimizer starts afresh."""
        from ..utils.safetensors_io import load_file

        sd = {k: v.float() for k, v in load_file(path).items()}
        if self.cfg.train_architecture == "lora":
            self.trainable["lora"] = lora_mod.from_peft_state_dict(sd, self.dit_cfg,
                                                                   device=self.device)
        if self.cfg.train_pose and any(pose_embedding.PREFIX in k for k in sd):
            self.trainable["pose"] = pose_embedding.params_from_torch_state_dict(
                sd, device=self.device).requires_grad_(True)
        self.reset_optimizer()

    def save_checkpoint(self, ckpt_dir: str):
        """Full resumable state: `train_state.pt` (the trainables and the
        optimizer's state, torch.save) and `host_state.pkl` (iteration count,
        both error buffers, the host RNG's state). (The reference does NOT
        checkpoint buffers: a resume restarts buffer warmup; we keep them.)
        On a mesh every rank calls it (ZeRO-1 gathers the moments), global
        rank 0 writes the single-device files, and every rank returns once
        they are written, so any rank can resume from them."""
        optimizer = self.optimizer.state_dict()
        if is_main_rank():
            os.makedirs(ckpt_dir, exist_ok=True)
            torch.save({"trainable": {k: p.detach() for k, p in
                                      self.named_trainables().items()},
                        "optimizer": optimizer},
                       os.path.join(ckpt_dir, "train_state.pt"))
            with open(os.path.join(ckpt_dir, "host_state.pkl"), "wb") as f:
                pickle.dump({
                    "iteration_count": self.iteration_count,
                    "latent_error_buffer": self.buffers.latent_error_buffer,
                    "y_error_buffer": self.buffers.y_error_buffer,
                    "rng_state": self.rng.getstate(),
                }, f)
        if self.mesh is not None:
            collectives.barrier(self.mesh.world)

    def restore_checkpoint(self, ckpt_dir: str):
        """The state of `save_checkpoint`, into a trainer of the same
        configuration: the trainables are copied in place, so the optimizer
        keeps its parameters."""
        state = torch.load(os.path.join(ckpt_dir, "train_state.pt"), map_location=self.device,
                           weights_only=True)
        mine = self.named_trainables()
        if state["trainable"].keys() != mine.keys():
            raise ValueError(f"{ckpt_dir}: the checkpoint's trainables differ from this "
                             "trainer's (another architecture, pose or LoRA targets)")
        with torch.no_grad():
            for k, p in mine.items():
                p.copy_(state["trainable"][k])
        self.optimizer.load_state_dict(state["optimizer"])
        host_path = os.path.join(ckpt_dir, "host_state.pkl")
        if os.path.exists(host_path):
            # written by save_checkpoint of this package
            with open(host_path, "rb") as f:
                host = pickle.load(f)
            self.iteration_count = host["iteration_count"]
            self.buffers.latent_error_buffer = host["latent_error_buffer"]
            self.buffers.y_error_buffer = host["y_error_buffer"]
            self.rng.setstate(host["rng_state"])
