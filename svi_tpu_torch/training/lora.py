"""Unfused LoRA adapters for training (port of svi_tpu/training/lora.py;
behavioral ref: train_svi.py:942-986 add_lora_to_model: peft LoraConfig r=128
alpha=128 on q,k,v,o,ffn.0,ffn.2, kaiming init on A / zeros on B, f32).

The adapters are a trainable `ParamTree` with one subtree per DiT block,
`lora["blocks"][i]["self_attn"]["q"]` = {"a": (in, r), "b": (r, out)}, all
f32 with requires_grad=True; `WanDiT.forward(lora=...)` adds them as a side
path (y = xW + scale·(xA)B). Export gives the peft state dict the inference
loaders fuse back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.params import ParamTree
from ..models.wan_dit import WanDiTConfig

DEFAULT_TARGETS = ("q", "k", "v", "o", "ffn.0", "ffn.2")

# peft target_modules match by module-name suffix: "q" hits BOTH self_attn.q
# and cross_attn.q (train_svi.py uses "q,k,v,o,ffn.0,ffn.2"), not k_img/v_img.
_ATTN_KEYS = ("q", "k", "v", "o")


def _target_dims(cfg: WanDiTConfig, module: str, key: str):
    d, f = cfg.dim, cfg.ffn_dim
    if module in ("self_attn", "cross_attn"):
        return d, d
    if module == "ffn":
        return (d, f) if key == "0" else (f, d)
    raise ValueError(module)


def _targets(cfg: WanDiTConfig, targets):
    """(module, key, fan_in, fan_out) of every adapted linear, in a fixed order."""
    targets = set(targets)
    out = [(m, k, *_target_dims(cfg, m, k)) for m in ("self_attn", "cross_attn")
           for k in _ATTN_KEYS if k in targets]
    return out + [("ffn", k, *_target_dims(cfg, "ffn", k)) for k in ("0", "2")
                  if f"ffn.{k}" in targets]


def _tree(blocks: list) -> ParamTree:
    return ParamTree({"blocks": blocks}, trainable=True)


def init_lora_params(cfg: WanDiTConfig, rank: int = 128, targets=DEFAULT_TARGETS,
                     generator: torch.Generator | None = None, device="cuda") -> ParamTree:
    """A: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's kaiming_uniform_(a=sqrt(5))
    on lora_A), B: zeros, so the initial delta is exactly 0 (peft
    init_lora_weights=True). Drawn on `device` from `generator` (a fresh
    generator seeded with 0 when None)."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    blocks = []
    for _ in range(cfg.num_layers):
        block: dict = {}
        for module, key, fi, fo in _targets(cfg, targets):
            bound = 1.0 / math.sqrt(fi)
            a = torch.empty((fi, rank), dtype=torch.float32, device=device)
            block.setdefault(module, {})[key] = {
                "a": a.uniform_(-bound, bound, generator=generator),
                "b": torch.zeros((rank, fo), dtype=torch.float32, device=device),
            }
        blocks.append(block)
    return _tree(blocks)


def lora_scale(rank: int, alpha: float) -> float:
    """peft scaling = alpha / r."""
    return alpha / rank


def num_lora_params(lora: ParamTree) -> int:
    return sum(p.numel() for p in lora.parameters())


def _leaves(lora: ParamTree):
    """(block index, 'module.key', leaf) for every adapter."""
    for i, block in enumerate(lora["blocks"]):
        for module in block._tree_keys:
            sub = block[module]
            for key in sub._tree_keys:
                yield i, f"{module}.{key}", sub[key]


def to_peft_state_dict(lora: ParamTree, prefix: str = "") -> dict:
    """peft-style numpy state dict (torch weight layout):
    blocks.{i}.{module}.{key}.lora_A.default.weight (r, in) and
    .lora_B.default.weight (out, r), f32."""
    out = {}
    for i, path, leaf in _leaves(lora):
        base = f"{prefix}blocks.{i}.{path}"
        out[f"{base}.lora_A.default.weight"] = leaf["a"].detach().float().cpu().numpy().T.copy()
        out[f"{base}.lora_B.default.weight"] = leaf["b"].detach().float().cpu().numpy().T.copy()
    return out


def from_peft_state_dict(sd: dict, cfg: WanDiTConfig, rank=None, dtype=torch.float32,
                         device="cuda") -> ParamTree:
    """A peft LoRA state dict (keys may carry a 'pipe.dit.' or
    'diffusion_model.' prefix, train_svi.py:968-981) -> adapters in `dtype`.
    rank is read from the tensors' shapes; the argument is accepted and
    unused, as in the JAX package."""
    clean = {}
    for k, v in sd.items():
        if "pipe.dit." in k:
            k = k.split("pipe.dit.")[1]
        if k.startswith("diffusion_model."):
            k = k[len("diffusion_model."):]
        clean[k] = v
    blocks: list = [{} for _ in range(cfg.num_layers)]
    for k, a in clean.items():
        if ".lora_A." not in k or not k.startswith("blocks."):
            continue
        parts = k.split(".")  # blocks, i, module..., key, lora_A, default, weight
        node = blocks[int(parts[1])]
        for name in parts[2:-4]:
            node = node.setdefault(name, {})
        node[parts[-4]] = {
            "a": torch.tensor(np.asarray(a, np.float32).T, dtype=dtype, device=device),
            "b": torch.tensor(np.asarray(clean[k.replace(".lora_A.", ".lora_B.")],
                                         np.float32).T, dtype=dtype, device=device),
        }
    return _tree(blocks)


def params_from_jax(lora: dict, device="cuda") -> ParamTree:
    """The JAX package's stacked adapter pytree ({module: {key: {"a": (L, in, r),
    "b": (L, r, out)}}}, as numpy) -> per-block adapters."""
    n = next(np.asarray(leaf["a"]).shape[0] for sub in lora.values() for leaf in sub.values())
    blocks = [{m: {k: {ab: torch.tensor(np.asarray(leaf[ab], np.float32)[i], device=device)
                       for ab in ("a", "b")}
                   for k, leaf in sub.items()}
               for m, sub in lora.items()} for i in range(n)]
    return _tree(blocks)
