"""AnimateDiff motion modules for the SD and SDXL UNets, port of
svi_tpu/models/motion.py: per-pixel temporal self-attention blocks with
learned 32-frame positional embeddings, run after the UNet plan entries that
`SD_MOTION_CALL_MAP` / `SDXL_MOTION_CALL_MAP` name (UNet entry -> motion
module). Video frames ride the batch axis. The temporal attention (8 heads
of 40, 80 or 160 over at most 32 frames) is the flash kernel's short-query
route on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from .params import ParamTree, dense
from . import sd
from .sd import StateDictMaker, _Reader, _group_norm, _layer_norm, sd_params_from_jax

SD_MOTION_CALL_MAP = {
    1: 0, 4: 1, 9: 2, 12: 3, 17: 4, 20: 5, 24: 6, 26: 7, 29: 8, 32: 9,
    34: 10, 36: 11, 40: 12, 43: 13, 46: 14, 50: 15, 53: 16, 56: 17,
    60: 18, 63: 19, 66: 20,
}
SDXL_MOTION_CALL_MAP = {
    0: 0, 2: 1, 7: 2, 10: 3, 15: 4, 18: 5, 25: 6, 28: 7, 31: 8, 35: 9,
    38: 10, 41: 11, 44: 12, 46: 13, 48: 14,
}
NUM_HEADS = 8
MAX_FRAMES = 32  # the learned positional embeddings' length


def _temporal_attention(p, x, pe, num_heads, head_dim, batch_size):
    """Tokens regrouped (b f) hw c -> (b hw) f c; the positional embedding
    is added to the attention's input only."""
    bf, hw, c = x.shape
    f = bf // batch_size
    y = x.reshape(batch_size, f, hw, c).transpose(1, 2).reshape(batch_size * hw, f, c)
    y = y + pe[:, :f].to(y.dtype)
    q = dense(p["to_q"], y).reshape(-1, f, num_heads, head_dim)
    k = dense(p["to_k"], y).reshape(-1, f, num_heads, head_dim)
    v = dense(p["to_v"], y).reshape(-1, f, num_heads, head_dim)
    o = dense(p["to_out"], flash_attention(q, k, v).reshape(-1, f, num_heads * head_dim))
    return o.reshape(batch_size, hw, f, c).transpose(1, 2).reshape(bf, hw, c)


def temporal_block(p, x, num_heads, head_dim, batch_size=1):
    """One motion module on (B*F, C, H, W)."""
    bf, c, h, w = x.shape
    residual = x
    y = _group_norm(p["norm"], x, eps=1e-6).permute(0, 2, 3, 1).reshape(bf, h * w, c)
    y = dense(p["proj_in"], y)
    for tp in p["transformer_blocks"]:
        y = y + _temporal_attention(tp["attn1"], _layer_norm(tp["norm1"], y), tp["pe1"],
                                    num_heads, head_dim, batch_size)
        y = y + _temporal_attention(tp["attn2"], _layer_norm(tp["norm2"], y), tp["pe2"],
                                    num_heads, head_dim, batch_size)
        a, gate = dense(tp["act_fn"], _layer_norm(tp["norm3"], y)).chunk(2, dim=-1)
        y = y + dense(tp["ff"], a * F.gelu(gate.float()).to(y.dtype))
    y = dense(p["proj_out"], y).reshape(bf, h, w, c).permute(0, 3, 1, 2)
    return y + residual


def motion_hooks(params, call_map=None, batch_size=1) -> dict:
    """{plan_index: fn(x)}, the hooks `sd._run_plan` runs."""
    call_map = SD_MOTION_CALL_MAP if call_map is None else call_map

    def make(mp):
        head_dim = mp["proj_in"]["w"].shape[0] // NUM_HEADS
        return lambda x: temporal_block(mp, x, NUM_HEADS, head_dim, batch_size)

    return {bid: make(params["motion_modules"][mid]) for bid, mid in call_map.items()}


def motion_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> ParamTree:
    """The reference's SDMotionModel state dict -> {'motion_modules': [...]}."""
    r = _Reader(sd, device, dtype)
    mods = []
    i = 0
    while f"motion_modules.{i}.norm.weight" in r:
        m = f"motion_modules.{i}"
        blocks = []
        j = 0
        while f"{m}.transformer_blocks.{j}.norm1.weight" in r:
            t = f"{m}.transformer_blocks.{j}"
            blocks.append({"pe1": r.t(f"{t}.pe1"), "norm1": r.norm(f"{t}.norm1"),
                           "attn1": r.attn(f"{t}.attn1"),
                           "pe2": r.t(f"{t}.pe2"), "norm2": r.norm(f"{t}.norm2"),
                           "attn2": r.attn(f"{t}.attn2"),
                           "norm3": r.norm(f"{t}.norm3"), "act_fn": r.lin(f"{t}.act_fn.proj"),
                           "ff": r.lin(f"{t}.ff")})
            j += 1
        mods.append({"norm": r.norm(f"{m}.norm"), "proj_in": r.lin(f"{m}.proj_in"),
                     "transformer_blocks": blocks, "proj_out": r.lin(f"{m}.proj_out")})
        i += 1
    return ParamTree({"motion_modules": mods})


def motion_params_from_jax(params: dict, dtype=torch.float32, device="cuda") -> ParamTree:
    return sd_params_from_jax(params, dtype, device)


def plan_channels(plan) -> list:
    """The channels of the stream after each plan entry (the skip stack
    starts with the input, at the first entry's channels)."""
    out, stack, c = [], [plan[0][1]], plan[0][1]
    for desc in plan:
        kind = desc[0]
        if kind == "res":
            c = desc[2]
        elif kind == "attn":
            c = desc[3]
        elif kind in ("down", "up", "vae_attn"):
            c = desc[1]
        elif kind == "push":
            stack.append(c)
        elif kind == "pop":
            c = c + stack.pop()
        out.append(c)
    return out


def sd_motion_state_dict(seed=0, device="cpu", dtype=torch.float32, call_map=None,
                         plan=None) -> dict:
    """Seeded random AnimateDiff weights for the SD UNet at `SD_UNET_PLAN`'s
    widths (or another UNet's plan and call map): one module per call-map
    entry (21, AnimateDiff v2's), one transformer block of two temporal
    attentions each."""
    call_map = SD_MOTION_CALL_MAP if call_map is None else call_map
    chans = plan_channels(sd.SD_UNET_PLAN if plan is None else plan)
    m = StateDictMaker(seed, device, dtype)
    for bid, mid in sorted(call_map.items(), key=lambda kv: kv[1]):
        c, mm = chans[bid], f"motion_modules.{mid}"
        t = f"{mm}.transformer_blocks.0"
        m.norm(f"{mm}.norm", c)
        m.lin(f"{mm}.proj_in", c, c)
        for a in ("1", "2"):
            m.sd[f"{t}.pe{a}"] = m.randn((1, MAX_FRAMES, c), 0.02)
            m.norm(f"{t}.norm{a}", c)
            m.attn(f"{t}.attn{a}", c)
        m.norm(f"{t}.norm3", c)
        m.lin(f"{t}.act_fn.proj", 8 * c, c)
        m.lin(f"{t}.ff", c, 4 * c)
        m.lin(f"{mm}.proj_out", c, c)
    return m.sd


def sdxl_motion_state_dict(seed=0, device="cpu", dtype=torch.float32) -> dict:
    """Seeded random AnimateDiff-SDXL weights: 15 modules at
    `sdxl.SDXL_UNET_PLAN`'s widths, after the entries of `SDXL_MOTION_CALL_MAP`."""
    from .sdxl import SDXL_UNET_PLAN

    return sd_motion_state_dict(seed, device, dtype, SDXL_MOTION_CALL_MAP, SDXL_UNET_PLAN)
