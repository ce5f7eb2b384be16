"""Tensor-parallel DiT forward: the blocks' weights sharded over the mesh's
tensor axis ('sp' reused, as in the JAX package), Megatron-style (port of
svi_tpu/parallel/tensor_parallel.py). Inference only.

Per block:
  * q/k/v and ffn.0 are column-parallel (each rank computes its own heads /
    its slice of the ffn's hidden width);
  * o and ffn.2 are row-parallel (input features sharded, the partial
    products summed by one psum each, the bias added once after it);
  * the q/k RMS norms run over the full model dim, so their mean of squares
    is a psum;
  * tokens, the adaLN modulation and the context stay replicated.

Each rank holds only its slice of the blocks (`shard_dit_params_tp`, made
from a tree on the host or the card without a second full copy on the
card); everything outside the blocks is replicated. The block is
`WanDiT.dit_block` on a view (`_TensorShardedDiT`) whose attention pieces
and FFN are the tensor-parallel ones below.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.wan_dit import WanDiT, dense
from ..ops.attention import flash_attention, flash_attention_flat
from ..ops.norms import gelu_tanh
from .collectives import gather_replicated, psum
from .mesh import Mesh, MeshAxis
from .sequence_parallel import local_batch

AXIS = "sp"  # the mesh's second axis is the tensor axis

COL, ROW = "col", "row"


def _rms_norm_tp(x, weight_local, eps: float, axis: MeshAxis):
    """RMSNorm over the full (sharded) feature dim: psum of the sum of squares."""
    xf = x.float()
    total_sq = psum((xf * xf).sum(-1, keepdim=True), axis)
    y = xf * torch.rsqrt(total_sq / (xf.shape[-1] * axis.size) + eps)
    return y.to(x.dtype) * weight_local


def _dense_row(p, x, axis: MeshAxis):
    """Row-parallel dense: the shard's partial product (a quantized leaf
    dequantizes its own partial product first: W8A8 quantizes the shard's
    slice of the activations with its own per-token max, as in the JAX
    package), one psum, the bias added once."""
    partial = dense({k: p[k] for k in p._tree_keys if k != "b"}, x)
    y = psum(partial, axis)
    b = p.get("b")
    return y if b is None else y + b.to(x.dtype)


def _self_attention_tp(dit, p, x, cos, sin, n_local: int, axis: MeshAxis):
    cfg = dit.cfg
    q = _rms_norm_tp(dense(p["q"], x), p["norm_q"]["w"], cfg.eps, axis)
    k = _rms_norm_tp(dense(p["k"], x), p["norm_k"]["w"], cfg.eps, axis)
    o = flash_attention_flat(q, k, dense(p["v"], x), cfg.head_dim, cos=cos, sin=sin)
    return _dense_row(p["o"], o, axis)


def _cross_attention_tp(dit, p, x, ctx, n_local: int, num_img_tokens: int, axis: MeshAxis):
    cfg = dit.cfg
    b, s, _ = x.shape
    hd = cfg.head_dim
    img, txt = (ctx[:, :num_img_tokens], ctx[:, num_img_tokens:]) if cfg.has_image_input \
        else (None, ctx)
    q = _rms_norm_tp(dense(p["q"], x), p["norm_q"]["w"], cfg.eps, axis).reshape(b, s, n_local,
                                                                              hd)

    def attend(kp, vp, norm, c):
        k = _rms_norm_tp(dense(kp, c), norm, cfg.eps, axis)
        shape = (b, c.shape[1], n_local, hd)
        return flash_attention(q, k.reshape(shape), dense(vp, c).reshape(shape))

    o = attend(p["k"], p["v"], p["norm_k"]["w"], txt)
    if img is not None:
        o = o + attend(p["k_img"], p["v_img"], p["norm_k_img"]["w"], img)
    return _dense_row(p["o"], o.reshape(b, s, n_local * hd), axis)


def _audio_cross_attention_tp(dit, p, x, audio, num_frames: int, n_local: int,
                              axis: MeshAxis):
    """Per-frame audio cross-attention, head-parallel: q and the split
    k_linear / v_linear (`split_audio_kv`) column-sharded by head, proj
    row-parallel; the per-frame grouping is token-local."""
    cfg = dit.cfg
    b, s_all, d = x.shape
    f = num_frames
    s = s_all // f
    hd = cfg.head_dim
    q = dense(p["q_linear"], x.reshape(b * f, s, d)).reshape(b * f, s, n_local, hd)
    na = audio.shape[2]
    a = audio.reshape(b * f, na, -1).to(x.dtype)
    k = dense(p["k_linear"], a).reshape(b * f, na, n_local, hd)
    v = dense(p["v_linear"], a).reshape(b * f, na, n_local, hd)
    logits = torch.einsum("bsnd,bknd->bnsk", q.float(), k.float()) * hd ** -0.5
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bnsk,bknd->bsnd", probs, v).reshape(b, s_all, n_local * hd)
    return _dense_row(p["proj"], o, axis)


class _TensorShardedDiT(WanDiT):
    """A view of a tensor-sharded WanDiT (the same tensors) whose attention
    pieces and FFN are the tensor-parallel ones."""

    def __init__(self, dit: WanDiT, axis: MeshAxis):
        self.__dict__.update(dit.__dict__)
        self.__dict__.update(tp_axis=axis, n_local=dit.cfg.num_heads // axis.size)

    def _self_attention(self, p, x, cos, sin, lora=None, lora_scale: float = 1.0):
        return _self_attention_tp(self, p, x, cos, sin, self.n_local, self.tp_axis)

    def _cross_attention(self, p, x, ctx, num_img_tokens: int, lora=None,
                         lora_scale: float = 1.0):
        return _cross_attention_tp(self, p, x, ctx, self.n_local, num_img_tokens, self.tp_axis)

    def _audio_cross_attention(self, p, x, audio, num_frames: int):
        return _audio_cross_attention_tp(self, p, x, audio, num_frames, self.n_local,
                                         self.tp_axis)

    def _ffn(self, p, x, lora=None, lora_scale: float = 1.0):
        return _dense_row(p["2"], gelu_tanh(dense(p["0"], x)), self.tp_axis)


# the JAX package's `_dit_block_tp`: WanDiT.dit_block on the sharded view
_dit_block_tp = _TensorShardedDiT.dit_block


def block_param_specs(cfg) -> dict:
    """Each block site's role: COL (column-parallel: every leaf's first axis,
    the port's out-feature axis, is sharded), ROW (row-parallel: the weight's
    in axis is sharded, biases and per-channel scales replicated), or None
    (replicated). The audio attention's kv_linear is split first
    (`split_audio_kv`)."""
    attn = {"q": COL, "k": COL, "v": COL, "o": ROW, "norm_q": COL, "norm_k": COL}
    cross = dict(attn)
    if cfg.has_image_input:
        cross.update(k_img=COL, v_img=COL, norm_k_img=COL)
    specs = {"self_attn": attn, "cross_attn": cross, "norm3": None,
             "ffn": {"0": COL, "2": ROW}, "modulation": None}
    if cfg.has_audio:
        specs["audio_cross_attn"] = {"q_linear": COL, "k_linear": COL, "v_linear": COL,
                                     "proj": ROW}
        specs["norm_x"] = None
    if cfg.enable_customtalk:
        specs["customtalk_context_pre_ffns"] = specs["customtalk_audio_pre_ffns"] = None
    return specs


# row-parallel leaves: the (out, in) weights shard their in axis, the biases
# and per-output-channel scales are replicated
_ROW_LEAVES = {"w": 1, "w_q8": 1, "w_q": 1, "b": None, "scale8": None, "scale": None}


def block_param_specs_for(block: dict, cfg) -> dict:
    """The slicing rule of one block's (audio-kv-split, possibly quantized)
    tree: the same nested dict with, at each leaf, the dim this rank slices
    (0 or 1) or None (replicated). Packed int4 cannot be row-sharded: its
    half-split nibble layout puts inputs i and i + in/2 in one byte, which
    is not the contiguous slice of activations a rank holds; quantize with
    w8a8 or int8 for tensor parallelism."""

    def walk(spec, site, path):
        out = {}
        for k, v in site.items():
            role = spec.get(k) if isinstance(spec, dict) else spec
            if isinstance(v, dict):
                out[k] = walk(role, v, path + (k,))
            elif role == COL:
                out[k] = 0
            elif role == ROW:
                if k not in _ROW_LEAVES:
                    raise ValueError(f"packed-int4 leaf {'.'.join(path + (k,))} cannot be "
                                     "row-sharded (half-split nibble layout); quantize with "
                                     "w8a8 or int8 for tensor parallelism")
                out[k] = _ROW_LEAVES[k]
            else:
                out[k] = None
        return out

    return walk(block_param_specs(cfg), block, ())


def split_audio_kv(block: dict) -> dict:
    """The fused audio kv_linear (out features (2, n, hd)) split into
    k_linear and v_linear, so that its out axis can be sharded by head."""
    if "audio_cross_attn" not in block:
        return block
    block = dict(block)
    aca = dict(block["audio_cross_attn"])
    kv = aca.pop("kv_linear")
    d = next(iter(kv.values())).shape[0] // 2  # every leaf's first axis is the out axis
    aca["k_linear"] = {k: v[:d] for k, v in kv.items()}
    aca["v_linear"] = {k: v[d:] for k, v in kv.items()}
    block["audio_cross_attn"] = aca
    return block


def shard_blocks(dit: WanDiT, axis: MeshAxis, device=None) -> WanDiT:
    """A WanDiT on `device` (the dit's by default) holding this rank's slice
    of every block and a copy of everything else. Each slice is cut from the
    tree where it lies and only the slice is copied to the device, so the
    device holds no second full tree."""
    cfg = dit.cfg
    tree = dit.tree()
    device = torch.device(device) if device is not None else next(dit.parameters()).device
    if cfg.num_heads % axis.size or cfg.ffn_dim % axis.size:
        raise ValueError(f"{cfg.num_heads} heads and ffn {cfg.ffn_dim} must divide over "
                         f"{axis.size} ranks")

    def place(t, dim):
        if dim is not None:
            n = t.shape[dim] // axis.size
            t = t.narrow(dim, axis.index * n, n)
        return t.to(device).contiguous()

    def cut(site, spec):
        return {k: cut(v, spec[k]) if isinstance(v, dict) else place(v, spec[k])
                for k, v in site.items()}

    def copy(t):
        if isinstance(t, dict):
            return {k: copy(v) for k, v in t.items()}
        return t.to(device)

    out = {k: copy(v) for k, v in tree.items() if k != "blocks"}
    blocks = [split_audio_kv(b) for b in tree["blocks"]]
    out["blocks"] = [cut(b, block_param_specs_for(b, cfg)) for b in blocks]
    return WanDiT(cfg, out)


def shard_dit_params_tp(dit: WanDiT, mesh: Mesh, device=None) -> WanDiT:
    """This rank's tensor-parallel DiT: its slice of the blocks over the
    mesh's tensor axis ('sp'), everything else replicated (`shard_blocks`)."""
    return shard_blocks(dit, mesh[AXIS], device)


def forward_tp(
    dit: WanDiT,
    x: torch.Tensor,
    timestep: torch.Tensor,
    context: torch.Tensor,
    clip_feature: Optional[torch.Tensor] = None,
    y: Optional[torch.Tensor] = None,
    add_condition: Optional[torch.Tensor] = None,
    *,
    mesh: Mesh,
    audio_embed_tuple=None,
) -> torch.Tensor:
    """Tensor-parallel `WanDiT.forward` (inference) of a DiT from
    `shard_dit_params_tp`, on every rank of `mesh`: the global batch in
    (sharded over 'data'), the global output out. Needs cfg.num_heads and
    cfg.ffn_dim divisible by the tensor axis. The multitalk / customtalk
    audio branches as in `WanDiT.forward`."""
    axis, data = mesh[AXIS], mesh["data"]
    cfg = dit.cfg
    if cfg.num_heads % axis.size or cfg.ffn_dim % axis.size:
        raise ValueError(f"{cfg.num_heads} heads and ffn {cfg.ffn_dim} over {axis.size} ranks")
    x, timestep, context, clip_feature, y, add_condition, audio = local_batch(
        data, x, timestep, context, clip_feature, y, add_condition, audio_embed_tuple)
    tokens, ctx, t, t_mod, grid = dit.forward_prelude(x, timestep, context, clip_feature, y,
                                                      add_condition)
    n_img = clip_feature.shape[1] if (cfg.has_image_input and clip_feature is not None) else 257
    audio_embed = dit.audio_proj_forward(*audio) if cfg.has_audio and audio is not None else None
    cond = add_condition if cfg.enable_customtalk and audio_embed is not None else None
    tokens = _TensorShardedDiT(dit, axis).forward_blocks(
        tokens, ctx, t_mod, grid, num_img_tokens=n_img, audio_embed=audio_embed,
        block_add_condition=cond)
    return gather_replicated(dit.forward_head(tokens, t, grid), data, dim=0)


def param_bytes(tree) -> int:
    """The bytes of every tensor a module (a DiT, its blocks) holds."""
    return sum(p.numel() * p.element_size() for p in tree.parameters())
