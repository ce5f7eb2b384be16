"""Tensor x sequence parallel DiT forward over a 3-axis mesh ('data', 'tp',
'sp') (port of svi_tpu/parallel/tp_sp.py). Inference only.

The production 14B shape: the weights shard over 'tp', the sequence over
'sp', the batch over 'data'. Per block: q/k/v and ffn.0 column-parallel over
'tp' (local heads, a slice of the hidden width), k and v all-gathered (or
rotated around the ring) over 'sp', o and ffn.2 row-parallel with one psum
over 'tp' each, the full-dim q/k RMS norms by a psum over 'tp'.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.wan_dit import WanDiT, dense
from .collectives import gather_seq
from .mesh import Mesh, MeshAxis
from .sequence_parallel import _keep_shard, _rotate, _sp_attend, sharded_forward
from .tensor_parallel import (_audio_cross_attention_tp, _dense_row, _rms_norm_tp,
                              _TensorShardedDiT, shard_blocks)

TP, SP = "tp", "sp"


def make_mesh3(data: int = 1, tp: int = 1, sp: int = 1) -> Mesh:
    return Mesh(("data", TP, SP), (data, tp, sp))


def _self_attention_tpsp(dit, p, x, cos_l, sin_l, kv_len: int, n_local: int, tp: MeshAxis,
                         sp: MeshAxis, ring: bool):
    cfg = dit.cfg
    hd = cfg.head_dim
    q = _rms_norm_tp(dense(p["q"], x), p["norm_q"]["w"], cfg.eps, tp)
    k = _rms_norm_tp(dense(p["k"], x), p["norm_k"]["w"], cfg.eps, tp)
    q, k = _rotate(q, cos_l, sin_l, n_local, hd), _rotate(k, cos_l, sin_l, n_local, hd)
    o = _sp_attend(q, k, dense(p["v"], x), sp, kv_len, n_local, hd, ring)
    return _dense_row(p["o"], o, tp)


def _audio_attn_tpsp(dit, p, x_local, audio, num_frames: int, kv_len: int, n_local: int,
                     tp: MeshAxis, sp: MeshAxis):
    """Per-frame audio attention under TP x SP: the tokens gathered over
    'sp' (the frame grouping needs the true sequence), heads local over
    'tp', proj row-summed over 'tp', each sp rank keeping its slice."""
    x_full = gather_seq(x_local, sp)
    o = _audio_cross_attention_tp(dit, p, x_full[:, :kv_len], audio, num_frames, n_local, tp)
    return _keep_shard(o, x_local, kv_len, sp)


class _TensorSequenceShardedDiT(_TensorShardedDiT):
    """The tensor-parallel view on one sequence shard."""

    def __init__(self, dit: WanDiT, tp: MeshAxis, sp: MeshAxis, kv_len: int, ring: bool):
        super().__init__(dit, tp)
        self.__dict__.update(sp_axis=sp, kv_len=kv_len, ring=ring)

    def _self_attention(self, p, x, cos, sin, lora=None, lora_scale: float = 1.0):
        return _self_attention_tpsp(self, p, x, cos, sin, self.kv_len, self.n_local,
                                    self.tp_axis, self.sp_axis, self.ring)

    def _audio_cross_attention(self, p, x, audio, num_frames: int):
        return _audio_attn_tpsp(self, p, x, audio, num_frames, self.kv_len, self.n_local,
                                self.tp_axis, self.sp_axis)


# the JAX package's `_dit_block_tpsp`: WanDiT.dit_block on the sharded view
_dit_block_tpsp = _TensorSequenceShardedDiT.dit_block


def shard_dit_params_tpsp(dit: WanDiT, mesh: Mesh, device=None) -> WanDiT:
    """This rank's slice of the blocks over 'tp' (`tensor_parallel.shard_blocks`)."""
    return shard_blocks(dit, mesh[TP], device)


def forward_tpsp(
    dit: WanDiT,
    x: torch.Tensor,
    timestep: torch.Tensor,
    context: torch.Tensor,
    clip_feature: Optional[torch.Tensor] = None,
    y: Optional[torch.Tensor] = None,
    add_condition: Optional[torch.Tensor] = None,
    *,
    mesh: Mesh,
    ring: bool = False,
    audio_embed_tuple=None,
) -> torch.Tensor:
    """2D tensor x sequence parallel forward of a DiT from
    `shard_dit_params_tpsp`: the global batch in, the global output out on
    every rank. num_heads and ffn_dim must divide by the tp size. The
    multitalk / customtalk audio branches as in `WanDiT.forward`."""
    tp, sp = mesh[TP], mesh[SP]
    cfg = dit.cfg
    if cfg.num_heads % tp.size or cfg.ffn_dim % tp.size:
        raise ValueError(f"{cfg.num_heads} heads and ffn {cfg.ffn_dim} over {tp.size} ranks")

    def view_for(kv_len):
        return _TensorSequenceShardedDiT(dit, tp, sp, kv_len, ring)

    return sharded_forward(dit, view_for, x, timestep, context, clip_feature, y, add_condition,
                           data=mesh["data"], sp=sp, audio_embed_tuple=audio_embed_tuple)
