"""Sequence-parallel DiT forward over a process mesh (port of
svi_tpu/parallel/sequence_parallel.py; the reference's USP, xfuser's
Ulysses + ring, diffsynth/distributed/xdit_context_parallel.py).

The f·h·w patch-token axis is sharded over the mesh's 'sp' axis, padded to
a multiple of its size: each rank rotates its own q and k with its rows of
the RoPE tables, self-attention all-gathers k and v (the keys carry their
rotated positions, so the gather order is the global token order) or
rotates them around a ring, the padded keys are masked by kv_len = S, the
modulated head runs on the shard, and the shards are gathered and the
padding dropped. The batch is sharded over 'data'.

Inputs are the global batch, as under the JAX package's jit: every rank
takes its 'data' rows, and every rank returns the whole output (the
gathers' backward keeps the rank's own slice), so a loss computed alike on
every rank has the JAX gradient once the ranks' parameter gradients are
summed (`training.trainer`).

The block is `WanDiT.dit_block` itself on a view of the DiT
(`_SequenceShardedDiT`) whose self-attention is `_self_attention_sp` and
whose per-frame audio attention is `_audio_attn_sp` (`_dit_block_sp`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..models.wan_dit import WanDiT, _l, dense_lora
# the JAX path rotates in XLA (`apply_rope`): the same f32 rotation, one rounding
from ..ops.attention import _apply_rope_reference as apply_rope
from ..ops.attention import flash_attention_self, flash_attention_with_lse
from ..ops.norms import rms_norm
from ..ops.rope import rope_angles_for_grid
from .collectives import axis_index, gather_replicated, gather_seq, ppermute_next
from .mesh import Mesh, MeshAxis


class _RingAttention(torch.autograd.Function):
    """The ring's forward; forward only, as the JAX ring is."""

    @staticmethod
    def forward(ctx, q, k_local, v_local, axis, kv_len_total):
        b, s, n, d = q.shape
        qt = q.transpose(1, 2)  # (B, N, S, D) views: K2's layout
        o = torch.zeros((b, n, s, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, n, s), -1e30, dtype=torch.float32, device=q.device)
        kb, vb = k_local, v_local
        for i in range(axis.size):
            src = (axis_index(axis) - i) % axis.size
            # valid keys inside this block (the padding sits at the global end)
            blk_valid = min(max(kv_len_total - src * s, 0), s)
            o_i, lse_i = flash_attention_with_lse(qt, kb.transpose(1, 2), vb.transpose(1, 2),
                                                  kv_len=blk_valid)
            # cross-shard softmax merge, in f32
            lse_new = torch.logaddexp(lse, lse_i)
            o = (o * torch.exp(lse - lse_new)[..., None]
                 + o_i.float() * torch.exp(lse_i - lse_new)[..., None])
            lse = lse_new
            if i + 1 < axis.size:  # the next block (JAX also rotates after the last)
                kb, vb = ppermute_next(kb, axis), ppermute_next(vb, axis)
        return o.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("ring attention is forward only (as the JAX package's); train with "
                           "the all-gather path (ring=False)")


def ring_attention(q, k_local, v_local, axis: MeshAxis, kv_len_total: int) -> torch.Tensor:
    """Ring attention over the axis's shards: k and v blocks rotate to the
    next rank while each step's flash result (K2, `flash_attention_with_lse`
    with the block's valid keys) merges by logsumexp. Layout (B, S, N, D);
    the shards are ordered blocks of the global (padded) sequence; keys at
    global positions >= kv_len_total are masked."""
    return _RingAttention.apply(q, k_local, v_local, axis, kv_len_total)


def _sp_attend(q, k, v, axis: MeshAxis, kv_len: int, n_heads: int, head_dim: int, ring: bool):
    """Attention of the shard's rotated flat q (B, s, N*D) against every
    shard's k, v: gathered, or around the ring."""
    b, s, _ = q.shape
    if ring:
        split = (b, s, n_heads, head_dim)
        return ring_attention(q.reshape(split), k.reshape(split), v.reshape(split), axis,
                              kv_len).reshape(b, s, n_heads * head_dim)
    k, v = gather_seq(k, axis), gather_seq(v, axis)
    return flash_attention_self(q, k, v, head_dim, kv_len=kv_len)


def _rotate(x, cos_l, sin_l, n_heads: int, head_dim: int):
    b, s, _ = x.shape
    return apply_rope(x.reshape(b, s, n_heads, head_dim), cos_l, sin_l).reshape(b, s, -1)


def _self_attention_sp(dit, p, x, cos_l, sin_l, kv_len, axis, lora, lora_scale, ring=False):
    cfg = dit.cfg
    n, hd = cfg.num_heads, cfg.head_dim
    q = rms_norm(dense_lora(p["q"], x, _l(lora, "q"), lora_scale), p["norm_q"]["w"], eps=cfg.eps)
    k = rms_norm(dense_lora(p["k"], x, _l(lora, "k"), lora_scale), p["norm_k"]["w"], eps=cfg.eps)
    v = dense_lora(p["v"], x, _l(lora, "v"), lora_scale)
    q, k = _rotate(q, cos_l, sin_l, n, hd), _rotate(k, cos_l, sin_l, n, hd)
    o = _sp_attend(q, k, v, axis, kv_len, n, hd, ring)
    return dense_lora(p["o"], o, _l(lora, "o"), lora_scale)


def _keep_shard(o_full, x_local, kv_len: int, axis: MeshAxis):
    """The full-sequence result o_full (b, kv_len, d): padded back to the
    gathered length, this rank's rows."""
    shard = x_local.shape[1]
    o_full = F.pad(o_full, (0, 0, 0, shard * axis.size - kv_len))
    return o_full.narrow(1, axis.index * shard, shard)


def _audio_attn_sp(dit, p, x_local, audio_embed, num_frames, kv_len, axis):
    """Per-frame audio cross-attention under sequence sharding: the
    per-frame token grouping needs frame-aligned blocks, so the tokens are
    all-gathered, the single-device attention runs on the true sequence, and
    each rank keeps its slice (the reference's SP analog is a block-diagonal
    mask, attention.py:348-356)."""
    x_full = gather_seq(x_local, axis)
    o_full = WanDiT._audio_cross_attention(dit, p, x_full[:, :kv_len], audio_embed, num_frames)
    return _keep_shard(o_full, x_local, kv_len, axis)


class _SequenceShardedDiT(WanDiT):
    """A view of a WanDiT (the same tensors) whose block pieces run on one
    sequence shard: `_self_attention_sp`, `_audio_attn_sp`."""

    def __init__(self, dit: WanDiT, axis: MeshAxis, kv_len: int, ring: bool):
        self.__dict__.update(dit.__dict__)
        self.__dict__.update(sp_axis=axis, kv_len=kv_len, ring=ring)

    def _self_attention(self, p, x, cos, sin, lora=None, lora_scale: float = 1.0):
        return _self_attention_sp(self, p, x, cos, sin, self.kv_len, self.sp_axis, lora,
                                  lora_scale, ring=self.ring)

    def _audio_cross_attention(self, p, x, audio, num_frames: int):
        return _audio_attn_sp(self, p, x, audio, num_frames, self.kv_len, self.sp_axis)


# the JAX package's `_dit_block_sp`: WanDiT.dit_block on the sharded view
# (the customtalk carry and the multitalk branch included)
_dit_block_sp = _SequenceShardedDiT.dit_block


def _rows(t, axis: MeshAxis):
    """This data rank's rows of a global-batch tensor (None stays None)."""
    if t is None:
        return None
    if t.shape[0] % axis.size:
        raise ValueError(f"batch {t.shape[0]} does not divide over {axis.size} data ranks")
    n = t.shape[0] // axis.size
    return t.narrow(0, axis.index * n, n)


def local_batch(data: MeshAxis, x, timestep, context, clip_feature, y, add_condition,
                audio_embed_tuple):
    """The 'data' rows of every batch input (a scalar timestep, or one of
    batch 1, is shared)."""
    if timestep.ndim and timestep.shape[0] == x.shape[0]:
        timestep = _rows(timestep, data)
    audio = None if audio_embed_tuple is None else tuple(_rows(a, data)
                                                         for a in audio_embed_tuple)
    return (_rows(x, data), timestep, _rows(context, data), _rows(clip_feature, data),
            _rows(y, data), _rows(add_condition, data), audio)


def sharded_forward(dit: WanDiT, view_for, x, timestep, context, clip_feature, y,
                    add_condition, *, data: MeshAxis, sp: MeshAxis, audio_embed_tuple=None,
                    **blocks_kw) -> torch.Tensor:
    """The body of `forward_sp` and `tp_sp.forward_tpsp`: the 'data' rows,
    the prelude, the tokens (and a customtalk carry) padded and sharded over
    sp, the block stack on `view_for(kv_len)`, the shard's head, the gathers.
    blocks_kw go to `forward_blocks`."""
    cfg = dit.cfg
    x, timestep, context, clip_feature, y, add_condition, audio = local_batch(
        data, x, timestep, context, clip_feature, y, add_condition, audio_embed_tuple)
    tokens, ctx, t, t_mod, grid = dit.forward_prelude(x, timestep, context, clip_feature, y,
                                                      add_condition)
    n_img = clip_feature.shape[1] if (cfg.has_image_input and clip_feature is not None) else 257
    b, S, d = tokens.shape
    shard = -(-S // sp.size)
    pad = shard * sp.size - S

    def my_rows(a):
        return F.pad(a, (0, 0, 0, pad)).narrow(1, sp.index * shard, shard)

    cos, sin = (F.pad(torch.from_numpy(a), (0, 0, 0, pad)).narrow(0, sp.index * shard, shard)
                .contiguous().to(tokens.device)
                for a in rope_angles_for_grid(tuple(grid), cfg.head_dim))
    audio_embed = None
    if cfg.has_audio and audio is not None:
        # AudioProjModel is tiny: it runs replicated
        audio_embed = dit.audio_proj_forward(*audio)
    cond = None
    if cfg.enable_customtalk and audio_embed is not None:
        cond = my_rows(add_condition.to(tokens.dtype) if add_condition is not None
                       else torch.zeros_like(tokens))
    tok = view_for(S).forward_blocks(my_rows(tokens), ctx, t_mod, grid, num_img_tokens=n_img,
                                     audio_embed=audio_embed, block_add_condition=cond,
                                     rope_tables=(cos, sin), **blocks_kw)
    out = gather_replicated(dit.apply_head(tok, t), sp, dim=1)[:, :S]
    return gather_replicated(dit.unpatchify(out, grid), data, dim=0)


def forward_sp(
    dit: WanDiT,
    x: torch.Tensor,
    timestep: torch.Tensor,
    context: torch.Tensor,
    clip_feature: Optional[torch.Tensor] = None,
    y: Optional[torch.Tensor] = None,
    add_condition: Optional[torch.Tensor] = None,
    *,
    mesh: Mesh,
    lora=None,
    lora_scale: float = 1.0,
    use_remat: bool = False,
    ring: bool = False,
    audio_embed_tuple=None,
    remat_granularity: Optional[int] = None,
    save_attention: bool = False,
    offload_carries: bool = False,
) -> torch.Tensor:
    """Sequence-parallel equivalent of `WanDiT.forward` on every rank of
    `mesh` ('data', 'sp'): the global batch in, the global output out (see
    the module's docstring). LoRA, remat (per block or in groups),
    save_attention, offloaded carries, the pose tokens (add_condition) and
    the multitalk / customtalk audio branches (audio_embed_tuple, projected
    replicated) as in `WanDiT.forward`. ring=True rotates k and v around the
    ring instead of gathering them (forward only). attention_quant does not
    apply here, as in the JAX package (its SP attention calls
    flash_attention without quant)."""
    axis = mesh["sp"]

    def view_for(kv_len):
        return _SequenceShardedDiT(dit, axis, kv_len, ring)

    return sharded_forward(dit, view_for, x, timestep, context, clip_feature, y, add_condition,
                           data=mesh["data"], sp=axis, audio_embed_tuple=audio_embed_tuple,
                           lora=lora, lora_scale=lora_scale, use_remat=use_remat,
                           remat_granularity=remat_granularity or 1,
                           save_attention=save_attention, offload_carries=offload_carries)
