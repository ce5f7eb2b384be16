"""Multi-speaker (MultiTalk) helpers (port of svi_tpu/utils/multitalk.py).

  * reference-attention maps: the affinity of each video token to each
    speaker's face region in the first frame, from the self-attention's q
    and k (`calculate_x_ref_attn_map`, `get_attn_map_with_target`);
  * 1-D RoPE with fractional speaker class labels (`rope_1d`), which
    `WanDiT.single_stream_multi_attention` uses to bind each video token's
    audio attention to its speaker;
  * adaptive projected guidance (`MomentumBuffer`, `project`,
    `adaptive_projected_guidance`);
  * the sequence-parallel token / frame split bookkeeping.

The SVI pipelines run the single-speaker path only, as in the JAX package;
these are the inherited MultiTalk capabilities. f32 throughout, plain torch.
"""

from __future__ import annotations

import torch


def split_token_counts_and_frame_ids(T: int, token_frame: int, world_size: int, rank: int):
    """Token counts per frame and the frame ids present in `rank`'s
    contiguous slice of T * token_frame tokens split over world_size."""
    S = T * token_frame
    split_sizes = [S // world_size + (1 if i < S % world_size else 0) for i in range(world_size)]
    start = sum(split_sizes[:rank])
    end = start + split_sizes[rank]
    counts = [0] * T
    for idx in range(start, end):
        counts[idx // token_frame] += 1
    counts_filtered, frame_ids = [], []
    for t, c in enumerate(counts):
        if c > 0:
            counts_filtered.append(c)
            frame_ids.append(t)
    return counts_filtered, frame_ids


def normalize_and_scale(column, source_range, target_range, epsilon=1e-8):
    """Affine rescale of `column` from source_range to target_range."""
    source_min, source_max = source_range
    new_min, new_max = target_range
    normalized = (column - source_min) / (source_max - source_min + epsilon)
    return normalized * (new_max - new_min) + new_min


def calculate_x_ref_attn_map(visual_q: torch.Tensor, ref_k: torch.Tensor,
                             ref_target_masks: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """visual_q (B, S, H, D), ref_k (B, S_ref, H, D), ref_target_masks (C,
    S_ref) 0/1 -> (C * B, S): the softmax attention of each video token onto
    each speaker's region, summed over the region's tokens over its size,
    then the mean (or max) over heads."""
    scale = 1.0 / visual_q.shape[-1] ** 0.5
    q = (visual_q.float() * scale).transpose(1, 2)  # B H S D
    k = ref_k.float().transpose(1, 2)
    probs = torch.softmax(torch.einsum("bhsd,bhrd->bhsr", q, k), dim=-1)
    masks = ref_target_masks.float()
    per_class = torch.einsum("bhsr,cr->cbhs", probs, masks) / masks.sum(-1)[:, None, None, None]
    if mode == "mean":
        out = per_class.mean(2)
    elif mode == "max":
        out = per_class.amax(2)
    else:
        raise ValueError(mode)
    c, b, s = out.shape
    return out.reshape(c * b, s)


def get_attn_map_with_target(visual_q, ref_k, grid, ref_target_masks, split_num=2):
    """The reference attention map against the first frame's h * w tokens of
    ref_k. The reference splits the heads into split_num chunks only to
    bound memory and averages them: the plain mean over heads, computed
    here at once."""
    _, h, w = grid
    return calculate_x_ref_attn_map(visual_q, ref_k[:, :h * w], ref_target_masks)


def rope_1d(x: torch.Tensor, pos: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """1-D rotary embedding of x (B, H, S, D) at positions pos (S,), which
    may be fractional class labels: interleaved pairs, each pair's angle
    repeated for both of its channels; computed in f32, returned in x's
    dtype."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device)[: d // 2].float() / d))
    ang = pos.float()[:, None] * freqs[None, :]  # (S, D/2)
    cos = torch.repeat_interleave(torch.cos(ang), 2, dim=-1)[None, None]
    sin = torch.repeat_interleave(torch.sin(ang), 2, dim=-1)[None, None]
    xf = x.float()
    x2 = xf.unflatten(-1, (d // 2, 2))
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(xf.shape)
    return (xf * cos + rot * sin).to(x.dtype)


class MomentumBuffer:
    """Running average of the CFG difference."""

    def __init__(self, momentum: float):
        self.momentum = momentum
        self.running_average = 0

    def update(self, update_value):
        self.running_average = update_value + self.momentum * self.running_average


def project(v0: torch.Tensor, v1: torch.Tensor):
    """v0's components parallel and orthogonal to v1 over the last four axes
    (C, T, H, W), in f32 (the reference's f64; the JAX package's f32),
    returned in v0's dtype."""
    dtype = v0.dtype
    v0d, v1d = v0.float(), v1.float()
    axes = tuple(range(v1d.ndim - 4, v1d.ndim))
    v1n = v1d / torch.sqrt((v1d * v1d).sum(axes, keepdim=True)).clamp_min(1e-12)
    v0_parallel = (v0d * v1n).sum(axes, keepdim=True) * v1n
    v0_orthogonal = v0d - v0_parallel
    return v0_parallel.to(dtype), v0_orthogonal.to(dtype)


def adaptive_projected_guidance(diff: torch.Tensor, pred_cond: torch.Tensor,
                                momentum_buffer: MomentumBuffer | None = None,
                                eta: float = 0.0, norm_threshold: float = 55.0) -> torch.Tensor:
    """APG: the CFG difference (through the momentum buffer when given)
    rescaled to a norm of at most norm_threshold, then its component
    orthogonal to the conditional prediction plus eta of the parallel one."""
    if momentum_buffer is not None:
        momentum_buffer.update(diff)
        diff = momentum_buffer.running_average
    if norm_threshold > 0:
        axes = tuple(range(diff.ndim - 4, diff.ndim))
        diff_norm = torch.sqrt((diff.float() ** 2).sum(axes, keepdim=True))
        scale_factor = torch.clamp(norm_threshold / diff_norm.clamp_min(1e-12), max=1.0)
        diff = diff * scale_factor.to(diff.dtype)
    diff_parallel, diff_orthogonal = project(diff, pred_cond)
    return diff_orthogonal + eta * diff_parallel
