"""Feathered spatial tiling for memory-bound forwards, port of
svi_tpu/models/tiler.py, in its channels-last layouts ((B, H, W, C) and
(B, T, H, W, C)):

  * `tiled_forward`: every full window at stride `tile_stride` (unfold
    positions), the forward on batches of tiles, then a fold weighted by a
    border mask (a linear ramp of `tile_stride // 2` pixels, at the output
    scale when the forward changes resolution); pixels no window covers
    come out 0;
  * `fast_tiled_forward`: a stride grid clamped at the edges, the forward
    given tile coordinates, masks whose ramp is (h + w) // 4 and full on
    sides that touch the tensor's border;
  * `tiled_forward_2dto3d`: the same grid over the (H, W) plane of a video
    tensor, the forward mapping a full-T tile to per-axis output scales.

Sums are f32 whatever the compute dtype.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["tiled_forward", "fast_tiled_forward", "tiled_forward_2dto3d"]


def _border_mask(h, w, border_width):
    """Centre 1, a linear ramp of `border_width` pixels at every side."""
    x = np.arange(h)[:, None]
    y = np.arange(w)[None, :]
    m = np.minimum(np.minimum(x + 1, h - x), np.minimum(y + 1, w - y))
    return np.clip(m / max(border_width, 1), 0.0, 1.0).astype(np.float32)


def _clamped_mask(h, w, is_bound, border_width=None):
    """A ramp clipped to [1, border] / border; sides on the tensor's border
    (is_bound: top, bottom, left, right) get full weight."""
    bw = max((h + w) // 4 if border_width is None else border_width, 1)
    x = np.arange(h)[:, None] * np.ones((1, w))
    y = np.arange(w)[None, :] * np.ones((h, 1))
    pad = np.full((h, w), bw, np.float64)
    m = np.stack([pad if is_bound[0] else x + 1, pad if is_bound[1] else h - x,
                  pad if is_bound[2] else y + 1, pad if is_bound[3] else w - y]).min(axis=0)
    return (np.clip(m, 1, bw) / bw).astype(np.float32)


def _unfold_positions(size, tile_size, tile_stride):
    return list(range(0, size - tile_size + 1, tile_stride))


def _mask(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(arr).to(like.device)


def tiled_forward(forward_fn, x, tile_size, tile_stride, tile_batch_size=1, border_width=None):
    """forward_fn: (N, ts, ts, C) -> (N, ts', ts', C') on (B, H, W, C) tiles;
    a uniform output scale ts'/ts folds at the scaled geometry."""
    b, h, w, c = x.shape
    bw = int(tile_stride * 0.5) if border_width is None else border_width
    rows = _unfold_positions(h, tile_size, tile_stride)
    cols = _unfold_positions(w, tile_size, tile_stride)
    pos = [(i, j) for i in rows for j in cols]
    outs = []
    for k in range(0, len(pos), tile_batch_size):
        chunk = torch.cat([x[:, i:i + tile_size, j:j + tile_size, :]
                           for i, j in pos[k:k + tile_batch_size]], dim=0)
        y = forward_fn(chunk)
        outs.append(y.reshape(-1, b, *y.shape[1:]))
    out = torch.cat(outs, dim=0)  # (n_tiles, b, ts', ts', c')
    ts_o = out.shape[2]
    io = ts_o / tile_size
    h_o, w_o = int(h * io), int(w * io)
    stride_o, bw_o = int(tile_stride * io), int(bw * io)
    rows_o = _unfold_positions(h_o, ts_o, stride_o)
    cols_o = _unfold_positions(w_o, ts_o, stride_o)
    assert len(rows_o) == len(rows) and len(cols_o) == len(cols), (
        f"non-integer io_scale {io} breaks fold alignment")
    mask = _mask(_border_mask(ts_o, ts_o, bw_o), x)[None, :, :, None]
    acc = torch.zeros((b, h_o, w_o, out.shape[-1]), dtype=torch.float32, device=x.device)
    wacc = torch.zeros((1, h_o, w_o, 1), dtype=torch.float32, device=x.device)
    for k, (i, j) in enumerate([(i, j) for i in rows_o for j in cols_o]):
        acc[:, i:i + ts_o, j:j + ts_o, :] += out[k].float() * mask
        wacc[:, i:i + ts_o, j:j + ts_o, :] += mask
    return (acc / wacc.clamp_min(1e-6)).to(x.dtype)


def _clamped_tasks(h, w, tile_size, tile_stride, floor_zero=False):
    """A stride grid (per-axis strides) with tiles clamped at the far edges
    and no final tile that the one before already reaches past the edge."""
    tasks = []
    for i in range(0, h, tile_stride[0]):
        for j in range(0, w, tile_stride[1]):
            if (i - tile_stride[0] >= 0 and i - tile_stride[0] + tile_size[0] >= h) or \
               (j - tile_stride[1] >= 0 and j - tile_stride[1] + tile_size[1] >= w):
                continue
            hl, wl, hr, wr = i, j, i + tile_size[0], j + tile_size[1]
            if hr > h:
                hl, hr = (max(h - tile_size[0], 0) if floor_zero else h - tile_size[0]), h
            if wr > w:
                wl, wr = (max(w - tile_size[1], 0) if floor_zero else w - tile_size[1]), w
            tasks.append((hl, hr, wl, wr))
    return tasks


def fast_tiled_forward(forward_fn, x, tile_size, tile_stride, border_width=None):
    """forward_fn(hl, hr, wl, wr) -> the processed (B, hr - hl, wr - wl, C)
    tile (the caller slices its own inputs). The feather width is always
    (tile_h + tile_w) // 4: border_width is not read, as in the JAX package."""
    b, h, w, c = x.shape
    tasks = _clamped_tasks(h, w, (tile_size, tile_size), (tile_stride, tile_stride))
    acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=x.device)
    wacc = torch.zeros((1, h, w, 1), dtype=torch.float32, device=x.device)
    for hl, hr, wl, wr in tasks:
        y = forward_fn(hl, hr, wl, wr).float()
        mask = _mask(_clamped_mask(hr - hl, wr - wl,
                                   is_bound=(hl == 0, hr >= h, wl == 0, wr >= w)),
                     x)[None, :, :, None]
        acc[:, hl:hr, wl:wr, :] += y * mask
        wacc[:, hl:hr, wl:wr, :] += mask
    return (acc / wacc).to(x.dtype)


def tiled_forward_2dto3d(forward_fn, x, tile_size, tile_stride, scales=(1, 1, 1, 1),
                         border_width=None, progress_bar=lambda t: t):
    """Tiles the (H, W) plane of (B, T, H, W, C); forward_fn maps a full-T
    tile (B, T, h, w, C) -> (B, T*sT, h*sH, w*sW, C*sC), scales = (sC, sT,
    sH, sW)."""
    b, t, h, w, c = x.shape
    s_c, s_t, s_h, s_w = scales
    t_o, h_o, w_o, c_o = int(t * s_t), int(h * s_h), int(w * s_w), int(c * s_c)
    tasks = _clamped_tasks(h, w, tile_size, tile_stride, floor_zero=True)
    acc = torch.zeros((b, t_o, h_o, w_o, c_o), dtype=torch.float32, device=x.device)
    wacc = torch.zeros((1, t_o, h_o, w_o, 1), dtype=torch.float32, device=x.device)
    for hl, hr, wl, wr in progress_bar(tasks):
        y = forward_fn(x[:, :, hl:hr, wl:wr, :]).float()
        mask = _mask(_clamped_mask(int((hr - hl) * s_h), int((wr - wl) * s_w),
                                   is_bound=(hl == 0, hr >= h, wl == 0, wr >= w),
                                   border_width=border_width), x)[None, None, :, :, None]
        ho_l, ho_r = int(hl * s_h), int(hr * s_h)
        wo_l, wo_r = int(wl * s_w), int(wr * s_w)
        acc[:, :, ho_l:ho_r, wo_l:wo_r, :] += y * mask
        wacc[:, :, ho_l:ho_r, wo_l:wo_r, :] += mask
    return (acc / wacc).to(x.dtype)
