"""FastBlend video deflickering and style blending, port of
svi_tpu/extensions/fastblend.py.

Patch-match temporal blending: a nearest-neighbour field (NNF) between
frames is estimated by coarse-to-fine PatchMatch (propagation and random
search), style frames are remapped through it, and windows of remapped
frames are blended (Fast mode: binary-lifting remapping tables).

The three patch operations (remap, patch error, pairwise patch error) are
gathers, computed by the JAX package in XLA outside Pallas; here they are
plain torch on the frames' device. Each gathers a chunk of patch offsets at
once and then adds the offsets' terms one by one in the JAX package's order,
so that on integer-valued frames the errors, and so the NNFs, are the JAX
package's bit for bit. The random search draws from the same numpy
Generator in the same order.

OpenCV is not used: the pyramid's INTER_AREA resample and the NNF's
INTER_LINEAR upscale (whose result is truncated to int32, so a last-bit
difference would move a match) follow OpenCV's float arithmetic
(`resize_area`, `resize_linear_cv`). Frames are (H, W, 3) uint8 arrays (a PIL
image is read through np.asarray). `update_nnf` offsets odd rows and columns
by one as intended, where the reference indexes rows by the batch size (the
JAX package's deliberate deviation, ROADMAP.md's known quirks).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

# one gathered chunk of patch offsets holds at most this many values
_CHUNK_VALUES = 1 << 28


# ---------------------------------------------------------------------------
# OpenCV's resizes in torch
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _area_weights(ssize: int, dsize: int) -> np.ndarray:
    """(dsize, ssize) f32 weights of OpenCV's `computeResizeAreaTab` (a
    shrink by ssize / dsize: each output cell averages the input pixels it
    covers, the partial ones by their covered share)."""
    scale = 1.0 / (dsize / ssize)
    out = np.zeros((dsize, ssize), np.float32)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        if sx1 - fsx1 > 1e-3:
            out[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            out[dx, sx] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            out[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return out


def resize_area(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W, C) f32 shrunk to (B, height, width, C) as cv2.resize with
    INTER_AREA does (to f32 rounding; the same size is a copy)."""
    b, h, w, c = images.shape
    if (h, w) == (height, width):
        return images
    dev = images.device
    wy = torch.from_numpy(_area_weights(h, height)).to(dev)
    wx = torch.from_numpy(_area_weights(w, width)).to(dev)
    x = images.permute(0, 3, 1, 2)
    return (wy @ (x @ wx.T)).permute(0, 2, 3, 1).contiguous()


@functools.lru_cache(maxsize=64)
def _linear_taps(ssize: int, dsize: int, clamp: bool):
    """OpenCV's INTER_LINEAR taps for one axis: source index, its neighbour
    (both clipped into the image) and the two f32 weights. Columns clamp an
    out-of-range position onto the border pixel with weight 1; rows keep the
    fraction and clip only the indices."""
    scale = 1.0 / (dsize / ssize)
    i0, a0, a1 = [], [], []
    for d in range(dsize):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = math.floor(f)
        f = np.float32(f - np.float32(s))
        if clamp and s < 0:
            f, s = np.float32(0), 0
        if clamp and s >= ssize - 1:
            f, s = np.float32(0), ssize - 1
        i0.append(s)
        a0.append(np.float32(1) - f)
        a1.append(f)
    i0 = np.asarray(i0)
    return (np.clip(i0, 0, ssize - 1), np.clip(i0 + 1, 0, ssize - 1),
            np.asarray(a0, np.float32), np.asarray(a1, np.float32))


def resize_linear_cv(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W, C) f32 resized to (B, height, width, C) as cv2.resize with
    INTER_LINEAR does for f32, bit for bit: the horizontal pass, then the
    vertical, each two f32 products and their f32 sum."""
    dev = images.device
    x0, x1, ax0, ax1 = (torch.from_numpy(t).to(dev)
                        for t in _linear_taps(images.shape[2], width, True))
    y0, y1, ay0, ay1 = (torch.from_numpy(t).to(dev)
                        for t in _linear_taps(images.shape[1], height, False))
    hor = images[:, :, x0] * ax0[None, None, :, None] + images[:, :, x1] * ax1[None, None, :, None]
    return hor[:, y0] * ay0[None, :, None, None] + hor[:, y1] * ay1[None, :, None, None]


# ---------------------------------------------------------------------------
# the patch operations (frames channels-last, padded by `pad`)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _offsets(patch_size: int, device: torch.device) -> tuple:
    """The patch offsets (px, py) in the JAX package's order, as Python
    ints and as (K,) int32 tensors on `device`."""
    r = (patch_size - 1) // 2
    pairs = [(px, py) for px in range(-r, r + 1) for py in range(-r, r + 1)]
    table = torch.tensor(pairs, dtype=torch.int32, device=device)
    return pairs, table[:, 0], table[:, 1]


def _chunks(patch_size: int, device, values_per_offset: int):
    """Runs of consecutive offsets, each gathered in one go: (the offsets,
    their px and py as (1, K, 1, 1) tensors)."""
    pairs, px, py = _offsets(patch_size, device)
    k = max(1, _CHUNK_VALUES // max(values_per_offset, 1))
    for i in range(0, len(pairs), k):
        view = lambda t: t[i:i + k].view(1, -1, 1, 1)
        yield pairs[i:i + k], view(px), view(py)


def _flat_rows(img_pad: torch.Tensor, xx: torch.Tensor, yy: torch.Tensor) -> torch.Tensor:
    """The rows of img_pad.reshape(-1, C) at padded-space indices xx, yy
    (B, ...) of each batch's image, int32 (a batch of frames has far fewer
    than 2^31 pixels)."""
    b, hp, wp, _ = img_pad.shape
    batch = torch.arange(b, device=xx.device, dtype=torch.int32).view(
        -1, *[1] * (xx.ndim - 1)) * (hp * wp)
    return (xx.int() * wp + yy.int()) + batch


def _rows(img_pad: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    c = img_pad.shape[-1]
    return img_pad.reshape(-1, c).index_select(0, rows.reshape(-1)).reshape(*rows.shape, c)


def _window(img_pad: torch.Tensor, pad: int, h: int, w: int, px: int, py: int) -> torch.Tensor:
    return img_pad[:, pad + px:pad + px + h, pad + py:pad + py + w]


def _windows(img_pad: torch.Tensor, pad: int, h: int, w: int, pairs) -> torch.Tensor:
    """The (h, w) windows of img_pad shifted by each offset: (B, K, h, w, C)."""
    return torch.stack([_window(img_pad, pad, h, w, px, py) for px, py in pairs], 1)


def _window_minus(img_pad: torch.Tensor, pad: int, h: int, w: int, pairs,
                  s: torch.Tensor) -> torch.Tensor:
    """s[:, k] replaced by the k-th offset's window of img_pad minus s[:, k]."""
    for k, (px, py) in enumerate(pairs):
        torch.sub(_window(img_pad, pad, h, w, px, py), s[:, k], out=s[:, k])
    return s


def _ssd(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, left to right, each step a fused
    multiply-add (`addcmul` rounds once, on the CPU and the card), as XLA's
    CPU code contracts the JAX package's `sum(d * d)`."""
    out = d[..., 0] * d[..., 0]
    for ch in range(1, d.shape[-1]):
        out = torch.addcmul(out, d[..., ch], d[..., ch])
    return out


def _sum_in_order(acc: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """acc + terms[:, 0] + terms[:, 1] + ..., one offset at a time."""
    for k in range(terms.shape[1]):
        acc = acc + terms[:, k]
    return acc


def apply_nnf_to_image(source_pad, nnf, patch_size: int, pad: int) -> torch.Tensor:
    """The remap: target[x, y] = the mean over the in-bounds patch
    neighbours (px, py) of source[nnf[x + px, y + py] - (px, py)]. Returns
    a padded target (zeros outside the interior)."""
    b, h, w = nnf.shape[:3]
    c = source_pad.shape[-1]
    r = (patch_size - 1) // 2
    nnf_pad = F.pad(nnf.permute(0, 3, 1, 2), (r, r, r, r), value=-10 ** 6).permute(0, 2, 3, 1)
    acc = source_pad.new_zeros((b, h, w, c))
    cnt = torch.zeros((b, h, w), dtype=torch.int64, device=nnf.device)
    for pairs, px, py in _chunks(patch_size, nnf.device, b * h * w * c):
        nn = _windows(nnf_pad, r, h, w, pairs)
        cx, cy = nn[..., 0] - px, nn[..., 1] - py
        xc, yc = cx.clamp(0, h - 1), cy.clamp(0, w - 1)
        valid = (xc == cx) & (yc == cy)
        g = torch.where(valid[..., None], _rows(source_pad, _flat_rows(source_pad, xc + pad,
                                                                       yc + pad)), 0.0)
        acc = _sum_in_order(acc, g)
        cnt += valid.sum(1)
    out = acc / cnt.to(acc.dtype).clamp_min(1.0)[..., None]
    return F.pad(out.permute(0, 3, 1, 2), (pad, pad, pad, pad)).permute(0, 2, 3, 1)


def patch_error(source_pad, nnf, target_pad, patch_size: int, pad: int) -> torch.Tensor:
    """The SSD between the target patch at (x, y) and the source patch at
    nnf[x, y]: (B, H, W) f32."""
    b, h, w = nnf.shape[:3]
    wp = source_pad.shape[2]
    base = _flat_rows(source_pad, nnf[..., 0] + pad, nnf[..., 1] + pad)[:, None]
    err = source_pad.new_zeros((b, h, w))
    for pairs, px, py in _chunks(patch_size, nnf.device, 3 * b * h * w * source_pad.shape[-1]):
        s = _rows(source_pad, base + (px * wp + py))
        err = _sum_in_order(err, _ssd(_window_minus(target_pad, pad, h, w, pairs, s)))
    return err


def pairwise_patch_error(source_a_pad, nnf_a, source_b_pad, nnf_b, patch_size: int,
                         pad: int) -> torch.Tensor:
    """The SSD between the two sources' patches at their NNF positions."""
    b, h, w = nnf_a.shape[:3]
    wp = source_a_pad.shape[2]
    base_a = _flat_rows(source_a_pad, nnf_a[..., 0] + pad, nnf_a[..., 1] + pad)[:, None]
    base_b = _flat_rows(source_b_pad, nnf_b[..., 0] + pad, nnf_b[..., 1] + pad)[:, None]
    err = source_a_pad.new_zeros((b, h, w))
    for _, px, py in _chunks(patch_size, nnf_a.device, 3 * b * h * w * source_a_pad.shape[-1]):
        shift = px * wp + py
        err = _sum_in_order(err, _ssd(_rows(source_a_pad, base_a + shift)
                                      - _rows(source_b_pad, base_b + shift)))
    return err


# ---------------------------------------------------------------------------
# PatchMatch
# ---------------------------------------------------------------------------


class PatchMatcher:
    def __init__(self, height, width, channel, minimum_patch_size, num_iter=5,
                 guide_weight=10.0, random_search_steps=3, random_search_range=4,
                 use_mean_target_style=False, use_pairwise_patch_error=False,
                 tracking_window_size=0, rng=None, **_unused):
        self.height = height
        self.width = width
        self.channel = channel
        self.num_iter = num_iter
        self.guide_weight = guide_weight
        self.random_search_steps = random_search_steps
        self.random_search_range = random_search_range
        self.use_mean_target_style = use_mean_target_style
        self.use_pairwise_patch_error = use_pairwise_patch_error
        self.tracking_window_size = tracking_window_size
        self.patch_size_list = [minimum_patch_size + i * 2 for i in range(num_iter)][::-1]
        self.pad_size = self.patch_size_list[0] // 2
        self.patch_size = self.patch_size_list[0]
        self.rng = rng or np.random.default_rng(0)

    def pad_image(self, image: torch.Tensor) -> torch.Tensor:
        p = self.pad_size
        return F.pad(image.float().permute(0, 3, 1, 2), (p, p, p, p)).permute(0, 2, 3, 1)

    def unpad_image(self, image):
        p = self.pad_size
        return image[:, p:-p, p:-p, :]

    def apply_nnf_to_image(self, nnf, source_pad):
        return apply_nnf_to_image(source_pad, nnf, self.patch_size, self.pad_size)

    def get_error(self, source_guide, target_guide, source_style, target_style, nnf):
        """The guide SSD times guide_weight plus the style SSD (the two in
        one batch where both are plain patch errors: the same arithmetic a
        batch element, half the launches)."""
        if not (self.use_mean_target_style or self.use_pairwise_patch_error):
            both = patch_error(torch.cat([source_guide, source_style]), torch.cat([nnf, nnf]),
                               torch.cat([target_guide, target_style]), self.patch_size,
                               self.pad_size)
            error_guide, error_style = both.chunk(2)
            return error_guide * self.guide_weight + error_style
        error_guide = patch_error(source_guide, nnf, target_guide, self.patch_size,
                                  self.pad_size)
        if self.use_mean_target_style:
            ts = self.apply_nnf_to_image(nnf, source_style)
            target_style = ts.mean(dim=0, keepdim=True).expand(source_guide.shape[0], -1, -1,
                                                               -1)
        if self.use_pairwise_patch_error:
            ea = pairwise_patch_error(source_style[0::2], nnf[0::2], source_style[1::2],
                                      nnf[1::2], self.patch_size, self.pad_size)
            error_style = ea.repeat_interleave(2, dim=0)
        else:
            error_style = patch_error(source_style, nnf, target_style, self.patch_size,
                                      self.pad_size)
        return error_guide * self.guide_weight + error_style

    def clamp_bound(self, nnf):
        return torch.stack([nnf[..., 0].clamp(0, self.height - 1),
                            nnf[..., 1].clamp(0, self.width - 1)], dim=-1)

    def random_step(self, nnf, r):
        step = self.rng.integers(-r, r + 1, size=tuple(nnf.shape)).astype(np.int32)
        return self.clamp_bound(nnf + torch.from_numpy(step).to(nnf.device))

    def neighboor_step(self, nnf, d):
        """The neighbour's NNF, shifted by one."""
        if d == 0:
            upd = torch.cat([nnf[:, :1], nnf[:, :-1]], 1) + _unit(nnf, 0, 1)
        elif d == 1:
            upd = torch.cat([nnf[:, :, :1], nnf[:, :, :-1]], 2) + _unit(nnf, 1, 1)
        elif d == 2:
            upd = torch.cat([nnf[:, 1:], nnf[:, -1:]], 1) + _unit(nnf, 0, -1)
        else:
            upd = torch.cat([nnf[:, :, 1:], nnf[:, :, -1:]], 2) + _unit(nnf, 1, -1)
        return self.clamp_bound(upd)

    def shift_nnf(self, nnf, d):
        if d > 0:
            d = min(nnf.shape[0], d)
            return torch.cat([nnf[d:]] + [nnf[-1:]] * d, 0)
        d = max(-nnf.shape[0], d)
        return torch.cat([nnf[:1]] * (-d) + [nnf[:d]], 0)

    def track_step(self, nnf, d):
        if self.use_pairwise_patch_error:
            upd = torch.zeros_like(nnf)
            upd[0::2] = self.shift_nnf(nnf[0::2], d)
            upd[1::2] = self.shift_nnf(nnf[1::2], d)
            return upd
        return self.shift_nnf(nnf, d)

    def update(self, sg, tg, ss, ts, nnf, err, upd_nnf):
        upd_err = self.get_error(sg, tg, ss, ts, upd_nnf)
        better = upd_err < err
        return torch.where(better[..., None], upd_nnf, nnf), torch.where(better, upd_err, err)

    def iteration(self, sg, tg, ss, ts, nnf, err):
        for d in self.rng.permutation(4):
            nnf, err = self.update(sg, tg, ss, ts, nnf, err, self.neighboor_step(nnf, int(d)))
        for _ in range(self.random_search_steps):
            nnf, err = self.update(sg, tg, ss, ts, nnf, err,
                                   self.random_step(nnf, self.random_search_range))
        for d in range(1, self.tracking_window_size + 1):
            nnf, err = self.update(sg, tg, ss, ts, nnf, err, self.track_step(nnf, d))
            nnf, err = self.update(sg, tg, ss, ts, nnf, err, self.track_step(nnf, -d))
        return nnf, err

    def estimate_nnf(self, source_guide, target_guide, source_style, nnf):
        sg = self.pad_image(source_guide)
        tg = self.pad_image(target_guide)
        ss = self.pad_image(source_style)
        for it in range(self.num_iter):
            self.patch_size = self.patch_size_list[it]
            ts = self.apply_nnf_to_image(nnf, ss)
            err = self.get_error(sg, tg, ss, ts, nnf)
            nnf, err = self.iteration(sg, tg, ss, ts, nnf, err)
        return nnf, self.unpad_image(self.apply_nnf_to_image(nnf, ss))


def _unit(nnf, axis: int, value: int) -> torch.Tensor:
    """value on NNF component `axis`, 0 on the other."""
    u = [0, 0]
    u[axis] = value
    return torch.tensor(u, dtype=nnf.dtype, device=nnf.device)


class PyramidPatchMatcher:
    """Coarse-to-fine PatchMatch over a pyramid of h // 2^k sizes, on `device`."""

    def __init__(self, image_height, image_width, channel, minimum_patch_size,
                 num_iter=5, guide_weight=10.0, use_mean_target_style=False,
                 use_pairwise_patch_error=False, tracking_window_size=0,
                 initialize="identity", seed=0, device="cuda", **_unused):
        maximum_patch_size = minimum_patch_size + (num_iter - 1) * 2
        self.pyramid_level = max(
            1, int(np.log2(min(image_height, image_width) / maximum_patch_size)))
        self.initialize = initialize
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.pyramid_heights, self.pyramid_widths, self.patch_matchers = [], [], []
        for level in range(self.pyramid_level):
            h = image_height // (2 ** (self.pyramid_level - 1 - level))
            w = image_width // (2 ** (self.pyramid_level - 1 - level))
            self.pyramid_heights.append(h)
            self.pyramid_widths.append(w)
            self.patch_matchers.append(PatchMatcher(
                h, w, channel, minimum_patch_size, num_iter=num_iter,
                guide_weight=guide_weight, use_mean_target_style=use_mean_target_style,
                use_pairwise_patch_error=use_pairwise_patch_error,
                tracking_window_size=tracking_window_size, rng=self.rng))

    def resample_image(self, images: torch.Tensor, level) -> torch.Tensor:
        return resize_area(images, self.pyramid_heights[level], self.pyramid_widths[level])

    def initialize_nnf(self, batch_size) -> torch.Tensor:
        h, w = self.pyramid_heights[0], self.pyramid_widths[0]
        if self.initialize == "random":
            nnf = np.stack([self.rng.integers(0, h, (batch_size, h, w)),
                            self.rng.integers(0, w, (batch_size, h, w))], axis=3)
        elif self.initialize == "identity":
            nnf = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), axis=2)
            nnf = np.stack([nnf] * batch_size)
        else:
            raise NotImplementedError(self.initialize)
        return torch.from_numpy(nnf.astype(np.int32)).to(self.device)

    def update_nnf(self, nnf, level) -> torch.Tensor:
        """The NNF upscaled to the next level: doubled, odd rows and columns
        offset by one, then resized to the level's size where it differs."""
        nnf = nnf.repeat_interleave(2, 1).repeat_interleave(2, 2) * 2
        nnf[:, 1::2, :, 0] += 1
        nnf[:, :, 1::2, 1] += 1
        h, w = self.pyramid_heights[level], self.pyramid_widths[level]
        if (h, w) != tuple(nnf.shape[1:3]):
            nnf = resize_linear_cv(nnf.float(), h, w).to(torch.int32)
            nnf = self.patch_matchers[level].clamp_bound(nnf)
        return nnf

    def estimate_nnf(self, source_guide, target_guide, source_style):
        """(B, H, W, C) stacks (numpy or torch) -> (nnf, target_style) as numpy."""
        as_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(self.device)
        source_guide, target_guide, source_style = map(as_dev, (source_guide, target_guide,
                                                                source_style))
        nnf = target_style = None
        for level in range(self.pyramid_level):
            nnf = (self.initialize_nnf(source_guide.shape[0]) if level == 0
                   else self.update_nnf(nnf, level))
            sg = self.resample_image(source_guide, level)
            tg = self.resample_image(target_guide, level)
            ss = self.resample_image(source_style, level)
            nnf, target_style = self.patch_matchers[level].estimate_nnf(sg, tg, ss, nnf)
        return nnf.cpu().numpy(), target_style.cpu().numpy()


# ---------------------------------------------------------------------------
# Fast mode's tables, and the smoother
# ---------------------------------------------------------------------------


class TableManager:
    """Binary-lifting remapping tables for Fast mode (host numpy, as the JAX
    package keeps them)."""

    def task_list(self, n):
        tasks = []
        max_level = 1
        while (1 << max_level) <= n:
            max_level += 1
        for i in range(n):
            j = i
            for level in range(max_level):
                if i & (1 << level):
                    continue
                j |= 1 << level
                if j >= n:
                    break
                tasks.append({"source": i, "target": j, "level": level + 1})
        tasks.sort(key=functools.cmp_to_key(lambda u, v: u["level"] - v["level"]))
        return tasks

    def build_remapping_table(self, frames_guide, frames_style, engine, batch_size):
        n = len(frames_guide)
        tasks = self.task_list(n)
        table = [[(np.asarray(frames_style[i], np.float32), 1)] for i in range(n)]
        for b0 in range(0, len(tasks), batch_size):
            batch = tasks[b0:b0 + batch_size]
            sg = np.stack([frames_guide[t["source"]] for t in batch])
            tg = np.stack([frames_guide[t["target"]] for t in batch])
            ss = np.stack([frames_style[t["source"]] for t in batch])
            _, ts = engine.estimate_nnf(sg, tg, ss)
            for t, result in zip(batch, ts):
                target, level = t["target"], t["level"]
                if len(table[target]) == level:
                    table[target].append((result, 1))
                else:
                    frame, weight = table[target][level]
                    table[target][level] = (
                        frame * (weight / (weight + 1)) + result / (weight + 1), weight + 1)
        return table

    def remapping_table_to_blending_table(self, table):
        for i in range(len(table)):
            for j in range(1, len(table[i])):
                f1, w1 = table[i][j - 1]
                f2, w2 = table[i][j]
                table[i][j] = ((f1 + f2) / 2, w1 + w2)
        return table

    def tree_query(self, leftbound, rightbound):
        node_list = []
        node_index = rightbound
        while node_index >= leftbound:
            node_level = 0
            while (1 << node_level) & node_index and \
                    node_index - (1 << (node_level + 1)) + 1 >= leftbound:
                node_level += 1
            node_list.append((node_index, node_level))
            node_index -= 1 << node_level
        return node_list

    def process_window_sum(self, frames_guide, blending_table, engine, window_size,
                           batch_size):
        n = len(blending_table)
        tasks, frames_result = [], []
        for target in range(n):
            for source, level in self.tree_query(max(target - window_size, 0), target):
                if source != target:
                    tasks.append({"source": source, "target": target, "level": level})
                else:
                    frames_result.append(blending_table[target][level])
        for b0 in range(0, len(tasks), batch_size):
            batch = tasks[b0:b0 + batch_size]
            sg = np.stack([frames_guide[t["source"]] for t in batch])
            tg = np.stack([frames_guide[t["target"]] for t in batch])
            ss = np.stack([blending_table[t["source"]][t["level"]][0] for t in batch])
            _, ts = engine.estimate_nnf(sg, tg, ss)
            for t, f2 in zip(batch, ts):
                source, target, level = t["source"], t["target"], t["level"]
                f1, w1 = frames_result[target]
                w2 = blending_table[source][level][1]
                w = w1 + w2
                frames_result[target] = (f1 * (w1 / w) + f2 * (w2 / w), w)
        return frames_result


class FastBlendSmoother:
    """Bidirectional Fast-mode blending of rendered frames, guided by the
    original frames; PatchMatch runs on `device`."""

    def __init__(self, batch_size=8, window_size=64, ebsynth_config=None, device="cuda"):
        self.batch_size = batch_size
        self.window_size = window_size
        self.device = device
        self.ebsynth_config = ebsynth_config or {
            "minimum_patch_size": 5,
            "num_iter": 5,
            "guide_weight": 10.0,
            "initialize": "identity",
            "tracking_window_size": 0,
        }

    @staticmethod
    def from_model_manager(model_manager, **kwargs):
        """No weights: the manager gives only its device (the card without one)."""
        if model_manager is not None:
            kwargs.setdefault("device", model_manager.device)
        return FastBlendSmoother(**kwargs)

    def run(self, frames_guide, frames_style, batch_size, window_size, cfg):
        frames_guide = [np.asarray(f, np.float32) for f in frames_guide]
        frames_style = [np.asarray(f, np.float32) for f in frames_style]
        tm = TableManager()
        engine = PyramidPatchMatcher(image_height=frames_style[0].shape[0],
                                     image_width=frames_style[0].shape[1], channel=3,
                                     device=self.device, **cfg)
        table_l = tm.build_remapping_table(frames_guide, frames_style, engine, batch_size)
        table_l = tm.remapping_table_to_blending_table(table_l)
        table_l = tm.process_window_sum(frames_guide, table_l, engine, window_size, batch_size)
        table_r = tm.build_remapping_table(frames_guide[::-1], frames_style[::-1], engine,
                                           batch_size)
        table_r = tm.remapping_table_to_blending_table(table_r)
        table_r = tm.process_window_sum(frames_guide[::-1], table_r, engine, window_size,
                                        batch_size)[::-1]
        frames = []
        for (f_l, w_l), f_m, (f_r, w_r) in zip(table_l, frames_style, table_r):
            w_m = -1
            w = w_l + w_m + w_r
            frames.append(f_l * (w_l / w) + f_m * (w_m / w) + f_r * (w_r / w))
        return [np.clip(f, 0, 255).astype(np.uint8) for f in frames]

    def __call__(self, rendered_frames, original_frames=None, **kwargs):
        return self.run(original_frames, rendered_frames, self.batch_size, self.window_size,
                        self.ebsynth_config)
