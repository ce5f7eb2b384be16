"""Wan 2.1 causal 3D video VAE: untiled encode and decode, f32.

Port of svi_tpu/models/wan_vae.py (`encode`, `decode`) in PyTorch's NCDHW
layout with `F.conv3d` (f32 convolutions in f32, TF32 off:
`ops.conv.conv_f32`). Every causal 3x3x3 conv carries a cache of its last
two input frames (zeros at stream start); the encoder consumes 1 + 4k frames
as a first frame then chunks, the decoder one latent frame then chunks, with
chunk sizes from `_pick_chunk` as in the JAX package. The mid-block spatial
attention goes through the port's flash kernel. `tiled_encode` /
`tiled_decode` run it on overlapping spatial tiles blended with feathered
masks, and `params_from_torch_state_dict` reads the reference's checkpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..ops.conv import conv_f32
from ..ops.norms import channel_rms_norm
from .params import Init, ParamTree, convert_tree

CACHE_T = 2

# Per-channel latent normalization (reference wan_video_vae.py:604-614).
LATENT_MEAN = np.array([
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
], dtype=np.float32)
LATENT_STD = np.array([
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    dim: int = 96
    z_dim: int = 16
    dim_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: tuple[bool, ...] = (False, True, True)
    dtype: torch.dtype = torch.float32

    @property
    def temporal_upsample(self):
        return self.temporal_downsample[::-1]


WAN_VAE = WanVAEConfig()


# ---------------------------------------------------------------------------
# Primitive layers (x is (b, c, t, h, w))
# ---------------------------------------------------------------------------


def _conv3d(p, x, stride=(1, 1, 1), spatial_pad=None):
    """Conv without time padding (the caches supply the causal frames)."""
    kh, kw = p["w"].shape[3:]
    if spatial_pad is None:
        spatial_pad = (kh // 2, kw // 2)
    return conv_f32(F.conv3d, x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride=stride,
                    padding=(0, *spatial_pad))


def causal_conv3d(p, x, cache, stride=(1, 1, 1)):
    """Causal 3D conv with an explicit 2-frame input cache. Returns (y, new_cache)."""
    if p["w"].shape[2] == 1:
        return _conv3d(p, x, stride), cache
    x_in = torch.cat([cache, x], dim=2)
    return _conv3d(p, x_in, stride), x_in[:, :, -CACHE_T:]


def _conv2d(p, x, stride=1, padding=None):
    """Per-frame 2D conv: a conv3d with a time kernel of one."""
    w = p["w"]  # (out, in, kh, kw)
    if padding is None:
        padding = w.shape[2] // 2  # 'SAME' for the odd, stride-1 kernels used here
    return conv_f32(F.conv3d, x, w[:, :, None].to(x.dtype), p["b"].to(x.dtype),
                    stride=(1, stride, stride), padding=(0, padding, padding))


def _rms_norm_video(p, x):
    return channel_rms_norm(x, p["gamma"].reshape(-1, 1, 1, 1), channel_axis=1)


def residual_block(p, x, caches, idx):
    h = _conv3d(p["shortcut"], x) if "shortcut" in p else x
    y = F.silu(_rms_norm_video(p["norm1"], x))
    y, caches[idx] = causal_conv3d(p["conv1"], y, caches[idx])
    y = F.silu(_rms_norm_video(p["norm2"], y))
    y, caches[idx + 1] = causal_conv3d(p["conv2"], y, caches[idx + 1])
    return y + h, idx + 2


def attention_block(p, x):
    """Single-head per-frame spatial self-attention through the flash kernel."""
    b, c, t, h, w = x.shape
    y = _rms_norm_video(p["norm"], x)
    qkv = _conv2d(p["to_qkv"], y)  # (b, 3c, t, h, w)
    # channels last, materialized: the kernel reads rows with a unit channel stride
    qkv = qkv.permute(0, 2, 3, 4, 1).reshape(b * t, h * w, 3 * c).contiguous()
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    o = flash_attention(q[:, :, None], k[:, :, None], v[:, :, None])[:, :, 0]
    o = o.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
    return x + _conv2d(p["proj"], o)


def resample(p, mode, x, caches, idx, first):
    b, c, t, h, w = x.shape
    if mode == "upsample3d":
        # temporal part first: the conv doubles channels, which become frame pairs
        if not first:
            y, caches[idx] = causal_conv3d(p["time_conv"], x, caches[idx])
            y = y.reshape(b, 2, c, t, h, w).permute(0, 2, 3, 1, 4, 5)
            x = y.reshape(b, c, t * 2, h, w)
        idx += 1
    if mode in ("upsample2d", "upsample3d"):
        x = x.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)  # nearest-exact 2x
        x = _conv2d(p["conv"], x)
    elif mode in ("downsample2d", "downsample3d"):
        x = F.pad(x, (0, 1, 0, 1))  # ZeroPad2d((0, 1, 0, 1))
        x = _conv2d(p["conv"], x, stride=2, padding=0)
    if mode == "downsample3d":
        # temporal part after spatial: 1-frame cache, stride 2
        if first:
            caches[idx] = x[:, :, -1:]
        else:
            x_in = torch.cat([caches[idx], x], dim=2)
            caches[idx] = x_in[:, :, -1:]
            x = _conv3d(p["time_conv"], x_in, stride=(2, 1, 1), spatial_pad=(0, 0))
        idx += 1
    return x, idx


# ---------------------------------------------------------------------------
# Plans (static layer lists derived from the config)
# ---------------------------------------------------------------------------


def encoder_plan(cfg: WanVAEConfig):
    dims = [cfg.dim * u for u in (1,) + tuple(cfg.dim_mult)]
    plan = [("conv_in", 3, dims[0])]
    for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
        d = in_dim
        for _ in range(cfg.num_res_blocks):
            plan.append(("res", d, out_dim))
            d = out_dim
        if i != len(cfg.dim_mult) - 1:
            mode = "downsample3d" if cfg.temporal_downsample[i] else "downsample2d"
            plan.append((mode, out_dim, out_dim))
    out_dim = dims[-1]
    plan += [("res", out_dim, out_dim), ("attn", out_dim, out_dim), ("res", out_dim, out_dim)]
    plan.append(("head", out_dim, cfg.z_dim * 2))
    return plan


def decoder_plan(cfg: WanVAEConfig):
    dims = [cfg.dim * u for u in (cfg.dim_mult[-1],) + tuple(cfg.dim_mult[::-1])]
    plan = [("conv_in", cfg.z_dim, dims[0])]
    plan += [("res", dims[0], dims[0]), ("attn", dims[0], dims[0]), ("res", dims[0], dims[0])]
    for i, (in_dim, out_dim) in enumerate(zip(dims[:-1], dims[1:])):
        if i in (1, 2, 3):
            in_dim = in_dim // 2
        d = in_dim
        for _ in range(cfg.num_res_blocks + 1):
            plan.append(("res", d, out_dim))
            d = out_dim
        if i != len(cfg.dim_mult) - 1:
            mode = "upsample3d" if cfg.temporal_upsample[i] else "upsample2d"
            plan.append((mode, out_dim, out_dim // 2))
    plan.append(("head", dims[-1], 3))
    return plan


def _cache_specs(plan, b, h, w):
    """(c, t, h, w) of each cache slot, in the order the plan uses them."""
    specs = []
    ch, cw = h, w
    for kind, cin, cout in plan:
        if kind in ("conv_in", "head"):
            specs.append((cin, CACHE_T, ch, cw))
        elif kind == "res":
            specs += [(cin, CACHE_T, ch, cw), (cout, CACHE_T, ch, cw)]
        elif kind == "downsample2d":
            ch, cw = ch // 2, cw // 2
        elif kind == "downsample3d":
            ch, cw = ch // 2, cw // 2
            specs.append((cout, 1, ch, cw))
        elif kind == "upsample3d":
            specs.append((cin, CACHE_T, ch, cw))
            ch, cw = ch * 2, cw * 2
        elif kind == "upsample2d":
            ch, cw = ch * 2, cw * 2
    return [(b,) + s for s in specs]


def _pick_chunk(n_steps: int, requested: int) -> int:
    """Largest divisor of n_steps that is <= requested."""
    for c in range(min(requested, n_steps), 0, -1):
        if n_steps % c == 0:
            return c
    return 1


class WanVAE(ParamTree):
    def __init__(self, cfg: WanVAEConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def _run_plan(self, plan, layers, x, caches, first):
        idx = 0
        for (kind, _, _), p in zip(plan, layers):
            if kind == "conv_in":
                x, caches[idx] = causal_conv3d(p["conv"], x, caches[idx])
                idx += 1
            elif kind == "res":
                x, idx = residual_block(p, x, caches, idx)
            elif kind == "attn":
                x = attention_block(p, x)
            elif kind == "head":
                x = F.silu(_rms_norm_video(p["norm"], x)).float()
                x, caches[idx] = causal_conv3d(p["conv"], x, caches[idx])
                idx += 1
            else:
                x, idx = resample(p, kind, x, caches, idx, first)
        return x

    def _latent_scale(self, device):
        cfg = self.cfg
        mean = LATENT_MEAN if cfg.z_dim == 16 else np.zeros(cfg.z_dim, np.float32)
        std = LATENT_STD if cfg.z_dim == 16 else np.ones(cfg.z_dim, np.float32)
        shape = (1, cfg.z_dim, 1, 1, 1)
        return (torch.from_numpy(mean).to(device).reshape(shape),
                torch.from_numpy(std).to(device).reshape(shape))

    def _stream(self, plan, layers, x, frames_first, frames_per_step, time_chunk):
        """Run x (b, c, T, h, w) through `plan`: the first `frames_first`
        frames, then the rest in chunks of `frames_per_step * chunk` frames."""
        b, _, T, h, w = x.shape
        caches = [torch.zeros(s, dtype=x.dtype, device=x.device)
                  for s in _cache_specs(plan, b, h, w)]
        outs = [self._run_plan(plan, layers, x[:, :, :frames_first], caches, first=True)]
        n_steps = (T - frames_first) // frames_per_step
        if n_steps > 0:
            step = frames_per_step * _pick_chunk(n_steps, time_chunk)
            for t0 in range(frames_first, T, step):
                outs.append(self._run_plan(plan, layers, x[:, :, t0:t0 + step], caches,
                                           first=False))
        return torch.cat(outs, dim=2)

    def encode(self, video: torch.Tensor, time_chunk: int = 2) -> torch.Tensor:
        """video (b, 3, T, H, W) in [-1, 1], T = 1 + 4k -> normalized latents
        (b, z, 1 + k, H/8, W/8)."""
        cfg = self.cfg
        if video.shape[2] % 4 != 1:
            raise ValueError(f"encoder expects 1+4k frames, got {video.shape[2]}")
        x = video.to(cfg.dtype)
        out = self._stream(encoder_plan(cfg), self["encoder"], x, 1, 4, time_chunk)
        out = _conv3d(self["conv1"], out)
        mean, std = self._latent_scale(out.device)
        return (out[:, :cfg.z_dim] - mean) / std

    def decode(self, latents: torch.Tensor, clamp: bool = True,
               time_chunk: int = 1) -> torch.Tensor:
        """latents (b, z, t, h, w) -> video (b, 3, 4t-3, 8h, 8w), clamped to [-1, 1]."""
        cfg = self.cfg
        mean, std = self._latent_scale(latents.device)
        x = latents.float() * std + mean
        x = _conv3d(self["conv2"], x).to(cfg.dtype)
        out = self._stream(decoder_plan(cfg), self["decoder"], x, 1, 1, time_chunk)
        return out.clamp(-1.0, 1.0) if clamp else out


    def tiled_encode(self, video: torch.Tensor, tile_size=(272, 272),
                     tile_stride=(144, 128)) -> torch.Tensor:
        """`encode` on overlapping spatial tiles blended with feathered masks.
        tile_size / tile_stride in PIXELS."""
        b, _, T, H, W = video.shape
        up = 8
        out_T = (T + 3) // 4
        values = torch.zeros((b, self.cfg.z_dim, out_T, H // up, W // up), dtype=torch.float32,
                             device=video.device)
        weight = torch.zeros((1, 1, out_T, H // up, W // up), dtype=torch.float32,
                             device=video.device)
        border = ((tile_size[0] - tile_stride[0]) // up, (tile_size[1] - tile_stride[1]) // up)
        for hh, h_, ww, w_ in _tile_tasks(H, W, tile_size, tile_stride):
            h_, w_ = min(h_, H), min(w_, W)
            lat = self.encode(video[:, :, :, hh:h_, ww:w_]).float()
            mask = build_mask(lat.shape[-2:], (hh == 0, h_ >= H, ww == 0, w_ >= W), border,
                              lat.device)
            th, tw = hh // up, ww // up
            values[:, :, :, th:th + lat.shape[3], tw:tw + lat.shape[4]] += lat * mask
            weight[:, :, :, th:th + lat.shape[3], tw:tw + lat.shape[4]] += mask
        return values / weight

    def tiled_decode(self, latents: torch.Tensor, tile_size=(34, 34),
                     tile_stride=(18, 16)) -> torch.Tensor:
        """`decode` on overlapping spatial tiles blended with feathered masks,
        clamped to [-1, 1] after blending. tile_size / tile_stride in LATENT
        units."""
        b, _, T, h, w = latents.shape
        up = 8
        out_T = T * 4 - 3
        values = torch.zeros((b, 3, out_T, h * up, w * up), dtype=torch.float32,
                             device=latents.device)
        weight = torch.zeros((1, 1, out_T, h * up, w * up), dtype=torch.float32,
                             device=latents.device)
        border = ((tile_size[0] - tile_stride[0]) * up, (tile_size[1] - tile_stride[1]) * up)
        for hh, h_, ww, w_ in _tile_tasks(h, w, tile_size, tile_stride):
            h_, w_ = min(h_, h), min(w_, w)
            vid = self.decode(latents[:, :, :, hh:h_, ww:w_], clamp=False).float()
            mask = build_mask(vid.shape[-2:], (hh == 0, h_ >= h, ww == 0, w_ >= w), border,
                              vid.device)
            th, tw = hh * up, ww * up
            values[:, :, :, th:th + vid.shape[3], tw:tw + vid.shape[4]] += vid * mask
            weight[:, :, :, th:th + vid.shape[3], tw:tw + vid.shape[4]] += mask
        return (values / weight).clamp(-1.0, 1.0)


# ---------------------------------------------------------------------------
# Spatial tiles with feathered blending
# ---------------------------------------------------------------------------


def _build_1d_mask(length, left_bound, right_bound, border_width) -> np.ndarray:
    x = np.ones((length,), np.float32)
    bw = min(border_width, length)
    if not left_bound and bw > 0:
        x[:bw] = (np.arange(bw) + 1) / bw
    if not right_bound and bw > 0:
        x[-bw:] = ((np.arange(bw) + 1) / bw)[::-1]
    return x


def build_mask(shape_hw, is_bound, border_width, device=None) -> torch.Tensor:
    """Feathered blend mask, (1, 1, 1, H, W) f32: ramps of border_width over
    each edge of the tile that is not the frame's (is_bound: top, bottom,
    left, right)."""
    H, W = shape_hw
    hm = _build_1d_mask(H, is_bound[0], is_bound[1], border_width[0])
    wm = _build_1d_mask(W, is_bound[2], is_bound[3], border_width[1])
    m = np.minimum(hm[:, None], wm[None, :])
    return torch.from_numpy(m[None, None, None]).to(device)


def _tile_tasks(H, W, size, stride):
    """(h0, h1, w0, w1) of each tile; a tile whose predecessor already reaches
    the frame's edge is skipped."""
    tasks = []
    for hh in range(0, H, stride[0]):
        if hh - stride[0] >= 0 and hh - stride[0] + size[0] >= H:
            continue
        for ww in range(0, W, stride[1]):
            if ww - stride[1] >= 0 and ww - stride[1] + size[1] >= W:
                continue
            tasks.append((hh, hh + size[0], ww, ww + size[1]))
    return tasks


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _init_layer(r: Init, kind, cin, cout):
    def conv3d(kt, kh, kw, ci, co):
        lim = (ci * kt * kh * kw) ** -0.5
        return {"w": r.uniform((co, ci, kt, kh, kw), lim), "b": r.uniform((co,), lim)}

    def conv2d(kh, kw, ci, co):
        lim = (ci * kh * kw) ** -0.5
        return {"w": r.uniform((co, ci, kh, kw), lim), "b": r.uniform((co,), lim)}

    if kind == "conv_in":
        return {"conv": conv3d(3, 3, 3, cin, cout)}
    if kind == "head":
        return {"norm": {"gamma": r.ones((cin,))}, "conv": conv3d(3, 3, 3, cin, cout)}
    if kind == "res":
        p = {
            "norm1": {"gamma": r.ones((cin,))},
            "conv1": conv3d(3, 3, 3, cin, cout),
            "norm2": {"gamma": r.ones((cout,))},
            "conv2": conv3d(3, 3, 3, cout, cout),
        }
        if cin != cout:
            p["shortcut"] = conv3d(1, 1, 1, cin, cout)
        return p
    if kind == "attn":
        return {
            "norm": {"gamma": r.ones((cin,))},
            "to_qkv": conv2d(1, 1, cin, cin * 3),
            "proj": {"w": r.zeros((cin, cin, 1, 1)), "b": r.zeros((cin,))},
        }
    if kind in ("upsample2d", "upsample3d"):
        p = {"conv": conv2d(3, 3, cin, cin // 2)}
        if kind == "upsample3d":
            p["time_conv"] = conv3d(3, 1, 1, cin, cin * 2)
        return p
    if kind in ("downsample2d", "downsample3d"):
        p = {"conv": conv2d(3, 3, cin, cin)}
        if kind == "downsample3d":
            p["time_conv"] = conv3d(3, 1, 1, cin, cin)
        return p
    raise ValueError(kind)


def init_params(cfg: WanVAEConfig = WAN_VAE, seed: int = 0, device="cuda") -> WanVAE:
    """Seeded random weights with the JAX package's distributions."""
    r = Init(seed, device, cfg.dtype)
    z2 = cfg.z_dim * 2

    def conv1x1(c):
        lim = c ** -0.5
        return {"w": r.uniform((c, c, 1, 1, 1), lim), "b": r.uniform((c,), lim)}

    tree = {
        "encoder": [_init_layer(r, *e) for e in encoder_plan(cfg)],
        "decoder": [_init_layer(r, *e) for e in decoder_plan(cfg)],
        "conv1": conv1x1(z2),
        "conv2": conv1x1(cfg.z_dim),
    }
    return WanVAE(cfg, tree)


def _conv_leaf(path: tuple, arr: np.ndarray) -> np.ndarray:
    """JAX DHWIO / HWIO conv weights -> PyTorch (out, in, k...)."""
    if path[-1] == "w" and arr.ndim == 5:
        return arr.transpose(4, 3, 0, 1, 2)
    if path[-1] == "w" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr


def params_from_jax(params: dict, cfg: WanVAEConfig = WAN_VAE) -> WanVAE:
    """The svi_tpu VAE pytree (numpy leaves) -> WanVAE."""
    return WanVAE(cfg, convert_tree(params, cfg.dtype, _conv_leaf))


# ---------------------------------------------------------------------------
# Checkpoints in the reference's naming (VideoVAE_'s state dict)
# ---------------------------------------------------------------------------

# the sub-modules of each plan entry: the port's name -> the reference's, under
# the entry's prefix (`_layer_prefixes`)
_VAE_NAMES = {
    "conv_in": {"conv": "conv1"},
    "head": {"norm": "head.0", "conv": "head.2"},
    "res": {"norm1": "residual.0", "conv1": "residual.2", "norm2": "residual.3",
            "conv2": "residual.6", "shortcut": "shortcut"},
    "attn": {"norm": "norm", "to_qkv": "to_qkv", "proj": "proj"},
}
for _kind in ("upsample2d", "upsample3d", "downsample2d", "downsample3d"):
    _VAE_NAMES[_kind] = {"conv": "resample.1", "time_conv": "time_conv"}
_LEAF_NAMES = {"w": "weight", "b": "bias", "gamma": "gamma"}


def _layer_prefixes(plan, root: str) -> list[str]:
    """The reference's module path of each plan entry: Encoder3d / Decoder3d
    hold conv1, then downsamples.{i} (encoder) or middle.{0,1,2} and
    upsamples.{i} (decoder), then middle (encoder), then head."""
    middle = set(range(len(plan) - 4, len(plan) - 1)) if root == "encoder" else {1, 2, 3}
    body = "downsamples" if root == "encoder" else "upsamples"
    out, seq_i, mid_i = [], 0, 0
    for i, (kind, _, _) in enumerate(plan):
        if kind in ("conv_in", "head"):
            out.append(root)
        elif i in middle:
            out.append(f"{root}.middle.{mid_i}")
            mid_i += 1
        else:
            out.append(f"{root}.{body}.{seq_i}")
            seq_i += 1
    return out


def _strip_model_prefix(sd: dict) -> dict:
    """WanVideoVAE keeps the VAE under 'model.'; VideoVAE_ at the root."""
    if any(k.startswith("model.") for k in sd):
        return {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    return sd


def config_from_state_dict(sd) -> WanVAEConfig:
    """Width and latent channels from the checkpoint's shapes (the structure
    is fixed); always f32."""
    sd = _strip_model_prefix(sd)
    return WanVAEConfig(dim=int(sd["encoder.conv1.weight"].shape[0]),
                        z_dim=int(sd["conv2.weight"].shape[0]))


def params_from_torch_state_dict(sd: dict, cfg: WanVAEConfig = WAN_VAE, device="cuda") -> WanVAE:
    """The reference state dict -> WanVAE on `device` in cfg.dtype. Conv
    weights are PyTorch's layout in both; the RMS-norm gammas lose their
    trailing unit axes."""
    sd = _strip_model_prefix(sd)

    def t(name, flat=False):
        x = sd[name].to(device=device, dtype=cfg.dtype)
        return x.reshape(-1) if flat else x

    def layers(plan, root):
        out = []
        for (kind, _, _), prefix in zip(plan, _layer_prefixes(plan, root)):
            p = {}
            for sub, ref in _VAE_NAMES[kind].items():
                if f"{prefix}.{ref}.gamma" in sd:
                    p[sub] = {"gamma": t(f"{prefix}.{ref}.gamma", flat=True)}
                elif f"{prefix}.{ref}.weight" in sd:
                    p[sub] = {"w": t(f"{prefix}.{ref}.weight"), "b": t(f"{prefix}.{ref}.bias")}
                elif sub not in ("shortcut", "time_conv"):  # present only where needed
                    raise KeyError(f"{prefix}.{ref}.weight (or .gamma)")
            out.append(p)
        return out

    tree = {"encoder": layers(encoder_plan(cfg), "encoder"),
            "decoder": layers(decoder_plan(cfg), "decoder"),
            "conv1": {"w": t("conv1.weight"), "b": t("conv1.bias")},
            "conv2": {"w": t("conv2.weight"), "b": t("conv2.bias")}}
    return WanVAE(cfg, tree)


def torch_state_dict_from_params(vae: WanVAE) -> dict[str, torch.Tensor]:
    """The inverse of `params_from_torch_state_dict` (VideoVAE_'s names, the
    gammas in the reference's shapes: (c, 1, 1) in attention blocks, (c, 1,
    1, 1) elsewhere). For writing checkpoints."""
    cfg = vae.cfg
    out = {f"{k}.{_LEAF_NAMES[leaf]}": vae[k][leaf].detach()
           for k in ("conv1", "conv2") for leaf in ("w", "b")}
    for root, plan in (("encoder", encoder_plan(cfg)), ("decoder", decoder_plan(cfg))):
        for (kind, _, _), prefix, p in zip(plan, _layer_prefixes(plan, root), vae[root]):
            for sub, ref in _VAE_NAMES[kind].items():
                if sub not in p:
                    continue
                for leaf in ("w", "b", "gamma"):
                    if leaf in p[sub]:
                        x = p[sub][leaf].detach()
                        if leaf == "gamma":
                            x = x.reshape(-1, *(1,) * (2 if kind == "attn" else 3))
                        out[f"{prefix}.{ref}.{_LEAF_NAMES[leaf]}"] = x
    return out
