"""ESRGAN 4x upscaler (RRDBNet), port of svi_tpu/extensions/esrgan.py.

23 RRDB blocks of three residual dense blocks (five 3x3 convolutions with
dense concatenations and LeakyReLU 0.2), the trunk convolution, two
nearest-2x upsamples with convolutions and the HR head, at Real-ESRGAN x4's
published widths (`RRDBNetConfig`). Every convolution is f32 through
`ops.conv.conv_f32` (cuDNN, TF32 off), as the JAX package computes them in
XLA outside Pallas. Weights are a `ParamTree` in PyTorch's layouts (the
blocks a list, where the JAX package stacks them for a scan); the public
forward keeps the JAX package's channels-last layout.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv_f32
from ..models.params import Init, ParamTree, convert_tree, to_torch, unstack


@dataclasses.dataclass(frozen=True)
class RRDBNetConfig:
    num_in_ch: int = 3
    num_out_ch: int = 3
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32


def _conv(p, x):
    return conv_f32(F.conv2d, x, p["w"], p["b"], 1, 1)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _rdb(p, x):
    """A residual dense block: five convolutions over the growing concat."""
    feats = [x]
    for i in range(1, 5):
        feats.append(_lrelu(_conv(p[f"conv{i}"], torch.cat(feats, 1))))
    return _conv(p["conv5"], torch.cat(feats, 1)) * 0.2 + x


def _rrdb(p, x):
    out = _rdb(p["rdb3"], _rdb(p["rdb2"], _rdb(p["rdb1"], x)))
    return out * 0.2 + x


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def esrgan_forward(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) in [0, 1] -> (B, 4H, 4W, 3)."""
    x = x.permute(0, 3, 1, 2)
    feat = _conv(params["conv_first"], x)
    body = feat
    for bp in params["body"]:
        body = _rrdb(bp, body)
    feat = feat + _conv(params["conv_body"], body)
    feat = _lrelu(_conv(params["conv_up1"], _up2(feat)))
    feat = _lrelu(_conv(params["conv_up2"], _up2(feat)))
    out = _conv(params["conv_last"], _lrelu(_conv(params["conv_hr"], feat)))
    return out.permute(0, 2, 3, 1)


def init_params(cfg: RRDBNetConfig = RRDBNetConfig(), seed: int = 0, device="cuda",
                dtype=torch.float32) -> ParamTree:
    """Seeded U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and biases."""
    init = Init(seed, device, dtype)

    def conv(cin, cout):
        lim = 1.0 / math.sqrt(cin * 9)
        return {"w": init.uniform((cout, cin, 3, 3), lim), "b": init.uniform((cout,), lim)}

    f, g = cfg.num_feat, cfg.num_grow_ch
    rdb = lambda: {f"conv{i + 1}": conv(f + i * g, g if i < 4 else f) for i in range(5)}
    return ParamTree({
        "conv_first": conv(cfg.num_in_ch, f),
        "body": [{f"rdb{j}": rdb() for j in (1, 2, 3)} for _ in range(cfg.num_block)],
        "conv_body": conv(f, f), "conv_up1": conv(f, f), "conv_up2": conv(f, f),
        "conv_hr": conv(f, f), "conv_last": conv(f, cfg.num_out_ch),
    })


def _hwio_leaf(path, arr):
    return arr.transpose(3, 2, 0, 1) if path[-1] == "w" else arr


def params_from_jax(params: dict, cfg: RRDBNetConfig = RRDBNetConfig(), device="cuda",
                    dtype=torch.float32) -> ParamTree:
    """svi_tpu's pytree (HWIO convolutions, the blocks stacked) -> ParamTree."""
    tree = dict(params)
    tree["body"] = unstack(params["body"], cfg.num_block)
    return ParamTree(convert_tree(tree, dtype, _hwio_leaf)).to(device)


def config_from_state_dict(sd: dict) -> RRDBNetConfig:
    """The widths and depth of an RRDBNet state dict."""
    n = 0
    while f"body.{n}.rdb1.conv1.weight" in sd:
        n += 1
    first, last = sd["conv_first.weight"], sd["conv_last.weight"]
    return RRDBNetConfig(num_in_ch=first.shape[1], num_out_ch=last.shape[0],
                         num_feat=first.shape[0], num_block=n,
                         num_grow_ch=sd["body.0.rdb1.conv1.weight"].shape[0])


def params_from_torch_state_dict(sd: dict, cfg: RRDBNetConfig = RRDBNetConfig(),
                                 device="cuda", dtype=torch.float32) -> ParamTree:
    """The reference's RRDBNet state dict -> ParamTree."""

    def t(name):
        v = sd[name]
        v = v if isinstance(v, torch.Tensor) else to_torch(v, dtype)
        return v.detach().to(device=device, dtype=dtype)

    conv = lambda prefix: {"w": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias")}
    return ParamTree({
        "conv_first": conv("conv_first"),
        "body": [{f"rdb{j}": {f"conv{k}": conv(f"body.{i}.rdb{j}.conv{k}") for k in range(1, 6)}
                  for j in (1, 2, 3)} for i in range(cfg.num_block)],
        **{name: conv(name) for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr",
                                         "conv_last")},
    })


def esrgan_state_dict(seed=0, device="cpu", dtype=torch.float32,
                      cfg: RRDBNetConfig = RRDBNetConfig()) -> dict:
    """Seeded random RRDBNet weights in the reference's naming."""
    from ..models.sd import StateDictMaker

    m, f, g = StateDictMaker(seed, device, dtype), cfg.num_feat, cfg.num_grow_ch
    m.conv("conv_first", f, cfg.num_in_ch)
    for i in range(cfg.num_block):
        for j in (1, 2, 3):
            for k in range(5):
                m.conv(f"body.{i}.rdb{j}.conv{k + 1}", g if k < 4 else f, f + k * g)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        m.conv(name, f, f)
    m.conv("conv_last", cfg.num_out_ch, f)
    return m.sd


class ESRGAN:
    """Frames in, frames out: (H, W, 3) uint8 arrays (a PIL image is read
    through np.asarray), upscaled 4x in batches on the weights' device."""

    def __init__(self, params: ParamTree, cfg: RRDBNetConfig = RRDBNetConfig()):
        self.params = params
        self.cfg = cfg
        self.device = next(params.parameters()).device

    @staticmethod
    def from_model_manager(model_manager):
        return ESRGAN(model_manager.fetch_model("esrgan"))

    @torch.no_grad()
    def upscale(self, images, batch_size=4, progress_bar=lambda x: x):
        single = not isinstance(images, list)
        if single:
            images = [images]
        arr = np.stack([np.asarray(im, np.float32) / 255.0 for im in images])
        outs = []
        for i in progress_bar(range(0, arr.shape[0], batch_size)):
            x = torch.from_numpy(arr[i:i + batch_size]).to(self.device)
            outs.append(esrgan_forward(self.params, x).float().cpu().numpy())
        out = [(np.clip(o, 0, 1) * 255).astype(np.uint8) for o in np.concatenate(outs)]
        return out[0] if single else out
