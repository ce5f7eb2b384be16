"""RIFE video frame interpolation (IFNet), port of svi_tpu/extensions/rife.py.

Three coarse-to-fine IFBlocks (scales 4 / 2 / 1), each run on both frame
orders; a backward warp of each frame by its flow; a sigmoid blend mask.
`RIFEInterpolater` doubles the frame count, `RIFESmoother` replaces each
inner frame by its neighbours' interpolation blended with itself.

What the JAX package writes as gathers is PyTorch's own operator here: its
border-clamped bilinear warp at align-corners coordinates is `grid_sample`
(padding "border", align_corners=True), its un-antialiased
`jax.image.resize('linear')` is `interpolate(bilinear, align_corners=False)`,
its input-dilated convolution with a flipped kernel is `conv_transpose2d`.
Every convolution is f32 with cuDNN TF32 off (`ops.conv`). Weights are a
`ParamTree` in PyTorch's layouts; the public forward keeps the JAX package's
channels-last layout. Frames are (H, W, 3) uint8 arrays (a PIL image is read
through np.asarray); Pillow's default resize is `utils.image_process.resize_uint8`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models.params import Init, ParamTree, convert_tree, to_torch
from ..ops.conv import conv_f32, conv_transpose2d_f32
from ..utils.image_process import resize_uint8

_CONVBLOCKS = ("convblock0", "convblock1", "convblock2", "convblock3")


def _conv_prelu(p, x, stride=1):
    """Conv2d(k=3, padding=1) and PReLU (torch pads symmetrically at stride 2)."""
    if 0 in x.shape[2:]:  # XLA's convolution of an empty map: an empty map
        h, w = (0 if s == 0 else (s - 1) // stride + 1 for s in x.shape[2:])
        return x.new_zeros((x.shape[0], p["w"].shape[0], h, w))
    y = conv_f32(F.conv2d, x, p["w"], p["b"], stride, 1)
    return _prelu(p, y)


def _prelu(p, x):
    return torch.where(x >= 0, x, p["a"][None, :, None, None] * x)


def _deconv(p, x):
    """ConvTranspose2d(k=4, s=2, p=1): doubles H and W. svi_tpu's dilated
    convolution reads an empty side as one of size 1 with no input: the bias
    alone, on 1 or 2n pixels (a frame shrunk below the IFBlock's scale)."""
    if 0 in x.shape[2:]:
        h, w = (max(2 * s, 1) for s in x.shape[2:])
        return p["b"][None, :, None, None].expand(x.shape[0], -1, h, w).contiguous()
    return conv_transpose2d_f32(x, p["w"], p["b"], 2, 1)


def _resize(x, h, w):
    if 0 in (h, w):
        return x.new_zeros((x.shape[0], x.shape[1], h, w))
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp: x (B, H, W, C) sampled bilinearly at the pixel
    coordinates + flow (B, H, W, 2) (dx, dy), clamped to the border."""
    b, h, w, _ = x.shape
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    gx = (xs + flow[..., 0]) * (2.0 / max(w - 1, 1)) - 1.0
    gy = (ys + flow[..., 1]) * (2.0 / max(h - 1, 1)) - 1.0
    out = F.grid_sample(x.permute(0, 3, 1, 2), torch.stack([gx, gy], -1), mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)


def _ifblock(p, x, flow, scale):
    """One IFBlock on NCHW: downscale, a residual conv trunk, the flow and
    mask heads back at full size."""
    h, w = x.shape[2:]
    hs, ws = int(h / scale), int(w / scale)
    x = _resize(x, hs, ws)
    flow = _resize(flow, hs, ws) * (1.0 / scale)
    feat = _conv_prelu(p["conv0_0"], torch.cat([x, flow], 1), stride=2)
    feat = _conv_prelu(p["conv0_1"], feat, stride=2)
    for blk in _CONVBLOCKS:
        feat = _conv_prelu(p[f"{blk}_1"], _conv_prelu(p[f"{blk}_0"], feat)) + feat
    f = _deconv(p["conv1_2"], _prelu(p["conv1_1"], _deconv(p["conv1_0"], feat)))
    m = _deconv(p["conv2_2"], _prelu(p["conv2_1"], _deconv(p["conv2_0"], feat)))
    return _resize(f, h, w) * scale, _resize(m, h, w)


def _swap(flow):
    return torch.cat([flow[:, 2:4], flow[:, :2]], 1)


def ifnet_forward(params, x: torch.Tensor, scale_list=(4, 2, 1)):
    """x: (B, H, W, 6), the two frames stacked on channels. Returns
    (flow_list, mask, merged_list), channels-last; merged[2] is the
    interpolated middle frame."""
    x = x.permute(0, 3, 1, 2)
    img0, img1 = x[:, :3], x[:, 3:6]
    b, _, h, w = x.shape
    flow = x.new_zeros((b, 4, h, w))
    mask = x.new_zeros((b, 1, h, w))
    warped0, warped1 = img0, img1
    flows, masks, warped = [], [], []
    for i, blk in enumerate(("block0", "block1", "block2")):
        f0, m0 = _ifblock(params[blk], torch.cat([warped0, warped1, mask], 1), flow,
                          scale_list[i])
        f1, m1 = _ifblock(params[blk], torch.cat([warped1, warped0, -mask], 1), _swap(flow),
                          scale_list[i])
        flow = flow + (f0 + _swap(f1)) / 2
        mask = mask + (m0 - m1) / 2
        masks.append(mask)
        flows.append(flow)
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        warped0 = warp(nhwc(img0), nhwc(flow[:, :2])).permute(0, 3, 1, 2)
        warped1 = warp(nhwc(img1), nhwc(flow[:, 2:4])).permute(0, 3, 1, 2)
        warped.append((warped0, warped1))
    merged = [(w0 * torch.sigmoid(mk) + w1 * (1 - torch.sigmoid(mk))).permute(0, 2, 3, 1)
              for (w0, w1), mk in zip(warped, masks)]
    return ([f.permute(0, 2, 3, 1) for f in flows],
            torch.sigmoid(masks[2]).permute(0, 2, 3, 1), merged)


def init_params(c=90, seed=0, device="cuda", dtype=torch.float32) -> ParamTree:
    """A seeded random IFNet (the inference blocks; in_planes 7 + 4)."""
    init = Init(seed, device, dtype)

    def conv(cin, cout):
        lim = 1.0 / math.sqrt(cin * 9)
        return {"w": init.uniform((cout, cin, 3, 3), lim), "b": init.uniform((cout,), lim),
                "a": torch.full((cout,), 0.25, dtype=dtype, device=device)}

    def deconv(cin, cout):
        lim = 1.0 / math.sqrt(cin * 16)
        return {"w": init.uniform((cin, cout, 4, 4), lim), "b": init.uniform((cout,), lim)}

    def prelu(n):
        return {"a": torch.full((n,), 0.25, dtype=dtype, device=device)}

    def block():
        p = {"conv0_0": conv(11, c // 2), "conv0_1": conv(c // 2, c)}
        for blk in _CONVBLOCKS:
            p[f"{blk}_0"], p[f"{blk}_1"] = conv(c, c), conv(c, c)
        p.update(conv1_0=deconv(c, c // 2), conv1_1=prelu(c // 2), conv1_2=deconv(c // 2, 4),
                 conv2_0=deconv(c, c // 2), conv2_1=prelu(c // 2), conv2_2=deconv(c // 2, 1))
        return p

    return ParamTree({b: block() for b in ("block0", "block1", "block2")})


def _jax_leaf(path, arr):
    """svi_tpu's HWIO convolutions -> (out, in, kh, kw); its deconvolutions
    (flipped forward-conv kernels, (kh, kw, in, out)) -> ConvTranspose2d's
    (in, out, kh, kw)."""
    if path[-1] != "w":
        return arr
    if arr.shape[0] == 4:
        return np.ascontiguousarray(np.flip(arr.transpose(2, 3, 0, 1), axis=(2, 3)))
    return arr.transpose(3, 2, 0, 1)


def params_from_jax(params: dict, device="cuda", dtype=torch.float32) -> ParamTree:
    return ParamTree(convert_tree(params, dtype, _jax_leaf)).to(device)


def params_from_torch_state_dict(sd: dict, device="cuda", dtype=torch.float32) -> ParamTree:
    """The reference's IFNet state dict (keys possibly 'module.'-prefixed) ->
    ParamTree; the inference blocks only (block_tea is the training teacher)."""
    sd = {k.replace("module.", ""): v for k, v in sd.items()}

    def t(name):
        v = sd[name]
        v = v if isinstance(v, torch.Tensor) else to_torch(v, dtype)
        return v.detach().to(device=device, dtype=dtype)

    def conv(prefix, prelu):
        return {"w": t(f"{prefix}.weight"), "b": t(f"{prefix}.bias"),
                "a": t(f"{prelu}.weight").reshape(-1)}

    def block(b):
        p = {"conv0_0": conv(f"{b}.conv0.0.0", f"{b}.conv0.0.1"),
             "conv0_1": conv(f"{b}.conv0.1.0", f"{b}.conv0.1.1")}
        for i, blk in enumerate(_CONVBLOCKS):
            for j in (0, 1):
                p[f"{blk}_{j}"] = conv(f"{b}.convblock{i}.{j}.0", f"{b}.convblock{i}.{j}.1")
        for head in ("conv1", "conv2"):
            p[f"{head}_0"] = {"w": t(f"{b}.{head}.0.weight"), "b": t(f"{b}.{head}.0.bias")}
            p[f"{head}_1"] = {"a": t(f"{b}.{head}.1.weight").reshape(-1)}
            p[f"{head}_2"] = {"w": t(f"{b}.{head}.2.weight"), "b": t(f"{b}.{head}.2.bias")}
        return p

    return ParamTree({b: block(b) for b in ("block0", "block1", "block2")})


def ifnet_state_dict(c=90, seed=0, device="cpu", dtype=torch.float32) -> dict:
    """Seeded random IFNet weights in the reference's naming (PReLU slopes
    0.25, as torch initialises them)."""
    from ..models.sd import StateDictMaker

    m = StateDictMaker(seed, device, dtype)

    def conv_prelu(prefix, cout, cin):
        m.conv(f"{prefix}.0", cout, cin)
        m.sd[f"{prefix}.1.weight"] = torch.full((cout,), 0.25, dtype=dtype, device=device)

    def deconv(prefix, cin, cout):
        m.sd[f"{prefix}.weight"] = m.randn((cin, cout, 4, 4), (cin * 16) ** -0.5)
        m.sd[f"{prefix}.bias"] = m.randn((cout,), 0.02)

    for b in ("block0", "block1", "block2"):
        conv_prelu(f"{b}.conv0.0", c // 2, 11)
        conv_prelu(f"{b}.conv0.1", c, c // 2)
        for i in range(4):
            for j in (0, 1):
                conv_prelu(f"{b}.convblock{i}.{j}", c, c)
        for head, out in (("conv1", 4), ("conv2", 1)):
            deconv(f"{b}.{head}.0", c, c // 2)
            m.sd[f"{b}.{head}.1.weight"] = torch.full((c // 2,), 0.25, dtype=dtype,
                                                      device=device)
            deconv(f"{b}.{head}.2", c // 2, out)
    return m.sd


class RIFEInterpolater:
    """Frames in, frames out, on the weights' device. call_defaults: keyword
    values merged into every call (the reference keeps scale / batch_size /
    num_iter on the instance)."""

    def __init__(self, params: ParamTree, **call_defaults):
        self.params = params
        self.call_defaults = call_defaults
        self.device = next(params.parameters()).device

    @classmethod
    def from_model_manager(cls, model_manager, **kwargs):
        params = None if model_manager is None else model_manager.fetch_model("rife")
        if params is None:
            raise ValueError("RIFE needs IFNet weights: a ModelManager that holds a 'rife' "
                             "model (an IFNet state dict loaded with load_model)")
        return cls(params, **kwargs)

    def _process(self, images) -> np.ndarray:
        """Frames -> (N, H, W, 3) f32 BGR in [0, 1]. A frame whose sides are
        not multiples of 32 is resized to ((w + 31) // 32, (h + 31) // 32)
        pixels first, as svi_tpu does (ROADMAP.md, known quirks)."""
        arrs = []
        for im in images:
            im = np.asarray(im)
            h, w = im.shape[:2]
            if w % 32 or h % 32:
                im = resize_uint8(im, (w + 31) // 32, (h + 31) // 32)
            arrs.append(im.astype(np.float32)[:, :, [2, 1, 0]] / 255.0)
        return np.stack(arrs)

    @staticmethod
    def _decode(arr, size) -> list:
        """(N, H, W, 3) BGR in [0, 1] -> frames of size (w, h)."""
        out = []
        for a in arr:
            im = (np.clip(a[..., [2, 1, 0]], 0, 1) * 255).astype(np.uint8)
            if (im.shape[1], im.shape[0]) != tuple(size):
                im = resize_uint8(im, *size)
            out.append(im)
        return out

    @torch.no_grad()
    def _middles(self, pairs: np.ndarray, scale, batch_size) -> np.ndarray:
        """(N, H, W, 6) frame pairs -> their interpolated middle frames."""
        sl = (4 / scale, 2 / scale, 1 / scale)
        outs = []
        for i in range(0, pairs.shape[0], batch_size):
            x = torch.from_numpy(np.ascontiguousarray(pairs[i:i + batch_size])).to(self.device)
            outs.append(ifnet_forward(self.params, x, sl)[2][2].float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    def interpolate(self, images, scale=1.0, batch_size=4, num_iter=1,
                    progress_bar=lambda x: x):
        """Doubles the frame count num_iter times."""
        size = (np.asarray(images[0]).shape[1], np.asarray(images[0]).shape[0])
        frames = self._process(images)
        for _ in range(num_iter):
            mids = np.clip(self._middles(np.concatenate([frames[:-1], frames[1:]], -1),
                                         scale, batch_size), 0, 1)
            out = []
            for f, m in zip(frames, mids):
                out += [f, m]
            out.append(frames[-1])
            frames = np.stack(out)
        return self._decode(frames, size)


class RIFESmoother(RIFEInterpolater):
    """Temporal smoothing: each inner frame re-interpolated from its
    neighbours, then blended with that interpolation."""

    def __call__(self, rendered_frames, scale=1.0, batch_size=4, num_iter=1, **kw):
        scale = self.call_defaults.get("scale", scale)
        batch_size = self.call_defaults.get("batch_size", batch_size)
        num_iter = self.call_defaults.get("num_iter", num_iter)
        first = np.asarray(rendered_frames[0])
        size = (first.shape[1], first.shape[0])
        frames = self._process(rendered_frames)
        for _ in range(num_iter):
            mids = self._middles(np.concatenate([frames[:-2], frames[2:]], -1), scale, batch_size)
            frames[1:-1] = self._middles(np.concatenate([frames[1:-1], mids], -1), scale,
                                         batch_size)
        return self._decode(frames, size)
