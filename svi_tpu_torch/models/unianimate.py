"""UniAnimate's side embedding stacks (reference pose, inpaint, learn-in), f32.

Port of svi_tpu/models/unianimate.py: three SiLU-separated convolution
stacks that the UniAnimate pipelines (`pipelines/wan_video.py`) load from
the side modules of a LoRA file (`ModelManager.state_dict_new_module`):

  * randomref_embedding_pose: 6 conv2d, 3 -> 16 -> ... -> 20, embedding the
    reference pose image into an additive term of the 20-channel `y` grid;
  * learn_in_embedding: 4 conv3d, 4 -> ... -> 16, embedding (masked video ‖
    mask) into latent-shaped features (replace-anyone);
  * inpaint_embedding: 3 conv3d, 16 -> ... -> 16, refining the VAE latent
    of the masked video (replace-anyone).

The main pose stack is models/pose_embedding.py (shared with SVI-Dance).
Weights are (out, in, k...) as PyTorch's; `params_from_jax` transposes the
JAX package's channels-last (k..., in, out) lists, and the
`*_from_torch_state_dict` readers take the reference's Sequential keys
'{prefix}{2i}.weight'. The convolutions are cuDNN's in f32 with TF32 off
(`ops.conv.conv_f32`; the JAX package runs XLA's, no Pallas kernel).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv_f32
from .params import Init, ParamTree, to_torch

CONCAT_DIM = 4
_W = CONCAT_DIM * 4  # base width 16

# (kernel, stride, padding) per conv
RANDOMREF_LAYERS = (
    ((3, 3), (1, 1), (1, 1)),
    ((3, 3), (1, 1), (1, 1)),
    ((3, 3), (1, 1), (1, 1)),
    ((3, 3), (2, 2), (1, 1)),
    ((3, 3), (2, 2), (1, 1)),
    ((3, 3), (2, 2), (1, 1)),
)
RANDOMREF_CHANNELS = (3, _W, _W, _W, _W, _W, 20)

LEARN_IN_LAYERS = (
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((3, 3, 3), (1, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
)
LEARN_IN_CHANNELS = (4, _W, _W, _W, 16)

INPAINT_LAYERS = (
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)),
)
INPAINT_CHANNELS = (16, _W, _W, 16)

PREFIXES = {"randomref": "randomref_embedding_pose.", "learn_in": "learn_in_embedding.",
            "inpaint": "inpaint_embedding."}


class ConvStack(ParamTree):
    """tree {"layers": [{"w": (out, in, k...), "b": (out,)}]}; `spec` gives
    each conv's (kernel, stride, padding), SiLU between them."""

    def __init__(self, tree: dict, spec: tuple):
        super().__init__(tree)
        self.spec = spec

    def run(self, x: torch.Tensor) -> torch.Tensor:
        params = self["layers"]
        conv = F.conv2d if len(self.spec[0][0]) == 2 else F.conv3d
        x = x.to(params[0]["w"].dtype)
        for i, (_, stride, pad) in enumerate(self.spec):
            x = conv_f32(conv, x, params[i]["w"], params[i]["b"], stride=stride, padding=pad)
            if i < len(self.spec) - 1:
                x = F.silu(x)
        return x


class RandomRefEmbedding(ConvStack):
    def forward(self, ref_pose: torch.Tensor) -> torch.Tensor:
        """ref_pose (b, H, W, 3) in [0, 255] -> (b, 20, 1, H/8, W/8), the
        additive term of the 20-channel `y`."""
        x = ref_pose.permute(0, 3, 1, 2).to(self["layers"][0]["w"].dtype) / 255.0
        return self.run(x)[:, :, None]


class LearnInEmbedding(ConvStack):
    def forward(self, masked_video: torch.Tensor) -> torch.Tensor:
        """masked_video (b, 4, F, H, W) = (video * ~mask ‖ ~mask); three
        copies of the first frame go in front -> latent-shaped
        (b, 16, F_lat, H/8, W/8)."""
        x = torch.cat([masked_video[:, :, :1].repeat(1, 1, 3, 1, 1), masked_video], dim=2)
        return self.run(x)


class InpaintEmbedding(ConvStack):
    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        """(b, 16, f, h, w) latent-space refinement of the masked video's
        encoding."""
        return self.run(latents)


_KINDS = {"randomref": (RandomRefEmbedding, RANDOMREF_LAYERS, RANDOMREF_CHANNELS),
          "learn_in": (LearnInEmbedding, LEARN_IN_LAYERS, LEARN_IN_CHANNELS),
          "inpaint": (InpaintEmbedding, INPAINT_LAYERS, INPAINT_CHANNELS)}


def init_params(kind: str, seed: int = 0, device="cuda", dtype=torch.float32,
                channels=None) -> ConvStack:
    """Seeded U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and biases of the
    `kind` stack ('randomref', 'learn_in', 'inpaint'); channels overrides
    the published widths (tiny test models)."""
    cls, layers, chans = _KINDS[kind]
    chans = chans if channels is None else channels
    r = Init(seed, device, dtype)
    out = []
    for i, (k, _, _) in enumerate(layers):
        lim = 1.0 / math.sqrt(chans[i] * math.prod(k))
        out.append({"w": r.uniform((chans[i + 1], chans[i], *k), lim),
                    "b": r.uniform((chans[i + 1],), lim)})
    return cls({"layers": out}, layers)


def params_from_jax(kind: str, params: list, device="cpu", dtype=torch.float32) -> ConvStack:
    """svi_tpu's list of {"w": (k..., in, out), "b"} -> the `kind` stack."""
    cls, layers, _ = _KINDS[kind]
    nd = len(layers[0][0])
    perm = (nd + 1, nd) + tuple(range(nd))
    return cls({"layers": [{"w": to_torch(np.transpose(np.asarray(p["w"]), perm), dtype),
                            "b": to_torch(p["b"], dtype)} for p in params]},
               layers).to(device)


def params_from_torch_state_dict(kind: str, sd: dict, device="cuda",
                                 dtype=torch.float32) -> ConvStack:
    """Keys '0.weight', '2.weight', ... (the Sequential's conv indices),
    after whatever precedes the kind's prefix where that is in the key."""
    cls, layers, _ = _KINDS[kind]
    prefix = PREFIXES[kind]
    clean = {k.split(prefix)[-1]: v for k, v in sd.items()}
    return cls({"layers": [
        {"w": torch.as_tensor(clean[f"{2 * i}.weight"]).to(device=device, dtype=dtype),
         "b": torch.as_tensor(clean[f"{2 * i}.bias"]).to(device=device, dtype=dtype)}
        for i in range(len(layers))]}, layers)


def torch_state_dict_from_params(kind: str, model: ConvStack) -> dict:
    """The inverse of `params_from_torch_state_dict`, under the kind's
    prefix (the reference's key names)."""
    out = {}
    for i, p in enumerate(model["layers"]):
        out[f"{PREFIXES[kind]}{2 * i}.weight"] = p["w"].detach()
        out[f"{PREFIXES[kind]}{2 * i}.bias"] = p["b"].detach()
    return out
