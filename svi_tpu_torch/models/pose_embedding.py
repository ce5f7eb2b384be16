"""DWPose skeleton-video embedding of SVI-Dance, f32.

Port of svi_tpu/models/pose_embedding.py: a stack of 7 Conv3d (SiLU between)
that compresses the pose video (3, F + 3, H, W) to patch-grid tokens
(F'/4 · H/16 · W/16, dim), added to the DiT's patch tokens as
`add_condition`. Its weights ride inside the SVI-Dance LoRA file under
`dwpose_embedding.{0,2,...,12}.{weight,bias}` (the indices of an
nn.Sequential). The convolutions are cuDNN's `F.conv3d` (the JAX package
runs XLA's here, no Pallas kernel).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .params import Init, ParamTree, to_torch

# (kernel, stride, padding) per conv; channels 3 -> 16 -> ... -> 16 -> dim
LAYERS = (
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((3, 3, 3), (1, 1, 1), (1, 1, 1)),
    ((3, 3, 3), (1, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ((1, 2, 2), (1, 2, 2), (0, 0, 0)),
)
WIDTH = 16  # concat_dim 4 x 4
PREFIX = "dwpose_embedding."


def _channels(dim: int) -> list[int]:
    return [3] + [WIDTH] * (len(LAYERS) - 1) + [dim]


class PoseEmbedding(ParamTree):
    """tree {"layers": [{"w": (out, in, kt, kh, kw), "b": (out,)}] x 7}."""

    def forward(self, pose: torch.Tensor) -> torch.Tensor:
        """pose (b, 3, F, H, W) in [0, 255], without the 3-frame prefix ->
        add_condition tokens (b, F'/4 · H/16 · W/16, dim): three copies of the
        first frame go in front and the video is divided by 255 first, as
        the reference's pipeline does."""
        x = torch.cat([pose[:, :, :1].repeat(1, 1, 3, 1, 1), pose], dim=2) / 255.0
        layers = self["layers"]
        x = x.to(layers[0]["w"].dtype)
        for i, (_, stride, pad) in enumerate(LAYERS):
            x = F.conv3d(x, layers[i]["w"], layers[i]["b"], stride=stride, padding=pad)
            if i < len(LAYERS) - 1:
                x = F.silu(x)
        return x.flatten(2).transpose(1, 2)


def init_params(dim: int, seed: int = 0, device="cuda", dtype=torch.float32) -> PoseEmbedding:
    """Seeded U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and biases."""
    r = Init(seed, device, dtype)
    chans = _channels(dim)
    layers = []
    for i, (k, _, _) in enumerate(LAYERS):
        lim = 1.0 / math.sqrt(chans[i] * math.prod(k))
        layers.append({"w": r.uniform((chans[i + 1], chans[i], *k), lim),
                       "b": r.uniform((chans[i + 1],), lim)})
    return PoseEmbedding({"layers": layers})


def params_from_jax(params: list, dtype=torch.float32) -> PoseEmbedding:
    """svi_tpu's list of {"w": (kt, kh, kw, in, out), "b"} -> PoseEmbedding."""
    return PoseEmbedding({"layers": [
        {"w": to_torch(np.transpose(np.asarray(p["w"]), (4, 3, 0, 1, 2)), dtype),
         "b": to_torch(p["b"], dtype)} for p in params]})


def params_from_torch_state_dict(sd: dict, device="cuda", dtype=torch.float32) -> PoseEmbedding:
    """Keys '0.weight', '2.weight', ... (the Sequential's conv indices),
    after whatever precedes 'dwpose_embedding.' where that is in the key."""
    clean = {k.split(PREFIX)[1] if PREFIX in k else k: v for k, v in sd.items()}
    return PoseEmbedding({"layers": [
        {"w": torch.as_tensor(clean[f"{2 * i}.weight"]).to(device=device, dtype=dtype),
         "b": torch.as_tensor(clean[f"{2 * i}.bias"]).to(device=device, dtype=dtype)}
        for i in range(len(LAYERS))]})


def torch_state_dict_from_params(model: PoseEmbedding, prefix: str = PREFIX) -> dict:
    """The inverse of `params_from_torch_state_dict`, under `prefix`."""
    out = {}
    for i, p in enumerate(model["layers"]):
        out[f"{prefix}{2 * i}.weight"] = p["w"].detach()
        out[f"{prefix}{2 * i}.bias"] = p["b"].detach()
    return out
