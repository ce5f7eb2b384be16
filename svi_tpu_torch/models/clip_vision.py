"""XLM-Roberta-CLIP ViT-H/14 vision tower (Wan's image encoder), f32.

Port of svi_tpu/models/clip_vision.py: `forward_tokens` (the output of 31 of
32 blocks, (b, 257, 1280)) and `encode_image` with its host bicubic resize
matrix; and the reference's checkpoint (`config_from_state_dict`,
`params_from_torch_state_dict`). Attention heads are 80 wide, so they go
through the (B, N, S, D) flash entry point, as K2 served them in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..ops.norms import layer_norm
from .params import Init, ParamTree, convert_tree, dense, linear_leaf, unstack

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: int = 4
    num_heads: int = 16
    num_layers: int = 32
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2


VIT_H_14 = ClipVisionConfig()


def _bicubic_kernel(x):
    # torch/PIL bicubic (a = -0.75)
    a = -0.75
    ax = np.abs(x)
    return np.where(
        ax <= 1, (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
        np.where(ax < 2, a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a, 0.0),
    )


@functools.lru_cache(maxsize=8)
def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """Dense (dst, src) bicubic resize matrix, align_corners=False semantics.
    Cached: callers must not write into it."""
    scale = src / dst
    out = np.zeros((dst, src), np.float64)
    for i in range(dst):
        center = (i + 0.5) * scale - 0.5
        lo = int(np.floor(center)) - 1
        idx = np.arange(lo, lo + 4)
        w = _bicubic_kernel(idx - center)
        w = w / w.sum()
        idx = np.clip(idx, 0, src - 1)
        for j, wj in zip(idx, w):
            out[i, j] += wj
    return out.astype(np.float32)


def resize_bicubic(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """img (b, c, H, W) -> (b, c, *size), separable bicubic in f32."""
    H, W = img.shape[-2:]
    mh = torch.from_numpy(_resize_matrix(H, size[0])).to(img.device)
    mw = torch.from_numpy(_resize_matrix(W, size[1])).to(img.device)
    out = torch.einsum("oh,bchw->bcow", mh, img.float())
    return torch.einsum("pw,bcow->bcop", mw, out)


class ClipVision(ParamTree):
    def __init__(self, cfg: ClipVisionConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def _block(self, p, x):
        """Pre-norm ViT block."""
        cfg = self.cfg
        b, L, d = x.shape
        n, hd = cfg.num_heads, d // cfg.num_heads
        y = layer_norm(x, p["norm1"]["w"], p["norm1"]["b"], eps=cfg.norm_eps)
        q, k, v = dense(p["attn"]["to_qkv"], y).chunk(3, dim=-1)
        o = flash_attention(q.reshape(b, L, n, hd), k.reshape(b, L, n, hd),
                            v.reshape(b, L, n, hd)).reshape(b, L, d)
        x = x + dense(p["attn"]["proj"], o)
        y = layer_norm(x, p["norm2"]["w"], p["norm2"]["b"], eps=cfg.norm_eps)
        h = F.gelu(dense(p["mlp"]["fc1"], y).float()).to(y.dtype)
        return x + dense(p["mlp"]["fc2"], h)

    def forward_tokens(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (b, 3, 224, 224), CLIP-normalized -> (b, 257, dim) after 31 of 32 blocks."""
        cfg = self.cfg
        b = pixels.shape[0]
        ps = cfg.patch_size
        hw = cfg.image_size // ps
        # patch conv (kernel == stride) as reshape + dense, features (c, kh, kw)
        x = pixels.to(cfg.dtype).reshape(b, 3, hw, ps, hw, ps).permute(0, 2, 4, 1, 3, 5)
        x = dense(self["patch_embedding"], x.reshape(b, hw * hw, 3 * ps * ps))
        cls = self["cls_embedding"].to(x.dtype).expand(b, 1, cfg.dim)
        x = torch.cat([cls, x], dim=1) + self["pos_embedding"].to(x.dtype)
        x = layer_norm(x, self["pre_norm"]["w"], self["pre_norm"]["b"], eps=cfg.norm_eps)
        for p in self["blocks"][:cfg.num_layers - 1]:
            x = self._block(p, x)
        return x

    def encode_image(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (b, 3, H, W) in [-1, 1] -> bicubic 224^2 -> CLIP normalize ->
        31-block tokens (b, 257, dim)."""
        cfg = self.cfg
        x = resize_bicubic(frames, (cfg.image_size, cfg.image_size))
        x = x * 0.5 + 0.5
        mean = torch.from_numpy(CLIP_MEAN).to(x.device)[:, None, None]
        std = torch.from_numpy(CLIP_STD).to(x.device)[:, None, None]
        return self.forward_tokens((x - mean) / std)


def init_params(cfg: ClipVisionConfig = VIT_H_14, seed: int = 0, device="cuda") -> ClipVision:
    """Seeded random weights with the JAX package's distributions."""
    r = Init(seed, device, cfg.dtype)
    gain = 1.0 / math.sqrt(cfg.dim)
    pdim = 3 * cfg.patch_size ** 2
    mdim = cfg.dim * cfg.mlp_ratio

    def block():
        return {
            "norm1": {"w": r.ones((cfg.dim,)), "b": r.zeros((cfg.dim,))},
            "norm2": {"w": r.ones((cfg.dim,)), "b": r.zeros((cfg.dim,))},
            "attn": {"to_qkv": r.linear(cfg.dim, cfg.dim * 3),
                     "proj": r.linear(cfg.dim, cfg.dim)},
            "mlp": {"fc1": r.linear(cfg.dim, mdim), "fc2": r.linear(mdim, cfg.dim)},
        }

    tree = {
        # pre_norm => the patch conv has no bias
        "patch_embedding": {"w": r.normal((cfg.dim, pdim), pdim ** -0.5)},
        "cls_embedding": r.normal((1, 1, cfg.dim), gain),
        "pos_embedding": r.normal((1, cfg.num_patches + 1, cfg.dim), gain),
        "pre_norm": {"w": r.ones((cfg.dim,)), "b": r.zeros((cfg.dim,))},
        "blocks": [block() for _ in range(cfg.num_layers)],
    }
    return ClipVision(cfg, tree)


def params_from_jax(params: dict, cfg: ClipVisionConfig = VIT_H_14) -> ClipVision:
    """The svi_tpu CLIP pytree (numpy leaves) -> ClipVision."""
    tree = dict(params)
    tree["blocks"] = unstack(params["blocks"], cfg.num_layers)
    return ClipVision(cfg, convert_tree(tree, cfg.dtype, linear_leaf))


# ---------------------------------------------------------------------------
# Checkpoints in the reference's naming (the open-clip XLM-Roberta ViT-H/14)
# ---------------------------------------------------------------------------


def _visual_prefix(sd) -> str:
    for cand in ("model.visual.", "visual.", ""):
        if f"{cand}patch_embedding.weight" in sd:
            return cand
    raise KeyError("no patch_embedding.weight under model.visual., visual. or the root")


def config_from_state_dict(sd) -> ClipVisionConfig:
    """The vision tower's architecture from the checkpoint's shapes; ViT-H
    has 16 heads of 80 at dim 1280, other widths heads of 80 (or 64)."""
    pref = _visual_prefix(sd)
    pe = sd[f"{pref}patch_embedding.weight"].shape  # (dim, 3, ps, ps)
    dim, ps = int(pe[0]), int(pe[2])
    hw = int(round((int(sd[f"{pref}pos_embedding"].shape[1]) - 1) ** 0.5))
    blocks = [k[len(pref):].split(".")[1] for k in sd if k.startswith(f"{pref}transformer.")]
    num_layers = 1 + max(int(i) for i in blocks if i.isdigit())
    mlp = int(sd[f"{pref}transformer.0.mlp.0.weight"].shape[0])
    return ClipVisionConfig(
        image_size=hw * ps, patch_size=ps, dim=dim, mlp_ratio=mlp // dim,
        num_heads=max(1, dim // 80) if dim % 80 == 0 else max(1, dim // 64),
        num_layers=num_layers)


def params_from_torch_state_dict(sd: dict, cfg: ClipVisionConfig, device="cuda") -> ClipVision:
    """The reference's image-encoder state dict (the vision tower under
    'model.visual.', 'visual.' or the root; the text tower is dropped) ->
    ClipVision on `device` in cfg.dtype. The patch conv (dim, 3, ps, ps)
    becomes the (dim, 3·ps·ps) linear of `forward_tokens`."""
    pref = _visual_prefix(sd)

    def t(name):
        return sd[f"{pref}{name}"].to(device=device, dtype=cfg.dtype)

    def wb(name):
        return {"w": t(f"{name}.weight"), "b": t(f"{name}.bias")}

    def block(i):
        b = f"transformer.{i}"
        return {"norm1": wb(f"{b}.norm1"), "norm2": wb(f"{b}.norm2"),
                "attn": {"to_qkv": wb(f"{b}.attn.to_qkv"), "proj": wb(f"{b}.attn.proj")},
                "mlp": {"fc1": wb(f"{b}.mlp.0"), "fc2": wb(f"{b}.mlp.2")}}

    patch = {"w": t("patch_embedding.weight").reshape(cfg.dim, -1)}
    if f"{pref}patch_embedding.bias" in sd:
        patch["b"] = t("patch_embedding.bias")
    tree = {"patch_embedding": patch, "cls_embedding": t("cls_embedding"),
            "pos_embedding": t("pos_embedding"), "pre_norm": wb("pre_norm"),
            "blocks": [block(i) for i in range(cfg.num_layers)]}
    return ClipVision(cfg, tree)


_CLIP_NAMES = {"fc1": "0", "fc2": "2"}  # the MLP is a Sequential in the reference


def torch_state_dict_from_params(clip: ClipVision, prefix: str = "visual.") -> dict:
    """The inverse of `params_from_torch_state_dict`: the tower's tensors
    under the reference's names, below `prefix`. For writing checkpoints."""
    cfg = clip.cfg
    out = {}
    for name, p in clip.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            parts[0] = "transformer"
        parts = [_CLIP_NAMES.get(x, x) for x in parts]
        parts[-1] = {"w": "weight", "b": "bias"}.get(parts[-1], parts[-1])
        t = p.detach()
        if name == "patch_embedding.w":
            t = t.reshape(cfg.dim, 3, cfg.patch_size, cfg.patch_size)
        out[prefix + ".".join(parts)] = t
    return out
