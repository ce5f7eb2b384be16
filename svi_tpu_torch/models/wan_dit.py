"""Wan 2.1 video diffusion transformer (DiT), bf16, forward and training.

Port of svi_tpu/models/wan_dit.py: configs, seeded init, patchify /
unpatchify, time embedding, the plain DiT block (self-attention with 3D RoPE
through the flash kernel, text + image cross-attention), the CLIP-feature
MLP, the head, the split prelude / blocks / head forward that TeaCache
needs, the unfused LoRA side path of training, and rematerialisation of the
block stack (per block, or in square-root groups). Quantized weights,
multitalk/customtalk, the save-attention remat policy and host-offloaded
carries are not part of this port. Activations are in cfg.dtype; norm and
softmax statistics f32; base weights are frozen.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import flash_attention, flash_attention_flat
from ..ops.norms import gelu_tanh, layer_norm, modulate, rms_norm
from ..ops.rope import rope_angles_for_grid, sinusoidal_embedding_1d
from .params import Init, ParamTree, convert_tree, dense, linear_leaf, unstack


@dataclasses.dataclass(frozen=True)
class WanDiTConfig:
    dim: int = 1536
    in_dim: int = 16
    ffn_dim: int = 8960
    out_dim: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    eps: float = 1e-6
    patch_size: tuple[int, int, int] = (1, 2, 2)
    num_heads: int = 12
    num_layers: int = 30
    has_image_input: bool = False
    clip_feature_dim: int = 1280
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


WAN_1_3B_T2V = WanDiTConfig()
WAN_14B_T2V = WanDiTConfig(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)
WAN_14B_I2V = WanDiTConfig(
    dim=5120, in_dim=36, ffn_dim=13824, num_heads=40, num_layers=40, has_image_input=True
)


def dense_lora(p: ParamTree, x: torch.Tensor, lora, scale: float) -> torch.Tensor:
    """Dense with an unfused LoRA side path (`_dense_lora`): y = xW + scale·((xA)B),
    A (in, r) and B (r, out) cast to x's dtype; the f32 masters stay with the
    optimizer."""
    y = dense(p, x)
    if lora is not None:
        y = y + ((x @ lora["a"].to(x.dtype)) @ lora["b"].to(x.dtype)) * scale
    return y


def _l(lora, key):
    return None if lora is None else lora.get(key)


def pick_remat_group(num_layers: int) -> int:
    """Divisor of num_layers closest to sqrt(num_layers) (sqrt-remat group)."""
    best = 1
    target = num_layers ** 0.5
    for g in range(1, num_layers + 1):
        if num_layers % g == 0 and abs(g - target) < abs(best - target):
            best = g
    return best


class WanDiT(ParamTree):
    def __init__(self, cfg: WanDiTConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    # -- pieces ---------------------------------------------------------------

    def patchify(self, x: torch.Tensor):
        """x: (b, c, f, h, w) -> tokens (b, f'*h'*w', dim), grid (f', h', w').
        Token features in (c, kt, kh, kw) order, the Conv3d weight layout."""
        b, c, f, h, w = x.shape
        pt, ph, pw = self.cfg.patch_size
        fg, hg, wg = f // pt, h // ph, w // pw
        xp = x.reshape(b, c, fg, pt, hg, ph, wg, pw).permute(0, 2, 4, 6, 1, 3, 5, 7)
        xp = xp.reshape(b, fg * hg * wg, c * pt * ph * pw)
        return dense(self["patch_embedding"], xp), (fg, hg, wg)

    def unpatchify(self, x: torch.Tensor, grid) -> torch.Tensor:
        """tokens (b, S, out_dim*prod(patch)) -> (b, out_dim, f, h, w); token
        features in (kt, kh, kw, c) order."""
        b = x.shape[0]
        fg, hg, wg = grid
        pt, ph, pw = self.cfg.patch_size
        c = self.cfg.out_dim
        x = x.reshape(b, fg, hg, wg, pt, ph, pw, c).permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(b, c, fg * pt, hg * ph, wg * pw)

    def time_inputs(self, timestep: torch.Tensor, dtype):
        """t embedding (b, d) and t_mod (b, 6, d)."""
        emb = sinusoidal_embedding_1d(self.cfg.freq_dim, timestep).to(dtype)
        t = dense(self["time_embedding"]["0"], emb)
        t = F.silu(t.float()).to(dtype)
        t = dense(self["time_embedding"]["2"], t)
        tp = F.silu(t.float()).to(dtype)
        t_mod = dense(self["time_projection"]["1"], tp).reshape(t.shape[0], 6, self.cfg.dim)
        return t, t_mod

    def _self_attention(self, p, x, cos, sin, lora=None, lora_scale: float = 1.0):
        cfg = self.cfg
        # q/k RMS norm over the full dim, before the heads are split
        q = rms_norm(dense_lora(p["q"], x, _l(lora, "q"), lora_scale), p["norm_q"]["w"],
                     eps=cfg.eps)
        k = rms_norm(dense_lora(p["k"], x, _l(lora, "k"), lora_scale), p["norm_k"]["w"],
                     eps=cfg.eps)
        v = dense_lora(p["v"], x, _l(lora, "v"), lora_scale)
        o = flash_attention_flat(q, k, v, cfg.head_dim, cos=cos, sin=sin)
        return dense_lora(p["o"], o, _l(lora, "o"), lora_scale)

    def _cross_attention(self, p, x, ctx, num_img_tokens: int, lora=None,
                         lora_scale: float = 1.0):
        """Text (+ image) cross attention; ctx = [image tokens | text tokens]."""
        cfg = self.cfg
        b, s, d = x.shape
        n, hd = cfg.num_heads, cfg.head_dim
        if cfg.has_image_input:
            img, txt = ctx[:, :num_img_tokens], ctx[:, num_img_tokens:]
        else:
            img, txt = None, ctx
        q = rms_norm(dense_lora(p["q"], x, _l(lora, "q"), lora_scale), p["norm_q"]["w"],
                     eps=cfg.eps).reshape(b, s, n, hd)
        k = rms_norm(dense_lora(p["k"], txt, _l(lora, "k"), lora_scale), p["norm_k"]["w"],
                     eps=cfg.eps)
        v = dense_lora(p["v"], txt, _l(lora, "v"), lora_scale)
        lk = txt.shape[1]
        o = flash_attention(q, k.reshape(b, lk, n, hd), v.reshape(b, lk, n, hd))
        if img is not None:
            k_img = rms_norm(dense(p["k_img"], img), p["norm_k_img"]["w"], eps=cfg.eps)
            v_img = dense(p["v_img"], img)
            li = img.shape[1]
            o = o + flash_attention(q, k_img.reshape(b, li, n, hd), v_img.reshape(b, li, n, hd))
        return dense_lora(p["o"], o.reshape(b, s, d), _l(lora, "o"), lora_scale)

    def dit_block(self, p, x, context, t_mod, cos, sin, num_img_tokens: int = 257, lora=None,
                  lora_scale: float = 1.0):
        """One adaLN-modulated DiT block; `lora` is this block's adapters or None."""
        cfg = self.cfg
        mod = p["modulation"].to(t_mod.dtype) + t_mod  # (b, 6, d)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            mod[:, i:i + 1] for i in range(6))
        input_x = modulate(layer_norm(x, eps=1e-6), shift_msa, scale_msa)
        x = x + gate_msa * self._self_attention(p["self_attn"], input_x, cos, sin,
                                                _l(lora, "self_attn"), lora_scale)
        x = x + self._cross_attention(
            p["cross_attn"], layer_norm(x, p["norm3"]["w"], p["norm3"]["b"], eps=cfg.eps),
            context, num_img_tokens, _l(lora, "cross_attn"), lora_scale)
        input_x = modulate(layer_norm(x, eps=1e-6), shift_mlp, scale_mlp)
        ffn_lora = _l(lora, "ffn")
        h = gelu_tanh(dense_lora(p["ffn"]["0"], input_x, _l(ffn_lora, "0"), lora_scale))
        return x + gate_mlp * dense_lora(p["ffn"]["2"], h, _l(ffn_lora, "2"), lora_scale)

    def _img_mlp(self, x: torch.Tensor) -> torch.Tensor:
        """CLIP-feature MLP: LN, Linear, GELU (exact, f32), Linear, LN."""
        p = self["img_emb"]
        x = layer_norm(x, p["norm0"]["w"], p["norm0"]["b"], eps=1e-5)
        x = dense(p["fc1"], x)
        x = F.gelu(x.float()).to(x.dtype)
        x = dense(p["fc3"], x)
        return layer_norm(x, p["norm4"]["w"], p["norm4"]["b"], eps=1e-5)

    def apply_head(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        p = self["head"]
        mod = p["modulation"].to(t.dtype) + t[:, None, :]
        shift, scale = mod[:, 0:1], mod[:, 1:2]
        return dense(p["head"], layer_norm(x, eps=self.cfg.eps) * (1 + scale) + shift)

    # -- split forward ----------------------------------------------------------

    def forward_prelude(self, x, timestep, context, clip_feature=None, y=None):
        """Everything before the block stack. Returns (tokens, ctx, t, t_mod, grid)."""
        cfg = self.cfg
        dtype = cfg.dtype
        x = x.to(dtype)
        if timestep.ndim == 0:
            timestep = timestep[None]
        t, t_mod = self.time_inputs(timestep, dtype)
        ctx = dense(self["text_embedding"]["0"], context.to(dtype))
        ctx = gelu_tanh(ctx)
        ctx = dense(self["text_embedding"]["2"], ctx)
        if cfg.has_image_input:
            x = torch.cat([x, y.to(dtype)], dim=1)
            clip_emb = self._img_mlp(clip_feature.to(dtype))
            ctx = torch.cat([clip_emb, ctx], dim=1)
        tokens, grid = self.patchify(x)
        return tokens, ctx, t, t_mod, grid

    def forward_blocks(self, tokens, ctx, t_mod, grid, num_img_tokens: int = 257, lora=None,
                       lora_scale: float = 1.0, use_remat: bool = False,
                       remat_granularity: int = 1, save_attention: bool = False,
                       offload_carries: bool = False):
        """The block stack. lora: the adapters (training.lora), whose
        ["blocks"][i] feeds block i. use_remat: each block runs under
        torch.utils.checkpoint, so only its input carry is saved; with
        remat_granularity g > 1 dividing the depth (and below it), groups of g
        blocks are checkpointed around the per-block checkpoints, saving L/g
        + g carries instead of L (`scan_blocks_remat`)."""
        if save_attention or offload_carries:
            raise NotImplementedError(
                "save_attention and offload_carries are not ported yet (ROADMAP)")
        cos, sin = rope_angles_for_grid(tuple(grid), self.cfg.head_dim)
        cos = torch.from_numpy(cos).to(tokens.device)
        sin = torch.from_numpy(sin).to(tokens.device)
        blocks = self["blocks"]
        lora_blocks = None if lora is None else lora["blocks"]

        def run(tok, i):
            lbp = None if lora_blocks is None else lora_blocks[i]
            return self.dit_block(blocks[i], tok, ctx, t_mod, cos, sin, num_img_tokens, lbp,
                                  lora_scale)

        def run_remat(tok, i):
            return checkpoint(run, tok, i, use_reentrant=False)

        n = len(blocks)
        group = remat_granularity if use_remat else None
        if not group or group <= 1 or n % group or n == group:
            step = run_remat if use_remat else run
            for i in range(n):
                tokens = step(tokens, i)
            return tokens

        def run_group(tok, first):
            for i in range(first, first + group):
                tok = run_remat(tok, i)
            return tok

        for first in range(0, n, group):
            tokens = checkpoint(run_group, tokens, first, use_reentrant=False)
        return tokens

    def forward_head(self, tokens, t, grid):
        return self.unpatchify(self.apply_head(tokens, t), grid)

    def forward(self, x, timestep, context, clip_feature=None, y=None, lora=None,
                lora_scale: float = 1.0, use_remat: bool = False, remat_granularity: int = 1,
                save_attention: bool = False, offload_carries: bool = False):
        """x: (b, in_dim - y channels, f, h, w) latents; timestep (b,) or scalar;
        context (b, L, text_dim); clip_feature (b, 257, clip_dim); y: (b, c, f, h, w).
        The rest as `forward_blocks` (training)."""
        tokens, ctx, t, t_mod, grid = self.forward_prelude(x, timestep, context, clip_feature, y)
        n_img = clip_feature.shape[1] if (self.cfg.has_image_input
                                          and clip_feature is not None) else 257
        tokens = self.forward_blocks(tokens, ctx, t_mod, grid, num_img_tokens=n_img, lora=lora,
                                     lora_scale=lora_scale, use_remat=use_remat,
                                     remat_granularity=remat_granularity,
                                     save_attention=save_attention,
                                     offload_carries=offload_carries)
        return self.forward_head(tokens, t, grid)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def init_params(cfg: WanDiTConfig, seed: int = 0, device="cuda") -> WanDiT:
    """Seeded random weights with the JAX package's distributions (init_params)."""
    r = Init(seed, device, cfg.dtype)
    d, f = cfg.dim, cfg.ffn_dim
    pt, ph, pw = cfg.patch_size

    def block():
        attn = lambda: {"q": r.linear(d, d), "k": r.linear(d, d), "v": r.linear(d, d),  # noqa: E731
                        "o": r.linear(d, d), "norm_q": {"w": r.ones((d,))},
                        "norm_k": {"w": r.ones((d,))}}
        p = {
            "self_attn": attn(),
            "cross_attn": attn(),
            "norm3": {"w": r.ones((d,)), "b": r.zeros((d,))},
            "ffn": {"0": r.linear(d, f), "2": r.linear(f, d)},
            "modulation": r.normal((1, 6, d), d ** -0.5),
        }
        if cfg.has_image_input:
            p["cross_attn"]["k_img"] = r.linear(d, d)
            p["cross_attn"]["v_img"] = r.linear(d, d)
            p["cross_attn"]["norm_k_img"] = {"w": r.ones((d,))}
        return p

    tree = {
        "patch_embedding": r.linear(cfg.in_dim * pt * ph * pw, d),
        "text_embedding": {"0": r.linear(cfg.text_dim, d), "2": r.linear(d, d)},
        "time_embedding": {"0": r.linear(cfg.freq_dim, d), "2": r.linear(d, d)},
        "time_projection": {"1": r.linear(d, d * 6)},
        "head": {"head": r.linear(d, cfg.out_dim * pt * ph * pw),
                 "modulation": r.normal((1, 2, d), d ** -0.5)},
        "blocks": [block() for _ in range(cfg.num_layers)],
    }
    if cfg.has_image_input:
        cd = cfg.clip_feature_dim
        tree["img_emb"] = {
            "norm0": {"w": r.ones((cd,)), "b": r.zeros((cd,))},
            "fc1": r.linear(cd, cd),
            "fc3": r.linear(cd, d),
            "norm4": {"w": r.ones((d,)), "b": r.zeros((d,))},
        }
    return WanDiT(cfg, tree)


def params_from_jax(params: dict, cfg: WanDiTConfig) -> WanDiT:
    """The svi_tpu pytree (after jax.tree.map(np.asarray, ...)) -> WanDiT:
    block arrays unstacked, (in, out) linears transposed."""
    tree = dict(params)
    tree["blocks"] = unstack(params["blocks"], cfg.num_layers)
    return WanDiT(cfg, convert_tree(tree, cfg.dtype, linear_leaf))
