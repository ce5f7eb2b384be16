"""Wan 2.1 video diffusion transformer (DiT), bf16, forward and training.

Port of svi_tpu/models/wan_dit.py: configs, seeded init, patchify /
unpatchify, time embedding, the plain DiT block (self-attention with 3D RoPE
through the flash kernel, text + image cross-attention), the CLIP-feature
MLP, the head, the split prelude / blocks / head forward that TeaCache
needs, the unfused LoRA side path of training, rematerialisation of the
block stack (per block, or in square-root groups), and quantized inference:
the weight quantizers (`quantize_params_for_inference`, modes
`QUANTIZE_MODES`), the dense's quantized branches with the int8 execution
(W4A8 through `ops.quant_matmul.w4a8_linear`, W8A8 through `_int8_exec`),
and the int8 self-attention forward (`WanDiTConfig.attention_quant`); and
the reference's checkpoints (`config_from_state_dict`,
`params_from_torch_state_dict`, quantize-on-load, and the inverse for
writing them). Multitalk/customtalk, the save-attention remat policy and
host-offloaded carries are not part of this port.
Activations are in cfg.dtype; norm and softmax statistics f32; base weights
are frozen.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import div_exact, flash_attention, flash_attention_flat
from ..ops.norms import gelu_tanh, layer_norm, modulate, rms_norm
from ..ops.quant_matmul import unpack_int4, unpack_requant_int4, w4a8_linear
from ..ops.rope import rope_angles_for_grid, sinusoidal_embedding_1d
from .params import Init, ParamTree, convert_tree, unstack


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
    # int8 SELF-attention forward: "none" | "qk8" | "qk8pv8" (K6,
    # ops.attention.flash_fwd_flat_q8). Inference only: a backward through it
    # raises, and the trainer refuses it.
    attention_quant: str = "none"

    def __post_init__(self):
        if self.attention_quant not in ("none", "qk8", "qk8pv8"):
            raise ValueError(f"attention_quant={self.attention_quant!r}: expected 'none', "
                             "'qk8', or 'qk8pv8'")

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


WAN_1_3B_T2V = WanDiTConfig()
WAN_14B_T2V = WanDiTConfig(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)
WAN_14B_I2V = WanDiTConfig(
    dim=5120, in_dim=36, ffn_dim=13824, num_heads=40, num_layers=40, has_image_input=True
)


def _int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, exact, for W8A8's
    `_int8_exec` (W4A8 runs its own GEMM, `w4a8_linear`). The JAX package
    leaves this product to XLA; here it is torch._int_mm (cuBLASLt on the
    card), with w.t() as the column-major operand, so no copy of w is made.
    cuBLASLt needs M > 16: the time-embedding linears run at M = batch, so
    their rows are padded with zeros to 17 (each int32 row is computed on its
    own) and cut off again."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        return torch._int_mm(F.pad(a, (0, 0, 0, 17 - m)), w.t())[:m]
    return torch._int_mm(a, w.t())


class _Int8Exec(torch.autograd.Function):
    """Dynamic per-token int8 activations x int8 weights (`_int8_exec`):
    y = (Qtok(x) @ w8iᵀ) · xs · col_scale ≈ x @ (w8i · col_scale)ᵀ. w8i is
    (out, in) int8, col_scale (out, 1) f32. The backward is the
    straight-through linearization dx = (g · col_scale) @ w8i in g's dtype
    (`_int8_exec_bwd`); the weights get no gradient."""

    @staticmethod
    def forward(ctx, x, w8i, col_scale):
        ctx.save_for_backward(w8i, col_scale)
        xf = x.float()
        xs = div_exact(xf.abs().amax(-1, keepdim=True), 127.0) + 1e-12
        xq = torch.round(xf / xs).clamp_(-127, 127).to(torch.int8)
        y32 = _int8_matmul(xq.reshape(-1, xq.shape[-1]), w8i).reshape(*x.shape[:-1], -1)
        return (y32.float() * xs * col_scale.reshape(-1)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        w8i, col_scale = ctx.saved_tensors
        return _straight_through_dx(g, w8i, col_scale), None, None


def _straight_through_dx(g: torch.Tensor, w8i: torch.Tensor, col_scale: torch.Tensor):
    """`_int8_exec_bwd`: dx = (g · col_scale) @ w8i in g's dtype."""
    return (g * col_scale.reshape(-1).to(g.dtype)) @ w8i.to(g.dtype)


def _int8_exec(x: torch.Tensor, w8i: torch.Tensor, col_scale: torch.Tensor) -> torch.Tensor:
    return _Int8Exec.apply(x, w8i, col_scale)


class _W4A8Exec(torch.autograd.Function):
    """The W4A8 branch of `_dense`: K3's unpack, `_int8_exec` and the bias in
    one forward, `ops.quant_matmul.w4a8_linear` (its GEMM unpacks the int4
    weight in shared memory). It saves the packed weight and its ratios; the
    backward is `_int8_exec`'s straight-through dx = (g · s8) @ w8i, with w8i
    unpacked by the standalone K3, and the bias's gradient the sum of g."""

    @staticmethod
    def forward(ctx, x, w_q4, r_q4, s8_q4, b):
        ctx.save_for_backward(w_q4, r_q4, s8_q4)
        ctx.bias_dtype = None if b is None else b.dtype
        return w4a8_linear(x, w_q4, r_q4, s8_q4, b)

    @staticmethod
    def backward(ctx, g):
        w_q4, r_q4, s8_q4 = ctx.saved_tensors
        dx = _straight_through_dx(g, unpack_requant_int4(w_q4, r_q4), s8_q4)
        db = None
        if ctx.needs_input_grad[4]:
            db = g.reshape(-1, g.shape[-1]).float().sum(0).to(ctx.bias_dtype)
        return dx, None, None, None, db


def _plus_bias(p: ParamTree, y: torch.Tensor) -> torch.Tensor:
    b = p.get("b")
    return y if b is None else y + b.to(y.dtype)


def dense(p: ParamTree, x: torch.Tensor) -> torch.Tensor:
    """The DiT's linear layer (`_dense`) over whichever weight the leaf holds,
    all (out, in):
      * w_q4 + r_q4 (W4A8): `w4a8_linear` (the int4 weight unpacked and
        requantized to per-channel int8 inside the int8 GEMM, whose epilogue
        applies `_int8_exec`'s scales with s8_q4 and the bias);
      * w_q4 alone (int4 storage): dequantized in x's dtype (the product is
        rounded to x's dtype, as the JAX package does) for a plain matmul;
      * w_q8 (W8A8): `_int8_exec` with scale8;
      * w_q (int8 storage): dequantized in x's dtype;
      * w: x @ wᵀ + b."""
    if "w_q4" in p:
        if "r_q4" in p:
            return _W4A8Exec.apply(x, p["w_q4"], p["r_q4"], p["s8_q4"], p.get("b"))
        scale = p["scale_q4"]  # (out, in // G)
        w8 = unpack_int4(p["w_q4"])
        n, k = w8.shape
        w = (w8.reshape(n, scale.shape[1], -1).to(x.dtype)
             * scale[:, :, None].to(x.dtype)).reshape(n, k)
        return _plus_bias(p, F.linear(x, w))
    if "w_q8" in p:
        return _plus_bias(p, _int8_exec(x, p["w_q8"], p["scale8"]))
    if "w_q" in p:
        return _plus_bias(p, F.linear(x, p["w_q"].to(x.dtype) * p["scale"].to(x.dtype)))
    return F.linear(x, p["w"], p.get("b"))


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
        quant = None if cfg.attention_quant == "none" else cfg.attention_quant
        o = flash_attention_flat(q, k, v, cfg.head_dim, cos=cos, sin=sin, quant=quant)
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


_QUANT_LEAVES = ("w_q4", "scale_q4", "r_q4", "s8_q4", "w_q8", "scale8", "w_q", "scale")
_F32_LEAVES = frozenset(("scale_q4", "r_q4", "s8_q4", "scale8", "scale"))


def _dit_leaf(path: tuple, arr):
    """JAX (in, out) linears -> (out, in); every 2-D quantized leaf is
    transposed the same way, and made contiguous for the kernels."""
    if arr.ndim != 2:
        return arr
    if path[-1] == "w":
        return arr.T
    return np.ascontiguousarray(arr.T) if path[-1] in _QUANT_LEAVES else arr


def params_from_jax(params: dict, cfg: WanDiTConfig) -> WanDiT:
    """The svi_tpu pytree (after jax.tree.map(np.asarray, ...)) -> WanDiT:
    block arrays unstacked, (in, out) linears transposed. A quantized tree
    (quantize_params_int4 / _w8a8 / _int8) comes across in the port's layout:
    w_q4 (out, in/2), scale_q4 and r_q4 (out, in/G), s8_q4, scale8 and scale
    (out, 1), w_q8 and w_q (out, in); the scales stay f32."""
    tree = dict(params)
    tree["blocks"] = unstack(params["blocks"], cfg.num_layers)
    return WanDiT(cfg, convert_tree(tree, cfg.dtype, _dit_leaf, keep_f32=_F32_LEAVES))


# ---------------------------------------------------------------------------
# Quantized weights for inference
# ---------------------------------------------------------------------------

INT4_GROUP = 128  # inputs per int4 quantization group

QUANTIZE_MODES = ("int8", "w8a8", "int4", "int4_w4a8")


def _quantize_leaf_int4(w: torch.Tensor, group: int = INT4_GROUP):
    """(out, in) float -> packed (out, in // 2) int8 + (out, in // group) f32
    scales (`_quantize_leaf_int4`, transposed). Symmetric per group:
    q = clip(round(w / scale), -8, 7), scale = max|w| over the group / 7.
    HALF-SPLIT packing: byte [n, i] holds inputs i and i + in // 2 as its
    (low, high) nibbles. Runs on w's device."""
    cout, cin = w.shape
    if cin % 2 or cin % group:
        raise ValueError(f"int4 quantization needs in ({cin}) divisible by 2 and by the "
                         f"group ({group})")
    wf = w.to(torch.float32).reshape(cout, cin // group, group)
    scale = div_exact(wf.abs().amax(-1), 7.0).clamp_min(1e-12)  # (out, in // G)
    q = torch.round(wf / scale[:, :, None]).clamp_(-8, 7).to(torch.int16).reshape(cout, cin)
    packed = (q[:, :cin // 2] & 0xF) | ((q[:, cin // 2:] & 0xF) << 4)  # bytes as 0..255
    packed = torch.where(packed > 127, packed - 256, packed).to(torch.int8)
    return packed, scale


def _w4a8_leaves(scale: torch.Tensor):
    """Per-output-channel int8 execution scales for W4A8 from the int4 group
    scales (`_w4a8_leaves`). scale: (out, in // G). Returns (r, s8): r =
    scale / smax · 127/7 (out, in // G), so the requantized |w4 · r| <= 127,
    and s8 = smax · 7/127 (out, 1), the per-channel int8 dequantization
    scale."""
    smax = scale.amax(-1, keepdim=True).clamp_min(1e-12)
    return (scale / smax) * (127.0 / 7.0), smax * (7.0 / 127.0)


def _map_weights(tree, quantize, consume: bool):
    """Rebuild a nested dict/list tree, replacing each dict's "w" leaf for
    which quantize(w) returns new leaves. consume=True takes the leaves out of
    `tree` as it goes, so each float weight is freed once its quantized leaves
    exist (if nothing else holds it)."""
    if isinstance(tree, list):
        out = []
        for i in range(len(tree)):
            item = tree[i]
            if consume:
                tree[i] = None
            out.append(_map_weights(item, quantize, consume))
            del item
        return out
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k in list(tree):
        v = tree.pop(k) if consume else tree[k]
        new = quantize(v) if k == "w" and torch.is_tensor(v) else None
        if new is not None:
            out.update(new)
        elif isinstance(v, (dict, list)):
            out[k] = _map_weights(v, quantize, consume)
        else:
            out[k] = v
        del v
    return out


# Leaf choice: key "w", 2-D, at least min_size elements, and for int4 `in`
# (the LAST dim here) divisible by the group: patch_embedding (in 144) stays
# float under int4 but not under w8a8. The JAX package applies min_size to its
# stacked (L, in, out) block arrays; at the default 1 << 16 every block
# linear is far above it either way.
def _is_linear(w: torch.Tensor, min_size: int) -> bool:
    return w.ndim == 2 and w.numel() >= min_size


def quantize_params_int4(params: dict, min_size: int = 1 << 16, group: int = INT4_GROUP,
                         w4a8: bool = False, consume: bool = False) -> dict:
    """Large linear weights -> packed int4 (w_q4) with group-wise scales
    (scale_q4); w4a8=True adds the per-channel int8 execution scales (r_q4,
    s8_q4), so `dense` runs the product in int8. Small tensors stay as they
    are. Apply after any LoRA fusion."""

    def quantize(w):
        if not (_is_linear(w, min_size) and w.shape[-1] % group == 0):
            return None
        packed, scale = _quantize_leaf_int4(w, group)
        out = {"w_q4": packed, "scale_q4": scale}
        if w4a8:
            out["r_q4"], out["s8_q4"] = _w4a8_leaves(scale)
        return out

    return _map_weights(params, quantize, consume)


def _quantize_int8_channels(w: torch.Tensor):
    """(out, in) float -> int8 (out, in) and per-output-channel f32 scales
    (out, 1): scale = max|w| over the inputs / 127."""
    wf = w.to(torch.float32)
    scale = div_exact(wf.abs().amax(-1, keepdim=True), 127.0).clamp_min(1e-12)
    return torch.round(wf / scale).clamp_(-127, 127).to(torch.int8), scale


def quantize_params_w8a8(params: dict, min_size: int = 1 << 16, consume: bool = False) -> dict:
    """Large linear weights -> int8 (w_q8, scale8) for W8A8 execution: dynamic
    per-token int8 activations at run time (`_int8_exec`)."""

    def quantize(w):
        if not _is_linear(w, min_size):
            return None
        w8, scale = _quantize_int8_channels(w)
        return {"w_q8": w8, "scale8": scale}

    return _map_weights(params, quantize, consume)


def quantize_params_int8(params: dict, min_size: int = 1 << 16, consume: bool = False) -> dict:
    """Large linear weights -> int8 storage (w_q, scale), dequantized per use
    in `dense`; the products stay in x's dtype."""

    def quantize(w):
        if not _is_linear(w, min_size):
            return None
        w8, scale = _quantize_int8_channels(w)
        return {"w_q": w8, "scale": scale}

    return _map_weights(params, quantize, consume)


def quantize_params_for_inference(dit, mode: str, min_size: int = 1 << 16,
                                  group: int = INT4_GROUP, consume: bool = False):
    """Quantize a DiT for inference (`quantize_params_for_inference`). `dit` is
    a WanDiT (returns a new WanDiT with its config) or a nested dict tree
    (returns a dict). `mode` is one of QUANTIZE_MODES: int8 = int8 weight
    storage (matmuls in x's dtype), w8a8 = int8 execution, int4 / int4_w4a8 =
    packed int4 storage, the latter with int8 execution. The work runs block
    by block on the device that holds the weights. consume=True empties `dit`
    and frees each float weight as its quantized leaves are made, so peak
    memory stays below the float model's. Apply after any LoRA fusion."""
    fns = {"int4": lambda t: quantize_params_int4(t, min_size, group, False, consume),
           "int4_w4a8": lambda t: quantize_params_int4(t, min_size, group, True, consume),
           "w8a8": lambda t: quantize_params_w8a8(t, min_size, consume),
           "int8": lambda t: quantize_params_int8(t, min_size, consume)}
    if mode not in fns:
        raise ValueError(f"quantize mode {mode!r}; choose from {QUANTIZE_MODES}")
    if isinstance(dit, WanDiT):
        return WanDiT(dit.cfg, fns[mode](dit.tree(consume=consume)))
    return fns[mode](dit)


# ---------------------------------------------------------------------------
# Checkpoints in the reference's naming (diffsynth's WanModel state dict)
# ---------------------------------------------------------------------------

# the port's names that differ from the reference's, besides w/b for
# weight/bias: the CLIP-feature MLP is a Sequential there
_IMG_EMB_NAMES = {"norm0": "proj.0", "fc1": "proj.1", "fc3": "proj.3", "norm4": "proj.4"}


def config_from_state_dict(sd) -> WanDiTConfig:
    """The architecture from the checkpoint's shapes (`config_from_state_dict`):
    num_heads follows Wan's head_dim of 128 where dim divides, else 32 (tiny
    test configs). A multitalk or customtalk DiT (audio blocks) is not ported
    (Slice D) and raises."""
    keys = set(sd.keys())
    if any("audio" in k or "customtalk" in k for k in keys):
        raise NotImplementedError("the multitalk / customtalk DiT (audio blocks) is not ported "
                                  "yet (Slice D)")
    num_layers = 1 + max(int(k.split(".")[1]) for k in keys
                         if k.startswith("blocks.") and k.split(".")[1].isdigit())
    has_image = "blocks.0.cross_attn.k_img.weight" in keys
    pe = sd["patch_embedding.weight"].shape  # (dim, in_dim, pt, ph, pw)
    dim, in_dim = int(pe[0]), int(pe[1])
    patch = tuple(int(x) for x in pe[2:])
    head_out = int(sd["head.head.weight"].shape[0])
    return WanDiTConfig(
        dim=dim, in_dim=in_dim, ffn_dim=int(sd["blocks.0.ffn.0.weight"].shape[0]),
        out_dim=head_out // (patch[0] * patch[1] * patch[2]),
        text_dim=int(sd["text_embedding.0.weight"].shape[1]),
        freq_dim=int(sd["time_embedding.0.weight"].shape[1]), patch_size=patch,
        num_heads=dim // 128 if dim % 128 == 0 else max(1, dim // 32), num_layers=num_layers,
        has_image_input=has_image,
        clip_feature_dim=int(sd["img_emb.proj.0.weight"].shape[0]) if has_image else 1280)


def config_from_state_dict_keys(keys) -> WanDiTConfig:
    """Key-only variant (no shapes): resolves among the known Wan configs."""
    keys = set(keys)
    if any("audio" in k for k in keys):
        raise NotImplementedError("the multitalk DiT (audio blocks) is not ported yet (Slice D)")
    num_layers = 1 + max(int(k.split(".")[1]) for k in keys
                         if k.startswith("blocks.") and k.split(".")[1].isdigit())
    has_image = "blocks.0.cross_attn.k_img.weight" in keys
    base = (WAN_14B_I2V if has_image else WAN_14B_T2V) if num_layers >= 40 else WAN_1_3B_T2V
    return dataclasses.replace(base, num_layers=num_layers, has_image_input=has_image,
                               in_dim=36 if has_image else 16)


def params_from_torch_state_dict(sd: dict, cfg: WanDiTConfig, device="cuda") -> WanDiT:
    """The reference WanModel state dict (torch tensors, e.g. the CPU views
    `model_io.load_state_dicts` gives) -> WanDiT on `device`, in cfg.dtype.
    The layouts are the port's own, so this renames keys; the patch
    embedding's Conv3d weight (dim, c, pt, ph, pw) becomes the (dim, c·pt·ph·pw)
    linear of `patchify`. Each tensor goes to the device on its own."""

    def t(name):
        return sd[name].to(device=device, dtype=cfg.dtype)

    def lin(prefix):
        p = {"w": t(f"{prefix}.weight")}
        if f"{prefix}.bias" in sd:
            p["b"] = t(f"{prefix}.bias")
        return p

    def norm(prefix, bias=False):
        p = {"w": t(f"{prefix}.weight")}
        if bias:
            p["b"] = t(f"{prefix}.bias")
        return p

    def block(i):
        b = f"blocks.{i}"

        def attn(kind):
            a = {k: lin(f"{b}.{kind}.{k}") for k in ("q", "k", "v", "o")}
            a["norm_q"] = norm(f"{b}.{kind}.norm_q")
            a["norm_k"] = norm(f"{b}.{kind}.norm_k")
            return a

        p = {"self_attn": attn("self_attn"), "cross_attn": attn("cross_attn"),
             "norm3": norm(f"{b}.norm3", bias=True),
             "ffn": {"0": lin(f"{b}.ffn.0"), "2": lin(f"{b}.ffn.2")},
             "modulation": t(f"{b}.modulation")}
        if cfg.has_image_input:
            p["cross_attn"]["k_img"] = lin(f"{b}.cross_attn.k_img")
            p["cross_attn"]["v_img"] = lin(f"{b}.cross_attn.v_img")
            p["cross_attn"]["norm_k_img"] = norm(f"{b}.cross_attn.norm_k_img")
        return p

    tree = {
        "patch_embedding": {"w": t("patch_embedding.weight").reshape(cfg.dim, -1),
                            "b": t("patch_embedding.bias")},
        "text_embedding": {"0": lin("text_embedding.0"), "2": lin("text_embedding.2")},
        "time_embedding": {"0": lin("time_embedding.0"), "2": lin("time_embedding.2")},
        "time_projection": {"1": lin("time_projection.1")},
        "head": {"head": lin("head.head"), "modulation": t("head.modulation")},
        "blocks": [block(i) for i in range(cfg.num_layers)],
    }
    if cfg.has_image_input:
        tree["img_emb"] = {"norm0": norm("img_emb.proj.0", bias=True),
                           "fc1": lin("img_emb.proj.1"), "fc3": lin("img_emb.proj.3"),
                           "norm4": norm("img_emb.proj.4", bias=True)}
    return WanDiT(cfg, tree)


def quantized_params_from_torch_state_dict(sd: dict, cfg: WanDiTConfig, min_size: int = 1 << 16,
                                           group: int = INT4_GROUP, w4a8: bool = False,
                                           device="cuda") -> WanDiT:
    """`quantize_params_for_inference(params_from_torch_state_dict(...))` in
    int4 (w4a8=True: int4_w4a8) with the float weights staged on the host:
    each block moves to `device` and is quantized there on its own, so the
    device never holds the float tree."""
    return quantize_to_device(params_from_torch_state_dict(sd, cfg, device="cpu"),
                              "int4_w4a8" if w4a8 else "int4", device, min_size, group)


def quantize_to_device(dit: WanDiT, mode: str, device, min_size: int = 1 << 16,
                       group: int = INT4_GROUP) -> WanDiT:
    """Quantize a DiT held anywhere (e.g. bf16 on the host) onto `device`,
    one top-level subtree or block at a time: each is copied to the device,
    quantized there (consume=True) and its float weights dropped before the
    next one moves. `dit` is emptied."""
    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        return tree.to(device)

    def quantize(tree):
        return quantize_params_for_inference(move(tree), mode, min_size, group, consume=True)

    cfg, tree = dit.cfg, dit.tree(consume=True)
    out = {}
    for key in list(tree):
        sub = tree.pop(key)
        if key == "blocks":
            out[key] = []
            for i in range(len(sub)):
                out[key].append(quantize(sub[i]))
                sub[i] = None
        else:
            out[key] = quantize(sub) if isinstance(sub, dict) else sub.to(device)
        del sub
    return WanDiT(cfg, out)


def torch_state_dict_from_params(dit: WanDiT) -> dict[str, torch.Tensor]:
    """The inverse of `params_from_torch_state_dict` for a float DiT: its
    tensors under the reference's names (views where the layout agrees; the
    patch embedding back to its Conv3d shape). For writing checkpoints."""
    cfg = dit.cfg
    out = {}
    for name, p in dit.named_parameters():
        parts = name.split(".")
        if parts[-1] not in ("w", "b") and parts[-1] != "modulation":
            raise ValueError(f"{name}: a quantized leaf has no reference name")
        parts[-1] = {"w": "weight", "b": "bias"}.get(parts[-1], parts[-1])
        if parts[0] == "img_emb":
            parts[1] = _IMG_EMB_NAMES[parts[1]]
        t = p.detach()
        if name == "patch_embedding.w":
            t = t.reshape(cfg.dim, cfg.in_dim, *cfg.patch_size)
        out[".".join(parts)] = t
    return out
