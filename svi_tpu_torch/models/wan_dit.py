"""Wan 2.1 video diffusion transformer (DiT), bf16, forward and training.

Port of svi_tpu/models/wan_dit.py: configs, seeded init, patchify /
unpatchify, time embedding, the plain DiT block (self-attention with 3D RoPE
through the flash kernel, text + image cross-attention), the CLIP-feature
MLP, the head, the split prelude / blocks / head forward that TeaCache
needs, the unfused LoRA side path of training, rematerialisation of the
block stack (per block, or in square-root groups), the audio variants
(`enable_multitalk`: a per-frame audio cross-attention after the text one;
`enable_customtalk`: bottleneck FFNs that gate the text and audio
attentions' inputs, each block's audio output carried to the next as its
`add_condition`; both fed by `audio_proj_forward`), the pose tokens of
SVI-Dance (`add_condition`, added to the patch tokens), and quantized
inference:
the weight quantizers (`quantize_params_for_inference`, modes
`QUANTIZE_MODES`), the dense's quantized branches with the int8 execution
(W4A8 through `ops.quant_matmul.w4a8_linear`, W8A8 through `_int8_exec`),
and the int8 self-attention forward (`WanDiTConfig.attention_quant`); and
the reference's checkpoints (`config_from_state_dict`,
`params_from_torch_state_dict`, quantize-on-load, and the inverse for
writing them); in training, the save-attention remat policy and carries
offloaded to host memory; the multi-speaker audio attention
(`WanDiT.single_stream_multi_attention`, which no pipeline calls, as in the
JAX package) and `init_params_int4`, a quantized tree made on the device
without the float one. Activations are in cfg.dtype; norm and softmax statistics f32; base weights
are frozen.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint, create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..ops.attention import (div_exact, flash_attention, flash_attention_flat,
                             save_attention_policy)
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
    enable_multitalk: bool = False
    enable_customtalk: bool = False
    clip_feature_dim: int = 1280
    audio_hidden_dim: int = 768
    audio_context_tokens: int = 32
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

    @property
    def has_audio(self) -> bool:
        return self.enable_multitalk or self.enable_customtalk


WAN_1_3B_T2V = WanDiTConfig()
WAN_14B_T2V = WanDiTConfig(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)
WAN_14B_I2V = WanDiTConfig(
    dim=5120, in_dim=36, ffn_dim=13824, num_heads=40, num_layers=40, has_image_input=True
)
WAN_14B_I2V_MULTITALK = dataclasses.replace(WAN_14B_I2V, enable_multitalk=True)


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
                  lora_scale: float = 1.0, audio_embed=None, num_frames: int = 0,
                  add_condition=None):
        """One adaLN-modulated DiT block; `lora` is this block's adapters or
        None. With audio_embed (b, f, 32, 768) a multitalk block adds the
        per-frame audio cross-attention after the text one; a customtalk
        block gates both attentions' inputs with its bottleneck FFNs (the
        text one's from add_condition) and returns (x, its audio-attention
        output), which the next block takes as add_condition."""
        cfg = self.cfg
        mod = p["modulation"].to(t_mod.dtype) + t_mod  # (b, 6, d)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            mod[:, i:i + 1] for i in range(6))
        input_x = modulate(layer_norm(x, eps=1e-6), shift_msa, scale_msa)
        x = x + gate_msa * self._self_attention(p["self_attn"], input_x, cos, sin,
                                                _l(lora, "self_attn"), lora_scale)
        x_a = None
        if cfg.enable_customtalk and audio_embed is not None:
            def pre_ffn(fp, v):
                return dense(fp["2"], gelu_tanh(dense(fp["0"], v)))

            cond_in = add_condition if add_condition is not None else x
            x_in_ctx = x + pre_ffn(p["customtalk_context_pre_ffns"],
                                   layer_norm(cond_in, eps=cfg.eps))
            x_c = self._cross_attention(
                p["cross_attn"],
                layer_norm(x_in_ctx, p["norm3"]["w"], p["norm3"]["b"], eps=cfg.eps),
                context, num_img_tokens, _l(lora, "cross_attn"), lora_scale)
            x = x + x_c
            x_in_audio = x + pre_ffn(p["customtalk_audio_pre_ffns"], layer_norm(x_c, eps=cfg.eps))
            x_a = self._audio_cross_attention(
                p["audio_cross_attn"],
                layer_norm(x_in_audio, p["norm_x"]["w"], p["norm_x"]["b"], eps=cfg.eps),
                audio_embed, num_frames)
            x = x + x_a
        else:
            x = x + self._cross_attention(
                p["cross_attn"], layer_norm(x, p["norm3"]["w"], p["norm3"]["b"], eps=cfg.eps),
                context, num_img_tokens, _l(lora, "cross_attn"), lora_scale)
            if cfg.enable_multitalk and audio_embed is not None:
                xa = layer_norm(x, p["norm_x"]["w"], p["norm_x"]["b"], eps=cfg.eps)
                x = x + self._audio_cross_attention(p["audio_cross_attn"], xa, audio_embed,
                                                    num_frames)
        input_x = modulate(layer_norm(x, eps=1e-6), shift_mlp, scale_mlp)
        ffn_lora = _l(lora, "ffn")
        h = gelu_tanh(dense_lora(p["ffn"]["0"], input_x, _l(ffn_lora, "0"), lora_scale))
        x = x + gate_mlp * dense_lora(p["ffn"]["2"], h, _l(ffn_lora, "2"), lora_scale)
        return x if x_a is None else (x, x_a)

    def _audio_cross_attention(self, p, x, audio, num_frames: int):
        """Per-frame audio cross-attention (`_audio_cross_attention`): the
        video tokens of each latent frame attend to that frame's audio tokens
        (32), logits and softmax in f32, no q/k norm."""
        cfg = self.cfg
        b, s_all, d = x.shape
        s = s_all // num_frames
        n, hd = cfg.num_heads, cfg.head_dim
        bf = b * num_frames
        q = dense(p["q_linear"], x.reshape(bf, s, d)).reshape(bf, s, n, hd)
        na = audio.shape[2]
        kv = dense(p["kv_linear"], audio.reshape(bf, na, -1).to(x.dtype)).reshape(bf, na, 2, n, hd)
        k, v = kv[:, :, 0], kv[:, :, 1]
        logits = torch.einsum("bsnd,bknd->bnsk", q.float(), k.float()) * hd ** -0.5
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.einsum("bnsk,bknd->bsnd", probs, v).reshape(bf, s, d)
        return dense(p["proj"], o).reshape(b, s_all, d)

    def single_stream_multi_attention(self, p, x, audio, num_frames: int,
                                      x_ref_attn_map=None, human_num: int = 1,
                                      class_range: int = 24, class_interval: int = 4):
        """The multi-speaker per-frame audio cross-attention
        (`single_stream_multi_attention`): x (b, N_t * S, d); audio (b, N_t,
        N_a, 768), the speakers' windows concatenated (the first half of the
        N_a tokens speaker 1's, the second half speaker 2's);
        x_ref_attn_map (classes, N_t * S), each token's affinity to each
        speaker (`utils.multitalk.get_attn_map_with_target`). Each video
        token's query is rotated by a 1-D RoPE at its speaker's class label
        (its affinity rescaled into that speaker's range, or the background
        label), each audio key at its speaker's class centre; then the
        per-frame attention of `_audio_cross_attention`, logits and softmax
        in f32. With human_num 1 or no map it is `_audio_cross_attention`."""
        if human_num == 1 or x_ref_attn_map is None:
            return self._audio_cross_attention(p, x, audio, num_frames)
        from ..utils.multitalk import normalize_and_scale, rope_1d

        cfg = self.cfg
        b, s_all, d = x.shape
        f = num_frames
        s = s_all // f
        n, hd = cfg.num_heads, cfg.head_dim
        rope_h1 = (0, class_interval)
        rope_h2 = (class_range - class_interval, class_range)
        q = dense(p["q_linear"], x.reshape(b * f, s, d)).reshape(b * f, s, n, hd)

        # each token's position: its speaker's rescaled affinity, or the background's
        m = x_ref_attn_map.float()
        human1 = normalize_and_scale(m[0], (m[0].min(), m[0].max()), rope_h1)
        human2 = normalize_and_scale(m[1], (m[1].min(), m[1].max()), rope_h2)
        back = torch.full((s_all,), float(class_range // 2), device=x.device)
        normalized_map = torch.stack([human1, human2, back], dim=1)  # (N_t * S, 3)
        pos = normalized_map.gather(1, m.argmax(0)[:, None])[:, 0]
        q = rope_1d(q.reshape(b, f * s, n, hd).transpose(1, 2), pos)
        q = q.transpose(1, 2).reshape(b * f, s, n, hd)

        na = audio.shape[2]
        kv = dense(p["kv_linear"], audio.reshape(b * f, na, -1).to(x.dtype)).reshape(
            b * f, na, 2, n, hd)
        k, v = kv[:, :, 0], kv[:, :, 1]
        # the audio keys at their speaker's class centre
        per_frame = torch.cat([
            torch.full((na // 2,), (rope_h1[0] + rope_h1[1]) / 2, device=x.device),
            torch.full((na - na // 2,), (rope_h2[0] + rope_h2[1]) / 2, device=x.device)])
        k = rope_1d(k.reshape(b, f * na, n, hd).transpose(1, 2), per_frame.repeat(f))
        k = k.transpose(1, 2).reshape(b * f, na, n, hd)

        logits = torch.einsum("bsnd,bknd->bnsk", q.float(), k.float()) * hd ** -0.5
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        o = torch.einsum("bnsk,bknd->bsnd", probs, v).reshape(b * f, s, d)
        return dense(p["proj"], o).reshape(b, s_all, d)

    def audio_proj_forward(self, audio_first: torch.Tensor, audio_vf: torch.Tensor):
        """AudioProjModel (`audio_proj_forward`): the wav2vec2 windows of the
        first frame (b, 1, 5, 12, 768) and of each later group of 4 frames
        (b, n_t - 1, 8, 12, 768), cast to the DiT's dtype first, -> context
        tokens (b, n_t, 32, 768)."""
        cfg = self.cfg
        p = self["audio_proj"]
        b, f1 = audio_first.shape[:2]
        fv = audio_vf.shape[1]
        a = F.relu(dense(p["proj1"], audio_first.to(cfg.dtype).reshape(b, f1, -1)))
        av = F.relu(dense(p["proj1_vf"], audio_vf.to(cfg.dtype).reshape(b, fv, -1)))
        x = F.relu(dense(p["proj2"], torch.cat([a, av], dim=1)))
        x = dense(p["proj3"], x).reshape(b, f1 + fv, cfg.audio_context_tokens,
                                         cfg.audio_hidden_dim)
        return layer_norm(x, p["norm"]["w"], p["norm"]["b"], eps=1e-5)

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

    def forward_prelude(self, x, timestep, context, clip_feature=None, y=None,
                        add_condition=None):
        """Everything before the block stack; add_condition (b, S, dim), the
        pose tokens of SVI-Dance, is added to the patch tokens. Returns
        (tokens, ctx, t, t_mod, grid)."""
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
        if add_condition is not None:
            tokens = add_condition.to(dtype) + tokens
        return tokens, ctx, t, t_mod, grid

    def forward_blocks(self, tokens, ctx, t_mod, grid, num_img_tokens: int = 257, lora=None,
                       lora_scale: float = 1.0, use_remat: bool = False,
                       remat_granularity: int = 1, save_attention: bool = False,
                       offload_carries: bool = False, audio_embed=None,
                       block_add_condition=None):
        """The block stack. lora: the adapters (training.lora), whose
        ["blocks"][i] feeds block i. use_remat: each block runs under
        torch.utils.checkpoint, so only its input carry is saved; with
        remat_granularity g > 1 dividing the depth (and below it), groups of g
        blocks are checkpointed around the per-block checkpoints, saving L/g
        + g carries instead of L (`scan_blocks_remat`). audio_embed: the
        audio context tokens (`audio_proj_forward`); a customtalk DiT then
        carries (tokens, add_condition) from block to block, the first block
        taking block_add_condition (zeros when None).
        With use_remat, save_attention keeps each block's self-attention
        (out, lse) from the forward (a selective checkpoint policy over the
        `flash_fwd_rope` operator), so the backward's recompute skips K1 for
        +(S x dim) of activations a block; offload_carries saves the carries
        that the checkpoints keep in pinned host memory
        (torch.autograd.graph.save_on_cpu, the reference's
        use_gradient_checkpointing_offload) instead of on the device."""
        cos, sin = rope_angles_for_grid(tuple(grid), self.cfg.head_dim)
        cos = torch.from_numpy(cos).to(tokens.device)
        sin = torch.from_numpy(sin).to(tokens.device)
        blocks = self["blocks"]
        lora_blocks = None if lora is None else lora["blocks"]
        carry = self.cfg.enable_customtalk and audio_embed is not None

        def block(i):
            """Block i on the carry's tensors -> the next carry (a tuple)."""
            lbp = None if lora_blocks is None else lora_blocks[i]

            def fn(tok, cond=None):
                out = self.dit_block(blocks[i], tok, ctx, t_mod, cos, sin, num_img_tokens, lbp,
                                     lora_scale, audio_embed=audio_embed, num_frames=grid[0],
                                     add_condition=cond)
                return out if carry else (out,)
            return fn

        context_fn = noop_context_fn
        if save_attention:
            context_fn = functools.partial(create_selective_checkpoint_contexts,
                                           save_attention_policy)

        def remat(fn, state):
            # the carry's tensors as arguments of their own: checkpoint saves
            # each through the saved-tensor hooks (save_on_cpu sees them)
            return checkpoint(fn, *state, use_reentrant=False, context_fn=context_fn)

        def step(i, state):
            return remat(block(i), state) if use_remat else block(i)(*state)

        state = (tokens,)
        if carry:
            cond0 = (block_add_condition if block_add_condition is not None
                     else torch.zeros_like(tokens))
            state = (tokens, cond0.to(tokens.dtype))
        # contiguous carries (the pose tokens come transposed): save_on_cpu
        # hands back a contiguous copy, and the recompute must see the same
        # strides as the forward
        state = tuple(t.contiguous() for t in state)
        n = len(blocks)
        group = remat_granularity if use_remat else None
        offload = (torch.autograd.graph.save_on_cpu(pin_memory=True)
                   if use_remat and offload_carries else contextlib.nullcontext())
        with offload:
            if not group or group <= 1 or n % group or n == group:
                for i in range(n):
                    state = step(i, state)
            else:
                def run_group(first):
                    def fn(*st):
                        for i in range(first, first + group):
                            st = step(i, st)
                        return st
                    return fn

                for first in range(0, n, group):
                    state = remat(run_group(first), state)
        return state[0]

    def forward_head(self, tokens, t, grid):
        return self.unpatchify(self.apply_head(tokens, t), grid)

    def forward(self, x, timestep, context, clip_feature=None, y=None, add_condition=None,
                lora=None, lora_scale: float = 1.0, use_remat: bool = False,
                remat_granularity: int = 1, save_attention: bool = False,
                offload_carries: bool = False, audio_embed_tuple=None):
        """x: (b, in_dim - y channels, f, h, w) latents; timestep (b,) or scalar;
        context (b, L, text_dim); clip_feature (b, 257, clip_dim); y: (b, c, f, h, w);
        add_condition (b, S, dim): pose tokens (SVI-Dance); audio_embed_tuple:
        the wav2vec2 windows ((b, 1, 5, 12, 768), (b, n_t - 1, 8, 12, 768)) of
        an audio DiT (SVI-Talk). The rest as `forward_blocks` (training)."""
        cfg = self.cfg
        tokens, ctx, t, t_mod, grid = self.forward_prelude(x, timestep, context, clip_feature, y,
                                                           add_condition)
        n_img = clip_feature.shape[1] if (cfg.has_image_input
                                          and clip_feature is not None) else 257
        audio_embed = None
        if cfg.has_audio and audio_embed_tuple is not None:
            audio_embed = self.audio_proj_forward(*audio_embed_tuple)
        tokens = self.forward_blocks(tokens, ctx, t_mod, grid, num_img_tokens=n_img, lora=lora,
                                     lora_scale=lora_scale, use_remat=use_remat,
                                     remat_granularity=remat_granularity,
                                     save_attention=save_attention,
                                     offload_carries=offload_carries, audio_embed=audio_embed,
                                     block_add_condition=(add_condition if cfg.enable_customtalk
                                                          else None))
        return self.forward_head(tokens, t, grid)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def init_params(cfg: WanDiTConfig, seed: int = 0, device="cuda") -> WanDiT:
    """Seeded random weights with the JAX package's distributions (init_params)."""
    return WanDiT(cfg, _init_tree(cfg, Init(seed, device, cfg.dtype)))


def _init_tree(cfg: WanDiTConfig, r: Init) -> dict:
    """init_params' tree, its tensors made by r."""
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
        if cfg.has_audio:  # per-frame audio cross-attention + its affine norm
            p["audio_cross_attn"] = {"q_linear": r.linear(d, d),
                                     "kv_linear": r.linear(cfg.audio_hidden_dim, 2 * d),
                                     "proj": r.linear(d, d)}
            p["norm_x"] = {"w": r.ones((d,)), "b": r.zeros((d,))}
        if cfg.enable_customtalk:  # the bottleneck FFNs that gate the attentions' inputs
            for name in ("customtalk_context_pre_ffns", "customtalk_audio_pre_ffns"):
                p[name] = {"0": r.linear(d, 128), "2": r.linear(128, d)}
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
    if cfg.has_audio:
        # AudioProjModel: windows of 5 (first frame) / 8 (later 4-frame
        # groups) x 12 wav2vec2 layers x 768 -> 32 tokens of 768
        ad, blocks12 = cfg.audio_hidden_dim, 12
        tree["audio_proj"] = {"proj1": r.linear(5 * blocks12 * ad, 512),
                              "proj1_vf": r.linear(8 * blocks12 * ad, 512),
                              "proj2": r.linear(512, 512),
                              "proj3": r.linear(512, cfg.audio_context_tokens * ad),
                              "norm": {"w": r.ones((ad,)), "b": r.zeros((ad,))}}
    return tree


class _ShapeInit(Init):
    """init_params' shapes and dtypes without the values: every tensor on
    the meta device, so no memory is taken."""

    def __init__(self, dtype: torch.dtype):
        self.device, self.dtype = torch.device("meta"), dtype

    def uniform(self, shape, lim: float, dtype=None) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype or self.dtype, device=self.device)

    normal = uniform



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


def init_params_int4(cfg: WanDiTConfig, generator: torch.Generator, device="cuda",
                     min_size: int = 1 << 16, group: int = INT4_GROUP,
                     weight_scale: float = 0.02, w4a8: bool = False) -> WanDiT:
    """Random int4-packed weights with the layout of
    quantize_params_int4(init_params(cfg)) (`init_params_int4`), made
    directly on `device` from `generator` (a torch.Generator of that device)
    and never through the float tree: a 14B DiT in int4_w4a8 takes 8.6 GiB
    without a 30.5 GiB float tree on the way. The layout is read from
    init_params run on the meta device. Each large linear gets uniform
    random packed bytes (w_q4) and constant group scales (scale_q4 =
    weight_scale / 7; with w4a8, r_q4 = 127 / 7 and s8_q4 = weight_scale /
    127); modulations and the other linears N(0, weight_scale) in cfg.dtype,
    biases zeros, norm weights ones. As in the JAX package min_size counts a
    block linear's elements over all the blocks (its stacked array there),
    and a linear is packed only when its inputs divide by the group. For
    memory and speed measurements: the values are not a model's."""
    shapes = _init_tree(cfg, _ShapeInit(cfg.dtype))

    def build(tree, copies: int):
        if isinstance(tree, list):
            return [build(e, copies) for e in tree]
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                out[k] = build(v, cfg.num_layers if k == "blocks" else copies)
            elif (k == "w" and v.ndim == 2 and v.numel() * copies >= min_size
                  and v.shape[1] % group == 0):
                cout, cin = v.shape
                out["w_q4"] = torch.empty((cout, cin // 2), dtype=torch.int8,
                                          device=device).random_(-128, 128, generator=generator)
                out["scale_q4"] = torch.full((cout, cin // group), weight_scale / 7.0,
                                             device=device)
                if w4a8:  # constant group scales: r = 127 / 7, s8 = weight_scale / 127
                    out["r_q4"] = torch.full((cout, cin // group), 127.0 / 7.0, device=device)
                    out["s8_q4"] = torch.full((cout, 1), weight_scale / 127.0, device=device)
            elif k == "b":
                out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
            elif k == "modulation" or (k == "w" and v.ndim >= 2):
                out[k] = torch.empty(v.shape, dtype=v.dtype, device=device).normal_(
                    0.0, weight_scale, generator=generator)
            else:
                out[k] = torch.ones(v.shape, dtype=v.dtype, device=device)
        return out

    return WanDiT(cfg, build(shapes, 1))


# ---------------------------------------------------------------------------
# Checkpoints in the reference's naming (diffsynth's WanModel state dict)
# ---------------------------------------------------------------------------

# the port's names that differ from the reference's, besides w/b for
# weight/bias: the CLIP-feature MLP is a Sequential there
_IMG_EMB_NAMES = {"norm0": "proj.0", "fc1": "proj.1", "fc3": "proj.3", "norm4": "proj.4"}


def config_from_state_dict(sd) -> WanDiTConfig:
    """The architecture from the checkpoint's shapes (`config_from_state_dict`):
    num_heads follows Wan's head_dim of 128 where dim divides, else 32 (tiny
    test configs). Customtalk where its bottleneck FFNs are, else multitalk
    where any key names audio."""
    keys = set(sd.keys())
    num_layers = 1 + max(int(k.split(".")[1]) for k in keys
                         if k.startswith("blocks.") and k.split(".")[1].isdigit())
    has_image = "blocks.0.cross_attn.k_img.weight" in keys
    customtalk = "blocks.0.customtalk_context_pre_ffns.0.weight" in keys
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
        enable_multitalk=(not customtalk) and any("audio" in k for k in keys),
        enable_customtalk=customtalk,
        clip_feature_dim=int(sd["img_emb.proj.0.weight"].shape[0]) if has_image else 1280)


def config_from_state_dict_keys(keys) -> WanDiTConfig:
    """Key-only variant (no shapes): resolves among the known Wan configs;
    multitalk where any key names audio."""
    keys = set(keys)
    num_layers = 1 + max(int(k.split(".")[1]) for k in keys
                         if k.startswith("blocks.") and k.split(".")[1].isdigit())
    has_image = "blocks.0.cross_attn.k_img.weight" in keys
    base = (WAN_14B_I2V if has_image else WAN_14B_T2V) if num_layers >= 40 else WAN_1_3B_T2V
    return dataclasses.replace(base, num_layers=num_layers, has_image_input=has_image,
                               in_dim=36 if has_image else 16,
                               enable_multitalk=any("audio" in k for k in keys))


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
        if cfg.has_audio:
            p["audio_cross_attn"] = {k: lin(f"{b}.audio_cross_attn.{k}")
                                     for k in ("q_linear", "kv_linear", "proj")}
            p["norm_x"] = norm(f"{b}.norm_x", bias=True)
        if cfg.enable_customtalk:
            for name in ("customtalk_context_pre_ffns", "customtalk_audio_pre_ffns"):
                p[name] = {k: lin(f"{b}.{name}.{k}") for k in ("0", "2")}
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
    if cfg.has_audio:
        tree["audio_proj"] = {k: lin(f"audio_proj.{k}")
                              for k in ("proj1", "proj1_vf", "proj2", "proj3")}
        tree["audio_proj"]["norm"] = norm("audio_proj.norm", bias=True)
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
