"""Hunyuan-DiT (text to image), port of svi_tpu/models/hunyuan_dit.py.

A U-ViT: 21 down blocks and 19 up blocks with long skips (each up block
joins the matching down block's output through `skip_norm` / `skip_linear`),
shift-only adaLN modulation from the timestep and the extra embedding
(mT5's attention-pooled states, the image size and the style), per-head
LayerNorms on q and k, and 2-D RoPE on the image tokens (`calc_rope`). The
text is 77 BERT tokens and 256 mT5 tokens (the latter through
`t5_embedder`), their padding replaced by a learned embedding.

Both attentions of a block run `ops.attention.flash_attention`: the
self-attention with RoPE on q and k, the cross-attention over the 333 text
tokens with RoPE on q only, each applied before the call as the JAX package
applies it. The model runs in f32 at 16 heads of 88, which the flat kernel
does not take (88 is not a multiple of 128), so on the card both go to the
(B, N, S, D) entry, `flash_fwd_bnsd`: the 3xTF32 kernel of
csrc/flash_fwd_f32.cu at D = 88. `_attention_pool` is the plain f32 softmax
(one query), as in the JAX package.

Weights are `ParamTree`s in PyTorch's layouts, loaded from the reference's
diffsynth-named state dicts (`hunyuan_dit_params_from_torch`) or carried
from svi_tpu's pytrees (`params_from_jax`); `hunyuan_dit_state_dict` writes
seeded ones at Hunyuan-DiT's widths.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import _apply_rope_reference as _apply_rope  # (B, S, N, D) by (S, D/2)
from ..ops.attention import flash_attention
from ..ops.conv import conv_f32
from ..ops.norms import layer_norm
from .params import ParamTree, convert_tree, dense
from .sd import Params, StateDictMaker, _layer_norm, _Reader, _timesteps, jax_leaf
from .sd import timestep_embedding
from .sd3 import _ln_nowb

NUM_HEADS = 16

# ---------------------------------------------------------------------------
# RoPE tables
# ---------------------------------------------------------------------------


def _fill_resize_and_crop(src, tgt):
    th, tw = (tgt, tgt) if isinstance(tgt, int) else tgt
    h, w = src
    if h / w > th / tw:
        rh, rw = th, int(round(th / h * w))
    else:
        rh, rw = int(round(tw / w * h)), tw
    top = int(round((th - rh) / 2.0))
    left = int(round((tw - rw) / 2.0))
    return (top, left), (top + rh, left + rw)


def calc_rope(height, width, patch_size=2, head_size=88):
    """The image size manager's rotary tables: cos, sin (S, head_size // 2)
    f32 numpy, one angle per pair, positions aspect-cropped against 512 x 512
    (the "height" half of the table carries the w positions, as the
    reference stacks w first)."""
    th, tw = height // 8 // patch_size, width // 8 // patch_size
    base = 512 // 8 // patch_size
    start, stop = _fill_resize_and_crop((th, tw), base)
    grid_h = np.linspace(start[0], stop[0], th, endpoint=False, dtype=np.float32)
    grid_w = np.linspace(start[1], stop[1], tw, endpoint=False, dtype=np.float32)
    gw, gh = np.meshgrid(grid_w, grid_h)

    def one_axis(pos, dim):
        freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
        return np.outer(pos.reshape(-1), freqs)

    ang = np.concatenate([one_axis(gw, head_size // 2), one_axis(gh, head_size // 2)], axis=1)
    return np.cos(ang), np.sin(ang)


def _tables(freqs, device):
    return tuple(torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor) else t,
                                 dtype=torch.float32).to(device) for t in freqs)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _head_ln(p, x, eps=1e-6):
    """Per-head affine LayerNorm over head_dim."""
    return layer_norm(x, p["w"], p["b"], eps)


def _self_attention(p, x, cos, sin, num_heads, head_dim):
    b, s, _ = x.shape
    q = dense(p["to_q"], x).reshape(b, s, num_heads, head_dim)
    k = dense(p["to_k"], x).reshape(b, s, num_heads, head_dim)
    v = dense(p["to_v"], x).reshape(b, s, num_heads, head_dim)
    q = _apply_rope(_head_ln(p["q_norm"], q), cos, sin)
    k = _apply_rope(_head_ln(p["k_norm"], k), cos, sin)
    return dense(p["to_out"], flash_attention(q, k, v).reshape(b, s, num_heads * head_dim))


def _cross_attention(p, x, ctx, cos, sin, num_heads, head_dim):
    """q and k normed, RoPE on q only."""
    b, s, _ = x.shape
    sk = ctx.shape[1]
    q = dense(p["to_q"], x).reshape(b, s, num_heads, head_dim)
    k = dense(p["to_k"], ctx).reshape(b, sk, num_heads, head_dim)
    v = dense(p["to_v"], ctx).reshape(b, sk, num_heads, head_dim)
    q = _apply_rope(_head_ln(p["q_norm"], q), cos, sin)
    k = _head_ln(p["k_norm"], k)
    return dense(p["to_out"], flash_attention(q, k, v).reshape(b, s, num_heads * head_dim))


def _block(p, x, cond, text, cos, sin, num_heads, head_dim, residual=None):
    """HunyuanDiTBlock: the long skip, the shift-modulated self-attention,
    the cross-attention and the tanh-GELU MLP."""
    if residual is not None:
        x = dense(p["skip_linear"], _layer_norm(p["skip_norm"], torch.cat([x, residual], -1)))
    shift = dense(p["modulation"], F.silu(cond.float()).to(cond.dtype))
    x = x + _self_attention(p["attn1"], _layer_norm(p["norm1"], x) + shift[:, None], cos, sin,
                            num_heads, head_dim)
    x = x + _cross_attention(p["attn2"], _layer_norm(p["norm3"], x), text, cos, sin, num_heads,
                             head_dim)
    h = dense(p["mlp_0"], _layer_norm(p["norm2"], x))
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return x + dense(p["mlp_2"], h)


def _attention_pool(p, x, num_heads=8):
    """AttentionPool: the mean token queries the whole sequence (plain f32
    softmax), then the output projection. x (B, S, D) -> (B, output_dim)."""
    b, s, d = x.shape
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
    x = x + p["positional_embedding"][None].to(x.dtype)
    hd = d // num_heads
    q = dense(p["q_proj"], x[:, :1]).reshape(b, 1, num_heads, hd)
    k = dense(p["k_proj"], x).reshape(b, s + 1, num_heads, hd)
    v = dense(p["v_proj"], x).reshape(b, s + 1, num_heads, hd)
    logits = torch.einsum("bsnd,bknd->bnsk", q.float(), k.float()) * (hd ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bnsk,bknd->bsnd", probs, v).reshape(b, 1, d)
    return dense(p["c_proj"], o)[:, 0]


def hunyuan_dit_forward(params: Params, hidden_states, text_emb, text_emb_t5, text_emb_mask,
                        text_emb_mask_t5, timestep, size_emb, freq_cis_img, num_layers_down=21,
                        tiled=False, tile_size=64, tile_stride=32):
    """hidden_states (B, 4, H, W); text_emb (B, 77, 1024) BERT states;
    text_emb_t5 (B, 256, 2048) mT5 states; masks (B, 77) / (B, 256);
    size_emb (B, 6); freq_cis_img: `calc_rope`'s (cos, sin). Returns the
    (B, 4, H, W) prediction (the first half of the 8 output channels).

    tiled: each block runs on feathered tiles of tile_size^2 patches
    (`tiler.fast_tiled_forward`), so freq_cis_img must be one tile's tables
    (calc_rope(tile_size * 16, tile_size * 16)); the long-skip residuals are
    sliced per tile like the hidden states."""
    x = hidden_states
    b, _, h, w = x.shape
    dtype, dev = x.dtype, x.device
    cos, sin = _tables(freq_cis_img, dev)

    t5p = params["t5_embedder"]
    t5e = dense(t5p["0"], text_emb_t5.to(dtype))
    t5e = dense(t5p["2"], F.silu(t5e.float()).to(dtype))
    text = torch.cat([text_emb.to(dtype), t5e], dim=1)
    mask = torch.cat([torch.as_tensor(text_emb_mask, device=dev),
                      torch.as_tensor(text_emb_mask_t5, device=dev)], dim=-1) != 0
    text = torch.where(mask[:, :, None], text, params["text_emb_padding"][None].to(dtype))

    pooled = _attention_pool(params["t5_pooler"], text_emb_t5.to(dtype))
    temb = timestep_embedding(_timesteps(timestep, dev), 256).to(dtype)
    temb = dense(params["timestep_embedder"]["2"],
                 F.silu(dense(params["timestep_embedder"]["0"], temb)))
    size = timestep_embedding(torch.as_tensor(size_emb, device=dev).reshape(-1), 256)
    size = size.to(dtype).reshape(b, 6 * 256)
    style = params["style_embedder"].to(dtype)[None].expand(b, -1)
    extra = torch.cat([pooled.to(dtype), size, style], dim=1)
    eh = dense(params["extra_embedder"]["0"], extra)
    cond = temb + dense(params["extra_embedder"]["2"], F.silu(eh.float()).to(dtype))

    pe = params["patch_embedder"]
    xl = conv_f32(F.conv2d, x, pe["w"].to(dtype), pe["b"].to(dtype), 2, 0)
    xa = xl.flatten(2).transpose(1, 2)  # (B, (H/2)(W/2), D)

    num_heads = NUM_HEADS
    head_dim = xa.shape[-1] // num_heads
    residuals = []
    if tiled:
        from .tiler import fast_tiled_forward

        hp, wp = h // 2, w // 2
        xg = xa.reshape(b, hp, wp, -1)
        for i, bp in enumerate(params["blocks"]):
            rg = residuals.pop() if i >= num_layers_down else None

            def tile_fn(hl, hr, wl, wr, _bp=bp, _rg=rg, _xg=xg):
                n = (hr - hl) * (wr - wl)
                xt = _xg[:, hl:hr, wl:wr].reshape(b, n, -1)
                rt = None if _rg is None else _rg[:, hl:hr, wl:wr].reshape(b, n, -1)
                out = _block(_bp, xt, cond, text, cos, sin, num_heads, head_dim, residual=rt)
                return out.reshape(b, hr - hl, wr - wl, -1)

            xg = fast_tiled_forward(tile_fn, xg, tile_size, tile_stride)
            if i < num_layers_down - 2:
                residuals.append(xg)
        xa = xg.reshape(b, hp * wp, -1)
    else:
        for i, bp in enumerate(params["blocks"]):
            residual = residuals.pop() if i >= num_layers_down else None
            xa = _block(bp, xa, cond, text, cos, sin, num_heads, head_dim, residual=residual)
            if i < num_layers_down - 2:
                residuals.append(xa)

    fl = params["final_layer"]
    shift, scale = dense(fl["adaLN_modulation"], F.silu(cond.float()).to(dtype)).chunk(2, dim=1)
    xa = _ln_nowb(xa) * (1 + scale[:, None]) + shift[:, None]
    xa = dense(fl["linear"], xa)
    # B (H W) (P Q C) -> B C (H P) (W Q), the first half of the channels
    c = xa.shape[-1] // 4
    xa = xa.reshape(b, h // 2, w // 2, 2, 2, c).permute(0, 5, 1, 3, 2, 4).reshape(b, c, h, w)
    return xa[:, :c // 2]


# ---------------------------------------------------------------------------
# checkpoints in the reference's diffsynth naming
# ---------------------------------------------------------------------------


def _attn_p(r: _Reader, a, rota):
    p = r.attn(a)
    p["q_norm"] = r.norm(f"{rota}.q_norm")
    p["k_norm"] = r.norm(f"{rota}.k_norm")
    return p


def _block_p(r: _Reader, prefix):
    p = {"norm1": r.norm(f"{prefix}.norm1"),
         "attn1": _attn_p(r, f"{prefix}.attn1", f"{prefix}.rota1"),
         "norm3": r.norm(f"{prefix}.norm3"),
         "attn2": _attn_p(r, f"{prefix}.attn2", f"{prefix}.rota2"),
         "norm2": r.norm(f"{prefix}.norm2"),
         "modulation": r.lin(f"{prefix}.modulation.1"),
         "mlp_0": r.lin(f"{prefix}.mlp.0"),
         "mlp_2": r.lin(f"{prefix}.mlp.2")}
    if f"{prefix}.skip_norm.weight" in r:
        p["skip_norm"] = r.norm(f"{prefix}.skip_norm")
        p["skip_linear"] = r.lin(f"{prefix}.skip_linear")
    return p


def hunyuan_dit_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> Params:
    r = _Reader(sd, device, dtype)
    n = 0
    while f"blocks.{n}.norm1.weight" in r:
        n += 1
    return ParamTree({
        "text_emb_padding": r.t("text_emb_padding"),
        "t5_embedder": {"0": r.lin("t5_embedder.0"), "2": r.lin("t5_embedder.2")},
        "t5_pooler": {"positional_embedding": r.t("t5_pooler.positional_embedding"),
                      **{k: r.lin(f"t5_pooler.{k}")
                         for k in ("q_proj", "k_proj", "v_proj", "c_proj")}},
        "style_embedder": r.t("style_embedder"),
        "patch_embedder": r.conv("patch_embedder.proj"),
        "timestep_embedder": {"0": r.lin("timestep_embedder.mlp.0"),
                              "2": r.lin("timestep_embedder.mlp.2")},
        "extra_embedder": {"0": r.lin("extra_embedder.0"), "2": r.lin("extra_embedder.2")},
        "blocks": [_block_p(r, f"blocks.{i}") for i in range(n)],
        "final_layer": {"linear": r.lin("final_layer.linear"),
                        "adaLN_modulation": r.lin("final_layer.adaLN_modulation.1")},
    })


def _drop_none(tree):
    if isinstance(tree, dict):
        return {k: _drop_none(v) for k, v in tree.items() if v is not None}
    if isinstance(tree, (list, tuple)):
        return [_drop_none(v) for v in tree]
    return tree


def params_from_jax(params: dict, dtype=torch.float32, device="cuda") -> Params:
    """svi_tpu's Hunyuan-DiT pytree (numpy or JAX leaves) -> Params (its
    empty `norm_final` entry dropped)."""
    return ParamTree(convert_tree(_drop_none(params), dtype, jax_leaf)).to(device)


# ---------------------------------------------------------------------------
# seeded random weights under the reference's names
# ---------------------------------------------------------------------------


def hunyuan_dit_state_dict(seed=0, device="cpu", dtype=torch.float32, dim=1408,
                           num_layers_down=21, num_layers_up=19, text_dim=1024, t5_dim=2048,
                           t5_len=256, text_len=77, mlp_dim=6144, out_channels=8) -> dict:
    """Seeded random Hunyuan-DiT weights (v1.x's: 40 blocks 1408 wide, 16
    heads of 88), in the reference's names."""
    m = StateDictMaker(seed, device, dtype)
    hd = dim // NUM_HEADS
    m.sd["text_emb_padding"] = m.randn((text_len + t5_len, text_dim), 0.02)
    m.lin("t5_embedder.0", 4 * t5_dim, t5_dim)
    m.lin("t5_embedder.2", text_dim, 4 * t5_dim)
    m.sd["t5_pooler.positional_embedding"] = m.randn((t5_len + 1, t5_dim), t5_dim ** -0.5)
    for k in ("q_proj", "k_proj", "v_proj"):
        m.lin(f"t5_pooler.{k}", t5_dim, t5_dim)
    m.lin("t5_pooler.c_proj", text_dim, t5_dim)
    m.sd["style_embedder"] = m.randn((dim,), 0.02)
    m.conv("patch_embedder.proj", dim, 4, k=2)
    m.lin("timestep_embedder.mlp.0", dim, 256)
    m.lin("timestep_embedder.mlp.2", dim, dim)
    m.lin("extra_embedder.0", 4 * dim, text_dim + 6 * 256 + dim)
    m.lin("extra_embedder.2", dim, 4 * dim)
    for i in range(num_layers_down + num_layers_up):
        b = f"blocks.{i}"
        m.norm(f"{b}.norm1", dim)
        m.attn(f"{b}.attn1", dim, qkv_bias=True)
        m.norm(f"{b}.norm3", dim)
        m.attn(f"{b}.attn2", dim, text_dim, qkv_bias=True)
        for rota in ("rota1", "rota2"):
            m.norm(f"{b}.{rota}.q_norm", hd)
            m.norm(f"{b}.{rota}.k_norm", hd)
        m.norm(f"{b}.norm2", dim)
        m.lin(f"{b}.modulation.1", dim, dim)
        m.lin(f"{b}.mlp.0", mlp_dim, dim)
        m.lin(f"{b}.mlp.2", dim, mlp_dim)
        if i >= num_layers_down:
            m.norm(f"{b}.skip_norm", 2 * dim)
            m.lin(f"{b}.skip_linear", dim, 2 * dim)
    m.lin("final_layer.adaLN_modulation.1", 2 * dim, dim)
    m.lin("final_layer.linear", 4 * out_channels, dim)
    return m.sd
