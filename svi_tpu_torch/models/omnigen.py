"""OmniGen v1: the Phi-3 image model over the SDXL VAE's latents, port of
svi_tpu/models/omnigen.py.

The sequence is [text and reference-image tokens | a time token | the noise
latents' 2x2 patches], embedded by two patch convolutions (noise and
reference images) with a center crop of a 192 x 192 sin-cos position table,
and run through Phi-3-mini (32 layers 3072 wide, 32 heads of 96, SwiGLU
8192 wide, RMSNorm, LongRoPE "su" rotary scaling on packed q / k / v) under
the collator's 3-D block mask: causal over the text, bidirectional over the
time and image tokens and within each reference image. The attention is a
plain masked softmax with f32 logits, as in the JAX package (a 3-D mask; the
kernels take none). A DiT final layer modulated by the timestep unpatchifies
the noise tokens.

The condition KV cache: a first forward with return_kv returns every
layer's K / V over the condition positions, stacked (layers, B, L, heads,
D); later steps run only the time and noise suffix against them.

Weights are `ParamTree`s loaded from the reference's names by
`omnigen_params_from_torch(sd, device=, dtype=)` (f32 by default) or carried
from svi_tpu's pytrees by `params_from_jax`; `omnigen_state_dict` writes
seeded ones at the published widths.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv_f32
from ..ops.norms import layer_norm
from .flux import _count
from .params import ParamTree, convert_tree, dense, unstack
from .sd import StateDictMaker, _Reader, _timesteps, jax_leaf, timestep_embedding
from .sd3 import _rms
from .stepvideo import _masked_attention

# The OmniGen transformer's Phi-3 rotary configuration: the "su" / LongRoPE
# factors are the checkpoint's constants (tuples, as svi_tpu keeps them).
OMNIGEN_ROPE = (
    ("base", 10000.0),
    ("max_position_embeddings", 131072),
    ("original_max_position_embeddings", 4096),
    ("short_factor", (
        1.05, 1.05, 1.05, 1.1, 1.1, 1.1, 1.2500000000000002,
        1.2500000000000002, 1.4000000000000004, 1.4500000000000004,
        1.5500000000000005, 1.8500000000000008, 1.9000000000000008,
        2.000000000000001, 2.000000000000001, 2.000000000000001,
        2.000000000000001, 2.000000000000001, 2.000000000000001,
        2.000000000000001, 2.000000000000001, 2.000000000000001,
        2.000000000000001, 2.000000000000001, 2.000000000000001,
        2.000000000000001, 2.000000000000001, 2.000000000000001,
        2.000000000000001, 2.000000000000001, 2.000000000000001,
        2.000000000000001, 2.1000000000000005, 2.1000000000000005, 2.2,
        2.3499999999999996, 2.3499999999999996, 2.3499999999999996,
        2.3499999999999996, 2.3999999999999995, 2.3999999999999995,
        2.6499999999999986, 2.6999999999999984, 2.8999999999999977,
        2.9499999999999975, 3.049999999999997, 3.049999999999997,
        3.049999999999997)),
    ("long_factor", (
        1.0299999713897705, 1.0499999523162842, 1.0499999523162842,
        1.0799999237060547, 1.2299998998641968, 1.2299998998641968,
        1.2999999523162842, 1.4499999284744263, 1.5999999046325684,
        1.6499998569488525, 1.8999998569488525, 2.859999895095825,
        3.68999981880188, 5.419999599456787, 5.489999771118164,
        5.489999771118164, 9.09000015258789, 11.579999923706055,
        15.65999984741211, 15.769999504089355, 15.789999961853027,
        18.360000610351562, 21.989999771118164, 23.079999923706055,
        30.009998321533203, 32.35000228881836, 32.590003967285156,
        35.56000518798828, 39.95000457763672, 53.840003967285156,
        56.20000457763672, 57.95000457763672, 59.29000473022461,
        59.77000427246094, 59.920005798339844, 61.190006256103516,
        61.96000671386719, 62.50000762939453, 63.3700065612793,
        63.48000717163086, 63.48000717163086, 63.66000747680664,
        63.850006103515625, 64.08000946044922, 64.760009765625,
        64.80001068115234, 64.81001281738281, 64.81001281738281)),
)


def longrope_inv_freq(head_dim, seq_len=None, base=10000.0,
                      short_factor=None, long_factor=None,
                      max_position_embeddings=131072,
                      original_max_position_embeddings=4096):
    """Phi-3's "su" (LongRoPE) scaling, as transformers computes it:
    inv_freq = 1 / (ext_factor * base^(2i / d)), the short factors up to the
    original context and the long ones past it; attention scaling
    sqrt(1 + ln(max / orig) / ln(orig)). numpy f32."""
    if short_factor is None:
        return (1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float32)
                                / head_dim)), 1.0)
    factor = max_position_embeddings / original_max_position_embeddings
    if factor <= 1.0:
        scaling = 1.0
    else:
        scaling = math.sqrt(1 + math.log(factor)
                            / math.log(original_max_position_embeddings))
    ext = np.asarray(long_factor if seq_len is not None
                     and seq_len > original_max_position_embeddings
                     else short_factor, np.float32)
    inv = 1.0 / (ext * base ** (np.arange(0, head_dim, 2, dtype=np.float32)
                                / head_dim))
    return inv, scaling




def phi3_rope_tables(position_ids, inv_freq, scaling=1.0):
    """cos, sin (B, S, head_dim) f32 for the position ids: cat(freqs, freqs),
    the half-rotation layout, times the attention scaling."""
    pos = torch.as_tensor(position_ids)
    freqs = pos[..., None].float() * torch.as_tensor(inv_freq, dtype=torch.float32,
                                                     device=pos.device)[None, None]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb) * scaling, torch.sin(emb) * scaling


def _rotate_half_apply(x, cos, sin):
    """x (B, S, N, D); cos / sin (B, S, D); in f32, cast back."""
    d = x.shape[-1]
    xf = x.float()
    rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    return (xf * cos[:, :, None] + rot * sin[:, :, None]).to(x.dtype)


def _phi3_layer(p, x, cos, sin, add_mask, cache, cond_len, num_heads, num_kv_heads, head_dim,
                eps):
    b, s, dim = x.shape
    qkv = dense(p["qkv_proj"], _rms(x, p["input_layernorm"]["w"], eps))
    nq, nkv = num_heads * head_dim, num_kv_heads * head_dim
    q = _rotate_half_apply(qkv[..., :nq].reshape(b, s, num_heads, head_dim), cos, sin)
    k = _rotate_half_apply(qkv[..., nq:nq + nkv].reshape(b, s, num_kv_heads, head_dim), cos, sin)
    v = qkv[..., nq + nkv:].reshape(b, s, num_kv_heads, head_dim)
    kv_out = (k[:, :cond_len], v[:, :cond_len]) if cond_len else None
    if cache is not None:
        k = torch.cat([cache[0].to(k.dtype), k], dim=1)
        v = torch.cat([cache[1].to(v.dtype), v], dim=1)
    per = num_heads // num_kv_heads
    if per > 1:
        k = k.repeat_interleave(per, dim=2)
        v = v.repeat_interleave(per, dim=2)
    o = _masked_attention(q, k, v, add_mask).reshape(b, s, dim)
    x = x + dense(p["o_proj"], o)
    g, u = dense(p["gate_up_proj"], _rms(x, p["post_attention_layernorm"]["w"], eps)).chunk(2, dim=-1)
    return x + dense(p["down_proj"], F.silu(g.float()).to(x.dtype) * u), kv_out


def phi3_forward(params, inputs_embeds, attention_mask, position_ids, num_heads,
                 num_kv_heads=None, eps=1e-5, rope_seq_len=None, rope_cfg=OMNIGEN_ROPE,
                 kv_cache=None, cond_len=0):
    """The Phi-3 decoder under a 3-D 0/1 mask (B, S, S_keys), made additive;
    the final RMSNorm. Returns (hidden, cond_kv): cond_kv stacks each layer's
    K and V over the first `cond_len` positions, (layers, B, cond_len,
    kv heads, D) each, or None when cond_len is 0. kv_cache: such a pair,
    put before each layer's keys."""
    num_kv_heads = num_kv_heads or num_heads
    head_dim = inputs_embeds.shape[-1] // num_heads
    inv, scaling = longrope_inv_freq(head_dim, seq_len=rope_seq_len, **dict(rope_cfg))
    dev = inputs_embeds.device
    cos, sin = phi3_rope_tables(torch.as_tensor(position_ids).to(dev), inv, scaling)
    mask = torch.as_tensor(attention_mask).to(dev)
    add_mask = torch.zeros(mask.shape, dtype=torch.float32, device=dev).masked_fill(
        mask <= 0, float("-inf"))[:, None]
    x, ks, vs = inputs_embeds, [], []
    for i, p in enumerate(params["layers"]):
        cache = None if kv_cache is None else (kv_cache[0][i], kv_cache[1][i])
        x, kv = _phi3_layer(p, x, cos, sin, add_mask, cache, cond_len, num_heads, num_kv_heads,
                            head_dim, eps)
        if kv is not None:
            ks.append(kv[0])
            vs.append(kv[1])
    cond_kv = (torch.stack(ks), torch.stack(vs)) if cond_len else None
    return _rms(x, params["norm"]["w"], eps), cond_kv


# ---------------------------------------------------------------------------
# the DiT around it
# ---------------------------------------------------------------------------


def timestep_embedding_omnigen(t, dim=256):
    """[cos | sin] of the timesteps (f32) at geometric frequencies."""
    return timestep_embedding(torch.as_tensor(t), dim)


def _t_embed(p, t, dtype):
    emb = timestep_embedding_omnigen(t).to(dtype)
    return dense(p["2"], F.silu(dense(p["0"], emb)))


def get_2d_sincos_pos_embed(embed_dim, grid_size, interpolation_scale=1.0,
                            base_size=1):
    """The (grid_size^2, embed_dim) sin-cos table: [sin | cos] halves, the
    h half first (float64 numpy)."""
    gh = np.arange(grid_size, dtype=np.float32) / (grid_size / base_size) \
        / interpolation_scale
    gw = np.arange(grid_size, dtype=np.float32) / (grid_size / base_size) \
        / interpolation_scale
    grid = np.meshgrid(gw, gh)  # w first
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])

    def axis(pos, dim):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64)
                                / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb_h = axis(grid[0], embed_dim // 2)
    emb_w = axis(grid[1], embed_dim // 2)
    return np.concatenate([emb_h, emb_w], axis=1)




def cropped_pos_embed(pos_embed, height, width, patch_size=2, pos_embed_max_size=192):
    """The center crop of the max-size table for a (height, width) latent:
    (1, h * w, D), the table's own type (a tensor or an array)."""
    h, w = height // patch_size, width // patch_size
    top = (pos_embed_max_size - h) // 2
    left = (pos_embed_max_size - w) // 2
    table = pos_embed.reshape(pos_embed_max_size, pos_embed_max_size, -1)
    return table[top:top + h, left:left + w].reshape(1, h * w, -1)


def _patch_embed(p, x, patch_size=2):
    """The 2x2-stride patch conv, NCHW -> (B, L, D)."""
    y = conv_f32(F.conv2d, x, p["w"].to(x.dtype), p["b"].to(x.dtype), patch_size)
    return y.flatten(2).transpose(1, 2)


def omnigen_forward(params, x, timestep, input_ids, input_img_latents, input_image_sizes,
                    attention_mask, position_ids, num_heads=32, num_kv_heads=None,
                    rope_cfg=OMNIGEN_ROPE, kv_cache=None, return_kv=False, patch_size=2,
                    pos_embed_max_size=None):
    """x (B, 4, H, W) noise latents; input_ids (B, L), or None on the cached
    steps; input_img_latents: the reference images' (1, 4, h, w) latents, in
    the order of input_image_sizes' spans ({batch index: [[start, end],
    ...]}, or its sorted tuple form); attention_mask (B, S, S_keys) 0/1;
    position_ids (B, S). Returns (latents (B, 4, H, W), cond_kv or None)."""
    dtype, dev = x.dtype, x.device
    b, _, height, width = x.shape
    pos_table = params["pos_embed"]
    if pos_embed_max_size is None:
        pos_embed_max_size = int(math.isqrt(pos_table.shape[0]))
    tok = _patch_embed(params["x_embedder"], x, patch_size)
    tok = tok + cropped_pos_embed(pos_table, height, width, patch_size,
                                  pos_embed_max_size).to(dtype)
    num_tokens = tok.shape[1]
    t = _timesteps(timestep, dev)
    time_token = _t_embed(params["time_token"], t, dtype)[:, None]

    if input_ids is not None:
        ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(input_ids, torch.Tensor)
                              else input_ids).to(dev).long()
        cond = params["embed_tokens"].to(dtype)[ids]
        if input_img_latents:
            sizes = (input_image_sizes.items() if isinstance(input_image_sizes, dict)
                     else input_image_sizes)
            spans = [(b_inx, s0, s1) for b_inx, sp in sorted(sizes) for (s0, s1) in sp]
            for (b_inx, s0, s1), lat in zip(spans, input_img_latents):
                lat = torch.as_tensor(lat).to(dev, dtype)
                emb = _patch_embed(params["input_x_embedder"], lat, patch_size)
                ipe = cropped_pos_embed(pos_table, lat.shape[-2], lat.shape[-1], patch_size,
                                        pos_embed_max_size).to(dtype)
                cond[b_inx, s0:s1] = (emb + ipe)[0]
        input_emb = torch.cat([cond, time_token.expand(b, 1, cond.shape[-1]), tok], dim=1)
        cond_len = cond.shape[1] if return_kv else 0
    else:
        input_emb = torch.cat([time_token.expand(b, 1, tok.shape[-1]), tok], dim=1)
        cond_len = 0

    out, cond_kv = phi3_forward(params, input_emb, attention_mask, position_ids, num_heads,
                                num_kv_heads, rope_cfg=rope_cfg, kv_cache=kv_cache,
                                cond_len=cond_len)

    image_embedding = out[:, -num_tokens:]
    time_emb = _t_embed(params["t_embedder"], t, dtype)
    shift, scale = dense(params["final_layer"]["adaLN"], F.silu(time_emb)).chunk(2, dim=-1)
    y = dense(params["final_layer"]["linear"],
              layer_norm(image_embedding, eps=1e-6) * (1 + scale[:, None]) + shift[:, None])

    # unpatchify
    hp, wp = height // patch_size, width // patch_size
    c = y.shape[-1] // (patch_size * patch_size)
    y = y.reshape(b, hp, wp, patch_size, patch_size, c)
    return y.permute(0, 5, 1, 3, 2, 4).reshape(b, c, height, width), cond_kv


# ---------------------------------------------------------------------------
# checkpoints in the reference's names, the JAX package's pytrees
# ---------------------------------------------------------------------------


def omnigen_params_from_torch(sd: dict, pos_embed_max_size=192, pe_interpolation=1.0,
                              device="cuda", dtype=torch.float32) -> ParamTree:
    """The checkpoint's `pos_embed` when it has one, else the sin-cos table
    at base size 64, as the reference builds it."""
    r = _Reader(sd, device, dtype)

    def layer(i):
        pre = f"llm.layers.{i}"
        return {"input_layernorm": {"w": r.t(f"{pre}.input_layernorm.weight")},
                "post_attention_layernorm": {"w": r.t(f"{pre}.post_attention_layernorm.weight")},
                "qkv_proj": r.lin(f"{pre}.self_attn.qkv_proj"),
                "o_proj": r.lin(f"{pre}.self_attn.o_proj"),
                "gate_up_proj": r.lin(f"{pre}.mlp.gate_up_proj"),
                "down_proj": r.lin(f"{pre}.mlp.down_proj")}

    hidden = sd["llm.embed_tokens.weight"].shape[1]
    if "pos_embed" in r:
        pos = r.t("pos_embed")[0]
    else:
        pos = torch.from_numpy(get_2d_sincos_pos_embed(
            hidden, pos_embed_max_size, interpolation_scale=pe_interpolation,
            base_size=64).astype(np.float32)).to(device, dtype)
    return ParamTree({
        "embed_tokens": r.t("llm.embed_tokens.weight"),
        "layers": [layer(i) for i in range(_count(r, "llm.layers.{}.input_layernorm.weight"))],
        "norm": {"w": r.t("llm.norm.weight")},
        "x_embedder": r.conv("x_embedder.proj"),
        "input_x_embedder": r.conv("input_x_embedder.proj"),
        "time_token": {"0": r.lin("time_token.mlp.0"), "2": r.lin("time_token.mlp.2")},
        "t_embedder": {"0": r.lin("t_embedder.mlp.0"), "2": r.lin("t_embedder.mlp.2")},
        "final_layer": {"adaLN": r.lin("final_layer.adaLN_modulation.1"),
                        "linear": r.lin("final_layer.linear")},
        "pos_embed": pos,
    })


def params_from_jax(params: dict, dtype=torch.float32, device="cuda") -> ParamTree:
    """svi_tpu's OmniGen pytree (its layers stacked for the scan) -> a
    ParamTree."""
    tree = dict(params)
    tree["layers"] = unstack(tree["layers"], int(np.asarray(
        tree["layers"]["input_layernorm"]["w"]).shape[0]))
    return ParamTree(convert_tree(tree, dtype, jax_leaf)).to(device)


def omnigen_state_dict(seed=0, device="cpu", dtype=torch.float32, hidden=3072, num_layers=32,
                       num_heads=32, num_kv_heads=None, intermediate=8192, vocab=32064,
                       in_channels=4, patch_size=2) -> dict:
    """Seeded random OmniGen weights (v1 on Phi-3-mini: 32 layers 3072 wide,
    32 heads of 96, SwiGLU 8192 wide, the 32064-token vocabulary; no
    `pos_embed`: the loader builds the sin-cos table), in the reference's
    names."""
    m = StateDictMaker(seed, device, dtype)
    head_dim = hidden // num_heads
    nkv = num_kv_heads or num_heads
    m.sd["llm.embed_tokens.weight"] = m.randn((vocab, hidden), 0.02)
    for i in range(num_layers):
        pre = f"llm.layers.{i}"
        m.sd[f"{pre}.input_layernorm.weight"] = 1 + m.randn((hidden,), 0.1)
        m.sd[f"{pre}.post_attention_layernorm.weight"] = 1 + m.randn((hidden,), 0.1)
        m.lin(f"{pre}.self_attn.qkv_proj", (num_heads + 2 * nkv) * head_dim, hidden, bias=False)
        m.lin(f"{pre}.self_attn.o_proj", hidden, hidden, bias=False)
        m.lin(f"{pre}.mlp.gate_up_proj", 2 * intermediate, hidden, bias=False)
        m.lin(f"{pre}.mlp.down_proj", hidden, intermediate, bias=False)
    m.sd["llm.norm.weight"] = 1 + m.randn((hidden,), 0.1)
    for name in ("x_embedder", "input_x_embedder"):
        m.conv(f"{name}.proj", hidden, in_channels, k=patch_size)
    for name in ("time_token", "t_embedder"):
        m.lin(f"{name}.mlp.0", hidden, 256)
        m.lin(f"{name}.mlp.2", hidden, hidden)
    m.lin("final_layer.adaLN_modulation.1", 2 * hidden, hidden)
    m.lin("final_layer.linear", patch_size * patch_size * in_channels, hidden)
    return m.sd
