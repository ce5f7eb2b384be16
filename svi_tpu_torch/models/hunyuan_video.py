"""HunyuanVideo: the double- and single-stream video DiT and the causal 3-D
VAE, port of svi_tpu/models/hunyuan_video.py.

The DiT embeds the latents with a (1, 2, 2) patch convolution, refines the
LLM's text states (`_token_refiner`: masked self-attention blocks, the plain
f32 softmax as in the JAX package), conditions every block on the timestep,
CLIP's pooled embedding and the embedded guidance, and runs 20 double-stream
blocks (image and text each with their own weights, one attention over
both) and 40 single-stream blocks, 24 heads of 128 with RMS q / k norms and
3-axis RoPE on the image tokens. As in the reference, the joined sequence is
cut into two fixed groups that attend only within themselves
(`_split_attention`): the image tokens with the first 71 text tokens, and
the last 185 text tokens. Each group is one `ops.attention.flash_attention`
call: bf16 at D = 128 on the card goes to K1's flat entry, the TMA + wgmma
kernel of csrc/flash_fwd_sm90.cu, two launches a block.

The VAE is channels-first (B, C, T, H, W) with replicate-padded causal
convolutions (`ops.conv.conv_f32`) and, in the mid-block, attention masked
by frame: each token attends to the tokens of its own and earlier frames.
The JAX package computes that outside any kernel as one masked softmax; the
port computes it one query frame at a time against the keys of the frames
up to it (`_mid_attention`), the same rows without the whole score matrix.

Weights are `ParamTree`s in PyTorch's layouts, loaded from the reference's
diffsynth-named state dicts (`*_params_from_torch`) or carried from
svi_tpu's pytrees (`params_from_jax`); `*_state_dict` write seeded ones at
the published widths.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..ops.conv import conv_f32
from .flux import _count
from .hunyuan_dit import _apply_rope, _tables
from .params import ParamTree, convert_tree, dense, unstack
from .sd import Params, StateDictMaker, _layer_norm, _Reader, _timesteps, jax_leaf
from .sd import timestep_embedding
from .sd3 import _ff, _ln_nowb, _rms

NUM_HEADS = 24

# ---------------------------------------------------------------------------
# RoPE: axes (16, 56, 56), theta 256, over (T, H / 2, W / 2)
# ---------------------------------------------------------------------------


def prepare_rope_tables(t, h, w, rope_dims=(16, 56, 56), theta=256.0):
    """cos, sin (T * H * W, 64) f32 numpy, one angle per pair, for the
    patch grid (t, h, w)."""
    grids = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in (t, h, w)], indexing="ij")
    outs = []
    for g, d in zip(grids, rope_dims):
        freqs = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
        outs.append(np.outer(g.reshape(-1), freqs))
    ang = np.concatenate(outs, axis=1)
    return np.cos(ang), np.sin(ang)


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------

TXT_LEN = 256
SPLIT_TOKEN = 71


def _qkv(p, x, num_heads, head_dim):
    b, s, _ = x.shape
    qkv = dense(p["to_qkv"], x).reshape(b, s, 3, num_heads, head_dim)
    return (_rms(qkv[:, :, 0], p["norm_q"]["w"]), _rms(qkv[:, :, 1], p["norm_k"]["w"]),
            qkv[:, :, 2])


def _split_attention(q, k, v, split):
    """The reference's fixed partition: group A = the image tokens and the
    first 71 text tokens, group B = the last 185 text tokens, each attending
    only within itself (one kernel call each)."""
    oa = flash_attention(q[:, :split], k[:, :split], v[:, :split])
    ob = flash_attention(q[:, split:], k[:, split:], v[:, split:])
    o = torch.cat([oa, ob], dim=1)
    return o.reshape(o.shape[0], o.shape[1], -1)


def _mod6(p, vec):
    return dense(p["linear"], F.silu(vec))[:, None].chunk(6, dim=2)


def _double_block(p, img, txt, vec, cos, sin, num_heads, head_dim):
    """MMDoubleStreamBlock."""
    pa, pb = p["component_a"], p["component_b"]
    a_shift, a_scale, a_gate, a_shift2, a_scale2, a_gate2 = _mod6(pa["mod"], vec)
    b_shift, b_scale, b_gate, b_shift2, b_scale2, b_gate2 = _mod6(pb["mod"], vec)
    na = _ln_nowb(img) * (1 + a_scale) + a_shift
    nb = _ln_nowb(txt) * (1 + b_scale) + b_shift
    qa, ka, va = _qkv(pa, na, num_heads, head_dim)
    qb, kb, vb = _qkv(pb, nb, num_heads, head_dim)
    qa, ka = _apply_rope(qa, cos, sin), _apply_rope(ka, cos, sin)
    simg = img.shape[1]
    o = _split_attention(torch.cat([qa, qb], 1), torch.cat([ka, kb], 1), torch.cat([va, vb], 1),
                         simg + SPLIT_TOKEN)
    oa, ob = o[:, :simg], o[:, simg:]

    img = img + a_gate * dense(pa["to_out"], oa)
    img = img + a_gate2 * _ff(pa["ff"], _ln_nowb(img) * (1 + a_scale2) + a_shift2)
    txt = txt + b_gate * dense(pb["to_out"], ob)
    txt = txt + b_gate2 * _ff(pb["ff"], _ln_nowb(txt) * (1 + b_scale2) + b_shift2)
    return img, txt


def _single_block(p, x, vec, cos, sin, num_heads, head_dim):
    """MMSingleStreamBlock: one modulated norm feeds the attention and the
    FF, whose outputs share one gate."""
    shift, scale, gate = dense(p["mod"]["linear"], F.silu(vec))[:, None].chunk(3, dim=2)
    nx = _ln_nowb(x) * (1 + scale) + shift
    q, k, v = _qkv(p, nx, num_heads, head_dim)
    simg = x.shape[1] - TXT_LEN
    q = torch.cat([_apply_rope(q[:, :simg], cos, sin), q[:, simg:]], 1)
    k = torch.cat([_apply_rope(k[:, :simg], cos, sin), k[:, simg:]], 1)
    o = _split_attention(q, k, v, simg + SPLIT_TOKEN)
    x = x + gate * dense(p["to_out"], o)
    return x + gate * _ff(p["ff"], nx)


def _refiner_block(p, x, c, mask, num_heads=None):
    """IndividualTokenRefinerBlock: masked self-attention (plain f32
    softmax) and a SiLU MLP, each gated by the conditioning."""
    num_heads = num_heads or NUM_HEADS
    gate_msa, gate_mlp = dense(p["adaLN_modulation"], F.silu(c))[:, None].chunk(2, dim=2)
    nx = _layer_norm(p["norm1"], x)
    b, s, d = nx.shape
    hd = d // num_heads
    qkv = dense(p["self_attn_qkv"], nx).reshape(b, s, 3, num_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    logits = torch.einsum("bsnd,bknd->bnsk", q.float(), k.float()) * (hd ** -0.5)
    logits = logits.masked_fill(~mask[:, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bnsk,bknd->bsnd", probs, v).reshape(b, s, d)
    x = x + dense(p["self_attn_proj"], o) * gate_msa
    h = dense(p["mlp_0"], _layer_norm(p["norm2"], x))
    h = F.silu(h.float()).to(x.dtype)
    return x + dense(p["mlp_2"], h) * gate_mlp


def _token_refiner(p, x, t, mask):
    """SingleTokenRefiner: the text states conditioned on the timestep and
    their masked mean, then the refiner blocks."""
    temb = timestep_embedding(_timesteps(t, x.device), 256)
    temb = dense(p["t_embedder"]["2"], F.silu(dense(p["t_embedder"]["0"], temb.to(x.dtype))))
    mf = mask.to(x.dtype)[:, :, None]
    ctx = (x * mf).sum(dim=1) / mf.sum(dim=1)
    ctx = dense(p["c_embedder"]["2"], F.silu(dense(p["c_embedder"]["0"], ctx)))
    c = temb + ctx
    x = dense(p["input_embedder"], x)
    m = mask != 0
    attn_mask = m[:, :, None] & m[:, None, :]
    attn_mask[:, :, 0] = True
    for bp in p["blocks"]:
        x = _refiner_block(bp, x, c, attn_mask)
    return x


def hunyuan_video_dit_forward(params: Params, x, t, prompt_emb, text_mask, pooled_prompt_emb,
                              guidance=None, freqs=None):
    """x (B, 16, T, H, W) latents; prompt_emb (B, 256, 4096) LLM states;
    text_mask (B, 256); pooled (B, 768) CLIP; guidance (B,) or a scalar ->
    the (B, 16, T, H, W) prediction. freqs: `prepare_rope_tables`' (cos, sin)."""
    b, c, tt, h, w = x.shape
    dtype, dev = x.dtype, x.device
    if freqs is None:
        freqs = prepare_rope_tables(tt, h // 2, w // 2)
    cos, sin = _tables(freqs, dev)

    vec = timestep_embedding(_timesteps(t, dev), 256).to(dtype)
    vec = dense(params["time_in"]["2"], F.silu(dense(params["time_in"]["0"], vec)))
    vec = vec + dense(params["vector_in"]["2"],
                      F.silu(dense(params["vector_in"]["0"], pooled_prompt_emb.to(dtype))))
    if "guidance_in" in params and guidance is not None:
        # scaled in the guidance's own dtype, as svi_tpu does
        g = timestep_embedding(_timesteps(guidance, dev) * 1000, 256).to(dtype)
        vec = vec + dense(params["guidance_in"]["2"], F.silu(dense(params["guidance_in"]["0"], g)))

    w_in = params["img_in"]["w"]
    xl = x.transpose(1, 2).reshape(b * tt, c, h, w)
    xl = conv_f32(F.conv2d, xl, w_in[:, :, 0].to(dtype), params["img_in"]["b"].to(dtype), 2, 0)
    img = xl.flatten(2).transpose(1, 2).reshape(b, tt * (h // 2) * (w // 2), -1)

    txt = _token_refiner(params["txt_in"], prompt_emb.to(dtype), t,
                         torch.as_tensor(text_mask, device=dev))

    num_heads = NUM_HEADS
    head_dim = img.shape[-1] // num_heads
    for p in params["double_blocks"]:
        img, txt = _double_block(p, img, txt, vec, cos, sin, num_heads, head_dim)
    xs = torch.cat([img, txt], 1)
    for p in params["single_blocks"]:
        xs = _single_block(p, xs, vec, cos, sin, num_heads, head_dim)
    img = xs[:, :-TXT_LEN]

    fl = params["final_layer"]
    shift, scale = dense(fl["adaLN_modulation"], F.silu(vec)).chunk(2, dim=1)
    img = dense(fl["linear"], _ln_nowb(img) * (1 + scale[:, None]) + shift[:, None])
    # B (T H W) (C pT pH pW) -> B C T (H 2) (W 2)
    co = img.shape[-1] // 4
    img = img.reshape(b, tt, h // 2, w // 2, co, 2, 2)
    return img.permute(0, 4, 1, 2, 5, 3, 6).reshape(b, co, tt, h, w)


def _component_p(r: _Reader, prefix):
    return {"mod": {"linear": r.lin(f"{prefix}.mod.linear")},
            "to_qkv": r.lin(f"{prefix}.to_qkv"),
            "norm_q": {"w": r.t(f"{prefix}.norm_q.weight")},
            "norm_k": {"w": r.t(f"{prefix}.norm_k.weight")},
            "to_out": r.lin(f"{prefix}.to_out"),
            "ff": {"0": r.lin(f"{prefix}.ff.0"), "2": r.lin(f"{prefix}.ff.2")}}


def hunyuan_video_dit_params_from_torch(sd: dict, device="cuda",
                                        dtype=torch.bfloat16) -> Params:
    r = _Reader(sd, device, dtype)
    n_double = _count(r, "double_blocks.{}.component_a.mod.linear.weight")
    n_single = _count(r, "single_blocks.{}.mod.linear.weight")
    n_ref = _count(r, "txt_in.blocks.{}.norm1.weight")
    tree = {
        "img_in": r.conv("img_in.proj"),
        "txt_in": {
            "input_embedder": r.lin("txt_in.input_embedder"),
            "t_embedder": {"0": r.lin("txt_in.t_embedder.timestep_embedder.0"),
                           "2": r.lin("txt_in.t_embedder.timestep_embedder.2")},
            "c_embedder": {"0": r.lin("txt_in.c_embedder.0"), "2": r.lin("txt_in.c_embedder.2")},
            "blocks": [{"norm1": r.norm(f"txt_in.blocks.{i}.norm1"),
                        "self_attn_qkv": r.lin(f"txt_in.blocks.{i}.self_attn_qkv"),
                        "self_attn_proj": r.lin(f"txt_in.blocks.{i}.self_attn_proj"),
                        "norm2": r.norm(f"txt_in.blocks.{i}.norm2"),
                        "mlp_0": r.lin(f"txt_in.blocks.{i}.mlp.0"),
                        "mlp_2": r.lin(f"txt_in.blocks.{i}.mlp.2"),
                        "adaLN_modulation": r.lin(f"txt_in.blocks.{i}.adaLN_modulation.1")}
                       for i in range(n_ref)],
        },
        "time_in": {"0": r.lin("time_in.timestep_embedder.0"),
                    "2": r.lin("time_in.timestep_embedder.2")},
        "vector_in": {"0": r.lin("vector_in.0"), "2": r.lin("vector_in.2")},
        "double_blocks": [{"component_a": _component_p(r, f"double_blocks.{i}.component_a"),
                           "component_b": _component_p(r, f"double_blocks.{i}.component_b")}
                          for i in range(n_double)],
        "single_blocks": [{"mod": {"linear": r.lin(f"single_blocks.{i}.mod.linear")},
                           "to_qkv": r.lin(f"single_blocks.{i}.to_qkv"),
                           "norm_q": {"w": r.t(f"single_blocks.{i}.norm_q.weight")},
                           "norm_k": {"w": r.t(f"single_blocks.{i}.norm_k.weight")},
                           "to_out": r.lin(f"single_blocks.{i}.to_out"),
                           "ff": {"0": r.lin(f"single_blocks.{i}.ff.0"),
                                  "2": r.lin(f"single_blocks.{i}.ff.2")}}
                          for i in range(n_single)],
        "final_layer": {"linear": r.lin("final_layer.linear"),
                        "adaLN_modulation": r.lin("final_layer.adaLN_modulation.1")},
    }
    if "guidance_in.timestep_embedder.0.weight" in r:
        tree["guidance_in"] = {"0": r.lin("guidance_in.timestep_embedder.0"),
                               "2": r.lin("guidance_in.timestep_embedder.2")}
    return ParamTree(tree)


# ---------------------------------------------------------------------------
# VAE: replicate-padded causal convolutions, channels first (B, C, T, H, W)
# ---------------------------------------------------------------------------

HYV_VAE_SCALING_FACTOR = 0.476986
# the (time, h, w) factor of each up block's upsampler (stride of each down
# block's downsampler): space in blocks 0-2, time in blocks 1-2, none in 3
_RESAMPLE = ((1, 2, 2), (2, 2, 2), (2, 2, 2))


def _causal_conv3d(p, x, stride=(1, 1, 1)):
    """CausalConv3d: replicate padding k - 1 frames before, k // 2 pixels
    around."""
    w = p["w"].to(x.dtype)
    k = w.shape[2]
    if k > 1:
        x = F.pad(x, (k // 2, k // 2, k // 2, k // 2, k - 1, 0), mode="replicate")
    return conv_f32(F.conv3d, x, w, p["b"].to(x.dtype), stride)


def _gn3d(p, x, groups=32, eps=1e-6):
    y = F.group_norm(x.float(), groups, p["w"].float(), p["b"].float(), eps)
    return y.to(x.dtype)


def _res3d(p, x):
    h = _causal_conv3d(p["conv1"], F.silu(_gn3d(p["norm1"], x)))
    h = _causal_conv3d(p["conv2"], F.silu(_gn3d(p["norm2"], h)))
    if "conv_shortcut" in p:
        x = _causal_conv3d(p["conv_shortcut"], x)
    return x + h


def _mid_attention(p, x):
    """One head as wide as the channels, each token attending to the tokens
    of frames <= its own: computed one query frame at a time against the
    keys of frames 0..f (plain f32 scores, as the JAX package's masked
    softmax computes each row)."""
    b, c, t, h, w = x.shape
    hw = h * w
    y = _gn3d(p["group_norm"], x).flatten(2).transpose(1, 2)  # (B, T*H*W, C)
    q = dense(p["to_q"], y)
    k = dense(p["to_k"], y)
    v = dense(p["to_v"], y)
    scale = c ** -0.5
    outs = []
    for f in range(t):
        end = (f + 1) * hw
        logits = (q[:, f * hw:end].float() @ k[:, :end].float().transpose(1, 2)) * scale
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(probs @ v[:, :end])
        del logits, probs
    o = dense(p["to_out"], torch.cat(outs, dim=1))
    return x + o.transpose(1, 2).reshape(b, c, t, h, w)


def _upsample(p, x, factor):
    """UpsampleCausal3D: nearest repeat (the first frame in space only),
    then a causal conv."""
    ft, fh, fw = factor

    def space(y):
        return y.repeat_interleave(fh, dim=3).repeat_interleave(fw, dim=4)

    if x.shape[2] > 1:
        rest = x[:, :, 1:]
        if ft > 1:
            rest = rest.repeat_interleave(ft, dim=2)
        x = torch.cat([space(x[:, :, :1]), space(rest)], dim=2)
    else:
        x = space(x)
    return _causal_conv3d(p, x)


def _pointwise3d(p, x):
    return conv_f32(F.conv3d, x, p["w"].to(x.dtype), p["b"].to(x.dtype))


def hunyuan_video_vae_decode(params: Params, latents):
    """HunyuanVideoVAEDecoder: latents (B, 16, T, H, W) -> video
    (B, 3, 4(T - 1) + 1, 8H, 8W)."""
    x = _pointwise3d(params["post_quant_conv"], latents / HYV_VAE_SCALING_FACTOR)
    d = params["decoder"]
    x = _causal_conv3d(d["conv_in"], x)
    x = _res3d(d["mid"]["resnets"][0], x)
    x = _mid_attention(d["mid"]["attn"], x)
    x = _res3d(d["mid"]["resnets"][1], x)
    for i, blk in enumerate(d["up_blocks"]):
        for rp in blk["resnets"]:
            x = _res3d(rp, x)
        if "upsampler" in blk:
            x = _upsample(blk["upsampler"], x, _RESAMPLE[i])
    x = F.silu(_gn3d(d["conv_norm_out"], x))
    return _causal_conv3d(d["conv_out"], x)


def hunyuan_video_vae_encode(params: Params, video):
    """HunyuanVideoVAEEncoder: video (B, 3, T, H, W) in [-1, 1] -> latents
    (B, 16, (T - 1) / 4 + 1, H / 8, W / 8) times the scaling factor."""
    e = params["encoder"]
    x = _causal_conv3d(e["conv_in"], video)
    for i, blk in enumerate(e["down_blocks"]):
        for rp in blk["resnets"]:
            x = _res3d(rp, x)
        if "downsampler" in blk:
            x = _causal_conv3d(blk["downsampler"], x, stride=_RESAMPLE[i])
    x = _res3d(e["mid"]["resnets"][0], x)
    x = _mid_attention(e["mid"]["attn"], x)
    x = _res3d(e["mid"]["resnets"][1], x)
    x = F.silu(_gn3d(e["conv_norm_out"], x))
    x = _causal_conv3d(e["conv_out"], x)
    x = _pointwise3d(params["quant_conv"], x)
    return x[:, :16] * HYV_VAE_SCALING_FACTOR


def _cc3d_p(r: _Reader, prefix):
    key = f"{prefix}.conv" if f"{prefix}.conv.weight" in r else prefix
    return r.conv(key)


def _res_p(r: _Reader, prefix):
    p = {"norm1": r.norm(f"{prefix}.norm1"), "conv1": _cc3d_p(r, f"{prefix}.conv1"),
         "norm2": r.norm(f"{prefix}.norm2"), "conv2": _cc3d_p(r, f"{prefix}.conv2")}
    if f"{prefix}.conv_shortcut.conv.weight" in r:
        p["conv_shortcut"] = _cc3d_p(r, f"{prefix}.conv_shortcut")
    return p


def _mid_p(r: _Reader, prefix):
    a = f"{prefix}.attentions.0"
    return {"resnets": [_res_p(r, f"{prefix}.resnets.0"), _res_p(r, f"{prefix}.resnets.1")],
            "attn": {"group_norm": r.norm(f"{a}.group_norm"), "to_q": r.lin(f"{a}.to_q"),
                     "to_k": r.lin(f"{a}.to_k"), "to_v": r.lin(f"{a}.to_v"),
                     "to_out": r.lin(f"{a}.to_out.0")}}


def _blocks_p(r: _Reader, prefix, sampler):
    blocks = []
    for i in range(4):
        blk = f"{prefix}.{i}"
        entry = {"resnets": [_res_p(r, f"{blk}.resnets.{j}")
                             for j in range(_count(r, blk + ".resnets.{}.norm1.weight"))]}
        if f"{blk}.{sampler}s.0.conv.conv.weight" in r:
            entry[sampler] = _cc3d_p(r, f"{blk}.{sampler}s.0.conv")
        blocks.append(entry)
    return blocks


def hunyuan_video_vae_decoder_params_from_torch(sd: dict, device="cuda",
                                                dtype=torch.float32) -> Params:
    r = _Reader(sd, device, dtype)
    return ParamTree({
        "post_quant_conv": r.conv("post_quant_conv"),
        "decoder": {"conv_in": _cc3d_p(r, "decoder.conv_in"),
                    "mid": _mid_p(r, "decoder.mid_block"),
                    "up_blocks": _blocks_p(r, "decoder.up_blocks", "upsampler"),
                    "conv_norm_out": r.norm("decoder.conv_norm_out"),
                    "conv_out": _cc3d_p(r, "decoder.conv_out")},
    })


def hunyuan_video_vae_encoder_params_from_torch(sd: dict, device="cuda",
                                                dtype=torch.float32) -> Params:
    r = _Reader(sd, device, dtype)
    return ParamTree({
        "quant_conv": r.conv("quant_conv"),
        "encoder": {"conv_in": _cc3d_p(r, "encoder.conv_in"),
                    "down_blocks": _blocks_p(r, "encoder.down_blocks", "downsampler"),
                    "mid": _mid_p(r, "encoder.mid_block"),
                    "conv_norm_out": r.norm("encoder.conv_norm_out"),
                    "conv_out": _cc3d_p(r, "encoder.conv_out")},
    })


def _without_static(tree):
    """svi_tpu's pytree without its python-int leaves (the resamplers'
    `factor` / `stride`, which the port reads from `_RESAMPLE`)."""
    if isinstance(tree, dict):
        return {k: _without_static(v) for k, v in tree.items() if k not in ("factor", "stride")}
    if isinstance(tree, (list, tuple)):
        return [_without_static(v) for v in tree]
    return tree


def params_from_jax(params: dict, dtype=torch.float32, device="cuda") -> Params:
    """Any HunyuanVideo pytree of svi_tpu (the DiT, its double and single
    blocks stacked for svi_tpu's scan, or a VAE half) -> Params."""
    tree = _without_static(dict(params))
    for key, first in (("double_blocks", ("component_a", "mod", "linear", "w")),
                       ("single_blocks", ("mod", "linear", "w"))):
        if key in tree:
            leaf = tree[key]
            for k in first:
                leaf = leaf[k]
            tree[key] = unstack(tree[key], int(np.asarray(leaf).shape[0]))
    return ParamTree(convert_tree(tree, dtype, jax_leaf)).to(device)


# ---------------------------------------------------------------------------
# seeded random weights under the reference's names
# ---------------------------------------------------------------------------


def _cc3d_sd(m: StateDictMaker, name, cout, cin, k=3):
    """A CausalConv3d's weights (under its inner `.conv`)."""
    m.conv3d(f"{name}.conv", cout, cin, k)


def _component_sd(m, prefix, dim, mlp, hd, mods):
    m.lin(f"{prefix}.mod.linear", mods * dim, dim)
    m.lin(f"{prefix}.to_qkv", 3 * dim, dim)
    m.sd[f"{prefix}.norm_q.weight"] = 1 + m.randn((hd,), 0.1)
    m.sd[f"{prefix}.norm_k.weight"] = 1 + m.randn((hd,), 0.1)
    m.lin(f"{prefix}.to_out", dim, dim)
    m.lin(f"{prefix}.ff.0", mlp, dim)
    m.lin(f"{prefix}.ff.2", dim, mlp)


def hunyuan_video_dit_state_dict(seed=0, device="cpu", dtype=torch.bfloat16, dim=3072,
                                 num_double=20, num_single=40, num_refiner=2, text_dim=4096,
                                 pooled_dim=768, mlp_ratio=4, guidance=True) -> dict:
    """Seeded random HunyuanVideo DiT weights (the published 13B: 20 double
    and 40 single blocks 3072 wide, 24 heads of 128, a 2-block token
    refiner, the guidance embedder), in the reference's names."""
    m = StateDictMaker(seed, device, dtype)
    mlp, hd = mlp_ratio * dim, dim // NUM_HEADS
    m.sd["img_in.proj.weight"] = m.randn((dim, 16, 1, 2, 2), (16 * 4) ** -0.5)
    m.sd["img_in.proj.bias"] = m.randn((dim,), 0.02)
    m.lin("txt_in.input_embedder", dim, text_dim)
    m.lin("txt_in.t_embedder.timestep_embedder.0", dim, 256)
    m.lin("txt_in.t_embedder.timestep_embedder.2", dim, dim)
    m.lin("txt_in.c_embedder.0", dim, text_dim)
    m.lin("txt_in.c_embedder.2", dim, dim)
    for i in range(num_refiner):
        b = f"txt_in.blocks.{i}"
        m.norm(f"{b}.norm1", dim)
        m.lin(f"{b}.self_attn_qkv", 3 * dim, dim)
        m.lin(f"{b}.self_attn_proj", dim, dim)
        m.norm(f"{b}.norm2", dim)
        m.lin(f"{b}.mlp.0", mlp, dim)
        m.lin(f"{b}.mlp.2", dim, mlp)
        m.lin(f"{b}.adaLN_modulation.1", 2 * dim, dim)
    m.lin("time_in.timestep_embedder.0", dim, 256)
    m.lin("time_in.timestep_embedder.2", dim, dim)
    m.lin("vector_in.0", dim, pooled_dim)
    m.lin("vector_in.2", dim, dim)
    if guidance:
        m.lin("guidance_in.timestep_embedder.0", dim, 256)
        m.lin("guidance_in.timestep_embedder.2", dim, dim)
    for i in range(num_double):
        for comp in ("component_a", "component_b"):
            _component_sd(m, f"double_blocks.{i}.{comp}", dim, mlp, hd, 6)
    for i in range(num_single):
        _component_sd(m, f"single_blocks.{i}", dim, mlp, hd, 3)
    m.lin("final_layer.adaLN_modulation.1", 2 * dim, dim)
    m.lin("final_layer.linear", 16 * 4, dim)
    return m.sd


def _res_sd(m, prefix, cin, cout):
    m.norm(f"{prefix}.norm1", cin)
    _cc3d_sd(m, f"{prefix}.conv1", cout, cin)
    m.norm(f"{prefix}.norm2", cout)
    _cc3d_sd(m, f"{prefix}.conv2", cout, cout)
    if cin != cout:
        _cc3d_sd(m, f"{prefix}.conv_shortcut", cout, cin, k=1)


def _mid_sd(m, prefix, c):
    _res_sd(m, f"{prefix}.resnets.0", c, c)
    _res_sd(m, f"{prefix}.resnets.1", c, c)
    a = f"{prefix}.attentions.0"
    m.norm(f"{a}.group_norm", c)
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        m.lin(f"{a}.{n}", c, c)


HYV_VAE_CHANNELS = (128, 256, 512, 512)


def hunyuan_video_vae_decoder_state_dict(seed=0, device="cpu", dtype=torch.float32,
                                         channels=HYV_VAE_CHANNELS, layers=3) -> dict:
    """Seeded random causal-VAE decoder weights (the published widths)."""
    m = StateDictMaker(seed, device, dtype)
    rev = list(reversed(channels))
    m.sd["post_quant_conv.weight"] = m.randn((16, 16, 1, 1, 1), 0.25)
    m.sd["post_quant_conv.bias"] = m.randn((16,), 0.02)
    _cc3d_sd(m, "decoder.conv_in", rev[0], 16)
    _mid_sd(m, "decoder.mid_block", rev[0])
    cin = rev[0]
    for i, cout in enumerate(rev):
        for j in range(layers):
            _res_sd(m, f"decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
        if i < len(rev) - 1:
            _cc3d_sd(m, f"decoder.up_blocks.{i}.upsamplers.0.conv", cout, cout)
        cin = cout
    m.norm("decoder.conv_norm_out", rev[-1])
    _cc3d_sd(m, "decoder.conv_out", 3, rev[-1])
    return m.sd


def hunyuan_video_vae_encoder_state_dict(seed=0, device="cpu", dtype=torch.float32,
                                         channels=HYV_VAE_CHANNELS, layers=2) -> dict:
    """Seeded random causal-VAE encoder weights (the published widths)."""
    m = StateDictMaker(seed, device, dtype)
    _cc3d_sd(m, "encoder.conv_in", channels[0], 3)
    cin = channels[0]
    for i, cout in enumerate(channels):
        for j in range(layers):
            _res_sd(m, f"encoder.down_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout)
        if i < len(channels) - 1:
            _cc3d_sd(m, f"encoder.down_blocks.{i}.downsamplers.0.conv", cout, cout)
        cin = cout
    _mid_sd(m, "encoder.mid_block", channels[-1])
    m.norm("encoder.conv_norm_out", channels[-1])
    _cc3d_sd(m, "encoder.conv_out", 32, channels[-1])
    m.sd["quant_conv.weight"] = m.randn((32, 32, 1, 1, 1), 32 ** -0.5)
    m.sd["quant_conv.bias"] = m.randn((32,), 0.02)
    return m.sd
