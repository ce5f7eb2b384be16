"""Stable Diffusion 3 / 3.5: the MMDiT, the 16-channel VAE and the first text
encoder, port of svi_tpu/models/sd3.py.

The MMDiT patchifies the latents with a stride-2 convolution plus a cropped
global position embedding, conditions every block on the timestep and the
pooled text through AdaLayerNorm modulation, and runs joint attention over
the image tokens followed by the text tokens (`_joint_attention`), one flash
attention over both (the hand-written kernel on the card: f32 at D64 in
`SD3ImagePipeline`, 24 heads at SD3-medium's 1536 width). SD3.5's dual blocks
add a second, image-only attention; its per-head RMS q / k norms apply where
the weights carry them. The last block updates only the image stream.

The VAE is SD's plan machinery (`models.sd`) with 16 latent channels and no
quant convs, latents shifted by 0.0609 and scaled by 1.5305. The first text
encoder is CLIP-L's tower returning the final-LN EOS state (no projection)
and the penultimate hidden state; the second is SDXL's bigG
(`models.sdxl.sdxl_text_encoder_2_forward`).

`_ff`, `_rms` and `_ln_nowb` serve FLUX too. Weights are `ParamTree`s in
PyTorch's layouts, loaded by `*_params_from_torch(sd, device=...)` from the
reference's diffsynth names or by `*_params_from_jax`; `*_state_dict` write
seeded ones under those names.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..ops.conv import conv_f32
from .params import ParamTree, convert_tree, dense, unstack
from .sd import (
    StateDictMaker,
    _attention,
    _block_from,
    _conv2d,
    _group_norm,
    _layer_norm,
    _Reader,
    _run_plan,
    _tiled_nchw,
    _timesteps,
    jax_leaf,
    timestep_embedding,
)

SD3_VAE_SCALING_FACTOR = 1.5305
SD3_VAE_SHIFT_FACTOR = 0.0609

SD3_VAE_ENCODER_PLAN = (
    [("res", 128, 128), ("res", 128, 128), ("down", 128, 0, True),
     ("res", 128, 256), ("res", 256, 256), ("down", 256, 0, True),
     ("res", 256, 512), ("res", 512, 512), ("down", 512, 0, True),
     ("res", 512, 512), ("res", 512, 512),
     ("res", 512, 512), ("vae_attn", 512), ("res", 512, 512)]
)

SD3_VAE_DECODER_PLAN = (
    [("res", 512, 512), ("vae_attn", 512), ("res", 512, 512)]
    + [("res", 512, 512)] * 3 + [("up", 512)]
    + [("res", 512, 512)] * 3 + [("up", 512)]
    + [("res", 512, 256), ("res", 256, 256), ("res", 256, 256), ("up", 256)]
    + [("res", 256, 128), ("res", 128, 128), ("res", 128, 128)]
)


def _vae_encode(params, image, plan, shift, scale):
    x = _conv2d(params["conv_in"], image)
    x = _run_plan(plan, params["blocks"], x, None, None, eps_res=1e-6)
    x = _group_norm(params["conv_norm_out"], x, eps=1e-6)
    x = _conv2d(params["conv_out"], F.silu(x))
    return (x[:, :16] - shift) * scale


def _vae_decode(params, latents, plan, shift, scale):
    x = _conv2d(params["conv_in"], latents / scale + shift)
    x = _run_plan(plan, params["blocks"], x, None, None, eps_res=1e-6)
    x = _group_norm(params["conv_norm_out"], x, eps=1e-6)
    return _conv2d(params["conv_out"], F.silu(x))


def sd3_vae_encode(params, image, tiled=False, tile_size=64, tile_stride=32):
    """(B, 3, H, W) in [-1, 1] -> (B, 16, H/8, W/8): the mean channels,
    (x - 0.0609) * 1.5305. tiled: feathered tiles of the whole forward."""
    if tiled:
        return _tiled_nchw(lambda t: sd3_vae_encode(params, t), image, tile_size, tile_stride)
    return _vae_encode(params, image, SD3_VAE_ENCODER_PLAN, SD3_VAE_SHIFT_FACTOR,
                       SD3_VAE_SCALING_FACTOR)


def sd3_vae_decode(params, latents, tiled=False, tile_size=64, tile_stride=32):
    """(B, 16, h, w) latents -> (B, 3, 8h, 8w) images in about [-1, 1]."""
    if tiled:
        return _tiled_nchw(lambda t: sd3_vae_decode(params, t), latents, tile_size, tile_stride)
    return _vae_decode(params, latents, SD3_VAE_DECODER_PLAN, SD3_VAE_SHIFT_FACTOR,
                       SD3_VAE_SCALING_FACTOR)


# ---------------------------------------------------------------------------
# MMDiT
# ---------------------------------------------------------------------------


def _ln_nowb(x, eps=1e-6):
    """LayerNorm without weight or bias, f32 statistics, cast back."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _rms(x, w, eps=1e-6):
    """RMSNorm over the last axis, f32 statistics, times w where given."""
    xf = x.float()
    y = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)).to(x.dtype)
    return y * w.to(x.dtype) if w is not None else y


def _qkv(p, x, num_heads, head_dim, rms_q=None, rms_k=None):
    """Fused qkv laid out [q heads | k heads | v heads], optional q / k RMS."""
    b, s, _ = x.shape
    qkv = dense(p, x).reshape(b, s, 3, num_heads, head_dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if rms_q is not None:
        q = _rms(q, rms_q.get("w"))
    if rms_k is not None:
        k = _rms(k, rms_k.get("w"))
    return q, k, v


def _joint_attention(p, xa, xb, num_heads, head_dim, only_out_a=False):
    """Image (a) tokens then text (b) tokens in one attention, split back."""
    sa = xa.shape[1]
    qa, ka, va = _qkv(p["a_to_qkv"], xa, num_heads, head_dim, p.get("norm_q_a"),
                      p.get("norm_k_a"))
    qb, kb, vb = _qkv(p["b_to_qkv"], xb, num_heads, head_dim, p.get("norm_q_b"),
                      p.get("norm_k_b"))
    o = flash_attention(torch.cat([qa, qb], 1), torch.cat([ka, kb], 1), torch.cat([va, vb], 1))
    o = o.reshape(o.shape[0], o.shape[1], num_heads * head_dim)
    oa = dense(p["a_to_out"], o[:, :sa])
    if only_out_a:
        return oa
    return oa, dense(p["b_to_out"], o[:, sa:])


def _single_attention(p, x, num_heads, head_dim):
    q, k, v = _qkv(p["a_to_qkv"], x, num_heads, head_dim, p.get("norm_q_a"), p.get("norm_k_a"))
    o = flash_attention(q, k, v)
    return dense(p["a_to_out"], o.reshape(o.shape[0], o.shape[1], -1))


def _ada_mod(p, temb, n_chunks):
    """silu(temb) -> n * dim, as n (B, 1, dim) modulation chunks."""
    return dense(p["linear"], F.silu(temb))[:, None].chunk(n_chunks, dim=2)


def _ff(p, x):
    h = dense(p["0"], x)
    return dense(p["2"], F.gelu(h.float(), approximate="tanh").to(x.dtype))


def _joint_block(p, xa, xb, temb, num_heads, head_dim, dual=False, final=False):
    """JointTransformerBlock; dual: SD3.5's image-only second attention;
    final: the last block, which updates the image stream only."""
    if dual:
        (shift_a, scale_a, gate_a, shift_mlp_a, scale_mlp_a, gate_mlp_a,
         shift_a2, scale_a2, gate_a2) = _ada_mod(p["norm1_a"], temb, 9)
        norm_a = _ln_nowb(xa)
        na = norm_a * (1 + scale_a) + shift_a
        na2 = norm_a * (1 + scale_a2) + shift_a2
    else:
        shift_a, scale_a, gate_a, shift_mlp_a, scale_mlp_a, gate_mlp_a = \
            _ada_mod(p["norm1_a"], temb, 6)
        na = _ln_nowb(xa) * (1 + scale_a) + shift_a

    if final:  # single AdaLayerNorm: (scale, shift)
        scale_b, shift_b = _ada_mod(p["norm1_b"], temb, 2)
        nb = _ln_nowb(xb) * (1 + scale_b) + shift_b
        xa = xa + gate_a * _joint_attention(p["attn"], na, nb, num_heads, head_dim,
                                            only_out_a=True)
        na = _ln_nowb(xa) * (1 + scale_mlp_a) + shift_mlp_a
        return xa + gate_mlp_a * _ff(p["ff_a"], na), xb

    shift_b, scale_b, gate_b, shift_mlp_b, scale_mlp_b, gate_mlp_b = \
        _ada_mod(p["norm1_b"], temb, 6)
    nb = _ln_nowb(xb) * (1 + scale_b) + shift_b
    attn_a, attn_b = _joint_attention(p["attn"], na, nb, num_heads, head_dim)
    xa = xa + gate_a * attn_a
    if dual:
        xa = xa + gate_a2 * _single_attention(p["attn2"], na2, num_heads, head_dim)
    na = _ln_nowb(xa) * (1 + scale_mlp_a) + shift_mlp_a
    xa = xa + gate_mlp_a * _ff(p["ff_a"], na)
    xb = xb + gate_b * attn_b
    nb = _ln_nowb(xb) * (1 + scale_mlp_b) + shift_mlp_b
    return xa, xb + gate_mlp_b * _ff(p["ff_b"], nb)


def _cond_embed(params, timestep, pooled, device, dtype):
    """The timestep embedding plus the pooled text's, (B, dim)."""
    temb = timestep_embedding(_timesteps(timestep, device), 256).to(dtype)
    temb = dense(params["time_embedder"]["2"], F.silu(dense(params["time_embedder"]["0"], temb)))
    pt = params["pooled_text_embedder"]
    return temb + dense(pt["2"], F.silu(dense(pt["0"], pooled.to(dtype))))


def sd3_dit_forward(params, hidden_states, timestep, prompt_emb, pooled_prompt_emb,
                    patch_size=2, tiled=False, tile_size=128, tile_stride=64):
    """hidden_states (B, 16, H, W) latents; prompt_emb (B, S, 4096);
    pooled (B, 2048) -> the velocity (B, 16, H, W). tiled: feathered latent
    tiles of the whole forward (the global position embedding rules out
    tiling inside it)."""
    if tiled:
        return _tiled_nchw(lambda t: sd3_dit_forward(params, t, timestep, prompt_emb,
                                                     pooled_prompt_emb, patch_size),
                           hidden_states, tile_size, tile_stride)
    x = hidden_states
    b, _, h, w = x.shape
    dtype = x.dtype
    temb = _cond_embed(params, timestep, pooled_prompt_emb, x.device, dtype)
    ctx = dense(params["context_embedder"], prompt_emb.to(dtype))

    pe = params["pos_embedder"]
    xl = conv_f32(F.conv2d, x, pe["proj"]["w"], pe["proj"]["b"], patch_size, 0)
    hp, wp = h // patch_size, w // patch_size
    table = pe["pos_embed"]  # (1, P, P, dim)
    top, left = (table.shape[1] - hp) // 2, (table.shape[2] - wp) // 2
    xl = xl.permute(0, 2, 3, 1) + table[:, top:top + hp, left:left + wp].to(dtype)
    xa = xl.reshape(b, hp * wp, -1)

    num_heads = xa.shape[-1] // 64
    for p in params["dual_blocks"]:
        xa, ctx = _joint_block(p, xa, ctx, temb, num_heads, 64, dual=True)
    for p in params["mid_blocks"]:
        xa, ctx = _joint_block(p, xa, ctx, temb, num_heads, 64)
    xa, _ = _joint_block(params["final_block"], xa, ctx, temb, num_heads, 64, final=True)

    scale, shift = _ada_mod(params["norm_out"], temb, 2)
    xa = dense(params["proj_out"], _ln_nowb(xa) * (1 + scale) + shift)
    # B (H W) (P Q C) -> B C (H P) (W Q)
    xa = xa.reshape(b, hp, wp, patch_size, patch_size, -1)
    return xa.permute(0, 5, 1, 3, 2, 4).reshape(b, -1, h, w)


# ---------------------------------------------------------------------------
# text encoder 1 (CLIP-L: the pooled EOS state without projection, and the
# penultimate hidden state)
# ---------------------------------------------------------------------------


def sd3_text_encoder_1_forward(params, input_ids, clip_skip: int = 2, extra_mask=None):
    """(pooled (B, 768), hidden (B, S, 768)): the final-LN state at the
    argmax (EOS) id, and the pre-LN state after all but clip_skip - 1
    layers. extra_mask (B, S): keys where the first row is 0 are masked for
    every row, as the reference does."""
    dev = params["token_embedding"].device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    x = params["token_embedding"][input_ids] + params["position_embeds"][0]
    s = x.shape[1]
    mask = torch.triu(torch.full((s, s), float("-inf"), device=dev), 1)[None, None]
    if extra_mask is not None:
        mask = torch.where(torch.as_tensor(extra_mask, device=dev)[0][None, None, None, :] == 0,
                           float("-inf"), mask)
    keep = len(params["encoders"]) - clip_skip
    hidden = x
    for i, p in enumerate(params["encoders"]):
        x = x + _attention(p["attn"], _layer_norm(p["layer_norm1"], x), None, num_heads=12,
                           head_dim=64, mask=mask)
        y = dense(p["fc1"], _layer_norm(p["layer_norm2"], x))
        x = x + dense(p["fc2"], y * torch.sigmoid(1.702 * y.float()).to(y.dtype))
        if i == keep:
            hidden = x
    final = _layer_norm(params["final_layer_norm"], x)
    pooled = final[torch.arange(final.shape[0], device=dev), input_ids.argmax(-1)]
    return pooled, hidden


# ---------------------------------------------------------------------------
# checkpoints in the reference's diffsynth naming
# ---------------------------------------------------------------------------


def _attn_p(r: _Reader, prefix, joint=True):
    p = {"a_to_qkv": r.lin(f"{prefix}.a_to_qkv"), "a_to_out": r.lin(f"{prefix}.a_to_out")}
    if joint:
        p["b_to_qkv"] = r.lin(f"{prefix}.b_to_qkv")
        if f"{prefix}.b_to_out.weight" in r:
            p["b_to_out"] = r.lin(f"{prefix}.b_to_out")
    for n in ("norm_q_a", "norm_k_a", "norm_q_b", "norm_k_b"):
        if f"{prefix}.{n}.weight" in r:
            p[n] = {"w": r.t(f"{prefix}.{n}.weight")}
    return p


def _joint_block_p(r: _Reader, prefix, dual=False, final=False):
    p = {"norm1_a": {"linear": r.lin(f"{prefix}.norm1_a.linear")},
         "norm1_b": {"linear": r.lin(f"{prefix}.norm1_b.linear")},
         "attn": _attn_p(r, f"{prefix}.attn"),
         "ff_a": {"0": r.lin(f"{prefix}.ff_a.0"), "2": r.lin(f"{prefix}.ff_a.2")}}
    if not final:
        p["ff_b"] = {"0": r.lin(f"{prefix}.ff_b.0"), "2": r.lin(f"{prefix}.ff_b.2")}
    if dual:
        p["attn2"] = _attn_p(r, f"{prefix}.attn2", joint=False)
    return p


def sd3_dit_params_from_torch(sd: dict, num_dual_blocks: int = 0, device="cuda",
                              dtype=torch.float32) -> ParamTree:
    r = _Reader(sd, device, dtype)
    n = 0
    while f"blocks.{n}.norm1_a.linear.weight" in r:
        n += 1
    return ParamTree({
        "pos_embedder": {"proj": r.conv("pos_embedder.proj"),
                         "pos_embed": r.t("pos_embedder.pos_embed")},
        "time_embedder": {"0": r.lin("time_embedder.timestep_embedder.0"),
                          "2": r.lin("time_embedder.timestep_embedder.2")},
        "pooled_text_embedder": {"0": r.lin("pooled_text_embedder.0"),
                                 "2": r.lin("pooled_text_embedder.2")},
        "context_embedder": r.lin("context_embedder"),
        "dual_blocks": [_joint_block_p(r, f"blocks.{i}", dual=True)
                        for i in range(num_dual_blocks)],
        "mid_blocks": [_joint_block_p(r, f"blocks.{i}") for i in range(num_dual_blocks, n - 1)],
        "final_block": _joint_block_p(r, f"blocks.{n - 1}", final=True),
        "norm_out": {"linear": r.lin("norm_out.linear")},
        "proj_out": r.lin("proj_out"),
    })


def _vae_params(sd, plan, device, dtype) -> ParamTree:
    r = _Reader(sd, device, dtype)
    return ParamTree({"conv_in": r.conv("conv_in"),
                      "blocks": [_block_from(r, i, d) for i, d in enumerate(plan)],
                      "conv_norm_out": r.norm("conv_norm_out"), "conv_out": r.conv("conv_out")})


def sd3_vae_encoder_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> ParamTree:
    return _vae_params(sd, SD3_VAE_ENCODER_PLAN, device, dtype)


def sd3_vae_decoder_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> ParamTree:
    return _vae_params(sd, SD3_VAE_DECODER_PLAN, device, dtype)


def params_from_jax(params: dict, dtype=torch.float32, device="cuda") -> ParamTree:
    """Any SD3 pytree of svi_tpu: the MMDiT (its middle blocks stacked for
    svi_tpu's scan), a VAE half or the first text encoder (`encoders`
    stacked)."""
    if "encoders" in params:
        from .sd import sd_text_encoder_params_from_jax

        return sd_text_encoder_params_from_jax(params, dtype, device)
    tree = dict(params)
    if "final_block" in params:
        mids = params.get("mid_blocks")
        n = 0 if mids is None else int(np.asarray(mids["norm1_a"]["linear"]["w"]).shape[0])
        tree["mid_blocks"] = [] if mids is None else unstack(mids, n)
        tree["dual_blocks"] = list(params.get("dual_blocks", []))
    return ParamTree(convert_tree(tree, dtype, jax_leaf)).to(device)


# ---------------------------------------------------------------------------
# seeded random weights under the reference's names
# ---------------------------------------------------------------------------


def _joint_block_sd(m: StateDictMaker, prefix, dim, dual=False, final=False, qk_norm=False):
    m.lin(f"{prefix}.norm1_a.linear", (9 if dual else 6) * dim, dim)
    m.lin(f"{prefix}.norm1_b.linear", (2 if final else 6) * dim, dim)
    m.lin(f"{prefix}.attn.a_to_qkv", 3 * dim, dim)
    m.lin(f"{prefix}.attn.b_to_qkv", 3 * dim, dim)
    m.lin(f"{prefix}.attn.a_to_out", dim, dim)
    if not final:
        m.lin(f"{prefix}.attn.b_to_out", dim, dim)
    if qk_norm:
        for n in ("norm_q_a", "norm_k_a", "norm_q_b", "norm_k_b"):
            m.sd[f"{prefix}.attn.{n}.weight"] = 1 + m.randn((64,), 0.1)
    for ff in ("ff_a",) + (() if final else ("ff_b",)):
        m.lin(f"{prefix}.{ff}.0", 4 * dim, dim)
        m.lin(f"{prefix}.{ff}.2", dim, 4 * dim)
    if dual:
        m.lin(f"{prefix}.attn2.a_to_qkv", 3 * dim, dim)
        m.lin(f"{prefix}.attn2.a_to_out", dim, dim)
        if qk_norm:
            for n in ("norm_q_a", "norm_k_a"):
                m.sd[f"{prefix}.attn2.{n}.weight"] = 1 + m.randn((64,), 0.1)


def sd3_dit_state_dict(seed=0, device="cpu", dtype=torch.float32, dim=1536, num_layers=24,
                       num_dual_blocks=0, qk_norm=False, pos_embed_max=192,
                       text_dim=4096, pooled_dim=2048) -> dict:
    """Seeded random MMDiT weights (SD3-medium's: 24 blocks 1536 wide, 2.03B
    parameters); num_dual_blocks / qk_norm give SD3.5-medium's layout."""
    m = StateDictMaker(seed, device, dtype)
    m.conv("pos_embedder.proj", dim, 16, k=2)
    m.sd["pos_embedder.pos_embed"] = m.randn((1, pos_embed_max, pos_embed_max, dim), 0.02)
    m.lin("time_embedder.timestep_embedder.0", dim, 256)
    m.lin("time_embedder.timestep_embedder.2", dim, dim)
    m.lin("pooled_text_embedder.0", dim, pooled_dim)
    m.lin("pooled_text_embedder.2", dim, dim)
    m.lin("context_embedder", dim, text_dim)
    for i in range(num_layers):
        _joint_block_sd(m, f"blocks.{i}", dim, dual=i < num_dual_blocks,
                        final=i == num_layers - 1, qk_norm=qk_norm)
    m.lin("norm_out.linear", 2 * dim, dim)
    m.lin("proj_out", 2 * 2 * 16, dim)
    return m.sd


def sd3_vae_encoder_state_dict(seed=0, device="cpu", dtype=torch.float32) -> dict:
    """Seeded random weights of the 16-channel VAE's encoder (no quant conv)."""
    plan, m = SD3_VAE_ENCODER_PLAN, StateDictMaker(seed, device, dtype)
    m.conv("conv_in", plan[0][1], 3)
    m.plan_blocks(plan)
    c = plan[-1][2]
    m.norm("conv_norm_out", c)
    m.conv("conv_out", 32, c)
    return m.sd


def sd3_vae_decoder_state_dict(seed=0, device="cpu", dtype=torch.float32) -> dict:
    plan, m = SD3_VAE_DECODER_PLAN, StateDictMaker(seed, device, dtype)
    m.conv("conv_in", plan[0][1], 16)
    m.plan_blocks(plan)
    c = plan[-1][2]
    m.norm("conv_norm_out", c)
    m.conv("conv_out", 3, c)
    return m.sd
