"""FLUX.1: the double- and single-stream DiT, its ControlNet and IP-Adapter,
and the 16-channel VAE, port of svi_tpu/models/flux.py.

The DiT embeds the 2x2-patchified latents and the T5 text, conditions every
block on the timestep, the pooled CLIP text and (FLUX.1-dev) the embedded
guidance, then runs 19 joint blocks (text and image streams, one attention
over [text | image]) and 38 single blocks (one fused qkv + MLP projection
over the joined sequence). The 3-axis RoPE (16 / 56 / 56 of each 128-wide
head) is applied to q and k in plain torch before the attention, as the JAX
package does; the attention is the hand-written kernel (bf16 D128: route
sm90 on the card). EliGen's entity prompts add a block attention mask, which
runs the plain f32 softmax, as in the JAX package. The IP-Adapter's
attention onto its 128 image tokens goes through the kernel too.

The VAE is SD3's architecture at scale 0.3611 / shift 0.1159. Weights are
`ParamTree`s in PyTorch's layouts, loaded by `*_params_from_torch(sd,
device=...)` from the reference's diffsynth names or by `*_params_from_jax`;
`*_state_dict` write seeded ones under those names (FLUX.1-dev's widths by
default).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from .params import ParamTree, convert_tree, dense, unstack
from .sd import StateDictMaker, _Reader, _tiled_nchw, _timesteps, jax_leaf, timestep_embedding
from .sd3 import (
    SD3_VAE_DECODER_PLAN,
    SD3_VAE_ENCODER_PLAN,
    _ada_mod,
    _ff,
    _ln_nowb,
    _rms,
    _vae_decode,
    _vae_encode,
    sd3_vae_decoder_params_from_torch,
    sd3_vae_decoder_state_dict,
    sd3_vae_encoder_params_from_torch,
    sd3_vae_encoder_state_dict,
)

FLUX_VAE_SCALING_FACTOR = 0.3611
FLUX_VAE_SHIFT_FACTOR = 0.1159


def flux_vae_encode(params, image, tiled=False, tile_size=64, tile_stride=32):
    """(B, 3, H, W) in [-1, 1] -> (B, 16, H/8, W/8), (x - 0.1159) * 0.3611."""
    if tiled:
        return _tiled_nchw(lambda t: flux_vae_encode(params, t), image, tile_size, tile_stride)
    return _vae_encode(params, image, SD3_VAE_ENCODER_PLAN, FLUX_VAE_SHIFT_FACTOR,
                       FLUX_VAE_SCALING_FACTOR)


def flux_vae_decode(params, latents, tiled=False, tile_size=64, tile_stride=32):
    if tiled:
        return _tiled_nchw(lambda t: flux_vae_decode(params, t), latents, tile_size, tile_stride)
    return _vae_decode(params, latents, SD3_VAE_DECODER_PLAN, FLUX_VAE_SHIFT_FACTOR,
                       FLUX_VAE_SCALING_FACTOR)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def flux_rope_tables(ids, axes_dim=(16, 56, 56), theta=10000.0):
    """ids (B, S, 3) positions -> cos, sin (B, S, head_dim // 2) f32, the
    pairs laid out axis by axis."""
    ids = torch.as_tensor(ids)
    outs = []
    for i, d in enumerate(axes_dim):
        scale = torch.arange(0, d, 2, dtype=torch.float32, device=ids.device) / d
        omega = 1.0 / (theta ** scale)
        outs.append(ids[..., i].float()[..., None] * omega[None, None])
    out = torch.cat(outs, dim=-1)
    return torch.cos(out), torch.sin(out)


def _apply_rope(x, cos, sin):
    """Interleaved-pair rotation of (B, S, N, D) in f32, cast back."""
    xf = x.float()
    xe, xo = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[:, :, None], sin[:, :, None]
    return torch.stack([c * xe - s * xo, s * xe + c * xo], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# attention / blocks
# ---------------------------------------------------------------------------


def _qkv_rms(p_qkv, x, num_heads, head_dim, rms_q, rms_k):
    b, s, _ = x.shape
    qkv = dense(p_qkv, x).reshape(b, s, 3, num_heads, head_dim)
    return _rms(qkv[:, :, 0], rms_q["w"]), _rms(qkv[:, :, 1], rms_k["w"]), qkv[:, :, 2]


def _attn(q, k, v, mask=None):
    """The flash kernel, or with an (additive) mask the plain f32 softmax."""
    if mask is None:
        return flash_attention(q, k, v)
    logits = torch.einsum("bsnd,bknd->bnsk", q.float(), k.float()) * (q.shape[-1] ** -0.5)
    probs = torch.softmax(logits + mask.float(), dim=-1)
    return torch.einsum("bnsk,bknd->bsnd", probs.to(v.dtype), v)


def _ip_attend(x, q, ipadapter):
    """x plus scale times the attention of the queries q (B, S, N, D) onto
    the IP tokens (ip_k / ip_v (1 or B, T, N, D))."""
    b, s = x.shape[:2]
    ip_k, ip_v = (ipadapter[n].to(q.dtype) for n in ("ip_k", "ip_v"))
    if ip_k.shape[0] != b:
        ip_k, ip_v = (t.expand(b, -1, -1, -1).contiguous() for t in (ip_k, ip_v))
    o = flash_attention(q.contiguous(), ip_k, ip_v)
    return x + ipadapter.get("scale", 1.0) * o.reshape(b, s, -1)


def _flux_joint_attention(p, xa, xb, cos, sin, num_heads, head_dim, only_out_a=False, mask=None,
                          ipadapter=None):
    """Text (b) tokens lead the joined sequence; the IP-Adapter attends with
    the image queries before RoPE."""
    sb = xb.shape[1]
    qa, ka, va = _qkv_rms(p["a_to_qkv"], xa, num_heads, head_dim, p["norm_q_a"], p["norm_k_a"])
    qb, kb, vb = _qkv_rms(p["b_to_qkv"], xb, num_heads, head_dim, p["norm_q_b"], p["norm_k_b"])
    q = _apply_rope(torch.cat([qb, qa], 1), cos, sin)
    k = _apply_rope(torch.cat([kb, ka], 1), cos, sin)
    o = _attn(q, k, torch.cat([vb, va], 1), mask)
    o = o.reshape(o.shape[0], o.shape[1], num_heads * head_dim)
    oa = o[:, sb:]
    if ipadapter is not None:
        oa = _ip_attend(oa, qa, ipadapter)
    oa = dense(p["a_to_out"], oa)
    if only_out_a:
        return oa
    return oa, dense(p["b_to_out"], o[:, :sb])


def _flux_joint_block(p, xa, xb, temb, cos, sin, num_heads, head_dim, mask=None,
                      ipadapter=None):
    shift_a, scale_a, gate_a, shift_mlp_a, scale_mlp_a, gate_mlp_a = \
        _ada_mod(p["norm1_a"], temb, 6)
    shift_b, scale_b, gate_b, shift_mlp_b, scale_mlp_b, gate_mlp_b = \
        _ada_mod(p["norm1_b"], temb, 6)
    na = _ln_nowb(xa) * (1 + scale_a) + shift_a
    nb = _ln_nowb(xb) * (1 + scale_b) + shift_b
    attn_a, attn_b = _flux_joint_attention(p["attn"], na, nb, cos, sin, num_heads, head_dim,
                                           mask=mask, ipadapter=ipadapter)
    xa = xa + gate_a * attn_a
    xa = xa + gate_mlp_a * _ff(p["ff_a"], _ln_nowb(xa) * (1 + scale_mlp_a) + shift_mlp_a)
    xb = xb + gate_b * attn_b
    xb = xb + gate_mlp_b * _ff(p["ff_b"], _ln_nowb(xb) * (1 + scale_mlp_b) + shift_mlp_b)
    return xa, xb


def _flux_single_block(p, x, temb, cos, sin, num_heads, head_dim, mask=None, ipadapter=None):
    """One fused qkv + MLP projection; attention and tanh-GELU MLP joined
    into one output projection, gated. The IP-Adapter attends with the
    queries after RoPE over the whole sequence."""
    dim = x.shape[-1]
    shift, scale, gate = dense(p["norm"]["linear"], F.silu(temb))[:, None].chunk(3, dim=2)
    h = dense(p["to_qkv_mlp"], _ln_nowb(x) * (1 + scale) + shift)
    qkv, mlp = h[..., :dim * 3], h[..., dim * 3:]
    b, s, _ = qkv.shape
    qkv = qkv.reshape(b, s, 3, num_heads, head_dim)
    q = _apply_rope(_rms(qkv[:, :, 0], p["norm_q_a"]["w"]), cos, sin)
    k = _apply_rope(_rms(qkv[:, :, 1], p["norm_k_a"]["w"]), cos, sin)
    o = _attn(q, k, qkv[:, :, 2], mask).reshape(b, s, num_heads * head_dim)
    if ipadapter is not None:
        o = _ip_attend(o, q, ipadapter)
    mlp = F.gelu(mlp.float(), approximate="tanh").to(x.dtype)
    return x + gate * dense(p["proj_out"], torch.cat([o, mlp], dim=2))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def prepare_image_ids(latents):
    """(B, (H/2)(W/2), 3) ids = (0, row, col), f32."""
    b, _, h, w = latents.shape
    rows, cols = torch.meshgrid(torch.arange(h // 2, dtype=torch.float32),
                                torch.arange(w // 2, dtype=torch.float32), indexing="ij")
    ids = torch.stack([torch.zeros_like(rows), rows, cols], dim=-1).reshape(1, -1, 3)
    return ids.expand(b, -1, -1).to(latents.device)


def _patchify(x):
    """B C (H P) (W Q) -> B (H W) (C P Q), P = Q = 2."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(b, (h // 2) * (w // 2), c * 4)


def _unpatchify(x, h, w):
    b, c = x.shape[0], x.shape[-1] // 4
    x = x.reshape(b, h // 2, w // 2, c, 2, 2)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, c, h, w)


def _entity_attention_mask(patched_masks, s_txt, s_img):
    """Each entity prompt sees only its masked image tokens (and they it);
    entity prompts do not see each other; the global prompt (the last group)
    sees all its all-ones mask allows. An additive (B, 1, S, S) f32 mask."""
    n = len(patched_masks)
    b = patched_masks[0].shape[0]
    total = n * s_txt + s_img
    dev = patched_masks[0].device
    m = torch.ones((b, total, total), dtype=torch.bool, device=dev)
    img0 = n * s_txt
    for i, pm in enumerate(patched_masks):
        blk = (pm.sum(dim=-1) > 0)[:, None, :].expand(b, s_txt, s_img)
        m[:, i * s_txt:(i + 1) * s_txt, img0:] = blk
        m[:, img0:, i * s_txt:(i + 1) * s_txt] = blk.transpose(1, 2)
    for i in range(n):
        for j in range(n):
            if i != j:
                m[:, i * s_txt:(i + 1) * s_txt, j * s_txt:(j + 1) * s_txt] = False
    return torch.where(m, 0.0, float("-inf")).float()[:, None]


def _cond(params, timestep, pooled, guidance, device, dtype):
    """Timestep + pooled text (+ guidance x 1000 where the DiT embeds it)."""
    temb = timestep_embedding(_timesteps(timestep, device), 256).to(dtype)
    temb = dense(params["time_embedder"]["2"], F.silu(dense(params["time_embedder"]["0"], temb)))
    pt = params["pooled_text_embedder"]
    temb = temb + dense(pt["2"], F.silu(dense(pt["0"], pooled.to(dtype))))
    if "guidance_embedder" in params and guidance is not None:
        # scaled in the guidance's own dtype (bf16 in the pipeline), as svi_tpu does
        g = timestep_embedding(_timesteps(guidance, device) * 1000, 256).to(dtype)
        ge = params["guidance_embedder"]
        temb = temb + dense(ge["2"], F.silu(dense(ge["0"], g)))
    return temb


def flux_dit_forward(params, hidden_states, timestep, prompt_emb, pooled_prompt_emb,
                     guidance=None, text_ids=None, image_ids=None, attn_mask=None,
                     controlnet_res=None, ipadapter=None, tiled=False, tile_size=128,
                     tile_stride=64, entity_prompt_emb=None, entity_masks=None):
    """hidden_states (B, 16, H, W); prompt_emb (B, S, 4096) T5 states;
    pooled (B, 768) CLIP; guidance (B,) -> the velocity (B, 16, H, W).
    controlnet_res: (joint (19, B, S, D), single (38, B, S, D)) residuals
    added after each block; ipadapter: (ip_k (57, 1, T, N, D), ip_v, scale)
    from `flux_ipadapter_forward`, the joint blocks taking rows [:19].
    tiled: feathered latent tiles of the whole forward, RoPE ids per tile."""
    if tiled:
        return _tiled_nchw(lambda t: flux_dit_forward(
            params, t, timestep, prompt_emb, pooled_prompt_emb, guidance=guidance,
            text_ids=text_ids, image_ids=None), hidden_states, tile_size, tile_stride)
    h, w = hidden_states.shape[-2:]
    xa, ctx, temb, cos, sin, attn_mask = flux_dit_prelude(
        params, hidden_states, timestep, prompt_emb, pooled_prompt_emb, guidance=guidance,
        text_ids=text_ids, image_ids=image_ids, attn_mask=attn_mask,
        entity_prompt_emb=entity_prompt_emb, entity_masks=entity_masks)
    xa = flux_dit_blocks(params, xa, ctx, temb, cos, sin, attn_mask=attn_mask,
                         controlnet_res=controlnet_res, ipadapter=ipadapter)
    return flux_dit_head(params, xa, temb, h, w)


def flux_dit_prelude(params, hidden_states, timestep, prompt_emb, pooled_prompt_emb,
                     guidance=None, text_ids=None, image_ids=None, attn_mask=None,
                     entity_prompt_emb=None, entity_masks=None):
    """Everything before the blocks: the conditioning, the patchified and
    embedded latents, the embedded text (EliGen's entity groups first, with
    their block mask), the RoPE tables. Returns (xa, ctx, temb, cos, sin,
    attn_mask); TeaCache decides on xa."""
    x = hidden_states
    b = x.shape[0]
    dtype, dev = x.dtype, x.device
    prompt_emb = prompt_emb.to(dtype)
    if image_ids is None:
        image_ids = prepare_image_ids(x)
    if text_ids is None:
        text_ids = torch.zeros((b, prompt_emb.shape[1], 3), dtype=torch.float32, device=dev)
    if entity_prompt_emb is not None and entity_masks is not None:
        entity_prompt_emb = entity_prompt_emb.to(dtype)
        n_ent = entity_masks.shape[1]
        mask_imgs = [entity_masks[:, i].to(dtype).repeat_interleave(x.shape[1], dim=1)
                     for i in range(n_ent)]
        mask_imgs.append(torch.ones_like(mask_imgs[0]))
        patched = [_patchify(m) for m in mask_imgs]
        attn_mask = _entity_attention_mask(patched, prompt_emb.shape[1], patched[0].shape[1])
        prompt_emb = torch.cat([entity_prompt_emb[:, i] for i in range(n_ent)] + [prompt_emb],
                               dim=1)
        text_ids = torch.cat([text_ids] * (n_ent + 1), dim=1)
    temb = _cond(params, timestep, pooled_prompt_emb, guidance, dev, dtype)
    xa = dense(params["x_embedder"], _patchify(x))
    ctx = dense(params["context_embedder"], prompt_emb)
    cos, sin = flux_rope_tables(torch.cat([text_ids.to(dev).float(), image_ids.float()], dim=1))
    return xa, ctx, temb, cos, sin, attn_mask


def flux_teacache_modulated(params, xa, temb):
    """The first joint block's modulated image input: TeaCache's signal."""
    shift_a, scale_a, *_ = _ada_mod(params["blocks"][0]["norm1_a"], temb, 6)
    return _ln_nowb(xa) * (1 + scale_a) + shift_a


def flux_dit_blocks(params, xa, ctx, temb, cos, sin, attn_mask=None, controlnet_res=None,
                    ipadapter=None):
    """The joint then the single blocks; returns the image tokens."""
    num_heads = xa.shape[-1] // 128
    n_joint = len(params["blocks"])
    joint_res, single_res = controlnet_res if controlnet_res is not None else (None, None)

    def ip(i):
        if ipadapter is None:
            return None
        return {"ip_k": ipadapter[0][i], "ip_v": ipadapter[1][i], "scale": ipadapter[2]}

    for i, p in enumerate(params["blocks"]):
        xa, ctx = _flux_joint_block(p, xa, ctx, temb, cos, sin, num_heads, 128, mask=attn_mask,
                                    ipadapter=ip(i))
        if joint_res is not None:
            xa = xa + joint_res[i].to(xa.dtype)
    sb = ctx.shape[1]
    x = torch.cat([ctx, xa], dim=1)
    for i, p in enumerate(params["single_blocks"]):
        x = _flux_single_block(p, x, temb, cos, sin, num_heads, 128, mask=attn_mask,
                               ipadapter=ip(n_joint + i))
        if single_res is not None:
            x = torch.cat([x[:, :sb], x[:, sb:] + single_res[i].to(x.dtype)], dim=1)
    return x[:, sb:]


def flux_dit_head(params, xa, temb, h, w):
    """AdaLayerNormContinuous (scale first), the projection, unpatchify."""
    scale, shift = dense(params["final_norm_out"]["linear"], F.silu(temb))[:, None].chunk(2, 2)
    return _unpatchify(dense(params["final_proj_out"], _ln_nowb(xa) * (1 + scale) + shift), h, w)


# ---------------------------------------------------------------------------
# ControlNet
# ---------------------------------------------------------------------------


def align_res_stack(res, num_blocks):
    """(n, B, S, D) residuals -> (num_blocks, B, S, D) by interval repetition."""
    n = res.shape[0]
    interval = (num_blocks + n - 1) // n
    return res[torch.from_numpy(np.arange(num_blocks) // interval).to(res.device)]


def flux_controlnet_forward(params, hidden_states, controlnet_conditioning, timestep, prompt_emb,
                            pooled_prompt_emb, guidance=None, text_ids=None, image_ids=None,
                            processor_id_index=None, num_joint_out=19, num_single_out=38):
    """A truncated FLUX DiT whose per-block linear taps become the full
    DiT's residuals; the control latents add a second x embedding, and a
    union ControlNet prepends its task's mode embedding to the text. Returns
    (joint (num_joint_out, B, S, D), single (num_single_out, B, S, D))."""
    x = hidden_states
    b = x.shape[0]
    dtype, dev = x.dtype, x.device
    if image_ids is None:
        image_ids = prepare_image_ids(x)
    if text_ids is None:
        text_ids = torch.zeros((b, prompt_emb.shape[1], 3), dtype=torch.float32, device=dev)
    temb = _cond(params, timestep, pooled_prompt_emb, guidance, dev, dtype)
    ctx = dense(params["context_embedder"], prompt_emb.to(dtype))
    if "controlnet_mode_embedder" in params:
        mode = params["controlnet_mode_embedder"][int(processor_id_index)].to(dtype)
        ctx = torch.cat([mode.expand(b, 1, ctx.shape[-1]), ctx], dim=1)
        text_ids = torch.cat([text_ids[:, :1], text_ids], dim=1)
    cos, sin = flux_rope_tables(torch.cat([text_ids.to(dev).float(), image_ids.float()], dim=1))
    xa = dense(params["x_embedder"], _patchify(x))
    xa = xa + dense(params["controlnet_x_embedder"], _patchify(controlnet_conditioning.to(dtype)))
    num_heads = xa.shape[-1] // 128
    joint_res = []
    for p, tap in zip(params["blocks"], params["controlnet_blocks"]):
        xa, ctx = _flux_joint_block(p, xa, ctx, temb, cos, sin, num_heads, 128)
        joint_res.append(dense(tap, xa))
    sb = ctx.shape[1]
    x = torch.cat([ctx, xa], dim=1)
    single_res = []
    for p, tap in zip(params["single_blocks"], params["controlnet_single_blocks"]):
        x = _flux_single_block(p, x, temb, cos, sin, num_heads, 128)
        single_res.append(dense(tap, x[:, sb:]))
    return (align_res_stack(torch.stack(joint_res), num_joint_out),
            align_res_stack(torch.stack(single_res), num_single_out))


# ---------------------------------------------------------------------------
# IP-Adapter
# ---------------------------------------------------------------------------


def flux_ipadapter_forward(params, image_emb, scale=1.0, num_heads=24, head_dim=128):
    """A SigLIP image embedding (B, 1152) -> 128 tokens of 4096 through the
    MLP projector and its LayerNorm, then each block's K / V (K RMS-normed,
    no affine). Returns (ip_k (L, 1, T, N, D), ip_v, scale)."""
    ipj = params["image_proj"]
    x = dense(ipj["0"], image_emb)
    x = dense(ipj["2"], F.gelu(x.float()).to(x.dtype))
    d = ipj["norm"]["w"].shape[0]
    x = x.reshape(-1, x.shape[-1] // d, d)
    x = F.layer_norm(x.float(), (d,), ipj["norm"]["w"].float(), ipj["norm"]["b"].float(),
                     1e-5).to(x.dtype).reshape(1, -1, d)
    t = x.shape[1]
    ks, vs = [], []
    for p in params["ipadapter_modules"]:
        kf = dense(p["to_k_ip"], x).reshape(1, t, num_heads, head_dim).float()
        ks.append((kf * torch.rsqrt((kf * kf).mean(-1, keepdim=True) + 1e-5)).to(x.dtype))
        vs.append(dense(p["to_v_ip"], x).reshape(1, t, num_heads, head_dim))
    return torch.stack(ks), torch.stack(vs), scale


# ---------------------------------------------------------------------------
# checkpoints in the reference's diffsynth naming
# ---------------------------------------------------------------------------


def _rms_p(r, prefix):
    return {"w": r.t(f"{prefix}.weight")}


def _joint_p(r: _Reader, prefix):
    a = f"{prefix}.attn"
    return {
        "norm1_a": {"linear": r.lin(f"{prefix}.norm1_a.linear")},
        "norm1_b": {"linear": r.lin(f"{prefix}.norm1_b.linear")},
        "attn": {"a_to_qkv": r.lin(f"{a}.a_to_qkv"), "b_to_qkv": r.lin(f"{a}.b_to_qkv"),
                 "a_to_out": r.lin(f"{a}.a_to_out"), "b_to_out": r.lin(f"{a}.b_to_out"),
                 **{n: _rms_p(r, f"{a}.{n}")
                    for n in ("norm_q_a", "norm_k_a", "norm_q_b", "norm_k_b")}},
        "ff_a": {"0": r.lin(f"{prefix}.ff_a.0"), "2": r.lin(f"{prefix}.ff_a.2")},
        "ff_b": {"0": r.lin(f"{prefix}.ff_b.0"), "2": r.lin(f"{prefix}.ff_b.2")},
    }


def _single_p(r: _Reader, prefix):
    return {"norm": {"linear": r.lin(f"{prefix}.norm.linear")},
            "to_qkv_mlp": r.lin(f"{prefix}.to_qkv_mlp"),
            "norm_q_a": _rms_p(r, f"{prefix}.norm_q_a"),
            "norm_k_a": _rms_p(r, f"{prefix}.norm_k_a"),
            "proj_out": r.lin(f"{prefix}.proj_out")}


def _count(r, fmt):
    n = 0
    while fmt.format(n) in r:
        n += 1
    return n


def _dit_common(r: _Reader) -> dict:
    n_joint = _count(r, "blocks.{}.norm1_a.linear.weight")
    n_single = _count(r, "single_blocks.{}.norm.linear.weight")
    tree = {
        "time_embedder": {"0": r.lin("time_embedder.timestep_embedder.0"),
                          "2": r.lin("time_embedder.timestep_embedder.2")},
        "pooled_text_embedder": {"0": r.lin("pooled_text_embedder.0"),
                                 "2": r.lin("pooled_text_embedder.2")},
        "context_embedder": r.lin("context_embedder"),
        "x_embedder": r.lin("x_embedder"),
        "blocks": [_joint_p(r, f"blocks.{i}") for i in range(n_joint)],
        "single_blocks": [_single_p(r, f"single_blocks.{i}") for i in range(n_single)],
    }
    if "guidance_embedder.timestep_embedder.0.weight" in r:
        tree["guidance_embedder"] = {"0": r.lin("guidance_embedder.timestep_embedder.0"),
                                     "2": r.lin("guidance_embedder.timestep_embedder.2")}
    return tree


def flux_dit_params_from_torch(sd: dict, device="cuda", dtype=torch.bfloat16) -> ParamTree:
    r = _Reader(sd, device, dtype)
    tree = _dit_common(r)
    tree["final_norm_out"] = {"linear": r.lin("final_norm_out.linear")}
    tree["final_proj_out"] = r.lin("final_proj_out")
    return ParamTree(tree)


def flux_vae_encoder_params_from_torch(sd: dict, device="cuda", dtype=torch.float32):
    return sd3_vae_encoder_params_from_torch(sd, device, dtype)


def flux_vae_decoder_params_from_torch(sd: dict, device="cuda", dtype=torch.float32):
    return sd3_vae_decoder_params_from_torch(sd, device, dtype)


def flux_controlnet_params_from_torch(sd: dict, device="cuda",
                                      dtype=torch.bfloat16) -> ParamTree:
    r = _Reader(sd, device, dtype)
    tree = _dit_common(r)
    tree["controlnet_x_embedder"] = r.lin("controlnet_x_embedder")
    tree["controlnet_blocks"] = [r.lin(f"controlnet_blocks.{i}")
                                 for i in range(len(tree["blocks"]))]
    tree["controlnet_single_blocks"] = [r.lin(f"controlnet_single_blocks.{i}")
                                        for i in range(len(tree["single_blocks"]))]
    if "controlnet_mode_embedder.weight" in r:
        tree["controlnet_mode_embedder"] = r.t("controlnet_mode_embedder.weight")
    return ParamTree(tree)


def flux_ipadapter_params_from_torch(sd: dict, device="cuda",
                                     dtype=torch.bfloat16) -> ParamTree:
    r = _Reader(sd, device, dtype)
    n = _count(r, "ipadapter_modules.{}.to_k_ip.weight")
    return ParamTree({
        "image_proj": {"0": r.lin("image_proj.proj.0"), "2": r.lin("image_proj.proj.2"),
                       "norm": r.norm("image_proj.norm")},
        "ipadapter_modules": [{"to_k_ip": r.lin(f"ipadapter_modules.{i}.to_k_ip"),
                               "to_v_ip": r.lin(f"ipadapter_modules.{i}.to_v_ip")}
                              for i in range(n)],
    })


_STACKED = ("blocks", "single_blocks", "controlnet_blocks", "controlnet_single_blocks",
            "ipadapter_modules")


def params_from_jax(params: dict, dtype=torch.bfloat16, device="cuda") -> ParamTree:
    """Any FLUX pytree of svi_tpu (the DiT, a ControlNet, the IP-Adapter, a
    VAE half): the stacked block families become lists."""
    def first_leaf(t):
        return first_leaf(next(iter(t.values()))) if isinstance(t, dict) else t

    tree = dict(params)
    for key in _STACKED:
        if key in tree:
            tree[key] = unstack(tree[key], int(np.asarray(first_leaf(tree[key])).shape[0]))
    return ParamTree(convert_tree(tree, dtype, jax_leaf)).to(device)



# ---------------------------------------------------------------------------
# seeded random weights under the reference's names
# ---------------------------------------------------------------------------


def _rms_sd(m, name, d=128):
    m.sd[f"{name}.weight"] = 1 + m.randn((d,), 0.1)


def _dit_sd(m: StateDictMaker, dim, num_joint, num_single, text_dim, pooled_dim, guidance):
    m.lin("time_embedder.timestep_embedder.0", dim, 256)
    m.lin("time_embedder.timestep_embedder.2", dim, dim)
    if guidance:
        m.lin("guidance_embedder.timestep_embedder.0", dim, 256)
        m.lin("guidance_embedder.timestep_embedder.2", dim, dim)
    m.lin("pooled_text_embedder.0", dim, pooled_dim)
    m.lin("pooled_text_embedder.2", dim, dim)
    m.lin("context_embedder", dim, text_dim)
    m.lin("x_embedder", dim, 64)
    for i in range(num_joint):
        b = f"blocks.{i}"
        m.lin(f"{b}.norm1_a.linear", 6 * dim, dim)
        m.lin(f"{b}.norm1_b.linear", 6 * dim, dim)
        for s in ("a", "b"):
            m.lin(f"{b}.attn.{s}_to_qkv", 3 * dim, dim)
            m.lin(f"{b}.attn.{s}_to_out", dim, dim)
            _rms_sd(m, f"{b}.attn.norm_q_{s}")
            _rms_sd(m, f"{b}.attn.norm_k_{s}")
            m.lin(f"{b}.ff_{s}.0", 4 * dim, dim)
            m.lin(f"{b}.ff_{s}.2", dim, 4 * dim)
    for i in range(num_single):
        b = f"single_blocks.{i}"
        m.lin(f"{b}.norm.linear", 3 * dim, dim)
        m.lin(f"{b}.to_qkv_mlp", 7 * dim, dim)
        _rms_sd(m, f"{b}.norm_q_a")
        _rms_sd(m, f"{b}.norm_k_a")
        m.lin(f"{b}.proj_out", dim, 5 * dim)


def flux_dit_state_dict(seed=0, device="cpu", dtype=torch.bfloat16, dim=3072, num_joint=19,
                        num_single=38, text_dim=4096, pooled_dim=768, guidance=True) -> dict:
    """Seeded random FLUX DiT weights (FLUX.1-dev's: 19 + 38 blocks 3072 wide,
    24 heads of 128, the guidance embedder; 11.9B parameters)."""
    m = StateDictMaker(seed, device, dtype)
    _dit_sd(m, dim, num_joint, num_single, text_dim, pooled_dim, guidance)
    m.lin("final_norm_out.linear", 2 * dim, dim)
    m.lin("final_proj_out", 64, dim)
    return m.sd


def flux_controlnet_state_dict(seed=0, device="cpu", dtype=torch.bfloat16, dim=3072,
                               num_joint=5, num_single=10, text_dim=4096, pooled_dim=768,
                               guidance=True, num_modes=0) -> dict:
    """Seeded random FLUX ControlNet weights (5 + 10 blocks by default, as
    the public Union ControlNet; num_modes > 0 adds its mode embedding)."""
    m = StateDictMaker(seed, device, dtype)
    _dit_sd(m, dim, num_joint, num_single, text_dim, pooled_dim, guidance)
    m.lin("controlnet_x_embedder", dim, 64)
    for i in range(num_joint):
        m.lin(f"controlnet_blocks.{i}", dim, dim)
    for i in range(num_single):
        m.lin(f"controlnet_single_blocks.{i}", dim, dim)
    if num_modes:
        m.sd["controlnet_mode_embedder.weight"] = m.randn((num_modes, dim), 0.02)
    return m.sd


def flux_ipadapter_state_dict(seed=0, device="cpu", dtype=torch.bfloat16, image_dim=1152,
                              num_tokens=128, cross_dim=4096, dim=3072, num_blocks=57) -> dict:
    """Seeded random FLUX IP-Adapter weights (the public one's widths)."""
    m = StateDictMaker(seed, device, dtype)
    m.lin("image_proj.proj.0", 2 * image_dim, image_dim)
    m.lin("image_proj.proj.2", cross_dim * num_tokens, 2 * image_dim)
    m.norm("image_proj.norm", cross_dim)
    for i in range(num_blocks):
        m.lin(f"ipadapter_modules.{i}.to_k_ip", dim, cross_dim, bias=False)
        m.lin(f"ipadapter_modules.{i}.to_v_ip", dim, cross_dim, bias=False)
    return m.sd


flux_vae_encoder_state_dict = sd3_vae_encoder_state_dict
flux_vae_decoder_state_dict = sd3_vae_decoder_state_dict
