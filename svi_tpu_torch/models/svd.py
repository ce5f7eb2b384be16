"""Stable Video Diffusion: the spatio-temporal UNet and the temporal VAE
decoder, port of svi_tpu/models/svd.py.

The UNet is a plan (`SVD_UNET_PLAN`), walked with an explicit skip stack as
the SD UNet is: every spatial resnet and attention block of SD's machinery
(`models.sd`) is paired with a temporal counterpart and the two are mixed
by a learned sigmoid (the "mix" entries). Frames ride the batch axis, NCHW.
The spatial attention runs `ops.attention.flash_attention` (f32 on the card:
the hand-written 3xTF32 kernel, 5 / 10 / 20 heads of 64 through the
(B, N, S, D) entry); the temporal attention attends across frames per pixel
and, as the JAX package computes it, is the plain f32 softmax
(`_plain_attention`). The VAE decoder is SD's with sigmoid-mixed temporal
resnets and a final temporal convolution; its mid-block attention is one
head of 512 (the f32 kernel through the flat entry). Convolutions run
through `ops.conv.conv_f32`.

Weights are `ParamTree`s in PyTorch's layouts, loaded from the reference's
diffsynth-named state dicts (`svd_unet_params_from_torch`,
`svd_vae_decoder_params_from_torch`) or carried from svi_tpu's pytrees
(`params_from_jax`); `svd_unet_state_dict` / `svd_vae_decoder_state_dict`
write seeded ones at SVD-XT's widths.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv_f32
from .params import ParamTree, convert_tree, dense
from .sd import (
    Params,
    StateDictMaker,
    _attention_block,
    _block_from,
    _conv2d,
    _group_norm,
    _layer_norm,
    _Reader,
    _resnet_block,
    _timesteps,
    _vae_attention_block,
    jax_leaf,
    timestep_embedding,
)

# ---------------------------------------------------------------------------
# plan. Descriptor kinds: sres(cin, cout, eps) push tres(c, eps) mix mixp(c)
# attn(heads, head_dim, ch) tattn(heads, head_dim, ch) down(c) up(c) pop
# ---------------------------------------------------------------------------


def _res_pair(cin, cout, eps, trailing_push=True):
    p = [("sres", cin, cout, eps), ("push",), ("tres", cout, eps), ("mix",)]
    return p + ([("push",)] if trailing_push else [])


def _attn_pair(heads, ch, trailing_push=True):
    p = [("attn", heads, 64, ch), ("push",), ("tattn", heads, 64, ch), ("mixp", ch)]
    return p + ([("push",)] if trailing_push else [])


SVD_UNET_PLAN = (
    _res_pair(320, 320, 1e-6) + _attn_pair(5, 320)
    + _res_pair(320, 320, 1e-6) + _attn_pair(5, 320)
    + [("down", 320), ("push",)]
    + _res_pair(320, 640, 1e-6) + _attn_pair(10, 640)
    + _res_pair(640, 640, 1e-6) + _attn_pair(10, 640)
    + [("down", 640), ("push",)]
    + _res_pair(640, 1280, 1e-6) + _attn_pair(20, 1280)
    + _res_pair(1280, 1280, 1e-6) + _attn_pair(20, 1280)
    + [("down", 1280), ("push",)]
    + _res_pair(1280, 1280, 1e-5) + _res_pair(1280, 1280, 1e-5)
    + _res_pair(1280, 1280, 1e-5) + _attn_pair(20, 1280, False)
    + _res_pair(1280, 1280, 1e-5, False)
    + [("pop",)] + _res_pair(2560, 1280, 1e-6, False)
    + [("pop",)] + _res_pair(2560, 1280, 1e-6, False)
    + [("pop",)] + _res_pair(2560, 1280, 1e-6, False)
    + [("up", 1280)]
    + [("pop",)] + _res_pair(2560, 1280, 1e-6) + _attn_pair(20, 1280, False)
    + [("pop",)] + _res_pair(2560, 1280, 1e-6) + _attn_pair(20, 1280, False)
    + [("pop",)] + _res_pair(1920, 1280, 1e-6) + _attn_pair(20, 1280, False)
    + [("up", 1280)]
    + [("pop",)] + _res_pair(1920, 640, 1e-6) + _attn_pair(10, 640, False)
    + [("pop",)] + _res_pair(1280, 640, 1e-6) + _attn_pair(10, 640, False)
    + [("pop",)] + _res_pair(960, 640, 1e-6) + _attn_pair(10, 640, False)
    + [("up", 640)]
    + [("pop",)] + _res_pair(960, 320, 1e-6) + _attn_pair(5, 320, False)
    + [("pop",)] + _res_pair(640, 320, 1e-6) + _attn_pair(5, 320, False)
    + [("pop",)] + _res_pair(640, 320, 1e-6) + _attn_pair(5, 320, False)
)

SVD_IMAGE_EMB_DIM = 1024  # the CLIP ViT-H image embedding the UNet attends to


def _group_norm_video(p, x, groups=32, eps=1e-5):
    """GroupNorm over the whole clip (torch sees (1, C, F, H, W)); x (F, C, H, W)."""
    y = F.group_norm(x.transpose(0, 1)[None].float(), groups, p["w"].float(), p["b"].float(),
                     eps)
    return y[0].transpose(0, 1).to(x.dtype)


def _temporal_conv(p, x):
    """Conv3d with a (3, 1, 1) kernel over the frame axis; x (F, C, H, W)."""
    y = conv_f32(F.conv3d, x.transpose(0, 1)[None], p["w"].to(x.dtype), p["b"].to(x.dtype), 1,
                 (1, 0, 0))
    return y[0].transpose(0, 1)


def _pointwise(p, x):
    """A (1, 1, 1) Conv3d as a per-pixel linear on (F, C, H, W)."""
    return dense({"w": p["w"].reshape(p["w"].shape[:2]), "b": p["b"]},
                 x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _temporal_resnet(p, x, time_emb, eps):
    """TemporalResnetBlock: no residual of its own (the mix that follows
    blends against the pushed spatial output)."""
    h = _temporal_conv(p["conv1"], F.silu(_group_norm_video(p["norm1"], x, eps=eps)))
    if time_emb is not None and "time_emb_proj" in p:
        h = h + dense(p["time_emb_proj"], F.silu(time_emb))[0][None, :, None, None]
    h = _temporal_conv(p["conv2"], F.silu(_group_norm_video(p["norm2"], h, eps=eps)))
    if "conv_shortcut" in p:
        x = _pointwise(p["conv_shortcut"], x)
    return x + h


def _plain_attention(p, x, ctx, num_heads, head_dim):
    """to_q / to_k / to_v / to_out attention with the plain f32 softmax, as
    the JAX package computes the temporal attention (outside any kernel)."""
    b, s, _ = x.shape
    sk = ctx.shape[1]
    q = dense(p["to_q"], x).reshape(b, s, num_heads, head_dim)
    k = dense(p["to_k"], ctx).reshape(b, sk, num_heads, head_dim)
    v = dense(p["to_v"], ctx).reshape(b, sk, num_heads, head_dim)
    logits = torch.einsum("bsnd,bknd->bnsk", q.float(), k.float()) * (head_dim ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bnsk,bknd->bsnd", probs, v)
    return dense(p["to_out"], o.reshape(b, s, num_heads * head_dim))


def _geglu(p_act, p_ff, x):
    a, gate = dense(p_act, x).chunk(2, dim=-1)
    return dense(p_ff, a * F.gelu(gate.float()).to(x.dtype))


def positional_ids(num_frames, max_id=25, repeat_length=20, pivot=0):
    """PositionalID: frame ids that run up to max_id and then bounce."""
    ids = []
    for i in range(num_frames):
        fid = abs(i - pivot)
        if fid < max_id:
            ids.append(fid)
        else:
            pos = (fid - max_id) % (repeat_length * 2)
            ids.append(max_id - 2 - pos if pos < repeat_length
                       else max_id - 2 * repeat_length + pos)
    return np.array(ids, np.int32)


def _temporal_attention_block(p, x, text_emb, num_heads, head_dim):
    """TemporalAttentionBlock on (F, C, H, W): each pixel attends across the
    frames, then to the image embedding."""
    f, c, h, w = x.shape
    frames = torch.arange(f, device=x.device)
    if "positional_embedding" in p:  # trainable (the long-video variant)
        pe = p["positional_embedding"][frames]
    else:
        pe = timestep_embedding(frames, c)
    pe = pe.to(x.dtype)
    pe = dense(p["pe_proj_2"], F.silu(dense(p["pe_proj_0"], pe)))
    x = x + pe[:, :, None, None]
    if "positional_conv" in p:
        xp = F.pad(x.transpose(0, 1)[None], (1, 1, 1, 1, 1, 1), mode="reflect")
        x = conv_f32(F.conv3d, xp, p["positional_conv"]["w"].to(x.dtype),
                     p["positional_conv"]["b"].to(x.dtype))[0].transpose(0, 1)
    y = x.permute(2, 3, 0, 1).reshape(h * w, f, c)
    y = y + _geglu(p["act_fn_in"], p["ff_in"], _layer_norm(p["norm_in"], y))
    n1 = _layer_norm(p["norm1"], y)
    y = y + _plain_attention(p["attn1"], n1, n1, num_heads, head_dim)
    ctx = text_emb.reshape(1, 1, -1).expand(h * w, 1, text_emb.shape[-1])
    y = y + _plain_attention(p["attn2"], _layer_norm(p["norm2"], y), ctx, num_heads, head_dim)
    y = y + _geglu(p["act_fn_out"], p["ff_out"], _layer_norm(p["norm_out"], y))
    return y.reshape(h, w, f, c).permute(2, 3, 0, 1)


def _mix(p, res, x):
    alpha = torch.sigmoid(p["mix_factor"].float()).to(x.dtype)
    return alpha * res + (1 - alpha) * x


def svd_unet_forward(params: Params, sample, timestep, encoder_hidden_states, add_time_id):
    """SVDUNet: sample (F, 8, H, W), the frames on the batch axis;
    encoder_hidden_states the (1, 1, 1024) CLIP image embedding; add_time_id
    (3,) = (fps - 1, motion_bucket_id, noise_aug_strength). Returns the
    (F, 4, H, W) prediction."""
    x = sample
    dtype, dev = x.dtype, x.device
    t = timestep_embedding(_timesteps(timestep, dev), 320).to(dtype)
    t = dense(params["time_embedding"]["2"], F.silu(dense(params["time_embedding"]["0"], t)))
    add = timestep_embedding(torch.as_tensor(add_time_id, device=dev).reshape(-1), 256)
    add = add.to(dtype).reshape(-1, 768)
    add = dense(params["add_time_embedding"]["2"],
                F.silu(dense(params["add_time_embedding"]["0"], add)))
    time_emb = t + add  # (1, 1280)

    text_emb = encoder_hidden_states.to(dtype)
    x = _conv2d(params["conv_in"], x)
    res_stack = [x]
    for desc, p in zip(SVD_UNET_PLAN, params["blocks"]):
        kind = desc[0]
        if kind == "sres":
            x = _resnet_block(p, x, time_emb.expand(x.shape[0], -1), eps=desc[3])
        elif kind == "tres":
            x = _temporal_resnet(p, x, time_emb, desc[2])
        elif kind == "attn":
            x = _attention_block(p, x, None, text_emb.reshape(1, -1, text_emb.shape[-1]),
                                 desc[1], desc[2])
        elif kind == "tattn":
            x = _temporal_attention_block(p, x, text_emb, desc[1], desc[2])
        elif kind == "push":
            res_stack.append(x)
        elif kind == "pop":
            x = torch.cat([x, res_stack.pop()], dim=1)
        elif kind in ("mix", "mixp"):
            x = _mix(p, res_stack.pop(), x)
            if kind == "mixp":
                x = dense(p["proj"], x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                x = x + res_stack.pop()
        elif kind == "down":
            x = _conv2d(p["conv"], x, stride=2, padding=1)
        elif kind == "up":
            x = _conv2d(p["conv"], F.interpolate(x, scale_factor=2, mode="nearest"))
    x = _group_norm(params["conv_norm_out"], x, eps=1e-5)
    return _conv2d(params["conv_out"], F.silu(x))


# ---------------------------------------------------------------------------
# VAE decoder
# ---------------------------------------------------------------------------

SVD_VAE_DECODER_PLAN = (
    [("sres", 512, 512), ("tres", 512), ("vae_attn", 512),
     ("sres", 512, 512), ("tres", 512)]
    + ([("sres", 512, 512), ("tres", 512)] * 3 + [("up", 512)])
    + ([("sres", 512, 512), ("tres", 512)] * 3 + [("up", 512)])
    + [("sres", 512, 256), ("tres", 256), ("sres", 256, 256), ("tres", 256),
       ("sres", 256, 256), ("tres", 256), ("up", 256)]
    + [("sres", 256, 128), ("tres", 128), ("sres", 128, 128), ("tres", 128),
       ("sres", 128, 128), ("tres", 128)]
)

SVD_VAE_SCALING_FACTOR = 0.18215


def _vae_temporal_resnet(p, x):
    """The decoder's TemporalResnetBlock: a temporal conv stack with its
    residual, then sigmoid-mixed against the spatial input."""
    h = _temporal_conv(p["conv1"], F.silu(_group_norm_video(p["norm1"], x, eps=1e-6)))
    h = _temporal_conv(p["conv2"], F.silu(_group_norm_video(p["norm2"], h, eps=1e-6)))
    return _mix(p, x + h, x)


def svd_vae_decode(params: Params, latents):
    """SVDVAEDecoder: latents (4, T, H, W) -> video (3, T, 8H, 8W)."""
    x = latents.transpose(0, 1) / SVD_VAE_SCALING_FACTOR
    x = _conv2d(params["conv_in"], x)
    for desc, p in zip(SVD_VAE_DECODER_PLAN, params["blocks"]):
        if desc[0] == "sres":
            x = _resnet_block(p, x, None, eps=1e-6)
        elif desc[0] == "tres":
            x = _vae_temporal_resnet(p, x)
        elif desc[0] == "vae_attn":
            x = _vae_attention_block(p, x, eps=1e-6)
        else:
            x = _conv2d(p["conv"], F.interpolate(x, scale_factor=2, mode="nearest"))
    x = _group_norm(params["conv_norm_out"], x, eps=1e-5)
    x = _conv2d(params["conv_out"], F.silu(x))
    return _temporal_conv(params["time_conv_out"], x).transpose(0, 1)


# ---------------------------------------------------------------------------
# checkpoints in the reference's diffsynth naming
# ---------------------------------------------------------------------------


def _tres_p(r: _Reader, b):
    p = {"norm1": r.norm(f"{b}.norm1"), "conv1": r.conv(f"{b}.conv1"),
         "norm2": r.norm(f"{b}.norm2"), "conv2": r.conv(f"{b}.conv2")}
    if f"{b}.time_emb_proj.weight" in r:
        p["time_emb_proj"] = r.lin(f"{b}.time_emb_proj")
    if f"{b}.conv_shortcut.weight" in r:
        p["conv_shortcut"] = r.conv(f"{b}.conv_shortcut")
    if f"{b}.mix_factor" in r:
        p["mix_factor"] = r.t(f"{b}.mix_factor")
    return p


def _tattn_p(r: _Reader, b):
    p = {"pe_proj_0": r.lin(f"{b}.positional_embedding_proj.0"),
         "pe_proj_2": r.lin(f"{b}.positional_embedding_proj.2"),
         "norm_in": r.norm(f"{b}.norm_in"), "act_fn_in": r.lin(f"{b}.act_fn_in.proj"),
         "ff_in": r.lin(f"{b}.ff_in"), "norm1": r.norm(f"{b}.norm1"),
         "attn1": r.attn(f"{b}.attn1"), "norm2": r.norm(f"{b}.norm2"),
         "attn2": r.attn(f"{b}.attn2"), "norm_out": r.norm(f"{b}.norm_out"),
         "act_fn_out": r.lin(f"{b}.act_fn_out.proj"), "ff_out": r.lin(f"{b}.ff_out")}
    if f"{b}.positional_embedding.embeddings" in r:
        p["positional_embedding"] = r.t(f"{b}.positional_embedding.embeddings")
    if f"{b}.positional_conv.weight" in r:
        p["positional_conv"] = r.conv(f"{b}.positional_conv")
    return p


def svd_unet_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> Params:
    r = _Reader(sd, device, dtype)
    blocks = []
    for i, desc in enumerate(SVD_UNET_PLAN):
        b, kind = f"blocks.{i}", desc[0]
        if kind == "sres":
            blocks.append(_block_from(r, i, ("res",)))
        elif kind == "tres":
            blocks.append(_tres_p(r, b))
        elif kind == "attn":
            blocks.append(_block_from(r, i, ("attn",)))
        elif kind == "tattn":
            blocks.append(_tattn_p(r, b))
        elif kind in ("mix", "mixp"):
            p = {"mix_factor": r.t(f"{b}.mix_factor")}
            if f"{b}.proj.weight" in r:
                p["proj"] = r.lin(f"{b}.proj")
            blocks.append(p)
        elif kind in ("down", "up"):
            blocks.append({"conv": r.conv(f"{b}.conv")})
        else:
            blocks.append({})
    return ParamTree({
        "time_embedding": {"0": r.lin("time_embedding.0"), "2": r.lin("time_embedding.2")},
        "add_time_embedding": {"0": r.lin("add_time_embedding.0"),
                               "2": r.lin("add_time_embedding.2")},
        "conv_in": r.conv("conv_in"),
        "blocks": blocks,
        "conv_norm_out": r.norm("conv_norm_out"),
        "conv_out": r.conv("conv_out"),
    })


def svd_vae_decoder_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> Params:
    r = _Reader(sd, device, dtype)
    blocks = []
    for i, desc in enumerate(SVD_VAE_DECODER_PLAN):
        if desc[0] == "sres":
            blocks.append(_block_from(r, i, ("res",)))
        elif desc[0] == "tres":
            blocks.append(_tres_p(r, f"blocks.{i}"))
        elif desc[0] == "vae_attn":
            blocks.append(_block_from(r, i, ("vae_attn",)))
        else:
            blocks.append({"conv": r.conv(f"blocks.{i}.conv")})
    return ParamTree({
        "conv_in": r.conv("conv_in"),
        "blocks": blocks,
        "conv_norm_out": r.norm("conv_norm_out"),
        "conv_out": r.conv("conv_out"),
        "time_conv_out": r.conv("time_conv_out"),
    })


def params_from_jax(params: dict, dtype=torch.float32, device="cuda") -> Params:
    """svi_tpu's SVD UNet or VAE-decoder pytree (numpy or JAX leaves) -> Params;
    3-D convolution weights DHWIO -> (out, in, kd, kh, kw)."""
    return ParamTree(convert_tree(params, dtype, jax_leaf)).to(device)


# ---------------------------------------------------------------------------
# seeded random weights under the reference's names
# ---------------------------------------------------------------------------


def _tres_sd(m, b, c, temb=None, mix=False):
    m.norm(f"{b}.norm1", c)
    m.conv3d(f"{b}.conv1", c, c, (3, 1, 1))
    if temb:
        m.lin(f"{b}.time_emb_proj", c, temb)
    m.norm(f"{b}.norm2", c)
    m.conv3d(f"{b}.conv2", c, c, (3, 1, 1))
    if mix:
        m.sd[f"{b}.mix_factor"] = m.randn((1,), 1.0)


def _tattn_sd(m, b, c, ctx_dim):
    m.lin(f"{b}.positional_embedding_proj.0", 4 * c, c)
    m.lin(f"{b}.positional_embedding_proj.2", c, 4 * c)
    m.norm(f"{b}.norm_in", c)
    m.lin(f"{b}.act_fn_in.proj", 8 * c, c)
    m.lin(f"{b}.ff_in", c, 4 * c)
    m.norm(f"{b}.norm1", c)
    m.attn(f"{b}.attn1", c)
    m.norm(f"{b}.norm2", c)
    m.attn(f"{b}.attn2", c, ctx_dim)
    m.norm(f"{b}.norm_out", c)
    m.lin(f"{b}.act_fn_out.proj", 8 * c, c)
    m.lin(f"{b}.ff_out", c, 4 * c)


def svd_unet_state_dict(seed=0, device="cpu", dtype=torch.float32,
                        image_dim=SVD_IMAGE_EMB_DIM) -> dict:
    """Seeded random SVD UNet weights at `SVD_UNET_PLAN`'s widths (SVD-XT's
    UNet), in the reference's names."""
    plan, m = SVD_UNET_PLAN, StateDictMaker(seed, device, dtype)
    c0 = plan[0][1]
    temb = 4 * c0
    m.lin("time_embedding.0", temb, 320)  # the timestep's 320-wide sinusoid
    m.lin("time_embedding.2", temb, temb)
    m.lin("add_time_embedding.0", temb, 768)
    m.lin("add_time_embedding.2", temb, temb)
    m.conv("conv_in", c0, 8)
    chans = c0
    for i, desc in enumerate(plan):
        b, kind = f"blocks.{i}", desc[0]
        if kind == "sres":
            cin, cout = desc[1], desc[2]
            m.norm(f"{b}.norm1", cin)
            m.conv(f"{b}.conv1", cout, cin)
            m.lin(f"{b}.time_emb_proj", cout, temb)
            m.norm(f"{b}.norm2", cout)
            m.conv(f"{b}.conv2", cout, cout)
            if cin != cout:
                m.conv(f"{b}.conv_shortcut", cout, cin, k=1)
            chans = cout
        elif kind == "tres":
            _tres_sd(m, b, desc[1], temb)
        elif kind == "attn":
            c = desc[3]
            m.norm(f"{b}.norm", c)
            m.lin(f"{b}.proj_in", c, c)
            t = f"{b}.transformer_blocks.0"
            m.norm(f"{t}.norm1", c)
            m.attn(f"{t}.attn1", c)
            m.norm(f"{t}.norm2", c)
            m.attn(f"{t}.attn2", c, image_dim)
            m.norm(f"{t}.norm3", c)
            m.lin(f"{t}.act_fn.proj", 8 * c, c)
            m.lin(f"{t}.ff", c, 4 * c)
        elif kind == "tattn":
            _tattn_sd(m, b, desc[3], image_dim)
        elif kind in ("mix", "mixp"):
            m.sd[f"{b}.mix_factor"] = m.randn((1,), 1.0)
            if kind == "mixp":
                m.lin(f"{b}.proj", desc[1], desc[1])
        elif kind in ("down", "up"):
            m.conv(f"{b}.conv", desc[1], desc[1])
    m.norm("conv_norm_out", chans)
    m.conv("conv_out", 4, chans)
    return m.sd


def svd_vae_decoder_state_dict(seed=0, device="cpu", dtype=torch.float32) -> dict:
    """Seeded random SVD VAE-decoder weights (`SVD_VAE_DECODER_PLAN`'s widths)."""
    plan, m = SVD_VAE_DECODER_PLAN, StateDictMaker(seed, device, dtype)
    m.conv("conv_in", plan[0][1], 4)
    chans = plan[0][1]
    for i, desc in enumerate(plan):
        b = f"blocks.{i}"
        if desc[0] == "sres":
            m.plan_blocks([("push",)] * i + [("res", desc[1], desc[2])])
            chans = desc[2]
        elif desc[0] == "tres":
            _tres_sd(m, b, desc[1], mix=True)
        elif desc[0] == "vae_attn":
            m.norm(f"{b}.norm", desc[1])
            m.attn(f"{b}.transformer_blocks.0", desc[1], qkv_bias=True)
        else:
            m.conv(f"{b}.conv", desc[1], desc[1])
    m.norm("conv_norm_out", chans)
    m.conv("conv_out", 3, chans)
    m.conv3d("time_conv_out", 3, 3, (3, 1, 1))
    return m.sd
