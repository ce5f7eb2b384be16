"""Stable Diffusion 1.5 family: the UNet, the CLIP text encoder and the image
VAE, port of svi_tpu/models/sd.py.

The architectures are plans, as in the JAX package: block descriptor lists
(`SD_UNET_PLAN`, `SD_VAE_ENCODER_PLAN`, `SD_VAE_DECODER_PLAN`) walked by
`_run_plan` with an explicit push / pop skip stack. Weights are `ParamTree`s
addressed as the JAX package's pytrees, in PyTorch's layouts: convolutions
(out, in, kh, kw), linears (out, in). Activations run NCHW; attention blocks
work on (B, H*W, C) tokens.

Precision is the port's f32 policy: convolutions go through
`ops.conv.conv_f32` (cuDNN TF32 off), group norms take f32 statistics,
linears run under PyTorch's default (TF32 off). Attention without a mask
runs `ops.attention.flash_attention`, the hand-written f32 kernel on the
card (8 heads of 40, 80 or 160 in the UNet; one head of 512 in the VAE);
the text encoder's causal attention is the plain masked softmax, as the JAX
package computes it. `tiled=True` tiles the VAE's whole forward and the
UNet's transformer blocks spatially (`models.tiler`).

Loaders (`*_params_from_torch`) read the reference's diffsynth-named state
dicts (torch tensors or numpy arrays) onto a device; `*_params_from_jax`
carry the JAX package's pytrees across. `*_state_dict` write seeded random
weights under the reference's names, for checkpoint files.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..ops.conv import conv_f32
from ..ops.norms import layer_norm
from .params import ParamTree, convert_tree, dense, to_torch, unstack

Params = ParamTree


# ---------------------------------------------------------------------------
# primitives (NCHW)
# ---------------------------------------------------------------------------


def _conv2d(p, x, stride=1, padding=1):
    return conv_f32(F.conv2d, x, p["w"], p["b"], stride, padding)


def _group_norm(p, x, groups=32, eps=1e-5):
    """torch GroupNorm with f32 statistics, cast back to x's dtype."""
    y = F.group_norm(x.float(), groups, p["w"].float(), p["b"].float(), eps)
    return y.to(x.dtype)


def _layer_norm(p, x, eps=1e-5):
    return layer_norm(x, p["w"], p["b"], eps=eps)


def _ipadapter_attention(q, ipadapter, num_heads, hd):
    """The same queries (B, S, N, D) onto the projected image tokens, softmax
    in f32, scaled; returns (B, S, N * D)."""
    b, s = q.shape[0], q.shape[1]
    ip_k = ipadapter["ip_k"].reshape(1, -1, num_heads, hd).to(q.dtype)
    ip_v = ipadapter["ip_v"].reshape(1, -1, num_heads, hd).to(q.dtype)
    logits = torch.einsum("bsnd,bknd->bnsk", q.float(),
                          ip_k.expand(b, -1, -1, -1).float()) * (hd ** -0.5)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bnsk,bknd->bsnd", probs, ip_v.expand(b, -1, -1, -1))
    return ipadapter.get("scale", 1.0) * o.reshape(b, s, num_heads * hd)


def _attention(p, x, ctx=None, num_heads=8, head_dim=None, mask=None, ipadapter=None):
    """to_q / to_k / to_v / to_out attention on (B, S, C) tokens: the flash
    kernel without a mask, the plain f32 softmax with one."""
    ctx = x if ctx is None else ctx
    b, s, _ = x.shape
    sk = ctx.shape[1]
    q = dense(p["to_q"], x)
    k = dense(p["to_k"], ctx)
    v = dense(p["to_v"], ctx)
    hd = head_dim or q.shape[-1] // num_heads
    if mask is None:
        qh = q.reshape(b, s, num_heads, hd)
        o = flash_attention(qh, k.reshape(b, sk, num_heads, hd), v.reshape(b, sk, num_heads, hd))
        o = o.reshape(b, s, num_heads * hd)
        if ipadapter is not None:
            o = o + _ipadapter_attention(qh, ipadapter, num_heads, hd)
    else:
        qh = q.reshape(b, s, num_heads, hd).transpose(1, 2)
        kh = k.reshape(b, sk, num_heads, hd).transpose(1, 2)
        vh = v.reshape(b, sk, num_heads, hd).transpose(1, 2)
        logits = (qh.float() @ kh.float().transpose(-1, -2)) * (hd ** -0.5)
        probs = torch.softmax(logits + mask.float(), dim=-1).to(x.dtype)
        o = (probs @ vh).transpose(1, 2).reshape(b, s, num_heads * hd)
    return dense(p["to_out"], o)


def timestep_embedding(timesteps: torch.Tensor, num_channels=320) -> torch.Tensor:
    """[cos | sin] of the timesteps (f32) at geometric frequencies."""
    half = num_channels // 2
    exponent = -math.log(10000) * torch.arange(half, dtype=torch.float32,
                                               device=timesteps.device) / half
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def _timesteps(timestep, device) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(timestep, device=device)).reshape(-1)


# ---------------------------------------------------------------------------
# block forwards
# ---------------------------------------------------------------------------


def _resnet_block(p, x, time_emb, groups=32, eps=1e-5):
    h = _group_norm(p["norm1"], x, groups, eps)
    h = _conv2d(p["conv1"], F.silu(h))
    if time_emb is not None and "time_emb_proj" in p:
        h = h + dense(p["time_emb_proj"], F.silu(time_emb))[:, :, None, None]
    h = _group_norm(p["norm2"], h, groups, eps)
    h = _conv2d(p["conv2"], F.silu(h))
    if "conv_shortcut" in p:
        x = _conv2d(p["conv_shortcut"], x, padding=0)
    return x + h


def _transformer_block(p, x, ctx, num_heads, head_dim, ipadapter=None):
    """Self-attention, cross-attention (with optional IP-Adapter K/V), GEGLU."""
    x = x + _attention(p["attn1"], _layer_norm(p["norm1"], x), None, num_heads, head_dim)
    x = x + _attention(p["attn2"], _layer_norm(p["norm2"], x), ctx, num_heads, head_dim,
                       ipadapter=ipadapter)
    a, gate = dense(p["act_fn"], _layer_norm(p["norm3"], x)).chunk(2, dim=-1)
    return x + dense(p["ff"], a * F.gelu(gate.float()).to(x.dtype))


def _attention_block(p, x, time_emb, text_emb, num_heads, head_dim, eps=1e-6,
                     ipadapter_kwargs=None, tiled=False, tile_size=64, tile_stride=32):
    """The spatial transformer on (B, C, H, W). ipadapter_kwargs:
    {transformer_id: {ip_k, ip_v, scale}}. tiled: each transformer block
    runs on feathered spatial tiles (IP-Adapter K/V are skipped there, as in
    the JAX package)."""
    b, c, h, w = x.shape
    residual = x
    y = _group_norm(p["norm"], x, eps=eps).permute(0, 2, 3, 1).reshape(b, h * w, c)
    y = dense(p["proj_in"], y)
    ctx = text_emb
    if ctx.shape[0] != b:
        ctx = ctx.repeat_interleave(b // ctx.shape[0], dim=0)
    if tiled:
        from . import tiler

        ts = min(tile_size, min(h, w))
        y = y.reshape(b, h, w, c)
        for tp in p["transformer_blocks"]:
            def block_tile(t, _tp=tp):
                tb, th, tw, tc = t.shape
                out = _transformer_block(_tp, t.reshape(tb, th * tw, tc),
                                         ctx.repeat(tb // b, 1, 1), num_heads, head_dim)
                return out.reshape(tb, th, tw, tc)

            y = tiler.tiled_forward(block_tile, y, ts, tile_stride)
        y = y.reshape(b, h * w, c)
    else:
        for tid, tp in enumerate(p["transformer_blocks"]):
            ip = None if ipadapter_kwargs is None else ipadapter_kwargs.get(tid)
            y = _transformer_block(tp, y, ctx, num_heads, head_dim, ipadapter=ip)
    if "proj_out" not in p:  # need_proj_out=False (SVD)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2)
    y = dense(p["proj_out"], y).reshape(b, h, w, c).permute(0, 3, 1, 2)
    return y + residual


def _vae_attention_block(p, x, eps=1e-5):
    """The VAE's mid-block attention: one head as wide as the channels."""
    b, c, h, w = x.shape
    y = _group_norm(p["norm"], x, eps=eps).permute(0, 2, 3, 1).reshape(b, h * w, c)
    for tp in p["transformer_blocks"]:
        y = _attention(tp, y, None, num_heads=1, head_dim=c)
    return y.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


# ---------------------------------------------------------------------------
# architecture plans
# ---------------------------------------------------------------------------

# ("res", cin, cout) | ("attn", heads, head_dim, ch) | ("push",) | ("pop",)
# | ("down", ch, padding, extra_padding) | ("up", ch) | ("vae_attn", ch)

SD_UNET_PLAN = (
    [("res", 320, 320), ("attn", 8, 40, 320), ("push",)] * 2
    + [("down", 320, 1, False), ("push",)]
    + [("res", 320, 640), ("attn", 8, 80, 640), ("push",),
       ("res", 640, 640), ("attn", 8, 80, 640), ("push",),
       ("down", 640, 1, False), ("push",)]
    + [("res", 640, 1280), ("attn", 8, 160, 1280), ("push",),
       ("res", 1280, 1280), ("attn", 8, 160, 1280), ("push",),
       ("down", 1280, 1, False), ("push",)]
    + [("res", 1280, 1280), ("push",), ("res", 1280, 1280), ("push",)]
    + [("res", 1280, 1280), ("attn", 8, 160, 1280), ("res", 1280, 1280)]
    + [("pop",), ("res", 2560, 1280), ("pop",), ("res", 2560, 1280),
       ("pop",), ("res", 2560, 1280), ("up", 1280)]
    + [("pop",), ("res", 2560, 1280), ("attn", 8, 160, 1280),
       ("pop",), ("res", 2560, 1280), ("attn", 8, 160, 1280),
       ("pop",), ("res", 1920, 1280), ("attn", 8, 160, 1280), ("up", 1280)]
    + [("pop",), ("res", 1920, 640), ("attn", 8, 80, 640),
       ("pop",), ("res", 1280, 640), ("attn", 8, 80, 640),
       ("pop",), ("res", 960, 640), ("attn", 8, 80, 640), ("up", 640)]
    + [("pop",), ("res", 960, 320), ("attn", 8, 40, 320),
       ("pop",), ("res", 640, 320), ("attn", 8, 40, 320),
       ("pop",), ("res", 640, 320), ("attn", 8, 40, 320)]
)

SD_VAE_ENCODER_PLAN = (
    [("res", 128, 128), ("res", 128, 128), ("down", 128, 0, True),
     ("res", 128, 256), ("res", 256, 256), ("down", 256, 0, True),
     ("res", 256, 512), ("res", 512, 512), ("down", 512, 0, True),
     ("res", 512, 512), ("res", 512, 512),
     ("res", 512, 512), ("vae_attn", 512), ("res", 512, 512)]
)

SD_VAE_DECODER_PLAN = (
    [("res", 512, 512), ("vae_attn", 512), ("res", 512, 512)]
    + [("res", 512, 512)] * 3 + [("up", 512)]
    + [("res", 512, 512)] * 3 + [("up", 512)]
    + [("res", 512, 256), ("res", 256, 256), ("res", 256, 256), ("up", 256)]
    + [("res", 256, 128), ("res", 128, 128), ("res", 128, 128)]
)

VAE_SCALING_FACTOR = 0.18215
CONTROLNET_INSERT_AT = 30  # the UNet plan entry after which ControlNet residuals enter


def _run_plan(plan, blocks, x, time_emb, text_emb, eps_res=1e-5, controlnet_res=None,
              controlnet_insert_at=None, ipadapter_kwargs_list=None, motion=None, tiled=False,
              tile_size=64, tile_stride=32):
    """Walk a plan on (B, C, H, W). controlnet_res: NCHW residuals; after the
    entry at controlnet_insert_at the last one is added to the stream and the
    rest elementwise onto the skip stack. ipadapter_kwargs_list: {plan_index:
    {transformer_id: kv-kwargs}}. motion: {plan_index: fn(x)} run after that
    entry (AnimateDiff)."""
    res_stack = [x] if time_emb is not None else None
    ipadapter_kwargs_list = ipadapter_kwargs_list or {}
    for i, (desc, p) in enumerate(zip(plan, blocks)):
        kind = desc[0]
        if kind == "res":
            x = _resnet_block(p, x, time_emb, eps=eps_res)
        elif kind == "attn":
            x = _attention_block(p, x, time_emb, text_emb, desc[1], desc[2],
                                 ipadapter_kwargs=ipadapter_kwargs_list.get(i), tiled=tiled,
                                 tile_size=tile_size, tile_stride=tile_stride)
        elif kind == "vae_attn":
            x = _vae_attention_block(p, x)
        elif kind == "push":
            res_stack.append(x)
        elif kind == "pop":
            x = torch.cat([x, res_stack.pop()], dim=1)
        elif kind == "down":
            if desc[3]:  # an extra ZeroPad2d((0, 1, 0, 1)) before an unpadded conv
                x = _conv2d(p["conv"], F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)
            else:
                x = _conv2d(p["conv"], x, stride=2, padding=desc[2])
        elif kind == "up":
            x = _conv2d(p["conv"], F.interpolate(x, scale_factor=2, mode="nearest"))
        else:
            raise ValueError(kind)
        if motion is not None and i in motion:
            x = motion[i](x)
        if controlnet_res is not None and i == controlnet_insert_at:
            x = x + controlnet_res[-1]
            res_stack = [r + a for r, a in zip(res_stack, controlnet_res[:-1])]
    return x


def sd_unet_forward(params: Params, sample, timestep, encoder_hidden_states,
                    controlnet_res=None, ipadapter_kwargs_list=None, motion=None, tiled=False,
                    tile_size=64, tile_stride=32):
    """The SD 1.5 UNet: sample (B, 4, H/8, W/8) -> the noise prediction of the
    same shape. controlnet_res: the ControlNet's 13 NCHW residuals, added
    after plan entry 30. motion: AnimateDiff hooks (`motion.motion_hooks`)."""
    x = sample
    t = timestep_embedding(_timesteps(timestep, x.device), 320).to(x.dtype)
    t = dense(params["time_embedding"]["2"], F.silu(dense(params["time_embedding"]["0"], t)))
    x = _conv2d(params["conv_in"], x)
    if controlnet_res is not None:
        controlnet_res = [r.to(x.dtype) for r in controlnet_res]
    # resnets use eps 1e-5, the attention blocks' group norms 1e-6
    x = _run_plan(SD_UNET_PLAN, params["blocks"], x, t, encoder_hidden_states,
                  controlnet_res=controlnet_res, controlnet_insert_at=CONTROLNET_INSERT_AT,
                  ipadapter_kwargs_list=ipadapter_kwargs_list, motion=motion, tiled=tiled,
                  tile_size=tile_size, tile_stride=tile_stride)
    x = _group_norm(params["conv_norm_out"], x, eps=1e-5)
    return _conv2d(params["conv_out"], F.silu(x))


def _tiled_nchw(fn, x, tile_size, tile_stride):
    """tiler.tiled_forward (channels-last) around an NCHW function."""
    from . import tiler

    out = tiler.tiled_forward(lambda t: fn(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
                              x.permute(0, 2, 3, 1), tile_size, tile_stride)
    return out.permute(0, 3, 1, 2).contiguous()


def sd_vae_encode(params: Params, image, scaling_factor=VAE_SCALING_FACTOR, tiled=False,
                  tile_size=64, tile_stride=32):
    """(B, 3, H, W) in [-1, 1] -> (B, 4, H/8, W/8) latents (the mean branch)
    times the scaling factor. tiled: feathered tiles of tile_size pixels."""
    if tiled:
        return _tiled_nchw(lambda t: sd_vae_encode(params, t, scaling_factor), image,
                           tile_size, tile_stride)
    x = _conv2d(params["conv_in"], image)
    x = _run_plan(SD_VAE_ENCODER_PLAN, params["blocks"], x, None, None, eps_res=1e-6)
    x = _group_norm(params["conv_norm_out"], x, eps=1e-6)
    x = _conv2d(params["conv_out"], F.silu(x))
    x = _conv2d(params["quant_conv"], x, padding=0)
    return x[:, :4] * scaling_factor


def sd_vae_decode(params: Params, latents, scaling_factor=VAE_SCALING_FACTOR, tiled=False,
                  tile_size=64, tile_stride=32):
    """(B, 4, h, w) latents -> (B, 3, 8h, 8w) images in about [-1, 1]. tiled:
    feathered tiles of tile_size latent pixels."""
    if tiled:
        return _tiled_nchw(lambda t: sd_vae_decode(params, t, scaling_factor), latents,
                           tile_size, tile_stride)
    x = _conv2d(params["post_quant_conv"], latents / scaling_factor, padding=0)
    x = _conv2d(params["conv_in"], x)
    x = _run_plan(SD_VAE_DECODER_PLAN, params["blocks"], x, None, None, eps_res=1e-6)
    x = _group_norm(params["conv_norm_out"], x, eps=1e-5)
    return _conv2d(params["conv_out"], F.silu(x))


def clip_encoder_scan(encoders, embeds, num_heads=12, quick_gelu=True, n_run=None,
                      causal=True):
    """The first `n_run` (default all) CLIP encoder layers: pre-LN (causal)
    self-attention and a (quick)GELU MLP."""
    s = embeds.shape[1]
    mask = torch.zeros((1, 1, s, s), dtype=torch.float32, device=embeds.device)
    if causal:
        mask = torch.triu(torch.full((s, s), float("-inf"), device=embeds.device), 1)[None, None]
    hd = encoders[0]["attn"]["to_q"]["w"].shape[0] // num_heads
    n_run = len(encoders) if n_run is None else n_run
    for p in list(encoders)[:n_run]:
        embeds = embeds + _attention(p["attn"], _layer_norm(p["layer_norm1"], embeds), None,
                                     num_heads=num_heads, head_dim=hd, mask=mask)
        y = dense(p["fc1"], _layer_norm(p["layer_norm2"], embeds))
        if quick_gelu:
            y = y * torch.sigmoid(1.702 * y.float()).to(y.dtype)
        else:
            y = F.gelu(y.float()).to(y.dtype)
        embeds = embeds + dense(p["fc2"], y)
    return embeds


def sd_text_encoder_forward(params: Params, input_ids, clip_skip: int = 1,
                            token_embedding=None):
    """CLIP ViT-L/14's text tower: (n, 77) ids -> (n, 77, 768), the last
    `clip_skip - 1` layers skipped, then the final LayerNorm.
    token_embedding: a table to use instead of the encoder's own (one
    extended by textual-inversion rows)."""
    table = params["token_embedding"] if token_embedding is None else token_embedding
    embeds = table[input_ids] + params["position_embeds"][0]
    n_layers = len(params["encoders"])
    embeds = clip_encoder_scan(params["encoders"], embeds, n_run=n_layers - (clip_skip - 1))
    return _layer_norm(params["final_layer_norm"], embeds)


# ---------------------------------------------------------------------------
# checkpoints in the reference's diffsynth naming
# ---------------------------------------------------------------------------


class _Reader:
    """Tensors of a state dict (torch tensors or numpy arrays) on `device`
    in `dtype`, as the converters below name them."""

    def __init__(self, sd: dict, device, dtype):
        self.sd, self.device, self.dtype = sd, torch.device(device), dtype

    def __contains__(self, name):
        return name in self.sd

    def t(self, name):
        v = self.sd[name]
        if not isinstance(v, torch.Tensor):
            v = to_torch(v, self.dtype)
        return v.detach().to(device=self.device, dtype=self.dtype)

    def conv(self, prefix):
        return {"w": self.t(f"{prefix}.weight"), "b": self.t(f"{prefix}.bias")}

    def lin(self, prefix):
        p = {"w": self.t(f"{prefix}.weight")}
        if f"{prefix}.bias" in self.sd:
            p["b"] = self.t(f"{prefix}.bias")
        return p

    norm = conv

    def attn(self, prefix):
        return {k: self.lin(f"{prefix}.{k}") for k in ("to_q", "to_k", "to_v", "to_out")}


def _block_from(r: _Reader, i, desc):
    b = f"blocks.{i}"
    kind = desc[0]
    if kind == "res":
        p = {"norm1": r.norm(f"{b}.norm1"), "conv1": r.conv(f"{b}.conv1"),
             "norm2": r.norm(f"{b}.norm2"), "conv2": r.conv(f"{b}.conv2")}
        if f"{b}.time_emb_proj.weight" in r:
            p["time_emb_proj"] = r.lin(f"{b}.time_emb_proj")
        if f"{b}.conv_shortcut.weight" in r:
            p["conv_shortcut"] = r.conv(f"{b}.conv_shortcut")
        return p
    if kind == "attn":
        blocks = []
        j = 0
        while f"{b}.transformer_blocks.{j}.norm1.weight" in r:
            t = f"{b}.transformer_blocks.{j}"
            blocks.append({"norm1": r.norm(f"{t}.norm1"), "attn1": r.attn(f"{t}.attn1"),
                           "norm2": r.norm(f"{t}.norm2"), "attn2": r.attn(f"{t}.attn2"),
                           "norm3": r.norm(f"{t}.norm3"), "act_fn": r.lin(f"{t}.act_fn.proj"),
                           "ff": r.lin(f"{t}.ff")})
            j += 1
        p = {"norm": r.norm(f"{b}.norm"), "proj_in": r.lin(f"{b}.proj_in"),
             "transformer_blocks": blocks}
        if f"{b}.proj_out.weight" in r:  # need_proj_out=False in SVD
            p["proj_out"] = r.lin(f"{b}.proj_out")
        return p
    if kind == "vae_attn":
        blocks = []
        j = 0
        while f"{b}.transformer_blocks.{j}.to_q.weight" in r:
            blocks.append(r.attn(f"{b}.transformer_blocks.{j}"))
            j += 1
        return {"norm": r.norm(f"{b}.norm"), "transformer_blocks": blocks}
    if kind in ("down", "up"):
        return {"conv": r.conv(f"{b}.conv")}
    return {}  # push / pop


def sd_unet_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> Params:
    r = _Reader(sd, device, dtype)
    return ParamTree({
        "time_embedding": {"0": r.lin("time_embedding.0"), "2": r.lin("time_embedding.2")},
        "conv_in": r.conv("conv_in"),
        "blocks": [_block_from(r, i, d) for i, d in enumerate(SD_UNET_PLAN)],
        "conv_norm_out": r.norm("conv_norm_out"),
        "conv_out": r.conv("conv_out"),
    })


def sd_vae_encoder_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> Params:
    r = _Reader(sd, device, dtype)
    return ParamTree({
        "quant_conv": r.conv("quant_conv"),
        "conv_in": r.conv("conv_in"),
        "blocks": [_block_from(r, i, d) for i, d in enumerate(SD_VAE_ENCODER_PLAN)],
        "conv_norm_out": r.norm("conv_norm_out"),
        "conv_out": r.conv("conv_out"),
    })


def sd_vae_decoder_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> Params:
    r = _Reader(sd, device, dtype)
    return ParamTree({
        "post_quant_conv": r.conv("post_quant_conv"),
        "conv_in": r.conv("conv_in"),
        "blocks": [_block_from(r, i, d) for i, d in enumerate(SD_VAE_DECODER_PLAN)],
        "conv_norm_out": r.norm("conv_norm_out"),
        "conv_out": r.conv("conv_out"),
    })


def sd_text_encoder_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> Params:
    r = _Reader(sd, device, dtype)
    layers = []
    i = 0
    while f"encoders.{i}.layer_norm1.weight" in r:
        e = f"encoders.{i}"
        layers.append({"layer_norm1": r.norm(f"{e}.layer_norm1"), "attn": r.attn(f"{e}.attn"),
                       "layer_norm2": r.norm(f"{e}.layer_norm2"), "fc1": r.lin(f"{e}.fc1"),
                       "fc2": r.lin(f"{e}.fc2")})
        i += 1
    return ParamTree({
        "token_embedding": r.t("token_embedding.weight"),
        "position_embeds": r.t("position_embeds"),
        "encoders": layers,
        "final_layer_norm": r.norm("final_layer_norm"),
    })


# ---------------------------------------------------------------------------
# the JAX package's pytrees
# ---------------------------------------------------------------------------


def jax_leaf(path: tuple, arr: np.ndarray) -> np.ndarray:
    """A JAX leaf in PyTorch's layout: conv weights HWIO -> (out, in, kh, kw),
    DHWIO -> (out, in, kd, kh, kw), linear weights (in, out) -> (out, in)."""
    if path and path[-1] == "w" and arr.ndim == 5:
        return arr.transpose(4, 3, 0, 1, 2)
    if path and path[-1] == "w" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if path and path[-1] == "w" and arr.ndim == 2:
        return arr.T
    return arr


def sd_params_from_jax(params: dict, dtype=torch.float32, device="cuda") -> Params:
    """A JAX pytree of the SD family (the UNet, a VAE half, the motion
    modules, a ControlNet; numpy or JAX leaves) -> Params on `device`."""
    return ParamTree(convert_tree(params, dtype, jax_leaf)).to(device)


def sd_text_encoder_params_from_jax(params: dict, dtype=torch.float32, device="cuda") -> Params:
    """The JAX text encoder (its layers stacked for a scan) -> Params."""
    tree = dict(params)
    enc = params["encoders"]
    tree["encoders"] = unstack(enc, int(np.asarray(enc["layer_norm1"]["w"]).shape[0]))
    return sd_params_from_jax(tree, dtype, device)


# ---------------------------------------------------------------------------
# seeded random weights under the reference's names
# ---------------------------------------------------------------------------


class StateDictMaker:
    """Seeded random tensors on `device` for the state dicts below: linear
    and conv weights N(0, 1/fan_in), biases N(0, 0.02^2), norm scales
    1 + N(0, 0.1^2), embeddings N(0, 0.02^2)."""

    def __init__(self, seed: int, device="cpu", dtype=torch.float32):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.device, self.dtype = device, dtype
        self.sd: dict[str, torch.Tensor] = {}

    def randn(self, shape, std):
        t = torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)
        return (t * std).to(self.dtype)

    def lin(self, name, fan_out, fan_in, bias=True):
        self.sd[f"{name}.weight"] = self.randn((fan_out, fan_in), fan_in ** -0.5)
        if bias:
            self.sd[f"{name}.bias"] = self.randn((fan_out,), 0.02)

    def conv(self, name, cout, cin, k=3):
        self.sd[f"{name}.weight"] = self.randn((cout, cin, k, k), (cin * k * k) ** -0.5)
        self.sd[f"{name}.bias"] = self.randn((cout,), 0.02)

    def conv3d(self, name, cout, cin, k=3):
        """A Conv3d weight (out, in, kt, kh, kw); k an int (a cube) or a triple."""
        k = (k,) * 3 if isinstance(k, int) else tuple(k)
        self.sd[f"{name}.weight"] = self.randn((cout, cin) + k, (cin * k[0] * k[1] * k[2]) ** -0.5)
        self.sd[f"{name}.bias"] = self.randn((cout,), 0.02)

    def norm(self, name, c):
        self.sd[f"{name}.weight"] = 1 + self.randn((c,), 0.1)
        self.sd[f"{name}.bias"] = self.randn((c,), 0.02)

    def attn(self, name, c, ctx_dim=None, qkv_bias=False):
        self.lin(f"{name}.to_q", c, c, qkv_bias)
        self.lin(f"{name}.to_k", c, ctx_dim or c, qkv_bias)
        self.lin(f"{name}.to_v", c, ctx_dim or c, qkv_bias)
        self.lin(f"{name}.to_out", c, c)

    def plan_blocks(self, plan, temb=None, text_dim=768, depth=None):
        """The blocks of a plan; resnets get a time projection when temb.
        depth: {plan index: transformer layers} of the attention blocks
        (default one each)."""
        depth = depth or {}
        for i, desc in enumerate(plan):
            b, kind = f"blocks.{i}", desc[0]
            if kind == "res":
                cin, cout = desc[1], desc[2]
                self.norm(f"{b}.norm1", cin)
                self.conv(f"{b}.conv1", cout, cin)
                if temb:
                    self.lin(f"{b}.time_emb_proj", cout, temb)
                self.norm(f"{b}.norm2", cout)
                self.conv(f"{b}.conv2", cout, cout)
                if cin != cout:
                    self.conv(f"{b}.conv_shortcut", cout, cin, k=1)
            elif kind == "attn":
                c = desc[3]
                self.norm(f"{b}.norm", c)
                self.lin(f"{b}.proj_in", c, c)
                for j in range(depth.get(i, 1)):
                    t = f"{b}.transformer_blocks.{j}"
                    self.norm(f"{t}.norm1", c)
                    self.attn(f"{t}.attn1", c)
                    self.norm(f"{t}.norm2", c)
                    self.attn(f"{t}.attn2", c, text_dim)
                    self.norm(f"{t}.norm3", c)
                    self.lin(f"{t}.act_fn.proj", 8 * c, c)
                    self.lin(f"{t}.ff", c, 4 * c)
                self.lin(f"{b}.proj_out", c, c)
            elif kind == "vae_attn":
                c = desc[1]
                self.norm(f"{b}.norm", c)
                self.attn(f"{b}.transformer_blocks.0", c, qkv_bias=True)
            elif kind in ("down", "up"):
                self.conv(f"{b}.conv", desc[1], desc[1])


def unet_time_dim(plan) -> int:
    """The time embedding's width: four times the first level's channels."""
    return 4 * plan[0][1]


def sd_unet_state_dict(seed=0, device="cpu", dtype=torch.float32, text_dim=768) -> dict:
    """Seeded random SD 1.5 UNet weights at `SD_UNET_PLAN`'s widths."""
    plan, m = SD_UNET_PLAN, StateDictMaker(seed, device, dtype)
    c0, temb = plan[0][1], unet_time_dim(plan)
    m.lin("time_embedding.0", temb, 320)
    m.lin("time_embedding.2", temb, temb)
    m.conv("conv_in", c0, 4)
    m.plan_blocks(plan, temb, text_dim)
    m.norm("conv_norm_out", c0)
    m.conv("conv_out", 4, c0)
    return m.sd


def sd_vae_encoder_state_dict(seed=0, device="cpu", dtype=torch.float32) -> dict:
    plan, m = SD_VAE_ENCODER_PLAN, StateDictMaker(seed, device, dtype)
    m.conv("conv_in", plan[0][1], 3)
    m.plan_blocks(plan)
    c = plan[-1][2]
    m.norm("conv_norm_out", c)
    m.conv("conv_out", 8, c)
    m.conv("quant_conv", 8, 8, k=1)
    return m.sd


def sd_vae_decoder_state_dict(seed=0, device="cpu", dtype=torch.float32) -> dict:
    plan, m = SD_VAE_DECODER_PLAN, StateDictMaker(seed, device, dtype)
    m.conv("post_quant_conv", 4, 4, k=1)
    m.conv("conv_in", plan[0][1], 4)
    m.plan_blocks(plan)
    c = plan[-1][2]
    m.norm("conv_norm_out", c)
    m.conv("conv_out", 3, c)
    return m.sd


def sd_text_encoder_state_dict(seed=0, device="cpu", dtype=torch.float32, dim=768,
                               num_layers=12, vocab=49408, max_len=77, final_norm=True,
                               projection=None) -> dict:
    """Seeded random CLIP text-tower weights (ViT-L/14's: 12 layers of 768);
    final_norm=False leaves out the final LayerNorm (SDXL's first encoder),
    projection=n adds an (n, dim) text projection (its second)."""
    m = StateDictMaker(seed, device, dtype)
    m.sd["token_embedding.weight"] = m.randn((vocab, dim), 0.02)
    m.sd["position_embeds"] = m.randn((1, max_len, dim), 0.02)
    for i in range(num_layers):
        e = f"encoders.{i}"
        m.norm(f"{e}.layer_norm1", dim)
        m.attn(f"{e}.attn", dim, qkv_bias=True)
        m.norm(f"{e}.layer_norm2", dim)
        m.lin(f"{e}.fc1", 4 * dim, dim)
        m.lin(f"{e}.fc2", dim, 4 * dim)
    if final_norm:
        m.norm("final_layer_norm", dim)
    if projection:
        m.lin("text_projection", projection, dim, bias=False)
    return m.sd
