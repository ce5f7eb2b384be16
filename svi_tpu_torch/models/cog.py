"""CogVideoX: the DiT and the cached-convolution 3-D VAE, port of
svi_tpu/models/cog.py.

The DiT patchifies each latent frame with a stride-2 convolution, embeds
the T5 text (226 tokens a prompt) and runs 42 blocks of joint attention
over [text | video]: one affine LayerNorm per sub-layer modulates both
streams (shift, scale and gate each), q and k take LayerNorms, and 3-D RoPE
rotates the video tokens only (`prepare_rope_tables`, aspect-cropped
against 480 x 720). The attention is `ops.attention.flash_attention` at 48
heads of 64: in bf16 on the card that is K2's (B, N, S, D) entry,
`flash_fwd_bnsd`, route "sm90" at D = 64 (csrc/flash_fwd_sm90.cu, TMA +
wgmma). The DiT tiles spatially when asked (the RoPE tables made per tile).

The VAE streams its convolutions' time context as an explicit cache dict
(`_cached_conv3d`: the last two frames of each convolution's input), so a
video is encoded in 8-frame chunks and decoded in 2-latent-frame chunks;
its decoder conditions every group norm on the latents
(`_spatial_norm`, nearest-resized as torch's `interpolate` indexes).
Tiled encode and decode feather spatial tiles (`tiler.tiled_forward_2dto3d`).
Convolutions run through `ops.conv.conv_f32`, channels first (B, C, T, H, W).

Weights are `ParamTree`s in PyTorch's layouts, loaded from the reference's
diffsynth-named state dicts (`*_params_from_torch`) or carried from
svi_tpu's pytrees (`params_from_jax`); `*_state_dict` write seeded ones at
CogVideoX-5B's widths.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..ops.conv import conv_f32
from ..ops.norms import layer_norm
from .hunyuan_dit import _apply_rope, _tables
from .params import ParamTree, convert_tree, dense, unstack
from .sd import Params, StateDictMaker, _Reader, _timesteps, jax_leaf, timestep_embedding
from .sd3 import _ff

NUM_HEADS, HEAD_DIM = 48, 64

# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------


def _ln(p, x, eps):
    return layer_norm(x, p["w"], p["b"], eps)


def _ada(p, temb, n):
    return dense(p["linear"], F.silu(temb))[:, None].chunk(n, dim=2)


def _cog_block(p, x, ctx, temb, cos, sin, num_heads=NUM_HEADS, head_dim=HEAD_DIM):
    """CogDiTBlock: the same affine LayerNorm modulates both streams;
    attention over [text | video] with RoPE on the video part only."""
    sb = ctx.shape[1]
    shift_a, scale_a, gate_a, shift_b, scale_b, gate_b = _ada(p["norm1"], temb, 6)
    nx = _ln(p["norm1"]["norm"], x, 1e-5) * (1 + scale_a) + shift_a
    nc = _ln(p["norm1"]["norm"], ctx, 1e-5) * (1 + scale_b) + shift_b
    io = torch.cat([nc, nx], dim=1)
    b, s, _ = io.shape
    q = dense(p["attn1"]["to_q"], io).reshape(b, s, num_heads, head_dim)
    k = dense(p["attn1"]["to_k"], io).reshape(b, s, num_heads, head_dim)
    v = dense(p["attn1"]["to_v"], io).reshape(b, s, num_heads, head_dim)
    q = _ln(p["norm_q"], q, 1e-6)
    k = _ln(p["norm_k"], k, 1e-6)
    q = torch.cat([q[:, :sb], _apply_rope(q[:, sb:], cos, sin)], dim=1)
    k = torch.cat([k[:, :sb], _apply_rope(k[:, sb:], cos, sin)], dim=1)
    o = flash_attention(q, k, v).reshape(b, s, num_heads * head_dim)
    o = dense(p["attn1"]["to_out"], o)
    x = x + gate_a * o[:, sb:]
    ctx = ctx + gate_b * o[:, :sb]

    shift_a, scale_a, gate_a, shift_b, scale_b, gate_b = _ada(p["norm2"], temb, 6)
    nx = _ln(p["norm2"]["norm"], x, 1e-5) * (1 + scale_a) + shift_a
    nc = _ln(p["norm2"]["norm"], ctx, 1e-5) * (1 + scale_b) + shift_b
    io = _ff(p["ff"], torch.cat([nc, nx], dim=1))
    return x + gate_a * io[:, sb:], ctx + gate_b * io[:, :sb]


def _resize_crop_region(src, tgt_w, tgt_h):
    h, w = src
    if h / w > tgt_h / tgt_w:
        rh, rw = tgt_h, int(round(tgt_h / h * w))
    else:
        rh, rw = int(round(tgt_w / w * h)), tgt_w
    top = int(round((tgt_h - rh) / 2.0))
    left = int(round((tgt_w - rw) / 2.0))
    return (top, left), (top + rh, left + rw)


def prepare_rope_tables(height, width, num_frames, embed_dim=64, theta=10000.0):
    """3-D rotary tables (t, h, w dims 16, 24, 24 of 64), the h / w grids
    aspect-cropped against a 480 x 720 base: cos, sin (S, embed_dim // 2)
    f32 numpy for the (num_frames, height / 2, width / 2) patch grid."""
    gh, gw = height // 2, width // 2
    start, stop = _resize_crop_region((gh, gw), 720 // 16, 480 // 16)
    grid_h = np.linspace(start[0], stop[0], gh, endpoint=False, dtype=np.float32)
    grid_w = np.linspace(start[1], stop[1], gw, endpoint=False, dtype=np.float32)
    grid_t = np.arange(num_frames, dtype=np.float32)

    def axis(pos, dim):
        freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
        return np.outer(pos, freqs)

    ft = axis(grid_t, embed_dim // 4)
    fh = axis(grid_h, embed_dim // 8 * 3)
    fw = axis(grid_w, embed_dim // 8 * 3)
    ang = np.concatenate([
        np.broadcast_to(ft[:, None, None], (len(grid_t), gh, gw, ft.shape[-1])),
        np.broadcast_to(fh[None, :, None], (len(grid_t), gh, gw, fh.shape[-1])),
        np.broadcast_to(fw[None, None, :], (len(grid_t), gh, gw, fw.shape[-1])),
    ], axis=-1).reshape(-1, embed_dim // 2)
    return np.cos(ang), np.sin(ang)


def _patch_weight(w):
    """A (1, kh, kw) Conv3d weight (out, in, 1, kh, kw) as a Conv2d one."""
    return w[:, :, 0] if w.ndim == 5 else w


def cog_dit_forward(params: Params, hidden_states, timestep, prompt_emb, image_rotary_emb=None,
                    tiled=False, tile_size=(60, 90), tile_stride=(30, 45)):
    """hidden_states (B, 16, T, H, W); prompt_emb (B, S, 4096) T5 states ->
    the (B, 16, T, H, W) prediction. image_rotary_emb: `prepare_rope_tables`'
    (cos, sin). tiled: feathered spatial tiles of the whole forward, each
    with its own tables."""
    if tiled:
        from . import tiler

        if isinstance(tile_size, int):
            tile_size = (tile_size, tile_size)
        if isinstance(tile_stride, int):
            tile_stride = (tile_stride, tile_stride)
        out = tiler.tiled_forward_2dto3d(
            lambda v: cog_dit_forward(params, v.permute(0, 4, 1, 2, 3), timestep,
                                      prompt_emb).permute(0, 2, 3, 4, 1),
            hidden_states.permute(0, 2, 3, 4, 1), tuple(tile_size), tuple(tile_stride))
        return out.permute(0, 4, 1, 2, 3)
    x = hidden_states
    b, c, tt, h, w = x.shape
    dtype, dev = x.dtype, x.device
    if image_rotary_emb is None:
        image_rotary_emb = prepare_rope_tables(h, w, tt)
    cos, sin = _tables(image_rotary_emb, dev)

    pw = _patch_weight(params["patchify"]["w"]).to(dtype)
    xl = conv_f32(F.conv2d, x.transpose(1, 2).reshape(b * tt, c, h, w), pw,
                  params["patchify"]["b"].to(dtype), 2, 0)
    xa = xl.flatten(2).transpose(1, 2).reshape(b, tt * (h // 2) * (w // 2), -1)

    temb = timestep_embedding(_timesteps(timestep, dev), 3072).to(dtype)
    temb = dense(params["time_embedder"]["2"], F.silu(dense(params["time_embedder"]["0"], temb)))
    ctx = dense(params["context_embedder"], prompt_emb.to(dtype))

    for p in params["blocks"]:
        xa, ctx = _cog_block(p, xa, ctx, temb, cos, sin)

    xa = _ln(params["norm_final"], torch.cat([ctx, xa], dim=1), 1e-5)[:, ctx.shape[1]:]
    shift, scale = _ada(params["norm_out"], temb, 2)  # shift first
    xa = _ln(params["norm_out"]["norm"], xa, 1e-5) * (1 + scale) + shift
    xa = dense(params["proj_out"], xa)
    # B (T H W) (C P Q) -> B C T (H P) (W Q)
    co = xa.shape[-1] // 4
    xa = xa.reshape(b, tt, h // 2, w // 2, co, 2, 2)
    return xa.permute(0, 4, 1, 2, 5, 3, 6).reshape(b, co, tt, h, w)


def _dit_block_p(r: _Reader, prefix):
    return {"norm1": {"linear": r.lin(f"{prefix}.norm1.linear"),
                      "norm": r.norm(f"{prefix}.norm1.norm")},
            "attn1": r.attn(f"{prefix}.attn1"),
            "norm_q": r.norm(f"{prefix}.norm_q"), "norm_k": r.norm(f"{prefix}.norm_k"),
            "norm2": {"linear": r.lin(f"{prefix}.norm2.linear"),
                      "norm": r.norm(f"{prefix}.norm2.norm")},
            "ff": {"0": r.lin(f"{prefix}.ff.0"), "2": r.lin(f"{prefix}.ff.2")}}


def cog_dit_params_from_torch(sd: dict, device="cuda", dtype=torch.bfloat16) -> Params:
    r = _Reader(sd, device, dtype)
    n = 0
    while f"blocks.{n}.norm1.linear.weight" in r:
        n += 1
    return ParamTree({
        "patchify": r.conv("patchify.proj"),
        "time_embedder": {"0": r.lin("time_embedder.timestep_embedder.0"),
                          "2": r.lin("time_embedder.timestep_embedder.2")},
        "context_embedder": r.lin("context_embedder"),
        "blocks": [_dit_block_p(r, f"blocks.{i}") for i in range(n)],
        "norm_final": r.norm("norm_final"),
        "norm_out": {"linear": r.lin("norm_out.linear"), "norm": r.norm("norm_out.norm")},
        "proj_out": r.lin("proj_out"),
    })


# ---------------------------------------------------------------------------
# VAE: channels first (B, C, T, H, W), an explicit streaming cache dict
# ---------------------------------------------------------------------------

COG_VAE_SCALING_FACTOR = 0.7

COG_VAE_ENCODER_PLAN = (
    [("res", 128, 128)] * 3 + [("down", 128, True)]
    + [("res", 128, 256), ("res", 256, 256), ("res", 256, 256), ("down", 256, True)]
    + [("res", 256, 256)] * 3 + [("down", 256, False)]
    + [("res", 256, 512)] + [("res", 512, 512)] * 4
)

COG_VAE_DECODER_PLAN = (
    [("res", 512, 512)] * 6 + [("up", 512, True)]
    + [("res", 512, 256)] + [("res", 256, 256)] * 3 + [("up", 256, True)]
    + [("res", 256, 256)] * 4 + [("up", 256, False)]
    + [("res", 256, 128)] + [("res", 128, 128)] * 3
)


def _cached_conv3d(p, x, cache):
    """CachedConv3d: a 2-frame leading time cache (on the first call the
    first frame twice), spatial padding (k - 1) / 2, no time padding.
    Returns (y, the new cache)."""
    if cache is None:
        cache = torch.cat([x[:, :, :1]] * 2, dim=2)
    xin = torch.cat([cache, x], dim=2)
    w = p["w"].to(x.dtype)
    y = conv_f32(F.conv3d, xin, w, p["b"].to(x.dtype), 1,
                 (0, (w.shape[3] - 1) // 2, (w.shape[4] - 1) // 2))
    return y, xin[:, :, -2:]


def _conv1(p, x):
    return conv_f32(F.conv3d, x, p["w"].to(x.dtype), p["b"].to(x.dtype))


def _group_norm_3d(p, x, groups=32, eps=1e-6):
    y = F.group_norm(x.float(), groups, p["w"].float(), p["b"].float(), eps)
    return y.to(x.dtype)


def _nearest_idx(out_len, in_len, device):
    return torch.from_numpy((np.arange(out_len) * in_len // out_len).astype(np.int64)).to(device)


def _interp_nearest(z, t, h, w):
    """torch `interpolate(mode='nearest')`'s indexing, floor(i * in / out),
    on the (T, H, W) axes of (B, C, T, H, W)."""
    dev = z.device
    z = z.index_select(2, _nearest_idx(t, z.shape[2], dev))
    z = z.index_select(3, _nearest_idx(h, z.shape[3], dev))
    return z.index_select(4, _nearest_idx(w, z.shape[4], dev))


def _spatial_norm(p, f, zq):
    """CogVideoXSpatialNorm3D: zq nearest-resized to f (the first frame on
    its own when f has an odd frame count > 1), an affine group norm of f,
    then norm(f) * conv_y(zq) + conv_b(zq)."""
    _, _, t, h, w = f.shape
    if t > 1 and t % 2 == 1:
        z = torch.cat([_interp_nearest(zq[:, :, :1], 1, h, w),
                       _interp_nearest(zq[:, :, 1:], t - 1, h, w)], dim=2)
    else:
        z = _interp_nearest(zq, t, h, w)
    return _group_norm_3d(p["norm_layer"], f) * _conv1(p["conv_y"], z) + _conv1(p["conv_b"], z)


def _res3d(p, x, zq, cache, pref):
    """Resnet3DBlock with cached convolutions; its norms are spatial norms
    where the weights carry conv_y (the decoder)."""
    def norm(which, y):
        np_ = p[which]
        return _spatial_norm(np_, y, zq) if "conv_y" in np_ else _group_norm_3d(np_, y)

    h, cache[f"{pref}.conv1"] = _cached_conv3d(p["conv1"], F.silu(norm("norm1", x)),
                                               cache.get(f"{pref}.conv1"))
    h, cache[f"{pref}.conv2"] = _cached_conv3d(p["conv2"], F.silu(norm("norm2", h)),
                                               cache.get(f"{pref}.conv2"))
    h0 = _conv1(p["conv_shortcut"], x) if "conv_shortcut" in p else x
    return h0 + h, cache


def _frame_conv(p, x, stride, padding):
    """A 2-D convolution on every frame of (B, C, T, H, W)."""
    b, c, t, h, w = x.shape
    y = conv_f32(F.conv2d, x.transpose(1, 2).reshape(b * t, c, h, w),
                 _patch_weight(p["w"]).to(x.dtype), p["b"].to(x.dtype), stride, padding)
    return y.reshape(b, t, y.shape[1], y.shape[2], y.shape[3]).transpose(1, 2)


def _downsample3d(p, x, compress_time):
    """Downsample3D: an odd-aware average over frame pairs, then a
    right / bottom zero pad and a stride-2 convolution on every frame."""
    if compress_time:
        if x.shape[2] % 2 == 1:
            first, rest = x[:, :, :1], x[:, :, 1:]
            if rest.shape[2] > 0:
                rest = (rest[:, :, 0::2] + rest[:, :, 1::2]) / 2
            x = torch.cat([first, rest], dim=2)
        else:
            x = (x[:, :, 0::2] + x[:, :, 1::2]) / 2
    return _frame_conv(p, F.pad(x, (0, 1, 0, 1)), 2, 0)


def _upsample3d(p, x, compress_time):
    """Upsample3D: nearest x2 in space (and in time when compressing more
    than one frame, the odd first frame in space only), then a 3 x 3
    convolution on every frame."""
    t = x.shape[2]

    def space(y):
        return y.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)

    if compress_time and t > 1 and t % 2 == 1:
        x = torch.cat([space(x[:, :, :1]), space(x[:, :, 1:].repeat_interleave(2, dim=2))], 2)
    elif compress_time and t > 1:
        x = space(x.repeat_interleave(2, dim=2))
    else:
        x = space(x)
    return _frame_conv(p, x, 1, 1)


def _run_vae(plan, params, x, zq, cache):
    for i, (desc, p) in enumerate(zip(plan, params)):
        if desc[0] == "res":
            x, cache = _res3d(p, x, zq, cache, f"blocks.{i}")
        elif desc[0] == "down":
            x = _downsample3d(p, x, desc[2])
        else:
            x = _upsample3d(p, x, desc[2])
    return x, cache


def cog_vae_encode_chunk(params: Params, video, cache=None):
    """CogVAEEncoder on a chunk: video (B, 3, T, H, W) in [-1, 1] ->
    ((B, 16, T / 4, H / 8, W / 8) latents times the scaling factor, cache)."""
    cache = {} if cache is None else cache
    zq = video
    x, cache["conv_in"] = _cached_conv3d(params["conv_in"], video, cache.get("conv_in"))
    x, cache = _run_vae(COG_VAE_ENCODER_PLAN, params["blocks"], x, zq, cache)
    x = F.silu(_group_norm_3d(params["norm_out"], x))
    x, cache["conv_out"] = _cached_conv3d(params["conv_out"], x, cache.get("conv_out"))
    return x[:, :16] * COG_VAE_SCALING_FACTOR, cache


def cog_vae_decode_chunk(params: Params, latents, cache=None):
    """CogVAEDecoder on a chunk: latents (B, 16, T, H, W) -> (video, cache)."""
    cache = {} if cache is None else cache
    x = latents / COG_VAE_SCALING_FACTOR
    zq = x
    x, cache["conv_in"] = _cached_conv3d(params["conv_in"], x, cache.get("conv_in"))
    x, cache = _run_vae(COG_VAE_DECODER_PLAN, params["blocks"], x, zq, cache)
    x = F.silu(_spatial_norm(params["norm_out"], x, zq))
    x, cache["conv_out"] = _cached_conv3d(params["conv_out"], x, cache.get("conv_out"))
    return x, cache


def cog_vae_encode_video(params: Params, video, tiled=False, tile_size=(60, 90),
                         tile_stride=(30, 45), progress_bar=lambda x: x):
    """8-frame chunks (the first takes the odd leading frame), a fresh cache
    a video. tiled: feathered spatial tiles of tile_size * 8 pixels."""
    t = video.shape[2]
    if tiled:
        from . import tiler

        out = tiler.tiled_forward_2dto3d(
            lambda v: cog_vae_encode_video(params, v.permute(0, 4, 1, 2, 3)).permute(
                0, 2, 3, 4, 1),
            video.permute(0, 2, 3, 4, 1), tuple(i * 8 for i in tile_size),
            tuple(i * 8 for i in tile_stride), scales=(16 / 3, (t // 4 + t % 2) / t, 1 / 8, 1 / 8),
            progress_bar=progress_bar)
        return out.permute(0, 4, 1, 2, 3)
    outs, cache = [], None
    for i in range(t // 8):
        tl = i * 8 + t % 2 - (t % 2 and i == 0)
        tr = i * 8 + 8 + t % 2
        out, cache = cog_vae_encode_chunk(params, video[:, :, tl:tr], cache)
        outs.append(out)
    return torch.cat(outs, dim=2)


def cog_vae_decode_video(params: Params, latents, tiled=False, tile_size=(60, 90),
                         tile_stride=(30, 45), progress_bar=lambda x: x):
    """2-latent-frame chunks (the first takes the odd leading frame). tiled:
    feathered spatial tiles in latent units."""
    t = latents.shape[2]
    if tiled:
        from . import tiler

        out = tiler.tiled_forward_2dto3d(
            lambda v: cog_vae_decode_video(params, v.permute(0, 4, 1, 2, 3)).permute(
                0, 2, 3, 4, 1),
            latents.permute(0, 2, 3, 4, 1), tuple(tile_size), tuple(tile_stride),
            scales=(3 / 16, (t // 2 * 8 + t % 2) / t, 8, 8), progress_bar=progress_bar)
        return out.permute(0, 4, 1, 2, 3)
    outs, cache = [], None
    for i in range(t // 2):
        tl = i * 2 + t % 2 - (t % 2 and i == 0)
        tr = i * 2 + 2 + t % 2
        out, cache = cog_vae_decode_chunk(params, latents[:, :, tl:tr], cache)
        outs.append(out)
    return torch.cat(outs, dim=2)


def _vae_norm_p(r: _Reader, prefix):
    if f"{prefix}.conv_y.weight" in r:
        return {"norm_layer": r.norm(f"{prefix}.norm_layer"), "conv_y": r.conv(f"{prefix}.conv_y"),
                "conv_b": r.conv(f"{prefix}.conv_b")}
    return r.norm(prefix)


def _vae_block_p(r: _Reader, i, desc):
    b = f"blocks.{i}"
    if desc[0] == "res":
        p = {"norm1": _vae_norm_p(r, f"{b}.norm1"), "conv1": r.conv(f"{b}.conv1"),
             "norm2": _vae_norm_p(r, f"{b}.norm2"), "conv2": r.conv(f"{b}.conv2")}
        if f"{b}.conv_shortcut.weight" in r:
            p["conv_shortcut"] = r.conv(f"{b}.conv_shortcut")
        return p
    return r.conv(f"{b}.conv")


def cog_vae_encoder_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> Params:
    r = _Reader(sd, device, dtype)
    return ParamTree({
        "conv_in": r.conv("conv_in"),
        "blocks": [_vae_block_p(r, i, d) for i, d in enumerate(COG_VAE_ENCODER_PLAN)],
        "norm_out": r.norm("norm_out"),
        "conv_out": r.conv("conv_out"),
    })


def cog_vae_decoder_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> Params:
    r = _Reader(sd, device, dtype)
    return ParamTree({
        "conv_in": r.conv("conv_in"),
        "blocks": [_vae_block_p(r, i, d) for i, d in enumerate(COG_VAE_DECODER_PLAN)],
        "norm_out": _vae_norm_p(r, "norm_out"),
        "conv_out": r.conv("conv_out"),
    })


def params_from_jax(params: dict, dtype=torch.float32, device="cuda") -> Params:
    """Any CogVideoX pytree of svi_tpu (the DiT, its blocks stacked for
    svi_tpu's scan, or a VAE half) -> Params."""
    tree = dict(params)
    if "context_embedder" in tree:
        n = int(np.asarray(tree["blocks"]["norm1"]["linear"]["w"]).shape[0])
        tree["blocks"] = unstack(tree["blocks"], n)
    return ParamTree(convert_tree(tree, dtype, jax_leaf)).to(device)


# ---------------------------------------------------------------------------
# seeded random weights under the reference's names
# ---------------------------------------------------------------------------


def cog_dit_state_dict(seed=0, device="cpu", dtype=torch.bfloat16, dim=3072, num_layers=42,
                       time_dim=512, text_dim=4096, in_channels=16, head_dim=HEAD_DIM) -> dict:
    """Seeded random CogVideoX DiT weights (CogVideoX-5B's: 42 blocks 3072
    wide, 48 heads of 64, a 512-wide time embedding), in the reference's names."""
    m = StateDictMaker(seed, device, dtype)
    m.sd["patchify.proj.weight"] = m.randn((dim, in_channels, 1, 2, 2), (in_channels * 4) ** -0.5)
    m.sd["patchify.proj.bias"] = m.randn((dim,), 0.02)
    m.lin("time_embedder.timestep_embedder.0", time_dim, 3072)
    m.lin("time_embedder.timestep_embedder.2", time_dim, time_dim)
    m.lin("context_embedder", dim, text_dim)
    for i in range(num_layers):
        b = f"blocks.{i}"
        for n in ("norm1", "norm2"):
            m.lin(f"{b}.{n}.linear", 6 * dim, time_dim)
            m.norm(f"{b}.{n}.norm", dim)
        m.attn(f"{b}.attn1", dim, qkv_bias=True)
        m.norm(f"{b}.norm_q", head_dim)
        m.norm(f"{b}.norm_k", head_dim)
        m.lin(f"{b}.ff.0", 4 * dim, dim)
        m.lin(f"{b}.ff.2", dim, 4 * dim)
    m.norm("norm_final", dim)
    m.lin("norm_out.linear", 2 * dim, time_dim)
    m.norm("norm_out.norm", dim)
    m.lin("proj_out", 4 * in_channels, dim)
    return m.sd


def _vae_sd(m: StateDictMaker, plan, latent_ch=None):
    """The plan's blocks; latent_ch: the decoder's spatial norms."""
    for i, desc in enumerate(plan):
        b = f"blocks.{i}"
        if desc[0] == "res":
            cin, cout = desc[1], desc[2]
            for n, c in (("norm1", cin), ("norm2", cout)):
                if latent_ch:
                    m.norm(f"{b}.{n}.norm_layer", c)
                    m.conv3d(f"{b}.{n}.conv_y", c, latent_ch, k=1)
                    m.conv3d(f"{b}.{n}.conv_b", c, latent_ch, k=1)
                else:
                    m.norm(f"{b}.{n}", c)
            m.conv3d(f"{b}.conv1", cout, cin)
            m.conv3d(f"{b}.conv2", cout, cout)
            if cin != cout:
                m.conv3d(f"{b}.conv_shortcut", cout, cin, k=1)
        else:
            m.conv(f"{b}.conv", desc[1], desc[1])


def cog_vae_encoder_state_dict(seed=0, device="cpu", dtype=torch.float32) -> dict:
    """Seeded random CogVideoX VAE-encoder weights (`COG_VAE_ENCODER_PLAN`'s widths)."""
    plan, m = COG_VAE_ENCODER_PLAN, StateDictMaker(seed, device, dtype)
    m.conv3d("conv_in", plan[0][1], 3)
    _vae_sd(m, plan)
    m.norm("norm_out", plan[-1][2])
    m.conv3d("conv_out", 32, plan[-1][2])
    return m.sd


def cog_vae_decoder_state_dict(seed=0, device="cpu", dtype=torch.float32) -> dict:
    """Seeded random CogVideoX VAE-decoder weights (`COG_VAE_DECODER_PLAN`'s widths)."""
    plan, m = COG_VAE_DECODER_PLAN, StateDictMaker(seed, device, dtype)
    m.conv3d("conv_in", plan[0][1], 16)
    _vae_sd(m, plan, latent_ch=16)
    c = plan[-1][2]
    m.norm("norm_out.norm_layer", c)
    m.conv3d("norm_out.conv_y", c, 16, k=1)
    m.conv3d("norm_out.conv_b", c, 16, k=1)
    m.conv3d("conv_out", 3, c)
    return m.sd
