"""StepVideo's causal 3-D VAE (version 2), port of
svi_tpu/models/stepvideo_vae.py.

It maps 17-frame pixel chunks to 3-frame latent chunks of 64 channels at a
sixteenth of the size. Activations here are channels-first (B, C, T, H, W)
(svi_tpu's are channels-last); every convolution is f32 through
`ops.conv.conv_f32` (cuDNN TF32 off). The pieces:
- causal time padding (k_t - 1 zero frames in front) on every 3-D conv;
- group norms with per-frame statistics (version 2), the "zero-pad" ones
  followed by two zero frames that make the next conv time-valid;
- pixel-unshuffle / pixel-shuffle patchify stages with channel-averaging /
  channel-duplicating shortcuts, the channel order (c, ft, fh, fw) of the
  JAX package;
- a token-causal single-head attention over the flattened (t, h, w) tokens
  in the mid blocks: the kernels are non-causal, so it is plain torch in
  query chunks of 512, as svi_tpu computes it, and the whole score matrix
  never exists;
- the chunked decode with cross-chunk frame blending (`mix`) and the
  feathered spatially tiled decode (the reference's tiled path skips the
  blend, and so does this one).
The structure is read from the weights (the key names say each level's
down- or upsampler), so one forward serves any channel configuration.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv_f32
from .flux import _count
from .params import ParamTree, convert_tree
from .sd import StateDictMaker, _Reader, jax_leaf

# ---------------------------------------------------------------------------
# primitives, channels first (B, C, T, H, W)
# ---------------------------------------------------------------------------


def _conv3d(p, x, stride=(1, 1, 1), time_pad=0, spatial_pad=0):
    if time_pad:
        x = F.pad(x, (0, 0, 0, 0, time_pad, 0))
    return conv_f32(F.conv3d, x, p["w"].to(x.dtype), p["b"].to(x.dtype), stride,
                    (0, spatial_pad, spatial_pad))


def _causal_conv3d(p, x, stride=(1, 1, 1)):
    """Time padded by k_t - 1 frames in front, space by half the kernel."""
    kt, kh = p["w"].shape[2], p["w"].shape[3]
    return _conv3d(p, x, stride, time_pad=kt - 1, spatial_pad=kh // 2)


def _conv2d(p, x, stride=1, padding=1):
    """A 2-D conv on every frame (a conv3d of kernel depth 1: no transposed
    copy of the video)."""
    return conv_f32(F.conv3d, x, p["w"].to(x.dtype)[:, :, None], p["b"].to(x.dtype),
                    (1, stride, stride), (0, padding, padding))


def _gn(p, x, act_silu=False, groups=32, eps=1e-5, pad_front=0):
    """Group norm with statistics over (C / groups, H, W) of each frame, in
    f32, SiLU after it with act_silu. pad_front zero frames come first: the
    norm is written into the padded tensor, so no second copy of the video
    exists."""
    b, c, t, h, w = x.shape
    xg = x.float().reshape(b, groups, c // groups, t, h, w)
    var, mean = torch.var_mean(xg, dim=(2, 4, 5), keepdim=True, correction=0)
    y = torch.empty((b, c, t + pad_front, h, w), dtype=torch.float32, device=x.device)
    y[:, :, :pad_front].zero_()
    yg = y[:, :, pad_front:].unflatten(1, (groups, c // groups))
    torch.sub(xg, mean, out=yg)
    yg.mul_(torch.rsqrt(var + eps))
    yg.mul_(p["w"].float().reshape(1, groups, -1, 1, 1, 1))
    yg.add_(p["b"].float().reshape(1, groups, -1, 1, 1, 1))
    if act_silu:
        F.silu(yg, inplace=True)
    return y.to(x.dtype)


def _gn_zero_pad(p, x, pad_size=2):
    """Norm and SiLU, then `pad_size` zero frames in front (the causal
    padding of the conv that follows)."""
    return _gn(p, x, act_silu=True, pad_front=pad_size)


def _causal_attention(q, k, v, chunk=512):
    """Single-head token-causal attention, q, k, v (B, S, C), in f32, one
    query chunk at a time."""
    b, s, c = q.shape
    scale = c ** -0.5
    kf, vf = k.float(), v.float()
    keys = torch.arange(s, device=q.device)
    outs = []
    for i in range(0, s, chunk):
        qc = q[:, i:i + chunk].float()
        logits = (qc @ kf.transpose(1, 2)) * scale
        rows = torch.arange(i, i + qc.shape[1], device=q.device)
        logits = logits.masked_fill(rows[:, None] < keys[None, :], float("-inf"))
        outs.append(torch.softmax(logits, dim=-1) @ vf)
        del logits
    return torch.cat(outs, dim=1).to(q.dtype)


def _attn_block(p, x):
    """Norm, 1x1 q / k / v, causal attention, 1x1 out, plus x."""
    b, c, t, h, w = x.shape
    nx = _gn(p["norm"], x)

    def tokens(name):
        return _conv3d(p[name], nx).flatten(2).transpose(1, 2)

    o = _causal_attention(tokens("q"), tokens("k"), tokens("v"))
    return _conv3d(p["proj_out"], o.transpose(1, 2).reshape(b, c, t, h, w)) + x


def _resnet_block(p, x):
    """Zero-pad norm + SiLU before each time-valid conv; the shortcut added
    in place."""
    h = _conv3d(p["conv1"], _gn_zero_pad(p["norm1"], x), spatial_pad=1)
    h = _conv3d(p["conv2"], _gn_zero_pad(p["norm2"], h), spatial_pad=1)
    return h.add_(_conv3d(p["nin_shortcut"], x) if "nin_shortcut" in p else x)


def _res3d_block_upsample(p, x):
    """silu(conv path + x) + x."""
    h = _gn(p["norm1"], _causal_conv3d(p["conv1"], x), act_silu=True)
    h = _gn(p["norm2"], _causal_conv3d(p["conv2"], h))
    return F.silu(h + x) + x


def _pixel_unshuffle_3d(x, factor):
    """factor - 1 zero frames in front; channels (c, ft, fh, fw), c major."""
    x = F.pad(x, (0, 0, 0, 0, factor - 1, 0))
    b, c, t, h, w = x.shape
    x = x.reshape(b, c, t // factor, factor, h // factor, factor, w // factor, factor)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, c * factor ** 3, t // factor, h // factor, w // factor)


def _pixel_shuffle_3d(x, factor):
    """Channels (c', ft, fh, fw) to space-time; the first factor - 1 frames
    dropped."""
    b, c, t, h, w = x.shape
    nc = c // factor ** 3
    x = x.reshape(b, nc, factor, factor, factor, t, h, w)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    x = x.reshape(b, nc, t * factor, h * factor, w * factor)
    return x[:, :, factor - 1:]


def _chan_avg_down(x, out_channels, factor):
    """Pixel-unshuffle, then the mean of each run of channels."""
    y = _pixel_unshuffle_3d(x, factor) if factor > 1 else x
    b, c, t, h, w = y.shape
    return y.reshape(b, out_channels, c // out_channels, t, h, w).mean(2)


def _chan_dup_up(x, out_channels, factor):
    """Each channel repeated, then pixel-shuffled."""
    repeats = out_channels * factor ** 3 // x.shape[1]
    y = x.repeat_interleave(repeats, dim=1)
    return y if factor == 1 else _pixel_shuffle_3d(y, factor)


def _nearest_up(x, time=True):
    """Each pixel (and frame, with time) repeated twice."""
    return F.interpolate(x, scale_factor=(2 if time else 1, 2, 2), mode="nearest")


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------


def stepvideo_vae_encode_chunk(params, x):
    """x (B, T, C, H, W) pixel chunk -> (B, t, 2 z, H / 16, W / 16) moments
    (mean | logvar)."""
    enc = params["encoder"]
    h = _causal_conv3d(enc["conv_in"], x.transpose(1, 2))
    for level in enc["down"]:
        for blk in level["block"]:
            h = _resnet_block(blk, h)
        if "downsample3d" in level:
            h = _causal_conv3d(level["downsample3d"], h, stride=(2, 2, 2))
        elif "downsample2d" in level:
            # padding 0 after one pixel right and bottom
            h = _conv2d(level["downsample2d"], F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
    h = _resnet_block(enc["mid"]["block_1"], h)
    h = _attn_block(enc["mid"]["attn_1"], h)
    h = _resnet_block(enc["mid"]["block_2"], h)

    h = _gn(enc["norm_out"], h, act_silu=True)
    out_ch = enc["conv_patchify"]["w"].shape[0]
    shortcut = _chan_avg_down(h, out_ch * 8, 2)
    h = _pixel_unshuffle_3d(_causal_conv3d(enc["conv_patchify"], h), 2) + shortcut
    shortcut = _chan_avg_down(h, enc["conv_out"]["w"].shape[0], 1)
    h = _causal_conv3d(enc["conv_out"], h) + shortcut
    return h.transpose(1, 2)


def stepvideo_vae_decode_chunk(params, z, temporal_downsample=4):
    """z (B, t, z, h, w) -> a (B, C, T, H, W) pixel chunk (channels first, as
    the reference returns it)."""
    dec = params["decoder"]
    h = z.transpose(1, 2)
    ch = dec["conv_in"]["w"].shape[0]
    h = _causal_conv3d(dec["conv_in"], h) + _chan_dup_up(h, ch, 1)
    block_in = dec["conv_unpatchify"]["w"].shape[0] // 8
    shortcut = _chan_dup_up(h, block_in, 2)
    h = _pixel_shuffle_3d(_causal_conv3d(dec["conv_unpatchify"], h), 2) + shortcut
    del shortcut

    h = _resnet_block(dec["mid"]["block_1"], h)
    h = _attn_block(dec["mid"]["attn_1"], h)
    h = _resnet_block(dec["mid"]["block_2"], h)

    for level in reversed(dec["up"]):
        for blk in level["block"]:
            h = _resnet_block(blk, h)
        if "upsample3d" in level:
            h = _res3d_block_upsample(level["upsample3d"], _nearest_up(h))
        elif "upsample2d" in level:
            h = _conv2d(level["upsample2d"], _nearest_up(h, time=False), stride=1, padding=1)

    h = _conv3d(dec["conv_out"], _gn_zero_pad(dec["norm_out"], h), spatial_pad=1)
    return h[:, :, temporal_downsample - 1:]


# ---------------------------------------------------------------------------
# the chunked API
# ---------------------------------------------------------------------------

FRAME_LEN = 17
LATENT_LEN = 3


def gaussian_sample(moments, rng=None, deterministic=False):
    """moments (B, T, 2 z, H, W) -> the mean, or with a torch Generator `rng`
    a draw (std from the clipped log-variance)."""
    mean, logvar = moments.chunk(2, dim=2)
    if deterministic or rng is None:
        return mean
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    noise = torch.randn(mean.shape, generator=rng, dtype=torch.float32,
                        device=rng.device).to(mean.device, mean.dtype)
    return mean + std * noise


def stepvideo_vae_encode(params, video, rng=None, deterministic=False):
    """video (B, T, C, H, W) in 17-frame chunks -> latents (B, t, z, h, w)."""
    chunks = [stepvideo_vae_encode_chunk(params, video[:, i:i + FRAME_LEN])
              for i in range(0, video.shape[1], FRAME_LEN)]
    return gaussian_sample(torch.cat(chunks, dim=1), rng, deterministic)


def mix(x, frame_len=FRAME_LEN, smooth_scale=0.6):
    """The last frame of each chunk and the first of the next blended, each
    from the other's original value. x (B, T, ...)."""
    t = x.shape[1]
    front = torch.arange(frame_len - 1, t - 1, frame_len, device=x.device)
    back = front + 1
    xf, xb = x[:, front], x[:, back]
    x = x.clone()
    x[:, front] = xf * smooth_scale + xb * (1 - smooth_scale)
    x[:, back] = xb * smooth_scale + xf * (1 - smooth_scale)
    return x


def stepvideo_vae_decode(params, latents, smooth_scale=0.6, decode_chunk_fn=None):
    """latents (B, T_lat, z, h, w) in 3-frame chunks -> (B, T, 3, H, W),
    blended across chunks."""
    fn = decode_chunk_fn or (lambda z: stepvideo_vae_decode_chunk(params, z))
    chunks = [fn(latents[:, i:i + LATENT_LEN]).transpose(1, 2)
              for i in range(0, latents.shape[1], LATENT_LEN)]
    return mix(torch.cat(chunks, dim=1), smooth_scale=smooth_scale)


def _build_1d_mask(length, left_bound, right_bound, border_width):
    x = np.ones((length,), np.float32)
    if not left_bound:
        x[:border_width] = (np.arange(border_width) + 1) / border_width
    if not right_bound:
        x[-border_width:] = np.flip((np.arange(border_width) + 1) / border_width)
    return x


def stepvideo_vae_tiled_decode(params, latents, tile_size=(34, 34), tile_stride=(16, 16),
                               smooth_scale=0.6, decode_chunk_fn=None):
    """Feather-blended spatial tiles of 3-frame latent chunks, accumulated on
    the latents' device in f32 -> (B, T, 3, H, W). As in the reference's
    tiled path (whose blend slices its channel axis and so does nothing),
    chunks are not blended: smooth_scale is unused."""
    fn = decode_chunk_fn or (lambda z: stepvideo_vae_decode_chunk(params, z))
    b, t, _, hh, ww = latents.shape
    size_h, size_w = tile_size
    stride_h, stride_w = tile_stride
    dev = latents.device
    values = torch.zeros((b, 3, t // 3 * 17, hh * 16, ww * 16), dtype=torch.float32, device=dev)
    weight = torch.zeros((1, 1, t // 3 * 17, hh * 16, ww * 16), dtype=torch.float32, device=dev)
    for ti in range(0, t, 3):
        for h in range(0, hh, stride_h):
            if h - stride_h >= 0 and h - stride_h + size_h >= hh:
                continue
            for w in range(0, ww, stride_w):
                if w - stride_w >= 0 and w - stride_w + size_w >= ww:
                    continue
                h_, w_ = h + size_h, w + size_w
                out = fn(latents[:, ti:ti + 3, :, h:h_, w:w_]).float()
                mh = _build_1d_mask(out.shape[3], h == 0, h_ >= hh, (size_h - stride_h) * 16)
                mw = _build_1d_mask(out.shape[4], w == 0, w_ >= ww, (size_w - stride_w) * 16)
                m = torch.from_numpy(np.minimum(mh[:, None], mw[None, :])).to(dev)
                tt, th, tw = out.shape[2:]
                t0, h0, w0 = ti // 3 * 17, h * 16, w * 16
                values[:, :, t0:t0 + tt, h0:h0 + th, w0:w0 + tw] += out * m
                weight[:, :, t0:t0 + tt, h0:h0 + th, w0:w0 + tw] += m
                del out
    del smooth_scale
    return (values / weight).transpose(1, 2)


# ---------------------------------------------------------------------------
# checkpoints in the reference's names
# ---------------------------------------------------------------------------


def _res_p(r: _Reader, prefix):
    p = {"norm1": r.norm(f"{prefix}.norm1"), "conv1": r.conv(f"{prefix}.conv1.conv"),
         "norm2": r.norm(f"{prefix}.norm2"), "conv2": r.conv(f"{prefix}.conv2.conv")}
    if f"{prefix}.nin_shortcut.conv.weight" in r:
        p["nin_shortcut"] = r.conv(f"{prefix}.nin_shortcut.conv")
    return p


def _attn_p(r: _Reader, prefix):
    return {"norm": r.norm(f"{prefix}.norm"),
            **{n: r.conv(f"{prefix}.{n}.conv") for n in ("q", "k", "v", "proj_out")}}


def _mid_p(r: _Reader, prefix):
    return {"block_1": _res_p(r, f"{prefix}.block_1"), "attn_1": _attn_p(r, f"{prefix}.attn_1"),
            "block_2": _res_p(r, f"{prefix}.block_2")}


def _levels(r: _Reader, prefix):
    return [[_res_p(r, f"{prefix}.{i}.block.{j}")
             for j in range(_count(r, f"{prefix}.{i}.block.{{}}.norm1.weight"))]
            for i in range(_count(r, f"{prefix}.{{}}.block.0.norm1.weight"))]


def stepvideo_vae_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> ParamTree:
    """The encoder and decoder under the reference's module names; a
    checkpoint's `decoder.conv_out.*` keys are read as `decoder.conv_out.conv.*`,
    as the reference's loader renames them."""
    sd = {(k.replace("decoder.conv_out.", "decoder.conv_out.conv.")
           if k.startswith("decoder.conv_out.") and not k.startswith("decoder.conv_out.conv.")
           else k): v for k, v in sd.items()}
    r = _Reader(sd, device, dtype)
    down = []
    for i, blocks in enumerate(_levels(r, "encoder.down")):
        level = {"block": blocks}
        if f"encoder.down.{i}.downsample.conv.conv.weight" in r:
            level["downsample3d"] = r.conv(f"encoder.down.{i}.downsample.conv.conv")
        elif f"encoder.down.{i}.downsample.conv.weight" in r:
            level["downsample2d"] = r.conv(f"encoder.down.{i}.downsample.conv")
        down.append(level)
    up = []
    for i, blocks in enumerate(_levels(r, "decoder.up")):
        level = {"block": blocks}
        pre = f"decoder.up.{i}.upsample"
        if f"{pre}.conv3d.conv1.conv.weight" in r:
            level["upsample3d"] = {"conv1": r.conv(f"{pre}.conv3d.conv1.conv"),
                                   "norm1": r.norm(f"{pre}.conv3d.norm1"),
                                   "conv2": r.conv(f"{pre}.conv3d.conv2.conv"),
                                   "norm2": r.norm(f"{pre}.conv3d.norm2")}
        elif f"{pre}.conv.weight" in r:
            level["upsample2d"] = r.conv(f"{pre}.conv")
        up.append(level)
    return ParamTree({
        "encoder": {"conv_in": r.conv("encoder.conv_in.conv"), "down": down,
                    "mid": _mid_p(r, "encoder.mid"), "norm_out": r.norm("encoder.norm_out"),
                    "conv_patchify": r.conv("encoder.conv_patchify.conv.conv"),
                    "conv_out": r.conv("encoder.conv_out.conv")},
        "decoder": {"conv_in": r.conv("decoder.conv_in.conv"),
                    "conv_unpatchify": r.conv("decoder.conv_unpatchify.conv.conv"),
                    "mid": _mid_p(r, "decoder.mid"), "up": up,
                    "norm_out": r.norm("decoder.norm_out"),
                    "conv_out": r.conv("decoder.conv_out.conv")},
    })


def params_from_jax(params: dict, dtype=torch.float32, device="cuda") -> ParamTree:
    """svi_tpu's VAE pytree (channels-last DHWIO / HWIO kernels) -> a
    ParamTree."""
    return ParamTree(convert_tree(dict(params), dtype, jax_leaf)).to(device)


# ---------------------------------------------------------------------------
# seeded random weights under the reference's names
# ---------------------------------------------------------------------------


def _res_sd(m: StateDictMaker, prefix, cin, cout):
    m.norm(f"{prefix}.norm1", cin)
    m.conv3d(f"{prefix}.conv1.conv", cout, cin)
    m.norm(f"{prefix}.norm2", cout)
    m.conv3d(f"{prefix}.conv2.conv", cout, cout)
    if cin != cout:
        m.conv3d(f"{prefix}.nin_shortcut.conv", cout, cin, k=1)


def _mid_sd(m: StateDictMaker, prefix, c):
    _res_sd(m, f"{prefix}.block_1", c, c)
    m.norm(f"{prefix}.attn_1.norm", c)
    for n in ("q", "k", "v", "proj_out"):
        m.conv3d(f"{prefix}.attn_1.{n}.conv", c, c, k=1)
    _res_sd(m, f"{prefix}.block_2", c, c)


def stepvideo_vae_state_dict(seed=0, device="cpu", dtype=torch.float32, z_channels=64,
                             num_res_blocks=2, enc_ch=32, enc_ch_mult=(4, 8, 16, 16),
                             down_sampling_layer=(1, 2), dec_ch=128, dec_ch_mult=(1, 2, 4, 4),
                             temporal_up_layers=(2, 3)) -> dict:
    """Seeded random VAE weights (version 2 at the published widths: the
    encoder 32 wide with multipliers (4, 8, 16, 16), the decoder 128 wide
    with (1, 2, 4, 4), 64 latent channels), in the checkpoint's names (the
    decoder's last conv as `decoder.conv_out.*`)."""
    m = StateDictMaker(seed, device, dtype)
    patch_ch = 4 * z_channels * 2 ** 3
    m.conv3d("encoder.conv_in.conv", enc_ch, 3)
    block_in = enc_ch
    for i, mult in enumerate(enc_ch_mult):
        block_out = enc_ch * mult
        for j in range(num_res_blocks):
            _res_sd(m, f"encoder.down.{i}.block.{j}", block_in, block_out)
            block_in = block_out
        if i != len(enc_ch_mult) - 1:
            if i in down_sampling_layer:
                m.conv3d(f"encoder.down.{i}.downsample.conv.conv", block_in, block_in)
            else:
                m.conv(f"encoder.down.{i}.downsample.conv", block_in, block_in)
    _mid_sd(m, "encoder.mid", block_in)
    m.norm("encoder.norm_out", block_in)
    m.conv3d("encoder.conv_patchify.conv.conv", patch_ch // 8, block_in)
    m.conv3d("encoder.conv_out.conv", 2 * z_channels, patch_ch)

    block_in = dec_ch * dec_ch_mult[-1]
    m.conv3d("decoder.conv_in.conv", patch_ch, z_channels)
    m.conv3d("decoder.conv_unpatchify.conv.conv", block_in * 8, patch_ch)
    _mid_sd(m, "decoder.mid", block_in)
    for i in reversed(range(len(dec_ch_mult))):
        block_out = dec_ch * dec_ch_mult[i]
        for j in range(num_res_blocks + 1):
            _res_sd(m, f"decoder.up.{i}.block.{j}", block_in, block_out)
            block_in = block_out
        if i != 0:
            if i in temporal_up_layers:
                pre = f"decoder.up.{i}.upsample.conv3d"
                m.conv3d(f"{pre}.conv1.conv", block_in, block_in)
                m.norm(f"{pre}.norm1", block_in)
                m.conv3d(f"{pre}.conv2.conv", block_in, block_in)
                m.norm(f"{pre}.norm2", block_in)
            else:
                m.conv(f"decoder.up.{i}.upsample.conv", block_in, block_in)
    m.norm("decoder.norm_out", block_in)
    m.conv3d("decoder.conv_out", 3, block_in)
    return m.sd
