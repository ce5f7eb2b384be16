"""Narrow SVD, Hunyuan-DiT, HunyuanVideo and CogVideoX fixtures for the
port's CPU tests and the card's small run: plans of the published plans'
lengths and kinds at a tenth (UNet) or a quarter (VAEs) of their channels,
DiTs a few blocks deep at narrow widths, and seeded random state dicts in
the reference's diffsynth naming (the port's `*_state_dict` writers), as
torch tensors for the port and numpy arrays for svi_tpu. Imports no JAX.

Head counts: svi_tpu fixes Hunyuan-DiT's 16 heads and HunyuanVideo's 24 in
its forwards, so their narrow DiTs keep those counts (16 heads of 8, 24
heads of 8 with RoPE axes (2, 2, 4), passed as `HYV_ROPE_DIMS`); CogVideoX's
block takes its head count as an argument (2 heads of 64 here,
`COG_HEADS`)."""

import numpy as np
import torch

from svi_tpu_torch.models import cog as tcog
from svi_tpu_torch.models import hunyuan_dit as thy
from svi_tpu_torch.models import hunyuan_video as thv
from svi_tpu_torch.models import ipadapter as tip
from svi_tpu_torch.models import sd as tsd
from svi_tpu_torch.models import svd as tsvd


def narrow_svd_plan(plan, div):
    out = []
    for d in plan:
        if d[0] == "sres":
            out.append(("sres", d[1] // div, d[2] // div, d[3]))
        elif d[0] == "tres":
            out.append(("tres", d[1] // div, d[2]))
        elif d[0] in ("attn", "tattn"):
            out.append((d[0], 1, d[3] // div, d[3] // div))  # one head a block
        elif d[0] in ("mixp", "down", "up", "vae_attn"):
            out.append((d[0], d[1] // div))
        else:
            out.append(d)
    return out


def narrow_svd_vae_plan(plan, div):
    out = []
    for d in plan:
        if d[0] == "sres":
            out.append(("sres", d[1] // div, d[2] // div))
        elif d[0] in ("tres", "vae_attn", "up"):
            out.append((d[0], d[1] // div))
        else:
            out.append(d)
    return out


SVD_UNET_PLAN = narrow_svd_plan(tsvd.SVD_UNET_PLAN, 10)
SVD_VAE_DECODER_PLAN = narrow_svd_vae_plan(tsvd.SVD_VAE_DECODER_PLAN, 4)
SVD_IMAGE_DIM, SVD_IMAGE_PROJ = 64, 32  # the narrow CLIP image tower (16 heads of 4)


def patch_svd_plans(monkeypatch, jax_module=None):
    """The narrow SVD plans in the port's (and svi_tpu's, when given) module."""
    for mod in (tsvd, jax_module):
        if mod is not None:
            monkeypatch.setattr(mod, "SVD_UNET_PLAN", SVD_UNET_PLAN)
            monkeypatch.setattr(mod, "SVD_VAE_DECODER_PLAN", SVD_VAE_DECODER_PLAN)


def svd_state_dicts(seed=0) -> dict:
    """The SVD UNet and VAE decoder at the narrow plans (patched in by the
    caller), the SD VAE encoder at the narrow SD plans of
    torch_sd_fixtures (patched in by the caller) and a one-layer CLIP image
    tower."""
    return {"unet": tsvd.svd_unet_state_dict(seed, image_dim=SVD_IMAGE_PROJ),
            "vae_decoder": tsvd.svd_vae_decoder_state_dict(seed + 1),
            "vae_encoder": tsd.sd_vae_encoder_state_dict(seed + 2),
            "image_encoder": tip.clip_image_encoder_state_dict(
                seed + 3, dim=SVD_IMAGE_DIM, num_layers=1, projection=SVD_IMAGE_PROJ)}


# Hunyuan-DiT: 4 down and 2 up blocks 128 wide (16 heads of 8), BERT 32 wide,
# mT5 32 wide over its 77 + 256 tokens
HY_DIT = dict(dim=128, num_layers_down=4, num_layers_up=2, text_dim=32, t5_dim=32, mlp_dim=256)
HY_DOWN = HY_DIT["num_layers_down"]
HY_HEAD = HY_DIT["dim"] // thy.NUM_HEADS


def hunyuan_dit_state_dicts(seed=0) -> dict:
    """The narrow DiT and the SDXL VAE halves at the narrow SD VAE plans
    (patched in by the caller)."""
    return {"dit": thy.hunyuan_dit_state_dict(seed, **HY_DIT),
            "vae_encoder": tsd.sd_vae_encoder_state_dict(seed + 1),
            "vae_decoder": tsd.sd_vae_decoder_state_dict(seed + 2)}


# HunyuanVideo: 24 heads of 8 (RoPE axes 2 + 2 + 4), 2 double and 2 single
# blocks, a one-block token refiner, LLM states 32 wide, CLIP's pooled 768;
# the causal VAE at a quarter of its channels
HYV_ROPE_DIMS = (2, 2, 4)
HYV_DIT = dict(dim=24 * 8, num_double=2, num_single=2, num_refiner=1, text_dim=32,
               pooled_dim=768, mlp_ratio=2)
HYV_VAE_CHANNELS = tuple(c // 4 for c in thv.HYV_VAE_CHANNELS)


def hunyuan_video_state_dicts(seed=0) -> dict:
    return {"dit": thv.hunyuan_video_dit_state_dict(seed, dtype=torch.float32, **HYV_DIT),
            "vae_encoder": thv.hunyuan_video_vae_encoder_state_dict(
                seed + 1, channels=HYV_VAE_CHANNELS),
            "vae_decoder": thv.hunyuan_video_vae_decoder_state_dict(
                seed + 2, channels=HYV_VAE_CHANNELS),
            "clip": tsd.sd_text_encoder_state_dict(seed + 3, num_layers=1)}


# CogVideoX: 2 blocks of 2 heads of 64, a 32-wide time embedding, T5 32 wide;
# the VAE at a quarter of its channels
COG_HEADS = 2
COG_DIT = dict(dim=COG_HEADS * 64, num_layers=2, time_dim=32, text_dim=32)


def narrow_cog_plan(plan, div):
    return [(d[0], d[1] // div, d[2] // div) if d[0] == "res" else (d[0], d[1] // div, d[2])
            for d in plan]


COG_VAE_ENCODER_PLAN = narrow_cog_plan(tcog.COG_VAE_ENCODER_PLAN, 4)
COG_VAE_DECODER_PLAN = narrow_cog_plan(tcog.COG_VAE_DECODER_PLAN, 4)


def patch_cog_plans(monkeypatch, jax_module=None):
    for mod in (tcog, jax_module):
        if mod is not None:
            monkeypatch.setattr(mod, "COG_VAE_ENCODER_PLAN", COG_VAE_ENCODER_PLAN)
            monkeypatch.setattr(mod, "COG_VAE_DECODER_PLAN", COG_VAE_DECODER_PLAN)


def cog_state_dicts(seed=0) -> dict:
    """The narrow DiT and the VAE halves at the narrow plans (patched in by
    the caller)."""
    return {"dit": tcog.cog_dit_state_dict(seed, dtype=torch.float32, **COG_DIT),
            "vae_encoder": tcog.cog_vae_encoder_state_dict(seed + 1),
            "vae_decoder": tcog.cog_vae_decoder_state_dict(seed + 2)}


def frames(n, h, w, seed) -> np.ndarray:
    """n smooth seeded (H, W, 3) uint8 frames."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, h // 8 + 1, w // 8 + 1, 3)).astype(np.float32)
    up = base.repeat(8, axis=1).repeat(8, axis=2)[:, :h, :w]
    return up.clip(0, 255).astype(np.uint8)


# StepVideo: 2 heads of 128 (the RoPE split pins the head at 128), 2 blocks,
# 8 latent channels, Step1 64 wide (the captions the DiT reads) with 4
# heads in 2 groups; the VAE with 8 latent channels, one resnet a level, 32
# and 64 channels (its group norms take 32 groups)
STEP_DIT = dict(num_heads=2, head_dim=128, num_layers=2, in_channels=8, out_channels=8,
                caption_channels=64, clip_channels=24)
STEP1 = dict(dim=64, num_layers=2, num_heads=4, num_groups=2, ffn_dim=128, vocab=50)
STEP_VAE = dict(z_channels=8, num_res_blocks=1, enc_ch=32, enc_ch_mult=(1, 1, 2, 2),
                dec_ch=32, dec_ch_mult=(1, 1, 2, 2))


def stepvideo_state_dicts(seed=0) -> dict:
    from svi_tpu_torch.models import stepvideo as tsv
    from svi_tpu_torch.models import stepvideo_vae as tsvae

    return {"dit": tsv.stepvideo_dit_state_dict(seed, dtype=torch.float32, **STEP_DIT),
            "step1": tsv.step1_state_dict(seed + 1, dtype=torch.float32, **STEP1),
            "vae": tsvae.stepvideo_vae_state_dict(seed + 2, **STEP_VAE)}


# OmniGen: Phi-3 64 wide, 2 layers of 4 heads in 2 key-value groups, a
# 16 x 16 position table and LongRoPE factors for its 16-wide heads (the
# shapes of svi_tpu's own OmniGen test); the SDXL VAE at the narrow SD plans
# of torch_sd_fixtures (patched in by the caller)
OMNIGEN = dict(hidden=64, num_layers=2, num_heads=4, num_kv_heads=2, intermediate=128,
               vocab=50)
OMNIGEN_POS_MAX = 16
OMNIGEN_ROPE = (
    ("base", 10000.0),
    ("max_position_embeddings", 128),
    ("original_max_position_embeddings", 64),
    ("short_factor", (1.1, 1.3, 1.5, 1.7, 1.9, 2.1, 2.3, 2.5)),
    ("long_factor", (2.0,) * 8),
)


def omnigen_state_dicts(seed=0) -> dict:
    from svi_tpu_torch.models import omnigen as tog

    return {"transformer": tog.omnigen_state_dict(seed, **OMNIGEN),
            "vae_encoder": tsd.sd_vae_encoder_state_dict(seed + 1),
            "vae_decoder": tsd.sd_vae_decoder_state_dict(seed + 2)}
