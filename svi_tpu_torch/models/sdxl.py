"""Stable Diffusion XL: the UNet, the two CLIP text encoders and the VAE,
port of svi_tpu/models/sdxl.py.

The UNet is the SD UNet's plan machinery (`models.sd`) over SDXL's plan:
wider levels, 2 or 10 transformer layers an attention block, a 2048-wide
text context, and the add-time embedding of the pooled text and the six
micro-conditioning ids. The first text encoder is CLIP ViT-L's tower without
its final LayerNorm; the second OpenCLIP ViT-bigG's (20 heads of 64, plain
GELU) with its penultimate hidden state and a pooled, projected EOS state.
The VAE is SD's at scaling factor 0.13025. The f32 attention runs the
hand-written kernel on the card (K2: 10 or 20 heads of 64 in the UNet; K1:
the VAE's one head of 512); the text encoders' causal attention is the plain
masked softmax, as in the JAX package. A `text_intermediate_proj` entry in
the UNet's weights (Kolors' 4096-wide text) is applied when present.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .params import ParamTree, dense
from .sd import (
    StateDictMaker,
    _attention,
    _block_from,
    _conv2d,
    _group_norm,
    _layer_norm,
    _Reader,
    _run_plan,
    _timesteps,
    clip_encoder_scan,
    sd_text_encoder_state_dict,
    sd_vae_decode,
    sd_vae_encode,
    timestep_embedding,
)

SDXL_VAE_SCALING_FACTOR = 0.13025
SDXL_CONTROLNET_INSERT_AT = 22  # the plan entry after which ControlNet residuals enter
SDXL_TEXT_DIM, SDXL_POOLED_DIM = 2048, 1280

SDXL_UNET_PLAN = (
    [("res", 320, 320), ("push",), ("res", 320, 320), ("push",),
     ("down", 320, 1, False), ("push",)]
    + [("res", 320, 640), ("attn", 10, 64, 640), ("push",),
       ("res", 640, 640), ("attn", 10, 64, 640), ("push",),
       ("down", 640, 1, False), ("push",)]
    + [("res", 640, 1280), ("attn", 20, 64, 1280), ("push",),
       ("res", 1280, 1280), ("attn", 20, 64, 1280), ("push",)]
    + [("res", 1280, 1280), ("attn", 20, 64, 1280), ("res", 1280, 1280)]
    + [("pop",), ("res", 2560, 1280), ("attn", 20, 64, 1280),
       ("pop",), ("res", 2560, 1280), ("attn", 20, 64, 1280),
       ("pop",), ("res", 1920, 1280), ("attn", 20, 64, 1280), ("up", 1280)]
    + [("pop",), ("res", 1920, 640), ("attn", 10, 64, 640),
       ("pop",), ("res", 1280, 640), ("attn", 10, 64, 640),
       ("pop",), ("res", 960, 640), ("attn", 10, 64, 640), ("up", 640)]
    + [("pop",), ("res", 960, 320), ("pop",), ("res", 640, 320),
       ("pop",), ("res", 640, 320)]
)
# transformer layers of each attention block (plan index -> layers)
SDXL_TRANSFORMER_DEPTH = {7: 2, 10: 2, 15: 10, 18: 10, 21: 10, 25: 10, 28: 10, 31: 10, 35: 2,
                          38: 2, 41: 2}


def add_embedding(params, add_time_id, add_text_embeds, dtype) -> torch.Tensor:
    """The pooled text and the sinusoidal embeddings (256 each) of the
    micro-conditioning ids through the two-layer MLP."""
    ids = torch.as_tensor(add_time_id, device=add_text_embeds.device).reshape(-1)
    emb = timestep_embedding(ids, 256).reshape(add_text_embeds.shape[0], -1)
    emb = torch.cat([add_text_embeds, emb.to(add_text_embeds.dtype)], -1).to(dtype)
    return dense(params["2"], F.silu(dense(params["0"], emb)))


def sdxl_unet_forward(params, sample, timestep, encoder_hidden_states, add_time_id,
                      add_text_embeds, controlnet_res=None, ipadapter_kwargs_list=None,
                      motion=None, tiled=False, tile_size=64, tile_stride=32):
    """sample (B, 4, h, w) -> the noise prediction. add_time_id: (B, 6) or
    (B * 6,) micro-conditioning values; add_text_embeds: (B, 1280) pooled
    text; controlnet_res: the ControlNet's NCHW residuals, added after plan
    entry 22; motion: AnimateDiff hooks (`motion.motion_hooks`)."""
    x = sample
    t = timestep_embedding(_timesteps(timestep, x.device), 320).to(x.dtype)
    t = dense(params["time_embedding"]["2"], F.silu(dense(params["time_embedding"]["0"], t)))
    time_emb = t + add_embedding(params["add_time_embedding"], add_time_id, add_text_embeds,
                                 x.dtype)
    ctx = encoder_hidden_states
    if "text_intermediate_proj" in params:
        ctx = dense(params["text_intermediate_proj"], ctx)
    x = _conv2d(params["conv_in"], x)
    if controlnet_res is not None:
        controlnet_res = [r.to(x.dtype) for r in controlnet_res]
    x = _run_plan(SDXL_UNET_PLAN, params["blocks"], x, time_emb, ctx,
                  controlnet_res=controlnet_res, controlnet_insert_at=SDXL_CONTROLNET_INSERT_AT,
                  ipadapter_kwargs_list=ipadapter_kwargs_list, motion=motion, tiled=tiled,
                  tile_size=tile_size, tile_stride=tile_stride)
    x = _group_norm(params["conv_norm_out"], x, eps=1e-5)
    return _conv2d(params["conv_out"], F.silu(x))


def sdxl_text_encoder_forward(params, input_ids, clip_skip: int = 1) -> torch.Tensor:
    """CLIP ViT-L's text tower without its final LayerNorm: (n, 77) ids ->
    the hidden state `clip_skip - 1` layers before the last."""
    embeds = params["token_embedding"][input_ids] + params["position_embeds"][0]
    n_layers = len(params["encoders"])
    return clip_encoder_scan(params["encoders"], embeds, num_heads=12,
                             n_run=n_layers - (clip_skip - 1))


def sdxl_text_encoder_2_forward(params, input_ids, clip_skip: int = 2):
    """OpenCLIP bigG's text tower: (n, 77) ids -> (pooled (n, 1280), the
    hidden state `clip_skip` layers from the end, before the final LN). The
    pooled output is the final-LN state at the argmax (EOS) id through the
    text projection."""
    x = params["token_embedding"][input_ids] + params["position_embeds"][0]
    s = x.shape[1]
    mask = torch.triu(torch.full((s, s), float("-inf"), device=x.device), 1)[None, None]
    keep = len(params["encoders"]) - clip_skip  # 0-indexed layer whose output is kept
    hidden = x
    for i, p in enumerate(params["encoders"]):
        x = x + _attention(p["attn"], _layer_norm(p["layer_norm1"], x), None, num_heads=20,
                           head_dim=64, mask=mask)
        y = dense(p["fc1"], _layer_norm(p["layer_norm2"], x))
        x = x + dense(p["fc2"], F.gelu(y.float()).to(y.dtype))
        if i == keep:
            hidden = x
    final = _layer_norm(params["final_layer_norm"], x)
    eos = torch.as_tensor(input_ids).argmax(-1)
    pooled = final[torch.arange(final.shape[0], device=final.device), eos]
    return dense(params["text_projection"], pooled), hidden


def sdxl_vae_encode(params, image, tiled=False, tile_size=64, tile_stride=32):
    return sd_vae_encode(params, image, scaling_factor=SDXL_VAE_SCALING_FACTOR, tiled=tiled,
                         tile_size=tile_size, tile_stride=tile_stride)


def sdxl_vae_decode(params, latents, tiled=False, tile_size=64, tile_stride=32):
    return sd_vae_decode(params, latents, scaling_factor=SDXL_VAE_SCALING_FACTOR, tiled=tiled,
                         tile_size=tile_size, tile_stride=tile_stride)


# ---------------------------------------------------------------------------
# checkpoints in the reference's diffsynth naming
# ---------------------------------------------------------------------------


def sdxl_unet_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> ParamTree:
    r = _Reader(sd, device, dtype)
    tree = {
        "time_embedding": {"0": r.lin("time_embedding.0"), "2": r.lin("time_embedding.2")},
        "add_time_embedding": {"0": r.lin("add_time_embedding.0"),
                               "2": r.lin("add_time_embedding.2")},
        "conv_in": r.conv("conv_in"),
        "blocks": [_block_from(r, i, d) for i, d in enumerate(SDXL_UNET_PLAN)],
        "conv_norm_out": r.norm("conv_norm_out"),
        "conv_out": r.conv("conv_out"),
    }
    if "text_intermediate_proj.weight" in r:
        tree["text_intermediate_proj"] = r.lin("text_intermediate_proj")
    return ParamTree(tree)


def _clip_layers(r: _Reader) -> list:
    layers = []
    while f"encoders.{len(layers)}.layer_norm1.weight" in r:
        e = f"encoders.{len(layers)}"
        layers.append({"layer_norm1": r.norm(f"{e}.layer_norm1"), "attn": r.attn(f"{e}.attn"),
                       "layer_norm2": r.norm(f"{e}.layer_norm2"), "fc1": r.lin(f"{e}.fc1"),
                       "fc2": r.lin(f"{e}.fc2")})
    return layers


def sdxl_text_encoder_params_from_torch(sd: dict, device="cuda",
                                        dtype=torch.float32) -> ParamTree:
    r = _Reader(sd, device, dtype)
    return ParamTree({"token_embedding": r.t("token_embedding.weight"),
                      "position_embeds": r.t("position_embeds"), "encoders": _clip_layers(r)})


def sdxl_text_encoder_2_params_from_torch(sd: dict, device="cuda",
                                          dtype=torch.float32) -> ParamTree:
    r = _Reader(sd, device, dtype)
    return ParamTree({"token_embedding": r.t("token_embedding.weight"),
                      "position_embeds": r.t("position_embeds"), "encoders": _clip_layers(r),
                      "final_layer_norm": r.norm("final_layer_norm"),
                      "text_projection": r.lin("text_projection")})


# ---------------------------------------------------------------------------
# seeded random weights under the reference's names
# ---------------------------------------------------------------------------


def sdxl_unet_state_dict(seed=0, device="cpu", dtype=torch.float32, text_dim=SDXL_TEXT_DIM,
                         pooled_dim=SDXL_POOLED_DIM, depth=None, text_proj_dim=None) -> dict:
    """Seeded random SDXL UNet weights at `SDXL_UNET_PLAN`'s widths
    (2.567B parameters at the published plan); depth: transformer layers
    per attention block (`SDXL_TRANSFORMER_DEPTH`). Kolors' UNet:
    text_proj_dim=4096 adds `text_intermediate_proj` (4096 -> text_dim) and
    pooled_dim=4096 widens the add embedding to 5632."""
    plan, m = SDXL_UNET_PLAN, StateDictMaker(seed, device, dtype)
    c0 = plan[0][1]
    temb = 4 * c0
    m.lin("time_embedding.0", temb, 320)
    m.lin("time_embedding.2", temb, temb)
    m.lin("add_time_embedding.0", temb, pooled_dim + 6 * 256)
    m.lin("add_time_embedding.2", temb, temb)
    if text_proj_dim:
        m.lin("text_intermediate_proj", text_dim, text_proj_dim)
    m.conv("conv_in", c0, 4)
    m.plan_blocks(plan, temb, text_dim, SDXL_TRANSFORMER_DEPTH if depth is None else depth)
    m.norm("conv_norm_out", c0)
    m.conv("conv_out", 4, c0)
    return m.sd


def sdxl_text_encoder_state_dict(seed=0, device="cpu", dtype=torch.float32, dim=768,
                                 num_layers=12) -> dict:
    """CLIP ViT-L's text tower (12 layers of 768), no final LayerNorm."""
    return sd_text_encoder_state_dict(seed, device, dtype, dim=dim, num_layers=num_layers,
                                      final_norm=False)


def sdxl_text_encoder_2_state_dict(seed=0, device="cpu", dtype=torch.float32, dim=1280,
                                   num_layers=32) -> dict:
    """OpenCLIP bigG's text tower (32 layers of 1280) with its projection."""
    return sd_text_encoder_state_dict(seed, device, dtype, dim=dim, num_layers=num_layers,
                                      projection=dim)
