"""Narrow SD 1.5 and SDXL family fixtures for the port's CPU tests (the
SDXL ones at the end): plans of the
published plans' lengths and kinds at a tenth of the UNet's channels (a
quarter of the VAE's), patched into both packages' module globals, a 2-layer
text encoder 96 wide (12 heads of 8), and seeded random state dicts in the
reference's diffsynth naming (the port's `*_state_dict` writers), as torch
tensors for the port and numpy arrays for svi_tpu."""

import contextlib
from pathlib import Path

import numpy as np
import torch

from svi_tpu_torch.models import controlnets as tcn
from svi_tpu_torch.models import ipadapter as tip
from svi_tpu_torch.models import motion as tmo
from svi_tpu_torch.models import sd as tsd
from svi_tpu_torch.models import sdxl as tsdxl
from svi_tpu_torch.utils.safetensors_io import save_file

TEXT_DIM, TEXT_LAYERS = 96, 2


@contextlib.contextmanager
def one_torch_thread():
    """torch's intra-op threads at 1 inside the block, restored after: the
    narrow models' many small ops gain nothing from threads, and beside
    other test workers on the same cores OpenMP's waiting threads slowed
    them several times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
COND_CHANNELS = (8, 16, 16, 32)


def narrow_plan(plan, div, heads=2):
    out = []
    for d in plan:
        if d[0] == "res":
            out.append(("res", d[1] // div, d[2] // div))
        elif d[0] == "attn":
            out.append(("attn", heads, d[3] // div // heads, d[3] // div))
        elif d[0] == "down":
            out.append(("down", d[1] // div, d[2], d[3]))
        elif d[0] in ("up", "vae_attn"):
            out.append((d[0], d[1] // div))
        else:
            out.append(d)
    return out


UNET_PLAN = narrow_plan(tsd.SD_UNET_PLAN, 10)
VAE_ENCODER_PLAN = narrow_plan(tsd.SD_VAE_ENCODER_PLAN, 4)
VAE_DECODER_PLAN = narrow_plan(tsd.SD_VAE_DECODER_PLAN, 4)
CONTROLNET_PLAN = narrow_plan(tcn.SD_CONTROLNET_PLAN, 10)


def patch_narrow_plans(monkeypatch):
    """The narrow plans in svi_tpu's and the port's module globals."""
    from svi_tpu.models import controlnets as jcn
    from svi_tpu.models import sd as jsd

    for mod in (jsd, tsd):
        monkeypatch.setattr(mod, "SD_UNET_PLAN", UNET_PLAN)
        monkeypatch.setattr(mod, "SD_VAE_ENCODER_PLAN", VAE_ENCODER_PLAN)
        monkeypatch.setattr(mod, "SD_VAE_DECODER_PLAN", VAE_DECODER_PLAN)
    for mod in (jcn, tcn):
        monkeypatch.setattr(mod, "SD_CONTROLNET_PLAN", CONTROLNET_PLAN)


def state_dicts(seed=0) -> dict:
    """{kind: torch state dict} of every SD-family model at the patched plans."""
    return {
        "sd_unet": tsd.sd_unet_state_dict(seed, text_dim=TEXT_DIM),
        "sd_text_encoder": tsd.sd_text_encoder_state_dict(seed + 1, dim=TEXT_DIM,
                                                          num_layers=TEXT_LAYERS),
        "sd_vae_encoder": tsd.sd_vae_encoder_state_dict(seed + 2),
        "sd_vae_decoder": tsd.sd_vae_decoder_state_dict(seed + 3),
        "sd_motion_modules": tmo.sd_motion_state_dict(seed + 4),
        "sd_controlnet": tcn.sd_controlnet_state_dict(seed + 5, text_dim=TEXT_DIM,
                                                      conditioning_channels=COND_CHANNELS),
    }


def to_numpy(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


FILE_NAMES = {"sd_unet": "unet.safetensors", "sd_text_encoder": "text_encoder.safetensors",
              "sd_vae_encoder": "vae_encoder.safetensors",
              "sd_vae_decoder": "vae_decoder.safetensors",
              "sd_motion_modules": "motion.safetensors",
              "sd_controlnet": "controlnet_tile.safetensors"}


def write_files(root: Path, sds: dict) -> dict:
    """Each state dict as a safetensors file under root; {kind: path}."""
    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for kind, sd in sds.items():
        paths[kind] = str(root / FILE_NAMES[kind])
        save_file(sd, paths[kind])
    return paths


def rel(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


_JITTED = {}


def jit_jax_blocks(monkeypatch):
    """svi_tpu's block forwards (resnet, spatial transformer, VAE attention,
    motion module), its text encoder and the primitives that sd.py calls
    outside them (conv, group norm, dense, the timestep embedding) patched
    to jitted versions of themselves, shared across tests: a UNet forward
    then compiles each distinct block shape once instead of dispatching its
    thousands of operations one by one. The arithmetic is the same
    functions'."""
    import jax
    from svi_tpu.models import motion as jmo
    from svi_tpu.models import sd as jsd

    if not _JITTED:
        _JITTED["res"] = jax.jit(jsd._resnet_block, static_argnames=("groups", "eps"))
        _JITTED["attn"] = jax.jit(jsd._attention_block, static_argnames=(
            "num_heads", "head_dim", "eps", "tiled", "tile_size", "tile_stride"))
        _JITTED["vae_attn"] = jax.jit(jsd._vae_attention_block, static_argnames=("eps",))
        _JITTED["temporal"] = jax.jit(jmo.temporal_block, static_argnames=(
            "num_heads", "head_dim", "batch_size"))
        _JITTED["text"] = jax.jit(jsd.sd_text_encoder_forward, static_argnames=("clip_skip",))
        _JITTED["conv"] = jax.jit(jsd._conv2d, static_argnames=("stride", "padding"))
        _JITTED["gn"] = jax.jit(jsd._group_norm, static_argnames=("groups", "eps"))
        _JITTED["dense"] = jax.jit(jsd._dense)
        _JITTED["temb"] = jax.jit(jsd.timestep_embedding, static_argnames=("num_channels",))
    monkeypatch.setattr(jsd, "_resnet_block", _JITTED["res"])
    monkeypatch.setattr(jsd, "_attention_block", _JITTED["attn"])
    monkeypatch.setattr(jsd, "_vae_attention_block", _JITTED["vae_attn"])
    monkeypatch.setattr(jmo, "temporal_block", _JITTED["temporal"])
    monkeypatch.setattr(jsd, "sd_text_encoder_forward", _JITTED["text"])
    for name, key in (("_conv2d", "conv"), ("_group_norm", "gn"), ("_dense", "dense"),
                      ("timestep_embedding", "temb")):
        monkeypatch.setattr(jsd, name, _JITTED[key])


# ---------------------------------------------------------------------------
# SDXL: the plan at a tenth of its channels with 2 heads (1 on the card's
# small run), one or two transformer layers a block, CLIP-L's text tower 96
# wide and bigG's 1280 wide (its 20 heads of 64 are fixed in svi_tpu) with
# one layer, ControlNet Union, AnimateDiff-SDXL, IP-Adapter with a one-layer
# 64-wide image encoder
# ---------------------------------------------------------------------------

XL_TEXT2_DIM, XL_IMAGE_DIM, XL_IMAGE_PROJ = 1280, 64, 32
XL_TEXT_DIM = TEXT_DIM + XL_TEXT2_DIM
XL_DEPTH = {21: 2}  # the mid block two layers deep, every other block one


_XL_PLANS = (tsdxl.SDXL_UNET_PLAN, tcn.SDXL_CONTROLNET_PLAN)  # the published ones


def xl_plans(heads=2) -> tuple:
    """The narrow SDXL UNet and ControlNet plans with `heads` heads a block."""
    return tuple(narrow_plan(plan, 10, heads) for plan in _XL_PLANS)


def patch_narrow_xl_plans(monkeypatch, heads=2):
    """The narrow SDXL plans (and SD's narrow VAE plans, which SDXL's VAE
    uses) in svi_tpu's and the port's module globals."""
    from svi_tpu.models import controlnets as jcn
    from svi_tpu.models import sdxl as jsdxl

    patch_narrow_plans(monkeypatch)
    unet, cnet = xl_plans(heads)
    for mod in (jsdxl, tsdxl):
        monkeypatch.setattr(mod, "SDXL_UNET_PLAN", unet)
    for mod in (jcn, tcn):
        monkeypatch.setattr(mod, "SDXL_CONTROLNET_PLAN", cnet)


def xl_state_dicts(seed=0) -> dict:
    """{kind: torch state dict} of the SDXL family at the patched plans."""
    return {
        "sdxl_unet": tsdxl.sdxl_unet_state_dict(seed, text_dim=XL_TEXT_DIM, depth=XL_DEPTH),
        "sdxl_text_encoder": tsdxl.sdxl_text_encoder_state_dict(seed + 1, dim=TEXT_DIM,
                                                                num_layers=TEXT_LAYERS),
        "sdxl_text_encoder_2": tsdxl.sdxl_text_encoder_2_state_dict(seed + 2, num_layers=1),
        "sdxl_vae_encoder": tsd.sd_vae_encoder_state_dict(seed + 3),
        "sdxl_vae_decoder": tsd.sd_vae_decoder_state_dict(seed + 4),
        "sdxl_motion_modules": tmo.sdxl_motion_state_dict(seed + 5),
        "sdxl_controlnet": tcn.sdxl_controlnet_state_dict(
            seed + 6, text_dim=XL_TEXT_DIM, conditioning_channels=COND_CHANNELS, depth=XL_DEPTH),
        "sdxl_ipadapter": tip.sdxl_ipadapter_state_dict(seed + 7, image_dim=XL_IMAGE_PROJ,
                                                        text_dim=XL_TEXT_DIM),
        "sdxl_ipadapter_clip_image_encoder": tip.clip_image_encoder_state_dict(
            seed + 8, dim=XL_IMAGE_DIM, num_layers=1, projection=XL_IMAGE_PROJ),
    }


# ---------------------------------------------------------------------------
# Kolors, SD3 and FLUX: ChatGLM 64 wide (4 heads of 16 over 2 key / value
# groups; a vocabulary that holds the vendored tokenizer's special ids), the
# MMDiT 64 wide (one head of 64; a dual block with RMS q / k norms, a middle
# and the final block), the FLUX DiT 128 wide (one head of 128, the width its
# RoPE needs) with a 32-wide text input, the 16-channel VAE at a quarter of
# its channels, CLIP-L's text tower at its 768 width (2 layers), bigG's at
# 1280 (1 layer), one-layer T5s as wide as each DiT's text input
# ---------------------------------------------------------------------------

GLM = dict(num_heads=4, num_groups=2, kv_channels=16)
GLM_HIDDEN, GLM_VOCAB = 64, 65040
SD3_DIT = dict(dim=64, num_layers=3, num_dual_blocks=1, qk_norm=True, pos_embed_max=16)
FLUX_DIM, FLUX_TEXT = 128, 32


def sd3_vae_plans():
    from svi_tpu_torch.models import sd3 as tsd3

    return (narrow_plan(tsd3.SD3_VAE_ENCODER_PLAN, 4), narrow_plan(tsd3.SD3_VAE_DECODER_PLAN, 4))


def tiny_t5_config(dim, dtype=torch.float32):
    from svi_tpu_torch.models import t5 as tt5

    return tt5.T5Config(vocab=32128, dim=dim, dim_attn=dim, dim_ffn=2 * dim, num_heads=2,
                        num_layers=1, dtype=dtype)


def kolors_state_dicts(seed=0) -> dict:
    """ChatGLM and the Kolors UNet (text projection 64 -> TEXT_DIM, add
    embedding 64 + 1536 wide) at the narrow SDXL plans patched in by the
    caller, AnimateDiff-SDXL and the VAE decoder."""
    from svi_tpu_torch.models import kolors as tkolors

    return {"chatglm": tkolors.chatglm_state_dict(seed, num_layers=2, hidden=GLM_HIDDEN,
                                                  ffn=48, vocab=GLM_VOCAB, **GLM),
            "unet": tsdxl.sdxl_unet_state_dict(seed + 1, text_dim=TEXT_DIM, pooled_dim=GLM_HIDDEN,
                                               depth=XL_DEPTH, text_proj_dim=GLM_HIDDEN),
            "motion": tmo.sdxl_motion_state_dict(seed + 2),
            "vae": tsd.sd_vae_decoder_state_dict(seed + 3)}


def sd3_state_dicts(seed=0) -> dict:
    """The MMDiT, the VAE halves (at the SD3 plans patched in by the
    caller), both CLIP towers and a T5 64 wide (and its config)."""
    from svi_tpu_torch.models import sd3 as tsd3
    from svi_tpu_torch.models import t5 as tt5

    t5_cfg = tiny_t5_config(64)
    return {"dit": tsd3.sd3_dit_state_dict(seed, **SD3_DIT),
            "vae_encoder": tsd3.sd3_vae_encoder_state_dict(seed + 1),
            "vae_decoder": tsd3.sd3_vae_decoder_state_dict(seed + 2),
            "te1": tsd.sd_text_encoder_state_dict(seed + 3, num_layers=2),
            "te2": tsdxl.sdxl_text_encoder_2_state_dict(seed + 4, num_layers=1),
            "t5": tt5.torch_state_dict_from_params(tt5.init_params(t5_cfg, seed + 5,
                                                                   device="cpu")),
            "t5_cfg": t5_cfg}


def flux_state_dicts(seed=0) -> dict:
    """The FLUX DiT with and without its guidance embedder, a union
    ControlNet, an IP-Adapter of 4 tokens, the VAE halves (at the SD3 plans
    patched in by the caller), CLIP-L and a T5 32 wide (and its config)."""
    from svi_tpu_torch.models import flux as tflux
    from svi_tpu_torch.models import t5 as tt5

    t5_cfg = tiny_t5_config(FLUX_TEXT)
    kw = dict(dtype=torch.float32, dim=FLUX_DIM, text_dim=FLUX_TEXT)
    return {"dit": tflux.flux_dit_state_dict(seed, num_joint=2, num_single=2, **kw),
            "dit_noguide": tflux.flux_dit_state_dict(seed + 1, num_joint=1, num_single=1,
                                                     guidance=False, **kw),
            "cnet": tflux.flux_controlnet_state_dict(seed + 2, num_joint=1, num_single=1,
                                                     num_modes=2, **kw),
            "ip": tflux.flux_ipadapter_state_dict(seed + 3, dtype=torch.float32, num_tokens=4,
                                                  cross_dim=64, dim=FLUX_DIM, num_blocks=4),
            "vae_encoder": tflux.flux_vae_encoder_state_dict(seed + 4),
            "vae_decoder": tflux.flux_vae_decoder_state_dict(seed + 5),
            "te1": tsd.sd_text_encoder_state_dict(seed + 6, num_layers=2),
            "t5": tt5.torch_state_dict_from_params(tt5.init_params(t5_cfg, seed + 7,
                                                                   device="cpu")),
            "t5_cfg": t5_cfg}
