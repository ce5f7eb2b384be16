"""Tiny checkpoint files in the reference's on-disk formats, for the port's
tests: a Wan I2V DiT as two bf16 safetensors shards, umT5 as a bf16 .pth,
the VAE and the CLIP vision tower as f32 .pth, a peft-named LoRA, and the
vendored T5 sentencepiece model standing in for google/umt5-xxl's. The
weights are the port's seeded `init_params`, written under the names that
svi_tpu's converters read (`torch_state_dict_from_params`)."""

import dataclasses
import shutil
from pathlib import Path

import numpy as np
import torch

from svi_tpu_torch.models import clip_vision, t5, wan_dit, wan_vae
from svi_tpu_torch.utils.safetensors_io import save_file

REPO = Path(__file__).resolve().parent.parent
SPIECE = REPO / "svi_tpu_torch" / "tokenizer_configs" / "t5" / "spiece.model"

Z = 4  # latent channels: the DiT's in_dim is Z (noise) + 4 (mask) + Z (condition)
T5_VOCAB = 32128  # the stand-in tokenizer's ids are below 32128
DIT_CFG = wan_dit.WanDiTConfig(dim=64, in_dim=2 * Z + 4, ffn_dim=128, out_dim=Z, text_dim=64,
                               freq_dim=32, num_heads=2, num_layers=2, has_image_input=True,
                               clip_feature_dim=80)
T5_CFG = t5.T5Config(vocab=T5_VOCAB, dim=64, dim_attn=64, dim_ffn=96, num_heads=4, num_layers=2)
VAE_CFG = wan_vae.WanVAEConfig(dim=16, z_dim=Z)
CLIP_CFG = clip_vision.ClipVisionConfig(image_size=28, patch_size=14, dim=80, mlp_ratio=2,
                                        num_heads=1, num_layers=2)
LORA_TARGETS = ("self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o", "ffn.0", "ffn.2")
LORA_RANK = 4

DIT_SHARDS = ("diffusion_pytorch_model-00001-of-00002.safetensors",
              "diffusion_pytorch_model-00002-of-00002.safetensors")
T5_FILE = "models_t5_umt5-xxl-enc-bf16.pth"
VAE_FILE = "Wan2.1_VAE.pth"
CLIP_FILE = "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"
LORA_FILE = "svi-lora.safetensors"


def dit_state_dict(cfg=DIT_CFG, seed=1) -> dict:
    dit = wan_dit.init_params(dataclasses.replace(cfg, dtype=torch.bfloat16), seed=seed,
                              device="cpu")
    return wan_dit.torch_state_dict_from_params(dit)


def lora_state_dict(cfg=DIT_CFG, seed=5, rank=LORA_RANK) -> dict:
    """peft naming under diffusion_model., f32; B is not zero, so the fused
    weights move."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(cfg.num_layers):
        for mod in LORA_TARGETS:
            fo, fi = {"ffn.0": (cfg.ffn_dim, cfg.dim), "ffn.2": (cfg.dim, cfg.ffn_dim)}.get(
                mod, (cfg.dim, cfg.dim))
            key = f"diffusion_model.blocks.{i}.{mod}"
            out[f"{key}.lora_A.default.weight"] = torch.from_numpy(
                (rng.standard_normal((rank, fi)) / np.sqrt(fi)).astype(np.float32))
            out[f"{key}.lora_B.default.weight"] = torch.from_numpy(
                (rng.standard_normal((fo, rank)) * 0.05).astype(np.float32))
    return out


def write_tiny_checkpoints(root) -> dict:
    """Writes every file under `root` (the layout the drivers read under
    --dit_root); returns their paths and the state dicts written."""
    root = Path(root)
    (root / "google" / "umt5-xxl").mkdir(parents=True, exist_ok=True)
    shutil.copy(SPIECE, root / "google" / "umt5-xxl" / "spiece.model")
    sds = {"dit": dit_state_dict(),
           "t5": t5.torch_state_dict_from_params(t5.init_params(
               dataclasses.replace(T5_CFG, dtype=torch.bfloat16), seed=2, device="cpu")),
           "vae": wan_vae.torch_state_dict_from_params(
               wan_vae.init_params(VAE_CFG, seed=3, device="cpu")),
           "clip": clip_vision.torch_state_dict_from_params(
               clip_vision.init_params(CLIP_CFG, seed=4, device="cpu")),
           "lora": lora_state_dict()}
    # the proj convs of the VAE's attention start at zero; give them weights
    for k, v in sds["vae"].items():
        if ".proj." in k:
            sds["vae"][k] = torch.from_numpy(np.random.default_rng(len(k)).standard_normal(
                tuple(v.shape)).astype(np.float32) * 0.05)
    # the t5 file is bf16 throughout, as the reference's is
    sds["t5"] = {k: v.to(torch.bfloat16) for k, v in sds["t5"].items()}
    keys = list(sds["dit"])
    half = {k: sds["dit"][k] for k in keys if not k.startswith("blocks.1.")}
    save_file(half, str(root / DIT_SHARDS[0]))
    save_file({k: sds["dit"][k] for k in keys if k not in half}, str(root / DIT_SHARDS[1]))
    torch.save(sds["t5"], root / T5_FILE)
    torch.save(sds["vae"], root / VAE_FILE)
    torch.save(sds["clip"], root / CLIP_FILE)
    save_file(sds["lora"], str(root / LORA_FILE))
    return {"root": str(root), "dit": [str(root / s) for s in DIT_SHARDS],
            "t5": str(root / T5_FILE), "vae": str(root / VAE_FILE),
            "clip": str(root / CLIP_FILE), "lora": str(root / LORA_FILE), "sds": sds}
