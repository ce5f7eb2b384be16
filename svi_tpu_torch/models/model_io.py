"""Checkpoint loading, model detection, LoRA fusing and the model manager
(port of svi_tpu/models/model_io.py).

* `load_state_dict(s)`: one file, a shard list or a directory of shards into
  {name: torch tensor} on the CPU. `.safetensors` goes through the port's own
  reader (`utils.safetensors_io`: views of the mapped file, nothing read
  until used); `.pth` / `.bin` / `.ckpt` through `torch.load(weights_only=True,
  mmap=True)`, unwrapping `state_dict` and `model_state`.
* `hash_state_dict_keys` (the reference's md5 of the sorted keys) and
  `detect_model_kind` (structural detection). Only the Wan models and LoRA
  files load; the SD family raises (Slice F).
* `fuse_lora_into_dit`: W += α·B@A for peft `lora_A` / `lora_B` pairs, the
  delta in f32 and cast to the weight's dtype before the add.
* `ModelManager`: loads the files, fuses LoRA into the DiT, and hands each
  model to the pipeline (`fetch_model`). Each model's tensors go from the
  file to the device one at a time. With `quantize_dit`, the DiT stays on
  the host in its float dtype until the first fetch (LoRA is fused there),
  then moves to the device block by block, each block quantized as it
  arrives, so the device never holds the float tree. Downloading
  (`model_id_list`) is not ported: there is no network.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional

import torch
from torch import nn

from ..utils.safetensors_io import load_file
from . import clip_vision, t5, wan_dit, wan_vae

# ---------------------------------------------------------------------------
# State-dict reading
# ---------------------------------------------------------------------------


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """One checkpoint file -> {name: CPU tensor}, dtypes as stored."""
    if path.endswith(".safetensors"):
        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    if "model_state" in sd:
        sd = sd["model_state"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_state_dicts(paths) -> dict[str, torch.Tensor]:
    """Merge one file, a shard list, or a directory of shards."""
    if isinstance(paths, str):
        if os.path.isdir(paths):
            paths = sorted(os.path.join(paths, f) for f in os.listdir(paths)
                           if f.endswith((".safetensors", ".bin", ".pth", ".ckpt")))
        else:
            paths = [paths]
    out = {}
    for p in paths:
        out.update(load_state_dict(p))
    return out


# ---------------------------------------------------------------------------
# Identification
# ---------------------------------------------------------------------------


def _keys_to_str(state_dict, with_shape=True):
    keys = []
    for key, value in state_dict.items():
        if isinstance(key, str):
            if hasattr(value, "shape"):
                if with_shape:
                    shape = "_".join(map(str, list(value.shape)))
                    keys.append(key + ":" + shape)
                keys.append(key)
            elif isinstance(value, dict):
                keys.append(key + "|" + _keys_to_str(value, with_shape=with_shape))
    keys.sort()
    return ",".join(keys)


def hash_state_dict_keys(state_dict, with_shape=True) -> str:
    """The reference's md5 of the sorted keys (and shapes)."""
    return hashlib.md5(_keys_to_str(state_dict, with_shape).encode("utf-8")).hexdigest()


def detect_model_kind(sd: dict) -> Optional[str]:
    """Structural detection (robust to fine-tunes, unlike a hash lookup)."""
    keys = sd.keys()

    def has(k):
        return k in keys

    if has("blocks.0.self_attn.q.weight") or has("blocks.0.self_attn.norm_q.weight"):
        return "wan_video_dit"
    if has("blocks.0.attn.q.weight") and has("token_embedding.weight"):
        return "wan_video_text_encoder"
    if has("encoder.conv1.weight") or has("model.encoder.conv1.weight"):
        return "wan_video_vae"
    if any(k.startswith(("visual.", "model.visual.", "textual.")) for k in keys):
        return "wan_video_image_encoder"
    # SD-family files in diffsynth naming (the zoo's pipelines)
    if has("motion_modules.0.transformer_blocks.0.pe1"):
        return "sd_motion_modules"
    if has("controlnet_blocks.0.weight") and has("controlnet_conv_in.blocks.0.weight"):
        return "sd_controlnet"
    if has("time_embedding.0.weight") and has("conv_in.weight") \
            and has("blocks.2.transformer_blocks.0.attn1.to_q.weight"):
        return "sd_unet"
    if has("encoders.0.layer_norm1.weight") and has("token_embedding.weight") \
            and has("position_embeds"):
        return "sd_text_encoder"
    if has("quant_conv.weight"):
        return "sd_vae_encoder"
    if has("post_quant_conv.weight"):
        return "sd_vae_decoder"
    if any(".lora_A." in k or ".lora_B." in k for k in keys):
        return "lora"
    return None


_SD_FAMILY = ("sd_motion_modules", "sd_controlnet", "sd_unet", "sd_text_encoder",
              "sd_vae_encoder", "sd_vae_decoder")


# ---------------------------------------------------------------------------
# LoRA fusing (peft naming)
# ---------------------------------------------------------------------------


def lora_name_map(lora_sd: dict) -> dict:
    """peft key pairs -> the target's reference name: {target: (B key, A key)}."""
    out = {}
    for key in lora_sd:
        if ".lora_B." not in key:
            continue
        keys = key.split(".")
        if len(keys) > keys.index("lora_B") + 2:
            keys.pop(keys.index("lora_B") + 1)
        keys.pop(keys.index("lora_B"))
        if keys[0] == "diffusion_model":
            keys.pop(0)
        out[".".join(keys)] = (key, key.replace(".lora_B.", ".lora_A."))
    return out


def extract_side_modules(sd: dict) -> dict:
    """Extra-module weights carried inside LoRA files (dwpose / randomref /
    inpaint / learn_in embeddings). Their consumers, the pose and talk
    pipelines, are Slice D's: nothing in this slice holds them."""
    markers = ("dwpose_embedding", "randomref_embedding_pose", "inpaint_embedding",
               "learn_in_embedding", "randomref")
    return {k: v for k, v in sd.items() if any(m in k for m in markers)}


_IMG_EMB_PORT = {"proj.0": "norm0", "proj.1": "fc1", "proj.3": "fc3", "proj.4": "norm4"}


def dit_param(dit: wan_dit.WanDiT, target: str) -> torch.Tensor:
    """The DiT parameter that a reference name (e.g. 'blocks.3.ffn.0.weight')
    names; KeyError when there is none."""
    if target.startswith("img_emb.proj."):
        head, rest = target[len("img_emb."):].rsplit(".", 1)
        parts = ["img_emb", _IMG_EMB_PORT.get(head, head), rest]
    else:
        parts = target.split(".")
    parts[-1] = {"weight": "w", "bias": "b"}.get(parts[-1], parts[-1])
    node = dit
    for part in parts:
        if isinstance(node, nn.ModuleList):
            if not part.isdigit() or int(part) >= len(node):
                raise KeyError(target)
            node = node[int(part)]
        elif isinstance(node, nn.Module) and part in node:
            node = node[part]
        else:
            raise KeyError(target)
    if not isinstance(node, torch.Tensor):
        raise KeyError(target)
    return node


@torch.no_grad()
def fuse_lora_into_dit(dit: wan_dit.WanDiT, lora_sd: dict, alpha: float = 1.0) -> int:
    """W += α·B@A in place for every LoRA pair, on the weight's device: B@A
    and α in f32, cast to W's dtype, then added. Our linears are (out, in),
    like the reference's, so the delta is not transposed. Returns the number
    of weights updated; raises KeyError on a target the DiT lacks."""
    n = 0
    for target, (up_key, down_key) in lora_name_map(lora_sd).items():
        w = dit_param(dit, target)
        up = lora_sd[up_key].to(device=w.device, dtype=torch.float32)  # B: (out, r)
        down = lora_sd[down_key].to(device=w.device, dtype=torch.float32)  # A: (r, in)
        if up.ndim == 4:
            up, down = up[..., 0, 0], down[..., 0, 0]
        w.add_((alpha * (up @ down)).reshape(w.shape).to(w.dtype))
        n += 1
    return n


# ---------------------------------------------------------------------------
# ModelManager
# ---------------------------------------------------------------------------


class ModelManager:
    """Loads checkpoints, identifies the models, fuses LoRA; the pipeline
    fetches each model (an nn.Module with its cfg) by name."""

    def __init__(self, torch_dtype=torch.bfloat16, device="cuda", quantize_dit=None):
        if quantize_dit is not None and quantize_dit not in wan_dit.QUANTIZE_MODES:
            raise ValueError(
                f"quantize_dit={quantize_dit!r}; choose from {wan_dit.QUANTIZE_MODES}")
        self.dtype = torch_dtype
        self.device = torch.device(device)
        self.quantize_dit = quantize_dit
        self._dit_quantized = False
        self.models: dict[str, nn.Module] = {}
        self.model_paths: dict = {}
        self.lora_log: list = []

    # -- loading ----------------------------------------------------------------

    def load_model(self, paths) -> str:
        """Load one model (a file, a shard list or a directory): detect its
        kind, convert it, and keep it under that kind. The DiT and umT5 take
        the manager's dtype; the VAE and CLIP stay f32."""
        sd = load_state_dicts(paths)
        kind = detect_model_kind(sd)
        if kind is None:
            raise ValueError(f"Cannot identify model from {paths}; key hash "
                             f"{hash_state_dict_keys(sd)} (keys like {list(sd)[:3]})")
        if kind in _SD_FAMILY:
            raise NotImplementedError(f"{paths}: a '{kind}' file; the SD-family loaders are not "
                                      "ported yet (Slice F of ROADMAP.md's Queue 1)")
        if kind == "lora":
            raise ValueError(f"load_model cannot load a '{kind}' file; use load_lora_v2")
        if kind == "wan_video_dit":
            cfg = dataclasses.replace(wan_dit.config_from_state_dict(sd), dtype=self.dtype)
            # with quantize_dit the float DiT waits on the host for the first fetch
            device = "cpu" if self.quantize_dit else self.device
            model = wan_dit.params_from_torch_state_dict(sd, cfg, device=device)
            self._dit_quantized = False
        elif kind == "wan_video_text_encoder":
            cfg = t5.config_from_state_dict(sd, dtype=self.dtype)
            model = t5.params_from_torch_state_dict(sd, cfg, device=self.device)
        elif kind == "wan_video_vae":
            model = wan_vae.params_from_torch_state_dict(sd, wan_vae.config_from_state_dict(sd),
                                                         device=self.device)
        else:
            model = clip_vision.params_from_torch_state_dict(
                sd, clip_vision.config_from_state_dict(sd), device=self.device)
        self.models[kind] = model
        self.model_paths[kind] = paths
        return kind

    def load_models(self, path_list):
        for paths in path_list:
            self.load_model(paths)

    def load_lora_v2(self, file_path, lora_alpha=1.0):
        """Fuse LoRA file(s) into the loaded DiT, where it lies (on the host
        while it waits to be quantized)."""
        if isinstance(file_path, (list, tuple)):
            for p in file_path:
                self.load_lora_v2(p, lora_alpha=lora_alpha)
            return
        sd = load_state_dict(file_path)
        if "wan_video_dit" not in self.models:
            raise RuntimeError("load the DiT before LoRA")
        n = fuse_lora_into_dit(self.models["wan_video_dit"], sd, alpha=lora_alpha)
        if n == 0:
            raise RuntimeError(f"Cannot load LoRA from {file_path}: no matching tensors")
        self.lora_log.append((file_path, n))

    # -- fetching ---------------------------------------------------------------

    def fetch_model(self, model_name, require_model_path=False):
        """The model loaded under model_name (None if none); with
        require_model_path, (model, its paths). The first fetch of a DiT to
        be quantized quantizes it onto the device."""
        if model_name not in self.models:
            return None
        if model_name == "wan_video_dit" and self.quantize_dit and not self._dit_quantized:
            self.models[model_name] = wan_dit.quantize_to_device(
                self.models[model_name], self.quantize_dit, self.device)
            self._dit_quantized = True
        model = self.models[model_name]
        if require_model_path:
            return model, self.model_paths.get(model_name)
        return model
