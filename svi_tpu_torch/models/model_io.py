"""Checkpoint loading, model detection, LoRA fusing and the model manager
(port of svi_tpu/models/model_io.py).

* `load_state_dict(s)`: one file, a shard list or a directory of shards into
  {name: torch tensor} on the CPU. `.safetensors` goes through the port's own
  reader (`utils.safetensors_io`: views of the mapped file, nothing read
  until used); `.pth` / `.bin` / `.ckpt` through `torch.load(weights_only=True,
  mmap=True)`, unwrapping `state_dict` and `model_state`.
* `hash_state_dict_keys` (the reference's md5 of the sorted keys) and
  `detect_model_kind` (structural detection): the Wan models, LoRA files
  and the SD 1.5 and SDXL families (UNets, text encoders, VAE encoder and
  decoder, AnimateDiff motion modules, ControlNet, IP-Adapter SDXL and its
  image encoder) in the reference's diffsynth naming and the extensions'
  weights (ESRGAN's RRDBNet, RIFE's IFNet), which load in f32 (the
  pipelines cast to their own dtype). The SDXL VAE has the SD VAE's keys:
  `load_model(path, model_names="sdxl_vae_decoder")` names the kind where
  detection cannot (svi_tpu's manager detects none of the SDXL kinds).
* `fuse_lora_into_dit`: W += α·B@A for peft `lora_A` / `lora_B` pairs, the
  delta in f32 and cast to the weight's dtype before the add.
* `ModelManager`: loads the files, fuses LoRA into the DiT (keeping the
  extra modules a LoRA file carries, `state_dict_new_module`), and hands
  each model to the pipeline (`fetch_model`). A DiT given as shards plus
  `multitalk.safetensors` (the audio branches) loads as one state dict, so
  its config follows the keys. Each model's tensors go from the
  file to the device one at a time. With `quantize_dit`, the DiT stays on
  the host in its float dtype until the first fetch (LoRA is fused there),
  then moves to the device block by block, each block quantized as it
  arrives, so the device never holds the float tree. Downloading is not
  ported (it needs the network): a non-empty `model_id_list` raises.
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
    # SD-family files in diffsynth naming (the zoo's pipelines); SDXL's
    # motion modules are 15 where SD's are 21, its IP-Adapter has 70 modules
    if has("motion_modules.0.transformer_blocks.0.pe1"):
        sdxl = has("motion_modules.14.norm.weight") and not has("motion_modules.15.norm.weight")
        return "sdxl_motion_modules" if sdxl else "sd_motion_modules"
    if has("ipadapter_modules.0.to_k_ip.weight") and has("image_proj.proj.weight"):
        return "sdxl_ipadapter" if has("ipadapter_modules.16.to_k_ip.weight") else "sd_ipadapter"
    if has("embeddings.patch_embedding.weight") and has("visual_projection.weight"):
        return "sdxl_ipadapter_clip_image_encoder"
    if has("conv_first.weight") and has("body.0.rdb1.conv1.weight"):
        return "esrgan"
    if has("block0.conv0.0.0.weight") or has("module.block0.conv0.0.0.weight"):
        return "rife"
    if has("time_embedding.0.weight") and has("add_time_embedding.0.weight") \
            and has("conv_in.weight") and not has("controlnet_conv_in.blocks.0.weight"):
        return "sdxl_unet"
    if has("controlnet_blocks.0.weight") and has("controlnet_conv_in.blocks.0.weight"):
        return "sdxl_controlnet" if has("task_embedding") else "sd_controlnet"
    # the UNet's first attention block is plan entry 1; svi_tpu looks for
    # entry 2 (a push block) alone, and so does not identify these files
    if has("time_embedding.0.weight") and has("conv_in.weight") and (
            has("blocks.1.transformer_blocks.0.attn1.to_q.weight")
            or has("blocks.2.transformer_blocks.0.attn1.to_q.weight")):
        return "sd_unet"
    if has("encoders.0.layer_norm1.weight") and has("token_embedding.weight") \
            and has("position_embeds"):
        if has("text_projection.weight"):
            return "sdxl_text_encoder_2"
        return "sd_text_encoder" if has("final_layer_norm.weight") else "sdxl_text_encoder"
    if has("quant_conv.weight"):
        return "sd_vae_encoder"
    if has("post_quant_conv.weight"):
        return "sd_vae_decoder"
    if any(".lora_A." in k or ".lora_B." in k for k in keys):
        return "lora"
    return None


_SD_FAMILY = ("sd_motion_modules", "sd_controlnet", "sd_unet", "sd_text_encoder",
              "sd_vae_encoder", "sd_vae_decoder", "sdxl_unet", "sdxl_text_encoder",
              "sdxl_text_encoder_2", "sdxl_vae_encoder", "sdxl_vae_decoder",
              "sdxl_motion_modules", "sdxl_controlnet", "sd_ipadapter", "sdxl_ipadapter",
              "sdxl_ipadapter_clip_image_encoder", "esrgan", "rife")


def _sd_family_loader(kind: str):
    """The converter of an SD-family or extension state dict in the
    reference's naming (civitai / diffusers layouts are converted to it
    beforehand)."""
    from ..extensions import esrgan, rife
    from . import controlnets, ipadapter, motion, sd, sdxl

    return {"sd_unet": sd.sd_unet_params_from_torch,
            "sd_text_encoder": sd.sd_text_encoder_params_from_torch,
            "sd_vae_encoder": sd.sd_vae_encoder_params_from_torch,
            "sd_vae_decoder": sd.sd_vae_decoder_params_from_torch,
            "sd_motion_modules": motion.motion_params_from_torch,
            "sd_controlnet": controlnets.sd_controlnet_params_from_torch,
            "sdxl_unet": sdxl.sdxl_unet_params_from_torch,
            "sdxl_text_encoder": sdxl.sdxl_text_encoder_params_from_torch,
            "sdxl_text_encoder_2": sdxl.sdxl_text_encoder_2_params_from_torch,
            "sdxl_vae_encoder": sd.sd_vae_encoder_params_from_torch,
            "sdxl_vae_decoder": sd.sd_vae_decoder_params_from_torch,
            "sdxl_motion_modules": motion.motion_params_from_torch,
            "sdxl_controlnet": controlnets.sdxl_controlnet_params_from_torch,
            "sd_ipadapter": ipadapter.ipadapter_params_from_torch,
            "sdxl_ipadapter": ipadapter.ipadapter_params_from_torch,
            "sdxl_ipadapter_clip_image_encoder": ipadapter.clip_image_encoder_params_from_torch,
            "esrgan": lambda sd_, device: esrgan.params_from_torch_state_dict(
                sd_, esrgan.config_from_state_dict(sd_), device=device),
            "rife": rife.params_from_torch_state_dict}[kind]


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
    inpaint / learn_in embeddings): `ModelManager.load_lora_v2` keeps them in
    `state_dict_new_module`, where the dance pipeline finds its pose
    embedding."""
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

    def __init__(self, torch_dtype=torch.bfloat16, device="cuda", model_id_list=None,
                 downloading_priority=None, file_path_list=None, train_architecture=None,
                 quantize_dit=None):
        """file_path_list: checkpoints loaded at once (`load_models`).
        train_architecture is kept and read nowhere, as in the JAX package.
        model_id_list names preset downloads, which need the network: the
        port does not download and raises for a non-empty list."""
        if model_id_list:
            raise NotImplementedError(
                "ModelManager(model_id_list=...) downloads checkpoints; the port loads local "
                "files only (file_path_list, load_model)")
        if quantize_dit is not None and quantize_dit not in wan_dit.QUANTIZE_MODES:
            raise ValueError(
                f"quantize_dit={quantize_dit!r}; choose from {wan_dit.QUANTIZE_MODES}")
        self.dtype = torch_dtype
        self.device = torch.device(device)
        self.quantize_dit = quantize_dit
        self._dit_quantized = False
        self.models: dict[str, nn.Module] = {}
        self.model_paths: dict = {}
        self.state_dict_new_module: dict[str, torch.Tensor] = {}
        self.lora_log: list = []
        self.train_architecture = train_architecture
        if file_path_list:
            self.load_models(file_path_list)

    # -- loading ----------------------------------------------------------------

    def load_model(self, paths, model_names=None, torch_dtype=None) -> str:
        """Load one model (a file, a shard list or a directory): detect its
        kind (or take it from model_names, a kind or a one-kind list),
        convert it, and keep it under that kind. The DiT and umT5 take
        torch_dtype (default the manager's dtype); the VAE, CLIP, the SD
        families and the extensions stay f32."""
        dtype = torch_dtype or self.dtype
        sd = load_state_dicts(paths)
        if isinstance(model_names, (list, tuple)):
            model_names = model_names[0] if model_names else None
        kind = model_names or detect_model_kind(sd)
        if kind is None:
            raise ValueError(f"Cannot identify model from {paths}; key hash "
                             f"{hash_state_dict_keys(sd)} (keys like {list(sd)[:3]})")
        if kind == "lora":
            raise ValueError(f"load_model cannot load a '{kind}' file; use load_lora_v2")
        if kind == "wan_video_dit":
            cfg = dataclasses.replace(wan_dit.config_from_state_dict(sd), dtype=dtype)
            # with quantize_dit the float DiT waits on the host for the first fetch
            device = "cpu" if self.quantize_dit else self.device
            model = wan_dit.params_from_torch_state_dict(sd, cfg, device=device)
            self._dit_quantized = False
        elif kind == "wan_video_text_encoder":
            cfg = t5.config_from_state_dict(sd, dtype=dtype)
            model = t5.params_from_torch_state_dict(sd, cfg, device=self.device)
        elif kind in _SD_FAMILY:
            model = _sd_family_loader(kind)(sd, device=self.device)
        elif kind == "wan_video_vae":
            model = wan_vae.params_from_torch_state_dict(sd, wan_vae.config_from_state_dict(sd),
                                                         device=self.device)
        else:
            model = clip_vision.params_from_torch_state_dict(
                sd, clip_vision.config_from_state_dict(sd), device=self.device)
        self.models[kind] = model
        self.model_paths[kind] = paths
        return kind

    def load_models(self, path_list, model_names=None, torch_dtype=None):
        """`load_model` on each entry, every kind detected: model_names is
        accepted and unused, as in the JAX package."""
        for paths in path_list:
            self.load_model(paths, torch_dtype=torch_dtype)

    def load_lora_v2(self, file_path="", state_dict=None, lora_alpha=1.0):
        """Fuse LoRA file(s), or a state dict already loaded, into the loaded
        DiT, where it lies (on the host while it waits to be quantized); the
        extra modules a file carries go to state_dict_new_module."""
        if isinstance(file_path, (list, tuple)):
            for p in file_path:
                self.load_lora_v2(p, lora_alpha=lora_alpha)
            return
        sd = state_dict if state_dict else load_state_dict(file_path)
        self.state_dict_new_module.update(extract_side_modules(sd))
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
