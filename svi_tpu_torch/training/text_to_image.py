"""Text-to-image LoRA fine-tuning of an SD / SDXL UNet, port of
svi_tpu/training/text_to_image.py.

`TextImageDataset` reads `train/metadata.csv` (file_name, text) and gives
[-1, 1] CHW float32 images: a cover resize (Pillow's bilinear, byte for
byte, `utils.image_process.resize_uint8`), a centre or random crop and an
optional flip, with svi_tpu's host draws in svi_tpu's order. An image file
is opened by Pillow; a `.npy` (H, W, 3) uint8 array needs no Pillow (the
card's machine has none).

The adapters are {dotted site: {"A": (in, r), "B": (r, out)}} f32 tensors,
svi_tpu's shapes, so that `lora_state_dict` writes the same PEFT tensors;
the port's linear weights are (out, in), so a fused weight is
w + ((A @ B) * scale).T cast to w's dtype. `apply_lora` builds a nested
dict / list view of the UNet that shares every untouched leaf (no copy of
the frozen weights); only A and B require gradients. `T2ILoRATrainer` runs
one step as svi_tpu's jitted step does: the noise and the timestep drawn on
the host from `np.random.RandomState(seed)`, the eps-MSE loss through the
UNet, and `torch.optim.AdamW` with optax.adamw's defaults (betas 0.9 /
0.999, eps 1e-8, weight decay 1e-4). On the card the UNet's attention
backward runs the f32 split kernels (csrc/flash_bwd_f32.cu).
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch
from torch import nn

from ..models.params import ParamTree

DEFAULT_TARGET_MODULES = ("to_q", "to_k", "to_v", "to_out")


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------


def _read_rgb(path: str) -> np.ndarray:
    """An (H, W, 3) uint8 image: a `.npy` array as stored, any other file
    through Pillow's RGB conversion."""
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
            raise ValueError(f"{path}: {arr.shape} {arr.dtype}, expected (H, W, 3) uint8")
        return arr
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


class TextImageDataset:
    """metadata.csv-driven (file_name, text) pairs; `steps_per_epoch`
    virtual length, a seeded rotation of the rows."""

    def __init__(self, dataset_path, steps_per_epoch=10000, height=1024, width=1024,
                 center_crop=True, random_flip=False, seed=0):
        self.steps_per_epoch = steps_per_epoch
        with open(os.path.join(dataset_path, "train", "metadata.csv")) as f:
            rows = list(csv.DictReader(f))
        self.path = [os.path.join(dataset_path, "train", r["file_name"]) for r in rows]
        self.text = [r["text"] for r in rows]
        self.height, self.width = height, width
        self.center_crop = center_crop
        self.random_flip = random_flip
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.steps_per_epoch

    def __getitem__(self, index):
        from ..utils.image_process import resize_uint8

        data_id = (int(self.rng.randint(0, len(self.path))) + index) % len(self.path)
        image = _read_rgb(self.path[data_id])
        h, w = image.shape[:2]
        scale = max(self.width / w, self.height / h)
        image = resize_uint8(image, round(w * scale), round(h * scale), "bilinear")
        h, w = image.shape[:2]
        if self.center_crop:
            left = (w - self.width) // 2
            top = (h - self.height) // 2
        else:
            left = int(self.rng.randint(0, w - self.width + 1))
            top = int(self.rng.randint(0, h - self.height + 1))
        image = image[top:top + self.height, left:left + self.width]
        if self.random_flip and self.rng.rand() < 0.5:
            image = image[:, ::-1]
        arr = np.asarray(image, np.float32).transpose(2, 0, 1) / 127.5 - 1.0
        return {"text": self.text[data_id], "image": arr}


# ---------------------------------------------------------------------------
# LoRA on a parameter tree
# ---------------------------------------------------------------------------


def _items(node):
    """(key, child) pairs of a ParamTree, dict, ModuleList or list node; None
    for a leaf."""
    if isinstance(node, ParamTree):
        return [(k, node[k]) for k in node._tree_keys]
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (nn.ModuleList, list, tuple)):
        return list(enumerate(node))
    return None


def _is_linear(node) -> bool:
    items = _items(node)
    if items is None:
        return False
    w = dict(items).get("w")
    return isinstance(w, torch.Tensor) and w.ndim == 2


def find_lora_sites(params, target_modules=DEFAULT_TARGET_MODULES):
    """Paths (tuples of keys and list indices) of every {module: {"w": 2-D}}
    node whose module name is in target_modules, in the tree's order."""
    sites = []

    def walk(node, path):
        for k, v in _items(node) or ():
            if k in target_modules and _is_linear(v):
                sites.append(path + (k,))
            else:
                walk(v, path + (k,))

    walk(params, ())
    return sites


def _get(params, path):
    node = params
    for p in path:
        node = node[p]
    return node


def init_lora(generator, params, rank=4, target_modules=DEFAULT_TARGET_MODULES,
              init_lora_weights="kaiming"):
    """{dotted path: {"A": (in, r), "B": (r, out)}} f32 adapters on the
    weights' device, requiring gradients. B starts at zero (the identity);
    A is gaussian / r or kaiming-uniform over U(-sqrt(6 / in), sqrt(6 / in)),
    drawn from `generator` (a torch.Generator on that device, or an int
    seed) site by site."""
    sites = find_lora_sites(params, target_modules)
    lora = {}
    for path in sites:
        w = _get(params, path)["w"]
        fan_out, fan_in = w.shape
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=w.device).manual_seed(int(generator))
        a = torch.empty((fan_in, rank), dtype=torch.float32, device=w.device)
        if init_lora_weights == "gaussian":
            a = a.normal_(generator=generator) / rank
        else:
            bound = float(np.sqrt(6.0 / fan_in))
            a = a.uniform_(-bound, bound, generator=generator)
        lora[".".join(map(str, path))] = {
            "A": a.requires_grad_(),
            "B": torch.zeros((rank, fan_out), dtype=torch.float32,
                             device=w.device).requires_grad_()}
    return lora


def apply_lora(params, lora, scale=1.0):
    """Fused view: w' = w + (scale * A @ B).T at every adapted site, as a
    nested dict / list that shares every untouched leaf with `params`."""

    def clone(node, path):
        items = _items(node)
        if items is None:
            return node
        dotted = ".".join(map(str, path))
        if dotted in lora and _is_linear(node):
            ab = lora[dotted]
            w = node["w"]
            delta = ((ab["A"] @ ab["B"]) * scale).T
            return {**dict(items), "w": w + delta.to(w.dtype)}
        out = {k: clone(v, path + (k,)) for k, v in items}
        return out if isinstance(node, (ParamTree, dict)) else list(out.values())

    return clone(params, ())


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def lora_state_dict(lora, alpha=None, rank=None):
    """PEFT-style export ({path}.lora_A.default.weight = A^T, (r, in);
    .lora_B.default.weight = B^T, (out, r)) as contiguous f32 numpy arrays."""
    out = {}
    for dotted, ab in lora.items():
        out[f"{dotted}.lora_A.default.weight"] = np.ascontiguousarray(_np32(ab["A"]).T)
        out[f"{dotted}.lora_B.default.weight"] = np.ascontiguousarray(_np32(ab["B"]).T)
    return out


def lora_from_state_dict(sd, device="cuda"):
    """A PEFT state dict (torch tensors or numpy arrays) -> adapters in f32 on
    `device`, requiring gradients."""
    lora = {}
    for k, v in sd.items():
        for part, name in ((".lora_A.", "A"), (".lora_B.", "B")):
            if part in k:
                t = torch.tensor(np.ascontiguousarray(_np32(v).T), device=device)
                lora.setdefault(k.split(part)[0], {})[name] = t.requires_grad_()
    return lora


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


class T2ILoRATrainer:
    """LoRA-only AdamW fine-tuning of a frozen UNet (a ParamTree on its
    device; the adapters and every step's tensors go there).

    `forward_fn(params, noisy_latents, timestep, prompt_emb) -> noise_pred`
    defaults to the SD UNet; pass an SDXL closure for SDXL. The scheduler
    must expose add_noise / training_target / training_weight
    (`EnhancedDDIMScheduler`)."""

    def __init__(self, unet_params, scheduler=None, forward_fn=None, learning_rate=1e-4,
                 lora_rank=4, lora_alpha=4.0, lora_target_modules=DEFAULT_TARGET_MODULES,
                 init_lora_weights="kaiming", pretrained_lora_path=None, seed=0):
        from ..models import sd as sd_models
        from ..schedulers.ddim import EnhancedDDIMScheduler

        self.unet_params = unet_params
        self.device = next(t for _, t in _leaves(unet_params)).device
        self.scheduler = scheduler or EnhancedDDIMScheduler()
        # train over the full timestep range
        self.scheduler.set_timesteps(self.scheduler.num_train_timesteps)
        self.forward_fn = forward_fn or sd_models.sd_unet_forward
        self.lora_alpha = lora_alpha
        self.lora_rank = lora_rank
        self.scale = lora_alpha / lora_rank
        if isinstance(lora_target_modules, str):
            lora_target_modules = tuple(lora_target_modules.split(","))
        generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.lora = init_lora(generator, unet_params, lora_rank, lora_target_modules,
                              init_lora_weights)
        if pretrained_lora_path is not None:
            from ..models.model_io import load_state_dict

            loaded = lora_from_state_dict(load_state_dict(pretrained_lora_path), self.device)
            matched = {k: v for k, v in loaded.items() if k in self.lora}
            print(f"{2 * len(matched)} parameters are loaded from {pretrained_lora_path}. "
                  f"{2 * (len(loaded) - len(matched))} parameters are unexpected.")
            self.lora.update(matched)
        self.optimizer = torch.optim.AdamW(
            [t for ab in self.lora.values() for t in (ab["A"], ab["B"])], lr=learning_rate,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        self.rng = np.random.RandomState(seed)

    def training_step(self, batch_image=None, prompt_emb=None, latents=None, vae_encode_fn=None):
        """One step. Either `latents` or (`batch_image` + `vae_encode_fn`)
        must be given; `prompt_emb` is the already-encoded text context.
        Returns the loss as a float."""
        if latents is None:
            latents = vae_encode_fn(batch_image)
        noise = self.rng.standard_normal(tuple(latents.shape)).astype(np.float32)
        timestep_id = int(self.rng.randint(0, len(self.scheduler.timesteps)))
        timestep = float(np.asarray(self.scheduler.timesteps)[timestep_id])
        dev = self.device
        latents = torch.as_tensor(latents).to(device=dev, dtype=torch.float32)
        noise = torch.from_numpy(noise).to(dev)
        noisy = self.scheduler.add_noise(latents, noise, timestep)
        target = self.scheduler.training_target(latents, noise, timestep).float()
        weight = float(self.scheduler.training_weight(timestep))
        t = torch.tensor([timestep], dtype=torch.float32, device=dev)
        emb = torch.as_tensor(prompt_emb).to(dev)
        pred = self.forward_fn(apply_lora(self.unet_params, self.lora, self.scale), noisy, t, emb)
        loss = torch.mean((pred.float() - target) ** 2) * weight
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return float(loss.detach())

    def save_lora(self, path):
        """LoRA-only checkpoint through the port's safetensors writer."""
        from ..utils.safetensors_io import save_file

        sd = lora_state_dict(self.lora, alpha=self.lora_alpha)
        save_file({k: torch.from_numpy(v) for k, v in sd.items()}, path)


def _leaves(node, path=()):
    """(path, tensor) of every leaf of a parameter tree."""
    items = _items(node)
    if items is None:
        yield path, node
        return
    for k, v in items:
        yield from _leaves(v, path + (k,))
