"""Parameter containers shared by the port's models.

Each model is an `nn.Module` whose parameters are addressed like the JAX
package's parameter pytrees (`p["self_attn"]["q"]["w"]`), so every forward
function reads next to its JAX counterpart. Layouts are PyTorch's: linear
weights are (out, in) for `F.linear`, convolution weights (out, in, k...).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class ParamTree(nn.Module):
    """An nn.Module over a nested dict (and lists) of tensors. Frozen unless
    `trainable` (the base weights are frozen; training adapters are not)."""

    def __init__(self, tree: dict, trainable: bool = False):
        super().__init__()
        self._tree_keys = tuple(tree)
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val, trainable))
            elif isinstance(val, (list, tuple)):
                self.add_module(key, nn.ModuleList(ParamTree(x, trainable) for x in val))
            else:
                self.register_parameter(key, nn.Parameter(val, requires_grad=trainable))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._tree_keys

    def get(self, key: str, default=None):
        return getattr(self, key) if key in self._tree_keys else default

    def tree(self, consume: bool = False) -> dict:
        """The nested dict (and lists) of this module's tensors, detached.
        consume=True also removes them from the module, so the returned tree
        holds the only references the module had."""
        out = {}
        for key in self._tree_keys:
            val = getattr(self, key)
            if isinstance(val, ParamTree):
                out[key] = val.tree(consume)
            elif isinstance(val, nn.ModuleList):
                out[key] = [m.tree(consume) for m in val]
            else:
                out[key] = val.detach()
        if consume:
            for key in self._tree_keys:
                delattr(self, key)
            self._tree_keys = ()
        return out


def dense(p: ParamTree, x: torch.Tensor) -> torch.Tensor:
    """x @ w.T + b with the port's (out, in) weights."""
    return F.linear(x, p["w"], p.get("b"))


# -- weights carried across from the JAX package --------------------------------


def to_torch(arr, dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: exact through f32
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr))  # a writable copy
    return t.to(dtype) if t.is_floating_point() else t


def convert_tree(tree, dtype: torch.dtype, leaf_fn: Callable, path: tuple = (),
                 keep_f32: frozenset = frozenset()):
    """numpy pytree -> torch tree; leaf_fn(path, array) rearranges a leaf
    (e.g. transposes a weight) before conversion. Floating leaves become
    `dtype`, except those whose key is in keep_f32 (quantization scales),
    which become float32."""
    if isinstance(tree, dict):
        return {k: convert_tree(v, dtype, leaf_fn, path + (k,), keep_f32)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [convert_tree(v, dtype, leaf_fn, path + (i,), keep_f32)
                for i, v in enumerate(tree)]
    leaf_dtype = torch.float32 if path and path[-1] in keep_f32 else dtype
    return to_torch(leaf_fn(path, np.asarray(tree)), leaf_dtype)


def unstack(tree, n: int) -> list:
    """Stacked (L, ...) block arrays -> a list of L per-block trees."""
    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        return t[i]

    return [take(tree, i) for i in range(n)]


def linear_leaf(path: tuple, arr: np.ndarray) -> np.ndarray:
    """JAX (in, out) linear weights under key 'w' -> (out, in)."""
    return arr.T if path[-1] == "w" and arr.ndim == 2 else arr


# -- seeded random init on any device ------------------------------------------


class Init:
    """Seeded random tensors made directly on `device` in `dtype`."""

    def __init__(self, seed: int, device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def uniform(self, shape, lim: float, dtype=None) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype or self.dtype, device=self.device)
        return t.uniform_(-lim, lim, generator=self.gen)

    def normal(self, shape, std: float, dtype=None) -> torch.Tensor:
        t = torch.empty(shape, dtype=dtype or self.dtype, device=self.device)
        return t.normal_(0.0, std, generator=self.gen)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def linear(self, fan_in: int, fan_out: int, bias: bool = True) -> dict:
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weight (out, in) and bias."""
        lim = 1.0 / math.sqrt(fan_in)
        p = {"w": self.uniform((fan_out, fan_in), lim)}
        if bias:
            p["b"] = self.uniform((fan_out,), lim)
        return p
