"""umT5-XXL text encoder (Wan's T5).

Port of svi_tpu/models/t5.py: `forward`, `encode_prompt_states`, and the
reference's checkpoint (`config_from_state_dict`, `params_from_torch_state_dict`).
Relative-position buckets are the JAX package's exactly, there is no QK
scaling, and masked keys get a bias of -3.4e38 * 0.7. The attention here is
plain PyTorch (it was plain XLA in JAX): logits and softmax in f32.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.norms import t5_layer_norm
from .params import Init, ParamTree, convert_tree, to_torch, unstack


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    max_dist: int = 128
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self):
        return self.dim_attn // self.num_heads


UMT5_XXL = T5Config()


@functools.lru_cache(maxsize=8)
def relative_position_buckets(seq_len: int, num_buckets: int = 32, max_dist: int = 128):
    """Bidirectional T5 bucket matrix, (L, L) int32 numpy. Cached: callers
    must not write into it."""
    rel_pos = np.arange(seq_len)[None, :] - np.arange(seq_len)[:, None]
    nb = num_buckets // 2
    rel_buckets = (rel_pos > 0).astype(np.int64) * nb
    rel_pos = np.abs(rel_pos)
    max_exact = nb // 2
    with np.errstate(divide="ignore"):
        rel_large = max_exact + (
            np.log(np.maximum(rel_pos, 1) / max_exact) / math.log(max_dist / max_exact)
            * (nb - max_exact)
        ).astype(np.int64)
    rel_large = np.minimum(rel_large, nb - 1)
    rel_buckets += np.where(rel_pos < max_exact, rel_pos, rel_large)
    return rel_buckets.astype(np.int32)


def _gelu_erfless(x: torch.Tensor) -> torch.Tensor:
    """The reference's hand-rolled tanh GELU, in f32."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (xf + 0.044715 * xf ** 3)))
    return y.to(x.dtype)


class T5Encoder(ParamTree):
    def __init__(self, cfg: T5Config, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def _block(self, p, x, bias):
        """One T5 self-attention block. bias: (b, 1, 1, L) f32 mask bias."""
        cfg = self.cfg
        b, L, _ = x.shape
        n, hd = cfg.num_heads, cfg.head_dim
        y = t5_layer_norm(x, p["norm1"]["w"])
        q = F.linear(y, p["attn"]["q"].to(y.dtype)).reshape(b, L, n, hd)
        k = F.linear(y, p["attn"]["k"].to(y.dtype)).reshape(b, L, n, hd)
        v = F.linear(y, p["attn"]["v"].to(y.dtype)).reshape(b, L, n, hd)
        # no scaling; bf16 products are exact in f32, so f32 logits match an
        # f32-accumulating bf16 matmul
        logits = torch.einsum("bind,bjnd->bnij", q.float(), k.float())
        buckets = torch.from_numpy(relative_position_buckets(L, cfg.num_buckets, cfg.max_dist))
        rel = p["pos_embedding"]["table"][buckets.to(x.device).long()]  # (L, L, heads) f32
        logits = logits + rel.permute(2, 0, 1)[None].float() + bias
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.einsum("bnij,bjnd->bind", probs, v).reshape(b, L, n * hd)
        x = x + F.linear(attn, p["attn"]["o"].to(attn.dtype))
        y = t5_layer_norm(x, p["norm2"]["w"])
        gate = _gelu_erfless(F.linear(y, p["ffn"]["gate"].to(y.dtype)))
        h = F.linear(y, p["ffn"]["fc1"].to(y.dtype)) * gate
        return x + F.linear(h, p["ffn"]["fc2"].to(h.dtype))

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids (b, L) int; mask (b, L) 1/0 -> (b, L, dim) states."""
        x = self["token_embedding"][ids.long()].to(self.cfg.dtype)
        bias = torch.where(mask[:, None, None, :].to(x.device) == 0,
                           torch.tensor(-3.4e38 * 0.7, dtype=torch.float32, device=x.device),
                           torch.tensor(0.0, dtype=torch.float32, device=x.device))
        for p in self["blocks"]:
            x = self._block(p, x, bias)
        return t5_layer_norm(x, self["norm"]["w"])

    def encode_prompt_states(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Run the encoder, then zero the states past each sequence's length."""
        emb = self.forward(ids, mask)
        seq_lens = (mask > 0).sum(dim=1)
        pos = torch.arange(ids.shape[1], device=emb.device)[None, :, None]
        return torch.where(pos < seq_lens.to(emb.device)[:, None, None], emb,
                           torch.zeros((), dtype=emb.dtype, device=emb.device))


def init_params(cfg: T5Config = UMT5_XXL, seed: int = 0, device="cuda") -> T5Encoder:
    """Seeded random weights with the JAX package's distributions. Projection
    weights are stored (out, in)."""
    r = Init(seed, device, cfg.dtype)
    d, da, df = cfg.dim, cfg.dim_attn, cfg.dim_ffn

    def block():
        return {
            "norm1": {"w": r.ones((d,))},
            "norm2": {"w": r.ones((d,))},
            "attn": {
                "q": r.normal((da, d), (d * da) ** -0.5),
                "k": r.normal((da, d), d ** -0.5),
                "v": r.normal((da, d), d ** -0.5),
                "o": r.normal((d, da), (cfg.num_heads * da) ** -0.5),
            },
            "ffn": {
                "gate": r.normal((df, d), d ** -0.5),
                "fc1": r.normal((df, d), d ** -0.5),
                "fc2": r.normal((d, df), df ** -0.5),
            },
            "pos_embedding": {"table": r.normal(
                (cfg.num_buckets, cfg.num_heads),
                (2 * cfg.num_buckets * cfg.num_heads) ** -0.5, dtype=torch.float32)},
        }

    tree = {
        "token_embedding": r.normal((cfg.vocab, d), 1.0),
        "blocks": [block() for _ in range(cfg.num_layers)],
        "norm": {"w": r.ones((d,))},
    }
    return T5Encoder(cfg, tree)


def _t5_leaf(path: tuple, arr: np.ndarray) -> np.ndarray:
    """JAX (in, out) projections under attn/ffn -> (out, in)."""
    return arr.T if len(path) >= 2 and path[-2] in ("attn", "ffn") else arr


def params_from_jax(params: dict, cfg: T5Config = UMT5_XXL) -> T5Encoder:
    """The svi_tpu T5 pytree (numpy leaves) -> T5Encoder. The relative-position
    tables stay f32."""
    blocks = unstack(params["blocks"], cfg.num_layers)
    tree = convert_tree(dict(params, blocks=blocks), cfg.dtype, _t5_leaf)
    for bt, bj in zip(tree["blocks"], blocks):
        bt["pos_embedding"]["table"] = to_torch(bj["pos_embedding"]["table"], torch.float32)
    return T5Encoder(cfg, tree)


# ---------------------------------------------------------------------------
# Checkpoints in the reference's naming (WanTextEncoder's state dict)
# ---------------------------------------------------------------------------

# port leaf path within a block -> the reference's name
_T5_BLOCK_NAMES = {
    ("norm1", "w"): "norm1.weight", ("norm2", "w"): "norm2.weight",
    ("attn", "q"): "attn.q.weight", ("attn", "k"): "attn.k.weight",
    ("attn", "v"): "attn.v.weight", ("attn", "o"): "attn.o.weight",
    ("ffn", "gate"): "ffn.gate.0.weight", ("ffn", "fc1"): "ffn.fc1.weight",
    ("ffn", "fc2"): "ffn.fc2.weight", ("pos_embedding", "table"): "pos_embedding.embedding.weight",
}


def config_from_state_dict(sd, dtype: torch.dtype = torch.bfloat16) -> T5Config:
    """The architecture from the checkpoint's shapes."""
    vocab, dim = sd["token_embedding.weight"].shape
    num_layers = 1 + max(int(k.split(".")[1]) for k in sd
                         if k.startswith("blocks.") and k.split(".")[1].isdigit())
    num_buckets, num_heads = sd["blocks.0.pos_embedding.embedding.weight"].shape
    return T5Config(vocab=int(vocab), dim=int(dim),
                    dim_attn=int(sd["blocks.0.attn.q.weight"].shape[0]),
                    dim_ffn=int(sd["blocks.0.ffn.fc1.weight"].shape[0]),
                    num_heads=int(num_heads), num_layers=int(num_layers),
                    num_buckets=int(num_buckets), dtype=dtype)


def params_from_torch_state_dict(sd: dict, cfg: T5Config, device="cuda") -> T5Encoder:
    """The reference state dict (torch tensors) -> T5Encoder on `device`: the
    projections are (out, in) in both, so this renames keys; the
    relative-position tables are f32, the rest cfg.dtype."""
    def block(i):
        p = {}
        for (group, leaf), ref in _T5_BLOCK_NAMES.items():
            dtype = torch.float32 if group == "pos_embedding" else cfg.dtype
            p.setdefault(group, {})[leaf] = sd[f"blocks.{i}.{ref}"].to(device=device, dtype=dtype)
        return p

    tree = {"token_embedding": sd["token_embedding.weight"].to(device=device, dtype=cfg.dtype),
            "blocks": [block(i) for i in range(cfg.num_layers)],
            "norm": {"w": sd["norm.weight"].to(device=device, dtype=cfg.dtype)}}
    return T5Encoder(cfg, tree)


def torch_state_dict_from_params(text: T5Encoder) -> dict[str, torch.Tensor]:
    """The inverse of `params_from_torch_state_dict`: the encoder's tensors
    under the reference's names. For writing checkpoints."""
    out = {"token_embedding.weight": text["token_embedding"].detach(),
           "norm.weight": text["norm"]["w"].detach()}
    for i, p in enumerate(text["blocks"]):
        for (group, leaf), ref in _T5_BLOCK_NAMES.items():
            out[f"blocks.{i}.{ref}"] = p[group][leaf].detach()
    return out
