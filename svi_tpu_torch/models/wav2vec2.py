"""The wav2vec2 audio tower of SVI-Talk (chinese-wav2vec2-base), f32.

Port of svi_tpu/models/wav2vec2.py: the 7-conv feature extractor (group
norm on the first conv), the linear interpolation of its features to the
video's length (25 per second of audio, align_corners), the feature
projection, and the 12-layer post-norm encoder with its grouped positional
convolution; `forward` returns all 12 hidden states, which SVI-Talk's
AudioProjModel reads. Checkpoints are in transformers' naming
(`params_from_torch`, `load_params`), no transformers module is built.
The attention is plain softmax in f32, as in the JAX package, and the
convolutions run in f32 with cuDNN TF32 off (`ops.conv.conv_f32`).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv_f32
from ..ops.norms import layer_norm
from ..utils.safetensors_io import load_file
from .params import Init, ParamTree, dense


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5


WAV2VEC2_BASE = Wav2Vec2Config()


class Wav2Vec2(ParamTree):
    """Conv weights (out, in, k), linears (out, in)."""

    def __init__(self, cfg: Wav2Vec2Config, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def feature_extractor(self, input_values: torch.Tensor) -> torch.Tensor:
        """(B, S) normalized waveform -> (B, S', 512) conv features."""
        cfg = self.cfg
        x = input_values[:, None, :]
        for i, p in enumerate(self["conv_layers"]):
            x = conv_f32(F.conv1d, x, p["w"], stride=cfg.conv_stride[i])
            if "group_norm" in p:  # GroupNorm(C, C): each channel normalized over time
                gp = p["group_norm"]
                mu = x.mean(-1, keepdim=True)
                var = (x - mu).square().mean(-1, keepdim=True)
                x = (x - mu) * torch.rsqrt(var + cfg.layer_norm_eps)
                x = x * gp["w"][:, None] + gp["b"][:, None]
            x = F.gelu(x)
        return x.transpose(1, 2)

    def encoder(self, hidden: torch.Tensor) -> torch.Tensor:
        """The post-norm stack: (B, S, H) -> the 12 layers' hidden states
        stacked as (L, B, S, H)."""
        cfg = self.cfg
        k = cfg.num_conv_pos_embeddings
        pc = self["pos_conv"]
        pos = conv_f32(F.conv1d, hidden.transpose(1, 2), pc["w"], pc["b"], padding=k // 2,
                       groups=cfg.num_conv_pos_embedding_groups).transpose(1, 2)
        if k % 2 == 0:  # the reference's same-pad layer drops the extra last column
            pos = pos[:, :-1]
        hidden = hidden + F.gelu(pos)
        ln = self["encoder_layer_norm"]
        hidden = layer_norm(hidden, ln["w"], ln["b"], eps=cfg.layer_norm_eps)
        heads = cfg.num_attention_heads
        hd = cfg.hidden_size // heads
        states = []
        for p in self["layers"]:
            b, s, h = hidden.shape
            q = (dense(p["q"], hidden) * hd ** -0.5).reshape(b, s, heads, hd)
            kk = dense(p["k"], hidden).reshape(b, s, heads, hd)
            v = dense(p["v"], hidden).reshape(b, s, heads, hd)
            att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, kk), dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, s, h)
            hidden = layer_norm(hidden + dense(p["o"], o), p["ln1"]["w"], p["ln1"]["b"],
                                eps=cfg.layer_norm_eps)
            y = F.gelu(dense(p["fc1"], hidden))
            hidden = layer_norm(hidden + dense(p["fc2"], y), p["ln2"]["w"], p["ln2"]["b"],
                                eps=cfg.layer_norm_eps)
            states.append(hidden)
        return torch.stack(states)

    def forward(self, input_values: torch.Tensor, video_length: int) -> torch.Tensor:
        """(B, S) normalized waveform -> (L = 12, B, video_length, 768)."""
        feats = linear_interpolate(self.feature_extractor(input_values), int(video_length))
        fp = self["feature_projection"]
        hidden = layer_norm(feats, fp["layer_norm"]["w"], fp["layer_norm"]["b"],
                            eps=self.cfg.layer_norm_eps)
        return self.encoder(dense(fp["projection"], hidden))


def linear_interpolate(feats: torch.Tensor, out_len: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=True) along axis 1 of
    (B, S, C), written out as svi_tpu writes it (lo / hi taps and weights)."""
    s = feats.shape[1]
    if s == out_len:
        return feats
    pos = torch.arange(out_len, dtype=torch.float32, device=feats.device) * (
        (s - 1) / max(out_len - 1, 1))
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=s - 1)
    w = (pos - lo)[None, :, None]
    return feats[:, lo] * (1.0 - w) + feats[:, hi] * w


def normalize_input(speech: np.ndarray) -> np.ndarray:
    """Zero mean, unit variance over the utterance (the feature extractor's
    do_normalize)."""
    speech = np.asarray(speech, np.float32)
    return (speech - speech.mean()) / np.sqrt(speech.var() + 1e-7)


def init_params(cfg: Wav2Vec2Config = WAV2VEC2_BASE, seed: int = 0, device="cuda") -> Wav2Vec2:
    """Seeded random weights: U(±1/sqrt(fan_in)) for convs and linears;
    norms at ones and zeros."""
    r = Init(seed, device, torch.float32)
    h, ffn = cfg.hidden_size, cfg.intermediate_size

    def u(shape, fan_in):
        return r.uniform(shape, 1.0 / math.sqrt(fan_in))

    def lin(fi, fo):
        return {"w": u((fo, fi), fi), "b": u((fo,), fi)}

    def norm(n):
        return {"w": r.ones((n,)), "b": r.zeros((n,))}

    convs, cin = [], 1
    for i, (cout, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        entry = {"w": u((cout, cin, k), cin * k)}
        if i == 0:
            entry["group_norm"] = norm(cout)
        convs.append(entry)
        cin = cout
    g, kp = cfg.num_conv_pos_embedding_groups, cfg.num_conv_pos_embeddings
    tree = {
        "conv_layers": convs,
        "feature_projection": {"layer_norm": norm(cin), "projection": lin(cin, h)},
        "pos_conv": {"w": u((h, h // g, kp), h // g * kp), "b": u((h,), h // g * kp)},
        "encoder_layer_norm": norm(h),
        "layers": [{"q": lin(h, h), "k": lin(h, h), "v": lin(h, h), "o": lin(h, h),
                    "ln1": norm(h), "fc1": lin(h, ffn), "fc2": lin(ffn, h), "ln2": norm(h)}
                   for _ in range(cfg.num_hidden_layers)],
    }
    return Wav2Vec2(cfg, tree)


# -- transformers' naming --------------------------------------------------------

_LAYER_NAMES = {"q": "attention.q_proj", "k": "attention.k_proj", "v": "attention.v_proj",
                "o": "attention.out_proj", "ln1": "layer_norm",
                "fc1": "feed_forward.intermediate_dense", "fc2": "feed_forward.output_dense",
                "ln2": "final_layer_norm"}
_POS = "encoder.pos_conv_embed.conv"


def params_from_torch(sd: dict, device="cuda") -> Wav2Vec2:
    """A transformers Wav2Vec2Model state dict (optionally under 'wav2vec2.')
    -> Wav2Vec2 on `device`, f32. The positional conv's weight norm is folded
    in from weight_g / weight_v or their parametrizations.* names (norm over
    (out, in) per kernel position)."""
    sd = {k.removeprefix("wav2vec2."): v for k, v in sd.items()}

    def t(name):
        return torch.as_tensor(sd[name]).to(device=device, dtype=torch.float32)

    def wb(name):
        return {"w": t(f"{name}.weight"), "b": t(f"{name}.bias")}

    convs, i = [], 0
    while f"feature_extractor.conv_layers.{i}.conv.weight" in sd:
        entry = {"w": t(f"feature_extractor.conv_layers.{i}.conv.weight")}
        gn = f"feature_extractor.conv_layers.{i}.layer_norm"
        if f"{gn}.weight" in sd:
            entry["group_norm"] = wb(gn)
        convs.append(entry)
        i += 1
    if f"{_POS}.parametrizations.weight.original0" in sd:
        g, v = (t(f"{_POS}.parametrizations.weight.original{j}") for j in (0, 1))
    else:
        g, v = t(f"{_POS}.weight_g"), t(f"{_POS}.weight_v")
    w = g * v / v.square().sum(dim=(0, 1), keepdim=True).sqrt()
    n = 0
    while f"encoder.layers.{n}.attention.q_proj.weight" in sd:
        n += 1
    tree = {
        "conv_layers": convs,
        "feature_projection": {"layer_norm": wb("feature_projection.layer_norm"),
                               "projection": wb("feature_projection.projection")},
        "pos_conv": {"w": w, "b": t(f"{_POS}.bias")},
        "encoder_layer_norm": wb("encoder.layer_norm"),
        "layers": [{k: wb(f"encoder.layers.{j}.{name}") for k, name in _LAYER_NAMES.items()}
                   for j in range(n)],
    }
    cfg = dataclasses.replace(WAV2VEC2_BASE, num_hidden_layers=n)
    return Wav2Vec2(cfg, tree)


def torch_state_dict_from_params(model: Wav2Vec2) -> dict[str, torch.Tensor]:
    """The inverse of `params_from_torch`, in transformers' naming, with the
    positional conv as weight_g (its norm per kernel position) and weight_v
    (the weight itself). For writing checkpoints."""
    out = {}
    for i, p in enumerate(model["conv_layers"]):
        out[f"feature_extractor.conv_layers.{i}.conv.weight"] = p["w"].detach()
        if "group_norm" in p:
            out[f"feature_extractor.conv_layers.{i}.layer_norm.weight"] = \
                p["group_norm"]["w"].detach()
            out[f"feature_extractor.conv_layers.{i}.layer_norm.bias"] = \
                p["group_norm"]["b"].detach()
    for name, key in (("layer_norm", "feature_projection.layer_norm"),
                      ("projection", "feature_projection.projection")):
        out[f"{key}.weight"] = model["feature_projection"][name]["w"].detach()
        out[f"{key}.bias"] = model["feature_projection"][name]["b"].detach()
    w = model["pos_conv"]["w"].detach()
    out[f"{_POS}.weight_g"] = w.square().sum(dim=(0, 1), keepdim=True).sqrt()
    out[f"{_POS}.weight_v"] = w
    out[f"{_POS}.bias"] = model["pos_conv"]["b"].detach()
    out["encoder.layer_norm.weight"] = model["encoder_layer_norm"]["w"].detach()
    out["encoder.layer_norm.bias"] = model["encoder_layer_norm"]["b"].detach()
    for j, p in enumerate(model["layers"]):
        for k, name in _LAYER_NAMES.items():
            out[f"encoder.layers.{j}.{name}.weight"] = p[k]["w"].detach()
            out[f"encoder.layers.{j}.{name}.bias"] = p[k]["b"].detach()
    return out


def load_params(path: str, device="cuda") -> Wav2Vec2:
    """A local wav2vec2 checkpoint directory: model.safetensors (the port's
    reader) or pytorch_model.bin (torch.load)."""
    st = os.path.join(path, "model.safetensors")
    if os.path.isfile(st):
        return params_from_torch(load_file(st), device=device)
    sd = torch.load(os.path.join(path, "pytorch_model.bin"), map_location="cpu",
                    weights_only=True)
    return params_from_torch(sd, device=device)
