"""The feature towers of the image-quality metrics, port of
svi_tpu/extensions/quality_towers.py.

One pre-LN transformer forward covers the CLIP-family towers
(transformers' CLIPModel for Aesthetic / PickScore / MPS, open_clip's for
CLIPScore / HPSv2, BLIP's timm ViT for ImageReward); the BLIP BERT encoder
with per-layer cross-attention onto the image tokens (ImageReward's text
side); and MPS's CoCa-style cross model. Converters read each checkpoint's
own naming. The JAX package computes this attention as a plain softmax in
XLA outside Pallas, so here it is plain `torch.matmul` and `softmax`, f32;
the patch embedding is `conv_f32` (cuDNN, TF32 off).

Weights are nested dicts of tensors on a device; linear weights keep
PyTorch's (out, in) layout (`F.linear`), the projections (`proj`) are
(in, out) matrices applied as `x @ proj`, as both checkpoint families give
them. Images are (H, W, 3) uint8 arrays (a PIL image is read through
np.asarray, a path opened: `.npy`, else through Pillow); the bicubic resize
is Pillow's, byte for byte (`utils.image_process.resize_uint8`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import conv_f32

# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _ln(p, x, eps=1e-5):
    return F.layer_norm(x.float(), x.shape[-1:], p["w"].float(), p["b"].float(),
                        eps).to(x.dtype)


def _dense(p, x):
    return F.linear(x, p["w"], p.get("b"))


def _gelu(x, quick=False):
    if quick:
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


def _mha(p, q_in, kv_in, heads, mask=None):
    """Multi-head attention: q_in (B, Lq, D), kv_in (B, Lk, Dkv), an additive
    mask (..., Lq, Lk) or None; a plain f32 softmax."""
    b, lq, _ = q_in.shape
    lk = kv_in.shape[1]
    q = _dense(p["q"], q_in).reshape(b, lq, heads, -1).transpose(1, 2)
    k = _dense(p["k"], kv_in).reshape(b, lk, heads, -1).transpose(1, 2)
    v = _dense(p["v"], kv_in).reshape(b, lk, heads, -1).transpose(1, 2)
    logits = (q @ k.transpose(-1, -2)) / np.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits + mask
    attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = (attn @ v).transpose(1, 2).reshape(b, lq, -1)
    return _dense(p["o"], out) if "o" in p else out


def _pre_ln_block(p, x, heads, mask=None, quick_gelu=False, ln_eps=1e-5):
    h = _ln(p["ln1"], x, ln_eps)
    x = x + _mha(p, h, h, heads, mask)
    return x + _dense(p["fc2"], _gelu(_dense(p["fc1"], _ln(p["ln2"], x, ln_eps)), quick_gelu))


def _causal_mask(n, device):
    return torch.triu(torch.full((n, n), float("-inf"), device=device), 1)[None, None]


# ---------------------------------------------------------------------------
# CLIP-family towers
# ---------------------------------------------------------------------------


def clip_vision_forward(p, pixels, heads, quick_gelu=False, ln_eps=1e-5):
    """pixels (B, 3, H, W) normalized -> (pooled | None, tokens): pooled is
    ln_post(cls) @ proj where a projection exists; tokens the final hidden
    sequence, with ln_post on every token when `ln_post_all` (BLIP's final
    norm; pooled is then None)."""
    b = pixels.shape[0]
    ps = p["patch_w"].shape[-1]
    patch = conv_f32(F.conv2d, pixels, p["patch_w"], p.get("patch_b"), ps)
    tokens = patch.reshape(b, patch.shape[1], -1).transpose(1, 2)
    cls = p["cls"].reshape(1, 1, -1).expand(b, 1, tokens.shape[-1])
    x = torch.cat([cls, tokens], 1) + p["pos"][None]
    if p.get("ln_pre") is not None:
        x = _ln(p["ln_pre"], x, ln_eps)
    for blk in p["blocks"]:
        x = _pre_ln_block(blk, x, heads, quick_gelu=quick_gelu, ln_eps=ln_eps)
    if p.get("ln_post_all"):
        return None, _ln(p["ln_post"], x, ln_eps)
    pooled = _ln(p["ln_post"], x[:, 0], ln_eps)
    if p.get("proj") is not None:
        pooled = pooled @ p["proj"]
    return pooled, x


def _text_tokens(p, ids, heads, quick_gelu, ln_eps):
    ids = torch.as_tensor(np.asarray(ids), device=p["tok"].device).long()
    x = p["tok"][ids] + p["pos"][:ids.shape[1]][None]
    mask = _causal_mask(ids.shape[1], x.device)
    for blk in p["blocks"]:
        x = _pre_ln_block(blk, x, heads, mask=mask, quick_gelu=quick_gelu, ln_eps=ln_eps)
    x = _ln(p["ln_final"], x, ln_eps)
    return ids, x, x[torch.arange(ids.shape[0], device=x.device), ids.argmax(-1)]


def clip_text_forward(p, ids, heads, quick_gelu=False, ln_eps=1e-5):
    """ids (B, L) -> the causal tower's state at the argmax id (the EOT
    token has the highest id in the CLIP vocabulary), through the text
    projection."""
    _, _, pooled = _text_tokens(p, ids, heads, quick_gelu, ln_eps)
    return pooled @ p["proj"] if p.get("proj") is not None else pooled


def clip_text_token_features(text, ids, heads_t, quick_gelu=False, ln_eps=1e-5):
    """MPS's token-level text features: the whole final-LN sequence and the
    pooled state, both through the text projection."""
    _, x, pooled = _text_tokens(text, ids, heads_t, quick_gelu, ln_eps)
    if text.get("proj") is not None:
        x, pooled = x @ text["proj"], pooled @ text["proj"]
    return x, pooled


def clip_image_token_features(vision, px, heads_v, quick_gelu=False, ln_eps=1e-5):
    """MPS's token-level image features: the encoder's last hidden state
    (no post-LN) through the visual projection."""
    _, tokens = clip_vision_forward(vision, px, heads_v, quick_gelu=quick_gelu, ln_eps=ln_eps)
    return tokens @ vision["proj"] if vision.get("proj") is not None else tokens


# ---------------------------------------------------------------------------
# BLIP's BERT with per-layer cross-attention (ImageReward)
# ---------------------------------------------------------------------------


def bert_cross_forward(p, ids, attn_mask, enc_states, heads, ln_eps=1e-12):
    """Word + position embeddings and LN, then per layer post-LN
    self-attention, post-LN cross-attention onto the image tokens, post-LN
    FFN; returns the last hidden state."""
    ids = torch.as_tensor(np.asarray(ids), device=p["word"].device).long()
    x = _ln(p["emb_ln"], p["word"][ids] + p["pos"][:ids.shape[1]][None], ln_eps)
    mask = None
    if attn_mask is not None:
        m = torch.as_tensor(np.asarray(attn_mask), dtype=torch.float32, device=x.device)
        mask = (1.0 - m)[:, None, None, :] * -1e4
    for layer in p["layers"]:
        h = _mha(layer["self"], x, x, heads, mask)
        x = _ln(layer["self"]["out_ln"], x + _dense(layer["self"]["od"], h), ln_eps)
        if "cross" in layer:
            h = _mha(layer["cross"], x, enc_states, heads)
            x = _ln(layer["cross"]["out_ln"], x + _dense(layer["cross"]["od"], h), ln_eps)
        x = _ln(layer["out_ln"], x + _dense(layer["fc2"], _gelu(_dense(layer["fc1"], x))), ln_eps)
    return x


# ---------------------------------------------------------------------------
# MPS's cross model
# ---------------------------------------------------------------------------


def _swiglu(x):
    a, gate = x.chunk(2, dim=-1)
    return F.silu(gate) * a


def _rotary_table(n, dim_head, inv_freq=None, device="cpu"):
    """(n, dim_head): the frequencies duplicated over the two halves."""
    if inv_freq is None:
        inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim_head, 2, dtype=np.float32) / dim_head))
    inv_freq = torch.as_tensor(inv_freq, dtype=torch.float32, device=device)
    freqs = torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv_freq[None]
    return torch.cat([freqs, freqs], -1)


def _rotate_half(t):
    x1, x2 = t.chunk(2, dim=-1)
    return torch.cat([-x2, x1], -1)


def _apply_rotary(pos, t):
    return t * torch.cos(pos) + _rotate_half(t) * torch.sin(pos)


def _softmax_stable(sim):
    return torch.softmax(sim - sim.amax(-1, keepdim=True), dim=-1)


def cross_model_forward(p, query_tokens, context_tokens, mask):
    """query_tokens (B, N, D) image features, context_tokens (B, M, D) text
    features, an additive mask (B, N, M) (0 / -inf); per layer a residual
    multi-query cross-attention with a parallel SwiGLU FF onto the context,
    then a residual PaLM-style parallel block. f32."""
    x = query_tokens.float()
    ctx = context_tokens.float()
    mask = mask.float()[:, None]
    b, n, _ = x.shape
    for layer in p["layers"]:
        ca, sa = layer["cross"], layer["self"]
        h = ca["heads"]
        xn = _ln(ca["norm"], x)
        d_head = ca["to_kv"]["w"].shape[0] // 2
        q = _dense(ca["to_q"], xn).reshape(b, n, h, d_head).transpose(1, 2) * d_head ** -0.5
        k, v = _dense(ca["to_kv"], ctx).chunk(2, dim=-1)
        attn = _softmax_stable(torch.einsum("bhid,bjd->bhij", q, k) + mask)
        out = torch.einsum("bhij,bjd->bhid", attn, v).transpose(1, 2).reshape(b, n, -1)
        x = x + (_dense(ca["to_out"], out) + _dense(ca["ff2"], _swiglu(_dense(ca["ff1"], xn))))
        h, d_head = sa["heads"], sa["dim_head"]
        xn = _ln(sa["norm"], x)
        fused = _dense(sa["fused"], xn)
        qd = h * d_head
        q = fused[..., :qd].reshape(b, n, h, d_head).transpose(1, 2)
        k = fused[..., qd:qd + d_head]
        v = fused[..., qd + d_head:qd + 2 * d_head]
        pos = _rotary_table(n, d_head, sa.get("inv_freq"), x.device)
        q = _apply_rotary(pos, q) * d_head ** -0.5
        k = _apply_rotary(pos, k)
        attn = _softmax_stable(torch.einsum("bhid,bjd->bhij", q, k))
        out = torch.einsum("bhij,bjd->bhid", attn, v).transpose(1, 2).reshape(b, n, -1)
        x = x + _dense(sa["attn_out"], out) + _dense(sa["ff_out"], _swiglu(fused[..., qd + 2 * d_head:]))
    return x


# ---------------------------------------------------------------------------
# state-dict converters
# ---------------------------------------------------------------------------


class _SD:
    """A state dict's tensors as f32 on `device`."""

    def __init__(self, sd, device):
        self.sd, self.device = sd, device

    def __contains__(self, k):
        return k in self.sd

    def t(self, k):
        v = self.sd[k]
        v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
        return v.detach().to(device=self.device, dtype=torch.float32)

    def lin(self, prefix):
        p = {"w": self.t(f"{prefix}.weight")}
        if f"{prefix}.bias" in self.sd:
            p["b"] = self.t(f"{prefix}.bias")
        return p

    def ln(self, prefix):
        return {"w": self.t(f"{prefix}.weight"), "b": self.t(f"{prefix}.bias")}


def _count(sd, prefix, field):
    return len({k.split(".")[field] for k in sd if k.startswith(prefix)})


def _logit_scale(sd):
    return float(np.exp(np.asarray(sd["logit_scale"], np.float32).item())) \
        if "logit_scale" in sd else 100.0


def clip_params_from_hf(sd, device="cuda"):
    """transformers CLIPModel state dict -> (vision, text, logit_scale)."""
    r = _SD(sd, device)

    def block(pre):
        return {"ln1": r.ln(f"{pre}.layer_norm1"), "q": r.lin(f"{pre}.self_attn.q_proj"),
                "k": r.lin(f"{pre}.self_attn.k_proj"), "v": r.lin(f"{pre}.self_attn.v_proj"),
                "o": r.lin(f"{pre}.self_attn.out_proj"), "ln2": r.ln(f"{pre}.layer_norm2"),
                "fc1": r.lin(f"{pre}.mlp.fc1"), "fc2": r.lin(f"{pre}.mlp.fc2")}

    pre_ln = next((k for k in ("vision_model.pre_layrnorm", "vision_model.pre_layernorm")
                   if f"{k}.weight" in sd), None)
    vis = {
        "cls": r.t("vision_model.embeddings.class_embedding"),
        "patch_w": r.t("vision_model.embeddings.patch_embedding.weight"),
        "patch_b": (r.t("vision_model.embeddings.patch_embedding.bias")
                    if "vision_model.embeddings.patch_embedding.bias" in sd else None),
        "pos": r.t("vision_model.embeddings.position_embedding.weight"),
        "ln_pre": r.ln(pre_ln) if pre_ln else None,
        "ln_post": r.ln("vision_model.post_layernorm"),
        "proj": r.t("visual_projection.weight").T.contiguous(),
        "blocks": [block(f"vision_model.encoder.layers.{i}")
                   for i in range(_count(sd, "vision_model.encoder.layers.", 3))],
    }
    txt = {
        "tok": r.t("text_model.embeddings.token_embedding.weight"),
        "pos": r.t("text_model.embeddings.position_embedding.weight"),
        "ln_final": r.ln("text_model.final_layer_norm"),
        "proj": r.t("text_projection.weight").T.contiguous(),
        "blocks": [block(f"text_model.encoder.layers.{i}")
                   for i in range(_count(sd, "text_model.encoder.layers.", 3))],
    }
    return vis, txt, _logit_scale(sd)


def _split_qkv(r, prefix, dim):
    """A fused (3D, D) in-projection -> q / k / v linears."""
    w, b = r.t(f"{prefix}.in_proj_weight"), r.t(f"{prefix}.in_proj_bias")
    return tuple({"w": w[i * dim:(i + 1) * dim], "b": b[i * dim:(i + 1) * dim]}
                 for i in range(3))


def clip_params_from_open_clip(sd, device="cuda"):
    """open_clip CLIP state dict -> (vision, text, logit_scale)."""
    r = _SD(sd, device)

    def block(pre, width):
        q, k, v = _split_qkv(r, f"{pre}.attn", width)
        return {"ln1": r.ln(f"{pre}.ln_1"), "q": q, "k": k, "v": v,
                "o": r.lin(f"{pre}.attn.out_proj"), "ln2": r.ln(f"{pre}.ln_2"),
                "fc1": r.lin(f"{pre}.mlp.c_fc"), "fc2": r.lin(f"{pre}.mlp.c_proj")}

    width = np.asarray(sd["visual.class_embedding"]).shape[0]
    vis = {
        "cls": r.t("visual.class_embedding"), "patch_w": r.t("visual.conv1.weight"),
        "patch_b": None, "pos": r.t("visual.positional_embedding"),
        "ln_pre": r.ln("visual.ln_pre"), "ln_post": r.ln("visual.ln_post"),
        "proj": r.t("visual.proj"),
        "blocks": [block(f"visual.transformer.resblocks.{i}", width)
                   for i in range(_count(sd, "visual.transformer.resblocks.", 3))],
    }
    twidth = np.asarray(sd["positional_embedding"]).shape[1]
    txt = {
        "tok": r.t("token_embedding.weight"), "pos": r.t("positional_embedding"),
        "ln_final": r.ln("ln_final"), "proj": r.t("text_projection"),
        "blocks": [block(f"transformer.resblocks.{i}", twidth)
                   for i in range(_count(sd, "transformer.resblocks.", 2))],
    }
    return vis, txt, _logit_scale(sd)


def blip_params_from_torch(sd, device="cuda"):
    """BLIP's state dict (ImageReward's naming, with or without the leading
    'blip.') -> (vit, bert)."""
    if any(k.startswith("blip.") for k in sd):
        sd = {k[5:]: v for k, v in sd.items() if k.startswith("blip.")}
    r = _SD(sd, device)
    width = np.asarray(sd["visual_encoder.cls_token"]).shape[-1]

    def vit_block(pre):
        w = r.t(f"{pre}.attn.qkv.weight")
        b = r.t(f"{pre}.attn.qkv.bias") if f"{pre}.attn.qkv.bias" in sd \
            else torch.zeros(3 * width, device=device)
        q, k, v = ({"w": w[i * width:(i + 1) * width], "b": b[i * width:(i + 1) * width]}
                   for i in range(3))
        return {"ln1": r.ln(f"{pre}.norm1"), "q": q, "k": k, "v": v,
                "o": r.lin(f"{pre}.attn.proj"), "ln2": r.ln(f"{pre}.norm2"),
                "fc1": r.lin(f"{pre}.mlp.fc1"), "fc2": r.lin(f"{pre}.mlp.fc2")}

    vit = {
        "cls": r.t("visual_encoder.cls_token").reshape(-1),
        "patch_w": r.t("visual_encoder.patch_embed.proj.weight"),
        "patch_b": r.t("visual_encoder.patch_embed.proj.bias"),
        "pos": r.t("visual_encoder.pos_embed").reshape(-1, width),
        "ln_pre": None, "ln_post": r.ln("visual_encoder.norm"), "ln_post_all": True,
        "proj": None,
        "blocks": [vit_block(f"visual_encoder.blocks.{i}")
                   for i in range(_count(sd, "visual_encoder.blocks.", 2))],
    }

    def attn(pre):
        return {"q": r.lin(f"{pre}.self.query"), "k": r.lin(f"{pre}.self.key"),
                "v": r.lin(f"{pre}.self.value"), "od": r.lin(f"{pre}.output.dense"),
                "out_ln": r.ln(f"{pre}.output.LayerNorm")}

    bert = {"word": r.t("text_encoder.embeddings.word_embeddings.weight"),
            "pos": r.t("text_encoder.embeddings.position_embeddings.weight"),
            "emb_ln": r.ln("text_encoder.embeddings.LayerNorm"), "layers": []}
    for i in range(_count(sd, "text_encoder.encoder.layer.", 3)):
        pre = f"text_encoder.encoder.layer.{i}"
        layer = {"self": attn(f"{pre}.attention"), "fc1": r.lin(f"{pre}.intermediate.dense"),
                 "fc2": r.lin(f"{pre}.output.dense"), "out_ln": r.ln(f"{pre}.output.LayerNorm")}
        if f"{pre}.crossattention.self.query.weight" in sd:
            layer["cross"] = attn(f"{pre}.crossattention")
        bert["layers"].append(layer)
    return vit, bert


def cross_model_params_from_torch(sd, prefix="cross_model.", device="cuda"):
    """MPS's Cross_model state dict (`layers.{i}.{0,1}.fn.*` under prefix) ->
    forward params; the LayerNorm bias is a loaded buffer."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    r = _SD(sd, device)
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("layers."))
    layers = []
    for i in range(n_layers):
        c, s = f"layers.{i}.0.fn", f"layers.{i}.1.fn"
        to_kv, to_q = r.lin(f"{c}.to_kv"), r.lin(f"{c}.to_q")
        d_head = to_kv["w"].shape[0] // 2
        attn_out = r.lin(f"{s}.attn_out")
        self_p = {"norm": r.ln(f"{s}.norm"), "fused": r.lin(f"{s}.fused_attn_ff_proj"),
                  "attn_out": attn_out, "ff_out": r.lin(f"{s}.ff_out.1"),
                  "heads": attn_out["w"].shape[1] // d_head, "dim_head": d_head}
        if f"{s}.rotary_emb.inv_freq" in sd:
            self_p["inv_freq"] = r.t(f"{s}.rotary_emb.inv_freq")
        layers.append({"cross": {"norm": r.ln(f"{c}.norm"), "to_q": to_q, "to_kv": to_kv,
                                 "to_out": r.lin(f"{c}.to_out"), "ff1": r.lin(f"{c}.ff.0"),
                                 "ff2": r.lin(f"{c}.ff.2"),
                                 "heads": to_q["w"].shape[0] // d_head},
                       "self": self_p})
    return {"layers": layers}


# ---------------------------------------------------------------------------
# preprocessing and the scorers' feature functions
# ---------------------------------------------------------------------------

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def load_image(image) -> np.ndarray:
    """An (H, W, 3) uint8 array from an array, a PIL image or a path
    (`.npy`, else opened with Pillow)."""
    if isinstance(image, (str, bytes)) or hasattr(image, "__fspath__"):
        path = str(image)
        if path.endswith(".npy"):
            return np.load(path)
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    return np.asarray(image)[..., :3]


def clip_preprocess(image, size=224) -> np.ndarray:
    """CLIP's transform: Pillow's bicubic resize of the short side to
    `size`, a centre crop, normalization -> (1, 3, size, size) f32."""
    from ..utils.image_process import resize_uint8

    arr = load_image(image)
    h, w = arr.shape[:2]
    s = size / min(w, h)
    arr = resize_uint8(arr, round(w * s), round(h * s))
    h, w = arr.shape[:2]
    left, top = (w - size) // 2, (h - size) // 2
    x = arr[top:top + size, left:left + size].astype(np.float32) / 255.0
    return ((x - CLIP_MEAN) / CLIP_STD).transpose(2, 0, 1)[None]


def _pixels(image, size, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(clip_preprocess(image, size)).to(like.device)


def make_clip_feature_fns(vision, text, heads_v, heads_t, tokenizer, quick_gelu=False,
                          logit_scale=100.0, size=224):
    """(image_features_fn, text_features_fn, features_fn) over the towers on
    their device; each returns torch tensors there."""

    def image_features_fn(image):
        pooled, _ = clip_vision_forward(vision, _pixels(image, size, vision["cls"]), heads_v,
                                        quick_gelu)
        return pooled

    def text_features_fn(prompt):
        ids = tokenizer(prompt, return_tensors="np", padding="max_length", max_length=77,
                        truncation=True).input_ids
        return clip_text_forward(text, ids, heads_t, quick_gelu)

    def features_fn(image, prompt):
        return image_features_fn(image), text_features_fn(prompt), logit_scale

    return image_features_fn, text_features_fn, features_fn


def make_blip_feature_fn(vit, bert, heads_v, heads_t, tokenizer, size=224):
    """ImageReward's text_features_fn: the BERT's CLS state cross-attending
    BLIP's image tokens."""

    def text_features_fn(image, prompt):
        # BLIP's ViT builds its LayerNorms with eps 1e-6 (timm's default)
        _, image_embeds = clip_vision_forward(vit, _pixels(image, size, vit["cls"]), heads_v,
                                              ln_eps=1e-6)
        tok = tokenizer(prompt, padding="max_length", truncation=True, max_length=35,
                        return_tensors="np")
        out = bert_cross_forward(bert, tok.input_ids, tok.attention_mask, image_embeds, heads_t)
        return out[:, 0, :]

    return text_features_fn


# ---------------------------------------------------------------------------
# seeded random checkpoints in each family's naming
# ---------------------------------------------------------------------------


def _tower_layer(m, pre, width, names):
    """One pre-LN layer: names = (ln1, q, k, v, out, ln2, fc1, fc2) or, for a
    fused in-projection, (ln1, in_proj, out, ln2, fc1, fc2)."""
    if len(names) == 8:
        ln1, q, k, v, out, ln2, fc1, fc2 = names
        m.norm(f"{pre}.{ln1}", width)
        for name in (q, k, v, out):
            m.lin(f"{pre}.{name}", width, width)
    else:
        ln1, in_proj, out, ln2, fc1, fc2 = names
        m.norm(f"{pre}.{ln1}", width)
        m.sd[f"{pre}.{in_proj}_weight"] = m.randn((3 * width, width), width ** -0.5)
        m.sd[f"{pre}.{in_proj}_bias"] = m.randn((3 * width,), 0.02)
        m.lin(f"{pre}.{out}", width, width)
    m.norm(f"{pre}.{ln2}", width)
    m.lin(f"{pre}.{fc1}", 4 * width, width)
    m.lin(f"{pre}.{fc2}", width, 4 * width)


def hf_clip_state_dict(seed=0, device="cpu", dtype=torch.float32, vision_width=1024,
                       vision_layers=24, patch=14, image_size=224, text_width=768, text_layers=12,
                       projection=768, vocab=49408, max_len=77) -> dict:
    """Seeded random transformers CLIPModel weights (CLIP ViT-L/14's widths
    by default)."""
    from ..models.sd import StateDictMaker

    m = StateDictMaker(seed, device, dtype)
    v, t = "vision_model", "text_model"
    m.sd[f"{v}.embeddings.class_embedding"] = m.randn((vision_width,), 0.02)
    m.sd[f"{v}.embeddings.patch_embedding.weight"] = m.randn(
        (vision_width, 3, patch, patch), (3 * patch * patch) ** -0.5)
    m.sd[f"{v}.embeddings.position_embedding.weight"] = m.randn(
        ((image_size // patch) ** 2 + 1, vision_width), 0.02)
    m.norm(f"{v}.pre_layrnorm", vision_width)
    names = ("layer_norm1", "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
             "self_attn.out_proj", "layer_norm2", "mlp.fc1", "mlp.fc2")
    for i in range(vision_layers):
        _tower_layer(m, f"{v}.encoder.layers.{i}", vision_width, names)
    m.norm(f"{v}.post_layernorm", vision_width)
    m.lin("visual_projection", projection, vision_width, bias=False)
    m.sd[f"{t}.embeddings.token_embedding.weight"] = m.randn((vocab, text_width), 0.02)
    m.sd[f"{t}.embeddings.position_embedding.weight"] = m.randn((max_len, text_width), 0.02)
    for i in range(text_layers):
        _tower_layer(m, f"{t}.encoder.layers.{i}", text_width, names)
    m.norm(f"{t}.final_layer_norm", text_width)
    m.lin("text_projection", projection, text_width, bias=False)
    m.sd["logit_scale"] = torch.tensor(float(np.log(100.0)), device=device, dtype=dtype)
    return m.sd


def open_clip_state_dict(seed=0, device="cpu", dtype=torch.float32, vision_width=1280,
                         vision_layers=32, patch=14, image_size=224, text_width=1024,
                         text_layers=24, projection=1024, vocab=49408, max_len=77) -> dict:
    """Seeded random open_clip CLIP weights (ViT-H/14's widths by default)."""
    from ..models.sd import StateDictMaker

    m = StateDictMaker(seed, device, dtype)
    m.sd["visual.class_embedding"] = m.randn((vision_width,), 0.02)
    m.sd["visual.conv1.weight"] = m.randn((vision_width, 3, patch, patch),
                                          (3 * patch * patch) ** -0.5)
    m.sd["visual.positional_embedding"] = m.randn(((image_size // patch) ** 2 + 1,
                                                   vision_width), 0.02)
    m.norm("visual.ln_pre", vision_width)
    names = ("ln_1", "attn.in_proj", "attn.out_proj", "ln_2", "mlp.c_fc", "mlp.c_proj")
    for i in range(vision_layers):
        _tower_layer(m, f"visual.transformer.resblocks.{i}", vision_width, names)
    m.norm("visual.ln_post", vision_width)
    m.sd["visual.proj"] = m.randn((vision_width, projection), vision_width ** -0.5)
    m.sd["token_embedding.weight"] = m.randn((vocab, text_width), 0.02)
    m.sd["positional_embedding"] = m.randn((max_len, text_width), 0.02)
    for i in range(text_layers):
        _tower_layer(m, f"transformer.resblocks.{i}", text_width, names)
    m.norm("ln_final", text_width)
    m.sd["text_projection"] = m.randn((text_width, projection), text_width ** -0.5)
    m.sd["logit_scale"] = torch.tensor(float(np.log(100.0)), device=device, dtype=dtype)
    return m.sd
