"""StepVideo: the text-to-video DiT and the Step1 LLM text encoder, port of
svi_tpu/models/stepvideo.py.

The DiT (48 blocks 6144 wide, 48 heads of 128 in the published 30B model)
embeds the latents with a 1x1 patch (a channel matmul), conditions every
block PixArt-style on one timestep embedding (adaLN-single: each block adds
its own scale-shift table, in f32), and attends:
- to itself through `ops.attention.flash_attention`, the hand-written kernel
  (bf16 D128 on the card: K1's flat entry, route sm90), after per-head RMS
  norms and the 3-axis RoPE. The rotation is a half-rotation within each of
  the (64, 32, 32) channel splits of a head, computed in f32 and applied in
  torch before the kernel, as the JAX package applies it;
- to the caption tokens ([CLIP projection | LLM projection]) by a plain
  masked softmax with f32 logits, its probabilities cast to q's dtype before
  P.V, on the un-normalized residual stream, as the JAX package computes it
  outside any kernel; masked keys get -inf.
The head modulates each frame with the timestep embedding.

Step1 is a causal decoder with grouped-query attention (the groups' K / V
repeated to the heads), RMSNorm and SwiGLU, no rotary embedding; all plain
torch, as in the JAX package. `step1_tokenize` frames a caller's tokenizer
(BOS 1, EOS 2, pad 2 to 320 tokens).

Weights are `ParamTree`s in PyTorch's layouts, loaded from the reference's
names by `*_params_from_torch(sd, device=, dtype=)` or carried from
svi_tpu's pytrees by `params_from_jax`; `*_state_dict` write seeded ones at
the published widths.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..ops.norms import layer_norm
from .flux import _count
from .params import ParamTree, convert_tree, dense, unstack
from .sd import StateDictMaker, _layer_norm, _Reader, _timesteps, jax_leaf, timestep_embedding
from .sd3 import _rms

STEPVIDEO_ROPE_SPLITS = (64, 32, 32)


def _gelu_tanh(x):
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def prepare_stepvideo_rope(f, h, w, splits=STEPVIDEO_ROPE_SPLITS, base=1e4):
    """cos, sin (F*H*W, sum(splits)) f32 numpy: positions are the (f, h, w)
    grid; each split's table is cat(freqs, freqs), the half-rotation
    layout."""
    pos = [g.reshape(-1) for g in np.meshgrid(
        np.arange(f), np.arange(h), np.arange(w), indexing="ij")]
    parts = []
    for i, d in enumerate(splits):
        inv = 1.0 / (base ** (np.arange(0, d, 2, dtype=np.float32) / d))
        fr = np.outer(pos[i].astype(np.float32), inv)
        parts.append(np.concatenate([fr, fr], axis=-1))
    ang = np.concatenate(parts, axis=-1)
    return np.cos(ang), np.sin(ang)


def _rope_apply(x, cos, sin, splits=STEPVIDEO_ROPE_SPLITS):
    """x (B, S, N, D); cos / sin (S, D) f32 tensors; per split
    x * cos + rotate_half(x) * sin, in f32, cast back."""
    xf = x.float()
    c, s = cos[None, :, None], sin[None, :, None]
    outs, o = [], 0
    for d in splits:
        xs = xf[..., o:o + d]
        rot = torch.cat([-xs[..., d // 2:], xs[..., :d // 2]], dim=-1)
        outs.append(xs * c[..., o:o + d] + rot * s[..., o:o + d])
        o += d
    return torch.cat(outs, dim=-1).to(x.dtype)


def _masked_attention(q, k, v, add_mask):
    """Plain attention under an additive f32 mask (broadcast to (B, N, S,
    Sk)): q (B, S, N, D), k and v (B, Sk, N, D); logits in f32, the
    probabilities cast to q's dtype before P.V."""
    logits = torch.einsum("bsnd,bknd->bnsk", q.float(), k.float()) * (q.shape[-1] ** -0.5)
    probs = torch.softmax(logits + add_mask, dim=-1).to(q.dtype)
    del logits
    return torch.einsum("bnsk,bknd->bsnd", probs, v)


def _stepvideo_block(p, x, ctx, t6, cos, sin, add_mask, num_heads, head_dim):
    b, s, dim = x.shape
    mods = p["scale_shift_table"][None].float() + t6.reshape(-1, 6, dim).float()
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
        m.to(x.dtype) for m in mods.chunk(6, dim=1))

    nx = _layer_norm(p["norm1"], x) * (1 + scale_msa) + shift_msa
    qkv = dense(p["attn1"]["wqkv"], nx).reshape(b, s, num_heads, 3 * head_dim)
    q, k, v = qkv.split(head_dim, dim=-1)
    q = _rope_apply(_rms(q, p["attn1"]["q_norm"]["w"]), cos, sin)
    k = _rope_apply(_rms(k, p["attn1"]["k_norm"]["w"]), cos, sin)
    o = flash_attention(q, k, v).reshape(b, s, dim)
    x = x + gate_msa * dense(p["attn1"]["wo"], o)

    # cross-attention on the un-normalized residual stream
    sk = ctx.shape[1]
    q = dense(p["attn2"]["wq"], x).reshape(b, s, num_heads, head_dim)
    k, v = dense(p["attn2"]["wkv"], ctx).reshape(b, sk, num_heads, 2 * head_dim).split(
        head_dim, dim=-1)
    o = _masked_attention(_rms(q, p["attn2"]["q_norm"]["w"]), _rms(k, p["attn2"]["k_norm"]["w"]),
                          v, add_mask).reshape(b, s, dim)
    x = x + dense(p["attn2"]["wo"], o)

    nx = _layer_norm(p["norm2"], x) * (1 + scale_mlp) + shift_mlp
    h = _gelu_tanh(dense(p["ff"]["0"], nx))
    return x + gate_mlp * dense(p["ff"]["2"], h)


def stepvideo_dit_forward(params, hidden_states, encoder_hidden_states, encoder_attention_mask,
                          timestep, encoder_hidden_states_2=None, rope_tables=None,
                          num_heads=48, head_dim=128):
    """hidden_states (B, F, C, H, W); encoder_hidden_states (B, L, 6144) LLM
    states; encoder_hidden_states_2 (B, Lc, 1024) CLIP states, projected and
    put first; encoder_attention_mask (B, Lc + L), ones over the CLIP part.
    rope_tables: `prepare_stepvideo_rope`'s (cos, sin). Returns
    (B, F, C_out, H, W)."""
    x = hidden_states
    b, f, cin, h, w = x.shape
    dtype, dev = x.dtype, x.device
    dim = num_heads * head_dim

    # the 1x1 patch embedding is a channel matmul
    tok = dense(params["pos_embed"], x.permute(0, 1, 3, 4, 2).reshape(b, f * h * w, cin))

    te = timestep_embedding(_timesteps(timestep, dev) * 1000.0, 256)
    te = dense(params["t_embedder"]["linear_2"],
               F.silu(dense(params["t_embedder"]["linear_1"], te.to(dtype))))
    t6 = dense(params["adaln_linear"], F.silu(te))

    ctx = layer_norm(encoder_hidden_states, eps=1e-6)
    ctx = _gelu_tanh(dense(params["caption_projection"]["linear_1"], ctx))
    ctx = dense(params["caption_projection"]["linear_2"], ctx)
    if encoder_hidden_states_2 is not None:
        clip = dense(params["clip_projection"], encoder_hidden_states_2)
        ctx = torch.cat([clip, ctx], dim=1)

    mask = torch.as_tensor(encoder_attention_mask, device=dev)
    add_mask = torch.zeros(mask.shape, dtype=torch.float32, device=dev).masked_fill(
        mask <= 0, float("-inf"))[:, None, None]

    if rope_tables is None:
        rope_tables = prepare_stepvideo_rope(f, h, w)
    cos, sin = (torch.as_tensor(t, dtype=torch.float32).to(dev) for t in rope_tables)

    for p in params["blocks"]:
        tok = _stepvideo_block(p, tok, ctx, t6, cos, sin, add_mask, num_heads, head_dim)

    # the head: each frame modulated by the embedded timestep
    emb = te.repeat_interleave(f, dim=0)
    mods = params["scale_shift_table"][None].float() + emb[:, None].float()
    shift, scale = (m.to(dtype) for m in mods.chunk(2, dim=1))
    tok = tok.reshape(b * f, h * w, dim)
    tok = dense(params["proj_out"], layer_norm(tok, eps=1e-6) * (1 + scale) + shift)
    cout = tok.shape[-1]
    return tok.reshape(b, f, h, w, cout).permute(0, 1, 4, 2, 3)


def _block_p(r: _Reader, prefix):
    return {
        "scale_shift_table": r.t(f"{prefix}.scale_shift_table"),
        "norm1": r.norm(f"{prefix}.norm1"),
        "norm2": r.norm(f"{prefix}.norm2"),
        "attn1": {"wqkv": r.lin(f"{prefix}.attn1.wqkv"), "wo": r.lin(f"{prefix}.attn1.wo"),
                  "q_norm": {"w": r.t(f"{prefix}.attn1.q_norm.weight")},
                  "k_norm": {"w": r.t(f"{prefix}.attn1.k_norm.weight")}},
        "attn2": {"wq": r.lin(f"{prefix}.attn2.wq"), "wkv": r.lin(f"{prefix}.attn2.wkv"),
                  "wo": r.lin(f"{prefix}.attn2.wo"),
                  "q_norm": {"w": r.t(f"{prefix}.attn2.q_norm.weight")},
                  "k_norm": {"w": r.t(f"{prefix}.attn2.k_norm.weight")}},
        "ff": {"0": r.lin(f"{prefix}.ff.net.0.proj"), "2": r.lin(f"{prefix}.ff.net.2")},
    }


def stepvideo_dit_params_from_torch(sd: dict, device="cuda", dtype=torch.bfloat16) -> ParamTree:
    r = _Reader(sd, device, dtype)
    pw = r.t("pos_embed.proj.weight")  # (D, C, 1, 1)
    tree = {
        "pos_embed": {"w": pw[:, :, 0, 0], "b": r.t("pos_embed.proj.bias")},
        "t_embedder": {"linear_1": r.lin("adaln_single.emb.timestep_embedder.linear_1"),
                       "linear_2": r.lin("adaln_single.emb.timestep_embedder.linear_2")},
        "adaln_linear": r.lin("adaln_single.linear"),
        "caption_projection": {"linear_1": r.lin("caption_projection.linear_1"),
                               "linear_2": r.lin("caption_projection.linear_2")},
        "blocks": [_block_p(r, f"transformer_blocks.{i}")
                   for i in range(_count(r, "transformer_blocks.{}.norm1.weight"))],
        "scale_shift_table": r.t("scale_shift_table"),
        "proj_out": r.lin("proj_out"),
    }
    if "clip_projection.weight" in r:
        tree["clip_projection"] = r.lin("clip_projection")
    return ParamTree(tree)


# ---------------------------------------------------------------------------
# Step1 LLM text encoder
# ---------------------------------------------------------------------------


def _step1_block(p, x, causal_mask, num_heads, num_groups, head_dim, eps):
    b, s, dim = x.shape
    qkv = dense(p["attention"]["wqkv"], _rms(x, p["attention_norm"]["w"], eps))
    q = qkv[..., :dim].reshape(b, s, num_heads, head_dim)
    k, v = qkv[..., dim:].reshape(b, s, num_groups, 2 * head_dim).split(head_dim, dim=-1)
    per = num_heads // num_groups
    if per > 1:
        k = k.repeat_interleave(per, dim=2)
        v = v.repeat_interleave(per, dim=2)
    o = _masked_attention(q, k, v, causal_mask).reshape(b, s, dim)
    x = x + dense(p["attention"]["wo"], o)

    h1, h2 = dense(p["feed_forward"]["w1"], _rms(x, p["ffn_norm"]["w"], eps)).chunk(2, dim=-1)
    h = F.silu(h1.float()).to(x.dtype) * h2
    return x + dense(p["feed_forward"]["w2"], h)


def step1_encode(params, input_ids, num_heads, num_groups, eps=1e-5, dtype=torch.float32):
    """The Step1 decoder: ids (B, S) -> (B, S, dim) hidden states in dtype."""
    emb = params["word_embeddings"]
    ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(input_ids, torch.Tensor)
                          else input_ids).to(emb.device).long()
    x = emb.to(dtype)[ids]
    s = x.shape[1]
    head_dim = x.shape[-1] // num_heads
    pos = torch.arange(s, device=x.device)
    causal = torch.zeros((s, s), dtype=torch.float32, device=x.device).masked_fill(
        pos[:, None] < pos[None, :], float("-inf"))[None, None]
    for p in params["layers"]:
        x = _step1_block(p, x, causal, num_heads, num_groups, head_dim, eps)
    return x


def step1_params_from_torch(sd: dict, device="cuda", dtype=torch.bfloat16) -> ParamTree:
    r = _Reader(sd, device, dtype)

    def layer(i):
        pre = f"transformer.layers.{i}"
        return {"attention_norm": {"w": r.t(f"{pre}.attention_norm.weight")},
                "ffn_norm": {"w": r.t(f"{pre}.ffn_norm.weight")},
                "attention": {"wqkv": r.lin(f"{pre}.attention.wqkv"),
                              "wo": r.lin(f"{pre}.attention.wo")},
                "feed_forward": {"w1": r.lin(f"{pre}.feed_forward.w1"),
                                 "w2": r.lin(f"{pre}.feed_forward.w2")}}

    n = _count(r, "transformer.layers.{}.attention_norm.weight")
    return ParamTree({"word_embeddings": r.t("tok_embeddings.word_embeddings.weight"),
                      "layers": [layer(i) for i in range(n)]})


def step1_tokenize(texts, tokenizer, max_length=320):
    """BOS 1 / EOS 2 / PAD 2 framing padded to max_length, and the mask.
    `tokenizer` is any callable str -> list[int] (a sentencepiece
    processor's encode_as_ids). Returns int32 numpy (ids, mask)."""
    if isinstance(texts, str):
        texts = [texts]
    ids, mask = [], []
    if len(texts) == 0:
        texts = [""]
    for text in texts:
        toks = list(tokenizer(text))[: max_length - 2] if text else []
        toks = [1] + toks + [2]
        valid = len(toks)
        ids.append(toks + [2] * (max_length - valid))
        mask.append([1] * valid + [0] * (max_length - valid))
    return np.asarray(ids, np.int32), np.asarray(mask, np.int32)


# ---------------------------------------------------------------------------
# the JAX package's pytrees
# ---------------------------------------------------------------------------


def params_from_jax(params: dict, dtype=torch.float32, device="cuda") -> ParamTree:
    """svi_tpu's StepVideo DiT or Step1 pytree (blocks / layers stacked for
    its scan) -> a ParamTree."""
    tree = dict(params)
    for key, first in (("blocks", ("norm1", "w")), ("layers", ("attention_norm", "w"))):
        if key in tree:
            leaf = tree[key]
            for k in first:
                leaf = leaf[k]
            tree[key] = unstack(tree[key], int(np.asarray(leaf).shape[0]))
    return ParamTree(convert_tree(tree, dtype, jax_leaf)).to(device)


# ---------------------------------------------------------------------------
# seeded random weights under the reference's names
# ---------------------------------------------------------------------------


def _block_sd(m: StateDictMaker, prefix, dim, head_dim, ff_mult=4):
    """One transformer block's weights (bias-free attention, the FF with
    biases)."""
    m.sd[f"{prefix}.scale_shift_table"] = m.randn((6, dim), dim ** -0.5)
    m.norm(f"{prefix}.norm1", dim)
    m.norm(f"{prefix}.norm2", dim)
    m.lin(f"{prefix}.attn1.wqkv", 3 * dim, dim, bias=False)
    m.lin(f"{prefix}.attn1.wo", dim, dim, bias=False)
    m.lin(f"{prefix}.attn2.wq", dim, dim, bias=False)
    m.lin(f"{prefix}.attn2.wkv", 2 * dim, dim, bias=False)
    m.lin(f"{prefix}.attn2.wo", dim, dim, bias=False)
    for a in ("attn1", "attn2"):
        for n in ("q_norm", "k_norm"):
            m.sd[f"{prefix}.{a}.{n}.weight"] = 1 + m.randn((head_dim,), 0.1)
    m.lin(f"{prefix}.ff.net.0.proj", ff_mult * dim, dim)
    m.lin(f"{prefix}.ff.net.2", dim, ff_mult * dim)


def stepvideo_dit_state_dict(seed=0, device="cpu", dtype=torch.bfloat16, num_heads=48,
                             head_dim=128, num_layers=48, in_channels=64, out_channels=64,
                             caption_channels=6144, clip_channels=1024) -> dict:
    """Seeded random StepVideo DiT weights (the published 30B: 48 blocks of 48
    heads of 128, 64 latent channels, Step1's 6144-wide and the CLIP's
    1024-wide captions), in the reference's names."""
    m = StateDictMaker(seed, device, dtype)
    dim = num_heads * head_dim
    m.sd["pos_embed.proj.weight"] = m.randn((dim, in_channels, 1, 1), in_channels ** -0.5)
    m.sd["pos_embed.proj.bias"] = m.randn((dim,), 0.02)
    m.lin("adaln_single.emb.timestep_embedder.linear_1", dim, 256)
    m.lin("adaln_single.emb.timestep_embedder.linear_2", dim, dim)
    m.lin("adaln_single.linear", 6 * dim, dim)
    m.lin("caption_projection.linear_1", dim, caption_channels)
    m.lin("caption_projection.linear_2", dim, dim)
    m.lin("clip_projection", dim, clip_channels)
    for i in range(num_layers):
        _block_sd(m, f"transformer_blocks.{i}", dim, head_dim)
    m.sd["scale_shift_table"] = m.randn((2, dim), dim ** -0.5)
    m.lin("proj_out", out_channels, dim)
    return m.sd


def step1_state_dict(seed=0, device="cpu", dtype=torch.bfloat16, dim=6144, num_layers=48,
                     num_heads=64, num_groups=8, ffn_dim=16384, vocab=65536) -> dict:
    """Seeded random Step1 weights (the published encoder: 48 layers 6144
    wide, 64 heads in 8 key-value groups, SwiGLU 16384 wide), in the
    reference's names."""
    m = StateDictMaker(seed, device, dtype)
    head_dim = dim // num_heads
    m.sd["tok_embeddings.word_embeddings.weight"] = m.randn((vocab, dim), 0.02)
    for i in range(num_layers):
        pre = f"transformer.layers.{i}"
        m.sd[f"{pre}.attention_norm.weight"] = 1 + m.randn((dim,), 0.1)
        m.sd[f"{pre}.ffn_norm.weight"] = 1 + m.randn((dim,), 0.1)
        m.lin(f"{pre}.attention.wqkv", dim + 2 * num_groups * head_dim, dim, bias=False)
        m.lin(f"{pre}.attention.wo", dim, dim, bias=False)
        m.lin(f"{pre}.feed_forward.w1", 2 * ffn_dim, dim, bias=False)
        m.lin(f"{pre}.feed_forward.w2", dim, ffn_dim, bias=False)
    return m.sd
