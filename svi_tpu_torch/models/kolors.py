"""Kolors' text encoder, ChatGLM3-6B, port of svi_tpu/models/kolors.py.

A GQA decoder: 32 query heads of kv_channels=128 over 2 key/value groups
(each group serving 16 heads, expanded group-major), the half-head
interleaved rotary embedding indexed by per-sample position ids, RMSNorm,
a SwiGLU MLP, no biases but the fused query-key-value projection. The mask is
causal and lets left-padding queries see every key, as the reference's
`get_masks`. Its attention is the plain f32 softmax, as in the JAX package
(no flash kernel runs here).

`kolors_tokenize` frames the ChatGLM tokenizer's ids ([gMASK] sop, left
padding with <unk>, position ids zero over the pad); `kolors_encode_prompt`
returns the pooled embedding (the last token of the final pre-norm state)
and the hidden state `clip_skip_2` from the end. The Kolors UNet is SDXL's
with `text_intermediate_proj` (models/sdxl.py); its scheduler switch is in
the SDXL pipelines.

Weights are a ParamTree in PyTorch's layouts (linears (out, in)),
loaded by `chatglm_params_from_torch(sd, device=...)` from the reference's
state dict, by `params_from_jax` from svi_tpu's pytree; `chatglm_state_dict`
writes seeded ones under the reference's names.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .params import ParamTree, convert_tree, dense, linear_leaf, unstack
from .sd import StateDictMaker, _Reader


def _rms(p, x, eps=1e-6):
    """RMSNorm: f32 statistics, cast back, times the weight (stepvideo's)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * p["w"].to(x.dtype)


def chatglm_rope_cache(seq_len, kv_channels):
    """cos, sin (S, kv_channels // 4) f32 numpy: kv_channels // 2 rotated
    channels as interleaved pairs (the first half of each head)."""
    n_elem = kv_channels // 2
    theta = 1.0 / (10000.0 ** (np.arange(0, n_elem, 2, dtype=np.float32) / n_elem))
    idx = np.outer(np.arange(seq_len, dtype=np.float32), theta)
    return np.cos(idx), np.sin(idx)


def _apply_rotary(x, cos, sin):
    """Interleaved pairs over the first 2 * cos.shape[-1] channels in f32,
    the rest passed through. x (B, S, N, D); cos / sin (B, S, n)."""
    rot = cos.shape[-1] * 2
    xr, xp = x[..., :rot], x[..., rot:]
    xf = xr.float()
    xe, xo = xf[..., 0::2], xf[..., 1::2]
    c, s = cos[:, :, None].float(), sin[:, :, None].float()
    out = torch.stack([xe * c - xo * s, xo * c + xe * s], dim=-1)
    return torch.cat([out.reshape(xr.shape).to(x.dtype), xp], dim=-1)


def _glm_block(p, x, add_mask, cos, sin, num_heads, num_groups, head_dim, eps):
    """Pre-RMSNorm GQA attention and SwiGLU, each with its residual."""
    b, s, dim = x.shape
    qkv = dense(p["query_key_value"], _rms(p["input_layernorm"], x, eps))
    nq, nkv = num_heads * head_dim, num_groups * head_dim
    q = qkv[..., :nq].reshape(b, s, num_heads, head_dim)
    k = qkv[..., nq:nq + nkv].reshape(b, s, num_groups, head_dim)
    v = qkv[..., nq + nkv:].reshape(b, s, num_groups, head_dim)
    q, k = _apply_rotary(q, cos, sin), _apply_rotary(k, cos, sin)
    per = num_heads // num_groups
    if per > 1:  # group-major: heads [0, per) read group 0
        k = k.repeat_interleave(per, dim=2)
        v = v.repeat_interleave(per, dim=2)
    logits = torch.einsum("bsnd,bknd->bnsk", q.float(), k.float()) * (head_dim ** -0.5)
    probs = torch.softmax(logits + add_mask, dim=-1).to(x.dtype)
    o = torch.einsum("bnsk,bknd->bsnd", probs, v).reshape(b, s, dim)
    x = x + dense(p["dense"], o)
    h1, h2 = dense(p["dense_h_to_4h"], _rms(p["post_attention_layernorm"], x, eps)).chunk(2, -1)
    h = F.silu(h1.float()).to(x.dtype) * h2
    return x + dense(p["dense_4h_to_h"], h)


def chatglm_encode(params, input_ids, attention_mask=None, position_ids=None, num_heads=32,
                   num_groups=2, kv_channels=128, eps=1e-5, dtype=torch.float32):
    """(final_normed (B, S, H), hidden_states (L + 1, B, S, H)): index 0 of
    the stack is the embedding, -1 the last block's output (pre final norm)."""
    dev = params["word_embeddings"].device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    b, s = input_ids.shape
    x = params["word_embeddings"].to(dtype)[input_ids]
    if position_ids is None:
        position_ids = torch.arange(s, device=dev).expand(b, s)
    position_ids = torch.as_tensor(position_ids, device=dev).long()
    # positions are < s in the left-padded layout: an S-long cache covers them
    cos_t, sin_t = chatglm_rope_cache(s, kv_channels)
    cos = torch.from_numpy(cos_t).to(dev)[position_ids]
    sin = torch.from_numpy(sin_t).to(dev)[position_ids]
    causal = torch.arange(s, device=dev)[:, None] >= torch.arange(s, device=dev)[None, :]
    if attention_mask is None:
        attend = causal.expand(b, s, s)
    else:
        pad = torch.as_tensor(attention_mask, device=dev).bool()
        attend = (causal[None] & pad[:, None, :]) | (~pad[:, :, None])
    add_mask = torch.where(attend, 0.0, float("-inf")).float()[:, None]
    hidden = [x]
    for p in params["layers"]:
        x = _glm_block(p, x, add_mask, cos, sin, num_heads, num_groups, kv_channels, eps)
        hidden.append(x)
    return _rms(params["final_layernorm"], x, eps), torch.stack(hidden)


def kolors_encode_prompt(params, input_ids, attention_mask=None, position_ids=None,
                         clip_skip_2=2, **kw):
    """(pooled (B, H), prompt_emb (B, S, H)): the last token of the final
    pre-norm state, and the hidden state clip_skip_2 from the end."""
    _, hs = chatglm_encode(params, input_ids, attention_mask, position_ids, **kw)
    return hs[-1][:, -1], hs[-clip_skip_2]


def kolors_tokenize(texts, tokenizer, max_length=256):
    """[gMASK] sop + the text's ids, cut to max_length, left-padded with the
    tokenizer's pad (<unk>); position ids zero over the pad. Returns (ids,
    mask, positions), int32 numpy (B, max_length)."""
    if isinstance(texts, str):
        texts = [texts]
    gmask, sop = tokenizer.special_tokens["[gMASK]"], tokenizer.special_tokens["sop"]
    ids, mask, pos = [], [], []
    for text in texts:
        toks = ([gmask, sop] + list(tokenizer.encode(text)))[:max_length]
        d = max_length - len(toks)
        ids.append([tokenizer.pad_id] * d + toks)
        mask.append([0] * d + [1] * len(toks))
        pos.append([0] * d + list(range(len(toks))))
    return (np.asarray(ids, np.int32), np.asarray(mask, np.int32),
            np.asarray(pos, np.int32))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def chatglm_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> ParamTree:
    """The reference's ChatGLM state dict (torch tensors or numpy arrays)."""
    r = _Reader(sd, device, dtype)
    layers = []
    while f"encoder.layers.{len(layers)}.input_layernorm.weight" in r:
        pre = f"encoder.layers.{len(layers)}"
        layers.append({
            "input_layernorm": {"w": r.t(f"{pre}.input_layernorm.weight")},
            "post_attention_layernorm": {"w": r.t(f"{pre}.post_attention_layernorm.weight")},
            "query_key_value": r.lin(f"{pre}.self_attention.query_key_value"),
            "dense": r.lin(f"{pre}.self_attention.dense"),
            "dense_h_to_4h": r.lin(f"{pre}.mlp.dense_h_to_4h"),
            "dense_4h_to_h": r.lin(f"{pre}.mlp.dense_4h_to_h"),
        })
    return ParamTree({"word_embeddings": r.t("embedding.word_embeddings.weight"),
                      "layers": layers,
                      "final_layernorm": {"w": r.t("encoder.final_layernorm.weight")}})



def params_from_jax(params: dict, dtype=torch.float32, device="cuda") -> ParamTree:
    """svi_tpu's ChatGLM pytree (layers stacked for its scan) -> ParamTree."""
    tree = dict(params)
    n = int(np.asarray(params["layers"]["input_layernorm"]["w"]).shape[0])
    tree["layers"] = unstack(params["layers"], n)
    return ParamTree(convert_tree(tree, dtype, linear_leaf)).to(device)


def chatglm_state_dict(seed=0, device="cpu", dtype=torch.float32, num_layers=28, hidden=4096,
                       ffn=13696, vocab=65024, num_heads=32, num_groups=2,
                       kv_channels=128) -> dict:
    """Seeded random ChatGLM weights under the reference's names (ChatGLM3-6B's
    widths by default: 6.24B parameters with the output layer, which the
    checkpoint carries and text encoding does not read)."""
    m = StateDictMaker(seed, device, dtype)
    m.sd["embedding.word_embeddings.weight"] = m.randn((vocab, hidden), 0.02)
    qkv = (num_heads + 2 * num_groups) * kv_channels
    for i in range(num_layers):
        pre = f"encoder.layers.{i}"
        m.sd[f"{pre}.input_layernorm.weight"] = 1 + m.randn((hidden,), 0.1)
        m.sd[f"{pre}.post_attention_layernorm.weight"] = 1 + m.randn((hidden,), 0.1)
        m.lin(f"{pre}.self_attention.query_key_value", qkv, hidden)
        m.lin(f"{pre}.self_attention.dense", hidden, num_heads * kv_channels, bias=False)
        m.lin(f"{pre}.mlp.dense_h_to_4h", 2 * ffn, hidden, bias=False)
        m.lin(f"{pre}.mlp.dense_4h_to_h", hidden, ffn, bias=False)
    m.sd["encoder.final_layernorm.weight"] = 1 + m.randn((hidden,), 0.1)
    m.lin("output_layer", vocab, hidden, bias=False)
    return m.sd
