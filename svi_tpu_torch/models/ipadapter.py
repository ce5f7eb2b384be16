"""IP-Adapters and the CLIP vision tower they use, port of
svi_tpu/models/ipadapter.py.

The image encoder is a CLIP ViT (ViT-H/14 for the SD and SDXL adapters):
class token, patch convolution, learned positions, non-causal GELU layers,
the pooled class token projected. An adapter projects that embedding to 4
context tokens, and each mapped cross-attention of the UNet gets its own
(to_k_ip, to_v_ip) pair, added as `scale * attention(q, ip_k, ip_v)` by
`sd._attention`. "Instant style" keeps only the SDXL up-blocks' modules.
The encoder's attention is the plain softmax, as the JAX package's
`clip_encoder_scan` computes it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.conv import conv_f32
from .params import ParamTree, dense
from .sd import StateDictMaker, _layer_norm, _Reader, clip_encoder_scan

IPADAPTER_TOKENS = 4

# (unet plan index, transformer id) -> ipadapter module index
SD_IPADAPTER_MAP = {(i, 0): j for j, i in enumerate(
    [1, 4, 9, 12, 17, 20, 40, 43, 46, 50, 53, 56, 60, 63, 66, 29])}
SDXL_IPADAPTER_MAP = {i: j for j, i in enumerate(sum([
    [(7, i) for i in range(2)], [(10, i) for i in range(2)],
    [(15, i) for i in range(10)], [(18, i) for i in range(10)],
    [(25, i) for i in range(10)], [(28, i) for i in range(10)],
    [(31, i) for i in range(10)], [(35, i) for i in range(2)],
    [(38, i) for i in range(2)], [(41, i) for i in range(2)],
    [(21, i) for i in range(10)],
], []))}
# instant style: modules 34..43 only, the up-blocks' attention layers
SDXL_IPADAPTER_MAP_LESS = {k: v for k, v in SDXL_IPADAPTER_MAP.items() if 34 <= v < 44}


def clip_image_encoder_forward(params, pixel_values, num_heads=16, pooled=True):
    """pixel_values (B, 3, 224, 224) -> the projected class-token embedding,
    or with pooled=False every final hidden state (before the post-LN)."""
    w = params["patch_embedding"]
    x = pixel_values.to(w.dtype)
    emb = conv_f32(F.conv2d, x, w, None, w.shape[-1])
    b, d = emb.shape[:2]
    emb = emb.reshape(b, d, -1).transpose(1, 2)
    cls = params["class_embedding"].reshape(1, 1, d).expand(b, 1, d)
    emb = torch.cat([cls, emb], 1) + params["position_embeds"]
    emb = _layer_norm(params["pre_layernorm"], emb)
    emb = clip_encoder_scan(params["encoders"], emb, num_heads=num_heads, quick_gelu=False,
                            causal=False)
    if not pooled:
        return emb
    return dense(params["visual_projection"], _layer_norm(params["post_layernorm"], emb[:, 0]))


def ipadapter_kv(params, image_emb, call_map, scale=1.0, n_tokens=IPADAPTER_TOKENS) -> dict:
    """The pooled image embedding projected to n_tokens tokens, then each
    mapped cross-attention's (ip_k, ip_v): {plan_index: {transformer_id:
    {ip_k, ip_v, scale}}}."""
    tokens = dense(params["image_proj"]["proj"], image_emb)
    tokens = tokens.reshape(-1, n_tokens, tokens.shape[-1] // n_tokens)
    tokens = _layer_norm(params["image_proj"]["norm"], tokens)
    tokens = tokens.reshape(1, -1, tokens.shape[-1])
    out = {}
    for (block_id, tid), mod_id in call_map.items():
        mod = params["adapters"][mod_id]
        out.setdefault(block_id, {})[tid] = {"ip_k": dense(mod["to_k_ip"], tokens),
                                             "ip_v": dense(mod["to_v_ip"], tokens),
                                             "scale": scale}
    return out


def sd_ipadapter_kv(params, image_emb, scale=1.0):
    return ipadapter_kv(params, image_emb, SD_IPADAPTER_MAP, scale)


def sdxl_ipadapter_kv(params, image_emb, scale=1.0, use_instant_style=False):
    return ipadapter_kv(params, image_emb,
                        SDXL_IPADAPTER_MAP_LESS if use_instant_style else SDXL_IPADAPTER_MAP,
                        scale)


# ---------------------------------------------------------------------------
# checkpoints in the reference's diffsynth naming, and seeded ones
# ---------------------------------------------------------------------------


def clip_image_encoder_params_from_torch(sd: dict, device="cuda",
                                         dtype=torch.float32) -> ParamTree:
    r = _Reader(sd, device, dtype)
    layers = []
    while f"encoders.{len(layers)}.layer_norm1.weight" in r:
        e = f"encoders.{len(layers)}"
        layers.append({"layer_norm1": r.norm(f"{e}.layer_norm1"), "attn": r.attn(f"{e}.attn"),
                       "layer_norm2": r.norm(f"{e}.layer_norm2"), "fc1": r.lin(f"{e}.fc1"),
                       "fc2": r.lin(f"{e}.fc2")})
    return ParamTree({
        "class_embedding": r.t("embeddings.class_embedding")[0],
        "patch_embedding": r.t("embeddings.patch_embedding.weight"),
        "position_embeds": r.t("embeddings.position_embeds")[0],
        "pre_layernorm": r.norm("pre_layernorm"),
        "encoders": layers,
        "post_layernorm": r.norm("post_layernorm"),
        "visual_projection": r.lin("visual_projection"),
    })


def ipadapter_params_from_torch(sd: dict, device="cuda", dtype=torch.float32) -> ParamTree:
    r = _Reader(sd, device, dtype)
    mods = []
    while f"ipadapter_modules.{len(mods)}.to_k_ip.weight" in r:
        i = len(mods)
        mods.append({"to_k_ip": r.lin(f"ipadapter_modules.{i}.to_k_ip"),
                     "to_v_ip": r.lin(f"ipadapter_modules.{i}.to_v_ip")})
    return ParamTree({"image_proj": {"proj": r.lin("image_proj.proj"),
                                     "norm": r.norm("image_proj.norm")},
                      "adapters": mods})


def clip_image_encoder_state_dict(seed=0, device="cpu", dtype=torch.float32, dim=1280,
                                  num_layers=32, patch=14, image_size=224,
                                  projection=1024) -> dict:
    """Seeded random CLIP ViT-H/14 image-encoder weights (32 layers of 1280,
    a 1024-wide projection) in the reference's naming."""
    m = StateDictMaker(seed, device, dtype)
    positions = (image_size // patch) ** 2 + 1
    m.sd["embeddings.class_embedding"] = m.randn((1, 1, dim), 0.02)
    m.sd["embeddings.patch_embedding.weight"] = m.randn((dim, 3, patch, patch),
                                                        (3 * patch * patch) ** -0.5)
    m.sd["embeddings.position_embeds"] = m.randn((1, positions, dim), 0.02)
    m.norm("pre_layernorm", dim)
    for i in range(num_layers):
        e = f"encoders.{i}"
        m.norm(f"{e}.layer_norm1", dim)
        m.attn(f"{e}.attn", dim, qkv_bias=True)
        m.norm(f"{e}.layer_norm2", dim)
        m.lin(f"{e}.fc1", 4 * dim, dim)
        m.lin(f"{e}.fc2", dim, 4 * dim)
    m.norm("post_layernorm", dim)
    m.lin("visual_projection", projection, dim, bias=False)
    return m.sd


def sdxl_ipadapter_state_dict(seed=0, device="cpu", dtype=torch.float32, image_dim=1024,
                              text_dim=2048, plan=None) -> dict:
    """Seeded random IP-Adapter SDXL weights: the image projection to 4
    tokens of text_dim and one (to_k_ip, to_v_ip) pair per entry of
    `SDXL_IPADAPTER_MAP` at its block's width (70 at SDXL's plan)."""
    from .sdxl import SDXL_UNET_PLAN

    plan = SDXL_UNET_PLAN if plan is None else plan
    m = StateDictMaker(seed, device, dtype)
    m.lin("image_proj.proj", IPADAPTER_TOKENS * text_dim, image_dim)
    m.norm("image_proj.norm", text_dim)
    for (block_id, _), mod_id in sorted(SDXL_IPADAPTER_MAP.items(), key=lambda kv: kv[1]):
        c = plan[block_id][3]
        m.lin(f"ipadapter_modules.{mod_id}.to_k_ip", c, text_dim, bias=False)
        m.lin(f"ipadapter_modules.{mod_id}.to_v_ip", c, text_dim, bias=False)
    return m.sd
