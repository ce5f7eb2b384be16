"""Image quality and preference metrics, port of
svi_tpu/extensions/image_quality.py.

The score heads: AestheticScore (CLIP ViT-L image features into a 5-layer
linear MLP), ImageRewardScore (BLIP's cross-attended text features into the
same MLP, normalized by fixed constants), PickScore (normalized CLIP-H
features, optionally a softmax over logit-scaled scores), CLIPScore and
HPSv2 (open_clip ViT-H normalized feature dot) and MPScore (a
condition-masked cross model), with the model registry
`load_preference_model`.

The default engine ("native") runs the port's own towers
(`extensions/quality_towers.py`) on `device`, the card unless the caller
names the CPU (the JAX package's default device is the host); the CLIP
tokenizers are the port's own (`prompters/clip_tokenizer.py`,
`utils/clip_bpe.py`), ImageReward's BERT WordPiece tokenizer comes from
transformers. engine="torch" keeps the JAX package's meaning: transformers
models as the towers, on the host (it raises without transformers). Nothing
downloads: `path` names local files, the reference's snapshot layout.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from . import quality_towers as qt

# the fixed normalization of the ImageReward head
IMAGE_REWARD_MEAN = 0.16717362830052426
IMAGE_REWARD_STD = 1.0333394966054072

PREFERENCE_MODEL_IDS = ("ImageReward", "Aesthetic", "PickScore", "CLIP", "HPSv2", "HPSv2.1",
                        "MPS")
_MLP_LAYERS = ("0", "2", "4", "6", "7")


def score_mlp_forward(params, x: torch.Tensor) -> torch.Tensor:
    """The 768 -> 1024 -> 128 -> 64 -> 16 -> 1 linear stack of the
    Aesthetic and ImageReward heads (dropouts are eval no-ops, there is no
    activation)."""
    for key in _MLP_LAYERS:
        x = F.linear(x, params[key]["w"], params[key]["b"])
    return x


def score_mlp_params_from_torch(sd: dict, device="cuda") -> dict:
    r = qt._SD(sd, device)
    return {k: r.lin(f"layers.{k}") for k in _MLP_LAYERS}


def score_mlp_state_dict(seed=0, device="cpu", dtype=torch.float32, dim=768) -> dict:
    """Seeded random weights of the score MLP (`layers.{0,2,4,6,7}`)."""
    from ..models.sd import StateDictMaker

    m = StateDictMaker(seed, device, dtype)
    for key, (i, o) in zip(_MLP_LAYERS, [(dim, 1024), (1024, 128), (128, 64), (64, 16),
                                         (16, 1)]):
        m.lin(f"layers.{key}", o, i)
    return m.sd


def _as_tensor(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.as_tensor(np.asarray(x, np.float32),
                           device=None if like is None else like.device)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def _listed(images) -> list:
    return images if isinstance(images, list) else [images]


class AestheticScore:
    """`image_features_fn(image) -> (1, 768)`: CLIP ViT-L's projected image
    features."""

    def __init__(self, mlp_params, image_features_fn):
        self.mlp_params = mlp_params
        self.image_features_fn = image_features_fn

    @torch.no_grad()
    def score(self, images, prompt=""):
        w = self.mlp_params["0"]["w"]
        out = []
        for image in _listed(images):
            emb = _normalize(_as_tensor(self.image_features_fn(image), w).to(w.device))
            out.append(float(score_mlp_forward(self.mlp_params, emb)[0, 0]))
        return out


class ImageRewardScore:
    """`text_features_fn(image, prompt) -> (1, 768)`: BLIP's text encoder CLS
    state cross-attended on the image."""

    def __init__(self, mlp_params, text_features_fn, mean=IMAGE_REWARD_MEAN,
                 std=IMAGE_REWARD_STD):
        self.mlp_params = mlp_params
        self.text_features_fn = text_features_fn
        self.mean, self.std = mean, std

    @torch.no_grad()
    def score(self, images, prompt):
        w = self.mlp_params["0"]["w"]
        out = []
        for image in _listed(images):
            feat = _as_tensor(self.text_features_fn(image, prompt), w).to(w.device)
            r = score_mlp_forward(self.mlp_params, feat)
            out.append(float((r[0, 0] - self.mean) / self.std))
        return out


class PickScore:
    """`features_fn(image, prompt) -> (image (1, D), text (1, D),
    logit_scale)` from a CLIP-H checkpoint."""

    def __init__(self, features_fn):
        self.features_fn = features_fn

    @torch.no_grad()
    def _calculate_score(self, image, prompt, softmax=False):
        img, txt, logit_scale = self.features_fn(image, prompt)
        img = _normalize(_as_tensor(img))
        txt = _normalize(_as_tensor(txt, img).to(img.device))
        s = (txt @ img.T)[0]
        if softmax:
            s = torch.softmax(float(np.exp(logit_scale)) * s, dim=-1)
        return float(s[0])

    def score(self, images, prompt, softmax=False):
        return [self._calculate_score(im, prompt, softmax) for im in _listed(images)]


class CLIPScore:
    """The diagonal of image @ text^T over features the encoder already
    normalized. `encode_fn(image, prompt) -> (image_f, text_f)`."""

    def __init__(self, encode_fn):
        self.encode_fn = encode_fn

    @torch.no_grad()
    def _calculate_score(self, image, prompt):
        img, txt = self.encode_fn(image, prompt)
        img = _as_tensor(img)
        return float(torch.diagonal(img @ _as_tensor(txt, img).to(img.device).T)[0])

    def score(self, images, prompt):
        return [self._calculate_score(im, prompt) for im in _listed(images)]


HPScore_v2 = CLIPScore  # the same scoring math, the HPS checkpoint

MPS_CONDITIONS = {
    "overall": "light, color, clarity, tone, style, ambiance, artistry, "
               "shape, face, hair, hands, limbs, structure, instance, "
               "texture, quantity, attributes, position, number, location, "
               "word, things",
    "aesthetics": "light, color, clarity, tone, style, ambiance, artistry",
    "quality": "shape, face, hair, hands, limbs, structure, instance, "
               "texture",
    "semantic": "quantity, attributes, position, number, location",
}


def mps_condition_mask(text_f, condition_f, threshold=0.3) -> torch.Tensor:
    """Token-level text / condition similarity -> an additive -inf mask
    where below `threshold` of the max. text_f (B, S, D), condition_f
    (B, Sc, D) -> (B, 1, S) f32."""
    text_f = _as_tensor(text_f)
    sim = torch.einsum("bid,bjd->bji", text_f, _as_tensor(condition_f, text_f).to(text_f.device))
    sim = sim.amax(dim=1, keepdim=True)
    sim = sim / sim.max()
    return torch.where(sim > threshold, 0.0, float("-inf")).float()


class MPScore:
    """`text_features_fn(prompt) -> (token_states, pooled)`,
    `image_features_fn(image) -> token_states`, `cross_fn(image_f, text_f,
    mask) -> (B, S, D)` and the raw `logit_scale` parameter."""

    def __init__(self, text_features_fn, image_features_fn, cross_fn, logit_scale,
                 condition="overall"):
        self.text_features_fn = text_features_fn
        self.image_features_fn = image_features_fn
        self.cross_fn = cross_fn
        self.logit_scale = logit_scale
        self.condition_prompt = MPS_CONDITIONS[condition]

    @torch.no_grad()
    def _calculate_score(self, image, prompt):
        text_f, text_features = self.text_features_fn(prompt)
        image_f = _as_tensor(self.image_features_fn(image))
        condition_f, _ = self.text_features_fn(self.condition_prompt)
        mask = mps_condition_mask(text_f, condition_f).to(image_f.device)
        mask = mask.repeat_interleave(image_f.shape[1], dim=1)
        image_features = _normalize(_as_tensor(self.cross_fn(image_f, text_f, mask))[:, 0, :])
        text_features = _normalize(_as_tensor(text_features).to(image_features.device))
        s = float(np.exp(self.logit_scale)) * text_features @ image_features.T
        return float(s[0, 0])

    def score(self, images, prompt):
        return [self._calculate_score(im, prompt) for im in _listed(images)]


def _load_state_dict_any(p) -> dict:
    """A state dict (f32 tensors on the host) from a .safetensors file, a
    torch .pt / .bin file, or a model directory holding one of them."""
    from ..utils.safetensors_io import load_file

    if os.path.isdir(p):
        for name in ("model.safetensors", "open_clip_pytorch_model.bin", "pytorch_model.bin",
                     "pytorch_model.pt"):
            if os.path.exists(os.path.join(p, name)):
                p = os.path.join(p, name)
                break
        else:
            raise FileNotFoundError(f"no model weights found in {p}")
    if p.endswith(".safetensors"):
        sd = load_file(p)
    else:
        sd = torch.load(p, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    return {k: v.float() for k, v in sd.items()}


# transformer width -> heads of the CLIP-family towers these metrics ship
# (ViT-B / L / H vision and their text towers); the head width is not
# uniform across them (ViT-H vision has 80), so width // 64 would be wrong
_WIDTH_TO_HEADS = {512: 8, 640: 10, 768: 12, 896: 14, 1024: 16, 1280: 16}


def _heads_of(width: int) -> int:
    return _WIDTH_TO_HEADS.get(int(width), max(1, int(width) // 64))


def _heads(sd, key) -> int:
    return _heads_of(np.asarray(sd[key]).shape[-1])


def _transformers_features(model_dir, processor_dir, text=False):
    """engine="torch": transformers' CLIPModel on the host."""
    from transformers import AutoModel, AutoProcessor

    clip = AutoModel.from_pretrained(model_dir).eval()
    proc = AutoProcessor.from_pretrained(processor_dir)

    @torch.no_grad()
    def image_features_fn(image):
        px = proc(images=image, return_tensors="pt").pixel_values
        return clip.get_image_features(pixel_values=px)

    @torch.no_grad()
    def features_fn(image, prompt):
        tx = proc(text=prompt, padding=True, truncation=True, max_length=77,
                  return_tensors="pt")
        return image_features_fn(image), clip.get_text_features(**tx), float(clip.logit_scale)

    return features_fn if text else image_features_fn


def load_preference_model(model_name, device="cuda", path=None, engine="native"):
    """A scorer for one of PREFERENCE_MODEL_IDS. `path`: the reference
    snapshot's load_path dict resolved to local files. engine "native"
    (default) runs the port's towers on `device`; "torch" transformers'
    models on the host."""
    if model_name not in PREFERENCE_MODEL_IDS:
        raise ValueError(f"unknown preference model {model_name!r}; expected one of "
                         f"{PREFERENCE_MODEL_IDS}")
    if engine not in ("native", "torch"):
        raise ValueError(f"engine={engine!r}; choose 'native' or 'torch'")
    if path is None:
        raise FileNotFoundError(
            f"no local checkpoint paths for {model_name!r}: nothing is downloaded; pass the "
            "reference's snapshot layout as a load_path dict")
    from ..prompters.clip_tokenizer import ClipBpeTokenizer

    if model_name == "Aesthetic":
        mlp = score_mlp_params_from_torch(_load_state_dict_any(path["aesthetic_predictor"]),
                                          device)
        if engine == "torch":
            return AestheticScore(mlp, _transformers_features(path["clip-large"],
                                                              path["clip-large"]))
        sd = _load_state_dict_any(path["clip-large"])
        vis, txt, scale = qt.clip_params_from_hf(sd, device)
        image_features_fn, _, _ = qt.make_clip_feature_fns(
            vis, txt, _heads(sd, "vision_model.embeddings.class_embedding"),
            _heads_of(txt["tok"].shape[1]), None, quick_gelu=True, logit_scale=scale)
        return AestheticScore(mlp, image_features_fn)

    if model_name == "PickScore":
        if engine == "torch":
            return PickScore(_transformers_features(path["pickscore"], path["clip"], text=True))
        sd = _load_state_dict_any(path["pickscore"])
        vis, txt, scale = qt.clip_params_from_hf(sd, device)
        # PickScore is CLIP-H: plain GELU
        _, _, features_fn = qt.make_clip_feature_fns(
            vis, txt, _heads(sd, "vision_model.embeddings.class_embedding"),
            _heads(sd, "text_model.embeddings.token_embedding.weight"), ClipBpeTokenizer(),
            quick_gelu=False, logit_scale=scale)
        return PickScore(features_fn)

    if model_name in ("CLIP", "HPSv2", "HPSv2.1"):
        from ..utils.clip_bpe import SimpleTokenizer

        key = {"CLIP": "open_clip", "HPSv2": "hpsv2", "HPSv2.1": "hpsv2.1"}[model_name]
        sd = _load_state_dict_any(path[key])
        vis, txt, _ = qt.clip_params_from_open_clip(sd, device)
        tok = SimpleTokenizer(path.get("open_clip_bpe"))
        hv, ht = _heads(sd, "visual.class_embedding"), _heads(sd, "positional_embedding")

        @torch.no_grad()
        def encode_fn(image, prompt):
            img_f, _ = qt.clip_vision_forward(vis, qt._pixels(image, 224, vis["cls"]), hv)
            txt_f = qt.clip_text_forward(txt, tok([prompt]), ht)
            return _normalize(img_f), _normalize(txt_f)

        return CLIPScore(encode_fn)

    if model_name == "ImageReward":
        from transformers import AutoTokenizer  # BERT's WordPiece

        sd = _load_state_dict_any(path["imagereward"])
        mlp = score_mlp_params_from_torch(
            {k[4:]: v for k, v in sd.items() if k.startswith("mlp.")}, device)
        vit, bert = qt.blip_params_from_torch(sd, device)
        tok = AutoTokenizer.from_pretrained(path["bert_model_path"])
        text_features_fn = qt.make_blip_feature_fn(
            vit, bert, _heads(sd, next(k for k in sd if k.endswith("cls_token"))),
            _heads_of(bert["word"].shape[1]), tok)
        return ImageRewardScore(mlp, text_features_fn)

    # MPS: one file holding transformers' CLIPModel under `model.` (CLIP-H,
    # plain GELU) and the cross model under `cross_model.`, scored on
    # token-level projected features
    sd = _load_state_dict_any(path["mps"])
    clip_sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    vis, txt, _ = qt.clip_params_from_hf(clip_sd, device)
    scale = float(np.asarray(clip_sd["logit_scale"]))  # MPScore exponentiates the raw one
    cross = qt.cross_model_params_from_torch(sd, device=device)
    hv = _heads(clip_sd, "vision_model.embeddings.class_embedding")
    ht = _heads_of(txt["tok"].shape[1])
    tok = ClipBpeTokenizer()

    @torch.no_grad()
    def text_features_fn(prompt):
        ids = tok(prompt, max_length=77, padding="max_length", truncation=True,
                  return_tensors="np").input_ids
        return qt.clip_text_token_features(txt, ids, ht)

    @torch.no_grad()
    def image_features_fn(image):
        return qt.clip_image_token_features(vis, qt._pixels(image, 224, vis["cls"]), hv)

    @torch.no_grad()
    def cross_fn(image_f, text_f, mask):
        return qt.cross_model_forward(cross, image_f, text_f, mask)

    return MPScore(text_features_fn, image_features_fn, cross_fn, scale)
