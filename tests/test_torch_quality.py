"""The image-quality metrics of the port (svi_tpu_torch.utils.clip_bpe,
extensions.quality_towers, extensions.image_quality) against svi_tpu on the
CPU, on tiny seeded checkpoints in each family's own naming (transformers'
CLIPModel, open_clip, BLIP, MPS's cross model) at the towers' real input
size (224, 32-pixel patches).

Tolerances: token ids equal; CLIP's preprocessing exact (Pillow's bicubic
byte for byte, the same f32 arithmetic); f32 forwards and scores within 1e-4
of the output's largest magnitude (two f32 implementations).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from svi_tpu.extensions import image_quality as jiq
from svi_tpu.extensions import quality_towers as jqt
from svi_tpu.prompters.clip_tokenizer import ClipBpeTokenizer as JClipTok
from svi_tpu.utils.clip_bpe import SimpleTokenizer as JSimple
from svi_tpu_torch.extensions import image_quality as tiq
from svi_tpu_torch.extensions import quality_towers as tqt
from svi_tpu_torch.prompters.clip_tokenizer import ClipBpeTokenizer as TClipTok
from svi_tpu_torch.prompters.clip_tokenizer import _MERGES_PATH
from svi_tpu_torch.utils.clip_bpe import SimpleTokenizer as TSimple

import torch_sd_fixtures as fx

F32_REL = 1e-4
VIS, TXT, PROJ, PATCH, VOCAB = 48, 32, 24, 32, 49408
POSITIONS = (224 // PATCH) ** 2 + 1
PROMPTS = ["a photo of an astronaut riding a horse on mars",
           "A   Photo, of  a CAT!!  (masterpiece:1.2) &amp; 8k &lt;ultra&gt;",
           "she'll've done it, naïve café; 100 years 42x", "",
           "a <start_of_text> spelled out<end_of_text> special", "word " * 120]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


class _Maker:
    """Seeded numpy weights under a checkpoint's names."""

    def __init__(self, seed):
        self.rng, self.sd = np.random.default_rng(seed), {}

    def t(self, name, shape, std=0.05):
        self.sd[name] = (self.rng.standard_normal(shape) * std).astype(np.float32)

    def lin(self, name, out, inp, bias=True):
        self.t(f"{name}.weight", (out, inp), inp ** -0.5)
        if bias:
            self.t(f"{name}.bias", (out,), 0.02)

    def ln(self, name, n):
        self.sd[f"{name}.weight"] = (1 + self.rng.standard_normal(n) * 0.1).astype(np.float32)
        self.t(f"{name}.bias", (n,), 0.02)


def _hf_clip(seed):
    """A transformers CLIPModel checkpoint from the port's seeded writer."""
    return fx.to_numpy(tqt.hf_clip_state_dict(seed, vision_width=VIS, vision_layers=1,
                                              patch=PATCH, text_width=TXT, text_layers=1,
                                              projection=PROJ))


def _open_clip(seed):
    """An open_clip checkpoint from the port's seeded writer."""
    return fx.to_numpy(tqt.open_clip_state_dict(seed, vision_width=VIS, vision_layers=1,
                                                patch=PATCH, text_width=TXT, text_layers=1,
                                                projection=PROJ))


def _blip(seed, hid=64, words=100):
    m = _Maker(seed)
    v = "blip.visual_encoder"
    m.t(f"{v}.cls_token", (1, 1, VIS))
    m.lin(f"{v}.patch_embed.proj", VIS, 3 * PATCH * PATCH)
    m.sd[f"{v}.patch_embed.proj.weight"] = m.sd[f"{v}.patch_embed.proj.weight"].reshape(
        VIS, 3, PATCH, PATCH)
    m.t(f"{v}.pos_embed", (1, POSITIONS, VIS))
    m.ln(f"{v}.blocks.0.norm1", VIS)
    m.lin(f"{v}.blocks.0.attn.qkv", 3 * VIS, VIS)
    m.lin(f"{v}.blocks.0.attn.proj", VIS, VIS)
    m.ln(f"{v}.blocks.0.norm2", VIS)
    m.lin(f"{v}.blocks.0.mlp.fc1", 2 * VIS, VIS)
    m.lin(f"{v}.blocks.0.mlp.fc2", VIS, 2 * VIS)
    m.ln(f"{v}.norm", VIS)
    t = "blip.text_encoder"
    m.t(f"{t}.embeddings.word_embeddings.weight", (words, hid))
    m.t(f"{t}.embeddings.position_embeddings.weight", (40, hid))
    m.ln(f"{t}.embeddings.LayerNorm", hid)
    pre = f"{t}.encoder.layer.0"
    for att, kv in (("attention", hid), ("crossattention", VIS)):
        m.lin(f"{pre}.{att}.self.query", hid, hid)
        m.lin(f"{pre}.{att}.self.key", hid, kv)
        m.lin(f"{pre}.{att}.self.value", hid, kv)
        m.lin(f"{pre}.{att}.output.dense", hid, hid)
        m.ln(f"{pre}.{att}.output.LayerNorm", hid)
    m.lin(f"{pre}.intermediate.dense", 2 * hid, hid)
    m.lin(f"{pre}.output.dense", hid, 2 * hid)
    m.ln(f"{pre}.output.LayerNorm", hid)
    for name, (i, o) in zip(("0", "2", "4", "6", "7"),
                            [(hid, 1024), (1024, 128), (128, 64), (64, 16), (16, 1)]):
        m.lin(f"mlp.layers.{name}", o, i)
    return m.sd


def _cross_model(seed, d=PROJ, heads=3, dh=8, ffi=16):
    m = _Maker(seed)
    c, s = "cross_model.layers.0.0.fn", "cross_model.layers.0.1.fn"
    m.ln(f"{c}.norm", d)
    m.lin(f"{c}.to_q", heads * dh, d, bias=False)
    m.lin(f"{c}.to_kv", 2 * dh, d, bias=False)
    m.lin(f"{c}.to_out", d, heads * dh, bias=False)
    m.lin(f"{c}.ff.0", 2 * ffi, d, bias=False)
    m.lin(f"{c}.ff.2", d, ffi, bias=False)
    m.ln(f"{s}.norm", d)
    m.lin(f"{s}.fused_attn_ff_proj", heads * dh + 2 * dh + 2 * ffi, d, bias=False)
    m.lin(f"{s}.attn_out", d, heads * dh, bias=False)
    m.lin(f"{s}.ff_out.1", d, ffi, bias=False)
    return m.sd


def _image(seed, h=180, w=250):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _ids(tok, prompts):
    return tok(prompts, return_tensors="np", padding="max_length", max_length=77,
               truncation=True).input_ids


# -- the tokenizer and the preprocessing -----------------------------------------------


@pytest.mark.parametrize("context_length", [20, 77])
def test_clip_bpe_token_ids_equal(context_length):
    """open_clip's tokenizer over the port's merges file: HTML entities,
    whitespace, contractions, non-ASCII, the spelled-out specials and a
    truncated long prompt."""
    want = JSimple(_MERGES_PATH)(PROMPTS, context_length=context_length)
    got = TSimple()(PROMPTS, context_length=context_length)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_clip_preprocess_matches_jax(tmp_path):
    """A frame, a PIL image and a .npy path through CLIP's transform."""
    frame = _image(1, 97, 131)
    want = jqt.clip_preprocess(Image.fromarray(frame))
    np.save(tmp_path / "f.npy", frame)
    for src in (frame, Image.fromarray(frame), str(tmp_path / "f.npy")):
        np.testing.assert_array_equal(tqt.clip_preprocess(src), want)


# -- the towers ------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["hf", "open_clip"])
def test_clip_towers_match_jax(family):
    sd = _hf_clip(2) if family == "hf" else _open_clip(3)
    convert = {"hf": (jqt.clip_params_from_hf, tqt.clip_params_from_hf),
               "open_clip": (jqt.clip_params_from_open_clip, tqt.clip_params_from_open_clip)}
    (jv, jt, js), (tv, tt, ts) = convert[family][0](sd), convert[family][1](sd, device="cpu")
    assert ts == pytest.approx(js)
    px = tqt.clip_preprocess(_image(4))
    ids = _ids(TClipTok(), PROMPTS[:3])
    for quick in (False, True):
        jp, jtok = jqt.clip_vision_forward(jv, jnp.asarray(px), 2, quick)
        tp, ttok = tqt.clip_vision_forward(tv, torch.from_numpy(px), 2, quick)
        assert fx.rel(tp, jp) <= F32_REL and fx.rel(ttok, jtok) <= F32_REL
        assert fx.rel(tqt.clip_text_forward(tt, ids, 2, quick),
                      jqt.clip_text_forward(jt, ids, 2, quick)) <= F32_REL
    jx, jpool = jqt.clip_text_token_features(jt, ids, 2)
    tx, tpool = tqt.clip_text_token_features(tt, ids, 2)
    assert fx.rel(tx, jx) <= F32_REL and fx.rel(tpool, jpool) <= F32_REL
    assert fx.rel(tqt.clip_image_token_features(tv, torch.from_numpy(px), 2),
                  jqt.clip_image_token_features(jv, jnp.asarray(px), 2)) <= F32_REL


def test_blip_and_cross_model_match_jax():
    """BLIP's ViT (post-LN on every token, eps 1e-6) into the BERT with
    cross-attention (a padding mask), and MPS's cross model with its rotary
    self-attention under a condition mask."""
    sd = _blip(5)
    (jvit, jbert), (tvit, tbert) = jqt.blip_params_from_torch(sd), tqt.blip_params_from_torch(
        sd, device="cpu")
    px = tqt.clip_preprocess(_image(6))
    _, jimg = jqt.clip_vision_forward(jvit, jnp.asarray(px), 2, ln_eps=1e-6)
    _, timg = tqt.clip_vision_forward(tvit, torch.from_numpy(px), 2, ln_eps=1e-6)
    assert fx.rel(timg, jimg) <= F32_REL
    ids = np.random.default_rng(7).integers(0, 100, (1, 35))
    mask = (np.arange(35) < 20).astype(np.int64)[None]
    assert fx.rel(tqt.bert_cross_forward(tbert, ids, mask, timg, 2),
                  jqt.bert_cross_forward(jbert, ids, mask, jimg, 2)) <= F32_REL
    sd = _cross_model(8)
    jc, tc = jqt.cross_model_params_from_torch(sd), tqt.cross_model_params_from_torch(
        sd, device="cpu")
    rng = np.random.default_rng(9)
    q, ctx = (rng.standard_normal(s).astype(np.float32) for s in ((1, 50, PROJ), (1, 77, PROJ)))
    cmask = np.where(rng.random((1, 50, 77)) > 0.3, 0.0, -np.inf).astype(np.float32)
    cmask[..., 0] = 0.0
    assert fx.rel(tqt.cross_model_forward(tc, torch.from_numpy(q), torch.from_numpy(ctx),
                                          torch.from_numpy(cmask)),
                  jqt.cross_model_forward(jc, q, ctx, cmask)) <= F32_REL


# -- the scores --------------------------------------------------------------------------


def _save(path, sd):
    from svi_tpu_torch.utils.safetensors_io import save_file

    save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, str(path))
    return str(path)


def test_load_preference_model_matches_jax(tmp_path):
    """Aesthetic (a transformers CLIP directory and the MLP head), CLIP and
    HPSv2 (open_clip files and the BPE merges) loaded by both packages'
    load_preference_model from the same files: the scores."""
    head = fx.to_numpy(tiq.score_mlp_state_dict(10, dim=PROJ))
    (tmp_path / "clip-large").mkdir()
    path = {"aesthetic_predictor": _save(tmp_path / "aesthetic.safetensors", head),
            "clip-large": str(tmp_path / "clip-large"),
            "open_clip": _save(tmp_path / "open_clip.safetensors", _open_clip(11)),
            "hpsv2": _save(tmp_path / "hpsv2.safetensors", _open_clip(12)),
            "open_clip_bpe": _MERGES_PATH}
    _save(tmp_path / "clip-large" / "model.safetensors", _hf_clip(13))
    images = [_image(14), _image(15, 224, 300)]
    for name in ("Aesthetic", "CLIP", "HPSv2"):
        jm = jiq.load_preference_model(name, path=path)
        tm = tiq.load_preference_model(name, device="cpu", path=path)
        want = jm.score([Image.fromarray(im) for im in images], PROMPTS[0])
        got = tm.score(images, PROMPTS[0])
        assert len(got) == 2 and fx.rel(got, want) <= F32_REL, name
    with pytest.raises(ValueError):
        tiq.load_preference_model("NotAModel", device="cpu", path=path)
    with pytest.raises(FileNotFoundError):
        tiq.load_preference_model("CLIP", device="cpu")


def test_score_heads_match_jax():
    """PickScore (with and without the softmax), ImageReward's normalized
    head on BLIP's cross-attended features and MPScore's condition-masked
    cross model, each on both packages' towers from the same weights."""
    sd = _hf_clip(16)
    (jv, jt, _), (tv, tt, _) = jqt.clip_params_from_hf(sd), tqt.clip_params_from_hf(
        sd, device="cpu")
    images = [_image(17)]
    # PickScore exponentiates the scale it is given, which the native loaders
    # already exponentiated (ROADMAP.md, known quirks): a small one keeps
    # exp(exp(.)) finite here
    _, _, jfeat = jqt.make_clip_feature_fns(jv, jt, 2, 2, JClipTok(), logit_scale=3.0)
    _, _, tfeat = tqt.make_clip_feature_fns(tv, tt, 2, 2, TClipTok(), logit_scale=3.0)
    for softmax in (False, True):
        want = jiq.PickScore(jfeat).score([Image.fromarray(im) for im in images], PROMPTS[0],
                                          softmax=softmax)
        got = tiq.PickScore(tfeat).score(images, PROMPTS[0], softmax=softmax)
        assert fx.rel(got, want) <= F32_REL

    sd = _blip(18)
    (jvit, jbert), (tvit, tbert) = jqt.blip_params_from_torch(sd), tqt.blip_params_from_torch(
        sd, device="cpu")

    def bert_tok(prompt, **kw):  # BERT's WordPiece is transformers'; fixed ids stand in
        ids = np.random.default_rng(len(prompt)).integers(0, 100, (1, 35))
        return type("T", (), {"input_ids": ids, "attention_mask": (ids > 10).astype(np.int64)})

    jmlp = jiq.score_mlp_params_from_torch({k[4:]: v for k, v in sd.items()
                                            if k.startswith("mlp.")})
    tmlp = tiq.score_mlp_params_from_torch({k[4:]: v for k, v in sd.items()
                                            if k.startswith("mlp.")}, device="cpu")
    want = jiq.ImageRewardScore(jmlp, jqt.make_blip_feature_fn(jvit, jbert, 2, 2, bert_tok)).score(
        [Image.fromarray(im) for im in images], PROMPTS[0])
    got = tiq.ImageRewardScore(tmlp, tqt.make_blip_feature_fn(tvit, tbert, 2, 2, bert_tok)).score(
        images, PROMPTS[0])
    assert fx.rel(got, want) <= F32_REL

    cross = _cross_model(19)
    jc, tc = jqt.cross_model_params_from_torch(cross), tqt.cross_model_params_from_torch(
        cross, device="cpu")
    jtok, ttok = JClipTok(), TClipTok()
    jmps = jiq.MPScore(lambda p: jqt.clip_text_token_features(jt, _ids(jtok, p), 2),
                       lambda im: jqt.clip_image_token_features(
                           jv, jnp.asarray(jqt.clip_preprocess(im)), 2),
                       lambda i, t, m: jqt.cross_model_forward(jc, i, t, m), 2.5)
    tmps = tiq.MPScore(lambda p: tqt.clip_text_token_features(tt, _ids(ttok, p), 2),
                       lambda im: tqt.clip_image_token_features(
                           tv, torch.from_numpy(tqt.clip_preprocess(im)), 2),
                       lambda i, t, m: tqt.cross_model_forward(tc, i, t, m), 2.5)
    want = jmps.score([Image.fromarray(im) for im in images], PROMPTS[1])
    got = tmps.score(images, PROMPTS[1])
    assert fx.rel(got, want) <= F32_REL
