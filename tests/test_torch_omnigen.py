"""OmniGen in the port (svi_tpu_torch.models.omnigen,
prompters.omnigen_prompter, pipelines.omnigen_image) against svi_tpu on the
CPU.

Both packages load the same seeded state dicts in the reference's names
through their own converters (tests/torch_video_fixtures.py): Phi-3 64 wide,
2 layers of 4 heads in 2 key-value groups with LongRoPE factors for its
16-wide heads (svi_tpu's own OmniGen test's shapes), the 192 x 192 position
table, and the SDXL VAE at the narrow SD plans of tests/torch_sd_fixtures.py;
svi_tpu's pytree is also carried across by `params_from_jax`. The tokenizer
is the caller's in both: a stand-in of fixed ids.

Tolerances: the collator's ids, masks, positions and spans, the crop's
bytes (against Pillow through svi_tpu's `crop_arr`) and the cropped
position table equal; the rotary tables and the sin-cos table within 1e-6;
f32 forwards (text only, with a reference image, through the KV cache)
within 1e-4 of the output's largest magnitude (two f32 implementations,
sums in other orders); the pipelines' decoded image within 1e-4 and its
uint8 pixels within one level.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import omnigen as jog
from svi_tpu.models import sd as jsd
from svi_tpu.pipelines import omnigen_image as jpipe_mod
from svi_tpu.prompters import omnigen_prompter as jprompt
from svi_tpu_torch.models import omnigen as tog
from svi_tpu_torch.models import sd as tsd
from svi_tpu_torch.pipelines import omnigen_image as tpipe_mod
from svi_tpu_torch.prompters import omnigen_prompter as tprompt

import torch_sd_fixtures as fx
import torch_video_fixtures as vfx

TABLE_TOL, F32_REL, LEVELS = 1e-6, 1e-4, 1
ROPE = vfx.OMNIGEN_ROPE
HEADS = dict(num_heads=vfx.OMNIGEN["num_heads"], num_kv_heads=vfx.OMNIGEN["num_kv_heads"])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def sds():
    mp = pytest.MonkeyPatch()
    fx.patch_narrow_plans(mp)
    out = vfx.omnigen_state_dicts(seed=91)
    mp.undo()
    return out


_JITTED = {}


def _jax_forward(params, x, t, ids, lats, sizes, mask, pos, kv_cache=None, return_kv=False):
    return jog.omnigen_forward(params, x, t, ids, lats, sizes, mask, pos, rope_cfg=ROPE,
                               kv_cache=kv_cache, return_kv=return_kv, **HEADS)


@pytest.fixture(scope="module")
def jforward():
    if not _JITTED:
        _JITTED["fwd"] = jax.jit(_jax_forward, static_argnames=("sizes", "return_kv"))
    return _JITTED["fwd"]


@pytest.fixture(scope="module")
def models(sds):
    jp = jog.omnigen_params_from_torch(fx.to_numpy(sds["transformer"]))
    return jp, (tog.omnigen_params_from_torch(sds["transformer"], device="cpu"),
                tog.params_from_jax(jp, device="cpu"))


def _tokenize(text):
    """A tokenizer of fixed ids (a stand-in for Phi-3's): BOS 1, then each
    character's code point mod 40, plus 5."""
    return [1] + [ord(c) % 40 + 5 for c in text]


def _collated(img_hw=None, h=64, w=64):
    """The collator's inputs for a short prompt (with one reference image of
    img_hw pixels: its spliced tokens at 3..)."""
    ids, spans = [1, 5, 6, 7, 8], None
    if img_hw is not None:
        size = img_hw[0] * img_hw[1] // 256
        ids = ids[:3] + [0] * size + ids[3:]
        spans = [[3, 3 + size]]
    mllm = {"input_ids": ids, "pixel_values": [0] if spans else None, "image_sizes": spans}
    padded, pos, mask, _, _, sizes = tprompt.process_mllm_input([mllm], [[h, w]])
    return padded, pos, mask.astype(np.float32), sizes


def _frozen(sizes):
    return tuple(sorted((k, tuple(map(tuple, v))) for k, v in sizes.items()))


def _both(jforward, models, x, t, padded, lats, sizes, mask, pos):
    jp, tps = models
    want, _ = jforward(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(padded),
                       [jnp.asarray(a) for a in lats], _frozen(sizes), jnp.asarray(mask),
                       jnp.asarray(pos))
    with torch.no_grad():
        for tp in tps:
            got, kv = tog.omnigen_forward(
                tp, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(padded),
                [torch.from_numpy(a) for a in lats], sizes, torch.from_numpy(mask),
                torch.from_numpy(pos), rope_cfg=ROPE, **HEADS)
            assert kv is None
            assert got.shape == np.asarray(want).shape == x.shape
            assert fx.rel(fx.np32(got), np.asarray(want)) < F32_REL


def test_forward_text_only_matches_svi_tpu(jforward, models):
    padded, pos, mask, sizes = _collated()
    x = (np.random.default_rng(92).standard_normal((1, 4, 8, 8)) * 0.5).astype(np.float32)
    _both(jforward, models, x, np.array([0.4], np.float32), padded, [], sizes, mask, pos)


def test_forward_with_reference_image_matches_svi_tpu(jforward, models):
    padded, pos, mask, sizes = _collated(img_hw=(64, 64))
    rng = np.random.default_rng(93)
    x = (rng.standard_normal((1, 4, 8, 8)) * 0.5).astype(np.float32)
    lat = (rng.standard_normal((1, 4, 8, 8)) * 0.5).astype(np.float32)
    _both(jforward, models, x, np.array([0.7], np.float32), padded, [lat], sizes, mask, pos)


def test_kv_cache_matches_uncached_and_svi_tpu(jforward, models):
    """The cached suffix forward against the full one (the reference's
    cache semantics), in the port with its own cache and with svi_tpu's, and
    against svi_tpu's cached forward."""
    jp, (tp, _) = models
    padded, pos, mask, sizes = _collated(img_hw=(32, 32))
    rng = np.random.default_rng(94)
    x = (rng.standard_normal((1, 4, 8, 8)) * 0.5).astype(np.float32)
    lat = (rng.standard_normal((1, 4, 4, 4)) * 0.5).astype(np.float32)
    t = np.array([0.5], np.float32)
    n = 8 * 8 // 4 + 1
    jfull, jkv = jforward(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(padded),
                          [jnp.asarray(lat)], _frozen(sizes), jnp.asarray(mask),
                          jnp.asarray(pos), return_kv=True)
    jcached, _ = jforward(jp, jnp.asarray(x), jnp.asarray(t), None, [], (),
                          jnp.asarray(mask[:, -n:, :]), jnp.asarray(pos[:, -n:]), kv_cache=jkv)
    kw = dict(rope_cfg=ROPE, **HEADS)
    with torch.no_grad():
        full, kv = tog.omnigen_forward(tp, torch.from_numpy(x), torch.from_numpy(t),
                                       torch.from_numpy(padded), [torch.from_numpy(lat)], sizes,
                                       torch.from_numpy(mask), torch.from_numpy(pos),
                                       return_kv=True, **kw)
        assert kv[0].shape == (2, 1, padded.shape[1], 2, 16)
        for cache in (kv, tuple(torch.from_numpy(np.array(a)) for a in jkv)):
            cached, none = tog.omnigen_forward(
                tp, torch.from_numpy(x), torch.from_numpy(t), None, [], (),
                torch.from_numpy(mask[:, -n:, :]), torch.from_numpy(pos[:, -n:]),
                kv_cache=cache, **kw)
            assert none is None
            assert fx.rel(fx.np32(cached), fx.np32(full)) < F32_REL
            assert fx.rel(fx.np32(cached), np.asarray(jcached)) < F32_REL
    assert fx.rel(fx.np32(full), np.asarray(jfull)) < F32_REL
    for ours, theirs in zip(kv, jkv):
        assert fx.rel(fx.np32(ours), np.asarray(theirs)) < F32_REL


def test_collator_matches_svi_tpu():
    mllm = [{"input_ids": [1, 5, 6, 0, 0, 0, 7], "pixel_values": [np.zeros((3, 16, 16))],
             "image_sizes": [[3, 6]]},
            {"input_ids": [1, 5], "pixel_values": None, "image_sizes": None}]
    import copy

    ours = tprompt.process_mllm_input(copy.deepcopy(mllm), [[64, 64], [32, 32]])
    theirs = jprompt.process_mllm_input(copy.deepcopy(mllm), [[64, 64], [32, 32]])
    for k in (0, 1, 2):
        np.testing.assert_array_equal(ours[k], theirs[k])
        assert ours[k].dtype == theirs[k].dtype
    assert [p is None for p in ours[3]] == [p is None for p in theirs[3]]
    assert ours[5] == theirs[5]
    assert tprompt.NEGATIVE_PROMPT == jprompt.NEGATIVE_PROMPT
    assert tprompt.add_prefix_instruction("x") == jprompt.add_prefix_instruction("x")


def test_prompter_with_reference_image_matches_svi_tpu():
    """The three branches' ids, masks, positions, spans and pixels for a
    prompt with one reference image (the crop's bytes through Pillow in
    svi_tpu, through numpy in the port)."""
    from PIL import Image

    img = vfx.frames(1, 50, 70, seed=95)[0]
    prompt = "a cat beside <img><|image_1|></img> on a sofa"
    ours = tprompt.OmniGenPrompter(_tokenize)(prompt, [img], height=64, width=64)
    theirs = jprompt.OmniGenPrompter(_tokenize)(prompt, [Image.fromarray(img)], height=64,
                                                width=64)
    assert len(ours["input_ids"]) == 3
    for key in ("input_ids", "attention_mask", "position_ids"):
        for a, b in zip(ours[key], theirs[key]):
            np.testing.assert_array_equal(a, b)
    assert ours["input_image_sizes"] == theirs["input_image_sizes"]
    for a, b in zip(ours["input_pixel_values"], theirs["input_pixel_values"]):
        assert len(a) == len(b)
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("hw,max_size", [((2100, 1300), 512), ((520, 700), 1024),
                                         ((900, 1500), 1024), ((10, 40), 1024)])
def test_crop_arr_matches_pillow(hw, max_size):
    """BOX halving, the bicubic bound, the short side raised to 16 and the
    crop to multiples of 16: the port's numpy against svi_tpu's Pillow."""
    from PIL import Image

    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,), dtype=np.uint8)
    want = jprompt.crop_arr(Image.fromarray(img), max_size)
    got = tprompt.crop_arr(img, max_size)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_position_tables_match_svi_tpu():
    for args, kw in (((64, 16), dict(base_size=8)), ((64, 192), dict(base_size=64))):
        ours, theirs = tog.get_2d_sincos_pos_embed(*args, **kw), jog.get_2d_sincos_pos_embed(
            *args, **kw)
        assert np.abs(ours - theirs).max() <= TABLE_TOL
    table = jog.get_2d_sincos_pos_embed(64, 192, base_size=64).astype(np.float32)
    for h, w in ((64, 64), (128, 96), (8, 8)):
        np.testing.assert_array_equal(
            tog.cropped_pos_embed(torch.from_numpy(table), h, w).numpy(),
            np.asarray(jog.cropped_pos_embed(table, h, w)))
    for seq_len in (None, 100):
        for ours, theirs in zip(tog.longrope_inv_freq(16, seq_len, **dict(ROPE)),
                                jog.longrope_inv_freq(16, seq_len, **dict(ROPE))):
            np.testing.assert_array_equal(ours, theirs)
    pos = np.arange(30)[None]
    inv, scale = jog.longrope_inv_freq(16, **dict(ROPE))
    for ours, theirs in zip(tog.phi3_rope_tables(torch.from_numpy(pos), inv, scale),
                            jog.phi3_rope_tables(jnp.asarray(pos), inv, scale)):
        assert np.abs(ours.numpy() - np.asarray(theirs)).max() <= TABLE_TOL


@pytest.fixture
def narrow(monkeypatch):
    """The narrow SD VAE plans in both packages; svi_tpu's VAE blocks jitted
    once per shape, and its pipeline's forward through the module's jit."""
    fx.patch_narrow_plans(monkeypatch)
    fx.jit_jax_blocks(monkeypatch)
    fwd = _JITTED.get("pipe") or jax.jit(jog.omnigen_forward, static_argnames=(
        "input_image_sizes", "num_heads", "num_kv_heads", "return_kv", "rope_cfg"))
    _JITTED["pipe"] = fwd

    def jit(f, **kw):
        return fwd if f is jog.omnigen_forward else f

    monkeypatch.setattr(jpipe_mod, "jax", types.SimpleNamespace(jit=jit))


def _pipelines(sds, models):
    jp, (tp, _) = models
    jpipe = jpipe_mod.OmnigenImagePipeline(
        jp, jsd.sd_vae_encoder_params_from_torch(fx.to_numpy(sds["vae_encoder"])),
        jsd.sd_vae_decoder_params_from_torch(fx.to_numpy(sds["vae_decoder"])),
        prompter=jprompt.OmniGenPrompter(_tokenize), rope_cfg=ROPE, **HEADS)
    tpipe = tpipe_mod.OmnigenImagePipeline(
        tp, tsd.sd_vae_encoder_params_from_torch(sds["vae_encoder"], device="cpu"),
        tsd.sd_vae_decoder_params_from_torch(sds["vae_decoder"], device="cpu"),
        prompter=tprompt.OmniGenPrompter(_tokenize), rope_cfg=ROPE, **HEADS)
    return jpipe, tpipe


@pytest.mark.parametrize("with_image", [False, True])
def test_pipeline_matches_svi_tpu(narrow, sds, models, with_image):
    """OmnigenImagePipeline at 64 x 64, 2 steps with the KV cache: text only
    (2 branches) and with one 32 x 48 reference image (3 branches,
    image_cfg_scale): the decoded image within F32_REL, the pixels within
    LEVELS."""
    from PIL import Image

    jpipe, tpipe = _pipelines(sds, models)
    decoded = {}
    for name, pipe in (("jax", jpipe), ("torch", tpipe)):
        conv = pipe.vae_output_to_image
        pipe.vae_output_to_image = lambda out, _c=conv, _n=name: (
            decoded.__setitem__(_n, np.asarray(out, np.float32) if _n == "jax"
                                else fx.np32(out)), _c(out))[1]
    img = vfx.frames(1, 32, 48, seed=96)[0]
    prompt = "a cat beside <img><|image_1|></img> on a sofa" if with_image else "a cat"
    kw = dict(height=64, width=64, num_inference_steps=2, seed=3, cfg_scale=2.5,
              image_cfg_scale=1.6)
    want = np.asarray(jpipe(prompt, reference_images=[Image.fromarray(img)] if with_image
                            else [], **kw))
    got = tpipe(prompt, reference_images=[img] if with_image else [], **kw)
    assert fx.rel(decoded["torch"], decoded["jax"]) < F32_REL
    assert got.shape == want.shape == (64, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= LEVELS
