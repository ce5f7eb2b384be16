"""Kolors in the port (svi_tpu_torch.prompters.sp_tokenizer's BPE model and
ChatGLMSpTokenizer, models.kolors, prompters.kolors_prompter, the Kolors
switch of both SDXL pipelines) against svi_tpu on the CPU.

Both packages load the same seeded state dicts in the reference's names
through their own converters (tests/torch_sd_fixtures.py): ChatGLM with 2
layers 64 wide (4 heads of 16 over 2 key/value groups, FFN 48), a vocabulary
of 65040 so that the vendored tokenizer's special ids fit. The prompter's
encoder call is patched to those widths in both packages (svi_tpu's
prompter fixes ChatGLM3's 32 heads of 128). The pipelines run the narrow
SDXL plans with Kolors' text projection and a 64 + 1536-wide add embedding.

Tolerances: token ids equal; f32 forwards within 1e-4 of the output's
largest magnitude (two f32 implementations, sums in other orders); uint8
frames within one level.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import kolors as jkolors
from svi_tpu.models import motion as jmo
from svi_tpu.models import sd as jsd
from svi_tpu.models import sdxl as jsdxl
from svi_tpu.pipelines import sdxl_image as jimage
from svi_tpu.pipelines import sdxl_video as jvideo
from svi_tpu.prompters import sp_tokenizer as jsp
from svi_tpu.prompters.kolors_prompter import KolorsPrompter as JPrompter
from svi_tpu_torch.models import kolors as tkolors
from svi_tpu_torch.models import motion as tmo
from svi_tpu_torch.models import sd as tsd
from svi_tpu_torch.models import sdxl as tsdxl
from svi_tpu_torch.pipelines import sdxl_image as timage
from svi_tpu_torch.pipelines import sdxl_video as tvideo
from svi_tpu_torch.prompters import sp_tokenizer as tsp
from svi_tpu_torch.prompters.kolors_prompter import KolorsPrompter as TPrompter

import torch_sd_fixtures as fx

F32_REL, LEVELS = 1e-4, 1
GLM, GLM_HIDDEN, GLM_VOCAB = fx.GLM, fx.GLM_HIDDEN, fx.GLM_VOCAB
PROMPTS = [
    "一只可爱的小猫坐在窗台上，阳光明媚",
    "a photo of an astronaut riding a horse on the moon, 4k, highly detailed",
    "赛博朋克风格的城市夜景, neon lights, 8K 超高清",
    "  leading and   repeated   spaces ",
    "emoji 🐱🚀 and rare 㐀 chars",
    "",
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def kolors_sds():
    mp = pytest.MonkeyPatch()
    fx.patch_narrow_xl_plans(mp)
    out = fx.kolors_state_dicts(seed=3)
    mp.undo()
    return out


@pytest.fixture(scope="module")
def glm_sd(kolors_sds):
    return kolors_sds["chatglm"]


@pytest.fixture(scope="module")
def tokenizers():
    return jsp.default_chatglm_tokenizer(), tsp.default_chatglm_tokenizer()


@pytest.mark.parametrize("prompt", PROMPTS)
def test_chatglm_bpe_ids_equal(tokenizers, prompt):
    """The BPE segmentation id for id, the framed batch, and the decode."""
    jt, tt = tokenizers
    assert tt.encode(prompt) == jt.encode(prompt)
    assert tt.special_tokens == jt.special_tokens and tt.pad_id == jt.pad_id
    for a, b in zip(tkolors.kolors_tokenize(prompt, tt, 64),
                    jkolors.kolors_tokenize(prompt, jt, 64)):
        np.testing.assert_array_equal(a, b)
    ids = tt.encode(prompt, bos=True, eos=True)
    assert tt.decode(ids) == jt.decode(ids)


def test_chatglm_encode_causal_and_left_padded(glm_sd):
    """chatglm_encode without a mask (causal) and left-padded with per-row
    position ids: the final state and every hidden state, through both
    loaders (the reference's state dict and params_from_jax)."""
    jp = jkolors.chatglm_params_from_torch(fx.to_numpy(glm_sd))
    tp = tkolors.chatglm_params_from_torch(glm_sd, device="cpu")
    tj = tkolors.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, GLM_VOCAB, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[0, :4] = 0
    pos = np.stack([np.r_[np.zeros(4), np.arange(8)], np.arange(12)]).astype(np.int32)
    for args in ((ids,), (ids, mask, pos)):
        want_f, want_h = jkolors.chatglm_encode(jp, *map(jnp.asarray, args), **GLM)
        for params in (tp, tj):
            got_f, got_h = tkolors.chatglm_encode(params, *map(torch.from_numpy, args), **GLM)
            assert got_h.shape == want_h.shape == (3, 2, 12, GLM_HIDDEN)
            assert fx.rel(got_f, want_f) <= F32_REL and fx.rel(got_h, want_h) <= F32_REL


@pytest.mark.parametrize("clip_skip_2", [1, 2])
def test_kolors_prompter_indexing(glm_sd, tokenizers, clip_skip_2, monkeypatch):
    """KolorsPrompter.encode_prompt: 256 left-padded tokens, the pooled last
    token and the hidden state clip_skip_2 from the end."""
    _patch_glm_widths(monkeypatch)
    jp = jkolors.chatglm_params_from_torch(fx.to_numpy(glm_sd))
    tp = tkolors.chatglm_params_from_torch(glm_sd, device="cpu")
    want = JPrompter(tokenizers[0]).encode_prompt(jp, None, PROMPTS[2], clip_skip_2=clip_skip_2)
    got = TPrompter(tokenizers[1]).encode_prompt(tp, None, PROMPTS[2], clip_skip_2=clip_skip_2)
    assert got[0].shape == want[0].shape == (1, GLM_HIDDEN)
    assert got[1].shape == want[1].shape == (1, 256, GLM_HIDDEN)
    assert fx.rel(got[0], want[0]) <= F32_REL and fx.rel(got[1], want[1]) <= F32_REL


def _patch_glm_widths(monkeypatch):
    for mod in (jkolors, tkolors):
        monkeypatch.setattr(mod, "kolors_encode_prompt",
                            functools.partial(mod.kolors_encode_prompt, **GLM))


_JITTED = {}


@pytest.fixture
def narrow(monkeypatch):
    fx.patch_narrow_xl_plans(monkeypatch)
    fx.jit_jax_blocks(monkeypatch)
    _patch_glm_widths(monkeypatch)
    if not _JITTED:
        _JITTED["glm"] = jax.jit(jkolors.chatglm_encode, static_argnames=tuple(GLM))
    monkeypatch.setattr(jkolors, "chatglm_encode", _JITTED["glm"])


def _models(sds):
    jm = {"unet": jsdxl.sdxl_unet_params_from_torch(fx.to_numpy(sds["unet"])),
          "motion": jmo.motion_params_from_torch(fx.to_numpy(sds["motion"])),
          "vae": jsd.sd_vae_decoder_params_from_torch(fx.to_numpy(sds["vae"])),
          "chatglm": jkolors.chatglm_params_from_torch(fx.to_numpy(sds["chatglm"]))}
    tm = {"unet": tsdxl.sdxl_unet_params_from_torch(sds["unet"], device="cpu"),
          "motion": tmo.motion_params_from_torch(sds["motion"], device="cpu"),
          "vae": tsd.sd_vae_decoder_params_from_torch(sds["vae"], device="cpu"),
          "chatglm": tkolors.chatglm_params_from_torch(sds["chatglm"], device="cpu")}
    return jm, tm


def test_kolors_image_pipeline_matches_jax(kolors_sds, narrow, monkeypatch):
    """SDXLImagePipeline with chatglm_params: Kolors' prompter and DDIM
    (beta_end 0.014, 1100 training timesteps), the UNet's 64 -> 96 text
    projection and 64 + 1536-wide add embedding; 64 x 64, 2 steps, CFG 5 as
    one batch of two: the decoded image before the uint8 cast, the frame."""
    jm, tm = _models(kolors_sds)
    assert "text_intermediate_proj" in tm["unet"]
    assert tm["unet"]["add_time_embedding"]["0"]["w"].shape[1] == GLM_HIDDEN + 6 * 256
    cls = jimage.SDXLImagePipeline
    monkeypatch.setattr(cls, "_cfg_unet_impl", staticmethod(cls._cfg_unet_impl.__wrapped__))
    monkeypatch.setattr(jimage, "jax", SimpleNamespace(jit=lambda f, **kw: f, tree=jax.tree))
    jpipe = cls(jm["unet"], vae_decoder_params=jm["vae"], chatglm_params=jm["chatglm"])
    tpipe = timage.SDXLImagePipeline(tm["unet"], vae_decoder=tm["vae"],
                                     chatglm_params=tm["chatglm"])
    for pipe in (jpipe, tpipe):
        assert type(pipe.prompter).__name__ == "KolorsPrompter"
        assert pipe.scheduler.num_train_timesteps == 1100
    np.testing.assert_allclose(np.asarray(tpipe.scheduler.alphas_cumprod),
                               np.asarray(jpipe.scheduler.alphas_cumprod), rtol=1e-6)
    outs = {}
    for name, pipe in (("jax", jpipe), ("port", tpipe)):
        to_image = pipe.vae_output_to_image
        pipe.vae_output_to_image = lambda out, _n=name, _f=to_image: (
            outs.setdefault(_n, fx.np32(out)), _f(out))[1]
    kw = dict(prompt=PROMPTS[0], negative_prompt="模糊", cfg_scale=5.0, height=64, width=64,
              num_inference_steps=2, seed=3)
    want, got = jpipe(**kw), tpipe(**kw)
    assert fx.rel(outs["port"], outs["jax"]) <= F32_REL
    assert got.shape == (64, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - np.asarray(want, int)).max() <= LEVELS


def test_kolors_video_pipeline_switch_matches_jax(kolors_sds, narrow):
    """SDXLVideoPipeline with chatglm_params: with motion modules the
    AnimateDiff betas (linear), without them Kolors' own schedule, as
    svi_tpu's; 2 frames at 64 x 64 with motion, 1 step, CFG 7.5."""
    jm, tm = _models(kolors_sds)
    bare = tvideo.SDXLVideoPipeline(tm["unet"], chatglm_params=tm["chatglm"])
    jbare = jvideo.SDXLVideoPipeline(jm["unet"], chatglm_params=jm["chatglm"])
    assert bare.scheduler.num_train_timesteps == jbare.scheduler.num_train_timesteps == 1100
    assert type(bare.prompter).__name__ == "KolorsPrompter"
    jpipe = jvideo.SDXLVideoPipeline(jm["unet"], jm["motion"], vae_decoder_params=jm["vae"],
                                     chatglm_params=jm["chatglm"])
    tpipe = tvideo.SDXLVideoPipeline(tm["unet"], tm["motion"], vae_decoder=tm["vae"],
                                     chatglm_params=tm["chatglm"])
    assert tpipe.scheduler.beta_schedule == jpipe.scheduler.beta_schedule == "linear"
    assert tpipe.scheduler.num_train_timesteps == 1000
    lat = {}
    for name, pipe in (("jax", jpipe), ("port", tpipe)):
        decode = pipe.decode_video
        pipe.decode_video = lambda latents, *a, _n=name, _d=decode, **k: (
            lat.setdefault(_n, fx.np32(latents)), _d(latents, *a, **k))[1]
    kw = dict(prompt=PROMPTS[1], negative_prompt="", cfg_scale=7.5, num_frames=2, height=64,
              width=64, num_inference_steps=1, seed=2)
    want, got = jpipe(**kw), tpipe(**kw)
    assert fx.rel(lat["port"], lat["jax"]) <= F32_REL
    assert len(got) == 2 and max(np.abs(g.astype(int) - np.asarray(w, int)).max()
                                 for g, w in zip(got, want)) <= LEVELS
