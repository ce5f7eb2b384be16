"""HunyuanVideo in the port (svi_tpu_torch.models.hunyuan_video,
prompters.hunyuan_video_prompter, pipelines.hunyuan_video) against svi_tpu
on the CPU.

Both packages load the same seeded state dicts in the reference's diffsynth
names through their own converters (tests/torch_video_fixtures.py): a DiT
192 wide (svi_tpu fixes its 24 heads, so 24 heads of 8 with RoPE axes
(2, 2, 4) given to both) with 2 double and 2 single blocks, a one-block
token refiner over 256 LLM states 32 wide, the causal VAE at a quarter of
its channels, CLIP-L's text tower at its 768 width with one layer; svi_tpu's
pytrees are also carried across by `params_from_jax`. The LLM and its
tokenizer are the caller's in both packages: here a seeded embedding table
and a tokenizer of fixed ids, the same for both.

Tolerances: the rotary tables and the prompter's crops equal; f32 forwards
within 1e-4 of the output's largest magnitude (two f32 implementations, sums
in other orders); the frame-causal attention computed per query frame
within 1e-6 of the masked whole (the same f32 rows, the softmax's sums over
fewer -inf terms); the pipeline's uint8 frames within one level.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import hunyuan_video as jhv
from svi_tpu.models import sd as jsd
from svi_tpu.pipelines import hunyuan_video as jpipe_mod
from svi_tpu.prompters import hunyuan_video_prompter as jprompt
from svi_tpu_torch.models import hunyuan_video as thv
from svi_tpu_torch.models import sd as tsd
from svi_tpu_torch.pipelines import hunyuan_video as tpipe_mod
from svi_tpu_torch.prompters import hunyuan_video_prompter as tprompt

import torch_sd_fixtures as fx
import torch_video_fixtures as vfx

F32_REL, CAUSAL_REL, LEVELS = 1e-4, 1e-6, 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


_JITTED = {}


def _jax_dit_impl(params, latents, timestep, emb, mask, pooled, guidance, cos, sin):
    return jhv.hunyuan_video_dit_forward(params, latents, timestep, emb, mask, pooled,
                                         guidance=guidance, freqs=(cos, sin))


@pytest.fixture
def narrow(monkeypatch):
    """The narrow RoPE axes in both packages; svi_tpu's blocks jitted once
    per shape, its pipeline's whole-DiT jit off."""
    for mod in (jhv, thv):
        monkeypatch.setattr(mod, "prepare_rope_tables", functools.partial(
            mod.prepare_rope_tables, rope_dims=vfx.HYV_ROPE_DIMS))
    if not _JITTED:
        _JITTED.update(
            dit=jax.jit(_jax_dit_impl), res=jax.jit(jhv._res3d), mid=jax.jit(jhv._mid_attention),
            up=jax.jit(jhv._upsample, static_argnames=("factor",)),
            conv=jax.jit(jhv._causal_conv3d, static_argnames=("stride",)))
    for name, key in (("_res3d", "res"), ("_mid_attention", "mid"), ("_upsample", "up"),
                      ("_causal_conv3d", "conv")):
        monkeypatch.setattr(jhv, name, _JITTED[key])
    # one jit of the DiT for the forward test and the pipeline's steps (the
    # pipeline's own is the same function, compiled anew per test module)
    monkeypatch.setattr(jpipe_mod.HunyuanVideoPipeline, "_dit_impl",
                        staticmethod(_JITTED["dit"]))


@pytest.fixture(scope="module")
def sds():
    return vfx.hunyuan_video_state_dicts(seed=61)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((1, 256), np.int64)
    mask[:, 100:] = 0
    return dict(x=(rng.standard_normal((1, 16, 3, 8, 12)) * 0.5).astype(np.float32),
                t=np.array([700.0], np.float32),
                emb=(rng.standard_normal((1, 256, 32)) * 0.1).astype(np.float32), mask=mask,
                pooled=(rng.standard_normal((1, 768)) * 0.1).astype(np.float32),
                guidance=np.array([6.0], np.float32))


def test_rope_tables_match_svi_tpu():
    for args in ((3, 4, 6), (33, 45, 80)):
        for ours, theirs in zip(thv.prepare_rope_tables(*args), jhv.prepare_rope_tables(*args)):
            np.testing.assert_array_equal(ours, theirs)


def test_dit_forward_matches_svi_tpu(narrow, sds):
    jdit = jhv.hunyuan_video_dit_params_from_torch(fx.to_numpy(sds["dit"]))
    x = _inputs(62)
    freqs = jhv.prepare_rope_tables(3, 4, 6)
    args = [x[k] for k in ("x", "t", "emb", "mask", "pooled")]
    want = np.asarray(_JITTED["dit"](jdit, *map(jnp.asarray, args), jnp.asarray(x["guidance"]),
                                     *freqs))
    with torch.no_grad():
        for dit in (thv.hunyuan_video_dit_params_from_torch(sds["dit"], device="cpu",
                                                            dtype=torch.float32),
                    thv.params_from_jax(jdit, device="cpu")):
            got = thv.hunyuan_video_dit_forward(dit, *map(torch.from_numpy, args),
                                                guidance=torch.from_numpy(x["guidance"]),
                                                freqs=freqs)
            assert got.shape == want.shape == (1, 16, 3, 8, 12)
            assert fx.rel(fx.np32(got), want) < F32_REL


def test_vae_roundtrip_matches_svi_tpu(narrow, sds):
    """Encode a 9-frame 64 x 96 clip (3 latent frames: the pipeline test's
    latent shape), decode the latents."""
    je = jhv.hunyuan_video_vae_encoder_params_from_torch(fx.to_numpy(sds["vae_encoder"]))
    jd = jhv.hunyuan_video_vae_decoder_params_from_torch(fx.to_numpy(sds["vae_decoder"]))
    video = np.random.default_rng(63).uniform(-1, 1, (1, 3, 9, 64, 96)).astype(np.float32)
    want_lat = np.asarray(jhv.hunyuan_video_vae_encode(je, jnp.asarray(video)))
    want = np.asarray(jhv.hunyuan_video_vae_decode(jd, jnp.asarray(want_lat)))
    with torch.no_grad():
        for enc, dec in ((thv.hunyuan_video_vae_encoder_params_from_torch(sds["vae_encoder"],
                                                                          device="cpu"),
                          thv.hunyuan_video_vae_decoder_params_from_torch(sds["vae_decoder"],
                                                                          device="cpu")),
                         (thv.params_from_jax(je, device="cpu"),
                          thv.params_from_jax(jd, device="cpu"))):
            lat = thv.hunyuan_video_vae_encode(enc, torch.from_numpy(video))
            assert lat.shape == want_lat.shape == (1, 16, 3, 8, 12)
            assert fx.rel(fx.np32(lat), want_lat) < F32_REL
            got = thv.hunyuan_video_vae_decode(dec, torch.from_numpy(want_lat))
            assert got.shape == want.shape == (1, 3, 9, 64, 96)
            assert fx.rel(fx.np32(got), want) < F32_REL


def test_frame_causal_attention_per_frame_equals_the_masked_whole(sds):
    """The mid-block attention one query frame at a time (the port) against
    the whole (T*H*W)^2 masked softmax (svi_tpu's formulation, here in
    torch) and against svi_tpu's own."""
    dec = thv.hunyuan_video_vae_decoder_params_from_torch(sds["vae_decoder"], device="cpu")
    p = dec["decoder"]["mid"]["attn"]
    c = vfx.HYV_VAE_CHANNELS[-1]
    x = torch.from_numpy(np.random.default_rng(64).standard_normal((1, c, 4, 3, 5))
                         .astype(np.float32))
    with torch.no_grad():
        got = thv._mid_attention(p, x)
        b, _, t, h, w = x.shape
        y = thv._gn3d(p["group_norm"], x).flatten(2).transpose(1, 2)
        q, k, v = (tsd.dense(p[n], y) for n in ("to_q", "to_k", "to_v"))
        frame = torch.arange(t * h * w) // (h * w)
        logits = (q @ k.transpose(1, 2)) * c ** -0.5
        logits = logits.masked_fill(frame[:, None] < frame[None, :], float("-inf"))
        whole = x + tsd.dense(p["to_out"], torch.softmax(logits, -1) @ v).transpose(1, 2) \
            .reshape(x.shape)
    assert fx.rel(fx.np32(got), fx.np32(whole)) < CAUSAL_REL
    jp = jhv.hunyuan_video_vae_decoder_params_from_torch(
        fx.to_numpy(sds["vae_decoder"]))["decoder"]["mid"]["attn"]
    want = np.asarray(jhv._mid_attention(jp, jnp.asarray(x.numpy().transpose(0, 2, 3, 4, 1))))
    assert fx.rel(fx.np32(got), want.transpose(0, 4, 1, 2, 3)) < F32_REL


class _Tokenizer:
    """A tokenizer of fixed ids (a stand-in for the LLM's): the prompt's
    characters' code points mod 1000, padded with 0 (mask 0)."""

    def __call__(self, prompt, return_tensors=None, padding=None, max_length=None,
                 truncation=None):
        ids = [ord(ch) % 1000 + 1 for ch in prompt][:max_length]
        mask = [1] * len(ids) + [0] * (max_length - len(ids))
        return types.SimpleNamespace(input_ids=np.asarray([ids + [0] * (max_length - len(ids))]),
                                     attention_mask=np.asarray([mask]))


class _ClipTokenizer:
    """The CLIP BPE ids of each package with a mask through the first end token."""

    def __init__(self, tok):
        self.tok = tok

    def __call__(self, text, return_attention_mask=False, **kw):
        ids = self.tok(text, **kw).input_ids
        first = (ids == self.tok.eos_token_id).argmax(1)
        return types.SimpleNamespace(input_ids=ids, attention_mask=(
            np.arange(ids.shape[1])[None] <= first[:, None]).astype(np.int64))


def _llm(dim=32):
    table = np.random.default_rng(65).standard_normal((1001, dim)).astype(np.float32) * 0.1

    def llm_forward(input_ids, attention_mask, hidden_state_skip_layer, pixel_values=None):
        return table[input_ids] * (1.0 + hidden_state_skip_layer)

    return llm_forward


def _prompters(sds):
    from svi_tpu.prompters.clip_tokenizer import ClipBpeTokenizer as JTok
    from svi_tpu_torch.prompters.clip_tokenizer import ClipBpeTokenizer as TTok

    llm = _llm()
    jp = jprompt.HunyuanVideoPrompter(_ClipTokenizer(JTok()), _Tokenizer(),
                                      jsd.sd_text_encoder_params_from_torch(
                                          fx.to_numpy(sds["clip"])), llm)
    tp = tprompt.HunyuanVideoPrompter(_ClipTokenizer(TTok()), _Tokenizer(),
                                      tsd.sd_text_encoder_params_from_torch(sds["clip"],
                                                                            device="cpu"), llm)
    return jp, tp


def test_prompter_matches_svi_tpu(sds):
    """The templates, the CLIP pooled branch, the LLM crop (video and image
    templates, the negative default) and the image-to-video crop."""
    assert tprompt.PROMPT_TEMPLATE == jprompt.PROMPT_TEMPLATE
    assert tprompt.NEGATIVE_PROMPT == jprompt.NEGATIVE_PROMPT
    jp, tp = _prompters(sds)
    for kw in (dict(prompt="a red fox running through snow"),
               dict(prompt="a red fox", data_type="image"),
               dict(prompt="", positive=False)):
        (je, jpool, jm), (te, tpool, tm) = jp.encode_prompt(**kw), tp.encode_prompt(**kw)
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(tm, jm)
        assert fx.rel(fx.np32(tpool), np.asarray(jpool)) < F32_REL
    tp.enable_i2v()
    jp.enable_i2v()
    assert tp.prompt_template_video == jp.prompt_template_video
    rng = np.random.default_rng(66)
    ids = rng.integers(300, 900, (2, 700))
    ids[0, [10, 40, 300, 650]] = 271
    ids[1, [12, 50, 400]] = 271  # an over-long prompt: its last marker cut off
    mask = np.ones_like(ids)
    mask[:, 690:] = 0
    hidden = rng.standard_normal((2, 700 + 575, 8)).astype(np.float32)
    for crop in (103, 36):
        for a, b in zip(tp.crop_mllm_states(ids[:1], mask[:1], hidden[:1], crop),
                        jp.crop_mllm_states(ids[:1], mask[:1], hidden[:1], crop)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tp.crop_mllm_states(ids[1:], mask[1:], hidden[1:], 103),
                    jp.crop_mllm_states(ids[1:], mask[1:], hidden[1:], 103)):
        np.testing.assert_array_equal(a, b)


def test_pipeline_matches_svi_tpu(narrow, sds):
    """HunyuanVideoPipeline, 9 frames at 64 x 96, 2 steps, embedded guidance
    6 and true CFG 2, the prompts through each package's prompter: the
    decoded video within F32_REL and the frames within LEVELS."""
    jp, tp = _prompters(sds)

    def encoder(prompter):
        return lambda prompt: (lambda e, pooled, m: (e, m, pooled))(
            *prompter.encode_prompt(prompt))

    kw = dict(negative_prompt="blurry", cfg_scale=2.0, height=64, width=96, num_frames=9,
              num_inference_steps=2, seed=11)
    decoded = {}
    f32 = dict(dtype=jnp.float32)
    jpipe = jpipe_mod.HunyuanVideoPipeline(
        jhv.hunyuan_video_dit_params_from_torch(fx.to_numpy(sds["dit"])), encoder(jp), **f32)
    # set after construction: svi_tpu's constructor casts every leaf, the
    # upsamplers' int factors too, and its decode then fails (ROADMAP.md)
    jpipe.vae_decoder_params = jhv.hunyuan_video_vae_decoder_params_from_torch(
        fx.to_numpy(sds["vae_decoder"]))
    jdecode = jhv.hunyuan_video_vae_decode
    jpipe_mod.hv.hunyuan_video_vae_decode = lambda p, lat: decoded.setdefault(
        "jax", jdecode(p, lat))
    try:
        want = [np.asarray(f) for f in jpipe("a red fox running through snow", **kw)]
    finally:
        jpipe_mod.hv.hunyuan_video_vae_decode = jdecode
    tpipe = tpipe_mod.HunyuanVideoPipeline(
        thv.hunyuan_video_dit_params_from_torch(sds["dit"], device="cpu", dtype=torch.float32),
        encoder(tp), vae_decoder_params=thv.hunyuan_video_vae_decoder_params_from_torch(
            sds["vae_decoder"], device="cpu"), dtype=torch.float32)
    tdecode = thv.hunyuan_video_vae_decode
    tpipe_mod.hv.hunyuan_video_vae_decode = lambda p, lat: decoded.setdefault(
        "torch", tdecode(p, lat))
    try:
        got = tpipe("a red fox running through snow", **kw)
    finally:
        tpipe_mod.hv.hunyuan_video_vae_decode = tdecode
    assert fx.rel(fx.np32(decoded["torch"]), np.asarray(decoded["jax"])) < F32_REL
    assert len(got) == len(want) == 9 and got[0].shape == (64, 96, 3)
    assert max(np.abs(a.astype(int) - b.astype(int)).max() for a, b in zip(got, want)) <= LEVELS
