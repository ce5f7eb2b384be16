"""CogVideoX in the port (svi_tpu_torch.models.cog, prompters.cog_prompter,
pipelines.cog_video) against svi_tpu on the CPU.

Both packages load the same seeded state dicts in the reference's diffsynth
names through their own converters (tests/torch_video_fixtures.py): a DiT
2 blocks of 2 heads of 64 (svi_tpu's block takes its head count as an
argument: both get 2) over T5 states 32 wide, the cached-conv VAE at a
quarter of its channels, a one-layer T5 32 wide; svi_tpu's pytrees are also
carried across by `params_from_jax`.

Tolerances: the rotary tables equal; f32 forwards within 1e-4 of the
output's largest magnitude (two f32 implementations, sums in other orders);
the pipeline's uint8 frames within one level.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import cog as jcog
from svi_tpu.models import t5 as jt5
from svi_tpu.pipelines import cog_video as jpipe_mod
from svi_tpu.prompters import cog_prompter as jprompt
from svi_tpu_torch.models import cog as tcog
from svi_tpu_torch.models import t5 as tt5
from svi_tpu_torch.pipelines import cog_video as tpipe_mod
from svi_tpu_torch.prompters import cog_prompter as tprompt

import torch_sd_fixtures as fx
import torch_video_fixtures as vfx

F32_REL, LEVELS = 1e-4, 1
T5_DIM = vfx.COG_DIT["text_dim"]
PROMPT = "a paper boat drifting down a rainy street, cinematic"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


_JITTED = {}


def _jax_cfg_dit(params, latents, timestep, emb_posi, emb_nega, cos, sin, cfg_scale):
    """svi_tpu's batched-CFG step (`CogVideoPipeline._cfg_dit_impl`) on the
    shared jit of its DiT forward."""
    pred = jcog.cog_dit_forward(params, jnp.concatenate([latents, latents]),
                                jnp.concatenate([timestep, timestep]),
                                jnp.concatenate([emb_posi, emb_nega]), (cos, sin))
    posi, nega = jnp.split(pred, 2)
    return nega + cfg_scale * (posi - nega)


@pytest.fixture
def narrow(monkeypatch):
    """The narrow VAE plans and head count in both packages; svi_tpu's DiT
    forward and VAE chunks jitted once per shape, shared by the tests below
    (their shapes chosen alike: latents 3 x 4 x 6, tiles of 4 x 6 latents)."""
    vfx.patch_cog_plans(monkeypatch, jcog)
    for mod in (jcog, tcog):
        monkeypatch.setattr(mod, "_cog_block", functools.partial(mod._cog_block,
                                                                 num_heads=vfx.COG_HEADS))
    if not _JITTED:
        _JITTED.update(
            fwd=jax.jit(jcog.cog_dit_forward,
                        static_argnames=("tiled", "tile_size", "tile_stride")),
            enc=jax.jit(jcog.cog_vae_encode_chunk), dec=jax.jit(jcog.cog_vae_decode_chunk))
    monkeypatch.setattr(jcog, "cog_dit_forward", _JITTED["fwd"])
    monkeypatch.setattr(jcog, "cog_vae_encode_chunk", _JITTED["enc"])
    monkeypatch.setattr(jcog, "cog_vae_decode_chunk", _JITTED["dec"])
    monkeypatch.setattr(jpipe_mod.CogVideoPipeline, "_cfg_dit_impl", staticmethod(_jax_cfg_dit))


@pytest.fixture(scope="module")
def sds():
    mp = pytest.MonkeyPatch()
    vfx.patch_cog_plans(mp)
    out = vfx.cog_state_dicts(seed=71)
    cfg = fx.tiny_t5_config(T5_DIM)
    out["t5"] = tt5.torch_state_dict_from_params(tt5.init_params(cfg, 72, device="cpu"))
    out["t5_cfg"] = cfg
    mp.undo()
    return out


def _models(sds):
    jm = {k: f(fx.to_numpy(sds[k])) for k, f in (
        ("dit", jcog.cog_dit_params_from_torch),
        ("vae_encoder", jcog.cog_vae_encoder_params_from_torch),
        ("vae_decoder", jcog.cog_vae_decoder_params_from_torch))}
    tm = {"dit": tcog.cog_dit_params_from_torch(sds["dit"], device="cpu", dtype=torch.float32),
          "vae_encoder": tcog.cog_vae_encoder_params_from_torch(sds["vae_encoder"], device="cpu"),
          "vae_decoder": tcog.cog_vae_decoder_params_from_torch(sds["vae_decoder"], device="cpu")}
    c = sds["t5_cfg"]
    jcfg = jt5.T5Config(vocab=c.vocab, dim=c.dim, dim_attn=c.dim_attn, dim_ffn=c.dim_ffn,
                        num_heads=c.num_heads, num_layers=c.num_layers, dtype=jnp.float32)
    jm["t5"] = (jt5.params_from_torch_state_dict(sds["t5"], jcfg), jcfg, None)
    tm["t5"] = (tt5.params_from_torch_state_dict(sds["t5"], c, device="cpu"), c, None)
    return jm, tm


def test_rope_tables_match_svi_tpu():
    for args in ((60, 90, 13), (8, 12, 3), (40, 120, 2)):
        for ours, theirs in zip(tcog.prepare_rope_tables(*args), jcog.prepare_rope_tables(*args)):
            np.testing.assert_array_equal(ours, theirs)


def test_dit_forward_matches_svi_tpu(narrow, sds):
    """B2 (batched CFG's shape) at 3 x 4 x 6 latents over 226 tokens with the
    pipeline's tables, and B1 at 3 x 4 x 8 tiled (4 x 6 latent tiles, stride
    2 x 4, the tables made per tile)."""
    jm, tm = _models(sds)
    rng = np.random.default_rng(73)
    for b, w, kw in ((2, 6, {}), (1, 8, dict(tiled=True, tile_size=(4, 6), tile_stride=(2, 4)))):
        x = (rng.standard_normal((b, 16, 3, 4, w)) * 0.5).astype(np.float32)
        t = np.array([501.0] * b, np.float32)
        emb = (rng.standard_normal((b, 226, T5_DIM)) * 0.3).astype(np.float32)
        rope = () if kw else (jcog.prepare_rope_tables(4, w, 3),)
        want = np.asarray(jcog.cog_dit_forward(jm["dit"], jnp.asarray(x), jnp.asarray(t),
                                               jnp.asarray(emb), *[tuple(map(jnp.asarray, r))
                                                                   for r in rope], **kw))
        with torch.no_grad():
            for dit in (tm["dit"], tcog.params_from_jax(jm["dit"], device="cpu")):
                got = tcog.cog_dit_forward(dit, torch.from_numpy(x), torch.from_numpy(t),
                                           torch.from_numpy(emb), *rope, **kw)
                assert got.shape == want.shape == x.shape
                assert fx.rel(fx.np32(got), want) < F32_REL


def test_vae_matches_svi_tpu(narrow, sds):
    """A 9-frame 32 x 48 clip encoded in 8-frame chunks (the odd leading
    frame in the first) and its 3 latent frames decoded in 2-frame chunks,
    the spatial norms' nearest resize on odd frame counts (the tiled VAE
    runs in the video-to-video pipeline test)."""
    jm, tm = _models(sds)
    video = np.random.default_rng(74).uniform(-1, 1, (1, 3, 9, 32, 48)).astype(np.float32)
    want_lat = np.asarray(jcog.cog_vae_encode_video(jm["vae_encoder"], jnp.asarray(video)))
    want = np.asarray(jcog.cog_vae_decode_video(jm["vae_decoder"], jnp.asarray(want_lat)))
    with torch.no_grad():
        for enc, dec in ((tm["vae_encoder"], tm["vae_decoder"]),
                         (tcog.params_from_jax(jm["vae_encoder"], device="cpu"),
                          tcog.params_from_jax(jm["vae_decoder"], device="cpu"))):
            lat = tcog.cog_vae_encode_video(enc, torch.from_numpy(video))
            assert lat.shape == want_lat.shape == (1, 16, 3, 4, 6)
            assert fx.rel(fx.np32(lat), want_lat) < F32_REL
            got = tcog.cog_vae_decode_video(dec, torch.from_numpy(want_lat.copy()))
            assert got.shape == want.shape == (1, 3, 9, 32, 48)
            assert fx.rel(fx.np32(got), want) < F32_REL


def test_prompter_matches_svi_tpu(sds):
    """T5 over 226 tokens (the vendored spiece model), reshaped to (1, 226, dim)."""
    jm, tm = _models(sds)
    want = np.asarray(jprompt.CogPrompter(jm["t5"]).encode_prompt(PROMPT, dtype=jnp.float32))
    got = tprompt.CogPrompter(tm["t5"]).encode_prompt(PROMPT, dtype=torch.float32)
    assert got.shape == want.shape == (1, 226, T5_DIM)
    assert fx.rel(fx.np32(got), want) < F32_REL


@pytest.mark.parametrize("mode", ["text", "video_tiled"])
def test_pipeline_matches_svi_tpu(narrow, sds, mode):
    """CogVideoPipeline, 9 frames, 2 steps, CFG 6, the prompts through each
    package's T5: text-to-video at 32 x 48 with the batched CFG, and
    video-to-video (strength 0.7) at 32 x 64 tiled (2 VAE and DiT tiles),
    svi_tpu given the clip as a (1, 3, T, H, W) array (its list-of-frames
    path stacks the frames on the wrong axes), the port as a list of frames
    (checked to reach the VAE as that array): the decoded video within
    F32_REL, the frames within LEVELS."""
    jm, tm = _models(sds)
    kw = dict(negative_prompt="blurry", cfg_scale=6.0, num_frames=9, height=32, width=48,
              num_inference_steps=2, seed=13)
    if mode == "video_tiled":
        clip = vfx.frames(9, 32, 64, seed=75)
        video = (clip.astype(np.float32) * (2 / 255) - 1).transpose(3, 0, 1, 2)[None]
        kw.update(height=32, width=64, input_video=video, denoising_strength=0.7, tiled=True,
                  tile_size=(4, 6), tile_stride=(2, 4))
    decoded = {}
    jpipe = jpipe_mod.CogVideoPipeline(jm["dit"], jm["t5"], jm["vae_encoder"], jm["vae_decoder"],
                                       dtype=jnp.float32)
    jdecode = jcog.cog_vae_decode_video
    jpipe_mod.cog.cog_vae_decode_video = lambda p, lat, **k: decoded.setdefault(
        "jax", jdecode(p, lat, **k))
    try:
        want = [np.asarray(f) for f in jpipe(PROMPT, **kw)]
    finally:
        jpipe_mod.cog.cog_vae_decode_video = jdecode
    tpipe = tpipe_mod.CogVideoPipeline(tm["dit"], tm["t5"], tm["vae_encoder"], tm["vae_decoder"],
                                       dtype=torch.float32)
    tdecode, tencode = tcog.cog_vae_decode_video, tcog.cog_vae_encode_video
    tpipe_mod.cog.cog_vae_decode_video = lambda p, lat, **k: decoded.setdefault(
        "torch", tdecode(p, lat, **k))
    tpipe_mod.cog.cog_vae_encode_video = lambda p, v, **k: (decoded.setdefault("clip", v),
                                                            tencode(p, v, **k))[1]
    if mode == "video_tiled":
        kw["input_video"] = list(clip)  # the port's list path
    try:
        got = tpipe(PROMPT, **kw)
    finally:
        tpipe_mod.cog.cog_vae_decode_video = tdecode
        tpipe_mod.cog.cog_vae_encode_video = tencode
    if mode == "video_tiled":
        assert fx.rel(fx.np32(decoded["clip"]), video) < 1e-7
    assert fx.rel(fx.np32(decoded["torch"]), np.asarray(decoded["jax"])) < F32_REL
    assert len(got) == len(want) == 9 and got[0].shape == want[0].shape
    assert max(np.abs(a.astype(int) - b.astype(int)).max() for a, b in zip(got, want)) <= LEVELS
