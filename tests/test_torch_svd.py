"""Stable Video Diffusion in the port (svi_tpu_torch.schedulers.continuous_ode,
models.svd, pipelines.svd_video) against svi_tpu on the CPU.

Both packages load the same seeded state dicts in the reference's diffsynth
names through their own converters (tests/torch_video_fixtures.py): the UNet
plan at a tenth of its channels with one head a block, the temporal VAE
decoder and SD's VAE encoder at a quarter, a one-layer CLIP image tower 64
wide; svi_tpu's pytrees are also carried across by `params_from_jax`.

Tolerances: the scheduler's tables equal, its step within 1e-6 of the
sample's scale (float64 host arithmetic on f32 arrays in both); f32
forwards within 1e-4 of the output's largest magnitude (two f32
implementations, sums in other orders); the pipeline's uint8 frames within
one level.
"""

import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from svi_tpu.models import ipadapter as jip
from svi_tpu.models import sd as jsd
from svi_tpu.models import svd as jsvd
from svi_tpu.pipelines import svd_video as jpipe_mod
from svi_tpu.schedulers import continuous_ode as jode
from svi_tpu_torch.models import ipadapter as tip
from svi_tpu_torch.models import sd as tsd
from svi_tpu_torch.models import svd as tsvd
from svi_tpu_torch.pipelines import svd_video as tpipe_mod
from svi_tpu_torch.schedulers import continuous_ode as tode

import torch_sd_fixtures as fx
import torch_video_fixtures as vfx

F32_REL, STEP_REL, LEVELS = 1e-4, 1e-6, 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


_JITTED = {}


@pytest.fixture
def narrow(monkeypatch):
    """The narrow plans in both packages; svi_tpu's block forwards jitted
    once per shape (eager JAX dispatches the UNet's thousands of ops one by
    one)."""
    vfx.patch_svd_plans(monkeypatch, jsvd)
    fx.patch_narrow_plans(monkeypatch)
    fx.jit_jax_blocks(monkeypatch)
    if not _JITTED:
        _JITTED.update(
            tres=jax.jit(jsvd._temporal_resnet, static_argnames=("eps",)),
            tattn=jax.jit(jsvd._temporal_attention_block,
                          static_argnames=("num_heads", "head_dim")),
            vtres=jax.jit(jsvd._vae_temporal_resnet),
            img=jax.jit(jip.clip_image_encoder_forward, static_argnames=("num_heads", "pooled")))
    for name, key in (("_temporal_resnet", "tres"), ("_temporal_attention_block", "tattn"),
                      ("_vae_temporal_resnet", "vtres")):
        monkeypatch.setattr(jsvd, name, _JITTED[key])
    for name in ("_resnet_block", "_attention_block", "_conv2d", "_group_norm", "_dense",
                 "timestep_embedding"):
        monkeypatch.setattr(jsvd, name, getattr(jsd, name))
    monkeypatch.setattr(jip, "clip_image_encoder_forward", _JITTED["img"])
    # the pipeline's whole-UNet jit would compile the narrow UNet again as
    # one program; run it on the jitted blocks above instead
    monkeypatch.setattr(jpipe_mod, "jax", types.SimpleNamespace(jit=lambda f, **kw: f,
                                                                tree=jax.tree))


@pytest.fixture(scope="module")
def sds():
    mp = pytest.MonkeyPatch()
    vfx.patch_svd_plans(mp)
    fx.patch_narrow_plans(mp)
    out = vfx.svd_state_dicts(seed=41)
    mp.undo()
    return out


def _models(sds):
    jm = {"unet": jsvd.svd_unet_params_from_torch(fx.to_numpy(sds["unet"])),
          "vae_decoder": jsvd.svd_vae_decoder_params_from_torch(fx.to_numpy(sds["vae_decoder"])),
          "vae_encoder": jsd.sd_vae_encoder_params_from_torch(fx.to_numpy(sds["vae_encoder"])),
          "image_encoder": jip.clip_image_encoder_params_from_torch(
              fx.to_numpy(sds["image_encoder"]))}
    tm = {"unet": tsvd.svd_unet_params_from_torch(sds["unet"], device="cpu"),
          "vae_decoder": tsvd.svd_vae_decoder_params_from_torch(sds["vae_decoder"],
                                                                device="cpu"),
          "vae_encoder": tsd.sd_vae_encoder_params_from_torch(sds["vae_encoder"], device="cpu"),
          "image_encoder": tip.clip_image_encoder_params_from_torch(sds["image_encoder"],
                                                                    device="cpu")}
    return jm, tm


@pytest.mark.parametrize("steps,strength", [(25, 1.0), (7, 0.6)])
def test_continuous_ode_scheduler(steps, strength):
    """Sigmas and timesteps equal; one step (mid and last), add_noise and the
    training target within STEP_REL of the sample's scale; weights equal."""
    js, ts = jode.ContinuousODEScheduler(), tode.ContinuousODEScheduler()
    js.set_timesteps(steps, denoising_strength=strength)
    ts.set_timesteps(steps, denoising_strength=strength)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    rng = np.random.default_rng(3)
    out, sample, noise = (rng.standard_normal((2, 4, 6, 6)).astype(np.float32) for _ in range(3))
    tt = [torch.from_numpy(a) for a in (out, sample, noise)]
    for tid in (0, steps // 2, steps - 1):
        t = js.timesteps[tid]
        assert fx.rel(ts.step(tt[0], torch.tensor([t]), tt[1]),
                      js.step(out, t, sample)) < STEP_REL
        assert fx.rel(ts.add_noise(tt[1], tt[2], t), js.add_noise(sample, noise, t)) < STEP_REL
        assert fx.rel(ts.training_target(tt[1], tt[2], t),
                      js.training_target(sample, noise, t)) < STEP_REL
        assert ts.training_weight(t) == js.training_weight(t)
    assert ts.return_to_timestep(js.timesteps[0], tt[1], tt[1]) is None


def test_positional_ids():
    for n in (5, 25, 30, 80):
        np.testing.assert_array_equal(tsvd.positional_ids(n), jsvd.positional_ids(n))
        np.testing.assert_array_equal(tsvd.positional_ids(n, pivot=3),
                                      jsvd.positional_ids(n, pivot=3))


def test_svd_unet_and_vae_match_svi_tpu(narrow, sds):
    """The UNet (3 frames at 8 x 8 latents) and the temporal VAE decoder
    (4 x 3 x 8 x 8 latents), the port loading the reference's names and
    svi_tpu's pytrees alike."""
    jm, tm = _models(sds)
    rng = np.random.default_rng(42)
    sample = (rng.standard_normal((3, 8, 8, 8)) * 0.5).astype(np.float32)
    emb = (rng.standard_normal((1, 1, vfx.SVD_IMAGE_PROJ)) * 0.3).astype(np.float32)
    add = np.array([6.0, 127.0, 0.02], np.float32)
    want = np.asarray(jsvd.svd_unet_forward(jm["unet"], jnp.asarray(sample), jnp.asarray([444.0]),
                                            jnp.asarray(emb), jnp.asarray(add)))
    with torch.no_grad():
        for unet in (tm["unet"], tsvd.params_from_jax(jm["unet"], device="cpu")):
            got = tsvd.svd_unet_forward(unet, torch.from_numpy(sample), torch.tensor([444.0]),
                                        torch.from_numpy(emb), torch.from_numpy(add))
            assert got.shape == want.shape and fx.rel(fx.np32(got), want) < F32_REL
    lat = rng.standard_normal((4, 3, 8, 8)).astype(np.float32)
    want = np.asarray(jsvd.svd_vae_decode(jm["vae_decoder"], jnp.asarray(lat)))
    with torch.no_grad():
        for dec in (tm["vae_decoder"], tsvd.params_from_jax(jm["vae_decoder"], device="cpu")):
            got = tsvd.svd_vae_decode(dec, torch.from_numpy(lat))
            assert got.shape == want.shape == (3, 3, 64, 64)
            assert fx.rel(fx.np32(got), want) < F32_REL


def test_svd_pipeline_matches_svi_tpu(narrow, sds):
    """The image-to-video pipeline, 3 frames at 64 x 64, 2 steps, CFG 1 -> 3
    per frame, one mask frame re-noised, post-normalize and contrast: the
    decoded video within F32_REL and the frames within LEVELS."""
    jm, tm = _models(sds)
    image = vfx.frames(2, 64, 64, seed=5)
    kw = dict(num_frames=3, height=64, width=64, num_inference_steps=2, seed=7,
              mask_frames=[image[1]], mask_frame_ids=[2], min_cfg_scale=1.0, max_cfg_scale=3.0,
              noise_aug_strength=0.05, motion_bucket_id=100, fps=6)
    videos = {}
    jp = jpipe_mod.SVDVideoPipeline(jm["unet"], jm["image_encoder"], jm["vae_encoder"],
                                    jm["vae_decoder"])
    jdecode = jsvd.svd_vae_decode
    jpipe_mod.svd.svd_vae_decode = lambda p, lat: videos.setdefault("jax", jdecode(p, lat))
    try:
        jframes = [np.asarray(f) for f in jp(Image.fromarray(image[0]), **kw)]
    finally:
        jpipe_mod.svd.svd_vae_decode = jdecode
    tp = tpipe_mod.SVDVideoPipeline(tm["unet"], tm["image_encoder"], tm["vae_encoder"],
                                    tm["vae_decoder"])
    tdecode = tsvd.svd_vae_decode
    tpipe_mod.svd.svd_vae_decode = lambda p, lat: videos.setdefault("torch", tdecode(p, lat))
    try:
        tframes = tp(image[0], **kw)
    finally:
        tpipe_mod.svd.svd_vae_decode = tdecode
    assert fx.rel(fx.np32(videos["torch"]), np.asarray(videos["jax"])) < F32_REL
    assert len(tframes) == len(jframes) == 3 and tframes[0].dtype == np.uint8
    assert max(np.abs(a.astype(int) - b.astype(int)).max()
               for a, b in zip(tframes, jframes)) <= LEVELS
