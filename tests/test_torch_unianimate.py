"""The port's UniAnimate family (svi_tpu_torch/models/unianimate.py,
svi_tpu_torch/pipelines/wan_video.py) against svi_tpu's on the CPU.

The side stacks: seeded weights in svi_tpu's layout carried across with
the port's params_from_jax, and the reference's Sequential keys read by
both packages' converters; f32 within F32_TOL of the largest output. context_scheduler
integer-equal over a grid. The four pipelines at tests/test_unianimate.py's
tiny config (64x64, 2 steps, f32): the latents and the frames before the
uint8 cast within LATENT_TOL, NaNs in the same places (the long pipeline's
never-kept latent frames), and the frames after the cast within
FRAME_LEVELS where they are finite.
"""

import itertools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import clip_vision as jclip
from svi_tpu.models import unianimate as jua
from svi_tpu.models import wan_dit as jdit
from svi_tpu.models import wan_vae as jvae
from svi_tpu.pipelines import wan_video as jwv
from svi_tpu_torch.models import clip_vision as tclip
from svi_tpu_torch.models import model_io
from svi_tpu_torch.models import pose_embedding as tpose
from svi_tpu_torch.models import unianimate as tua
from svi_tpu_torch.models import wan_dit as tdit
from svi_tpu_torch.models import wan_vae as tvae
from svi_tpu_torch.pipelines import wan_video as twv

# the stacks: f32 convs of at most 16 x 27 terms, summed in another order
F32_TOL = 1e-5
# f32 pipelines through 2 DiT steps, the VAE and CLIP (as the port's other
# pipeline tests)
LATENT_TOL = 1e-3
FRAME_LEVELS = 2
Z, H, W, STEPS = 4, 64, 64, 2


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_stack(seed, layers, channels):
    """svi_tpu's parameter layout for a conv stack (a list of {"w": (k...,
    in, out), "b"}), U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from numpy (svi_tpu's
    own init draws op by op, seconds per stack on the CPU)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (k, _, _) in enumerate(layers):
        lim = 1.0 / math.sqrt(channels[i] * math.prod(k))
        out.append({"w": rng.uniform(-lim, lim, (*k, channels[i], channels[i + 1])).astype(
            np.float32), "b": rng.uniform(-lim, lim, channels[i + 1]).astype(np.float32)})
    return out


_SPECS = {"randomref": (jua.RANDOMREF_LAYERS, jua.RANDOMREF_CHANNELS),
          "learn_in": (jua.LEARN_IN_LAYERS, jua.LEARN_IN_CHANNELS),
          "inpaint": (jua.INPAINT_LAYERS, jua.INPAINT_CHANNELS)}


# ---------------------------------------------------------------------------
# the side stacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,shape", [
    ("randomref", (2, 32, 48, 3)), ("learn_in", (1, 4, 9, 32, 32)),
    ("inpaint", (1, 16, 3, 4, 4))])
def test_stacks_match_svi_tpu(kind, shape):
    forward = {"randomref": jua.randomref_forward, "learn_in": jua.learn_in_forward,
               "inpaint": jua.inpaint_forward}[kind]
    from_torch = {"randomref": jua.randomref_from_torch, "learn_in": jua.learn_in_from_torch,
                  "inpaint": jua.inpaint_from_torch}[kind]
    params = _jax_stack(3, *_SPECS[kind])
    rng = np.random.default_rng(4)
    x = (rng.integers(0, 255, shape) if kind == "randomref"
         else rng.standard_normal(shape)).astype(np.float32)
    want = np.asarray(forward(params, jnp.asarray(x)))
    model = tua.params_from_jax(kind, _host(params), device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert _rel_err(got, want) <= F32_TOL
    # the reference's Sequential keys, both ways and through svi_tpu's reader
    sd = tua.torch_state_dict_from_params(kind, model)
    assert sorted(sd) == sorted(f"{tua.PREFIXES[kind]}{2 * i}.{k}"
                                for i in range(len(params)) for k in ("weight", "bias"))
    back = tua.params_from_torch_state_dict(kind, {"pipe.dit." + k: v for k, v in sd.items()},
                                            device="cpu")
    jback = from_torch({k: v.numpy() for k, v in sd.items()})
    with torch.inference_mode():
        np.testing.assert_array_equal(back(torch.from_numpy(x)).numpy(), got)
    assert _rel_err(np.asarray(forward(jback, jnp.asarray(x))), want) <= F32_TOL
    assert set(model_io.extract_side_modules(sd)) == set(sd)


def test_context_scheduler_and_ordered_halving_match_svi_tpu():
    grid = itertools.product((0, 1, 3, 17, 30), (31, 50), (6, 12, 21, 30), (3, 4, 8, 21),
                             (1, 3), (1, 2, 4), (False, True))
    n = 0
    for step, steps, frames, size, stride, overlap, closed in grid:
        if size * 1 - overlap <= 0:
            continue
        kw = dict(context_size=size, context_stride=stride, context_overlap=overlap,
                  closed_loop=closed)
        assert (list(twv.context_scheduler(step, steps, frames, **kw))
                == list(jwv.context_scheduler(step, steps, frames, **kw)))
        n += 1
    assert n > 500
    for v in (0, 1, 2, 3, 12345, 2**40 + 7):
        assert twv.ordered_halving(v) == jwv.ordered_halving(v)


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """tests/test_unianimate.py's tiny models in both packages, from the
    port's init_params carried to svi_tpu by the reference's names (svi_tpu's
    own inits draw op by op, seconds each on the CPU): the DiT, the VAE and
    CLIP; the side stacks in svi_tpu's layout from numpy, cut as that test
    cuts them to the tiny DiT's 4 latent channels (y has 4 + 4), carried to
    the port by params_from_jax. The svi_tpu pipelines share one jit cache:
    they hold the same models, so each shape compiles once."""
    dit_kw = dict(dim=64, in_dim=Z + 4 + Z, ffn_dim=128, out_dim=Z, text_dim=48, freq_dim=32,
                  num_heads=2, num_layers=2, has_image_input=True, clip_feature_dim=40)
    cfg_j = jdit.WanDiTConfig(dtype=jnp.float32, **dit_kw)
    dit_t = tdit.init_params(tdit.WanDiTConfig(dtype=torch.float32, **dit_kw), seed=2,
                             device="cpu")
    clip_kw = dict(image_size=28, patch_size=14, dim=40, mlp_ratio=2, num_heads=2, num_layers=2)
    vae = tvae.init_params(tvae.WanVAEConfig(dim=16, z_dim=Z), seed=1, device="cpu")
    clip = tclip.init_params(tclip.ClipVisionConfig(**clip_kw), seed=3, device="cpu")
    jv = jvae.WanVAEConfig(dtype=jnp.float32, dim=16, z_dim=Z)
    jc = jclip.ClipVisionConfig(dtype=jnp.float32, **clip_kw)
    to_np = lambda sd: {k: v.float().numpy() for k, v in sd.items()}  # noqa: E731
    dit_j = (jdit.params_from_torch_state_dict(to_np(tdit.torch_state_dict_from_params(dit_t)),
                                               cfg_j), cfg_j)
    vae_j = (jvae.params_from_torch_state_dict(to_np(tvae.torch_state_dict_from_params(vae)),
                                               jv), jv)
    clip_j = (jclip.params_from_torch_state_dict(to_np(tclip.torch_state_dict_from_params(clip)),
                                                 jc), jc)
    side = {"dwpose_embedding": _jax_stack(13, tpose.LAYERS, (3,) + (16,) * 6 + (64,)),
            "randomref": _jax_stack(14, jua.RANDOMREF_LAYERS, (3, 16, 16, 16, 16, 16, 8)),
            "learn_in": _jax_stack(16, jua.LEARN_IN_LAYERS, (4, 16, 16, 16, Z)),
            "inpaint": _jax_stack(17, jua.INPAINT_LAYERS, (Z, 16, 16, Z))}
    return dit_j, dit_t, vae, clip, vae_j, clip_j, side, {}


def _pipes(models, name):
    dit_j, dit_t, vae, clip, vae_j, clip_j, side, jit_cache = models
    jpipe = getattr(jwv, name)(torch_dtype=jnp.float32)
    jpipe.dit, jpipe.vae, jpipe.image_encoder = dit_j, vae_j, clip_j
    jpipe._jit_cache = jit_cache
    tpipe = getattr(twv, name)(device="cpu", torch_dtype=torch.float32)
    tpipe.dit, tpipe.vae, tpipe.image_encoder = dit_t, vae, clip
    if name != "WanVideoPipeline":
        jpipe.dwpose_embedding = side["dwpose_embedding"]
        jpipe.randomref_embedding_pose = side["randomref"]
        tpipe.dwpose_embedding = tpose.params_from_jax(_host(side["dwpose_embedding"]))
        tpipe.randomref_embedding_pose = tua.params_from_jax("randomref", _host(side["randomref"]),
                                                              device="cpu")
    if name == "WanRepalceAnyoneVideoPipeline":
        jpipe.learn_in_embedding, jpipe.inpaint_embedding = side["learn_in"], side["inpaint"]
        tpipe.learn_in_embedding = tua.params_from_jax("learn_in", _host(side["learn_in"]),
                                                        device="cpu")
        tpipe.inpaint_embedding = tua.params_from_jax("inpaint", _host(side["inpaint"]),
                                                       device="cpu")
    return jpipe, tpipe


def _capture_decode(pipe, seen: dict, key: str):
    """Keep the frames of the pipeline's decode, before the uint8 cast."""
    decode = pipe.decode_video

    def spy(*a, **kw):
        out = decode(*a, **kw)
        seen[key] = np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out, np.float32)
        return out

    pipe.decode_video = spy


def _compare_frames(jf, tf, want_nan: bool = False):
    assert jf.shape == tf.shape
    nan_j, nan_t = np.isnan(jf), np.isnan(tf)
    np.testing.assert_array_equal(nan_t, nan_j)
    assert nan_j.any() == want_nan
    fin = ~nan_j
    assert np.abs(tf[fin] - jf[fin]).max() <= LATENT_TOL


def _call_kwargs(seed, frames):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    ctx = rng.standard_normal((1, 7, 48)).astype(np.float32)
    pose = rng.integers(0, 255, (3, frames, H, W)).astype(np.float32)
    ref_pose = rng.integers(0, 255, (H, W, 3)).astype(np.float32)
    return dict(input_image=img, dwpose_data=pose, random_ref_dwpose=ref_pose, seed=seed + 1,
                height=H, width=W, num_frames=frames, cfg_scale=5.0,
                num_inference_steps=STEPS, tiled=False, prompt_emb_posi=ctx,
                prompt_emb_nega=ctx * 0.5)


@pytest.mark.parametrize("name", ["WanVideoPipeline", "WanUniAnimateVideoPipeline"])
def test_plain_pipelines_match_svi_tpu(models, name):
    """Upstream I2V (the input image as its own reference frame) and the
    pose-driven pipeline (pose tokens on the conditional branch, the
    reference pose on y): the latents, then both decodes of them."""
    jpipe, tpipe = _pipes(models, name)
    kw = dict(_call_kwargs(0, 9), return_latents=True)
    if name == "WanVideoPipeline":
        for k in ("dwpose_data", "random_ref_dwpose"):
            kw.pop(k)
    (fj, lj), (ft, lt) = jpipe(**kw), tpipe(**kw)
    lj, lt = np.asarray(lj, np.float32), lt.numpy()
    assert np.abs(lt - lj).max() <= LATENT_TOL
    with torch.inference_mode():
        _compare_frames(np.asarray(jpipe.decode_video(lj, tiled=False)),
                        tpipe.decode_video(torch.from_numpy(lt), tiled=False).numpy())
    fj, ft = np.stack([np.asarray(f) for f in fj]), np.stack(ft)
    assert ft.shape == fj.shape == (9, H, W, 3)
    assert np.abs(ft.astype(np.int16) - fj.astype(np.int16)).max() <= FRAME_LEVELS
    if name == "WanUniAnimateVideoPipeline":  # the pose moves the clip
        _, plain = tpipe(**dict(kw, dwpose_data=None))
        assert np.abs(plain.numpy() - lt).max() > 10 * LATENT_TOL


@pytest.mark.parametrize("frames,size,overlap,nan", [(21, 3, 1, True), (17, 3, 2, False)])
def test_long_pipeline_matches_svi_tpu(models, frames, size, overlap, nan):
    """tests/test_unianimate.py's 21 frames, windows of 3 latent frames with
    overlap 1 (latent frame 3 is kept by no window: NaN in both), and 17
    frames in windows of 3 with overlap 2 (every frame kept; the windows'
    shapes compile once for both cases)."""
    jpipe, tpipe = _pipes(models, "WanUniAnimateLongVideoPipeline")
    seen = {}
    _capture_decode(jpipe, seen, "jax")
    _capture_decode(tpipe, seen, "torch")
    kw = dict(_call_kwargs(1, frames), context_size=size, context_overlap=overlap)
    jf, tf = jpipe(**kw), tpipe(**kw)
    assert len(tf) == len(jf) == frames
    _compare_frames(seen["jax"], seen["torch"], want_nan=nan)
    if not nan:
        diff = np.abs(np.stack(tf).astype(np.int16) - np.stack([np.asarray(f) for f in jf]))
        assert diff.max() <= FRAME_LEVELS


def test_replace_anyone_pipeline_matches_svi_tpu(models):
    """The masked video through learn_in and, VAE-encoded, through inpaint
    on the conditional branch; two batch-1 forwards a step. 7 frames are
    rounded up to 9."""
    jpipe, tpipe = _pipes(models, "WanRepalceAnyoneVideoPipeline")
    seen = {}
    _capture_decode(jpipe, seen, "jax")
    _capture_decode(tpipe, seen, "torch")
    rng = np.random.default_rng(2)
    batch = {"video": rng.uniform(-1, 1, (3, 9, H, W)).astype(np.float32),
             "segmentation_data": (rng.random((9, H, W)) > 0.7).astype(np.float32) * 255}
    kw = dict(_call_kwargs(2, 9), batch=batch, num_frames=7)
    jf, tf = jpipe(**kw), tpipe(**kw)
    assert len(tf) == len(jf) == 9
    _compare_frames(seen["jax"], seen["torch"])
    diff = np.abs(np.stack(tf).astype(np.int16) - np.stack([np.asarray(f) for f in jf]))
    assert diff.max() <= FRAME_LEVELS


def test_side_modules_load_through_the_model_manager(models):
    """fetch_models reads dwpose_embedding.*, randomref_embedding_pose.*,
    learn_in_embedding.* and inpaint_embedding.* from the manager's side
    modules (a LoRA file's extras), under the reference's key names."""
    side = models[6]
    sd = dict(tpose.torch_state_dict_from_params(tpose.params_from_jax(
        _host(side["dwpose_embedding"]))))
    for kind in ("randomref", "learn_in", "inpaint"):
        sd.update(tua.torch_state_dict_from_params(kind, tua.params_from_jax(
            kind, _host(side[kind]), device="cpu")))
    mm = model_io.ModelManager(torch_dtype=torch.float32, device="cpu")
    mm.state_dict_new_module.update(model_io.extract_side_modules(
        {f"pipe.dit.{k}": v for k, v in sd.items()}))
    pipe = twv.WanRepalceAnyoneVideoPipeline.from_model_manager(mm, device="cpu")
    assert pipe.dit is None and pipe.is_test is False
    x = np.random.default_rng(5).standard_normal((1, 4, 5, 16, 16)).astype(np.float32)
    want = np.asarray(jua.learn_in_forward(side["learn_in"], jnp.asarray(x)))
    with torch.inference_mode():
        got = pipe.learn_in_embedding(torch.from_numpy(x)).numpy()
    assert _rel_err(got, want) <= F32_TOL
    for attr in ("dwpose_embedding", "randomref_embedding_pose", "inpaint_embedding"):
        assert getattr(pipe, attr) is not None
