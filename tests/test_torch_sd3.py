"""SD3 in the port (svi_tpu_torch.models.sd3, prompters.sd3_prompter,
pipelines.sd3_image) and the flow-match scheduler's other options against
svi_tpu on the CPU.

Both packages load the same seeded state dicts in the reference's diffsynth
names through their own converters: an MMDiT 64 wide (one head of 64; three
blocks, the first a dual block in the SD3.5 layout, with per-head RMS q / k
norms), the 16-channel VAE at a quarter of its channels (narrow plans patched
into both packages), CLIP-L's text tower at its 768 width (svi_tpu fixes its
12 heads of 64) with 2 layers, bigG's at 1280 with one, and a one-layer T5 64
wide run over 64 tokens (one 4096-wide row of the prompt embedding).

Tolerances: the flow-match tables within 1e-6 relative (both are float64
tables stored as f32); f32 forwards within 1e-4 of the output's largest
magnitude (two f32 implementations, sums in other orders); uint8 frames
within one level.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import sd as jsd
from svi_tpu.models import sd3 as jsd3
from svi_tpu.models import sdxl as jsdxl
from svi_tpu.models import t5 as jt5
from svi_tpu.pipelines import sd3_image as jpipe_mod
from svi_tpu.prompters.sd3_prompter import SD3Prompter as JPrompter
from svi_tpu.schedulers import flow_match as jfm
from svi_tpu_torch.models import sd as tsd
from svi_tpu_torch.models import sd3 as tsd3
from svi_tpu_torch.models import sdxl as tsdxl
from svi_tpu_torch.models import t5 as tt5
from svi_tpu_torch.pipelines import sd3_image as tpipe_mod
from svi_tpu_torch.prompters.sd3_prompter import SD3Prompter as TPrompter
from svi_tpu_torch.schedulers import flow_match as tfm

import torch_sd_fixtures as fx

F32_REL, TABLE_REL, LEVELS = 1e-4, 1e-6, 1
T5_LEN = 64
PROMPT = "a red fox in the snow, golden hour"
VAE_ENC, VAE_DEC = fx.sd3_vae_plans()

# the options of svi_tpu/tests/test_flow_match.py plus each new one
SCHEDULES = [
    dict(shift=5, sigma_min=0.0, extra_one_step=True),
    dict(shift=3.0),
    dict(shift=3.0, sigma_max=0.8),
    dict(shift=3.0, inverse_timesteps=True),
    dict(shift=3.0, reverse_sigmas=True),
    dict(shift=2.0, inverse_timesteps=True, reverse_sigmas=True, extra_one_step=True),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


@pytest.mark.parametrize("kw", SCHEDULES)
@pytest.mark.parametrize("strength,training", [(1.0, False), (0.6, True)])
def test_flow_match_tables_and_steps(kw, strength, training):
    """The sigma / timestep tables (and training weights), then step (to the
    next entry, past the last, to_final), add_noise, return_to_timestep and
    the training target and weight, on the same arrays. The training
    weights need the training table's 1000 steps (their bell is centred on
    num_inference_steps / 2 in timestep units)."""
    js, ts = jfm.FlowMatchScheduler(**kw), tfm.FlowMatchScheduler(**kw)
    for s in (js, ts):
        s.set_timesteps(1000 if training else 12, denoising_strength=strength,
                        training=training)
    np.testing.assert_allclose(ts.sigmas.numpy(), np.asarray(js.sigmas), rtol=TABLE_REL)
    np.testing.assert_allclose(ts.timesteps.numpy(), np.asarray(js.timesteps), rtol=TABLE_REL)
    if training:
        np.testing.assert_allclose(ts.linear_timesteps_weights.numpy(),
                                   np.asarray(js.linear_timesteps_weights), rtol=TABLE_REL)
        for t in (1.0, 500.0, 980.0):
            assert abs(float(ts.training_weight(t)) - float(js.training_weight(t))) <= 1e-6
    rng = np.random.default_rng(1)
    x, e = (rng.standard_normal((1, 4, 4, 4)).astype(np.float32) for _ in range(2))
    for i in (0, 5, 11):
        t = float(js.timesteps[i])
        for to_final in (False, True):
            np.testing.assert_allclose(
                ts.step(torch.from_numpy(e), t, torch.from_numpy(x), to_final=to_final).numpy(),
                np.asarray(js.step(e, t, x, to_final=to_final)), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            ts.add_noise(torch.from_numpy(x), torch.from_numpy(e), t).numpy(),
            np.asarray(js.add_noise(x, e, t)), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            ts.return_to_timestep(t, torch.from_numpy(x), torch.from_numpy(e)).numpy(),
            np.asarray(js.return_to_timestep(t, x, e)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ts.training_target(torch.from_numpy(x),
                                                     torch.from_numpy(e)).numpy(),
                                  np.asarray(js.training_target(x, e)))


def _patch_vae_plans(monkeypatch):
    for mod in (jsd3, tsd3):
        monkeypatch.setattr(mod, "SD3_VAE_ENCODER_PLAN", VAE_ENC)
        monkeypatch.setattr(mod, "SD3_VAE_DECODER_PLAN", VAE_DEC)


@pytest.fixture(scope="module")
def sds():
    mp = pytest.MonkeyPatch()
    _patch_vae_plans(mp)
    out = fx.sd3_state_dicts(seed=11)
    mp.undo()
    return out


def _models(sds, kinds):
    jload = {"dit": lambda sd: jsd3.sd3_dit_params_from_torch(sd, num_dual_blocks=1),
             "vae_encoder": jsd3.sd3_vae_encoder_params_from_torch,
             "vae_decoder": jsd3.sd3_vae_decoder_params_from_torch,
             "te1": jsd.sd_text_encoder_params_from_torch,
             "te2": jsdxl.sdxl_text_encoder_2_params_from_torch}
    tload = {"dit": lambda sd, device: tsd3.sd3_dit_params_from_torch(sd, 1, device=device),
             "vae_encoder": tsd3.sd3_vae_encoder_params_from_torch,
             "vae_decoder": tsd3.sd3_vae_decoder_params_from_torch,
             "te1": tsd.sd_text_encoder_params_from_torch,
             "te2": tsdxl.sdxl_text_encoder_2_params_from_torch}
    jm, tm = {}, {}
    for k in kinds:
        if k == "t5":
            c = sds["t5_cfg"]
            jcfg = jt5.T5Config(vocab=c.vocab, dim=c.dim, dim_attn=c.dim_attn, dim_ffn=c.dim_ffn,
                                num_heads=c.num_heads, num_layers=c.num_layers,
                                dtype=jnp.float32)
            jm[k] = (jt5.params_from_torch_state_dict(sds["t5"], jcfg), jcfg, None)
            tm[k] = (tt5.params_from_torch_state_dict(sds["t5"], c, device="cpu"), c, None)
        else:
            jm[k] = jload[k](fx.to_numpy(sds[k]))
            tm[k] = tload[k](sds[k], device="cpu")
    return jm, tm


_JITTED = {}


@pytest.fixture
def narrow(monkeypatch):
    """The narrow VAE plans; svi_tpu's blocks, its MMDiT and its text
    encoders jitted once per shape (eager JAX dispatches each operation)."""
    _patch_vae_plans(monkeypatch)
    fx.jit_jax_blocks(monkeypatch)
    if not _JITTED:
        _JITTED["dit"] = jax.jit(jsd3.sd3_dit_forward, static_argnames=(
            "patch_size", "tiled", "tile_size", "tile_stride"))
        _JITTED["te1"] = jax.jit(jsd3.sd3_text_encoder_1_forward, static_argnames=("clip_skip",))
        _JITTED["te2"] = jax.jit(jsdxl.sdxl_text_encoder_2_forward,
                                 static_argnames=("clip_skip",))
    monkeypatch.setattr(jsd3, "sd3_dit_forward", _JITTED["dit"])
    monkeypatch.setattr(jsd3, "sd3_text_encoder_1_forward", _JITTED["te1"])
    monkeypatch.setattr(jsdxl, "sdxl_text_encoder_2_forward", _JITTED["te2"])


def test_sd3_dit_dual_rms_and_from_jax(sds, narrow):
    """The MMDiT (a dual block with RMS q / k norms, a middle and the final
    block) on B2 latents 16 x 24 and 90 text tokens, loaded from the state
    dict and carried from svi_tpu's pytree (params_from_jax); tiled too."""
    jm, tm = _models(sds, ("dit",))
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((2, 16, 16, 24)).astype(np.float32)
    ctx = (rng.standard_normal((2, 90, 4096)) * 0.5).astype(np.float32)
    pooled = rng.standard_normal((2, 2048)).astype(np.float32)
    t = np.array([441.0, 441.0], np.float32)
    want = jsd3.sd3_dit_forward(jm["dit"], lat, t, ctx, pooled)
    from_jax = tsd3.params_from_jax(jax.tree.map(np.asarray, jm["dit"]), device="cpu")
    assert len(from_jax["dual_blocks"]) == 1 and len(from_jax["mid_blocks"]) == 1
    for params in (tm["dit"], from_jax):
        got = tsd3.sd3_dit_forward(params, *map(torch.from_numpy, (lat, t, ctx, pooled)))
        assert got.shape == want.shape == lat.shape and fx.rel(got, want) <= F32_REL
    args = (lat[:1, :, :8], t[:1], ctx[:1], pooled[:1])  # 3 tiles of 8
    want = jsd3.sd3_dit_forward(jm["dit"], *args, tiled=True, tile_size=8, tile_stride=8)
    got = tsd3.sd3_dit_forward(tm["dit"], *map(torch.from_numpy, args), tiled=True,
                               tile_size=8, tile_stride=8)
    assert fx.rel(got, want) <= F32_REL


def test_sd3_dit_plain_medium_layout(narrow):
    """SD3-medium's layout: no dual block, no q / k norms."""
    sd = tsd3.sd3_dit_state_dict(21, dim=64, num_layers=2, pos_embed_max=8)
    jp = jsd3.sd3_dit_params_from_torch(fx.to_numpy(sd))
    tp = tsd3.sd3_dit_params_from_torch(sd, device="cpu")
    assert not tp["dual_blocks"] and "norm_q_a" not in tp["final_block"]["attn"]
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((1, 16, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 20, 4096)).astype(np.float32)
    pooled = rng.standard_normal((1, 2048)).astype(np.float32)
    t = np.array([900.0], np.float32)
    want = jsd3.sd3_dit_forward(jp, lat, t, ctx, pooled)
    got = tsd3.sd3_dit_forward(tp, *map(torch.from_numpy, (lat, t, ctx, pooled)))
    assert fx.rel(got, want) <= F32_REL


def test_sd3_text_encoder_1_and_vae_round_trip(sds, narrow):
    """Text encoder 1's pooled and penultimate states (with the first row's
    extra mask), then the VAE encode and decode, tiled and not."""
    jm, tm = _models(sds, ("te1", "vae_encoder", "vae_decoder"))
    ids = np.random.default_rng(4).integers(0, 49408, (2, 77)).astype(np.int64)
    extra = np.ones((2, 77), np.int64)
    extra[0, 40:] = 0
    for mask in (None, extra):
        want = jsd3.sd3_text_encoder_1_forward(jm["te1"], jnp.asarray(ids), extra_mask=mask)
        got = tsd3.sd3_text_encoder_1_forward(tm["te1"], torch.from_numpy(ids), extra_mask=mask)
        assert fx.rel(got[0], want[0]) <= F32_REL and fx.rel(got[1], want[1]) <= F32_REL
    img = np.random.default_rng(5).uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32)
    for tiled in (False, True):
        kw = dict(tiled=tiled, tile_size=32, tile_stride=32)
        want = jsd3.sd3_vae_encode(jm["vae_encoder"], img, **kw)
        got = tsd3.sd3_vae_encode(tm["vae_encoder"], torch.from_numpy(img), **kw)
        assert got.shape == want.shape == (1, 16, 8, 8) and fx.rel(got, want) <= F32_REL
        kw = dict(tiled=tiled, tile_size=4, tile_stride=4)
        want = jsd3.sd3_vae_decode(jm["vae_decoder"], want, **kw)
        got = tsd3.sd3_vae_decode(tm["vae_decoder"], got, **kw)
        assert got.shape == want.shape == (1, 3, 64, 64) and fx.rel(got, want) <= F32_REL


def test_sd3_prompter_with_and_without_t5(sds, narrow):
    """Both CLIP windows zero-padded to 4096, then the T5 rows (zeros
    without T5); the pooled CLIP-L + bigG embedding."""
    jm, tm = _models(sds, ("te1", "te2", "t5"))
    jp, tp = JPrompter(), TPrompter()
    for t5_key in (None, "t5"):
        want = jp.encode_prompt(jm["te1"], jm["te2"], jm.get(t5_key), PROMPT, T5_LEN)
        got = tp.encode_prompt(tm["te1"], tm["te2"], tm.get(t5_key), PROMPT, T5_LEN)
        rows = 77 + (1 if t5_key else T5_LEN)
        assert got[0].shape == want[0].shape == (1, rows, 4096)
        assert got[1].shape == want[1].shape == (1, 2048)
        assert fx.rel(got[0], want[0]) <= F32_REL and fx.rel(got[1], want[1]) <= F32_REL


def test_sd3_image_pipeline_matches_jax(sds, narrow):
    """SD3ImagePipeline image-to-image at 64 x 64, strength 0.8, 2 steps,
    CFG 7.5 as one batch of two, T5 on: the decoded image before the uint8
    cast, then the frame."""
    jm, tm = _models(sds, ("dit", "te1", "te2", "t5", "vae_encoder", "vae_decoder"))
    names = ("dit", "te1", "te2", "t5", "vae_encoder", "vae_decoder")
    jpipe = jpipe_mod.SD3ImagePipeline(*(jm[k] for k in names))
    tpipe = tpipe_mod.SD3ImagePipeline(*(tm[k] for k in names))
    outs = {}
    for name, pipe in (("jax", jpipe), ("port", tpipe)):
        to_image = pipe.vae_output_to_image
        pipe.vae_output_to_image = lambda out, _n=name, _f=to_image: (
            outs.setdefault(_n, fx.np32(out)), _f(out))[1]
    image = np.random.default_rng(6).integers(0, 256, (64, 64, 3)).astype(np.uint8)
    kw = dict(prompt=PROMPT, negative_prompt="blurry", cfg_scale=7.5, denoising_strength=0.8,
              height=64, width=64, num_inference_steps=2, t5_sequence_length=T5_LEN, seed=7)
    from PIL import Image

    want = jpipe(input_image=Image.fromarray(image), **kw)
    got = tpipe(input_image=image, **kw)
    assert fx.rel(outs["port"], outs["jax"]) <= F32_REL
    assert got.shape == (64, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - np.asarray(want, int)).max() <= LEVELS
