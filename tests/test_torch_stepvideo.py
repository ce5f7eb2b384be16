"""StepVideo in the port (svi_tpu_torch.models.stepvideo, .stepvideo_vae,
prompters.stepvideo_prompter, pipelines.step_video) against svi_tpu on the
CPU.

Both packages load the same seeded state dicts in the reference's names
through their own converters (tests/torch_video_fixtures.py): the DiT at 2
heads of 128 (the RoPE's (64, 32, 32) split pins the head at 128) with 2
blocks, 8 latent channels and narrow captions; Step1 64 wide with 4 heads in
2 groups; the VAE with 8 latent channels at 32 / 64 channels. svi_tpu's
pytrees are also carried across by `params_from_jax`. The CLIP encoder and
the tokenizer are the caller's in both packages: a seeded table and a
tokenizer of fixed ids.

Tolerances: the RoPE tables and the rotation within 1e-6 (the same f32
numpy and f32 products); the tokenizer, the mask and the scheduler's table
equal; f32 forwards within 1e-4 of the output's largest magnitude (two f32
implementations, sums in other orders); the pipeline's decoded video within
1e-4 and its uint8 frames within one level.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import stepvideo as jsv
from svi_tpu.models import stepvideo_vae as jsvae
from svi_tpu.pipelines import step_video as jpipe_mod
from svi_tpu.prompters import stepvideo_prompter as jprompt
from svi_tpu.schedulers.flow_match import FlowMatchScheduler as JFlowMatch
from svi_tpu_torch.models import stepvideo as tsv
from svi_tpu_torch.models import stepvideo_vae as tsvae
from svi_tpu_torch.pipelines import step_video as tpipe_mod
from svi_tpu_torch.prompters import stepvideo_prompter as tprompt
from svi_tpu_torch.schedulers.flow_match import FlowMatchScheduler as TFlowMatch

import torch_sd_fixtures as fx
import torch_video_fixtures as vfx

ROPE_TOL, F32_REL, LEVELS = 1e-6, 1e-4, 1
HEADS = vfx.STEP_DIT["num_heads"]
S1 = vfx.STEP1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def sds():
    return vfx.stepvideo_state_dicts(seed=71)


@pytest.fixture(scope="module")
def jit():
    """svi_tpu's forwards, each jitted once for the module (eager JAX takes
    minutes)."""
    return dict(
        dit=jax.jit(jsv.stepvideo_dit_forward, static_argnames=("num_heads", "head_dim")),
        step1=jax.jit(jsv.step1_encode, static_argnames=("num_heads", "num_groups")),
        enc=jax.jit(jsvae.stepvideo_vae_encode_chunk),
        dec=jax.jit(jsvae.stepvideo_vae_decode_chunk))


@pytest.fixture(scope="module")
def jvae(sds):
    return jsvae.stepvideo_vae_params_from_torch(fx.to_numpy(sds["vae"]))


def _vaes(sds, jvae):
    return (tsvae.stepvideo_vae_params_from_torch(sds["vae"], device="cpu"),
            tsvae.params_from_jax(jvae, device="cpu"))


def _dit_inputs(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((1, 14), np.int64)
    mask[:, 11:] = 0
    return dict(x=(rng.standard_normal((1, 3, 8, 4, 6)) * 0.5).astype(np.float32),
                llm=(rng.standard_normal((1, 10, 64)) * 0.2).astype(np.float32),
                clip=(rng.standard_normal((1, 4, 24)) * 0.2).astype(np.float32), mask=mask,
                t=np.array([0.7], np.float32))


def test_rope_tables_and_rotation_match_svi_tpu():
    for args in ((3, 4, 6), (9, 34, 62)):
        for ours, theirs in zip(tsv.prepare_stepvideo_rope(*args),
                                jsv.prepare_stepvideo_rope(*args)):
            assert np.abs(ours - theirs).max() <= ROPE_TOL
    cos, sin = jsv.prepare_stepvideo_rope(3, 4, 5)
    x = np.random.default_rng(72).standard_normal((1, 60, 2, 128)).astype(np.float32)
    want = np.asarray(jsv._rope_apply(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin)))
    got = tsv._rope_apply(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin))
    assert np.abs(got.numpy() - want).max() <= ROPE_TOL


def test_dit_forward_matches_svi_tpu(sds, jit):
    jdit = jsv.stepvideo_dit_params_from_torch(fx.to_numpy(sds["dit"]))
    x = _dit_inputs(73)
    want = np.asarray(jit["dit"](jdit, jnp.asarray(x["x"]), jnp.asarray(x["llm"]),
                                 jnp.asarray(x["mask"]), jnp.asarray(x["t"]),
                                 encoder_hidden_states_2=jnp.asarray(x["clip"]),
                                 num_heads=HEADS, head_dim=128))
    with torch.no_grad():
        for dit in (tsv.stepvideo_dit_params_from_torch(sds["dit"], device="cpu",
                                                        dtype=torch.float32),
                    tsv.params_from_jax(jdit, device="cpu")):
            got = tsv.stepvideo_dit_forward(
                dit, torch.from_numpy(x["x"]), torch.from_numpy(x["llm"]),
                torch.from_numpy(x["mask"]), torch.from_numpy(x["t"]),
                encoder_hidden_states_2=torch.from_numpy(x["clip"]), num_heads=HEADS,
                head_dim=128)
            assert got.shape == want.shape == (1, 3, 8, 4, 6)
            assert fx.rel(fx.np32(got), want) < F32_REL


def test_step1_matches_svi_tpu(sds, jit):
    jp = jsv.step1_params_from_torch(fx.to_numpy(sds["step1"]))
    ids = np.random.default_rng(74).integers(0, S1["vocab"], (2, 12))
    want = np.asarray(jit["step1"](jp, jnp.asarray(ids), num_heads=S1["num_heads"],
                                   num_groups=S1["num_groups"]))
    with torch.no_grad():
        for p in (tsv.step1_params_from_torch(sds["step1"], device="cpu", dtype=torch.float32),
                  tsv.params_from_jax(jp, device="cpu")):
            got = tsv.step1_encode(p, ids, S1["num_heads"], S1["num_groups"])
            assert got.shape == want.shape == (2, 12, S1["dim"])
            assert fx.rel(fx.np32(got), want) < F32_REL


def test_vae_encoder_matches_svi_tpu(sds, jit, jvae):
    video = np.random.default_rng(75).uniform(-1, 1, (1, 17, 3, 64, 96)).astype(np.float32)
    want = np.asarray(jit["enc"](jvae, jnp.asarray(video)))
    with torch.no_grad():
        for vae in _vaes(sds, jvae):
            got = tsvae.stepvideo_vae_encode_chunk(vae, torch.from_numpy(video))
            assert got.shape == want.shape == (1, 3, 16, 4, 6)
            assert fx.rel(fx.np32(got), want) < F32_REL
            mean = tsvae.stepvideo_vae_encode(vae, torch.from_numpy(video))
            assert torch.equal(mean, got[:, :, :8])


def test_vae_decoder_matches_svi_tpu(sds, jit, jvae):
    z = (np.random.default_rng(76).standard_normal((1, 3, 8, 4, 6)) * 0.5).astype(np.float32)
    want = np.asarray(jit["dec"](jvae, jnp.asarray(z)))
    with torch.no_grad():
        for vae in _vaes(sds, jvae):
            got = tsvae.stepvideo_vae_decode_chunk(vae, torch.from_numpy(z))
            assert got.shape == want.shape == (1, 3, 17, 64, 96)
            assert fx.rel(fx.np32(got), want) < F32_REL


def test_vae_chunked_decode_with_mix_matches_svi_tpu(sds, jit, jvae):
    """Two latent chunks (6 frames): 34 frames, the chunks' edge frames
    blended (svi_tpu's chunk decode compiled once, at the decoder test's
    shape)."""
    z = (np.random.default_rng(77).standard_normal((1, 6, 8, 4, 6)) * 0.5).astype(np.float32)
    want = np.asarray(jsvae.stepvideo_vae_decode(
        jvae, jnp.asarray(z), decode_chunk_fn=lambda c: jit["dec"](jvae, c)))
    vae = _vaes(sds, jvae)[0]
    with torch.no_grad():
        got = tsvae.stepvideo_vae_decode(vae, torch.from_numpy(z))
    assert got.shape == want.shape == (1, 34, 3, 64, 96)
    assert fx.rel(fx.np32(got), want) < F32_REL
    x = np.random.default_rng(78).standard_normal((1, 34, 2)).astype(np.float32)
    np.testing.assert_allclose(tsvae.mix(torch.from_numpy(x)).numpy(),
                               np.asarray(jsvae.mix(jnp.asarray(x))), rtol=0, atol=1e-6)


def test_vae_tiled_decode_matches_svi_tpu(sds, jit, jvae):
    """Feathered 4 x 6 tiles at stride (2, 3) over a 6 x 9 latent: four
    tiles, each at the decoder test's shape."""
    z = (np.random.default_rng(79).standard_normal((1, 3, 8, 6, 9)) * 0.5).astype(np.float32)
    want = np.asarray(jsvae.stepvideo_vae_tiled_decode(
        jvae, jnp.asarray(z), tile_size=(4, 6), tile_stride=(2, 3),
        decode_chunk_fn=lambda c: jit["dec"](jvae, c)))
    vae = _vaes(sds, jvae)[0]
    with torch.no_grad():
        got = tsvae.stepvideo_vae_tiled_decode(vae, torch.from_numpy(z), tile_size=(4, 6),
                                               tile_stride=(2, 3))
    assert got.shape == want.shape == (1, 17, 3, 96, 144)
    assert fx.rel(fx.np32(got), want) < F32_REL


def _tokenizer(text):
    """A tokenizer of fixed ids (a stand-in for Step1's sentencepiece)."""
    return [ord(ch) % 40 + 3 for ch in text]


def test_step1_tokenize_matches_svi_tpu():
    for texts in ("a red fox in the snow", ["", "ab"], [], ["x" * 400]):
        for ours, theirs in zip(tsv.step1_tokenize(texts, _tokenizer, 16),
                                jsv.step1_tokenize(texts, _tokenizer, 16)):
            np.testing.assert_array_equal(ours, theirs)
            assert ours.dtype == theirs.dtype


def test_scheduler_table_matches_svi_tpu():
    """The pipeline's scheduler: sigma_min 0, one extra step, shift 13,
    reversed sigmas, one training timestep."""
    kw = dict(sigma_min=0.0, extra_one_step=True, shift=13.0, reverse_sigmas=True,
              num_train_timesteps=1)
    j, t = JFlowMatch(**kw), TFlowMatch(**kw)
    for steps in (6, 30):
        j.set_timesteps(steps)
        t.set_timesteps(steps)
        np.testing.assert_array_equal(t.sigmas.numpy(), np.asarray(j.sigmas))
        np.testing.assert_array_equal(t.timesteps.numpy(), np.asarray(j.timesteps))


class _Clip:
    """A seeded table over the characters standing in for CLIP-BERT: prompt
    list -> (B, 4, 24)."""

    def __init__(self):
        self.table = np.random.default_rng(80).standard_normal((64, 24)).astype(np.float32) * 0.2

    def __call__(self, prompts):
        return np.stack([self.table[[ord(c) % 64 for c in (p + "    ")[:4]]] for p in prompts])


def _prompters(sds):
    jp = jprompt.StepVideoPrompter(_Clip(), jsv.step1_params_from_torch(fx.to_numpy(sds["step1"])),
                                   _tokenizer, num_heads=S1["num_heads"],
                                   num_groups=S1["num_groups"], dtype=jnp.float32)
    tp = tprompt.StepVideoPrompter(_Clip(), tsv.step1_params_from_torch(
        sds["step1"], device="cpu", dtype=torch.float32), _tokenizer,
        num_heads=S1["num_heads"], num_groups=S1["num_groups"], dtype=torch.float32)
    return jp, tp


def test_prompter_matches_svi_tpu(sds):
    jp, tp = _prompters(sds)
    (jc, jl, jm), (tc, tl, tm) = jp("a red fox", max_length=24), tp("a red fox", max_length=24)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tm, jm)
    assert tm.shape == (1, 4 + 24)
    assert fx.rel(tl, jl) < F32_REL


def test_pipeline_matches_svi_tpu(sds, jit, jvae):
    """StepVideoPipeline in f32: 17 frames at 64 x 96 (3 latent frames, one
    chunk of the untiled decode), 2 steps with CFG 9 over the prompters'
    embeddings: the decoded video within F32_REL, the frames within LEVELS."""
    jp, tp = _prompters(sds)
    emb = {"posi": jp("a red fox running through snow", max_length=24),
           "nega": jp("blurry", max_length=24)}
    temb = {"posi": tp("a red fox running through snow", max_length=24),
            "nega": tp("blurry", max_length=24)}
    kw = dict(seed=5, height=64, width=96, num_frames=17, num_inference_steps=2,
              cfg_scale=9.0, tiled=False)
    decoded = {}
    jpipe = jpipe_mod.StepVideoPipeline(jsv.stepvideo_dit_params_from_torch(
        fx.to_numpy(sds["dit"])), vae_params=jvae, dtype=jnp.float32)
    jdecode = jsvae.stepvideo_vae_decode
    jpipe_mod.svae.stepvideo_vae_decode = lambda p, lat, **k: decoded.setdefault(
        "jax", jdecode(p, lat, smooth_scale=k["smooth_scale"],
                       decode_chunk_fn=lambda c: jit["dec"](jvae, c)))
    try:
        want = [np.asarray(f) for f in jpipe("", prompt_emb_posi=emb["posi"],
                                             prompt_emb_nega=emb["nega"], **kw)]
    finally:
        jpipe_mod.svae.stepvideo_vae_decode = jdecode
    tpipe = tpipe_mod.StepVideoPipeline(
        tsv.stepvideo_dit_params_from_torch(sds["dit"], device="cpu", dtype=torch.float32),
        vae_params=tsvae.stepvideo_vae_params_from_torch(sds["vae"], device="cpu"),
        prompter=tp, dtype=torch.float32)
    tdecode = tsvae.stepvideo_vae_decode
    tpipe_mod.svae.stepvideo_vae_decode = lambda *a, **k: decoded.setdefault(
        "torch", tdecode(*a, **k))
    try:
        got = tpipe("a red fox running through snow", negative_prompt="blurry",
                    prompt_emb_posi=temb["posi"], prompt_emb_nega=temb["nega"], **kw)
    finally:
        tpipe_mod.svae.stepvideo_vae_decode = tdecode
    assert fx.rel(fx.np32(decoded["torch"]), np.asarray(decoded["jax"])) < F32_REL
    assert len(got) == len(want) == 17 and got[0].shape == (64, 96, 3)
    assert max(np.abs(a.astype(int) - b.astype(int)).max() for a, b in zip(got, want)) <= LEVELS
