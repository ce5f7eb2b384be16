"""FLUX in the port (svi_tpu_torch.models.flux, prompters.flux_prompter,
pipelines.flux_image) against svi_tpu on the CPU.

Both packages load the same seeded state dicts in the reference's diffsynth
names through their own converters: a DiT 128 wide (one head of 128, the
only width its 16 / 56 / 56 RoPE allows) with 2 joint and 2 single blocks
and a 32-wide text input, a union ControlNet with one block of each kind,
an IP-Adapter of 4 tokens over the 4 blocks, the 16-channel VAE at a quarter
of its channels (narrow plans patched into both packages), CLIP-L's text
tower at its 768 width with 2 layers and a one-layer T5 32 wide.

Tolerances: the RoPE tables within 1e-6; f32 forwards within 1e-4 of the
output's largest magnitude (two f32 implementations, sums in other orders);
TeaCache decisions equal; uint8 frames within one level.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from svi_tpu.models import flux as jflux
from svi_tpu.models import sd as jsd
from svi_tpu.models import sd3 as jsd3
from svi_tpu.models import t5 as jt5
from svi_tpu.pipelines import flux_image as jpipe_mod
from svi_tpu_torch.models import flux as tflux
from svi_tpu_torch.models import sd as tsd
from svi_tpu_torch.models import sd3 as tsd3
from svi_tpu_torch.models import t5 as tt5
from svi_tpu_torch.pipelines import flux_image as tpipe_mod

import torch_sd_fixtures as fx

F32_REL, ROPE_TOL, LEVELS = 1e-4, 1e-6, 1
DIM, TEXT = fx.FLUX_DIM, fx.FLUX_TEXT
T5_LEN = 16
PROMPT = "a lighthouse on a cliff at dusk"
VAE_ENC, VAE_DEC = fx.sd3_vae_plans()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


def _patch_vae_plans(monkeypatch):
    for mod in (jsd3, tsd3, jflux, tflux):
        monkeypatch.setattr(mod, "SD3_VAE_ENCODER_PLAN", VAE_ENC)
        monkeypatch.setattr(mod, "SD3_VAE_DECODER_PLAN", VAE_DEC)


_JITTED = {}


@pytest.fixture
def narrow(monkeypatch):
    """The narrow VAE plans; svi_tpu's blocks and its DiT pieces jitted once
    per shape."""
    _patch_vae_plans(monkeypatch)
    fx.jit_jax_blocks(monkeypatch)
    if not _JITTED:
        _JITTED["fwd"] = jax.jit(jflux.flux_dit_forward, static_argnames=(
            "tiled", "tile_size", "tile_stride"))
        _JITTED["te1"] = jax.jit(jsd3.sd3_text_encoder_1_forward, static_argnames=("clip_skip",))
    monkeypatch.setattr(jsd3, "sd3_text_encoder_1_forward", _JITTED["te1"])


@pytest.fixture(scope="module")
def sds():
    mp = pytest.MonkeyPatch()
    _patch_vae_plans(mp)
    out = fx.flux_state_dicts(seed=31)
    mp.undo()
    return out


_JLOAD = {"dit": jflux.flux_dit_params_from_torch, "dit_noguide": jflux.flux_dit_params_from_torch,
          "cnet": jflux.flux_controlnet_params_from_torch,
          "ip": jflux.flux_ipadapter_params_from_torch,
          "vae_encoder": jflux.flux_vae_encoder_params_from_torch,
          "vae_decoder": jflux.flux_vae_decoder_params_from_torch,
          "te1": jsd.sd_text_encoder_params_from_torch}
_TLOAD = {"dit": tflux.flux_dit_params_from_torch, "dit_noguide": tflux.flux_dit_params_from_torch,
          "cnet": tflux.flux_controlnet_params_from_torch,
          "ip": tflux.flux_ipadapter_params_from_torch,
          "vae_encoder": tflux.flux_vae_encoder_params_from_torch,
          "vae_decoder": tflux.flux_vae_decoder_params_from_torch,
          "te1": tsd.sd_text_encoder_params_from_torch}


def _models(sds, kinds):
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
            jm[k] = _JLOAD[k](fx.to_numpy(sds[k]))
            tm[k] = _TLOAD[k](sds[k], device="cpu", dtype=torch.float32)
    return jm, tm


def _inputs(seed, s_txt=TEXT // 2):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((1, 16, 16, 24)) * 0.5).astype(np.float32),
            np.array([700.0], np.float32),
            (rng.standard_normal((1, s_txt, TEXT)) * 0.1).astype(np.float32),
            (rng.standard_normal((1, 768)) * 0.1).astype(np.float32),
            np.array([3.5], np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_flux_rope_tables():
    ids = np.array([[[0.0, 0, 0], [0, 1, 0], [0, 2, 3], [0, 5, 7], [0, 31, 47]]], np.float32)
    want = jflux.flux_rope_tables(jnp.asarray(ids))
    got = tflux.flux_rope_tables(torch.from_numpy(ids))
    assert got[0].shape == want[0].shape == (1, 5, 64)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ROPE_TOL)
    lat = torch.zeros(2, 16, 6, 8)
    np.testing.assert_array_equal(tflux.prepare_image_ids(lat).numpy(),
                                  np.asarray(jflux.prepare_image_ids(jnp.zeros((2, 16, 6, 8)))))


@pytest.mark.parametrize("kind", ["dit", "dit_noguide"])
def test_flux_dit_with_and_without_guidance(sds, narrow, kind):
    """One DiT forward with the guidance embedder (2 + 2 blocks) and
    without it (1 + 1), loaded from the state dict and carried from
    svi_tpu's pytree (params_from_jax)."""
    jm, tm = _models(sds, (kind,))
    lat, t, ctx, pooled, g = _inputs(1)
    want = _JITTED["fwd"](jm[kind], lat, t, ctx, pooled, guidance=g)
    from_jax = tflux.params_from_jax(jax.tree.map(np.asarray, jm[kind]), dtype=torch.float32,
                                     device="cpu")
    assert ("guidance_embedder" in from_jax) == (kind == "dit")
    for params in (tm[kind], from_jax):
        got = tflux.flux_dit_forward(params, *_t(lat, t, ctx, pooled), guidance=_t(g)[0])
        assert got.shape == want.shape == lat.shape and fx.rel(got, want) <= F32_REL


def test_flux_dit_eligen_entity_masks(sds, narrow):
    """Two entity prompts with their block attention mask (the plain
    softmax path), on the DiT and through its split prelude / blocks / head
    and the TeaCache signal."""
    jm, tm = _models(sds, ("dit",))
    lat, t, ctx, pooled, g = _inputs(2)
    rng = np.random.default_rng(3)
    ent = (rng.standard_normal((1, 2, TEXT // 2, TEXT)) * 0.1).astype(np.float32)
    masks = np.zeros((1, 2, 1, 16, 24), np.float32)
    masks[:, 0, :, :, :12] = 1.0
    masks[:, 1, :, :8, 12:] = 1.0
    want = _JITTED["fwd"](jm["dit"], lat, t, ctx, pooled, guidance=g,
                          entity_prompt_emb=ent, entity_masks=masks)
    got = tflux.flux_dit_forward(tm["dit"], *_t(lat, t, ctx, pooled), guidance=_t(g)[0],
                                 entity_prompt_emb=_t(ent)[0], entity_masks=_t(masks)[0])
    assert fx.rel(got, want) <= F32_REL
    xa, _, temb, *_ = tflux.flux_dit_prelude(tm["dit"], *_t(lat, t, ctx, pooled),
                                             guidance=_t(g)[0])
    jxa, _, jtemb, *_ = jflux.flux_dit_prelude(jm["dit"], lat, t, ctx, pooled, guidance=g)
    assert fx.rel(tflux.flux_teacache_modulated(tm["dit"], xa, temb),
                  jflux.flux_teacache_modulated(jm["dit"], jxa, jtemb)) <= F32_REL


def test_flux_controlnet_and_ipadapter_through_dit(sds, narrow):
    """The union ControlNet's residuals (task 1) aligned to the DiT's blocks,
    the IP-Adapter's per-block K / V from a SigLIP-sized embedding, then the
    DiT with both (scale 0.7 and 0.9)."""
    jm, tm = _models(sds, ("dit", "cnet", "ip"))
    lat, t, ctx, pooled, g = _inputs(4)
    cond = (np.random.default_rng(5).standard_normal(lat.shape) * 0.5).astype(np.float32)
    jres = jflux.flux_controlnet_forward(jm["cnet"], lat, cond, t, ctx, pooled, g,
                                         processor_id_index=1, num_joint_out=2,
                                         num_single_out=2)
    tres = tflux.flux_controlnet_forward(tm["cnet"], *_t(lat, cond, t, ctx, pooled, g),
                                         processor_id_index=1, num_joint_out=2,
                                         num_single_out=2)
    for a, b in zip(tres, jres):
        assert a.shape == b.shape and fx.rel(a, b) <= F32_REL
    emb = (np.random.default_rng(6).standard_normal((1, 1152)) * 0.3).astype(np.float32)
    jip = jflux.flux_ipadapter_forward(jm["ip"], jnp.asarray(emb), scale=0.9, num_heads=1)
    tip = tflux.flux_ipadapter_forward(tm["ip"], torch.from_numpy(emb), scale=0.9, num_heads=1)
    assert tip[0].shape == jip[0].shape == (4, 1, 4, 1, 128)
    assert fx.rel(tip[0], jip[0]) <= F32_REL and fx.rel(tip[1], jip[1]) <= F32_REL
    want = _JITTED["fwd"](jm["dit"], lat, t, ctx, pooled, guidance=g,
                          controlnet_res=tuple(r * 0.7 for r in jres), ipadapter=jip)
    got = tflux.flux_dit_forward(tm["dit"], *_t(lat, t, ctx, pooled), guidance=_t(g)[0],
                                 controlnet_res=tuple(r * 0.7 for r in tres), ipadapter=tip)
    assert fx.rel(got, want) <= F32_REL


@pytest.mark.parametrize("thresh", [0.0, 0.05, 0.3, 1e9])
def test_flux_teacache_decisions(thresh):
    """The skip decisions over 8 steps of drifting modulated inputs equal
    svi_tpu's, and the stored residual is reused as its."""
    jtc = jpipe_mod.FluxTeaCache(8, thresh)
    ttc = tpipe_mod.FluxTeaCache(8, thresh)
    rng = np.random.default_rng(7)
    m = rng.standard_normal((1, 8, 16)).astype(np.float32)
    decisions = []
    for _ in range(8):
        m = m + (rng.standard_normal(m.shape) * 0.02).astype(np.float32)
        want = jtc.check(m)
        assert ttc.check(torch.from_numpy(m)) is want
        decisions.append(want)
    assert decisions[0] is False and decisions[-1] is False
    pre, post = (rng.standard_normal((1, 8, 16)).astype(np.float32) for _ in range(2))
    jtc.store(pre, post)
    ttc.store(*_t(pre, post))
    np.testing.assert_allclose(ttc.update(torch.from_numpy(post)).numpy(), jtc.update(post),
                               atol=1e-6)


def _run_pipelines(jm, tm, jkw, tkw, kw):
    names = ("dit", "te1", "t5", "vae_encoder", "vae_decoder")
    jpipe = jpipe_mod.FluxImagePipeline(*(jm[k] for k in names), dtype=jnp.float32)
    tpipe = tpipe_mod.FluxImagePipeline(*(tm[k] for k in names), dtype=torch.float32)
    outs = {}
    for name, pipe in (("jax", jpipe), ("port", tpipe)):
        to_image = pipe.vae_output_to_image
        pipe.vae_output_to_image = lambda out, _n=name, _f=to_image: (
            outs.setdefault(_n, fx.np32(out)), _f(out))[1]
    want, got = jpipe(**jkw, **kw), tpipe(**tkw, **kw)
    assert fx.rel(outs["port"], outs["jax"]) <= F32_REL
    assert got.shape == (64, 64, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - np.asarray(want, int)).max() <= LEVELS


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3)).astype(np.uint8) for _ in range(n)]


def test_flux_pipeline_controlnet_ipadapter_cfg(sds, narrow, monkeypatch):
    """FluxImagePipeline for 2 steps at 64 x 64: a ControlNet unit on an
    image (VAE-encoded), an IP-Adapter embedding, true CFG 2.0 (the positive
    branch carries the extras, the negative runs alone), guidance 3.5. Both
    pipelines call the IP-Adapter at FLUX's 24 heads: patched to this DiT's
    one."""
    import functools

    for mod in (jflux, tflux):
        monkeypatch.setattr(mod, "flux_ipadapter_forward",
                            functools.partial(mod.flux_ipadapter_forward, num_heads=1))
    jm, tm = _models(sds, ("dit", "cnet", "ip", "te1", "t5", "vae_encoder", "vae_decoder"))
    cond = _images(1, 8)[0]
    emb = (np.random.default_rng(9).standard_normal((1, 1152)) * 0.3).astype(np.float32)
    kw = dict(prompt=PROMPT, negative_prompt="fog", cfg_scale=2.0, height=64, width=64,
              num_inference_steps=2, t5_sequence_length=T5_LEN, seed=10, ipadapter_scale=0.8)
    _run_pipelines(
        jm, tm,
        dict(controlnet_units=[(jm["cnet"], Image.fromarray(cond), 0.6, 0)],
             ipadapter_params=jm["ip"], ipadapter_image_emb=emb),
        dict(controlnet_units=[(tm["cnet"], cond, 0.6, 0)], ipadapter_params=tm["ip"],
             ipadapter_image_emb=emb), kw)


def test_flux_pipeline_eligen_teacache_inpaint(sds, narrow):
    """FluxImagePipeline for 2 steps at 64 x 64, image-to-image at strength
    0.9: one EliGen entity with its mask, EliGen inpainting, TeaCache."""
    jm, tm = _models(sds, ("dit", "te1", "t5", "vae_encoder", "vae_decoder"))
    image = _images(1, 11)[0]
    mask = np.zeros((64, 64, 3), np.uint8)
    mask[8:40, 16:56] = 255
    kw = dict(prompt=PROMPT, height=64, width=64, num_inference_steps=2, denoising_strength=0.9,
              t5_sequence_length=T5_LEN, seed=12, eligen_entity_prompts=["a red door"],
              enable_eligen_inpaint=True, tea_cache_l1_thresh=0.3)
    _run_pipelines(jm, tm, dict(input_image=Image.fromarray(image),
                                eligen_entity_masks=[Image.fromarray(mask)]),
                   dict(input_image=image, eligen_entity_masks=[mask]), kw)
