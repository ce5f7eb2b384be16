"""Parity of the PyTorch port's models with svi_tpu's, at tiny sizes on the CPU.

Weights come from svi_tpu's `init_params` and are carried across with the
port's `params_from_jax`; inputs come from np.random.default_rng(seed).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import clip_vision as jclip
from svi_tpu.models import t5 as jt5
from svi_tpu.models import wan_dit as jdit
from svi_tpu.models import wan_vae as jvae
from svi_tpu_torch.models import clip_vision as tclip
from svi_tpu_torch.models import t5 as tt5
from svi_tpu_torch.models import wan_dit as tdit
from svi_tpu_torch.models import wan_vae as tvae

# f32 forward through a few layers of matmuls, norms and attention, summed in
# another order by each framework
F32_TOL = 1e-4


def _np(x):
    return np.asarray(x, np.float32)


def _host(params):
    return jax.tree.map(np.asarray, params)


def _dit_cfgs(dtype_j, dtype_t):
    kw = dict(dim=64, in_dim=12, ffn_dim=128, out_dim=4, text_dim=48, freq_dim=32,
              num_heads=2, num_layers=2, has_image_input=True, clip_feature_dim=40)
    return jdit.WanDiTConfig(dtype=dtype_j, **kw), tdit.WanDiTConfig(dtype=dtype_t, **kw)


def _dit_inputs(rng):
    x = rng.standard_normal((2, 4, 3, 8, 8)).astype(np.float32)
    y = rng.standard_normal((2, 8, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 12, 48)).astype(np.float32)
    clip = rng.standard_normal((2, 5, 40)).astype(np.float32)
    t = np.array([731.0], np.float32)
    return x, t, ctx, clip, y


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dit_i2v_forward_matches_jax(dtype):
    dj, dt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    cfg_j, cfg_t = _dit_cfgs(dj, dt)
    params = jdit.init_params(jax.random.PRNGKey(0), cfg_j)
    model = tdit.params_from_jax(_host(params), cfg_t)
    inputs = _dit_inputs(np.random.default_rng(0))
    fwd = jax.jit(lambda p, x, t, c, cf, y: jdit.forward(p, cfg_j, x, t, c, clip_feature=cf, y=y))
    want = _np(fwd(params, *(jnp.asarray(a) for a in inputs)))
    with torch.inference_mode():
        got = _np(model(*(torch.from_numpy(a) for a in inputs)).float())
    assert got.shape == want.shape == (2, 4, 3, 8, 8)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        # bf16 rounds after each op in PyTorch but inside fused f32 regions in
        # XLA: the two drift by a few bf16 ulps (2^-8 relative) per layer
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 2e-2, rel


def test_dit_split_forward_equals_forward():
    """prelude -> blocks -> head (the TeaCache path) is the same computation."""
    cfg_j, cfg_t = _dit_cfgs(jnp.float32, torch.float32)
    model = tdit.params_from_jax(_host(jdit.init_params(jax.random.PRNGKey(1), cfg_j)), cfg_t)
    x, t, ctx, clip, y = (torch.from_numpy(a) for a in _dit_inputs(np.random.default_rng(1)))
    with torch.inference_mode():
        whole = model(x, t, ctx, clip, y)
        tokens, c, te, tm, grid = model.forward_prelude(x, t, ctx, clip, y)
        split = model.forward_head(model.forward_blocks(tokens, c, tm, grid, num_img_tokens=5),
                                   te, grid)
    torch.testing.assert_close(split, whole, atol=0, rtol=0)


def _vae_pair(seed):
    cfg_j = jvae.WanVAEConfig(dim=16, z_dim=4, dtype=jnp.float32)
    params = _host(jax.jit(jvae.init_params, static_argnums=1)(jax.random.PRNGKey(seed), cfg_j))
    # the attention output projection is zero-initialized; give it weights so
    # the mid-block attention shows in the output
    rng = np.random.default_rng(seed)
    for stack in ("encoder", "decoder"):
        for layer, (kind, cin, _) in zip(params[stack], getattr(jvae, f"{stack}_plan")(cfg_j)):
            if kind == "attn":
                layer["proj"]["w"] = (rng.standard_normal((1, 1, cin, cin)) / cin ** 0.5
                                      ).astype(np.float32)
    cfg_t = tvae.WanVAEConfig(dim=16, z_dim=4)
    return cfg_j, params, tvae.params_from_jax(params, cfg_t)


def test_vae_encode_matches_jax():
    cfg_j, params, model = _vae_pair(0)
    video = np.random.default_rng(0).uniform(-1, 1, (1, 3, 9, 32, 32)).astype(np.float32)
    want = _np(jax.jit(lambda p, v: jvae.encode(p, cfg_j, v))(params, jnp.asarray(video)))
    with torch.inference_mode():
        got = _np(model.encode(torch.from_numpy(video)))
    assert got.shape == want.shape == (1, 4, 3, 4, 4)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_vae_decode_matches_jax():
    cfg_j, params, model = _vae_pair(1)
    lat = np.random.default_rng(1).standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    want = _np(jax.jit(lambda p, z: jvae.decode(p, cfg_j, z))(params, jnp.asarray(lat)))
    with torch.inference_mode():
        got = _np(model.decode(torch.from_numpy(lat)))
    assert got.shape == want.shape == (1, 3, 9, 32, 32)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def _clip_pair():
    kw = dict(image_size=28, patch_size=14, dim=40, mlp_ratio=2, num_heads=2, num_layers=2)
    cfg_j = jclip.ClipVisionConfig(dtype=jnp.float32, **kw)
    params = jclip.init_params(jax.random.PRNGKey(2), cfg_j)
    return cfg_j, params, tclip.params_from_jax(_host(params), tclip.ClipVisionConfig(**kw))


def test_clip_tokens_and_encode_image_match_jax():
    cfg_j, params, model = _clip_pair()
    rng = np.random.default_rng(2)
    pixels = rng.standard_normal((2, 3, 28, 28)).astype(np.float32)
    frames = rng.uniform(-1, 1, (1, 3, 20, 24)).astype(np.float32)
    with torch.inference_mode():
        tok = _np(model.forward_tokens(torch.from_numpy(pixels)))
        enc = _np(model.encode_image(torch.from_numpy(frames)))
    np.testing.assert_allclose(
        tok, _np(jclip.forward_tokens(params, cfg_j, jnp.asarray(pixels))),
        atol=F32_TOL, rtol=F32_TOL)
    want = _np(jclip.encode_image(params, cfg_j, jnp.asarray(frames)))
    assert enc.shape == want.shape == (1, 5, 40)
    np.testing.assert_allclose(enc, want, atol=F32_TOL, rtol=F32_TOL)


def test_t5_forward_and_prompt_states_match_jax():
    kw = dict(vocab=100, dim=64, dim_attn=64, dim_ffn=128, num_heads=4, num_layers=3)
    cfg_j = jt5.T5Config(dtype=jnp.float32, **kw)
    params = jt5.init_params(jax.random.PRNGKey(3), cfg_j)
    model = tt5.params_from_jax(_host(params), tt5.T5Config(dtype=torch.float32, **kw))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, kw["vocab"], (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[0, 10:] = 0
    mask[1, 5:] = 0
    with torch.inference_mode():
        got = _np(model(torch.from_numpy(ids), torch.from_numpy(mask)))
        states = _np(model.encode_prompt_states(torch.from_numpy(ids), torch.from_numpy(mask)))
    np.testing.assert_allclose(got, _np(jt5.forward(params, cfg_j, jnp.asarray(ids),
                                                    jnp.asarray(mask))),
                               atol=F32_TOL, rtol=F32_TOL)
    want = _np(jt5.encode_prompt_states(params, cfg_j, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(states, want, atol=F32_TOL, rtol=F32_TOL)
    assert np.all(states[0, 10:] == 0) and np.all(states[1, 5:] == 0)
    np.testing.assert_array_equal(tt5.relative_position_buckets(40, 32, 128),
                                  jt5.relative_position_buckets(40, 32, 128))


@pytest.mark.parametrize("module", [tdit, tvae, tclip, tt5])
def test_seeded_init_is_reproducible(module):
    cfgs = {
        tdit: tdit.WanDiTConfig(dim=32, in_dim=12, ffn_dim=64, out_dim=4, text_dim=16,
                                freq_dim=16, num_heads=2, num_layers=1, has_image_input=True,
                                clip_feature_dim=8),
        tvae: tvae.WanVAEConfig(dim=8, z_dim=4),
        tclip: tclip.ClipVisionConfig(image_size=28, patch_size=14, dim=16, num_heads=2,
                                      num_layers=1, mlp_ratio=2),
        tt5: tt5.T5Config(vocab=50, dim=16, dim_attn=16, dim_ffn=32, num_heads=2, num_layers=1),
    }
    a = module.init_params(cfgs[module], seed=5, device="cpu").state_dict()
    b = module.init_params(cfgs[module], seed=5, device="cpu").state_dict()
    c = module.init_params(cfgs[module], seed=6, device="cpu").state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
