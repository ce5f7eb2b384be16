"""Parity of the port's Error-Recycling LoRA training (svi_tpu_torch.training)
with svi_tpu's.

Inputs and weights come from a seed through numpy (weights from svi_tpu's
init_params, carried across with params_from_jax); both packages run on the
CPU, where the port's attention takes its plain forward and backward. The
whole trainer is compared over 3 steps: the same host RNG draws the same
timesteps, noise and error injections in both, and the device step (forward
with LoRA, weighted loss, backward, optax-rule clip, AdamW) agrees to f32.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_tpu.models import wan_dit as jdit
from svi_tpu.schedulers import flow_match as jfm
from svi_tpu.training import ErrorRecyclingTrainer as JTrainer
from svi_tpu.training import TrainerConfig as JConfig
from svi_tpu.training import error_recycling as jer
from svi_tpu.training import lora as jlora
from svi_tpu_torch.models import wan_dit as tdit
from svi_tpu_torch.schedulers import flow_match as tfm
from svi_tpu_torch.training import ErrorRecyclingTrainer as TTrainer
from svi_tpu_torch.training import TrainerConfig as TConfig
from svi_tpu_torch.training import error_recycling as ter
from svi_tpu_torch.training import lora as tlora

# a 2-layer f32 I2V DiT: 2 heads of 32, a 2 x 8 x 8 latent grid (32 tokens)
DIT_KW = dict(dim=64, in_dim=12, ffn_dim=128, out_dim=4, text_dim=48, freq_dim=32,
              num_heads=2, num_layers=2, has_image_input=True, clip_feature_dim=40)
TRAIN_KW = dict(lora_rank=4, lora_alpha=4.0, buffer_warmup_iter=2, error_buffer_k=8,
                num_grids=10, seed=0)


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("steps,training", [(1000, True), (40, False), (50, True)])
def test_schedule_matches_jax_exactly(steps, training):
    kw = dict(shift=5.0, sigma_min=0.0, extra_one_step=True, training=training)
    got, want = tfm.make_schedule(steps, **kw), jfm.make_schedule(steps, **kw)
    # the same float64 numpy recipe rounded once to f32: bit-identical
    np.testing.assert_array_equal(got.sigmas.numpy(), _np(want.sigmas))
    np.testing.assert_array_equal(got.timesteps.numpy(), _np(want.timesteps))
    assert got.sigmas.dtype == got.timesteps.dtype == torch.float32
    if training:
        assert got.training_weights.dtype == torch.float32
        np.testing.assert_array_equal(got.training_weights.numpy(),
                                      _np(want.training_weights))
    else:
        assert got.training_weights is None and want.training_weights is None


@pytest.mark.parametrize("strategy,all_grids", [("random", False), ("fifo", True),
                                                ("l2_batch", False)])
def test_error_buffers_match_jax(strategy, all_grids):
    """The same seed banks, replaces and samples the same arrays."""
    kw = dict(num_grids=6, buffer_size=3, replacement_strategy=strategy,
              y_error_sample_from_all_grids=all_grids)
    got = ter.ErrorBuffers(rng=random.Random(7), **kw)
    want = jer.ErrorBuffers(rng=random.Random(7), **kw)
    np.testing.assert_array_equal(got.grid_timesteps, want.grid_timesteps)
    data = np.random.default_rng(0)
    shape = (1, 4, 2, 3, 3)
    for i in range(30):
        t = float(data.uniform(0, 1000))
        assert got.grid_index(t) == want.grid_index(t)
        err = data.standard_normal(shape).astype(np.float32)
        for buf in (got, want):
            (buf.add_latent_error if i % 2 else buf.add_y_error)(err, t)
        for name in ("sample_noise_error", "sample_latent_error", "sample_y_error"):
            np.testing.assert_array_equal(getattr(got, name)(shape, t),
                                          getattr(want, name)(shape, t))
        assert got.has_y_data(t) == want.has_y_data(t)
    assert got.stats() == want.stats()
    assert got.rng.getstate() == want.rng.getstate()


def _trainers(use_remat: bool = True):
    """JAX's trainer and the port's on the same base weights and adapters (B
    non-zero, so that every adapter gets a gradient from step 1)."""
    cj = jdit.WanDiTConfig(dtype=jnp.float32, **DIT_KW)
    ct = tdit.WanDiTConfig(dtype=torch.float32, **DIT_KW)
    params = jdit.init_params(jax.random.PRNGKey(0), cj)
    kw = dict(TRAIN_KW, use_gradient_checkpointing=use_remat)
    jt = JTrainer(params, cj, JConfig(**kw))
    jt.lora = jax.tree.map(lambda x: x + 0.02, jt.lora)
    tt = TTrainer(tdit.params_from_jax(jax.tree.map(np.asarray, params), ct), TConfig(**kw),
                  device="cpu")
    tt.lora = tlora.params_from_jax(jax.tree.map(np.asarray, jt.lora), device="cpu")
    # the same banked errors in every grid, so that injection happens
    data = np.random.default_rng(3)
    for t in jt.buffers.grid_timesteps:
        for add in ("add_latent_error", "add_y_error"):
            err = data.standard_normal((1, 4, 2, 8, 8)).astype(np.float32)
            getattr(jt.buffers, add)(err, float(t))
            getattr(tt.buffers, add)(err, float(t))
    return jt, tt


def _batch():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((1, 4, 2, 8, 8)).astype(np.float32),
            rng.standard_normal((1, 7, 48)).astype(np.float32),
            rng.standard_normal((1, 8, 2, 8, 8)).astype(np.float32),
            rng.standard_normal((1, 5, 40)).astype(np.float32))


def test_corrupt_inputs_match_jax():
    """Timesteps, noise, error injection and the clean-input draw: the host
    RNG code is the JAX package's, so the arrays are bit-identical."""
    jt, tt = _trainers()
    lat, _, y, _ = _batch()
    for _ in range(6):
        (tid_j, t_j), (tid_t, t_t) = jt.sample_timestep(), tt.sample_timestep()
        assert (tid_j, t_j) == (tid_t, t_t)
        assert tt.buffers.grid_index(t_t) == jt.buffers.grid_index(t_j)
        got, want = tt.corrupt_inputs(lat, y, t_t), jt.corrupt_inputs(lat, y, t_j)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        assert got[3] == want[3]
    assert tt.rng.getstate() == jt.rng.getstate()


def test_lora_init_is_identity_and_targets_match_jax():
    ct = tdit.WanDiTConfig(dtype=torch.float32, **DIT_KW)
    cj = jdit.WanDiTConfig(dtype=jnp.float32, **DIT_KW)
    dit = tdit.init_params(ct, seed=0, device="cpu")
    lora = tlora.init_lora_params(ct, rank=4, generator=torch.Generator().manual_seed(0),
                                  device="cpu")
    jl = jlora.init_lora_params(jax.random.PRNGKey(0), cj, rank=4)
    assert tlora.num_lora_params(lora) == jlora.num_lora_params(jl)
    # peft's suffix match: q, k, v, o of both attentions, not k_img / v_img
    assert set(lora["blocks"][0]["cross_attn"]._tree_keys) == {"q", "k", "v", "o"}
    assert all(p.requires_grad and p.dtype == torch.float32 for p in lora.parameters())
    assert all(not p.requires_grad for p in dit.parameters())
    a = lora["blocks"][1]["ffn"]["2"]["a"]
    assert a.abs().max() <= 1 / np.sqrt(DIT_KW["ffn_dim"]) and a.abs().max() > 0
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 4, 2, 8, 8)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((1, 8, 2, 8, 8)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 7, 48)).astype(np.float32))
    clip = torch.from_numpy(rng.standard_normal((1, 5, 40)).astype(np.float32))
    t = torch.tensor([500.0])
    with torch.no_grad():
        base = dit(x, t, ctx, clip, y)
        adapted = dit(x, t, ctx, clip, y, lora=lora, lora_scale=1.0)
    # B is zero: the side path adds exactly 0
    assert torch.equal(base, adapted)


def test_remat_variants_give_the_same_gradients():
    """Per-block and grouped (sqrt) checkpointing recompute the same blocks:
    the LoRA gradients equal those of the plain forward; the group size is
    the JAX package's pick."""
    for n in (1, 4, 12, 30, 40):
        assert tdit.pick_remat_group(n) == jdit.pick_remat_group(n)
    ct = tdit.WanDiTConfig(dtype=torch.float32, **dict(DIT_KW, num_layers=4))
    dit = tdit.init_params(ct, seed=1, device="cpu")
    lora = tlora.init_lora_params(ct, rank=4, generator=torch.Generator().manual_seed(1),
                                  device="cpu")
    with torch.no_grad():
        for p in lora.parameters():
            p.add_(0.01)
    x, ctx, y, clip = (torch.from_numpy(a) for a in _batch())
    grads = []
    for kw in (dict(), dict(use_remat=True), dict(use_remat=True, remat_granularity=2)):
        out = dit(x, torch.tensor([300.0]), ctx, clip, y, lora=lora, **kw)
        grads.append(torch.autograd.grad(out.square().mean(), list(lora.parameters())))
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_peft_export_round_trip_matches_jax():
    cj = jdit.WanDiTConfig(dtype=jnp.float32, **DIT_KW)
    ct = tdit.WanDiTConfig(dtype=torch.float32, **DIT_KW)
    jl = jlora.init_lora_params(jax.random.PRNGKey(1), cj, rank=4)
    jl = jax.tree.map(lambda x: x + 0.5, jl)  # B non-zero too
    want = jlora.to_peft_state_dict(jl, prefix="pipe.dit.")
    got = tlora.to_peft_state_dict(tlora.params_from_jax(jax.tree.map(np.asarray, jl), device="cpu"),
                                   prefix="pipe.dit.")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back = tlora.to_peft_state_dict(tlora.from_peft_state_dict(want, ct, device="cpu"))
    assert back.keys() == jlora.to_peft_state_dict(jl).keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v, want["pipe.dit." + k])


# f32 on both sides: the loss and gradient norm differ only by the order of
# f32 sums. AdamW's first steps move each parameter by about lr * g / (|g| +
# eps), so a parameter whose gradient is near eps = 1e-8 is sensitive to that
# order (measured: 8.6e-6 for one such parameter after step 1, then no
# growth); the bound on the parameters is a quarter of one step (lr = 1e-4),
# while a wrong gradient sign moves a parameter by two steps.
LOSS_RTOL = 1e-4
LORA_ATOL = 2.5e-5
ERROR_ATOL = 1e-4  # the banked one-step errors: |pred - target| of order 1


@pytest.mark.parametrize("use_remat", [True, False])
def test_trainer_three_steps_match_jax(use_remat):
    jt, tt = _trainers(use_remat)
    lat, ctx, y, clip = _batch()
    for _ in range(3):
        mj = jt.training_step(lat, ctx, y=y, clip_feature=clip)
        mt = tt.training_step(lat, ctx, y=y, clip_feature=clip)
        for key in ("timestep", "grid", "used_clean_input", "warmup", "buffer_latent_total",
                    "buffer_y_total"):
            assert mt[key] == mj[key], key
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(mt["grad_norm"], mj["grad_norm"], rtol=LOSS_RTOL)
        jl = jax.tree.map(np.asarray, jt.lora)
        for m, sub in jl.items():
            for k, leaf in sub.items():
                for ab in ("a", "b"):
                    for i in range(DIT_KW["num_layers"]):
                        got = tt.lora["blocks"][i][m][k][ab].detach().numpy()
                        np.testing.assert_allclose(got, leaf[ab][i], atol=LORA_ATOL, rtol=0)
    for store in ("latent_error_buffer", "y_error_buffer"):
        got, want = getattr(tt.buffers, store), getattr(jt.buffers, store)
        assert got.keys() == want.keys()
        for g in want:
            assert len(got[g]) == len(want[g])
            for a, b in zip(got[g], want[g]):
                np.testing.assert_allclose(a, b, atol=ERROR_ATOL, rtol=0)
