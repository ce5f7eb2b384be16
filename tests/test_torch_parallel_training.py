"""The port's parallel training (svi_tpu_torch.parallel, the trainer's mesh
half, the drivers under torchrun) against svi_tpu's on the CPU: the port's
ranks are gloo processes (tests/torch_parallel_ranks.py), the JAX package
runs on conftest.py's 8 virtual devices, both on the same numpy-seeded f32
weights and inputs.

  * the LoRA gradients of forward_sp with remat (per block, in groups, with
    save_attention) against jax.grad of JAX's forward_sp, on padded shards;
  * one trainer step on (data 2, sp 2) against JAX's trainer on the same
    mesh: the loss, the adapters after the step and the banked errors, on
    every rank;
  * ZeRO-1 against the replicated optimizer: the same adapters and losses,
    each rank keeping only its share of the moments, and its checkpoint the
    single-device one, from which every rank resumes;
  * train_svi under torchrun's environment: --training_strategy sp on 2
    ranks against the single-process run, and data_parallel
    --shard_optimizer_state writing one set of files.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import wan_dit as jdit
from svi_tpu.parallel.mesh import make_mesh as jmesh
from svi_tpu.parallel.sequence_parallel import forward_sp as jforward_sp
from svi_tpu.training import ErrorRecyclingTrainer as JTrainer
from svi_tpu.training import TrainerConfig as JConfig
from svi_tpu.training import error_recycling as jer
from svi_tpu.training import lora as jlora
from svi_tpu_torch.scripts import train_svi as port_shot
from torch_checkpoint_files import DIT_SHARDS, write_variant_checkpoints
import torch_parallel_ranks as ranks

REPO = Path(__file__).resolve().parent.parent
# a 2-layer f32 I2V DiT, 2 heads of 32; latents 3 x 6 x 6 -> 27 tokens, padded
# over 2 sp ranks
DIT_KW = dict(dim=64, in_dim=12, ffn_dim=128, out_dim=4, text_dim=48, freq_dim=32,
              num_heads=2, num_layers=2, has_image_input=True, clip_feature_dim=40)
LAT = (4, 3, 6, 6)
TRAIN_KW = dict(lora_rank=4, lora_alpha=4.0, buffer_warmup_iter=2, error_buffer_k=8,
                num_grids=10, seed=0)
# f32 on both sides, sums in other orders (the gathers' reduce-scatter, the
# ranks' gradient sum): the bounds of tests/test_torch_training.py's
# single-device parity (a gradient component is ~1e-2 here; a wrong
# transpose, a missing or doubled rank's share moves it by its own size)
GRAD_TOL = 2e-5
LOSS_RTOL = 1e-4
LORA_ATOL = 2.5e-5  # a quarter of one AdamW step (lr 1e-4)
ERROR_ATOL = 1e-4


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg():
    return jdit.WanDiTConfig(dtype=jnp.float32, **DIT_KW)


def _lora(seed=1):
    return jax.tree.map(lambda v: v + 0.02, jlora.init_lora_params(jax.random.PRNGKey(seed),
                                                                   _cfg(), rank=4))


def _batch(b, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, *LAT)).astype(np.float32),
            rng.standard_normal((b, 7, 48)).astype(np.float32),
            rng.standard_normal((b, 8, *LAT[1:])).astype(np.float32),
            rng.standard_normal((b, 5, 40)).astype(np.float32))


def _jax_leaf(tree, key):
    """blocks.{i}.{module}.{key}.{a|b} of a stacked JAX adapter tree."""
    _, i, module, name, ab = key.split(".")
    return np.asarray(tree[module][name][ab][int(i)])


# ---------------------------------------------------------------------------
# forward_sp's gradients
# ---------------------------------------------------------------------------

GRAD_CASES = {  # name: (mesh, forward_sp's remat options)
    "remat_2x2": ((2, 2), dict(use_remat=True)),
    "remat_group_1x4": ((1, 4), dict(use_remat=True, remat_granularity=2)),
    "save_attention_1x4": ((1, 4), dict(use_remat=True, save_attention=True)),
    "offload_1x4": ((1, 4), dict(use_remat=True, offload_carries=True)),
}


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    params = jdit.init_params(jax.random.PRNGKey(0), _cfg())
    lora = _lora()
    lat, ctx, y, clip = _batch(2, seed=4)
    g = np.random.default_rng(5).standard_normal((2, *LAT)).astype(np.float32)
    inputs = dict(x=lat, t=np.array([300.0, 700.0], np.float32), ctx=ctx, clip=clip, y=y)
    cases, want = [], {}
    for name, (mesh, kw) in GRAD_CASES.items():
        cases.append(dict(cfg=DIT_KW, params=_host(params), lora=_host(lora), inputs=inputs,
                          g=g, mesh=mesh, kw=dict(kw, remat_granularity=kw.get(
                              "remat_granularity", 1))))
        jm = jmesh(*mesh, devices=jax.devices()[:4])
        # the carries' host offload moves no number: JAX's reference runs without it
        jkw = {k: v for k, v in kw.items() if k != "offload_carries"}

        def loss(lo, jm=jm, jkw=jkw):
            out = jforward_sp(params, _cfg(), lat, inputs["t"], ctx, clip_feature=clip, y=y,
                              mesh=jm, lora=lo, lora_scale=0.5, **jkw)
            return jnp.sum(out * g)

        want[name] = _host(jax.jit(jax.grad(loss))(lora))
    got = ranks.run_ranks(ranks.lora_grads, 4, tmp_path_factory.mktemp("grads"), cases)
    return {name: ([r[i] for r in got], want[name]) for i, name in enumerate(GRAD_CASES)}


@pytest.mark.parametrize("name", list(GRAD_CASES))
def test_forward_sp_lora_grads_match_jax_grad(grads, name):
    """The LoRA gradients of forward_sp (summed over the ranks, as the
    trainer sums them) equal jax.grad of JAX's forward_sp, by value, on
    every rank: not sp times too large, not 1/sp of it (counterpart of
    test_sharded_variants.py's SP training-gradient test)."""
    per_rank, want = grads[name]
    for r, res in enumerate(per_rank):
        assert len(res["grads"]) == 2 * 10 * 2  # a and b of 10 targets in 2 blocks
        for key, g in res["grads"].items():
            np.testing.assert_allclose(g, _jax_leaf(want, key), atol=GRAD_TOL, rtol=1e-4,
                                       err_msg=f"rank {r} {key}")
        assert np.abs(res["grads"]["blocks.0.self_attn.q.b"]).max() > 1e-3


def test_save_attention_keeps_the_sequence_parallel_self_attention(grads):
    """save_attention under SP: the backward's recompute runs the two cross
    attentions (text and image) of each block but not the self-attention,
    whose forward goes through the `flash_fwd_self` operator the policy
    keeps; plain remat recomputes all three."""
    for res in grads["remat_2x2"][0] + grads["save_attention_1x4"][0]:
        assert res["fwd_calls"] == 2 * 3
    assert all(res["bwd_calls"] == 2 * 3 for res in grads["remat_2x2"][0])
    assert all(res["bwd_calls"] == 2 * 2 for res in grads["save_attention_1x4"][0])


# ---------------------------------------------------------------------------
# the trainer on a mesh, ZeRO-1
# ---------------------------------------------------------------------------


def _banked():
    """The same errors banked in every grid of both packages' buffers."""
    data = np.random.default_rng(3)
    grid_t = jer.ErrorBuffers(num_grids=TRAIN_KW["num_grids"]).grid_timesteps
    return [(float(t), add, data.standard_normal((1, *LAT)).astype(np.float32))
            for t in grid_t for add in ("add_latent_error", "add_y_error")]


def _train_case(steps, b):
    params = jdit.init_params(jax.random.PRNGKey(0), _cfg())
    return params, dict(cfg=DIT_KW, params=_host(params), lora=_host(_lora()), train=TRAIN_KW,
                        banked=_banked(), batch=_batch(b), steps=steps)


def test_train_step_on_a_2x2_mesh_matches_jax(tmp_path):
    """One step on (data 2, sp 2) against JAX's make_train_step(mesh=...):
    the global batch's loss, the adapters after the step and both error
    buffers (every entry of the global batch, in order) on every rank."""
    params, case = _train_case(steps=1, b=2)
    case["mesh"] = (2, 2)
    jt = JTrainer(params, _cfg(), JConfig(**TRAIN_KW),
                  mesh=jmesh(2, 2, devices=jax.devices()[:4]))
    jt.lora = _lora()
    for t, add, err in case["banked"]:
        getattr(jt.buffers, add)(err, t)
    want = jt.training_step(*case["batch"][:2], y=case["batch"][2],
                            clip_feature=case["batch"][3])
    want_lora = jlora.to_peft_state_dict(jt.lora)
    for res in ranks.run_ranks(ranks.train_steps, 4, tmp_path, case):
        got = res["metrics"][0]
        for key in ("timestep", "grid", "used_clean_input", "buffer_latent_total",
                    "buffer_y_total"):
            assert got[key] == want[key], key
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=LOSS_RTOL)
        assert res["lora"].keys() == want_lora.keys()
        for k, v in want_lora.items():
            np.testing.assert_allclose(res["lora"][k], v, atol=LORA_ATOL, rtol=0, err_msg=k)
        for store, mine in (("latent_error_buffer", "latent_buffer"),
                            ("y_error_buffer", "y_buffer")):
            theirs = getattr(jt.buffers, store)
            assert res[mine].keys() == theirs.keys()
            for grid in theirs:
                assert len(res[mine][grid]) == len(theirs[grid])
                for a, b in zip(res[mine][grid], theirs[grid]):
                    np.testing.assert_allclose(a, b, atol=ERROR_ATOL, rtol=0)


def test_zero1_matches_the_replicated_optimizer(tmp_path):
    """ZeRO-1 on 2 'data' ranks: the same losses and adapters as the
    replicated AdamW over 2 steps (the same elementwise update, on the
    owner); each rank keeps the moments of its share only (together all of
    them); its state dict and checkpoint are the single-device ones, and a
    replicated trainer resumed from that checkpoint on each rank steps as
    the ZeRO-1 trainer does."""
    _, case = _train_case(steps=2, b=2)
    per_rank = ranks.run_ranks(ranks.zero1_steps, 2, tmp_path, case, str(tmp_path / "ckpt"))
    assert (tmp_path / "ckpt" / "train_state.pt").is_file()
    owned = [res["zero1"]["moments"] for res in per_rank]
    total = per_rank[0]["zero1"]["total"]
    assert sum(owned) == total and all(0 < n < total for n in owned)
    assert all(res["replicated"]["moments"] == total for res in per_rank)
    for res in per_rank:
        rep, zero = res["replicated"], res["zero1"]
        for a, b in zip(rep["metrics"], zero["metrics"]):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
        for k, v in rep["lora"].items():
            np.testing.assert_allclose(zero["lora"][k], v, atol=1e-7, rtol=0, err_msg=k)
        for state in (zero["state"], res["resumed"]["state"]):
            assert state.keys() == rep["state"].keys()
            for i, st in rep["state"].items():
                for key in ("exp_avg", "exp_avg_sq", "step"):
                    np.testing.assert_allclose(state[i][key], st[key], atol=1e-9, rtol=1e-6)
        resumed = res["resumed"]
        for k, v in zero["lora"].items():
            np.testing.assert_array_equal(resumed["lora"][k], v)
        assert resumed["next"]["loss"] == pytest.approx(resumed["next_zero1"]["loss"], rel=1e-6)


# ---------------------------------------------------------------------------
# the driver under torchrun
# ---------------------------------------------------------------------------

STEPS, LR = 3, 1e-4
# bf16 DiT in both runs (the driver's dtype), sharded against one process:
# the driver test's bounds (tests/test_torch_train_driver.py)
DRIVER_LOSS_RTOL, DRIVER_GRAD_RTOL = 1e-2, 2e-2
EXPORT_ATOL = 2 * STEPS * LR * 1.5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_variant_checkpoints(tmp_path_factory.mktemp("train_weights"))


def _argv(files, out, *extra):
    return ["--dataset_path", str(REPO / "data" / "toy_train" / "svi-film-shot"),
            "--dit_path", ",".join(str(Path(files["root"]) / s) for s in DIT_SHARDS),
            "--vae_path", files["vae"], "--text_encoder_path", files["t5"],
            "--image_encoder_path", files["clip"], "--output_path", str(out),
            "--lora_rank", "4", "--lora_alpha", "4", "--use_error_recycling",
            "--buffer_warmup_iter", "1", "--num_grids", "10", "--error_buffer_k", "4",
            "--max_steps", str(STEPS), "--save_every_n_steps", "2",
            "--height", "48", "--width", "48", "--num_frames", "5", "--ref_pad_num", "-1",
            *extra]


def _metrics(out):
    return [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]


def test_train_driver_sp_on_two_ranks_matches_one_process(weights, tmp_path):
    """train_svi --training_strategy sp under torchrun's environment on 2
    gloo ranks: one metrics.jsonl and one set of exports (rank 0's), equal
    to the single-process run's within the driver test's bounds; every rank
    saw the same metrics."""
    from svi_tpu_torch.utils.safetensors_io import load_file

    single = port_shot.main(_argv(weights, tmp_path / "one"), device="cpu")
    per_rank = ranks.run_ranks(ranks.run_driver, 2, tmp_path, "svi_tpu_torch.scripts.train_svi",
                               _argv(weights, tmp_path / "sp", "--training_strategy", "sp"),
                               torchrun_env=True)
    assert per_rank[0]["metrics"] == per_rank[1]["metrics"]
    got, want = _metrics(tmp_path / "sp"), _metrics(tmp_path / "one")
    assert [m["step"] for m in got] == [1, 2, 3]
    for a, b in zip(got, want):
        assert a["timestep"] == b["timestep"] and a["grid"] == b["grid"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=DRIVER_LOSS_RTOL)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=DRIVER_GRAD_RTOL)
    exports = sorted(p.name for p in (tmp_path / "sp").glob("*.safetensors"))
    assert exports == sorted(Path(p).name for p in single["exports"])
    for name in exports:
        a, b = load_file(str(tmp_path / "sp" / name)), load_file(str(tmp_path / "one" / name))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=EXPORT_ATOL, rtol=0)


def test_train_driver_zero1_on_two_ranks_writes_one_set_of_files(weights, tmp_path):
    """data_parallel --shard_optimizer_state on 2 ranks: a global batch of 2
    a step, one args.json, one metrics.jsonl of 3 finite steps and the two
    exports, written by rank 0."""
    out = tmp_path / "dp"
    per_rank = ranks.run_ranks(ranks.run_driver, 2, tmp_path, "svi_tpu_torch.scripts.train_svi",
                               _argv(weights, out, "--shard_optimizer_state"),
                               torchrun_env=True)
    assert per_rank[0]["metrics"] == per_rank[1]["metrics"]
    metrics = _metrics(out)
    assert [m["step"] for m in metrics] == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in metrics)
    names = sorted(p.name for p in out.iterdir())
    assert names[0] == "args.json" and names[-1] == "metrics.jsonl" and len(names) == 4
    assert [n.split("-")[1] for n in names[1:3]] == ["step=2.safetensors", "step=3.safetensors"]
    assert json.loads((out / "args.json").read_text())["shard_optimizer_state"] is True


def test_one_process_strategies_take_the_single_device_path():
    """Without torchrun (one process) every strategy's mesh is None, as
    JAX's make_training_mesh is on one device, and init_distributed joins
    nothing."""
    from svi_tpu_torch.parallel.mesh import init_distributed, make_training_mesh

    for strategy in ("data_parallel", "sp", "dataxsp"):
        assert make_training_mesh(strategy) is None
    with pytest.raises(ValueError, match="strategy"):
        make_training_mesh("ddp")
    assert init_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
