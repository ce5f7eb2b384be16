"""Ranks of the port's parallel tests: `run_ranks` starts gloo processes on
the CPU (spawned, a FileStore rendezvous under the test's tmp_path, a
timeout on every collective and on the join), and the functions below are
what each rank runs. This module imports no JAX: spawn re-imports it in
every rank."""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist

JOIN_TIMEOUT = 240  # seconds for every rank's result; a hang fails the test here
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


def _entry(fn, rank, world, store, results, args, env):
    os.environ.update(env)
    torch.set_num_threads(1)
    try:
        if env.get("RANK") is None:  # torchrun-style ranks join from their environment
            dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                    world_size=world, timeout=COLLECTIVE_TIMEOUT)
        results.put((rank, None, fn(rank, world, *args)))
    except BaseException:  # noqa: BLE001 -- reported to the test, which raises it
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, torchrun_env: bool = False) -> list:
    """fn(rank, world, *args) on `world` gloo ranks; returns their results in
    rank order, or raises with the first rank's traceback. torchrun_env:
    the ranks get torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT on a free port) and join
    the group themselves."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}_{world}")
    port = _free_port() if torchrun_env else None
    procs = []
    for rank in range(world):
        env = {}
        if torchrun_env:
            env = {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                   "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(port)}
        p = ctx.Process(target=_entry, args=(fn, rank, world, store, results, args, env),
                        daemon=True)
        p.start()
        procs.append(p)
    out, errors = {}, []
    try:
        for _ in range(world):
            rank, err, res = results.get(timeout=JOIN_TIMEOUT)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            out[rank] = res
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(world)) - set(out))} gave no result in "
                      f"{JOIN_TIMEOUT} s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out[r] for r in range(world)]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# What the ranks run
# ---------------------------------------------------------------------------


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _dit(params_np, cfg_kw):
    from svi_tpu_torch.models import wan_dit

    return wan_dit.params_from_jax(params_np, wan_dit.WanDiTConfig(dtype=torch.float32,
                                                                   **cfg_kw))


def _inputs(inp):
    keys = ("x", "t", "ctx", "clip", "y", "cond")
    return [_t(inp.get(k)) for k in keys], (None if inp.get("audio") is None
                                            else tuple(_t(a) for a in inp["audio"]))


def forwards(rank, world, cases):
    """Each case's sharded forward: {"kind": "sp" | "tp" | "tpsp", "cfg",
    "params" (numpy, the JAX layout, maybe quantized), "inputs", "mesh",
    "kw", "lora"}. Returns per case {"out", "bytes" (the blocks this rank
    holds), "full_bytes" (unsharded), "ffn" (this rank's ffn leaf shapes)} or
    {"error": message} where sharding raised ValueError."""
    from svi_tpu_torch.parallel import make_mesh
    from svi_tpu_torch.parallel.sequence_parallel import forward_sp
    from svi_tpu_torch.parallel.tensor_parallel import (forward_tp, param_bytes,
                                                        shard_dit_params_tp)
    from svi_tpu_torch.parallel.tp_sp import forward_tpsp, make_mesh3, shard_dit_params_tpsp
    from svi_tpu_torch.training import lora as lora_mod

    outs = []
    for case in cases:
        kind, kw = case["kind"], case.get("kw", {})
        dit = _dit(case["params"], case["cfg"])
        (x, t, ctx, clip, y, cond), audio = _inputs(case["inputs"])
        mesh = (make_mesh3 if kind == "tpsp" else make_mesh)(*case["mesh"])
        res = {"full_bytes": param_bytes(dit["blocks"])}
        try:
            if kind == "tp":
                dit = shard_dit_params_tp(dit, mesh)
            elif kind == "tpsp":
                dit = shard_dit_params_tpsp(dit, mesh)
        except ValueError as e:
            outs.append({"error": str(e)})
            continue
        res["bytes"] = param_bytes(dit["blocks"])
        ffn = dit["blocks"][0]["ffn"]
        res["ffn"] = [tuple(ffn[i][k].shape) for i in ("0", "2") for k in ffn[i]._tree_keys]
        with torch.no_grad():
            if kind == "sp":
                lora = None if case.get("lora") is None else lora_mod.params_from_jax(
                    case["lora"], device="cpu")
                out = forward_sp(dit, x, t, ctx, clip, y, cond, mesh=mesh, lora=lora,
                                 audio_embed_tuple=audio, **kw)
            elif kind == "tp":
                out = forward_tp(dit, x, t, ctx, clip, y, cond, mesh=mesh,
                                 audio_embed_tuple=audio)
            else:
                out = forward_tpsp(dit, x, t, ctx, clip, y, cond, mesh=mesh,
                                   audio_embed_tuple=audio, **kw)
        res["out"] = out.numpy()
        outs.append(res)
    return outs


def lora_grads(rank, world, cases):
    """Per case, forward_sp's LoRA gradients of sum(out * g) (lora_scale
    0.5), summed over the ranks as the trainer sums them, and the plain
    attention forward's calls during the forward and during the backward
    (the recompute)."""
    from svi_tpu_torch.ops import attention as A
    from svi_tpu_torch.parallel import collectives, make_mesh
    from svi_tpu_torch.parallel.sequence_parallel import forward_sp
    from svi_tpu_torch.training import lora as lora_mod

    calls = {"n": 0}
    plain = A._flash_fwd_reference

    def counted(*args, **kwargs):
        calls["n"] += 1
        return plain(*args, **kwargs)

    A._flash_fwd_reference = counted
    outs = []
    for case in cases:
        mesh = make_mesh(*case["mesh"])
        dit = _dit(case["params"], case["cfg"])
        (x, t, ctx, clip, y, cond), audio = _inputs(case["inputs"])
        lora = lora_mod.params_from_jax(case["lora"], device="cpu")
        calls["n"] = 0
        out = forward_sp(dit, x, t, ctx, clip, y, cond, mesh=mesh, lora=lora, lora_scale=0.5,
                         audio_embed_tuple=audio, **case["kw"])
        fwd_calls, calls["n"] = calls["n"], 0
        (out * _t(case["g"])).sum().backward()
        for p in lora.parameters():
            collectives.all_reduce_(p.grad, mesh.world)
        grads = {f"blocks.{i}.{path}.{ab}": leaf[ab].grad.numpy()
                 for i, path, leaf in lora_mod._leaves(lora) for ab in ("a", "b")}
        outs.append({"out": out.detach().numpy(), "grads": grads, "fwd_calls": fwd_calls,
                     "bwd_calls": calls["n"]})
    return outs


def _trainer(case, mesh, **overrides):
    from svi_tpu_torch.training import ErrorRecyclingTrainer, TrainerConfig
    from svi_tpu_torch.training import lora as lora_mod

    trainer = ErrorRecyclingTrainer(_dit(case["params"], case["cfg"]),
                                    TrainerConfig(**dict(case["train"], **overrides)),
                                    mesh=mesh, device="cpu")
    trainer.lora = lora_mod.params_from_jax(case["lora"], device="cpu")
    for t, add, err in case["banked"]:
        getattr(trainer.buffers, add)(err, t)
    return trainer


def _adapters(trainer):
    from svi_tpu_torch.training import lora as lora_mod

    return lora_mod.to_peft_state_dict(trainer.lora)


def train_steps(rank, world, case):
    """`case["steps"]` trainer steps on the mesh (data, sp) on the global
    batch: per step the metrics, then the adapters and both error buffers."""
    from svi_tpu_torch.parallel import make_mesh

    trainer = _trainer(case, make_mesh(*case["mesh"]))
    metrics = [trainer.training_step(*case["batch"]) for _ in range(case["steps"])]
    return {"metrics": metrics, "lora": _adapters(trainer),
            "latent_buffer": trainer.buffers.latent_error_buffer,
            "y_buffer": trainer.buffers.y_error_buffer}


def zero1_steps(rank, world, case, ckpt_dir):
    """The same steps with replicated AdamW and with ZeRO-1 on an all-'data'
    mesh; the moments each rank keeps; the ZeRO-1 checkpoint (written by
    rank 0) and a replicated trainer resumed from it on every rank."""
    from svi_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world, 1)
    out = {}
    for name, shard in (("replicated", False), ("zero1", True)):
        trainer = _trainer(case, mesh, shard_optimizer_state=shard)
        out[name] = {"metrics": [trainer.training_step(*case["batch"])
                                 for _ in range(case["steps"])],
                     "lora": _adapters(trainer),
                     "moments": sum(st["exp_avg"].numel()
                                    for st in trainer.optimizer.opt.state.values()),
                     "total": sum(p.numel() for p in trainer.optimizer.params),
                     "state": _numpy_state(trainer.optimizer.state_dict())}
        if shard:
            trainer.save_checkpoint(ckpt_dir)
            resumed = _trainer(case, mesh)
            resumed.restore_checkpoint(ckpt_dir)
            out["resumed"] = {"lora": _adapters(resumed),
                              "state": _numpy_state(resumed.optimizer.state_dict()),
                              "next": resumed.training_step(*case["batch"]),
                              "next_zero1": trainer.training_step(*case["batch"])}
    return out


def _numpy_state(state):
    """An optimizer state dict's moments as numpy (results leave the rank
    pickled; torch tensors would leave by shared memory the rank frees)."""
    return {i: {k: v.cpu().numpy().copy() for k, v in st.items()}
            for i, st in state["state"].items()}


def run_driver(rank, world, module, argv):
    """A training driver's main under torchrun's environment, on the CPU."""
    import importlib

    record = importlib.import_module(module).main(argv, device="cpu")
    return {"metrics": record["metrics"], "exports": record["exports"]}


def usp_pipeline(rank, world, trees, call):
    """The port's SVIVideoPipeline on the tiny models with use_usp over every
    rank: one clip's frames and latents."""
    pipe = _pipeline(trees).enable_usp(True)
    frames, latents = pipe(**call, return_latents=True)
    return np.stack([np.asarray(f) for f in frames]), latents.float().numpy()


def _pipeline(trees):
    from svi_tpu_torch.models import clip_vision, wan_dit, wan_vae
    from svi_tpu_torch.pipelines.svi_video import SVIVideoPipeline

    pipe = SVIVideoPipeline(device="cpu", torch_dtype=torch.float32)
    pipe.vae = wan_vae.params_from_jax(trees["vae"], wan_vae.WanVAEConfig(**trees["vae_kw"]))
    pipe.dit = wan_dit.params_from_jax(trees["dit"], wan_dit.WanDiTConfig(
        dtype=torch.float32, **trees["dit_kw"]))
    pipe.image_encoder = clip_vision.params_from_jax(
        trees["clip"], clip_vision.ClipVisionConfig(**trees["clip_kw"]))
    return pipe
