"""The port's training drivers (svi_tpu_torch/scripts/train_svi.py,
train_svi_dance.py, train_svi_talk.py) against the JAX drivers
(scripts/train_svi*.py), both in-process on the same tiny checkpoint files
(tests/torch_checkpoint_files.py: the DiT shards, umT5, the VAE, CLIP, and
multitalk.safetensors for talk) and the repository's toy datasets
(data/toy_train/svi-{film-shot,dance,talk}): 3 steps at 48 x 48, 5 frames,
rank-4 LoRA, error recycling from step 2, an export at step 2 and at the end.

The JAX drivers run unchanged: `sys.argv` is set for them,
`svi_tpu.enable_compilation_cache` is a no-op, and their mesh helper returns
None, which is what it gives on one device (the tests' JAX has 8 virtual
CPU devices).
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (svi_tpu's drivers run in this process)

import svi_tpu
import svi_tpu.parallel.mesh as jax_mesh
from svi_tpu.models import model_io as jax_model_io
from svi_tpu_torch.models import model_io as port_model_io
from svi_tpu_torch.scripts import train_svi as port_shot
from svi_tpu_torch.scripts import train_svi_dance as port_dance
from svi_tpu_torch.scripts import train_svi_talk as port_talk
from torch_checkpoint_files import DIT_SHARDS, write_variant_checkpoints

REPO = Path(__file__).resolve().parent.parent
TOY = REPO / "data" / "toy_train"
STEPS, LR = 3, 1e-4
# Both drivers run the DiT and umT5 in bf16 (the drivers' dtype), XLA's CPU
# ops against PyTorch's, each rounding to bf16 in its own places, and their
# frames differ by the resize (Pillow's against the port's: at most one
# level, tests/test_torch_train_data.py). Measured on the CPU with these
# files: the per-step loss within 5e-4 relative, the gradient norm within
# 3e-3; the bounds are a few times that, far below what a wrong window,
# timestep, noise draw, injected error or condition gives (tens of percent).
LOSS_RTOL, GRAD_RTOL = 1e-2, 2e-2
# The exported adapters after 3 AdamW steps from the same start: each step
# moves a parameter by at most about lr (Adam's normalised update), so a
# gradient component within the bf16 noise of zero can step either way; two
# steps' worth each step (x1.5 for Adam's ratio above 1) bounds any element
# (measured: 3.7e-4), and the mean difference stays far below one step
# (measured: 4.9e-6).
EXPORT_ATOL, EXPORT_MEAN = 2 * STEPS * LR * 1.5, 0.25 * LR


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_variant_checkpoints(tmp_path_factory.mktemp("train_weights"))


def _argv(files, dataset, out, *extra):
    return ["--dataset_path", str(TOY / dataset),
            "--dit_path", ",".join(str(Path(files["root"]) / s) for s in DIT_SHARDS),
            "--vae_path", files["vae"], "--text_encoder_path", files["t5"],
            "--image_encoder_path", files["clip"], "--output_path", str(out),
            "--lora_rank", "4", "--lora_alpha", "4", "--use_error_recycling",
            "--buffer_warmup_iter", "1", "--num_grids", "10", "--error_buffer_k", "4",
            "--max_steps", str(STEPS), "--save_every_n_steps", "2",
            "--height", "48", "--width", "48", "--num_frames", "5", "--ref_pad_num", "-1",
            *extra]


def _run_jax(name, argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(svi_tpu, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(jax_mesh, "make_training_mesh", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    module.main()


def _metrics(out):
    with open(Path(out) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _exports(out):
    from safetensors.numpy import load_file

    return {p.name: load_file(str(p)) for p in sorted(Path(out).glob("*.safetensors"))}


CASES = {
    # driver: (port module, JAX script, dataset, extra flags)
    "shot": (port_shot, "train_svi", "svi-film-shot", ("--num_motion_frames", "3")),
    "dance": (port_dance, "train_svi_dance", "svi-dance", ("--pose_drop_prob1", "0.3")),
    "talk": (port_talk, "train_svi_talk", "svi-talk", ("--audio_drop_prob", "0.3")),
}
# the adapters (and for dance the pose convs) both drivers start from: the
# packages draw their initial A matrices from different generators
START = {"shot": "lora", "dance": "dance_lora", "talk": "lora"}


@pytest.mark.parametrize("driver", list(CASES))
def test_train_driver_matches_the_jax_driver(driver, weights, tmp_path, monkeypatch):
    """The same steps (timesteps, grids, clean-input draws, buffer counts),
    losses and grad norms within the bf16 bounds, args.json, and exports of
    the same names and keys whose adapters agree within the bound of 3 Adam
    steps; the inference loaders of both packages fuse each other's export.
    The shot run also writes its step-3 trace (--profile_dir)."""
    module, script, dataset, extra = CASES[driver]
    extra = extra + ("--pretrained_lora_path", weights[START[driver]])
    if driver == "talk":
        extra = extra + ("--multitalk_path", weights["multitalk"])
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    port_extra = extra + (("--profile_dir", str(tmp_path / "trace")) if driver == "shot" else ())
    record = module.main(_argv(weights, dataset, port_out, *port_extra), device="cpu")
    _run_jax(script, _argv(weights, dataset, jax_out, *extra), monkeypatch)

    assert json.loads((port_out / "args.json").read_text())["dataset_path"].endswith(dataset)
    got, want = _metrics(port_out), _metrics(jax_out)
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        for key in ("step", "timestep", "grid", "used_clean_input", "warmup",
                    "buffer_latent_total", "buffer_y_total"):
            assert g[key] == w[key], (key, g, w)
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=GRAD_RTOL)
    assert [m["loss"] for m in record["metrics"]] == [g["loss"] for g in got]

    got, want = _exports(port_out), _exports(jax_out)
    n = len(record["dataset"])
    assert list(got) == list(want) == [f"epoch={(s - 1) // n}-step={s}.safetensors"
                                       for s in (2, STEPS)]
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k, w in want[name].items():
            if "dwpose_embedding" in k and k.endswith(".weight"):
                # the JAX file holds these in memory order (see
                # tests/test_torch_training_variants.py); held by shape here
                assert got[name][k].shape == w.shape
                continue
            diff = np.abs(got[name][k] - w)
            assert diff.max() <= EXPORT_ATOL and diff.mean() <= EXPORT_MEAN, (k, diff.max())

    last = str(port_out / list(got)[-1])
    jm = jax_model_io.ModelManager()
    jm.load_models([weights["dit"]])
    jm.load_lora_v2(last)
    pm = port_model_io.ModelManager(torch_dtype=torch.float32, device="cpu")
    pm.load_models([weights["dit"]])
    pm.load_lora_v2(str(jax_out / list(want)[-1]))
    assert jm.lora_log[0][1] == pm.lora_log[0][1] == 2 * 6  # q, k, v, o, ffn.0, ffn.2 a block
    if driver == "shot":
        assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_train_driver_refuses_what_it_does_not_run(weights, tmp_path):
    """On one process every --training_strategy and --shard_optimizer_state
    run the single-device path (no mesh, as JAX's make_training_mesh gives
    on one device): the same metrics and exports as the plain run; the
    parallel runs are tests/test_torch_parallel_training.py's. Without a
    card the default device raises (no silent CPU)."""
    plain = port_shot.main(_argv(weights, "svi-film-shot", tmp_path / "plain"), device="cpu")
    for flags in (("--training_strategy", "sp"), ("--training_strategy", "dataxsp"),
                  ("--shard_optimizer_state",)):
        args = port_shot.parse_args(_argv(weights, "svi-film-shot", tmp_path / "x", *flags))
        assert port_shot.setup(args, "cpu") == (torch.device("cpu"), None)
    run = port_shot.main(_argv(weights, "svi-film-shot", tmp_path / "sp", "--training_strategy",
                               "dataxsp", "--shard_optimizer_state"), device="cpu")
    assert [m["loss"] for m in run["metrics"]] == [m["loss"] for m in plain["metrics"]]
    assert run["trainer"].mesh is None and run["trainer"].optimizer.owner is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_shot.main(_argv(weights, "svi-film-shot", tmp_path / "y"))
