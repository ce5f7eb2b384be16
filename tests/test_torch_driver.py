"""The port's clip-loop driver (svi_tpu_torch/scripts/test_svi.py) against the
JAX driver (scripts/test_svi.py), both in-process on the same tiny files
(tests/torch_checkpoint_files.py), PNG reference image, two-prompt file and
google/umt5-xxl/spiece.model (the vendored T5 model standing in for umT5's).

The JAX driver runs unchanged: `sys.argv` is set for it, its
`save_video` is replaced by a capture of the stitched frames, and
`svi_tpu.enable_compilation_cache` by a no-op so that no global JAX setting
leaks into the worker.
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (svi_tpu's driver runs in this process)

import svi_tpu
import svi_tpu.utils.video as jax_video
from svi_tpu_torch.scripts import test_svi as port_driver
from torch_checkpoint_files import LORA_TARGETS, write_tiny_checkpoints

REPO = Path(__file__).resolve().parent.parent
NUM_FRAMES, MOTION = 5, 1
# Both drivers run the DiT in bf16 (the drivers' dtype), XLA's CPU ops
# against PyTorch's: each rounds its activations to bf16 (2^-8 relative) in
# its own places, CFG 5 scales the cond - uncond difference five times, and
# the two steps and the VAE decode carry it to the pixels. Measured on the
# CPU with these files: mean 0.57 levels, max 7 levels of 255. The bounds sit a few times above that, far
# below a wrong clip (a swapped prompt, seed or motion frame moves the mean
# by tens of levels).
MEAN_LEVELS, MAX_LEVELS = 2.0, 24


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("driver")
    files = write_tiny_checkpoints(root / "weights")
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (64, 64, 3), dtype=np.uint8)
                    ).save(root / "frame.png")
    (root / "prompt.txt").write_text(
        'prompts = ["A lone explorer walks across rolling green hills.", '
        '"The explorer pauses at the hilltop, wind rippling through the grass."]\n')
    return root, files


def _argv(root, out, *extra):
    return ["--dit_root", str(root / "weights"),
            "--extra_module_root", str(root / "weights" / "svi-lora.safetensors"),
            "--output", str(out), "--ref_image_path", str(root / "frame.png"),
            "--prompt_path", str(root / "prompt.txt"), "--ref_pad_num", "-1",
            "--cfg_scale_text", "5.0", "--num_motion_frames", str(MOTION), "--num_clips", "2",
            "--num_steps", "2", "--num_frames", str(NUM_FRAMES), "--max_width", "64",
            "--seed_times", "3", *extra]


def _clip_lines(text):
    return re.findall(r"^  clip \d+/\d+ seed=.*$", text, flags=re.M)


def _jax_driver():
    spec = importlib.util.spec_from_file_location("jax_test_svi", REPO / "scripts" / "test_svi.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_driver_matches_the_jax_driver(inputs, tmp_path, monkeypatch, capsys):
    root, _ = inputs
    record = port_driver.main(_argv(root, tmp_path / "port", "--save_format", "npy"),
                              device="cpu")
    port_lines = _clip_lines(capsys.readouterr().out)
    (sample,) = record["samples"]
    frames = np.load(sample["path"])
    assert sample["frames"] == frames.shape[0] == 2 * NUM_FRAMES - MOTION
    assert frames.shape[1:] == (64, 64, 3) and frames.dtype == np.uint8
    assert [c["seed"] for c in sample["clips"]] == [0, 3]
    assert record["manager"].lora_log[0][1] == 2 * len(LORA_TARGETS)

    captured = {}
    monkeypatch.setattr(jax_video, "save_video", lambda f, path, **kw: captured.update(
        frames=np.stack([np.asarray(x) for x in f]), path=path))
    monkeypatch.setattr(svi_tpu, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["test_svi.py", *_argv(root, tmp_path / "jax")])
    _jax_driver().main()
    jax_lines = _clip_lines(capsys.readouterr().out)

    assert port_lines == jax_lines and len(port_lines) == 2  # seeds and prompts, clip by clip
    want = captured["frames"]
    assert want.shape == frames.shape
    diff = np.abs(frames.astype(np.int16) - want.astype(np.int16))
    assert diff.mean() <= MEAN_LEVELS and diff.max() <= MAX_LEVELS, (diff.mean(), diff.max())


def test_driver_writes_a_readable_mp4(inputs, tmp_path):
    """The mp4 goes through save_video as in the JAX package: imageio where it
    has an mp4 backend, else OpenCV (this box's imageio has none), and is
    read back with OpenCV."""
    import cv2

    root, _ = inputs
    record = port_driver.main(_argv(root, tmp_path, "--num_clips", "1", "--tiled",
                                    "--tile_size", "6", "6", "--tile_stride", "4", "4"),
                              device="cpu")
    path = record["samples"][0]["path"]
    assert path.endswith(".mp4")
    cap = cv2.VideoCapture(path)
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        assert frame.shape == (64, 64, 3)
        n += 1
    cap.release()
    assert n == NUM_FRAMES


def test_driver_defaults_to_the_card(inputs, tmp_path):
    root, _ = inputs
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card path is chip_smoke.py's")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_driver.main(_argv(root, tmp_path))


@pytest.mark.parametrize("flags", [("--sequential_cfg", "latent", "--train_architecture",
                                    "customtalk"),
                                   ("--sequential_cfg", "latent")])
def test_driver_refuses_modes_it_does_not_run(inputs, tmp_path, flags):
    """With --sequential_cfg latent the pipeline returns (frames, latent),
    which the frame-recycling loop of scripts/test_svi.py does not take: it
    raises before any loading, whatever --train_architecture says (customtalk
    itself runs: tests/test_torch_driver_variants.py)."""
    root, _ = inputs
    with pytest.raises(NotImplementedError, match=flags[0]):
        port_driver.main(_argv(root, tmp_path, *flags), device="cpu")
    assert not any(tmp_path.iterdir())
