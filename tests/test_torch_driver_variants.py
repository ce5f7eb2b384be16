"""The port's SVI-Dance and SVI-Talk drivers (svi_tpu_torch/scripts/
test_svi_dance.py, test_svi_talk.py) against the JAX drivers
(scripts/test_svi_dance.py, scripts/test_svi_talk.py), both in-process on
the same tiny files (tests/torch_checkpoint_files.py: the DiT shards, plus
multitalk.safetensors and the wav2vec2 directory for talk, the LoRA with the
pose embedding for dance), a 64 x 64 PNG reference image, the repository's
data/toy_test/dance/pose.mp4 and data/toy_test/talk/speech.wav: one clip and
one recycled clip, 2 steps each.

The JAX drivers run unchanged, as tests/test_torch_driver.py runs
scripts/test_svi.py: `sys.argv` is set for them, their `save_video` is
replaced by a capture of the stitched frames, and
`svi_tpu.enable_compilation_cache` by a no-op.
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (svi_tpu's drivers run in this process)

import svi_tpu
import svi_tpu.utils.video as jax_video
from svi_tpu_torch.scripts import test_svi as port_svi
from svi_tpu_torch.scripts import test_svi_dance as port_dance
from svi_tpu_torch.scripts import test_svi_talk as port_talk
from svi_tpu_torch.utils.video import load_video_frames
from torch_checkpoint_files import LORA_TARGETS, write_variant_checkpoints

REPO = Path(__file__).resolve().parent.parent
POSE = REPO / "data" / "toy_test" / "dance" / "pose.mp4"
SPEECH = REPO / "data" / "toy_test" / "talk" / "speech.wav"
NUM_FRAMES = 9
# Both drivers run the DiT in bf16, XLA's CPU ops against PyTorch's, each
# rounding its activations to bf16 in its own places, through 2 steps with
# CFG and the VAE decode; as tests/test_torch_driver.py bounds its clips
# (there: mean 0.57, max 7 levels measured). A wrong pose window, audio
# slice or motion frame moves the mean by tens of levels.
MEAN_LEVELS, MAX_LEVELS = 2.0, 24


@pytest.fixture
def real_audio_imports(monkeypatch):
    """tests/reference_loader.py puts librosa and pyloudnorm stubs (which
    raise) into sys.modules for the reference's imports, and a test file run
    earlier in this process may have loaded it: hide such a stub, so that
    both packages' load_audio take the branch this machine's own packages
    give."""
    for name in ("librosa", "pyloudnorm"):
        mod = sys.modules.get(name)
        if mod is not None and getattr(mod, "__file__", None) is None:
            monkeypatch.setitem(sys.modules, name, None)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("variants")
    files = write_variant_checkpoints(root / "weights")
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (64, 64, 3), dtype=np.uint8)
                    ).save(root / "frame.png")
    return root, files


def _jax_driver(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(name, argv, monkeypatch):
    captured = []
    monkeypatch.setattr(jax_video, "save_video", lambda f, path, **kw: captured.append(
        np.stack([np.asarray(x) for x in f])))
    monkeypatch.setattr(svi_tpu, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    _jax_driver(name).main()
    return captured[-1]


def _close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.mean() <= MEAN_LEVELS and diff.max() <= MAX_LEVELS, (diff.mean(), diff.max())


def _clip_lines(text):
    return re.findall(r"^clip \d+/\d+.*$", text, flags=re.M)


def test_dance_driver_matches_the_jax_driver(inputs, tmp_path, monkeypatch, capsys):
    root, files = inputs
    w = root / "weights"
    argv = ["--dit_root", str(w), "--extra_module_root", files["dance_lora"],
            "--image_path", str(root / "frame.png"), "--pose_path", str(POSE),
            "--num_clips", "2", "--num_steps", "2", "--num_frames", str(NUM_FRAMES)]
    record = port_dance.main([*argv, "--output", str(tmp_path / "port"), "--save_format", "npy"],
                             device="cpu")
    port_lines = _clip_lines(capsys.readouterr().out)
    frames = np.load(record["path"])
    motion = 5  # the driver's default --num_motion_frames
    assert record["frames"] == frames.shape[0] == 2 * NUM_FRAMES - motion
    assert record["manager"].lora_log[0][1] == 2 * len(LORA_TARGETS)
    assert sorted(record["manager"].state_dict_new_module) == sorted(
        k for k in files["sds"]["dance_lora"] if k.startswith("dwpose_embedding."))
    assert record["pipe"].dwpose_embedding is not None

    want = _run_jax("test_svi_dance", [*argv, "--output", str(tmp_path / "jax")], monkeypatch)
    assert port_lines == _clip_lines(capsys.readouterr().out) and len(port_lines) == 2
    _close(frames, want)

    # --remove_pose: the same clips without the pose condition differ
    bare = port_dance.main([*argv, "--output", str(tmp_path / "bare"), "--save_format", "npy",
                            "--remove_pose", "--num_clips", "1"], device="cpu")
    first = np.load(bare["path"])
    assert np.abs(first.astype(np.int16) - frames[:NUM_FRAMES].astype(np.int16)).mean() > 1.0


def test_pose_video_reads_alike_from_npy(tmp_path):
    """The .npy pose video the card's machine reads (no cv2 there) holds the
    frames OpenCV decodes from the mp4."""
    frames = load_video_frames(str(POSE))
    np.save(tmp_path / "pose.npy", np.stack(frames))
    again = load_video_frames(str(tmp_path / "pose.npy"))
    assert len(again) == len(frames) == 96
    assert all(np.array_equal(a, b) for a, b in zip(again, frames))
    assert [f.shape for f in load_video_frames(str(POSE), indices=[3, 50])] == [(448, 256, 3)] * 2


def test_pose_video_without_cv2_goes_to_imageio(monkeypatch):
    """Without cv2 the mp4 goes to imageio: read alike where imageio has an
    mp4 backend, else the reader says to pass a .npy."""
    import imageio

    want = load_video_frames(str(POSE))
    monkeypatch.setitem(sys.modules, "cv2", None)
    try:
        imageio.get_reader(str(POSE)).close()
    except ValueError:  # no backend for mp4
        with pytest.raises(RuntimeError, match="npy"):
            load_video_frames(str(POSE))
    else:
        got = load_video_frames(str(POSE))
        assert len(got) == len(want) and got[0].shape == want[0].shape


def test_talk_driver_matches_the_jax_driver(inputs, tmp_path, monkeypatch, capsys,
                                            real_audio_imports):
    root, files = inputs
    w = root / "weights"
    argv = ["--dit_root", str(w), "--extra_module_root", files["lora"],
            "--multitalk_path", files["multitalk"], "--wav2vec_path", files["wav2vec2"],
            "--ref_image_path", str(root / "frame.png"), "--audio_path", str(SPEECH),
            "--num_clips", "2", "--num_steps", "2", "--num_frames", str(NUM_FRAMES),
            "--max_width", "64"]
    record = port_talk.main([*argv, "--output", str(tmp_path / "port"), "--save_format", "npy"],
                            device="cpu")
    port_lines = _clip_lines(capsys.readouterr().out)
    assert port_lines == ["clip 1/2 audio_start=0", "clip 2/2 audio_start=80"]
    pipe = record["pipe"]
    assert pipe.dit.cfg.enable_multitalk and list(pipe._audio_emb_cache) == [str(SPEECH)]
    assert pipe._audio_emb_cache[str(SPEECH)].shape[1:] == (12, 768)
    frames = np.load(record["paths"][-1])
    assert record["frames"] == frames.shape[0] == 2 * NUM_FRAMES  # the overlap is kept
    assert len(record["paths"]) == 2

    want = _run_jax("test_svi_talk", [*argv, "--output", str(tmp_path / "jax")], monkeypatch)
    assert port_lines == _clip_lines(capsys.readouterr().out)
    _close(frames, want)


@pytest.mark.parametrize("driver", [port_dance, port_talk])
def test_variant_drivers_default_to_the_card(inputs, tmp_path, driver):
    root, files = inputs
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card path is chip_smoke.py's")
    argv = ["--dit_root", str(root / "weights"), "--output", str(tmp_path)]
    argv += (["--image_path", "x.png", "--pose_path", "x.mp4"] if driver is port_dance
             else ["--ref_image_path", "x.png", "--audio_path", "x.wav"])
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(argv)
    with pytest.raises(NotImplementedError, match="--sequential_cfg"):
        driver.main([*argv, "--sequential_cfg", "latent"], device="cpu")


def test_customtalk_flag_is_accepted(inputs, tmp_path):
    """--train_architecture is read nowhere at inference (the DiT's variant
    follows the checkpoint's keys): the shot driver runs with customtalk."""
    root, files = inputs
    (root / "prompt.txt").write_text('prompts = ["A lone explorer walks across green hills."]\n')
    record = port_svi.main(
        ["--dit_root", str(root / "weights"), "--extra_module_root", files["lora"],
         "--output", str(tmp_path), "--ref_image_path", str(root / "frame.png"),
         "--prompt_path", str(root / "prompt.txt"), "--ref_pad_num", "-1", "--num_clips", "1",
         "--num_steps", "1", "--num_frames", "5", "--max_width", "64", "--save_format", "npy",
         "--train_architecture", "customtalk"], device="cpu")
    assert record["samples"][0]["frames"] == 5
