"""The gradio demo's core in the port (svi_tpu_torch/scripts/gradio_demo.py)
against svi_tpu's (scripts/gradio_demo.py, run unchanged), both in-process
on the same tiny checkpoint files (tests/torch_checkpoint_files.py): the
prompt parsing, the mode switch and demo content, the preview wrapper, and
the clips streamed by `generate_video` after `initialize_models`.

svi_tpu's demo writes mp4s through `svi_tpu.utils.video.save_video`, which is
replaced here by a capture of the frames; the port's writes `.npy` arrays.
Frame bounds: those of tests/test_torch_driver.py, which runs the same
pipeline on the same files (bf16 DiT, XLA's CPU ops against PyTorch's, CFG 5):
mean 2 levels, max 24 of 255.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (svi_tpu's demo runs in this process)

import svi_tpu.utils.video as jax_video
from svi_tpu_torch.scripts import gradio_demo as tgd
from torch_checkpoint_files import LORA_FILE, write_tiny_checkpoints

REPO = Path(__file__).resolve().parent.parent
NUM_FRAMES = 9  # film mode recycles 5 motion frames
MEAN_LEVELS, MAX_LEVELS = 2.0, 24


def _jax_demo():
    spec = importlib.util.spec_from_file_location("jax_gradio_demo",
                                                  REPO / "scripts" / "gradio_demo.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jgd = _jax_demo()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("gradio") / "weights"
    write_tiny_checkpoints(root)
    return root


@pytest.mark.parametrize("text", [
    "a\nb\n\n c ", '["x", " y ", ""]', "p, q,, r", "single", "", "   ", "[not, a list",
    '["only"]', "[1, 2]", "line one, with comma\nline two"])
def test_parse_prompts_matches_svi_tpu(text):
    assert tgd.SVIGradioDemo.parse_prompts(text) == jgd.SVIGradioDemo.parse_prompts(text)


def test_mode_switch_and_demo_content_match_svi_tpu(monkeypatch):
    monkeypatch.chdir(REPO)
    port = tgd.SVIGradioDemo("unused", mode="film", device="cpu")
    ref = jgd.SVIGradioDemo("unused", mode="film")
    for demo in (port, ref):
        demo.pipe = object()
    for mode in ("shot", "nope", "film"):
        assert port.switch_model_mode(mode) == ref.switch_model_mode(mode)
        assert port.mode == ref.mode
    assert port.pipe is None and ref.pipe is None  # a switch forces re-initialisation
    for mode in ("film", "shot"):
        assert port.get_demo_content_for_mode(mode) == ref.get_demo_content_for_mode(mode)
    assert port.get_current_mode_config() == ref.get_current_mode_config()
    assert tgd.MODEL_MODES == jgd.MODEL_MODES and tgd.NEGATIVE == jgd.NEGATIVE
    assert tgd.STREAMING_EXAMPLES == jgd.STREAMING_EXAMPLES


def test_preview_wrapper_validates_and_streams(tmp_path):
    """The UI wrapper: the same status HTML as svi_tpu's for a demo with no
    models, no image or no prompt; then one (path, status) per clip and the
    final one, on a stub pipeline."""
    port = tgd.SVIGradioDemo("unused", output_dir=str(tmp_path), mode="shot", device="cpu",
                             save_format="npy")
    ref = jgd.SVIGradioDemo("unused", output_dir=str(tmp_path), mode="shot")
    image = np.random.default_rng(0).integers(0, 255, (32, 48, 3), np.uint8)
    args = ("a cat", tgd.NEGATIVE, 2, 2, 5.0, 1)
    assert list(port.generate_video_with_preview(image, *args)) == \
        list(ref.generate_video_with_preview(image, *args))
    port.pipe = ref.pipe = object()
    for img, prompts in ((None, "a cat"), (image, "  ")):
        assert list(port.generate_video_with_preview(img, prompts, *args[1:])) == \
            list(ref.generate_video_with_preview(img, prompts, *args[1:]))

    calls = []

    def stub(**kw):
        calls.append(kw)
        return [np.full((kw["height"], kw["width"], 3), len(calls), np.uint8)] * kw["num_frames"]

    port.pipe = stub
    out = list(port.generate_video_with_preview(image, "a cat", tgd.NEGATIVE, 2, 2, 5.0, 1,
                                                max_width=32))
    assert len(out) == 4 and out[0][0] is None
    frames = np.load(out[2][0])
    assert frames.shape == (2 * 81 - 1, 16, 32, 3)  # 32 x 48 capped at 32 wide, cut to 16s
    assert [c["seed"] for c in calls] == [0, 1]
    assert [c["prompt"] for c in calls] == ["a cat", "a cat"]


def test_initialize_refuses_without_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card path is chip_smoke.py's")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgd.SVIGradioDemo(str(weights)).initialize_models()


def test_streamed_clips_match_svi_tpus_demo(weights, tmp_path, monkeypatch):
    """`initialize_models` on the tiny files (the mode's LoRA pointed at the
    tiny LoRA in both demos) and `generate_video` for 2 film clips of 9
    frames at 2 steps: the same statuses, the cumulative video after each
    clip within the driver's bounds of svi_tpu's, and the same
    generation_info.json but for the timestamp and the file extension."""
    lora = str(weights / LORA_FILE)
    for mod in (tgd, jgd):
        monkeypatch.setitem(mod.MODEL_MODES, "film", {**mod.MODEL_MODES["film"],
                                                      "lora_path": lora})
    captured = {}
    monkeypatch.setattr(jax_video, "save_video", lambda f, path, **kw: captured.update(
        {Path(path).stem: np.stack([np.asarray(x) for x in f])}))
    image = np.random.default_rng(1).integers(0, 255, (72, 96, 3), np.uint8)
    kw = dict(num_clips=2, num_steps=2, seed=3, num_frames=NUM_FRAMES, max_width=64)

    port = tgd.SVIGradioDemo(str(weights), output_dir=str(tmp_path / "port"), mode="film",
                             device="cpu", save_format="npy")
    assert "SVI-Film" in port.initialize_models()
    assert port.pipe.device.type == "cpu"
    got = list(port.generate_video(image, "a cat\na dog", **kw))
    ref = jgd.SVIGradioDemo(str(weights), output_dir=str(tmp_path / "jax"), mode="film")
    ref.initialize_models()
    want = list(ref.generate_video(image, "a cat\na dog", **kw))

    assert [s for s, _ in got[:-1]] == [s for s, _ in want[:-1]]
    assert got[-1][0].split(" in ")[0] == want[-1][0].split(" in ")[0]
    n_frames = [NUM_FRAMES - 5, 2 * NUM_FRAMES - 5]
    for clip, (_, path) in enumerate(got[:-1]):
        frames = np.load(path)
        stem = Path(path).stem
        assert stem == f"cumulative_clips_1_to_{clip + 1}" and stem in captured
        assert frames.shape == captured[stem].shape == (n_frames[clip], 48, 64, 3)
        diff = np.abs(frames.astype(np.int16) - captured[stem].astype(np.int16))
        assert diff.mean() <= MEAN_LEVELS and diff.max() <= MAX_LEVELS, (diff.mean(), diff.max())
    assert got[-1][1] == got[-2][1]

    infos = []
    for side in ("port", "jax"):
        (session,) = os.listdir(tmp_path / side)
        infos.append(json.loads((tmp_path / side / session / "generation_info.json").read_text()))
    for info in infos:
        info.pop("timestamp")
    assert infos[0].pop("cumulative_videos") == [f"cumulative_clips_1_to_{i}.npy" for i in (1, 2)]
    infos[1].pop("cumulative_videos")
    assert infos[0] == infos[1]
