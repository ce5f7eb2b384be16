"""The port's data and checkpoint tools (svi_tpu_torch/scripts/extract_lora,
prepare_video_audio, make_toy_data, process_mixkit), its recipes, its
experiment bookkeeping and its f32 convolution policy, on the CPU.

Each tool runs beside the JAX package's script on the same files where that
script can run here (scripts/*.py, unchanged, loaded from their paths), with
the tolerance stated at each test; the .npy paths, which serve machines
without Pillow, imageio or cv2, are held to the same arrays.
"""

import importlib
import importlib.util
import pickle
import runpy
import shlex
import sys
import wave
from argparse import Namespace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from svi_tpu.utils import project_utils as jpu
from svi_tpu_torch.models import pose_embedding, wan_vae, wav2vec2
from svi_tpu_torch.models.model_io import load_state_dict
from svi_tpu_torch.scripts import extract_lora, make_toy_data, prepare_video_audio, process_mixkit
from svi_tpu_torch.utils import project_utils as tpu
from svi_tpu_torch.utils.safetensors_io import save_file
from test_torch_variants import real_audio_imports  # noqa: F401 (a fixture)
from torch_checkpoint_files import WAV2VEC_CFG

REPO = Path(__file__).resolve().parent.parent


def _load_script(name: str):
    """scripts/<name>.py as a module (it imports svi_tpu from the repo)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(name: str, argv: list, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"scripts/{name}.py", *argv])
    runpy.run_path(str(REPO / "scripts" / f"{name}.py"), run_name="__main__")


# ---------------------------------------------------------------------------
# extract_lora
# ---------------------------------------------------------------------------


def _trained_checkpoint(path: Path, fmt: str):
    """A checkpoint as the reference's trainer leaves one: LoRA pairs under
    pipe.dit. (bf16 and f32), a pose side module, and tensors that are
    dropped (base weights, optimizer state)."""
    g = torch.Generator().manual_seed(0)
    sd = {
        "pipe.dit.blocks.0.self_attn.q.lora_A.default.weight": torch.randn(4, 64, generator=g),
        "pipe.dit.blocks.0.self_attn.q.lora_B.default.weight":
            torch.randn(64, 4, generator=g).to(torch.bfloat16),
        "blocks.1.ffn.0.lora_A.default.weight": torch.randn(4, 64, generator=g),
        "pipe.dit.dwpose_embedding.0.weight": torch.randn(16, 3, 3, 3, 3, generator=g),
        "pipe.dit.dwpose_embedding.0.bias": torch.randn(16, generator=g),
        "pipe.dit.blocks.0.self_attn.q.weight": torch.randn(64, 64, generator=g),
        "optimizer.step": torch.ones(1),
    }
    if fmt == "safetensors":
        save_file(sd, str(path))
    else:
        torch.save({"state_dict": sd}, path)


@pytest.mark.parametrize("fmt", ["safetensors", "pth"])
def test_extract_lora_matches_the_jax_script(tmp_path, monkeypatch, fmt):
    """The same keys and, bit for bit, the same f32 values as
    scripts/extract_lora.py on the same checkpoint."""
    src = tmp_path / f"trained.{fmt}"
    _trained_checkpoint(src, fmt)
    _run_script("extract_lora", ["--input", str(src), "--output", str(tmp_path / "jax.st")],
                monkeypatch)
    n = extract_lora.main(["--input", str(src), "--output", str(tmp_path / "port.safetensors")])
    from safetensors.numpy import load_file as np_load

    want = np_load(str(tmp_path / "jax.st"))
    got = load_state_dict(str(tmp_path / "port.safetensors"))
    assert n == len(got) == 5
    assert sorted(got) == sorted(want)
    assert "blocks.0.self_attn.q.lora_A.default.weight" in got
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and w.dtype == np.float32
        assert got[k].numpy().tobytes() == w.tobytes(), k


def test_extract_lora_refuses_a_checkpoint_without_lora(tmp_path):
    save_file({"blocks.0.self_attn.q.weight": torch.zeros(2, 2)}, str(tmp_path / "a.safetensors"))
    with pytest.raises(SystemExit, match="no lora_"):
        extract_lora.main(["--input", str(tmp_path / "a.safetensors"),
                           "--output", str(tmp_path / "b.safetensors")])


# ---------------------------------------------------------------------------
# prepare_video_audio
# ---------------------------------------------------------------------------

# f32 wav2vec2 (the tiny tower of tests/torch_checkpoint_files.py) in two
# frameworks, sums in another order, relative to the largest state
PREP_REL = 1e-5


def _talk_sources(root: Path):
    """clips/talk_00.mp4 (cv2), clips/talk_01.npy, wavs/ of 0.6 s and 0.4 s at
    16 kHz, and the tiny wav2vec2 directory."""
    import cv2

    rng = np.random.default_rng(0)
    (root / "clips").mkdir()
    (root / "wavs").mkdir()
    frames = rng.integers(0, 255, (6, 32, 48, 3), dtype=np.uint8)
    writer = cv2.VideoWriter(str(root / "clips" / "talk_00.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 25, (48, 32))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    np.save(root / "clips" / "talk_01.npy", frames[:4])
    for stem, n in (("talk_00", 9600), ("talk_01", 6400)):
        pcm = (rng.standard_normal(n) * 6000).astype(np.int16)
        with wave.open(str(root / "wavs" / f"{stem}.wav"), "wb") as wf:
            wf.setnchannels(1)
            wf.setsampwidth(2)
            wf.setframerate(16000)
            wf.writeframes(pcm.tobytes())
    w2v = root / "w2v"
    w2v.mkdir()
    save_file(wav2vec2.torch_state_dict_from_params(
        wav2vec2.init_params(WAV2VEC_CFG, seed=8, device="cpu")), str(w2v / "model.safetensors"))
    return root / "clips", root / "wavs", w2v


def test_prepare_video_audio_matches_the_jax_script(tmp_path, monkeypatch, real_audio_imports):
    """On an mp4 with its wav: the same frame_data.pkl (JPEG bytes) and the
    audio embedding (12, s, 768) within PREP_REL; the .npy clip, which the
    JAX script does not read, gets the same kind of sample."""
    clips, wavs, w2v = _talk_sources(tmp_path)
    jax_clips = tmp_path / "jax_clips"
    jax_clips.mkdir()
    (jax_clips / "talk_00.mp4").write_bytes((clips / "talk_00.mp4").read_bytes())
    _run_script("prepare_video_audio", ["--video_dir", str(jax_clips), "--audio_dir", str(wavs),
                                        "--out_dir", str(tmp_path / "jax"),
                                        "--wav2vec_path", str(w2v)], monkeypatch)
    done = prepare_video_audio.main(["--video_dir", str(clips), "--audio_dir", str(wavs),
                                     "--out_dir", str(tmp_path / "port"),
                                     "--wav2vec_path", str(w2v)], device="cpu")
    assert done == {"talk_00": (12, 15, 768), "talk_01": (12, 10, 768)}
    for name in ("frame_data.pkl", "audio_embedding.pkl"):
        with open(tmp_path / "jax" / "talk_00" / name, "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "port" / "talk_00" / name, "rb") as f:
            got = pickle.load(f)
        if name == "frame_data.pkl":
            assert got == want
        else:
            assert got.shape == want.shape and got.dtype == want.dtype == np.float32
            assert np.abs(got - want).max() <= PREP_REL * np.abs(want).max()
    assert (tmp_path / "port" / "talk_01" / "frame_data.pkl").is_file()


def test_prepare_video_audio_writes_npy_frames_without_pillow(tmp_path, monkeypatch,
                                                              real_audio_imports):
    """Without Pillow the frames go into video.npy, which TalkVideoDataset
    reads beside audio_embedding.pkl."""
    from svi_tpu_torch.training.dataset import TalkVideoDataset

    clips, wavs, w2v = _talk_sources(tmp_path)
    monkeypatch.setattr(prepare_video_audio, "_pillow", lambda: None)
    prepare_video_audio.main(["--video_dir", str(clips), "--audio_dir", str(wavs),
                              "--out_dir", str(tmp_path / "out"), "--wav2vec_path", str(w2v),
                              "--device", "cpu"])
    got = np.load(tmp_path / "out" / "talk_01" / "video.npy")
    np.testing.assert_array_equal(got, np.load(clips / "talk_01.npy"))
    assert not (tmp_path / "out" / "talk_01" / "frame_data.pkl").exists()
    ds = TalkVideoDataset(str(tmp_path / "out"), seed=0)
    assert len(ds.video_list) == 2


def test_prepare_video_audio_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """The tool's default device is the card; with no CUDA it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_video_audio.main(["--video_dir", str(tmp_path), "--out_dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# make_toy_data
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def toy_data(tmp_path_factory):
    """The JAX script's output (its ROOT moved to a temporary dir) and the
    port's, with .npy images and videos as on a machine without Pillow,
    imageio or cv2."""
    root = tmp_path_factory.mktemp("toy")
    jmod = _load_script("make_toy_data")
    jmod.ROOT = str(root / "jax")
    jmod.main()
    make_toy_data.main(["--root", str(root / "port")],
                       writer=make_toy_data.Writer(pillow=False, videos=False))
    return jmod, root / "jax", root / "port"


def test_make_toy_data_arrays_equal_the_jax_script(toy_data):
    """The same generated arrays, and byte-equal speech.wav,
    audio_embedding.pkl and prompt files."""
    from PIL import Image

    jmod, jroot, proot = toy_data
    for rel in ("toy_test/talk/speech.wav", "toy_train/svi-talk/00001/audio_embedding.pkl",
                "toy_test/shot/prompt.txt", "toy_test/tom/prompt.txt"):
        assert (proot / rel).read_bytes() == (jroot / rel).read_bytes(), rel
    for rel in ("toy_test/dance/image", "toy_test/talk/portrait"):  # lossless PNGs there
        np.testing.assert_array_equal(np.load(proot / f"{rel}.npy"),
                                      np.asarray(Image.open(jroot / f"{rel}.png")))
    np.testing.assert_array_equal(
        np.load(proot / "toy_test/shot/frame.npy"),
        jmod.scene_frame(0, 480, 832, seed=make_toy_data.name_seed("shot"), style="shot"))
    videos = {"toy_test/dance/pose": [jmod.pose_frame(t, 448, 256) for t in range(96)],
              "toy_train/svi-dance/00001/dwpose": [jmod.pose_frame(t, 144, 256)
                                                   for t in range(96)],
              "toy_train/svi-film-shot/hills/hills_01": [jmod.scene_frame(t, 144, 256, seed=11)
                                                         for t in range(100)],
              "toy_train/svi-talk/00001/video": [jmod.portrait(144, 144, seed=t % 7)
                                                 for t in range(96)]}
    for rel, frames in videos.items():
        np.testing.assert_array_equal(np.load(proot / f"{rel}.npy"), np.stack(frames), rel)
    # the JAX script's JPEG pickles need Pillow; the port writes them where it has it
    assert (jroot / "toy_train/svi-dance/preprocessed/00001/frame_data.pkl").is_file()
    assert not (proot / "toy_train/svi-dance/preprocessed").exists()


def test_make_toy_data_npy_output_is_read_by_the_datasets(toy_data):
    from svi_tpu_torch.training.dataset import (DanceVideoDataset, TalkVideoDataset,
                                                TextVideoDataset)

    _, _, proot = toy_data
    kw = dict(max_num_frames=5, num_frames=5, height=64, width=112, seed=0)
    text = TextVideoDataset(str(proot / "toy_train/svi-film-shot"), **kw)
    assert len(text.video_list) == 4 and all(v["path"].endswith(".npy")
                                             for v in text.video_list)
    assert {v["description"] for v in text.video_list} >= {
        "A synthetic hills scene with a drifting sun, clip 0."}
    for ds in (text, DanceVideoDataset(str(proot / "toy_train/svi-dance"), **kw),
               TalkVideoDataset(str(proot / "toy_train/svi-talk"), **kw)):
        video = np.asarray(ds[0]["video"])
        assert video.shape[-2:] == (64, 112) and np.isfinite(video).all()


# ---------------------------------------------------------------------------
# process_mixkit and the experiment bookkeeping
# ---------------------------------------------------------------------------


def test_process_mixkit_on_npy_clips(tmp_path):
    """16:9 clips long enough are cut, resized (area average) and listed with
    their captions; a 4:3 clip and a short one are skipped."""
    rng = np.random.default_rng(1)
    src, caps = tmp_path / "raw", tmp_path / "caps"
    src.mkdir()
    caps.mkdir()
    np.save(src / "a.npy", rng.integers(0, 255, (12, 36, 64, 3), dtype=np.uint8))
    np.save(src / "b.npy", rng.integers(0, 255, (12, 48, 64, 3), dtype=np.uint8))  # 4:3
    np.save(src / "c.npy", rng.integers(0, 255, (5, 36, 64, 3), dtype=np.uint8))  # short
    (caps / "a.txt").write_text("a drifting sun\n")
    kept = process_mixkit.main(["--input_dir", str(src), "--output_dir", str(tmp_path / "out"),
                                "--caption_dir", str(caps), "--width", "32", "--height", "18",
                                "--num_frames", "8", "--category", "clips"])
    assert kept == (1, 2)
    got = np.load(tmp_path / "out" / "clips" / "a.npy")
    x = torch.from_numpy(np.load(src / "a.npy")[:8]).permute(0, 3, 1, 2).float()
    want = F.adaptive_avg_pool2d(x, (18, 32)).round().to(torch.uint8).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got, want.numpy())
    csv = (tmp_path / "out" / "clips" / "clips.csv").read_text().splitlines()
    assert csv == ["Filename,Video Description", "a.npy,a drifting sun"]


def test_process_mixkit_needs_cv2_for_mp4(tmp_path, monkeypatch):
    import builtins

    (tmp_path / "raw").mkdir()
    (tmp_path / "raw" / "x.mp4").write_bytes(b"")
    real_import = builtins.__import__
    monkeypatch.setattr(builtins, "__import__", lambda name, *a, **k: (
        (_ for _ in ()).throw(ImportError(name)) if name == "cv2" else real_import(name, *a, **k)))
    with pytest.raises(RuntimeError, match="needs OpenCV"):
        process_mixkit.main(["--input_dir", str(tmp_path / "raw"),
                             "--output_dir", str(tmp_path / "out")])


def test_project_utils_match_jax(tmp_path, capsys):
    for name in ("x.mp4", "y.mov", "z.txt"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "x.txt").write_text("a caption")
    n_j = jpu.generate_metadata_with_captions(str(tmp_path), str(tmp_path),
                                              str(tmp_path / "j.csv"), "default")
    n_t = tpu.generate_metadata_with_captions(str(tmp_path), str(tmp_path),
                                              str(tmp_path / "t.csv"), "default")
    assert n_t == n_j == 2
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    args = dict(output_path=str(tmp_path / "exp"), train_architecture="lora", lora_rank=16,
                exp_prefix="svi-shot", note=Path("p"))
    a_t, a_j = tpu.update_experiment_path(Namespace(**args)), jpu.update_experiment_path(
        Namespace(**args))
    assert a_t.output_path == a_j.output_path == str(tmp_path / "exp" / "svi-shot-lora_16")
    tpu.print_args(a_t)
    out_t = capsys.readouterr().out
    jpu.print_args(a_j)
    assert out_t == capsys.readouterr().out
    p_t = tpu.save_args(a_t, str(tmp_path / "t"))
    p_j = jpu.save_args(a_j, str(tmp_path / "j"))
    saved = sorted(Path(tmp_path / "t").iterdir())
    assert [p.name for p in saved] == [p.name for p in sorted(Path(tmp_path / "j").iterdir())]
    assert saved[0].read_bytes() == sorted(Path(tmp_path / "j").iterdir())[0].read_bytes()
    assert Path(p_t).name == Path(p_j).name


# ---------------------------------------------------------------------------
# the recipes
# ---------------------------------------------------------------------------

RECIPES = sorted(str(p.relative_to(REPO)) for p in
                 (REPO / "svi_tpu_torch" / "scripts" / "recipes").glob("*/*.sh"))


def _recipe_command(text: str):
    """(module, argv) of a recipe's python command, its $W expanded; a JAX
    recipe's `python scripts/X.py` reads as module scripts.X, its
    WARM_COMPILE line is skipped."""
    env, lines = {}, []
    for line in text.splitlines():
        if line.startswith("#") or not line.strip() or "WARM_COMPILE" in line:
            continue
        if "=" in line.split()[0] and not line.startswith("python"):
            k, v = line.split("=", 1)
            env[k] = v
            continue
        lines.append(line.rstrip("\\").strip())
    words = [w.replace("$W", env.get("W", "")) for w in shlex.split(" ".join(lines))]
    if words[1].startswith("scripts/"):
        words = ["python", "-m", words[1][:-3].replace("/", ".")] + words[2:]
    assert words[:2] == ["python", "-m"], words[:3]
    return words[2], words[3:]


def test_recipes_cover_the_jax_recipes():
    jax_recipes = sorted(str(p.relative_to(REPO / "scripts")) for p in
                         (REPO / "scripts").glob("t*/*.sh"))
    assert [r.split("recipes/")[1] for r in RECIPES] == jax_recipes


@pytest.mark.parametrize("recipe", RECIPES)
def test_recipe_parses_with_its_driver(recipe):
    """Each recipe's flags are those of its JAX recipe and parse with the
    port's driver."""
    module, argv = _recipe_command((REPO / recipe).read_text())
    jax_module, jax_argv = _recipe_command(
        (REPO / "scripts" / recipe.split("recipes/")[1]).read_text())
    assert module == "svi_tpu_torch." + jax_module and argv == jax_argv
    args = importlib.import_module(module).parse_args(argv)
    if "train" in recipe:
        assert args.training_strategy == "data_parallel"


# ---------------------------------------------------------------------------
# f32 convolutions stay f32
# ---------------------------------------------------------------------------


def test_f32_convs_run_with_cudnn_tf32_off(monkeypatch):
    """With cuDNN TF32 switched on for the process, every f32 convolution of
    the VAE, the pose stack and wav2vec2 sees it off at call time, and the
    switch is on again afterwards; a bf16 convolution keeps it."""
    seen = []

    def recorder(fn):
        def wrapped(x, *args, **kwargs):
            seen.append((fn.__name__, x.dtype, torch.backends.cudnn.allow_tf32))
            return fn(x, *args, **kwargs)
        return wrapped

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(F, "conv3d", recorder(F.conv3d))
    monkeypatch.setattr(F, "conv1d", recorder(F.conv1d))
    with torch.inference_mode():
        vae = wan_vae.init_params(wan_vae.WanVAEConfig(dim=16, z_dim=4), seed=0, device="cpu")
        video = torch.rand(1, 3, 5, 32, 32) * 2 - 1
        vae.decode(vae.encode(video))
        pose = pose_embedding.init_params(32, seed=0, device="cpu")
        pose(torch.rand(1, 3, 4, 64, 64) * 255)
        tower = wav2vec2.init_params(WAV2VEC_CFG, seed=0, device="cpu")
        tower(torch.randn(1, 3200), 5)
        pose_bf16 = pose_embedding.init_params(32, seed=0, device="cpu", dtype=torch.bfloat16)
        pose_bf16(torch.rand(1, 3, 4, 64, 64) * 255)
    f32 = [s for s in seen if s[1] == torch.float32]
    assert {s[0] for s in f32} == {"conv3d", "conv1d"} and len(f32) > 30
    assert not any(s[2] for s in f32), "an f32 convolution ran with cuDNN TF32 on"
    assert all(s[2] for s in seen if s[1] == torch.bfloat16)
    assert torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("conv,x_shape,w_shape,kw", [
    (F.conv3d, (2, 3, 5, 9, 9), (4, 3, 3, 3, 3), dict(stride=(1, 2, 2), padding=(1, 1, 1))),
    (F.conv1d, (2, 8, 40), (8, 2, 5), dict(padding=2, groups=4)),
    (F.conv1d, (2, 3, 40), (6, 3, 4), dict(stride=2))])
def test_conv_f32_backward_runs_with_cudnn_tf32_off(conv, x_shape, w_shape, kw, monkeypatch):
    """Where a gradient is taken (the pose stack in training), the backward
    of an f32 convolution also runs with TF32 off, and gives the gradients
    of the plain convolution bit for bit."""
    from svi_tpu_torch.ops.conv import conv_f32

    g = torch.Generator().manual_seed(0)
    x, w, b = (torch.randn(shape, generator=g, requires_grad=True)
               for shape in (x_shape, w_shape, w_shape[:1]))
    real, seen = torch.ops.aten.convolution_backward, []

    def recorded(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", recorded)
    y = conv_f32(conv, x, w, b, **kw)
    gy = torch.randn(y.shape, generator=g)
    got = torch.autograd.grad(y, (x, w, b), gy)
    monkeypatch.undo()
    want_y = conv(x, w, b, **kw)
    want = torch.autograd.grad(want_y, (x, w, b), gy)
    assert seen == [False] and torch.equal(y, want_y)
    for a, c in zip(got, want):
        assert torch.equal(a, c)
