"""The port's prompt tools and the subpackages' exports against svi_tpu, on the
CPU: the prompt refiners with stub generators, Omost's canvas (masks and
prompts), the Qwen-VL input helpers, the prompt expander's dispatch, the
VACE processors and `prepare_source`, and each subpackage's `__all__`.

Everything host-side is held exactly (numpy and Pillow on both sides), except
`prepare_source`'s letterbox resize: svi_tpu runs `jax.image.resize`
(XLA's f32 contraction), the port the same weights through torch's, so the
two differ by f32 rounding: 1e-5.
"""

import base64
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from svi_tpu.prompters import omost as jomost
from svi_tpu.prompters import prompt_refiners as jpr
from svi_tpu.utils import prompt_extend as jpe
from svi_tpu.utils import qwen_vl as jqv
from svi_tpu.utils import vace_processor as jvace
from svi_tpu_torch.prompters import omost as tomost
from svi_tpu_torch.prompters import prompt_refiners as tpr
from svi_tpu_torch.utils import prompt_extend as tpe
from svi_tpu_torch.utils import qwen_vl as tqv
from svi_tpu_torch.utils import vace_processor as tvace

REPO = Path(__file__).resolve().parent.parent
RESIZE_TOL = 1e-5

CANVAS_PROGRAM = """```python
canvas = Canvas()
canvas.set_global_description(
    description='A serene lake at dawn',
    detailed_descriptions=['Mist drifts over the water', 'Golden light'],
    tags='lake, dawn, mist', HTML_web_color_name='sky blue')
canvas.add_local_description(
    location='on the left', offset='slightly to the upper',
    area='a medium-sized vertical area', distance_to_viewer=2.5,
    description='A wooden boat', detailed_descriptions=['An old rowboat'],
    tags='boat', atmosphere='calm', style='realistic',
    quality_meta='high detail', HTML_web_color_name='saddlebrown')
canvas.add_local_description(
    location='on the bottom-rigth', offset='no offset',
    area='a large square area', distance_to_viewer=5.0,
    description='The lake surface', detailed_descriptions=['Reflections'],
    tags='water', atmosphere='serene', style='photo', quality_meta='4k',
    HTML_web_color_name='navyblue')
```"""
BOT_RESPONSE = f"Sure! Here is the canvas:\n{CANVAS_PROGRAM}\nEnjoy."


# ---------------------------------------------------------------------------
# prompt refiners
# ---------------------------------------------------------------------------


def test_prompt_refiners_match_svi_tpu(capsys):
    """BeautifulPrompt, QwenPrompt and Translator with stub generators: the
    same text handed to the generator, the same prompt back."""
    seen = {"j": [], "t": []}

    def gen(side):
        return lambda text: seen[side].append(text) or " vivid colours, 4k "

    def chat(side):
        return lambda messages: seen[side].append(messages) or f"EN({messages[-1]['content']})"

    for side, mod in (("j", jpr), ("t", tpr)):
        bp = mod.BeautifulPrompt(gen(side), mod.beautiful_prompt_template_for("ckpt/v2"))
        qp = mod.QwenPrompt(chat(side))
        tr = mod.Translator(lambda text: text[::-1])
        seen[side].append((bp("a cat"), bp("a cat", positive=False), qp("一只猫"),
                           qp("x", positive=False), tr("abc")))
    assert seen["t"] == seen["j"]
    assert seen["t"][-1][0] == "a cat, vivid colours, 4k"
    for name in ("BEAUTIFUL_PROMPT_TEMPLATE_V1", "BEAUTIFUL_PROMPT_TEMPLATE_V2",
                 "QWEN_SYSTEM_PROMPT"):
        assert getattr(tpr, name) == getattr(jpr, name)
    assert tpr.beautiful_prompt_template_for("a/v1") == jpr.BEAUTIFUL_PROMPT_TEMPLATE_V1
    capsys.readouterr()


def test_refiners_load_through_the_model_manager(monkeypatch):
    """`BasePrompter.load_prompt_refiners` builds BeautifulPrompt through its
    `from_model_manager`: the checkpoint path the manager recorded picks the
    template, and the generator is built from that path (stubbed here: the
    real one loads a local transformers checkpoint)."""
    from svi_tpu_torch.prompters.base_prompter import BasePrompter

    class Manager:
        def fetch_model(self, name, require_model_path=False):
            assert name == "beautiful_prompt" and require_model_path
            return None, "models/BeautifulPrompt/v2"

    built = []
    monkeypatch.setattr(tpr, "_causal_generate_fn", lambda path, max_new_tokens, sample_kwargs:
                        built.append((path, max_new_tokens)) or (lambda text: "tags"))
    p = BasePrompter()
    p.load_prompt_refiners(Manager(), [tpr.BeautifulPrompt])
    assert built == [("models/BeautifulPrompt/v2", 384)]
    assert p.refiners[0].template == tpr.BEAUTIFUL_PROMPT_TEMPLATE_V2
    assert p.process_prompt("a fox") == "a fox, tags"


# ---------------------------------------------------------------------------
# Omost
# ---------------------------------------------------------------------------


def test_omost_canvas_masks_and_prompts_match_svi_tpu(capsys):
    """The canvas program (a misspelt location corrected by the fuzzy match)
    parsed and processed by both packages: the sketch, every mask, the
    prompts, and the PIL masks of `canvas_to_prompt_dict`, equal."""
    assert tomost.valid_colors == jomost.valid_colors
    got = tomost.canvas_to_prompt_dict(tomost.Canvas.from_bot_response(BOT_RESPONSE),
                                       {"prompt": "p"})
    want = jomost.canvas_to_prompt_dict(jomost.Canvas.from_bot_response(BOT_RESPONSE),
                                        {"prompt": "p"})
    assert got["prompt"] == want["prompt"] and got["prompts"] == want["prompts"]
    assert np.array_equal(got["initial_latent"], want["initial_latent"])
    assert len(got["bag_of_conditions"]) == len(want["bag_of_conditions"]) == 3
    for a, b in zip(got["bag_of_conditions"], want["bag_of_conditions"]):
        assert np.array_equal(a["mask"], b["mask"]) and a["mask"].dtype == b["mask"].dtype
        assert (a["prefixes"], a["suffixes"], a["location"]) == \
            (b["prefixes"], b["suffixes"], b["location"])
    for a, b in zip(got["masks"], want["masks"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="codes"):
        tomost.Canvas.from_bot_response("no code here")
    capsys.readouterr()


def test_omost_prompter_extends_through_chat(capsys):
    convs = []
    out = tomost.OmostPromter(chat_fn=lambda c: convs.append(c) or BOT_RESPONSE)(
        {"prompt": "a lake"})
    ref = jomost.OmostPromter(chat_fn=lambda c: BOT_RESPONSE)({"prompt": "a lake"})
    assert convs[0][0]["content"] == jomost.OMOST_SYSTEM_TEMPLATE
    assert convs[0][1] == {"role": "user", "content": "a lake"}
    assert out["prompt"] == ref["prompt"] and out["prompts"] == ref["prompts"]
    assert capsys.readouterr().out.count("Component") == 6


# ---------------------------------------------------------------------------
# Qwen-VL inputs
# ---------------------------------------------------------------------------


def test_smart_resize_and_nframes_match_svi_tpu():
    for h, w in [(28, 28), (100, 60), (1080, 1920), (3000, 4000), (5, 900), (7000, 200)]:
        for kw in ({}, dict(min_pixels=128 * 28 * 28, max_pixels=256 * 28 * 28)):
            assert tqv.smart_resize(h, w, **kw) == jqv.smart_resize(h, w, **kw)
    with pytest.raises(ValueError, match="aspect ratio"):
        tqv.smart_resize(10, 3000)
    for ele, total, fps in [({}, 300, 30.0), ({"fps": 4.0}, 300, 30.0), ({"nframes": 7}, 40, 24.0),
                            ({"min_frames": 9, "max_frames": 20}, 500, 25.0), ({}, 9, 30.0)]:
        assert tqv.smart_nframes(ele, total, fps) == jqv.smart_nframes(ele, total, fps)


def _png(tmp_path, seed, hw=(90, 130)):
    arr = np.random.default_rng(seed).integers(0, 255, (*hw, 3), dtype=np.uint8)
    path = tmp_path / f"img{seed}.png"
    Image.fromarray(arr).save(path)
    return path


def test_process_vision_info_matches_svi_tpu(tmp_path):
    """Chat messages with a local path, a file:// URL, a base64 data URI
    (with fixed resized dims) and a frame list: the same images and frames."""
    p0, p1 = _png(tmp_path, 0), _png(tmp_path, 1, (50, 50))
    b64 = "data:image/png;base64," + base64.b64encode(p1.read_bytes()).decode()
    messages = [{"role": "user", "content": [
        {"type": "text", "text": "describe"},
        {"type": "image", "image": str(p0)},
        {"type": "image", "image": f"file://{p1}", "min_pixels": 64 * 28 * 28},
        {"type": "image_url", "image_url": b64, "resized_height": 60, "resized_width": 90},
        {"type": "video", "video": [str(p0), str(p1), str(p0)]},
    ]}]
    got, want = tqv.process_vision_info(messages), jqv.process_vision_info(messages)
    assert len(got[0]) == len(want[0]) == 3 and len(got[1]) == len(want[1]) == 1
    for a, b in zip(got[0] + got[1][0], want[0] + want[1][0]):
        assert a.size == b.size and np.array_equal(np.asarray(a), np.asarray(b))
    assert len(got[1][0]) == 4  # padded to FRAME_FACTOR
    assert tqv.process_vision_info([{"role": "user", "content": "text"}]) == (None, None)


# ---------------------------------------------------------------------------
# the prompt expander
# ---------------------------------------------------------------------------


def test_prompt_expander_dispatch_matches_svi_tpu():
    """The system prompt by language, vision input and image count; the
    seed kept; the texts equal; the local Qwen expander builds without
    weights; DashScope is gated on its package in both."""
    for mod in (jpe, tpe):
        class Echo(mod.PromptExpander):
            def extend(self, prompt, system_prompt, seed=-1, *args, **kwargs):
                return mod.PromptOutput(True, prompt + "!", seed, system_prompt, "")

            def extend_with_img(self, prompt, system_prompt, image=None, seed=-1, *a, **k):
                return mod.PromptOutput(True, prompt + "?", seed, system_prompt, str(image))

        outs = [Echo("m")("a cat", tar_lang="en", seed=3), Echo("m")("一只猫", seed=4),
                Echo("m", is_vl=True)("a cat", image="x.png", tar_lang="en", seed=5),
                Echo("m", is_vl=True)("a cat", image=["a", "b"], seed=6)]
        if mod is jpe:
            want = [(o.prompt, o.seed, o.system_prompt, o.message) for o in outs]
        else:
            got = [(o.prompt, o.seed, o.system_prompt, o.message) for o in outs]
    assert got == want
    assert tpe.SYSTEM_PROMPT_TYPES == jpe.SYSTEM_PROMPT_TYPES
    q = tpe.QwenPromptExpander(model_name="Qwen2.5_3B")
    assert q.model_name == jpe.QwenPromptExpander(model_name="Qwen2.5_3B").model_name
    assert q.model is None
    if importlib.util.find_spec("dashscope") is None:
        with pytest.raises(ImportError, match="dashscope"):
            tpe.DashScopePromptExpander(api_key="k")


def test_load_system_prompts(tmp_path, monkeypatch):
    monkeypatch.setattr(tpe, "SYSTEM_PROMPT_TYPES", dict(tpe.SYSTEM_PROMPT_TYPES))
    path = tmp_path / "prompts.json"
    path.write_text('{"0": "official en", "3": "official vl zh"}', encoding="utf-8")
    tpe.load_system_prompts(str(path))
    assert tpe.SYSTEM_PROMPT_TYPES[0] == "official en"
    assert tpe.PromptExpander("m", is_vl=True).decide_system_prompt("zh") == "official vl zh"


# ---------------------------------------------------------------------------
# VACE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keep_last,zero_start", [(True, True), (False, False)])
def test_vace_frame_ids_and_boxes_match_svi_tpu(keep_last, zero_start):
    args = dict(downsample=(4, 8, 8), min_area=480 * 832 // 4, max_area=480 * 832, min_fps=8,
                max_fps=24, zero_start=zero_start, seq_len=32760, keep_last=keep_last)
    fps, n = 30.0, 120
    ts = np.stack([np.arange(n) / fps, (np.arange(n) + 1) / fps], axis=1).astype(np.float32)
    got = tvace.VaceVideoProcessor(**args)._get_frameid_bbox(
        fps, ts, 480, 640, (10, 600, 20, 470), np.random.default_rng(7))
    want = jvace.VaceVideoProcessor(**args)._get_frameid_bbox(
        fps, ts, 480, 640, (10, 600, 20, 470), np.random.default_rng(7))
    assert got[:3] == want[:3]
    assert got[3] == want[3]


def test_vace_processors_match_svi_tpu(tmp_path):
    """The image processor on a PNG and an RGBA PIL image (the budgeted size,
    the LANCZOS cover crop), the video processor's bicubic cover crop."""
    path = _png(tmp_path, 3, (300, 500))
    rgba = Image.fromarray(np.random.default_rng(4).integers(0, 255, (120, 90, 4), np.uint8))
    for key in (str(path), rgba):
        got = tvace.VaceImageProcessor(downsample=(4, 8, 8), seq_len=1024).load_image(key)
        want = jvace.VaceImageProcessor(downsample=(4, 8, 8), seq_len=1024).load_image(key)
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
    video = np.random.default_rng(5).integers(0, 255, (5, 60, 90, 3)).astype(np.uint8)
    assert np.array_equal(tvace.VaceVideoProcessor.resize_crop(video, 48, 64),
                          jvace.VaceVideoProcessor.resize_crop(video, 48, 64))


@pytest.mark.parametrize("ref_hw", [(30, 40), (200, 90)])
def test_prepare_source_matches_svi_tpu(ref_hw):
    """Missing video and mask filled; a reference image letterboxed onto the
    white canvas at an upscale (30 x 40 -> 48 x 64) and a downscale (200 x
    90 -> 64 x 28, antialiased): against svi_tpu's jax.image.resize."""
    ref = np.random.default_rng(sum(ref_hw)).uniform(-1, 1, (3, 1, *ref_hw)).astype(np.float32)
    out = {}
    for name, mod in (("t", tvace), ("j", jvace)):
        out[name] = mod.prepare_source([None, np.zeros((3, 9, 64, 64), np.float32)],
                                       [None, np.ones((1, 9, 64, 64), np.float32)],
                                       [[ref.copy(), None], None], 9, (64, 64))
    (tv, tm, tr), (jv, jm, jr) = out["t"], out["j"]
    for a, b in zip(tv + tm, jv + jm):
        assert np.array_equal(a, b)
    assert tr[0][1] is None and tr[1] is None
    assert tr[0][0].shape == jr[0][0].shape == (3, 1, 64, 64)
    assert np.abs(tr[0][0] - np.asarray(jr[0][0])).max() <= RESIZE_TOL


# ---------------------------------------------------------------------------
# the subpackages' exports
# ---------------------------------------------------------------------------

PACKAGES = ("pipelines", "models", "prompters", "schedulers", "training", "utils", "ops")
# svi_tpu names with no counterpart of that name in the port, and why
NOT_EXPORTED = {
    "models.downloader": "not ported: it fetches checkpoints over the network",
    "ops.apply_rope": ("recorded divergence: the port rotates q and k in the attention kernels' "
                       "RoPE pre-pass (`attention.rope_rotate_flat`)"),
    "pipelines.model_fn_wan_video": ("recorded divergence: the method "
                                     "`SVIVideoPipeline.denoising_model`"),
    "training.make_train_step": ("recorded divergence: the trainer's method "
                                 "`ErrorRecyclingTrainer.train_step`"),
}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_exports_cover_svi_tpus(pkg):
    """Each subpackage's `__all__` covers svi_tpu's, apart from NOT_EXPORTED,
    and every exported name resolves; `training` also exports
    `text_to_image`."""
    ours = importlib.import_module(f"svi_tpu_torch.{pkg}")
    ref = importlib.import_module(f"svi_tpu.{pkg}")
    missing = sorted(n for n in ref.__all__ if n not in ours.__all__
                     and f"{pkg}.{n}" not in NOT_EXPORTED)
    assert not missing, missing
    assert all(n not in ours.__all__ for n in ref.__all__ if f"{pkg}.{n}" in NOT_EXPORTED)
    for n in ours.__all__:
        assert getattr(ours, n) is not None
    if pkg == "training":
        assert "text_to_image" in ours.__all__
        assert ours.text_to_image.T2ILoRATrainer.__module__.endswith("text_to_image")


def test_exports_and_prompt_tools_import_no_pillow_or_cv2():
    """In a fresh interpreter, importing every subpackage, the prompt tools,
    the trainer and the gradio core, and resolving the SD / Step / OmniGen
    paths' exports, loads no PIL, cv2, imageio, jax or svi_tpu."""
    code = (
        "import sys\n"
        "import svi_tpu_torch.pipelines as p, svi_tpu_torch.models as m\n"
        "import svi_tpu_torch.prompters as pr, svi_tpu_torch.schedulers as s\n"
        "import svi_tpu_torch.training as t, svi_tpu_torch.utils as u, svi_tpu_torch.ops as o\n"
        "import svi_tpu_torch.prompters.omost, svi_tpu_torch.prompters.prompt_refiners\n"
        "import svi_tpu_torch.utils.qwen_vl, svi_tpu_torch.utils.prompt_extend\n"
        "import svi_tpu_torch.utils.vace_processor, svi_tpu_torch.training.text_to_image\n"
        "import svi_tpu_torch.scripts.gradio_demo\n"
        "p.SDVideoPipeline, p.SDXLVideoPipeline, p.StepVideoPipeline, p.OmnigenImagePipeline\n"
        "m.sd, m.sdxl, m.stepvideo, m.omnigen, m.ModelManager, pr.SDPrompter, pr.OmostPromter\n"
        "s.EnhancedDDIMScheduler, t.text_to_image, o.attention_bnsd, u.image_process\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('PIL', 'cv2', 'imageio', 'jax', 'jaxlib', 'svi_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
