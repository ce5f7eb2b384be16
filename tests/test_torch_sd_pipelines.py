"""The SD 1.5 pipelines of the port (sd_image, sd_video with the long-video
blend, the config-driven runner), the processors, the regional-prompt merge
and the frame sources, against svi_tpu on the CPU, on the narrow seeded
models of tests/torch_sd_fixtures.py.

svi_tpu's pipelines run as they are, their UNet and VAE calls unjitted at
the top (the blocks inside are jitted, fx.jit_jax_blocks): the same
functions on the same inputs, compiled once per block shape.

Tolerances: latents and images before the uint8 cast within 1e-4 of their
largest magnitude (f32 in two frameworks, through CFG 7.5); uint8 frames
within one level; where a uint8 frame feeds the next step (the smoother)
an f32 difference can move a value across a rounding boundary, so that
run's latents are held to 1e-3 and its frames to one level.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from svi_tpu.models import controlnets as jcn
from svi_tpu.models import motion as jmo
from svi_tpu.models import sd as jsd
from svi_tpu.pipelines import base as jbase
from svi_tpu.pipelines import sd_image as jimage
from svi_tpu.pipelines import sd_video as jvideo
from svi_tpu_torch.models import controlnets as tcn
from svi_tpu_torch.models import motion as tmo
from svi_tpu_torch.models import sd as tsd
from svi_tpu_torch.pipelines import base as tbase
from svi_tpu_torch.pipelines import sd_image as timage
from svi_tpu_torch.pipelines import sd_video as tvideo

import torch_sd_fixtures as fx

F32_REL, SMOOTHED_REL, LEVELS = 1e-4, 1e-3, 1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def sds():
    mp = pytest.MonkeyPatch()
    fx.patch_narrow_plans(mp)
    out = fx.state_dicts(seed=7)
    mp.undo()
    return out


@pytest.fixture
def narrow(monkeypatch):
    fx.patch_narrow_plans(monkeypatch)
    fx.jit_jax_blocks(monkeypatch)


def _frames(n, h=64, w=64, seed=0):
    """Smooth seeded frames (a gradient plus noise), uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        base = np.stack([x * 3 + 10 * i, y * 3, (x + y) * 2], -1) % 256
        out.append(np.clip(base + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8))
    return out


def _models(sds, kinds):
    jl = {"sd_unet": jsd.sd_unet_params_from_torch,
          "sd_text_encoder": jsd.sd_text_encoder_params_from_torch,
          "sd_vae_encoder": jsd.sd_vae_encoder_params_from_torch,
          "sd_vae_decoder": jsd.sd_vae_decoder_params_from_torch,
          "sd_motion_modules": jmo.motion_params_from_torch,
          "sd_controlnet": jcn.sd_controlnet_params_from_torch}
    tl = {"sd_unet": tsd.sd_unet_params_from_torch,
          "sd_text_encoder": tsd.sd_text_encoder_params_from_torch,
          "sd_vae_encoder": tsd.sd_vae_encoder_params_from_torch,
          "sd_vae_decoder": tsd.sd_vae_decoder_params_from_torch,
          "sd_motion_modules": tmo.motion_params_from_torch,
          "sd_controlnet": tcn.sd_controlnet_params_from_torch}
    return ({k: jl[k](fx.to_numpy(sds[k])) for k in kinds},
            {k: tl[k](sds[k], device="cpu") for k in kinds})


def _unjit_image_pipeline(monkeypatch, pipe):
    """svi_tpu's SDImagePipeline with its UNet and VAE calls unjitted at the
    top, its decoded image returned before the uint8 cast."""
    cls = jimage.SDImagePipeline
    monkeypatch.setattr(cls, "_cfg_unet_impl", staticmethod(cls._cfg_unet_impl.__wrapped__))
    monkeypatch.setattr(cls, "_unet_single_impl",
                        staticmethod(cls._unet_single_impl.__wrapped__))
    pipe._decode = lambda latents, **kw: jsd.sd_vae_decode(pipe.vae_decoder_params, latents, **kw)
    pipe._encode = lambda image, **kw: jsd.sd_vae_encode(pipe.vae_encoder_params, image, **kw)
    pipe.vae_output_to_image = lambda out: np.asarray(out, np.float32)


def test_denoise_long_video_matches_jax():
    """24 frames: windows of 16 at stride 8 (two windows), the triangle bias."""
    lat = np.zeros((24, 4, 2, 3), np.float32)
    outs = {}

    def window(lo, hi):
        if (lo, hi) not in outs:
            outs[(lo, hi)] = np.random.default_rng(lo).standard_normal(
                (hi - lo, 4, 2, 3)).astype(np.float32)
        return outs[(lo, hi)]

    want = jvideo.denoise_long_video(window, lat)
    got = tvideo.denoise_long_video(lambda lo, hi: torch.from_numpy(window(lo, hi)),
                                    torch.from_numpy(lat))
    assert sorted(outs) == [(0, 16), (8, 24)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_merge_latents_matches_jax():
    """The feathered regional merge: a 32-pixel mask on a 16 x 16 latent
    grid (the blur's 16-pixel reflect padding at its limit) and one on 8 x 8
    (reflected twice)."""
    for hw in (16, 8):
        value = np.random.default_rng(0).standard_normal((1, 4, hw, hw)).astype(np.float32)
        local = [np.random.default_rng(1).standard_normal((1, 4, hw, hw)).astype(np.float32)]
        mask = np.zeros((8 * hw, 8 * hw, 3), np.uint8)
        mask[:, : 8 * hw // 2] = 255
        want = jbase.merge_latents(value, local, [Image.fromarray(mask)], [2.0])
        got = tbase.merge_latents(torch.from_numpy(value), [torch.from_numpy(local[0])], [mask],
                                  [2.0])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("regional", [False, True])
def test_sd_image_pipeline_matches_jax(sds, narrow, monkeypatch, regional):
    """Text-to-image at 64 x 64, 2 steps, CFG 7.5 (batched, or apart with a
    regional prompt on the left half), the image before the uint8 cast."""
    kinds = ("sd_unet", "sd_text_encoder", "sd_vae_decoder")
    jm, tm = _models(sds, kinds)
    jpipe = jimage.SDImagePipeline(jm["sd_unet"], jm["sd_text_encoder"],
                                   vae_decoder_params=jm["sd_vae_decoder"])
    tpipe = timage.SDImagePipeline(tm["sd_unet"], tm["sd_text_encoder"],
                                   vae_decoder=tm["sd_vae_decoder"])
    _unjit_image_pipeline(monkeypatch, jpipe)
    tpipe.vae_output_to_image = lambda out: out.numpy()
    kw = dict(prompt="a lighthouse on a cliff at dusk", negative_prompt="blurry",
              height=64, width=64, num_inference_steps=2, seed=0)
    mask = np.zeros((64, 64, 3), np.uint8)
    mask[:, :32] = 255
    jkw, tkw = dict(kw), dict(kw)
    if regional:
        jkw.update(local_prompts=["a red boat"], masks=[Image.fromarray(mask)],
                   mask_scales=[1.0])
        tkw.update(local_prompts=["a red boat"], masks=[mask], mask_scales=[1.0])
    want, got = jpipe(**jkw), tpipe(**tkw)
    assert got.shape == want.shape == (1, 3, 64, 64)
    assert fx.rel(got, want) <= F32_REL


def _spy_last_latents(pipe, store):
    """Record the latents of each decode_video call, then decode as before."""
    decode = pipe.decode_video

    def spy(latents, *a, **kw):
        store.append(fx.np32(latents) if isinstance(latents, torch.Tensor)
                     else np.asarray(latents, np.float32))
        return decode(latents, *a, **kw)

    pipe.decode_video = spy


def test_sd_video_pipeline_matches_jax(sds, narrow):
    """3 frames at 64 x 64 in windows of 2 at stride 1, motion modules, one
    tile ControlNet unit at scale 0.5, video-to-video at strength 0.9 over 3
    steps, CFG 7.5 and a Contrast smoother after step 1."""
    from svi_tpu.processors import ContrastEditor as JContrast
    from svi_tpu_torch.processors import ContrastEditor as TContrast

    kinds = ("sd_unet", "sd_text_encoder", "sd_vae_encoder", "sd_vae_decoder",
             "sd_motion_modules", "sd_controlnet")
    jm, tm = _models(sds, kinds)
    frames = _frames(3)
    jcnm = jcn.MultiControlNetManager([(jcn.sd_controlnet_forward, jm["sd_controlnet"], 0.5)],
                                      [jcn.Annotator("tile")])
    tcnm = tcn.MultiControlNetManager([(tcn.sd_controlnet_forward, tm["sd_controlnet"], 0.5)],
                                      [tcn.Annotator("tile")])
    jpipe = jvideo.SDVideoPipeline(jm["sd_unet"], jm["sd_motion_modules"],
                                   jm["sd_text_encoder"], jm["sd_vae_encoder"],
                                   jm["sd_vae_decoder"], controlnet=jcnm)
    tpipe = tvideo.SDVideoPipeline(tm["sd_unet"], tm["sd_motion_modules"],
                                   tm["sd_text_encoder"], tm["sd_vae_encoder"],
                                   tm["sd_vae_decoder"], controlnet=tcnm)
    assert tpipe.scheduler.beta_schedule == jpipe.scheduler.beta_schedule == "linear"
    jl, tl = [], []
    _spy_last_latents(jpipe, jl)
    _spy_last_latents(tpipe, tl)
    kw = dict(prompt="a watercolor city street", negative_prompt="", cfg_scale=7.5,
              num_frames=3, denoising_strength=0.9, height=64, width=64,
              num_inference_steps=3, animatediff_batch_size=2, animatediff_stride=1,
              smoother_progress_ids=[1], seed=1)
    want = jpipe(input_frames=[Image.fromarray(f) for f in frames],
                 controlnet_frames=[[Image.fromarray(f) for f in frames]],
                 smoother=JContrast(1.3), **kw)
    got = tpipe(input_frames=frames, controlnet_frames=[frames], smoother=TContrast(1.3), **kw)
    assert len(jl) == len(tl) == 2  # the smoother's render and the end
    assert fx.rel(tl[0], jl[0]) <= F32_REL  # the step-1 render, before any uint8 cast
    assert fx.rel(tl[1], jl[1]) <= SMOOTHED_REL
    assert len(got) == 3 and got[0].shape == (64, 64, 3) and got[0].dtype == np.uint8
    gap = max(np.abs(g.astype(int) - np.asarray(w, int)).max() for g, w in zip(got, want))
    assert gap <= LEVELS


def test_runner_matches_jax(sds, narrow, monkeypatch, tmp_path):
    """SDVideoPipelineRunner.run on files of the seeded models: an mp4 of 3
    frames, its frames as the tile ControlNet's stream, 2 steps, a Contrast
    smoother; the frames, the PNGs and the provenance config against
    svi_tpu's runner (whose detector is given the port's UNet rule: it looks
    for a push block, ROADMAP.md Queue 3)."""
    from svi_tpu.models import model_io as jio
    from svi_tpu.pipelines.pipeline_runner import SDVideoPipelineRunner as JRunner
    from svi_tpu.utils import video as jvid
    from svi_tpu_torch.models import model_io as tio
    from svi_tpu_torch.pipelines.pipeline_runner import SDVideoPipelineRunner as TRunner

    monkeypatch.setattr(jio, "detect_model_kind", tio.detect_model_kind)
    paths = fx.write_files(tmp_path / "models", sds)
    mp4 = str(tmp_path / "in.mp4")
    jvid.save_video(_frames(4, seed=3), mp4, fps=8)

    def config(out):
        src = {"video_file": mp4, "height": 64, "width": 64, "start_frame_id": 0,
               "end_frame_id": 3}
        return {
            "models": {"model_list": [paths[k] for k in ("sd_unet", "sd_text_encoder",
                                                         "sd_vae_encoder", "sd_vae_decoder",
                                                         "sd_motion_modules")],
                       "textual_inversion_folder": str(tmp_path / "none"), "device": "cpu",
                       "lora_alphas": [],
                       "controlnet_units": [{"processor_id": "tile",
                                             "model_path": paths["sd_controlnet"],
                                             "scale": 0.5}]},
            "data": {"input_frames": dict(src), "controlnet_frames": [dict(src)],
                     "output_folder": str(tmp_path / out), "fps": 8},
            "pipeline": {"seed": 2, "pipeline_inputs": {
                "prompt": "an oil painting", "negative_prompt": "", "cfg_scale": 7.5,
                "clip_skip": 1, "denoising_strength": 0.9, "num_inference_steps": 2,
                "animatediff_batch_size": 2, "animatediff_stride": 1,
                "smoother_progress_ids": [1]}},
            "smoother_configs": [{"processor_type": "Contrast", "config": {"rate": 1.2}}],
        }

    want = JRunner().run(config("jax_out"))
    got = TRunner(device="cpu").run(config("port_out"))
    assert len(got) == len(want) == 3
    gap = max(np.abs(g.astype(int) - np.asarray(w, int)).max() for g, w in zip(got, want))
    assert gap <= LEVELS
    for i, g in enumerate(got):
        png = np.asarray(Image.open(tmp_path / "port_out" / "frames" / f"{i}.png"))
        np.testing.assert_array_equal(png, g)
    assert os.path.getsize(tmp_path / "port_out" / "video.mp4") > 0
    saved = [json.load(open(tmp_path / d / "config.json")) for d in ("port_out", "jax_out")]
    for s in saved:
        s["data"]["output_folder"] = None
    assert saved[0] == saved[1]
    assert saved[0]["pipeline"]["pipeline_inputs"]["input_frames"] == []
    assert saved[0]["pipeline"]["pipeline_inputs"]["num_frames"] == 3


# ---------------------------------------------------------------------------
# processors, annotators, frame sources
# ---------------------------------------------------------------------------


def test_processors_match_pillow():
    """The numpy Contrast and Sharpness editors give Pillow's bytes (svi_tpu's
    editors are Pillow's), alone and chained; the extension smoothers build
    from their configs (FastBlend without a model manager, RIFE from one
    holding IFNet weights) and match svi_tpu's on a tiny clip (FastBlend
    exactly, RIFE within one level)."""
    import jax

    from svi_tpu.extensions import rife as jrife
    from svi_tpu.processors import AutoVideoProcessor as JAuto
    from svi_tpu.processors import SequencialProcessor as JSeq
    from svi_tpu_torch.extensions import FastBlendSmoother, RIFESmoother
    from svi_tpu_torch.extensions import rife as trife
    from svi_tpu_torch.processors import AutoVideoProcessor, SequencialProcessor

    frames = _frames(3, 37, 53, seed=4) + [np.full((9, 7, 3), 200, np.uint8)]
    configs = [{"processor_type": "Contrast", "config": {"rate": 1.7}},
               {"processor_type": "Sharpness", "config": {"rate": 2.5}},
               {"processor_type": "Contrast", "config": {"rate": 0.4}},
               {"processor_type": "Sharpness", "config": {"rate": -0.5}}]
    for n in range(1, len(configs) + 1):
        want = JSeq.from_model_manager(None, configs[:n])([Image.fromarray(f) for f in frames])
        got = SequencialProcessor.from_model_manager(None, configs[:n])(frames)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    clip = [np.repeat(np.repeat(f[:8, :12] // 8, 2, 0), 2, 1) for f in _frames(3, seed=6)]
    cfg = {"minimum_patch_size": 3, "num_iter": 1}
    got = AutoVideoProcessor.from_model_manager(None, "FastBlend", device="cpu",
                                                ebsynth_config=cfg)
    assert isinstance(got, FastBlendSmoother)
    want = JAuto.from_model_manager(None, "FastBlend", ebsynth_config=cfg)
    for g, w in zip(got(clip, original_frames=clip[::-1]), want(
            [Image.fromarray(f) for f in clip], original_frames=clip[::-1])):
        np.testing.assert_array_equal(g, np.asarray(w))
    jp = jax.jit(lambda k: jrife.init_params(k, c=8))(jax.random.key(0, impl="unsafe_rbg"))
    mm = SimpleNamespace(fetch_model=lambda name: trife.params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu") if name == "rife" else None)
    jmm = SimpleNamespace(fetch_model=lambda name: (jp, None))
    got = AutoVideoProcessor.from_model_manager(mm, "RIFE", batch_size=2)
    assert isinstance(got, RIFESmoother)
    want = JAuto.from_model_manager(jmm, "RIFE", batch_size=2)
    frames = _frames(4, 32, 32, seed=7)
    gap = max(np.abs(g.astype(int) - np.asarray(w, int)).max() for g, w in zip(
        got(frames), want([Image.fromarray(f) for f in frames])))
    assert gap <= 1
    with pytest.raises(ValueError, match="IFNet"):
        AutoVideoProcessor.from_model_manager(None, "RIFE")
    with pytest.raises(ValueError):
        AutoVideoProcessor.from_model_manager(None, "NotAProcessor")


def test_annotators():
    """tile / none / inpaint pass the frame through; a detector without
    controlnet_aux raises ImportError, as svi_tpu's does."""
    f = _frames(1, 16, 24)[0]
    for pid in ("tile", "none", "inpaint"):
        np.testing.assert_array_equal(tcn.Annotator(pid)(f), f)
    cond = tcn.MultiControlNetManager([], [tcn.Annotator("tile")]).process_image(f)
    np.testing.assert_allclose(cond, f.transpose(2, 0, 1)[None] / 255.0)
    try:
        import controlnet_aux  # noqa: F401
    except ImportError:
        for mod in (tcn, jcn):
            with pytest.raises(ImportError, match="controlnet_aux"):
                mod.Annotator("canny")
    with pytest.raises(ValueError):
        tcn.Annotator("sketch")


def test_video_data_sources(tmp_path):
    """VideoData over an image folder (digit-aware order), an mp4 and a .npy
    video, cropped and resized as svi_tpu's (Pillow's resize), byte for
    byte; save_frames' PNGs read back as written, the .npy output format."""
    from svi_tpu.utils import video as jvid
    from svi_tpu_torch.pipelines.pipeline_runner import SDVideoPipelineRunner
    from svi_tpu_torch.utils import video as tvid

    frames = _frames(11, 48, 80, seed=5)
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(folder / f"frame{i}.png")
    mp4 = str(tmp_path / "v.mp4")
    jvid.save_video(frames[:4], mp4, fps=8)
    npy = str(tmp_path / "v.npy")
    np.save(npy, np.stack(frames))
    assert tvid.split_file_name("frame10.png") == jvid.split_file_name("frame10.png")
    for src in (dict(image_folder=str(folder)), dict(video_file=mp4)):
        for hw in ((None, None), (32, 32), (48, 80), (40, 24)):
            got = tvid.VideoData(height=hw[0], width=hw[1], **src)
            want = jvid.VideoData(height=hw[0], width=hw[1], **src)
            assert len(got) == len(want) and got.shape() == want.shape()
            for i in (0, len(got) - 1):
                np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    data = tvid.VideoData(video_file=npy, height=40, width=24)
    assert len(data) == 11 and data.shape() == (40, 24)
    np.testing.assert_array_equal(tvid.VideoData(video_file=npy)[10], frames[10])
    data.set_length(3)
    assert len(data.raw_data()) == 3
    tvid.save_frames(frames[:3], str(tmp_path / "out"))
    assert sorted(os.listdir(tmp_path / "out")) == ["0.png", "1.png", "2.png"]
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "out" / "2.png")), frames[2])
    config = {"pipeline": {"pipeline_inputs": {}}}
    SDVideoPipelineRunner(device="cpu").save_output(frames[:2], str(tmp_path / "o2"), 8,
                                                    config, save_format="npy")
    np.testing.assert_array_equal(np.load(tmp_path / "o2" / "video.npy"), np.stack(frames[:2]))
    with pytest.raises(ValueError):
        tvid.VideoData()
