"""The port's training data path against svi_tpu's, on the CPU: the three
datasets on the repository's toy data (data/toy_train: mp4 through OpenCV,
the JPEG pickles through Pillow) and on `.npy` copies of the same videos,
the port's crop and resize against Pillow's BILINEAR, the first-frame
augmentation, the frame count, the audio cut, the read-ahead and the
metrics log.

The datasets draw from `random.Random` in the JAX package's order, so one
seed gives the same windows, crop boxes, anchors and captions (checked by
recording the boxes and comparing the generators' states after each
sample); the frames differ only by the resize.
"""

import csv
import json
import pickle
import random
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import svi_tpu.pipelines.base as jbase
import svi_tpu.training.dataset as jds
import svi_tpu.utils.audio as jaudio
import svi_tpu.utils.video as jvideo
import svi_tpu_torch.pipelines.base as tbase
import svi_tpu_torch.training.dataset as tds
import svi_tpu_torch.utils.audio as taudio
import svi_tpu_torch.utils.video as tvideo
from svi_tpu_torch.utils.logging import MetricsLogger

REPO = Path(__file__).resolve().parent.parent
TOY = REPO / "data" / "toy_train"
# The port resizes with torch's antialiased bilinear on uint8 (fixed-point
# weights, as Pillow's), Pillow with its own: the two round a pixel to
# neighbouring levels where the exact value lies near a half level.
# Measured on the seeded set below: at most 1 level, at most 0.025 of a
# level on average (0.003-0.007 at the toy and 512x928 -> 480x832 sizes).
RESIZE_MAX_LEVELS, RESIZE_MEAN_LEVELS = 1, 0.05
LEVEL = 2 / 255  # one uint8 level in the [-1, 1] video
KW = dict(max_num_frames=5, height=48, width=48)
DATASETS = {"shot": ("TextVideoDataset", TOY / "svi-film-shot"),
            "dance": ("DanceVideoDataset", TOY / "svi-dance"),
            "talk": ("TalkVideoDataset", TOY / "svi-talk")}


def _recording_boxes(monkeypatch, module, cls, boxes):
    raw = getattr(module, cls)._random_crop_box

    def record(self, w, h):
        boxes.append(raw(self, w, h))
        return boxes[-1]

    monkeypatch.setattr(getattr(module, cls), "_random_crop_box", record)


def _check_frames(got, want, levels=RESIZE_MAX_LEVELS):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= levels + 1e-3, np.abs(got - want).max()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(DATASETS))
def test_datasets_match_jax(name, seed, monkeypatch):
    """Every sample of each toy dataset (two epochs' worth): the same video,
    caption, crop box and generator state after it, the same audio windows
    exactly; the frames, anchor and motion frames within the resize's bound."""
    cls, root = DATASETS[name]
    boxes = {"port": [], "jax": []}
    _recording_boxes(monkeypatch, tds, cls, boxes["port"])
    _recording_boxes(monkeypatch, jds, cls, boxes["jax"])
    got_ds = getattr(tds, cls)(str(root), seed=seed, **KW)
    want_ds = getattr(jds, cls)(str(root), seed=seed, **KW)
    assert [v["path"] for v in got_ds.video_list] == [v["path"] for v in want_ds.video_list]
    for i in range(2 * len(want_ds)):
        got, want = got_ds[i], want_ds[i]
        assert got.keys() == want.keys()
        assert (got["text"], got["path"]) == (want["text"], want["path"])
        assert got_ds.rng.getstate() == want_ds.rng.getstate()
        _check_frames(got["video"] / LEVEL, want["video"] / LEVEL)
        _check_frames(got["random_ref_frame"], want["random_ref_frame"])
        assert len(got["first_ref_frames"]) == len(want["first_ref_frames"])
        _check_frames(np.stack(got["first_ref_frames"]), np.stack(want["first_ref_frames"]))
        if name == "dance":
            _check_frames(got["dwpose_data"], want["dwpose_data"])
        if name == "talk":
            for key in ("audio_first", "audio_vf"):
                assert got[key].dtype == np.float32
                np.testing.assert_array_equal(got[key], want[key])
    assert boxes["port"] == boxes["jax"] and len(boxes["port"]) == 2 * len(want_ds)


def _npy_copy(name, dst: Path) -> Path:
    """The toy dataset `name` with every mp4 decoded into an (N, H, W, 3)
    uint8 .npy in the same layout (captions keyed by the new file names)."""
    src = DATASETS[name][1]
    out = dst / name
    if name == "shot":
        for cat in sorted(p for p in src.iterdir() if p.is_dir()):
            (out / cat.name).mkdir(parents=True)
            with open(cat / f"{cat.name}.csv", encoding="utf-8") as f:
                rows = list(csv.DictReader(f))
            for row in rows:
                np.save(out / cat.name / row["Filename"].replace(".mp4", ".npy"),
                        np.stack(tvideo.load_video_frames(str(cat / row["Filename"]))))
                row["Filename"] = row["Filename"].replace(".mp4", ".npy")
            with open(out / cat.name / f"{cat.name}.csv", "w", encoding="utf-8", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=list(rows[0]))
                writer.writeheader()
                writer.writerows(rows)
        return out
    sample = out / "00001"
    sample.mkdir(parents=True)
    for video in ("video", "dwpose") if name == "dance" else ("video",):
        np.save(sample / f"{video}.npy",
                np.stack(tvideo.load_video_frames(str(src / "00001" / f"{video}.mp4"))))
    if name == "talk":
        shutil.copy(src / "00001" / "audio_embedding.pkl", sample)
    return out


@pytest.mark.parametrize("name", list(DATASETS))
def test_npy_videos_give_the_mp4_samples(name, tmp_path):
    """`.npy` copies of the toy mp4s (the form the card can read) give the
    same samples as the mp4s, bit for bit (the dance set's JPEG pickles are
    left out of the copy, so the mp4 sample is compared)."""
    root = _npy_copy(name, tmp_path)
    cls = getattr(tds, DATASETS[name][0])
    mp4 = cls(str(DATASETS[name][1]), seed=3, **KW)
    if name == "dance":
        mp4.video_list = [v for v in mp4.video_list if v["path"].endswith("svi-dance/00001")]
    npy = cls(str(root), seed=3, **KW)
    assert len(npy) == len(mp4)
    npy.rng.setstate(mp4.rng.getstate())
    for i in range(len(mp4)):
        got, want = npy[i], mp4[i]
        assert got["text"] == want["text"]
        for key, val in want.items():
            if isinstance(val, np.ndarray):
                np.testing.assert_array_equal(got[key], val, err_msg=key)
        np.testing.assert_array_equal(np.stack(got["first_ref_frames"]),
                                      np.stack(want["first_ref_frames"]))


def test_resize_is_within_a_level_of_pillow():
    """The port's crop and resize against Pillow's crop + BILINEAR resize on
    seeded images, crop boxes and sizes, shrinking and enlarging: max and
    mean |difference| in uint8 levels within the stated bounds."""
    from PIL import Image

    rng = np.random.default_rng(0)
    worst, means = 0, []
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(24, 200, 2))
        th, tw = (int(v) for v in rng.integers(8, 160, 2))
        x1, y1 = int(rng.integers(0, w // 4)), int(rng.integers(0, h // 4))
        x2, y2 = int(rng.integers(x1 + w // 2, w + 1)), int(rng.integers(y1 + h // 2, h + 1))
        noise = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        smooth = (np.sin(xx / 7.0)[..., None] * np.cos(yy / 5.0)[..., None] * 100 + 128
                  + np.zeros(3)).astype(np.uint8)
        frames = np.concatenate([noise, smooth[None]])
        got = tds.crop_resize(frames, (x1, y1, x2, y2), tw, th)
        want = np.stack([np.asarray(Image.fromarray(f).crop((x1, y1, x2, y2)).resize(
            (tw, th), Image.BILINEAR)) for f in frames])
        assert got.shape == want.shape == (3, th, tw, 3) and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int))
        worst = max(worst, int(diff.max()))
        means.append(float(diff.mean()))
    assert worst <= RESIZE_MAX_LEVELS and max(means) <= RESIZE_MEAN_LEVELS, (worst, means)


@pytest.mark.parametrize("seed", range(6))
def test_first_frame_augmentation_matches_jax(seed):
    """apply_augmentation with the same numpy generator gives the JAX
    package's image bit for bit (the same Pillow calls in the same draw
    order), and preprocess_image(use_aug=True) its array."""
    img = np.random.default_rng(seed + 10).integers(0, 256, (24, 32, 3), dtype=np.uint8)
    got = tbase.apply_augmentation(img, rng=np.random.default_rng(seed))
    want = jbase.apply_augmentation(img, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(
        tbase.preprocess_image(img, use_aug=True, rng=np.random.default_rng(seed)),
        jbase.preprocess_image(img, use_aug=True, rng=np.random.default_rng(seed)))


def test_first_frame_augmentation_reaches_only_the_condition_frames(monkeypatch):
    """encode_images_adaptive(use_first_aug=True) augments the VAE's
    condition frames only: CLIP's features stay those of the plain frame,
    y moves. Without Pillow it raises (it never skips the augmentation
    quietly)."""
    from svi_tpu_torch.models import clip_vision, wan_vae
    from svi_tpu_torch.pipelines.svi_video import SVIVideoPipeline
    from torch_checkpoint_files import CLIP_CFG, VAE_CFG

    pipe = SVIVideoPipeline(device="cpu", torch_dtype=torch.float32)
    pipe.vae = wan_vae.init_params(VAE_CFG, seed=3, device="cpu")
    pipe.image_encoder = clip_vision.init_params(CLIP_CFG, seed=4, device="cpu")
    frame = np.random.default_rng(0).integers(0, 255, (16, 16, 3), dtype=np.uint8)
    with torch.no_grad():
        plain = pipe.encode_images_adaptive([frame], frame, 5, 16, 16, ref_pad_num=-1)
        augmented = pipe.encode_images_adaptive([frame], frame, 5, 16, 16, ref_pad_num=-1,
                                                use_first_aug=True)
    torch.testing.assert_close(augmented["clip_feature"], plain["clip_feature"], atol=0, rtol=0)
    # the augmentation draws from an unseeded generator: all of its branches
    # may be skipped (0.3 * 0.5 * 0.5), so compare a few draws
    moved = [float((augmented["y"] - plain["y"]).abs().max())]
    with torch.no_grad():
        for _ in range(4):
            moved.append(float((pipe.encode_images_adaptive(
                [frame], frame, 5, 16, 16, ref_pad_num=-1, use_first_aug=True)["y"]
                - plain["y"]).abs().max()))
    assert max(moved) > 0
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        tbase.apply_augmentation(frame)
    with pytest.raises(RuntimeError, match="use_first_aug"):
        pipe.encode_images_adaptive([frame], frame, 5, 16, 16, ref_pad_num=-1,
                                    use_first_aug=True)


def test_frame_count_and_windows_read_only_their_frames(tmp_path):
    """video_frame_count: the JAX package's for an mp4, the header's for a
    .npy; a .npy window is read through a memory map."""
    mp4 = str(TOY / "svi-film-shot" / "hills" / "hills_00.mp4")
    assert tvideo.video_frame_count(mp4) == jvideo.video_frame_count(mp4) == 100
    video = np.random.default_rng(0).integers(0, 255, (7, 4, 6, 3), dtype=np.uint8)
    np.save(tmp_path / "v.npy", video)
    assert tvideo.video_frame_count(str(tmp_path / "v.npy")) == 7
    assert isinstance(tvideo.open_npy_video(str(tmp_path / "v.npy")), np.memmap)
    frames = tvideo.load_video_frames(str(tmp_path / "v.npy"), [5, 1])
    np.testing.assert_array_equal(np.stack(frames), video[[5, 1]])
    np.save(tmp_path / "bad.npy", video.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        tvideo.video_frame_count(str(tmp_path / "bad.npy"))


@pytest.mark.parametrize("start,end", [(0, 81), (7, 12), (90, 95)])
def test_cut_audio_embedding_takes_the_end_index(start, end):
    """audio_end_idx is taken and ignored, as in the JAX package."""
    with open(TOY / "svi-talk" / "00001" / "audio_embedding.pkl", "rb") as f:
        emb = pickle.load(f)
    got = taudio.cut_audio_embedding(emb, 5, audio_start_idx=start, audio_end_idx=end)
    want = jaudio.cut_audio_embedding(emb, 5, audio_start_idx=start, audio_end_idx=end)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_prefetch_keeps_the_order_and_stops_when_closed():
    """The read-ahead yields the plain loop's samples in order, raises the
    dataset's error in the consumer, and its worker stops once the consumer
    closes it."""
    import threading

    class Counting:
        def __init__(self, fail_at=None):
            self.rng, self.reads, self.fail_at = random.Random(0), [], fail_at

        def __getitem__(self, i):
            if i == self.fail_at:
                raise IOError("unreadable")
            self.reads.append(i)
            return (i, self.rng.random())

    draws = random.Random(0)
    want = [(i, draws.random()) for i in range(6)]
    assert list(tds.prefetch_samples(Counting(), range(6))) == want
    with pytest.raises(IOError, match="unreadable"):
        list(tds.prefetch_samples(Counting(fail_at=3), range(6)))
    ds = Counting()
    before = threading.active_count()
    gen = tds.prefetch_samples(ds, range(1000), depth=1)
    assert next(gen) == want[0]
    gen.close()
    for _ in range(100):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.02)
    assert threading.active_count() <= before and len(ds.reads) < 10


def test_metrics_logger_writes_one_json_line_a_step(tmp_path):
    log = MetricsLogger(str(tmp_path / "run" / "metrics.jsonl"))
    log.log(1, loss=torch.tensor(0.5), warmup=True, grid=3, note="x")
    log.log(2, loss=0.25)
    log.close()
    lines = [json.loads(x) for x in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    assert lines[0]["loss"] == 0.5 and lines[0]["warmup"] == 1.0 and lines[0]["note"] == "x"
