"""The port's pose path (svi_tpu_torch/dwpose/, the pose scripts and
metadata_gen) against svi_tpu's on the CPU.

svi_tpu runs its OpenCV paths here (this machine has cv2); the port runs
none. Bounds, each stated before the port's first run:
- `_preprocess_det` (cv2.resize INTER_LINEAR, fixed point): max |d| <= 1
  uint8 level, the same ratio;
- `_crop` (cv2.warpAffine, 1/32-pixel coordinates): mean |d| <= 0.5 and
  max |d| <= 6 levels on seeded noise, the same (sw, sh);
- the YOLOX decode, NMS and SimCC decode: exactly equal;
- `Wholebody` on tests/test_dwpose.py's synthetic graphs: boxes and
  keypoints within 1e-3 px of svi_tpu's engine="jax"; on a graph whose
  SimCC rows depend on the crop, raw SimCC within 1e-2 of the largest;
- `draw_pose_frame` at 768x512: at most 0.5% of the pixels differ, the
  painted masks' IoU >= 0.95, equal colours where both paint;
- `align`: within 1e-6;
- the scripts: the keypoints and rendered frames as above and the same
  files; metadata_gen's CSV byte for byte.
"""

import importlib.util
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import svi_tpu.dwpose as jdw
from svi_tpu.dwpose import align as jalign
from svi_tpu.dwpose import draw as jdraw
from svi_tpu.dwpose import onnx_infer as jinfer
from svi_tpu.dwpose import wholebody as jwb
import svi_tpu_torch.dwpose as tdw
from svi_tpu_torch.dwpose import align as talign
from svi_tpu_torch.dwpose import draw as tdraw
from svi_tpu_torch.dwpose import onnx_infer as tinfer
from svi_tpu_torch.dwpose import wholebody as twb
from svi_tpu_torch.scripts import metadata_gen, prepare_video_pose, run_align_pose
from svi_tpu_torch.utils import onnx_torch
import torch_dwpose_graphs as graphs

REPO = Path(__file__).resolve().parent.parent
RESIZE_LEVELS = 1
CROP_MEAN, CROP_MAX = 0.5, 6
KPT_PX = 1e-3
SIMCC_REL = 1e-2
DRAW_PIXELS, DRAW_IOU = 0.005, 0.95
ALIGN_TOL = 1e-6


# ---------------------------------------------------------------------------
# preprocessing without cv2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(480, 640), (300, 500), (720, 1280), (1000, 300), (123, 77)])
def test_preprocess_det_against_cv2(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), dtype=np.uint8)
    want, r_want = jinfer._preprocess_det(img)
    got, r_got = tinfer._preprocess_det(img)
    assert r_got == r_want and got.shape == want.shape == (1, 3, 640, 640)
    assert np.abs(got.numpy() - want).max() <= RESIZE_LEVELS


@pytest.mark.parametrize("bbox", [[100, 50, 300, 400], [-30, -20, 200, 500],
                                  [400.3, 100.7, 639.9, 479.2], [10, 10, 30, 20]])
def test_crop_against_cv2(bbox):
    img = np.random.default_rng(7).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    center, scale = jinfer._bbox_to_center_scale(np.asarray(bbox, np.float32))
    tc, ts = tinfer._bbox_to_center_scale(np.asarray(bbox, np.float32))
    np.testing.assert_array_equal(tc, center)
    np.testing.assert_array_equal(ts, scale)
    want, wsize = jinfer._crop(img, center, scale)
    got, gsize = tinfer._crop(torch.from_numpy(img), center, scale)
    assert gsize == wsize and got.shape == want.shape == (384, 288, 3)
    d = np.abs(got.numpy().astype(np.int16) - want.astype(np.int16))
    assert d.mean() <= CROP_MEAN and d.max() <= CROP_MAX, (d.mean(), d.max())


def test_decode_nms_and_simcc_decode_are_numpy_equal():
    rng = np.random.default_rng(8)
    raw = rng.standard_normal((1, graphs.N_ANCHORS_640, 85)).astype(np.float32)
    np.testing.assert_array_equal(tinfer._yolox_decode(raw.copy()), jinfer._yolox_decode(raw.copy()))
    boxes = np.sort(rng.uniform(0, 600, (50, 4)).astype(np.float32).reshape(50, 2, 2), axis=1)
    boxes = boxes.transpose(0, 2, 1).reshape(50, 4)[:, [0, 2, 1, 3]]
    scores = rng.uniform(0, 1, 50).astype(np.float32)
    assert tinfer._nms(boxes, scores) == jinfer._nms(boxes, scores)

    class Fixed:
        """A session that returns fixed SimCC rows whatever it is fed."""

        def __init__(self, outs):
            self.outs = outs

        def get_inputs(self):
            return [onnx_torch._IOInfo("input")]

        def run(self, names, feeds):
            return [o.copy() for o in self.outs]

    outs = [rng.standard_normal((1, 133, 576)).astype(np.float32),
            rng.standard_normal((1, 133, 768)).astype(np.float32)]
    img = rng.integers(0, 256, (200, 300, 3), dtype=np.uint8)
    det = np.array([[20, 30, 120, 180], [150, 10, 290, 190]], np.float32)
    for boxes_in in (det, np.zeros((0, 4), np.float32)):
        k_t, s_t = tinfer.inference_pose(Fixed(outs), boxes_in, img)
        k_j, s_j = jinfer.inference_pose(Fixed(outs), boxes_in, img)
        np.testing.assert_array_equal(k_t, k_j)
        np.testing.assert_array_equal(s_t, s_j)
    k, s = rng.uniform(0, 100, (2, 133, 2)), rng.uniform(0, 1, (2, 133))
    for a, b in zip(twb.keypoints_to_openpose(k, s), jwb.keypoints_to_openpose(k, s)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Wholebody
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graph_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs")
    files = {"det": graphs.synthetic_det_graph(), "pose": graphs.synthetic_pose_graph(),
             "crop_pose": graphs.crop_pose_graph(), "kpt_pose": graphs.keypoint_pose_graph()}
    for name, data in files.items():
        (d / f"{name}.onnx").write_bytes(data)
    return {name: str(d / f"{name}.onnx") for name in files}


@pytest.mark.parametrize("shape", [(480, 640), (96, 80)])
def test_wholebody_matches_svi_tpu(graph_files, shape):
    frame = np.random.default_rng(9).integers(0, 256, shape + (3,), dtype=np.uint8)
    jw = jdw.Wholebody(det_onnx=graph_files["det"], pose_onnx=graph_files["pose"], engine="jax")
    tw = tdw.Wholebody(det_onnx=graph_files["det"], pose_onnx=graph_files["pose"], device="cpu")
    assert isinstance(tw.session_det, onnx_torch.InferenceSession)
    box_j = jinfer.inference_detector(jw.session_det, frame)
    box_t = tinfer.inference_detector(tw.session_det, frame)
    assert box_t.shape == box_j.shape == (1, 4)
    assert np.abs(box_t - box_j).max() <= KPT_PX
    (kj, sj), (kt, st) = jw(frame), tw(frame)
    assert kt.shape == kj.shape == (1, 134, 2)
    assert np.abs(kt - kj).max() <= KPT_PX
    np.testing.assert_array_equal(st, sj)


def test_wholebody_simcc_depends_on_the_crop(graph_files):
    """The raw SimCC rows of a graph that reads the crop's pixels, fed the
    port's crop and svi_tpu's (cv2's)."""
    frame = np.random.default_rng(10).integers(0, 256, (240, 320, 3), dtype=np.uint8)
    jw = jdw.Wholebody(det_onnx=graph_files["det"], pose_onnx=graph_files["crop_pose"],
                       engine="jax")
    tw = tdw.Wholebody(det_onnx=graph_files["det"], pose_onnx=graph_files["crop_pose"],
                       device="cpu")
    seen = {}
    for key, sess in (("jax", jw.session_pose), ("torch", tw.session_pose)):
        run = sess.run

        def spy(names, feeds, run=run, key=key):
            out = run(names, feeds)
            seen[key] = out
            return out

        sess.run = spy
    jw(frame)
    tw(frame)
    for a, b in zip(seen["torch"], seen["jax"]):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= SIMCC_REL * np.abs(b).max()


def test_wholebody_engines_and_device():
    """engine='torch' on the card is the default: without CUDA it raises (no
    silent CPU); 'ort' raises without onnxruntime; names are checked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if importlib.util.find_spec("onnxruntime") is None:
        with pytest.raises(ImportError):
            tdw.Wholebody(engine="ort")
        with pytest.raises(RuntimeError, match="CUDA"):
            tdw.Wholebody(engine="auto")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdw.Wholebody()
    with pytest.raises(ValueError):
        tdw.Wholebody(engine="jax")
    with pytest.raises(FileNotFoundError):
        tdw.Wholebody(device="cpu")
    # the scripts too: the card unless --device cpu
    with pytest.raises(RuntimeError, match="CUDA"):
        prepare_video_pose.main(["--video_dir", "v", "--out_dir", "o"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run_align_pose.main(["--ref_name", "r.npy", "--source_video_paths", "v.npy",
                             "--saved_pose_dir", "o"])


# ---------------------------------------------------------------------------
# drawing without cv2
# ---------------------------------------------------------------------------


def _seeded_pose(seed, people=2):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 1, (people, 18)).astype(np.float32)
    scores[scores < 0.15] = -1
    return {"bodies": rng.uniform(0.1, 0.9, (people, 18, 2)).astype(np.float32),
            "body_scores": scores,
            "hands": rng.uniform(-0.05, 1.0, (2 * people, 21, 2)).astype(np.float32),
            "faces": rng.uniform(0.2, 0.8, (people, 68, 2)).astype(np.float32)}


def _draw_gap(got: np.ndarray, want: np.ndarray):
    differ = (got != want).any(-1)
    pg, pw = got.any(-1), want.any(-1)
    iou = (pg & pw).sum() / max((pg | pw).sum(), 1)
    both = pg & pw & ~differ
    return differ.mean(), iou, bool((got[pg & pw & ~differ] == want[both]).all())


@pytest.mark.parametrize("seed,face", [(0, False), (1, True), (2, True)])
def test_draw_pose_frame_against_cv2(seed, face):
    pose = _seeded_pose(seed)
    want = jdraw.draw_pose_frame(pose, 768, 512, draw_face_pts=face)
    got = tdraw.draw_pose_frame(pose, 768, 512, draw_face_pts=face)
    assert got.shape == want.shape and got.dtype == np.uint8
    share, iou, _ = _draw_gap(got, want)
    assert share <= DRAW_PIXELS and iou >= DRAW_IOU, (share, iou)
    painted = got.any(-1) & want.any(-1) & (got == want).all(-1)
    assert painted.sum() > 0.9 * (got.any(-1) & want.any(-1)).sum()


def test_draw_primitives_match_cv2_inside_the_canvas():
    """Inside the canvas the rasteriser is OpenCV's pixel for pixel: the
    ellipse polygons, their fill, filled circles and 2-px lines."""
    import cv2

    rng = np.random.default_rng(11)
    for _ in range(60):
        c = (int(rng.integers(20, 140)), int(rng.integers(20, 180)))
        axes = (int(rng.integers(0, 40)), 4)
        ang = int(rng.integers(-180, 180))
        poly = cv2.ellipse2Poly(c, axes, ang, 0, 360, 1)
        np.testing.assert_array_equal(tdraw.ellipse2poly(c, axes, ang, 0, 360, 1), poly)
        a, b = np.zeros((200, 160, 3), np.uint8), np.zeros((200, 160, 3), np.uint8)
        cv2.fillConvexPoly(a, poly, [1, 2, 3])
        tdraw.fill_convex_poly(b, poly, [1, 2, 3])
        r = int(rng.integers(1, 6))
        cv2.circle(a, c, r, (9, 8, 7), thickness=-1)
        tdraw.circle(b, c, r, (9, 8, 7))
        p = (int(rng.integers(2, 158)), int(rng.integers(2, 198)))
        cv2.line(a, c, p, (4, 5, 6), thickness=2)
        tdraw.line(b, c, p, (4, 5, 6), 2)
        np.testing.assert_array_equal(b, a)


# ---------------------------------------------------------------------------
# alignment
# ---------------------------------------------------------------------------


def _openpose_frame(rng, n=1):
    return (rng.uniform(50, 400, (n, 134, 2)).astype(np.float32),
            rng.uniform(0, 1, (n, 134)).astype(np.float32))


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=ALIGN_TOL)


def test_align_matches_svi_tpu():
    rng = np.random.default_rng(12)
    frames = [talign.pose_from_openpose(*_openpose_frame(rng), 480, 640) for _ in range(4)]
    jframes = [jalign.pose_from_openpose(*_openpose_frame(np.random.default_rng(12)), 480, 640)]
    _close(frames[0], jframes[0])
    for f in frames:  # the shoulders and hips visible, so that the ratios exist
        f["bodies"]["candidate"][[2, 5, 8, 11]] = rng.uniform(0.2, 0.8, (4, 2))
    ref = talign.pose_from_openpose(*_openpose_frame(rng), 768, 512)
    ref["bodies"]["candidate"][[2, 5, 8, 11]] = rng.uniform(0.2, 0.8, (4, 2))
    _close(talign.compute_retarget_params(frames[0], ref),
           jalign.compute_retarget_params(frames[0], ref))
    params = talign.compute_retarget_params(frames[0], ref)
    _close(talign.retarget_pose(frames[1], params), jalign.retarget_pose(frames[1], params))
    got, want = talign.align_pose_sequence(frames, ref), jalign.align_pose_sequence(frames, ref)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w)
    assert talign.align_pose_sequence([], ref) == jalign.align_pose_sequence([], ref) == []
    fj = jalign.OneEuroFilter(0.0, np.zeros(3), min_cutoff=0.5, beta=0.3)
    ft = talign.OneEuroFilter(0.0, np.zeros(3), min_cutoff=0.5, beta=0.3)
    for t in range(1, 6):
        x = rng.standard_normal(3)
        _close(ft(t * 0.04, x), fj(t * 0.04, x))


# ---------------------------------------------------------------------------
# the scripts
# ---------------------------------------------------------------------------


def _write_mp4(path: Path, frames):
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


def _record(monkeypatch, wholebody_cls, draw_module, seen: dict, key: str):
    """Wrap wholebody_cls.__call__ and draw_module.draw_pose_frame (where the
    script imports them from), keeping what they return under seen[key]."""
    call = wholebody_cls.__call__
    draw = draw_module.draw_pose_frame
    seen[key] = {"kpts": [], "frames": []}

    def spy_call(self, frame):
        out = call(self, frame)
        seen[key]["kpts"].append(out)
        return out

    def spy_draw(*a, **kw):
        out = draw(*a, **kw)
        seen[key]["frames"].append(out)
        return out

    monkeypatch.setattr(wholebody_cls, "__call__", spy_call)
    monkeypatch.setattr(draw_module, "draw_pose_frame", spy_draw)


def _no_writers(monkeypatch):
    """The tools as on a machine with neither Pillow nor an mp4 writer."""
    from svi_tpu_torch.scripts import make_toy_data

    def init(self, pillow=None, videos=None):
        self.pillow = self.videos = False

    monkeypatch.setattr(make_toy_data.Writer, "__init__", init)


def _run_jax_script(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"scripts/{name}.py", *argv])
    runpy.run_path(str(REPO / "scripts" / f"{name}.py"), run_name="__main__")


def _compare_runs(seen):
    assert len(seen["torch"]["kpts"]) == len(seen["jax"]["kpts"]) > 0
    for (kt, st), (kj, sj) in zip(seen["torch"]["kpts"], seen["jax"]["kpts"]):
        assert np.abs(kt - kj).max() <= KPT_PX
        np.testing.assert_array_equal(st, sj)
    assert len(seen["torch"]["frames"]) == len(seen["jax"]["frames"]) > 0
    for got, want in zip(seen["torch"]["frames"], seen["jax"]["frames"]):
        share, iou, _ = _draw_gap(got, want)
        assert share <= DRAW_PIXELS and iou >= DRAW_IOU, (share, iou)


def test_prepare_video_pose_matches_the_jax_script(graph_files, tmp_path, monkeypatch):
    rng = np.random.default_rng(13)
    frames = [rng.integers(0, 256, (72, 96, 3), dtype=np.uint8) for _ in range(3)]
    vids = tmp_path / "videos"
    vids.mkdir()
    _write_mp4(vids / "clip_a.mp4", frames)
    common = ["--video_dir", str(vids), "--det_onnx", graph_files["det"],
              "--pose_onnx", graph_files["kpt_pose"], "--fps", "25"]
    seen = {}
    _record(monkeypatch, jwb.Wholebody, jdw, seen, "jax")
    _run_jax_script("prepare_video_pose", [*common, "--out_dir", str(tmp_path / "jax")],
                    monkeypatch)
    _record(monkeypatch, twb.Wholebody, tdw, seen, "torch")
    done = prepare_video_pose.main([*common, "--out_dir", str(tmp_path / "port")], device="cpu")
    _compare_runs(seen)
    assert done == {"clip_a": (3, ("video.mp4", "dwpose.mp4"))}
    assert (sorted(p.name for p in (tmp_path / "port" / "clip_a").iterdir())
            == sorted(p.name for p in (tmp_path / "jax" / "clip_a").iterdir()))
    # an .npy video, and no mp4 writer: video.npy + dwpose.npy, which the
    # dance dataset reads
    np.save(vids / "clip_b.npy", np.stack(frames))
    (vids / "clip_a.mp4").unlink()
    _no_writers(monkeypatch)
    seen["torch"] = {"kpts": [], "frames": []}
    done = prepare_video_pose.main([*common, "--out_dir", str(tmp_path / "npy")], device="cpu")
    assert done == {"clip_b": (3, ("video.npy", "dwpose.npy"))}
    np.testing.assert_array_equal(np.load(tmp_path / "npy" / "clip_b" / "video.npy"),
                                  np.stack(frames))
    np.testing.assert_array_equal(np.load(tmp_path / "npy" / "clip_b" / "dwpose.npy"),
                                  np.stack(seen["torch"]["frames"]))
    from svi_tpu_torch.training.dataset import DanceVideoDataset

    ds = DanceVideoDataset(str(tmp_path / "npy"), num_frames=2, height=64, width=96)
    assert len(ds.video_list) == 1


def test_run_align_pose_matches_the_jax_script(graph_files, tmp_path, monkeypatch):
    from PIL import Image

    rng = np.random.default_rng(14)
    frames = [rng.integers(0, 256, (64, 80, 3), dtype=np.uint8) for _ in range(3)]
    _write_mp4(tmp_path / "drive.mp4", frames)
    ref = rng.integers(0, 256, (96, 64, 3), dtype=np.uint8)
    Image.fromarray(ref).save(tmp_path / "ref.png")
    common = ["--ref_name", str(tmp_path / "ref.png"), "--source_video_paths",
              str(tmp_path / "drive.mp4"), "--det_onnx", graph_files["det"],
              "--pose_onnx", graph_files["kpt_pose"], "--height", "384", "--width", "256"]
    seen = {}
    aligned_j = []
    align_seq = jalign.align_pose_sequence
    monkeypatch.setattr(jalign, "align_pose_sequence",
                        lambda p, r: aligned_j.extend(align_seq(p, r)) or aligned_j)
    _record(monkeypatch, jwb.Wholebody, jdraw, seen, "jax")
    _run_jax_script("run_align_pose", [*common, "--saved_pose_dir", str(tmp_path / "jax")],
                    monkeypatch)
    _record(monkeypatch, twb.Wholebody, tdraw, seen, "torch")
    out = run_align_pose.main([*common, "--saved_pose_dir", str(tmp_path / "port")],
                              device="cpu")
    _compare_runs(seen)
    assert len(out["aligned"]) == len(aligned_j) == 3
    for g, w in zip(out["aligned"], aligned_j):
        _close(g, w)
    assert out["files"] == ["0000.jpg", "0001.jpg", "0002.jpg", "pose.jpg"]
    assert (sorted(p.name for p in (tmp_path / "port").iterdir())
            == sorted(p.name for p in (tmp_path / "jax").iterdir()))
    # without Pillow: a .npy reference in, .npy frames out
    np.save(tmp_path / "ref.npy", ref)
    _no_writers(monkeypatch)
    argv = [a if a != str(tmp_path / "ref.png") else str(tmp_path / "ref.npy") for a in common]
    out = run_align_pose.main([*argv, "--saved_pose_dir", str(tmp_path / "npy")], device="cpu")
    assert out["files"] == ["0000.npy", "0001.npy", "0002.npy", "pose.npy"]
    np.testing.assert_array_equal(np.load(tmp_path / "npy" / "pose.npy"),
                                  seen["torch"]["frames"][-1])


def test_metadata_gen_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    vids, caps = tmp_path / "v", tmp_path / "c"
    vids.mkdir()
    caps.mkdir()
    for name in ("b.mp4", "a.MOV", "c.avi", "notes.txt", "d.mkv"):
        (vids / name).write_bytes(b"")
    (caps / "a.txt").write_text("a dancer, spinning \n", encoding="utf-8")
    (caps / "b.caption").write_text("Ein Satz mit Ümlauten, \"quoted\"", encoding="utf-8")
    (caps / "c.text").write_text("   ", encoding="utf-8")
    for tool, out in (("jax", "jax.csv"), ("port", "port.csv")):
        argv = ["--video_dir", str(vids), "--caption_dir", str(caps), "--output_csv",
                str(tmp_path / out), "--default_text", "someone, moving"]
        if tool == "jax":
            _run_jax_script("metadata_gen", argv, monkeypatch)
        else:
            metadata_gen.main(argv)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    capsys.readouterr()
    for tool in ("jax", "port"):
        argv = ["--video_dir", str(vids), "--caption_dir", str(caps), "--list_captions"]
        if tool == "jax":
            _run_jax_script("metadata_gen", argv, monkeypatch)
        else:
            metadata_gen.main(argv)
    printed = capsys.readouterr().out.splitlines()
    half = len(printed) // 2
    assert printed[:half] == printed[half:] and half > 0
