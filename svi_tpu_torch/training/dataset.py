"""Training datasets (port of svi_tpu/training/dataset.py; behavioral ref:
train_svi.py:368-624 TextVideoDataset_onestage, train_svi_dance.py:505-660,
train_svi_talk.py:462-540).

Host-side numpy pipeline: scan the dataset's layout, per item sample a
random-stride window of frames, an aspect-ratio random crop, resize, scale
to [-1, 1]; emit 12 candidate motion frames and one random anchor frame. The
`random.Random` calls are the JAX package's, in the same order, so that one
seed gives the same windows, crop boxes, anchors and captions. Read failures
fall back to another random video (ref :521-526).

Layouts, as the JAX package reads them, plus `.npy` videos ((N, H, W, 3)
uint8, memory-mapped so that a window reads only its own frames) for
machines with neither OpenCV nor Pillow (the card's):
  * TextVideoDataset: category dirs, each with `{category}.csv` captions
    (Filename, Video Description) and its videos (`.mp4` ... or `.npy`);
  * DanceVideoDataset: sample dirs with `video.mp4` + `dwpose.mp4`, or
    `video.npy` + `dwpose.npy`, or the `frame_data.pkl` +
    `dw_pose_with_foot_wo_face.pkl` dicts of JPEG bytes (Pillow);
  * TalkVideoDataset: sample dirs with `audio_embedding.pkl` ((12, s, 768)
    wav2vec2 states) and `frame_data.pkl` (Pillow), `video.mp4` or
    `video.npy`.

The crop and resize are the port's own (`crop_resize`: torch's antialiased
bilinear on host uint8 tensors), not Pillow's; they differ from Pillow's
BILINEAR by at most one level (tests/test_torch_train_data.py).
"""

from __future__ import annotations

import csv
import os
import random

import numpy as np
import torch
import torch.nn.functional as F

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".npy")


def crop_resize(frames: np.ndarray, box, width: int, height: int) -> np.ndarray:
    """(T, H0, W0, 3) uint8 frames -> the crop box (x1, y1, x2, y2) of each
    resized to (T, height, width, 3) uint8: bilinear with the support widened
    when shrinking (antialiased, as Pillow's BILINEAR is), on host tensors."""
    x1, y1, x2, y2 = box
    t = torch.from_numpy(np.ascontiguousarray(frames[:, y1:y2, x1:x2]))
    t = t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    out = F.interpolate(t, size=(height, width), mode="bilinear", antialias=True,
                        align_corners=False)
    return out.permute(0, 2, 3, 1).contiguous().numpy()


def _frame_indices(rng: random.Random, total: int, sample_fps: int, max_frames: int,
                   min_one: bool) -> tuple[list[int], int, int]:
    """The window's frame indices (padded with its last to max_frames), its
    start and its end, drawn as the JAX package draws them."""
    stride = rng.randint(1, sample_fps)
    cover = stride * max_frames
    if total < cover + 1:
        start = 0
        stride = max(total // max_frames, 1)
        end = min(stride * max_frames, total - 1)
    else:
        max_start = max(0, total - cover - 5)
        start = rng.randint(0, max_start) if max_start > 0 else 0
        end = start + cover
    stop = min(max(end, start + 1), total) if min_one else min(end, total)
    idxs = list(range(start, stop, stride))
    while len(idxs) < max_frames:
        idxs.append(idxs[-1] if idxs else 0)
    return idxs[:max_frames], start, end


def _jpeg_frames(path: str, keys=None) -> tuple[list, list[np.ndarray]]:
    """A pickled dict of JPEG bytes -> (its keys, the decoded RGB frames of
    `keys` where given, else of all its keys in order)."""
    import io
    import pickle

    from PIL import Image

    with open(path, "rb") as f:
        data = pickle.load(f)
    keys = list(data.keys()) if keys is None else [k for k in keys if k in data]
    return keys, [np.asarray(Image.open(io.BytesIO(data[k])).convert("RGB")) for k in keys]


class TextVideoDataset:
    def __init__(self, base_path, max_num_frames=81, frame_interval=1, num_frames=81,
                 height=480, width=832, steps_per_epoch=1, seed=None, args=None):
        self.max_frames = max_num_frames
        self.sample_fps = frame_interval
        self.height = height
        self.width = width
        self.steps_per_epoch = steps_per_epoch
        self.rng = random.Random(seed)
        self.video_list = []

        if os.path.isdir(base_path):
            subdirs = [d for d in sorted(os.listdir(base_path))
                       if os.path.isdir(os.path.join(base_path, d))]
            for subdir in subdirs:
                subdir_path = os.path.join(base_path, subdir)
                captions = {}
                csv_file = os.path.join(subdir_path, f"{subdir}.csv")
                if os.path.exists(csv_file):
                    with open(csv_file, "r", encoding="utf-8") as f:
                        for row in csv.DictReader(f):
                            if "Filename" in row and "Video Description" in row:
                                captions[row["Filename"]] = row["Video Description"]
                for file in sorted(os.listdir(subdir_path)):
                    if file.lower().endswith(VIDEO_EXTS):
                        self.video_list.append({
                            "path": os.path.join(subdir_path, file),
                            "description": captions.get(file, f"A video from {subdir} category"),
                            "category": subdir,
                        })
            if not subdirs:
                for root, dirs, files in os.walk(base_path):
                    for file in sorted(files):
                        if file.lower().endswith(VIDEO_EXTS):
                            self.video_list.append({
                                "path": os.path.join(root, file),
                                "description": "The video", "category": "unknown",
                            })
        elif base_path.lower().endswith(VIDEO_EXTS):
            self.video_list.append({"path": base_path, "description": "The video",
                                    "category": "single"})
        self.rng.shuffle(self.video_list)

    def __len__(self):
        return len(self.video_list)

    def _read_window(self, path):
        from ..utils.video import load_video_frames, video_frame_count

        total = video_frame_count(path)
        if total <= 0:
            raise IOError(f"empty video: {path}")
        idxs, _, _ = _frame_indices(self.rng, total, self.sample_fps, self.max_frames,
                                    min_one=False)
        return [f[..., :3] for f in load_video_frames(path, idxs)]

    def _random_crop_box(self, w, h):
        """Aspect-ratio random crop (ref :568-605)."""
        target_ar = self.height / self.width
        if w * target_ar <= h:
            cw = self.rng.randint(w - w // 14, w)
            ch = int(cw * target_ar)
        else:
            ch = self.rng.randint(h - h // 14, h)
            cw = int(ch / target_ar)
        cw, ch = min(cw, w), min(ch, h)
        x1 = self.rng.randint(0, w - cw) if w > cw else 0
        y1 = self.rng.randint(0, h - ch) if h > ch else 0
        return x1, y1, x1 + cw, y1 + ch

    def _crop_window(self, frames, idxs):
        """The frames at idxs, cropped by a fresh random box and resized:
        (T, H, W, 3) uint8."""
        h, w = frames[0].shape[:2]
        box = self._random_crop_box(w, h)
        return crop_resize(np.stack([frames[i][..., :3] for i in idxs]), box, self.width,
                           self.height)

    def _sample(self, item, proc: np.ndarray, n: int) -> dict:
        """The fields every dataset emits from its (T, H, W, 3) uint8 window."""
        video = np.transpose(proc.astype(np.float32) * (2 / 255) - 1, (3, 0, 1, 2))
        return {
            "text": item["description"],
            "video": video,  # (3, T, H, W) in [-1, 1]
            "path": item["path"],
            "first_ref_frames": [proc[i] for i in range(min(12, n))],  # HWC uint8
            "random_ref_frame": proc[self.rng.randint(0, n - 1)],
        }

    def __getitem__(self, index, _retries=8):
        item = self.video_list[index % len(self.video_list)]
        try:
            frames = self._read_window(item["path"])
        except (OSError, IOError, ValueError):
            # skip unreadable videos by resampling (ref :521-526), bounded
            if _retries <= 0:
                raise
            return self.__getitem__(self.rng.randint(0, len(self.video_list) - 1),
                                    _retries=_retries - 1)
        proc = self._crop_window(frames, range(len(frames)))
        return self._sample(item, proc, len(frames))


class DanceVideoDataset(TextVideoDataset):
    """SVI-Dance training data (ref train_svi_dance.py:505-660): per-sample
    dirs with paired video + pose videos or JPEG dicts. Emits the aligned
    pose window as raw (3, T, H, W) in [0, 255]."""

    def __init__(self, base_path, **kw):
        super().__init__(base_path, **kw)
        self.video_list = []
        for root, dirs, files in os.walk(base_path):
            if "video.mp4" in files or "video.npy" in files or "frame_data.pkl" in files:
                self.video_list.append({"path": root, "description": "the person is dancing",
                                        "category": "dance"})
        self.video_list.sort(key=lambda d: d["path"])
        self.rng.shuffle(self.video_list)

    def _load_pair(self, path_dir):
        from ..utils.video import load_video_frames

        if os.path.exists(os.path.join(path_dir, "video.mp4")):
            frames = load_video_frames(os.path.join(path_dir, "video.mp4"))
            poses = load_video_frames(os.path.join(path_dir, "dwpose.mp4"))
        elif os.path.exists(os.path.join(path_dir, "video.npy")):
            from ..utils.video import open_npy_video

            frames = open_npy_video(os.path.join(path_dir, "video.npy"))
            poses = open_npy_video(os.path.join(path_dir, "dwpose.npy"))
        else:
            keys, frames = _jpeg_frames(os.path.join(path_dir, "frame_data.pkl"))
            _, poses = _jpeg_frames(os.path.join(path_dir, "dw_pose_with_foot_wo_face.pkl"),
                                    keys)
        n = min(len(frames), len(poses))
        return frames[:n], poses[:n]

    def __getitem__(self, index, _retries=4):
        item = self.video_list[index % len(self.video_list)]
        try:
            frames, poses = self._load_pair(item["path"])
        except (OSError, IOError, ValueError, KeyError):
            if _retries <= 0:
                raise
            return self.__getitem__(self.rng.randint(0, len(self.video_list) - 1),
                                    _retries=_retries - 1)
        idxs, _, _ = _frame_indices(self.rng, len(frames), self.sample_fps, self.max_frames,
                                    min_one=True)
        h, w = frames[0].shape[:2]
        box = self._random_crop_box(w, h)
        proc = crop_resize(np.stack([frames[i][..., :3] for i in idxs]), box, self.width,
                           self.height)
        pose_proc = crop_resize(np.stack([poses[i][..., :3] for i in idxs]), box, self.width,
                                self.height)
        out = self._sample(item, proc, len(idxs))
        out["dwpose_data"] = np.transpose(pose_proc.astype(np.float32), (3, 0, 1, 2))  # 0..255
        return out


class TalkVideoDataset(TextVideoDataset):
    """SVI-Talk training data (ref train_svi_talk.py:462-540): per-sample dirs
    with frames and audio_embedding.pkl ((12, s, 768) wav2vec2 states).
    Emits the cut and grouped audio windows aligned to the frame window."""

    def __init__(self, base_path, **kw):
        super().__init__(base_path, **kw)
        self.video_list = []
        for root, dirs, files in os.walk(base_path):
            if "audio_embedding.pkl" in files and (
                    "frame_data.pkl" in files or "video.mp4" in files or "video.npy" in files):
                self.video_list.append({"path": root, "description": "the person is talking",
                                        "category": "talk"})
        self.video_list.sort(key=lambda d: d["path"])
        self.rng.shuffle(self.video_list)

    def __getitem__(self, index, _retries=4):
        import pickle

        from ..utils.audio import cut_audio_embedding
        from ..utils.video import open_npy_video, load_video_frames

        item = self.video_list[index % len(self.video_list)]
        path_dir = item["path"]
        try:
            if os.path.exists(os.path.join(path_dir, "frame_data.pkl")):
                _, frames = _jpeg_frames(os.path.join(path_dir, "frame_data.pkl"))
            elif os.path.exists(os.path.join(path_dir, "video.mp4")):
                frames = load_video_frames(os.path.join(path_dir, "video.mp4"))
            else:
                frames = open_npy_video(os.path.join(path_dir, "video.npy"))
            # the dataset's own file (written by its preprocessing)
            with open(os.path.join(path_dir, "audio_embedding.pkl"), "rb") as f:
                audio_embed = pickle.load(f)
            if hasattr(audio_embed, "detach"):
                audio_embed = audio_embed.detach().float().numpy()
        except (OSError, IOError, ValueError, KeyError):
            if _retries <= 0:
                raise
            return self.__getitem__(self.rng.randint(0, len(self.video_list) - 1),
                                    _retries=_retries - 1)
        idxs, start, end = _frame_indices(self.rng, len(frames), self.sample_fps,
                                          self.max_frames, min_one=True)
        audio_first, audio_vf = cut_audio_embedding(
            audio_embed, self.max_frames, audio_start_idx=start, audio_end_idx=end)
        proc = self._crop_window(frames, idxs)
        out = self._sample(item, proc, len(idxs))
        out["audio_first"] = audio_first[None]  # (1, 1, 5, 12, 768)
        out["audio_vf"] = audio_vf[None]  # (1, n_t - 1, 8, 12, 768)
        return out


def prefetch_samples(ds, indices, depth: int = 2):
    """Yield ``ds[i]`` for each index, read ahead on ONE background thread, so
    that the host's decode, crop and resize overlap the device's train step
    (the reference's DataLoader workers, train_svi.py:1408-1414). One worker
    keeps the dataset's RNG call order: the samples are those of the plain
    ``for i in indices: ds[i]`` loop. An exception of the dataset (after its
    own bounded resampling) is raised in the consumer. Closing the generator
    (or leaving it unfinished and dropping it) stops the worker after the
    sample it is reading."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
    done = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker():
        try:
            for i in indices:
                if not _put(ds[i]):
                    return
        except BaseException as ex:  # noqa: BLE001 - raised again in the consumer
            _put(ex)
            return
        _put(done)

    threading.Thread(target=_worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
