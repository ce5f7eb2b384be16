"""Video input and output (port of svi_tpu/utils/video.py: `save_video`,
`AsyncVideoSaver`, `load_video_frames`, `video_frame_count`, and the lazy
frame sources `LowMemoryVideo`, `LowMemoryImageFolder`, `VideoData` with
`crop_and_resize`, `save_frames`), and `save_frames_npy` for machines with
no video writer.

Frames are (H, W, 3) uint8 arrays. A video is an mp4 (read through OpenCV or
imageio) or an (N, H, W, 3) uint8 `.npy`, which needs neither; an image
folder is read through Pillow. `save_frames` writes PNGs with the standard
library's zlib, so it needs no Pillow either.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib

import numpy as np


def save_video(frames, save_path: str, fps: int = 24, quality: int = 8) -> None:
    """A list of (H, W, 3) uint8 frames (or PIL images) -> mp4, through imageio
    where it has an mp4 backend, else through OpenCV, as the JAX package does;
    raises when neither can write one."""
    frames = [np.asarray(f) for f in frames]
    try:
        import imageio

        writer = imageio.get_writer(save_path, fps=fps, quality=quality)
    except (ImportError, ValueError):  # no imageio, or no mp4 backend for it
        pass
    else:
        for frame in frames:
            writer.append_data(frame)
        writer.close()
        return
    try:
        import cv2
    except ImportError as err:
        raise RuntimeError(f"cannot write {save_path}: neither imageio (with an mp4 backend) "
                           "nor cv2 is installed; save the frames as .npy instead") from err
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(save_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def open_npy_video(path: str) -> np.ndarray:
    """An (N, H, W, 3) uint8 .npy video, memory-mapped: only the frames that
    are indexed are read."""
    video = np.load(path, mmap_mode="r")
    if video.dtype != np.uint8 or video.ndim != 4 or video.shape[-1] != 3:
        raise ValueError(f"{path}: {video.shape} {video.dtype}, expected (N, H, W, 3) uint8")
    return video


def video_frame_count(path: str) -> int:
    """The number of frames of a video: a `.npy`'s from its header, other
    files' from OpenCV's frame count (as the JAX package reads it)."""
    if path.endswith(".npy"):
        return int(open_npy_video(path).shape[0])
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def load_video_frames(path: str, indices=None) -> list[np.ndarray]:
    """A video -> a list of (H, W, 3) uint8 RGB frames (all, or those at
    `indices`). A `.npy` of (N, H, W, 3) uint8 is read with numpy (for
    machines with neither cv2 nor imageio); other files through OpenCV, as
    the JAX package reads them, else imageio where it has a backend."""
    if path.endswith(".npy"):
        video = open_npy_video(path)
        return [np.array(video[i]) for i in (range(len(video)) if indices is None else indices)]
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        try:
            import imageio

            reader = imageio.get_reader(path)
        except (ImportError, ValueError) as err:
            raise RuntimeError(f"cannot read {path}: neither cv2 nor imageio (with a backend "
                               "for it) is installed; pass the frames as an (N, H, W, 3) "
                               "uint8 .npy") from err
        try:
            frames = [np.asarray(f)[..., :3] for f in reader]
        finally:
            reader.close()
        return frames if indices is None else [frames[int(i)] for i in indices]
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    frames = []
    try:
        if indices is None:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        else:
            for idx in indices:
                cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
                ok, frame = cap.read()
                if not ok:
                    raise IOError(f"cannot read frame {idx} of {path}")
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    return frames


def save_frames_npy(frames, save_path: str) -> None:
    """A list of (H, W, 3) uint8 frames -> one (T, H, W, 3) uint8 .npy array."""
    video = np.stack([np.asarray(f) for f in frames])
    if video.dtype != np.uint8 or video.ndim != 4 or video.shape[-1] != 3:
        raise ValueError(f"frames must be (H, W, 3) uint8, got {video.shape[1:]} {video.dtype}")
    np.save(save_path, video)


class AsyncVideoSaver:
    """Runs the per-clip save of the growing stitched video off the clip
    loop's path.

    submit() joins the previous write first (one write in flight: bounded
    memory, no two writes to one path at once), then runs the callable on a
    background thread, so the write overlaps the next clip's denoise. An
    exception surfaces on the next submit() or close(). Always close() before
    exiting so the last write completes. Snapshot the state the callable
    reads (e.g. `list(video_list)`): the caller keeps mutating it."""

    def __init__(self):
        self._thread = None
        self._err = None

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, fn):
        self._join()

        def _run():
            try:
                fn()
            except Exception as ex:  # noqa: BLE001 - re-raised by the caller's next _join
                self._err = ex

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def close(self):
        self._join()


# ---------------------------------------------------------------------------
# Lazy frame sources
# ---------------------------------------------------------------------------


class LowMemoryVideo:
    """Random access to the frames of an mp4 or an (N, H, W, 3) uint8 .npy."""

    def __init__(self, file_name):
        self.file_name = file_name
        self._len = video_frame_count(file_name)

    def __len__(self):
        return self._len

    def __getitem__(self, item) -> np.ndarray:
        return load_video_frames(self.file_name, [item])[0]


def split_file_name(file_name):
    """A digit-aware sort key: 'frame10.png' sorts after 'frame2.png'."""
    result, number = [], -1
    for ch in file_name:
        if "0" <= ch <= "9":
            number = max(number, 0) * 10 + ord(ch) - ord("0")
        else:
            if number != -1:
                result.append(number)
                number = -1
            result.append(ch)
    if number != -1:
        result.append(number)
    return tuple(result)


def search_for_images(folder):
    files = [f for f in os.listdir(folder) if f.endswith(".jpg") or f.endswith(".png")]
    return [os.path.join(folder, f) for f in sorted(files, key=split_file_name)]


class LowMemoryImageFolder:
    """The .jpg / .png files of a folder in digit-aware order, read through
    Pillow one at a time."""

    def __init__(self, folder, file_list=None):
        if file_list is None:
            self.file_list = search_for_images(folder)
        else:
            self.file_list = [os.path.join(folder, f) for f in file_list]

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, item) -> np.ndarray:
        try:
            from PIL import Image
        except ImportError as err:
            raise RuntimeError(f"reading {self.file_list[item]} needs Pillow, which is not "
                               "installed; pass the frames as an (N, H, W, 3) uint8 .npy "
                               "video instead") from err
        return np.asarray(Image.open(self.file_list[item]).convert("RGB"))


def crop_and_resize(image, height, width) -> np.ndarray:
    """The centre crop of the target's aspect ratio, resized to (height,
    width) as Pillow's default resize does (`utils.image_process.resize_uint8`)."""
    from .image_process import resize_uint8

    arr = np.asarray(image)
    ih, iw = arr.shape[:2]
    if ih / iw < height / width:
        cw = int(ih / height * width)
        left = (iw - cw) // 2
        arr = arr[:, left:left + cw]
    else:
        ch = int(iw / width * height)
        top = (ih - ch) // 2
        arr = arr[top:top + ch, :]
    return resize_uint8(arr, width, height)


class VideoData:
    """A lazy view of a video (mp4 or .npy) or an image folder, optionally
    cropped and resized to (height, width) and cut to a length."""

    def __init__(self, video_file=None, image_folder=None, height=None, width=None, **kwargs):
        if video_file is not None:
            self.data_type = "video"
            self.data = LowMemoryVideo(video_file, **kwargs)
        elif image_folder is not None:
            self.data_type = "images"
            self.data = LowMemoryImageFolder(image_folder, **kwargs)
        else:
            raise ValueError("Cannot open video or image folder")
        self.length = None
        self.set_shape(height, width)

    def raw_data(self):
        return [self[i] for i in range(len(self))]

    def set_length(self, length):
        self.length = length

    def set_shape(self, height, width):
        self.height = height
        self.width = width

    def __len__(self):
        return len(self.data) if self.length is None else self.length

    def shape(self):
        if self.height is not None and self.width is not None:
            return self.height, self.width
        return tuple(self[0].shape[:2])

    def __getitem__(self, item) -> np.ndarray:
        frame = self.data[item]
        height, width = frame.shape[:2]
        if self.height is not None and self.width is not None \
                and (self.height != height or self.width != width):
            frame = crop_and_resize(frame, self.height, self.width)
        return frame

    def save_images(self, folder):
        save_frames([self[i] for i in range(len(self))], folder)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(frame) -> bytes:
    """An (H, W, 3) uint8 frame as a PNG file (8-bit RGB, no filter)."""
    arr = np.ascontiguousarray(np.asarray(frame))
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"a frame must be (H, W, 3) uint8, got {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, 3 * w)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_frames(frames, save_path):
    """Frames -> save_path/0.png, 1.png, ..."""
    os.makedirs(save_path, exist_ok=True)
    for i, frame in enumerate(frames):
        with open(os.path.join(save_path, f"{i}.png"), "wb") as f:
            f.write(png_bytes(frame))
