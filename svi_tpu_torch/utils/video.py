"""Video input and output (port of svi_tpu/utils/video.py: `save_video`,
`AsyncVideoSaver`, `load_video_frames`, `video_frame_count`), and
`save_frames_npy` for machines with no video writer."""

from __future__ import annotations

import threading

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
