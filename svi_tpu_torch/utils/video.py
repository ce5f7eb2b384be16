"""Video output (port of svi_tpu/utils/video.py: `save_video`,
`AsyncVideoSaver`), and `save_frames_npy` for machines with no video writer."""

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
