"""Generate the toy datasets of the drivers and the datasets (port of
scripts/make_toy_data.py): synthetic, from fixed seeds, in the layouts the
port reads. Host only.

    python -m svi_tpu_torch.scripts.make_toy_data [--root data]

  toy_test/shot|film|tom  : frame.jpg + prompt.txt (a `prompts = [...]` stream)
  toy_test/dance          : image.png + pose.mp4
  toy_test/talk           : portrait.png + speech.wav (16 kHz)
  toy_train/svi-film-shot : category dirs of mp4s + {category}.csv
  toy_train/svi-dance     : 00001/video.mp4 + dwpose.mp4, and preprocessed/00001
                            with JPEG pickles (frame_data.pkl,
                            dw_pose_with_foot_wo_face.pkl)
  toy_train/svi-talk      : 00001/video.mp4 + audio_embedding.pkl ((12, s, 768),
                            f16)

The frames are the JAX script's, and so are speech.wav and
audio_embedding.pkl, byte for byte. Where Pillow is not installed the images
are (H, W, 3) uint8 .npy files of the same stem and the JPEG pickles are not
written; where neither imageio nor cv2 is installed the videos are (N, H, W,
3) uint8 .npy files of the same stem (the CSVs name them), which the drivers
and datasets read. The shot / film / tom frames are seeded by a CRC of the
sample's name: the JAX script's `hash(name)` changes from one Python process
to the next.
"""

from __future__ import annotations

import argparse
import importlib.util
import io
import os
import pickle
import wave as wave_mod
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2] / "data"


def scene_frame(t, h, w, seed=0, style="shot"):
    """Procedural scene: sky gradient, sun, drifting shapes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    # gradient sky
    img[..., 0] = 60 + 120 * yy / h
    img[..., 1] = 90 + 100 * yy / h
    img[..., 2] = 160 + 60 * (1 - yy / h)
    # sun / moon disc drifting with t
    cx = (0.2 + 0.6 * ((t * 3) % 100) / 100) * w
    cy = 0.25 * h + 10 * np.sin(t * 0.3)
    d2 = (xx - cx) ** 2 + (yy - cy) ** 2
    disc = np.exp(-d2 / (2 * (0.06 * h) ** 2))
    img[..., 0] += 180 * disc
    img[..., 1] += 150 * disc
    # rolling hills
    hill = yy > (0.7 * h + 0.05 * h * np.sin(xx / w * 6 + seed))
    img[hill] = np.array([40, 120 + 30 * np.sin(seed), 60], np.float32)
    # a walking blob (the "character")
    bx = (0.1 + 0.8 * ((t * 5) % 120) / 120) * w
    by = 0.75 * h + 6 * np.sin(t * 0.9)
    b2 = ((xx - bx) / (0.04 * w)) ** 2 + ((yy - by) / (0.1 * h)) ** 2
    img[b2 < 1] = np.array([200, 80, 60], np.float32)
    if style == "tom":  # second character chasing
        b2 = ((xx - bx + 0.12 * w) / (0.05 * w)) ** 2 + ((yy - by) / (0.08 * h)) ** 2
        img[b2 < 1] = np.array([90, 90, 200], np.float32)
    noise = rng.normal(0, 3, (h, w, 3)).astype(np.float32)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def pose_frame(t, h, w):
    """OpenPose-style stick figure on black, limbs swinging with t."""
    img = np.zeros((h, w, 3), np.uint8)
    cx, cy = w // 2, int(h * 0.35)
    ang = 0.6 * np.sin(t * 0.4)

    def line(p0, p1, color):
        n = 60
        for i in range(n):
            a = i / (n - 1)
            x = int(p0[0] * (1 - a) + p1[0] * a)
            y = int(p0[1] * (1 - a) + p1[1] * a)
            img[max(0, y - 2):y + 3, max(0, x - 2):x + 3] = color

    hip = (cx, int(h * 0.6))
    line((cx, cy), hip, (0, 255, 85))  # spine
    line((cx, cy), (int(cx - 0.15 * w * np.cos(ang)), int(cy + 0.18 * h + 20 * np.sin(ang))),
         (255, 85, 0))  # left arm
    line((cx, cy), (int(cx + 0.15 * w * np.cos(ang)), int(cy + 0.18 * h - 20 * np.sin(ang))),
         (255, 170, 0))  # right arm
    line(hip, (int(cx - 0.08 * w - 15 * np.sin(ang)), int(h * 0.9)), (0, 85, 255))  # left leg
    line(hip, (int(cx + 0.08 * w + 15 * np.sin(ang)), int(h * 0.9)), (85, 0, 255))  # right leg
    img[cy - 10:cy + 2, cx - 6:cx + 7] = (255, 0, 85)  # head
    return img


def portrait(h, w, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 50, np.float32)
    face = ((xx - w / 2) / (0.28 * w)) ** 2 + ((yy - 0.45 * h) / (0.35 * h)) ** 2 < 1
    img[face] = np.array([210, 170, 140], np.float32)
    for ex in (-0.1, 0.1):
        eye = ((xx - w / 2 - ex * w) / (0.04 * w)) ** 2 + ((yy - 0.38 * h) / (0.025 * h)) ** 2 < 1
        img[eye] = 30
    mouth = ((xx - w / 2) / (0.08 * w)) ** 2 + ((yy - 0.58 * h) / (0.02 * h)) ** 2 < 1
    img[mouth] = np.array([150, 60, 60], np.float32)
    img += rng.normal(0, 2, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


SHOT_PROMPTS = [
    "A lone explorer walks across rolling green hills under a warm evening sun.",
    "The explorer pauses at the hilltop, wind rippling through the tall grass.",
    "Clouds drift past as the explorer descends toward a quiet valley.",
    "At the valley floor, the explorer sets up a small camp as dusk settles.",
]
FILM_PROMPTS = [
    "Wide establishing shot: a red-cloaked traveler crosses a sunlit meadow.",
    "The traveler follows a winding path as the light turns golden.",
    "A gentle breeze carries leaves past the traveler's shoulders.",
    "The traveler reaches a ridge and gazes at the horizon.",
]
TOM_PROMPTS = [
    "A blue cat chases an orange mouse across a cartoon meadow.",
    "The mouse ducks behind a hill while the cat skids past.",
    "The cat doubles back; the mouse sprints toward the setting sun.",
    "Both tumble down the hillside in a cloud of dust.",
]


def name_seed(name: str) -> int:
    return zlib.crc32(name.encode()) % 97


def speech_pcm(sr: int = 16000, secs: int = 6) -> np.ndarray:
    """speech.wav's samples: vowel-ish harmonics under a syllable envelope,
    int16."""
    t = np.arange(sr * secs) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 0.7 * t)
    wave = sum(a * np.sin(2 * np.pi * k * np.cumsum(f0) / sr)
               for k, a in [(1, 0.6), (2, 0.25), (3, 0.1)])
    envelope = np.clip(np.sin(2 * np.pi * 2.5 * t), 0, 1) ** 0.5
    return (wave * envelope * 0.6 * 32767).astype(np.int16)


def talk_embedding() -> np.ndarray:
    """audio_embedding.pkl's array: (12 wav2vec2 layers, 100 frames, 768),
    f16 (it keeps the file small)."""
    return np.random.default_rng(31).standard_normal((12, 100, 768)).astype(np.float16)


class Writer:
    """Images through Pillow and videos through imageio or cv2 where they are
    installed (or as told), else as .npy files of the same stem. Each write
    returns the file's name."""

    def __init__(self, pillow: bool | None = None, videos: bool | None = None):
        find = importlib.util.find_spec
        self.pillow = find("PIL") is not None if pillow is None else pillow
        self.videos = (find("imageio") is not None or find("cv2") is not None
                       if videos is None else videos)

    def image(self, arr: np.ndarray, path: str, **save_kw) -> str:
        if not self.pillow:
            path = os.path.splitext(path)[0] + ".npy"
            np.save(path, arr)
        else:
            from PIL import Image

            Image.fromarray(arr).save(path, **save_kw)
        return os.path.basename(path)

    def video(self, frames: list, path: str, fps: int = 24) -> str:
        if not self.videos:
            path = os.path.splitext(path)[0] + ".npy"
            np.save(path, np.stack(frames))
        else:
            from ..utils.video import save_video

            save_video(frames, path, fps=fps)
        return os.path.basename(path)


def jpeg_bytes(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=70)
    return buf.getvalue()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", type=str, default=str(ROOT), help="the data directory to fill")
    return p.parse_args(argv)


def main(argv=None, writer: Writer | None = None) -> str:
    """Write the toy data under --root (the repository's data/ by default);
    returns the root."""
    root = parse_args(argv).root
    w = writer or Writer()

    # ---- toy_test ----
    for name, prompts, style in [("shot", SHOT_PROMPTS, "shot"),
                                 ("film", FILM_PROMPTS, "film"),
                                 ("tom", TOM_PROMPTS, "tom")]:
        d = os.path.join(root, "toy_test", name)
        os.makedirs(d, exist_ok=True)
        w.image(scene_frame(0, 480, 832, seed=name_seed(name), style=style),
                os.path.join(d, "frame.jpg"), quality=90)
        with open(os.path.join(d, "prompt.txt"), "w") as f:
            f.write("prompts = [\n")
            for p in prompts:
                f.write(f"    {p!r},\n")
            f.write("]\n")

    d = os.path.join(root, "toy_test", "dance")
    os.makedirs(d, exist_ok=True)
    w.image(scene_frame(0, 448, 256, seed=11), os.path.join(d, "image.png"))
    w.video([pose_frame(t, 448, 256) for t in range(96)], os.path.join(d, "pose.mp4"))

    d = os.path.join(root, "toy_test", "talk")
    os.makedirs(d, exist_ok=True)
    w.image(portrait(448, 448), os.path.join(d, "portrait.png"))
    with wave_mod.open(os.path.join(d, "speech.wav"), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        wf.writeframes(speech_pcm().tobytes())

    # ---- toy_train ----
    for cat, seed in [("hills", 1), ("meadow", 2)]:
        d = os.path.join(root, "toy_train", "svi-film-shot", cat)
        os.makedirs(d, exist_ok=True)
        rows = []
        for vi in range(2):
            frames = [scene_frame(t, 144, 256, seed=seed * 10 + vi) for t in range(100)]
            fn = w.video(frames, os.path.join(d, f"{cat}_{vi:02d}.mp4"))
            rows.append((fn, f"A synthetic {cat} scene with a drifting sun, clip {vi}."))
        with open(os.path.join(d, f"{cat}.csv"), "w") as f:
            f.write("Filename,Video Description\n")
            for fn, desc in rows:
                f.write(f'{fn},"{desc}"\n')

    d = os.path.join(root, "toy_train", "svi-dance", "00001")
    os.makedirs(d, exist_ok=True)
    w.video([scene_frame(t, 144, 256, seed=21) for t in range(96)], os.path.join(d, "video.mp4"))
    w.video([pose_frame(t, 144, 256) for t in range(96)], os.path.join(d, "dwpose.mp4"))

    if w.pillow:  # the preprocessed layout: per-frame JPEG bytes in pickles
        d = os.path.join(root, "toy_train", "svi-dance", "preprocessed", "00001")
        os.makedirs(d, exist_ok=True)
        frame_data = {f"{t:05d}": jpeg_bytes(scene_frame(t, 96, 128, seed=23))
                      for t in range(24)}
        dw_pose = {f"{t:05d}": jpeg_bytes(pose_frame(t, 96, 128)) for t in range(24)}
        with open(os.path.join(d, "frame_data.pkl"), "wb") as f:
            pickle.dump(frame_data, f)
        with open(os.path.join(d, "dw_pose_with_foot_wo_face.pkl"), "wb") as f:
            pickle.dump(dw_pose, f)

    d = os.path.join(root, "toy_train", "svi-talk", "00001")
    os.makedirs(d, exist_ok=True)
    w.video([portrait(144, 144, seed=t % 7) for t in range(96)], os.path.join(d, "video.mp4"))
    with open(os.path.join(d, "audio_embedding.pkl"), "wb") as f:
        pickle.dump(talk_embedding(), f)

    total = sum(os.path.getsize(os.path.join(r, f)) for r, _, files in os.walk(root)
                for f in files)
    print(f"toy data written under {os.path.abspath(root)} ({total / 1e6:.1f} MB)")
    return root


if __name__ == "__main__":
    main()
