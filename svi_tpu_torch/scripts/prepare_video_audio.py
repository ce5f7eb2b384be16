"""Prepare an SVI-Talk training set from a user's clips (port of
scripts/prepare_video_audio.py).

    python -m svi_tpu_torch.scripts.prepare_video_audio --video_dir clips/ \
        --audio_dir wavs/ --out_dir data/talk/ --wav2vec_path weights/chinese-wav2vec2-base/

For each video of --video_dir (mp4 / mov / avi / mkv through OpenCV, or an
(N, H, W, 3) uint8 .npy) it writes a sample directory <out_dir>/<stem>/ with
the frames and, where <audio_dir>/<stem>.wav exists, audio_embedding.pkl:
the 12 wav2vec2 hidden states of the audio, (12, s, 768) f32 at 25 a second,
the layout `training.dataset.TalkVideoDataset` reads. The frames go into
frame_data.pkl (JPEG bytes, quality 90, keys "%06d.jpg") where Pillow is
installed, as the JAX script writes them, and into video.npy ((N, H, W, 3)
uint8) where it is not. wav2vec2 runs on the card unless --device cpu is
given (it raises when no card is present).
"""

from __future__ import annotations

import argparse
import io
import os
import pickle

import numpy as np

VIDEO_SUFFIXES = (".mp4", ".mov", ".avi", ".mkv", ".npy")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--video_dir", type=str, required=True,
                   help="dir of videos (mp4 / mov / avi / mkv, or (N, H, W, 3) uint8 .npy)")
    p.add_argument("--audio_dir", type=str, default=None,
                   help="dir of .wav files named like the videos")
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--wav2vec_path", type=str, default="./weights/chinese-wav2vec2-base/")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _pillow():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def write_frames(frames, out: str) -> str:
    """frame_data.pkl (JPEG bytes) where Pillow is installed, else video.npy;
    returns the file's name."""
    Image = _pillow()
    if Image is None:
        np.save(os.path.join(out, "video.npy"), np.stack([np.asarray(f) for f in frames]))
        return "video.npy"
    frame_data = {}
    for i, frame in enumerate(frames):
        buf = io.BytesIO()
        Image.fromarray(np.asarray(frame)).save(buf, format="JPEG", quality=90)
        frame_data[f"{i:06d}.jpg"] = buf.getvalue()
    with open(os.path.join(out, "frame_data.pkl"), "wb") as f:
        pickle.dump(frame_data, f)
    return "frame_data.pkl"


def main(argv=None, device=None) -> dict:
    """Run the tool (device, when given, overrides --device); returns
    {stem: the audio embedding's shape, or None where no audio was found}."""
    from ..utils import audio as audio_utils
    from ..utils.video import load_video_frames
    from .test_svi import card_device

    args = parse_args(argv)
    device = card_device(args.device if device is None else device)
    model = audio_utils.load_wav2vec(args.wav2vec_path, device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    done = {}
    for fname in sorted(os.listdir(args.video_dir)):
        if not fname.lower().endswith(VIDEO_SUFFIXES):
            continue
        stem = os.path.splitext(fname)[0]
        out = os.path.join(args.out_dir, stem)
        os.makedirs(out, exist_ok=True)
        frames = load_video_frames(os.path.join(args.video_dir, fname))
        frames_file = write_frames(frames, out)

        wav_path = os.path.join(args.audio_dir, stem + ".wav") if args.audio_dir else None
        if wav_path is None or not os.path.exists(wav_path):
            print(f"[{stem}] no audio found -- skipped embedding")
            done[stem] = None
            continue
        emb = audio_utils.wav2vec_embedding(audio_utils.load_audio(wav_path), None, model)
        emb_stored = np.transpose(emb, (1, 0, 2))  # (12, s, 768), the pickle's layout
        with open(os.path.join(out, "audio_embedding.pkl"), "wb") as f:
            pickle.dump(emb_stored, f)
        print(f"[{stem}] {len(frames)} frames ({frames_file}), audio embedding "
              f"{emb_stored.shape}")
        done[stem] = emb_stored.shape
    return done


if __name__ == "__main__":
    main()
