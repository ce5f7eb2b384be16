"""Experiment bookkeeping of the training drivers (port of
svi_tpu/utils/project_utils.py): the experiment directory's name, the
configuration echo, the args dump, and the metadata CSV of a directory of
captioned videos. Host only."""

from __future__ import annotations

import csv
import json
import os

# the JAX package lists the first four; the port also lists (N, H, W, 3) uint8
# .npy clips, which its datasets read
VIDEO_SUFFIXES = (".mp4", ".mov", ".avi", ".mkv", ".npy")


def update_experiment_path(args, short: bool = True):
    """Point args.output_path at a subdirectory named for the run (the train
    architecture, its LoRA rank for lora, behind args.exp_prefix when set),
    made if missing."""
    arch = getattr(args, "train_architecture", "lora")
    parts = [arch]
    if arch == "lora":
        parts.append(str(getattr(args, "lora_rank", 128)))
    name = "_".join(parts)
    prefix = getattr(args, "exp_prefix", None)
    if prefix:
        name = f"{prefix}-{name}"
    full = os.path.join(args.output_path, name)
    os.makedirs(full, exist_ok=True)
    args.output_path = full
    return args


def print_args(args) -> None:
    """Every argument, sorted and aligned, between rules."""
    d = vars(args)
    width = max(len(k) for k in d)
    print("=" * 80)
    print("CONFIGURATION PARAMETERS:")
    print("=" * 80)
    for k in sorted(d):
        print(f"  {k.ljust(width)} : {d[k]}")
    print("=" * 80)
    print(f"Total number of cfg parameters: {len(d)}")
    print("=" * 80)


def save_args(args, output_path: str, filename: str = "args.yaml") -> str:
    """The arguments as YAML where PyYAML is installed, else as JSON beside
    the requested name (.json); values that are not plain become strings.
    Returns the path asked for."""
    os.makedirs(output_path, exist_ok=True)
    path = os.path.join(output_path, filename)
    d = {k: (v if isinstance(v, (int, float, str, bool, list, type(None))) else str(v))
         for k, v in vars(args).items()}
    try:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(d, f, sort_keys=True)
    except ImportError:
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump(d, f, indent=2, sort_keys=True)
    return path


def generate_metadata_with_captions(video_dir, caption_dir, output_csv,
                                    default_text="A person is dancing") -> int:
    """metadata.csv with one row per video of video_dir (Filename, Video
    Description): its caption from caption_dir/<stem>.txt or .caption when
    that is not empty, else default_text. Returns the number of rows."""
    rows = []
    for f in sorted(os.listdir(video_dir)):
        if not f.lower().endswith(VIDEO_SUFFIXES):
            continue
        stem = os.path.splitext(f)[0]
        caption = default_text
        for ext in (".txt", ".caption"):
            cp = os.path.join(caption_dir, stem + ext)
            if os.path.exists(cp):
                with open(cp, "r", encoding="utf-8") as fh:
                    content = fh.read().strip()
                if content:
                    caption = content
                break
        rows.append({"Filename": f, "Video Description": caption})
    with open(output_csv, "w", newline="", encoding="utf-8") as fh:
        writer = csv.DictWriter(fh, fieldnames=["Filename", "Video Description"])
        writer.writeheader()
        writer.writerows(rows)
    return len(rows)
