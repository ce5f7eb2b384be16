"""Generate a training ``metadata.csv`` pairing video files with captions
(port of scripts/metadata_gen.py).

    python -m svi_tpu_torch.scripts.metadata_gen --video_dir videos/ --caption_dir captions/

Scans a directory of videos, looks up a same-stem caption file
(``.txt`` / ``.caption`` / ``.text``) in a caption directory, and writes a
two-column ``file_name,text`` CSV, the file that
``training.dataset.TextVideoDataset`` reads. Videos with no caption fall
back to ``--default_text``. The output is byte for byte the JAX script's.
"""

import argparse
import csv
import os

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".flv", ".wmv")
CAPTION_EXTENSIONS = (".txt", ".caption", ".text")


def read_caption_file(caption_path):
    try:
        with open(caption_path, "r", encoding="utf-8") as f:
            return f.read().strip() or None
    except OSError as e:
        print(f"Warning: failed to read caption file {caption_path}: {e}")
        return None


def find_caption(caption_dir, video_name):
    for ext in CAPTION_EXTENSIONS:
        path = os.path.join(caption_dir, video_name + ext)
        if os.path.exists(path):
            text = read_caption_file(path)
            if text:
                return text
    return None


def generate_metadata(video_dir, caption_dir, output_csv, default_text):
    if not os.path.isdir(video_dir):
        raise SystemExit(f"video directory '{video_dir}' does not exist")
    if not os.path.isdir(caption_dir):
        raise SystemExit(f"caption directory '{caption_dir}' does not exist")

    video_files = sorted(
        f
        for f in os.listdir(video_dir)
        if os.path.isfile(os.path.join(video_dir, f))
        and os.path.splitext(f)[1].lower() in VIDEO_EXTENSIONS
    )
    print(f"Found {len(video_files)} video files")

    found = missing = 0
    with open(output_csv, "w", newline="", encoding="utf-8") as csvfile:
        writer = csv.writer(csvfile)
        writer.writerow(["file_name", "text"])
        for video_file in video_files:
            stem = os.path.splitext(video_file)[0]
            text = find_caption(caption_dir, stem)
            if text is None:
                text = default_text
                missing += 1
                print(f"Warning: no caption for {video_file}, using default text")
            else:
                found += 1
            writer.writerow([video_file, text])

    print(f"videos={len(video_files)} captions={found} defaulted={missing}")
    print(f"wrote {output_csv}")


def list_caption_files(caption_dir):
    if not os.path.isdir(caption_dir):
        print(f"Caption directory does not exist: {caption_dir}")
        return
    by_ext = {}
    for f in sorted(os.listdir(caption_dir)):
        by_ext.setdefault(os.path.splitext(f)[1].lower(), []).append(f)
    for ext, files in by_ext.items():
        print(f"  {ext or '(none)'}: {len(files)} files")
        for f in files[:3]:
            print(f"    {f}")
        if len(files) > 3:
            print(f"    ... and {len(files) - 3} more")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate metadata.csv for video files with captions"
    )
    parser.add_argument("--video_dir", type=str, required=True)
    parser.add_argument("--caption_dir", type=str, required=True)
    parser.add_argument("--output_csv", type=str, default="metadata.csv")
    parser.add_argument("--default_text", type=str, default="A person is speaking")
    parser.add_argument("--list_captions", action="store_true",
                        help="list caption files in the directory and exit")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.list_captions:
        list_caption_files(args.caption_dir)
        return
    generate_metadata(args.video_dir, args.caption_dir, args.output_csv, args.default_text)


if __name__ == "__main__":
    main()
