"""Extract an inference LoRA file from a trained checkpoint (port of
scripts/extract_lora.py). Host only.

    python -m svi_tpu_torch.scripts.extract_lora --input ckpt.safetensors \
        --output lora.safetensors

Keeps the `lora_*` tensors and the side modules (`dwpose_embedding` and the
other reference embeddings), strips the `pipe.dit.` prefix of the reference's
training checkpoints, and writes them in f32 as safetensors. Reads
.safetensors, .pth, .ckpt and .bin (`models.model_io.load_state_dict`).
"""

from __future__ import annotations

import argparse

import torch

SIDE_MARKERS = ("dwpose_embedding", "randomref_embedding_pose", "inpaint_embedding",
                "learn_in_embedding", "randomref")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", type=str, required=True,
                   help="trained checkpoint (.safetensors / .pth / .ckpt / .bin)")
    p.add_argument("--output", type=str, required=True, help="inference .safetensors")
    return p.parse_args(argv)


def extract(sd: dict) -> dict[str, torch.Tensor]:
    """The tensors an inference LoRA file holds, renamed, in f32."""
    out = {}
    for key, value in sd.items():
        if "lora_" not in key and not any(m in key for m in SIDE_MARKERS):
            continue
        new_key = key.split("pipe.dit.")[1] if "pipe.dit." in key else key
        out[new_key] = value.to(torch.float32).contiguous()
    return out


def main(argv=None) -> int:
    """Run the tool; returns the number of tensors written."""
    from ..models.model_io import load_state_dict
    from ..utils.safetensors_io import save_file

    args = parse_args(argv)
    out = extract(load_state_dict(args.input))
    if not out:
        raise SystemExit(f"no lora_/side-module tensors found in {args.input}")
    save_file(out, args.output)
    print(f"extracted {len(out)} tensors -> {args.output}")
    return len(out)


if __name__ == "__main__":
    main()
