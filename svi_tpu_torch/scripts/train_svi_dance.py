"""SVI-Dance training driver on the card (port of scripts/train_svi_dance.py;
behavioral ref: train_svi_dance.py).

    python -m svi_tpu_torch.scripts.train_svi_dance --dataset_path data/toy_train/svi-dance \
        --dit_path ... --vae_path ... --text_encoder_path ... --image_encoder_path ...

train_svi with a TRAINABLE pose embedding (dwpose_embedding, seeded as
seed + 1) optimized jointly with the LoRA adapters, pose dropout (p < 0.05,
then p < 0.1, on the EMBEDDED condition, ref :1045-1048), clip_feature / y
dropout (p < 0.1, ref :1055-1062), and the paired video + pose dataset
(`training.dataset.DanceVideoDataset`: video.mp4 + dwpose.mp4, video.npy +
dwpose.npy, or the JPEG pickles). --pretrained_lora_path warm-starts the
adapters and, where the file has them, the pose convs; --pretrained_pose_path
the pose convs alone, from the side modules of a LoRA file (e.g.
UniAnimate's). The exports keep `lora_*` + `dwpose_embedding.*` keys and load
in the dance inference pipeline.

`main(argv, device)` runs in-process, as train_svi.main.
"""

from __future__ import annotations

import functools
import random

from ..parallel.mesh import is_main_rank
from .train_svi import (Encoders, build_parser, load_models_and_prompter, setup, train_loop,
                        trainer_config_from_args)


def parse_args(argv=None):
    p = build_parser("SVI-Dance error-recycling training (PyTorch, CUDA)")
    p.add_argument("--pose_drop_prob1", type=float, default=0.05)
    p.add_argument("--pose_drop_prob2", type=float, default=0.1)
    p.add_argument("--cond_drop_prob", type=float, default=0.1)
    p.add_argument("--pretrained_pose_path", type=str, default=None,
                   help="warm-start dwpose_embedding (e.g. UniAnimate LoRA file)")
    return p.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    """Run the driver; returns what train_svi.main returns."""
    from ..models import pose_embedding
    from ..models.model_io import extract_side_modules, load_state_dict
    from ..training import ErrorRecyclingTrainer
    from ..training.dataset import DanceVideoDataset

    args = parse_args(argv)
    device, mesh = setup(args, device)

    mm, prompter = load_models_and_prompter(args, device)
    tc = trainer_config_from_args(args)
    tc.train_pose = True
    tc.pose_drop_prob1 = args.pose_drop_prob1
    tc.pose_drop_prob2 = args.pose_drop_prob2
    tc.cond_drop_prob = args.cond_drop_prob
    trainer = ErrorRecyclingTrainer(mm.fetch_model("wan_video_dit"), tc, mesh=mesh, device=device)
    if args.pretrained_lora_path:
        trainer.load_lora_safetensors(args.pretrained_lora_path)
    if args.pretrained_pose_path:
        side = extract_side_modules(load_state_dict(args.pretrained_pose_path))
        if side:
            trainer.pose_params = pose_embedding.params_from_torch_state_dict(side, device=device)
    enc = Encoders(mm, prompter, device)

    ds = DanceVideoDataset(args.dataset_path, max_num_frames=args.num_frames,
                           frame_interval=args.frame_interval, height=args.height,
                           width=args.width, seed=args.seed)
    if is_main_rank():
        print(f"dance dataset: {len(ds)} samples", flush=True)

    def encode(item):
        ctx = enc.text(item["text"])
        latents = enc.video(item["video"])
        y, clip_feat = enc.images(item["first_ref_frames"][:1], item["random_ref_frame"], args)
        return dict(latents=latents, context=ctx, y=y, clip_feature=clip_feat,
                    pose=item["dwpose_data"][None])

    record = train_loop(args, trainer, ds, lambda item: functools.partial(encode, item),
                        device, random.Random(args.seed), mesh)
    record["seconds"].update(enc.seconds)
    return dict(record, trainer=trainer, dataset=ds, encoders=enc)


if __name__ == "__main__":
    main()
