"""SVI-Talk training driver on the card (port of scripts/train_svi_talk.py;
behavioral ref: train_svi_talk.py).

    python -m svi_tpu_torch.scripts.train_svi_talk --dataset_path data/toy_train/svi-talk \
        --dit_path ... --multitalk_path multitalk.safetensors --vae_path ... \
        --text_encoder_path ... --image_encoder_path ...

train_svi with the audio branches: --multitalk_path is loaded with the DiT's
shards as one state dict (which makes it a multitalk DiT), each sample's
audio_embedding.pkl window is cut to its frame window
(`training.dataset.TalkVideoDataset`), and the audio is dropped with
p < --audio_drop_prob (ref :969-973). The JAX driver passes the audio only
to a multitalk DiT; here any audio DiT (multitalk or customtalk) takes it,
so that --train_architecture customtalk trains its FFNs (without audio they
are not on the path).

`main(argv, device)` runs in-process, as train_svi.main.
"""

from __future__ import annotations

import functools
import random

from ..parallel.mesh import is_main_rank
from .train_svi import (Encoders, build_parser, load_models_and_prompter, setup, train_loop,
                        trainer_config_from_args)


def parse_args(argv=None):
    p = build_parser("SVI-Talk error-recycling training (PyTorch, CUDA)")
    p.add_argument("--multitalk_path", type=str, default=None,
                   help="multitalk.safetensors (audio branches) merged into the DiT")
    p.add_argument("--audio_drop_prob", type=float, default=0.1)
    return p.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    """Run the driver; returns what train_svi.main returns."""
    from ..training import ErrorRecyclingTrainer
    from ..training.dataset import TalkVideoDataset

    args = parse_args(argv)
    if args.multitalk_path:
        args.dit_path = args.dit_path + "," + args.multitalk_path
    device, mesh = setup(args, device)

    mm, prompter = load_models_and_prompter(args, device)
    dit = mm.fetch_model("wan_video_dit")
    if not dit.cfg.has_audio and is_main_rank():
        print("WARNING: DiT loaded without audio branches (pass --multitalk_path); audio "
              "conditioning will be ignored", flush=True)
    tc = trainer_config_from_args(args)
    tc.audio_drop_prob = args.audio_drop_prob
    trainer = ErrorRecyclingTrainer(dit, tc, mesh=mesh, device=device)
    if args.pretrained_lora_path:
        trainer.load_lora_safetensors(args.pretrained_lora_path)
    enc = Encoders(mm, prompter, device)

    ds = TalkVideoDataset(args.dataset_path, max_num_frames=args.num_frames,
                          frame_interval=args.frame_interval, height=args.height,
                          width=args.width, seed=args.seed)
    if is_main_rank():
        print(f"talk dataset: {len(ds)} samples", flush=True)

    def encode(item):
        ctx = enc.text(item["text"])
        latents = enc.video(item["video"])
        y, clip_feat = enc.images(item["first_ref_frames"][:1], item["random_ref_frame"], args)
        audio = (item["audio_first"], item["audio_vf"]) if dit.cfg.has_audio else None
        return dict(latents=latents, context=ctx, y=y, clip_feature=clip_feat, audio_tuple=audio)

    record = train_loop(args, trainer, ds, lambda item: functools.partial(encode, item),
                        device, random.Random(args.seed), mesh)
    record["seconds"].update(enc.seconds)
    return dict(record, trainer=trainer, dataset=ds, encoders=enc)


if __name__ == "__main__":
    main()
