"""SVI Error-Recycling LoRA training driver on the card (port of
scripts/train_svi.py; behavioral ref: train_svi.py, the flags that
scripts/train/svi_shot.sh uses).

    python -m svi_tpu_torch.scripts.train_svi \
        --dataset_path data/toy_train/svi-film-shot \
        --dit_path <dir or comma-separated diffusion_pytorch_model*.safetensors> \
        --vae_path <Wan2.1_VAE.pth> \
        --text_encoder_path <models_t5_umt5-xxl-enc-bf16.pth> \
        --image_encoder_path <models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth> \
        --use_error_recycling --output_path experiments/train/svi

Per sample: the dataset's window (`training.dataset`, read ahead on one
thread), umT5 on its caption, the f32 VAE encode of its frames, and
`encode_images_adaptive` (CLIP and the VAE's condition latents) with the
motion-frame curriculum, all frozen; then one `ErrorRecyclingTrainer` step.
It writes `args.json`, `metrics.jsonl` (one line a step) and LoRA exports
`epoch={E}-step={S}.safetensors` every --save_every_n_steps steps and at the
end, and with --profile_dir a torch.profiler trace of step 3. The tokenizer
is `google/umt5-xxl/spiece.model` beside the text encoder unless
--tokenizer_path names another directory. On a machine without OpenCV or
Pillow (the card's) the videos are `.npy` files and --use_first_aug stays
off (it raises without Pillow).

Several GPUs: launch it with torchrun,

    torchrun --nproc_per_node N -m svi_tpu_torch.scripts.train_svi \
        --training_strategy sp|dataxsp|data_parallel [--shard_optimizer_state] ...

Each rank joins the group torchrun describes (`parallel.mesh.init_distributed`:
NCCL when every rank has a card of its own, else gloo), runs on
cuda:LOCAL_RANK, and builds the mesh of --training_strategy
(`make_training_mesh`: None on one process, where every strategy is the
single-device path). The global batch holds one sample per 'data' rank, in
the order the JAX driver concatenates them: every rank reads every sample
(the dataset's and the curriculum's random draws stay in step), encodes
only its own 'data' rank's sample (the 'sp' ranks of one 'data' rank encode
the same one), and the encodings are gathered, so every rank hands the
trainer the same global batch. Only global rank 0 writes files and prints.

`main(argv, device)` runs in-process: the models go on `device` (the card
unless the caller asks for the CPU) and it returns what it made.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import time

import numpy as np
import torch

from ..parallel.mesh import is_main_rank


def build_parser(description="SVI error-recycling LoRA training (PyTorch, CUDA)"):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--lora_rank", type=int, default=128)
    p.add_argument("--lora_alpha", type=float, default=128.0)
    p.add_argument("--lora_target_modules", type=str, default="q,k,v,o,ffn.0,ffn.2")
    p.add_argument("--dataset_path", type=str, required=True)
    p.add_argument("--dit_path", type=str, required=True, help="comma-separated shards or dir")
    p.add_argument("--vae_path", type=str, required=True)
    p.add_argument("--text_encoder_path", type=str, required=True)
    p.add_argument("--image_encoder_path", type=str, default=None)
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--max_epochs", type=int, default=10)
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--train_architecture", type=str, default="lora")
    p.add_argument("--use_gradient_checkpointing", action="store_true", default=True)
    p.add_argument("--use_gradient_checkpointing_offload", action="store_true", default=False,
                   help="keep the checkpoints' block carries in pinned host memory")
    p.add_argument("--training_strategy", type=str, default="data_parallel",
                   help="mesh layout under torchrun: data_parallel | sp | dataxsp (one "
                        "process: no mesh)")
    p.add_argument("--shard_optimizer_state", action="store_true", default=False,
                   help="ZeRO-1 analog of the reference's deepspeed_stage_2 (train_svi.py"
                        ":156-161): shard the AdamW moments over the mesh's 'data' axis")
    p.add_argument("--remat_granularity", type=int, default=1,
                   help="blocks per checkpoint group: 1 = per-block remat, 0 = auto "
                        "sqrt(L) grouping, n>1 explicit")
    p.add_argument("--save_attention", action="store_true", default=False,
                   help="keep each block's self-attention out / lse from the forward so the "
                        "backward's recompute skips the attention forward (costs S x dim of "
                        "activations a block)")
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8", "w8a8", "int4", "int4_w4a8"],
                   help="DiT base-weight quantization for QLoRA-style training (the adapters "
                        "stay f32; the base's backward is straight-through)")
    p.add_argument("--output_path", type=str, default="./experiments/train/svi")
    p.add_argument("--use_error_recycling", action="store_true", default=False)
    p.add_argument("--error_buffer_k", type=int, default=500)
    p.add_argument("--y_error_num", type=int, default=1)
    p.add_argument("--num_motion_frames", type=int, default=1)
    p.add_argument("--p_motion_threshold", type=float, default=0.5)
    p.add_argument("--repeat_first_frame", action="store_true", default=False)
    p.add_argument("--buffer_warmup_iter", type=int, default=50)
    p.add_argument("--buffer_replacement_strategy", type=str, default="random")
    p.add_argument("--y_error_sample_from_all_grids", action="store_true", default=False)
    p.add_argument("--y_error_sample_range", type=str, default=None)
    p.add_argument("--use_last_y_error", action="store_true", default=False)
    p.add_argument("--num_grids", type=int, default=40)
    p.add_argument("--timestep_grid_size", type=int, default=25)
    p.add_argument("--error_modulate_factor", type=float, default=0.2)
    p.add_argument("--ref_pad_num", type=int, default=-1)
    p.add_argument("--ref_pad_cfg", action="store_true", default=False)
    p.add_argument("--noise_prob", type=float, default=0.99)
    p.add_argument("--y_prob", type=float, default=0.99)
    p.add_argument("--latent_prob", type=float, default=0.99)
    p.add_argument("--clean_prob", type=float, default=0.1)
    p.add_argument("--clean_buffer_update_prob", type=float, default=0.5)
    p.add_argument("--exp_prefix", type=str, default="svi")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=832)
    p.add_argument("--num_frames", type=int, default=81)
    p.add_argument("--frame_interval", type=int, default=1)
    p.add_argument("--save_every_n_steps", type=int, default=100)
    p.add_argument("--pretrained_lora_path", type=str, default=None)
    p.add_argument("--use_first_aug", action="store_true", default=False)
    p.add_argument("--gradient_clip_val", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace (Chrome format) of train step 3 here")
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def trainer_config_from_args(args):
    from ..training import TrainerConfig

    y_range = None
    if args.y_error_sample_range:
        a, b = (int(v) for v in args.y_error_sample_range.split(","))
        gs = args.timestep_grid_size
        y_range = (a // gs, b // gs)
    return TrainerConfig(
        train_architecture=args.train_architecture,
        learning_rate=args.learning_rate,
        gradient_clip_val=args.gradient_clip_val,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        lora_targets=tuple(args.lora_target_modules.split(",")),
        use_gradient_checkpointing=args.use_gradient_checkpointing,
        use_gradient_checkpointing_offload=args.use_gradient_checkpointing_offload,
        use_error_recycling=args.use_error_recycling,
        error_buffer_k=args.error_buffer_k,
        buffer_replacement_strategy=args.buffer_replacement_strategy,
        buffer_warmup_iter=args.buffer_warmup_iter,
        num_grids=args.num_grids,
        error_modulate_factor=args.error_modulate_factor,
        noise_prob=args.noise_prob,
        y_prob=args.y_prob,
        latent_prob=args.latent_prob,
        clean_prob=args.clean_prob,
        clean_buffer_update_prob=args.clean_buffer_update_prob,
        y_error_num=args.y_error_num,
        use_last_y_error=args.use_last_y_error,
        y_error_sample_from_all_grids=args.y_error_sample_from_all_grids,
        y_error_sample_range=y_range,
        seed=args.seed,
        remat_granularity=args.remat_granularity,
        save_attention_activations=args.save_attention,
        shard_optimizer_state=args.shard_optimizer_state,
    )


def load_models_and_prompter(args, device):
    """The DiT (its shards as one state dict; quantized onto the device with
    --quantize), the VAE, umT5 and CLIP through the ModelManager, and the
    prompter with umT5 and its tokenizer."""
    from ..models.model_io import ModelManager
    from ..prompters.wan_prompter import WanPrompter

    mm = ModelManager(torch_dtype=torch.bfloat16, device=device,
                      quantize_dit=None if args.quantize == "none" else args.quantize)
    dit_paths = args.dit_path.split(",") if "," in args.dit_path else args.dit_path
    load_list = [dit_paths, args.vae_path, args.text_encoder_path]
    if args.image_encoder_path:
        load_list.append(args.image_encoder_path)
    mm.load_models(load_list)
    prompter = WanPrompter(tokenizer_path=args.tokenizer_path)
    prompter.fetch_models(mm.fetch_model("wan_video_text_encoder"))
    if args.tokenizer_path is None:
        cand = os.path.join(os.path.dirname(args.text_encoder_path), "google/umt5-xxl")
        if os.path.isdir(cand):
            prompter.fetch_tokenizer(cand)
    return mm, prompter


class Encoders:
    """The frozen encoders of a training run (the analog of the reference's
    LightningModelForDataProcess): umT5 through the prompter, the f32 VAE and
    CLIP through an encode-only pipeline. Each call returns host f32 arrays
    and adds its seconds to `seconds` (host clock; every call ends in a copy
    to the host, so the device work is inside it)."""

    def __init__(self, mm, prompter, device):
        from ..pipelines.svi_video import SVIVideoPipeline

        self.prompter = prompter
        self.device = device
        self.pipe = SVIVideoPipeline(device=device, torch_dtype=torch.bfloat16)
        self.pipe.vae = mm.fetch_model("wan_video_vae")
        self.pipe.image_encoder = mm.fetch_model("wan_video_image_encoder")
        self.seconds: dict[str, list[float]] = {}

    def _timed(self, name, fn):
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fn()
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def text(self, prompt: str) -> np.ndarray:
        return self._timed("t5", lambda: self.prompter.encode_prompt(prompt).float().cpu().numpy())

    def video(self, video: np.ndarray) -> np.ndarray:
        """(3, T, H, W) in [-1, 1] -> latents (1, 16, T', H/8, W/8), untiled."""
        return self._timed("vae_encode", lambda: self.pipe.vae.encode(
            torch.from_numpy(video[None]).to(self.device)).float().cpu().numpy())

    def images(self, cond_frames, ref_frame, args, use_first_aug=False, ref_pad_cfg=False):
        """y and the CLIP features (`encode_images_adaptive`: CLIP of the
        first frame, the VAE of the condition frames and their padding)."""
        def run():
            emb = self.pipe.encode_images_adaptive(
                cond_frames, ref_frame, args.num_frames, args.height, args.width,
                use_first_aug=use_first_aug, ref_pad_cfg=ref_pad_cfg, ref_pad_num=args.ref_pad_num)
            return (emb["y"].float().cpu().numpy(), emb["clip_feature"].float().cpu().numpy())
        return self._timed("clip_and_y", run)


def write_args(args) -> None:
    if not is_main_rank():
        return
    os.makedirs(args.output_path, exist_ok=True)
    with open(os.path.join(args.output_path, "args.json"), "w") as f:
        json.dump(vars(args), f, indent=2)  # provenance dump (ref project_utils.py:46-109)


def setup(args, device):
    """The process group (under torchrun), this rank's device, the mesh of
    --training_strategy (None on one process) and args.json."""
    from ..parallel.mesh import init_distributed, make_training_mesh
    from .test_svi import card_device

    device = init_distributed(card_device(device))
    mesh = make_training_mesh(args.training_strategy)
    if mesh is not None and is_main_rank():
        print(f"training mesh: {mesh.shape} ({mesh.world.backend})", flush=True)
    write_args(args)
    return device, mesh


def gather_batch(batch: dict, mesh, device) -> dict:
    """The 'data' ranks' encoded samples concatenated in rank order (the
    global batch), on every rank, as host arrays."""
    from ..parallel import collectives

    def gather(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return tuple(gather(x) for x in a)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return collectives.all_gather_tensors(t, mesh["data"]).cpu().numpy()

    return {k: gather(v) for k, v in batch.items()}


def train_loop(args, trainer, ds, plan_sample, device, rng: random.Random, mesh=None) -> dict:
    """The loop of the three drivers: epochs over a shuffled order, the
    samples read ahead, `plan_sample(item)` (the sample's host random draws)
    -> a callable that encodes it into the keyword arguments of
    `training_step`; one step per global batch (one sample per 'data' rank,
    this rank encoding its own, `gather_batch`), metrics.jsonl, the exports.
    Returns {"metrics", "exports", "seconds" (per phase: data wait, step,
    export), "last_batch"}."""
    from ..training.dataset import prefetch_samples
    from ..utils.logging import MetricsLogger, profile_trace

    main_rank = is_main_rank()
    batch_b = mesh.shape["data"] if mesh is not None else 1
    mine = mesh["data"].index if mesh is not None else 0
    record = {"metrics": [], "exports": [], "seconds": {"data": [], "step": [], "export": []},
              "last_batch": None}
    step = 0
    max_steps = args.max_steps if args.max_steps > 0 else args.max_epochs * max(len(ds), 1)
    t_start = time.time()
    log = (MetricsLogger(os.path.join(args.output_path, "metrics.jsonl")) if main_rank
           else None)
    pending = []
    try:
        for epoch in range(args.max_epochs):
            order = list(range(len(ds)))
            rng.shuffle(order)
            with contextlib.closing(prefetch_samples(ds, order)) as samples:
                while True:
                    t0 = time.perf_counter()
                    item = next(samples, None)
                    record["seconds"]["data"].append(time.perf_counter() - t0)
                    if item is None:
                        break
                    pending.append(plan_sample(item))
                    if len(pending) < batch_b:
                        continue
                    batch = pending[mine]()
                    pending = []
                    if batch_b > 1:
                        batch = gather_batch(batch, mesh, device)
                    record["last_batch"] = batch
                    t0 = time.perf_counter()
                    profile = args.profile_dir if step + 1 == 3 and main_rank else None
                    with profile_trace(profile):
                        metrics = trainer.training_step(**batch)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    record["seconds"]["step"].append(time.perf_counter() - t0)
                    step += 1
                    scalars = {k: v for k, v in metrics.items()
                               if isinstance(v, (int, float, bool))}
                    if log is not None:
                        log.log(step, **scalars)
                    record["metrics"].append(scalars)
                    if main_rank and (step % 10 == 0 or step == 1):
                        el = time.time() - t_start
                        print(f"step {step}/{max_steps} epoch {epoch} loss {metrics['loss']:.4f} "
                              f"grad {metrics['grad_norm']:.3f} buffers "
                              f"L{metrics.get('buffer_latent_total', 0)}/"
                              f"Y{metrics.get('buffer_y_total', 0)} {el / step:.1f}s/step",
                              flush=True)
                    if step % args.save_every_n_steps == 0 or step >= max_steps:
                        t0 = time.perf_counter()
                        path = os.path.join(args.output_path,
                                            f"epoch={epoch}-step={step}.safetensors")
                        trainer.save_lora_safetensors(path)
                        record["seconds"]["export"].append(time.perf_counter() - t0)
                        record["exports"].append(path)
                        if main_rank:
                            print(f"saved {path}", flush=True)
                    if step >= max_steps:
                        return record
    finally:
        if log is not None:
            log.close()
    return record


def main(argv=None, device="cuda") -> dict:
    """Run the driver; returns {"trainer", "dataset", "encoders", "metrics",
    "exports", "seconds", "last_batch"}."""
    from ..training import ErrorRecyclingTrainer
    from ..training.dataset import TextVideoDataset

    args = parse_args(argv)
    device, mesh = setup(args, device)

    mm, prompter = load_models_and_prompter(args, device)
    trainer = ErrorRecyclingTrainer(mm.fetch_model("wan_video_dit"),
                                    trainer_config_from_args(args), mesh=mesh, device=device)
    if args.pretrained_lora_path:
        trainer.load_lora_safetensors(args.pretrained_lora_path)
    enc = Encoders(mm, prompter, device)

    ds = TextVideoDataset(args.dataset_path, max_num_frames=args.num_frames,
                          frame_interval=args.frame_interval, height=args.height,
                          width=args.width, seed=args.seed)
    if is_main_rank():
        print(f"dataset: {len(ds)} videos", flush=True)
    rng = random.Random(args.seed)

    def plan_sample(item):
        # motion-frame curriculum (ref :1013-1031): drawn for every sample on
        # every rank, so the draws stay in step
        first_ref_frames = item["first_ref_frames"]
        if args.num_motion_frames > 1:
            if rng.random() < args.p_motion_threshold:
                cond_frames = first_ref_frames[: args.num_motion_frames]
            elif args.repeat_first_frame:
                cond_frames = [first_ref_frames[0]] * args.num_motion_frames
            else:
                cond_frames = first_ref_frames[:1]
        else:
            cond_frames = first_ref_frames[:1]

        def encode():
            ctx = enc.text(item["text"])
            latents = enc.video(item["video"])
            y, clip_feat = enc.images(cond_frames, item["random_ref_frame"], args,
                                      use_first_aug=args.use_first_aug,
                                      ref_pad_cfg=args.ref_pad_cfg)
            return dict(latents=latents, context=ctx, y=y, clip_feature=clip_feat)
        return encode

    record = train_loop(args, trainer, ds, plan_sample, device, rng, mesh)
    record["seconds"].update(enc.seconds)
    return dict(record, trainer=trainer, dataset=ds, encoders=enc)


if __name__ == "__main__":
    main()
