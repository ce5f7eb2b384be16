"""The SVI gradio demo on the card, port of scripts/gradio_demo.py: the
film / shot modes, `SVIGradioDemo` (mode switch, demo content, model
loading through the port's ModelManager and
`SVIVideoPipeline.from_model_manager(..., is_test=True)`, the four prompt
formats, per-clip streaming of the cumulative video with
`generation_info.json`, and the UI wrapper that yields status HTML), and
`create_demo` / `main`, which need gradio (imported inside `create_demo`;
neither this package's test machine nor the card's has it).

    python -m svi_tpu_torch.scripts.gradio_demo --dit_root <Wan2.1-I2V-14B-480P dir> \
        --mode film --save_format mp4

Everything up to `create_demo` runs without gradio: `SVIGradioDemo(dit_root,
device="cpu")` here, the card by default. The reference image is a PIL
image, an (H, W, 3) uint8 array, or a path (`.npy`, or an image file Pillow
opens); it is resized as Pillow's bicubic resize does, in numpy
(`utils.image_process.resize_uint8`), so no Pillow is needed on the card.
Videos are mp4 (`--save_format mp4`, through imageio or OpenCV) or `.npy`
(T, H, W, 3) uint8 arrays (`--save_format npy`, for a machine with no video
writer, such as the card's).
"""

import argparse
import json
import os
from datetime import datetime

import numpy as np
import torch

MODEL_MODES = {
    "film": {
        "name": "SVI-Film (1 text prompt stream)",
        "description": ("Suitable for cinematic narratives, storylines and "
                        "long continuous shots"),
        "lora_path": "weights/Stable-Video-Infinity/version-1.0/svi-film.safetensors",
        "demo_image": "data/toy_test/film/frame.jpg",
        "demo_prompts": "data/toy_test/film/prompt.txt",
        "num_motion_frames": 5,
        "ref_pad_num": 0,
        "use_first_prompt_only": False,
    },
    "shot": {
        "name": "SVI-Shot (1 text prompt)",
        "description": "Suitable for camera movements, dynamic shooting effects",
        "lora_path": "weights/Stable-Video-Infinity/version-1.0/svi-shot.safetensors",
        "demo_image": "data/toy_test/shot/frame.jpg",
        "demo_prompts": "data/toy_test/shot/prompt.txt",
        "num_motion_frames": 1,
        "ref_pad_num": -1,
        "use_first_prompt_only": True,
    },
}

NEGATIVE = (
    "bright tones, overexposed, static, blurred details, subtitles, style, works, "
    "paintings, images, static, overall gray, worst quality, low quality, JPEG "
    "compression residue, ugly, incomplete, extra fingers, poorly drawn hands, "
    "poorly drawn faces, deformed, disfigured, misshapen limbs, fused fingers, "
    "still picture, messy background, three legs, many people in the background, "
    "walking backwards"
)

# single-prompt starters shown next to the prompt box
EXAMPLE_PROMPTS = [
    "Low evening sun paints a golden trail across a calm sea.",
    "Rain streaks down a window while city lights blur behind it.",
    "A hot-air balloon drifts over patchwork fields at dawn.",
    "Snow settles silently on pine branches in a quiet forest.",
    "A lighthouse beam sweeps across a foggy harbor at night.",
]

# multi-clip prompt-stream examples in each supported input format
# (newline, Python list, comma)
STREAMING_EXAMPLES = [
    "Waves roll onto the beach,\nFoam slides back into the sea,\nGulls bank over the surf",
    "A kettle steams on the stove,\nThe steam curls toward the ceiling,\nA cup is filled with tea",
    '["A fox trots along a snowy ridge", "The fox stops and pricks its ears", '
    '"The fox pounces into the snow", "The fox surfaces with snow on its muzzle", '
    '"The fox continues along the ridge at dusk"]',
    "A paper boat floats down a gutter stream, It spins around a leaf, "
    "It slips under a small bridge",
]


def _reference_frame(input_image) -> np.ndarray:
    """The reference image as an (H, W, 3) uint8 array: a PIL image (RGB
    converted), an array, or a path (`.npy`, else Pillow opens it)."""
    if isinstance(input_image, (str, os.PathLike)):
        path = os.fspath(input_image)
        if path.endswith(".npy"):
            input_image = np.load(path)
        else:
            from PIL import Image

            input_image = Image.open(path)
    if hasattr(input_image, "convert"):  # a PIL image
        input_image = input_image.convert("RGB")
    arr = np.asarray(input_image)
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
        raise ValueError(f"reference image {arr.shape} {arr.dtype}: expected (H, W, 3) uint8")
    return arr


class SVIGradioDemo:
    def __init__(self, dit_root, output_dir="videos/gradio", mode="film", device="cuda",
                 save_format="mp4"):
        if save_format not in ("mp4", "npy"):
            raise ValueError(f"save_format {save_format!r}: expected 'mp4' or 'npy'")
        self.dit_root = dit_root
        self.output_dir = output_dir
        self.mode = mode
        self.device = torch.device(device)
        self.save_format = save_format
        self.pipe = None

    # -- mode management -------------------------------------------------------

    def switch_model_mode(self, mode):
        """Switch mode, drop the loaded pipeline (the LoRA differs per mode),
        and return a status message."""
        if mode not in MODEL_MODES:
            return f"unknown mode: {mode}"
        self.mode = mode
        self.pipe = None  # force re-init with the mode's LoRA
        cfg = MODEL_MODES[mode]
        return (f"switched to {cfg['name']} — {cfg['description']}. "
                "Click 'Initialize models' to reload.")

    def get_demo_content_for_mode(self, mode=None):
        """Demo image path + prompt stream of a mode, from the repository's
        toy assets (None and "" where they are absent)."""
        cfg = MODEL_MODES[mode or self.mode]
        image = cfg["demo_image"] if os.path.exists(cfg["demo_image"]) else None
        prompts = ""
        if os.path.exists(cfg["demo_prompts"]):
            from ..utils.prompt_files import load_prompts_from_file

            prompts = "\n".join(load_prompts_from_file(cfg["demo_prompts"]))
        return image, prompts

    def get_current_mode_config(self):
        return MODEL_MODES[self.mode]

    # -- model loading -----------------------------------------------------------

    def initialize_models(self, mode=None):
        """The DiT (`diffusion_pytorch_model*.safetensors` shards under
        dit_root, else the directory), umT5, the VAE and CLIP where their
        files are, the mode's LoRA where it exists, onto `device` in bf16;
        then the pipeline and the tokenizer under `google/umt5-xxl`."""
        import glob

        from ..models.model_io import ModelManager
        from ..pipelines.svi_video import SVIVideoPipeline

        if mode is not None:
            self.mode = mode
        cfg = MODEL_MODES[self.mode]
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the demo runs on the card "
                               "(SVIGradioDemo(..., device='cpu') runs it on the CPU)")
        mm = ModelManager(torch_dtype=torch.bfloat16, device=self.device)
        shards = sorted(glob.glob(os.path.join(self.dit_root,
                                               "diffusion_pytorch_model*.safetensors")))
        paths = [shards if shards else self.dit_root]
        for name in ("models_t5_umt5-xxl-enc-bf16.pth", "Wan2.1_VAE.pth",
                     "models_clip_open-clip-xlm-roberta-large-vit-huge-14.pth"):
            fp = os.path.join(self.dit_root, name)
            if os.path.exists(fp):
                paths.append(fp)
        mm.load_models(paths)
        if os.path.exists(cfg["lora_path"]):
            mm.load_lora_v2(cfg["lora_path"], lora_alpha=1.0)
        self.pipe = SVIVideoPipeline.from_model_manager(mm, torch_dtype=torch.bfloat16,
                                                        device=self.device, is_test=True)
        tok = os.path.join(self.dit_root, "google/umt5-xxl")
        if os.path.isdir(tok):
            self.pipe.prompter.fetch_tokenizer(tok)
        return f"initialized {cfg['name']}"

    # -- prompt handling -----------------------------------------------------------

    @staticmethod
    def parse_prompts(prompts_text):
        """A Python-literal list, else one prompt per line, else comma-separated,
        else a single prompt."""
        import ast

        text = (prompts_text or "").strip()
        if text.startswith("[") and text.endswith("]"):
            try:
                parsed = ast.literal_eval(text)
                if isinstance(parsed, list):
                    out = [str(p).strip() for p in parsed if str(p).strip()]
                    if out:
                        return out
            except (ValueError, SyntaxError):
                pass
        if "\n" in text:
            return [line.strip() for line in text.split("\n") if line.strip()]
        if "," in text:
            return [p.strip() for p in text.split(",") if p.strip()]
        return [text] if text else []

    # -- generation ------------------------------------------------------------------

    def _save(self, frames, stem):
        """Write frames as `stem.mp4` or `stem.npy`; returns the path."""
        from ..utils.video import save_frames_npy, save_video

        path = f"{stem}.{self.save_format}"
        if self.save_format == "npy":
            save_frames_npy(frames, path)
        else:
            save_video(frames, path, fps=16, quality=8)
        return path

    def generate_video(self, input_image, prompts_text, negative_prompt=NEGATIVE,
                       num_clips=3, num_steps=50, cfg_scale_text=5.0, seed=42,
                       num_frames=81, max_width=832, num_motion_frames=None):
        """Per-clip streaming generation: yields (status, cumulative video
        path) after every clip; each clip also gets its own preview file and
        every cumulative stage its own file inside a timestamped session dir,
        then generation_info.json. Clip i's seed is i * the base seed (a
        random base for seed < 0), as the driver's.

        max_width / num_motion_frames override the mode defaults."""
        from ..utils.image_process import calculate_dimensions, resize_uint8

        cfg = MODEL_MODES[self.mode]
        frame = _reference_frame(input_image)
        prompts = self.parse_prompts(prompts_text) or ["a video"]

        height, width = calculate_dimensions(frame, max_width=int(max_width))
        ref = resize_uint8(frame, width, height)
        ref_gt = ref
        nmf = int(num_motion_frames or cfg["num_motion_frames"])
        motion = [ref] * nmf if nmf > 1 else ref

        ts = datetime.now().strftime("%Y%m%d_%H%M%S")
        session_dir = os.path.join(self.output_dir, f"session_{ts}")
        os.makedirs(session_dir, exist_ok=True)
        # the UI's -1 means "random base"
        seed = int(seed) if seed is not None else 42
        seed_times = int(np.random.default_rng().integers(1, 10000)) if seed < 0 else seed

        video_list = []
        cumulative_path = None
        for clip_idx in range(int(num_clips)):
            prompt = (prompts[0] if cfg["use_first_prompt_only"]
                      else prompts[clip_idx % len(prompts)])
            video = self.pipe(
                prompt=prompt, negative_prompt=negative_prompt,
                input_image=motion, num_frames=num_frames,
                num_inference_steps=int(num_steps),
                cfg_scale=dict(text=float(cfg_scale_text)),
                seed=clip_idx * seed_times,
                tiled=False, random_ref_frame=ref_gt,
                height=height, width=width, ref_pad_num=cfg["ref_pad_num"],
            )
            self._save(video, os.path.join(session_dir, f"clip_{clip_idx + 1:03d}_preview"))
            motion = video[-nmf:]
            if clip_idx < num_clips - 1:
                video_list += video[:-nmf]
            else:
                video_list += video
            cumulative_path = self._save(
                video_list, os.path.join(session_dir, f"cumulative_clips_1_to_{clip_idx + 1}"))
            yield (f"clip {clip_idx + 1}/{num_clips} done "
                   f"({len(video_list)} frames)"), cumulative_path

        with open(os.path.join(session_dir, "generation_info.json"), "w") as f:
            json.dump({
                "timestamp": ts, "mode": self.mode, "num_clips": int(num_clips),
                "prompts": prompts, "seed": seed, "num_steps": int(num_steps),
                "cfg_scale": float(cfg_scale_text),
                "num_motion_frames": nmf,
                "video_dimensions": f"{width}x{height}",
                "cumulative_videos": [
                    f"cumulative_clips_1_to_{i + 1}.{self.save_format}"
                    for i in range(int(num_clips))
                ],
            }, f, indent=2)
        yield f"done — {len(video_list)} frames in {session_dir}", cumulative_path

    def generate_video_with_preview(self, input_image, prompts_text,
                                    negative_prompt, num_clips, num_steps,
                                    cfg_scale_text, seed, max_width=832,
                                    num_motion_frames=None):
        """UI wrapper: yields (video_path, status_html); the video updates per
        clip, the status carries progress, validation and error text."""
        if self.pipe is None:
            yield None, _status_html("Initialize the models first", error=True)
            return
        if input_image is None:
            yield None, _status_html("Upload a reference image first", error=True)
            return
        if not (prompts_text or "").strip():
            yield None, _status_html("Enter at least one prompt", error=True)
            return
        yield None, _status_html("Starting generation...")
        try:
            for status, path in self.generate_video(
                    input_image, prompts_text, negative_prompt, num_clips,
                    num_steps, cfg_scale_text, seed,
                    max_width=max_width, num_motion_frames=num_motion_frames):
                if path and not os.path.exists(path):
                    yield None, _status_html(f"missing output file: {path}", error=True)
                    continue
                yield path, _status_html(status)
        except Exception as ex:  # surface errors in the UI instead of dying
            import traceback

            traceback.print_exc()
            yield None, _status_html(f"{type(ex).__name__}: {ex}", error=True)


def _status_html(text, error=False):
    color = "#dc2626" if error else "#334155"
    return (f"<div style='text-align:center;padding:8px;color:{color};"
            f"font-size:15px'>{text}</div>")


USAGE_MD = """\
## How to use

**Modes** — *SVI-Film* carries 5 motion frames between clips and walks through
your prompt stream clip by clip (narratives, long takes); *SVI-Shot* carries 1
motion frame and repeats the first prompt (camera moves). Switching modes
reloads the matching LoRA — click *Initialize models* again after a switch.

**Prompts** accept three formats: one prompt per line, a Python list
(`["first", "second"]`), or comma-separated. Clips cycle through the list.

**Outputs** — every clip is written as its own preview mp4 and every
cumulative stage as `cumulative_clips_1_to_N.mp4` inside
`videos/gradio/session_YYYYMMDD_HHMMSS/`, together with
`generation_info.json` provenance; the player updates as each clip lands.
"""


def create_demo(demo: SVIGradioDemo):
    try:
        import gradio as gr
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "the web demo needs gradio (`pip install gradio`); the generation "
            "core (SVIGradioDemo.generate_video) works without it"
        ) from e

    demo_image, demo_prompts = demo.get_demo_content_for_mode(demo.mode)
    streaming_examples = STREAMING_EXAMPLES + ([demo_prompts] if demo_prompts else [])
    mode_choices = [(MODEL_MODES[m]["name"], m) for m in MODEL_MODES]

    with gr.Blocks(title="SVI: Stable Video Infinity",
                   theme=gr.themes.Soft()) as ui:
        gr.Markdown("# SVI — infinite-length video generation\n"
                    "Per-clip streaming with motion-frame recycling; each clip "
                    "plays as soon as it is generated.")
        with gr.Row():
            with gr.Column(scale=1):
                gr.Markdown("## Controls")
                with gr.Row():
                    mode = gr.Dropdown(mode_choices, value=demo.mode,
                                       label="Model mode",
                                       info=MODEL_MODES[demo.mode]["description"])
                    mode_switch_btn = gr.Button("Switch mode", size="sm")
                mode_status = gr.Textbox(
                    label="Mode status", interactive=False, lines=2,
                    value=(f"Current: {MODEL_MODES[demo.mode]['name']} — "
                           f"{MODEL_MODES[demo.mode]['description']}"))
                init_btn = gr.Button("Initialize models", variant="primary")
                init_status = gr.Textbox(label="Model status", interactive=False,
                                         value="Click 'Initialize models' to start")
                image = gr.Image(label="Reference image", type="pil",
                                 value=demo_image, height=320)
                load_demo_btn = gr.Button("Load demo example", size="sm")
                prompts = gr.Textbox(
                    label="Prompts (multi-format)", lines=8,
                    value=demo_prompts or "",
                    placeholder=("one prompt per line\n"
                                 "or a Python list: [\"first\", \"second\"]\n"
                                 "or comma-separated"),
                    info="newlines, Python lists, or commas — clips cycle through")
                example_dropdown = gr.Dropdown(
                    choices=streaming_examples, value=None,
                    label="Prompt-stream examples")
                single_example_dropdown = gr.Dropdown(
                    choices=EXAMPLE_PROMPTS, value=None,
                    label="Single-prompt examples")
                negative = gr.Textbox(label="Negative prompt", value=NEGATIVE,
                                      lines=2)
                gr.Markdown("## Generation settings")
                with gr.Row():
                    num_clips = gr.Slider(1, 30, value=3, step=1, label="Clips",
                                          info="more clips = longer video")
                    num_steps = gr.Slider(1, 100, value=50, step=1,
                                          label="Denoise steps")
                with gr.Row():
                    cfg_text = gr.Slider(1.0, 10.0, value=5.0, step=0.5,
                                         label="CFG (text)")
                    seed = gr.Number(value=-1, precision=0,
                                     label="Seed (-1 = random)")
                with gr.Row():
                    max_width = gr.Slider(320, 1280, value=832, step=16,
                                          label="Max width (px)",
                                          info="height follows the image aspect")
                    motion_frames = gr.Slider(0, 8, value=0, step=1,
                                              label="Motion frames (0 = mode default)")
                gen_btn = gr.Button("Generate streaming video",
                                    variant="primary", size="lg")
            with gr.Column(scale=1):
                gr.Markdown("## Output")
                video_out = gr.Video(label="Video (updates per clip)",
                                     height=480, autoplay=True,
                                     show_download_button=True,
                                     format=demo.save_format)
                video_status = gr.HTML(value=_status_html("Ready"))
                gr.Markdown(USAGE_MD)

        # -- events ------------------------------------------------------------
        def switch_mode_and_load_demo(m):
            status = demo.switch_model_mode(m)
            img, pr = demo.get_demo_content_for_mode(m)
            return status, img, pr or ""

        mode_switch_btn.click(switch_mode_and_load_demo, inputs=[mode],
                              outputs=[mode_status, image, prompts])
        load_demo_btn.click(
            lambda: demo.get_demo_content_for_mode(demo.mode),
            outputs=[image, prompts])
        example_dropdown.change(lambda ex: ex or "", inputs=[example_dropdown],
                                outputs=[prompts])
        single_example_dropdown.change(
            lambda ex: ex or "", inputs=[single_example_dropdown],
            outputs=[prompts])
        init_btn.click(demo.initialize_models, inputs=[mode],
                       outputs=[init_status])

        def _gen(img, pr, neg, nc, ns, cfgt, sd, mw, mf):
            yield from demo.generate_video_with_preview(
                img, pr, neg, nc, ns, cfgt, sd, max_width=mw,
                num_motion_frames=int(mf) or None)

        gen_btn.click(
            _gen,
            inputs=[image, prompts, negative, num_clips, num_steps, cfg_text,
                    seed, max_width, motion_frames],
            outputs=[video_out, video_status],
        )
    return ui


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dit_root", type=str, default="weights/Wan2.1-I2V-14B-480P/")
    p.add_argument("--output", type=str, default="videos/gradio")
    p.add_argument("--mode", type=str, default="film", choices=list(MODEL_MODES))
    p.add_argument("--server_port", type=int, default=7860)
    p.add_argument("--share", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--save_format", type=str, default="mp4", choices=["mp4", "npy"])
    args = p.parse_args(argv)
    demo = SVIGradioDemo(args.dit_root, args.output, args.mode, device=args.device,
                         save_format=args.save_format)
    ui = create_demo(demo)
    ui.launch(server_port=args.server_port, share=args.share)


if __name__ == "__main__":
    main()
