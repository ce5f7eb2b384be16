"""Config-driven video style transfer, port of
svi_tpu/pipelines/pipeline_runner.py: `SDVideoPipelineRunner.run(config)`
reads a JSON-like config with `models` (the checkpoint list, a
textual-inversion folder, LoRA alphas, ControlNet units, the device),
`data` (the input video or image folder with its window and size, the
ControlNet frame streams, the output folder, fps) and `pipeline` (the seed
and the pipeline's inputs), renders through `SDVideoPipeline`, applies the
smoother chain, and writes the frames (PNG), the video and the provenance
`config.json` (the frame lists emptied).

The video is an mp4 (through imageio or OpenCV) unless `data.save_format`
is "npy": then `video.npy`, (N, H, W, 3) uint8, for machines without a
video writer. `models.lora_alphas` is read nowhere, as in the JAX package.
The models load on `models.device`, else on the runner's device (the card
unless the caller names the CPU).
"""

from __future__ import annotations

import json
import os

from ..models.controlnets import ControlNetConfigUnit
from ..models.model_io import ModelManager
from ..processors.sequencial_processor import SequencialProcessor
from ..utils.video import VideoData, save_frames, save_frames_npy, save_video
from .sd_video import SDVideoPipeline


class SDVideoPipelineRunner:
    def __init__(self, in_streamlit=False, device="cuda"):
        self.in_streamlit = in_streamlit
        self.device = device

    def load_pipeline(self, model_list, textual_inversion_folder, device=None, lora_alphas=(),
                      controlnet_units=()):
        model_manager = ModelManager(device=device or self.device)
        model_manager.load_models(model_list)
        pipe = SDVideoPipeline.from_model_manager(
            model_manager,
            [ControlNetConfigUnit(processor_id=unit["processor_id"],
                                  model_path=unit["model_path"], scale=unit["scale"])
             for unit in controlnet_units])
        ti_paths = []
        if textual_inversion_folder and os.path.isdir(textual_inversion_folder):
            for file_name in sorted(os.listdir(textual_inversion_folder)):
                if file_name.endswith((".pt", ".bin", ".pth", ".safetensors")):
                    ti_paths.append(os.path.join(textual_inversion_folder, file_name))
        if ti_paths:
            pipe.prompter.load_textual_inversions(ti_paths)
        return model_manager, pipe

    def load_smoother(self, model_manager, smoother_configs):
        return SequencialProcessor.from_model_manager(model_manager, smoother_configs)

    def synthesize_video(self, model_manager, pipe, seed, smoother, **pipeline_inputs):
        return pipe(**pipeline_inputs, smoother=smoother, seed=seed)

    def load_video(self, video_file=None, image_folder=None, height=None, width=None,
                   start_frame_id=None, end_frame_id=None):
        video = VideoData(video_file=video_file, image_folder=image_folder, height=height,
                          width=width)
        start_frame_id = 0 if start_frame_id is None else start_frame_id
        end_frame_id = len(video) if end_frame_id is None else end_frame_id
        return [video[i] for i in range(start_frame_id, end_frame_id)]

    def add_data_to_pipeline_inputs(self, data, pipeline_inputs):
        pipeline_inputs["input_frames"] = self.load_video(**data["input_frames"])
        pipeline_inputs["num_frames"] = len(pipeline_inputs["input_frames"])
        pipeline_inputs["height"], pipeline_inputs["width"] = \
            pipeline_inputs["input_frames"][0].shape[:2]
        if len(data.get("controlnet_frames", [])) > 0:
            pipeline_inputs["controlnet_frames"] = [self.load_video(**unit)
                                                    for unit in data["controlnet_frames"]]
        return pipeline_inputs

    def save_output(self, video, output_folder, fps, config, save_format="mp4"):
        os.makedirs(output_folder, exist_ok=True)
        save_frames(video, os.path.join(output_folder, "frames"))
        if save_format == "npy":
            save_frames_npy(video, os.path.join(output_folder, "video.npy"))
        else:
            save_video(video, os.path.join(output_folder, "video.mp4"), fps=fps)
        config["pipeline"]["pipeline_inputs"]["input_frames"] = []
        config["pipeline"]["pipeline_inputs"]["controlnet_frames"] = []
        with open(os.path.join(output_folder, "config.json"), "w") as f:
            json.dump(config, f, indent=4)

    def run(self, config):
        config["pipeline"]["pipeline_inputs"] = self.add_data_to_pipeline_inputs(
            config["data"], config["pipeline"]["pipeline_inputs"])
        model_manager, pipe = self.load_pipeline(**config["models"])
        smoother = (self.load_smoother(model_manager, config["smoother_configs"])
                    if "smoother_configs" in config else None)
        output_video = self.synthesize_video(model_manager, pipe, config["pipeline"]["seed"],
                                             smoother, **config["pipeline"]["pipeline_inputs"])
        self.save_output(output_video, config["data"]["output_folder"], config["data"]["fps"],
                         config, config["data"].get("save_format", "mp4"))
        return output_video
