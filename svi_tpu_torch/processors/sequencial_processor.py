"""Config-driven smoother chains, port of
svi_tpu/processors/sequencial_processor.py (the reference's spelling kept).
FastBlend and RIFE are the smoothers of `extensions/`; RIFE takes its IFNet
weights from the model manager.
"""

from .base import VideoProcessor


class AutoVideoProcessor(VideoProcessor):
    @staticmethod
    def from_model_manager(model_manager, processor_type, **kwargs):
        if processor_type == "FastBlend":
            from ..extensions.fastblend import FastBlendSmoother

            return FastBlendSmoother.from_model_manager(model_manager, **kwargs)
        if processor_type == "RIFE":
            from ..extensions.rife import RIFESmoother

            return RIFESmoother.from_model_manager(model_manager, **kwargs)
        if processor_type == "Contrast":
            from .pil_editor import ContrastEditor

            return ContrastEditor.from_model_manager(model_manager, **kwargs)
        if processor_type == "Sharpness":
            from .pil_editor import SharpnessEditor

            return SharpnessEditor.from_model_manager(model_manager, **kwargs)
        raise ValueError(f"invalid processor_type: {processor_type}")


class SequencialProcessor(VideoProcessor):
    """Runs its processors in order."""

    def __init__(self, processors=()):
        self.processors = list(processors)

    @staticmethod
    def from_model_manager(model_manager, configs):
        return SequencialProcessor([
            AutoVideoProcessor.from_model_manager(model_manager, config["processor_type"],
                                                  **config["config"])
            for config in configs])

    def __call__(self, rendered_frames, **kwargs):
        for processor in self.processors:
            rendered_frames = processor(rendered_frames, **kwargs)
        return rendered_frames
