"""Config-driven smoother chains, port of
svi_tpu/processors/sequencial_processor.py (the reference's spelling kept).

FastBlend and RIFE are the extensions (ROADMAP.md, Queue 1: extensions/),
not ported yet: naming them raises NotImplementedError.
"""

from .base import VideoProcessor


class AutoVideoProcessor(VideoProcessor):
    @staticmethod
    def from_model_manager(model_manager, processor_type, **kwargs):
        if processor_type in ("FastBlend", "RIFE"):
            raise NotImplementedError(
                f"the {processor_type} smoother is not ported yet (ROADMAP.md, Queue 1: "
                "extensions/, FastBlend and RIFE first)")
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
