"""Video post-processors (smoothers) of the SD video pipeline: the Pillow
enhancement editors in numpy and the config-driven chain."""

from .base import VideoProcessor
from .pil_editor import ContrastEditor, SharpnessEditor
from .sequencial_processor import AutoVideoProcessor, SequencialProcessor

__all__ = ["VideoProcessor", "ContrastEditor", "SharpnessEditor", "AutoVideoProcessor",
           "SequencialProcessor"]
