"""Error-Recycling LoRA training (port of svi_tpu/training): adapters,
host-side error buffers and the trainer."""

from .error_recycling import ErrorBuffers
from .trainer import ErrorRecyclingTrainer, TrainerConfig

__all__ = ["ErrorBuffers", "ErrorRecyclingTrainer", "TrainerConfig"]
