"""Training of the port: Error-Recycling LoRA training of the Wan DiT
(adapters, host-side error buffers, the trainer) and text-to-image LoRA
training of the SD / SDXL UNets (`text_to_image`). svi_tpu's exports,
imported at first access; svi_tpu's `make_train_step` is the trainer's
method `ErrorRecyclingTrainer.train_step`."""

from .._exports import lazy_exports

_EXPORTS = {
    "dataset": "dataset",
    "error_recycling": "error_recycling",
    "lora": "lora",
    "trainer": "trainer",
    "text_to_image": "text_to_image",
    "ErrorBuffers": "error_recycling",
    "ErrorRecyclingTrainer": "trainer",
    "TrainerConfig": "trainer",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
