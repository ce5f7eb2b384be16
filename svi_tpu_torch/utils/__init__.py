"""Host utilities of the port: safetensors files, prompt files, reference
images, pose and audio inputs, video input and output, and the prompt
expander's helpers (Qwen-VL inputs, VACE preprocessing). svi_tpu's exports
(its modules), imported at first access."""

from .._exports import lazy_exports

_EXPORTS = {
    "audio": "audio",
    "image_process": "image_process",
    "prompt_files": "prompt_files",
    "video": "video",
    "safetensors_io": "safetensors_io",
    "qwen_vl": "qwen_vl",
    "prompt_extend": "prompt_extend",
    "vace_processor": "vace_processor",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
