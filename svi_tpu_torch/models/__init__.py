"""Models of the port: the Wan DiT and VAE, CLIP, umT5, the pose and audio
towers, and the image / video zoo (SD 1.5, SDXL, SD3, FLUX, Kolors, SVD,
Hunyuan-DiT, HunyuanVideo, CogVideoX, StepVideo, OmniGen) with the model
manager. svi_tpu's exports (each module, `ModelManager`), imported at first
access; svi_tpu's `downloader` is not ported (nothing downloads here)."""

from .._exports import lazy_exports

_EXPORTS = {
    "clip_vision": "clip_vision",
    "cog": "cog",
    "controlnets": "controlnets",
    "flux": "flux",
    "ipadapter": "ipadapter",
    "motion": "motion",
    "hunyuan_dit": "hunyuan_dit",
    "hunyuan_video": "hunyuan_video",
    "model_io": "model_io",
    "sd": "sd",
    "sd3": "sd3",
    "sdxl": "sdxl",
    "svd": "svd",
    "t5": "t5",
    "tiler": "tiler",
    "wan_dit": "wan_dit",
    "wan_vae": "wan_vae",
    "kolors": "kolors",
    "omnigen": "omnigen",
    "stepvideo": "stepvideo",
    "stepvideo_vae": "stepvideo_vae",
    "unianimate": "unianimate",
    "pose_embedding": "pose_embedding",
    "wav2vec2": "wav2vec2",
    "params": "params",
    "ModelManager": "model_io",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
