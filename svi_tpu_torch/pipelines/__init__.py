"""Inference pipelines of the port: the SVI video pipelines (shot / film,
dance, talk), the Wan pipelines (UniAnimate, replace-anyone) and the
image / video zoo (SD 1.5, SDXL, SD3, FLUX, Kolors through the SDXL
pipelines, SVD, Hunyuan-DiT, HunyuanVideo, CogVideoX, StepVideo, OmniGen).
svi_tpu's exports, imported at first access; svi_tpu's `model_fn_wan_video`
is the method `SVIVideoPipeline.denoising_model`."""

from .._exports import lazy_exports

_EXPORTS = {
    "SVDVideoPipeline": "svd_video",
    "HunyuanVideoPipeline": "hunyuan_video",
    "CogVideoPipeline": "cog_video",
    "HunyuanDiTImagePipeline": "hunyuan_image",
    "HunyuanTextEncoderWrapper": "hunyuan_image",
    "FluxImagePipeline": "flux_image",
    "FluxPrompter": "flux_image",
    "SDImagePipeline": "sd_image",
    "SDPrompter": "sd_image",
    "SDVideoPipeline": "sd_video",
    "denoise_long_video": "sd_video",
    "SD3ImagePipeline": "sd3_image",
    "SD3Prompter": "sd3_image",
    "SDXLImagePipeline": "sdxl_image",
    "SDXLPrompter": "sdxl_image",
    "SDXLVideoPipeline": "sdxl_video",
    "SVIVideoPipeline": "svi_video",
    "SVIDanceVideoPipeline": "svi_video_dance",
    "SVITalkVideoPipeline": "svi_video_talk",
    "WanVideoPipeline": "wan_video",
    "TeaCache": "svi_video",
    "WanUniAnimateVideoPipeline": "wan_video",
    "WanUniAnimateLongVideoPipeline": "wan_video",
    "WanRepalceAnyoneVideoPipeline": "wan_video",
    "StepVideoPipeline": "step_video",
    "OmnigenImagePipeline": "omnigen_image",
    "SDVideoPipelineRunner": "pipeline_runner",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
