"""The port's public signatures against svi_tpu's.

For every module of svi_tpu_torch that has a counterpart of the same path in
svi_tpu, each public function and class defined there (and each public
method, `__init__` and `__call__` of those classes) is compared with
`inspect.signature`: the parameters' names, order, kinds and whether they
have a default (default values differ in type: torch against JAX dtypes).
A name svi_tpu defines and the port lacks is a difference too.

Every difference left must be on ALLOWED with its reason, every ALLOWED
entry must still be a difference, and every entry is named in ROADMAP.md
("Signature divergences"), so that none is kept unrecorded.
"""

import importlib
import inspect
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

DEVICE = ("recorded divergence: the port places what it builds or loads with `device` (the card "
          "by default) and a torch `dtype`, after svi_tpu's own arguments")
DEVICE_BEFORE = ("recorded divergence: `device` (the card by default) comes before an argument "
                 "svi_tpu has there; pass that one by keyword")
KEY = ("JAX-only: `key` (a JAX PRNG key); the port seeds with `seed` or a torch `generator` and "
       "places with `device`")
MODULE = ("recorded divergence: the port's models are `nn.Module`s (ParamTree), passed where "
          "svi_tpu passes a params pytree or a (params, cfg) pair; the argument is named for the "
          "model, without `_params`")
METHOD = ("recorded divergence: the function is a method of the port's model module (the "
          "`nn.Module` carries its cfg), e.g. `WanDiT.forward_blocks`, `WanVAE.encode`")
JAX_XLA = "JAX-only: `force_xla` / `save_tag` choose XLA paths and remat tags"
JAX_DEVICES = "JAX-only: `devices`, a JAX device list; the port's meshes are process groups"
JAX_ONLY = "JAX-only: XLA's compilation cache, pytree registration or a jnp helper"
CONSUME = ("recorded divergence: `consume` frees the float weights as their quantized copies "
           "are made, so the 14B fits the card")
BF16_AS = ("JAX-only: `bf16_as`, the numpy dtype svi_tpu stages bf16 tensors in; the port reads "
           "bf16 as torch bf16")
UNIANIMATE = ("recorded divergence: the three UniAnimate side stacks are `ConvStack` modules made "
              "by `init_params(kind, ...)` / `params_from_jax(kind, ...)`, run by calling them")

ALLOWED = {
    "__init__.py:enable_compilation_cache": JAX_ONLY,
    "dwpose/wholebody.py:Wholebody.__init__": DEVICE,
    "extensions/esrgan.py:init_params": KEY,
    "extensions/esrgan.py:params_from_torch_state_dict": DEVICE,
    "extensions/fastblend.py:PyramidPatchMatcher.__init__": DEVICE_BEFORE,
    "extensions/fastblend.py:FastBlendSmoother.__init__": DEVICE,
    "extensions/image_quality.py:score_mlp_params_from_torch": DEVICE,
    "extensions/quality_towers.py:clip_params_from_hf": DEVICE,
    "extensions/quality_towers.py:clip_params_from_open_clip": DEVICE,
    "extensions/quality_towers.py:blip_params_from_torch": DEVICE,
    "extensions/quality_towers.py:cross_model_params_from_torch": DEVICE,
    "extensions/rife.py:init_params": KEY,
    "extensions/rife.py:params_from_torch_state_dict": DEVICE,
    "models/clip_vision.py:ClipVisionConfig.__init__": (
        "recorded divergence: the port's ViT-H/14 runs plain GELU only (svi_tpu's "
        "`activation` field is 'gelu' for it)"),
    "models/clip_vision.py:forward_tokens": METHOD,
    "models/clip_vision.py:encode_image": METHOD,
    "models/clip_vision.py:init_params": KEY,
    "models/clip_vision.py:params_from_torch_state_dict": DEVICE,
    "models/cog.py:cog_dit_params_from_torch": DEVICE,
    "models/cog.py:cog_vae_encoder_params_from_torch": DEVICE,
    "models/cog.py:cog_vae_decoder_params_from_torch": DEVICE,
    "models/controlnets.py:sd_controlnet_params_from_torch": DEVICE,
    "models/controlnets.py:sdxl_controlnet_params_from_torch": DEVICE,
    "models/flux.py:flux_dit_params_from_torch": DEVICE,
    "models/flux.py:flux_vae_encoder_params_from_torch": DEVICE,
    "models/flux.py:flux_vae_decoder_params_from_torch": DEVICE,
    "models/flux.py:flux_controlnet_params_from_torch": DEVICE,
    "models/flux.py:flux_ipadapter_params_from_torch": DEVICE,
    "models/hunyuan_dit.py:hunyuan_dit_params_from_torch": DEVICE,
    "models/hunyuan_video.py:hunyuan_video_dit_params_from_torch": DEVICE,
    "models/hunyuan_video.py:hunyuan_video_vae_decoder_params_from_torch": DEVICE,
    "models/hunyuan_video.py:hunyuan_video_vae_encoder_params_from_torch": DEVICE,
    "models/ipadapter.py:ipadapter_kv": (
        "recorded divergence: the IP-Adapter's token count is a constant argument "
        "(`n_tokens`), not a leaf of its params"),
    "models/ipadapter.py:clip_image_encoder_params_from_torch": DEVICE,
    "models/ipadapter.py:ipadapter_params_from_torch": (
        "recorded divergence: `n_tokens` is passed to `ipadapter_kv`, not stored; `device` / "
        "`dtype` place the weights"),
    "models/kolors.py:chatglm_params_from_torch": DEVICE,
    "models/model_io.py:load_state_dict": BF16_AS,
    "models/model_io.py:load_state_dicts": BF16_AS,
    "models/model_io.py:fuse_lora_into_dit_params": (
        "recorded divergence: the port fuses LoRA into the DiT module in place "
        "(`fuse_lora_into_dit`)"),
    "models/motion.py:motion_params_from_torch": DEVICE,
    "models/omnigen.py:omnigen_params_from_torch": DEVICE,
    "models/pose_embedding.py:init_params": KEY,
    "models/pose_embedding.py:params_from_torch_state_dict": DEVICE_BEFORE,
    "models/pose_embedding.py:forward": METHOD,
    "models/sd.py:sd_text_encoder_forward": (
        "recorded divergence: `token_embedding` takes a table extended by textual-inversion "
        "rows"),
    "models/sd.py:sd_unet_params_from_torch": DEVICE,
    "models/sd.py:sd_vae_encoder_params_from_torch": DEVICE,
    "models/sd.py:sd_vae_decoder_params_from_torch": DEVICE,
    "models/sd.py:sd_text_encoder_params_from_torch": DEVICE,
    "models/sd3.py:sd3_dit_params_from_torch": DEVICE,
    "models/sd3.py:sd3_vae_encoder_params_from_torch": DEVICE,
    "models/sd3.py:sd3_vae_decoder_params_from_torch": DEVICE,
    "models/sdxl.py:sdxl_unet_params_from_torch": DEVICE,
    "models/sdxl.py:sdxl_text_encoder_params_from_torch": DEVICE,
    "models/sdxl.py:sdxl_text_encoder_2_params_from_torch": DEVICE,
    "models/stepvideo.py:stepvideo_dit_params_from_torch": DEVICE,
    "models/stepvideo.py:step1_params_from_torch": DEVICE,
    "models/stepvideo_vae.py:stepvideo_vae_params_from_torch": DEVICE,
    "models/svd.py:svd_unet_params_from_torch": DEVICE,
    "models/svd.py:svd_vae_decoder_params_from_torch": DEVICE,
    "models/t5.py:forward": METHOD,
    "models/t5.py:encode_prompt_states": METHOD,
    "models/t5.py:init_params": KEY,
    "models/t5.py:params_from_torch_state_dict": DEVICE,
    "models/unianimate.py:init_randomref": UNIANIMATE,
    "models/unianimate.py:randomref_from_torch": UNIANIMATE,
    "models/unianimate.py:randomref_forward": UNIANIMATE,
    "models/unianimate.py:init_learn_in": UNIANIMATE,
    "models/unianimate.py:learn_in_from_torch": UNIANIMATE,
    "models/unianimate.py:learn_in_forward": UNIANIMATE,
    "models/unianimate.py:init_inpaint": UNIANIMATE,
    "models/unianimate.py:inpaint_from_torch": UNIANIMATE,
    "models/unianimate.py:inpaint_forward": UNIANIMATE,
    "models/wan_dit.py:WanDiTConfig.__init__": (
        "recorded divergence: `text_len` is read by the prompter (`WanPrompter.text_len`), not "
        "the DiT's config"),
    "models/wan_dit.py:init_params": KEY,
    "models/wan_dit.py:patchify": METHOD,
    "models/wan_dit.py:unpatchify": METHOD,
    "models/wan_dit.py:dit_block": METHOD,
    "models/wan_dit.py:audio_proj_forward": METHOD,
    "models/wan_dit.py:single_stream_multi_attention": METHOD,
    "models/wan_dit.py:time_inputs": METHOD,
    "models/wan_dit.py:head": METHOD,
    "models/wan_dit.py:forward_prelude": METHOD,
    "models/wan_dit.py:scan_blocks_remat": METHOD,
    "models/wan_dit.py:forward_blocks": METHOD,
    "models/wan_dit.py:forward_head": METHOD,
    "models/wan_dit.py:forward": METHOD,
    "models/wan_dit.py:params_from_torch_state_dict": DEVICE,
    "models/wan_dit.py:quantize_params_int4": CONSUME,
    "models/wan_dit.py:init_params_int4": KEY,
    "models/wan_dit.py:quantized_params_from_torch_state_dict": DEVICE,
    "models/wan_dit.py:quantize_params_for_inference": MODULE,
    "models/wan_dit.py:quantize_params_w8a8": CONSUME,
    "models/wan_dit.py:quantize_params_int8": CONSUME,
    "models/wan_vae.py:causal_conv3d": (
        "recorded divergence: `stride` is one int (the causal convs stride time and space "
        "alike or not at all)"),
    "models/wan_vae.py:init_params": KEY,
    "models/wan_vae.py:init_caches": METHOD,
    "models/wan_vae.py:encode": METHOD,
    "models/wan_vae.py:decode": METHOD,
    "models/wan_vae.py:build_mask": DEVICE,
    "models/wan_vae.py:tiled_encode": METHOD,
    "models/wan_vae.py:tiled_decode": METHOD,
    "models/wan_vae.py:params_from_torch_state_dict": DEVICE,
    "models/wav2vec2.py:params_from_torch": DEVICE,
    "models/wav2vec2.py:feature_extractor": METHOD,
    "models/wav2vec2.py:encoder": METHOD,
    "models/wav2vec2.py:forward": METHOD,
    "models/wav2vec2.py:load_params": DEVICE,
    "ops/attention.py:flash_attention": JAX_XLA,
    "ops/attention.py:flash_attention_rope": JAX_XLA,
    "ops/attention.py:flash_attention_flat": JAX_XLA,
    "ops/attention.py:flash_attention_with_lse": JAX_XLA,
    "ops/attention.py:attention_bnsd": JAX_XLA,
    "ops/rope.py:apply_rope": (
        "recorded divergence: the port rotates q and k in the kernel's RoPE pre-pass "
        "(`attention.rope_rotate_flat`), its plain version `_apply_rope_reference`"),
    "parallel/mesh.py:make_mesh": JAX_DEVICES,
    "parallel/mesh.py:make_sp_mesh": JAX_DEVICES,
    "parallel/mesh.py:make_training_mesh": JAX_DEVICES,
    "parallel/mesh.py:replicated": JAX_DEVICES,
    "parallel/sequence_parallel.py:forward_sp": MODULE,
    "parallel/tensor_parallel.py:block_param_specs": (
        "recorded divergence: the port shards one block module at a time, reading its cfg"),
    "parallel/tensor_parallel.py:block_param_specs_for": MODULE,
    "parallel/tensor_parallel.py:split_audio_kv": MODULE,
    "parallel/tensor_parallel.py:shard_dit_params_tp": MODULE,
    "parallel/tensor_parallel.py:forward_tp": MODULE,
    "parallel/tp_sp.py:make_mesh3": JAX_DEVICES,
    "parallel/tp_sp.py:shard_dit_params_tpsp": MODULE,
    "parallel/tp_sp.py:forward_tpsp": MODULE,
    "pipelines/pipeline_runner.py:SDVideoPipelineRunner.__init__": DEVICE,
    "pipelines/pipeline_runner.py:SDVideoPipelineRunner.save_output": (
        "recorded divergence: `save_format` writes `.npy` where the card has no mp4 writer"),
    "pipelines/sd_image.py:SDImagePipeline.__init__": MODULE,
    "pipelines/sd_video.py:SDVideoPipeline.__init__": MODULE,
    "pipelines/sdxl_image.py:SDXLImagePipeline.__init__": MODULE,
    "pipelines/sdxl_video.py:SDXLVideoPipeline.__init__": MODULE,
    "pipelines/svi_video.py:model_fn_wan_video": METHOD,
    "pipelines/svi_video.py:SVIVideoPipeline.denoising_model": METHOD,
    "pipelines/wan_video.py:WanVideoPipeline.from_model_manager": (
        "recorded divergence: a classmethod, so the subclasses build themselves"),
    "pipelines/wan_video.py:WanUniAnimateVideoPipeline.from_model_manager": (
        "recorded divergence: a classmethod, so the subclasses build themselves"),
    "prompters/sd_prompter.py:SDPrompter.encode_prompt": MODULE,
    "prompters/sdxl_prompter.py:SDXLPrompter.encode_prompt": MODULE,
    "schedulers/flow_match.py:tree_flatten": JAX_ONLY,
    "schedulers/flow_match.py:tree_unflatten": JAX_ONLY,
    "training/lora.py:init_lora_params": KEY,
    "training/text_to_image.py:init_lora": KEY,
    "training/text_to_image.py:lora_from_state_dict": DEVICE,
    "training/lora.py:from_peft_state_dict": DEVICE,
    "training/trainer.py:make_optimizer": MODULE,
    "training/trainer.py:shard_optimizer_state": (
        "recorded divergence: ZeRO-1 lives in the port's `ClippedAdamW` (its `mesh`)"),
    "training/trainer.py:split_customtalk_params": METHOD,
    "training/trainer.py:merge_customtalk_params": METHOD,
    "training/trainer.py:make_train_step": METHOD,
    "training/trainer.py:ErrorRecyclingTrainer.__init__": MODULE,
    "utils/audio.py:load_wav2vec": DEVICE_BEFORE,
    "utils/clip_bpe.py:SimpleTokenizer.__init__": (
        "recorded divergence: `bpe_path` defaults to the port's vendored CLIP merges"),
    "utils/clip_bpe.py:SimpleTokenizer.bpe": (
        "recorded divergence: the BPE step is the shared `ClipBpeTokenizer._bpe`"),
}


# the modules of the video zoo's families (SVD, Hunyuan-DiT, HunyuanVideo,
# CogVideoX; then StepVideo, OmniGen and the flow-matching solvers): each is
# compared
PORTED_VIDEO_ZOO = (
    "schedulers/continuous_ode.py", "models/svd.py", "pipelines/svd_video.py",
    "prompters/sp_tokenizer.py", "models/hunyuan_dit.py", "prompters/hunyuan_dit_prompter.py",
    "pipelines/hunyuan_image.py", "models/hunyuan_video.py",
    "prompters/hunyuan_video_prompter.py", "pipelines/hunyuan_video.py", "models/cog.py",
    "prompters/cog_prompter.py", "pipelines/cog_video.py",
    "models/stepvideo.py", "models/stepvideo_vae.py", "prompters/stepvideo_prompter.py",
    "pipelines/step_video.py", "models/omnigen.py", "prompters/omnigen_prompter.py",
    "pipelines/omnigen_image.py", "schedulers/fm_solvers.py")


# the modules of the last slice: the prompt tools, the text-to-image trainer
# and the subpackages' exports
PORTED_LAST_SLICE = (
    "prompters/prompt_refiners.py", "prompters/omost.py", "utils/qwen_vl.py",
    "utils/prompt_extend.py", "utils/vace_processor.py", "training/text_to_image.py",
    "pipelines/__init__.py", "models/__init__.py", "prompters/__init__.py",
    "schedulers/__init__.py", "training/__init__.py", "utils/__init__.py", "ops/__init__.py")


def _pairs():
    """Module paths (relative, '/') that both packages have."""
    port, ref = REPO / "svi_tpu_torch", REPO / "svi_tpu"
    return sorted(p.relative_to(port).as_posix() for p in port.rglob("*.py")
                  if (ref / p.relative_to(port)).exists())


def _module(pkg, rel):
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join([pkg] + parts))


def _members(mod) -> dict:
    """Public functions and classes defined in mod, and the classes' public
    methods, `__init__` and `__call__` (properties as the string 'property')."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isfunction(obj):
            out[name] = obj
        elif inspect.isclass(obj):
            out[name] = obj
            for m, v in vars(obj).items():
                if m.startswith("_") and m not in ("__init__", "__call__"):
                    continue
                if isinstance(v, (staticmethod, classmethod)):
                    v = v.__func__
                if isinstance(v, property):
                    out[f"{name}.{m}"] = "property"
                elif inspect.isfunction(v):
                    out[f"{name}.{m}"] = v
    return out


def _sig(fn):
    if fn == "property":
        return fn
    return tuple((p.name, p.kind.name, p.default is not inspect.Parameter.empty)
                 for p in inspect.signature(fn).parameters.values())


def _differences() -> dict:
    diffs = {}
    for rel in _pairs():
        ref, port = _members(_module("svi_tpu", rel)), _members(_module("svi_tpu_torch", rel))
        for name, obj in ref.items():
            if "." in name and name.split(".")[0] not in port:
                continue  # the class itself is reported
            key = f"{rel}:{name}"
            if name not in port:
                diffs[key] = "missing in the port"
            elif not inspect.isclass(obj) and _sig(obj) != _sig(port[name]):
                diffs[key] = f"svi_tpu {_sig(obj)} / port {_sig(port[name])}"
    return diffs


@pytest.fixture(scope="module")
def differences():
    return _differences()


def test_every_difference_is_allowed(differences):
    unlisted = {k: v for k, v in differences.items() if k not in ALLOWED}
    assert not unlisted, "\n".join(f"{k}: {v}" for k, v in unlisted.items())


def test_every_allowed_entry_is_a_difference(differences):
    stale = sorted(set(ALLOWED) - set(differences))
    assert not stale, stale


def test_every_allowed_entry_is_in_the_roadmap():
    roadmap = (REPO / "ROADMAP.md").read_text()
    missing = sorted(k for k in ALLOWED if f"`{k}`" not in roadmap)
    assert not missing, missing


@pytest.mark.parametrize("qualname,argument", [
    ("pipelines/svi_video.py:SVIVideoPipeline.__call__", "rand_device"),
    ("pipelines/svi_video.py:SVIVideoPipeline.__call__", "use_controlnet"),
    ("pipelines/svi_video.py:SVIVideoPipeline.__init__", "is_test"),
    ("pipelines/svi_video.py:SVIVideoPipeline.from_model_manager", "is_test"),
    ("pipelines/svi_video_dance.py:SVIDanceVideoPipeline.from_model_manager", "is_test"),
    ("pipelines/svi_video_talk.py:SVITalkVideoPipeline.from_model_manager", "is_test"),
    ("pipelines/svi_video_talk.py:SVITalkVideoPipeline.preprocess_audio", "audio_window"),
    ("pipelines/svi_video_talk.py:SVITalkVideoPipeline.preprocess_audio", "vae_scale"),
    ("models/model_io.py:ModelManager.__init__", "file_path_list"),
    ("models/model_io.py:ModelManager.__init__", "train_architecture"),
    ("models/model_io.py:ModelManager.load_model", "torch_dtype"),
    ("models/model_io.py:ModelManager.load_models", "model_names"),
    ("models/model_io.py:ModelManager.load_models", "torch_dtype"),
    ("models/model_io.py:ModelManager.load_lora_v2", "state_dict"),
    ("utils/audio.py:wav2vec_embedding", "feature_extractor"),
    ("prompters/sp_tokenizer.py:T5SpTokenizer.__call__", "padding"),
    ("prompters/sp_tokenizer.py:T5SpTokenizer.__call__", "return_tensors"),
    ("training/lora.py:from_peft_state_dict", "rank"),
])
def test_repaired_arguments_bind_like_svi_tpus(qualname, argument):
    """The arguments the port used to refuse: each at svi_tpu's position, so
    positional calls bind alike."""
    rel, name = qualname.split(":")
    want = _sig(_members(_module("svi_tpu", rel))[name])
    got = _sig(_members(_module("svi_tpu_torch", rel))[name])
    names = [p[0] for p in want]
    assert [p[0] for p in got][:names.index(argument) + 1] == names[:names.index(argument) + 1]


@pytest.mark.parametrize("rel", PORTED_VIDEO_ZOO)
def test_video_zoo_module_is_compared(rel, differences):
    """Each module of SVD, Hunyuan-DiT, HunyuanVideo, CogVideoX, StepVideo,
    OmniGen and the flow-matching solvers has its svi_tpu counterpart at the same path, defines every public name svi_tpu's
    does, and every signature left differing is on ALLOWED."""
    assert rel in _pairs()
    assert _members(_module("svi_tpu_torch", rel))
    ours = {k: v for k, v in differences.items() if k.startswith(rel + ":")}
    assert all(k in ALLOWED and v != "missing in the port" for k, v in ours.items()), ours


@pytest.mark.parametrize("rel", PORTED_LAST_SLICE)
def test_last_slice_module_is_compared(rel, differences):
    """Each module of the last slice has its svi_tpu counterpart at the same
    path, and every signature left differing is on ALLOWED (the packages'
    `__init__` files define no public function of their own: their exports
    are held by tests/test_torch_prompt_tools.py)."""
    assert rel in _pairs()
    if not rel.endswith("__init__.py"):
        assert _members(_module("svi_tpu_torch", rel))
    ours = {k: v for k, v in differences.items() if k.startswith(rel + ":")}
    assert all(k in ALLOWED and v != "missing in the port" for k, v in ours.items()), ours
