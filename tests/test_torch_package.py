"""Package-level rules of the PyTorch port: no JAX, how the kernel is built,
and how the attention wrappers dispatch."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import svi_tpu_torch
from svi_tpu_torch.kernels import build
from svi_tpu_torch.ops import attention as tattn

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest), importing
    every module of the port loads no jax module."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import svi_tpu_torch, svi_tpu_torch.kernels.build, svi_tpu_torch.ops.attention\n"
        "import svi_tpu_torch.ops.quant_matmul\n"
        "import svi_tpu_torch.models.wan_dit, svi_tpu_torch.models.wan_vae\n"
        "import svi_tpu_torch.models.clip_vision, svi_tpu_torch.models.t5\n"
        "import svi_tpu_torch.pipelines.svi_video\n"
        "import svi_tpu_torch.training, svi_tpu_torch.training.lora\n"
        "import svi_tpu_torch.models.model_io, svi_tpu_torch.utils.safetensors_io\n"
        "import svi_tpu_torch.utils.proto, svi_tpu_torch.utils.prompt_files\n"
        "import svi_tpu_torch.utils.image_process, svi_tpu_torch.utils.video\n"
        "import svi_tpu_torch.prompters.sp_tokenizer, svi_tpu_torch.prompters.wan_prompter\n"
        "import svi_tpu_torch.scripts.test_svi\n"
        "import svi_tpu_torch.training.dataset, svi_tpu_torch.utils.logging\n"
        "import svi_tpu_torch.scripts.train_svi, svi_tpu_torch.scripts.train_svi_dance\n"
        "import svi_tpu_torch.scripts.train_svi_talk\n"
        "import svi_tpu_torch.ops.conv, svi_tpu_torch.utils.fidelity\n"
        "import svi_tpu_torch.utils.multitalk, svi_tpu_torch.utils.project_utils\n"
        "import svi_tpu_torch.utils.audio\n"
        "import svi_tpu_torch.scripts.extract_lora, svi_tpu_torch.scripts.prepare_video_audio\n"
        "import svi_tpu_torch.scripts.make_toy_data, svi_tpu_torch.scripts.process_mixkit\n"
        "import svi_tpu_torch.utils.onnx_torch, svi_tpu_torch.dwpose, svi_tpu_torch.dwpose.align\n"
        "import svi_tpu_torch.dwpose.onnx_infer, svi_tpu_torch.models.unianimate\n"
        "import svi_tpu_torch.pipelines.wan_video, svi_tpu_torch.scripts.metadata_gen\n"
        "import svi_tpu_torch.scripts.prepare_video_pose, svi_tpu_torch.scripts.run_align_pose\n"
        "import svi_tpu_torch.models.sd, svi_tpu_torch.models.tiler, svi_tpu_torch.models.motion\n"
        "import svi_tpu_torch.models.controlnets, svi_tpu_torch.schedulers.ddim\n"
        "import svi_tpu_torch.prompters.clip_tokenizer, svi_tpu_torch.prompters.sd_prompter\n"
        "import svi_tpu_torch.prompters.base_prompter, svi_tpu_torch.prompters.textual_inversion\n"
        "import svi_tpu_torch.pipelines.sd_image, svi_tpu_torch.pipelines.sd_video\n"
        "import svi_tpu_torch.pipelines.pipeline_runner, svi_tpu_torch.processors\n"
        "import svi_tpu_torch.extensions, svi_tpu_torch.extensions.image_quality\n"
        "import svi_tpu_torch.extensions.quality_towers, svi_tpu_torch.utils.clip_bpe\n"
        "import svi_tpu_torch.models.sdxl, svi_tpu_torch.models.ipadapter\n"
        "import svi_tpu_torch.prompters.sdxl_prompter, svi_tpu_torch.pipelines.sdxl_image\n"
        "import svi_tpu_torch.pipelines.sdxl_video\n"
        "import svi_tpu_torch.models.kolors, svi_tpu_torch.prompters.kolors_prompter\n"
        "import svi_tpu_torch.models.sd3, svi_tpu_torch.prompters.sd3_prompter\n"
        "import svi_tpu_torch.pipelines.sd3_image, svi_tpu_torch.schedulers.flow_match\n"
        "import svi_tpu_torch.models.flux, svi_tpu_torch.prompters.flux_prompter\n"
        "import svi_tpu_torch.pipelines.flux_image\n"
        "import svi_tpu_torch.schedulers.continuous_ode, svi_tpu_torch.models.svd\n"
        "import svi_tpu_torch.pipelines.svd_video, svi_tpu_torch.models.hunyuan_dit\n"
        "import svi_tpu_torch.prompters.hunyuan_dit_prompter\n"
        "import svi_tpu_torch.pipelines.hunyuan_image, svi_tpu_torch.models.hunyuan_video\n"
        "import svi_tpu_torch.prompters.hunyuan_video_prompter\n"
        "import svi_tpu_torch.pipelines.hunyuan_video, svi_tpu_torch.models.cog\n"
        "import svi_tpu_torch.prompters.cog_prompter, svi_tpu_torch.pipelines.cog_video\n"
        "import svi_tpu_torch.models.stepvideo, svi_tpu_torch.models.stepvideo_vae\n"
        "import svi_tpu_torch.prompters.stepvideo_prompter, svi_tpu_torch.pipelines.step_video\n"
        "import svi_tpu_torch.models.omnigen, svi_tpu_torch.prompters.omnigen_prompter\n"
        "import svi_tpu_torch.pipelines.omnigen_image, svi_tpu_torch.schedulers.fm_solvers\n"
        "import svi_tpu_torch.training.text_to_image, svi_tpu_torch.scripts.gradio_demo\n"
        "import svi_tpu_torch.prompters.prompt_refiners, svi_tpu_torch.prompters.omost\n"
        "import svi_tpu_torch.utils.qwen_vl, svi_tpu_torch.utils.prompt_extend\n"
        "import svi_tpu_torch.utils.vace_processor\n"
        "import svi_tpu_torch.models, svi_tpu_torch.pipelines, svi_tpu_torch.prompters\n"
        "import svi_tpu_torch.schedulers, svi_tpu_torch.utils, svi_tpu_torch.ops\n"
        "from svi_tpu_torch.prompters import sp_tokenizer\n"
        "sp_tokenizer.default_chatglm_tokenizer().encode('一只猫')\n"
        "sp_tokenizer.default_bert_tokenizer()('一只猫')\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'svi_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_sd_path_imports_no_pillow_or_cv2():
    """In a fresh interpreter, importing the SD 1.5 and SDXL video paths (the
    runner, the pipelines, the processors, the extensions), running the
    smoothers (FastBlend and RIFE among them) and writing PNG frames and a
    .npy video loads no PIL, cv2, imageio or safetensors: the card has none
    of them."""
    code = (
        "import sys, tempfile, os\n"
        "import numpy as np\n"
        "import svi_tpu_torch.pipelines.pipeline_runner, svi_tpu_torch.pipelines.sdxl_video\n"
        "import svi_tpu_torch.pipelines.sdxl_image, svi_tpu_torch.extensions\n"
        "from svi_tpu_torch.extensions import rife\n"
        "from svi_tpu_torch.processors import ContrastEditor, SharpnessEditor\n"
        "from svi_tpu_torch.processors import AutoVideoProcessor\n"
        "from svi_tpu_torch.utils import video\n"
        "f = [np.full((16, 24, 3), 40 * i, np.uint8) for i in range(3)]\n"
        "f = SharpnessEditor(1.3)(ContrastEditor(1.5)(f))\n"
        "g = [np.random.default_rng(i).integers(0, 255, (32, 32, 3), np.uint8) for i in range(3)]\n"
        "fb = AutoVideoProcessor.from_model_manager(None, 'FastBlend', device='cpu',\n"
        "    ebsynth_config=dict(minimum_patch_size=5, num_iter=1))\n"
        "assert len(fb(g, original_frames=g)) == 3\n"
        "assert len(rife.RIFESmoother(rife.init_params(c=8, device='cpu'))(g)) == 3\n"
        "d = tempfile.mkdtemp()\n"
        "video.save_frames(f, os.path.join(d, 'frames'))\n"
        "video.save_frames_npy(f, os.path.join(d, 'v.npy'))\n"
        "assert len(video.VideoData(video_file=os.path.join(d, 'v.npy'), height=8, width=8)[2]) == 8\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('PIL', 'cv2', 'imageio', 'safetensors'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_step_omnigen_paths_import_no_pillow_or_cv2():
    """In a fresh interpreter, importing StepVideo, OmniGen and the
    flow-matching solvers and running OmniGen's image crop and collator
    (Pillow's BOX and BICUBIC resizes, in numpy) loads no PIL, cv2, imageio or
    safetensors: the card has none of them."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import svi_tpu_torch.pipelines.step_video, svi_tpu_torch.pipelines.omnigen_image\n"
        "import svi_tpu_torch.prompters.stepvideo_prompter, svi_tpu_torch.schedulers.fm_solvers\n"
        "from svi_tpu_torch.prompters.omnigen_prompter import OmniGenPrompter\n"
        "img = np.random.default_rng(0).integers(0, 255, (700, 300, 3), np.uint8)\n"
        "out = OmniGenPrompter(lambda s: [1, 5, 6], max_image_size=128)(\n"
        "    'a <img><|image_1|></img>', [img], height=64, width=64)\n"
        "assert out['input_pixel_values'][0][0].shape == (1, 3, 128, 48)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('PIL', 'cv2', 'imageio', 'safetensors'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_pose_path_imports_no_cv2():
    """In a fresh interpreter, importing the pose path (the ONNX executor,
    dwpose, the UniAnimate pipelines, the two pose scripts) and running
    DWPose's preprocessing and drawing loads no cv2 and no onnxruntime."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "import svi_tpu_torch.dwpose as dw, svi_tpu_torch.utils.onnx_torch\n"
        "from svi_tpu_torch.dwpose import onnx_infer\n"
        "import svi_tpu_torch.pipelines.wan_video, svi_tpu_torch.models.unianimate\n"
        "import svi_tpu_torch.scripts.prepare_video_pose, svi_tpu_torch.scripts.run_align_pose\n"
        "img = np.zeros((48, 64, 3), np.uint8)\n"
        "onnx_infer._preprocess_det(img)\n"
        "onnx_infer._crop(torch.from_numpy(img), np.array([30.0, 20.0], np.float32),\n"
        "                 np.array([20.0, 30.0], np.float32))\n"
        "pose = {'bodies': np.full((1, 18, 2), 0.5, np.float32),\n"
        "        'body_scores': np.ones((1, 18), np.float32),\n"
        "        'hands': np.full((2, 21, 2), 0.4, np.float32)}\n"
        "dw.draw_pose_frame(pose, 64, 48)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('cv2', 'onnxruntime'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_build_command_targets_sm90a_into_an_ignored_dir():
    out = build.library_path(build.SM90_SOURCE)
    cmd = build.nvcc_command("nvcc", build.SM90_SOURCE, out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == str(build.SM90_SOURCE) and cmd[cmd.index("-o") + 1] == str(out)
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    rel = out.parent.relative_to(REPO).as_posix()
    ignored = [line.strip().rstrip("/") for line in (REPO / ".gitignore").read_text().splitlines()]
    assert rel in ignored, f"{rel} is not listed in .gitignore"
    # the library name follows the source: an edited kernel rebuilds
    assert out.name.startswith("libflash_fwd_sm90_") and out.suffix == ".so"
    # each source under csrc/ builds into a library of its own
    assert build.library_path(build.BWD_SOURCE).name.startswith("libflash_bwd_")
    assert build.BWD_SOURCE in build.CSRC.glob("*.cu")
    for source, stem in ((build.Q8_SOURCE, "flash_fwd_q8"), (build.UNPACK_SOURCE, "quant_unpack"),
                         (build.F32_SOURCE, "flash_fwd_f32"),
                         (build.BWD_SM90_SOURCE, "flash_bwd_sm90"),
                         (build.BWD_SPLIT_SM90_SOURCE, "flash_bwd_split_sm90"),
                         (build.Q8_SM90_SOURCE, "flash_fwd_q8_sm90"),
                         (build.W4A8_SOURCE, "w4a8_gemm_sm90"),
                         (build.DGRAD_SOURCE, "w4a8_dgrad_sm90"),
                         (build.BWD_F32_SOURCE, "flash_bwd_f32")):
        assert source in build.CSRC.glob("*.cu")
        lib = build.library_path(source)
        assert lib.name.startswith(f"lib{stem}_") and lib.parent == out.parent
    # a grouped source builds one library per group of head dims, each with
    # the group's defines, every head dim in one group
    for source, groups in build.HEAD_DIM_GROUPS.items():
        dims = [d for g in groups for d in g]
        assert len(dims) == len(set(dims))
        libs = {build.library_path(source, g) for g in groups}
        assert len(libs) == len(groups) and build.library_path(source) not in libs
        cmd = build.nvcc_command("nvcc", source, out, groups[0])
        assert "-DSVI_GROUP" in cmd and all(f"-DSVI_D{d}" in cmd for d in groups[0])
    assert len(build.units()) == len(list(build.CSRC.glob("*.cu"))) + sum(
        len(g) - 1 for g in build.HEAD_DIM_GROUPS.values())


@pytest.mark.parametrize("entry", ["wan_dit", "t5", "clip_vision", "wan_vae", "pipeline",
                                   "trainer", "model_manager", "from_model_manager", "driver",
                                   "dit_from_checkpoint", "t5_from_checkpoint",
                                   "vae_from_checkpoint", "clip_from_checkpoint",
                                   "dit_quantized_from_checkpoint", "dit_int4", "wav2vec2",
                                   "svd_unet_from_checkpoint", "hunyuan_dit_from_checkpoint",
                                   "hunyuan_video_dit_from_checkpoint", "cog_dit_from_checkpoint",
                                   "stepvideo_dit_from_checkpoint", "step1_from_checkpoint",
                                   "stepvideo_vae_from_checkpoint", "omnigen_from_checkpoint",
                                   "lora_from_jax", "unianimate_from_jax",
                                   "t2i_lora_from_state_dict", "gradio_demo"])
def test_entry_points_default_to_the_card(entry):
    import inspect

    from svi_tpu_torch.models import (clip_vision, cog, hunyuan_dit, hunyuan_video, omnigen,
                                      stepvideo, stepvideo_vae, svd, t5, unianimate, wan_dit,
                                      wan_vae)
    from svi_tpu_torch.models.model_io import ModelManager
    from svi_tpu_torch.pipelines.svi_video import SVIVideoPipeline
    from svi_tpu_torch.scripts import gradio_demo, test_svi
    from svi_tpu_torch.training import ErrorRecyclingTrainer, lora, text_to_image
    from svi_tpu_torch.utils import audio

    fn = {"wan_dit": wan_dit.init_params, "dit_int4": wan_dit.init_params_int4,
          "wav2vec2": audio.load_wav2vec, "t5": t5.init_params,
          "clip_vision": clip_vision.init_params, "wan_vae": wan_vae.init_params,
          "pipeline": SVIVideoPipeline, "trainer": ErrorRecyclingTrainer,
          "model_manager": ModelManager, "from_model_manager": SVIVideoPipeline.from_model_manager,
          "driver": test_svi.main, "dit_from_checkpoint": wan_dit.params_from_torch_state_dict,
          "t5_from_checkpoint": t5.params_from_torch_state_dict,
          "vae_from_checkpoint": wan_vae.params_from_torch_state_dict,
          "clip_from_checkpoint": clip_vision.params_from_torch_state_dict,
          "dit_quantized_from_checkpoint": wan_dit.quantized_params_from_torch_state_dict,
          "svd_unet_from_checkpoint": svd.svd_unet_params_from_torch,
          "hunyuan_dit_from_checkpoint": hunyuan_dit.hunyuan_dit_params_from_torch,
          "hunyuan_video_dit_from_checkpoint": hunyuan_video.hunyuan_video_dit_params_from_torch,
          "cog_dit_from_checkpoint": cog.cog_dit_params_from_torch,
          "stepvideo_dit_from_checkpoint": stepvideo.stepvideo_dit_params_from_torch,
          "step1_from_checkpoint": stepvideo.step1_params_from_torch,
          "stepvideo_vae_from_checkpoint": stepvideo_vae.stepvideo_vae_params_from_torch,
          "omnigen_from_checkpoint": omnigen.omnigen_params_from_torch,
          "lora_from_jax": lora.params_from_jax, "unianimate_from_jax": unianimate.params_from_jax,
          "t2i_lora_from_state_dict": text_to_image.lora_from_state_dict,
          "gradio_demo": gradio_demo.SVIGradioDemo}[entry]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_unported_training_options_raise():
    """Every training option is ported: a mesh is accepted (the parallel
    slice, tests/test_torch_parallel_training.py), shard_optimizer_state
    without a mesh changes nothing (one optimizer over every trainable, as
    in the JAX package); customtalk, pose, save_attention, offloaded carries
    and the first-frame augmentation run (tests/test_torch_training_variants.py,
    tests/test_torch_train_data.py)."""
    from svi_tpu_torch.models import wan_dit
    from svi_tpu_torch.training import ErrorRecyclingTrainer, TrainerConfig

    cfg = wan_dit.WanDiTConfig(dim=32, in_dim=4, ffn_dim=64, out_dim=4, text_dim=8,
                               freq_dim=16, num_heads=1, num_layers=2, dtype=torch.float32)
    dit = wan_dit.init_params(cfg, device="cpu")
    sharded = ErrorRecyclingTrainer(dit, TrainerConfig(shard_optimizer_state=True),
                                    device="cpu")
    plain = ErrorRecyclingTrainer(dit, TrainerConfig(), device="cpu")
    assert sharded.optimizer.owner is None
    assert len(sharded.optimizer.opt.param_groups[0]["params"]) == len(plain.optimizer.params)
    assert ErrorRecyclingTrainer(dit, TrainerConfig(), mesh=object(), device="cpu").mesh \
        is not None
    for ok in (dict(train_pose=True), dict(save_attention_activations=True),
               dict(use_gradient_checkpointing_offload=True)):
        ErrorRecyclingTrainer(dit, TrainerConfig(**ok), device="cpu")
    with pytest.raises(ValueError, match="customtalk"):  # a plain DiT has no customtalk FFNs
        ErrorRecyclingTrainer(dit, TrainerConfig(train_architecture="customtalk"), device="cpu")
    x = torch.zeros(1, 4, 1, 4, 4)
    for kw in (dict(save_attention=True), dict(offload_carries=True)):
        assert dit(x, torch.zeros(1), torch.zeros(1, 3, 8), use_remat=True, **kw).shape == x.shape


@pytest.mark.parametrize("quant", ["qk8", "qk8pv8"])
def test_quantized_attention_is_not_silently_bf16(quant):
    """quant= runs the int8 forward's plain version on CPU tensors: it differs
    from the unquantized result, stays within the JAX package's bounds of it
    (tests/test_attention.py: max 0.012 for qk8, 0.03 for qk8pv8), and has no
    backward."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 200, 2 * 128)).astype(np.float32))
               for _ in range(3))
    ref = tattn.flash_attention_flat(q, k, v, 128)
    got = tattn.flash_attention_flat(q, k, v, 128, quant=quant)
    err = (got - ref).abs().max().item()
    assert 0 < err < (0.012 if quant == "qk8" else 0.03), err
    leaf = q.clone().requires_grad_()
    out = tattn.flash_attention_flat(leaf, k, v, 128, quant=quant)
    with pytest.raises(RuntimeError, match="inference-only"):
        out.sum().backward()
    with pytest.raises(NotImplementedError, match="flat layout"):  # 2 heads of 64
        tattn.flash_attention_flat(q, k, v, 64, quant=quant)


def test_trainer_refuses_quantized_attention():
    from svi_tpu_torch.models import wan_dit
    from svi_tpu_torch.training import ErrorRecyclingTrainer, TrainerConfig

    cfg = wan_dit.WanDiTConfig(dim=32, in_dim=4, ffn_dim=64, out_dim=4, text_dim=8,
                               freq_dim=16, num_heads=1, num_layers=2, dtype=torch.float32,
                               attention_quant="qk8")
    with pytest.raises(ValueError, match="attention_quant"):
        ErrorRecyclingTrainer(wan_dit.init_params(cfg, device="cpu"), TrainerConfig(),
                              device="cpu")


def test_non_cpu_tensor_without_kernel_raises():
    """A tensor that is not on the CPU never takes the plain version: it
    launches the kernel or raises (here: a meta tensor, no CUDA)."""
    q = torch.empty(1, 8, 2 * 64, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        tattn.flash_fwd_flat(q, q, q, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tattn.flash_fwd_bnsd(*(torch.empty(1, 2, 8, 64, device="meta"),) * 3)


def test_non_cpu_tensor_without_kernel_raises_quantized():
    """The same for K3's, the W4A8 input gradient's and K6's entries."""
    from svi_tpu_torch.ops import quant_matmul as tqm

    with pytest.raises(RuntimeError, match="CUDA"):
        tqm.unpack_requant_int4(torch.empty(8, 64, dtype=torch.int8, device="meta"),
                                torch.empty(8, 1, device="meta"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tqm.w4a8_dgrad(torch.empty(3, 8, dtype=torch.bfloat16, device="meta"),
                       torch.empty(8, 64, dtype=torch.int8, device="meta"),
                       torch.empty(8, 8, device="meta"), torch.empty(8, 1, device="meta"))
    q8 = torch.empty(1, 8, 2 * 64, dtype=torch.int8, device="meta")
    qs = torch.empty(1, 2, 8, device="meta")
    kscale = torch.empty(1, 2, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        tattn.flash_fwd_flat_q8(q8, qs, q8, kscale, q8, torch.empty(1, 2, 64, device="meta"), 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tattn.flash_fwd_flat_q8(q8, qs, q8, kscale,
                                torch.empty(1, 8, 2 * 64, dtype=torch.bfloat16, device="meta"),
                                None, 64)


@pytest.mark.parametrize("d,dtype", [pytest.param(64, torch.bfloat16, id="64"),
                                     pytest.param(128, torch.bfloat16, id="128"),
                                     pytest.param(40, torch.float32, id="f32-40"),
                                     pytest.param(64, torch.float32, id="f32-64")])
def test_non_cpu_tensor_without_kernel_raises_backward(d, dtype):
    """The same for the split backward's entries on every route, the whole
    split backward and its lse / delta prep: no plain fallback. bf16: the
    flat layout at both head dims; f32: two heads, the (B, N, S, D) route."""
    n = 2 if d == 128 or dtype == torch.float32 else 1
    q = torch.empty(1, 8, n * d, dtype=dtype, device="meta")
    lse = torch.empty(1, n, 8, device="meta")
    for call in (lambda: tattn.flash_bwd_dq(q, q, q, q, lse, q, d),
                 lambda: tattn.flash_bwd_dkv(q, q, q, q, lse, q, d),
                 lambda: tattn.flash_bwd_flat(q, q, q, q, lse, q, d),
                 lambda: tattn._bwd_prep(*(q.unflatten(-1, (n, d)),) * 2, lse, 128)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_mixed_devices_raise():
    q = torch.zeros(1, 8, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tattn.flash_fwd_flat(q, q, q.to("meta"), 64)


@pytest.mark.parametrize("bad", ["kv_shape", "dtype", "rope_short", "kv_len"])
def test_attention_input_checks(bad):
    q = torch.zeros(1, 8, 2, 64)
    k = torch.zeros(1, 6, 2, 64)
    cos = sin = None
    kv_len = None
    if bad == "kv_shape":
        k = torch.zeros(1, 6, 2, 32)
    elif bad == "dtype":
        k = k.double()
    elif bad == "rope_short":
        cos = sin = torch.zeros(4, 32)
    else:
        kv_len = -1
    with pytest.raises(ValueError):
        tattn.flash_fwd_bnsd(q.transpose(1, 2), k.transpose(1, 2), k.transpose(1, 2),
                             kv_len=kv_len, cos=cos, sin=sin)


def test_capability_probe_reports_the_machine():
    info = svi_tpu_torch.capability_probe()
    assert {"torch", "torch_cuda", "cuda_available", "nvcc", "triton", "nvidia_smi"} <= set(info)
    assert info["torch"] == torch.__version__
    assert info["cuda_available"] == torch.cuda.is_available()
