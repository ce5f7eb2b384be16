"""The port's checkpoint loading against svi_tpu's, on tiny files written to
a temporary directory in the reference's formats (tests/torch_checkpoint_files.py).

Both packages load the same files: svi_tpu through its own `load_state_dict`
(the `safetensors` package), the port through its own reader. Loaded
weights, fused LoRA and quantized leaves are compared bit for bit (svi_tpu's
carried across with the port's `params_from_jax`), configs field by field,
and one forward of each model with the F32_TOL below.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import clip_vision as jclip
from svi_tpu.models import model_io as jio
from svi_tpu.models import t5 as jt5
from svi_tpu.models import wan_dit as jdit
from svi_tpu.models import wan_vae as jvae
from svi_tpu_torch.models import clip_vision as tclip
from svi_tpu_torch.models import model_io as tio
from svi_tpu_torch.models import t5 as tt5
from svi_tpu_torch.models import wan_dit as tdit
from svi_tpu_torch.models import wan_vae as tvae
from svi_tpu_torch.utils import safetensors_io
from torch_checkpoint_files import DIT_CFG, LORA_TARGETS, dit_state_dict, write_tiny_checkpoints

# f32 forward through a few layers of matmuls, norms and attention, summed in
# another order by each framework (as tests/test_torch_models.py)
F32_TOL = 1e-4

KINDS = ("wan_video_dit", "wan_video_text_encoder", "wan_video_vae", "wan_video_image_encoder")
PORT = {"wan_video_dit": tdit, "wan_video_text_encoder": tt5, "wan_video_vae": tvae,
        "wan_video_image_encoder": tclip}


def _host(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_tiny_checkpoints(tmp_path_factory.mktemp("weights"))


@pytest.fixture(scope="module")
def managers(files):
    """svi_tpu's and the port's ModelManager over the same files, in f32, with
    the LoRA fused."""
    paths = [files["dit"], files["t5"], files["vae"], files["clip"]]
    jm = jio.ModelManager(torch_dtype=jnp.float32)
    jm.load_models(paths)
    jm.load_lora_v2(files["lora"])
    tm = tio.ModelManager(torch_dtype=torch.float32, device="cpu")
    tm.load_models(paths)
    tm.load_lora_v2(files["lora"])
    return jm, tm


# -- the safetensors reader and writer -------------------------------------------

ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
             "F8_E4M3": torch.float8_e4m3fn, "I8": torch.int8, "I32": torch.int32,
             "I64": torch.int64, "U8": torch.uint8, "BOOL": torch.bool}


def _tensors(dtype, seed):
    """Seeded tensors of `dtype` in several shapes (a scalar, an empty one, odd
    sizes), beside a bool and an f64 tensor, so that offsets are not all
    aligned to the element size."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, shape in enumerate([(3, 5), (7,), (), (2, 0, 3), (4, 3, 2)]):
        x = np.asarray(rng.standard_normal(shape) * 3, np.float32)
        if dtype == torch.bool:
            t = torch.from_numpy(np.asarray(x > 0))
        elif dtype.is_floating_point:
            t = torch.from_numpy(x).to(dtype)
        else:
            t = torch.from_numpy(np.asarray(rng.integers(0, 100, shape))).to(dtype)
        out[f"t{i}"] = t
    out["odd_bool"] = torch.from_numpy(rng.standard_normal(3) > 0)
    out["wide"] = torch.from_numpy(rng.standard_normal(5))
    return out


def _bits(t):
    """A tensor's bytes as uint8, so that NaN payloads and float8 compare too."""
    return t.reshape(-1).view(torch.uint8) if t.numel() else t.reshape(-1)


@pytest.mark.parametrize("name", sorted(ST_DTYPES))
def test_safetensors_reader_is_bit_exact(tmp_path, name):
    from safetensors.torch import save_file

    tensors = _tensors(ST_DTYPES[name], seed=len(name))
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    f = safetensors_io.SafetensorsFile(path)
    assert sorted(f.keys()) == sorted(tensors) and f.metadata == {"format": "pt"}
    for key, want in tensors.items():
        got = f.get_tensor(key)
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert torch.equal(_bits(got), _bits(want)), key
    loaded = safetensors_io.load_file(path)
    assert all(torch.equal(_bits(loaded[k]), _bits(v)) for k, v in tensors.items())
    assert torch.equal(_bits(f.get_tensor("t0", device="cpu")), _bits(tensors["t0"]))


def test_safetensors_writer_is_read_by_the_package(tmp_path):
    from safetensors import safe_open

    tensors = {}
    for name, dtype in ST_DTYPES.items():
        tensors.update({f"{name}.{k}": v for k, v in _tensors(dtype, seed=1).items()})
    path = str(tmp_path / "y.safetensors")
    size = safetensors_io.save_file(tensors, path)
    assert size == (tmp_path / "y.safetensors").stat().st_size
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(tensors) and not f.metadata()
        for key, want in tensors.items():
            got = f.get_tensor(key)
            assert got.dtype == want.dtype and got.shape == want.shape, key
            assert torch.equal(_bits(got), _bits(want)), key


# -- identification -------------------------------------------------------------------

SD_FAMILY_KEYS = {
    "sd_motion_modules": ["motion_modules.0.transformer_blocks.0.pe1"],
    "sd_controlnet": ["controlnet_blocks.0.weight", "controlnet_conv_in.blocks.0.weight"],
    "sd_unet": ["time_embedding.0.weight", "conv_in.weight",
                "blocks.2.transformer_blocks.0.attn1.to_q.weight"],
    "sd_vae_decoder": ["post_quant_conv.weight"],
}


@pytest.mark.parametrize("which", ["dit", "t5", "vae", "clip", "lora", "unknown",
                                   *SD_FAMILY_KEYS])
def test_hash_and_kind_match_svi_tpu(files, which):
    if which in files:
        paths = files[which]
        tsd, jsd = tio.load_state_dicts(paths), jio.load_state_dicts(paths)
    else:
        keys = SD_FAMILY_KEYS.get(which, ["something.weight"])
        tsd = {k: torch.zeros(2, 3) for k in keys}
        jsd = {k: np.zeros((2, 3), np.float32) for k in keys}
    assert sorted(tsd) == sorted(jsd)
    assert tio.hash_state_dict_keys(tsd) == jio.hash_state_dict_keys(jsd)
    assert (tio.hash_state_dict_keys(tsd, with_shape=False)
            == jio.hash_state_dict_keys(jsd, with_shape=False))
    assert tio.detect_model_kind(tsd) == jio.detect_model_kind(jsd)


def test_sd_family_and_lora_files_do_not_load_as_models(tmp_path, files):
    path = str(tmp_path / "unet.safetensors")
    safetensors_io.save_file({k: torch.zeros(2) for k in SD_FAMILY_KEYS["sd_unet"]}, path)
    mm = tio.ModelManager(device="cpu")
    with pytest.raises(NotImplementedError, match="Slice F"):
        mm.load_model(path)
    with pytest.raises(ValueError, match="load_lora_v2"):
        mm.load_model(files["lora"])
    with pytest.raises(RuntimeError, match="DiT before LoRA"):
        mm.load_lora_v2(files["lora"])


# -- converters ------------------------------------------------------------------------

JAX_CONFIG = {"wan_video_dit": lambda sd: jdit.config_from_state_dict(sd),
              "wan_video_text_encoder": lambda sd: jt5.config_from_state_dict(sd),
              "wan_video_vae": lambda sd: jvae.config_from_state_dict(sd),
              "wan_video_image_encoder": lambda sd: jclip.config_from_state_dict(sd)}
FILE_OF = {"wan_video_dit": "dit", "wan_video_text_encoder": "t5", "wan_video_vae": "vae",
           "wan_video_image_encoder": "clip"}


@pytest.mark.parametrize("kind", KINDS)
def test_config_from_state_dict_matches_svi_tpu(files, kind):
    paths = files[FILE_OF[kind]]
    got = PORT[kind].config_from_state_dict(tio.load_state_dicts(paths))
    want = JAX_CONFIG[kind](jio.load_state_dicts(paths))
    fields = [f.name for f in dataclasses.fields(got) if f.name != "dtype"]
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}


def test_dit_config_from_keys_matches_svi_tpu(files):
    for n in (2, 40):
        keys = [k.replace("blocks.1.", f"blocks.{n - 1}.") for k in dit_state_dict()]
        got, want = tdit.config_from_state_dict_keys(keys), jdit.config_from_state_dict_keys(keys)
        fields = [f.name for f in dataclasses.fields(got) if f.name != "dtype"]
        assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}


@pytest.mark.parametrize("kind", KINDS)
def test_loaded_weights_are_svi_tpus_bit_for_bit(managers, kind):
    """Every tensor, the LoRA-fused DiT weights included."""
    jm, tm = managers
    jp, _ = jm.models[kind]
    model = tm.models[kind]
    want = dict(PORT[kind].params_from_jax(_host(jp), model.cfg).named_parameters())
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    bad = [k for k in got if got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k])]
    assert not bad, bad


@pytest.mark.parametrize("kind", KINDS)
def test_written_and_read_back_is_the_same_tensor(files, kind):
    """The port's converter is the inverse of its writer: every tensor written
    comes back (the file's f32 / bf16 as stored, the DiT before LoRA)."""
    sd = files["sds"][FILE_OF[kind]]
    mod = PORT[kind]
    cfg = mod.config_from_state_dict(sd)  # bf16 for the DiT and umT5, f32 for the others
    back = mod.torch_state_dict_from_params(mod.params_from_torch_state_dict(sd, cfg, "cpu"))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k].to(v.dtype).reshape(v.shape), v), k


def _forward_inputs(rng):
    x = rng.standard_normal((2, 4, 3, 8, 8)).astype(np.float32)
    y = rng.standard_normal((2, 8, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 12, DIT_CFG.text_dim)).astype(np.float32)
    clip = rng.standard_normal((2, 5, DIT_CFG.clip_feature_dim)).astype(np.float32)
    return x, np.array([731.0], np.float32), ctx, clip, y


@pytest.mark.parametrize("kind", KINDS)
def test_loaded_model_forward_matches_svi_tpu(managers, kind):
    jm, tm = managers
    jp, jc = jm.models[kind]
    model = tm.models[kind]
    rng = np.random.default_rng(7)
    if kind == "wan_video_dit":
        args = _forward_inputs(rng)
        want = jdit.forward(jp, jc, *(jnp.asarray(a) for a in args[:3]),
                            clip_feature=jnp.asarray(args[3]), y=jnp.asarray(args[4]))
        with torch.inference_mode():
            got = model(*(torch.from_numpy(a) for a in args))
    elif kind == "wan_video_text_encoder":
        ids = rng.integers(0, jc.vocab, (2, 16)).astype(np.int32)
        mask = np.ones((2, 16), np.int32)
        mask[1, 6:] = 0
        want = jt5.encode_prompt_states(jp, jc, jnp.asarray(ids), jnp.asarray(mask))
        with torch.inference_mode():
            got = model.encode_prompt_states(torch.from_numpy(ids), torch.from_numpy(mask))
    elif kind == "wan_video_vae":
        video = rng.uniform(-1, 1, (1, 3, 5, 16, 16)).astype(np.float32)
        want = jvae.decode(jp, jc, jvae.encode(jp, jc, jnp.asarray(video)))
        with torch.inference_mode():
            got = model.decode(model.encode(torch.from_numpy(video)))
    else:
        frames = rng.uniform(-1, 1, (1, 3, 20, 24)).astype(np.float32)
        want = jclip.encode_image(jp, jc, jnp.asarray(frames))
        with torch.inference_mode():
            got = model.encode_image(torch.from_numpy(frames))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got.float().numpy(), want, atol=F32_TOL, rtol=F32_TOL)


# -- LoRA ---------------------------------------------------------------------------------


def test_lora_fuses_the_same_targets_as_svi_tpu(files, managers):
    jm, tm = managers
    assert [n for _, n in tm.lora_log] == [n for _, n in jm.lora_log] \
        == [DIT_CFG.num_layers * len(LORA_TARGETS)]
    # the fused weight is W + alpha * B @ A with the delta from f32 (alpha 1 here)
    sd, lora = files["sds"]["dit"], files["sds"]["lora"]
    w = tm.models["wan_video_dit"]["blocks"][1]["ffn"]["2"]["w"]
    a = lora["diffusion_model.blocks.1.ffn.2.lora_A.default.weight"]
    b = lora["diffusion_model.blocks.1.ffn.2.lora_B.default.weight"]
    assert torch.equal(w, sd["blocks.1.ffn.2.weight"].float() + b @ a)


def test_lora_on_a_missing_target_raises_key_error():
    sd = dit_state_dict()
    dit = tdit.params_from_torch_state_dict(sd, DIT_CFG, device="cpu")
    jsd = {k: v.float().numpy() for k, v in sd.items()}
    jparams = jdit.params_from_torch_state_dict(jsd, jdit.config_from_state_dict(jsd))
    for target in ("blocks.9.self_attn.q", "blocks.0.self_attn.qq", "nowhere"):
        lora = {f"{target}.lora_A.default.weight": torch.zeros(2, 64),
                f"{target}.lora_B.default.weight": torch.zeros(64, 2)}
        with pytest.raises(KeyError):
            tio.fuse_lora_into_dit(dit, lora)
        if target.startswith("blocks.9."):
            continue  # svi_tpu adds into its stacked blocks, and drops a layer out of range
        with pytest.raises(KeyError):  # svi_tpu raises on the same targets
            jio.fuse_lora_into_dit_params(jparams, {k: v.numpy() for k, v in lora.items()})


def test_side_modules_match_svi_tpu(files):
    """The extra-module weights a LoRA file may carry are the keys svi_tpu's
    `extract_side_modules` picks."""
    lora = dict(files["sds"]["lora"])
    for name in ("dwpose_embedding.0.weight", "randomref_embedding_pose.conv.bias",
                 "inpaint_embedding.weight", "learn_in_embedding.proj.weight"):
        lora[name] = torch.ones(3)
    got = tio.extract_side_modules(lora)
    want = jio.extract_side_modules({k: v.numpy() for k, v in lora.items()})
    assert sorted(got) == sorted(want) and len(got) == 4
    assert tio.extract_side_modules(files["sds"]["lora"]) == {}


# -- quantize on load ---------------------------------------------------------------------

# wide enough that every block linear (256 x 256 and up) is quantized on both
# sides: svi_tpu applies min_size to the stacked (L, in, out) block weights,
# the port to each block's
QUANT_CFG = dataclasses.replace(DIT_CFG, dim=256, ffn_dim=512, text_dim=256, num_heads=2)


def test_quantize_on_load_matches_svi_tpu(tmp_path):
    sd = dit_state_dict(QUANT_CFG, seed=9)
    path = str(tmp_path / "diffusion_pytorch_model.safetensors")
    safetensors_io.save_file(sd, path)
    tm = tio.ModelManager(torch_dtype=torch.bfloat16, device="cpu", quantize_dit="int4_w4a8")
    tm.load_model(path)
    assert tm.models["wan_video_dit"]["blocks"][0]["ffn"]["0"]["w"].device.type == "cpu"
    got = tm.fetch_model("wan_video_dit")
    jsd = jio.load_state_dict(path, bf16_as="bf16")
    jcfg = dataclasses.replace(jdit.config_from_state_dict(jsd), dtype=jnp.bfloat16)
    jq = jdit.quantized_params_from_torch_state_dict(jsd, jcfg, w4a8=True)
    want = dict(tdit.params_from_jax(_host(jq), got.cfg).named_parameters())
    mine = dict(got.named_parameters())
    assert sorted(mine) == sorted(want)
    n_q4 = sum(k.endswith("w_q4") for k in mine)
    # 12 a block; text_embedding.0 / .2, time_embedding.2 and time_projection.1
    assert n_q4 == QUANT_CFG.num_layers * 12 + 4
    bad = [k for k in mine if mine[k].dtype != want[k].dtype or not torch.equal(mine[k], want[k])]
    assert not bad, bad
    # the port's converter is the one-call form of the same
    direct = tdit.quantized_params_from_torch_state_dict(tio.load_state_dict(path), got.cfg,
                                                         w4a8=True, device="cpu")
    assert all(torch.equal(p, mine[k]) for k, p in direct.named_parameters())
