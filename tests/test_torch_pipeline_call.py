"""The rest of the port's `SVIVideoPipeline.__call__` against svi_tpu's, and
its tiled VAE: text prompts through the tokenizer and umT5, tiled encode and
decode with tiles smaller than the frame (several masks blend), `input_video`
with `denoising_strength`, `last_latent`, `y_extra`, and the
`sequential_cfg == "latent"` return. Tiny f32 models from the port's
`init_params`, carried to svi_tpu through a state dict in the reference's
naming and svi_tpu's own `params_from_torch_state_dict` (held bit for bit
against the port's loader in tests/test_torch_model_io.py)."""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svi_tpu.models import clip_vision as jclip
from svi_tpu.models import t5 as jt5
from svi_tpu.models import wan_dit as jdit
from svi_tpu.models import wan_vae as jvae
from svi_tpu.pipelines.svi_video import SVIVideoPipeline as JaxPipeline
from svi_tpu.prompters.sp_tokenizer import asset_path
from svi_tpu_torch.models import clip_vision as tclip
from svi_tpu_torch.models import t5 as tt5
from svi_tpu_torch.models import wan_dit as tdit
from svi_tpu_torch.models import wan_vae as tvae
from svi_tpu_torch.pipelines.svi_video import SVIVideoPipeline as TorchPipeline

PORT_T5 = str(Path(__file__).resolve().parent.parent / "svi_tpu_torch" / "tokenizer_configs"
              / "t5")
Z, H, W, NF, STEPS = 4, 32, 48, 5, 2
# f32 VAE convs and attention, summed in another order by each framework (as
# tests/test_torch_models.py)
F32_TOL = 1e-4
# f32 through 2 DiT steps with CFG 5, umT5, the VAE and CLIP (as
# tests/test_torch_pipeline.py)
LATENT_TOL = 1e-3
# uint8 frames: a value within 1e-4 of a level boundary may round either way
FRAME_LEVELS = 2


def _to_jax(jmod, tmod, model, cfg_j):
    """The port's model -> svi_tpu's params, through the reference's names."""
    sd = {k: v.float().numpy() for k, v in tmod.torch_state_dict_from_params(model).items()}
    return jmod.params_from_torch_state_dict(sd, cfg_j)


@pytest.fixture(scope="module")
def vae_pair():
    model = tvae.init_params(tvae.WanVAEConfig(dim=16, z_dim=Z), seed=1, device="cpu")
    # the attention's proj starts at zero: give it weights, so the mid-block counts
    gen = torch.Generator().manual_seed(1)
    for layers in (model["encoder"], model["decoder"]):
        for p in layers:
            if "to_qkv" in p:
                p["proj"]["w"].normal_(0.0, 0.05, generator=gen)
    cfg_j = jvae.WanVAEConfig(dim=16, z_dim=Z, dtype=jnp.float32)
    return cfg_j, _to_jax(jvae, tvae, model, cfg_j), model


def test_tiles_and_masks_match_svi_tpu():
    for args in ((48, 64, (32, 32), (16, 16)), (60, 104, (30, 52), (15, 26)),
                 (4, 6, (2, 4), (1, 2)), (8, 8, (34, 34), (18, 16))):
        assert tvae._tile_tasks(*args) == jvae._tile_tasks(*args)
    for shape, bound, border in (((4, 6), (True, False, False, True), (1, 2)),
                                 ((16, 32), (False, False, True, False), (8, 16)),
                                 ((3, 3), (False, False, False, False), (5, 5))):
        np.testing.assert_array_equal(tvae.build_mask(shape, bound, border).numpy(),
                                      np.asarray(jvae.build_mask(shape, bound, border)))


def test_tiled_encode_matches_svi_tpu(vae_pair):
    cfg_j, params, model = vae_pair
    # one frame: the tiles are spatial, and the temporal path is
    # tests/test_torch_models.py's
    video = np.random.default_rng(0).uniform(-1, 1, (1, 3, 1, 32, 48)).astype(np.float32)
    size, stride = (24, 32), (8, 16)  # pixels: 2 x 2 tiles of 24 x 32
    want = np.asarray(jvae.tiled_encode(params, cfg_j, jnp.asarray(video), size, stride))
    with torch.inference_mode():
        got = model.tiled_encode(torch.from_numpy(video), size, stride).numpy()
        whole = model.encode(torch.from_numpy(video)).numpy()
    assert got.shape == want.shape == whole.shape == (1, Z, 1, 4, 6)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    assert np.abs(got - whole).max() > 1e-3  # the tiles blended, not one whole-frame encode


def test_tiled_decode_matches_svi_tpu(vae_pair):
    cfg_j, params, model = vae_pair
    lat = np.random.default_rng(1).standard_normal((1, Z, 1, 4, 6)).astype(np.float32)
    size, stride = (3, 4), (1, 2)  # latent units: 2 x 2 tiles
    want = np.asarray(jvae.tiled_decode(params, cfg_j, jnp.asarray(lat), size, stride))
    with torch.inference_mode():
        got = model.tiled_decode(torch.from_numpy(lat), size, stride).numpy()
        whole = model.decode(torch.from_numpy(lat)).numpy()
    assert got.shape == want.shape == whole.shape == (1, 3, 1, 32, 48)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    assert np.abs(got).max() <= 1.0 and np.abs(got - whole).max() > 1e-3


@pytest.fixture(scope="module")
def pipelines(vae_pair):
    cfg_jv, vparams, tvae_model = vae_pair
    dit_kw = dict(dim=64, in_dim=2 * Z + 4, ffn_dim=128, out_dim=Z, text_dim=64, freq_dim=32,
                  num_heads=2, num_layers=2, has_image_input=True, clip_feature_dim=40)
    clip_kw = dict(image_size=28, patch_size=14, dim=40, mlp_ratio=2, num_heads=2,
                   num_layers=2)
    t5_kw = dict(vocab=32128, dim=64, dim_attn=64, dim_ffn=96, num_heads=4, num_layers=2)
    tpipe = TorchPipeline(device="cpu", torch_dtype=torch.float32, tokenizer_path=PORT_T5)
    tpipe.vae = tvae_model
    tpipe.dit = tdit.init_params(tdit.WanDiTConfig(dtype=torch.float32, **dit_kw), seed=2,
                                 device="cpu")
    tpipe.image_encoder = tclip.init_params(tclip.ClipVisionConfig(**clip_kw), seed=3,
                                            device="cpu")
    tpipe.text_encoder = tt5.init_params(tt5.T5Config(dtype=torch.float32, **t5_kw), seed=4,
                                         device="cpu")
    tpipe.prompter.fetch_models(tpipe.text_encoder)

    jd_cfg = jdit.WanDiTConfig(dtype=jnp.float32, **dit_kw)
    jc_cfg = jclip.ClipVisionConfig(dtype=jnp.float32, **clip_kw)
    jt_cfg = jt5.T5Config(dtype=jnp.float32, **t5_kw)
    jpipe = JaxPipeline(torch_dtype=jnp.float32, tokenizer_path=asset_path("t5"))
    jpipe.vae = (vparams, cfg_jv)
    jpipe.dit = (_to_jax(jdit, tdit, tpipe.dit, jd_cfg), jd_cfg)
    jpipe.image_encoder = (_to_jax(jclip, tclip, tpipe.image_encoder, jc_cfg), jc_cfg)
    jpipe.text_encoder = (_to_jax(jt5, tt5, tpipe.text_encoder, jt_cfg), jt_cfg)
    jpipe.prompter.fetch_models(jpipe.text_encoder)
    return jpipe, tpipe


def _call_kwargs():
    rng = np.random.default_rng(3)
    lt, lh, lw = (NF - 1) // 4 + 1, H // 8, W // 8
    return dict(
        prompt="A lone explorer walks across rolling green hills.",
        negative_prompt="blurred, static, overexposed",
        input_image=[rng.integers(0, 255, (H, W, 3), dtype=np.uint8)],
        random_ref_frame=rng.integers(0, 255, (H, W, 3), dtype=np.uint8),
        input_video=[rng.integers(0, 255, (H, W, 3), dtype=np.uint8) for _ in range(NF)],
        denoising_strength=0.7, seed=4, height=H, width=W, num_frames=NF, cfg_scale=5.0,
        num_inference_steps=STEPS, tiled=True, tile_size=(3, 4), tile_stride=(1, 2),
        last_latent=rng.standard_normal((1, lt, lh, lw)).astype(np.float32),
        y_extra=0.1 * rng.standard_normal((1, 4 + Z, lt, lh, lw)).astype(np.float32),
        args=types.SimpleNamespace(sequential_cfg="latent", ref_pad_num=-1, ref_pad_cfg=False))


def test_call_with_prompts_tiles_video_and_conditioning_matches_svi_tpu(pipelines):
    jpipe, tpipe = pipelines
    kwargs = _call_kwargs()
    frames_j, last_j = jpipe(**kwargs)
    steps = []
    frames_t, last_t = tpipe(**kwargs, progress_bar_cmd=lambda r: (steps.append(i) or i
                                                                  for i in r))
    assert steps == list(range(STEPS))
    assert last_t.shape == last_j.shape == (1, 2, H // 8, W // 8)  # latents[:, -1]
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), atol=LATENT_TOL, rtol=0)
    frames_t = np.stack(frames_t)
    frames_j = np.stack([np.asarray(f) for f in frames_j])
    assert frames_t.shape == frames_j.shape == (NF, H, W, 3) and frames_t.dtype == np.uint8
    diff = np.abs(frames_t.astype(np.int16) - frames_j.astype(np.int16))
    assert diff.max() <= FRAME_LEVELS, diff.max()
    # each option moved the result: without them the clip differs
    plain = dict(kwargs, input_video=None, last_latent=None, y_extra=None, tiled=False,
                 args=None, ref_pad_num=-1)
    other = np.stack(tpipe(**plain))
    assert np.abs(other.astype(np.int16) - frames_t.astype(np.int16)).max() > FRAME_LEVELS


def test_add_condition_is_not_ported(pipelines):
    _, tpipe = pipelines
    with pytest.raises(NotImplementedError, match="Slice D"):
        tpipe(prompt="a", add_condition=np.zeros(1))
