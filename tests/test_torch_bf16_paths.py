"""The port's bf16 paths against svi_tpu on the CPU: the attention entries at
the head dims the card's bf16 kernel (csrc/flash_fwd_sm90.cu) serves, the SD
1.5 image pipeline in bf16, FLUX's VAE decode in the pipeline's bf16 (svi_tpu
casts the VAE to it; the port kept it in f32 before the bf16 kernel) and one
Hunyuan-DiT forward in bf16.

Both packages load the same seeded weights (tests/torch_sd_fixtures.py,
tests/torch_video_fixtures.py) cast to bf16 on both sides; inputs are seeded
numpy arrays rounded to bf16 once and handed to both.

Tolerances:
- attention: both sides compute in f32 from the same bf16 inputs and round
  out to bf16 once, so out is within one bf16 ulp of the larger magnitude
  (2^-7 relative: the f32 sums differ in order, which can move a value
  across a rounding boundary) plus F32_SUMS = 1e-5 of the output's largest
  magnitude (where a row's sum cancels to near zero, the f32 sums' order is
  larger than that value's ulp), lse within 1e-5;
- whole bf16 models: each package rounds to bf16 after every operation in
  its own places (XLA fuses elementwise chains and rounds at the end of a
  fusion; torch rounds after each op), so the two drift by bf16 roundings
  (2^-9 relative each) through every layer: two bf16 runs whose roundings
  are independent lie about sqrt(2) times as far apart as either lies from
  f32. The bound is BF16_MODEL_REL = 5e-2 of the output's largest
  magnitude for one model call (FLUX's decode, Hunyuan-DiT's forward; each
  SD 1.5 model alone reads 1.3-2.1e-2) and BF16_PIPELINE_REL = 0.15 for
  the SD pipeline, whose 2 steps at CFG 7.5 amplify each step's difference
  (svi_tpu's own bf16 run lies 8.4e-2 from its f32 run there), and in both
  DTYPE_SPREAD = 2 times the distance between svi_tpu's bf16 run and an f32
  run of the same weights (the port's, which the f32 tests hold to
  svi_tpu's within 1e-4); that the port runs in bf16 where svi_tpu does is
  checked on the weights' and the outputs' dtypes;
- one bf16 convolution: bit for bit (svi_tpu adds the bias to the rounded
  convolution in bf16, and so does the port's `ops.conv.conv_f32`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import flux as jflux
from svi_tpu.models import hunyuan_dit as jhy
from svi_tpu.models import sd as jsd
from svi_tpu.models import sd3 as jsd3
from svi_tpu.ops import attention as jattn
from svi_tpu.pipelines import sd_image as jimage
from svi_tpu_torch.models import flux as tflux
from svi_tpu_torch.models import hunyuan_dit as thy
from svi_tpu_torch.models import sd as tsd
from svi_tpu_torch.models import sd3 as tsd3
from svi_tpu_torch.ops import attention as tattn
from svi_tpu_torch.pipelines import flux_image as tflux_pipe
from svi_tpu_torch.pipelines import sd_image as timage

import torch_sd_fixtures as fx
import torch_video_fixtures as vfx

BF16_ULP, F32_SUMS, LSE_TOL = 2.0 ** -7, 1e-5, 1e-5
BF16_MODEL_REL, BF16_PIPELINE_REL, DTYPE_SPREAD = 5e-2, 0.15, 2.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


def _bf16_pair(x: np.ndarray):
    """The same bf16 values for both packages."""
    t = torch.from_numpy(x).bfloat16()
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _jax_bf16(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)


def _assert_within_ulp(got: torch.Tensor, want) -> None:
    a, w = fx.np32(got), np.asarray(jnp.asarray(want, jnp.float32))
    assert a.shape == w.shape and np.isfinite(a).all()
    tol = BF16_ULP * np.maximum(np.abs(a), np.abs(w)) + F32_SUMS * np.abs(w).max()
    assert np.all(np.abs(a - w) <= tol)


def _assert_model_close(got, want, f32_want, bound=BF16_MODEL_REL) -> None:
    """got within `bound` of want and within DTYPE_SPREAD times the distance
    between want (bf16) and f32_want (an f32 run)."""
    got, want, f32_want = fx.np32(got), fx.np32(want), fx.np32(f32_want)
    assert got.shape == want.shape and np.isfinite(got).all()
    gap, dtype_gap = fx.rel(got, want), fx.rel(want, f32_want)
    assert gap <= bound, (gap, dtype_gap)
    assert gap <= DTYPE_SPREAD * dtype_gap, (gap, dtype_gap)


@pytest.mark.parametrize("d,n,sq,sk,kv_len", [(40, 8, 70, 70, None), (40, 8, 70, 77, None),
                                              (88, 16, 64, 45, 40), (160, 8, 16, 16, None)])
def test_bf16_attention_bnsd_matches_svi_tpu(d, n, sq, sk, kv_len):
    """svi_tpu's bf16 `attention_bnsd` (its XLA path on the CPU) and the
    port's (the plain version on the CPU; the card's route is "sm90") at the
    SD UNet's D40 self- and cross-attention, Hunyuan-DiT's D88 with masked
    keys and the SD UNet's D160 at AnimateDiff's 16 frames."""
    assert tattn._fwd_route(torch.bfloat16, d) == "sm90"
    rng = np.random.default_rng(d + sk)
    q, k, v = (rng.standard_normal((2, n, s, d)).astype(np.float32) for s in (sq, sk, sk))
    (jq, tq), (jk, tk), (jv, tv) = map(_bf16_pair, (q, k, v))
    want = jattn.attention_bnsd(jq, jk, jv, kv_len=kv_len)
    got = tattn.attention_bnsd(tq, tk, tv, kv_len=kv_len)
    assert got.dtype == torch.bfloat16
    _assert_within_ulp(got, want)
    want_o, want_l = jattn.flash_attention_with_lse(jq, jk, jv, kv_len=kv_len, force_xla=True)
    got_o, got_l = tattn.flash_fwd_bnsd(tq, tk, tv, kv_len=kv_len)
    _assert_within_ulp(got_o, want_o)
    np.testing.assert_allclose(fx.np32(got_l), np.asarray(want_l), atol=LSE_TOL, rtol=0)


def test_bf16_single_head_512_flat_matches_svi_tpu():
    """One head of 512 through the flat entry, as the VAE mid-blocks call it
    (K1's contract; the card's route is "sm90"), q, k, v column slices of
    one qkv tensor."""
    assert tattn._fwd_route(torch.bfloat16, 512) == "sm90"
    qkv = np.random.default_rng(5).standard_normal((1, 96, 3 * 512)).astype(np.float32)
    jqkv, tqkv = _bf16_pair(qkv)
    want = jattn.flash_attention_flat(jqkv[..., :512], jqkv[..., 512:1024], jqkv[..., 1024:],
                                      512)
    got = tattn.flash_attention_flat(tqkv[..., :512], tqkv[..., 512:1024], tqkv[..., 1024:],
                                     512)
    assert got.dtype == torch.bfloat16
    _assert_within_ulp(got, want)


@pytest.fixture(scope="module")
def sd_sds():
    mp = pytest.MonkeyPatch()
    fx.patch_narrow_plans(mp)
    out = fx.state_dicts(seed=7)
    mp.undo()
    return out


def test_sd_image_pipeline_bf16_matches_svi_tpu(sd_sds, monkeypatch):
    """SDImagePipeline(dtype=bf16) at 64 x 64, 2 steps, CFG 7.5 (one UNet
    batch of two), the narrow SD 1.5 plans (2 heads a block): the UNet, the
    text encoder and the VAE decoder in bf16 in both packages; the decoded
    image before the uint8 cast. svi_tpu's UNet call is unjitted at the top
    (its blocks jitted, fx.jit_jax_blocks)."""
    fx.patch_narrow_plans(monkeypatch)
    fx.jit_jax_blocks(monkeypatch)
    kinds = ("sd_unet", "sd_text_encoder", "sd_vae_decoder")
    jm = {"sd_unet": jsd.sd_unet_params_from_torch,
          "sd_text_encoder": jsd.sd_text_encoder_params_from_torch,
          "sd_vae_decoder": jsd.sd_vae_decoder_params_from_torch}
    tm = {"sd_unet": tsd.sd_unet_params_from_torch,
          "sd_text_encoder": tsd.sd_text_encoder_params_from_torch,
          "sd_vae_decoder": tsd.sd_vae_decoder_params_from_torch}
    jp = {k: jm[k](fx.to_numpy(sd_sds[k])) for k in kinds}
    kw = dict(prompt="a lighthouse on a cliff at dusk", negative_prompt="blurry",
              height=64, width=64, num_inference_steps=2, seed=0)
    cls = jimage.SDImagePipeline
    monkeypatch.setattr(cls, "_cfg_unet_impl", staticmethod(cls._cfg_unet_impl.__wrapped__))
    jpipe = cls(jp["sd_unet"], jp["sd_text_encoder"], vae_decoder_params=jp["sd_vae_decoder"],
                dtype=jnp.bfloat16)
    jpipe._decode = lambda latents, **kw: jsd.sd_vae_decode(jpipe.vae_decoder_params, latents,
                                                            **kw)
    jpipe.vae_output_to_image = lambda out: np.asarray(jnp.asarray(out, jnp.float32))
    want = jpipe(**kw)
    outs = {}
    for dt in (torch.bfloat16, torch.float32):
        tpipe = timage.SDImagePipeline(*(tm[k](sd_sds[k], device="cpu") for k in kinds[:2]),
                                       vae_decoder=tm["sd_vae_decoder"](
                                           sd_sds["sd_vae_decoder"], device="cpu"), dtype=dt)
        assert all(p.dtype == dt for p in tpipe.unet.parameters())
        tpipe.vae_output_to_image = lambda out: out
        outs[dt] = tpipe(**kw)
    got = outs[torch.bfloat16]
    assert got.dtype == torch.bfloat16 and got.shape == (1, 3, 64, 64)
    _assert_model_close(got, want, outs[torch.float32], BF16_PIPELINE_REL)


def _flux_vae_plans(monkeypatch):
    enc, dec = fx.sd3_vae_plans()
    for mod in (jsd3, tsd3, jflux, tflux):
        monkeypatch.setattr(mod, "SD3_VAE_ENCODER_PLAN", enc)
        monkeypatch.setattr(mod, "SD3_VAE_DECODER_PLAN", dec)


def test_flux_pipeline_decodes_in_its_bf16(monkeypatch):
    """FluxImagePipeline at its default dtype casts the VAE to bf16, as
    svi_tpu's does (no f32 VAE is kept), and its decode of bf16 latents
    matches svi_tpu's `flux_vae_decode` on the same bf16 weights; the
    narrow 16-channel VAE of tests/test_torch_flux.py."""
    _flux_vae_plans(monkeypatch)
    fx.jit_jax_blocks(monkeypatch)
    assert not hasattr(tflux_pipe, "VAE_DTYPE")
    sds = fx.flux_state_dicts(seed=31)
    dit = tflux.flux_dit_params_from_torch(sds["dit"], device="cpu")
    tvae = tflux.flux_vae_decoder_params_from_torch(sds["vae_decoder"], device="cpu")
    pipe = tflux_pipe.FluxImagePipeline(dit, vae_decoder_params=tvae)
    assert pipe.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in pipe.vae_decoder_params.parameters())
    lat = (np.random.default_rng(3).standard_normal((1, 16, 8, 8)) * 0.5).astype(np.float32)
    jlat, tlat = _bf16_pair(lat)
    jvae = jflux.flux_vae_decoder_params_from_torch(fx.to_numpy(sds["vae_decoder"]))
    want = jflux.flux_vae_decode(_jax_bf16(jvae), jlat)
    with torch.no_grad():
        got = tflux.flux_vae_decode(pipe.vae_decoder_params, tlat.to(pipe.dtype))
        f32_want = tflux.flux_vae_decode(tflux.flux_vae_decoder_params_from_torch(
            sds["vae_decoder"], device="cpu"), tlat.float())
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, 3, 64, 64)
    _assert_model_close(got, want, f32_want)


def test_hunyuan_dit_forward_bf16_matches_svi_tpu(monkeypatch):
    """One Hunyuan-DiT forward in bf16 (the narrow DiT of
    tests/test_torch_hunyuan_dit.py: 16 heads of 8; on the card its 16 heads
    of 88 take route "sm90"), B2 as CFG batches it, 8 x 8 latents."""
    assert tattn._fwd_route(torch.bfloat16, 88) == "sm90"
    fx.patch_narrow_plans(monkeypatch)
    sds = vfx.hunyuan_dit_state_dicts(seed=51)
    jdit = jhy.hunyuan_dit_params_from_torch(fx.to_numpy(sds["dit"]))
    tdit = thy.hunyuan_dit_params_from_torch(sds["dit"], device="cpu", dtype=torch.bfloat16)
    rng = np.random.default_rng(52)
    d = vfx.HY_DIT
    mask = np.ones((2, 77), np.int64)
    mask[:, 40:] = 0
    mask_t5 = np.ones((2, 256), np.int64)
    mask_t5[:, 100:] = 0
    floats = [rng.standard_normal((2, 4, 8, 8)).astype(np.float32),
              (rng.standard_normal((2, 77, d["text_dim"])) * 0.3).astype(np.float32),
              (rng.standard_normal((2, 256, d["t5_dim"])) * 0.3).astype(np.float32)]
    pairs = [_bf16_pair(x) for x in floats]
    t = np.array([391.0, 391.0], np.float32)
    size = np.array([[128.0, 128, 128, 128, 0, 0]] * 2, np.float32)
    freqs = jhy.calc_rope(64, 64, head_size=vfx.HY_HEAD)
    fwd = jax.jit(jhy.hunyuan_dit_forward, static_argnames=("num_layers_down",))
    jargs = [p[0] for p in pairs] + [jnp.asarray(mask), jnp.asarray(mask_t5)]
    want = fwd(_jax_bf16(jdit), *jargs, jnp.asarray(t, jnp.bfloat16),
               jnp.asarray(size, jnp.bfloat16), freqs, num_layers_down=vfx.HY_DOWN)
    masks = (torch.from_numpy(mask), torch.from_numpy(mask_t5))
    with torch.no_grad():
        got = thy.hunyuan_dit_forward(
            tdit, *(p[1] for p in pairs), *masks, torch.from_numpy(t).bfloat16(),
            torch.from_numpy(size).bfloat16(), freqs, num_layers_down=vfx.HY_DOWN)
        f32_want = thy.hunyuan_dit_forward(
            thy.hunyuan_dit_params_from_torch(sds["dit"], device="cpu"),
            *(p[1].float() for p in pairs), *masks, torch.from_numpy(t),
            torch.from_numpy(size), freqs, num_layers_down=vfx.HY_DOWN)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 4, 8, 8)
    _assert_model_close(got, want, f32_want)


def test_bf16_conv_adds_its_bias_as_svi_tpu_does():
    """The SD family's convolution (`models.sd._conv2d`, over
    `ops.conv.conv_f32`) in bf16: the bias is added to the rounded
    convolution in bf16, as svi_tpu's `_conv2d` does, so the two agree bit
    for bit (a bias inside the convolution moved 30% of these values by an
    ulp)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 32, 16, 16)).astype(np.float32)
    w = (rng.standard_normal((48, 32, 3, 3)) * 0.1).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = map(_bf16_pair, (x, w, b))
    want = jax.jit(jsd._conv2d)({"w": jw.transpose(2, 3, 1, 0), "b": jb},
                                jx.transpose(0, 2, 3, 1))
    got = tsd._conv2d({"w": tw, "b": tb}, tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(fx.np32(got), np.asarray(want.astype(jnp.float32)).transpose(
        0, 3, 1, 2))


def test_hunyuan_image_pipeline_bf16_matches_svi_tpu(monkeypatch):
    """HunyuanDiTImagePipeline(dtype=bf16) through its normal entry point on
    the narrow DiT (16 heads of 8) and the narrow SD VAE, 64 x 64, 2 steps,
    CFG 5 as two passes, seeded embedding tables for BERT and mT5 (the same
    callables in both packages): the decoded image before the uint8 cast.
    svi_tpu's block is jitted once per shape, its pipeline's whole-model
    jits off (as tests/test_torch_hunyuan_dit.py runs it)."""
    import functools
    import types

    from svi_tpu.pipelines import hunyuan_image as jpipe_mod
    from svi_tpu.prompters import hunyuan_dit_prompter as jprompt
    from svi_tpu.prompters import sp_tokenizer as jsp
    from svi_tpu_torch.pipelines import hunyuan_image as tpipe_mod
    from svi_tpu_torch.prompters import hunyuan_dit_prompter as tprompt
    from svi_tpu_torch.prompters import sp_tokenizer as tsp

    fx.patch_narrow_plans(monkeypatch)
    fx.jit_jax_blocks(monkeypatch)
    monkeypatch.setattr(jhy, "_block", _JAX_HY_BLOCK.setdefault("block", jax.jit(
        jhy._block, static_argnames=("num_heads", "head_dim"))))
    monkeypatch.setattr(jpipe_mod, "jax", types.SimpleNamespace(jit=lambda f, **kw: f,
                                                                tree=jax.tree))
    for mod in (jhy, thy):
        monkeypatch.setattr(mod, "calc_rope", functools.partial(mod.calc_rope,
                                                                 head_size=vfx.HY_HEAD))
    sds = vfx.hunyuan_dit_state_dicts(seed=51)
    d = vfx.HY_DIT
    tables = [np.random.default_rng(s).standard_normal((v, w)).astype(np.float32) * 0.3
              for s, v, w in ((1, 50000, d["text_dim"]), (2, 32128, d["t5_dim"]))]

    def encoder(table):
        t = torch.from_numpy(table)
        return lambda ids, mask, clip_skip=1: (t[torch.as_tensor(np.asarray(ids)).long()
                                                  % t.shape[0]]
                                                * torch.as_tensor(np.asarray(mask))[..., None]
                                                .float() / clip_skip)

    bert, mt5 = map(encoder, tables)
    kw = dict(negative_prompt="模糊", cfg_scale=5.0, height=64, width=64, num_inference_steps=2,
              seed=9)
    decoded = {}
    jdit = jhy.hunyuan_dit_params_from_torch(fx.to_numpy(sds["dit"]))
    jdec = jsd.sd_vae_decoder_params_from_torch(fx.to_numpy(sds["vae_decoder"]))
    jpipe = jpipe_mod.HunyuanDiTImagePipeline(jdit, jpipe_mod.HunyuanTextEncoderWrapper(
        bert, None, mt5, jsp.default_t5_tokenizer()), vae_decoder_params=jdec,
        dtype=jnp.bfloat16, num_layers_down=vfx.HY_DOWN)
    jpipe.vae_output_to_image = lambda out, f=jpipe.vae_output_to_image: (
        decoded.setdefault("jax", np.asarray(jnp.asarray(out, jnp.float32))), f(out))[1]
    jpipe("a cat 在窗台上 sleeping", **kw)
    for dt in (torch.bfloat16, torch.float32):
        tpipe = tpipe_mod.HunyuanDiTImagePipeline(
            thy.hunyuan_dit_params_from_torch(sds["dit"], device="cpu"),
            tpipe_mod.HunyuanTextEncoderWrapper(bert, None, mt5, tsp.default_t5_tokenizer()),
            vae_decoder_params=tsd.sd_vae_decoder_params_from_torch(sds["vae_decoder"],
                                                                   device="cpu"),
            dtype=dt, num_layers_down=vfx.HY_DOWN)
        assert all(p.dtype == dt for p in tpipe.dit_params.parameters())
        tpipe.vae_output_to_image = lambda out, _dt=dt, f=tpipe.vae_output_to_image: (
            decoded.setdefault(_dt, out), f(out))[1]
        got = tpipe("a cat 在窗台上 sleeping", **kw)
    assert got.shape == (64, 64, 3) and decoded[torch.bfloat16].dtype == torch.bfloat16
    _assert_model_close(decoded[torch.bfloat16], decoded["jax"], decoded[torch.float32],
                        BF16_PIPELINE_REL)


_JAX_HY_BLOCK = {}
