"""The port's fidelity measures, `init_params_int4` and the clip-level
fidelity gate of the quantized modes, against svi_tpu on the CPU.

The gate runs the tiny shot pipeline of tests/test_torch_pipeline.py (its
DiT widened to one head of 128, so that the int8 attention runs) with a bf16
DiT, then with that DiT quantized to w8a8 and to int4_w4a8 with qk8
attention, in both packages: the same weights (quantized by svi_tpu and
carried with `params_from_jax`), inputs and seeds. Each package scores its
quantized clip against its own bf16 clip with `clip_psnr`; the two scores
must agree within GATE_DB. svi_tpu ignores attention_quant off the TPU, so
its DiT gets the interpret-mode int8 attention of tests/test_torch_quant.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import clip_vision as jclip
from svi_tpu.models import wan_dit as jdit
from svi_tpu.models import wan_vae as jvae
from svi_tpu.pipelines.svi_video import SVIVideoPipeline as JaxPipeline
from svi_tpu.utils import fidelity as jfid
from svi_tpu_torch.models import clip_vision as tclip
from svi_tpu_torch.models import wan_dit as tdit
from svi_tpu_torch.models import wan_vae as tvae
from svi_tpu_torch.pipelines.svi_video import SVIVideoPipeline as TorchPipeline
from svi_tpu_torch.utils import fidelity as tfid
from test_torch_quant import DIT_KW, DIT_TOL, GROUP, MIN_SIZE, _dit_inputs, _jax_q8_flat

# The gate: each package's PSNR of a quantized clip against its bf16 clip,
# port against svi_tpu (dB). The two run the same weights and seeds; what
# differs is the order of sums in bf16 and f32, and an activation that lands
# on the other side of an int8 rounding boundary in one of them. A wrong
# scale, packing or rounding mode moves a clip's PSNR by tens of dB.
GATE_DB = 0.5
Z, H, W, NF, STEPS = 4, 64, 64, 9, 4
GATE_DIT = dict(dim=128, in_dim=2 * Z + 4, ffn_dim=256, out_dim=Z, text_dim=48, freq_dim=32,
                num_heads=1, num_layers=2, has_image_input=True, clip_feature_dim=40)
GATE_MODES = ("w8a8", "int4_w4a8")


def _host(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# psnr / clip_psnr
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["uint8", "signed_unit", "peak_given", "identical"])
def test_psnr_matches_jax(case):
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (3, 8, 8, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 4, a.shape), 0, 255)
    kw = {}
    if case == "signed_unit":
        a, b = a / 127.5 - 1, b / 127.5 - 1
    elif case == "peak_given":
        kw = dict(peak=100.0)
    elif case == "identical":
        b = a
    got = tfid.psnr(a, b, **kw)
    assert isinstance(got, float)
    assert got == jfid.psnr(a, b, **kw)


def test_clip_psnr_matches_jax():
    rng = np.random.default_rng(1)
    a = [rng.integers(0, 256, (6, 5, 3), dtype=np.uint8) for _ in range(4)]
    b = [np.clip(f.astype(int) + rng.integers(-3, 4, f.shape), 0, 255).astype(np.uint8)
         for f in a]
    assert tfid.clip_psnr(a, b) == jfid.clip_psnr(a, b)
    with pytest.raises(ValueError, match="different shapes"):
        tfid.clip_psnr(a, b[:3])


# ---------------------------------------------------------------------------
# init_params_int4
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, path + (i,)).items()}
    return {path: tree}


def _int4_trees(w4a8):
    cfg_j = jdit.WanDiTConfig(dtype=jnp.float32, **DIT_KW)
    cfg_t = tdit.WanDiTConfig(dtype=torch.float32, **DIT_KW)
    jtree = jdit.init_params_int4(jax.random.PRNGKey(3), cfg_j, min_size=MIN_SIZE, group=GROUP,
                                  w4a8=w4a8)
    return jtree, cfg_j, cfg_t


@pytest.mark.parametrize("w4a8", [False, True])
def test_init_params_int4_layout_matches_jax(w4a8):
    """The keys, shapes and dtypes of params_from_jax(svi_tpu's
    init_params_int4), and the same constant scales and zero biases; the
    packed bytes are random (each package draws its own). The port's norm
    weights are ones; svi_tpu's block norms are drawn N(0, weight_scale),
    since their stacked (L, d) arrays pass its `ndim >= 2` weight test."""
    jtree, _, cfg_t = _int4_trees(w4a8)
    want = _leaves(tdit.params_from_jax(_host(jtree), cfg_t).tree())
    got = _leaves(tdit.init_params_int4(cfg_t, torch.Generator().manual_seed(3), device="cpu",
                                        min_size=MIN_SIZE, group=GROUP, w4a8=w4a8).tree())
    assert got.keys() == want.keys()
    for path, g in got.items():
        w = want[path]
        assert (g.shape, g.dtype, g.device.type) == (w.shape, w.dtype, "cpu"), path
        if path[-1] in ("scale_q4", "r_q4", "s8_q4", "b"):
            assert torch.equal(g, w), path
        if path[-2:] in (("norm_q", "w"), ("norm3", "w")):
            assert (g == 1).all(), path
    n_q4 = sum(p[-1] == "w_q4" for p in got)
    assert n_q4 > 0 and (sum(p[-1] == "r_q4" for p in got) == (n_q4 if w4a8 else 0))
    packed = got[("blocks", 0, "ffn", "0", "w_q4")]
    assert packed.min() < -100 and packed.max() > 100  # the whole byte range is drawn


@pytest.mark.parametrize("w4a8", [False, True])
def test_init_params_int4_forward_matches_jax(w4a8):
    """The forward on svi_tpu's int4 tree carried into the port, against
    svi_tpu's, within the quantized forward's bound of
    tests/test_torch_quant.py (int4: the same dequantized weights, sums in
    another order; int4_w4a8: int8 activations, one level may flip); and the
    port's own tree gives a finite output of the same shape."""
    jtree, cfg_j, cfg_t = _int4_trees(w4a8)
    inputs = _dit_inputs(np.random.default_rng(8))
    want = np.asarray(jdit.forward(jtree, cfg_j, *(jnp.asarray(a) for a in inputs[:3]),
                                   clip_feature=jnp.asarray(inputs[3]), y=jnp.asarray(inputs[4])))
    args = [torch.from_numpy(a) for a in inputs]
    with torch.inference_mode():
        got = tdit.params_from_jax(_host(jtree), cfg_t)(*args[:3], clip_feature=args[3],
                                                           y=args[4]).numpy()
        own = tdit.init_params_int4(cfg_t, torch.Generator().manual_seed(3), device="cpu",
                                    min_size=MIN_SIZE, group=GROUP, w4a8=w4a8)(
            *args[:3], clip_feature=args[3], y=args[4])
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < DIT_TOL["int4_w4a8" if w4a8 else "int4"], err
    assert own.shape == got.shape and torch.isfinite(own).all()


# ---------------------------------------------------------------------------
# the clip-level fidelity gate
# ---------------------------------------------------------------------------


def _gate_pipelines():
    """The two pipelines without their DiT: the VAE and CLIP are the port's
    seeded weights, carried into svi_tpu through its checkpoint readers
    (faster here than svi_tpu's own init, which compiles per shape)."""
    vae_cfg = dict(dim=16, z_dim=Z)
    clip_cfg = dict(image_size=28, patch_size=14, dim=40, mlp_ratio=2, num_heads=2, num_layers=2)
    tpipe = TorchPipeline(device="cpu", torch_dtype=torch.float32)
    tpipe.vae = tvae.init_params(tvae.WanVAEConfig(**vae_cfg), seed=1, device="cpu")
    tpipe.image_encoder = tclip.init_params(tclip.ClipVisionConfig(**clip_cfg), seed=3,
                                            device="cpu")
    numpy_sd = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
    jvae_cfg = jvae.WanVAEConfig(dtype=jnp.float32, **vae_cfg)
    jclip_cfg = jclip.ClipVisionConfig(dtype=jnp.float32, **clip_cfg)
    jpipe = JaxPipeline(torch_dtype=jnp.float32)
    jpipe.vae = (jvae.params_from_torch_state_dict(
        numpy_sd(tvae.torch_state_dict_from_params(tpipe.vae)), jvae_cfg), jvae_cfg)
    jpipe.image_encoder = (jclip.params_from_torch_state_dict(
        numpy_sd(tclip.torch_state_dict_from_params(tpipe.image_encoder)), jclip_cfg), jclip_cfg)
    return jpipe, tpipe


def _clip(pipe, **kw):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    ref = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    ctx = rng.standard_normal((1, 12, 48)).astype(np.float32)
    frames = pipe(input_image=img, random_ref_frame=ref, seed=0, height=H, width=W,
                  num_frames=NF, cfg_scale=5.0, num_inference_steps=STEPS, tiled=False,
                  prompt_emb_posi=ctx, prompt_emb_nega=ctx * 0.5, ref_pad_num=-1, **kw)
    return np.stack([np.asarray(f) for f in frames])


@pytest.fixture(scope="module")
def gate():
    """Each package's bf16 clip and its clips in the gate's modes."""
    jpipe, tpipe = _gate_pipelines()
    jcfg = jdit.WanDiTConfig(dtype=jnp.bfloat16, **GATE_DIT)
    jparams = jdit.init_params(jax.random.PRNGKey(2), jcfg)
    cfg_t = tdit.WanDiTConfig(dtype=torch.bfloat16, **GATE_DIT)
    clips = {}
    for mode in (None,) + GATE_MODES:
        tree = jparams if mode is None else jdit.quantize_params_for_inference(
            jparams, mode, min_size=MIN_SIZE, group=GROUP)
        quant = "none" if mode is None else "qk8"
        jpipe.dit = (tree, dataclasses.replace(jcfg, attention_quant=quant))
        tpipe.dit = tdit.params_from_jax(_host(tree), dataclasses.replace(cfg_t,
                                                                          attention_quant=quant))
        with pytest.MonkeyPatch.context() as mp:
            if mode is not None:
                mp.setattr(jdit, "flash_attention_flat", _jax_q8_flat)
            clips[mode] = (_clip(jpipe), _clip(tpipe))
    return clips


@pytest.mark.parametrize("mode", GATE_MODES)
def test_fidelity_gate_matches_jax(gate, mode):
    (jref, tref), (jq, tq) = gate[None], gate[mode]
    assert tq.shape == jq.shape == (NF, H, W, 3) and tq.dtype == np.uint8
    jpsnr, tpsnr = jfid.clip_psnr(jq, jref), tfid.clip_psnr(tq, tref)
    assert abs(tpsnr - jpsnr) <= GATE_DB, (mode, tpsnr, jpsnr)
    # the quantized clip differs from the bf16 one: the quantized path ran
    assert np.isfinite(tpsnr) and tpsnr < 100
