"""Quantized inference of the PyTorch port against svi_tpu's, on the CPU.

The weight quantizers and K3's plain version must agree bit for bit (after
the port's (out, in) layout transpose); the quantized dense, K6's plain
version, a tiny quantized DiT forward and the tiny two-clip pipeline with
int4_w4a8 weights agree within the tolerances stated beside each test.
Where svi_tpu reaches a Pallas kernel (K3, K6) it runs in interpret mode, as
its own tests run it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from svi_tpu.models import wan_dit as jdit
from svi_tpu.ops import attention as jattn
from svi_tpu.ops import quant_matmul as jqm
from svi_tpu.ops.rope import rope_angles_for_grid
from svi_tpu_torch.models import wan_dit as tdit
from svi_tpu_torch.ops import attention as tattn
from svi_tpu_torch.ops import quant_matmul as tqm

MODES = tdit.QUANTIZE_MODES
# tiny configs quantize every linear of 1024 elements or more, in groups of
# 16 inputs, as the JAX package's own quantization tests do
MIN_SIZE, GROUP = 1024, 16


def _host(params):
    return jax.tree.map(np.asarray, params)


def _leaves(tree, path=()):
    """Flat {path: tensor} of a nested dict/list tree of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, path + (i,)))
        return out
    return {path: tree}


# a DiT whose self-attention has one head of 128 (the int8 attention forward
# takes the flat layout only), I2V with every kind of linear
DIT_KW = dict(dim=128, in_dim=12, ffn_dim=256, out_dim=4, text_dim=48, freq_dim=32,
              num_heads=1, num_layers=2, has_image_input=True, clip_feature_dim=40)


def _dits(attention_quant="none"):
    cfg_j = jdit.WanDiTConfig(dtype=jnp.float32, attention_quant=attention_quant, **DIT_KW)
    cfg_t = tdit.WanDiTConfig(dtype=torch.float32, attention_quant=attention_quant, **DIT_KW)
    params = jdit.init_params(jax.random.PRNGKey(7), cfg_j)
    return params, cfg_j, cfg_t


def _jax_quantized(params, mode):
    return jdit.quantize_params_for_inference(params, mode, min_size=MIN_SIZE, group=GROUP)


# ---------------------------------------------------------------------------
# (a) the quantizers, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_quantizers_bit_exact(mode):
    params, _, cfg_t = _dits()
    want = tdit.params_from_jax(_host(_jax_quantized(params, mode)), cfg_t)
    dit = tdit.params_from_jax(_host(params), cfg_t)
    got = tdit.quantize_params_for_inference(dit, mode, min_size=MIN_SIZE, group=GROUP,
                                             consume=True)
    assert isinstance(got, tdit.WanDiT) and got.cfg == cfg_t
    assert len(list(dit.parameters())) == 0  # consumed
    w, g = _leaves(want.tree()), _leaves(got.tree())
    assert sorted(map(str, w)) == sorted(map(str, g))
    quantized = [p for p in g if p[-1] in ("w_q4", "w_q8", "w_q")]
    assert len(quantized) >= 20, quantized
    for path, t in w.items():
        assert g[path].dtype == t.dtype and g[path].shape == t.shape, path
        assert torch.equal(g[path], t), path
    # int4 needs in % group == 0: the patch embedding (in 48 = 12 x 4) is
    # quantized, the CLIP MLP's fc1 (in 40) is not; w8a8 and int8 take both
    fc1 = got["img_emb"]["fc1"]
    assert ("w" in fc1) == mode.startswith("int4")


def test_int4_group_128_bit_exact():
    """The production group size, on one (in 512, out 384) weight."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((512, 384)).astype(np.float32) * 0.02
    w[:256] *= 3.0  # group-scale variation within a channel
    want = jdit.quantize_params_int4({"w": jnp.asarray(w)}, min_size=1, w4a8=True)
    got = tdit.quantize_params_int4({"w": torch.from_numpy(w.T.copy())}, min_size=1, w4a8=True)
    assert sorted(got) == sorted(want) == ["r_q4", "s8_q4", "scale_q4", "w_q4"]
    for key in got:
        assert torch.equal(got[key], torch.from_numpy(np.asarray(want[key]).T.copy())), key


# ---------------------------------------------------------------------------
# (b) K3's plain version, bit for bit
# ---------------------------------------------------------------------------


def _xla_unpack_requant(wq, r):
    """The XLA unpack + requant of svi_tpu's `_dense` (wan_dit.py:284-292)."""
    lo = jnp.right_shift(jnp.left_shift(wq, 4), 4)
    hi = jnp.right_shift(wq, 4)
    w8 = jnp.concatenate([lo, hi], axis=0)
    g = w8.shape[0] // r.shape[0]
    return np.asarray(jnp.clip(jnp.round(w8.reshape(r.shape[0], g, -1).astype(jnp.float32)
                                         * r[:, None, :]), -127, 127)
                      .astype(jnp.int8).reshape(w8.shape))


@pytest.mark.parametrize("group", [128, 16])
def test_unpack_requant_reference_bit_exact(group):
    rng = np.random.default_rng(2)
    k, n = 512, 256
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
    w[: k // 2] *= 3.0
    q = jdit.quantize_params_int4({"w": jnp.asarray(w)}, min_size=1, group=group, w4a8=True)
    if group == 128:  # the Pallas kernel's own gate
        want = np.asarray(jqm.unpack_requant_int4(q["w_q4"], q["r_q4"], interpret=True))
    else:
        want = _xla_unpack_requant(q["w_q4"], q["r_q4"])
    wq_t = torch.from_numpy(np.asarray(q["w_q4"]).T.copy())
    r_t = torch.from_numpy(np.asarray(q["r_q4"]).T.copy())
    assert tqm.supports_unpack_requant(wq_t, r_t)
    before = tqm.unpack_requant_int4.launches
    got = tqm.unpack_requant_int4(wq_t, r_t)  # CPU tensors: the plain version
    assert tqm.unpack_requant_int4.launches == before
    assert got.dtype == torch.int8 and torch.equal(got, torch.from_numpy(want.T.copy()))


# ---------------------------------------------------------------------------
# (c) the dense in every mode, and the straight-through gradient
# ---------------------------------------------------------------------------

# the int8 paths quantize the same f32 activations to the same int8 values on
# both sides and their int32 products are exact: only the f32 epilogue may
# round apart. The int4 / int8 storage modes dequantize to f32 weights and
# then run an f32 matmul, summed in another order.
DENSE_TOL = 2e-5


@pytest.mark.parametrize("mode", MODES + ("none",))
def test_dense_matches_jax(mode):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((256, 96)).astype(np.float32) * 0.05
    b = rng.standard_normal((96,)).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 20, 256)).astype(np.float32)
    tree = {"lin": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}
    if mode != "none":
        tree = jdit.quantize_params_for_inference(tree, mode, min_size=MIN_SIZE, group=GROUP)
    want = np.asarray(jdit._dense(tree["lin"], jnp.asarray(x)))
    ptree = {"lin": {"w": torch.from_numpy(w.T.copy()), "b": torch.from_numpy(b)}}
    if mode != "none":
        ptree = tdit.quantize_params_for_inference(ptree, mode, min_size=MIN_SIZE, group=GROUP)
    p = tdit.ParamTree(ptree)["lin"]
    got = tdit.dense(p, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=DENSE_TOL, atol=DENSE_TOL)


@pytest.mark.parametrize("mode", ["w8a8", "int4_w4a8"])
def test_int8_exec_straight_through_grad_matches_jax(mode):
    """dx of sum(dense(x)^2) through `_int8_exec`'s straight-through backward,
    against jax.grad of the JAX dense (f32: products summed in another order)."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((512, 768)).astype(np.float32) * 0.05
    x = rng.standard_normal((32, 512)).astype(np.float32)
    jtree = jdit.quantize_params_for_inference({"q": {"w": jnp.asarray(w)}}, mode,
                                               min_size=MIN_SIZE)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jdit._dense(jtree["q"], a) ** 2))(
        jnp.asarray(x)))
    ptree = tdit.quantize_params_for_inference({"q": {"w": torch.from_numpy(w.T.copy())}},
                                               mode, min_size=MIN_SIZE)
    xt = torch.from_numpy(x).requires_grad_()
    (tdit.dense(tdit.ParamTree(ptree)["q"], xt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# (d) K6's operand prep and plain version
# ---------------------------------------------------------------------------


def _attn_inputs(s=448, n=2, d=128, seed=6):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, s, n * d)).astype(np.float32) for _ in range(3))
    k = k + 0.7  # biased K channels: the centring must absorb this
    cos, sin = rope_angles_for_grid((7, 8, 8), d)
    return q, k, v, cos[:s], sin[:s]


@pytest.mark.parametrize("pv8", [False, True])
def test_quant_prep_matches_jax(pv8):
    """Same quantization of the same f32 inputs: scales to f32 rounding; an
    int8 value may differ by one level where the centred K (a mean, summed in
    another order) or a rotated value sits on a rounding boundary."""
    q, k, v, cos, sin = _attn_inputs()
    want = jattn._quant_prep_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(cos), jnp.asarray(sin), True, 128, pv8)
    got = tattn._quant_prep(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(cos), torch.from_numpy(sin), 128, pv8)
    names = ("q8", "qs", "k8", "kscale", "v8", "vss")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w).reshape(tuple(g.shape))
        if g.dtype == torch.int8:
            diff = np.abs(g.numpy().astype(int) - w.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (name, diff.max())
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.parametrize("quant", ["qk8", "qk8pv8"])
def test_q8_reference_matches_jax_kernel(quant):
    """`_flash_fwd_q8_reference` at the JAX kernel's blocks (block_k 512 in 4
    sub-blocks of 128, keys padded 448 -> 512: a masked tail) on the JAX
    prep's own operands, against `_fwd_kernel_flat_q8` in interpret mode.
    Same integer scores, same max, same order of f32 steps: what remains is
    exp2 and the sums' order (f32 ulps), and for qk8pv8 a P that lands on
    the other side of a rounding boundary (one level of 127 in one term)."""
    q, k, v, cos, sin = _attn_inputs()
    s, d, pad = q.shape[1], 128, 512 - q.shape[1]
    pv8 = quant == "qk8pv8"
    q8, qs, k8, kscale, v8, vss = jattn._quant_prep_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cos), jnp.asarray(sin),
        True, d, pv8)
    v_in = v8 if pv8 else jnp.asarray(v)
    with pltpu.force_tpu_interpret_mode():
        out, lse = jattn._flash_fwd_pallas_flat_q8(
            jnp.pad(q8, ((0, 0), (0, pad), (0, 0))),
            jnp.pad(qs, ((0, 0), (0, 0), (0, pad), (0, 0))),
            jnp.pad(k8, ((0, 0), (0, pad), (0, 0))), jnp.pad(v_in, ((0, 0), (0, pad), (0, 0))),
            kscale, vss, s, d ** -0.5, 256, 512, d, 4, pv8, jnp.float32)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    got, got_lse = tattn._flash_fwd_q8_reference(
        t(q8), t(qs)[..., 0], t(k8), t(kscale), t(v_in), t(vss), s, d ** -0.5, torch.float32,
        block_k=512, nsub=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(out)[:, :s], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[:, :, :s], rtol=0, atol=1e-5)


@pytest.mark.parametrize("quant", ["qk8", "qk8pv8"])
def test_quantized_attention_close_to_exact(quant):
    """flash_attention_flat(quant=...) on CPU tensors (prep + the plain
    version at the kernel's 64-key tiles) against exact attention, with the
    JAX package's own bounds for its interpret-mode kernel
    (tests/test_attention.py)."""
    q, k, v, cos, sin = _attn_inputs()
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn.flash_attention_flat(qt, kt, vt, 128, cos=cos, sin=sin, quant=quant).numpy()
    ref = tattn.flash_attention_flat(qt, kt, vt, 128, cos=cos, sin=sin).numpy()
    err = np.abs(got - ref)
    tol = 0.012 if quant == "qk8" else 0.03
    assert err.max() < tol and err.mean() < tol / 8, (err.max(), err.mean())
    np.testing.assert_allclose(got.mean(-1), ref.mean(-1), atol=6e-3)


# ---------------------------------------------------------------------------
# (e), (f) a tiny quantized DiT forward
# ---------------------------------------------------------------------------


def _dit_inputs(rng):
    # 3 latent frames of 4 x 4 patches: 48 tokens, under one 64-key tile
    x = rng.standard_normal((2, 4, 3, 8, 8)).astype(np.float32)
    y = rng.standard_normal((2, 8, 3, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 12, 48)).astype(np.float32)
    clip = rng.standard_normal((2, 5, 40)).astype(np.float32)
    t = np.array([731.0], np.float32)
    return x, t, ctx, clip, y


def _jax_q8_flat(q, k, v, head_dim, cos=None, sin=None, kv_len=None, scale=None,
                 force_xla=False, quant=None):
    """svi_tpu's flash_attention_flat as it runs on a TPU with quant set:
    `_quant_prep_xla`, the padding of `_flash_core_flat_fwd` (:1158-1172) and
    `_flash_fwd_pallas_flat_q8` in interpret mode. Off the TPU the JAX DiT
    ignores `quant` (attention.py:1438), so the test swaps this in."""
    if quant is None:
        return _JAX_FLAT(q, k, v, head_dim, cos=cos, sin=sin, kv_len=kv_len, scale=scale)
    b, sq, nd = q.shape
    sk = k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    scale = head_dim ** -0.5 if scale is None else scale
    block_q, block_k, nsub = jattn._choose_blocks_flat(sq, sk, head_dim)
    sq_p, sk_p = jattn._ceil_to(sq, block_q), jattn._ceil_to(sk, block_k)
    pv8 = quant == "qk8pv8"
    q8, qs, k8, kscale, v8, vss = jattn._quant_prep_xla(
        q, k, v, jnp.asarray(cos, jnp.float32)[:sq], jnp.asarray(sin, jnp.float32)[:sq],
        True, head_dim, pv8)
    v_in = v8 if pv8 else v
    q8 = jnp.pad(q8, ((0, 0), (0, sq_p - sq), (0, 0)))
    qs = jnp.pad(qs, ((0, 0), (0, 0), (0, sq_p - sq), (0, 0)))
    k8 = jnp.pad(k8, ((0, 0), (0, sk_p - sk), (0, 0)))
    v_in = jnp.pad(v_in, ((0, 0), (0, sk_p - sk), (0, 0)))
    with pltpu.force_tpu_interpret_mode():
        out, _ = jattn._flash_fwd_pallas_flat_q8(q8, qs, k8, v_in, kscale, vss, kv_len, scale,
                                                 block_q, block_k, head_dim, nsub, pv8,
                                                 q.dtype)
    return out[:, :sq]


_JAX_FLAT = jdit.flash_attention_flat

# Relative to the output's largest value, f32 through 2 blocks. The storage
# modes (int8, int4) dequantize identical weights: sums in another order
# only (measured ~4e-7). The int8 paths round activations (and, with
# attention_quant, Q, K and P) to int8 on both sides; a value computed in
# another order can land one level apart, and that level (~1% of a row's
# largest value) then moves later layers (measured: 2e-7 without such a
# flip, 1.2e-3 with qk8pv8). A wrong scale, layout or rounding mode gives
# errors of the output's own size.
DIT_TOL = {"int8": 1e-5, "int4": 1e-5, "w8a8": 5e-3, "int4_w4a8": 5e-3, "qk8": 5e-3,
           "qk8pv8": 1e-2}


def _forward_pair(mode, attention_quant, monkeypatch):
    params, cfg_j, cfg_t = _dits(attention_quant)
    if mode is not None:
        params = _jax_quantized(params, mode)
    model = tdit.params_from_jax(_host(params), cfg_t)
    inputs = _dit_inputs(np.random.default_rng(8))
    if attention_quant != "none":
        monkeypatch.setattr(jdit, "flash_attention_flat", _jax_q8_flat)
    want = np.asarray(jdit.forward(params, cfg_j, *(jnp.asarray(a) for a in inputs[:3]),
                                   clip_feature=jnp.asarray(inputs[3]),
                                   y=jnp.asarray(inputs[4])))
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in inputs[:3]),
                    clip_feature=torch.from_numpy(inputs[3]),
                    y=torch.from_numpy(inputs[4])).numpy()
    return got, want


@pytest.mark.parametrize("mode", MODES)
def test_quantized_dit_forward_matches_jax(mode, monkeypatch):
    got, want = _forward_pair(mode, "none", monkeypatch)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < DIT_TOL[mode], (mode, err)


@pytest.mark.parametrize("attention_quant", ["qk8", "qk8pv8"])
def test_attention_quant_dit_forward_matches_jax(attention_quant, monkeypatch):
    got, want = _forward_pair("int4_w4a8", attention_quant, monkeypatch)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < DIT_TOL[attention_quant], (attention_quant, err)
    # and the int8 attention really ran: it differs from the bf16-math forward
    plain, _ = _forward_pair("int4_w4a8", "none", monkeypatch)
    assert np.abs(got - plain).max() > 0


def test_attention_quant_config_is_validated():
    with pytest.raises(ValueError, match="attention_quant"):
        tdit.WanDiTConfig(attention_quant="fp8")


# ---------------------------------------------------------------------------
# (g) the two-clip slice with int4_w4a8 weights
# ---------------------------------------------------------------------------


# W4A8 rounds every linear's activations to int8 per token. f32 values that
# the two frameworks compute in another order can sit on the two sides of a
# rounding boundary; such a flip (one level, ~1% of a row's largest value,
# often in the time embedding, which reaches every token) is then amplified
# by CFG 5 over the steps. Measured on this slice: clip 1 agrees to 2e-6,
# clip 2 (TeaCache) to 0.038 max and 1.6e-3 mean abs latent error (|latent|
# ~0.95), frames to 2 levels. Missing a scale, a wrong packing or a wrong
# rounding mode moves latents by their own size.
SLICE_LAT_MAX, SLICE_LAT_MEAN, SLICE_FRAME_LEVELS = 0.1, 5e-3, 4


def test_two_clip_slice_int4_w4a8_matches_jax():
    """The tiny pipelines of tests/test_torch_pipeline.py with W4A8 DiTs (the
    port quantizes its own float weights, svi_tpu its own), two clips as the
    clip loop drives them, clip 2 with TeaCache. Clip 2's motion frame is
    svi_tpu's last frame of clip 1 for both: a W4A8 clip is chaotic in its
    input, one level of one pixel of the motion frame moves the port's own
    clip 2 by 0.09 in the latents (measured)."""
    from test_torch_pipeline import (H, MOTION, NF, STEPS, TEA_THRESH, W, _pipelines)

    rng = np.random.default_rng(0)
    first = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    anchor = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    ctx_pos = rng.standard_normal((1, 12, 48)).astype(np.float32)
    jpipe, tpipe = _pipelines()
    jparams, jcfg = jpipe.dit
    jpipe.dit = (jdit.quantize_params_for_inference(jparams, "int4_w4a8", min_size=MIN_SIZE,
                                                    group=GROUP), jcfg)
    tpipe.dit = tdit.quantize_params_for_inference(tpipe.dit, "int4_w4a8", min_size=MIN_SIZE,
                                                   group=GROUP, consume=True)
    assert "r_q4" in tpipe.dit["blocks"][0]["ffn"]["0"]

    def clip(pipe, motion, i):
        frames, lat = pipe(
            input_image=motion, random_ref_frame=anchor, seed=i, height=H, width=W,
            num_frames=NF, cfg_scale=5.0, num_inference_steps=STEPS, tiled=False,
            prompt_emb_posi=ctx_pos, prompt_emb_nega=ctx_pos * 0.5, ref_pad_num=-1,
            tea_cache_l1_thresh=TEA_THRESH if i == 1 else None,
            tea_cache_model_id="Wan2.1-I2V-14B-480P", return_latents=True)
        return np.stack([np.asarray(f) for f in frames]), np.asarray(lat, np.float32)

    motion = first
    for i in range(2):
        frames_j, lat_j = clip(jpipe, motion, i)
        frames_t, lat_t = clip(tpipe, motion, i)
        assert frames_t.shape == frames_j.shape == (NF, H, W, 3)
        err = np.abs(lat_t - lat_j)
        assert err.max() <= SLICE_LAT_MAX and err.mean() <= SLICE_LAT_MEAN, (i, err.max(),
                                                                            err.mean())
        diff = np.abs(frames_t.astype(np.int16) - frames_j.astype(np.int16))
        assert diff.max() <= SLICE_FRAME_LEVELS, (i, diff.max())
        motion = list(frames_j[-MOTION:])
    assert tpipe.last_tea_cache.skipped_steps == STEPS - 2
