"""The post-processing extensions of the port (svi_tpu_torch.extensions: ESRGAN,
RIFE, FastBlend) and the smoothers they give `AutoVideoProcessor`, against
svi_tpu on the CPU.

ESRGAN and RIFE carry svi_tpu's `init_params` across (`params_from_jax`) and
also load one seeded state dict in the reference's naming through both
packages. FastBlend's OpenCV resizes are held to the installed cv2, which
svi_tpu calls.

Tolerances: f32 forwards within 1e-4 of the output's largest magnitude (two
f32 implementations); uint8 frames within one level; FastBlend's patch
operations bit for bit, and its NNFs and remapped styles exact on
integer-valued frames (integer sums in f32 are exact, so the JAX package's
arithmetic is matched step for step); cv2's INTER_LINEAR on an NNF bit for
bit (it is truncated to int32 next), its INTER_AREA within 1e-4 on 0-255
images (f32 sums in another order).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from svi_tpu.extensions import esrgan as jesr
from svi_tpu.extensions import fastblend as jfb
from svi_tpu.extensions import rife as jrife
from svi_tpu_torch.extensions import esrgan as tesr
from svi_tpu_torch.extensions import fastblend as tfb
from svi_tpu_torch.extensions import rife as trife

import torch_sd_fixtures as fx

F32_REL, LEVELS = 1e-4, 1
EBSYNTH = {"minimum_patch_size": 5, "num_iter": 2, "guide_weight": 10.0,
           "initialize": "identity", "tracking_window_size": 0}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _key(seed):
    """A key of XLA's own generator: svi_tpu's init_params compiles in a few
    seconds on it, where threefry's takes tens here."""
    return jax.random.key(seed, impl="unsafe_rbg")


def _uint8_frames(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _gap(got, want) -> int:
    return max(int(np.abs(np.asarray(g, int) - np.asarray(w, int)).max())
               for g, w in zip(got, want))


# -- ESRGAN -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def esrgan():
    cfg = jesr.RRDBNetConfig(num_feat=16, num_block=2, num_grow_ch=8)
    tcfg = tesr.RRDBNetConfig(num_feat=16, num_block=2, num_grow_ch=8)
    jp = jax.jit(lambda key: jesr.init_params(key, cfg))(_key(0))
    return cfg, tcfg, jp, tesr.params_from_jax(_np(jp), tcfg, device="cpu")


def test_esrgan_forward_and_upscale_match_jax(esrgan):
    """RRDBNet from svi_tpu's init_params and from one seeded state dict;
    ESRGAN.upscale's frames within one level."""
    cfg, tcfg, jp, tp = esrgan
    x = np.random.default_rng(1).random((2, 12, 20, 3)).astype(np.float32)
    want = jesr.esrgan_forward(jp, x)
    got = tesr.esrgan_forward(tp, torch.from_numpy(x))
    assert got.shape == want.shape == (2, 48, 80, 3) and fx.rel(got, want) <= F32_REL
    sd = tesr.esrgan_state_dict(3, cfg=tcfg)
    assert tesr.config_from_state_dict(sd) == tcfg
    jq = jesr.params_from_torch_state_dict(fx.to_numpy(sd), cfg)
    tq = tesr.params_from_torch_state_dict(sd, tcfg, device="cpu")
    assert fx.rel(tesr.esrgan_forward(tq, torch.from_numpy(x)),
                  jesr.esrgan_forward(jq, x)) <= F32_REL
    frames = _uint8_frames(3, 10, 14, seed=2)
    want = jesr.ESRGAN(jp, cfg).upscale([Image.fromarray(f) for f in frames], batch_size=2)
    got = tesr.ESRGAN(tp, tcfg).upscale(frames, batch_size=2)
    assert len(got) == 3 and got[0].shape == (40, 56, 3) and got[0].dtype == np.uint8
    assert _gap(got, want) <= LEVELS
    single = tesr.ESRGAN(tp, tcfg).upscale(frames[0])
    np.testing.assert_array_equal(single, got[0])


# -- RIFE ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rife():
    jp = jax.jit(lambda key: jrife.init_params(key, c=16))(_key(1))
    fwd = jax.jit(jrife.ifnet_forward, static_argnums=(2,))
    return jp, trife.params_from_jax(_np(jp), device="cpu"), fwd


def _jax_rife(cls, jp, fwd, **kw):
    """svi_tpu's RIFE wrapper on the shared jitted IFNet (one compile per shape)."""
    out = cls(jp, **kw)
    out._fwd = fwd
    return out


def test_rife_warp_and_ifnet_match_jax(rife):
    """The grid_sample warp against svi_tpu's gather (border-clamped, flows
    past the edges), the IFNet outputs, and the state-dict loader."""
    jp, tp, fwd = rife
    rng = np.random.default_rng(2)
    x = rng.random((2, 8, 12, 3)).astype(np.float32)
    flow = ((rng.random((2, 8, 12, 2)) - 0.5) * 8).astype(np.float32)
    assert fx.rel(trife.warp(torch.from_numpy(x), torch.from_numpy(flow)),
                  jrife.warp(jnp.asarray(x), jnp.asarray(flow))) <= F32_REL
    x = rng.random((2, 64, 96, 6)).astype(np.float32)
    jf, jm, jg = fwd(jp, x, (4, 2, 1))
    tf, tm, tg = trife.ifnet_forward(tp, torch.from_numpy(x))
    for got, want in ((tf[2], jf[2]), (tm, jm), (tg[2], jg[2]), (tg[0], jg[0])):
        assert got.shape == want.shape and fx.rel(got, want) <= F32_REL
    sd = trife.ifnet_state_dict(c=16, seed=4)
    jq = jrife.params_from_torch_state_dict({"module." + k: v for k, v in fx.to_numpy(sd).items()})
    tq = trife.params_from_torch_state_dict(sd, device="cpu")
    assert fx.rel(trife.ifnet_forward(tq, torch.from_numpy(x))[2][2],
                  fwd(jq, x, (4, 2, 1))[2][2]) <= F32_REL


@pytest.mark.parametrize("size", [(64, 96), (40, 72)])
def test_rife_interpolate_and_smooth_match_jax(rife, size):
    """RIFEInterpolater doubles 3 frames to 5, RIFESmoother keeps 4; a size
    off the 32 grid is shrunk to ((w + 31) // 32, (h + 31) // 32) pixels
    first, svi_tpu's resize (ROADMAP.md, known quirks), and back."""
    jp, tp, fwd = rife
    frames = _uint8_frames(4, *size, seed=5)
    pil = [Image.fromarray(f) for f in frames]
    want = _jax_rife(jrife.RIFEInterpolater, jp, fwd).interpolate(pil[:3])
    got = trife.RIFEInterpolater(tp).interpolate(frames[:3])
    assert len(got) == len(want) == 5 and got[1].shape == (*size, 3)
    assert _gap(got, want) <= LEVELS
    want = _jax_rife(jrife.RIFESmoother, jp, fwd, batch_size=2)(pil)
    got = trife.RIFESmoother(tp, batch_size=2)(frames)
    assert len(got) == 4 and _gap(got, want) <= LEVELS


# -- FastBlend ----------------------------------------------------------------------


def test_patch_operations_bit_for_bit():
    """remap, patch error and pairwise patch error on random f32 images and
    NNFs: svi_tpu's XLA arithmetic (its fused multiply-adds) bit for bit (at
    the pyramid test's full-size shapes, so svi_tpu compiles them once)."""
    rng = np.random.default_rng(0)
    b, h, w, ps = 3, 32, 48, 7
    pad = ps // 2
    src, tgt = (rng.random((b, h + 2 * pad, w + 2 * pad, 3)).astype(np.float32) * 255
                for _ in range(2))
    nnf, nnf2 = (np.stack([rng.integers(0, h, (b, h, w)), rng.integers(0, w, (b, h, w))],
                          -1).astype(np.int32) for _ in range(2))
    t = torch.from_numpy
    cases = [
        (jfb.apply_nnf_to_image(src, nnf, ps, pad),
         tfb.apply_nnf_to_image(t(src), t(nnf), ps, pad)),
        (jfb.patch_error(src, nnf, tgt, ps, pad), tfb.patch_error(t(src), t(nnf), t(tgt), ps, pad)),
        (jfb.pairwise_patch_error(src, nnf, tgt, nnf2, ps, pad),
         tfb.pairwise_patch_error(t(src), t(nnf), t(tgt), t(nnf2), ps, pad)),
    ]
    for want, got in cases:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resizes_match_cv2():
    """INTER_AREA shrinks (the pyramid) and INTER_LINEAR on NNFs (the level
    change) against the installed cv2 over 150 random sizes each."""
    import cv2

    rng = np.random.default_rng(1)
    worst = 0.0
    for _ in range(150):
        sh, sw = (int(v) for v in rng.integers(1, 80, 2))
        h, w = int(rng.integers(1, sh + 1)), int(rng.integers(1, sw + 1))
        img = (rng.random((sh, sw, 3)) * 255).astype(np.float32)
        want = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        got = tfb.resize_area(torch.from_numpy(img)[None], h, w)[0].numpy()
        worst = max(worst, float(np.abs(got - want.reshape(got.shape)).max()))
    assert worst <= 1e-4
    for _ in range(150):
        sh, sw = (int(v) for v in rng.integers(1, 80, 2))
        h, w = int(rng.integers(sh, 2 * sh + 3)), int(rng.integers(sw, 2 * sw + 3))
        yy, xx = np.meshgrid(np.arange(sh), np.arange(sw), indexing="ij")
        nnf = np.stack([2 * yy + rng.integers(0, 3, (sh, sw)),
                        2 * xx + rng.integers(0, 3, (sh, sw))], -1).astype(np.float32)
        want = cv2.resize(nnf, (w, h), interpolation=cv2.INTER_LINEAR)
        got = tfb.resize_linear_cv(torch.from_numpy(nnf)[None], h, w)[0].numpy()
        np.testing.assert_array_equal(got, want.reshape(got.shape))


def _blocky_frames(n, h, w, seed):
    """Integer frames constant on 2x2 blocks (so the pyramid's halving stays
    integer-valued), drifting one block a frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 32, (h // 2, w // 2, 3))
    return [np.repeat(np.repeat(np.roll(base, i, axis=1) + rng.integers(0, 4, base.shape), 2, 0),
                      2, 1).astype(np.uint8) for i in range(n)]


def test_pyramid_nnf_exact_on_integer_frames():
    """The coarse-to-fine NNF and the remapped style of 3 pairs at 32 x 48
    (two levels, patch sizes 7 then 5 at each, the random search's draws),
    equal to svi_tpu's; and the NNF's move to an odd-sized level (doubled,
    odd rows and columns offset, INTER_LINEAR, truncated, clamped)."""
    h, w = 32, 48
    g, s = _blocky_frames(4, h, w, 1), _blocky_frames(4, h, w, 2)
    sg, tg, ss = (np.stack(x).astype(np.float32) for x in (g[:3], g[1:], s[:3]))
    j = jfb.PyramidPatchMatcher(h, w, 3, **EBSYNTH)
    t = tfb.PyramidPatchMatcher(h, w, 3, device="cpu", **EBSYNTH)
    assert t.pyramid_heights == j.pyramid_heights and t.pyramid_level == 2
    nj, sj = j.estimate_nnf(sg, tg, ss)
    nt, st = t.estimate_nnf(sg, tg, ss)
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_array_equal(st, sj)
    j = jfb.PyramidPatchMatcher(37, 45, 3, **EBSYNTH)
    t = tfb.PyramidPatchMatcher(37, 45, 3, device="cpu", **EBSYNTH)
    rng = np.random.default_rng(3)
    nnf = np.stack([rng.integers(0, 18, (2, 18, 22)), rng.integers(0, 22, (2, 18, 22))],
                   -1).astype(np.int32)
    np.testing.assert_array_equal(t.update_nnf(torch.from_numpy(nnf), 1).numpy(),
                                  np.asarray(j.update_nnf(jnp.asarray(nnf), 1)))


@pytest.mark.parametrize("shape", [(1, 1, 1, 2), (1, 3, 7, 2), (3, 5, 2, 2), (2, 64, 96, 2)])
def test_random_steps_are_numpys(shape):
    """The random search's step: svi_tpu's clamped NNF, drawn from the same
    numpy generator, which both leave in the same state for the draws that
    follow."""
    b, h, w, _ = shape
    for seed in range(3):
        a, c = np.random.default_rng(seed), np.random.default_rng(seed)
        a.integers(0, 3, size=seed)
        c.integers(0, 3, size=seed)
        j = jfb.PatchMatcher(h, w, 3, 5, rng=a)
        t = tfb.PatchMatcher(h, w, 3, 5, rng=c)
        d = np.random.default_rng(seed + 10)
        nnf = np.stack([d.integers(0, h, shape[:3]), d.integers(0, w, shape[:3])],
                       -1).astype(np.int32)
        for r in (4, 1):
            np.testing.assert_array_equal(t.random_step(torch.from_numpy(nnf), r).numpy(),
                                          np.asarray(j.random_step(jnp.asarray(nnf), r)))
            assert a.bit_generator.state == c.bit_generator.state
        np.testing.assert_array_equal(a.permutation(4), c.permutation(4))


def test_table_manager_matches_jax():
    jt, tt = jfb.TableManager(), tfb.TableManager()
    for n in (1, 5, 16, 23):
        assert tt.task_list(n) == jt.task_list(n)
        for lo in range(n):
            assert tt.tree_query(lo, n - 1) == jt.tree_query(lo, n - 1)


def test_fastblend_smoother_matches_jax():
    """FastBlendSmoother over 3 integer frames at 16 x 24 (one level; window
    2, batch 4): the blended frames equal svi_tpu's."""
    g, s = _blocky_frames(3, 16, 24, 3), _blocky_frames(3, 16, 24, 4)
    want = jfb.FastBlendSmoother(batch_size=4, window_size=2, ebsynth_config=EBSYNTH)(
        s, original_frames=g)
    got = tfb.FastBlendSmoother(batch_size=4, window_size=2, ebsynth_config=EBSYNTH,
                                device="cpu")(s, original_frames=g)
    assert len(got) == 3 and got[0].dtype == np.uint8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
