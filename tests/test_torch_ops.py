"""Parity of the PyTorch port's ops (svi_tpu_torch.ops) with svi_tpu's.

Inputs come from np.random.default_rng(seed) and go through both packages.
On the CPU the port's attention wrappers run their plain PyTorch version, so
these tests hold that version against the JAX package's XLA path and against
its Pallas kernels in interpret mode; the CUDA kernel itself is held against
the plain version on the card (test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from svi_tpu.ops import attention as jattn
from svi_tpu.ops import norms as jnorms
from svi_tpu.ops import rope as jrope
from svi_tpu_torch.ops import attention as tattn
from svi_tpu_torch.ops import norms as tnorms
from svi_tpu_torch.ops import rope as trope

# f32 elementwise math in two frameworks: a few ulps of reassociation
F32_TOL = 1e-5
# attention over a few hundred keys: f32 sums taken in another order
ATTN_TOL = 2e-5


def _np(x):
    return np.asarray(x, np.float32)


def _pair(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return a, jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("name", ["rms", "t5", "t5_bf16_weight", "layer", "layer_affine",
                                  "channel_rms", "gelu_tanh", "modulate"])
def test_norms_match_jax(name):
    rng = np.random.default_rng(0)
    _, xj, xt = _pair(rng, (2, 5, 24))
    _, wj, wt = _pair(rng, (24,))
    _, bj, bt = _pair(rng, (24,))
    if name == "rms":
        got, want = tnorms.rms_norm(xt, wt), jnorms.rms_norm(xj, wj)
    elif name == "t5":
        got, want = tnorms.t5_layer_norm(xt, wt), jnorms.t5_layer_norm(xj, wj)
    elif name == "t5_bf16_weight":
        # the low-precision weight branch casts before the multiply; compare
        # at bf16 resolution (one bf16 ulp at |y| <= 4 is 2^-6)
        got = tnorms.t5_layer_norm(xt, wt.bfloat16()).float()
        want = jnorms.t5_layer_norm(xj, wj.astype(jnp.bfloat16)).astype(jnp.float32)
        np.testing.assert_allclose(_np(got), _np(want), atol=2 ** -6, rtol=0)
        return
    elif name == "layer":
        got, want = tnorms.layer_norm(xt), jnorms.layer_norm(xj)
    elif name == "layer_affine":
        got, want = tnorms.layer_norm(xt, wt, bt, 1e-5), jnorms.layer_norm(xj, wj, bj, 1e-5)
    elif name == "channel_rms":
        _, vj, vt = _pair(rng, (1, 24, 2, 3, 3))
        got = tnorms.channel_rms_norm(vt, wt.reshape(-1, 1, 1, 1))
        want = jnorms.channel_rms_norm(vj, wj.reshape(-1, 1, 1, 1))
    elif name == "gelu_tanh":
        got, want = tnorms.gelu_tanh(xt), jnorms.gelu_tanh(xj)
    else:
        got, want = tnorms.modulate(xt, wt, bt), jnorms.modulate(xj, wj, bj)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("grid,head_dim", [((3, 4, 5), 128), ((2, 3, 3), 32)])
def test_rope_tables_and_rotation_match_jax(grid, head_dim):
    cos_t, sin_t = trope.rope_angles_for_grid(grid, head_dim)
    cos_j, sin_j = jrope.rope_angles_for_grid(grid, head_dim)
    # the same f64 numpy recipe: bit-identical tables
    np.testing.assert_array_equal(cos_t, cos_j)
    np.testing.assert_array_equal(sin_t, sin_j)
    rng = np.random.default_rng(1)
    s = int(np.prod(grid))
    _, xj, xt = _pair(rng, (2, s, 3, head_dim))
    got = tattn._apply_rope_reference(xt, torch.from_numpy(cos_t), torch.from_numpy(sin_t))
    want = jrope.apply_rope(xj, jnp.asarray(cos_j), jnp.asarray(sin_j))
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=F32_TOL)


def test_sinusoidal_embedding_matches_jax():
    pos = np.array([0.0, 1.0, 37.5, 999.0], np.float32)
    got = trope.sinusoidal_embedding_1d(256, torch.from_numpy(pos))
    want = jrope.sinusoidal_embedding_1d(256, jnp.asarray(pos))
    # f32 angles up to 999 rad: one ulp of a frequency moves the angle ~6e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4, rtol=0)


def _jax_flat_fwd(q, k, v, head_dim, cos, sin, kv_len, scale):
    """The JAX package's XLA forward with its lse (flash_attention_flat with
    force_xla=True returns only `out`; the lse comes from the same call)."""
    use_rope = cos is not None
    if not use_rope:
        cos = sin = jnp.zeros((1, head_dim // 2), jnp.float32)
    out, res = jattn._flash_core_flat_fwd(q, k, v, cos, sin, kv_len, scale, False, use_rope,
                                          head_dim)
    return out, res[-1]


@pytest.mark.parametrize("case", ["rope", "no_rope", "masked"])
def test_plain_flat_attention_matches_jax_xla(case):
    rng = np.random.default_rng(2)
    b, sq, n, d = 2, 120, 2, 128  # RoPE needs D with (D - 2*(D//3)) even
    sk = sq if case != "no_rope" else 77
    q, qj, qt = _pair(rng, (b, sq, n * d))
    k, kj, kt = _pair(rng, (b, sk, n * d))
    v, vj, vt = _pair(rng, (b, sk, n * d))
    kv_len = 90 if case == "masked" else sk
    cos = sin = None
    if case in ("rope", "masked"):
        cos, sin = trope.rope_angles_for_grid((3, 5, 8), d)
    out_t, lse_t = tattn.flash_fwd_flat(
        qt, kt, vt, d, cos=None if cos is None else torch.from_numpy(cos),
        sin=None if sin is None else torch.from_numpy(sin), kv_len=kv_len)
    want = jattn.flash_attention_flat(
        qj, kj, vj, d, cos=cos, sin=sin, kv_len=kv_len, force_xla=True)
    np.testing.assert_allclose(_np(out_t), _np(want), atol=ATTN_TOL, rtol=ATTN_TOL)
    _, lse_j = _jax_flat_fwd(qj, kj, vj, d, None if cos is None else jnp.asarray(cos),
                             None if sin is None else jnp.asarray(sin), kv_len, d ** -0.5)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_plain_bnsd_attention_matches_jax_with_lse():
    rng = np.random.default_rng(3)
    _, qj, qt = _pair(rng, (1, 3, 50, 80))
    _, kj, kt = _pair(rng, (1, 3, 70, 80))
    _, vj, vt = _pair(rng, (1, 3, 70, 80))
    out_t, lse_t = tattn.flash_attention_with_lse(qt, kt, vt, kv_len=60)
    out_j, lse_j = jattn.flash_attention_with_lse(qj, kj, vj, kv_len=60, force_xla=True)
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("n,d", [(2, 20), (1, 48), (2, 128)])
def test_public_flash_attention_routes_and_matches(n, d):
    """flash_attention picks the flat or the (B, N, S, D) entry as the JAX
    package does; both agree with the XLA path."""
    rng = np.random.default_rng(4)
    _, qj, qt = _pair(rng, (1, 40, n, d))
    _, kj, kt = _pair(rng, (1, 33, n, d))
    _, vj, vt = _pair(rng, (1, 33, n, d))
    before = (tattn.flash_fwd_flat.launches, tattn.flash_fwd_bnsd.launches)
    got = tattn.flash_attention(qt, kt, vt)
    want = jattn.flash_attention(qj, kj, vj, force_xla=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_TOL, rtol=ATTN_TOL)
    # the plain version on the CPU never counts as a kernel launch
    assert (tattn.flash_fwd_flat.launches, tattn.flash_fwd_bnsd.launches) == before


def test_plain_attention_matches_pallas_flat_kernel_rope_masked_tail():
    """K1 itself (interpret mode) with fused RoPE and a masked tail: 448
    tokens padded to 512 for the kernel, unpadded for the port."""
    rng = np.random.default_rng(6)
    b, s, n, d = 1, 448, 2, 128
    q, _, qt = _pair(rng, (b, s, n * d))
    k, _, kt = _pair(rng, (b, s, n * d))
    v, _, vt = _pair(rng, (b, s, n * d))
    cos, sin = jrope.rope_angles_for_grid((7, 8, 8), d)
    pad = ((0, 0), (0, 512 - s), (0, 0))
    cosE, sinE = jattn._expand_rope_tables(cos, sin, d, 512)
    with pltpu.force_tpu_interpret_mode():
        out_j, lse_j = jattn._flash_fwd_pallas_flat(
            jnp.pad(q, pad), jnp.pad(k, pad), jnp.pad(v, pad), cosE, sinE, s, d ** -0.5,
            256, 256, d, fuse_rope=True, nsub=2)
    out_t, lse_t = tattn.flash_fwd_flat(qt, kt, vt, d, cos=torch.from_numpy(cos),
                                        sin=torch.from_numpy(sin))
    np.testing.assert_allclose(_np(out_t), _np(out_j[:, :s]), atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j[:, :, :s]), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_plain_attention_matches_pallas_bnsd_kernel_d80():
    """K2 itself (interpret mode) at CLIP's head dim 80, 257 tokens padded to 384."""
    rng = np.random.default_rng(7)
    b, n, s, d = 1, 2, 257, 80
    q, _, qt = _pair(rng, (b, n, s, d))
    k, _, kt = _pair(rng, (b, n, s, d))
    v, _, vt = _pair(rng, (b, n, s, d))
    pad = ((0, 0), (0, 0), (0, 384 - s), (0, 0))
    with pltpu.force_tpu_interpret_mode():
        out_j, lse_j = jattn._flash_fwd_pallas(
            jnp.pad(q, pad), jnp.pad(k, pad), jnp.pad(v, pad), s, d ** -0.5, 128, 128)
    out_t, lse_t = tattn.flash_fwd_bnsd(qt, kt, vt)
    np.testing.assert_allclose(_np(out_t), _np(out_j[:, :, :s]), atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j[:, :, :s]), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_plain_bf16_d64_attention_matches_pallas_bnsd_kernel():
    """K2 itself (interpret mode) in bf16 at CogVideoX's head dim 64, the
    (B, N, S, D) contract the sm90 route serves at D = 64 on the card: 2
    heads, 200 tokens padded to 256 for the kernel, keys past 180 masked.
    Tolerances: out within one bf16 ulp of the largest |out| (both round
    out to bf16 once, from f32 sums in another order, and the TPU kernel
    rounds P to bf16 for P.V where the plain version keeps f32); lse is f32
    from the same bf16 scores in both (ATTN_TOL)."""
    rng = np.random.default_rng(9)
    b, n, s, d, kv_len = 1, 2, 200, 64, 180
    q, k, v = (rng.standard_normal((b, n, s, d)).astype(np.float32) for _ in range(3))
    qj, kj, vj = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    qt, kt, vt = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    pad = ((0, 0), (0, 0), (0, 256 - s), (0, 0))
    with pltpu.force_tpu_interpret_mode():
        out_j, lse_j = jattn._flash_fwd_pallas(
            jnp.pad(qj, pad), jnp.pad(kj, pad), jnp.pad(vj, pad), kv_len, d ** -0.5, 128, 128)
    out_t, lse_t = tattn.flash_fwd_bnsd(qt, kt, vt, kv_len=kv_len)
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (b, n, s, d)
    want = _np(out_j[:, :, :s].astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(_np(out_t.float()), want, atol=ulp, rtol=0)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j[:, :, :s]), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_plain_attention_row_chunking_is_exact(monkeypatch):
    """The plain version chunks query rows to bound its score tile; chunking
    must not change the result."""
    rng = np.random.default_rng(8)
    _, _, qt = _pair(rng, (1, 300, 2, 32))
    _, _, kt = _pair(rng, (1, 260, 2, 32))
    _, _, vt = _pair(rng, (1, 260, 2, 32))
    whole = tattn._flash_fwd_reference(qt, kt, vt, None, None, 200, 0.2)
    monkeypatch.setattr(tattn, "_REFERENCE_TILE_BYTES", 4 * 2 * 256 * 7)  # 7 rows a chunk
    chunked = tattn._flash_fwd_reference(qt, kt, vt, None, None, 200, 0.2)
    torch.testing.assert_close(chunked[0], whole[0], atol=0, rtol=0)
    torch.testing.assert_close(chunked[1], whole[1], atol=0, rtol=0)
