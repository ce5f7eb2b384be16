"""The forward's routing on the card and the RoPE pre-pass of its sm90 route.

`_fwd_route` names the kernel a CUDA call takes; `rope_rotate_flat` is the
rotation the sm90 route applies before the kernel (on the CPU its plain
version), held against the JAX package's `_apply_rope_xla`; and the identity
the route relies on: attention with RoPE inside equals attention without it
on inputs rotated beforehand. The kernels themselves run on the card
(test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svi_tpu.ops import attention as jattn
from svi_tpu.ops import rope as jrope
from svi_tpu_torch.ops import attention as tattn

# f32 elementwise math in two frameworks: a few ulps of reassociation (as
# test_torch_ops.py)
F32_TOL = 1e-5


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 64, "sm90"),
    *((torch.float32, d, "f32") for d in (32, 64, 80, 128, 384)),
    # the SD 1.5 family's bf16 head dims run the sm90 kernel over zero-filled
    # head-dim boxes (they raised before any kernel took them)
    (torch.bfloat16, 80, "sm90"),
    # the SD 1.5 family's f32 head dims; a pair with no kernel still raises
    *((torch.float32, d, "f32") for d in (40, 160, 512)),
    (torch.float32, 96, None), (torch.bfloat16, 40, "sm90"),
    # Hunyuan-DiT's 16 heads of 88
    (torch.float32, 88, "f32"), (torch.bfloat16, 88, "sm90"),
    # the rest of the bf16 head dims (384 and 512 on the column-split
    # kernel); bf16 D96 still raises
    *((torch.bfloat16, d, "sm90") for d in (32, 160, 384, 512)),
    (torch.bfloat16, 96, None),
])
def test_fwd_route(dtype, head_dim, route):
    if route is None:
        with pytest.raises(ValueError, match="head_dim"):
            tattn._fwd_route(dtype, head_dim)
    else:
        assert tattn._fwd_route(dtype, head_dim) == route


def test_both_dtypes_build_the_same_head_dims():
    """Every head dim the f32 kernel is built for has a bf16 kernel too."""
    bf16, f32 = (tattn._KERNEL_HEAD_DIMS[t] for t in (torch.bfloat16, torch.float32))
    assert bf16 == f32 == (32, 40, 64, 80, 88, 128, 160, 384, 512)


def test_every_fwd_route_loads_a_source_that_exists(monkeypatch):
    """Each (dtype, head dim) of `_FWD_ROUTES` names a `kernels.build` loader
    (the one `_launch` calls), and calling its entry at that head dim builds
    a source under csrc/ that exists, for a grouped source the group that
    holds the head dim; nvcc and the library load are stubbed (no card
    here)."""
    import ctypes
    from types import SimpleNamespace
    from unittest import mock

    from svi_tpu_torch.kernels import build

    built = []
    monkeypatch.setattr(build, "build", lambda src, head_dims=(): built.append(
        (src, head_dims)) or SimpleNamespace(path=src))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: mock.MagicMock())
    build._load_fwd_group.cache_clear()
    assert set(tattn._FWD_ROUTES.values()) == set(tattn._FWD_LOADERS)
    for (dtype, d), route in sorted(tattn._FWD_ROUTES.items(), key=str):
        build._load_fwd_group.cache_clear()
        lib = getattr(build, tattn._FWD_LOADERS[route]).__wrapped__()
        getattr(lib, f"svi_flash_fwd_{route}")(d)
        src, group = built[-1]
        assert src.is_file() and src.parent == build.CSRC, (route, src)
        assert group == () or d in group, (route, d, group)
    build._load_fwd_group.cache_clear()


def _rope_inputs(dtype):
    b, s, n, d = 2, 37, 3, 128
    cos, sin = jrope.rope_angles_for_grid((1, 1, s), d)
    x = np.random.default_rng(4).standard_normal((b, s, n * d)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    return xt, torch.from_numpy(cos), torch.from_numpy(sin), (b, s, n, d)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_rotate_flat_matches_jax(dtype):
    """bf16: within one bf16 ulp of the larger magnitude (XLA may contract a
    product into an FMA before the one rounding); f32: within F32_TOL."""
    xt, cos, sin, (b, s, n, d) = _rope_inputs(dtype)
    got = tattn.rope_rotate_flat(xt, cos, sin, d)
    assert got.shape == xt.shape and got.dtype == dtype and got.is_contiguous()
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(xt.float().numpy()).astype(jdt).reshape(b, s, n, d)
    want = np.asarray(jattn._apply_rope_xla(xj, jnp.asarray(cos.numpy()),
                                            jnp.asarray(sin.numpy())).astype(jnp.float32))
    a, w = got.float().numpy().reshape(b, s, n, d), want
    if dtype == torch.bfloat16:
        assert np.all(np.abs(a - w) <= 2.0 ** -7 * np.maximum(np.abs(a), np.abs(w)))
    else:
        np.testing.assert_allclose(a, w, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("kv_len", [None, 21])
def test_prerotated_inputs_give_the_fused_rope_result(kv_len):
    """flash_fwd_flat without tables on rope_rotate_flat's q and k equals
    flash_fwd_flat with the tables, bit for bit (the sm90 route's identity)."""
    q, cos, sin, (b, s, n, d) = _rope_inputs(torch.bfloat16)
    rng = np.random.default_rng(5)
    k, v = (torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).bfloat16()
            for _ in range(2))
    fused = tattn.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin, kv_len=kv_len)
    split = tattn.flash_fwd_flat(tattn.rope_rotate_flat(q, cos, sin, d),
                                 tattn.rope_rotate_flat(k, cos, sin, d), v, d, kv_len=kv_len)
    assert torch.equal(fused[0], split[0]) and torch.equal(fused[1], split[1])
