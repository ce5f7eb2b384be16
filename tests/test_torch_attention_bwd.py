"""Parity of the port's attention backward with svi_tpu's.

On the CPU the port's backward entries (flash_bwd_onepass for K4,
flash_bwd_dq / flash_bwd_dkv for K5a / K5b, and the routing autograd function
behind flash_attention_flat) run their plain PyTorch version. These tests
hold it against jax.grad of the JAX package's XLA path and against the Pallas
K4 and K5 kernels themselves in interpret mode; the CUDA kernels are held
against the plain version on the card (test_torch_kernels_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from svi_tpu.ops import attention as jattn
from svi_tpu.ops import rope as jrope
from svi_tpu_torch.ops import attention as tattn

# f32 gradients of f32 attention: sums over a few hundred to a few thousand
# keys taken in another order; the bound tests/test_attention.py holds the
# Pallas backward kernels to against jax.grad
GRAD_TOL = 2e-4


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jax_route(n, d, sq, sk, kv_len):
    """The branch `_flash_core_flat_bwd` takes (svi_tpu/ops/attention.py:1221-1296)."""
    flat_ok = d % 128 == 0 or n == 1
    if flat_ok and kv_len == sk and jattn._onepass_bwd_ok(jattn._ceil_to(sq, 1024), sk, d):
        return "onepass"
    return "split" if flat_ok and kv_len == sk else "xla"


def _kernel_launches():
    """Launches of K4, K5a and K5b (the split entries count per route)."""
    return (tattn.flash_bwd_onepass.launches, dict(tattn.flash_bwd_dq.routes),
            dict(tattn.flash_bwd_dkv.routes))


def _port_grads(q, k, v, g, d, cos, sin, kv_len):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.flash_attention_flat(*leaves, d, cos=cos, sin=sin, kv_len=kv_len)
    return [x.numpy() for x in torch.autograd.grad(out, leaves, torch.from_numpy(g))]


def _jax_grads(q, k, v, g, d, cos, sin, kv_len):
    def loss(q_, k_, v_):
        out = jattn.flash_attention_flat(q_, k_, v_, d, cos=cos, sin=sin, kv_len=kv_len,
                                         force_xla=True)
        return jnp.sum(out * g)

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize("case,b,sq,sk,n,grid,kv_len,route", [
    ("self_rope", 2, 120, 120, 2, (3, 5, 8), None, "split"),
    ("text_cross", 1, 100, 512, 2, None, None, "split"),
    ("image_cross", 1, 100, 257, 2, None, None, "split"),
    ("self_rope_onepass", 1, 4096, 4096, 1, (4, 32, 32), None, "onepass"),
    ("masked_kv_len", 1, 120, 120, 2, (3, 5, 8), 90, "xla"),
])
def test_plain_backward_matches_jax_grad_of_xla_path(case, b, sq, sk, n, grid, kv_len, route):
    """dq, dk, dv through torch.autograd against jax.grad of the XLA path, f32,
    at each route the JAX package takes; on the CPU every route (kv_len < Sk
    included) runs the plain backward."""
    d = 128
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = _rand(rng, (b, sq, n * d)), _rand(rng, (b, sk, n * d)), _rand(rng, (b, sk, n * d))
    g = _rand(rng, (b, sq, n * d))
    cos = sin = None
    if grid:
        cos, sin = jrope.rope_angles_for_grid(grid, d)
    kv = sk if kv_len is None else kv_len
    assert tattn._bwd_route(n, d, sq, sk, kv) == _jax_route(n, d, sq, sk, kv) == route
    before = _kernel_launches()
    got = _port_grads(q, k, v, g, d, cos, sin, kv_len)
    want = _jax_grads(q, k, v, g, d, cos, sin, kv_len)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, np.asarray(ref), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    # the plain version on the CPU never counts as a kernel launch
    assert _kernel_launches() == before


def test_differentiable_public_ops_match_jax():
    """flash_attention and flash_attention_rope ((B, S, N, D) in and out) are
    differentiable in q, k and v like their JAX counterparts."""
    rng = np.random.default_rng(5)
    b, s, n, d = 1, 60, 2, 128  # RoPE needs D with (D - 2*(D//3)) even
    cos, sin = jrope.rope_angles_for_grid((3, 4, 5), d)
    q, k, v, g = (_rand(rng, (b, s, n, d)) for _ in range(4))
    for rope in (False, True):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        if rope:
            out = tattn.flash_attention_rope(*leaves, cos, sin)
        else:
            out = tattn.flash_attention(*leaves)
        got = torch.autograd.grad(out, leaves, torch.from_numpy(g))

        def loss(q_, k_, v_):
            if rope:
                o = jattn.flash_attention_rope(q_, k_, v_, cos, sin, force_xla=True)
            else:
                o = jattn.flash_attention(q_, k_, v_, force_xla=True)
            return jnp.sum(o * g)

        want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
        for x, ref in zip(got, want):
            np.testing.assert_allclose(x.numpy(), np.asarray(ref), atol=GRAD_TOL, rtol=GRAD_TOL)


def _forward_and_delta(q, k, v, g, d, cos, sin):
    """The port's forward (out, lse) and delta = rowsum(dO * O), as numpy."""
    out, lse = tattn.flash_fwd_flat(*(torch.from_numpy(x) for x in (q, k, v)), d,
                                    cos=None if cos is None else torch.from_numpy(cos),
                                    sin=None if sin is None else torch.from_numpy(sin))
    b, s, nd = q.shape
    n = nd // d
    delta = np.einsum("bsnd,bsnd->bns", g.reshape(b, s, n, d), out.numpy().reshape(b, s, n, d))
    return out, lse, delta


@pytest.mark.parametrize("fuse_rope,sk", [(True, 256), (False, 200)])
def test_plain_backward_matches_pallas_split_kernels(fuse_rope, sk):
    """K5a + K5b themselves (interpret mode), called as tests/test_attention.py
    calls them; a ragged Sk = 200 is zero-padded to 256 for the kernels (as
    the JAX package pads) and masked, unpadded, in the port."""
    rng = np.random.default_rng(9)
    b, sq, n, d = 1, 256, 2, 128
    q, g = _rand(rng, (b, sq, n * d)), _rand(rng, (b, sq, n * d))
    k, v = _rand(rng, (b, sk, n * d)), _rand(rng, (b, sk, n * d))
    cos = sin = None
    if fuse_rope:
        cos, sin = jrope.rope_angles_for_grid((4, 8, 8), d)
        cosE, sinE = jattn._expand_rope_tables(cos, sin, d, 256)
    else:
        cosE = sinE = jnp.zeros((8, d), jnp.float32)
    out, lse, delta = _forward_and_delta(q, k, v, g, d, cos, sin)
    pad = ((0, 0), (0, 256 - sk), (0, 0))
    with pltpu.force_tpu_interpret_mode():
        dq_j, dk_j, dv_j = jattn._flash_bwd_pallas_flat(
            jnp.asarray(q), jnp.pad(k, pad), jnp.pad(v, pad), jnp.asarray(g),
            jnp.asarray(lse.numpy())[:, :, None, :], jnp.asarray(delta)[:, :, None, :],
            cosE, sinE, d ** -0.5, 128, 128, d, fuse_rope=fuse_rope)
    args = [torch.from_numpy(x) for x in (q, k, v)] + [out, lse, torch.from_numpy(g), d]
    tables = dict(cos=None if cos is None else torch.from_numpy(cos),
                  sin=None if sin is None else torch.from_numpy(sin))
    dq = tattn.flash_bwd_dq(*args, **tables)
    dk, dv = tattn.flash_bwd_dkv(*args, **tables)
    for x, ref in ((dq, dq_j), (dk, dk_j[:, :sk]), (dv, dv_j[:, :sk])):
        np.testing.assert_allclose(x.numpy(), np.asarray(ref), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_plain_backward_matches_pallas_onepass_kernel():
    """K4 itself (interpret mode), called as tests/test_attention.py calls it:
    its f32 dq summed across KV blocks, dk and dv."""
    rng = np.random.default_rng(11)
    b, s, n, d = 2, 256, 2, 128
    q, k, v, g = (_rand(rng, (b, s, n * d)) for _ in range(4))
    out, lse, delta = _forward_and_delta(q, k, v, g, d, None, None)
    block_q = block_k = 128
    nq = s // block_q
    with pltpu.force_tpu_interpret_mode():
        dq32, dk_j, dv_j = jattn._flash_bwd_onepass_pallas_flat(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
            jnp.asarray(lse.numpy()).reshape(b, n, nq, block_q),
            jnp.asarray(delta).reshape(b, n, nq, block_q), d ** -0.5, block_q, block_k, d)
    dq, dk, dv = tattn.flash_bwd_onepass(*(torch.from_numpy(x) for x in (q, k, v)), out, lse,
                                         torch.from_numpy(g), d)
    for x, ref in ((dq, dq32), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(x.numpy(), np.asarray(ref), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_backward_input_checks():
    q = torch.zeros(1, 8, 2 * 64)
    out, lse = tattn.flash_fwd_flat(q, q, q, 64)
    with pytest.raises(ValueError, match="lse"):
        tattn.flash_bwd_dq(q, q, q, out, lse[:, :1], q, 64)
    with pytest.raises(ValueError, match="dO"):
        tattn.flash_bwd_dkv(q, q, q, out, lse, q[:, :4], 64)


def test_onepass_with_rope_equals_the_backward_on_prerotated_inputs():
    """The card's K4 is given q and k rotated by `rope_rotate_flat` (as the
    JAX package rotates them outside its one-pass kernel) and rotates dq and
    dk back. On the CPU, flash_bwd_onepass with RoPE tables equals that
    route: the backward on the pre-rotated q and k, with dq and dk rotated
    by the inverse rotation; both match jax.grad of the JAX package's XLA
    path at the one-pass route."""
    b, s, n, d = 1, 4096, 1, 128
    assert tattn._bwd_route(n, d, s, s, s) == _jax_route(n, d, s, s, s) == "onepass"
    rng = np.random.default_rng(17)
    q, k, v, g = (_rand(rng, (b, s, n * d)) for _ in range(4))
    cos, sin = jrope.rope_angles_for_grid((4, 32, 32), d)
    qt, kt, vt, gt, ct, st = (torch.from_numpy(x) for x in (q, k, v, g, cos, sin))
    out, lse = tattn.flash_fwd_flat(qt, kt, vt, d, cos=ct, sin=st)
    fused = tattn.flash_bwd_onepass(qt, kt, vt, out, lse, gt, d, cos=ct, sin=st)
    qr, kr = tattn.rope_rotate_flat(qt, ct, st, d), tattn.rope_rotate_flat(kt, ct, st, d)
    dqr, dkr, dv = tattn.flash_bwd_onepass(qr, kr, vt, out, lse, gt, d)

    def back(x):
        return tattn._apply_rope_reference(x.unflatten(-1, (n, d)), ct, -st).flatten(2)

    want = _jax_grads(q, k, v, g, d, cos, sin, None)
    for name, x, y, ref in zip(("dq", "dk", "dv"), fused, (back(dqr), back(dkr), dv), want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6, rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(x.numpy(), np.asarray(ref), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
