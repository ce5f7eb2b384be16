"""The split backward's routing and the decompositions its sm90 kernels rely on.

On the card, bf16 D = 128 takes csrc/flash_bwd_split_sm90.cu: q and k are
rotated first by the forward's RoPE pre-pass, the kernels run without
tables and rotate dq and dk back by -theta, and one prep pass computes
lse * log2(e) and delta = rowsum(dO * O) for both kernels. Here, on the CPU,
each of those pieces runs its plain version and is held against the JAX
package: its Pallas split kernels with the RoPE fused inside (interpret
mode) and its delta. The kernels themselves run on the card
(test_torch_kernels_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from svi_tpu.ops import attention as jattn
from svi_tpu.ops import rope as jrope
from svi_tpu_torch.ops import attention as tattn

# f32 gradients of f32 attention, sums taken in another order: the bound
# test_torch_attention_bwd.py holds the plain backward to against the Pallas
# kernels
GRAD_TOL = 2e-4


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 64, "mma"),
    (torch.bfloat16, 80, ValueError), (torch.bfloat16, 384, ValueError),
    (torch.float32, 128, ValueError), (torch.float32, 64, "f32"),
    (torch.float16, 128, TypeError), (torch.float32, 40, "f32"), (torch.float32, 160, "f32"),
])
def test_split_bwd_route(dtype, head_dim, route):
    """bf16 D = 128 takes the TMA + wgmma kernels, bf16 D = 64 the mma.sync
    ones, f32 D = 40, 64, 80, 160 (the SD UNets) the f32 FMA ones; every
    other pair raises (no fallback)."""
    if isinstance(route, str):
        assert tattn._split_bwd_route(dtype, head_dim) == route
    else:
        with pytest.raises(route):
            tattn._split_bwd_route(dtype, head_dim)


def test_split_bwd_route_f32_takes_no_rope():
    """The f32 kernels take no RoPE tables (the SD UNets have none): a call
    with them raises instead of launching."""
    cos = torch.zeros((4, 20))
    with pytest.raises(NotImplementedError, match="no RoPE"):
        tattn._split_bwd_route(torch.float32, 40, cos)
    assert tattn._split_bwd_route(torch.bfloat16, 128, cos) == "sm90"


def test_rope_decomposition_matches_pallas_fused_rope():
    """What the sm90 route computes with RoPE: q and k rotated by the plain
    rotation (the pre-pass's plain version), the plain backward with no
    tables, dq and dk rotated back by -theta. Held against the JAX package's
    split kernels with the rotation fused inside (`_flash_bwd_pallas_flat(...,
    fuse_rope=True)`, interpret mode) at a ragged Sq 200 x Sk 300: 2 query
    and 3 key tiles of 128, the inputs zero-padded to them as the JAX package
    pads. f32, so GRAD_TOL."""
    rng = np.random.default_rng(13)
    b, sq, sk, n, d = 1, 200, 300, 2, 128
    scale = d ** -0.5
    q, g = _rand(rng, (b, sq, n * d)), _rand(rng, (b, sq, n * d))
    k, v = _rand(rng, (b, sk, n * d)), _rand(rng, (b, sk, n * d))
    cos, sin = jrope.rope_angles_for_grid((5, 8, 8), d)  # 320 positions
    qt, kt, vt, gt, ct, st = (torch.from_numpy(x) for x in (q, k, v, g, cos, sin))
    out, lse = tattn.flash_fwd_flat(qt, kt, vt, d, cos=ct, sin=st)

    q4, k4, v4, o4, g4 = (t.unflatten(-1, (n, d)) for t in (qt, kt, vt, out, gt))
    qr, kr = tattn._rope_rotate4(q4, ct, st), tattn._rope_rotate4(k4, ct, st)
    dqr, dkr, dv = tattn._flash_bwd_reference(qr, kr, v4, o4, lse, g4, None, None, sk, scale)
    got = (tattn._apply_rope_reference(dqr, ct[:sq], -st[:sq]),
           tattn._apply_rope_reference(dkr, ct[:sk], -st[:sk]), dv)

    sq_p, sk_p = 256, 384
    pad_q, pad_k = ((0, 0), (0, sq_p - sq), (0, 0)), ((0, 0), (0, sk_p - sk), (0, 0))
    delta = np.einsum("bsnd,bsnd->bns", g.reshape(b, sq, n, d), out.numpy().reshape(b, sq, n, d))
    pad_vec = ((0, 0), (0, 0), (0, sq_p - sq))
    cosE, sinE = jattn._expand_rope_tables(cos, sin, d, sk_p)
    with pltpu.force_tpu_interpret_mode():
        want = jattn._flash_bwd_pallas_flat(
            jnp.pad(q, pad_q), jnp.pad(k, pad_k), jnp.pad(v, pad_k), jnp.pad(g, pad_q),
            jnp.pad(lse.numpy(), pad_vec)[:, :, None, :], jnp.pad(delta, pad_vec)[:, :, None, :],
            cosE, sinE, scale, 128, 128, d, fuse_rope=True)
    for name, x, ref, s in zip(("dq", "dk", "dv"), got, want, (sq, sk, sk)):
        np.testing.assert_allclose(x.flatten(2).numpy(), np.asarray(ref)[:, :s], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("sq,rows", [(100, 128), (256, 128), (200, 64)])
def test_delta_once_gives_the_same_gradients(sq, rows):
    """flash_bwd_flat computes delta once for K5a and K5b. On the CPU: the
    prep's delta is the JAX package's (its f32 einsum over dO and O), lse2 is
    lse * log2(e), both padded to `rows` with 0 and +inf; and flash_bwd_flat
    gives the gradients of flash_bwd_dq and flash_bwd_dkv called alone (each
    computing its own delta), bit for bit, on the split route."""
    rng = np.random.default_rng(sq + rows)
    b, sk, n, d = 2, 77, 2, 128
    q, g = _rand(rng, (b, sq, n * d)), _rand(rng, (b, sq, n * d))
    k, v = _rand(rng, (b, sk, n * d)), _rand(rng, (b, sk, n * d))
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    out, lse = tattn.flash_fwd_flat(qt, kt, vt, d)

    lse2, delta = tattn._bwd_prep(out.unflatten(-1, (n, d)), gt.unflatten(-1, (n, d)), lse, rows)
    sq_pad = -(-sq // rows) * rows
    assert lse2.shape == delta.shape == (b, n, sq_pad)
    want = np.asarray(jnp.einsum("bsnd,bsnd->bns", g.reshape(b, sq, n, d),
                                 out.numpy().reshape(b, sq, n, d),
                                 preferred_element_type=jnp.float32))
    np.testing.assert_allclose(delta[..., :sq].numpy(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(lse2[..., :sq], lse * tattn._LOG2E)
    assert (delta[..., sq:] == 0).all() and torch.isinf(lse2[..., sq:]).all()

    assert tattn._bwd_route(n, d, sq, sk, sk) == "split"
    once = tattn.flash_bwd_flat(qt, kt, vt, out, lse, gt, d)
    alone = (tattn.flash_bwd_dq(qt, kt, vt, out, lse, gt, d),
             *tattn.flash_bwd_dkv(qt, kt, vt, out, lse, gt, d))
    for x, y in zip(once, alone):
        assert torch.equal(x, y)
