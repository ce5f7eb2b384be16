"""The CUDA flash-attention kernels (forward, and the K4 / K5a / K5b backward)
against their plain PyTorch versions, on the card.

Marked `cuda`; every test skips where torch sees no CUDA device. Run on a
machine with an H100 and nvcc (no JAX there, so without the JAX conftest):
`python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q`.
"""

import pytest
import torch

from svi_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.cuda

# bf16: P is rounded to bf16 for P.V and out once more, ~2 bf16 ulps at |out|<=1;
# lse comes from f32 scores of bf16 inputs
BF16_OUT_TOL, BF16_LSE_TOL = 2e-2, 1e-3
# f32 FMA path against f32 PyTorch (no TF32): summation order only
F32_TOL = 1e-4


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rand(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)


def _tables(s, d):
    """RoPE tables of random angles: the kernel takes any (S, D/2) pair."""
    ang = torch.rand((s, d // 2), generator=torch.Generator().manual_seed(s)) * 6.2832
    return torch.cos(ang).cuda(), torch.sin(ang).cuda()


def _check(got, want, out_tol, lse_tol):
    (o, lse), (o_ref, lse_ref) = got, want
    assert o.dtype == o_ref.dtype and o.shape == o_ref.shape
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o.float() - o_ref.float()).abs().max().item() <= out_tol
    assert (lse - lse_ref).abs().max().item() <= lse_tol


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["self_rope", "cross_ragged", "masked"])
def test_bf16_flat_kernel_matches_plain(d, case):
    n, b = 3, 2
    sq = 189  # ragged against the 64-row tiles
    sk = {"self_rope": 189, "cross_ragged": 77, "masked": 189}[case]
    q = _rand((b, sq, n * d), torch.bfloat16, 0)
    k = _rand((b, sk, n * d), torch.bfloat16, 1)
    v = _rand((b, sk, n * d), torch.bfloat16, 2)
    cos = sin = None
    if case != "cross_ragged":
        cos, sin = _tables(sq, d)
    kv_len = 150 if case == "masked" else None
    before = tattn.flash_fwd_flat.launches
    got = tattn.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin, kv_len=kv_len)
    torch.cuda.synchronize()
    assert tattn.flash_fwd_flat.launches == before + 1
    kv = sk if kv_len is None else kv_len
    q4, k4, v4 = (t.unflatten(-1, (n, d)) for t in (q, k, v))
    o_ref, lse_ref = tattn._flash_fwd_reference(q4, k4, v4, cos, sin, kv, d ** -0.5)
    _check(got, (o_ref.flatten(2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL)


@pytest.mark.parametrize("d", [32, 64, 80, 128, 384])
def test_f32_bnsd_kernel_matches_plain(d):
    b, n, sq, sk = 2, 2, 70, 45
    q, k, v = (_rand((b, n, s, d), torch.float32, i) for i, s in enumerate((sq, sk, sk)))
    before = tattn.flash_fwd_bnsd.launches
    got = tattn.flash_fwd_bnsd(q, k, v, kv_len=40)
    torch.cuda.synchronize()
    assert tattn.flash_fwd_bnsd.launches == before + 1
    o_ref, lse_ref = tattn._flash_fwd_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), None, None, 40, d ** -0.5)
    _check(got, (o_ref.transpose(1, 2), lse_ref), F32_TOL, F32_TOL)


def test_f32_strided_single_head_like_the_vae():
    """q, k, v as column slices of one qkv tensor (row stride 3c), as the VAE
    mid-block attention hands them over."""
    c, s = 384, 300
    qkv = _rand((2, s, 3 * c), torch.float32, 5)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    out = tattn.flash_attention(q[:, :, None], k[:, :, None], v[:, :, None])[:, :, 0]
    ref, _ = tattn._flash_fwd_reference(q[:, :, None], k[:, :, None], v[:, :, None], None,
                                        None, s, c ** -0.5)
    assert (out - ref[:, :, 0]).abs().max().item() <= F32_TOL


def test_f32_rope_kernel_matches_plain():
    d, n = 32, 2
    cos, sin = _tables(40, d)
    q, k, v = (_rand((1, 40, n * d), torch.float32, i) for i in range(3))
    got = tattn.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin)
    o_ref, lse_ref = tattn._flash_fwd_reference(
        *(t.unflatten(-1, (n, d)) for t in (q, k, v)), cos, sin, 40, d ** -0.5)
    _check(got, (o_ref.flatten(2), lse_ref), F32_TOL, F32_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_all_keys_masked_gives_finite_lse(dtype):
    q = _rand((1, 2, 20, 64), dtype, 0)
    out, lse = tattn.flash_fwd_bnsd(q, q, q, kv_len=0)
    torch.cuda.synchronize()
    assert torch.isfinite(lse).all() and (out == 0).all()


def test_unsupported_head_dim_raises():
    q = _rand((1, 2, 8, 96), torch.bfloat16, 0)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_fwd_bnsd(q, q, q)


# ---------------------------------------------------------------------------
# Backward kernels (K4 one-pass, K5a dq + K5b dk/dv)
# ---------------------------------------------------------------------------

# bf16 gradients against the plain f32 backward of the same bf16 inputs: the
# kernels round P and dS to bf16 before the products that consume them and
# round each gradient once to bf16 (2^-8 relative); K4 also sums dq with f32
# atomics in an order that changes from run to run. 2% of the gradient's
# largest magnitude covers both with room, and is far below what a wrong
# tile, mask or rotation gives (errors of the gradient's own size).
BWD_REL_TOL = 2e-2


def _bwd_inputs(b, sq, sk, n, d, rope, seed):
    q = _rand((b, sq, n * d), torch.bfloat16, seed)
    k = _rand((b, sk, n * d), torch.bfloat16, seed + 1)
    v = _rand((b, sk, n * d), torch.bfloat16, seed + 2)
    g = _rand((b, sq, n * d), torch.bfloat16, seed + 3)
    cos, sin = _tables(max(sq, sk), d) if rope else (None, None)
    out, lse = tattn.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin)
    return q, k, v, out, lse, g, cos, sin


def _plain_bwd(q, k, v, out, lse, g, d, cos, sin):
    n = q.shape[-1] // d
    views = [t.unflatten(-1, (n, d)) for t in (q, k, v, out)]
    grads = tattn._flash_bwd_reference(*views, lse, g.unflatten(-1, (n, d)), cos, sin,
                                       k.shape[1], d ** -0.5)
    return [t.flatten(2) for t in grads]


def _check_grads(got, want):
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == ref.dtype and x.shape == ref.shape, name
        assert torch.isfinite(x).all(), name
        err = (x.float() - ref.float()).abs().max().item()
        assert err <= BWD_REL_TOL * ref.float().abs().max().item(), (name, err)


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("sq,sk", [(300, 300), (77, 189)])
def test_onepass_bwd_kernel_matches_plain(rope, sq, sk):
    d, n, b = 128, 3, 2
    args = _bwd_inputs(b, sq, sk, n, d, rope, 10)
    before = tattn.flash_bwd_onepass.launches
    got = tattn.flash_bwd_onepass(*args[:6], d, cos=args[6], sin=args[7])
    torch.cuda.synchronize()
    assert tattn.flash_bwd_onepass.launches == before + 1
    _check_grads(got, _plain_bwd(*args[:6], d, *args[6:]))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,rope", [(189, 189, True), (189, 77, False), (70, 257, True)])
def test_split_bwd_kernels_match_plain(d, sq, sk, rope):
    n, b = 3, 2
    args = _bwd_inputs(b, sq, sk, n, d, rope, 20)
    before = (tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches)
    dq = tattn.flash_bwd_dq(*args[:6], d, cos=args[6], sin=args[7])
    dk, dv = tattn.flash_bwd_dkv(*args[:6], d, cos=args[6], sin=args[7])
    torch.cuda.synchronize()
    assert (tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    _check_grads((dq, dk, dv), _plain_bwd(*args[:6], d, *args[6:]))


@pytest.mark.parametrize("sk,route", [(4096, "onepass"), (512, "split")])
def test_autograd_routes_to_the_kernels(sk, route):
    """flash_attention_flat's backward takes K4 for long self-attention and
    K5a + K5b otherwise, as the JAX package routes it."""
    d, sq = 128, 4096
    q, k, v, _, _, g, cos, sin = _bwd_inputs(1, sq, sk, 1, d, sk == sq, 30)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    counters = (tattn.flash_bwd_onepass, tattn.flash_bwd_dq, tattn.flash_bwd_dkv)
    before = [c.launches for c in counters]
    out = tattn.flash_attention_flat(*leaves, d, cos=cos, sin=sin)
    out.backward(g)
    torch.cuda.synchronize()
    used = [c.launches - b for c, b in zip(counters, before)]
    assert used == ([1, 0, 0] if route == "onepass" else [0, 1, 1])
    out_ref, lse = tattn.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin)
    _check_grads([t.grad for t in leaves], _plain_bwd(q, k, v, out_ref, lse, g, d, cos, sin))


def test_bwd_with_masked_keys_raises_on_cuda():
    """kv_len < Sk (sequence-parallel shards) has no backward kernel yet: a
    CUDA tensor raises instead of taking the plain version."""
    q, k, v, out, lse, g, _, _ = _bwd_inputs(1, 64, 96, 2, 64, False, 40)
    with pytest.raises(NotImplementedError, match="kv_len"):
        tattn.flash_bwd_flat(q, k, v, out, lse, g, 64, kv_len=80)
