"""The arithmetic of the f32 attention forward on the card (route 'f32',
csrc/flash_fwd_f32.cu), emulated on the CPU: every product of Q.K^T and P.V
is taken in 3xTF32 -- each f32 operand split into hi = tf32(x) and
lo = tf32(x - hi), rounded as cvt.rna rounds (half away from zero on the 13
dropped mantissa bits), and a_hi*b_hi + a_hi*b_lo + a_lo*b_hi summed in f32
-- and the online softmax in f32 base 2. Held against f64 attention at the
VAE's head dim (384) and CLIP's (80), ten times tighter than the card's own
bound against the plain version (F32_TOL = 1e-4), so that the split, and not
only the kernel, is shown to fit that bound before the card sees it.
"""

import numpy as np
import pytest
import torch

from svi_tpu_torch.ops import attention as tattn

F32_TOL = 1e-4
LOG2E = 1.4426950408889634


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits) as cvt.rna.tf32.f32 does: add
    half of the dropped 13-bit field to the magnitude, then clear it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32 with f32 sums: the small cross terms, then hi * hi."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def attention_3xtf32(q, k, v, scale: float, block_k: int):
    """The kernel's forward on (B, N, S, D) f32: per key block, scores in
    3xTF32, the online softmax in base 2 (log2(e) folded into the scale),
    P.V in 3xTF32. Returns out and the base-e lse."""
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for j0 in range(0, k.shape[2], block_k):
        s = mm_3xtf32(q, k[:, :, j0:j0 + block_k].transpose(-1, -2)) * (scale * LOG2E)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm_3xtf32(p, v[:, :, j0:j0 + block_k])
        m = m_new
    return acc / l, (m / LOG2E + torch.log(l))[..., 0]


def test_tf32_rounding_is_half_away_from_zero():
    """A value exactly halfway between two TF32 neighbours rounds away from
    zero, either sign; TF32 values are fixed points."""
    one = 1.0
    ulp = 2.0 ** -10  # TF32's spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, 3.0], dtype=torch.float32)
    got = tf32_rna(x)
    np.testing.assert_array_equal(got.numpy(), np.float32([one + ulp, -(one + ulp), one, 3.0]))


@pytest.mark.parametrize("d,n,block_k", [(384, 1, 32), (80, 2, 64)])
def test_3xtf32_attention_is_f32_accurate(d, n, block_k):
    rng = np.random.default_rng(d)
    b, sq, sk = 1, 40, 200
    q, k, v = (rng.standard_normal((b, n, s, d)).astype(np.float32) for s in (sq, sk, sk))
    scale = d ** -0.5
    out, lse = attention_3xtf32(*(torch.from_numpy(x) for x in (q, k, v)), scale, block_k)
    s64 = np.einsum("bnqd,bnkd->bnqk", q.astype(np.float64), k.astype(np.float64)) * scale
    m64 = s64.max(-1, keepdims=True)
    p64 = np.exp(s64 - m64)
    out64 = np.einsum("bnqk,bnkd->bnqd", p64, v.astype(np.float64)) / p64.sum(-1, keepdims=True)
    lse64 = (m64 + np.log(p64.sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(out.numpy(), out64, atol=F32_TOL / 10, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse64, atol=F32_TOL / 10, rtol=0)
    # and the port's plain version (plain f32, what the card is held against)
    # sits within the same distance of f64
    ref_out, ref_lse = tattn._flash_fwd_reference(
        *(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)), None, None, sk, scale)
    np.testing.assert_allclose(ref_out.transpose(1, 2).numpy(), out64, atol=F32_TOL / 10, rtol=0)
    np.testing.assert_allclose(ref_lse.numpy(), lse64, atol=F32_TOL / 10, rtol=0)


def test_plain_tf32_would_not_fit_the_bound():
    """One TF32 product (the split's hi * hi alone) misses the bound at the
    VAE's width: why the kernel takes three."""
    rng = np.random.default_rng(1)
    q, k = (torch.from_numpy(rng.standard_normal((1, 1, 40, 384)).astype(np.float32))
            for _ in range(2))
    one = tf32_rna(q) @ tf32_rna(k).transpose(-1, -2)
    three = mm_3xtf32(q, k.transpose(-1, -2))
    exact = q.double() @ k.double().transpose(-1, -2)
    scale = 384 ** -0.5
    assert (one.double() - exact).abs().max().item() * scale > F32_TOL
    assert (three.double() - exact).abs().max().item() * scale < F32_TOL / 10
