"""The CUDA kernels (the flash forward on each route -- sm90 TMA + wgmma for
bf16 at every head dim with its RoPE pre-pass: D=128 and D=64, D=32, 40, 80,
88, 160 over zero-filled head-dim boxes and on the packed short-sequence
kernel, D=384 and 512 on the column-split kernel; 3xTF32 for f32 --,
at every head dim it is built for (D = 88 for Hunyuan-DiT), the K4
backward (TMA + wgmma), the K5a / K5b backward on each route -- sm90
TMA + wgmma for bf16 D=128 with its lse / delta prep, mma.sync for bf16
D=64, 3xTF32 for the (B, N, S, D) route's f32 D=40, 64, 80, 160, with a
text-to-image trainer step on it --, the K3 int4 unpack, the W4A8 linear --
its activation pre-pass and its int4-unpacking int8 GEMM --, its
straight-through input gradient (W8 made in shared memory, bf16 wgmma)
and the K6 int8 forward on each route --
sm90 TMA + integer wgmma at D=128, mma.sync at D=64 --) against their plain
PyTorch versions, on the card.

Marked `cuda`; every test skips where torch sees no CUDA device. Run on a
machine with an H100 and nvcc (no JAX there, so without the JAX conftest):
`python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q`.
"""

import pytest
import torch

from svi_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.cuda

# bf16: P is rounded to bf16 for P.V and out once more, ~2 bf16 ulps at |out|<=1;
# out is also held to a share of the plain version's largest |out|, so that a
# wrong P.V on some key tiles fails where a typical |out| is under 2e-2; lse
# comes from f32 scores of bf16 inputs
BF16_OUT_TOL, BF16_OUT_REL, BF16_LSE_TOL = 2e-2, 2e-2, 1e-3
# f32 path (3xTF32: about 2^-21 relative per product) against f32 PyTorch
# (no TF32): f32-level rounding and the order of sums
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


def _check(got, want, out_tol, lse_tol, out_rel=None):
    """out within out_tol (and within out_rel of the plain version's largest
    |out| when given), lse within lse_tol."""
    (o, lse), (o_ref, lse_ref) = got, want
    assert o.dtype == o_ref.dtype and o.shape == o_ref.shape
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    if out_rel is not None:
        out_tol = min(out_tol, out_rel * o_ref.float().abs().max().item())
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
    _check(got, (o_ref.flatten(2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


def _sm90_launches():
    return (tattn.flash_fwd_flat.routes[("sm90", "bfloat16", 128)]
            + tattn.flash_fwd_bnsd.routes[("sm90", "bfloat16", 128)])


@pytest.mark.parametrize("kv_len", [None, 150, 129, 0])
@pytest.mark.parametrize("sk,rope", [(189, True), (77, False), (257, False), (512, False),
                                     (1000, True)])
@pytest.mark.parametrize("sq", [189, 300])
def test_sm90_kernel_matches_plain(sq, sk, rope, kv_len):
    """The TMA + wgmma route (bf16, D = 128): Sq ragged against the 128-row
    tiles, Sk ragged against the 128-key tiles (257: one key in the last
    tile; 1000: 8 key tiles, so the 3-stage K/V ring wraps twice), kv_len
    mid-tile (150), one key past a tile (129) and 0 (every row masked: out 0,
    finite lse)."""
    d, n, b = 128, 3, 2
    q = _rand((b, sq, n * d), torch.bfloat16, 0)
    k = _rand((b, sk, n * d), torch.bfloat16, 1)
    v = _rand((b, sk, n * d), torch.bfloat16, 2)
    cos, sin = _tables(max(sq, sk), d) if rope else (None, None)
    before = _sm90_launches()
    got = tattn.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _sm90_launches() == before + 1
    kv = sk if kv_len is None else min(kv_len, sk)
    if kv == 0:  # the plain version's -1e30 mask averages v instead
        assert (got[0] == 0).all() and torch.isfinite(got[1]).all()
        assert (got[1] <= -1e30).all()
        return
    q4, k4, v4 = (t.unflatten(-1, (n, d)) for t in (q, k, v))
    o_ref, lse_ref = tattn._flash_fwd_reference(q4, k4, v4, cos, sin, kv, d ** -0.5)
    _check(got, (o_ref.flatten(2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


@pytest.mark.parametrize("rope", [True, False])
def test_sm90_strided_qkv_columns(rope):
    """q, k and v as column slices of one (B, S, 3*N*D) tensor: row stride
    3*N*D, as a fused projection hands them over."""
    d, n, b, s = 128, 3, 2, 300
    qkv = _rand((b, s, 3 * n * d), torch.bfloat16, 7)
    q, k, v = qkv[..., :n * d], qkv[..., n * d:2 * n * d], qkv[..., 2 * n * d:]
    cos, sin = _tables(s, d) if rope else (None, None)
    before = _sm90_launches()
    got = tattn.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin, kv_len=250)
    torch.cuda.synchronize()
    assert _sm90_launches() == before + 1
    o_ref, lse_ref = tattn._flash_fwd_reference(
        *(t.unflatten(-1, (n, d)) for t in (q, k, v)), cos, sin, 250, d ** -0.5)
    _check(got, (o_ref.flatten(2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


def test_sm90_bnsd_entry():
    """flash_fwd_bnsd at bf16 D = 128 takes the sm90 route on (B, N, S, D)."""
    b, n, sq, sk, d = 2, 3, 189, 257, 128
    q, k, v = (_rand((b, n, s, d), torch.bfloat16, i) for i, s in enumerate((sq, sk, sk)))
    before = tattn.flash_fwd_bnsd.routes[("sm90", "bfloat16", 128)]
    got = tattn.flash_fwd_bnsd(q, k, v, kv_len=200)
    torch.cuda.synchronize()
    assert tattn.flash_fwd_bnsd.routes[("sm90", "bfloat16", 128)] == before + 1
    o_ref, lse_ref = tattn._flash_fwd_reference(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), None, None, 200, d ** -0.5)
    _check(got, (o_ref.transpose(1, 2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


def test_rope_prepass_bit_exact():
    """The pre-pass kernel rounds as the plain rotation does: bit for bit."""
    b, s, n, d = 2, 300, 3, 128
    base = _rand((b, s, 2 * n * d), torch.bfloat16, 8)
    x = base[..., n * d:]  # strided rows
    cos, sin = _tables(s, d)
    before = tattn.rope_rotate_flat.launches
    got = tattn.rope_rotate_flat(x, cos, sin, d)
    torch.cuda.synchronize()
    assert tattn.rope_rotate_flat.launches == before + 1
    assert got.is_contiguous()
    want = tattn._apply_rope_reference(x.unflatten(-1, (n, d)), cos, sin).flatten(2)
    assert torch.equal(got, want)


def test_sm90_misaligned_view_raises():
    """A view whose data_ptr is off 16-byte alignment cannot feed TMA."""
    b, s, n, d = 1, 64, 2, 128
    flat = _rand((b * s * n * d + 4,), torch.bfloat16, 9)
    q = flat[4:].view(b, s, n * d)  # 8 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.flash_fwd_flat(q, q, q, d)


@pytest.mark.parametrize("d", [32, 64, 80, 128, 384, 40, 160, 512, 88])
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


def _f32_launches():
    return sum(n for entry in (tattn.flash_fwd_flat, tattn.flash_fwd_bnsd)
               for key, n in entry.routes.items() if key[0] == "f32")


@pytest.mark.parametrize("kv_len", [None, 211, 0])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("d", [32, 64, 80, 128, 384, 40, 160, 512, 88])
def test_f32_tc_kernel_matches_plain(d, rope, kv_len):
    """The 3xTF32 route at every head dim: Sq = 70 ragged against the 32- and
    64-row tiles, Sk = 300 (5 key tiles of 64, 10 of 32: the 2-stage K/V ring
    wraps at least twice), kv_len mid-tile (211) and 0 (every row masked: out
    0, finite lse)."""
    b, n, sq, sk = 2, 2, 70, 300
    q = _rand((b, sq, n * d), torch.float32, 80)
    k = _rand((b, sk, n * d), torch.float32, 81)
    v = _rand((b, sk, n * d), torch.float32, 82)
    cos, sin = _tables(sk, d) if rope else (None, None)
    before = _f32_launches()
    got = tattn.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _f32_launches() == before + 1
    kv = sk if kv_len is None else kv_len
    if kv == 0:
        assert (got[0] == 0).all() and torch.isfinite(got[1]).all()
        assert (got[1] <= -1e30).all()
        return
    o_ref, lse_ref = tattn._flash_fwd_reference(
        *(t.unflatten(-1, (n, d)) for t in (q, k, v)), cos, sin, kv, d ** -0.5)
    _check(got, (o_ref.flatten(2), lse_ref), F32_TOL, F32_TOL)


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


@pytest.mark.parametrize("d", [40, 80, 160])
def test_f32_sd_cross_attention_ragged_keys(d):
    """The SD UNet's cross-attention: 8 heads, 77 text keys, one full 64-key
    tile and a ragged last one (or five 16-key tiles on the short route)."""
    for sq in (300, 16):
        q = _rand((2, sq, 8 * d), torch.float32, 90)
        k, v = (_rand((2, 77, 8 * d), torch.float32, 91 + i) for i in range(2))
        got = tattn.flash_attention(*(t.unflatten(-1, (8, d)) for t in (q, k, v)))
        o_ref, _ = tattn._flash_fwd_reference(*(t.unflatten(-1, (8, d)) for t in (q, k, v)),
                                              None, None, 77, d ** -0.5)
        assert (got - o_ref).abs().max().item() <= F32_TOL


@pytest.mark.parametrize("d", [40, 80, 160])
def test_f32_temporal_attention_many_batches(d):
    """AnimateDiff's temporal attention: Sq = Sk = 16 frames over many
    (pixel, head) batches, on the short-query tiles."""
    q, k, v = (_rand((4096, 16, 8 * d), torch.float32, 95 + i) for i in range(3))
    before = _f32_launches()
    got = tattn.flash_fwd_bnsd(*(t.unflatten(-1, (8, d)).transpose(1, 2) for t in (q, k, v)))
    torch.cuda.synchronize()
    assert _f32_launches() == before + 1
    o_ref, lse_ref = tattn._flash_fwd_reference(*(t.unflatten(-1, (8, d)) for t in (q, k, v)),
                                                None, None, 16, d ** -0.5)
    _check(got, (o_ref.transpose(1, 2), lse_ref), F32_TOL, F32_TOL)


def test_f32_sd_vae_mid_block_s4096():
    """The SD VAE's mid-block at 512x512: one head of 512 over 64 x 64 = 4096
    tokens through the flat entry, q, k and v column slices of one qkv
    tensor (row stride 3 x 512)."""
    c, s = 512, 4096
    qkv = _rand((1, s, 3 * c), torch.float32, 7)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    got = tattn.flash_fwd_flat(q, k, v, c)
    torch.cuda.synchronize()
    o_ref, lse_ref = tattn._flash_fwd_reference(q[:, :, None], k[:, :, None], v[:, :, None],
                                                None, None, s, c ** -0.5)
    _check(got, (o_ref.flatten(2), lse_ref), F32_TOL, F32_TOL)


@pytest.mark.parametrize("sq,n,sk", [(4096, 10, 4096), (4096, 10, 77), (1024, 20, 1024),
                                     (1024, 20, 77)])
def test_f32_sdxl_unet_attention(sq, n, sk):
    """The SDXL UNet's attention at 1024 x 1024: heads of 64 (10 at the
    64 x 64 level, 20 at 32 x 32), self-attention and the 77-token text
    cross-attention, through the (B, N, S, D) entry."""
    q = _rand((2, sq, n * 64), torch.float32, 100)
    k, v = (_rand((2, sk, n * 64), torch.float32, 101 + i) for i in range(2))
    before = _f32_launches()
    got = tattn.flash_attention(*(t.unflatten(-1, (n, 64)) for t in (q, k, v)))
    torch.cuda.synchronize()
    assert _f32_launches() == before + 1
    o_ref, _ = tattn._flash_fwd_reference(*(t.unflatten(-1, (n, 64)) for t in (q, k, v)),
                                          None, None, sk, 64 ** -0.5)
    assert (got - o_ref).abs().max().item() <= F32_TOL


@pytest.mark.parametrize("sk", [4096, 333])
def test_f32_d88_hunyuan_dit_attention(sk):
    """Hunyuan-DiT at 1024 x 1024: 16 heads of 88 (11 k-steps of 8) over
    64 x 64 = 4096 image tokens, self-attention and the cross-attention over
    77 + 256 text tokens, B2 (CFG's two passes batch one each; the kernel
    sees B2 here), q, k, v (B, N, S, D) views of (B, S, 16 * 88) tensors
    (rows 1408 floats apart) through the (B, N, S, D) entry, counted as
    route f32 at D = 88."""
    d, n = 88, 16
    q = _rand((2, 4096, n * d), torch.float32, 110)
    k, v = (_rand((2, sk, n * d), torch.float32, 111 + i) for i in range(2))
    before = tattn.flash_fwd_bnsd.routes[("f32", "float32", d)]
    got = tattn.flash_attention(*(t.unflatten(-1, (n, d)) for t in (q, k, v)))
    torch.cuda.synchronize()
    assert tattn.flash_fwd_bnsd.routes[("f32", "float32", d)] == before + 1
    o_ref, _ = tattn._flash_fwd_reference(*(t.unflatten(-1, (n, d)) for t in (q, k, v)),
                                          None, None, sk, d ** -0.5)
    assert (got - o_ref).abs().max().item() <= F32_TOL


def test_bf16_d128_stepvideo_self_attention():
    """StepVideo's self-attention at one latent frame of 544 x 992 (1 x 34 x
    62 = 2108 tokens, ragged against the 128-row tiles), 48 heads of 128,
    bf16, as its block hands it over: q and k rotated in torch by the
    half-rotation RoPE of the (64, 32, 32) split, v a strided slice of the
    packed qkv; through `flash_attention`, counted as K1's flat entry on
    route "sm90" at D = 128."""
    from svi_tpu_torch.models import stepvideo as sv

    d, n, s = 128, 48, 2108
    q, k, v = _rand((1, s, n, 3 * d), torch.bfloat16, 130).split(d, dim=-1)
    cos, sin = (torch.from_numpy(t).cuda() for t in sv.prepare_stepvideo_rope(1, 34, 62))
    q, k = sv._rope_apply(q, cos, sin), sv._rope_apply(k, cos, sin)
    before = tattn.flash_fwd_flat.routes[("sm90", "bfloat16", d)]
    with torch.no_grad():
        got = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_fwd_flat.routes[("sm90", "bfloat16", d)] == before + 1
    o_ref, _ = tattn._flash_fwd_reference(q, k, v.contiguous(), None, None, s, d ** -0.5)
    assert got.dtype == o_ref.dtype and got.shape == o_ref.shape == (1, s, n, d)
    assert torch.isfinite(got).all()
    tol = min(BF16_OUT_TOL, BF16_OUT_REL * o_ref.float().abs().max().item())
    assert (got.float() - o_ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("s,kv_len", [(17776, None), (514, 500)])
def test_bf16_d64_mma_cogvideox_attention(s, kv_len):
    """CogVideoX-5B's joint attention: 48 heads of 64 over 226 text + 13 x 30
    x 45 video tokens (17776) at B2 (batched CFG), bf16, as (B, N, S, D)
    views of (B, S, 48 * 64) tensors through the (B, N, S, D) entry, route
    "sm90" at D = 64; and a short ragged sequence with masked keys."""
    d, n = 64, 48
    q, k, v = (_rand((2, s, n * d), torch.bfloat16, 120 + i) for i in range(3))
    before = tattn.flash_fwd_bnsd.routes[("sm90", "bfloat16", d)]
    got = tattn.flash_fwd_bnsd(*(t.unflatten(-1, (n, d)).transpose(1, 2) for t in (q, k, v)),
                               kv_len=kv_len)
    torch.cuda.synchronize()
    assert tattn.flash_fwd_bnsd.routes[("sm90", "bfloat16", d)] == before + 1
    kv = s if kv_len is None else kv_len
    o_ref, lse_ref = tattn._flash_fwd_reference(*(t.unflatten(-1, (n, d)) for t in (q, k, v)),
                                                None, None, kv, d ** -0.5)
    _check(got, (o_ref.transpose(1, 2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


# the sm90 D = 64 kernel's tile edges: 64-row warpgroups, CTAs of 2 or 3 of
# them (128 or 192 query rows), 128-key tiles
D64_EDGES = (1, 63, 64, 65, 127, 128, 129, 191, 192, 193)


def _sm90_d64_launches():
    return (tattn.flash_fwd_flat.routes[("sm90", "bfloat16", 64)]
            + tattn.flash_fwd_bnsd.routes[("sm90", "bfloat16", 64)])


def _bnsd_d64(b, sq, sk, n, seed):
    """q, k, v as (B, N, S, D) views of (B, S, N * 64) rows, and their
    (B, S, N, D) views for the plain version."""
    q = _rand((b, sq, n * 64), torch.bfloat16, seed)
    k, v = (_rand((b, sk, n * 64), torch.bfloat16, seed + 1 + i) for i in range(2))
    views = [t.unflatten(-1, (n, 64)) for t in (q, k, v)]
    return [t.transpose(1, 2) for t in views], views


@pytest.mark.parametrize("sk", D64_EDGES)
@pytest.mark.parametrize("sq", D64_EDGES)
def test_sm90_d64_tile_edges(sq, sk):
    """bf16 D = 64 through the (B, N, S, D) entry on strided views, Sq and Sk
    on each side of the kernel's row and key tile edges."""
    n, b = 3, 2
    heads, views = _bnsd_d64(b, sq, sk, n, 130)
    before = _sm90_d64_launches()
    got = tattn.flash_fwd_bnsd(*heads)
    torch.cuda.synchronize()
    assert _sm90_d64_launches() == before + 1
    o_ref, lse_ref = tattn._flash_fwd_reference(*views, None, None, sk, 64 ** -0.5)
    _check(got, (o_ref.transpose(1, 2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


@pytest.mark.parametrize("kv_len", [0, 1, 129, 700, 999])
def test_sm90_d64_kv_len(kv_len):
    """kv_len < Sk at D = 64: Sk 1000 (8 key tiles, so the K/V ring wraps),
    kv_len one key, one past a tile, mid-way and one short; 0 masks every
    key (out 0, lse -1e30 + log(1e-30), finite)."""
    n, b, sq, sk = 2, 2, 193, 1000
    heads, views = _bnsd_d64(b, sq, sk, n, 140)
    before = _sm90_d64_launches()
    got = tattn.flash_fwd_bnsd(*heads, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _sm90_d64_launches() == before + 1
    if kv_len == 0:  # the plain version's -1e30 mask averages v instead
        assert (got[0] == 0).all() and torch.isfinite(got[1]).all()
        assert (got[1] <= -1e30).all()
        return
    o_ref, lse_ref = tattn._flash_fwd_reference(*views, None, None, kv_len, 64 ** -0.5)
    _check(got, (o_ref.transpose(1, 2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


def test_sm90_d64_single_head_flat_rope():
    """One head of 64 through the flat entry (the JAX routing's flat case
    for N = 1) with RoPE tables: q and k through the pre-pass, then the
    kernel; q, k, v column slices of one (B, S, 3 * 64) tensor."""
    b, s, d = 2, 300, 64
    qkv = _rand((b, s, 3 * d), torch.bfloat16, 150)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    cos, sin = _tables(s, d)
    before, rope_before = _sm90_d64_launches(), tattn.rope_rotate_flat.launches
    got = tattn.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin)
    torch.cuda.synchronize()
    assert _sm90_d64_launches() == before + 1
    assert tattn.rope_rotate_flat.launches == rope_before + 2
    o_ref, lse_ref = tattn._flash_fwd_reference(
        *(t.unflatten(-1, (1, d)) for t in (q, k, v)), cos, sin, s, d ** -0.5)
    _check(got, (o_ref.flatten(2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


def test_sm90_d64_misaligned_view_raises():
    """A D = 64 view whose data_ptr is off 16-byte alignment cannot feed TMA:
    the wrapper raises before any launch."""
    b, s, n, d = 1, 64, 2, 64
    flat = _rand((b * s * n * d + 4,), torch.bfloat16, 160)
    q = flat[4:].view(b, s, n, d).transpose(1, 2)  # 8 bytes past an aligned start
    before = _sm90_d64_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.flash_fwd_bnsd(q, q, q)
    assert _sm90_d64_launches() == before


def test_f32_sdxl_vae_mid_block_s16384():
    """The SDXL VAE's mid-block at 1024 x 1024: one head of 512 over
    128 x 128 = 16384 tokens through the flat entry."""
    c, s = 512, 16384
    qkv = _rand((1, s, 3 * c), torch.float32, 8)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    got = tattn.flash_fwd_flat(q, k, v, c)
    torch.cuda.synchronize()
    o_ref, lse_ref = tattn._flash_fwd_reference(q[:, :, None], k[:, :, None], v[:, :, None],
                                                None, None, s, c ** -0.5)
    _check(got, (o_ref.flatten(2), lse_ref), F32_TOL, F32_TOL)


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


# the sm90 kernels' head dims other than 64 and 128 (route "sm90",
# csrc/flash_fwd_sm90.cu): tiles of DP = D rounded up to 64 columns, zero-filled
# by TMA past D; 192-row CTAs and 128-key tiles at D = 32, 40, 128-row CTAs and
# 128-key tiles at 80, 88, 128-row CTAs and 64-key tiles at 160; four
# (batch, head) items of 16 rows a tile when Sq and Sk <= 16; 64-row CTAs
# whose two warpgroups split O's columns, 64-key tiles, at 384 and 512
BF16_DIMS = (32, 40, 80, 88, 160, 384, 512)
BF16_EDGES = [(1, 1), (16, 77), (17, 33), (63, 65), (65, 129), (189, 300)]


def _bf16_launches(d):
    return (tattn.flash_fwd_flat.routes[("sm90", "bfloat16", d)]
            + tattn.flash_fwd_bnsd.routes[("sm90", "bfloat16", d)])


def _bf16_bnsd(b, sq, sk, n, d, seed):
    """q, k, v as (B, N, S, D) views of (B, S, N * D) rows, and their
    (B, S, N, D) views for the plain version."""
    q = _rand((b, sq, n * d), torch.bfloat16, seed)
    k, v = (_rand((b, sk, n * d), torch.bfloat16, seed + 1 + i) for i in range(2))
    views = [t.unflatten(-1, (n, d)) for t in (q, k, v)]
    return [t.transpose(1, 2) for t in views], views


@pytest.mark.parametrize("sq,sk", BF16_EDGES)
@pytest.mark.parametrize("d", BF16_DIMS)
def test_bf16_kernel_tile_edges(d, sq, sk):
    """bf16 through the (B, N, S, D) entry on strided views, Sq and Sk on
    each side of the row and key tile edges (and the packed short-sequence
    kernel at Sq and Sk <= 16), route "sm90"."""
    heads, views = _bf16_bnsd(2, sq, sk, 3, d, 170)
    before = _bf16_launches(d)
    got = tattn.flash_fwd_bnsd(*heads)
    torch.cuda.synchronize()
    assert _bf16_launches(d) == before + 1
    o_ref, lse_ref = tattn._flash_fwd_reference(*views, None, None, sk, d ** -0.5)
    _check(got, (o_ref.transpose(1, 2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


@pytest.mark.parametrize("kv_len", [0, 1, 33, 150, 299])
@pytest.mark.parametrize("d", BF16_DIMS)
def test_bf16_kernel_kv_len(d, kv_len):
    """kv_len < Sk: Sk 300 (3 key tiles of 128, 5 of 64), kv_len one key,
    mid-tile, and one short; 0 masks every key (out 0, lse -1e30 +
    log(1e-30), finite)."""
    heads, views = _bf16_bnsd(2, 70, 300, 2, d, 180)
    before = _bf16_launches(d)
    got = tattn.flash_fwd_bnsd(*heads, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _bf16_launches(d) == before + 1
    if kv_len == 0:  # the plain version's -1e30 mask averages v instead
        assert (got[0] == 0).all() and torch.isfinite(got[1]).all()
        assert (got[1] <= -1e30).all()
        return
    o_ref, lse_ref = tattn._flash_fwd_reference(*views, None, None, kv_len, d ** -0.5)
    _check(got, (o_ref.transpose(1, 2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


@pytest.mark.parametrize("d", BF16_DIMS)
def test_bf16_kernel_strided_qkv_columns(d):
    """q, k and v as (B, N, S, D) views of column slices of one
    (B, S, 3 * N * D) tensor (row stride 3 * N * D, as a fused projection
    hands them over), cross-attention shaped: Sq 200, Sk 77 from another
    slice of rows."""
    n, b = 2, 2
    qkv = _rand((b, 200, 3 * n * d), torch.bfloat16, 190)
    q = qkv[..., :n * d]
    k, v = qkv[:, 50:127, n * d:2 * n * d], qkv[:, 50:127, 2 * n * d:]
    views = [t.unflatten(-1, (n, d)) for t in (q, k, v)]
    before = _bf16_launches(d)
    got = tattn.flash_fwd_bnsd(*(t.transpose(1, 2) for t in views))
    torch.cuda.synchronize()
    assert _bf16_launches(d) == before + 1
    o_ref, lse_ref = tattn._flash_fwd_reference(*views, None, None, 77, d ** -0.5)
    _check(got, (o_ref.transpose(1, 2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


@pytest.mark.parametrize("d", BF16_DIMS)
def test_bf16_kernel_single_head_flat_rope(d):
    """One head through the flat entry (the JAX routing's flat case for
    N = 1, as the VAE mid-blocks call it) with RoPE tables: q and k through
    the pre-pass, then the kernel; q, k, v column slices of one
    (B, S, 3 * D) tensor."""
    b, s = 2, 300
    qkv = _rand((b, s, 3 * d), torch.bfloat16, 200)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    cos, sin = _tables(s, d)
    before, rope_before = _bf16_launches(d), tattn.rope_rotate_flat.launches
    got = tattn.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin)
    torch.cuda.synchronize()
    assert tattn.flash_fwd_flat.routes[("sm90", "bfloat16", d)] > 0
    assert _bf16_launches(d) == before + 1
    assert tattn.rope_rotate_flat.launches == rope_before + 2
    o_ref, lse_ref = tattn._flash_fwd_reference(
        *(t.unflatten(-1, (1, d)) for t in (q, k, v)), cos, sin, s, d ** -0.5)
    _check(got, (o_ref.flatten(2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


@pytest.mark.parametrize("sk,kv_len", [(1000, 650), (700, 577)])
@pytest.mark.parametrize("d", BF16_DIMS)
def test_bf16_kernel_kv_len_inside_the_last_tile(d, sk, kv_len):
    """kv_len inside the last key tile of a longer ring (tile 6 of 128 keys
    or 11 of 64; the ring of 3 or 4 stages wraps, the single K and V
    buffers of D = 384 / 512 refill ten times): only the last tile is
    masked, past kv_len."""
    heads, views = _bf16_bnsd(1, 130, sk, 2, d, 240)
    before = _bf16_launches(d)
    got = tattn.flash_fwd_bnsd(*heads, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _bf16_launches(d) == before + 1
    o_ref, lse_ref = tattn._flash_fwd_reference(*views, None, None, kv_len, d ** -0.5)
    _check(got, (o_ref.transpose(1, 2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


@pytest.mark.parametrize("d", [40, 88, 160])
def test_bf16_kernel_pad_columns_never_touch_a_neighbour(d):
    """Three heads through the flat entry, each of q, k, v cut from five
    heads of one (B, S, 5 D) tensor whose first and last heads hold values
    1e4 times larger: a box wider than D that read the next head's columns
    would move the result far past the bound. The kernel's own out (B, S,
    3 D) has adjacent heads, each written by other CTAs: a store of a box's
    pad columns would overwrite the next head's."""
    b, s, n = 2, 200, 3

    def cut(seed):
        full = _rand((b, s, (n + 2) * d), torch.bfloat16, seed)
        full[..., :d] *= 1e4
        full[..., (n + 1) * d:] *= 1e4
        return full[..., d:(n + 1) * d]

    q, k, v = cut(250), cut(251), cut(252)
    before = _bf16_launches(d)
    got = tattn.flash_fwd_flat(q, k, v, d)
    torch.cuda.synchronize()
    assert _bf16_launches(d) == before + 1
    o_ref, lse_ref = tattn._flash_fwd_reference(
        *(t.unflatten(-1, (n, d)) for t in (q, k, v)), None, None, s, d ** -0.5)
    _check(got, (o_ref.flatten(2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


@pytest.mark.parametrize("layout", ["bsnd", "bnsd"])
@pytest.mark.parametrize("d", BF16_DIMS)
def test_bf16_kernel_last_head_ends_its_allocation(d, layout):
    """q, k and v each in an allocation of exactly its size, contiguous as
    (B, S, N, D) or as (B, N, S, D): the last head's last row ends the
    allocation, so a box that read columns past D, or rows past S, would
    read past it."""
    b, sq, sk, n = 1, 130, 70, 2
    shapes = [(b, s, n, d) if layout == "bsnd" else (b, n, s, d) for s in (sq, sk, sk)]
    q, k, v = (_rand(shape, torch.bfloat16, 260 + i) for i, shape in enumerate(shapes))
    views = [t if layout == "bsnd" else t.transpose(1, 2) for t in (q, k, v)]
    before = _bf16_launches(d)
    got = tattn.flash_fwd_bnsd(*(t.transpose(1, 2) for t in views))
    torch.cuda.synchronize()
    assert _bf16_launches(d) == before + 1
    o_ref, lse_ref = tattn._flash_fwd_reference(*views, None, None, sk, d ** -0.5)
    _check(got, (o_ref.transpose(1, 2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


@pytest.mark.parametrize("b,sq,sk,kv_len", [(1024, 16, 16, None), (1025, 9, 13, 11)])
@pytest.mark.parametrize("d", [32, 40, 80, 88, 160])
def test_bf16_kernel_short_sequences_many_batches(d, b, sq, sk, kv_len):
    """AnimateDiff's temporal attention (16 frames over thousands of (pixel,
    head) batches) on the packed kernel: four (batch, head) items a 64-row
    tile; B 1025 x N 3 items leave the last tile three phantom items (never
    stored), and Sq 9 / Sk 13 / kv_len 11 leave rows and keys of each item
    empty."""
    n = 3
    heads, views = _bf16_bnsd(b, sq, sk, n, d, 270)
    before = _bf16_launches(d)
    got = tattn.flash_fwd_bnsd(*heads, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _bf16_launches(d) == before + 1
    o_ref, lse_ref = tattn._flash_fwd_reference(*views, None, None, kv_len or sk, d ** -0.5)
    _check(got, (o_ref.transpose(1, 2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


@pytest.mark.parametrize("s", [1000, 4096])
@pytest.mark.parametrize("d", [384, 512])
def test_bf16_wide_kernel_fewer_ctas_than_sms(d, s):
    """One head of 384 or 512 through the flat entry at B1: 16 or 64 CTAs of
    64 rows for the card's 132 SMs."""
    qkv = _rand((1, s, 3 * d), torch.bfloat16, 280)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    before = _bf16_launches(d)
    got = tattn.flash_fwd_flat(q, k, v, d)
    torch.cuda.synchronize()
    assert _bf16_launches(d) == before + 1
    o_ref, lse_ref = tattn._flash_fwd_reference(
        *(t.unflatten(-1, (1, d)) for t in (q, k, v)), None, None, s, d ** -0.5)
    _check(got, (o_ref.flatten(2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


@pytest.mark.parametrize("d", BF16_DIMS)
def test_bf16_kernel_misaligned_view_raises(d):
    """A view whose data_ptr is 8 bytes off 16-byte alignment: the wrapper
    raises before any launch."""
    b, s, n = 1, 64, 2
    flat = _rand((b * s * n * d + 4,), torch.bfloat16, 210)
    q = flat[4:].view(b, s, n, d).transpose(1, 2)
    before = _bf16_launches(d)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.flash_fwd_bnsd(q, q, q)
    assert _bf16_launches(d) == before


@pytest.mark.parametrize("case", ["sd_self_d40", "sd_cross_d80", "hunyuan_dit_self_d88",
                                  "vae_mid_d512"])
def test_bf16_kernel_at_the_pipelines_shapes(case):
    """The bf16 pipelines' shapes: SD 1.5's self-attention at 512 x 512 with
    batched CFG (B2 S4096 N8 D40), its D80 cross-attention over 77 tokens,
    Hunyuan-DiT's B2 S4096 N16 D88 and the SDXL / SD3 / FLUX VAE's one head
    of 512 over 128 x 128 tokens, the last through the flat entry on column
    slices of one qkv tensor."""
    b, sq, sk, n, d = {"sd_self_d40": (2, 4096, 4096, 8, 40),
                       "sd_cross_d80": (2, 1024, 77, 8, 80),
                       "hunyuan_dit_self_d88": (2, 4096, 4096, 16, 88),
                       "vae_mid_d512": (1, 16384, 16384, 1, 512)}[case]
    before = _bf16_launches(d)
    if n == 1:
        qkv = _rand((b, sq, 3 * d), torch.bfloat16, 220)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        got = tattn.flash_fwd_flat(q, k, v, d)
        views = [t.unflatten(-1, (1, d)) for t in (q, k, v)]
    else:
        heads, views = _bf16_bnsd(b, sq, sk, n, d, 230)
        got = tattn.flash_fwd_bnsd(*heads)
    torch.cuda.synchronize()
    assert _bf16_launches(d) == before + 1
    o_ref, lse_ref = tattn._flash_fwd_reference(*views, None, None, sk, d ** -0.5)
    o_ref = o_ref.flatten(2) if n == 1 else o_ref.transpose(1, 2)
    _check(got, (o_ref, lse_ref), BF16_OUT_TOL, BF16_LSE_TOL, BF16_OUT_REL)


def test_unsupported_head_dim_raises():
    q = _rand((1, 2, 8, 96), torch.bfloat16, 0)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_fwd_bnsd(q, q, q)


# ---------------------------------------------------------------------------
# Backward kernels (K4 one-pass, K5a dq + K5b dk/dv)
# ---------------------------------------------------------------------------

# bf16 gradients against the plain f32 backward of the same bf16 inputs: the
# kernels round P and dS to bf16 before the products that consume them and
# round each gradient once to bf16 (2^-8 relative); K4 also sums dq, and the
# sm90 K5b dk and dv, in f32 (TMA reduce-adds) in an order that changes from
# run to run. 2% of the gradient's largest magnitude covers both with room,
# and is far below what a wrong tile, mask or rotation gives (errors of the
# gradient's own size).
BWD_REL_TOL = 2e-2


def _split_launches(route):
    """Launches of K5a and K5b on a route (any dtype and head dim)."""
    return tuple(sum(n for key, n in entry.routes.items() if key[0] == route)
                 for entry in (tattn.flash_bwd_dq, tattn.flash_bwd_dkv))


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
@pytest.mark.parametrize("sq,sk", [(300, 300), (77, 189), (700, 600)])
def test_onepass_bwd_kernel_matches_plain(rope, sq, sk):
    """K4 (TMA + wgmma): ragged Sq and Sk against the 64-row and 128-key
    tiles; (700, 600) has 5 key tiles (CTAs) and 11 query steps, so the
    2-stage Q / dO ring and the double-buffered dS wrap several times."""
    d, n, b = 128, 3, 2
    args = _bwd_inputs(b, sq, sk, n, d, rope, 10)
    before = tattn.flash_bwd_onepass.launches
    got = tattn.flash_bwd_onepass(*args[:6], d, cos=args[6], sin=args[7])
    torch.cuda.synchronize()
    assert tattn.flash_bwd_onepass.launches == before + 1
    _check_grads(got, _plain_bwd(*args[:6], d, *args[6:]))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,rope", [(189, 189, True), (189, 77, False), (70, 257, True),
                                        (1000, 512, False), (2100, 257, True)])
def test_split_bwd_kernels_match_plain(d, sq, sk, rope):
    """Each entry alone, on the route of its head dim (D = 128: sm90, D = 64:
    mma). Ragged Sq and Sk against the 128-row and 64-key tiles of dq and the
    128-key tiles and 64-row steps of dk / dv; at (1000, 512) dq's 4-stage
    K / V ring wraps (8 key tiles) and dk / dv runs 2 query chunks of 8
    steps, at (2100, 257) 4 chunks of 8-9 steps (the ring wraps twice) and a
    last key tile with one live key (a warpgroup with none)."""
    n, b = 3, 2
    route = "sm90" if d == 128 else "mma"
    args = _bwd_inputs(b, sq, sk, n, d, rope, 20)
    before = _split_launches(route)
    dq = tattn.flash_bwd_dq(*args[:6], d, cos=args[6], sin=args[7])
    dk, dv = tattn.flash_bwd_dkv(*args[:6], d, cos=args[6], sin=args[7])
    torch.cuda.synchronize()
    assert _split_launches(route) == (before[0] + 1, before[1] + 1)
    _check_grads((dq, dk, dv), _plain_bwd(*args[:6], d, *args[6:]))


@pytest.mark.parametrize("rope", [True, False])
def test_split_bwd_strided_qkv_columns(rope):
    """The sm90 split backward through flash_bwd_flat (one prep for both
    kernels) on q, k, v as column slices of one (B, S, 3*N*D) tensor and dO
    as a column slice too: row strides of 3*N*D."""
    d, n, b, sq = 128, 3, 2, 700
    qkv = _rand((b, sq, 3 * n * d), torch.bfloat16, 21)
    q, k, v = qkv[..., :n * d], qkv[..., n * d:2 * n * d], qkv[..., 2 * n * d:]
    g = _rand((b, sq, 2 * n * d), torch.bfloat16, 22)[..., n * d:]
    cos, sin = _tables(sq, d) if rope else (None, None)
    out, lse = tattn.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin)
    assert tattn._bwd_route(n, d, sq, sq, sq) == "split"
    before = _split_launches("sm90")
    got = tattn.flash_bwd_flat(q, k, v, out, lse, g, d, cos=cos, sin=sin)
    torch.cuda.synchronize()
    assert _split_launches("sm90") == (before[0] + 1, before[1] + 1)
    _check_grads(got, _plain_bwd(q, k, v, out, lse, g, d, cos, sin))


# the f32 split backward (csrc/flash_bwd_f32.cu: 3xTF32 on the tensor cores,
# about 2^-21 relative per product) against the plain f32 backward (TF32 off)
# on the same inputs: f32-level rounding and the order of the sums over up
# to a few thousand keys or queries (and, in dk / dv, over query chunks)
# differ; each gradient within 1e-4 of its own largest magnitude, far below
# what a wrong tile or
# mask gives, or within the rounding floor where that is larger (one key
# makes dq and dk exactly 0 but for rounding): one ulp (2^-23) of the
# largest |dO| |v| over per-head rows, times the scale, the largest |q| or
# |k| and sqrt(ceil(Sq / Sk)) (the queries whose rounding a key's dk sums)
F32_BWD_REL_TOL = 1e-4
F32_BWD_EDGES = (1, 63, 64, 65, 77, 128, 129)


def _f32_bwd_inputs(b, sq, sk, n, d, seed):
    q, k, v, g = (_rand((b, s, n * d), torch.float32, seed + i)
                  for i, s in enumerate((sq, sk, sk, sq)))
    out, lse = tattn._forward_flat(q, k, v, d, None, None, sk, d ** -0.5)
    return q, k, v, out, lse, g


def _f32_bwd_floor(q, k, v, g, d):
    def row(t):
        return t.unflatten(-1, (-1, d)).norm(dim=-1).max().item()

    share = -(-q.shape[1] // k.shape[1])
    largest = max(q.abs().max().item(), k.abs().max().item())
    return 2.0 ** -23 * d ** -0.5 * row(g) * row(v) * largest * share ** 0.5


def _check_grads_f32(got, want, q, k, v, g, d):
    floor = _f32_bwd_floor(q, k, v, g, d)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == ref.dtype == torch.float32 and x.shape == ref.shape, name
        assert torch.isfinite(x).all(), name
        bound = max(F32_BWD_REL_TOL * ref.abs().max().item(), floor)
        err = (x - ref).abs().max().item()
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("d", [40, 64, 80, 160])
@pytest.mark.parametrize("sq,sk", [(300, 300), (300, 77), (64, 257), (1000, 600)])
def test_f32_bwd_kernels_match_plain(d, sq, sk):
    """Each f32 entry alone at the four head dims of the SD 1.5 and SDXL
    UNets: ragged Sq and Sk against the 64-row tiles of both kernels, text
    keys (77), and several steps of each kernel's loop."""
    n, b = 3, 2
    args = _f32_bwd_inputs(b, sq, sk, n, d, 60)
    before = (tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches, _split_launches("f32"))
    dq = tattn.flash_bwd_dq(*args, d)
    dk, dv = tattn.flash_bwd_dkv(*args, d)
    torch.cuda.synchronize()
    assert tattn.flash_bwd_dq.launches == before[0] + 1
    assert tattn.flash_bwd_dkv.launches == before[1] + 1
    assert _split_launches("f32") == (before[2][0] + 1, before[2][1] + 1)
    q, k, v, _, _, g = args
    _check_grads_f32((dq, dk, dv), _plain_bwd(*args, d, None, None), q, k, v, g, d)


@pytest.mark.parametrize("sk", F32_BWD_EDGES)
@pytest.mark.parametrize("sq", F32_BWD_EDGES)
def test_f32_bwd_tile_edges(sq, sk):
    """flash_bwd_flat on the (B, N, S, D) route (3 heads of 40, B = 2) at
    every pair of tile edges: one row, a tile less one, a tile, a tile and
    one, the text's 77, two tiles and two tiles and one."""
    d, n, b = 40, 3, 2
    args = _f32_bwd_inputs(b, sq, sk, n, d, 70)
    assert tattn._bwd_route(n, d, sq, sk, sk) == "xla"
    before = _split_launches("f32")
    got = tattn.flash_bwd_flat(*args, d)
    torch.cuda.synchronize()
    assert _split_launches("f32") == (before[0] + 1, before[1] + 1)
    q, k, v, _, _, g = args
    _check_grads_f32(got, _plain_bwd(*args, d, None, None), q, k, v, g, d)


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _f32_chunks(b, n, sq, sk):
    return tattn._f32_dkv_chunks(b, n, sq, sk, _sms())


def _check_dkv_f32(dk, dv, want, q, k, v, g, d):
    floor = _f32_bwd_floor(q, k, v, g, d)
    for name, x, ref in (("dk", dk, want[1]), ("dv", dv, want[2])):
        assert x.dtype == ref.dtype == torch.float32 and x.shape == ref.shape, name
        assert torch.isfinite(x).all(), name
        bound = max(F32_BWD_REL_TOL * ref.abs().max().item(), floor)
        err = (x - ref).abs().max().item()
        assert err <= bound, (name, err, bound)


@pytest.mark.parametrize("d", [40, 64, 80, 160])
@pytest.mark.parametrize("sq", ["one", 192, 193, 256, 257, "most"])
def test_f32_bwd_dkv_query_chunks(d, sq):
    """dk / dv of one 50-key tile (one head, B = 1: a grid of one CTA a
    chunk) across the query-chunk rule: Sq in one chunk (100), the last Sq
    of one chunk and the first of two (192, 193: the chunks meet at query 128), the second chunk
    ending on a 64-query unit and one query past it (256, 257), and the
    most chunks the rule picks (two waves of the card's SMs, at Sq = 256 x
    SMs), against the plain backward."""
    sms = _sms()
    sq, want_chunks = {"one": (100, 1), 192: (192, 1), 193: (193, 2), 256: (256, 2),
                       257: (257, 2), "most": (256 * sms, 2 * sms)}[sq]
    sk, n, b = 50, 1, 1
    assert _f32_chunks(b, n, sq, sk) == want_chunks
    args = _f32_bwd_inputs(b, sq, sk, n, d, 100)
    before = _split_launches("f32")
    dk, dv = tattn.flash_bwd_dkv(*args, d)
    torch.cuda.synchronize()
    assert _split_launches("f32") == (before[0], before[1] + 1)
    q, k, v, _, _, g = args
    _check_dkv_f32(dk, dv, _plain_bwd(*args, d, None, None), q, k, v, g, d)


@pytest.mark.parametrize("d", [40, 64, 80, 160])
@pytest.mark.parametrize("sq,sk", [(1024, 77), (128, 600)])
def test_f32_bwd_kernels_are_deterministic(d, sq, sk):
    """dq and dk / dv twice on the same inputs, bit for bit: SD's 77 text
    keys (8 heads: dk / dv over query chunks, their partials summed in
    order) and 128 queries (one chunk) over 600 keys (dq's sums flushed
    from the registers twice)."""
    n, b = 8, 1
    args = _f32_bwd_inputs(b, sq, sk, n, d, 110)
    assert (_f32_chunks(b, n, sq, sk) > 1) == (sk == 77)
    first = (tattn.flash_bwd_dq(*args, d), *tattn.flash_bwd_dkv(*args, d))
    second = (tattn.flash_bwd_dq(*args, d), *tattn.flash_bwd_dkv(*args, d))
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


def test_f32_bwd_dkv_sdxl_n20_under_one_wave():
    """dk / dv at SDXL's 32 x 32 level (20 heads of 64) against the 77 text
    keys at B = 2: 80 CTAs, under one wave of the card, so the queries are
    cut into chunks; against the plain backward."""
    b, sq, sk, n, d = 2, 1024, 77, 20, 64
    assert -(-sk // 64) * n * b < _sms()
    assert _f32_chunks(b, n, sq, sk) > 1
    args = _f32_bwd_inputs(b, sq, sk, n, d, 120)
    dk, dv = tattn.flash_bwd_dkv(*args, d)
    torch.cuda.synchronize()
    q, k, v, _, _, g = args
    _check_dkv_f32(dk, dv, _plain_bwd(*args, d, None, None), q, k, v, g, d)


@pytest.mark.parametrize("layout", ["bsnd", "bnsd"])
def test_f32_bwd_autograd_routes_to_the_kernels(layout):
    """torch.autograd through `flash_attention` (B, S, N, D) and
    `attention_bnsd` (B, N, S, D) at SD 1.5's cross-attention (8 heads of
    80 against 77 text keys): one f32 forward, one launch of each backward
    kernel, gradients against the plain backward."""
    d, n, b, sq, sk = 80, 8, 1, 1024, 77
    q, k, v, g = (_rand(shape, torch.float32, 80 + i) for i, shape in
                  enumerate(((b, sq, n, d), (b, sk, n, d), (b, sk, n, d), (b, sq, n, d))))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = _split_launches("f32")
    if layout == "bsnd":
        out = tattn.flash_attention(*leaves)
        out.backward(g)
    else:
        out = tattn.attention_bnsd(*(t.transpose(1, 2) for t in leaves))
        out.backward(g.transpose(1, 2))
    torch.cuda.synchronize()
    assert _split_launches("f32") == (before[0] + 1, before[1] + 1)
    flat = [t.flatten(2) for t in (q, k, v)]
    out_ref, lse = tattn._forward_flat(*flat, d, None, None, sk, d ** -0.5)
    want = _plain_bwd(*flat, out_ref, lse, g.flatten(2), d, None, None)
    _check_grads_f32([t.grad.flatten(2) for t in leaves], want, *flat, g.flatten(2), d)


def test_f32_bwd_unbuilt_pairs_raise():
    """The (B, N, S, D) route's backward on the card takes f32 at D = 40,
    64, 80, 160 only: f32 D = 88 and bf16 D = 80 raise (no fallback)."""
    for dtype, d in ((torch.float32, 88), (torch.bfloat16, 80)):
        q = _rand((1, 70, 2 * d), dtype, 90)
        lse = torch.zeros((1, 2, 70), device="cuda")
        with pytest.raises(NotImplementedError, match="route's backward kernel"):
            tattn.flash_bwd_flat(q, q, q, q, lse, q, d)


def test_split_bwd_misaligned_view_raises():
    """A view whose data_ptr is off 16-byte alignment cannot feed TMA: the
    split backward raises instead of launching."""
    b, s, n, d = 1, 64, 2, 128
    flat = _rand((b * s * n * d + 4,), torch.bfloat16, 23)
    q = flat[4:].view(b, s, n * d)  # 8 bytes past an aligned start
    aligned = q.clone()
    out, lse = tattn.flash_fwd_flat(aligned, aligned, aligned, d)
    for entry in (tattn.flash_bwd_dq, tattn.flash_bwd_dkv):
        with pytest.raises(ValueError, match="16-byte aligned"):
            entry(q, q, q, out, lse, out, d)


@pytest.mark.parametrize("sq,rows", [(9, 128), (300, 128), (300, 64)])
def test_bwd_prep_kernel_matches_plain(sq, rows):
    """The prep kernel's lse * log2(e) is the plain version's bit for bit
    (one f32 product each); delta = rowsum(dO * O) is an f32 sum of 128
    products in another order (bound 1e-5 of the largest |delta|); the
    padding is +inf and 0."""
    b, n, d = 2, 3, 128
    o = _rand((b, sq, 2 * n * d), torch.bfloat16, 24)[..., :n * d].unflatten(-1, (n, d))
    g = _rand((b, sq, n * d), torch.bfloat16, 25).unflatten(-1, (n, d))
    lse = _rand((b, n, sq), torch.float32, 26)
    lse2, delta = tattn._bwd_prep(o, g, lse, rows)
    torch.cuda.synchronize()
    want_lse2, want_delta = tattn._bwd_prep_reference(o, g, lse, lse2.shape[-1])
    assert lse2.shape == want_lse2.shape == (b, n, -(-sq // rows) * rows)
    assert torch.equal(lse2, want_lse2)
    assert (delta - want_delta).abs().max().item() <= 1e-5 * want_delta.abs().max().item()
    assert (delta[..., sq:] == 0).all()


@pytest.mark.parametrize("sk,route", [(4096, "onepass"), (512, "split")])
def test_autograd_routes_to_the_kernels(sk, route):
    """flash_attention_flat's backward takes K4 for long self-attention and
    K5a + K5b otherwise, as the JAX package routes it."""
    d, sq = 128, 4096
    q, k, v, _, _, g, cos, sin = _bwd_inputs(1, sq, sk, 1, d, sk == sq, 30)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    def counts():
        return [tattn.flash_bwd_onepass.launches, *_split_launches("sm90")]

    before = counts()
    out = tattn.flash_attention_flat(*leaves, d, cos=cos, sin=sin)
    out.backward(g)
    torch.cuda.synchronize()
    used = [c - b for c, b in zip(counts(), before)]
    assert used == ([1, 0, 0] if route == "onepass" else [0, 1, 1])
    out_ref, lse = tattn.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin)
    _check_grads([t.grad for t in leaves], _plain_bwd(q, k, v, out_ref, lse, g, d, cos, sin))


def test_onepass_autograd_at_the_gate_with_a_ragged_edge():
    """S = 4100 (past the gate, not a multiple of 64 or 128) through the
    autograd op with RoPE: the backward takes K4 and matches the plain
    version."""
    d, s = 128, 4100
    q, k, v, _, _, g, cos, sin = _bwd_inputs(1, s, s, 2, d, True, 35)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tattn.flash_bwd_onepass.launches
    out = tattn.flash_attention_flat(*leaves, d, cos=cos, sin=sin)
    out.backward(g)
    torch.cuda.synchronize()
    assert tattn.flash_bwd_onepass.launches == before + 1
    out_ref, lse = tattn.flash_fwd_flat(q, k, v, d, cos=cos, sin=sin)
    _check_grads([t.grad for t in leaves], _plain_bwd(q, k, v, out_ref, lse, g, d, cos, sin))


def test_bwd_with_masked_keys_raises_on_cuda():
    """kv_len < Sk with RoPE tables raises (nothing calls it: the
    sequence-parallel path rotates q and k before the call); without tables
    it runs the kernels (`test_bwd_masked_keys_run_the_kernels`), never the
    plain version."""
    q, k, v, out, lse, g, cos, sin = _bwd_inputs(1, 64, 96, 1, 64, True, 40)
    with pytest.raises(NotImplementedError, match="kv_len"):
        tattn.flash_bwd_flat(q, k, v, out, lse, g, 64, cos=cos, sin=sin, kv_len=80)
    out, lse = tattn.flash_fwd_flat(q, k, v, 64, kv_len=80)
    before = _split_launches("mma")
    got = tattn.flash_bwd_flat(q, k, v, out, lse, g, 64, kv_len=80)
    torch.cuda.synchronize()
    assert _split_launches("mma") == (before[0] + 1, before[1] + 1)
    _check_grads(got, _plain_bwd_masked(q, k, v, out, lse, g, 64, 80))


def _plain_bwd_masked(q, k, v, out, lse, g, d, kv_len):
    n = q.shape[-1] // d
    views = [t.unflatten(-1, (n, d)) for t in (q, k, v, out)]
    grads = tattn._flash_bwd_reference(*views, lse, g.unflatten(-1, (n, d)), None, None, kv_len,
                                       d ** -0.5)
    return [t.flatten(2) for t in grads]


@pytest.mark.parametrize("b,sq,sk,kv_len,n,route", [
    # a padded sequence-parallel shard: 9361 tokens over 2 ranks (4681 a
    # rank, keys gathered to 9362 of which 9361 live): past K4's gate
    (2, 4681, 9362, 9361, 40, "onepass"),
    # a shard under K4's gate (Sq < 4096): the split kernels
    (2, 1500, 3000, 2999, 3, "split"),
])
def test_bwd_masked_keys_run_the_kernels(b, sq, sk, kv_len, n, route):
    """kv_len < Sk (the sequence-parallel self-attention's backward: the
    shard's queries against the gathered, padded keys) on the card: K4 or
    K5a + K5b, routed by the cut shapes as the JAX package routes a
    kv_len == Sk call of that size, against the plain masked backward; the
    masked keys' dk and dv are exactly 0."""
    d = 128
    q = _rand((b, sq, n * d), torch.bfloat16, 50)
    k = _rand((b, sk, n * d), torch.bfloat16, 51)
    v = _rand((b, sk, n * d), torch.bfloat16, 52)
    g = _rand((b, sq, n * d), torch.bfloat16, 53)
    out, lse = tattn.flash_fwd_flat(q, k, v, d, kv_len=kv_len)
    assert tattn._bwd_route(n, d, sq, kv_len, kv_len) == route
    before = [tattn.flash_bwd_onepass.launches, *_split_launches("sm90")]
    got = tattn.flash_bwd_flat(q, k, v, out, lse, g, d, kv_len=kv_len)
    torch.cuda.synchronize()
    used = [c - b0 for c, b0 in zip([tattn.flash_bwd_onepass.launches,
                                     *_split_launches("sm90")], before)]
    assert used == ([1, 0, 0] if route == "onepass" else [0, 1, 1])
    assert (got[1][:, kv_len:] == 0).all() and (got[2][:, kv_len:] == 0).all()
    _check_grads(got, _plain_bwd_masked(q, k, v, out, lse, g, d, kv_len))


@pytest.mark.parametrize("kv_len", [2048, 1500, 0])
def test_k2_ring_block_matches_plain(kv_len):
    """K2 at the ring's shapes: bf16 D = 128 on (B, N, S, D) views of
    (B, S, N, D) shards (strided, as ring_attention hands them over), Sq =
    Sk = a shard, the block's valid keys full, partial or 0 (a block of
    padding: out 0 and lse <= -1e30, which the merge weighs 0)."""
    b, s, n, d = 1, 2048, 4, 128
    q, k, v = (_rand((b, s, n, d), torch.bfloat16, 60 + i).transpose(1, 2) for i in range(3))
    before = tattn.flash_fwd_bnsd.routes[("sm90", "bfloat16", 128)]
    out, lse = tattn.flash_fwd_bnsd(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    assert tattn.flash_fwd_bnsd.routes[("sm90", "bfloat16", 128)] == before + 1
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    if kv_len == 0:
        assert (out == 0).all() and (lse <= -1e30).all()
        return
    o_ref, lse_ref = tattn._flash_fwd_reference(*(t.transpose(1, 2) for t in (q, k, v)), None,
                                                None, kv_len, d ** -0.5)
    _check((out, lse), (o_ref.transpose(1, 2), lse_ref), BF16_OUT_TOL, BF16_LSE_TOL,
           BF16_OUT_REL)


# ---------------------------------------------------------------------------
# K3: int4 unpack + requantization, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,group", [(13824, 5120, 128), (77, 256, 128), (5, 32, 16),
                                       (7, 192, 48), (9, 256, 32), (3, 20, 10)])
def test_unpack_requant_kernel_bit_exact(n, k, group):
    """Odd N, a small K, a group that is no power of two (the division) and
    K/2 = 10 (not a multiple of 16: the byte-wise kernel) against the plain
    version on the same card tensors."""
    from svi_tpu_torch.ops import quant_matmul as tqm

    g = torch.Generator(device="cuda").manual_seed(n)
    packed = torch.randint(-128, 128, (n, k // 2), generator=g, device="cuda",
                           dtype=torch.int32).to(torch.int8)
    r = torch.rand((n, k // group), generator=g, device="cuda") * (127.0 / 7.0)
    r[:, 0] = 127.0 / 7.0  # a channel's largest group: |w4 * r| reaches 127 and clips
    before = tqm.unpack_requant_int4.launches
    got = tqm.unpack_requant_int4(packed, r)
    torch.cuda.synchronize()
    assert tqm.unpack_requant_int4.launches == before + 1
    assert got.dtype == torch.int8 and got.shape == (n, k)
    assert torch.equal(got, tqm._unpack_requant_reference(packed, r))


# ---------------------------------------------------------------------------
# K6: the int8 attention forward
# ---------------------------------------------------------------------------

# The plain version at the kernel's key tiles (Q8_BLOCK_K: 128 for the sm90
# route at D = 128, 64 for the mma route at D = 64) runs the same integer scores,
# the same row max and the same f32 steps, and rounds out to bf16 the same
# way; what remains is exp2 (a few f32 ulps) and the order of the sums, which
# can put the two on neighbouring bf16 values (one ulp, at most 2^-7 of the
# value), and for qk8pv8 a P that lands on the other side of a rounding
# boundary (one level of 127 in one term, weighed by 1/l). The out bound is a
# share of the reference's largest |out|: 2.5 to 5 bf16 ulps there.
Q8_OUT_REL, Q8_LSE_TOL = 2e-2, 1e-3


def _q8_out_tol(ref: torch.Tensor, rel: float = Q8_OUT_REL) -> float:
    return rel * ref.float().abs().max().item()


@pytest.mark.parametrize("quant", ["qk8", "qk8pv8"])
@pytest.mark.parametrize("d,sq,sk,kv_len", [(128, 189, 189, None), (128, 189, 77, None),
                                            (64, 150, 300, 211), (128, 70, 257, 0),
                                            (128, 300, 1000, 700), (128, 1, 129, 128)])
def test_q8_kernel_matches_plain(quant, d, sq, sk, kv_len):
    """Ragged Sq and Sk against the row and key tiles, a masked tail (on the
    sm90 route at D = 128 also whole masked tiles: Sk 1000 with kv_len 700),
    every key masked (kv_len 0: out 0, lse finite), a 4-stage K/V ring that
    wraps more than once (8 tiles) and a single query row; each launch on
    the route its head dim names."""
    n, b = 3, 2
    pv8 = quant == "qk8pv8"
    q = _rand((b, sq, n * d), torch.bfloat16, 50)
    k = _rand((b, sk, n * d), torch.bfloat16, 51) + 0.5
    v = _rand((b, sk, n * d), torch.bfloat16, 52)
    cos, sin = _tables(max(sq, sk), d)
    q8, qs, k8, kscale, v8, vss = tattn._quant_prep(q, k, v, cos, sin, d, pv8)
    v_in = v8 if pv8 else v
    kv = sk if kv_len is None else kv_len
    before = tattn.flash_fwd_flat_q8.launches
    key = (tattn._q8_route(d), quant, d)
    routed = tattn.flash_fwd_flat_q8.routes[key]
    got = tattn.flash_fwd_flat_q8(q8, qs, k8, kscale, v_in, vss, d, kv_len=kv)
    torch.cuda.synchronize()
    assert tattn.flash_fwd_flat_q8.launches == before + 1
    assert tattn.flash_fwd_flat_q8.routes[key] == routed + 1
    assert key[0] == ("sm90" if d == 128 else "mma")
    want = tattn._flash_fwd_q8_reference(q8, qs, k8, kscale, v_in, vss, kv, d ** -0.5,
                                         torch.bfloat16, block_k=tattn.Q8_BLOCK_K[d])
    _check(got, want, _q8_out_tol(want[0]), Q8_LSE_TOL)
    if kv == 0:
        assert (got[0] == 0).all()


@pytest.mark.parametrize("b,sk,n", [(2, 77, 3), (1, 300, 2), (2, 4680, 40)])
def test_v8_keys_major_kernel_bit_exact(b, sk, n):
    """qk8pv8's V8 pre-pass (transposed, key-permuted, zero-padded) against
    its plain version, on a strided view too."""
    g = torch.Generator(device="cuda").manual_seed(sk)
    v8 = torch.randint(-127, 128, (b, sk, 2 * n * 128), generator=g, device="cuda",
                       dtype=torch.int32).to(torch.int8)[..., : n * 128]
    got = tattn.v8_keys_major(v8, 128)
    torch.cuda.synchronize()
    assert torch.equal(got, tattn._v8_keys_major_reference(v8, 128))
    assert torch.equal(tattn.v8_from_keys_major(got, sk), v8)


@pytest.mark.parametrize("quant", ["qk8", "qk8pv8"])
def test_quantized_attention_launches_the_q8_kernel(quant):
    """flash_attention_flat(quant=...) on the card: prep, one K6 launch, and
    the result of the CPU path within the kernel's bound."""
    d, n = 128, 2
    q, k, v = (_rand((1, 200, n * d), torch.bfloat16, 60 + i) for i in range(3))
    cos, sin = _tables(200, d)
    before = tattn.flash_fwd_flat_q8.launches
    out = tattn.flash_attention_flat(q, k, v, d, cos=cos, sin=sin, quant=quant)
    torch.cuda.synchronize()
    assert tattn.flash_fwd_flat_q8.launches == before + 1
    ref = tattn.flash_attention_flat(*(t.cpu() for t in (q, k, v)), d, cos=cos.cpu(),
                                     sin=sin.cpu(), quant=quant)
    assert (out.float().cpu() - ref.float()).abs().max().item() <= _q8_out_tol(ref)


def test_q8pv8_kernel_f32_out_matches_plain():
    """qk8pv8 with an f32 output, as an f32 DiT calls it: no bf16 rounding of
    out, so the bound (1e-2 of the largest |out|) is the f32 steps' and a P
    that rounds the other way."""
    d, n, b, s = 128, 2, 1, 150
    q, k, v = (_rand((b, s, n * d), torch.float32, 70 + i) for i in range(3))
    q8, qs, k8, kscale, v8, vss = tattn._quant_prep(q, k, v, None, None, d, True)
    got = tattn.flash_fwd_flat_q8(q8, qs, k8, kscale, v8, vss, d, out_dtype=torch.float32)
    want = tattn._flash_fwd_q8_reference(q8, qs, k8, kscale, v8, vss, s, d ** -0.5,
                                         torch.float32, block_k=tattn.Q8_BLOCK_K[d])
    assert got[0].dtype == torch.float32
    _check(got, want, _q8_out_tol(want[0], 1e-2), Q8_LSE_TOL)
    with pytest.raises(TypeError, match="qk8 takes v and out both"):
        tattn.flash_fwd_flat_q8(q8, qs, k8, kscale, v, None, d, out_dtype=torch.bfloat16)


# qk8 with f32 v and out: P.V in 3xTF32 (about 2^-21 relative a product)
# against the plain version's f32 P.V; the same integer scores and row max,
# so what remains is exp2 (a few f32 ulps) and the order of the sums
Q8_F32_OUT_REL, Q8_F32_LSE_TOL = 1e-4, 1e-4


@pytest.mark.parametrize("b,sq,sk,n,kv_len", [(2, 189, 189, 3, None), (1, 300, 1000, 2, 700),
                                              (2, 70, 257, 3, 0), (1, 1, 129, 2, 128),
                                              (1, 600, 4680, 2, None)])
def test_q8_kernel_f32_matches_plain(b, sq, sk, n, kv_len):
    """qk8 with f32 v and out (an f32 DiT's quantized attention) on the
    sm90 route, counted as "sm90_f32": ragged Sq and Sk, whole masked tiles
    (Sk 1000, kv_len 700), every key masked, one query row, and a 2-stage
    f32 ring that wraps many times (37 tiles); within 1e-4 of the plain
    version's largest |out|."""
    d = 128
    q = _rand((b, sq, n * d), torch.float32, 80)
    k = _rand((b, sk, n * d), torch.float32, 81) + 0.5
    v = _rand((b, sk, n * d), torch.float32, 82)
    cos, sin = _tables(max(sq, sk), d)
    q8, qs, k8, kscale, _, _ = tattn._quant_prep(q, k, v, cos, sin, d, False)
    kv = sk if kv_len is None else kv_len
    key = ("sm90_f32", "qk8", d)
    routed = tattn.flash_fwd_flat_q8.routes[key]
    got = tattn.flash_fwd_flat_q8(q8, qs, k8, kscale, v, None, d, kv_len=kv,
                                  out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tattn.flash_fwd_flat_q8.routes[key] == routed + 1
    want = tattn._flash_fwd_q8_reference(q8, qs, k8, kscale, v, None, kv, d ** -0.5,
                                         torch.float32, block_k=tattn.Q8_BLOCK_K[d])
    assert got[0].dtype == torch.float32
    _check(got, want, max(_q8_out_tol(want[0], Q8_F32_OUT_REL), 1e-30), Q8_F32_LSE_TOL)
    if kv == 0:
        assert (got[0] == 0).all()


# ---------------------------------------------------------------------------
# The W4A8 linear (csrc/w4a8_gemm_sm90.cu): its pre-pass and GEMM, bit for bit
# ---------------------------------------------------------------------------


def _w4a8_operands(m, n, k, group, dtype, seed, bias=True):
    from svi_tpu_torch.models import wan_dit

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((n, k), generator=g, device="cuda") * 0.02
    packed, scale = wan_dit._quantize_leaf_int4(w, group)
    r, s8 = wan_dit._w4a8_leaves(scale)
    x = (torch.randn((m, k), generator=g, device="cuda") * 2).to(dtype)
    b = (torch.randn((n,), generator=g, device="cuda") * 0.1).to(dtype) if bias else None
    return x, packed, r, s8, b


# phase 3's shapes of chip_smoke.py with M cut down (ffn.0, ffn.2, self_attn.q,
# cross-attention k on text, the time embedding at M = batch), then M <= 16,
# a ragged M past one 256-row tile, no bias, f32 activations, and the tiny
# configs' K = 48 / 64 with groups of 16 (K/2 % 16 != 0 for K = 48)
W4A8_CASES = [(300, 13824, 5120, 128, "bfloat16", True), (300, 5120, 13824, 128, "bfloat16", True),
              (300, 5120, 5120, 128, "bfloat16", True), (256, 5120, 5120, 128, "bfloat16", True),
              (2, 5120, 256, 128, "bfloat16", True), (1, 1280, 1280, 128, "bfloat16", True),
              (16, 64, 5120, 128, "bfloat16", True), (257, 384, 512, 128, "bfloat16", False),
              (37, 256, 256, 16, "float32", True), (5, 128, 48, 16, "float32", True),
              (64, 128, 64, 16, "bfloat16", True)]


@pytest.mark.parametrize("m,n,k,group,dtype,bias", W4A8_CASES)
def test_w4a8_linear_bit_exact(m, n, k, group, dtype, bias):
    from svi_tpu_torch.ops import quant_matmul as tqm

    x, packed, r, s8, b = _w4a8_operands(m, n, k, group, getattr(torch, dtype), m + n + k,
                                         bias)
    before = (tqm.w4a8_linear.launches, tqm.quantize_rows_int8.launches,
              tqm.unpack_requant_int4.launches)
    got = tqm.w4a8_linear(x, packed, r, s8, b)
    torch.cuda.synchronize()
    assert (tqm.w4a8_linear.launches, tqm.quantize_rows_int8.launches,
            tqm.unpack_requant_int4.launches) == (before[0] + 1, before[1] + 1, before[2])
    assert got.dtype == x.dtype and got.shape == (m, n)
    assert torch.equal(got, tqm._w4a8_linear_reference(x, packed, r, s8, b))


@pytest.mark.parametrize("m,k,dtype", [(9360, 5120, "bfloat16"), (3, 13824, "bfloat16"),
                                       (5, 48, "float32")])
def test_w4a8_prepass_bit_exact(m, k, dtype):
    from svi_tpu_torch.ops import quant_matmul as tqm

    g = torch.Generator(device="cuda").manual_seed(k)
    x = (torch.randn((m, k), generator=g, device="cuda") * 3).to(getattr(torch, dtype))
    x[0] = 0  # xs = 1e-12
    x8, xs = tqm.quantize_rows_int8(x)
    rx8, rxs = tqm._quantize_rows_reference(x)
    assert torch.equal(x8, rx8) and torch.equal(xs, rxs)


def test_w4a8_linear_3d_input_and_unsupported_shapes_raise():
    from svi_tpu_torch.ops import quant_matmul as tqm

    x, packed, r, s8, b = _w4a8_operands(2 * 150, 256, 512, 128, torch.bfloat16, 5)
    got = tqm.w4a8_linear(x.reshape(2, 150, 512), packed, r, s8, b)
    assert got.shape == (2, 150, 256)
    assert torch.equal(got.reshape(300, 256), tqm._w4a8_linear_reference(x, packed, r, s8, b))
    with pytest.raises(ValueError, match="multiple of 8"):
        tqm.w4a8_linear(x, packed[:60], r[:60], s8[:60])
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tqm.w4a8_linear(x.half(), packed, r, s8)


# ---------------------------------------------------------------------------
# The W4A8 straight-through input gradient (csrc/w4a8_dgrad_sm90.cu)
# ---------------------------------------------------------------------------


def _dgrad_bound(gs: torch.Tensor, w8: torch.Tensor, exact: torch.Tensor) -> float:
    """How far two computations of bf16(gs @ W8) with f32 sums can lie apart
    (gs and W8 exact in bf16, so every product is exact in f32): each rounds
    its f32 sum once to bf16, so the two can land on neighbouring bf16
    values, one ulp of |dx| <= 2^-7 of the largest |dx|; and each sums in
    f32 in its own order: a tensor-core k16 step adds 16 exact products to
    the f32 accumulator with one rounding, at most an ulp (2^-23) of the
    running sum, itself at most sum_n |gs W8|, so each side is within (N/16
    + 1) such roundings of the exact sum, and the two within twice that."""
    n = gs.shape[-1]
    terms = (gs.double().abs() @ w8.double().abs()).max().item()
    return 2.0 ** -7 * exact.abs().max().item() + 2 * (n / 16 + 1) * 2.0 ** -23 * terms


def _dgrad_operands(m, n, k, group, seed):
    from svi_tpu_torch.models import wan_dit

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
    packed, scale = wan_dit._quantize_leaf_int4(w, group)
    r, s8 = wan_dit._w4a8_leaves(scale)
    g = (torch.randn((m, n), generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
    return g, packed, r, s8


# M = 1, 17, 255, 257 at the 14B's shapes (a 5120 x 5120 projection, ffn.0's
# and ffn.2's weights) and ragged ones (N and K/2 no multiples of the 64-row
# and 64-byte tiles, the second row tile of one row); the slice's 9360 rows
# at a narrow width; the tiny configs' K = 48 (packed rows of 24 bytes) and
# K = 32 with groups of 16
DGRAD_CASES = [(1, 5120, 5120, 128), (17, 13824, 5120, 128), (255, 5120, 13824, 128),
               (257, 328, 400, 16), (9360, 328, 256, 128), (257, 1280, 1280, 128),
               (17, 64, 48, 16), (40, 128, 32, 16)]


@pytest.mark.parametrize("m,n,k,group", DGRAD_CASES)
def test_w4a8_dgrad_kernel_within_bound_of_plain(m, n, k, group):
    """The kernel against its plain version (K3's plain unpack, g * bf16(s8)
    and cuBLAS's bf16 product) within `_dgrad_bound`; as the control, both
    against the exact product (f64) of the same bf16 operands, rounded to
    bf16, within the same bound. One launch, no standalone K3."""
    from svi_tpu_torch.ops import quant_matmul as tqm

    g, packed, r, s8 = _dgrad_operands(m, n, k, group, m + n + k)
    before = (tqm.w4a8_dgrad.launches, tqm.unpack_requant_int4.launches)
    got = tqm.w4a8_dgrad(g, packed, r, s8)
    torch.cuda.synchronize()
    assert (tqm.w4a8_dgrad.launches, tqm.unpack_requant_int4.launches) == (before[0] + 1,
                                                                          before[1])
    assert got.dtype == torch.bfloat16 and got.shape == (m, k) and torch.isfinite(got).all()
    want = tqm._w4a8_dgrad_reference(g, packed, r, s8)
    gs = g * s8.reshape(-1).to(torch.bfloat16)
    w8 = tqm._unpack_requant_reference(packed, r)
    exact = gs.double() @ w8.double()
    bound = _dgrad_bound(gs, w8, exact)
    exact = exact.to(torch.bfloat16).float()
    for a, b in ((got, want), (want, exact), (got, exact)):
        assert (a.float() - b.float()).abs().max().item() <= bound, (bound, a, b)


def test_w4a8_dgrad_3d_cotangent_and_unsupported_inputs():
    """g with leading dims; a dtype or shape the kernel does not take raises."""
    from svi_tpu_torch.ops import quant_matmul as tqm

    g, packed, r, s8 = _dgrad_operands(2 * 150, 256, 512, 128, 9)
    got = tqm.w4a8_dgrad(g.reshape(2, 150, 256), packed, r, s8)
    assert got.shape == (2, 150, 512)
    assert torch.equal(got.reshape(300, 512), tqm.w4a8_dgrad(g, packed, r, s8))
    before = tqm.w4a8_dgrad.launches
    for dtype in (torch.float32, torch.float16):
        with pytest.raises(TypeError, match="bfloat16"):
            tqm.w4a8_dgrad(g.to(dtype), packed, r, s8)
    assert tqm.w4a8_dgrad.launches == before
    with pytest.raises(ValueError, match="multiple of 8"):
        tqm.w4a8_dgrad(g[:, :60], packed[:60], r[:60], s8[:60])


def test_int4_w4a8_lora_backward_matches_the_cpu_and_counts_k3():
    """A LoRA forward + backward through a tiny bf16 int4_w4a8 DiT (2 blocks,
    one head of 128, groups of 16, per-block remat) on the card against the
    same on the CPU: every quantized linear through w4a8_linear in the
    forward (33: the blocks' 24, the prelude's 8, the head) and again the
    blocks' in the recompute (24), K3 once in the straight-through backward
    of each linear that needs dx (14; the rule of chip_smoke.py's
    `k3_per_step`, counted on the CPU in tests/test_torch_training_variants.py);
    the adapters' gradients, all of them as one vector, agree as bf16 allows
    (roundings in other places, and an activation that lands on another int8
    level: cosine >= 0.99, norms within 5%; a single adapter's gradient can
    be as small as 1e-5, near the resolution of the bf16 activations it is
    made of, and is held only to be finite)."""
    import copy

    from svi_tpu_torch.models import wan_dit
    from svi_tpu_torch.ops import quant_matmul as tqm
    from svi_tpu_torch.training import lora as tlora

    cfg = wan_dit.WanDiTConfig(dim=128, in_dim=12, ffn_dim=256, out_dim=4, text_dim=64,
                               freq_dim=32, num_heads=1, num_layers=2, has_image_input=True,
                               clip_feature_dim=64, dtype=torch.bfloat16)
    dit = wan_dit.quantize_params_for_inference(wan_dit.init_params(cfg, seed=5, device="cpu"),
                                                "int4_w4a8", min_size=1024, group=16)
    lora = tlora.init_lora_params(cfg, rank=8, generator=torch.Generator().manual_seed(6),
                                  device="cpu")
    with torch.no_grad():
        for p in lora.parameters():
            p.add_(0.02)
    g = torch.Generator().manual_seed(7)
    inputs = [torch.randn(shape, generator=g) for shape in
              ((1, 4, 2, 16, 16), (1, 77, 64), (1, 257, 64), (1, 8, 2, 16, 16))]
    grads, calls = {}, {}
    for dev in ("cuda", "cpu"):
        model, adapters = copy.deepcopy(dit).to(dev), copy.deepcopy(lora).to(dev)
        x, ctx, clip, y = (t.to(dev) for t in inputs)
        before = (tqm.w4a8_linear.launches, tqm.unpack_requant_int4.launches)
        out = model(x, torch.tensor([300.0], device=dev), ctx, clip, y, lora=adapters,
                    use_remat=True)
        grads[dev] = torch.autograd.grad(out.float().square().mean(),
                                         list(adapters.parameters()))
        calls[dev] = (tqm.w4a8_linear.launches - before[0],
                      tqm.unpack_requant_int4.launches - before[1])
    names = [n for n, _ in dit.named_parameters() if n.endswith("w_q4")]
    assert len(names) == 33 and sum(n.startswith("blocks.") for n in names) == 24
    assert calls == {"cuda": (57, 14), "cpu": (0, 0)}  # the CPU takes the plain versions
    a = torch.cat([t.float().cpu().flatten() for t in grads["cuda"]])
    b = torch.cat([t.float().flatten() for t in grads["cpu"]])
    assert torch.isfinite(a).all()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    assert cos >= 0.99 and abs(a.norm() - b.norm()) <= 0.05 * b.norm(), (cos, a.norm(), b.norm())


# ---------------------------------------------------------------------------
# The f32 convolutions stay f32 whatever the process sets
# ---------------------------------------------------------------------------


def test_f32_convs_ignore_the_process_tf32_switch():
    """The VAE's encode and decode and the pose stack in f32 give the same
    bits with cuDNN TF32 switched on and off for the process: the package
    runs every f32 convolution with TF32 off (ops.conv.conv_f32)."""
    from svi_tpu_torch.models import pose_embedding, wan_vae

    vae = wan_vae.init_params(wan_vae.WanVAEConfig(dim=32, z_dim=4), seed=0, device="cuda")
    pose = pose_embedding.init_params(64, seed=0, device="cuda")
    video = _rand((1, 3, 5, 64, 64), torch.float32, 90).clamp(-1, 1)
    pose_video = _rand((1, 3, 8, 128, 128), torch.float32, 91).abs() * 100
    outs = {}
    saved = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            with torch.inference_mode():
                lat = vae.encode(video)
                outs[tf32] = (lat, vae.decode(lat), pose(pose_video))
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for a, b in zip(outs[True], outs[False]):
        assert torch.isfinite(a).all() and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The text-to-image LoRA trainer on the f32 backward kernels
# ---------------------------------------------------------------------------


def test_t2i_trainer_step_card_matches_cpu(tmp_path):
    """One T2ILoRATrainer step of a narrow SD UNet (the published plan at
    half width, 4 heads of 40, 80 and 160) on the card against the CPU from
    the same adapters: the loss and the adapters within 1e-4 relative (f32
    through some 60 layers forward and back, sums in another order), the
    loss weighted by 1e-9 on both so that AdamW's step stays linear in the
    gradient; every attention backward on the f32 kernels, 32 launches of
    each: 10 at D = 40, 10 at D = 80, 12 at D = 160."""
    import numpy as np
    import torch_sd_fixtures as fx

    from svi_tpu_torch.models import sd
    from svi_tpu_torch.schedulers.ddim import EnhancedDDIMScheduler
    from svi_tpu_torch.training import text_to_image as t2i

    class Weighted(EnhancedDDIMScheduler):
        def training_weight(self, timestep):
            return 1e-9

    mp = pytest.MonkeyPatch()
    mp.setattr(sd, "SD_UNET_PLAN", fx.narrow_plan(sd.SD_UNET_PLAN, 2, heads=4))
    try:
        state = sd.sd_unet_state_dict(23, text_dim=fx.TEXT_DIM)
        rng = np.random.default_rng(21)
        lat = rng.standard_normal((1, 4, 16, 16)).astype(np.float32)
        emb = rng.standard_normal((1, 77, fx.TEXT_DIM)).astype(np.float32)
        start = tmp_path / "start.safetensors"
        out = {}
        for device in ("cuda", "cpu"):
            trainer = t2i.T2ILoRATrainer(
                sd.sd_unet_params_from_torch(state, device=device), scheduler=Weighted(),
                learning_rate=1.0, lora_rank=4, lora_alpha=4.0, seed=5,
                pretrained_lora_path=None if device == "cuda" else str(start))
            if device == "cuda":
                trainer.save_lora(str(start))
                before = _split_launches("f32")
                routes = dict(tattn.flash_bwd_dq.routes)
            loss = trainer.training_step(latents=lat, prompt_emb=emb)
            if device == "cuda":
                torch.cuda.synchronize()
                assert _split_launches("f32") == (before[0] + 32, before[1] + 32)
                grew = {k[2]: n - routes.get(k, 0) for k, n in tattn.flash_bwd_dq.routes.items()
                        if k[0] == "f32" and n > routes.get(k, 0)}
                assert grew == {40: 10, 80: 10, 160: 12}
            out[device] = (loss, {k: [t.detach().cpu() for t in ab.values()]
                                  for k, ab in trainer.lora.items()})
    finally:
        mp.undo()
    (lc, ac), (lh, ah) = out["cuda"], out["cpu"]
    assert np.isfinite(lc) and abs(lc - lh) <= 1e-4 * abs(lh)
    for i in range(2):
        got = torch.cat([ac[k][i].ravel() for k in ah])
        want = torch.cat([ah[k][i].ravel() for k in ah])
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
