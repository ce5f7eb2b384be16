"""The fused W4A8 linear and the Hopper int8 attention's layouts, on the CPU.

`ops.quant_matmul.w4a8_linear` replaces, on the inference path, the JAX
package's W4A8 branch of `_dense`: K3's unpack, `_int8_exec` (per-token int8
activations, an int32 product, the scales) and the bias. Its plain version
must equal that branch bit for bit, and so must the plain version of its
activation pre-pass; the straight-through gradient through the fused
forward must match `jax.grad`. The qk8pv8 kernel of the sm90 route reads v8
transposed and key-permuted (`v8_keys_major`): the layout is checked against
a direct index computation, its inverse, and an emulation of the integer
P.V8 product with the kernel's fragment packing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import wan_dit as jdit
from svi_tpu_torch.models import wan_dit as tdit
from svi_tpu_torch.ops import attention as tattn
from svi_tpu_torch.ops import quant_matmul as tqm

N_OUT = 64


def _linear_pair(k: int, bias: bool, seed: int, group: int = 128):
    """The same (in k, out N_OUT) float linear quantized to int4_w4a8 by each
    package (the quantizers are bit-exact: tests/test_torch_quant.py)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, N_OUT)).astype(np.float32) * 0.05
    b = rng.standard_normal((N_OUT,)).astype(np.float32) * 0.1
    jleaf = {"w": jnp.asarray(w), **({"b": jnp.asarray(b)} if bias else {})}
    tleaf = {"w": torch.from_numpy(w.T.copy()), **({"b": torch.from_numpy(b)} if bias else {})}
    jtree = jdit.quantize_params_for_inference({"lin": jleaf}, "int4_w4a8", min_size=1,
                                               group=group)
    ttree = tdit.quantize_params_for_inference({"lin": tleaf}, "int4_w4a8", min_size=1,
                                               group=group)
    return jtree["lin"], tdit.ParamTree(ttree)["lin"]


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return torch.from_numpy(a.copy())


# ---------------------------------------------------------------------------
# the plain version against the JAX W4A8 branch of `_dense`, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("k", [128, 256, 640])
@pytest.mark.parametrize("m", [1, 2, 37, 256])
def test_w4a8_reference_equals_jax_dense(m, k, bias):
    """bf16 activations, as the DiT runs them: the XLA unpack, `_int8_exec`
    and the bias on the JAX side; `_w4a8_linear_reference` on the port's."""
    jp, tp = _linear_pair(k, bias, seed=100 * m + k)
    x = np.random.default_rng(m + k).standard_normal((m, k)).astype(np.float32)
    want = jdit._dense(jp, jnp.asarray(x, dtype=jnp.bfloat16))
    got = tqm._w4a8_linear_reference(torch.from_numpy(x).to(torch.bfloat16), tp["w_q4"],
                                     tp["r_q4"], tp["s8_q4"], tp.get("b"))
    assert got.dtype == torch.bfloat16 and got.shape == (m, N_OUT)
    assert torch.equal(got, _to_torch(want).to(torch.bfloat16))


@pytest.mark.parametrize("m", [3, 40])
def test_w4a8_reference_equals_jax_dense_f32(m):
    """f32 activations (the tiny f32 DiTs), with a bias, three leading dims."""
    jp, tp = _linear_pair(256, True, seed=7 + m, group=16)
    x = np.random.default_rng(m).standard_normal((2, m, 256)).astype(np.float32)
    want = jdit._dense(jp, jnp.asarray(x))
    got = tqm._w4a8_linear_reference(torch.from_numpy(x), tp["w_q4"], tp["r_q4"], tp["s8_q4"],
                                     tp["b"])
    assert torch.equal(got, _to_torch(want))


def _jax_quantize_rows(x):
    """The activation quantization of svi_tpu's `_int8_exec`, statement for
    statement (it is not a function of its own there)."""
    xf = x.astype(jnp.float32)
    xs = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0 + 1e-12
    xq = jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8)
    return xq, xs[:, 0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k", [48, 5120])
def test_quantize_rows_reference_equals_jax(dtype, k):
    """xq and xs bit for bit, with a row of zeros (xs = 1e-12) and rows whose
    values sit on rounding boundaries (x / xs = n + 1/2)."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((9, k)).astype(np.float32) * 3.0
    x[0] = 0.0
    x[1, :4] = [127.0, 0.5, 1.5, -2.5]
    x[1, 4:] = 0.25
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_s = _jax_quantize_rows(jx)
    got_q, got_s = tqm._quantize_rows_reference(tx)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert torch.equal(got_q, torch.from_numpy(np.array(want_q)))
    assert torch.equal(got_s, torch.from_numpy(np.array(want_s)))
    # the CPU entry is the plain version, and counts no launch
    before = tqm.quantize_rows_int8.launches
    q2, s2 = tqm.quantize_rows_int8(tx)
    assert torch.equal(q2, got_q) and torch.equal(s2, got_s)
    assert tqm.quantize_rows_int8.launches == before


def test_w4a8_linear_on_cpu_is_the_plain_version():
    jp, tp = _linear_pair(256, True, seed=3)
    x = torch.randn((2, 5, 256), generator=torch.Generator().manual_seed(0))
    before = tqm.w4a8_linear.launches
    got = tqm.w4a8_linear(x, tp["w_q4"], tp["r_q4"], tp["s8_q4"], tp["b"])
    assert got.shape == (2, 5, N_OUT) and tqm.w4a8_linear.launches == before
    assert torch.equal(got, tqm._w4a8_linear_reference(x, tp["w_q4"], tp["r_q4"], tp["s8_q4"],
                                                        tp["b"]))


def test_dense_w4a8_branch_runs_the_fused_linear_without_k3(monkeypatch):
    """The W4A8 branch of `dense` goes through `w4a8_linear` once, with no K3
    in the forward and no torch._int_mm."""
    _, tp = _linear_pair(256, True, seed=4)
    calls = []
    monkeypatch.setattr(tdit, "w4a8_linear",
                        lambda *a: calls.append(1) or tqm.w4a8_linear(*a))

    def refuse(*a, **k):
        raise AssertionError("K3 or torch._int_mm in the W4A8 forward")

    monkeypatch.setattr(tdit, "unpack_requant_int4", refuse)
    monkeypatch.setattr(torch, "_int_mm", refuse)
    with torch.no_grad():
        y = tdit.dense(tp, torch.randn((3, 256), generator=torch.Generator().manual_seed(1)))
    assert y.shape == (3, N_OUT) and len(calls) == 1


def test_w4a8_straight_through_grad_with_bias_matches_jax():
    """dx and db of sum(dense(x)^2) through the fused forward's straight-
    through backward (K3's unpack, dx = (g * s8) @ w8i) against jax.grad of
    the JAX dense, with a bias and three leading dims (f32: products summed in
    another order)."""
    jp, tp = _linear_pair(512, True, seed=5)
    x = np.random.default_rng(6).standard_normal((2, 16, 512)).astype(np.float32)

    def loss(a, b):
        return jnp.sum(jdit._dense(dict(jp, b=b), a) ** 2)

    want_dx, want_db = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp["b"])
    xt = torch.from_numpy(x).requires_grad_()
    bt = tp["b"].clone().requires_grad_()
    (tdit.dense(dict(w_q4=tp["w_q4"], r_q4=tp["r_q4"], s8_q4=tp["s8_q4"], b=bt), xt) ** 2
     ).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want_db), rtol=1e-4, atol=1e-4)


def test_w4a8_shapes_of_the_dits_are_taken():
    """Every (K, N, group) the quantizer makes for the 14B I2V DiT and the
    tiny test configs is a shape the kernel takes; others are named."""
    for k, n in [(5120, 5120), (5120, 13824), (13824, 5120), (4096, 5120), (256, 5120),
                 (5120, 30720), (1280, 1280), (1280, 5120), (5120, 64)]:
        assert tqm.w4a8_shape_error(k, n, 128) is None, (k, n)
    for k, n in [(48, 128), (32, 128), (64, 64), (128, 16), (256, 768)]:
        assert tqm.w4a8_shape_error(k, n, 16) is None, (k, n)
    assert "multiple of 16" in tqm.w4a8_shape_error(40, 64, 8)
    assert "multiple of 8" in tqm.w4a8_shape_error(128, 60, 16)
    assert "group" in tqm.w4a8_shape_error(128, 64, 6)


def test_w4a8_linear_no_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device has no kernel:
    the wrapper raises instead of taking the plain version."""
    _, tp = _linear_pair(128, False, seed=8)
    x = torch.empty((4, 128), device="meta")
    with pytest.raises(RuntimeError, match="one CUDA device"):
        tqm.w4a8_linear(x, tp["w_q4"].to("meta"), tp["r_q4"].to("meta"),
                        tp["s8_q4"].to("meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        tqm.quantize_rows_int8(x)
    with pytest.raises(ValueError, match="x"):
        tqm.w4a8_linear(torch.zeros((4, 64)), tp["w_q4"], tp["r_q4"], tp["s8_q4"])


# ---------------------------------------------------------------------------
# the sm90 int8 attention: route, tile, and the qk8pv8 V8 layout
# ---------------------------------------------------------------------------


def test_q8_route_and_tile_follow_the_head_dim():
    assert tattn._q8_route(128) == "sm90" and tattn._q8_route(64) == "mma"
    assert tattn.Q8_BLOCK_K == {128: 128, 64: 64}
    with pytest.raises(ValueError, match="head_dim 80"):
        tattn._q8_route(80)
    # the plain version walks the kernel's tile of the head dim by default
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((1, 300, 128), generator=g) for _ in range(3))
    q8, qs, k8, ks, _, _ = tattn._quant_prep(q, k + 0.5, v, None, None, 128, False)
    default = tattn._flash_fwd_q8_reference(q8, qs, k8, ks, v, None, 300, 128 ** -0.5,
                                            torch.float32)
    at_128 = tattn._flash_fwd_q8_reference(q8, qs, k8, ks, v, None, 300, 128 ** -0.5,
                                           torch.float32, block_k=128)
    assert all(torch.equal(a, b) for a, b in zip(default, at_128))


def _slot_key(s: int) -> int:
    """The key in v8^T's slot s, computed directly: slot 16h + 4t + i of a
    32-key chunk holds key 16h + (2t, 2t+1, 8+2t, 9+2t)[i]."""
    c, r = divmod(s, 32)
    h, t, i = r // 16, (r % 16) // 4, r % 4
    return 32 * c + 16 * h + (2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t)[i]


@pytest.mark.parametrize("sk", [77, 300, 384])
def test_v8_keys_major_layout_and_inverse(sk):
    b, n, d = 2, 3, 128
    v8 = torch.randint(-127, 128, (b, sk, n * d), generator=torch.Generator().manual_seed(sk),
                       dtype=torch.int32).to(torch.int8)
    vt = tattn.v8_keys_major(v8, d)
    sk_pad = -(-sk // 128) * 128
    assert vt.shape == (b, n, d, sk_pad) and vt.is_contiguous()
    keys = torch.tensor([_slot_key(s) for s in range(sk_pad)])
    want = torch.zeros((b, n, d, sk_pad), dtype=torch.int8)
    live = keys < sk
    want[..., live] = v8.unflatten(-1, (n, d))[:, keys[live]].permute(0, 2, 3, 1)
    assert torch.equal(vt, want)
    assert torch.equal(tattn.v8_from_keys_major(vt, sk), v8)


def test_pv8_fragment_packing_gives_p_times_v8():
    """An emulation of the qk8pv8 P.V8 product as csrc/flash_fwd_q8_sm90.cu
    issues it: each thread's m64n128 accumulator values of P (d[4j + i]:
    row 16w + g + 8(i >> 1), key 8j + 2t + (i & 1)) packed by `pack_p_s8`
    into s8 A fragments (register q of chunk c: rows g / g + 8, k slots 4t ..
    4t + 3 and 16 + 4t .. 16 + 4t + 3), against v8^T's K-major slots. The
    product over every chunk must be P @ V8."""
    rng = np.random.default_rng(9)
    p = rng.integers(0, 128, (64, 128))
    v8 = torch.from_numpy(rng.integers(-127, 128, (1, 128, 128))).to(torch.int8)
    vt = tattn.v8_keys_major(v8, 128)[0, 0].numpy().astype(np.int64)  # (D, keys)
    # pack_p_s8: accumulator indices of the 4 bytes of register q of chunk c
    pack = [[0, 1, 4, 5], [2, 3, 6, 7], [8, 9, 12, 13], [10, 11, 14, 15]]
    a = np.zeros((64, 128), np.int64)  # the A operand as the tensor core reads it
    for w in range(4):
        for lane in range(32):
            g, t = divmod(lane, 4)
            acc = {}
            for j in range(16):
                for i in range(4):
                    acc[4 * j + i] = p[16 * w + g + 8 * (i >> 1), 8 * j + 2 * t + (i & 1)]
            for c in range(4):
                for q in range(4):
                    row = 16 * w + g + 8 * (q & 1)
                    k0 = 32 * c + 16 * (q >> 1) + 4 * t
                    for byte in range(4):
                        a[row, k0 + byte] = acc[16 * c + pack[q][byte]]
    got = a @ vt.T
    assert np.array_equal(got, p @ v8[0].numpy().astype(np.int64))
