"""The W4A8 linear's straight-through input gradient, on the CPU.

The backward of a LoRA on an int4_w4a8 base computes `_int8_exec_bwd` (dx =
(g · s8) @ w8i in g's dtype) on K3's unpacked weight. Its plain version,
`_w4a8_dgrad_reference`, which is also the plain version of the fused
`ops.quant_matmul.w4a8_dgrad`, is held against the JAX package's custom VJP:
jax.vjp of svi_tpu's `_dense` on an int4_w4a8 leaf (which on the CPU unpacks
in XLA), and, where svi_tpu's Pallas K3 takes the shape (K/2 and N multiples
of 128, groups of 128), jax.vjp of `_int8_exec` on the weight that K3
unpacks in interpret mode. On the CPU the public entries are the plain
versions, and the W4A8 dense's backward is the same arithmetic.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import wan_dit as jdit
from svi_tpu.ops import quant_matmul as jqm
from svi_tpu_torch.models import wan_dit as tdit
from svi_tpu_torch.ops import quant_matmul as tqm

N_OUT = 128
# (group, K): the tiny configs' groups of 16 at K = 32, 48 (K/2 = 24: no
# 16-byte rows) and 256, and the 14B's groups of 128
SHAPES = [(16, 32), (16, 48), (16, 256), (128, 256)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _leaves(group: int, k: int):
    """The same (in k, out N_OUT) float linear quantized to int4_w4a8 by each
    package (the quantizers are bit-exact: tests/test_torch_quant.py)."""
    w = np.random.default_rng(100 * group + k).standard_normal((k, N_OUT)).astype(np.float32)
    w *= 0.05
    w[: k // 2] *= 3.0  # group-scale variation within a channel
    jleaf = jdit.quantize_params_for_inference({"lin": {"w": jnp.asarray(w)}}, "int4_w4a8",
                                               min_size=1, group=group)["lin"]
    tleaf = tdit.quantize_params_for_inference({"lin": {"w": torch.from_numpy(w.T.copy())}},
                                               "int4_w4a8", min_size=1, group=group)["lin"]
    assert sorted(jleaf) == ["r_q4", "s8_q4", "scale_q4", "w_q4"]
    return jleaf, tleaf


def _close(got: torch.Tensor, want, dtype: str) -> None:
    """f32: the products are summed in another order, each element within
    1e-5 of its own size or of the largest |dx| (a sum that cancels); bf16:
    both sides round their f32 sum once to bf16, so an element can land on
    the neighbouring bf16 value: within one bf16 ulp of the largest |dx|."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    largest = float(np.abs(want).max())
    assert largest > 0
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * largest)
    else:
        ulp = 2.0 ** (np.floor(np.log2(largest)) - 7)
        assert float(np.abs(got - want).max()) <= ulp


@pytest.mark.parametrize("m", [1, 17, 40])
@pytest.mark.parametrize("group,k", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w4a8_dgrad_reference_matches_jax_vjp(dtype, group, k, m):
    jleaf, tleaf = _leaves(group, k)
    rng = np.random.default_rng(1000 * m + k + group)
    x = rng.standard_normal((m, k)).astype(np.float32)
    g = rng.standard_normal((m, N_OUT)).astype(np.float32)
    jx, jg = jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(g, getattr(jnp, dtype))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    got = tqm._w4a8_dgrad_reference(tg, tleaf["w_q4"], tleaf["r_q4"], tleaf["s8_q4"])
    assert got.dtype == tg.dtype and got.shape == (m, k)

    _, vjp = jax.vjp(lambda a: jdit._dense(jleaf, a), jx)
    _close(got, vjp(jg)[0], dtype)
    if jqm.supports_unpack_requant(jleaf["w_q4"], jleaf["r_q4"]):
        # the weight as svi_tpu's Pallas K3 unpacks it, into `_int8_exec`'s VJP
        w8i = jqm.unpack_requant_int4(jleaf["w_q4"], jleaf["r_q4"], interpret=True)
        _, vjp = jax.vjp(lambda a: jdit._int8_exec(a, w8i, jleaf["s8_q4"]), jx)
        _close(got, vjp(jg)[0], dtype)

    # the public entry on CPU tensors is the plain version and launches nothing
    before = tqm.w4a8_dgrad.launches
    same = tqm.w4a8_dgrad(tg, tleaf["w_q4"], tleaf["r_q4"], tleaf["s8_q4"])
    assert tqm.w4a8_dgrad.launches == before
    assert torch.equal(same, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w4a8_dense_backward_is_k3_then_the_plain_product(monkeypatch, dtype):
    """The W4A8 dense's backward, with three leading dims and a bias, calls
    the standalone K3 once and never the fused `w4a8_dgrad`; dx is the plain
    version's, bit for bit."""
    _, tleaf = _leaves(16, 256)
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return tqm.unpack_requant_int4(*args)

    def refuse(*args):
        raise AssertionError("the fused w4a8_dgrad ran in the W4A8 backward")

    monkeypatch.setattr(tdit, "unpack_requant_int4", counted)
    monkeypatch.setattr(tqm, "w4a8_dgrad", refuse)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 256), generator=gen).to(dtype).requires_grad_()
    g = torch.randn((2, 5, N_OUT), generator=gen).to(dtype)
    b = torch.zeros(N_OUT, dtype=dtype, requires_grad=True)
    y = tdit.dense(dict(w_q4=tleaf["w_q4"], r_q4=tleaf["r_q4"], s8_q4=tleaf["s8_q4"], b=b), x)
    y.backward(g)
    assert calls == [(N_OUT, 128)]
    want = tqm._w4a8_dgrad_reference(g, tleaf["w_q4"], tleaf["r_q4"], tleaf["s8_q4"])
    assert x.grad.dtype == dtype and torch.equal(x.grad, want)
    assert torch.equal(b.grad, g.reshape(-1, N_OUT).float().sum(0).to(dtype))


def test_w4a8_dgrad_checks_its_operands():
    """Shapes that do not match raise; a tensor neither on the CPU nor on a
    CUDA device has no kernel: the entry raises instead of taking the plain
    version."""
    _, tleaf = _leaves(16, 48)
    w, r, s8 = tleaf["w_q4"], tleaf["r_q4"], tleaf["s8_q4"]
    with pytest.raises(ValueError, match="g"):
        tqm.w4a8_dgrad(torch.zeros((3, N_OUT + 8)), w, r, s8)
    with pytest.raises(ValueError, match="group ratios"):
        tqm.w4a8_dgrad(torch.zeros((3, N_OUT)), w, r.double(), s8)
    meta = [t.to("meta") for t in (torch.zeros((3, N_OUT), dtype=torch.bfloat16), w, r, s8)]
    with pytest.raises(RuntimeError, match="one CUDA device"):
        tqm.w4a8_dgrad(*meta)
