"""The port's W8A8 int8 GEMM on the CPU: ``quantize_int8`` against the
reference's bit for bit, and the plain version against the JAX Pallas
kernel (interpret mode) and its ``ref.py`` oracle on the same
numpy-seeded inputs; the wrapper's routing.

Tolerances are those of the reference's test (tests/test_kernels.py:
115-128): float32 1e-6 relative, bfloat16 2e-2, atol 1e-2.  Where the
two compute the same float32 operations in the same order, the outputs
are also held equal.  The CUDA kernel itself runs only on a card;
``chip_smoke.py`` holds it against this plain version there with
``torch.equal``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.int8_matmul import int8_matmul as jax_int8_matmul
from repro.kernels.int8_matmul import int8_matmul_ref, quantize_int8 as jq
from repro_torch.kernels.int8_matmul import ops as tq

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

# the reference test's shapes, then the tiny model's pointwise GEMM
# (M = 256 x 49, K = N = 64)
SHAPES = [(256, 256, 256), (300, 500, 260), (128, 1024, 512),
          (12544, 64, 64)]
TOLS = {"float32": dict(rtol=1e-6, atol=1e-2),
        "bfloat16": dict(rtol=2e-2, atol=1e-2)}


def _quantized(seed, m, k, n):
    """x (M, K) and w (K, N) from numpy, quantized by the reference as
    numpy arrays: (xq, sx, wq, sw)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    xq, sx = jq(jnp.asarray(x), axis=1)
    wq, sw = jq(jnp.asarray(w), axis=0)
    return tuple(np.array(a) for a in (xq, sx, wq, sw))


@pytest.mark.parametrize("shape,axis", [((12544, 64), 1), ((64, 64), 0),
                                        ((300, 500), 1)])
def test_quantize_int8_is_bit_equal(shape, axis):
    x = (np.random.default_rng(sum(shape)).standard_normal(shape) * 3
         ).astype(np.float32)
    # a few exact half-way points: round half to even on both sides
    x[0, :4] = [0.5, 1.5, 2.5, -2.5]
    jqv, jsc = jq(jnp.asarray(x), axis=axis)
    tqv, tsc = tq.quantize_int8(torch.from_numpy(x), axis=axis)
    assert tqv.dtype == torch.int8 and tsc.dtype == torch.float32
    assert np.array_equal(tqv.numpy(), np.asarray(jqv))
    assert np.array_equal(tsc.numpy(), np.asarray(jsc))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_and_oracle(m, k, n, out_dtype):
    xq, sx, wq, sw = _quantized(m + n, m, k, n)
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    ref = np.asarray(int8_matmul_ref(jnp.asarray(xq), jnp.asarray(wq),
                                     jnp.asarray(sx), jnp.asarray(sw),
                                     out_dtype=jdt), np.float32)
    pallas = np.asarray(jax_int8_matmul(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sx), jnp.asarray(sw),
        out_dtype=jdt, interpret=True), np.float32)
    got = tq.int8_matmul_plain(*(torch.from_numpy(a)
                                 for a in (xq, wq, sx, sw)),
                               out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    got = got.float().numpy()
    np.testing.assert_allclose(got, pallas, **TOLS[out_dtype])
    np.testing.assert_allclose(got, ref, **TOLS[out_dtype])
    # an exact int32 sum and the same two float32 multiplies, in order:
    # the oracle's float32 output agrees bit for bit
    if out_dtype == "float32":
        assert np.array_equal(got, ref)


def test_int32_product_is_exact_at_the_extremes():
    """-128 and 127 everywhere at K = 4,096: the sum is 2^26, still
    exact in int32, and ``_int_mm`` equals an int32 ``@``."""
    x = torch.full((17, 4096), -128, dtype=torch.int8)
    w = torch.full((4096, 8), -128, dtype=torch.int8)
    w[:, 1] = 127
    one = torch.ones((17, 1)), torch.ones((1, 8))
    got = tq.int8_matmul_plain(x, w, *one, out_dtype=torch.float32)
    assert got[0, 0] == 128 * 128 * 4096
    assert got[0, 1] == -128 * 127 * 4096
    assert torch.equal(torch._int_mm(x, w), x.int() @ w.int())


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (3, 5, 7), (17, 500, 9)])
def test_plain_takes_any_shape(m, k, n):
    """No padding rules: any M, N, K >= 1 (the kernel checks its own
    bounds where the reference wrapper pads to 256)."""
    xq, sx, wq, sw = _quantized(m * k * n, m, k, n)
    got = tq.int8_matmul_plain(*(torch.from_numpy(a)
                                 for a in (xq, wq, sx, sw)),
                               out_dtype=torch.float32)
    acc = xq.astype(np.int64) @ wq.astype(np.int64)
    want = (acc.astype(np.float32) * sx) * sw
    assert np.array_equal(got.numpy(), want)


def test_cpu_wrapper_takes_the_plain_version_and_never_launches():
    xq, sx, wq, sw = (torch.from_numpy(a)
                      for a in _quantized(0, 64, 96, 40))
    before = tq.int8_matmul.launches
    got = tq.int8_matmul(xq, wq, sx, sw, out_dtype=torch.float32)
    assert torch.equal(got, tq.int8_matmul_plain(xq, wq, sx, sw,
                                                 torch.float32))
    assert tq.int8_matmul(xq, wq, sx, sw).dtype == torch.bfloat16
    assert tq.int8_matmul.launches == before


def test_wrapper_has_no_path_off_cpu_and_cuda():
    x = torch.zeros((4, 4), dtype=torch.int8, device="meta")
    s = torch.ones((4, 1), device="meta")
    with pytest.raises(ValueError, match="no path"):
        tq.int8_matmul(x, x, s, s.reshape(1, 4))
