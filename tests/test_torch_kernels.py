"""The port's attention kernels on the CPU: each plain PyTorch version
against the JAX Pallas kernel (interpret mode) and against its ``ref.py``
oracle, on the same numpy-seeded inputs; and the wrappers' routing.

Tolerances are the repo's kernel tolerances (tests/test_kernels.py:16):
float32 1e-4, bfloat16 2e-2.  The CUDA kernels themselves run only on a
card; ``chip_smoke.py`` holds them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import (
    decode_attention_ref as jax_decode_ref)
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro.models.layers import decode_attention_jnp, flash_attention_jnp
from repro_torch.kernels.decode_attention import ops as tdec
from repro_torch.kernels.flash_attention import ops as tflash

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

TOLS = {"float32": dict(rtol=1e-4, atol=1e-4),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_decode_plain_matches_pallas_and_ref(g, d, dtype):
    """Ragged per-slot pos (0 and S-1 included) and a scalar pos."""
    b, kvh, s = 3, 2, 256
    rng = np.random.default_rng(g * 1000 + d)
    qj, qt = _pair(rng, (b, 1, kvh * g, d), dtype)
    kj, kt = _pair(rng, (b, s, kvh, d), dtype)
    vj, vt = _pair(rng, (b, s, kvh, d), dtype)
    for pos in (np.array([0, 101, s - 1], np.int32), np.int32(77)):
        want = jax_decode(qj, kj, vj, jnp.asarray(pos), interpret=True)
        got = tdec.decode_attention_plain(qt, kt, vt, torch.tensor(pos))
        np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])
        np.testing.assert_allclose(
            _np(got), _np(decode_attention_jnp(qj, kj, vj, jnp.asarray(pos))),
            **TOLS[dtype])
        # kernel layout: (B*KVH, G, D) / (B*KVH, S, D), pos per row
        rows = np.repeat(pos, kvh) if pos.ndim else pos
        qr, kr = qj[:, 0].reshape(b * kvh, g, d), kj.transpose(0, 2, 1, 3)
        vr = vj.transpose(0, 2, 1, 3).reshape(b * kvh, s, d)
        want = jax_decode_ref(qr, kr.reshape(b * kvh, s, d), vr,
                              jnp.asarray(rows))
        got = tdec.decode_attention_ref(
            qt[:, 0].reshape(b * kvh, g, d),
            kt.transpose(1, 2).reshape(b * kvh, s, d),
            vt.transpose(1, 2).reshape(b * kvh, s, d), torch.tensor(rows))
        np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,h,kvh,d", [
    (17, 4, 2, 64),        # one ragged block
    (200, 8, 2, 128),      # two blocks, ragged tail, G = 4
    (129, 4, 4, 64),       # MHA, one row past a block
])
def test_flash_plain_matches_pallas_and_ref(sq, h, kvh, d, dtype):
    """Causal prefill attention at lengths that are not multiples of the
    Pallas kernel's 128-row blocks."""
    rng = np.random.default_rng(sq + h + d)
    qj, qt = _pair(rng, (1, sq, h, d), dtype)
    kj, kt = _pair(rng, (1, sq, kvh, d), dtype)
    vj, vt = _pair(rng, (1, sq, kvh, d), dtype)
    got = tflash.flash_attention_plain(qt, kt, vt, causal=True)
    want = jax_flash(qj, kj, vj, causal=True, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])
    # kernel layout oracle
    g = h // kvh
    qr = qj.transpose(0, 2, 1, 3).reshape(kvh, g, sq, d)
    want = jax_flash_ref(qr, kj.transpose(0, 2, 1, 3)[0],
                         vj.transpose(0, 2, 1, 3)[0], causal=True)
    got = tflash.flash_attention_ref(
        qt.transpose(1, 2).reshape(kvh, g, sq, d), kt.transpose(1, 2)[0],
        vt.transpose(1, 2)[0], causal=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])


@pytest.mark.parametrize("chunk", [64, 1024])
def test_flash_plain_matches_model_jnp_chunked(chunk):
    """The model-layout copy of ``flash_attention_jnp``, including its
    q-chunk loop with a ragged last chunk."""
    rng = np.random.default_rng(chunk)
    qj, qt = _pair(rng, (2, 150, 4, 32), "float32")
    kj, kt = _pair(rng, (2, 150, 2, 32), "float32")
    vj, vt = _pair(rng, (2, 150, 2, 32), "float32")
    want = flash_attention_jnp(qj, kj, vj, causal=True, chunk=chunk)
    got = tflash.flash_attention_plain(qt, kt, vt, causal=True, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), **TOLS["float32"])


def test_wrappers_route_cpu_tensors_to_plain_versions():
    """A CPU tensor takes the plain version and launches nothing."""
    rng = np.random.default_rng(0)
    _, q = _pair(rng, (2, 1, 4, 64), "float32")
    _, k = _pair(rng, (2, 32, 2, 64), "float32")
    _, v = _pair(rng, (2, 32, 2, 64), "float32")
    pos = torch.tensor([3, 31], dtype=torch.int32)
    n_dec, n_fl = tdec.decode_attention.launches, \
        tflash.flash_attention.launches
    torch.testing.assert_close(tdec.decode_attention(q, k, v, pos),
                               tdec.decode_attention_plain(q, k, v, pos),
                               rtol=0, atol=0)
    _, qp = _pair(rng, (2, 32, 4, 64), "float32")
    torch.testing.assert_close(tflash.flash_attention(qp, k, v),
                               tflash.flash_attention_plain(qp, k, v,
                                                            causal=True),
                               rtol=0, atol=0)
    assert tdec.decode_attention.launches == n_dec
    assert tflash.flash_attention.launches == n_fl


def test_wrappers_have_no_fallback_for_other_devices():
    """Neither wrapper quietly computes on a device it has no kernel for."""
    q = torch.empty((1, 1, 4, 64), device="meta")
    k = torch.empty((1, 16, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no path"):
        tdec.decode_attention(q, k, k, 3)
    with pytest.raises(ValueError, match="no path"):
        tflash.flash_attention(torch.empty((1, 16, 4, 64), device="meta"),
                               k, k)
