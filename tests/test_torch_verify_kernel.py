"""The port's contiguous verify-attention kernel on the CPU: its plain
PyTorch version against the JAX Pallas kernel (interpret mode) and the
reference's ``ref.py`` oracle, on the same numpy-seeded inputs, for
every (dtype, G) the CUDA kernel is built for, at ragged and scalar
window starts; T = 1 against decode attention; and the wrapper's
routing.

Tolerances are the repo's kernel tolerances (tests/test_kernels.py:16):
float32 1e-4, bfloat16 2e-2.  The CUDA kernel runs only on a card;
``chip_smoke.py`` holds it against this plain version there, and
against the paged verify kernel bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import verify_attention_ref
from repro.kernels.decode_attention.ops import (
    verify_attention as jax_verify_attention,
)
from repro_torch.kernels import verify_attention as tva_pkg
from repro_torch.kernels.decode_attention.ops import decode_attention_plain
from repro_torch.kernels.paged_verify_attention import (
    verify_attention_plain as reexported_plain,
)
from repro_torch.kernels.verify_attention import ops as tva

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

TOLS = {"float32": dict(rtol=1e-4, atol=1e-4),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _case(seed, b, t, kvh, g, d, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, kvh * g, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    return q, kc, vc


def _kernel_layout(q, kc, vc):
    """The reference wrapper's (B*KVH, T, G, D) / (B*KVH, S, D) layout,
    for ``ref.py::verify_attention_ref``."""
    b, t, h, d = q.shape
    s, kvh = kc.shape[1], kc.shape[2]
    qr = q.reshape(b, t, kvh, h // kvh, d).transpose(0, 2, 1, 3, 4)
    qr = qr.reshape(b * kvh, t, h // kvh, d)
    kr = kc.transpose(0, 2, 1, 3).reshape(b * kvh, s, d)
    vr = vc.transpose(0, 2, 1, 3).reshape(b * kvh, s, d)
    return qr, kr, vr


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_plain_matches_pallas_and_ref(dtype, g):
    """A 5-token window (the speculative T = k + 1) at ragged starts --
    0, mid-cache, and ending on the cache's last row -- and at a scalar
    start, against the Pallas kernel in interpret mode and the oracle."""
    b, t, kvh, d, s = 3, 5, 2, 64, 40
    q, kc, vc = _case(10 + g, b, t, kvh, g, d, s)
    jt = getattr(jnp, dtype)
    tt = getattr(torch, dtype)
    for pos in (np.array([0, 17, s - t], np.int32), np.int32(9)):
        got = tva.verify_attention_plain(
            torch.from_numpy(q).to(tt), torch.from_numpy(kc).to(tt),
            torch.from_numpy(vc).to(tt), torch.tensor(pos))
        want = jax_verify_attention(
            jnp.asarray(q, jt), jnp.asarray(kc, jt), jnp.asarray(vc, jt),
            jnp.asarray(pos), interpret=True)
        np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])
        qr, kr, vr = _kernel_layout(q, kc, vc)
        pos_rows = np.repeat(pos, kvh) if np.ndim(pos) else pos
        ref = verify_attention_ref(jnp.asarray(qr, jt), jnp.asarray(kr, jt),
                                   jnp.asarray(vr, jt),
                                   jnp.asarray(pos_rows))
        ref = np.asarray(ref, np.float32).reshape(b, kvh, t, g, d)
        ref = ref.transpose(0, 2, 1, 3, 4).reshape(b, t, kvh * g, d)
        np.testing.assert_allclose(_np(got), ref, **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_plain_t1_equals_decode_plain(dtype):
    """The T = 1 window is one-token decode, bit for bit, per slot and
    at a scalar depth."""
    q, kc, vc = _case(3, 2, 1, 2, 4, 64, 24)
    tt = getattr(torch, dtype)
    q, kc, vc = (torch.from_numpy(x).to(tt) for x in (q, kc, vc))
    for pos in (torch.tensor([5, 23]), torch.tensor(11)):
        assert torch.equal(tva.verify_attention_plain(q, kc, vc, pos),
                           decode_attention_plain(q, kc, vc, pos))


def test_verify_wrapper_routes_cpu_tensors_to_plain_version():
    """A CPU tensor takes the plain version and launches nothing; the
    paged package still re-exports the same plain function."""
    q, kc, vc = map(torch.from_numpy, _case(4, 2, 3, 2, 2, 64, 16))
    pos = torch.tensor([4, 9])
    n = tva.verify_attention.launches
    assert torch.equal(tva.verify_attention(q, kc, vc, pos),
                       tva.verify_attention_plain(q, kc, vc, pos))
    assert tva.verify_attention.launches == n
    assert reexported_plain is tva.verify_attention_plain
    assert tva_pkg.verify_attention is tva.verify_attention


def test_verify_wrapper_has_no_fallback_for_other_devices(monkeypatch):
    """The wrapper does not quietly compute on a device it has neither a
    kernel nor a plain route for: meta (a plain-route device, on which
    the dry-run counts) is taken out of ``PLAIN_DEVICES`` to stand for
    one.  On meta itself it takes the plain version."""
    import repro_torch.kernels as K
    q = torch.empty((1, 5, 4, 64), device="meta")
    cache = torch.empty((1, 16, 2, 64), device="meta")
    assert tva.verify_attention(q, cache, cache, 3).shape == q.shape
    monkeypatch.setattr(K, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="no path"):
        tva.verify_attention(q, cache, cache, 3)
