"""The port's RWKV-6 linear scan on the CPU: the plain PyTorch version
against the JAX Pallas kernel (interpret mode), its ``ref.py`` oracle and
the reference model's ``wkv_chunked``, on the same numpy-seeded inputs;
the exact zero-padded tail where the reference asserts; and the
wrapper's routing.

Tolerances are those of the reference's scan test
(tests/test_kernels.py:164-168): y float32 5e-4, bfloat16 2e-2; state
5e-4.  The CUDA kernel itself runs only on a card; ``chip_smoke.py``
holds it against this plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan import linear_scan as jax_scan
from repro.kernels.linear_scan import linear_scan_ref as jax_scan_ref
from repro.models.rwkv6 import wkv_chunked as jax_wkv
from repro_torch.kernels.linear_scan import ops as tscan
from repro_torch.models import rwkv6 as TR

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

Y_TOLS = {"float32": dict(rtol=5e-4, atol=5e-4),
          "bfloat16": dict(rtol=2e-2, atol=2e-2)}
S_TOL = dict(rtol=5e-4, atol=5e-4)


def _inputs(seed, b, t, h, dh, dtype="float32"):
    """r, k, v (dtype), logw <= 0 and u (float32), as numpy float32 and
    as torch tensors holding the same values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, h, dh)).astype(np.float32) * 0.5
            for _ in range(3)]
    arrs.append(-np.exp(rng.standard_normal((b, t, h, dh)) * 0.5)
                .astype(np.float32))
    arrs.append((rng.standard_normal((h, dh)) * 0.3).astype(np.float32))
    tdt = getattr(torch, dtype)
    tens = [torch.from_numpy(a).to(tdt) for a in arrs[:3]]
    tens += [torch.from_numpy(a) for a in arrs[3:]]
    # round r, k, v through the dtype so both packages see equal values
    arrs[:3] = [t.float().numpy() for t in tens[:3]]
    return arrs, tens


def _fold(x):
    b, t, h, dh = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, dh)


def _ref(arrs, dtype="float32"):
    """``linear_scan_ref`` in the model layout: (y, state)."""
    r, k, v, logw, u = arrs
    b, t, h, dh = r.shape
    jdt = getattr(jnp, dtype)
    ur = jnp.broadcast_to(jnp.asarray(u)[None], (b, h, dh)).reshape(
        b * h, 1, dh)
    y, s = jax_scan_ref(_fold(r).astype(jdt), _fold(k).astype(jdt),
                        _fold(v).astype(jdt), _fold(logw), ur)
    y = np.asarray(y, np.float32).reshape(b, h, t, dh).transpose(0, 2, 1, 3)
    return y, np.asarray(s).reshape(b, h, dh, dh)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,dh,chunk", [
    (2, 256, 3, 64, 64),
    (1, 128, 2, 128, 32),
    (1, 512, 1, 64, 128),
])
def test_scan_plain_matches_pallas_and_ref(b, t, h, dh, chunk, dtype):
    arrs, (r, k, v, logw, u) = _inputs(t + dh, b, t, h, dh, dtype)
    jdt = getattr(jnp, dtype)
    yj, sj = jax_scan(*(jnp.asarray(a).astype(jdt) for a in arrs[:3]),
                      jnp.asarray(arrs[3]), jnp.asarray(arrs[4]),
                      chunk=chunk, interpret=True)
    y, s = tscan.linear_scan_plain(r, k, v, logw, u, chunk=chunk,
                                   return_state=True)
    assert y.dtype == r.dtype and s.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(yj), **Y_TOLS[dtype])
    np.testing.assert_allclose(_np(s), _np(sj), **S_TOL)
    yr, sr = _ref(arrs, dtype)
    np.testing.assert_allclose(_np(y), yr, **Y_TOLS[dtype])
    np.testing.assert_allclose(_np(s), sr, **S_TOL)


def test_scan_plain_matches_model_wkv_with_carried_state():
    """The reference model's chunked form, its chunk rule (S // 32 above
    256 tokens) and ``state0``: two halves carried through the state
    equal the whole, as in the reference."""
    arrs, (r, k, v, logw, u) = _inputs(5, 2, 512, 2, 32)
    j = [jnp.asarray(a) for a in arrs]
    yj, sj = jax_wkv(*j, return_state=True)
    y, s = TR.wkv_chunked(r, k, v, logw, u, return_state=True)
    np.testing.assert_allclose(_np(y), _np(yj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s), _np(sj), rtol=1e-4, atol=1e-4)
    half = [x[:, :256] for x in (r, k, v, logw)]
    rest = [x[:, 256:] for x in (r, k, v, logw)]
    y1, s1 = TR.wkv_chunked(*half, u, return_state=True)
    y2, s2 = TR.wkv_chunked(*rest, u, state0=s1, return_state=True)
    yj2, sj2 = jax_wkv(*(jnp.asarray(x.numpy()) for x in rest), j[4],
                       state0=jnp.asarray(s1.numpy()), return_state=True)
    np.testing.assert_allclose(_np(y2), _np(yj2), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s2), _np(sj2), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(s2), _np(s), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t", [300, 1000])
def test_ragged_tail_is_exact_where_the_reference_asserts(t):
    """At T = 300 (or 1,000) the reference's chunk does not divide T and
    ``wkv_chunked`` asserts; the port pads the tail with r = k = v = 0,
    logw = 0 and matches the literal recurrence.  The padded steps leave
    the state bit for bit as it was: appending any zero tail by hand
    gives the same bits."""
    arrs, (r, k, v, logw, u) = _inputs(t, 1, t, 2, 32)
    j = [jnp.asarray(a) for a in arrs]
    chunk = min(max(256, t // 32), t)
    assert t % chunk
    with pytest.raises(AssertionError):
        jax_wkv(*j, return_state=True)
    y, s = TR.wkv_chunked(r, k, v, logw, u, return_state=True)
    yr, sr = _ref(arrs)
    np.testing.assert_allclose(_np(y), yr, **Y_TOLS["float32"])
    np.testing.assert_allclose(_np(s), sr, **S_TOL)
    for extra in (-t % chunk, -t % chunk + chunk):
        padded = [torch.nn.functional.pad(x, (0, 0, 0, 0, 0, extra))
                  for x in (r, k, v, logw)]
        yp, sp = TR.wkv_chunked(*padded, u, return_state=True)
        assert torch.equal(sp, s)
        assert torch.equal(yp[:, :t], y)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    """A CPU tensor takes the plain version (with the reference's
    chunk) and launches nothing; the result is (y, state)."""
    _, (r, k, v, logw, u) = _inputs(0, 2, 40, 3, 32)
    n = tscan.linear_scan.launches
    y, s = tscan.linear_scan(r, k, v, logw, u)
    yp, sp = tscan.linear_scan_plain(r, k, v, logw, u, return_state=True)
    torch.testing.assert_close(y, yp, rtol=0, atol=0)
    torch.testing.assert_close(s, sp, rtol=0, atol=0)
    assert tscan.linear_scan.launches == n
    assert tscan.linear_scan is TR.linear_scan


def test_wrapper_has_no_fallback_for_other_devices(monkeypatch):
    """The wrapper never quietly computes on a device it has neither a
    kernel nor a plain route for: meta (a plain-route device, on which
    the dry-run counts) is taken out of ``PLAIN_DEVICES`` to stand for
    one.  On meta itself it takes the plain version."""
    import repro_torch.kernels as K
    x = torch.empty((1, 8, 2, 64), device="meta")
    y, s = tscan.linear_scan(x, x, x, x.float(),
                             torch.empty((2, 64), device="meta"))
    assert y.shape == x.shape and s.shape == (1, 2, 64, 64)
    monkeypatch.setattr(K, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="no path"):
        tscan.linear_scan(x, x, x, x.float(),
                          torch.empty((2, 64), device="meta"))
