"""The port's paged attention kernels on the CPU: each plain PyTorch
version against the JAX Pallas kernel (interpret mode) and against the
contiguous plain version through a shuffled page table, on the same
numpy-seeded inputs; and the wrappers' routing.

Tolerances are the repo's kernel tolerances (tests/test_kernels.py:16):
float32 1e-4, bfloat16 2e-2.  Page 0 (the garbage page) holds large
finite values: attention must never let them through, and NaN there
would poison the plain einsum through 0 * NaN.  The CUDA kernels run
only on a card; ``chip_smoke.py`` holds them against these plain
versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import (
    paged_decode_attention as jax_paged_decode,
    paged_verify_attention as jax_paged_verify,
)
from repro.models.layers import verify_attention_jnp
from repro_torch.kernels.decode_attention.ops import decode_attention_plain
from repro_torch.kernels.paged_decode_attention import ops as tpd
from repro_torch.kernels.paged_verify_attention import ops as tpv

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

TOLS = {"float32": dict(rtol=1e-4, atol=1e-4),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GARBAGE = 1e4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def paged_case(seed, b, kvh, g, d, ps, nb, t=1):
    """A contiguous (B, NB*ps, KVH, D) cache, the same values scattered
    into a pool through a shuffled page table (page 0 = garbage), and a
    (B, T, H, D) query.  Returns numpy arrays."""
    rng = np.random.default_rng(seed)
    s = nb * ps
    q = rng.standard_normal((b, t, kvh * g, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    n_pages = b * nb + 1
    pages = (rng.permutation(n_pages - 1) + 1).reshape(b, nb).astype(
        np.int32)
    kp = np.full((n_pages, ps, kvh, d), GARBAGE, np.float32)
    vp = np.full((n_pages, ps, kvh, d), -GARBAGE, np.float32)
    kp[pages] = kc.reshape(b, nb, ps, kvh, d)
    vp[pages] = vc.reshape(b, nb, ps, kvh, d)
    return q, kc, vc, kp, vp, pages


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _j(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_plain_matches_pallas_and_contiguous(dtype):
    """Ragged per-slot depths (0 and the last row of the table
    included) through a shuffled table; a scalar depth too."""
    q, kc, vc, kp, vp, pages = paged_case(0, b=3, kvh=2, g=4, d=64, ps=8,
                                          nb=4)
    for pos in (np.array([0, 17, 31], np.int32), np.int32(12)):
        got = tpd.paged_decode_attention_plain(
            _t(q, dtype), _t(kp, dtype), _t(vp, dtype),
            torch.from_numpy(pages), torch.tensor(pos))
        want = jax_paged_decode(
            _j(q, dtype), _j(kp, dtype), _j(vp, dtype), jnp.asarray(pages),
            jnp.asarray(pos), interpret=True)
        np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])
        # same values in the contiguous layout: the same bits
        cont = decode_attention_plain(_t(q, dtype), _t(kc, dtype),
                                      _t(vc, dtype), torch.tensor(pos))
        assert torch.equal(got, cont)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_verify_plain_matches_pallas_and_contiguous(dtype):
    """A 5-token window per slot at ragged starts: inside one page,
    across a page boundary, and ending on the table's last row."""
    q, kc, vc, kp, vp, pages = paged_case(1, b=3, kvh=2, g=2, d=64, ps=8,
                                          nb=4, t=5)
    pos = np.array([2, 6, 27], np.int32)
    got = tpv.paged_verify_attention_plain(
        _t(q, dtype), _t(kp, dtype), _t(vp, dtype),
        torch.from_numpy(pages), torch.from_numpy(pos))
    want = jax_paged_verify(
        _j(q, dtype), _j(kp, dtype), _j(vp, dtype), jnp.asarray(pages),
        jnp.asarray(pos), interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])
    cont = tpv.verify_attention_plain(_t(q, dtype), _t(kc, dtype),
                                      _t(vc, dtype), torch.from_numpy(pos))
    assert torch.equal(got, cont)


@pytest.mark.parametrize("g,d", [(1, 64), (8, 128)])
def test_verify_plain_matches_model_jnp(g, d):
    """The copy of ``verify_attention_jnp`` on a contiguous cache, with
    per-slot and scalar window starts; T = 1 is decode attention."""
    q, kc, vc, *_ = paged_case(g + d, b=2, kvh=2, g=g, d=d, ps=8, nb=3,
                               t=4)
    for pos in (np.array([0, 19], np.int32), np.int32(9)):
        got = tpv.verify_attention_plain(
            torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.tensor(pos))
        want = jax.jit(verify_attention_jnp)(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(pos))
        np.testing.assert_allclose(_np(got), _np(want), **TOLS["float32"])
    one = tpv.verify_attention_plain(torch.from_numpy(q[:, :1]),
                                     torch.from_numpy(kc),
                                     torch.from_numpy(vc),
                                     torch.tensor([3, 20]))
    dec = decode_attention_plain(torch.from_numpy(q[:, :1]),
                                 torch.from_numpy(kc), torch.from_numpy(vc),
                                 torch.tensor([3, 20]))
    torch.testing.assert_close(one, dec, **TOLS["float32"])


def test_paged_view_gathers_logical_rows():
    _, kc, _, kp, _, pages = paged_case(2, b=2, kvh=2, g=1, d=64, ps=4,
                                        nb=3)
    view = tpd.paged_view(torch.from_numpy(kp), torch.from_numpy(pages))
    assert torch.equal(view, torch.from_numpy(kc))


def test_paged_wrappers_route_cpu_tensors_to_plain_versions():
    """A CPU tensor takes the plain version and launches nothing."""
    q, _, _, kp, vp, pages = paged_case(3, b=2, kvh=2, g=2, d=64, ps=8,
                                        nb=2, t=3)
    q, kp, vp = map(torch.from_numpy, (q, kp, vp))
    pages, pos = torch.from_numpy(pages), torch.tensor([4, 9])
    n_dec = tpd.paged_decode_attention.launches
    n_ver = tpv.paged_verify_attention.launches
    assert torch.equal(
        tpd.paged_decode_attention(q[:, :1], kp, vp, pages, pos),
        tpd.paged_decode_attention_plain(q[:, :1], kp, vp, pages, pos))
    assert torch.equal(
        tpv.paged_verify_attention(q, kp, vp, pages, pos),
        tpv.paged_verify_attention_plain(q, kp, vp, pages, pos))
    assert tpd.paged_decode_attention.launches == n_dec
    assert tpv.paged_verify_attention.launches == n_ver


def test_paged_wrappers_have_no_fallback_for_other_devices(monkeypatch):
    """Neither wrapper quietly computes on a device it has neither a
    kernel nor a plain route for: meta (a plain-route device, on which
    the dry-run counts) is taken out of ``PLAIN_DEVICES`` to stand for
    one.  On meta itself both take their plain versions."""
    import repro_torch.kernels as K
    q = torch.empty((1, 1, 4, 64), device="meta")
    pool = torch.empty((3, 8, 2, 64), device="meta")
    pages = torch.empty((1, 2), dtype=torch.int32, device="meta")
    assert tpd.paged_decode_attention(q, pool, pool, pages, 3).shape == \
        q.shape
    assert tpv.paged_verify_attention(q, pool, pool, pages, 3).shape == \
        q.shape
    monkeypatch.setattr(K, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="no path"):
        tpd.paged_decode_attention(q, pool, pool, pages, 3)
    with pytest.raises(ValueError, match="no path"):
        tpv.paged_verify_attention(q, pool, pool, pages, 3)
