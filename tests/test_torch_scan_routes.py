"""The linear scan's device routes, on the CPU.

A CUDA call of ``linear_scan`` takes one of two routes
(``kernels/linear_scan/ops.py:plan``): bfloat16 the chunked form on the
tensor cores (``csrc/scan_chunked.cuh``), float32 the CUDA-core loop.
The kernels run only on a card (``chip_smoke.py`` holds both routes
against ``linear_scan_plain`` there).  Here the chunked route's algorithm
at its own layout, ``linear_scan_chunked_plain`` (sub-block anchors, the
diagonal blocks in halves, the value split), is held against the
reference's Pallas kernel in interpret mode where T is a multiple of its
chunk and against its per-token oracle ``linear_scan_ref`` at ragged T,
within the reference's own scan tolerance
(tests/test_kernels.py:164-168): y and state 5e-4 in float32, y 2e-2 in
bfloat16.  The route is pure Python.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan import linear_scan as jax_scan
from repro.kernels.linear_scan import linear_scan_ref as jax_scan_ref
from repro_torch.kernels.linear_scan import ops as tscan

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

Y_TOLS = {"float32": dict(rtol=5e-4, atol=5e-4),
          "bfloat16": dict(rtol=2e-2, atol=2e-2)}
S_TOL = dict(rtol=5e-4, atol=5e-4)
# the chunked route's layout as ``csrc/scan_chunked.cuh`` builds it: the
# chunk per head dim (``chunk_steps``) and a carry CTA's state columns
CHUNKS = {32: 64, 64: 64, 128: 32}
VALUE_BLOCK = 32


def _inputs(seed, b, t, h, dh, dtype="float32", strong=False):
    """r, k, v (dtype), logw <= 0 and u (float32), as numpy float32 and
    as torch tensors holding the same values.  ``strong``: logw uniform
    in (-30, 0), a decay that sums to hundreds within a chunk."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, h, dh)).astype(np.float32) * 0.5
            for _ in range(3)]
    if strong:
        arrs.append((-30 * rng.random((b, t, h, dh))).astype(np.float32))
    else:
        arrs.append(-np.exp(rng.standard_normal((b, t, h, dh)) * 0.5)
                    .astype(np.float32))
    arrs.append((rng.standard_normal((h, dh)) * 0.3).astype(np.float32))
    tdt = getattr(torch, dtype)
    tens = [torch.from_numpy(a).to(tdt) for a in arrs[:3]]
    tens += [torch.from_numpy(a) for a in arrs[3:]]
    # round r, k, v through the dtype so both packages see equal values
    arrs[:3] = [x.float().numpy() for x in tens[:3]]
    return arrs, tens


def _fold(x):
    b, t, h, dh = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, dh)


def _ref(arrs):
    """``linear_scan_ref`` (the literal per-token recurrence) in the
    model layout: (y, state) in float32."""
    r, k, v, logw, u = arrs
    b, t, h, dh = r.shape
    ur = jnp.broadcast_to(jnp.asarray(u)[None], (b, h, dh)).reshape(
        b * h, 1, dh)
    y, s = jax_scan_ref(_fold(r), _fold(k), _fold(v), _fold(logw), ur)
    y = np.asarray(y, np.float32).reshape(b, h, t, dh).transpose(0, 2, 1, 3)
    return y, np.asarray(s).reshape(b, h, dh, dh)


def _np(x):
    return x.float().numpy()


def _chunked(tens, dh, value_block):
    """The chunked plain version at the route's chunk for ``dh``."""
    return tscan.linear_scan_chunked_plain(*tens, chunk=CHUNKS[dh],
                                           value_block=value_block)


@pytest.mark.parametrize("value_block", [None, VALUE_BLOCK],
                         ids=["whole", "split"])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_chunked_plain_matches_pallas(dh, value_block):
    """T 128, a multiple of the Pallas kernel's chunk (64) and of the
    route's (64, or 32 at dh 128)."""
    arrs, tens = _inputs(dh, 1, 128, 2, dh)
    yj, sj = jax_scan(*(jnp.asarray(a) for a in arrs), chunk=64,
                      interpret=True)
    y, s = _chunked(tens, dh, value_block)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    np.testing.assert_allclose(_np(y), np.asarray(yj), **Y_TOLS["float32"])
    np.testing.assert_allclose(_np(s), np.asarray(sj), **S_TOL)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 15, 77, 300])
def test_chunked_plain_matches_ref_at_ragged_t(t, dh):
    """T 1 and under a chunk (one padded chunk), 77 (a ragged tail) and
    300 (several chunks, ragged): the padded rows leave the state as it
    was."""
    arrs, tens = _inputs(t + dh, 1, t, 2, dh)
    y, s = _chunked(tens, dh, VALUE_BLOCK)
    yr, sr = _ref(arrs)
    np.testing.assert_allclose(_np(y), yr, **Y_TOLS["float32"])
    np.testing.assert_allclose(_np(s), sr, **S_TOL)


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_value_split_changes_no_column(dh):
    """Each state column depends only on its own v column, so splitting
    the columns over CTAs (16 or 32 a block) gives what the whole state
    gives, within float32 summation order."""
    _, tens = _inputs(7, 2, 77, 3, dh)
    y, s = _chunked(tens, dh, None)
    for vb in (16, 32):
        y2, s2 = _chunked(tens, dh, vb)
        torch.testing.assert_close(y2, y, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(s2, s, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_strong_decay_is_finite_and_exact(dh):
    """logw down to -30 a step sums to ~-1,000 within a chunk of 64: a
    factor e^(+x) would overflow there.  Every exponent of the chunked
    form is <= 0, so y and the state are finite and match the per-token
    recurrence."""
    arrs, tens = _inputs(100 + dh, 1, 100, 2, dh, strong=True)
    y, s = _chunked(tens, dh, VALUE_BLOCK)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    yr, sr = _ref(arrs)
    np.testing.assert_allclose(_np(y), yr, **Y_TOLS["float32"])
    np.testing.assert_allclose(_np(s), sr, **S_TOL)


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_bfloat16_inputs_round_y_once(dh):
    """The route's dtype: bf16 r, k, v (float32 math), y rounded to bf16
    once, the state float32."""
    arrs, tens = _inputs(3 * dh, 1, 77, 2, dh, dtype="bfloat16")
    y, s = _chunked(tens, dh, VALUE_BLOCK)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    yr, sr = _ref(arrs)
    np.testing.assert_allclose(_np(y), yr, **Y_TOLS["bfloat16"])
    np.testing.assert_allclose(_np(s), sr, **S_TOL)


@pytest.mark.parametrize("dh", [32, 64, 128])
def test_plan_routes_by_dtype_and_head_dim(dh):
    assert tscan.plan(torch.bfloat16, dh) == "chunked"
    assert tscan.plan(torch.float32, dh) == "loop"
    assert CHUNKS[dh] % tscan.SUB == 0 and dh % VALUE_BLOCK == 0


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="dh 48"):
        tscan.plan(torch.bfloat16, 48)
    with pytest.raises(TypeError, match="float16"):
        tscan.plan(torch.float16, 64)


class _Recorder:
    """Stands in for the library's entry points: the chunk per head dim
    as the library is built, and each launch's entry and arguments
    (returns 0)."""

    def __init__(self):
        self.calls = []

    def entry(self, name):
        if name == "linear_scan_chunked_steps":
            return lambda dh: CHUNKS[dh]

        def fn(*args):
            # as many arguments as the entry declares argument types
            assert len(args) == len(tscan.ARGTYPES[name])
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def recorder(monkeypatch):
    """``launch`` on meta tensors: the entry points and the stream
    stubbed, and float32 buffers recorded by size, so the Python side of
    a launch runs without a card."""
    rec = _Recorder()
    rec.buffers = []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        if kw.get("dtype") == torch.float32 and isinstance(shape[0], int):
            rec.buffers.append(shape[0])
        return empty(*shape, **kw)

    monkeypatch.setattr(tscan, "_entry", rec.entry)
    monkeypatch.setattr(tscan.torch, "empty", recording_empty)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return rec


def _meta(b, t, h, dh, dtype=torch.bfloat16, pad=0):
    """r, k, v in ``dtype`` and logw, u in float32 on the meta device;
    ``pad`` widens the rows of r by that many elements (a strided view)."""
    def m(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    r = m(b, t, h, dh + pad, dtype=dtype)[..., :dh]
    return (r, m(b, t, h, dh, dtype=dtype), m(b, t, h, dh, dtype=dtype),
            m(b, t, h, dh), m(h, dh))


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 77, 1024])
def test_chunked_launch_passes_its_arguments_and_scratch(recorder, t, dh):
    """The chunked entry takes 7 tensors, B, T, H, dh, the 15 strides in
    the order r, k, v, logw, y, the scratch and the stream; the scratch
    holds ``scratch_floats`` at the library's chunk."""
    b, h = 2, 3
    r, k, v, logw, u = _meta(b, t, h, dh)
    y, s = tscan.launch(r, k, v, logw, u, "chunked")
    assert y.shape == r.shape and y.dtype == torch.bfloat16
    assert s.shape == (b, h, dh, dh) and s.dtype == torch.float32
    (name, args), = recorder.calls
    assert name == "linear_scan_chunked_launch"
    assert args[7:11] == (b, t, h, dh)
    strides = [st for x in (r, k, v, logw, y) for st in x.stride()[:3]]
    assert list(args[11:26]) == strides
    assert recorder.buffers == [tscan.scratch_floats(b, t, h, dh,
                                                     CHUNKS[dh])]
    n_chunks = -(-t // CHUNKS[dh])
    assert recorder.buffers[0] == b * h * n_chunks * (
        2 * CHUNKS[dh] * dh + dh * dh + dh)


def test_loop_launch_passes_dtype_and_no_scratch(recorder):
    """The float32 loop takes the dtype code where the chunked route
    takes its scratch, and needs no scratch."""
    r, k, v, logw, u = _meta(1, 40, 2, 64, dtype=torch.float32)
    tscan.launch(r, k, v, logw, u, "loop")
    (name, args), = recorder.calls
    assert name == "linear_scan_launch"
    assert args[-2] == 0 and recorder.buffers == []


def test_misaligned_chunked_call_raises(recorder):
    """A row that is not 16 bytes aligned (r's rows 65 bf16 apart) raises
    on the chunked route before anything launches: its cp.async copies
    move 16 bytes."""
    r, k, v, logw, u = _meta(1, 40, 2, 64, pad=1)
    with pytest.raises(ValueError, match="r's rows are not 16-byte"):
        tscan.launch(r, k, v, logw, u, "chunked")
    assert recorder.calls == [] and recorder.buffers == []
