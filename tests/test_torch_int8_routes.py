"""The int8 GEMM's device routes, on the CPU.

A CUDA call of ``int8_matmul`` takes one of two routes
(``kernels/int8_matmul/ops.py:plan``, a function of the shape alone):
``"wgmma"`` where K and N are multiples of 16 (TMA loads, w transposed in
shared memory, ``wgmma`` s8 products: ``csrc/int8_wgmma.cuh``), else
``"sync"`` (the ``mma.sync`` kernel of ``csrc/int8_matmul.cu``).  Both
kernels run only on a card, where ``chip_smoke.py`` holds each against
``int8_matmul_plain`` bit for bit.  Here the route, the tile and the
launch's arguments are checked with the C entry points stubbed, on meta
tensors (no data) and on CPU tensors (real addresses, for alignment).
"""
import types

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.int8_matmul import ops
from repro_torch.launch import int8_ablation

F32, BF16 = torch.float32, torch.bfloat16

# (M, K, N) -> route: the main paths' shapes (tiny-kws, a qwen3-1.7b FFN
# up-projection), the reference test's, and chip_smoke phase 3b's
ROUTES = [((12544, 64, 64), "wgmma"), ((1024, 2048, 6144), "wgmma"),
          ((256, 256, 256), "wgmma"), ((128, 1024, 512), "wgmma"),
          ((300, 272, 528), "wgmma"), ((1, 16, 16), "wgmma"),
          ((200, 8192, 400), "wgmma"), ((300, 500, 260), "sync"),
          ((17, 500, 9), "sync"), ((1, 1, 1), "sync"),
          ((130, 77, 65), "sync"), ((129, 64, 63), "sync"),
          ((64, 24, 32), "sync"), ((64, 32, 24), "sync")]


@pytest.mark.parametrize("shape,route", ROUTES)
@pytest.mark.parametrize("out_dtype", [F32, BF16])
def test_plan_routes_by_k_and_n(shape, route, out_dtype):
    m, k, n = shape
    assert ops.plan(m, k, n, out_dtype) == route


@pytest.mark.parametrize("m", [1, 63, 64, 65, 4096, ops.MAX_M])
def test_plan_ignores_m(m):
    """M never changes the route: TMA's rule concerns row strides, and
    the kernels clip M themselves."""
    assert ops.plan(m, 64, 64, F32) == "wgmma"
    assert ops.plan(m, 72, 40, F32) == "sync"


def test_plan_refuses_what_neither_kernel_takes():
    with pytest.raises(TypeError, match="out_dtype"):
        ops.plan(16, 16, 16, torch.float16)
    for m, k, n in ((16, ops.MAX_K + 16, 16), (16, 0, 16), (0, 16, 16),
                    (16, 16, 0), (ops.MAX_M + 1, 16, 16)):
        with pytest.raises(ValueError, match="outside"):
            ops.plan(m, k, n, F32)


@pytest.mark.parametrize("shape,ctas", [((12544, 64, 64), 98),
                                        ((1024, 2048, 6144), 384)])
def test_main_shapes_grid(shape, ctas):
    """128 x 128 tiles: the tiny shape's 98 CTAs fit the card's 132 SMs
    in one wave; the LM shape's 384 run in 2.91 waves."""
    m, _, n = shape
    bm, bn = ops.WGMMA_TILE
    assert -(-m // bm) * -(-n // bn) == ctas


class _Recorder:
    """Stands in for the library's C entry points: records each call's
    entry name and arguments and returns ``ret``."""

    def __init__(self):
        self.calls = []
        self.ret = 0

    def entry(self, name):
        def fn(*args):
            assert len(args) == len(ops.ARGTYPES[name])
            self.calls.append((name, args))
            return self.ret
        return fn


STREAM = 0x5EED


@pytest.fixture
def recorder(monkeypatch):
    """``launch`` and the wrapper without a card: the entry points and
    the stream stubbed, meta tensors allowed to launch."""
    rec = _Recorder()
    monkeypatch.setattr(ops, "_entry", rec.entry)
    monkeypatch.setattr(ops, "LAUNCH_DEVICES", ("cuda", "meta"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=STREAM))
    return rec


def _meta(m, k, n):
    def e(*shape, dtype=F32):
        return torch.empty(shape, dtype=dtype, device="meta")
    return (e(m, k, dtype=torch.int8), e(k, n, dtype=torch.int8), e(m, 1),
            e(1, n))


@pytest.mark.parametrize("shape,route", [((12544, 64, 64), "wgmma"),
                                         ((1024, 2048, 6144), "wgmma"),
                                         ((300, 500, 260), "sync")])
@pytest.mark.parametrize("out_dtype", [F32, BF16])
def test_launch_passes_shape_dtype_tile_and_stream(recorder, shape, route,
                                                   out_dtype):
    """Each route's entry gets the five pointers, M, N, K, the dtype
    code and the stream; the output has the shape and dtype asked
    for."""
    m, k, n = shape
    out = ops.int8_matmul(*_meta(m, k, n), out_dtype=out_dtype)
    assert out.shape == (m, n) and out.dtype == out_dtype
    (name, args), = recorder.calls
    assert name == ops.ENTRIES[route]
    assert args[5:9] == (m, n, k, build.DTYPE_CODES[
        str(out_dtype).removeprefix("torch.")])
    assert args[9] == STREAM


@pytest.mark.parametrize("shape", [(64, 64, 64), (17, 500, 9)])
def test_launches_count_one_per_call_on_either_route(recorder, shape):
    before = ops.int8_matmul.launches
    for i in range(3):
        ops.int8_matmul(*_meta(*shape), out_dtype=F32)
        assert ops.int8_matmul.launches == before + i + 1
    assert len(recorder.calls) == 3


def test_cpu_call_never_reaches_an_entry(recorder):
    """A CPU tensor takes the plain version, even with entries stubbed."""
    x = torch.ones((16, 16), dtype=torch.int8)
    before = ops.int8_matmul.launches
    got = ops.int8_matmul(x, x, torch.ones((16, 1)), torch.ones((1, 16)),
                          out_dtype=F32)
    assert torch.equal(got, torch.full((16, 16), 16.0))
    assert recorder.calls == [] and ops.int8_matmul.launches == before


def _offset(t, nbytes):
    """``t``'s values in a buffer that starts ``nbytes`` past a 64-byte
    boundary."""
    buf = torch.empty(t.numel() + 64, dtype=t.dtype)
    start = (-buf.data_ptr()) % 64 + nbytes
    view = buf[start:start + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("route,w_align", [("wgmma", 16), ("sync", 4)])
def test_launch_aligns_x_and_w(recorder, route, w_align):
    """x goes to either kernel 16-byte aligned; w 16-byte aligned on the
    wgmma route (TMA's rule), 4 on the sync route, which takes a 4-byte
    aligned w as it is; the values are unchanged."""
    m, k, n = 32, 64, 48
    x0 = torch.arange(m * k, dtype=torch.int32).remainder(251).sub(125).to(
        torch.int8).reshape(m, k)
    w0 = torch.arange(k * n, dtype=torch.int32).remainder(241).sub(120).to(
        torch.int8).reshape(k, n)
    x, w = _offset(x0, 8), _offset(w0, 4)
    assert x.data_ptr() % 16 == 8 and w.data_ptr() % 16 == 4
    ops.launch(x, w, torch.ones((m, 1)), torch.ones((1, n)), F32, route)
    (name, args), = recorder.calls
    xp, wp = args[0], args[1]
    assert xp % 16 == 0 and wp % w_align == 0
    if route == "sync":
        assert wp == w.data_ptr()
    else:
        assert wp != w.data_ptr()


@pytest.mark.parametrize("ret,err,match", [(-1, ValueError, "not instan"),
                                           (-2, RuntimeError, "TMA"),
                                           (700, RuntimeError, "CUDA error")])
def test_entry_errors_raise(recorder, ret, err, match):
    """No route falls back: a refusal of the entry point raises."""
    recorder.ret = ret
    with pytest.raises(err, match=match):
        ops.int8_matmul(*_meta(64, 64, 64), out_dtype=F32)
    assert [name for name, _ in recorder.calls] == [ops.ENTRIES["wgmma"]]


@pytest.mark.parametrize("name", sorted(int8_ablation.VARIANTS))
def test_ablation_edits_match_the_kernel_source(name):
    """Each ablation of ``launch/int8_ablation.py`` finds every text it
    edits in ``int8_wgmma.cuh`` exactly once, so the kernel and its
    ablations do not drift apart; only ``base`` leaves the source as it
    is."""
    text = int8_ablation.patched_source(name)
    assert (text == int8_ablation.patched_source("base")) == (name == "base")
