"""Count a PyTorch program's FLOPs, bytes and peak memory, op by op.

The port's counterpart of XLA's ``cost_analysis()`` (FLOPs, bytes
accessed) and ``memory_analysis()`` (argument and temp bytes): a
``TorchDispatchMode`` that sees every ATen op a program runs, on any
device.  On ``meta`` tensors nothing is computed or allocated, so a
671 B-parameter step is counted in seconds; on CUDA the same Python
runs the same ops, so the two counts can be held against each other.

Rules, per ATen op:

* FLOPs: 2 M K N for a matrix product (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, per batch for the batched ones; ``einsum`` and ``@``
  reach these), 2 x output x (input channels / groups x kernel size)
  for a convolution, none for views, copies, gathers, scatters and
  factories, and one per output element for every other op
  (elementwise ops and reductions alike);
* bytes accessed: each tensor input read once and each output written
  once, unfused (as XLA's pre-fusion "bytes accessed": an upper bound
  of what a fused program moves), at its distinct elements (a
  broadcast view counts its stored elements once).  Views move
  nothing; a gather (``index``, ``gather``, ``index_select``,
  ``embedding``) reads its indices and the rows it picks, not the
  whole source; a scatter into a tensor in place (``index_put_``,
  ``scatter_``, ``index_copy_``, ``index_add_``) reads its indices and
  values and writes as many elements, not the whole destination;
  factories that write nothing (``empty``) move nothing;
* peak bytes: the most bytes of storage alive at once, from the
  arguments registered at the start (``OpCount(args)``) and every
  storage an op creates, until it is freed; ``temp_bytes`` is the peak
  less the arguments.

A hand-written kernel's call (``kernels.work.call``) adds its own
formula's work under ``kernel:<name>`` and counts nothing inside it,
whether the plain version (CPU, ``meta``) or the launch (CUDA) runs;
its output is tracked as one allocation.

  with OpCount(args=(params, cache)) as oc:
      model.decode_step(params, cache, tokens)
  oc.flops, oc.bytes, oc.peak_bytes, oc.temp_bytes, oc.by_op
"""
from __future__ import annotations

import contextlib
import math
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import work

aten = torch.ops.aten

_MATMUL = {aten.mm.default, aten.addmm.default, aten.bmm.default,
           aten.baddbmm.default}
_FREE = {aten.empty.memory_format, aten.empty_like.default,
         aten.empty_strided.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten.detach.default,
         aten.lift_fresh.default, aten._unsafe_view.default,
         aten._local_scalar_dense.default, aten.alias.default,
         aten.set_.source_Storage_storage_offset}
_GATHER = {aten.index.Tensor, aten.gather.default, aten.index_select.default,
           aten.embedding.default}
# in-place scatters: (destination, values argument position)
_SCATTER = {aten.index_put_.default: 2, aten.index_put.default: 2,
            aten._index_put_impl_.default: 2, aten.scatter_.src: 3,
            aten.scatter.src: 3, aten.scatter_add_.default: 3,
            aten.scatter_add.default: 3, aten.index_copy_.default: 3,
            aten.index_add_.default: 3}
_MOVE = {aten.copy_.default, aten._to_copy.default, aten.clone.default,
         aten.cat.default, aten.stack.default, aten.fill_.Scalar,
         aten.fill_.Tensor, aten.zero_.default, aten.zeros.default,
         aten.ones.default, aten.full.default, aten.zeros_like.default,
         aten.ones_like.default, aten.full_like.default, aten.arange.default,
         aten.arange.start, aten.arange.start_step, aten.new_zeros.default,
         aten.new_ones.default, aten.new_full.default, aten.repeat.default,
         aten.constant_pad_nd.default, aten.slice_scatter.default,
         aten.select_scatter.default, aten.scalar_tensor.default,
         aten.lift_fresh_copy.default, aten.expand_copy.default}


_NAMES: dict = {}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        out = []
        for x in tree:
            if isinstance(x, torch.Tensor):
                out.append(x)
            elif isinstance(x, (tuple, list, dict)):
                out.extend(_tensors(x))
        return out
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses, a broadcast (stride 0)
    dimension's once."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def op_flops(func, args, out) -> int:
    """FLOPs of one ATen op by the module's rules."""
    if func in _MATMUL:
        a, b = (args[1], args[2]) if func in (aten.addmm.default,
                                              aten.baddbmm.default) \
            else (args[0], args[1])
        return 2 * a.numel() * b.shape[-1]
    if func is aten.convolution.default:
        w = args[1]
        per_out = math.prod(w.shape[1:])
        return 2 * out.numel() * per_out
    if (func in _FREE or func in _GATHER or func in _SCATTER
            or func in _MOVE or func.is_view):
        return 0
    return sum(t.numel() for t in _tensors(out))


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one ATen op reads and writes by the module's rules."""
    if func in _FREE or func.is_view:
        return 0
    if func in _GATHER:
        picked = _tensors(out)
        idx = [t for t in _tensors(args[1:]) if not t.is_floating_point()]
        return (sum(distinct_bytes(t) for t in idx)
                + 2 * sum(distinct_bytes(t) for t in picked))
    if func in _SCATTER:
        vals = args[_SCATTER[func]]
        idx = [t for t in _tensors(args[1:_SCATTER[func]])
               if not t.is_floating_point()]
        moved = vals.numel() * args[0].element_size()
        if func in (aten.index_put_.default, aten.index_put.default,
                    aten._index_put_impl_.default):
            shape = torch.broadcast_shapes(*(t.shape for t in idx)) \
                if idx else ()
            rows = math.prod(shape) * math.prod(
                args[0].shape[len(args[1]):])
            moved = max(moved, rows * args[0].element_size())
        return (sum(distinct_bytes(t) for t in idx)
                + distinct_bytes(vals) + moved)
    ins = _tensors((args, kwargs))
    return (sum(distinct_bytes(t) for t in ins)
            + sum(distinct_bytes(t) for t in _tensors(out)))


class OpCount(TorchDispatchMode):
    """Counts FLOPs, bytes accessed and peak live bytes while active
    (see the module docstring); ``args`` (any tree of tensors) are
    live from the start.  ``by_op``: op name -> [calls, flops, bytes],
    hand-written kernels under ``kernel:<name>`` with their launches'
    count."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_op: dict[str, list] = {}
        self._live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._suspend = 0
        self.track(args)
        self.arg_bytes = self.live_bytes

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.arg_bytes

    @property
    def kernels(self) -> dict[str, list]:
        """name -> [calls, flops, bytes] of the hand-written kernels."""
        return {k[7:]: v for k, v in self.by_op.items()
                if k.startswith("kernel:")}

    def add(self, name: str, flops: int, nbytes: int) -> None:
        """Add one entry of work under ``name`` (an op's, a kernel's, or
        work counted apart from the program)."""
        rec = self.by_op.setdefault(name, [0, 0, 0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def kernel(self, name: str, flops: int, nbytes: int) -> None:
        """Add one call of hand-written kernel ``name``'s work."""
        self.add(f"kernel:{name}", int(flops), int(nbytes))

    @contextlib.contextmanager
    def suspended(self):
        """Neither count nor track the ops inside: they run with the
        mode off."""
        self._suspend += 1
        try:
            with _disable_current_modes():
                yield
        finally:
            self._suspend -= 1

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def track(self, tree) -> None:
        """Count every storage under ``tree`` as live until it is
        freed."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def __enter__(self):
        work._ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        work._ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suspend:
            return out
        name = _NAMES.get(func) or _NAMES.setdefault(func, func.name())
        if func.is_view:        # shares its input's storage, moves nothing
            self.add(name, 0, 0)
            return out
        self.track(out)
        self.add(name, op_flops(func, args, out),
                  op_bytes(func, args, kwargs, out))
        return out
