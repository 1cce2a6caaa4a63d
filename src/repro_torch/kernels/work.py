"""The work of each hand-written kernel's call: FLOPs and HBM bytes.

One formula a kernel, from the call's shapes, dtypes and (where the
work depends on the data) positions, so that a kernel's bound in
``chip_smoke.py`` and the dry-run's count (``launch/opcount.py``) are
the same number.  The rules:

* bytes: every input read once and every output written once, at their
  dtypes (the least a kernel must move);
* attention FLOPs: 4 D a visible (query head, key) pair (2 D for q.k,
  2 D for p.v); a decode or verify call reads each slot's rows up to
  its last visible position, a paged call also one page-table entry a
  page it reads and its positions;
* the scan: 5 dh^2 a step and head (the recurrence);
* the int8 GEMM: 2 M N K int8 operations (bound at the int8 rate).

A position tensor on the ``meta`` device holds no values: its call is
then counted at the cache's capacity, every slot at the last rows (the
dry-run's decode cell is one token against a full-length cache).  On a
device with values the positions are read back, which syncs; that
happens only while a counter is active.

Every wrapper reports its call through ``call``: with an ``opcount``
counter active (``active()``), the kernel's work is added to it and the
ops inside the call (its plain version on the CPU or ``meta``, the
launch's own allocations on CUDA) are neither counted nor tracked; the
call's output is tracked as one allocation.  So a kernel's counted work
is the same whatever implements it.
"""
from __future__ import annotations

import torch

# active counters (``launch.opcount.OpCount``), innermost last
_ACTIVE: list = []


def active():
    """The innermost active counter, or ``None``."""
    return _ACTIVE[-1] if _ACTIVE else None


def call(name: str, fn, args: tuple, work, empty):
    """``fn(*args)``, with ``work()`` -> (flops, bytes) added to the
    active counter under ``name`` and nothing inside counted.  Under a
    counter a call on ``meta`` tensors returns ``empty()``, outputs of
    the right shapes and dtypes, without running the plain version:
    none of its ops would count, and its Python loops over a 32k-token
    prompt cost seconds."""
    c = active()
    if c is None:
        return fn(*args)
    with c.suspended():
        c.kernel(name, *work())
        on_meta = all(a.device.type == "meta" for a in args
                      if isinstance(a, torch.Tensor))
        out = empty() if on_meta else fn(*args)
    c.track(out)
    return out


def _size(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _positions(pos, b: int, full: int) -> list[int]:
    """Each of ``b`` slots' position: ``pos`` (a scalar or (B,) tensor,
    or an int) read back, or ``full`` for every slot where it lives on
    ``meta``."""
    if isinstance(pos, torch.Tensor):
        if pos.device.type == "meta":
            return [full] * b
        pos = pos.detach().to("cpu", torch.long)
        return ([int(pos)] * b if pos.ndim == 0
                else [int(p) for p in pos.tolist()])
    return [int(pos)] * b


def attention_pairs(sq: int, skv: int, causal: bool) -> int:
    """Visible (query, key) pairs of one head of a call whose query row
    i sees keys j <= i (causal) or all ``skv`` keys."""
    if not causal:
        return sq * skv
    m = min(sq, skv)
    return m * (m + 1) // 2 + (sq - m) * skv


def flash(q, k, v, causal: bool) -> tuple[int, int]:
    """``flash_attention``: q, k, v read and o written once."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    flops = 4 * b * h * d * attention_pairs(sq, skv, causal)
    return flops, 2 * _size(q) + _size(k) + _size(v)


def decode(q, k_cache, pos) -> tuple[int, int]:
    """``decode_attention``: each slot's K/V rows up to ``pos`` read
    once, q read and o written once."""
    b, _, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    rows = sum(p + 1 for p in _positions(pos, b, s - 1))
    it = k_cache.element_size()
    return rows * h * d * 4, rows * kvh * d * 2 * it + 2 * _size(q)


def paged_decode(q, k_pool, pages, pos) -> tuple[int, int]:
    """``paged_decode_attention``: ``decode``'s work over the rows the
    page table maps, plus one table entry a page read and the
    positions."""
    b, _, h, d = q.shape
    ps, kvh = k_pool.shape[1], k_pool.shape[2]
    cap = pages.shape[1] * ps
    ends = [p + 1 for p in _positions(pos, b, cap - 1)]
    rows = sum(ends)
    blocks = sum(-(-e // ps) for e in ends)
    it = k_pool.element_size()
    return (rows * h * d * 4,
            rows * kvh * d * 2 * it + 2 * _size(q) + blocks * 4 + b * 4)


def verify(q, k_cache, pos) -> tuple[int, int]:
    """``verify_attention``: a T-token window at ``pos`` a slot; each
    slot's rows up to pos + T read once, q read and o written once,
    the positions read; query t of a slot sees pos + t + 1 keys."""
    b, t, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    starts = _positions(pos, b, s - t)
    rows = sum(p + t for p in starts)
    pairs = sum(t * p + t * (t + 1) // 2 for p in starts)
    it = k_cache.element_size()
    return (pairs * h * d * 4,
            rows * kvh * d * 2 * it + 2 * _size(q) + b * 4)


def paged_verify(q, k_pool, pages, pos) -> tuple[int, int]:
    """``paged_verify_attention``: ``verify``'s work over the rows the
    page table maps, plus one table entry a page read."""
    b, t, h, d = q.shape
    ps, kvh = k_pool.shape[1], k_pool.shape[2]
    cap = pages.shape[1] * ps
    starts = _positions(pos, b, cap - t)
    rows = sum(p + t for p in starts)
    pairs = sum(t * p + t * (t + 1) // 2 for p in starts)
    blocks = sum(-(-(p + t) // ps) for p in starts)
    it = k_pool.element_size()
    return (pairs * h * d * 4, rows * kvh * d * 2 * it + 2 * _size(q)
            + blocks * 4 + b * 4)


def linear_scan(r, k, v, logw, u) -> tuple[int, int]:
    """``linear_scan``: r, k, v read and y written once, logw and u
    read, the float32 final state written; 5 dh^2 a step and head."""
    b, t, h, dh = r.shape
    nbytes = (_size(r) + _size(k) + _size(v) + _size(r) + _size(logw)
              + _size(u) + b * h * dh * dh * 4)
    return 5 * b * t * h * dh * dh, nbytes


def int8_matmul(x, w, out_dtype) -> tuple[int, int]:
    """``int8_matmul``: x, w and both scales read, the output written;
    2 M N K int8 operations."""
    m, k = x.shape
    n = w.shape[1]
    out_bytes = torch.finfo(out_dtype).bits // 8
    return (2 * m * n * k,
            m * k + k * n + 4 * (m + n) + m * n * out_bytes)


def bound_ms(flops: float, nbytes: float, hbm_bytes_per_s: float,
             peak_per_s: float) -> tuple[float, str]:
    """The least time in ms a call's work can take on a card with these
    rates: the larger of the bytes over the memory rate and the
    operations over the peak, and which of the two it is."""
    t_bytes = nbytes / hbm_bytes_per_s * 1e3
    t_ops = flops / peak_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

