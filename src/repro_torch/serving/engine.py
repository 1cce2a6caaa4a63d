"""Serving engines: fixed-batch and slot-based continuous batching
(PyTorch port of the reference ``serving/engine.py``, contiguous greedy
path).

``ServeEngine`` (fixed batch)
    Prefills one batch together and decodes it in lock-step, one
    device->host copy per token.

``ContinuousBatchingEngine`` (the Server-scenario hot path)
    ``n_slots`` decode rows over one preallocated KV cache with a
    per-slot position vector.  Finished slots are refilled from the
    admission queue mid-flight by a batch-1 prefill written into the
    slot's cache rows.  Each decode chunk runs ``chunk_steps`` greedy
    steps with no host round trip inside; the host copies the chunk's
    (n_slots, chunk_steps) token buffer once (``host_syncs``).

Paged KV, prefix caching, chunked prefill, preemption and speculative
decoding are not ported yet (ROADMAP §A.5-§A.7); the constructor
refuses them.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.serving.kv_pages import GARBAGE_PAGE, PagePool, PoolExhausted
from repro_torch.serving.prefix_cache import PrefixCache


@dataclasses.dataclass
class Request:
    """One serving request: the contract every engine fills in.

    Caller-set: ``rid`` (unique per serve), ``prompt`` ((S,) int
    tokens), ``max_new_tokens``, ``arrival_s`` (seconds on the serve
    clock).  Everything else is engine-stamped.  The reference's fields
    for scheduling, preemption and speculative decoding arrive with
    those features.
    """

    rid: int
    prompt: Any                       # (S,) int tokens
    max_new_tokens: int = 16
    arrival_s: float = 0.0
    # filled by the engine:
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    output: Optional[list] = None
    energy_j: Optional[float] = None  # filled by attribute_request_energy
    cached_tokens: int = 0            # prompt tokens served from the
                                      # prefix cache (no prefill compute)
    prefill_tokens: int = 0           # prompt tokens computed at admission
                                      # (the unique suffix on a hit)

    def ttft_s(self) -> Optional[float]:
        """Time to first token (arrival to first emission)."""
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    def tpot_s(self) -> Optional[float]:
        """Time per output token after the first (decode cadence)."""
        if self.done_s is None or self.first_token_s is None:
            return None
        n = max(1, len(self.output or []) - 1)
        return (self.done_s - self.first_token_s) / n


@dataclasses.dataclass
class _ServeCtx:
    """Mutable host state of one ``serve`` call."""

    slots: list          # per-slot in-flight Request (None = free)
    slot_left: list      # host shadow of the device `remaining` vector
    ready: Any           # deque of arrived, unadmitted requests
    done: list           # completed requests
    now: Callable[[], float]
    t0: float


def _engine_device(model, device) -> torch.device:
    """The engine's device: ``device`` (default ``cuda``, which raises
    without a GPU), and it must be the model's."""
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"engine device {dev} != model device "
                         f"{model.device}")
    return dev


def _prompt_tensor(prompt, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(prompt).reshape(-1),
                           dtype=torch.long, device=device)[None]


class ServeEngine:
    """Fixed-batch engine (the baseline)."""

    def __init__(self, model, params, *, max_len: int = 256,
                 batch_size: int = 8, device="cuda"):
        self.device = _engine_device(model, device)
        self.model = model
        self.params = params
        self.max_len = max_len
        self.batch = batch_size

    @torch.no_grad()
    def run_batch(self, requests: list[Request],
                  now: Callable[[], float] = time.monotonic
                  ) -> list[Request]:
        """Service one batch of requests synchronously."""
        if len(requests) > self.batch:
            raise ValueError(f"{len(requests)} requests > batch size "
                             f"{self.batch}")
        prompts = torch.cat([_prompt_tensor(r.prompt, self.device)
                             for r in requests])
        logits, cache = self.model.prefill(self.params, {"tokens": prompts},
                                           max_len=self.max_len)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        t_first = now()
        outs = [[t] for t in tok[:, 0].tolist()]
        for r in requests:
            r.first_token_s = t_first
        steps = max(r.max_new_tokens for r in requests) - 1
        for _ in range(max(0, steps)):
            logits, cache = self.model.decode_step(self.params, cache, tok)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            for i, t in enumerate(tok[:, 0].tolist()):
                outs[i].append(t)
        t_done = now()
        for i, r in enumerate(requests):
            r.output = outs[i][: r.max_new_tokens]
            r.done_s = t_done
        return requests


class ContinuousBatchingEngine:
    """Slot-based continuous batching, greedy, contiguous or paged KV.

    Usage::

        eng = ContinuousBatchingEngine(model, params, max_len=2048,
                                       n_slots=8, chunk_steps=8)
        done = eng.serve(requests)          # honors Request.arrival_s

    ``device`` defaults to ``cuda`` and must match the model's.  Per
    decode chunk the host performs exactly one device->host copy
    (``host_syncs`` counts them); ``decode_steps`` counts the model
    decode steps run.

    Paged KV (``kv_page_size > 0``): ``kv_pages`` physical pages
    (default: every slot full, plus the garbage page 0) of
    ``kv_page_size`` rows, handed out by a host-side ``PagePool``; the
    (n_slots, max_len / kv_page_size) page table lives on the device.
    With ``prefix_caching`` a hit admits through ``_extend_slot``, which
    computes only the uncached suffix (``prefix_stats`` counts lookups,
    hits, cached tokens and evicted pages).
    """

    def __init__(self, model, params, *, max_len: int = 256,
                 n_slots: int = 8, chunk_steps: int = 8, device="cuda",
                 draft_model=None, spec_k: int = 0, kv_page_size: int = 0,
                 kv_pages: Optional[int] = None,
                 prefix_caching: bool = False,
                 prefill_chunk_tokens: int = 0, scheduler=None):
        refused = {
            "draft_model/spec_k (speculative decoding, ROADMAP §A.7)":
                draft_model is not None or spec_k,
            "prefill_chunk_tokens (chunked prefill, ROADMAP §A.6)":
                prefill_chunk_tokens,
            "scheduler (preemption, ROADMAP §A.6)": scheduler is not None,
        }
        for what, value in refused.items():
            if value:
                raise NotImplementedError(f"{what} is not ported yet")
        self.device = _engine_device(model, device)
        self.model = model
        self.params = params
        self.max_len = max_len
        self.n_slots = n_slots
        self.chunk_steps = chunk_steps
        self.host_syncs = 0            # decode-chunk device->host copies
        self.decode_steps = 0          # model decode steps (all slots)
        # paged KV: block-granular cache through a per-slot page table,
        # with optional radix prefix caching on top
        self.page_size = int(kv_page_size)
        self.paged = self.page_size > 0
        self.prefix_caching = bool(prefix_caching)
        if self.prefix_caching and not self.paged:
            raise ValueError("prefix_caching requires kv_page_size > 0")
        self.page_pool: Optional[PagePool] = None
        self.prefix_cache: Optional[PrefixCache] = None
        if self.paged:
            if max_len % self.page_size:
                raise ValueError(
                    f"max_len {max_len} not a multiple of kv_page_size "
                    f"{self.page_size}")
            self.pages_per_slot = max_len // self.page_size
            # +1: physical page 0 is the reserved garbage page
            self.n_pages = (int(kv_pages) if kv_pages is not None
                            else n_slots * self.pages_per_slot + 1)
            if self.n_pages < self.pages_per_slot + 1:
                raise ValueError(
                    f"kv_pages {self.n_pages} cannot hold even one "
                    f"full slot ({self.pages_per_slot} pages) plus the "
                    f"garbage page")
            self.page_pool = PagePool(self.n_pages, self.page_size)
            if self.prefix_caching:
                self.prefix_cache = PrefixCache(self.page_pool,
                                                self.page_size)
        self.prefix_stats = self._zero_prefix_stats()
        self.reset()

    @staticmethod
    def _zero_prefix_stats() -> dict:
        return {"lookups": 0, "hits": 0, "cached_tokens": 0,
                "evicted_pages": 0}

    # -- device state ---------------------------------------------------
    def reset(self):
        """Fresh slot state: empty cache, zero positions, no budgets;
        in paged mode also a full page pool and an empty prefix
        cache."""
        n = self.n_slots
        if self.paged:
            cache = self.model.init_paged_cache(
                n, self.n_pages, self.page_size, self.pages_per_slot)
            self.page_pool.reset()
            if self.prefix_cache is not None:
                self.prefix_cache.reset()
            # host shadow of page ownership: pages each slot holds a
            # reference on (the device side only sees the table row)
            self._slot_pages: list[list[int]] = [[] for _ in range(n)]
        else:
            cache = self.model.init_cache(n, self.max_len,
                                          per_slot_pos=True)
        self.state = {
            "cache": cache,
            "tok": torch.zeros((n,), dtype=torch.long, device=self.device),
            "remaining": torch.zeros((n,), dtype=torch.int32,
                                     device=self.device),
        }

    @torch.no_grad()
    def _prefill_slot(self, params, state, tokens, slot: int, budget: int,
                      pages: Optional[list] = None):
        """Prefill one (1, S) prompt into slot ``slot``, in place.

        Contiguous: the prompt's K/V land at rows [0, S) of the slot's
        cache row and the rest of the row is zeroed (the reference
        overwrites the whole row with the zero-padded batch-1 prefill
        cache).  Paged (``pages``: the slot's physical pages in position
        order): the prompt's K/V are chopped into page-size blocks and
        scattered at the first ceil(S / page_size) of them, and the
        slot's table row is installed.  The reference also scatters the
        zero tail of its padded prefill cache into the rest of the row;
        no position past S is ever read before decode writes it, so
        that write is left out.  The slot's position becomes S, its
        first greedy token seeds decoding, and its budget becomes
        ``budget - 1``.  Other slots are untouched.  Returns (state,
        tok0) with tok0 still on the device.
        """
        cache = state["cache"]
        if pages is None:
            row = {"blocks": {name: t[:, slot:slot + 1] for name, t in
                              cache["layers"]["blocks"].items()}}
            logits, one = self.model.prefill(params, {"tokens": tokens},
                                             max_len=self.max_len,
                                             cache=row)
        else:
            ps = self.page_size
            n_blk = -(-int(tokens.shape[1]) // ps)
            logits, one = self.model.prefill(params, {"tokens": tokens},
                                             max_len=n_blk * ps)
            idx = torch.as_tensor(pages[:n_blk], dtype=torch.long,
                                  device=self.device)
            for name, pool in cache["layers"]["blocks"].items():
                small = one["layers"]["blocks"][name]   # (L, 1, n*ps, ..)
                pool[:, idx] = small[:, 0].reshape(
                    small.shape[0], n_blk, ps, *pool.shape[3:])
            cache["pages"][slot] = self._table_row(pages)
        tok0 = torch.argmax(logits[0, -1], -1)
        cache["pos"][slot] = one["pos"]
        state["tok"][slot] = tok0
        state["remaining"][slot] = max(budget - 1, 0)
        return state, tok0

    @torch.no_grad()
    def _extend_slot(self, params, state, suffix, slot: int, pages: list,
                     start: int, budget: int):
        """Admit a prefix-cache hit: only the unique suffix is computed.

        ``suffix``: (1, S - start) the prompt tokens not covered by the
        cached pages (``lookup`` leaves it non-empty).  K/V are stored
        post-RoPE at absolute positions, so the shared pages already
        hold exactly what a full prefill would have written; the suffix
        runs through a batch-1 paged ``verify_step`` on the engine's
        pool, starting at absolute position ``start``, and its last
        logit row seeds decoding like a full prefill's.  Returns (state,
        tok0) with tok0 still on the device.
        """
        cache = state["cache"]
        table = self._table_row(pages)
        mini = {"layers": cache["layers"],
                "pos": torch.full((1,), start, dtype=torch.int32,
                                  device=self.device),
                "pages": table[None]}
        logits, _ = self.model.verify_step(params, mini, suffix)
        tok0 = torch.argmax(logits[0, -1], -1)
        cache["pos"][slot] = start + int(suffix.shape[1])
        cache["pages"][slot] = table
        state["tok"][slot] = tok0
        state["remaining"][slot] = max(budget - 1, 0)
        return state, tok0

    def _table_row(self, pages: list) -> torch.Tensor:
        """A slot's full device table row: its pages, then garbage page
        0 up to ``pages_per_slot``."""
        row = list(pages) + [GARBAGE_PAGE] * (self.pages_per_slot
                                              - len(pages))
        return torch.tensor(row, dtype=torch.int32, device=self.device)

    @torch.no_grad()
    def _decode_chunk(self, params, state):
        """Decode ``chunk_steps`` tokens for every slot, on the device.

        Exactly ``chunk_steps`` steps with no host read inside: the
        reference's early exit once every slot is done only saves
        compute.  Inactive slots (remaining == 0) hold their position
        and token; their cache row takes a garbage write at the frozen
        position, which the next prefill into the slot overwrites.
        Returns (state, buf) with buf (n_slots, chunk_steps) on device.
        """
        cache, tok, remaining = state["cache"], state["tok"], \
            state["remaining"]
        buf = torch.empty((self.n_slots, self.chunk_steps),
                          dtype=torch.long, device=self.device)
        for i in range(self.chunk_steps):
            active = remaining > 0
            pos_prev = cache["pos"]
            logits, cache = self.model.decode_step(params, cache,
                                                   tok[:, None])
            nxt = torch.argmax(logits[:, -1], -1)
            tok = torch.where(active, nxt, tok)
            cache["pos"] = torch.where(active, pos_prev + 1, pos_prev)
            buf[:, i] = tok
            remaining = remaining - active.to(remaining.dtype)
        self.decode_steps += self.chunk_steps
        state.update(cache=cache, tok=tok, remaining=remaining)
        return state, buf

    # -- paged admission (host side) -------------------------------------
    def _alloc_pages(self, n: int) -> list[int]:
        """Allocate ``n`` pages, evicting cache-only prefix pages under
        memory pressure.  Raises ``PoolExhausted`` when eviction cannot
        free enough (every remaining page is pinned by a live slot)."""
        pool = self.page_pool
        if n > pool.free_pages() and self.prefix_cache is not None:
            self.prefix_stats["evicted_pages"] += self.prefix_cache.evict(
                n - pool.free_pages())
        return pool.alloc(n)

    def _release_slot(self, b: int) -> None:
        """Drop a retired slot's page references, aiming its table row
        at the garbage page *first*: the frozen chunk loop keeps
        scattering at the dead slot's position, and those writes must
        not land on pages that may be reallocated to another request."""
        if not self.paged:
            return
        self.state["cache"]["pages"][b] = GARBAGE_PAGE
        for p in self._slot_pages[b]:
            self.page_pool.unref(p)
        self._slot_pages[b] = []

    def _acquire_pages(self, toks: tuple, s: int,
                       budget: int) -> tuple[list, int]:
        """Pin prefix-cache hit pages and allocate the fresh remainder
        for a prompt of ``s`` tokens decoding up to ``budget`` more.

        Hit pages are ``ref``-ed *before* allocating, because allocation
        may evict: pinning first means eviction can never free a page
        this request is about to read.  On ``PoolExhausted`` the pins
        are rolled back and the exception propagates (the caller
        defers).  Returns ``(row, start)``: the physical pages in
        position order and the cached-token count.
        """
        ps = self.page_size
        n_blocks = min(self.pages_per_slot, -(-(s + budget) // ps))
        shared = (self.prefix_cache.lookup(toks)
                  if self.prefix_cache is not None else [])
        for p in shared:
            self.page_pool.ref(p)
        try:
            fresh = self._alloc_pages(n_blocks - len(shared))
        except PoolExhausted:
            for p in shared:
                self.page_pool.unref(p)
            raise
        if self.prefix_cache is not None:
            self.prefix_stats["lookups"] += 1
            if shared:
                self.prefix_stats["hits"] += 1
                self.prefix_stats["cached_tokens"] += len(shared) * ps
        return shared + fresh, len(shared) * ps

    def _intern_prompt(self, toks: tuple, row: list) -> None:
        """Intern the *full* blocks of ``toks`` (physical pages
        ``row``) into the prefix cache, once their K/V exists.  Only
        full blocks: a partial last block still receives its slot's
        decode writes, so sharing it would let another request read
        tokens that aren't prompt."""
        if self.prefix_cache is None:
            return
        n_full = min(len(toks) // self.page_size, len(row))
        self.prefix_cache.insert(toks[:n_full * self.page_size],
                                 row[:n_full])

    def _admit_slot(self, r: Request, b: int, cx: _ServeCtx) -> bool:
        """Admit ``r`` into free slot ``b``: prefill (or, on a prefix
        hit, extend), stamp, route.  ``False`` = defer: the page pool
        cannot cover the request until a slot retires."""
        toks = tuple(int(x) for x in np.asarray(r.prompt).reshape(-1))
        prompt = _prompt_tensor(toks, self.device)
        s = len(toks)
        budget = r.max_new_tokens
        if s + budget > self.max_len:
            raise ValueError(f"request {r.rid}: prompt {s} + budget "
                             f"{budget} tokens exceed max_len "
                             f"{self.max_len}")
        if not self.paged:
            r.prefill_tokens += s
            self.state, tok0 = self._prefill_slot(self.params, self.state,
                                                  prompt, b, budget)
            self._finish_admit(r, b, tok0, budget, cx)
            return True
        try:
            row, start = self._acquire_pages(toks, s, budget)
        except PoolExhausted:
            return False
        self._slot_pages[b] = list(row)
        r.cached_tokens += start
        r.prefill_tokens += s - start
        if start:
            self.state, tok0 = self._extend_slot(
                self.params, self.state, prompt[:, start:], b, row, start,
                budget)
        else:
            self.state, tok0 = self._prefill_slot(
                self.params, self.state, prompt, b, budget, row)
        self._intern_prompt(toks, row)
        self._finish_admit(r, b, tok0, budget, cx)
        return True

    def _finish_admit(self, r: Request, b: int, tok0, budget: int,
                      cx: _ServeCtx) -> None:
        """Emit the first token (a host read: the true TTFT) and either
        retire the request or hand the slot to the decode loop."""
        first = int(tok0)
        t_now = cx.now() - cx.t0
        r.first_token_s = t_now
        r.output = [first][: r.max_new_tokens]      # budget 0 -> []
        if budget <= 1:
            r.done_s = t_now
            cx.done.append(r)
            self._release_slot(b)
        else:
            cx.slots[b] = r
            cx.slot_left[b] = budget - 1

    # -- host orchestration ---------------------------------------------
    def serve(self, requests: list[Request],
              now: Callable[[], float] = time.monotonic,
              sleep: Callable[[float], None] = time.sleep,
              honor_arrivals: bool = True) -> list[Request]:
        """Service ``requests``, admitting each at its ``arrival_s``.

        Returns the completed requests (short requests overtake
        stragglers).  ``first_token_s`` and ``done_s`` are seconds since
        serve() start, the clock of ``arrival_s``.  With
        ``honor_arrivals=False`` the queue drains as fast as slots free
        up (Offline scenario).  Admission is FIFO by arrival; in paged
        mode a request the page pool cannot cover waits at the head of
        the queue until a slot retires.
        """
        counts = collections.Counter(r.rid for r in requests)
        dup = sorted(r for r, c in counts.items() if c > 1)
        if dup:                        # validate before touching state
            raise ValueError(
                f"duplicate request ids in admission queue: {dup} -- "
                f"rids must be unique per serve()")
        self.reset()
        self.prefix_stats = self._zero_prefix_stats()
        self.host_syncs = 0
        self.decode_steps = 0
        pending = collections.deque(
            sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        cx = _ServeCtx(slots=[None] * self.n_slots,
                       slot_left=[0] * self.n_slots,
                       ready=collections.deque(), done=[], now=now,
                       t0=now())
        while pending or cx.ready or any(s is not None for s in cx.slots):
            t = now() - cx.t0
            while pending and (not honor_arrivals
                               or pending[0].arrival_s <= t):
                cx.ready.append(pending.popleft())
            for b in range(self.n_slots):
                if cx.slots[b] is not None or not cx.ready:
                    continue
                r = cx.ready.popleft()
                if not self._admit_slot(r, b, cx):
                    # defer: a retiring slot will free its pages
                    cx.ready.appendleft(r)
                    if not any(s is not None for s in cx.slots):
                        raise RuntimeError(
                            f"request {r.rid} needs more KV pages than "
                            f"eviction can ever free (pool of "
                            f"{self.page_pool.n_pages - 1} usable pages)")
                    break
            if not any(s is not None for s in cx.slots):
                if not cx.ready:
                    if not pending:
                        break
                    if honor_arrivals:
                        dt = pending[0].arrival_s - (now() - cx.t0)
                        if dt > 0:
                            sleep(dt)
                continue
            # one fused multi-token chunk; a single host copy after it
            self.state, buf = self._decode_chunk(self.params, self.state)
            buf_np = buf.cpu().numpy()
            self.host_syncs += 1
            t_chunk = now() - cx.t0
            for b in range(self.n_slots):
                r = cx.slots[b]
                if r is None:
                    continue
                toks = [int(x) for x in buf_np[b]]
                take = min(cx.slot_left[b], len(toks))
                r.output.extend(toks[:take])
                cx.slot_left[b] -= take
                if cx.slot_left[b] == 0:    # retire; slot free to refill
                    r.done_s = t_chunk
                    cx.done.append(r)
                    cx.slots[b] = None
                    self._release_slot(b)
        return cx.done


def attribute_request_energy(requests: list[Request],
                             times_s: np.ndarray,
                             watts: np.ndarray) -> dict[int, float]:
    """Split measured system energy across in-flight requests.

    ``times_s``/``watts``: power samples (seconds since run start -- the
    clock the engine stamps requests on).  Each sample interval's energy
    is divided equally among the requests in flight (arrival <= t <
    done) during it; idle intervals are dropped.  Fills
    ``Request.energy_j`` and returns {rid: joules}.  (The reference's
    per-request ``weight`` serves speculative decoding and arrives with
    it.)
    """
    times_s = np.asarray(times_s, float)
    watts = np.asarray(watts, float)
    per: dict[int, float] = {r.rid: 0.0 for r in requests}
    spans = [(r.rid, r.arrival_s, r.done_s) for r in requests
             if r.done_s is not None]
    for i in range(len(times_s) - 1):
        t_lo, t_hi = times_s[i], times_s[i + 1]
        e = watts[i] * (t_hi - t_lo)
        live = [rid for rid, a, d in spans if a < t_hi and d > t_lo]
        for rid in live:
            per[rid] += e / len(live)
    for r in requests:
        r.energy_j = per.get(r.rid)
    return per
