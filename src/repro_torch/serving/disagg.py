"""Prefill/decode disaggregation: two fleets, one paged-KV handoff (the
PyTorch port of the reference ``serving/disagg.py``).

Serving a request has two phases with opposite hardware appetites:
prefill is one big compute-bound pass over the whole prompt, decode is
thousands of tiny bandwidth-bound steps.  Disaggregating them lets each
fleet run its phase at its own batch shape, and lets each fleet sit
behind its own ``PowerDomain`` stack (``DisaggregatedSUT`` in
``repro_torch.harness.sut``).

The handoff rides the paged KV layout: a ``PrefillWorker`` computes the
prompt's K/V as page-shaped blocks ``(L, NB, page, kvh, dh)`` plus the
first output token, and the decode engine scatters those blocks into
freshly allocated pages of its own pool
(``ContinuousBatchingEngine._install_slot``: a prefill into the slot
without the compute).  K/V are stored post-RoPE at absolute positions,
so the installed pages hold what a local prefill would have written and
disaggregated decode is token-identical to the colocated engine.

Flow::

    arrivals -> [PrefillWorker x P] --KVHandoff--> [decode engine, B slots]
                 (compute prompt KV,  (queue)       (install pages, decode
                  emit first token)                  to completion)

Each worker prefills in a thread of its own; the calling thread
decodes.  All of them launch on the device's current (default) stream,
so a handoff's blocks are written before the decode thread's install
reads them, by stream order alone.  A worker that raises ends ``serve``
with its exception (the reference's decode loop would wait for its
handoffs forever).
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.serving.engine import (Request, _engine_device,
                                        _prompt_tensor, page_blocks)
from repro_torch.serving.kv_pages import PoolExhausted


@dataclasses.dataclass
class KVHandoff:
    """One prefilled request in flight between the fleets.

    Args:
        request: the ``Request``, with ``prefill_start_s`` /
            ``first_token_s`` already stamped (seconds on the serve
            clock) and ``output`` seeded with the first token.
        blocks: the prompt's K/V as page-shaped blocks, {name: (L, NB,
            page, kvh, dh)} on the worker's device.
        tok0: the first sampled token (host int), the decode slot's
            seed token.
        n_tokens: prompt length in tokens (NB = ceil(n_tokens / page)).
    """

    request: Request
    blocks: dict
    tok0: int
    n_tokens: int


@dataclasses.dataclass
class _WorkerFailed:
    """What a worker thread puts on the handoff queue when its share
    raised: ``serve`` re-raises ``error``."""

    error: BaseException


class PrefillWorker:
    """One prefill replica: prompt -> page-shaped K/V blocks + token.

    Args:
        model: the target LM (the decode fleet's model).
        params: its weights.
        page_size: the decode fleet's KV page size in tokens; block
            boundaries must agree on both sides of the handoff.
        rules: tensor-parallel sharding rules; the port runs at TP 1,
            so anything but ``None`` raises (ROADMAP §A.8).
        device: the model's device (default ``cuda``).

    ``prefill(request, t0_s, now)`` returns a ``KVHandoff`` and stamps
    the request's ``prefill_start_s``/``first_token_s`` relative to
    ``t0_s`` (seconds, the shared serve clock).
    """

    def __init__(self, model, params, *, page_size: int, rules=None,
                 device="cuda"):
        if page_size <= 0:
            raise ValueError("PrefillWorker needs page_size > 0")
        if rules is not None:
            raise NotImplementedError(
                "PrefillWorker(rules=...): tensor-parallel prefill is not "
                "ported yet (ROADMAP §A.8)")
        self.device = _engine_device(model, device)
        self.model = model
        self.params = params
        self.page_size = int(page_size)
        self.rules = rules
        self.prefill_tokens = 0        # host accounting, reset by serve

    # grad mode is thread-local: a worker thread does not inherit the
    # caller's no_grad
    @torch.no_grad()
    def prefill(self, r: Request, t0_s: float,
                now: Callable[[], float] = time.monotonic) -> KVHandoff:
        """Prefill ``r`` on this worker and return its ``KVHandoff``.

        The contiguous prefill runs with ``max_len = NB * page`` so that
        its cache rows slice into page-shaped blocks; rows past the
        prompt are zero and the decode fleet overwrites them at
        positions ``S..``.  The first token's host read is the true
        TTFT: ``first_token_s`` is stamped after it."""
        toks = np.asarray(r.prompt).reshape(-1)
        s = int(toks.shape[0])
        ps = self.page_size
        n_blocks = -(-s // ps)
        r.prefill_start_s = now() - t0_s
        logits, cache = self.model.prefill(
            self.params, {"tokens": _prompt_tensor(toks, self.device)},
            max_len=n_blocks * ps)
        tok0 = int(torch.argmax(logits[0, -1], -1))
        r.first_token_s = now() - t0_s
        r.output = [tok0][: r.max_new_tokens]
        r.prefill_tokens += s
        self.prefill_tokens += s
        return KVHandoff(request=r, blocks=page_blocks(cache, n_blocks, ps),
                         tok0=tok0, n_tokens=s)


class DisaggregatedEngine:
    """Prefill replicas feeding a decode engine via paged KV handoff.

    Args:
        prefill_workers: one or more ``PrefillWorker`` (the decode
            engine's model and ``page_size``).
        decode_engine: a paged, non-speculative
            ``ContinuousBatchingEngine``; its pool receives the
            handed-off blocks.

    ``serve(requests, ...)`` has the contract of
    ``ContinuousBatchingEngine.serve``: honours ``arrival_s``, stamps
    ``first_token_s``/``done_s`` on one t = 0 clock, returns the
    completed requests.  Prefill runs in one thread per worker
    (round-robin shares); the calling thread decodes, reading each
    decode chunk back once (``host_syncs``).  Output is token-identical
    to the colocated engine.
    """

    def __init__(self, prefill_workers: list, decode_engine):
        if not prefill_workers:
            raise ValueError("DisaggregatedEngine needs >= 1 "
                             "prefill worker")
        if not getattr(decode_engine, "paged", False):
            raise ValueError("decode engine must be paged "
                             "(kv_page_size > 0) to install handoffs")
        if getattr(decode_engine, "speculative", False):
            raise ValueError("disaggregated decode does not run "
                             "speculatively (the draft never saw the "
                             "prompt)")
        for w in prefill_workers:
            if w.page_size != decode_engine.page_size:
                raise ValueError(
                    f"prefill page_size {w.page_size} != decode "
                    f"page_size {decode_engine.page_size}")
            if (w.model.cfg.n_kv_heads
                    != decode_engine.model.cfg.n_kv_heads):
                raise ValueError(
                    f"prefill n_kv_heads {w.model.cfg.n_kv_heads} != "
                    f"decode n_kv_heads "
                    f"{decode_engine.model.cfg.n_kv_heads} — build "
                    f"workers from the decode engine's model/params "
                    f"(a sharded fleet may have replicated KV heads; "
                    f"see replicate_kv_heads)")
        self.workers = prefill_workers
        self.engine = decode_engine

    def _prefill_share(self, worker: PrefillWorker, share: list,
                       out: "queue.Queue", t0: float,
                       now: Callable[[], float],
                       sleep: Callable[[float], None],
                       honor_arrivals: bool,
                       stop: Optional[threading.Event] = None) -> None:
        """Drain this worker's share, SLO-aware: among the requests
        that have already arrived, prefill the highest-priority
        (earliest-arrived within a class) first, so that an interactive
        short never queues behind a best-effort long that arrived
        moments earlier.  An in-flight prefill is not preempted.
        Returns early once ``stop`` is set (the serve has failed); an
        exception is put on ``out`` for ``serve`` to raise."""
        backlog = collections.deque(share)     # arrival-sorted
        try:
            while backlog:
                if stop is not None and stop.is_set():
                    return
                if honor_arrivals:
                    dt = backlog[0].arrival_s - (now() - t0)
                    if dt > 0:
                        sleep(dt)
                    t = now() - t0
                    arrived = [r for r in backlog if r.arrival_s <= t]
                else:
                    arrived = list(backlog)
                r = max(arrived or [backlog[0]],
                        key=lambda q: (q.priority, -q.arrival_s, -q.rid))
                backlog.remove(r)
                out.put(worker.prefill(r, t0, now))
        except BaseException as e:     # re-raised by serve
            out.put(_WorkerFailed(e))

    def serve(self, requests: list[Request],
              now: Callable[[], float] = time.monotonic,
              sleep: Callable[[float], None] = time.sleep,
              honor_arrivals: bool = True) -> list[Request]:
        """Round-robin the requests over the prefill fleet (each worker
        drains its share priority-first), feed the handoffs to the
        decode engine as they come, and return the completed records.
        A worker's exception is raised here; the other workers stop
        after their current prefill."""
        eng = self.engine
        ordered = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        rids = [r.rid for r in ordered]
        if len(set(rids)) != len(rids):
            dup = sorted({r for r in rids if rids.count(r) > 1})
            raise ValueError(f"duplicate request ids in admission "
                             f"queue: {dup}")
        eng.reset()
        eng.prefix_stats = eng._zero_prefix_stats()
        eng.sched_stats = eng._zero_sched_stats()
        eng.host_syncs = 0
        eng.decode_steps = 0
        for w in self.workers:
            w.prefill_tokens = 0
        t0 = now()
        handoffs: queue.Queue = queue.Queue()
        stop = threading.Event()
        threads = [
            threading.Thread(
                target=self._prefill_share,
                args=(w, ordered[i::len(self.workers)], handoffs, t0,
                      now, sleep, honor_arrivals, stop), daemon=True)
            for i, w in enumerate(self.workers)]
        for th in threads:
            th.start()
        try:
            done = self._decode(handoffs, len(ordered), now, t0)
        finally:
            stop.set()
        for th in threads:
            th.join()
        return done

    def _decode(self, handoffs: "queue.Queue", n_expected: int,
                now: Callable[[], float], t0: float) -> list[Request]:
        """The decode loop: drain the handoff queue without blocking a
        busy decode (block for the next handoff only when no slot is
        busy and nothing waits), install waiting handoffs into free
        slots, run one decode chunk and read it back once."""
        eng = self.engine
        slots: list[Optional[Request]] = [None] * eng.n_slots
        slot_left = [0] * eng.n_slots
        waiting: list[KVHandoff] = []  # handed off, awaiting a slot
        done: list[Request] = []
        while len(done) < n_expected:
            busy = any(s is not None for s in slots)
            try:
                block = (not busy and not waiting
                         and len(done) + sum(s is not None
                                             for s in slots) < n_expected)
                while True:
                    item = handoffs.get(block=block, timeout=None)
                    if isinstance(item, _WorkerFailed):
                        raise item.error
                    waiting.append(item)
                    block = False
            except queue.Empty:
                pass
            for b in range(eng.n_slots):
                if slots[b] is not None or not waiting:
                    continue
                h = waiting[0]
                if not self._install(h, b, slots, slot_left, done,
                                     now, t0):
                    if not any(s is not None for s in slots):
                        raise RuntimeError(
                            f"request {h.request.rid} needs more KV "
                            f"pages than the decode pool can ever "
                            f"free ({eng.page_pool.n_pages - 1} "
                            f"usable pages)")
                    break                  # wait for a retiring slot
                waiting.pop(0)
            if not any(s is not None for s in slots):
                continue
            eng.state, buf = eng._decode_chunk(eng.params, eng.state)
            slot_toks = buf.cpu().tolist()
            eng.host_syncs += 1
            eng.sched_stats["decode_chunks"] += 1
            t_chunk = now() - t0
            for b in range(eng.n_slots):
                r = slots[b]
                if r is None:
                    continue
                toks = slot_toks[b]
                take = min(slot_left[b], len(toks))
                r.output.extend(toks[:take])
                slot_left[b] -= take
                if slot_left[b] == 0:
                    r.done_s = t_chunk
                    done.append(r)
                    slots[b] = None
                    eng._release_slot(b)
        return done

    def _install(self, h: KVHandoff, b: int, slots, slot_left, done,
                 now, t0) -> bool:
        """Scatter a handoff's blocks into slot ``b``'s fresh pages;
        ``False`` defers it (pool pressure: a retiring slot will free
        pages).  A request whose prompt and budget exceed the decode
        engine's ``max_len`` raises ``ValueError``, as the engine's own
        admission does."""
        eng = self.engine
        r = h.request
        s = h.n_tokens
        budget = r.max_new_tokens
        if s + budget > eng.max_len:
            raise ValueError(f"request {r.rid}: prompt {s} + budget "
                             f"{budget} tokens exceed max_len "
                             f"{eng.max_len}")
        total = min(eng.pages_per_slot, -(-(s + budget) // eng.page_size))
        try:
            row = eng._alloc_pages(total)
        except PoolExhausted:
            return False
        eng._slot_pages[b] = list(row)
        eng._slot_toks[b] = tuple(int(x) for x in
                                  np.asarray(r.prompt).reshape(-1))
        eng._slot_base[b] = 0
        eng.state = eng._install_slot(eng.state, h.blocks, h.tok0, b, row,
                                      s, budget)
        if budget <= 1:
            r.done_s = now() - t0
            done.append(r)
            eng._release_slot(b)
        else:
            slots[b] = r
            slot_left[b] = budget - 1
        return True
