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


@dataclasses.dataclass
class Request:
    """One serving request: the contract every engine fills in.

    Caller-set: ``rid`` (unique per serve), ``prompt`` ((S,) int
    tokens), ``max_new_tokens``, ``arrival_s`` (seconds on the serve
    clock).  Everything else is engine-stamped.  The reference's fields
    for scheduling, preemption, prefix caching and speculative decoding
    arrive with those features.
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
    prefill_tokens: int = 0           # prompt tokens computed at admission

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
    """Slot-based continuous batching, greedy, contiguous KV cache.

    Usage::

        eng = ContinuousBatchingEngine(model, params, max_len=2048,
                                       n_slots=8, chunk_steps=8)
        done = eng.serve(requests)          # honors Request.arrival_s

    ``device`` defaults to ``cuda`` and must match the model's.  Per
    decode chunk the host performs exactly one device->host copy
    (``host_syncs`` counts them); ``decode_steps`` counts the model
    decode steps run.
    """

    def __init__(self, model, params, *, max_len: int = 256,
                 n_slots: int = 8, chunk_steps: int = 8, device="cuda",
                 draft_model=None, spec_k: int = 0, kv_page_size: int = 0,
                 prefix_caching: bool = False,
                 prefill_chunk_tokens: int = 0, scheduler=None):
        refused = {
            "draft_model/spec_k (speculative decoding, ROADMAP §A.7)":
                draft_model is not None or spec_k,
            "kv_page_size (paged KV, ROADMAP §A.5)": kv_page_size,
            "prefix_caching (ROADMAP §A.5)": prefix_caching,
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
        self.reset()

    # -- device state ---------------------------------------------------
    def reset(self):
        """Fresh slot state: empty cache, zero positions, no budgets."""
        n = self.n_slots
        self.state = {
            "cache": self.model.init_cache(n, self.max_len,
                                           per_slot_pos=True),
            "tok": torch.zeros((n,), dtype=torch.long, device=self.device),
            "remaining": torch.zeros((n,), dtype=torch.int32,
                                     device=self.device),
        }

    @torch.no_grad()
    def _prefill_slot(self, params, state, tokens, slot: int, budget: int):
        """Prefill one (1, S) prompt into slot ``slot``, in place.

        The prompt's K/V land at rows [0, S) of the slot's cache row and
        the rest of the row is zeroed (the reference overwrites the whole
        row with the zero-padded batch-1 prefill cache).  The slot's
        position becomes S, its first greedy token seeds decoding, and
        its budget becomes ``budget - 1``.  Other slots are untouched.
        Returns (state, tok0) with tok0 still on the device.
        """
        cache = state["cache"]
        row = {"blocks": {name: t[:, slot:slot + 1] for name, t in
                          cache["layers"]["blocks"].items()}}
        logits, one = self.model.prefill(params, {"tokens": tokens},
                                         max_len=self.max_len, cache=row)
        tok0 = torch.argmax(logits[0, -1], -1)
        cache["pos"][slot] = one["pos"]
        state["tok"][slot] = tok0
        state["remaining"][slot] = max(budget - 1, 0)
        return state, tok0

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

    def _admit_slot(self, r: Request, b: int, cx: _ServeCtx) -> None:
        """Admit ``r`` into free slot ``b``: prefill, stamp, route."""
        prompt = _prompt_tensor(r.prompt, self.device)
        s = int(prompt.shape[1])
        budget = r.max_new_tokens
        if s + budget > self.max_len:
            raise ValueError(f"request {r.rid}: prompt {s} + budget "
                             f"{budget} tokens exceed max_len "
                             f"{self.max_len}")
        r.prefill_tokens += s
        self.state, tok0 = self._prefill_slot(self.params, self.state,
                                              prompt, b, budget)
        self._finish_admit(r, b, tok0, budget, cx)

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
        up (Offline scenario).  Admission is FIFO by arrival.
        """
        counts = collections.Counter(r.rid for r in requests)
        dup = sorted(r for r, c in counts.items() if c > 1)
        if dup:                        # validate before touching state
            raise ValueError(
                f"duplicate request ids in admission queue: {dup} -- "
                f"rids must be unique per serve()")
        self.reset()
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
                if cx.slots[b] is None and cx.ready:
                    self._admit_slot(cx.ready.popleft(), b, cx)
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
