"""Serving engines: fixed-batch and slot-based continuous batching
(PyTorch port of the reference ``serving/engine.py``).

``ServeEngine`` (fixed batch)
    Prefills one batch together and decodes it in lock-step, one
    device->host copy per token.  The one engine of an encoder-decoder
    (whisper): its frames go in as ``run_batch``'s ``extra_inputs``.

``ContinuousBatchingEngine`` (the Server-scenario hot path)
    ``n_slots`` decode rows over one preallocated KV cache with a
    per-slot position vector.  Finished slots are refilled from the
    admission queue mid-flight by a batch-1 prefill written into the
    slot's cache rows.  Each decode chunk runs ``chunk_steps`` greedy
    steps with no host round trip inside; the host copies the chunk's
    (n_slots, chunk_steps) token buffer once (``host_syncs``).  Paged
    KV with a radix prefix cache, speculative decoding with a draft
    model, chunked prefill interleaved with decode chunks, and a
    deadline-slack ``Scheduler`` that may park a running request under
    page-pool pressure and resume it later are modes of the same
    engine.
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
from repro_torch.serving.speculative import (greedy_verify,
                                             sample_categorical,
                                             speculative_sample)


@dataclasses.dataclass
class Request:
    """One serving request: the contract every engine fills in.

    Caller-set: ``rid`` (unique per serve), ``prompt`` ((S,) int
    tokens), ``max_new_tokens``, ``arrival_s`` (seconds on the serve
    clock), and the SLO-aware fields ``priority`` (higher = more
    urgent) and ``deadline_s`` (absolute completion deadline on the
    serve clock; ``None`` = best-effort).  Everything else is
    engine-stamped.
    """

    rid: int
    prompt: Any                       # (S,) int tokens
    max_new_tokens: int = 16
    arrival_s: float = 0.0
    priority: int = 0                 # scheduler class (higher first)
    deadline_s: Optional[float] = None   # completion deadline, serve
                                         # clock (None = best effort)
    # filled by the engine:
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    output: Optional[list] = None
    energy_j: Optional[float] = None  # filled by attribute_request_energy
    preemptions: int = 0              # times this request was parked
                                      # (pages evicted, state host-side)
    prefill_start_s: Optional[float] = None  # when prefill compute began
                                      # (disaggregation: on the prefill
                                      # fleet; None = admitted directly)
    cached_tokens: int = 0            # prompt tokens served from the
                                      # prefix cache (no prefill compute)
    prefill_tokens: int = 0           # prompt tokens computed at admission
                                      # (the unique suffix on a hit)
    draft_tokens: int = 0             # draft-model token forwards this
                                      # request triggered (speculative)
    verify_tokens: int = 0            # target token forwards it triggered
                                      # (speculative: prefill + rounds *
                                      # (k + 1), more per emitted token at
                                      # low acceptance)

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
class _PrefillProgress:
    """Host cursor of one chunked prefill in flight: the slot is held,
    its pages are pinned, and ``next_pos`` prompt tokens are absorbed
    so far (the device table row stays garbage until the final chunk
    installs the slot)."""

    r: Request
    prompt: torch.Tensor  # (1, S) device prompt (incl. resumed output)
    toks: tuple           # host copy of the same tokens
    row: list             # physical pages, position order
    table: torch.Tensor   # (pages_per_slot,) padded device row
    next_pos: int         # absolute position of the next chunk
    budget: int           # decode budget at this admission
    resume: bool          # parked-request resume (stamps differ)
    cached: int           # prefix-cache tokens skipped at acquire


@dataclasses.dataclass
class _ServeCtx:
    """Mutable host state of one ``serve`` call, shared by the
    admission/prefill/decode helpers."""

    slots: list          # per-slot in-flight Request (None = free)
    slot_left: list      # host shadow of the device `remaining` vector
    filling: dict        # slot -> _PrefillProgress (chunked prefill)
    ready: Any           # deque of arrived, unadmitted requests
    parked: set          # rids of preempted requests awaiting resume
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


def _on_device(t: torch.Tensor, dev: torch.device) -> bool:
    """Whether ``t`` lies on ``dev`` (``cuda`` without an index: any
    card)."""
    return t.device.type == dev.type and (dev.index is None
                                          or t.device.index == dev.index)


def page_blocks(cache, n_blocks: int, page_size: int) -> dict:
    """A batch-1 contiguous cache of ``n_blocks * page_size`` rows as
    page-shaped K/V blocks: {name: (L, NB, page, kvh, dh)} (views of
    its leaves)."""
    return {name: t[:, 0].reshape(t.shape[0], n_blocks, page_size,
                                  *t.shape[3:])
            for name, t in cache["layers"]["blocks"].items()}


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
                  now: Callable[[], float] = time.monotonic,
                  extra_inputs: Optional[dict] = None) -> list[Request]:
        """Service one batch of requests synchronously.

        ``extra_inputs`` are further prefill inputs beside the prompts'
        ``tokens`` (an encoder-decoder's ``frames``), tensors on the
        engine's device."""
        if len(requests) > self.batch:
            raise ValueError(f"{len(requests)} requests > batch size "
                             f"{self.batch}")
        # the batch decodes at positions s .. s + max(budget) - 2, each
        # inside the cache's max_len rows
        for r in requests:
            s = np.asarray(r.prompt).size
            if s + r.max_new_tokens > self.max_len + 1:
                raise ValueError(f"request {r.rid}: prompt {s} + budget "
                                 f"{r.max_new_tokens} tokens exceed "
                                 f"max_len {self.max_len} + 1")
        prompts = torch.cat([_prompt_tensor(r.prompt, self.device)
                             for r in requests])
        inputs = {"tokens": prompts}
        for name, t in (extra_inputs or {}).items():
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"extra_inputs[{name!r}] is a "
                                f"{type(t).__name__}, not a tensor")
            if not _on_device(t, self.device):
                raise ValueError(f"extra_inputs[{name!r}] is on {t.device}, "
                                 f"the engine on {self.device}")
            inputs[name] = t
        logits, cache = self.model.prefill(self.params, inputs,
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

    def tokens_per_request(self, requests: list[Request]) -> int:
        """Total emitted tokens (the efficiency denominators' work)."""
        return sum(len(r.output or []) for r in requests)


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

    Chunked prefill (``prefill_chunk_tokens > 0``, paged only): an
    admitted prompt is absorbed ``prefill_chunk_tokens`` at a time, one
    chunk per filling slot per loop iteration, each through a batch-1
    paged ``verify_step`` on the engine's pool, interleaved with the
    decode chunks of the other slots; the final chunk installs the slot
    and emits its first token (token-identical to a whole-prompt
    prefill in float32).  ``scheduler`` (``Scheduler``) orders the
    admission queue by priority and deadline slack; with
    ``preemption`` (which needs ``prefix_caching``) an admission that
    the page pool cannot cover parks a strictly lower-priority running
    request: its history is interned into the prefix cache, its pages
    released, and it is re-queued to resume later through the
    prefix-cache extend path with the tokens it would have emitted.
    ``sched_stats`` counts preemptions, resumes, prefill chunks, decode
    chunks and decode chunks run while a prompt was filling.

    Speculative decoding (``spec_k > 0`` with a ``draft_model``): each
    chunk runs ``chunk_steps`` draft-and-verify rounds instead of
    single-token steps (``spec_rounds`` counts them).  Per round the
    draft decodes ``spec_k + 1`` steps for every slot, the target scores
    the window ``[tok, d_1..d_k]`` in one ``verify_step``, and
    acceptance (``greedy_verify``, or ``speculative_sample`` at
    ``temperature > 0``) commits a per-slot prefix plus one token.
    Accepted lengths are ragged across slots; each round writes a fixed
    (n_slots, k + 1) block of the chunk's token buffer with per-slot
    emit counts, so the host still copies once per chunk.  Only the
    per-slot positions advance, so rejected tokens roll back in place.
    The draft keeps its own contiguous cache, in paged mode too.
    Greedy speculative output is token-identical to plain greedy
    decode for any draft.
    """

    def __init__(self, model, params, *, max_len: int = 256,
                 n_slots: int = 8, chunk_steps: int = 8, device="cuda",
                 draft_model=None, draft_params=None, spec_k: int = 0,
                 temperature: float = 0.0, spec_seed: int = 0,
                 kv_page_size: int = 0, kv_pages: Optional[int] = None,
                 prefix_caching: bool = False,
                 prefill_chunk_tokens: int = 0, scheduler=None):
        if model.cfg.family == "encdec":
            raise NotImplementedError(
                "ContinuousBatchingEngine has no encoder-decoder path (nor "
                "has the reference's slot engine): serve whisper through "
                "ServeEngine.run_batch(..., extra_inputs={'frames': ...})")
        self.device = _engine_device(model, device)
        self.model = model
        self.params = params
        self.max_len = max_len
        self.n_slots = n_slots
        self.chunk_steps = chunk_steps
        self.spec_k = int(spec_k)
        self.speculative = self.spec_k > 0
        if self.speculative and draft_model is None:
            raise ValueError("spec_k > 0 needs draft_model/draft_params")
        if self.speculative:
            model.check_verify()       # rwkv: no verify path, refuse now
        self.draft_model = draft_model
        self.draft_params = draft_params
        self.temperature = float(temperature)
        self.spec_seed = spec_seed
        if self.speculative:
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_model.cfg.vocab_size} != target "
                    f"vocab {model.cfg.vocab_size}")
            if draft_model.device != self.device:
                raise ValueError(f"draft device {draft_model.device} != "
                                 f"engine device {self.device}")
        self.host_syncs = 0            # decode-chunk device->host copies
        self.decode_steps = 0          # plain model decode steps (all slots)
        self.spec_rounds = 0           # speculative rounds (all slots)
        # speculative accounting (host-accumulated, reset per serve):
        # rounds/proposed/accepted over live slots, prefill token counts
        self.spec_stats = self._zero_spec_stats()
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
        # SLO-aware serving: chunked prefill + pluggable admission
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.chunked_prefill = self.prefill_chunk_tokens > 0
        if self.chunked_prefill and not self.paged:
            raise ValueError(
                "prefill_chunk_tokens > 0 requires kv_page_size > 0 -- "
                "chunked prefill writes each chunk's K/V through the "
                "paged verify path at absolute positions")
        self.scheduler = scheduler
        if (scheduler is not None and scheduler.preemption
                and not self.prefix_caching):
            raise ValueError(
                "Scheduler(preemption=True) requires "
                "prefix_caching=True -- a parked request's KV pages "
                "survive as prefix-cache entries until resume")
        self.sched_stats = self._zero_sched_stats()
        self.reset()

    @staticmethod
    def _zero_spec_stats() -> dict:
        return {"rounds": 0, "proposed": 0, "accepted": 0, "emitted": 0,
                "draft_fwd": 0, "draft_prefill_tokens": 0,
                "target_prefill_tokens": 0}

    @staticmethod
    def _zero_prefix_stats() -> dict:
        return {"lookups": 0, "hits": 0, "cached_tokens": 0,
                "evicted_pages": 0}

    @staticmethod
    def _zero_sched_stats() -> dict:
        return {"preemptions": 0, "resumes": 0, "prefill_chunks": 0,
                "decode_chunks": 0, "interleaved_chunks": 0}

    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens the target accepted."""
        return self.spec_stats["accepted"] / max(
            1, self.spec_stats["proposed"])

    # -- device state ---------------------------------------------------
    def reset(self):
        """Fresh slot state: empty cache, zero positions, no budgets;
        in paged mode also a full page pool and an empty prefix cache;
        in speculative mode also an empty contiguous draft cache and,
        when sampling, a generator seeded with ``spec_seed``."""
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
            # preemption shadows: the token history whose K/V occupies
            # the slot (admitted prompt, incl. resumed output) and how
            # many output tokens predate this admission -- enough to
            # reconstruct the parked state host-side
            self._slot_toks: list[tuple] = [()] * n
            self._slot_base: list[int] = [0] * n
        else:
            cache = self.model.init_cache(n, self.max_len,
                                          per_slot_pos=True)
        self.state = {
            "cache": cache,
            "tok": torch.zeros((n,), dtype=torch.long, device=self.device),
            "remaining": torch.zeros((n,), dtype=torch.int32,
                                     device=self.device),
        }
        if self.speculative:
            self.state["draft_cache"] = self.draft_model.init_cache(
                n, self.max_len, per_slot_pos=True)
            if self.temperature > 0:
                self.gen = torch.Generator(device=self.device)
                self.gen.manual_seed(self.spec_seed)

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
            logits = self._prefill_row(self.model, params, cache, tokens,
                                       slot)
        else:
            ps = self.page_size
            n_blk = -(-int(tokens.shape[1]) // ps)
            logits, one = self.model.prefill(params, {"tokens": tokens},
                                             max_len=n_blk * ps)
            self._scatter_blocks(cache, page_blocks(one, n_blk, ps),
                                 pages[:n_blk])
            cache["pages"][slot] = self._table_row(pages)
            cache["pos"][slot] = one["pos"]
        tok0 = torch.argmax(logits[0, -1], -1)
        state["tok"][slot] = tok0
        state["remaining"][slot] = max(budget - 1, 0)
        return state, tok0

    def _scatter_blocks(self, cache, blocks: dict, pages: list) -> None:
        """Write page-shaped K/V ``blocks`` ({name: (L, NB, page, kvh,
        dh)}) at the physical ``pages`` (NB of them, position order) of
        the pool, in place."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for name, pool in cache["layers"]["blocks"].items():
            pool[:, idx] = blocks[name].to(pool.dtype)

    @torch.no_grad()
    def _install_slot(self, state, blocks: dict, tok0: int, slot: int,
                      pages: list, n_tokens: int, budget: int):
        """Install handed-off K/V into slot ``slot`` (prefill/decode
        disaggregation): the paged ``_prefill_slot`` without the
        compute.

        ``blocks`` ({name: (L, NB, page, kvh, dh)}, on the engine's
        device) were computed by a ``PrefillWorker``; they are scattered
        at the first NB of ``pages`` (the slot's physical pages,
        position order), the slot's table row is installed, its
        position becomes ``n_tokens``, the first token ``tok0`` that the
        worker already emitted seeds decoding, and the budget becomes
        ``budget - 1``.  Other slots are untouched.  Returns the state.
        """
        cache = state["cache"]
        n_blk = -(-n_tokens // self.page_size)
        self._scatter_blocks(cache, blocks, pages[:n_blk])
        cache["pages"][slot] = self._table_row(pages)
        cache["pos"][slot] = n_tokens
        state["tok"][slot] = tok0
        state["remaining"][slot] = max(budget - 1, 0)
        return state

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

    @torch.no_grad()
    def _prefill_chunk(self, params, state, chunk, table, start: int):
        """Absorb one prompt chunk into a slot's pages (chunked prefill).

        ``chunk``: (1, C) prompt slice at absolute positions ``[start,
        start + C)``; ``table``: the slot's padded device table row.  The
        chunk runs through the batch-1 paged ``verify_step`` on the
        engine's own pool tensors, so its K/V land post-RoPE at absolute
        positions in place: after the last chunk the pages hold what one
        whole-prompt prefill would have written.  Only the pool changes
        here: the slot's table row, position, token and budget are
        installed by the *final* chunk (an ``_extend_slot`` call), so
        decode chunks running meanwhile never see a half-filled slot
        (their writes for the still-inactive slot land on the garbage
        page).  The logits are discarded, and nothing is read back to
        the host.
        """
        cache = state["cache"]
        mini = {"layers": cache["layers"],
                "pos": torch.full((1,), start, dtype=torch.int32,
                                  device=self.device),
                "pages": table[None]}
        self.model.verify_step(params, mini, chunk)
        return state

    def _prefill_row(self, model, params, cache, tokens, slot: int):
        """Batch-1 prefill of ``tokens`` (1, S) by ``model`` into row
        ``slot`` of the contiguous per-slot ``cache``, in place: K/V at
        rows [0, S), zeros after, position S.  Returns the logits."""
        row = {"blocks": {name: t[:, slot:slot + 1] for name, t in
                          cache["layers"]["blocks"].items()}}
        logits, one = model.prefill(params, {"tokens": tokens},
                                    max_len=self.max_len, cache=row)
        cache["pos"][slot] = one["pos"]
        return logits

    @torch.no_grad()
    def _prefill_draft(self, dparams, state, tokens, slot: int):
        """Speculative mode: the draft prefills the *full* (1, S) prompt
        into its contiguous cache row -- on a prefix hit too, since it
        has no pages to share -- so that drafting starts aligned with
        the target."""
        self._prefill_row(self.draft_model, dparams, state["draft_cache"],
                          tokens, slot)
        return state

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

    @torch.no_grad()
    def _spec_chunk(self, params, dparams, state):
        """Run ``chunk_steps`` draft-and-verify rounds on the device.

        Exactly ``chunk_steps`` rounds with no host read inside, as in
        ``_decode_chunk``.  Each round the draft runs k + 1 decode
        steps: step j processes the token at window offset j (writing
        its K/V at ``pos + j``) and proposes token j + 1; the last step
        only fills d_k's cache row, which a fully accepted window needs
        next round.  The target then scores ``[tok, d_1..d_k]`` in one
        ``verify_step`` and acceptance commits ``n_emit = acc + 1``
        tokens per active slot: target and draft positions both advance
        by ``n_emit``.  Inactive slots hold position, token and draft
        position; their window writes are garbage that the next prefill
        into the slot overwrites.

        Returns (state, out) with ``out`` (n_slots, rounds * (k + 2))
        long on the device: the per-round (k + 1) token blocks, then the
        per-round emit counts (0 for an inactive slot, else the accepted
        length + 1) -- one tensor, so that the host fetches the chunk in
        one copy (``_split_spec``).
        """
        k, b, rounds = self.spec_k, self.n_slots, self.chunk_steps
        sampled = self.temperature > 0
        cache, dcache = state["cache"], state["draft_cache"]
        tok, remaining = state["tok"], state["remaining"]
        dev = self.device
        buf = torch.zeros((b, rounds, k + 1), dtype=torch.long, device=dev)
        n_emit_all = torch.zeros((b, rounds), dtype=torch.long, device=dev)
        for i in range(rounds):
            active = remaining > 0
            pos0, dpos0 = cache["pos"], dcache["pos"]
            cur, proposals, dlogits = tok, [], []
            for _ in range(k + 1):
                logits, dcache = self.draft_model.decode_step(
                    dparams, dcache, cur[:, None])
                row = logits[:, -1].float()
                if sampled:
                    row = self._mask_pad(row)
                    cur = sample_categorical(self.gen,
                                             row / self.temperature)
                    dlogits.append(row)
                else:
                    cur = torch.argmax(row, dim=-1)
                proposals.append(cur)
            draft_toks = torch.stack(proposals[:k], dim=1)       # (B, k)
            window = torch.cat([tok[:, None], draft_toks], dim=1)
            logits, cache = self.model.verify_step(params, cache, window)
            if sampled:
                acc, out_toks = speculative_sample(
                    self.gen, self._mask_pad(logits.float()),
                    torch.stack(dlogits[:k], dim=1), draft_toks,
                    self.temperature)
            else:
                acc, out_toks = greedy_verify(logits, draft_toks)
            acc = acc.long()
            n_emit = torch.where(active, acc + 1, 0).to(torch.int32)
            new_tok = torch.gather(out_toks, 1, acc[:, None])[:, 0]
            buf[:, i] = out_toks
            n_emit_all[:, i] = n_emit
            cache["pos"] = pos0 + n_emit
            dcache["pos"] = torch.where(active, pos0 + n_emit, dpos0)
            tok = torch.where(active, new_tok, tok)
            remaining = (remaining - n_emit).clamp_min(0)
        self.spec_rounds += rounds
        state.update(cache=cache, draft_cache=dcache, tok=tok,
                     remaining=remaining)
        return state, torch.cat([buf.reshape(b, -1), n_emit_all], dim=1)

    def _split_spec(self, out) -> tuple[list, Any]:
        """Host side of ``_spec_chunk``'s packed output (numpy): each
        slot's emitted tokens, stitched from its per-round blocks, and
        the (n_slots, rounds) emit counts."""
        rounds, k1 = self.chunk_steps, self.spec_k + 1
        buf = out[:, :rounds * k1].reshape(-1, rounds, k1)
        n_emit = out[:, rounds * k1:]
        toks = [[int(x) for i in range(rounds)
                 for x in buf[b, i, :n_emit[b, i]]]
                for b in range(out.shape[0])]
        return toks, n_emit

    def _mask_pad(self, logits):
        """-1e30 over the padded vocabulary tail before sampling (the
        argmax paths stay unmasked, to match the plain engine)."""
        vocab = self.model.cfg.vocab_size
        if logits.shape[-1] == vocab:
            return logits
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab
        return torch.where(pad, -1e30, logits)

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
        n_blocks = min(self.pages_per_slot,
                       -(-(s + budget + self.spec_k) // ps))
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

    def _park(self, b: int, cx: _ServeCtx) -> Request:
        """Preempt slot ``b``: evict its pages, park its state host-side.

        The slot's decode-complete K/V -- its admitted token history
        plus every emitted token but the pending one -- is interned
        block-wise into the prefix cache, whose reference keeps those
        pages alive after ``_release_slot`` drops the slot's own ones
        (the partial last block frees at once).  ``_release_slot`` aims
        the table row at the garbage page first, so the frozen chunk
        loop's writes for the slot land there and never on a page that
        is handed out again.  The device slot is frozen by an in-place
        write of ``remaining[b] = 0`` (no host read).  Readmission
        resumes the request through the prefix-cache extend path with
        ``prompt' = prompt + output``, recomputing at most one block's
        tail and emitting the continuation token.  Under later pool
        pressure the parked pages may themselves be evicted (refcount
        1, cache-only), which makes the resume recompute more, never
        emit other tokens.
        """
        r = cx.slots[b]
        emitted = r.output[self._slot_base[b]:]
        # K/V exists for history + emitted[:-1]; emitted[-1] is the
        # pending decode input (its K/V row is written next step)
        hist = self._slot_toks[b] + tuple(emitted[:-1])
        self._intern_prompt(hist, self._slot_pages[b])
        self._release_slot(b)
        self.state["remaining"][b] = 0
        cx.slots[b] = None
        cx.slot_left[b] = 0
        r.preemptions += 1
        self.sched_stats["preemptions"] += 1
        return r

    def _acquire_or_preempt(self, r: Request, toks: tuple, s: int,
                            budget: int, cx: _ServeCtx):
        """``_acquire_pages`` for ``r``; on ``PoolExhausted`` with a
        preempting scheduler, park its victims one at a time (each
        re-queued) until the pages fit.  Returns ``(row, start)``, or
        ``None`` to defer when no victim frees enough."""
        try:
            return self._acquire_pages(toks, s, budget)
        except PoolExhausted:
            if self.scheduler is None:
                return None
        running = [(i, q) for i, q in enumerate(cx.slots) if q is not None]
        while running:
            v = self.scheduler.pick_victim(running, r)
            if v is None:
                break
            victim = self._park(v, cx)
            cx.parked.add(victim.rid)
            cx.ready.append(victim)
            running = [iq for iq in running if iq[0] != v]
            try:
                return self._acquire_pages(toks, s, budget)
            except PoolExhausted:
                continue
        return None

    def _admit_slot(self, r: Request, b: int, cx: _ServeCtx) -> bool:
        """Admit ``r`` into free slot ``b``: prefill (or, on a prefix
        hit, extend), stamp, route; with chunked prefill only start the
        prompt's chunk cursor.  ``False`` = defer: the page pool cannot
        cover the request, even after preemption, until a slot retires.

        A parked request (rid in ``cx.parked``) resumes with ``prompt' =
        prompt + output`` and the remaining decode budget; the
        prefix-cache lookup in ``_acquire_pages`` finds its parked full
        blocks, so only the tail is computed again.
        """
        resume = r.rid in cx.parked
        toks = tuple(int(x) for x in np.asarray(r.prompt).reshape(-1))
        budget = r.max_new_tokens
        if resume:
            toks += tuple(r.output)
            budget -= len(r.output)
        prompt = _prompt_tensor(toks, self.device)
        s = len(toks)
        # speculative verify windows write up to spec_k rows past the
        # last decoded position; keep them in the cache
        if s + budget + self.spec_k > self.max_len:
            raise ValueError(f"request {r.rid}: prompt {s} + budget "
                             f"{budget} + spec_k {self.spec_k} tokens "
                             f"exceed max_len {self.max_len}")
        start, row = 0, []
        if self.paged:
            got = self._acquire_or_preempt(r, toks, s, budget, cx)
            if got is None:
                return False
            row, start = got
            self._slot_pages[b] = list(row)
            self._slot_toks[b] = toks
            self._slot_base[b] = len(r.output) if resume else 0
            r.cached_tokens += start
        r.prefill_tokens += s - start
        if self.chunked_prefill:
            cx.filling[b] = _PrefillProgress(
                r=r, prompt=prompt, toks=toks, row=list(row),
                table=self._table_row(row), next_pos=start, budget=budget,
                resume=resume, cached=start)
            return True
        if start:
            self.state, tok0 = self._extend_slot(
                self.params, self.state, prompt[:, start:], b, row, start,
                budget)
        else:
            self.state, tok0 = self._prefill_slot(
                self.params, self.state, prompt, b, budget,
                row if self.paged else None)
        self._intern_prompt(toks, row)
        if self.speculative:
            self.state = self._prefill_draft(self.draft_params, self.state,
                                             prompt, b)
        self._finish_admit(r, b, tok0, resume, budget, s, start, cx)
        return True

    def _advance_prefill(self, b: int, cx: _ServeCtx) -> None:
        """Run one prefill chunk for the filling slot ``b``: a non-final
        chunk only writes the pool (no host read); the final one goes
        through ``_extend_slot``, which installs the slot, and then, in
        speculative mode, the draft prefills the *full* prompt; its
        first (or continuation) token is the admission's one host
        read."""
        p = cx.filling[b]
        c = self.prefill_chunk_tokens
        s = len(p.toks)
        self.sched_stats["prefill_chunks"] += 1
        if s - p.next_pos > c:
            self.state = self._prefill_chunk(
                self.params, self.state,
                p.prompt[:, p.next_pos:p.next_pos + c], p.table, p.next_pos)
            p.next_pos += c
            return
        del cx.filling[b]
        self.state, tok0 = self._extend_slot(
            self.params, self.state, p.prompt[:, p.next_pos:], b, p.row,
            p.next_pos, p.budget)
        self._intern_prompt(p.toks, p.row)
        if self.speculative:
            self.state = self._prefill_draft(self.draft_params, self.state,
                                             p.prompt, b)
        self._finish_admit(p.r, b, tok0, p.resume, p.budget, s, p.cached,
                           cx)

    def _finish_admit(self, r: Request, b: int, tok0, resume: bool,
                      budget: int, s: int, start: int,
                      cx: _ServeCtx) -> None:
        """Emit the first token (a host read: the true TTFT) or, on a
        resume, the continuation token (``first_token_s`` keeps its
        first stamp); account the speculative prefill work of a prompt
        of ``s`` tokens with ``start`` served from the prefix cache; and
        either retire the request or hand the slot to the decode
        loop."""
        first = int(tok0)
        t_now = cx.now() - cx.t0
        if resume:
            r.output.append(first)
            cx.parked.discard(r.rid)
            self.sched_stats["resumes"] += 1
        else:
            r.first_token_s = t_now
            r.output = [first][: r.max_new_tokens]  # budget 0 -> []
        if self.speculative:
            # the draft prefilled the full prompt, the target only the
            # part the prefix cache did not hold
            r.draft_tokens += s
            r.verify_tokens += s - start
            self.spec_stats["draft_prefill_tokens"] += s
            self.spec_stats["target_prefill_tokens"] += s - start
        if budget <= 1:
            r.done_s = t_now
            cx.done.append(r)
            self._release_slot(b)
        else:
            cx.slots[b] = r
            cx.slot_left[b] = budget - 1

    def _account_rounds(self, r: Request, n_emit, take: int) -> None:
        """Speculative accounting of one slot's chunk from its per-round
        emit counts: a round ran for the slot iff it emitted, and
        emitted its accepted length + 1."""
        k = self.spec_k
        rounds = int((n_emit > 0).sum())
        accepted = int(n_emit.sum()) - rounds
        r.draft_tokens += rounds * (k + 1)
        r.verify_tokens += rounds * (k + 1)
        st = self.spec_stats
        st["rounds"] += rounds
        st["proposed"] += rounds * k
        st["accepted"] += accepted
        st["draft_fwd"] += rounds * (k + 1)
        st["emitted"] += take

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
        up (Offline scenario).  Admission is FIFO by arrival unless a
        ``scheduler`` was given (priority, then deadline slack; with
        preemption a high-priority request the page pool cannot cover
        parks a lower-priority one); in paged mode a request the pool
        cannot cover otherwise waits at the head of the queue until a
        slot retires.  With ``prefill_chunk_tokens > 0`` each loop
        iteration advances every filling prompt by one chunk *and* runs
        one decode chunk, so decoding slots keep emitting while long
        prompts fill.  ``sched_stats`` counts preemptions, resumes and
        the chunks run, per serve.
        """
        counts = collections.Counter(r.rid for r in requests)
        dup = sorted(r for r, c in counts.items() if c > 1)
        if dup:                        # validate before touching state
            raise ValueError(
                f"duplicate request ids in admission queue: {dup} -- "
                f"rids must be unique per serve()")
        self.reset()
        self.spec_stats = self._zero_spec_stats()
        self.prefix_stats = self._zero_prefix_stats()
        self.sched_stats = self._zero_sched_stats()
        self.host_syncs = 0
        self.decode_steps = 0
        self.spec_rounds = 0
        pending = collections.deque(
            sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        cx = _ServeCtx(slots=[None] * self.n_slots,
                       slot_left=[0] * self.n_slots, filling={},
                       ready=collections.deque(), parked=set(), done=[],
                       now=now, t0=now())
        while (pending or cx.ready or cx.filling
               or any(s is not None for s in cx.slots)):
            t = now() - cx.t0
            while pending and (not honor_arrivals
                               or pending[0].arrival_s <= t):
                cx.ready.append(pending.popleft())
            if self.scheduler is not None and len(cx.ready) > 1:
                ordered = self.scheduler.order(cx.ready, t)
                cx.ready.clear()
                cx.ready.extend(ordered)
            # admit arrived requests into free slots (prefill into the
            # slot or, chunked, start the prompt's chunk cursor)
            for b in range(self.n_slots):
                if (cx.slots[b] is not None or b in cx.filling
                        or not cx.ready):
                    continue
                r = cx.ready.popleft()
                if not self._admit_slot(r, b, cx):
                    # defer: a retiring slot will free its pages
                    cx.ready.appendleft(r)
                    if not cx.filling and not any(
                            s is not None for s in cx.slots):
                        raise RuntimeError(
                            f"request {r.rid} needs more KV pages than "
                            f"eviction can ever free (pool of "
                            f"{self.page_pool.n_pages - 1} usable pages)")
                    break
            # chunked prefill: one chunk per filling slot per iteration
            for b in list(cx.filling):
                self._advance_prefill(b, cx)
            if not any(s is not None for s in cx.slots):
                if cx.filling:
                    continue           # keep chunking the prompt(s)
                if not cx.ready:
                    if not pending:
                        break
                    if honor_arrivals:
                        dt = pending[0].arrival_s - (now() - cx.t0)
                        if dt > 0:
                            sleep(dt)
                continue
            # one fused multi-token chunk; a single host copy after it
            if self.speculative:
                self.state, out = self._spec_chunk(
                    self.params, self.draft_params, self.state)
                slot_toks, n_emit = self._split_spec(out.cpu().numpy())
            else:
                self.state, buf = self._decode_chunk(self.params,
                                                     self.state)
                slot_toks = buf.cpu().tolist()
            self.host_syncs += 1
            self.sched_stats["decode_chunks"] += 1
            if cx.filling:             # decode emitted while a prompt
                self.sched_stats["interleaved_chunks"] += 1  # filled
            t_chunk = now() - cx.t0
            for b in range(self.n_slots):
                r = cx.slots[b]
                if r is None:
                    continue
                toks = slot_toks[b]
                take = min(cx.slot_left[b], len(toks))
                r.output.extend(toks[:take])
                cx.slot_left[b] -= take
                if self.speculative:
                    self._account_rounds(r, n_emit[b], take)
                if cx.slot_left[b] == 0:    # retire; slot free to refill
                    r.done_s = t_chunk
                    cx.done.append(r)
                    cx.slots[b] = None
                    self._release_slot(b)
        return cx.done

    tokens_per_request = ServeEngine.tokens_per_request


def attribute_request_energy(requests: list[Request],
                             times_s: np.ndarray,
                             watts: np.ndarray,
                             weight: Optional[Callable[[Request], float]]
                             = None) -> dict[int, float]:
    """Split measured system energy across in-flight requests.

    ``times_s``/``watts``: power samples (seconds since run start -- the
    clock the engine stamps requests on).  Each sample interval's energy
    is divided among the requests in flight (arrival <= t < done) during
    it; idle intervals are dropped.  Fills ``Request.energy_j`` and
    returns {rid: joules}.

    ``weight``: optional per-request weighting, ``r -> float``.  By
    default every live request gets an equal share of an interval's
    energy; with a weight the split is proportional, and the shares of
    an interval still sum to its energy.  Speculative serving uses it to
    bill draft-model forwards to the request that triggered them
    (``r.draft_tokens`` scaled by the draft/target FLOP ratio).
    """
    times_s = np.asarray(times_s, float)
    watts = np.asarray(watts, float)
    per: dict[int, float] = {r.rid: 0.0 for r in requests}
    w_of = ((lambda r: 1.0) if weight is None
            else (lambda r: max(float(weight(r)), 1e-12)))
    spans = [(r.rid, r.arrival_s, r.done_s, w_of(r)) for r in requests
             if r.done_s is not None]
    for i in range(len(times_s) - 1):
        t_lo, t_hi = times_s[i], times_s[i + 1]
        e = watts[i] * (t_hi - t_lo)
        live = [(rid, w) for rid, a, d, w in spans
                if a < t_hi and d > t_lo]
        if not live:
            continue
        w_sum = sum(w for _, w in live)
        for rid, w in live:
            per[rid] += e * w / w_sum
    for r in requests:
        r.energy_j = per.get(r.rid)
    return per
