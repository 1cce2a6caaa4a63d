"""Radix-style shared-prefix cache over the KV page pool (PyTorch port;
a copy of the reference's ``serving/prefix_cache.py``).

Prompts are split into page-sized token blocks and interned in a radix
tree: one node per block, holding the physical page whose KV rows were
prefilled for exactly those tokens at those absolute positions.  K/V
are stored post-RoPE at absolute positions, so two prompts that share
a token prefix share *bit-identical* page contents — a lookup hit can
reuse the page directly (refcount bump) and skip its prefill compute.
That skipped compute is the benchmark headline: J saved per cached
token.

Ownership protocol (see ``kv_pages.PagePool``): the cache holds one
reference on every interned page, and each live slot using the page
holds one more.  LRU eviction only considers leaf nodes whose page has
``refcount == 1`` — i.e. the cache is the sole owner — so a page a
live slot is still reading can never be freed underneath it.

Only *full* prompt blocks are interned, and ``lookup`` matches at most
``(len(prompt) - 1) // page_size`` blocks: the admission path always
recomputes at least the final prompt token, because it needs that
token's logits to seed decoding.
"""
from __future__ import annotations

from typing import Iterator, Sequence

from repro_torch.serving.kv_pages import PagePool


class _Node:
    __slots__ = ("page", "children", "last_used")

    def __init__(self, page: int, clock: int):
        self.page = page
        self.children: dict[tuple, "_Node"] = {}
        self.last_used = clock


class PrefixCache:
    """Radix tree over full prompt pages: lookup returns the pages of
    the longest interned block-prefix (each holding a cache ref in the
    ``PagePool``), insert interns a served prompt's full pages, and LRU
    eviction under pool pressure frees only pages whose sole owner is
    the cache."""

    def __init__(self, pool: PagePool, page_size: int):
        if page_size != pool.page_size:
            raise ValueError("page_size must match the pool's")
        self.pool = pool
        self.page_size = page_size
        self.reset()

    def reset(self) -> None:
        """Clear the tree (the pool is reset separately by the engine)."""
        self._root: dict[tuple, _Node] = {}
        self._clock = 0
        self.n_nodes = 0

    @property
    def cached_tokens(self) -> int:
        """Prompt tokens currently interned (nodes x page size)."""
        return self.n_nodes * self.page_size

    # -- lookup / insert --------------------------------------------------
    def lookup(self, tokens: Sequence[int]) -> list[int]:
        """Pages of the longest interned block-prefix of ``tokens``.

        Returns page ids only — the caller must ``pool.ref`` each one
        before anything that might trigger eviction, or the hit pages
        could be evicted (and reallocated) out from under it.
        """
        ps = self.page_size
        max_blocks = max(0, (len(tokens) - 1) // ps)
        self._clock += 1
        pages: list[int] = []
        children = self._root
        for i in range(max_blocks):
            node = children.get(tuple(tokens[i * ps:(i + 1) * ps]))
            if node is None:
                break
            node.last_used = self._clock
            pages.append(node.page)
            children = node.children
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> int:
        """Intern the full blocks of ``tokens`` mapped to ``pages``
        (one page per block, the slot's own page-table prefix).  New
        nodes take a cache reference on their page; blocks already
        interned are left untouched (the caller got their pages from
        ``lookup``, so the ids already agree).  Returns the number of
        newly interned blocks."""
        ps = self.page_size
        n = min(len(tokens) // ps, len(pages))
        self._clock += 1
        children = self._root
        added = 0
        for i in range(n):
            blk = tuple(tokens[i * ps:(i + 1) * ps])
            node = children.get(blk)
            if node is None:
                node = _Node(pages[i], self._clock)
                self.pool.ref(pages[i])
                children[blk] = node
                self.n_nodes += 1
                added += 1
            node.last_used = self._clock
            children = node.children
        return added

    # -- eviction ---------------------------------------------------------
    def _leaves(self) -> Iterator[tuple[int, dict, tuple, _Node]]:
        def walk(children: dict):
            for key, node in children.items():
                if node.children:
                    yield from walk(node.children)
                else:
                    yield (node.last_used, children, key, node)
        yield from walk(self._root)

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pages, least-recently-used leaves
        first, skipping any page a live slot still references.  An
        evicted leaf can expose its parent as the next candidate, so
        the sweep repeats while it makes progress.  Returns the number
        of pages actually freed."""
        freed = 0
        progress = True
        while freed < n_pages and progress:
            progress = False
            for _, parent, key, node in sorted(self._leaves(),
                                               key=lambda c: c[0]):
                if freed >= n_pages:
                    break
                if self.pool.refcount[node.page] != 1:
                    continue          # a live slot still reads this page
                del parent[key]
                self.pool.unref(node.page)
                self.n_nodes -= 1
                freed += 1
                progress = True
        return freed
