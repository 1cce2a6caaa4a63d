"""The port's paged KV path on the CPU against the JAX reference: the
page pool and the radix prefix cache (parametrised over both copies),
the paged cache writes and attention blocks, ``verify_step``, and the
paged engine -- greedy, token-identical to the JAX paged engine and to
the port's contiguous engine, with pages handed out in order and
shuffled, with prefix hits and under eviction.

Engine references run the JAX paged engine on its jnp path (reduced
configs default to ``use_pallas=False``: attention gathers through
``paged_view``); the Pallas paged kernels are held against the port's
plain versions in ``test_torch_paged_kernels.py``.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models.param import init_params as jax_init_params
from repro.serving import ContinuousBatchingEngine as JaxCBE
from repro.serving import Request as JaxRequest
from repro.serving.kv_pages import GARBAGE_PAGE as J_GARBAGE
from repro.serving.kv_pages import PagePool as JPagePool
from repro.serving.kv_pages import PoolExhausted as JPoolExhausted
from repro.serving.prefix_cache import PrefixCache as JPrefixCache
from repro_torch import configs as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.param import from_jax, tree_map
from repro_torch.serving import ContinuousBatchingEngine, Request
from repro_torch.serving.kv_pages import GARBAGE_PAGE as T_GARBAGE
from repro_torch.serving.kv_pages import PagePool as TPagePool
from repro_torch.serving.kv_pages import PoolExhausted as TPoolExhausted
from repro_torch.serving.prefix_cache import PrefixCache as TPrefixCache

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
IMPLS = {"jax-package": (JPagePool, JPrefixCache, JPoolExhausted,
                         J_GARBAGE),
         "port": (TPagePool, TPrefixCache, TPoolExhausted, T_GARBAGE)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


# --- PagePool / PrefixCache: the reference's cases, both copies ---------

@pytest.mark.parametrize("impl", IMPLS)
def test_pagepool_basics(impl):
    PagePool, _, PoolExhausted, GARBAGE_PAGE = IMPLS[impl]
    pool = PagePool(6, 8)
    assert pool.free_pages() == 5          # page 0 reserved
    a = pool.alloc(3)
    assert GARBAGE_PAGE not in a and len(set(a)) == 3
    assert pool.used_pages() == 3 and pool.peak_used == 3
    with pytest.raises(PoolExhausted):     # all-or-nothing
        pool.alloc(3)
    assert pool.free_pages() == 2
    pool.ref(a[0])
    pool.unref(a[0])
    assert pool.used_pages() == 3          # still one owner
    pool.unref(a[0])
    assert pool.free_pages() == 3          # last owner freed it
    assert pool.alloc_ops == 6
    with pytest.raises(ValueError):
        pool.unref(a[0])                   # double free
    with pytest.raises(ValueError):
        pool.ref(a[0])                     # ref of a free page
    with pytest.raises(ValueError):
        pool.ref(GARBAGE_PAGE)


@pytest.mark.parametrize("impl", IMPLS)
def test_pagepool_order_is_reset_stable(impl):
    PagePool = IMPLS[impl][0]
    order = [3, 1, 4, 2]
    pool = PagePool(5, 4, order=order)
    assert pool.alloc(4) == order
    pool.reset()
    assert pool.alloc(2) == order[:2] and pool.peak_used == 2
    with pytest.raises(ValueError):
        PagePool(5, 4, order=[0, 1, 2, 3])   # page 0 is reserved


@pytest.mark.parametrize("impl", IMPLS)
def test_prefix_cache_lookup_never_covers_whole_prompt(impl):
    PagePool, PrefixCache = IMPLS[impl][:2]
    pool = PagePool(16, 4)
    cache = PrefixCache(pool, 4)
    toks = tuple(range(8))                 # exactly 2 full pages
    cache.insert(toks, pool.alloc(2))
    assert len(cache.lookup(toks)) == 1    # capped at (len-1)//ps
    assert len(cache.lookup(toks + (9,))) == 2


@pytest.mark.parametrize("impl", IMPLS)
def test_prefix_cache_interns_full_pages_only(impl):
    PagePool, PrefixCache = IMPLS[impl][:2]
    pool = PagePool(16, 4)
    cache = PrefixCache(pool, 4)
    pages = pool.alloc(3)
    assert cache.insert(tuple(range(10)), pages) == 2
    assert cache.cached_tokens == 8
    assert pool.refcount[pages[0]] == 2    # the cache's reference
    assert pool.refcount[pages[2]] == 1    # partial page not interned


@pytest.mark.parametrize("impl", IMPLS)
def test_prefix_cache_eviction_skips_referenced_pages(impl):
    PagePool, PrefixCache = IMPLS[impl][:2]
    pool = PagePool(16, 4)
    cache = PrefixCache(pool, 4)
    live = pool.alloc(2)
    cache.insert(tuple(range(8)), live)    # refcount 2: slot + cache
    dead = pool.alloc(2)
    cache.insert(tuple(range(100, 108)), dead)
    for p in dead:
        pool.unref(p)                      # cache is the only owner
    assert cache.evict(4) == 2             # only the cache-only pages
    assert all(pool.refcount[p] == 2 for p in live)
    assert cache.lookup(tuple(range(8)) + (9,)) == live


# --- paged cache writes and attention blocks ----------------------------

def test_paged_and_window_writes_match_reference():
    """A 3-row window that crosses a page boundary, one whose rows run
    off the table (clamped to the slot's last entry), and the
    contiguous window write at per-slot and scalar starts (in range:
    past the last row the port clamps where the reference drops, see
    ROADMAP §C)."""
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((7, 4, 2, 8)).astype(np.float32)
    new = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    pages = np.array([[3, 5, 1], [6, 2, 4]], np.int32)
    pos = np.array([3, 10], np.int32)       # rows 3-5; 10, 11, 12 -> clamp
    want = jax.jit(JL.paged_insert_window)(
        jnp.asarray(pool), jnp.asarray(new), jnp.asarray(pages),
        jnp.asarray(pos))
    got = TL.paged_insert_window(torch.from_numpy(pool.copy()),
                                 torch.from_numpy(new),
                                 torch.from_numpy(pages),
                                 torch.from_numpy(pos))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    cache = rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
    for p in (np.array([0, 6], np.int32), np.int32(4)):
        want = jax.jit(JL.cache_update_window)(
            jnp.asarray(cache), jnp.asarray(new), jnp.asarray(p))
        got = TL.cache_update_window(torch.from_numpy(cache.copy()),
                                     torch.from_numpy(new),
                                     torch.tensor(p))
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def _models(arch="qwen3-1.7b"):
    """The same reduced config, model and weights in both packages."""
    jc = jcfg.reduce_config(jcfg.get_config(arch))
    assert not jc.use_pallas                # the reference's jnp path
    jm = jax_build_model(jc)
    jp = jax_init_params(jm.param_defs(), jax.random.PRNGKey(0))
    tm = build_model(tcfg.reduce_config(tcfg.get_config(arch)), "cpu")
    return jm, jp, tm, from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def models():
    return _models()


def test_gqa_paged_blocks_match_reference(models):
    """One layer's paged decode and paged verify (a window across a
    page boundary) on a shuffled pool: outputs and written pools."""
    jm, jp, tm, tp = models
    cfg = jm.cfg
    attn = tree_map(lambda a: np.array(a[0]), jp["blocks"]["attn"])
    rng = np.random.default_rng(2)
    ps, nb, b = 4, 3, 2
    shape = (b * nb + 1, ps, cfg.n_kv_heads, cfg.head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    pages = (rng.permutation(b * nb) + 1).reshape(b, nb).astype(np.int32)
    for t, pos in ((1, np.array([5, 0], np.int32)),
                   (3, np.array([2, 7], np.int32))):
        x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
        args = (jnp.asarray(x), tree_map(jnp.asarray, attn),
                {"k": jnp.asarray(kp), "v": jnp.asarray(vp)},
                jnp.asarray(pos), jnp.asarray(pages))
        tcache = {"k": torch.from_numpy(kp.copy()),
                  "v": torch.from_numpy(vp.copy())}
        targs = (torch.from_numpy(x), tree_map(torch.from_numpy, attn),
                 tm.cfg, tcache, torch.from_numpy(pos),
                 torch.from_numpy(pages))
        fn = JL.gqa_decode_paged if t == 1 else JL.gqa_verify_paged
        want, wc = jax.jit(lambda x, p, c, pos, pg: fn(x, p, cfg, c, pos,
                                                      pg))(*args)
        got = (TL.gqa_decode_paged if t == 1 else TL.gqa_verify_paged)(
            *targs)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tcache[name]), _np(wc[name]),
                                       **TOL)


def test_verify_step_matches_reference_and_needs_pages(models):
    """Model-level paged verify: logits, the unchanged ``pos``, and the
    written pools; without a page table it is refused."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(3)
    pos, pages = np.array([3, 9], np.int32), np.array(
        [[2, 4, 6], [5, 1, 3]], np.int32)
    toks = rng.integers(0, jm.cfg.vocab_size, (2, 4))
    jc = jm.init_paged_cache(2, 7, 4, 3)
    jc = dict(jc, pos=jnp.asarray(pos), pages=jnp.asarray(pages))
    want, wc = jax.jit(jm.verify_step)(jp, jc, jnp.asarray(toks))
    tc = tm.init_paged_cache(2, 7, 4, 3)
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), tc) == tree_map(
        lambda s: (s[0], s[1]), tm.paged_cache_specs(2, 7, 4, 3))
    tc.update(pos=torch.from_numpy(pos), pages=torch.from_numpy(pages))
    got, gc = tm.verify_step(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert torch.equal(gc["pos"], torch.from_numpy(pos))
    np.testing.assert_allclose(_np(gc["layers"]["blocks"]["k"]),
                               _np(wc["layers"]["blocks"]["k"]), **TOL)
    with pytest.raises(NotImplementedError, match="ROADMAP §A.7"):
        tm.verify_step(tp, tm.init_cache(2, 12, per_slot_pos=True),
                       torch.from_numpy(toks))


# --- the paged engine ---------------------------------------------------

def _mixed(cls):
    return [cls(rid=i, prompt=np.arange(8) + 3 * i, max_new_tokens=b)
            for i, b in enumerate([4, 7, 3, 6, 0])]


def _shared(cls):
    shared = list(np.arange(16) + 100)
    return [cls(rid=i, prompt=np.asarray(shared + [200 + i, 201 + i]),
                max_new_tokens=6) for i in range(4)]


def _rotating(cls):
    return [cls(rid=i, prompt=np.arange(16) + (i % 3), max_new_tokens=4)
            for i in range(9)]


def _serve(eng, requests):
    done = eng.serve(copy.deepcopy(requests), honor_arrivals=False)
    return {r.rid: r for r in done}


def _port_engine(tm, tp, order_seed=None, **kw):
    eng = ContinuousBatchingEngine(tm, tp, max_len=48, n_slots=2,
                                   chunk_steps=3, device="cpu", **kw)
    if order_seed is not None:
        order = list(np.random.default_rng(order_seed).permutation(
            np.arange(1, eng.n_pages)))
        eng.page_pool = TPagePool(eng.n_pages, eng.page_size, order=order)
        if eng.prefix_caching:
            eng.prefix_cache = TPrefixCache(eng.page_pool, eng.page_size)
        eng.reset()
    return eng


@pytest.fixture(scope="module")
def reference_runs(models):
    """The JAX paged engine on the three request sets, run once."""
    jm, jp, _, _ = models
    runs = {}
    for name, reqs, kw in (
            ("mixed", _mixed, {}),
            ("shared", _shared, dict(prefix_caching=True)),
            ("evict", _rotating, dict(prefix_caching=True, kv_pages=10))):
        eng = JaxCBE(jm, jp, max_len=48, n_slots=2, chunk_steps=3,
                     kv_page_size=8, **kw)
        runs[name] = (_serve(eng, reqs(JaxRequest)), dict(eng.prefix_stats))
    return runs


@pytest.mark.parametrize("order_seed", [None, 3])
def test_paged_engine_token_identical_to_reference(models, reference_runs,
                                                   order_seed):
    """Mixed budgets incl. zero, 5 requests through 2 slots: the same
    tokens as the JAX paged engine and the port's contiguous engine,
    pages in order and shuffled; every page returns to the pool."""
    _, _, tm, tp = models
    want = {rid: r.output for rid, r in reference_runs["mixed"][0].items()}
    eng = _port_engine(tm, tp, order_seed, kv_page_size=8)
    got = _serve(eng, _mixed(Request))
    assert {rid: r.output for rid, r in got.items()} == want
    assert eng.page_pool.used_pages() == 0
    assert eng.decode_steps == eng.host_syncs * eng.chunk_steps
    cont = _serve(_port_engine(tm, tp), _mixed(Request))
    assert {rid: r.output for rid, r in cont.items()} == want


@pytest.mark.parametrize("order_seed", [None, 5])
def test_prefix_hits_token_identical_with_reference_accounting(
        models, reference_runs, order_seed):
    """Four prompts sharing a 16-token prefix: three hits compute only
    their 2-token suffix, emit the tokens of a cold run, and match the
    reference's ``prefix_stats`` and per-request token accounting."""
    _, _, tm, tp = models
    ref, ref_stats = reference_runs["shared"]
    eng = _port_engine(tm, tp, order_seed, kv_page_size=8,
                       prefix_caching=True)
    got = _serve(eng, _shared(Request))
    assert {rid: r.output for rid, r in got.items()} == \
        {rid: r.output for rid, r in ref.items()}
    assert eng.prefix_stats == ref_stats
    assert ref_stats["hits"] == 3
    for rid, r in got.items():
        assert (r.cached_tokens, r.prefill_tokens) == \
            (ref[rid].cached_tokens, ref[rid].prefill_tokens)
    cold = _serve(_port_engine(tm, tp, kv_page_size=8), _shared(Request))
    assert {rid: r.output for rid, r in cold.items()} == \
        {rid: r.output for rid, r in got.items()}
    assert all(r.cached_tokens == 0 for r in cold.values())
    # only the cache's own references remain once every slot retired
    assert eng.page_pool.used_pages() == eng.prefix_cache.n_nodes


def test_eviction_under_a_small_pool_matches_reference(models,
                                                       reference_runs):
    """9 usable pages for 2 slots of 3 pages plus interned prefixes of
    three rotating prompts: admission has to evict LRU cache-only
    pages; every request completes with the reference's tokens."""
    _, _, tm, tp = models
    ref, ref_stats = reference_runs["evict"]
    eng = _port_engine(tm, tp, kv_page_size=8, prefix_caching=True,
                       kv_pages=10)
    got = _serve(eng, _rotating(Request))
    assert sorted(got) == list(range(9))
    assert {rid: r.output for rid, r in got.items()} == \
        {rid: r.output for rid, r in ref.items()}
    assert eng.prefix_stats == ref_stats
    assert ref_stats["evicted_pages"] > 0
    assert eng.page_pool.used_pages() == eng.prefix_cache.n_nodes


def test_paged_engine_defers_and_rejects_on_the_page_pool(models):
    """A request that can never get its pages raises instead of
    spinning; a pool that cannot hold one full slot is refused."""
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="kv_pages"):
        _port_engine(tm, tp, kv_page_size=8, kv_pages=6)
    with pytest.raises(ValueError, match="multiple"):
        _port_engine(tm, tp, kv_page_size=7)
    with pytest.raises(ValueError, match="kv_page_size"):
        _port_engine(tm, tp, prefix_caching=True)
    eng = _port_engine(tm, tp, kv_page_size=8, kv_pages=7)
    eng.page_pool.alloc(5)                  # pinned outside the engine
    eng.reset = lambda: None                # keep the pins across serve
    with pytest.raises(RuntimeError, match="KV pages"):
        eng.serve([Request(rid=0, prompt=np.arange(8), max_new_tokens=8)],
                  honor_arrivals=False)


def test_launcher_runs_paged_with_prefix_cache_on_cpu(capsys):
    m = tserve.main(["--arch", "qwen3-1.7b", "--reduce", "--device", "cpu",
                     "--kv-page-size", "8", "--prefix-cache", "--qps", "50",
                     "--min-duration", "0.1", "--new-tokens", "4",
                     "--slots", "2"])
    assert m["requests"] >= 1 and m["tokens"] == 4 * m["requests"]
    out = capsys.readouterr().out
    assert "prefix cache:" in out and "paged_decode_attention" in out


@pytest.mark.parametrize("flag", [["--prefix-cache"],
                                  ["--kv-page-size", "8", "--engine",
                                   "fixed"]])
def test_launcher_refuses_paged_flags_it_cannot_honour(flag, capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen3-1.7b", "--reduce", "--device", "cpu",
                     *flag])
    assert "--" in capsys.readouterr().err
