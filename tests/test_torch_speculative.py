"""The port's speculative decoding on the CPU against the JAX reference:
the contiguous verify block and ``LM.verify_step``, the acceptance math
(``greedy_verify`` exactly, ``speculative_sample`` by distribution),
the draft constructors, and the speculative engine -- greedy,
token-identical to the JAX speculative engine and to the port's plain
engine with equal ``spec_stats``, contiguous and paged (windows across
page boundaries, pages in order and shuffled, prefix hits), with a
truncated and an adversarial random draft -- plus the sampled serve,
weighted energy attribution, the launcher, and a guard that the
speculative chunk makes no host read.

References run the JAX package on its jnp path (reduced configs default
to ``use_pallas=False``); the Pallas verify kernel is held against the
port's plain version in ``test_torch_verify_kernel.py``.  Tolerance:
float32 1e-4 (tests/test_kernels.py:16).
"""
import copy
import dataclasses

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
from repro.serving import attribute_request_energy as jax_attribute
from repro.serving import damp_upper_layers as jax_damp
from repro.serving import greedy_verify as jax_greedy_verify
from repro.serving import truncate_draft as jax_truncate
from repro_torch import configs as tcfg
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models.param import from_jax, tree_leaves, tree_map
from repro_torch.serving import (ContinuousBatchingEngine, PagePool,
                                 Request, attribute_request_energy,
                                 damp_upper_layers, greedy_verify,
                                 speculative_sample, truncate_draft)

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
BUDGETS = [5, 9, 3, 7, 1, 0]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


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


def _prefilled(cache, lens, splice):
    """``cache`` with slot b prefilled to ragged depth lens[b]."""
    for b, n in enumerate(lens):
        cache = splice(cache, b, (np.arange(n) + 7 * b)[None].astype(
            np.int32))
    return cache


# --- the verify block and LM.verify_step --------------------------------

def test_gqa_verify_matches_reference(models):
    """One layer's contiguous verify: a 3-token window at per-slot and
    scalar starts, outputs and written caches."""
    jm, jp, tm, _ = models
    cfg = jm.cfg
    attn = tree_map(lambda a: np.array(a[0]), jp["blocks"]["attn"])
    rng = np.random.default_rng(1)
    shape = (2, 12, cfg.n_kv_heads, cfg.head_dim)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    for pos in (np.array([3, 9], np.int32), np.int32(4)):
        want, wc = jax.jit(lambda x, p, c, pos: JL.gqa_verify(
            x, p, cfg, c, pos))(jnp.asarray(x), tree_map(jnp.asarray, attn),
                                {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                                jnp.asarray(pos))
        tcache = {"k": torch.from_numpy(kc.copy()),
                  "v": torch.from_numpy(vc.copy())}
        got = TL.gqa_verify(torch.from_numpy(x),
                            tree_map(torch.from_numpy, attn), tm.cfg,
                            tcache, torch.tensor(pos))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tcache[name]), _np(wc[name]),
                                       **TOL)


def test_verify_step_matches_reference_and_sequential_decode(models):
    """Contiguous ``verify_step`` at ragged slot depths: logits and
    cache equal the reference's, ``pos`` comes back unchanged, and T
    sequential ``decode_step``s give the same logits and cache."""
    jm, jp, tm, tp = models
    lens, s = (8, 5), 24
    toks = np.array([[3, 9, 1, 4], [2, 2, 8, 5]], np.int32)

    def jsplice(cache, b, prompt):
        _, one = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, max_len=s)
        cache["layers"] = jax.tree.map(
            lambda big, small: big.at[:, b:b + 1].set(small),
            cache["layers"], one["layers"])
        cache["pos"] = cache["pos"].at[b].set(one["pos"])
        return cache

    def tsplice(cache, b, prompt):
        row = {"blocks": {k: t[:, b:b + 1] for k, t in
                          cache["layers"]["blocks"].items()}}
        _, one = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)},
                            max_len=s, cache=row)
        cache["pos"][b] = one["pos"]
        return cache

    jc = _prefilled(jm.init_cache(2, s, per_slot_pos=True), lens, jsplice)
    want, wc = jax.jit(jm.verify_step)(jp, jc, jnp.asarray(toks))
    tc = _prefilled(tm.init_cache(2, s, per_slot_pos=True), lens, tsplice)
    seq = tree_map(torch.clone, tc)
    got, gc = tm.verify_step(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert torch.equal(gc["pos"], torch.tensor(lens, dtype=torch.int32))
    np.testing.assert_allclose(_np(gc["layers"]["blocks"]["k"]),
                               _np(wc["layers"]["blocks"]["k"]), **TOL)
    steps = []
    for t in range(toks.shape[1]):
        lg, seq = tm.decode_step(tp, seq, torch.from_numpy(toks[:, t:t + 1]))
        steps.append(lg[:, 0])
    np.testing.assert_allclose(_np(got), _np(torch.stack(steps, 1)), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(gc["layers"]["blocks"][name]),
                                   _np(seq["layers"]["blocks"][name]),
                                   **TOL)


# --- acceptance math ----------------------------------------------------

def test_greedy_verify_matches_reference():
    """Random windows with drafts that match the target for a random
    prefix (every accepted length 0..k occurs), and the reference's
    hand-made case."""
    rng = np.random.default_rng(4)
    b, k, v = 12, 4, 16
    logits = rng.standard_normal((b, k + 1, v)).astype(np.float32)
    draft = np.argmax(logits[:, :k], -1).astype(np.int32)
    cut = np.arange(b) % (k + 1)
    for i in range(b):
        draft[i, cut[i]:] = (draft[i, cut[i]:] + 1 + i) % v
    acc, out = greedy_verify(torch.from_numpy(logits),
                             torch.from_numpy(draft))
    jacc, jout = jax_greedy_verify(jnp.asarray(logits), jnp.asarray(draft))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert acc.tolist() == cut.tolist()
    tl = torch.zeros((1, 3, 5))
    tl[0, 0, 2] = tl[0, 1, 4] = tl[0, 2, 1] = 5.0
    for d, want in (([2, 0], 1), ([2, 4], 2), ([0, 4], 0)):
        acc, out = greedy_verify(tl, torch.tensor([d]))
        assert int(acc[0]) == want and out[0].tolist() == [2, 4, 1]


def test_speculative_sampling_preserves_target_distribution():
    """Golden chi-squared test (the reference's): the first emitted
    token of a round is distributed per the temperature-scaled target,
    whatever the draft proposes.  40,000 rounds in one batch."""
    v, k, temp, n = 8, 2, 0.9, 40_000
    rng = np.random.default_rng(0)
    tl = (rng.standard_normal((1, k + 1, v)) * 1.5).astype(np.float32)
    dl = (rng.standard_normal((1, k, v)) * 1.5).astype(np.float32)
    q = np.exp(dl[0] / temp)
    q /= q.sum(-1, keepdims=True)
    draft = np.stack([rng.choice(v, n, p=q[j]) for j in range(k)], 1)
    gen = torch.Generator().manual_seed(42)
    _, out = speculative_sample(
        gen, torch.from_numpy(tl).expand(n, -1, -1),
        torch.from_numpy(dl).expand(n, -1, -1), torch.from_numpy(draft),
        temp)
    p0 = np.exp(tl[0, 0] / temp)
    p0 /= p0.sum()
    counts = np.bincount(out[:, 0].numpy(), minlength=v)
    expected = p0 * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 24.32, (chi2, counts.tolist())    # df 7, p = 0.001


def test_speculative_sample_full_accept_emits_bonus():
    """With p == q every draft token is accepted and the bonus token is
    drawn from the target's last position (here deterministic)."""
    logits = torch.log(torch.tensor([[0.7, 0.1, 0.1, 0.1],
                                     [0.1, 0.7, 0.1, 0.1],
                                     [0.0, 0.0, 1.0, 0.0]]) + 1e-9)[None]
    acc, out = speculative_sample(torch.Generator().manual_seed(3), logits,
                                  logits[:, :2], torch.tensor([[0, 1]]),
                                  1.0)
    assert int(acc[0]) == 2 and out[0].tolist() == [0, 1, 2]


# --- draft constructors -------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_draft_constructors_match_reference(models, dtype):
    """``truncate_draft`` and ``damp_upper_layers`` of ``from_jax(p)``
    equal ``from_jax`` of the reference's results, bit for bit; the
    draft's tensors are views of the target's."""
    jm, jp, tm, _ = models
    jp = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), jp)
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jdm, jdp = jax_truncate(jm, jp, 2)
    dm, dp = truncate_draft(tm, tp, 2)
    assert (dm.cfg.n_layers, dm.cfg.name) == (jdm.cfg.n_layers,
                                              jdm.cfg.name)
    assert (dm.device, dm.kernels) == (tm.device, tm.kernels)
    want = from_jax(jax.tree.map(np.asarray, jdp), "cpu")
    for a, b in zip(tree_leaves(dp), tree_leaves(want), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert dp["blocks"]["attn"]["wq"].data_ptr() == \
        tp["blocks"]["attn"]["wq"].data_ptr()
    assert dp["lm_head"] is tp["lm_head"]
    with pytest.raises(ValueError, match="n_layers"):
        truncate_draft(tm, tp, 0)
    for n_keep, damp in ((1, 0.001), (2, 0.2)):
        got = damp_upper_layers(tp, n_keep, damp)
        want = from_jax(jax.tree.map(np.asarray, jax_damp(jp, n_keep, damp)),
                        "cpu")
        for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)


# --- the speculative engine ---------------------------------------------

def _requests(cls, budgets=BUDGETS, prompt_len=10, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 512, prompt_len),
                max_new_tokens=b) for i, b in enumerate(budgets)]


def _serve(eng, requests):
    done = eng.serve(copy.deepcopy(requests), honor_arrivals=False)
    return {r.rid: r for r in done}


def _outputs(done):
    return {rid: r.output for rid, r in done.items()}


def _counts(done):
    return {rid: (r.draft_tokens, r.verify_tokens, r.prefill_tokens,
                  r.cached_tokens) for rid, r in done.items()}


def _spec_pair(models, jdraft=None, tdraft=None, **kw):
    """The JAX and the port speculative engines on the same weights and
    draft (default: each package's 2-layer truncated draft)."""
    jm, jp, tm, tp = models
    jdm, jdp = jdraft or jax_truncate(jm, jp, 2)
    tdm, tdp = tdraft or truncate_draft(tm, tp, 2)
    kw = dict(dict(max_len=64, n_slots=3, chunk_steps=2, spec_k=4), **kw)
    return (JaxCBE(jm, jp, draft_model=jdm, draft_params=jdp, **kw),
            ContinuousBatchingEngine(tm, tp, draft_model=tdm,
                                     draft_params=tdp, device="cpu", **kw))


@pytest.fixture(scope="module")
def plain_run(models):
    """The port's plain contiguous engine on ``BUDGETS``."""
    _, _, tm, tp = models
    eng = ContinuousBatchingEngine(tm, tp, max_len=64, n_slots=3,
                                   chunk_steps=4, device="cpu")
    return _outputs(_serve(eng, _requests(Request)))


@pytest.mark.parametrize("k", [2, 4])
def test_speculative_engine_token_identical(models, plain_run, k):
    """Mid-flight refills, ragged budgets incl. 1 and 0: the same tokens
    as the JAX speculative engine and as plain greedy decode, the same
    ``spec_stats`` and per-request draft/verify counts, one host copy
    per chunk of ``chunk_steps`` rounds."""
    jeng, teng = _spec_pair(models, spec_k=k)
    want = _serve(jeng, _requests(JaxRequest))
    got = _serve(teng, _requests(Request))
    assert _outputs(got) == _outputs(want) == plain_run
    assert teng.spec_stats == jeng.spec_stats
    assert teng.spec_stats["proposed"] > 0
    assert _counts(got) == _counts(want)
    assert all(r.draft_tokens >= 10 for r in got.values())
    assert teng.host_syncs * teng.chunk_steps == teng.spec_rounds
    assert teng.decode_steps == 0


def test_speculative_parity_with_adversarial_random_draft(models, plain_run):
    """Verification holds the output for any draft, even a random
    2-layer model that almost never agrees with the target."""
    jm, jp, tm, _ = models
    jdm = jax_build_model(dataclasses.replace(jm.cfg, n_layers=2))
    jdp = jax_init_params(jdm.param_defs(), jax.random.PRNGKey(99))
    tdm = build_model(dataclasses.replace(tm.cfg, n_layers=2), "cpu")
    tdp = from_jax(jax.tree.map(np.asarray, jdp), "cpu")
    jeng, teng = _spec_pair(models, (jdm, jdp), (tdm, tdp))
    want = _serve(jeng, _requests(JaxRequest))
    got = _serve(teng, _requests(Request))
    assert _outputs(got) == _outputs(want) == plain_run
    assert teng.spec_stats == jeng.spec_stats
    assert teng.acceptance_rate() < 0.5


def test_high_acceptance_pair_accepts_almost_everything(models):
    """The damped-target + truncated-draft construction of the
    speculative benchmark (and of ``chip_smoke.py`` phase 8) really is
    a high-acceptance pair, and still emits plain greedy's tokens."""
    _, _, tm, tp = models
    damped = damp_upper_layers(tp, 1, 0.001)
    dm, dp = truncate_draft(tm, damped, 1)
    reqs = _requests(Request, [20, 20])
    eng = ContinuousBatchingEngine(tm, damped, max_len=64, n_slots=2,
                                   chunk_steps=2, device="cpu",
                                   draft_model=dm, draft_params=dp, spec_k=4)
    got = _outputs(_serve(eng, reqs))
    assert eng.acceptance_rate() > 0.8
    plain = ContinuousBatchingEngine(tm, damped, max_len=64, n_slots=2,
                                     chunk_steps=4, device="cpu")
    assert got == _outputs(_serve(plain, reqs))


def _shuffle_pages(eng, seed):
    order = list(np.random.default_rng(seed).permutation(
        np.arange(1, eng.n_pages)))
    eng.page_pool = PagePool(eng.n_pages, eng.page_size, order=order)
    eng.reset()


@pytest.mark.parametrize("order_seed", [None, 3])
def test_paged_speculative_rolls_back_across_page_boundaries(models,
                                                             order_seed):
    """Page size 4 under 5-token windows: every verify window spans a
    page boundary, and about half the drafts are rejected (layers past
    2 damped to 0.2), so rejected rows roll back across pages.  Tokens
    and ``spec_stats`` equal the JAX paged speculative engine's and the
    port's contiguous speculative engine's; every page returns."""
    jm, jp, tm, tp = models
    jd = jax_damp(jp, 2, 0.2)
    td = damp_upper_layers(tp, 2, 0.2)
    pair = ((jm, jd, *jax_truncate(jm, jd, 2)),
            (tm, td, *truncate_draft(tm, td, 2)))
    kw = dict(max_len=64, n_slots=3, chunk_steps=2, spec_k=4)
    jeng = JaxCBE(pair[0][0], pair[0][1], draft_model=pair[0][2],
                  draft_params=pair[0][3], kv_page_size=4, **kw)
    want = _serve(jeng, _requests(JaxRequest))

    def port(**more):
        return ContinuousBatchingEngine(
            pair[1][0], pair[1][1], draft_model=pair[1][2],
            draft_params=pair[1][3], device="cpu", **kw, **more)

    eng = port(kv_page_size=4)
    if order_seed is not None:
        _shuffle_pages(eng, order_seed)
    got = _serve(eng, _requests(Request))
    assert _outputs(got) == _outputs(want)
    assert eng.spec_stats == jeng.spec_stats
    assert 0.2 < eng.acceptance_rate() < 0.8
    assert eng.page_pool.used_pages() == 0
    assert _outputs(_serve(port(), _requests(Request))) == _outputs(got)


def test_paged_speculative_prefix_hits_match_reference(models):
    """Four prompts behind one 16-token prefix: hits extend the target
    through paged verify while the draft prefills the full prompt;
    tokens, ``prefix_stats``, ``spec_stats`` (target prefill tokens
    below the draft's) and per-request counts equal the reference's."""
    shared = list(np.arange(16) + 100)

    def reqs(cls):
        return [cls(rid=i, prompt=np.asarray(shared + [200 + i, 201 + i]),
                    max_new_tokens=6) for i in range(4)]

    jeng, teng = _spec_pair(models, kv_page_size=8, prefix_caching=True,
                            n_slots=2)
    want = _serve(jeng, reqs(JaxRequest))
    got = _serve(teng, reqs(Request))
    assert _outputs(got) == _outputs(want)
    assert teng.prefix_stats == jeng.prefix_stats
    assert teng.prefix_stats["hits"] == 3
    assert teng.spec_stats == jeng.spec_stats
    st = teng.spec_stats
    assert st["target_prefill_tokens"] < st["draft_prefill_tokens"]
    assert _counts(got) == _counts(want)


def test_sampled_speculative_serve_is_well_formed(models):
    """temperature > 0: budgets are honoured, every sampled token is in
    the vocabulary (the padded tail is masked), and a second serve with
    the same seed reproduces the outputs."""
    _, _, tm, tp = models
    dm, dp = truncate_draft(tm, tp, 2)

    def run():
        eng = ContinuousBatchingEngine(
            tm, tp, max_len=64, n_slots=2, chunk_steps=2, device="cpu",
            draft_model=dm, draft_params=dp, spec_k=3, temperature=0.8,
            spec_seed=5)
        return _serve(eng, _requests(Request, [6, 4, 5]))

    done = run()
    assert sorted(len(r.output) for r in done.values()) == [4, 5, 6]
    for r in done.values():
        # the first token is the prefill's greedy argmax (over the
        # padded vocabulary, as in the plain engine); the rest are drawn
        assert all(0 <= t < tm.cfg.vocab_size for t in r.output[1:])
    assert _outputs(run()) == _outputs(done)


def test_engine_refuses_bad_speculative_setups(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="draft_model"):
        ContinuousBatchingEngine(tm, tp, device="cpu", spec_k=4)
    other = build_model(dataclasses.replace(tm.cfg, vocab_size=256), "cpu")
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatchingEngine(tm, tp, device="cpu", spec_k=4,
                                 draft_model=other, draft_params={})
    dm, dp = truncate_draft(tm, tp, 2)
    eng = ContinuousBatchingEngine(tm, tp, max_len=16, n_slots=1,
                                   device="cpu", spec_k=4, draft_model=dm,
                                   draft_params=dp)
    with pytest.raises(ValueError, match="spec_k"):     # 8 + 5 + 4 > 16
        eng.serve([Request(rid=0, prompt=np.arange(8), max_new_tokens=5)],
                  honor_arrivals=False)


class _HostRead(AssertionError):
    pass


@pytest.mark.parametrize("chunk", ["_spec_chunk", "_decode_chunk"])
def test_chunk_makes_no_host_read(models, monkeypatch, chunk):
    """Inside a chunk nothing reads a tensor back to the host: every
    tensor-to-Python conversion raises while the chunk runs, and the
    serve still completes with plain greedy's tokens (on a card each of
    them would be a device sync per round)."""
    _, _, tm, tp = models
    dm, dp = truncate_draft(tm, tp, 2)
    spec = dict(draft_model=dm, draft_params=dp, spec_k=4) \
        if chunk == "_spec_chunk" else {}
    eng = ContinuousBatchingEngine(tm, tp, max_len=64, n_slots=3,
                                   chunk_steps=2, device="cpu", **spec)
    inner = getattr(eng, chunk)
    names = ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
             "__float__", "__index__")

    def raiser(name):
        def f(*args, **kw):
            raise _HostRead(f"Tensor.{name} inside {chunk}")
        return f

    def guarded(*args):
        with monkeypatch.context() as m:
            for name in names:
                m.setattr(torch.Tensor, name, raiser(name))
            return inner(*args)

    monkeypatch.setattr(eng, chunk, guarded)
    got = _serve(eng, _requests(Request, [5, 9, 3, 7]))
    ref = ContinuousBatchingEngine(tm, tp, max_len=64, n_slots=3,
                                   chunk_steps=4, device="cpu")
    assert _outputs(got) == _outputs(_serve(ref, _requests(Request,
                                                           [5, 9, 3, 7])))
    assert eng.host_syncs > 1


def test_attribution_weights_bill_draft_work_and_sum_to_total():
    """The reference's case, and the port's shares against the
    reference's on the same spans, weighted and not."""
    def make(cls):
        r0 = cls(rid=0, prompt=[1], arrival_s=0.0)
        r0.done_s, r0.first_token_s = 2.0, 0.5
        r0.output, r0.draft_tokens = [1, 2], 30
        r1 = cls(rid=1, prompt=[1], arrival_s=0.5)
        r1.done_s, r1.first_token_s = 2.5, 1.0
        r1.output, r1.draft_tokens = [3, 4], 0
        return [r0, r1]

    t = np.asarray([0.0, 1.0, 2.0, 3.0])
    w = np.asarray([10.0, 12.0, 9.0, 10.0])

    def weight(r):
        return len(r.output) + 0.1 * r.draft_tokens

    for wt in (None, weight):
        reqs = make(Request)
        got = attribute_request_energy(reqs, t, w, weight=wt)
        want = jax_attribute(make(JaxRequest), t, w, weight=wt)
        assert got.keys() == want.keys()
        for rid in want:
            assert got[rid] == pytest.approx(want[rid], rel=1e-12)
        # every interval with a request in flight is billed in full
        assert sum(got.values()) == pytest.approx(10.0 + 12.0 + 9.0)
        assert [r.energy_j for r in reqs] == [got[0], got[1]]
    reqs = make(Request)
    for r in reqs:
        r.arrival_s, r.done_s = 0.0, 2.0
    per = attribute_request_energy(reqs, t, w, weight=weight)
    assert per[0] + per[1] == pytest.approx(22.0)
    assert per[0] / per[1] == pytest.approx(5.0 / 2.0)


def test_launcher_runs_speculative_on_cpu(capsys):
    m = tserve.main(["--arch", "qwen3-1.7b", "--reduce", "--device", "cpu",
                     "--speculative", "--k", "3", "--qps", "50",
                     "--min-duration", "0.1", "--new-tokens", "4",
                     "--slots", "2"])
    assert m["requests"] >= 1 and m["tokens"] == 4 * m["requests"]
    out = capsys.readouterr().out
    assert "speculative k=3 (draft qwen3-1.7b-draft2): acceptance" in out
    assert "verify_attention" in out
    m = tserve.main(["--arch", "qwen3-1.7b", "--reduce", "--device", "cpu",
                     "--speculative", "--draft", "granite-3-2b",
                     "--kv-page-size", "8", "--qps", "50",
                     "--min-duration", "0.05", "--new-tokens", "3",
                     "--slots", "2"])
    assert m["tokens"] == 3 * m["requests"]
    assert "draft granite-3-2b" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--engine", "fixed"],
                                  ["--max-len", "27"]])
def test_launcher_refuses_speculative_it_cannot_honour(flag, capsys):
    """``--speculative`` needs the continuous engine, and its windows
    need ``--k`` rows of room past prompt + new tokens (16 + 8 + 4)."""
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen3-1.7b", "--reduce", "--device", "cpu",
                     "--speculative", *flag])
    assert "--" in capsys.readouterr().err
