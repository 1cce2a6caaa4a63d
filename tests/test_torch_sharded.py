"""Tensor-parallel serving of the port (``repro_torch.parallel``,
``ShardedContinuousBatchingEngine``, ``ShardedSUT``, the launcher's
``--tp``/``--replicas``, ``scale_sweep``) against the JAX package on
the CPU.

The sharded engine runs one process per shard under gloo
(``run_tp``).  Each degree (TP 1, 2 and 4; TP 4 through KV-head
replication, the reduced qwen3 having 2 KV heads) is one module-scoped
job that serves every scenario on weights bridged from the reference
(``from_jax``): contiguous, paged with the prefix cache, chunked
prefill, preemption under a virtual clock, and speculative k = 4 with a
truncated draft, as the reference's ``tests/test_sharded.py``,
``scripts/paged_smoke.py`` and ``tests/test_speculative.py`` do.  Every
rank's tokens must equal rank 0's, and rank 0's the reference's
single-device engine's; prefill logits stay within 1e-4 of the
reference's.  The JAX package is imported in the test process only:
the ranks import this module, so JAX stays inside functions here.
"""
import copy
import dataclasses
import re
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.parallel import run_tp

torch.set_num_threads(1)

ARCH = "qwen3-1.7b"
TIMEOUT_S = 240.0
# scenario name -> the reference engine's geometry it is compared with
CONTIG = dict(max_len=48, n_slots=3, chunk_steps=4)
PAGED_REF = dict(max_len=64, n_slots=3, chunk_steps=4)
PRE_KW = dict(max_len=16, n_slots=3, chunk_steps=2, kv_page_size=4)
MIXED_BUDGETS = [5, 9, 3, 12, 1, 7]
LONG_BUDGETS = [4, 6, 5]
LOGIT_TOL = 1e-4


# -- requests (plain data: they cross into the ranks) -------------------
def _contig_prompts():
    """The reference test's 12-token prompts (jax.random, key 7)."""
    import jax

    key = jax.random.PRNGKey(7)
    return [np.asarray(jax.random.randint(jax.random.fold_in(key, i), (12,),
                                          0, 512)) for i in range(6)]


def _spec_prompts():
    import jax

    key = jax.random.PRNGKey(7)
    return [np.asarray(jax.random.randint(jax.random.fold_in(key, i), (10,),
                                          0, 512)) for i in range(6)]


def _specs(prompts, budgets):
    """(rid, prompt, budget, arrival, priority, deadline) of each
    request."""
    return [(i, np.asarray(p), b, 0.0, 0, None)
            for i, (p, b) in enumerate(zip(prompts, budgets))]


def _inputs() -> dict:
    """Every scenario's requests, as in the reference's tests."""
    mixed = [np.arange(8) + 3 * i for i in range(len(MIXED_BUDGETS))]
    shared = list(np.arange(16) + 100)
    return {
        "contiguous": _specs(_contig_prompts(), [5, 9, 3, 7, 5, 9]),
        "paged_mixed": _specs(mixed, MIXED_BUDGETS),
        "paged_shared": _specs([np.asarray(shared + [200 + i, 201 + i])
                                for i in range(4)], [6] * 4),
        "chunked": _specs([np.arange(20) + 3 * i for i in range(3)],
                          LONG_BUDGETS),
        "preempt": [(0, np.arange(12) + 7, 4, 0.0, 0, None),
                    (1, np.arange(12) + 40, 4, 0.0, 0, None),
                    (2, np.arange(4) + 90, 4, 0.01, 1, 0.05)],
        "speculative": _specs(_spec_prompts(), [5, 9, 3, 7, 5, 9]),
        "logits": np.arange(12) * 37 % 512,
    }


def _requests(cls, specs):
    return [cls(rid=rid, prompt=p, max_new_tokens=b, arrival_s=a,
                priority=pr, deadline_s=d)
            for rid, p, b, a, pr, d in specs]


def _virtual_clock():
    """The reference preemption test's clock: every read ticks 2 ms."""
    t = [0.0]

    def now():
        t[0] += 0.002
        return t[0]

    def sleep(dt):
        t[0] += max(0.0, dt)

    return now, sleep


# -- the ranks' side ------------------------------------------------------
def _tp_scenarios(rank, tp, params_np, inputs):
    """Every scenario through ``ShardedContinuousBatchingEngine`` on this
    rank (SPMD: every rank serves the same lists).  Returns, on rank 0,
    {scenario: [each rank's {rid: tokens}]} plus stats and logits."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model
    from repro_torch.models.param import from_jax
    from repro_torch.serving import (Request, Scheduler,
                                     ShardedContinuousBatchingEngine,
                                     truncate_draft)

    cfg = reduce_config(get_config(ARCH))
    model = build_model(cfg, "cpu")
    params = from_jax(params_np, "cpu")

    def engine(**kw):
        return ShardedContinuousBatchingEngine(model, params, tp=tp,
                                               rank=rank, device="cpu", **kw)

    def serve(eng, name, **kw):
        done = eng.serve(_requests(Request, inputs[name]),
                         honor_arrivals=False, **kw)
        return {r.rid: list(map(int, r.output)) for r in done}

    out, stats = {}, {}
    eng = engine(**CONTIG)
    out["contiguous"] = serve(eng, "contiguous")
    stats["contiguous"] = dict(host_syncs=eng.host_syncs,
                               decode_steps=eng.decode_steps)
    logits, _ = eng.model.prefill(
        eng.params, {"tokens": torch.as_tensor(inputs["logits"])[None]})
    stats["kv_heads"] = eng.model.cfg.n_kv_heads
    stats["cache_kv_heads"] = int(eng.state["cache"]["layers"]["blocks"]
                                  ["k"].shape[3])

    eng = engine(kv_page_size=8, prefix_caching=True, **PAGED_REF)
    out["paged_mixed"] = serve(eng, "paged_mixed")
    out["paged_shared"] = serve(eng, "paged_shared")
    stats["paged_shared"] = dict(eng.prefix_stats)

    eng = engine(kv_page_size=8, prefill_chunk_tokens=8, **PAGED_REF)
    out["chunked"] = serve(eng, "chunked")
    stats["chunked"] = dict(eng.sched_stats)

    eng = engine(kv_pages=9, prefix_caching=True,
                 scheduler=Scheduler(preemption=True), **PRE_KW)
    eng.serve([Request(rid=80, prompt=np.arange(12) + 300, max_new_tokens=2),
               Request(rid=81, prompt=np.arange(4) + 400, max_new_tokens=2)],
              honor_arrivals=False)
    now, sleep = _virtual_clock()
    done = eng.serve(_requests(Request, inputs["preempt"]), now=now,
                     sleep=sleep)
    out["preempt"] = {r.rid: list(map(int, r.output)) for r in done}
    stats["preempt"] = dict(eng.sched_stats)

    dmodel, dparams = truncate_draft(model, params, 2)
    eng = engine(draft_model=dmodel, draft_params=dparams, spec_k=4,
                 max_len=64, n_slots=3, chunk_steps=2)
    out["speculative"] = serve(eng, "speculative")
    stats["speculative"] = dict(eng.spec_stats)

    ranks = [None] * tp
    dist.all_gather_object(ranks, (out, stats))
    if rank:
        return None
    return {"outputs": {k: [r[0][k] for r in ranks] for k in out},
            "stats": [r[1] for r in ranks],
            "logits": logits[0, -1].numpy()}


def _raise_on_rank_1(rank, tp):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()              # rank 0 waits for a peer that never comes
    return "unreachable"


def _hang_on_rank_1(rank, tp):
    import torch.distributed as dist

    if rank == 1:
        time.sleep(600)
    dist.all_reduce(torch.ones(1))
    return "unreachable"


# -- the test process's side ----------------------------------------------
@pytest.fixture(scope="module")
def ref():
    """The reference's model, weights (as numpy), and its single-device
    engine's tokens in every scenario, plus the prefill logits."""
    import jax

    from repro import configs as jcfg
    from repro.models import build_model as jax_build_model
    from repro.models.param import init_params as jax_init_params
    from repro.serving import ContinuousBatchingEngine as JaxCBE
    from repro.serving import Request as JaxRequest

    cfg = jcfg.reduce_config(jcfg.get_config(ARCH))
    jm = jax_build_model(cfg)
    jp = jax_init_params(jm.param_defs(), jax.random.PRNGKey(0))
    inputs = _inputs()

    def serve(eng, name, **kw):
        done = eng.serve(copy.deepcopy(_requests(JaxRequest, inputs[name])),
                         honor_arrivals=False, **kw)
        return {r.rid: list(map(int, r.output)) for r in done}

    out = {}
    contig = JaxCBE(jm, jp, **CONTIG)
    out["contiguous"] = serve(contig, "contiguous")
    host_syncs = contig.host_syncs
    base = JaxCBE(jm, jp, **PAGED_REF)
    for name in ("paged_mixed", "paged_shared", "chunked", "speculative"):
        out[name] = serve(base, name)
    pre = JaxCBE(jm, jp, kv_pages=33, **PRE_KW)
    out["preempt"] = serve(pre, "preempt")
    logits, _ = jm.prefill(jp, {"tokens": np.asarray(inputs["logits"])[None]})
    return types.SimpleNamespace(
        cfg=cfg, model=jm, params=jp,
        params_np=jax.tree.map(np.asarray, jp), inputs=inputs, out=out,
        host_syncs=host_syncs, logits=np.asarray(logits[0, -1]))


@pytest.fixture(scope="module")
def tp_runs(ref):
    """One ``run_tp`` job a degree, every scenario in it."""
    return {tp: run_tp(_tp_scenarios, tp, timeout_s=TIMEOUT_S,
                       args=(ref.params_np, ref.inputs))
            for tp in (1, 2, 4)}


SCENARIOS = ["contiguous", "paged_mixed", "paged_shared", "chunked",
             "preempt", "speculative"]


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_sharded_tokens_equal_the_reference(tp_runs, ref, tp, scenario):
    """Greedy tokens at TP ``tp`` equal the reference's single-device
    engine's (and so the port's TP 1 engine's), on every rank."""
    ranks = tp_runs[tp]["outputs"][scenario]
    assert len(ranks) == tp
    want = ref.out[scenario]
    assert sorted(want) == sorted(ranks[0])
    assert ranks[0] == want
    for r, got in enumerate(ranks[1:], 1):
        assert got == ranks[0], f"rank {r} emitted other tokens"
    assert tp_runs[1]["outputs"][scenario][0] == ranks[0]


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_modes_ran_as_the_reference_asks(tp_runs, ref, tp):
    """The scenarios exercised what they name, alike on every rank: host
    syncs as the reference engine's, prefix hits, prefill chunks, a park
    and a resume, speculative proposals; each rank holds kvh / tp KV
    heads (TP 4 after replicating the 2 KV heads to 4)."""
    stats = tp_runs[tp]["stats"]
    assert all(s == stats[0] for s in stats[1:])
    s = stats[0]
    assert s["contiguous"]["host_syncs"] == ref.host_syncs
    assert s["contiguous"]["decode_steps"] == (
        ref.host_syncs * CONTIG["chunk_steps"])
    assert s["paged_shared"]["hits"] >= 3
    assert s["chunked"]["prefill_chunks"] >= 9
    assert s["preempt"]["preemptions"] >= 1 and s["preempt"]["resumes"] >= 1
    assert s["speculative"]["proposed"] > 0
    kvh = max(ref.cfg.n_kv_heads, tp) // tp
    assert s["kv_heads"] == s["cache_kv_heads"] == kvh


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_prefill_logits_match_the_reference(tp_runs, ref, tp):
    got = tp_runs[tp]["logits"]
    assert got.shape == ref.logits.shape
    np.testing.assert_allclose(got, ref.logits, rtol=0, atol=LOGIT_TOL)


# -- the layout -----------------------------------------------------------
def _port_model():
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import build_model

    return build_model(reduce_config(get_config(ARCH)), "cpu")


def test_replicate_kv_heads_equals_the_reference(ref):
    from repro.serving.sharded import replicate_kv_heads as jax_replicate
    from repro_torch.models.param import from_jax, tree_leaves
    from repro_torch.serving import replicate_kv_heads

    jm4, jp4 = jax_replicate(ref.model, ref.params, 4)
    tm4, tp4 = replicate_kv_heads(_port_model(), from_jax(ref.params_np,
                                                          "cpu"), 4)
    assert tm4.cfg.n_kv_heads == jm4.cfg.n_kv_heads == 4
    assert tm4.cfg.head_dim == jm4.cfg.head_dim
    import jax

    want = jax.tree.leaves(jax.tree.map(np.asarray, jp4))
    got = tree_leaves(tp4)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert np.array_equal(w, g.numpy())
    with pytest.raises(ValueError, match="neither divides"):
        replicate_kv_heads(_port_model(), from_jax(ref.params_np, "cpu"), 3)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_local_config_equals_the_reference(tp):
    from repro import configs as jcfg
    from repro.parallel.sharding import tp_local_config as jax_local
    from repro_torch import configs as tcfg
    from repro_torch.parallel import tp_local_config

    jc = dataclasses.replace(jcfg.reduce_config(jcfg.get_config(ARCH)),
                             n_kv_heads=4)
    tc = dataclasses.replace(tcfg.reduce_config(tcfg.get_config(ARCH)),
                             n_kv_heads=4)
    want, got = jax_local(jc, tp), tp_local_config(tc, tp)
    for f in ("n_heads", "n_kv_heads", "d_ff", "d_head", "d_model",
              "vocab_size", "n_layers"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.head_dim == want.head_dim == 32


@pytest.mark.parametrize("arch, reduced, tp", [
    ("rwkv6-3b", False, 2),      # not a dense family
    (ARCH, False, 3),            # 16 heads
    (ARCH, True, 4),             # 2 KV heads
])
def test_tp_local_config_refuses_as_the_reference(arch, reduced, tp):
    from repro import configs as jcfg
    from repro.parallel.sharding import tp_local_config as jax_local
    from repro_torch import configs as tcfg
    from repro_torch.parallel import tp_local_config

    msgs = []
    for cfgs, local in ((jcfg, jax_local), (tcfg, tp_local_config)):
        cfg = cfgs.get_config(arch)
        with pytest.raises(ValueError) as e:
            local(cfgs.reduce_config(cfg) if reduced else cfg, tp)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


class _FakeMesh:
    """A 1-D mesh's shape and names: enough for the reference's rules."""

    def __init__(self, tp):
        self.shape = {"model": tp}
        self.axis_names = ("model",)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_follows_the_reference_rules_and_round_trips(ref, tp):
    """Each leaf splits along the dim the reference's ``make_tp_rules``
    maps onto the model axis (``logical_pspec``) and nowhere else; the
    ranks' shards concatenate back to the full leaf; replicated leaves
    are the same tensors."""
    from repro.parallel.sharding import logical_pspec, make_tp_rules
    from repro.serving.sharded import replicate_kv_heads as jax_replicate
    from repro_torch.models.param import from_jax, tree_leaves
    from repro_torch.parallel import shard_params, tp_dim
    from repro_torch.serving import replicate_kv_heads

    jm, tm = ref.model, _port_model()
    params = from_jax(ref.params_np, "cpu")
    if tp > ref.cfg.n_kv_heads:
        jm, _ = jax_replicate(jm, ref.params, tp)
        tm, params = replicate_kv_heads(tm, params, tp)
    rules = make_tp_rules(jm.cfg, _FakeMesh(tp))
    import jax

    from repro.models.param import ParamDef as JaxParamDef
    jdefs = jax.tree.leaves(jm.param_defs(),
                            is_leaf=lambda x: isinstance(x, JaxParamDef))
    defs = tree_leaves(tm.param_defs())
    assert [d.names for d in defs] == [d.names for d in jdefs]
    shards = [tree_leaves(shard_params(params, tm.param_defs(), r, tp))
              for r in range(tp)]
    split = 0
    for i, (d, full) in enumerate(zip(defs, tree_leaves(params))):
        spec = tuple(logical_pspec(d.names, rules))
        want = [j for j, ax in enumerate(spec) if ax is not None]
        axis = tp_dim(d.names)
        assert want == ([] if axis is None else [axis]), d.names
        parts = [s[i] for s in shards]
        if axis is None:
            assert all(p is full for p in parts)
            continue
        split += 1
        assert all(p.shape[axis] == full.shape[axis] // tp for p in parts)
        assert torch.equal(torch.cat(parts, dim=axis), full)
    assert split == 7        # wq, wk, wv, wo, w_gate, w_up, w_down


def test_shard_params_refuses_a_dim_tp_does_not_divide():
    from repro_torch.parallel import shard_params

    tm = _port_model()
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        shard_params(tm.init(0), tm.param_defs(), 0, 3)
    with pytest.raises(ValueError, match="rank 4 outside"):
        shard_params(tm.init(0), tm.param_defs(), 4, 4)


# -- ShardedSUT -------------------------------------------------------------
def _sides():
    import repro.harness as jh
    import repro_torch.harness as th

    return {"ref": jh, "port": th}


def test_scaled_sysdesc_envelopes():
    """The reference's own test (tests/test_sharded.py), run on the
    port: ShardedSUT / ReplicatedSUT declare scale-matched envelopes:
    tp chips on the meter, replica sums on the fleet description."""
    h = _sides()["port"]
    cfg = types.SimpleNamespace(param_count=lambda: 1_000_000)
    engine = types.SimpleNamespace(tp=4, n_slots=4)
    sut = h.ShardedSUT(engine, cfg, make_request=lambda i, s, a: None)
    desc = sut.system_description()
    assert desc.scale == "datacenter" and desc.n_chips == 4
    assert desc.telemetry_accuracy is not None
    assert desc.max_system_watts > desc.idle_system_watts > 0

    one = types.SimpleNamespace(tp=1, n_slots=4)
    single = h.ShardedSUT(one, cfg, make_request=lambda i, s, a: None)
    sdesc = single.system_description()
    assert sdesc.scale == "edge"

    fleet = h.ReplicatedSUT([single, single, single])
    fdesc = fleet.system_description()
    assert fdesc.n_chips == 3 * sdesc.n_chips
    assert np.isclose(fdesc.idle_system_watts,
                      3 * sdesc.idle_system_watts)
    assert np.isclose(fdesc.max_system_watts,
                      3 * sdesc.max_system_watts)


GRID = np.linspace(-0.5, 6.0, 3251)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("qps", [0.5, 37.0])
def test_sharded_sut_rails_and_sysdesc_equal_the_reference(tp, qps):
    """On the same outcome and completed requests the port's modeled
    domains (one accelerator channel per shard), power source, PSU and
    system description are the reference's, value for value."""
    from repro import configs as jcfg
    from repro.serving import Request as JaxRequest
    from repro_torch import configs as tcfg
    from repro_torch.serving import Request

    outcome = types.SimpleNamespace(result=types.SimpleNamespace(qps=qps))
    got = {}
    for side, cfgs, Req in (("ref", jcfg, JaxRequest),
                            ("port", tcfg, Request)):
        h = _sides()[side]
        sut = h.ShardedSUT(types.SimpleNamespace(tp=tp, n_slots=4),
                           cfgs.reduce_config(cfgs.get_config(ARCH)),
                           name="tp-stub", make_request=lambda i, s, a: None)
        sut.completed = []
        for i in range(9):
            r = Req(rid=i, prompt=np.arange(8), max_new_tokens=4,
                    arrival_s=0.37 * i)
            r.done_s = r.arrival_s + 0.9 + 0.05 * i if i != 4 else None
            sut.completed.append(r)
        got[side] = ([(d.name, d.kind, d.boundary, d.source(GRID))
                      for d in sut.domains(outcome)],
                     sut.power_source(outcome)(GRID),
                     dataclasses.asdict(sut._psu()),
                     dataclasses.asdict(sut.system_description()))
    (a, pa, *ra), (b, pb, *rb) = got["ref"], got["port"]
    assert [x[:3] for x in a] == [y[:3] for y in b]
    for x, y in zip(a, b):
        assert np.array_equal(x[3], y[3]), x[0]
    assert np.array_equal(pa, pb) and ra == rb
    names = [x[0] for x in b]
    accel = (["accelerator"] if tp == 1
             else [f"accelerator/{i}" for i in range(tp)])
    assert names == accel + ["dram", "host", "wall"]


def _fake_meter():
    from repro_torch.power.nvml import EnergySampler

    t = [0.0]

    def counter():
        t[0] += 1.0
        return 150.0 * t[0]

    return lambda: EnergySampler(counter, period_s=0.001)


def test_sharded_sut_takes_a_measured_meter_at_tp_1_only():
    from repro_torch.harness import ShardedSUT
    from repro_torch.hw import DATACENTER_H100

    cfg = types.SimpleNamespace(param_count=lambda: 1_000_000)
    with pytest.raises(ValueError, match="ShardedSUT 'tp4'.*tp 1 only"):
        ShardedSUT(types.SimpleNamespace(tp=4, n_slots=4), cfg, name="tp4",
                   make_request=lambda i, s, a: None,
                   energy_meter=_fake_meter())
    one = ShardedSUT(types.SimpleNamespace(tp=1, n_slots=4), cfg,
                     name="tp1", make_request=lambda i, s, a: None,
                     energy_meter=_fake_meter())
    desc = one.system_description()
    assert one.trace is not None and one.meter.system == DATACENTER_H100
    assert desc.scale == "datacenter" and "nvml" in desc.instrument


# -- run_tp -----------------------------------------------------------------
def test_a_raising_rank_ends_run_tp_with_its_error():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised") as e:
        run_tp(_raise_on_rank_1, 2, timeout_s=60.0)
    assert "rank 1 fails on purpose" in str(e.value)
    assert time.monotonic() - t0 < 60.0


def test_a_hung_collective_ends_run_tp_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[.*\] of 2"):
        run_tp(_hang_on_rank_1, 2, timeout_s=12.0)
    assert time.monotonic() - t0 < 12.0 + 10.0


# -- the launcher and scale_sweep ----------------------------------------
LAUNCH = ["--arch", ARCH, "--reduce", "--device", "cpu", "--qps", "16",
          "--min-duration", "2", "--new-tokens", "4"]


def test_launcher_serves_at_tp_4_on_cpu(capfd):
    from repro_torch.launch import serve as tserve

    m = tserve.main(LAUNCH + ["--tp", "4"])
    out = capfd.readouterr().out
    assert m["review_passed"], out
    assert m["requests"] >= 1 and m["tokens"] == 4 * m["requests"]
    assert set(m["domain_energy_j"]) == {
        "accelerator/0", "accelerator/1", "accelerator/2", "accelerator/3",
        "dram", "host", "wall"}
    assert m["measured"] == [] and "across tp=4 ranks" in out


def test_launcher_serves_replicas_on_cpu(capsys):
    from repro_torch.launch import serve as tserve

    m = tserve.main(LAUNCH + ["--replicas", "2"])
    out = capsys.readouterr().out
    assert m["review_passed"], out
    assert m["requests"] >= 1 and m["tokens"] == 4 * m["requests"]
    assert {"r0/wall", "r1/wall", "pdu"} <= set(m["domain_energy_j"])
    assert m["energy_j"] == pytest.approx(m["domain_energy_j"]["pdu"])
    assert "x 2 replicas" in out and "per-replica wall energy" in out


# the reference's rows: scale_{point},{us/tok},{tok/s}toks/s;{tok/J}tok/J;
# {W}W;{chips}chips, then scale_r2_speedup,0.0,{x}x
ROW = re.compile(r"^scale_(tp1|tp4|r2),[0-9.]+,[0-9.]+toks/s;[0-9.]+tok/J;"
                 r"[0-9.]+W;[0-9]+chips$")


def test_scale_sweep_has_the_reference_points_rows_and_keys():
    from repro_torch.benchmarks import scale_sweep

    rows, points = scale_sweep.sweep("cpu", smoke=True)
    assert [r.split(",")[0] for r in rows] == [
        "scale_tp1", "scale_tp4", "scale_r2", "scale_r2_speedup"]
    assert all(ROW.match(r) for r in rows[:3]), rows
    assert re.match(r"^scale_r2_speedup,0\.0,[0-9.]+x$", rows[3])
    keys = {"tokens_per_s", "tok_per_j", "us_per_tok", "avg_watts", "chips"}
    assert set(points) == {"tp1", "tp4", "r2"}
    assert set(points["tp1"]) == set(points["tp4"]) == keys
    assert set(points["r2"]) == keys | {"speedup"}
    assert [points[p]["chips"] for p in ("tp1", "tp4", "r2")] == [1, 4, 2]
    assert all(points[p]["tokens_per_s"] > 0 and points[p]["tok_per_j"] > 0
               for p in points)


def test_scale_sweep_point_is_the_reference_point():
    """One point's row and numbers through the port's ``_finish_point``
    and the reference's, on the same run: equal."""
    import importlib
    import os
    import sys

    from repro_torch.benchmarks import scale_sweep as ts

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    js = importlib.import_module("benchmarks.scale_sweep")
    from repro_torch.harness import ContinuousBatchingSUT
    from repro_torch.serving import ContinuousBatchingEngine

    cfg, model, params = ts._setup("cpu")
    eng = ContinuousBatchingEngine(model, params, **ts._engine_kw(model))
    ts._warm(eng, cfg)
    r = ts._run_once(ContinuousBatchingSUT(
        eng, cfg, name="scale-tp1", make_request=ts._make_request_for(cfg)),
        8)
    assert ts._finish_point("tp1", r, 1) == js._finish_point("tp1", r, 1)
