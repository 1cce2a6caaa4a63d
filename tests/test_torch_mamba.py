"""The port's Mamba (S6) mixer (``repro_torch.models.mamba``, jamba's
sublayer) on the CPU against the JAX reference ``repro.models.mamba``:
the parameter definitions, ``causal_conv`` with and without a state,
``_ssm_params``, the chunked ``_ssm_scan`` (one chunk, two chunks, and
the ragged lengths where the reference asserts), ``mamba_block`` with
its final state, ``mamba_decode`` (the state written in place) and
``mamba_state_defs``; and the scan's own error against a float64
recurrence at strong decay.

The reduced jamba config (d_model 128: d_inner 256, d_state 16, d_conv
4, dt_rank 8), float32, inputs from a numpy seed, weights through
``from_jax``.  Tolerance: float32 1e-4 (tests/test_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import mamba as JM
from repro.models.param import init_params as jax_init_params
from repro_torch import configs as tcfg
from repro_torch.models import mamba as TM
from repro_torch.models.param import from_jax, tree_map

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=1e-4, atol=1e-4)
CFG = jcfg.reduce_config(jcfg.get_config(ARCH))
D_IN = CFG.mamba.expand * CFG.d_model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.fixture(scope="module")
def params():
    """One Mamba mixer's weights in both packages.  The reference draws
    ``A_log`` and ``dt_bias`` as zeros (A = -1 everywhere); they are
    redrawn here so that every channel decays at its own rate."""
    jp = jax_init_params(JM.mamba_defs(CFG), jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    jp = dict(jp,
              A_log=jnp.asarray(np.log(rng.uniform(
                  1, 16, (D_IN, CFG.mamba.d_state))), jnp.float32),
              dt_bias=jnp.asarray(rng.normal(-1, 1, D_IN), jnp.float32))
    return jp, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, b, s, d):
    x = np.random.default_rng(seed).standard_normal((b, s, d))
    return x.astype(np.float32)


def test_param_and_state_defs_are_the_reference_defs():
    """``mamba_defs`` (shapes, logical axes, init rules, dtypes, scales)
    and ``mamba_state_defs`` (h float32, conv in the model dtype) at the
    reduced and the full config."""
    full = tcfg.get_config(ARCH)
    for cfg, tc in ((CFG, tcfg.reduce_config(full)),
                    (jcfg.get_config(ARCH), full)):
        assert {k: tuple(v) for k, v in TM.mamba_defs(tc).items()} == \
            {k: tuple(v) for k, v in JM.mamba_defs(cfg).items()}
        want = JM.mamba_state_defs(cfg, 3)
        dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        got = TM.mamba_state_defs(tc, 3, dt)
        assert {k: s for k, (s, _) in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert {k: str(d)[6:] for k, (_, d) in got.items()} == \
            {k: str(v.dtype) for k, v in want.items()}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 64])
def test_causal_conv_matches_reference(params, s, with_state):
    """The depthwise causal conv and the state it hands on (the last
    d_conv - 1 rows of [state or zeros, x]: a 1- or 2-token input with
    no state leaves zero rows in it)."""
    jp, tp = params
    x = _x(s, 2, s, D_IN)
    st = _x(100 + s, 2, CFG.mamba.d_conv - 1, D_IN) if with_state else None
    wo, ws = JM.causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                            None if st is None else jnp.asarray(st))
    go, gs = TM.causal_conv(torch.from_numpy(x), tp["conv_w"],
                            tp["conv_b"],
                            None if st is None else torch.from_numpy(st))
    _close(go, wo)
    _close(gs, ws)
    if not with_state and s < CFG.mamba.d_conv - 1:
        assert not gs[:, :CFG.mamba.d_conv - 1 - s].any()


def test_ssm_params_match_reference(params):
    """dt (softplus, float32), A = -exp(A_log), B and C (float32)."""
    jp, tp = params
    x = _x(5, 2, 33, D_IN)
    want = JM._ssm_params(jnp.asarray(x), jp, CFG)
    got = TM._ssm_params(torch.from_numpy(x), tp, CFG)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32
        _close(g, w)


def _ab(seed, s, b=1, n=8, strong=False):
    """a in (0, 1] (exp of dt * A), b of unit scale, float32."""
    rng = np.random.default_rng(seed)
    lo = -6.0 if strong else -0.5
    a = np.exp(rng.uniform(lo, 0, (b, s, n, 16))).astype(np.float32)
    return a, rng.standard_normal((b, s, n, 16)).astype(np.float32)


@pytest.mark.parametrize("s", [64, 512, 1024])
def test_ssm_scan_matches_reference(s):
    """One chunk (64, 512) and two chunks of 512 with the state carried
    across (1,024), against the reference with its own chunk."""
    a, b = _ab(s, s)
    want = JM._ssm_scan(jnp.asarray(a), jnp.asarray(b))
    _close(TM._ssm_scan(torch.from_numpy(a), torch.from_numpy(b)), want)


@pytest.mark.parametrize("s", [700, 1100])
def test_ragged_scan_is_exact_where_the_reference_asserts(s, monkeypatch):
    """At S 700 and 1,100 the reference's chunk (512) does not divide S
    and ``_ssm_scan`` asserts; the port runs a ragged last chunk (188,
    and 512 + 76) and matches the reference's own math as one chunk of
    S (its ``CHUNK`` patched, no file edited)."""
    a, b = _ab(s, s)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    with pytest.raises(AssertionError):
        JM._ssm_scan(ja, jb)
    monkeypatch.setattr(JM, "CHUNK", s)
    want = JM._ssm_scan(ja, jb)
    _close(TM._ssm_scan(torch.from_numpy(a), torch.from_numpy(b)), want)


def test_scan_error_against_a_float64_recurrence():
    """The log-depth scan against the literal recurrence in float64 over
    1,100 tokens (a ragged tail), at mild and strong decay: within
    float32 rounding."""
    for strong in (False, True):
        a, b = _ab(7, 1100, strong=strong)
        h, want = np.zeros(a.shape[2:]), np.empty(a.shape, np.float64)
        for t in range(a.shape[1]):
            h = a[0, t] * h + b[0, t]
            want[0, t] = h
        got = TM._ssm_scan(torch.from_numpy(a), torch.from_numpy(b))
        err = np.abs(got.double().numpy() - want).max()
        assert err <= 1e-5 * max(1.0, np.abs(want).max()), (strong, err)


@pytest.mark.parametrize("s", [1, 2, 64, 700])
def test_mamba_block_matches_reference(params, s, monkeypatch):
    """The whole mixer with ``return_state``: out, the final h and the
    conv rows.  At 700 the reference runs with its ``CHUNK`` patched to
    700 (one chunk); the port takes 512 + 188."""
    jp, tp = params
    x = _x(s + 1, 2, s, CFG.d_model)
    if s > JM.CHUNK:
        monkeypatch.setattr(JM, "CHUNK", s)
    wo, ws = JM.mamba_block(jnp.asarray(x), jp, CFG, return_state=True)
    go, gs = TM.mamba_block(torch.from_numpy(x), tp, CFG, return_state=True)
    _close(go, wo)
    assert gs["h"].dtype == torch.float32 and gs["h"].shape == ws["h"].shape
    for name in ("h", "conv"):
        _close(gs[name], ws[name])
    _close(TM.mamba_block(torch.from_numpy(x), tp, CFG), wo)


def test_mamba_decode_matches_reference(params):
    """Five single-token steps after a 9-token prefill: the outputs, and
    the state, which the port writes in place (the reference returns a
    new one)."""
    jp, tp = params
    x = _x(11, 2, 14, CFG.d_model)
    _, ws = JM.mamba_block(jnp.asarray(x[:, :9]), jp, CFG, return_state=True)
    _, gs = TM.mamba_block(torch.from_numpy(x[:, :9]), tp, CFG,
                           return_state=True)
    st = {k: v.clone() for k, v in gs.items()}
    for t in range(9, 14):
        wo, ws = JM.mamba_decode(jnp.asarray(x[:, t:t + 1]), jp, CFG, ws)
        h_before = st["h"]
        go, got = TM.mamba_decode(torch.from_numpy(x[:, t:t + 1]), tp, CFG,
                                  st)
        assert got is st and got["h"] is h_before
        _close(go, wo)
        for name in ("h", "conv"):
            _close(st[name], ws[name])


def test_prefill_then_decode_equals_one_prefill(params):
    """The handoff: ``mamba_block`` over 600 tokens (a chunk of 512 and
    an 88-token tail) equals ``mamba_block`` over the first 520 and 80
    ``mamba_decode`` steps, outputs and final state."""
    _, tp = params
    x = torch.from_numpy(_x(13, 1, 600, CFG.d_model))
    want, wst = TM.mamba_block(x, tp, CFG, return_state=True)
    head, st = TM.mamba_block(x[:, :520], tp, CFG, return_state=True)
    outs = [head]
    for t in range(520, 600):
        outs.append(TM.mamba_decode(x[:, t:t + 1], tp, CFG, st)[0])
    _close(torch.cat(outs, 1), want)
    _close(st["h"], wst["h"])
    _close(st["conv"], wst["conv"])
    assert tree_map(lambda t: t.shape, st) == tree_map(lambda t: t.shape,
                                                       wst)
