"""The decode kernels' device routes, on the CPU.

Both decode wrappers (contiguous and paged) send a CUDA call down one of
two routes (``decode_attention/ops.py:plan``): bfloat16 takes the
split-KV kernel (``csrc/decode_split.cuh``) plus a log-sum-exp merge,
its split layout flash's ``_splits`` over (B * KVH, the cache's
capacity, SM count); float32 takes the CUDA-core loop.  The kernels run
only on a card (``chip_smoke.py`` holds them against the plain versions
there, and the two decode kernels against each other bit for bit).
Here the split algorithm's plain version at Sq = 1 with the slots'
positions as offsets (``flash_attention_split_plain(..., causal=True,
offsets=pos)``) is held against the reference's jnp
``decode_attention_jnp`` and against the Pallas ``decode_attention`` and
``paged_decode_attention`` kernels in interpret mode, in float32 within
1e-5 (only the order of the sums and exp against exp2 differ), and the
route, the split layout and the launch's checks are pure Python.  That
a non-CUDA call raises and a CPU call takes the plain version is held
for both wrappers by ``test_torch_kernels.py`` and
``test_torch_paged_kernels.py``.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import (
    decode_attention as jax_decode,
    paged_decode_attention as jax_paged_decode,
)
from repro.models.layers import decode_attention_jnp
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.paged_decode_attention.ops import paged_view

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16, F32 = torch.bfloat16, torch.float32
GARBAGE = 1e4


def _case(seed, b, kvh, g, d, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, kvh * g, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    return q, kc, vc


def _split_plain(q, kc, vc, pos, per):
    """The decode split route's plain version: Sq = 1, causal, each
    slot's position as its query row's offset (a scalar broadcast)."""
    b = q.shape[0]
    offsets = torch.as_tensor(pos).expand(b)
    return fops.flash_attention_split_plain(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        causal=True, keys_per_split=per, offsets=offsets)


def _references(q, kc, vc, pos):
    """decode_attention_jnp and the Pallas kernel in interpret mode."""
    args = [jnp.asarray(x) for x in (q, kc, vc, pos)]
    return (np.asarray(decode_attention_jnp(*args)),
            np.asarray(jax_decode(*args, interpret=True)))


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [64, 96, 128])
def test_split_plain_matches_reference(g, d):
    """Ragged positions over 200 rows in splits of 64: a slot at 0 (every
    split past the first is beyond it), one at S - 1 (a ragged last
    split), one at 37 (splits 1-3 start past it)."""
    b, kvh, s, per = 3, 2, 200, 64
    q, kc, vc = _case(g * d, b, kvh, g, d, s)
    pos = np.array([0, s - 1, 37], np.int32)
    got = _split_plain(q, kc, vc, pos, per)
    assert got.shape == (b, 1, kvh * g, d)
    assert bool(torch.isfinite(got).all())
    for want in _references(q, kc, vc, pos):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("pos", [0, 99, 199], ids=["at-0", "mid", "at-S-1"])
def test_split_plain_with_a_scalar_pos(pos):
    """A scalar position (the whole batch at one depth, as whisper's
    fixed batch decodes) broadcast over the slots."""
    b, kvh, g, d, s, per = 2, 2, 2, 64, 200, 32
    q, kc, vc = _case(pos + 1, b, kvh, g, d, s)
    p = np.int32(pos)
    got = _split_plain(q, kc, vc, torch.tensor(pos, dtype=torch.int32), per)
    for want in _references(q, kc, vc, p):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_split_plain_masks_splits_past_each_slot():
    """Positions 0, 130 and 511 over 512 keys in splits of 64: slot 0
    sees key 0 only, so splits 1-7 are wholly masked; slot 1 sees up to
    130, so splits 3-7 are; slot 2 sees every split.  Masked splits carry
    m = -inf, l = 0 and o = 0 and weigh nothing in the merge: no NaN."""
    b, kvh, g, d, s, per = 3, 2, 2, 64, 512, 64
    q, kc, vc = _case(5, b, kvh, g, d, s)
    pos = np.array([0, 130, 511], np.int32)
    o, m, l = fops.split_partials(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        causal=True, keys_per_split=per, offsets=torch.from_numpy(pos))
    assert m.shape == (b, kvh, s // per, g)
    for slot, first_masked in ((0, 1), (1, 3), (2, 8)):
        dead = slice(first_masked, None)
        assert bool((m[slot, :, dead] == -float("inf")).all())
        assert bool((l[slot, :, dead] == 0).all())
        assert bool((o[slot, :, dead] == 0).all())
        assert bool(torch.isfinite(m[slot, :, :first_masked]).all())
    got = fops.merge_partials(o, m, l)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_split_plain(q, kc, vc, pos, per).numpy(),
                               _references(q, kc, vc, pos)[0], **TOL)


@pytest.mark.parametrize("g,d", [(1, 64), (1, 96), (2, 128), (4, 64),
                                 (8, 128)])
def test_split_plain_through_pages_matches_paged_pallas(g, d):
    """The paged kernel's split route reads the slot's NB * ps positions
    through its page table: the split plain version on the gathered view
    of a shuffled pool (garbage page 0 = 1e4) against the Pallas paged
    kernel, at a page's last row (15), a page's first (16) and the last
    position (NB * ps - 1)."""
    b, kvh, ps, nb = 3, 2, 16, 8
    rng = np.random.default_rng(g * d)
    q, kc, vc = _case(g * d, b, kvh, g, d, nb * ps)
    n_pages = b * nb + 1
    pages = (rng.permutation(n_pages - 1) + 1).reshape(b, nb).astype(
        np.int32)
    kp = np.full((n_pages, ps, kvh, d), GARBAGE, np.float32)
    vp = np.full((n_pages, ps, kvh, d), -GARBAGE, np.float32)
    kp[pages] = kc.reshape(b, nb, ps, kvh, d)
    vp[pages] = vc.reshape(b, nb, ps, kvh, d)
    pos = np.array([15, 16, nb * ps - 1], np.int32)
    kv = [paged_view(torch.from_numpy(x), torch.from_numpy(pages))
          for x in (kp, vp)]
    got = fops.flash_attention_split_plain(
        torch.from_numpy(q), *kv, causal=True, keys_per_split=32,
        offsets=torch.from_numpy(pos))
    want = jax_paged_decode(jnp.asarray(q), jnp.asarray(kp),
                            jnp.asarray(vp), jnp.asarray(pages),
                            jnp.asarray(pos), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               _references(q, kc, vc, pos)[0], **TOL)


@pytest.mark.parametrize("args,plan", [
    # chip_smoke's phase-3 shape: 8 slots x 8 KV heads over 2,048 rows ->
    # 16 splits of 128 keys (1,024 CTAs on 132 SMs)
    pytest.param((16, 8, 128, BF16, 2048, 64), ("split", 16, 128),
                 id="qwen3-decode"),
    # whisper's decoder: 8 windows x 12 heads over its 448-row cache
    pytest.param((12, 12, 64, BF16, 448, 96), ("split", 7, 64),
                 id="whisper-decode"),
    # phi-3-vision: 8 slots x 32 KV heads (G 1, D 96) over 2,048 rows ->
    # 5 splits of 448 keys (1,280 CTAs)
    pytest.param((32, 32, 96, BF16, 2048, 256), ("split", 5, 448),
                 id="phi3v-decode"),
    # one slot of a short cache: one split per 64-key chunk
    pytest.param((8, 2, 64, BF16, 304, 2), ("split", 5, 64),
                 id="small-cache"),
    # float32 takes the CUDA-core loop at every shape
    pytest.param((16, 8, 128, F32, 2048, 64), ("loop", 0, 0), id="f32"),
])
def test_decode_plan(args, plan):
    h, kvh, d, dtype, cap, n_sets = args
    for name in ("decode_attention", "paged_decode_attention"):
        assert dops.plan(name, h, kvh, d, dtype, cap, n_sets, 132) == plan
    if plan[0] == "split":
        assert plan[1] * plan[2] >= cap
        assert plan[1:] == fops._splits(n_sets, cap, 132)


@pytest.mark.parametrize("args,exc", [
    pytest.param((8, 2, 80, BF16), ValueError, id="d80"),
    pytest.param((6, 2, 64, BF16), ValueError, id="g3"),
    pytest.param((32, 2, 64, F32), ValueError, id="g16"),
    pytest.param((4, 2, 64, torch.float16), TypeError, id="fp16"),
])
def test_decode_plan_raises_where_no_kernel_takes_the_call(args, exc):
    h, kvh, d, dtype = args
    with pytest.raises(exc, match="decode_attention"):
        dops.plan("decode_attention", h, kvh, d, dtype, 64, 2, 132)


def test_scratch_holds_both_partials_in_one_buffer():
    """o_part (rows, D) first, then ml_part (rows, 2), float32."""
    buf, o_part, ml_part = dops.scratch(24, 128, "cpu")
    assert buf.dtype == torch.float32 and buf.numel() == 24 * 130
    assert o_part == buf.data_ptr()
    assert ml_part == buf.data_ptr() + 24 * 128 * 4


class _Recorder:
    """Stands in for the C entry points: records each call's entry (loop
    or split) and arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def entry(self, name, split, n_ptr, n_int, n_after):
        def fn(*args):
            # as many arguments as ``_entry`` declares argument types
            assert len(args) == (n_ptr + 2 * split + n_int + 6 + n_after
                                 + 2 * split + 3)
            self.calls.append((name, split, n_ptr, n_int, n_after, args))
            return 0
        return fn


@pytest.fixture
def recorder(monkeypatch):
    """decode's ``launch`` on meta tensors: the entry points, the SM count
    and the stream stubbed, so the Python side of a launch runs without
    a card.  A meta tensor holds no values, so any host read of ``pos``
    would raise."""
    rec = _Recorder()
    monkeypatch.setattr(dops, "_entry", rec.entry)
    monkeypatch.setattr(dops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return rec


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _launch_both(b=8, kvh=8, g=2, d=128, s=2048, ps=16, dtype=BF16):
    """One launch of each decode kernel through ``launch``, as the
    wrappers call it, on a contiguous cache of S rows (a per-slot pos)
    and on pools of NB * ps = S positions."""
    h = kvh * g
    q = _meta(b, 1, h, d, dtype=dtype)
    pos = _meta(b, dtype=torch.int32)
    kc, vc = (_meta(b, s, kvh, d, dtype=dtype) for _ in "kv")
    nb = s // ps
    kp, vp = (_meta(b * nb + 1, ps, kvh, d, dtype=dtype) for _ in "kv")
    pages = _meta(b, nb, dtype=torch.int32)
    o1 = dops.launch("decode_attention", q, kvh, s, (kc, vc),
                     (kc.data_ptr(), vc.data_ptr(), pos.data_ptr()),
                     (b, s, kvh, g, d, *kc.stride()[:3], *vc.stride()[:3]),
                     after=(pos.stride(0),))
    o2 = dops.launch("paged_decode_attention", q, kvh, nb * ps, (kp, vp),
                     (kp.data_ptr(), vp.data_ptr(), pages.data_ptr(),
                      pos.data_ptr()),
                     (b, kvh, g, d, nb, ps, *kp.stride()[:3],
                      *vp.stride()[:3]))
    assert o1.shape == o2.shape == q.shape and o1.dtype == dtype


def _layout(call):
    """The (split count, keys per split) a split-route call passes, right
    after its ints that follow the strides."""
    _, split, n_ptr, n_int, n_after, args = call
    assert split
    i = n_ptr + 2 + n_int + 6 + n_after
    return args[i:i + 2]


@pytest.mark.parametrize("dtype,split", [(BF16, True), (F32, False)])
def test_both_wrappers_launch_one_route_and_layout(recorder, dtype, split):
    """Equal (H, KVH, D, dtype, capacity): both kernels take the same
    entry (split or loop) and, on the split route, the same split count
    and keys per split; the contiguous kernel passes its pos stride
    before them, the paged one nothing."""
    _launch_both(dtype=dtype)
    (n1, s1, p1, i1, a1, x1), (n2, s2, p2, i2, a2, x2) = recorder.calls
    assert (n1, n2) == ("decode_attention", "paged_decode_attention")
    assert s1 == s2 == split
    assert (p1, i1, a1, p2, i2, a2) == (5, 5, 1, 6, 6, 0)
    if split:
        assert _layout(recorder.calls[0]) == _layout(recorder.calls[1]) \
            == (16, 128)
    assert x1[-3:] == x2[-3:] == (1.0 / 128 ** 0.5,
                                  1 if dtype == BF16 else 0, 0)


def test_layout_is_set_by_shapes_alone(recorder):
    """The split layout follows (B * KVH, capacity, SM count): other
    depths need no host read (``pos`` is a meta tensor here), and only a
    different capacity or slot count changes it."""
    _launch_both(b=8, s=2048)
    _launch_both(b=1, s=2048)
    _launch_both(b=8, s=1024)
    layouts = [_layout(c) for c in recorder.calls]
    assert layouts == [(16, 128)] * 2 + [(32, 64)] * 2 + [(16, 64)] * 2


def test_misaligned_split_call_raises(recorder):
    """A row start that is not 16-byte aligned raises on the split route
    before anything launches: no quiet fall-back to the loop."""
    b, kvh, g, d, s = 2, 2, 2, 64, 128
    h = kvh * g
    k = _meta(b, s, kvh, d + 1)[..., :d]                 # odd row stride
    q = _meta(b, 1, h, d)
    pos = _meta(b, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        dops.launch("decode_attention", q, kvh, s, (k, k),
                    (k.data_ptr(), k.data_ptr(), pos.data_ptr()),
                    (b, s, kvh, g, d, *k.stride()[:3], *k.stride()[:3]),
                    after=(1,))
    assert recorder.calls == []


def test_launch_makes_q_contiguous(recorder):
    """The kernels read q as (B, KVH * G, D) rows: a strided q (a slice
    of a wider projection) is copied, and o has q's shape."""
    b, kvh, g, d, s = 2, 2, 2, 64, 128
    h = kvh * g
    q = _meta(b, 1, 2 * h, d)[:, :, :h]
    k = _meta(b, s, kvh, d)
    pos = _meta(b, dtype=torch.int32)
    o = dops.launch("decode_attention", q, kvh, s, (k, k),
                    (k.data_ptr(), k.data_ptr(), pos.data_ptr()),
                    (b, s, kvh, g, d, *k.stride()[:3], *k.stride()[:3]),
                    after=(1,))
    assert o.shape == (b, 1, h, d) and o.is_contiguous()
    assert len(recorder.calls) == 1
