"""The verify kernels' device routes, on the CPU.

Both verify wrappers (contiguous and paged) send a CUDA call down one of
flash's three routes (``plan``: ``_route`` of the window's T * G
rows per KV head, and the split layout of ``_splits``): the split-KV
kernel plus a log-sum-exp merge for bf16 with at most 16 rows (the
speculative window), the tensor-core tile kernel for bf16 with more (a
prefix hit's suffix), the CUDA-core tile loop for float32.  The kernels
run only on a card (``chip_smoke.py`` holds them against the plain
versions there, and the two verify kernels against each other bit for
bit); here the split algorithm's plain version with per-slot window
offsets is held against the reference's jnp ``verify_attention_jnp`` and
against the Pallas ``verify_attention_kernel`` and
``paged_verify_attention_kernel`` in interpret mode, in float32 within
1e-5 (only the order of the sums and exp against exp2 differ), and the
route, the split layout and the launch's checks are pure Python.  That
a non-CUDA call raises and a CPU call takes the plain version is held
for both wrappers by ``test_torch_verify_kernel.py`` and
``test_torch_paged_kernels.py``.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import (
    paged_verify_attention as jax_paged_verify,
    verify_attention as jax_verify,
)
from repro.models.layers import verify_attention_jnp
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.paged_decode_attention.ops import paged_view

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16, F32 = torch.bfloat16, torch.float32


def _case(seed, b, t, kvh, g, d, s):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, kvh * g, d)).astype(np.float32)
    kc = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    return q, kc, vc


def _split_plain(q, kc, vc, pos, per):
    return fops.flash_attention_split_plain(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        causal=True, keys_per_split=per, offsets=torch.from_numpy(pos))


@pytest.mark.parametrize("b,t,kvh,g,d,s,per,starts", [
    # the speculative window (T 5, G 2: 10 rows), D 128; a slot at 0 and
    # one whose window ends on the cache's last row (pos + T = S)
    pytest.param(3, 5, 2, 2, 128, 256, 64, (0, 100, 251), id="t5-g2-d128"),
    # 16 rows, the split route's last shape, and 18, the tile route's
    # (the plain algorithm takes any row count)
    pytest.param(3, 8, 2, 2, 64, 200, 64, (0, 37, 192), id="rows16-t8-g2"),
    pytest.param(3, 9, 2, 2, 64, 200, 64, (0, 50, 191), id="rows18-t9-g2"),
    pytest.param(2, 16, 2, 1, 64, 130, 64, (0, 114), id="rows16-t16-g1"),
    pytest.param(2, 4, 1, 4, 128, 300, 128, (0, 296), id="rows16-t4-g4"),
    pytest.param(2, 2, 2, 8, 64, 96, 32, (0, 94), id="rows16-t2-g8"),
    pytest.param(3, 1, 2, 8, 128, 77, 64, (0, 40, 76), id="t1-g8"),
    # phi-3-vision's head (D 96, G 1): the speculative window
    pytest.param(3, 5, 2, 1, 96, 200, 64, (0, 77, 195), id="t5-g1-d96"),
])
def test_split_plain_matches_reference(b, t, kvh, g, d, s, per, starts):
    q, kc, vc = _case(t * g + d + s, b, t, kvh, g, d, s)
    pos = np.asarray(starts, np.int32)
    got = _split_plain(q, kc, vc, pos, per)
    assert bool(torch.isfinite(got).all())
    want = verify_attention_jnp(jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pallas = jax_verify(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                        jnp.asarray(pos), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_split_plain_masks_splits_past_each_window():
    """Windows of 5 at starts 0, 130 and 507 over 512 keys in splits of
    64: slot 0 sees keys 0..4, so splits 1-7 are wholly masked; slot 1
    sees up to 134, so splits 3-7 are; slot 2 sees every split.  Masked
    splits carry m = -inf, l = 0 and o = 0 and weigh nothing in the
    merge: no NaN."""
    b, t, kvh, g, d, s, per = 3, 5, 2, 2, 64, 512, 64
    q, kc, vc = _case(5, b, t, kvh, g, d, s)
    pos = np.array([0, 130, 507], np.int32)
    o, m, l = fops.split_partials(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        causal=True, keys_per_split=per, offsets=torch.from_numpy(pos))
    assert m.shape == (b, kvh, s // per, t * g)
    for slot, first_masked in ((0, 1), (1, 3), (2, 8)):
        dead = slice(first_masked, None)
        assert bool((m[slot, :, dead] == -float("inf")).all())
        assert bool((l[slot, :, dead] == 0).all())
        assert bool((o[slot, :, dead] == 0).all())
        assert bool(torch.isfinite(m[slot, :, :first_masked]).all())
    # split 2 of slot 1 (keys 128..191): row t = 0 (position 130) sees
    # keys 128..130, every row something
    assert bool(torch.isfinite(m[1, :, 2]).all())
    got = fops.merge_partials(o, m, l)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(
        _split_plain(q, kc, vc, pos, per).numpy(),
        np.asarray(verify_attention_jnp(jnp.asarray(q), jnp.asarray(kc),
                                        jnp.asarray(vc), jnp.asarray(pos))),
        **TOL)


@pytest.mark.parametrize("g,d", [(1, 64), (1, 96), (2, 128), (4, 64),
                                 (8, 128)])
def test_split_plain_through_pages_matches_paged_pallas(g, d):
    """The paged kernel's split route reads the slot's NB * ps positions
    through its page table: the split plain version on the gathered view
    of a shuffled pool (garbage page 0 = 1e4) against the Pallas paged
    kernel, windows crossing a page boundary (14..15 | 16..18) and
    ending on the last position (pos + T = NB * ps)."""
    b, t, kvh, ps, nb = 3, 5 if g <= 2 else 2, 2, 16, 8
    rng = np.random.default_rng(g * d)
    q, kc, vc = _case(g * d, b, t, kvh, g, d, nb * ps)
    n_pages = b * nb + 1
    pages = (rng.permutation(n_pages - 1) + 1).reshape(b, nb).astype(
        np.int32)
    kp = np.full((n_pages, ps, kvh, d), 1e4, np.float32)
    vp = np.full((n_pages, ps, kvh, d), -1e4, np.float32)
    kp[pages] = kc.reshape(b, nb, ps, kvh, d)
    vp[pages] = vc.reshape(b, nb, ps, kvh, d)
    pos = np.array([14, 60, nb * ps - t], np.int32)
    kv = [paged_view(torch.from_numpy(x), torch.from_numpy(pages))
          for x in (kp, vp)]
    got = fops.flash_attention_split_plain(
        torch.from_numpy(q), *kv, causal=True, keys_per_split=32,
        offsets=torch.from_numpy(pos))
    want = jax_paged_verify(jnp.asarray(q), jnp.asarray(kp),
                            jnp.asarray(vp), jnp.asarray(pages),
                            jnp.asarray(pos), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(verify_attention_jnp(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(pos))), **TOL)


@pytest.mark.parametrize("args,plan", [
    # the speculative window at chip_smoke's phase-3 shape: 8 slots x 8
    # KV heads over 2,048 rows -> 16 splits of 128 keys
    pytest.param((5, 16, 8, 128, BF16, 2048, 64), ("split", 16, 128),
                 id="spec-window"),
    # both sides of the 16-row line at G 2
    pytest.param((8, 16, 8, 128, BF16, 2048, 64), ("split", 16, 128),
                 id="t8-rows16"),
    pytest.param((9, 16, 8, 128, BF16, 2048, 64), ("mma", 0, 0),
                 id="t9-rows18"),
    # a prefix hit's 200-token suffix in one slot
    pytest.param((200, 16, 8, 128, BF16, 2048, 8), ("mma", 0, 0),
                 id="prefix-hit"),
    # float32 takes the CUDA-core loop at every shape
    pytest.param((5, 16, 8, 128, F32, 2048, 64), ("tile_f32", 0, 0),
                 id="f32"),
    # phi-3-vision (G 1, D 96), 8 slots over 2,048 rows: the speculative
    # window splits (5 rows), a prefix hit's suffix takes the tile route
    pytest.param((5, 32, 32, 96, BF16, 2048, 256), ("split", 5, 448),
                 id="phi3v-spec-window"),
    pytest.param((200, 32, 32, 96, BF16, 2048, 32), ("mma", 0, 0),
                 id="phi3v-prefix-hit"),
    # one slot's window over a short cache: one split per 64-key chunk
    pytest.param((5, 4, 2, 64, BF16, 304, 6), ("split", 5, 64),
                 id="small-cache"),
])
def test_window_plan(args, plan):
    t, h, kvh, d, dtype, cap, n_sets = args
    for name in ("verify_attention", "paged_verify_attention"):
        assert fops.plan(name, t, h, kvh, d, dtype, cap, n_sets,
                               132) == plan


@pytest.mark.parametrize("args,exc", [
    pytest.param((5, 4, 2, 80, BF16), ValueError, id="d80"),
    pytest.param((5, 4, 2, 64, torch.float16), TypeError, id="fp16"),
])
def test_window_plan_raises_where_no_kernel_takes_the_call(args, exc):
    t, h, kvh, d, dtype = args
    with pytest.raises(exc, match="verify_attention"):
        fops.plan("verify_attention", t, h, kvh, d, dtype, 64, 2, 132)


class _Recorder:
    """Stands in for the C entry points: records each call's entry (tile
    or split) and arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def entry(self, name, split, n_ptr, n_int, n_flag):
        def fn(*args):
            # as many arguments as ``_entry`` declares argument types
            assert len(args) == (n_ptr + 4 * split + n_int + 12 + 1
                                 + n_flag + 2)
            self.calls.append((name, split, n_ptr, n_int, args))
            return 0
        return fn


@pytest.fixture
def recorder(monkeypatch):
    """flash's ``launch`` on meta tensors: the entry points, the SM count
    and the stream stubbed, so the Python side of a launch runs without
    a card.  A meta tensor holds no values, so any host read of ``pos``
    would raise."""
    rec = _Recorder()
    monkeypatch.setattr(fops, "_entry", rec.entry)
    monkeypatch.setattr(fops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return rec


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _launch_both(t, b=8, kvh=8, g=2, d=128, s=2048, ps=16, dtype=BF16):
    """One launch of each verify kernel through flash's ``launch``, as
    the wrappers call it, on a contiguous cache of S rows and on pools
    of NB * ps = S positions."""
    h = kvh * g
    q = _meta(b, t, h, d, dtype=dtype)
    pos = _meta(b, dtype=torch.int32)
    kc, vc = _meta(b, s, kvh, d, dtype=dtype), _meta(b, s, kvh, d,
                                                     dtype=dtype)
    nb = s // ps
    kp, vp = (_meta(b * nb + 1, ps, kvh, d, dtype=dtype) for _ in "kv")
    pages = _meta(b, nb, dtype=torch.int32)
    fops.launch("verify_attention", q, kvh, s, (kc, vc),
                      (kc.data_ptr(), vc.data_ptr(), pos.data_ptr()),
                      (b, t, s, h, kvh, d),
                      (*kc.stride()[:3], *vc.stride()[:3]))
    fops.launch("paged_verify_attention", q, kvh, nb * ps, (kp, vp),
                      (kp.data_ptr(), vp.data_ptr(), pages.data_ptr(),
                       pos.data_ptr()), (b, t, h, kvh, d, nb, ps),
                      (*kp.stride()[:3], *vp.stride()[:3]))


@pytest.mark.parametrize("t,split", [(5, True), (8, True), (9, False),
                                     (200, False)])
def test_both_wrappers_launch_one_route_and_layout(recorder, t, split):
    """Equal (T, H, KVH, D, dtype, capacity): both kernels take the same
    entry (split or tile) and, on the split route, the same split count
    and keys per split, passed right after the 12 strides."""
    _launch_both(t)
    (n1, s1, p1, i1, a1), (n2, s2, p2, i2, a2) = recorder.calls
    assert (n1, n2) == ("verify_attention", "paged_verify_attention")
    assert s1 == s2 == split
    assert (p1, i1, p2, i2) == (5, 6, 6, 7)
    if split:
        lay1 = a1[p1 + 2 + i1 + 12:p1 + 2 + i1 + 14]
        lay2 = a2[p2 + 2 + i2 + 12:p2 + 2 + i2 + 14]
        assert lay1 == lay2 == (16, 128)
    assert a1[-3:] == a2[-3:]                 # scale, dtype, stream


@pytest.mark.parametrize("sq,causal,split", [(1, False, True),
                                            (4, True, True),
                                            (200, True, False)])
def test_flash_launches_through_the_same_entry(recorder, sq, causal, split):
    """Flash's calls take the same launcher as the verify kernels: its
    route and split layout over Skv keys, its causal flag between the
    scale and the dtype."""
    b, kvh, g, d, skv = 2, 8, 2, 128, 1500
    h = kvh * g
    q, k = _meta(b, sq, h, d), _meta(b, skv, kvh, d)
    fops.launch("flash_attention", q, kvh, skv, (k, k),
                (k.data_ptr(), k.data_ptr()), (b, sq, skv, h, kvh, d),
                (*k.stride()[:3], *k.stride()[:3]), flags=(int(causal),))
    (name, s, p, i, a), = recorder.calls
    assert (name, s, p, i) == ("flash_attention", split, 4, 6)
    assert a[-4:-2] == (1.0 / d ** 0.5, int(causal))
    if split:
        assert a[p + 2 + i + 12:p + 2 + i + 14] == fops._splits(
            b * kvh, skv, 132)


def test_layout_is_set_by_shapes_alone(recorder):
    """The split layout follows (B * KVH, capacity, SM count): other
    depths need no host read (``pos`` is a meta tensor here), and only a
    different capacity or slot count changes it."""
    _launch_both(5, b=8, s=2048)
    _launch_both(5, b=1, s=2048)
    _launch_both(5, b=8, s=1024)
    layouts = [c[4][c[2] + 2 + c[3] + 12:c[2] + 2 + c[3] + 14]
               for c in recorder.calls]
    assert layouts == [(16, 128)] * 2 + [(32, 64)] * 2 + [(16, 64)] * 2


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_misaligned_call_raises(recorder, dtype):
    """A row start that is not 16-byte aligned raises before anything
    launches, on every route: no quiet fall-back to another path."""
    b, t, kvh, g, d, s = 2, 5, 2, 2, 64, 128
    h = kvh * g
    k = _meta(b, s, kvh, d + 1, dtype=dtype)[..., :d]   # odd row stride
    q = _meta(b, t, h, d, dtype=dtype)
    pos = _meta(b, dtype=torch.int32)
    for name in ("verify_attention", "paged_verify_attention"):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fops.launch(name, q, kvh, s, (k, k),
                              (k.data_ptr(), k.data_ptr(), pos.data_ptr()),
                              (b, t, s, h, kvh, d),
                              (*k.stride()[:3], *k.stride()[:3]))
    q_off = _meta(b * t * h * d + 1, dtype=dtype)[1:].view(b, t, h, d)
    kc = _meta(b, s, kvh, d, dtype=dtype)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fops.launch("verify_attention", q_off, kvh, s, (kc, kc),
                          (kc.data_ptr(), kc.data_ptr(), pos.data_ptr()),
                          (b, t, s, h, kvh, d),
                          (*kc.stride()[:3], *kc.stride()[:3]))
    assert recorder.calls == []
