"""Flash attention's device routes, on the CPU.

The wrapper sends a CUDA call down one of three routes (``_route``): the
tensor-core tile kernel for bf16 with more than 16 query rows per KV
head, the split-KV kernel plus a log-sum-exp merge for bf16 with at
most 16, and the CUDA-core tile loop for float32.  The kernels run only
on a card (``chip_smoke.py`` holds them against the plain versions
there); here the split algorithm's plain version (per-split partials,
then the merge) is held against the reference's jnp
``flash_attention_jnp`` in float32 within 1e-5, and the route choice,
the split count and the alignment check are pure Python.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_attention_jnp
from repro_torch.kernels.flash_attention import ops

torch.set_num_threads(1)

# the split route's plain version against the reference, both float32:
# only the order of the sums differs
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(rng, shape, dtype="float32"):
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _inputs(seed, b, sq, skv, h, kvh, d):
    rng = np.random.default_rng(seed)
    return (_pair(rng, (b, sq, h, d)), _pair(rng, (b, skv, kvh, d)),
            _pair(rng, (b, skv, kvh, d)))


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("b,sq,skv,h,kvh,d,per,n_split", [
    # one split holding every key (keys_per_split past Skv)
    pytest.param(2, 4, 300, 4, 2, 64, 320, 1, id="1-split"),
    # three splits, the last ragged: 128 + 128 + 44
    pytest.param(2, 4, 300, 4, 2, 64, 128, 3, id="3-splits-ragged"),
    # sixteen splits of 96 over whisper's 1,500 frames (last one 60), G 4
    pytest.param(2, 1, 1500, 8, 2, 64, 96, 16, id="16-splits-skv1500"),
    # whisper's own split (8 of 192, the last 156), one query row, D 128
    pytest.param(1, 1, 1500, 2, 2, 128, 192, 8, id="8-splits-d128"),
    # 16 rows per KV head (G 4 x Sq 4), the most the route takes
    pytest.param(1, 4, 200, 8, 2, 64, 64, 4, id="16-rows"),
    # D 96 (phi-3-vision's head), G 1, 2 ragged splits
    pytest.param(2, 3, 100, 2, 2, 96, 64, 2, id="2-splits-d96"),
])
def test_split_plain_matches_reference(b, sq, skv, h, kvh, d, per, n_split,
                                       causal):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(sq + skv + d + per, b, sq, skv,
                                           h, kvh, d)
    o, m, l = ops.split_partials(qt, kt, vt, causal=causal,
                                 keys_per_split=per)
    assert o.shape == (b, kvh, n_split, sq * (h // kvh), d)
    got = ops.flash_attention_split_plain(qt, kt, vt, causal=causal,
                                          keys_per_split=per)
    want = flash_attention_jnp(qj, kj, vj, causal=causal)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_split_plain_causal_masks_whole_splits(g):
    """Four causal rows over 300 keys in splits of 64: rows see keys 0..3
    only, so splits 1-4 are wholly masked.  They carry m = -inf, l = 0
    and o = 0 and weigh nothing in the merge: no NaN."""
    kvh = 2
    (qj, qt), (kj, kt), (vj, vt) = _inputs(g, 2, 4, 300, kvh * g, kvh, 64)
    o, m, l = ops.split_partials(qt, kt, vt, causal=True, keys_per_split=64)
    assert m.shape[2] == 5
    assert bool((m[:, :, 1:] == -float("inf")).all())
    assert bool((l[:, :, 1:] == 0).all()) and bool((o[:, :, 1:] == 0).all())
    assert bool(torch.isfinite(m[:, :, 0]).all())
    got = ops.merge_partials(o, m, l)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(
        ops.flash_attention_split_plain(qt, kt, vt, causal=True,
                                        keys_per_split=64).numpy(),
        np.asarray(flash_attention_jnp(qj, kj, vj, causal=True)), **TOL)


def test_split_plain_bf16_within_the_repo_tolerance():
    """bf16 inputs (the route's only dtype on the card), the split plain
    version against the reference's bf16 jnp function within the repo's
    bf16 tolerance (tests/test_kernels.py:16)."""
    rng = np.random.default_rng(11)
    qj, qt = _pair(rng, (2, 4, 4, 64), "bfloat16")
    kj, kt = _pair(rng, (2, 777, 4, 64), "bfloat16")
    vj, vt = _pair(rng, (2, 777, 4, 64), "bfloat16")
    got = ops.flash_attention_split_plain(qt, kt, vt, causal=False,
                                          keys_per_split=64)
    want = flash_attention_jnp(qj, kj, vj, causal=False)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("args,route", [
    # whisper-small: encoder self-attention, cross-attention at decode
    # and at prefill, the decoder's 4-row causal prefill
    pytest.param((1500, 1500, 12, 12, 64, BF16), "mma", id="whisper-encoder"),
    pytest.param((1, 1500, 12, 12, 64, BF16), "split", id="whisper-cross-sq1"),
    pytest.param((4, 1500, 12, 12, 64, BF16), "split", id="whisper-cross-sq4"),
    pytest.param((4, 4, 12, 12, 64, BF16), "split", id="whisper-self-sq4"),
    # qwen3-1.7b's prefill (G 2) at a short and a long prompt
    pytest.param((1024, 1024, 16, 8, 128, BF16), "mma", id="qwen3-prefill"),
    pytest.param((9, 9, 16, 8, 128, BF16), "mma", id="qwen3-prefill-9"),
    # G * Sq = 16 is the split route's last shape, 17 the tile route's first
    pytest.param((8, 8, 4, 2, 64, BF16), "split", id="rows-16"),
    pytest.param((17, 17, 4, 4, 64, BF16), "mma", id="rows-17"),
    pytest.param((2, 300, 16, 2, 128, BF16), "split", id="rows-16-g8"),
    # phi-3-vision (G 1, D 96): a patch-prefixed prefill, a 16-row window
    pytest.param((1024, 1024, 32, 32, 96, BF16), "mma", id="phi3v-prefill"),
    pytest.param((16, 16, 32, 32, 96, BF16), "split", id="phi3v-rows-16"),
    # float32 takes the CUDA-core tile loop at every shape
    pytest.param((1, 1500, 12, 12, 64, F32), "tile_f32", id="f32-sq1"),
    pytest.param((1024, 1024, 16, 8, 128, F32), "tile_f32", id="f32-prefill"),
])
def test_route(args, route):
    assert ops._route(*args) == route


@pytest.mark.parametrize("args,exc", [
    pytest.param((4, 4, 4, 4, 80, BF16), ValueError, id="d80"),
    pytest.param((4, 4, 4, 4, 64, torch.float16), TypeError, id="fp16"),
])
def test_route_raises_where_no_kernel_takes_the_call(args, exc):
    with pytest.raises(exc):
        ops._route(*args)


@pytest.mark.parametrize("n_sets,skv,n_sm,want", [
    # whisper at B 8: 96 (b, kvh) sets x 8 splits of 192 keys
    pytest.param(96, 1500, 132, (8, 192), id="whisper"),
    pytest.param(1, 4, 132, (1, 64), id="one-chunk"),
    pytest.param(12, 4, 132, (1, 64), id="whisper-self"),
    # few sets: one 64-key chunk per split, as many splits as chunks
    pytest.param(4, 777, 132, (13, 64), id="ragged"),
    # more sets than CTAs wanted: a single split
    pytest.param(2000, 1500, 132, (1, 1536), id="many-sets"),
])
def test_splits(n_sets, skv, n_sm, want):
    n_split, per = ops._splits(n_sets, skv, n_sm)
    assert (n_split, per) == want
    assert per % ops.SPLIT_CHUNK == 0
    assert n_split * per >= skv > (n_split - 1) * per


def test_alignment_check():
    """Every (batch, seq, head) row start must be 16-byte aligned for
    the kernels' 16-byte loads; a misaligned stride or start raises."""
    ops._check_aligned(torch.empty(2, 5, 3, 64, dtype=BF16),
                       torch.empty(2, 7, 4, 128, dtype=F32))
    # a per-layer view of a stacked cache keeps every row aligned
    ops._check_aligned(torch.empty(3, 2, 9, 4, 64, dtype=BF16)[1])
    # rows of 65 elements, viewed as 64: a head stride of 130 bytes
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops._check_aligned(torch.empty(1, 4, 2, 65, dtype=BF16)[..., :64])
    # a start one element in
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops._check_aligned(torch.empty(520, dtype=BF16)[1:513]
                           .view(1, 4, 2, 64))
