"""The port's attention kernels on the CPU: each plain PyTorch version
against the JAX Pallas kernel (interpret mode) and against its ``ref.py``
oracle, on the same numpy-seeded inputs; and the wrappers' routing.

Tolerances are the repo's kernel tolerances (tests/test_kernels.py:16):
float32 1e-4, bfloat16 2e-2.  The CUDA kernels themselves run only on a
card; ``chip_smoke.py`` holds them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import (
    decode_attention_ref as jax_decode_ref)
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref as jax_flash_ref
from repro.models.layers import decode_attention_jnp, flash_attention_jnp
from repro_torch.kernels.decode_attention import ops as tdec
from repro_torch.kernels.flash_attention import ops as tflash

# tiny shapes: one intra-op thread each, so that pytest-xdist workers do
# not oversubscribe the CPU that timing-sensitive tests share
torch.set_num_threads(1)

TOLS = {"float32": dict(rtol=1e-4, atol=1e-4),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_decode_plain_matches_pallas_and_ref(g, d, dtype):
    """Ragged per-slot pos (0 and S-1 included) and a scalar pos."""
    b, kvh, s = 3, 2, 256
    rng = np.random.default_rng(g * 1000 + d)
    qj, qt = _pair(rng, (b, 1, kvh * g, d), dtype)
    kj, kt = _pair(rng, (b, s, kvh, d), dtype)
    vj, vt = _pair(rng, (b, s, kvh, d), dtype)
    for pos in (np.array([0, 101, s - 1], np.int32), np.int32(77)):
        want = jax_decode(qj, kj, vj, jnp.asarray(pos), interpret=True)
        got = tdec.decode_attention_plain(qt, kt, vt, torch.tensor(pos))
        np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])
        np.testing.assert_allclose(
            _np(got), _np(decode_attention_jnp(qj, kj, vj, jnp.asarray(pos))),
            **TOLS[dtype])
        # kernel layout: (B*KVH, G, D) / (B*KVH, S, D), pos per row
        rows = np.repeat(pos, kvh) if pos.ndim else pos
        qr, kr = qj[:, 0].reshape(b * kvh, g, d), kj.transpose(0, 2, 1, 3)
        vr = vj.transpose(0, 2, 1, 3).reshape(b * kvh, s, d)
        want = jax_decode_ref(qr, kr.reshape(b * kvh, s, d), vr,
                              jnp.asarray(rows))
        got = tdec.decode_attention_ref(
            qt[:, 0].reshape(b * kvh, g, d),
            kt.transpose(1, 2).reshape(b * kvh, s, d),
            vt.transpose(1, 2).reshape(b * kvh, s, d), torch.tensor(rows))
        np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,h,kvh,d,causal", [
    pytest.param(17, 17, 4, 2, 64, True, id="17-4-2-64"),  # one ragged block
    # two blocks, ragged tail, G = 4
    pytest.param(200, 200, 8, 2, 128, True, id="200-8-2-128"),
    # MHA, one row past a block
    pytest.param(129, 129, 4, 4, 64, True, id="129-4-4-64"),
    # causal with fewer query rows than keys (rows at 0..Sq-1)
    pytest.param(77, 256, 4, 2, 64, True, id="causal-77-256-4-2-64"),
    # bidirectional: ragged Sq against two key blocks, G = 4
    pytest.param(200, 256, 8, 2, 128, False, id="bidir-200-256-8-2-128"),
    # bidirectional: one query row (a decoded token's cross-attention)
    pytest.param(1, 128, 4, 4, 64, False, id="bidir-1-128-4-4-64"),
    # phi-3-vision's head: D 96, G 1, a ragged block
    pytest.param(150, 150, 4, 4, 96, True, id="150-4-4-96"),
])
def test_flash_plain_matches_pallas_and_ref(sq, skv, h, kvh, d, causal,
                                            dtype):
    """Causal prefill attention at lengths that are not multiples of the
    Pallas kernel's 128-row blocks, and the bidirectional form (encoder,
    cross-attention) at Sq != Skv; the Pallas wrapper takes the
    bidirectional form only at Skv % 128 == 0."""
    rng = np.random.default_rng(sq + skv + h + d)
    qj, qt = _pair(rng, (1, sq, h, d), dtype)
    kj, kt = _pair(rng, (1, skv, kvh, d), dtype)
    vj, vt = _pair(rng, (1, skv, kvh, d), dtype)
    got = tflash.flash_attention_plain(qt, kt, vt, causal=causal)
    want = jax_flash(qj, kj, vj, causal=causal, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])
    # kernel layout oracle
    g = h // kvh
    qr = qj.transpose(0, 2, 1, 3).reshape(kvh, g, sq, d)
    want = jax_flash_ref(qr, kj.transpose(0, 2, 1, 3)[0],
                         vj.transpose(0, 2, 1, 3)[0], causal=causal)
    got = tflash.flash_attention_ref(
        qt.transpose(1, 2).reshape(kvh, g, sq, d), kt.transpose(1, 2)[0],
        vt.transpose(1, 2)[0], causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])


@pytest.mark.parametrize("chunk,causal,sq,skv", [
    pytest.param(64, True, 150, 150, id="64"),
    pytest.param(1024, True, 150, 150, id="1024"),
    # the reference pads q to whole chunks (150 -> 192), as it pads
    # whisper's 1,500 frames to 2,048; the port slices the last chunk
    pytest.param(64, False, 150, 150, id="bidir-64"),
    pytest.param(64, False, 150, 300, id="bidir-64-skv300"),
    pytest.param(1024, False, 3, 300, id="bidir-1024-sq3"),
])
def test_flash_plain_matches_model_jnp_chunked(chunk, causal, sq, skv):
    """The model-layout copy of ``flash_attention_jnp``, including its
    q-chunk loop with a ragged last chunk, in both forms."""
    rng = np.random.default_rng(chunk + sq + skv)
    qj, qt = _pair(rng, (2, sq, 4, 32), "float32")
    kj, kt = _pair(rng, (2, skv, 2, 32), "float32")
    vj, vt = _pair(rng, (2, skv, 2, 32), "float32")
    want = flash_attention_jnp(qj, kj, vj, causal=causal, chunk=chunk)
    got = tflash.flash_attention_plain(qt, kt, vt, causal=causal,
                                       chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), **TOLS["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bidirectional_ragged_keys_where_the_reference_asserts(dtype):
    """Whisper's encoder has 1,500 keys, and 1,500 % 128 = 92: the
    reference's Pallas wrapper asserts ``causal or Skv % block_k == 0``
    there.  The port's kernel masks keys past Skv and pads nothing, so
    its plain version takes any Skv >= 1; it is held against the
    reference's jnp ``flash_attention_jnp(causal=False)``."""
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng, (2, 40, 4, 64), dtype)
    kj, kt = _pair(rng, (2, 300, 2, 64), dtype)
    vj, vt = _pair(rng, (2, 300, 2, 64), dtype)
    with pytest.raises(AssertionError, match="Skv % block_k"):
        jax_flash(qj, kj, vj, causal=False, interpret=True)
    np.testing.assert_allclose(
        _np(tflash.flash_attention(qt, kt, vt, causal=False)),
        _np(flash_attention_jnp(qj, kj, vj, causal=False)), **TOLS[dtype])


def test_wrappers_route_cpu_tensors_to_plain_versions():
    """A CPU tensor takes the plain version and launches nothing."""
    rng = np.random.default_rng(0)
    _, q = _pair(rng, (2, 1, 4, 64), "float32")
    _, k = _pair(rng, (2, 32, 2, 64), "float32")
    _, v = _pair(rng, (2, 32, 2, 64), "float32")
    pos = torch.tensor([3, 31], dtype=torch.int32)
    n_dec, n_fl = tdec.decode_attention.launches, \
        tflash.flash_attention.launches
    torch.testing.assert_close(tdec.decode_attention(q, k, v, pos),
                               tdec.decode_attention_plain(q, k, v, pos),
                               rtol=0, atol=0)
    _, qp = _pair(rng, (2, 32, 4, 64), "float32")
    torch.testing.assert_close(tflash.flash_attention(qp, k, v),
                               tflash.flash_attention_plain(qp, k, v,
                                                            causal=True),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        tflash.flash_attention(qp, k, v, causal=False),
        tflash.flash_attention_plain(qp, k, v, causal=False),
        rtol=0, atol=0)
    assert tdec.decode_attention.launches == n_dec
    assert tflash.flash_attention.launches == n_fl


def test_wrappers_have_no_fallback_for_other_devices(monkeypatch):
    """Neither wrapper quietly computes on a device it has neither a
    kernel nor a plain route for: meta (a plain-route device, on which
    the dry-run counts) is taken out of ``PLAIN_DEVICES`` to stand for
    one.  On meta itself both take their plain versions."""
    import repro_torch.kernels as K
    q = torch.empty((1, 1, 4, 64), device="meta")
    k = torch.empty((1, 16, 2, 64), device="meta")
    assert tdec.decode_attention(q, k, k, 3).shape == q.shape
    monkeypatch.setattr(K, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="no path"):
        tdec.decode_attention(q, k, k, 3)
    with pytest.raises(ValueError, match="no path"):
        tflash.flash_attention(torch.empty((1, 16, 4, 64), device="meta"),
                               k, k)


def test_flash_wrapper_refuses_no_keys():
    """Skv = 0 has no softmax: refused on every device, both forms."""
    q = torch.zeros((1, 3, 4, 64))
    k = torch.zeros((1, 0, 2, 64))
    for causal in (True, False):
        with pytest.raises(ValueError, match="Skv = 0"):
            tflash.flash_attention(q, k, k, causal=causal)
