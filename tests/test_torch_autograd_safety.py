"""Autograd safety of the code train mode touches, on the CPU.

- ``linear_scan_plain`` and the Mamba chunk scan under autograd build
  their pairwise and log-depth products out of place (backward needs
  the operands the in-place forms overwrite) and give the same values,
  bit for bit, as the in-place forms; their gradients match finite
  differences.
- Every kernel wrapper refuses a launch under grad mode when an input
  requires grad (the kernels return tensors without a ``grad_fn``, so
  the weights behind them would get no gradient, silently): checked on
  meta tensors driven through the wrappers' CUDA branch (meta taken out
  of ``kernels.PLAIN_DEVICES``, as int8's tests add it to
  ``LAUNCH_DEVICES``), where the refusal comes before the device check;
  on CPU and meta tensors the wrappers take the plain versions, which
  are differentiable.
"""
import pytest
import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.int8_matmul.ops import int8_matmul
from repro_torch.kernels.linear_scan.ops import (linear_scan,
                                                 linear_scan_plain)
from repro_torch.kernels.paged_decode_attention.ops import (
    paged_decode_attention)
from repro_torch.kernels.paged_verify_attention.ops import (
    paged_verify_attention)
from repro_torch.kernels.verify_attention.ops import verify_attention
from repro_torch.models import mamba as M

torch.set_num_threads(1)


def _scan_inputs(dtype=torch.float32, t=40, seed=0):
    gen = torch.Generator().manual_seed(seed)
    b, h, dh = 2, 3, 8
    r, k, v = (torch.randn(b, t, h, dh, generator=gen, dtype=dtype)
               for _ in range(3))
    logw = -torch.rand(b, t, h, dh, generator=gen, dtype=dtype) * 2
    u = torch.randn(h, dh, generator=gen, dtype=dtype) * 0.3
    return r, k, v, logw, u


@pytest.mark.parametrize("chunk", [8, 40])
def test_scan_under_autograd_is_bit_for_bit_the_in_place_form(chunk):
    args = _scan_inputs()
    with torch.no_grad():
        y0, s0 = linear_scan_plain(*args, chunk=chunk, return_state=True)
    live = [a.clone().requires_grad_() for a in args]
    y1, s1 = linear_scan_plain(*live, chunk=chunk, return_state=True)
    assert torch.equal(y0, y1.detach()) and torch.equal(s0, s1.detach())
    grads = torch.autograd.grad((y1.square().sum() + s1.sum()), live)
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


def test_scan_gradients_match_finite_differences():
    """The scan computes in float32 whatever its inputs' dtype, so the
    finite differences step by 1e-3 (float32 rounding over the step is
    ~1e-4 of a derivative) and are held within 2e-3."""
    args = [a.double().requires_grad_() for a in _scan_inputs(t=6)]

    def f(r, k, v, logw, u):
        return linear_scan_plain(r, k, v, logw, u, chunk=4)

    assert torch.autograd.gradcheck(f, args, eps=1e-3, atol=2e-3,
                                    rtol=2e-3)


def test_mamba_chunk_under_autograd_is_bit_for_bit_the_in_place_form():
    gen = torch.Generator().manual_seed(2)
    a = torch.rand(2, 37, 5, 3, generator=gen) * 0.9 + 0.05
    b = torch.randn(2, 37, 5, 3, generator=gen)
    h = torch.randn(2, 5, 3, generator=gen)
    with torch.no_grad():
        want = M._ssm_chunk(a.clone(), b.clone(), h)
    la, lb = a.clone().requires_grad_(), b.clone().requires_grad_()
    got = M._ssm_chunk(la, lb, h)
    assert torch.equal(got.detach(), want)
    ga, gb = torch.autograd.grad(got.square().sum(), (la, lb))
    assert torch.isfinite(ga).all() and torch.isfinite(gb).all()
    # the inputs were not written in place under autograd
    assert torch.equal(la.detach(), a) and torch.equal(lb.detach(), b)


def test_mamba_chunk_gradients_match_finite_differences():
    gen = torch.Generator().manual_seed(3)
    a = (torch.rand(1, 9, 2, 2, generator=gen, dtype=torch.float64) * 0.9
         + 0.05).requires_grad_()
    b = torch.randn(1, 9, 2, 2, generator=gen,
                    dtype=torch.float64).requires_grad_()
    h = torch.randn(1, 2, 2, generator=gen,
                    dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b, h: M._ssm_chunk(a, b, h), (a, b, h), eps=1e-6,
        atol=1e-6)


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    t = torch.empty(shape, dtype=dtype, device="meta")
    return t.requires_grad_() if grad else t


def _calls(grad: bool):
    """Each wrapper's call on meta tensors, q (or x, r) requiring grad
    when ``grad``."""
    q1 = _meta(2, 1, 4, 64, grad=grad)
    qt = _meta(2, 5, 4, 64, grad=grad)
    kv = _meta(2, 16, 2, 64)
    pool = _meta(6, 8, 2, 64)
    pages = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    pos = torch.zeros((2,), dtype=torch.int32, device="meta")
    r = _meta(1, 8, 2, 64, grad=grad)
    f32 = dict(dtype=torch.float32)
    return {
        "flash_attention": lambda: flash_attention(qt, kv, kv),
        "decode_attention": lambda: decode_attention(q1, kv, kv, pos),
        "verify_attention": lambda: verify_attention(qt, kv, kv, pos),
        "paged_decode_attention": lambda: paged_decode_attention(
            q1, pool, pool, pages, pos),
        "paged_verify_attention": lambda: paged_verify_attention(
            qt, pool, pool, pages, pos),
        "linear_scan": lambda: linear_scan(
            r, _meta(1, 8, 2, 64), _meta(1, 8, 2, 64),
            _meta(1, 8, 2, 64, **f32), _meta(2, 64, **f32)),
        "int8_matmul": lambda: int8_matmul(
            _meta(4, 16, dtype=torch.int8), _meta(16, 8, dtype=torch.int8),
            _meta(4, 1, grad=grad, **f32), _meta(1, 8, **f32)),
    }


@pytest.mark.parametrize("name", sorted(_calls(False)))
def test_wrappers_refuse_a_launch_under_grad(name, monkeypatch):
    import repro_torch.kernels as K
    monkeypatch.setattr(K, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(RuntimeError, match=f"{name}: an input requires "
                                           f"grad"):
        _calls(True)[name]()
    # no input requiring grad, or grad mode off: past the refusal, on to
    # the device check (no kernel path for meta tensors)
    with pytest.raises(ValueError, match="no path for meta"):
        _calls(False)[name]()
    with torch.no_grad(), pytest.raises(ValueError,
                                        match="no path for meta"):
        _calls(True)[name]()


def test_cpu_tensors_that_require_grad_take_the_differentiable_plain_path():
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(1, 6, 4, 64, generator=gen, requires_grad=True)
    k = torch.randn(1, 6, 2, 64, generator=gen, requires_grad=True)
    (gq, gk) = torch.autograd.grad(flash_attention(q, k, k).sum(), (q, k))
    assert gq.abs().sum() > 0 and gk.abs().sum() > 0
    r, kk, v, logw, u = (a.requires_grad_() for a in _scan_inputs())
    y, _ = linear_scan(r, kk, v, logw, u)
    assert torch.autograd.grad(y.sum(), r)[0].abs().sum() > 0
