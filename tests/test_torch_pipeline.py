"""The port's GPipe schedule (``parallel.pipeline``) on the CPU: four
gloo ranks, one stage each, eight microbatches, against the sequential
run of the same layers within 1e-5 (the reference's own gate,
tests/test_multidevice.py::test_pipeline_parallel_matches_sequential;
the ranks run the same float32 products, so the results are in fact
equal); every rank returns all the outputs; the bubble fraction and the
microbatch split; the refusals.

The ranks import this module (``run_tp`` spawns them), so it imports no
JAX.
"""
import pytest
import torch

from repro_torch.parallel import (bubble_fraction, pipeline_forward,
                                  run_tp, split_microbatches)

S, L_PER, M, MB, D = 4, 2, 8, 4, 32


def _weights():
    gen = torch.Generator().manual_seed(0)
    return torch.randn(S, L_PER, D, D, generator=gen) * 0.1


def _inputs():
    gen = torch.Generator().manual_seed(1)
    return torch.randn(M * MB, D, generator=gen)


def _stage_fn(wp, x):
    for i in range(L_PER):
        x = torch.tanh(x @ wp[i])
    return x


def _pipelined(rank, world, n_micro):
    f = pipeline_forward(_stage_fn, S, n_micro)
    y = f(_weights()[rank], split_microbatches(_inputs(), n_micro))
    return y.numpy()


def _all_ranks(rank, world):
    """Every rank's outputs, gathered on rank 0."""
    import torch.distributed as dist
    f = pipeline_forward(_stage_fn, S, M)
    y = f(_weights()[rank], split_microbatches(_inputs(), M))
    got = [torch.empty_like(y) for _ in range(world)]
    dist.all_gather(got, y)
    return [g.numpy() for g in got]


def _sequential():
    x = _inputs()
    for s in range(S):
        x = _stage_fn(_weights()[s], x)
    return split_microbatches(x, M)


def test_pipeline_parallel_matches_sequential():
    y = run_tp(_pipelined, S, timeout_s=120.0, args=(M,))
    ref = _sequential().numpy()
    assert y.shape == (M, MB, D)
    torch.testing.assert_close(torch.from_numpy(y), torch.from_numpy(ref),
                               rtol=1e-5, atol=1e-5)
    assert abs(bubble_fraction(S, M) - 3 / 11) < 1e-9


def test_every_rank_returns_every_output():
    outs = run_tp(_all_ranks, S, timeout_s=120.0)
    for y in outs[1:]:
        assert (y == outs[0]).all()


def test_a_stage_count_that_is_not_the_group_size_raises():
    with pytest.raises(RuntimeError, match="stages"):
        run_tp(_pipelined, 2, timeout_s=60.0, args=(M,))


def test_split_microbatches():
    x = torch.arange(24).reshape(12, 2)
    m = split_microbatches(x, 3)
    assert m.shape == (3, 4, 2) and torch.equal(m[1], x[4:8])
    with pytest.raises(ValueError):
        split_microbatches(x, 5)
    assert bubble_fraction(1, 4) == 0.0
