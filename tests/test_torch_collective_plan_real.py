"""The dry-run's collective plan against the reference's compiled program
at the dry-run's own cells: the archs at their own widths, train_4k and
prefill_32k, on the production (16, 16) mesh of forced host devices, at
2 and 3 layers (one layer is the difference), counted as
``tests/test_torch_collective_plan.py`` counts.

What the small meshes cannot show: the reference's attention runs in
query chunks of ``attn_chunk`` (1,024) tokens, so a 4,096-token train
step has 4 and a 32,768-token prefill 32, where the 64-token programs
of the other files have one.  The forward pass keeps its layout over
chunks: every GQA prefill cell's layer equals the plan by (kind,
operand shape).  The backward pass does not: XLA lays the chunked
attention's backward out by the head counts (gathers of a chunk's
scores, per-chunk reductions of the K/V gradients), which the plan
leaves out and calls unchecked (``unchecked_layout``); the rest of a
train cell's layer is in the program as planned.

XLA's CPU backend carries bf16 tensors' collectives in float32, so the
program's bytes are twice the plan's, which counts the config's bf16.
"""
import pytest

import test_torch_collective_plan as plan22

MESH = (16, 16)
PREFILL = {(arch, "prefill", "nothing"): (2, 3)
           for arch in ("granite-3-2b", "qwen2.5-3b", "qwen3-1.7b", "yi-9b",
                        "qwen3-moe-30b-a3b", "phi-3-vision-4.2b")}
TRAIN = {(arch, "train", "nothing"): (2, 3)
         for arch in ("qwen3-1.7b", "qwen3-moe-30b-a3b")}
SHAPES = {"prefill": (32, 32768), "train": (256, 4096)}


@pytest.fixture(scope="module")
def layers():
    runs = {"prefill": PREFILL, "train": TRAIN}
    started = {k: plan22.start_reference(MESH, cells, *SHAPES[k], full=True)
               for k, cells in runs.items()}
    plans = {k: plan22.plan_layers(MESH, cells, *SHAPES[k], full=True)
             for k, cells in runs.items()}
    out = {}
    for k in runs:
        ref = plan22.reference_layers(started[k])
        out.update({c: (ref[c], plans[k][c]) for c in runs[k]})
    return out


@pytest.mark.parametrize("cell", list(PREFILL), ids=[c[0] for c in PREFILL])
def test_prefill_layer_equals_the_program_at_the_dry_run_s_cell(layers,
                                                                 cell):
    """A prefill_32k layer's activation collectives by (kind, operand
    shape) equal the program's at the dry-run's own width and mesh, over
    32 query chunks, for each layout the GQA cells take at a model axis
    of 16 (KV heads dividing it: granite, qwen2.5, qwen3, yi,
    qwen3-moe; split with it: phi-3-vision); their bytes are half the
    CPU-compiled program's (float32 there)."""
    ref, plan = layers[cell]
    plan22.print_bytes(cell, ref, plan)
    assert plan["unchecked"] == ""
    assert plan["acts"] == ref["acts"]
    assert sum(plan["acts"].values()) > 0
    for k in plan22.KINDS:
        assert 2 * plan["act_bytes"][k] == pytest.approx(
            ref["act_bytes"][k], rel=1e-12), k


@pytest.mark.parametrize("cell", list(TRAIN), ids=[c[0] for c in TRAIN])
def test_train_plan_is_the_program_less_the_chunked_backward(layers, cell):
    """A train_4k layer over 4 query chunks: every record of the plan is
    in the program (the forward pass, the recompute, the projections'
    and norms' backward, the MoE capacity buffers), and what the program
    has more is the chunked attention's backward, which the plan leaves
    out and names (``unchecked_layout``).  The residual's wire bytes by
    kind are printed (``-s``)."""
    ref, plan = layers[cell]
    plan22.print_bytes(cell, ref, plan)
    assert "query chunks" in plan["unchecked"]
    more = ref["acts"].copy()
    more.subtract(plan["acts"])
    assert min(more.values()) >= 0, {k: v for k, v in more.items() if v < 0}
    assert sum(plan["acts"].values()) > 0
    print(f"{cell[0]}: the program's chunked backward beyond the plan: "
          f"{dict(+more)}")
