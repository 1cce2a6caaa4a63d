"""Roofline of a counted cell (PyTorch port of ``launch/roofline.py``).

Sources, per device (``launch/specs.py``'s program of one device):

- ``launch.opcount.OpCount``: FLOPs and bytes accessed (the
  reference's ``compiled.cost_analysis()``), peak temp bytes (its
  ``memory_analysis()``);
- ``Cell.arg_bytes``: the arguments' shards under their partition specs
  (``memory_analysis().argument_size_in_bytes``);
- ``Cell.records``: the collectives the plan implies, as (kind, result
  bytes, group size), where the reference parses the post-SPMD HLO.

Terms (seconds, H100 SXM constants unless ``chip`` says otherwise):
  compute    = FLOPs / peak bf16 FLOP/s
  memory     = bytes / HBM bandwidth
  collective = collective bytes / link bandwidth

The collective term divides by ``chip.ici_bandwidth``, one NVLink link's
rate (50 GB/s on the H100), as the reference divides by one ICI link's.
Within a host of 8 H100s the links are NVLink; between hosts the bytes
cross the network, whose rate this term does not model.
"""
from __future__ import annotations

import dataclasses

from repro_torch.hw import H100_SXM, ChipSpec


def collective_bytes(records, n_devices: int = 2) -> dict:
    """Per-device wire bytes per collective kind, from (kind, result
    bytes, group size) records (a group of 0 or ``None`` means all
    ``n_devices``), with the standard ring / all-to-all cost model (per
    participating device):
      all-reduce:         2 * size * (g-1)/g       (reduce-scatter+AG ring)
      all-gather:         result * (g-1)/g         (result = gathered size)
      reduce-scatter:     result * (g-1)            (input = result * g)
      all-to-all:         size * (g-1)/g
      collective-permute: result
    ``"_counts"`` holds each kind's number of records."""
    out: dict = {}
    count: dict = {}
    for kind, size, g in records:
        g = g or n_devices
        if g <= 1:
            continue
        frac = (g - 1) / g
        if kind == "all-reduce":
            b = 2.0 * size * frac
        elif kind == "all-gather":
            b = size * frac
        elif kind == "reduce-scatter":
            b = size * (g - 1)
        elif kind == "all-to-all":
            b = size * frac
        else:                   # collective-permute
            b = float(size)
        out[kind] = out.get(kind, 0.0) + b
        count[kind] = count.get(kind, 0) + 1
    out["_counts"] = count
    return out


@dataclasses.dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    # per-device quantities
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    # model-level sanity
    model_flops: float            # global useful FLOPs (6ND / 2ND)
    model_flops_ratio: float      # model_flops / (flops * n_devices)
    # memory analysis (per device, bytes)
    arg_bytes: int = 0
    temp_bytes: int = 0
    out_bytes: int = 0
    alias_bytes: int = 0
    fits_hbm: bool = True
    step_s: float = 0.0
    # analytic HBM floor (weights/cache must stream at least once):
    # the counted bytes are pre-fusion and thus an upper bound; the
    # floor bounds the truth from below.
    min_hbm_bytes: float = 0.0
    memory_floor_s: float = 0.0
    notes: str = ""
    # why the collective term has no compiled program of the reference
    # behind it ("" where the collective-plan tests hold it):
    # ``launch.specs.unchecked_layout``
    collectives_unchecked: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "CellReport":
        return CellReport(**d)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (forward-only); N = active
    matmul params (MoE counts top-k + shared only; the input-embedding
    table is a gather, not a matmul, so it is excluded — the lm_head
    remains counted).  D = tokens processed."""
    n = cfg.active_param_count() if cfg.moe is not None else cfg.param_count()
    n -= cfg.vocab_size * cfg.d_model          # input embedding gather
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: one token each


def _terms(flops: float, hbm: float, coll: float, chip: ChipSpec):
    return {"compute": flops / chip.peak_flops_bf16,
            "memory": hbm / chip.hbm_bandwidth,
            "collective": coll / chip.ici_bandwidth}


def analyze(cell, counts, *, chip: ChipSpec = H100_SXM, mesh_name: str = "",
            out_bytes: int = 0, alias_bytes: int = 0) -> CellReport:
    """The report of ``cell`` (``launch.specs.Cell``) from its count
    (``launch.opcount.OpCount``: ``flops``, ``bytes``, ``temp_bytes``);
    ``out_bytes``/``alias_bytes``: the step's outputs' bytes and those of
    them written in place over an argument."""
    n_dev = cell.n_devices
    coll = collective_bytes(cell.records, n_dev)
    n_coll = coll.pop("_counts", {})
    cbytes = float(sum(coll.values()))
    flops, hbm = float(counts.flops), float(counts.bytes)
    terms = _terms(flops, hbm, cbytes, chip)
    mf = model_flops_for(cell.cfg, cell.shape)
    arg = int(cell.arg_bytes)
    tmp = int(counts.temp_bytes)
    min_hbm = analytic_min_bytes(cell.cfg, cell.shape, n_dev)
    return CellReport(
        arch=cell.cfg.name, shape=cell.shape.name, mesh=mesh_name,
        n_devices=n_dev, flops=flops, hbm_bytes=hbm, coll_bytes=cbytes,
        coll_breakdown={**{k: float(v) for k, v in coll.items()},
                        "counts": n_coll},
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"],
        bottleneck=max(terms, key=terms.get),
        model_flops=mf,
        model_flops_ratio=mf / max(flops * n_dev, 1.0),
        arg_bytes=arg, temp_bytes=tmp, out_bytes=int(out_bytes),
        alias_bytes=int(alias_bytes),
        fits_hbm=arg + tmp <= chip.hbm_capacity,
        step_s=max(terms.values()),
        min_hbm_bytes=min_hbm,
        memory_floor_s=min_hbm / chip.hbm_bandwidth,
        collectives_unchecked=cell.unchecked,
    )


def analytic_min_bytes(cfg, shape, n_devices: int) -> float:
    """Per-device HBM traffic floor: parameters (and KV/state cache)
    must stream from HBM at least once per step; training adds grad and
    optimizer-state traffic; activations add one write+read per layer."""
    p_bytes = cfg.param_count() * 2 / n_devices            # bf16 shards
    tokens = shape.global_batch * shape.seq_len / n_devices
    act = tokens * cfg.d_model * 2 * cfg.n_layers * 2      # write+read
    if shape.kind == "train":
        # params fwd+bwd reads, grad write+read, opt m/v f32 rw, fp32 upd
        return 4 * p_bytes + 2 * p_bytes + 4 * 2 * 2 * p_bytes + act
    if shape.kind == "prefill":
        return p_bytes + act
    # decode: params + cache read (+ small write)
    cache = 0.0
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        cache = cfg.n_layers * shape.seq_len * per_tok * 2
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.hybrid.attn_period
        cache = n_attn * shape.seq_len * kvh * dh * 2 * 2
        d_in = cfg.mamba.expand * cfg.d_model
        cache += (cfg.n_layers - n_attn) * d_in * cfg.mamba.d_state * 4
    elif cfg.family == "rwkv":
        from repro_torch.models.rwkv6 import padded_heads
        cache = cfg.n_layers * padded_heads(cfg) * dh * dh * 4
    elif cfg.family == "encdec":
        cache = cfg.n_layers * (shape.seq_len + cfg.encdec.enc_len) \
            * kvh * dh * 2 * 2
    else:
        cache = cfg.n_layers * shape.seq_len * kvh * dh * 2 * 2
    return p_bytes + cache * shape.global_batch / n_devices


def apply_calibration(report: CellReport, cal, *,
                      chip: ChipSpec = H100_SXM) -> CellReport:
    """Replace the report's costs with calibrated totals."""
    r = dataclasses.replace(
        report,
        flops=cal.flops, hbm_bytes=cal.hbm_bytes, coll_bytes=cal.coll_bytes,
        coll_breakdown={**cal.coll_breakdown,
                        "raw_counts": report.coll_breakdown.get("counts")},
        compute_s=cal.flops / chip.peak_flops_bf16,
        memory_s=cal.hbm_bytes / chip.hbm_bandwidth,
        collective_s=cal.coll_bytes / chip.ici_bandwidth,
    )
    terms = {"compute": r.compute_s, "memory": r.memory_s,
             "collective": r.collective_s}
    return dataclasses.replace(
        r, bottleneck=max(terms, key=terms.get),
        step_s=max(terms.values()),
        model_flops_ratio=r.model_flops / max(r.flops * r.n_devices, 1.0),
        notes=(report.notes + " calibrated").strip())


def render_table(reports: list) -> str:
    hdr = (f"{'arch':<20} {'shape':<12} {'mesh':<10} {'flops/dev':>10} "
           f"{'bytes/dev':>10} {'coll/dev':>10} {'t_comp':>9} {'t_mem':>9} "
           f"{'t_coll':>9} {'bneck':>10} {'MF-ratio':>8} {'GB/dev':>7} "
           f"{'fits':>5} {'coll plan':>9}")
    lines = [hdr, "-" * len(hdr)]
    for r in reports:
        live_gb = (r.arg_bytes + r.temp_bytes) / 2**30
        lines.append(
            f"{r.arch:<20} {r.shape:<12} {r.mesh:<10} {r.flops:>10.3e} "
            f"{r.hbm_bytes:>10.3e} {r.coll_bytes:>10.3e} "
            f"{r.compute_s:>9.4f} {r.memory_s:>9.4f} {r.collective_s:>9.4f} "
            f"{r.bottleneck:>10} {r.model_flops_ratio:>8.3f} "
            f"{live_gb:>7.2f} {str(r.fits_hbm):>5} "
            f"{'unchecked' if r.collectives_unchecked else 'checked':>9}")
    return "\n".join(lines)
