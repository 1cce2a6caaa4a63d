"""The C launch code's geometry, mirrored for the launch contracts.

Each kernel package's ``CONTRACTS`` (``repro_torch.analysis.contracts``)
describe the launches its wrapper makes.  This module holds, once, the
constants and the shared-memory arithmetic of the CUDA sources those
launches read (``csrc/*.cu``, ``*.cuh``; each constant names its
source), and the ``Launch`` builders of the launch sites that several
wrappers share: the decode pair's split grid and merge, flash's and the
verify kernels' tensor-core tile grid, split grid and merge, and the
float32 tile loops.  ``tests/test_torch_analysis.py`` holds every
constant against the C source it copies, and ``chip_smoke.py`` phase 29
holds every launch against the card's record of it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.contracts import Buffer, KernelInstance, Launch

BF16 = "__nv_bfloat16"
# the G = H / KVH every attention kernel is built for (``dispatch_g``)
GROUPS = (1, 2, 4, 8)
# the H100 SXM's SMs: a contract case's default for the split layouts
N_SM = 132

# ptxas's placement of some kernels' shared arrays: their -v report on the
# H100 gives the whole a multiple of 128 bytes (flash_split_kernel at D 128:
# 46,592 bytes for 46,528 declared; attend_tile's loops at every D: 64
# bytes over), where the decode bodies, the scan loop and the int8 sync
# kernel take exactly what they declare.  chip_smoke.py phase 29 holds
# every launch's static shared memory to ptxas's report.
SMEM_PLACEMENT = 128


def placed(nbytes: int) -> int:
    """``nbytes`` of shared arrays as ptxas places them (see
    ``SMEM_PLACEMENT``)."""
    return -(-nbytes // SMEM_PLACEMENT) * SMEM_PLACEMENT


# --- split_merge.cuh ------------------------------------------------------
MAX_SPLITS = 4096                 # kMaxSplits


def merge_smem_bytes(n_split: int) -> int:
    """``merge_smem_bytes``: each split's (m, l) pair, float32."""
    return 2 * n_split * 4


# --- decode_split.cuh -----------------------------------------------------
DECODE_SPLIT_THREADS = 128        # kThreads
DECODE_SPLIT_WARPS = DECODE_SPLIT_THREADS // 32
DECODE_SPLIT_STAGES = 3           # kStages
DECODE_SPLIT_STAGE_ELEMS = 4096   # kMaxStageElems


def decode_split_chunk(d: int) -> int:
    """``Shape<D>::kChunk``: keys a ring stage holds."""
    pieces = d // 8
    lanes = 8 if pieces & (pieces - 1) else pieces
    groups = 32 // lanes
    keys = DECODE_SPLIT_WARPS * groups
    return DECODE_SPLIT_STAGE_ELEMS // d // keys * keys


def decode_split_smem(d: int) -> int:
    """The K/V ring ``ring[kStages][2][kStageElems]`` of bf16."""
    return DECODE_SPLIT_STAGES * 2 * decode_split_chunk(d) * d * 2


# --- decode_body.cuh ------------------------------------------------------
DECODE_LOOP_WARPS = 8             # kDecodeWarps
DECODE_LOOP_THREADS = DECODE_LOOP_WARPS * 32


def decode_loop_smem(g: int, d: int) -> int:
    """``sm_m``, ``sm_l`` (kDecodeWarps x G) and ``sm_acc`` (kDecodeWarps
    x G x D), float32."""
    return DECODE_LOOP_WARPS * g * 4 * 2 + DECODE_LOOP_WARPS * g * d * 4


# --- flash_mma.cuh --------------------------------------------------------
MMA_BK = 64                       # kBK
MMA_WARPS = 4                     # kWarps
MMA_THREADS = 32 * MMA_WARPS
MMA_STAGES = 3                    # kStages


def mma_block_q(d: int) -> int:
    """``block_q<D>``: 16-row m-tiles, two a warp at D 64."""
    return 16 * MMA_WARPS * (2 if d == 64 else 1)


def mma_smem(d: int) -> int:
    """``smem_bytes<D>``: the Q tile and kStages K and V tiles, bf16."""
    return (mma_block_q(d) + 2 * MMA_STAGES * MMA_BK) * d * 2


# --- flash_split.cuh ------------------------------------------------------
SPLIT_ROWS = 16                   # kRows
SPLIT_CHUNK = 64                  # kChunk
SPLIT_THREADS = 128               # kThreads


def flash_split_smem(d: int) -> int:
    """``qs`` (f32), ``ks`` (bf16, rows padded by 8), ``vs`` (bf16),
    ``ps`` (f32, rows padded by 4), ``m_s``, ``l_s``, ``a_s``, as placed
    (``placed``)."""
    return placed(SPLIT_ROWS * d * 4 + SPLIT_CHUNK * (d + 8) * 2
                  + SPLIT_CHUNK * d * 2 + SPLIT_ROWS * (SPLIT_CHUNK + 4) * 4
                  + 3 * SPLIT_ROWS * 4)


# --- attention_tile.cuh ---------------------------------------------------
TILE_BQ = 32                      # kBQ
TILE_BK = 16                      # kBK
TILE_THREADS = 128                # kTileThreads


def tile_smem(d: int) -> int:
    """``attend_tile<float, D>``: ``qs``, ``ks``, ``vs``, ``ps`` (f32)
    and the ``krow``/``vrow`` pointers, as placed (``placed``)."""
    return placed(TILE_BQ * (d + 1) * 4 + TILE_BK * (d + 1) * 4
                  + TILE_BK * d * 4 + TILE_BQ * (TILE_BK + 1) * 4
                  + 2 * TILE_BK * 8)


# --- int8_matmul.cu (mma.sync) and int8_wgmma.cuh -------------------------
SYNC_BM = 128                     # kBM
SYNC_BN = 64                      # kBN
SYNC_BK = 64                      # kBK
SYNC_ROW = SYNC_BK + 16           # kRow
SYNC_THREADS = 256                # kThreads
SYNC_SMEM = 2 * (SYNC_BM + SYNC_BN) * SYNC_ROW    # Stage stages[2]

WGMMA_BM = 128                    # kBM
WGMMA_BN = 128                    # kBN
WGMMA_BK = 128                    # kBK
WGMMA_STAGES = 4                  # kStages
WGMMA_THREADS = 256 + 128 + 32    # kConsumers + transposer + producer
WGMMA_SMEM = (WGMMA_STAGES * (WGMMA_BM * WGMMA_BK + 2 * WGMMA_BK * WGMMA_BN)
              + (4 * WGMMA_STAGES + 1) * 8 + (WGMMA_BM + WGMMA_BN) * 4
              + 1024)             # kSmem

# --- linear_scan.cu (loop) and scan_chunked.cuh ---------------------------
SCAN_STAGE_FLOATS = 1024          # kStageFloats
SCAN_SUB = 16                     # kSub
SCAN_VB = 32                      # kVB
SCAN_P = 256                      # kP: the intra-chunk grid's threads
SCAN_Q = 128                      # kQ: the carry grid's threads
SCAN_CARRY_STAGES = 3             # CarryLayout::NS


def scan_loop_smem(d: int) -> int:
    """``r_s``, ``k_s``, ``w_s``, ``v_s`` (TS x D), ``p_s`` (TS x (D +
    1)) and ``bonus_s`` (TS), float32, TS = kStageFloats / D."""
    ts = SCAN_STAGE_FLOATS // d
    return 4 * ts * d * 4 + ts * (d + 1) * 4 + ts * 4


def scan_chunk_steps(d: int) -> int:
    """``chunk_steps<D>``: 64, or 32 at D 128."""
    return 32 if d == 128 else 64


def scan_chunk_floats(d: int, c: int) -> int:
    """``chunk_floats<D, C>``: a chunk's y part, carried factor, state
    increment and decay."""
    return 2 * c * d + d * d + d


def scan_intra_smem(d: int, c: int) -> int:
    """``IntraLayout<D, C>::kBytes``."""
    nb = c // SCAN_SUB
    npair = nb * (nb - 1) // 2
    ldf, ldh, lda = d + 4, d + 8, c + 4
    nvec = nb + npair + nb + 1
    raw = c * ldf * 4 + 2 * c * ldh * 2
    fac = 2 * c * ldf * 4
    return (max(raw, fac) + c * ldh * 2 + c * lda * 4 + nvec * d * 4
            + (nb + 1) * d * 4 + SCAN_P * 4 + d * 4)


def scan_carry_smem(d: int, c: int) -> int:
    """``CarryLayout<D, C>::kBytes``."""
    ldr, ldv, lds = d + 4, SCAN_VB + 4, SCAN_VB + 8
    stage = (c * ldr + c * ldv + d * ldv + d) * 4
    return SCAN_CARRY_STAGES * stage + d * lds * 4


# --- spills ----------------------------------------------------------------
# Builds that ptxas reports spilling (bytes of spill stores, as many
# loaded); every other build of the port spills nothing.  The G 8, D 96
# split decode bodies hold 8 query rows of 96 floats in registers (254-255
# of them); the float32 decode loop at G 2, D 128 was found spilling by
# phase 29's first run (80 registers; no model runs the float32 decode on
# the card).
KNOWN_SPILLS = {
    f"decode_split_kernel<8,96,ContiguousCache<{BF16}>>": 40,
    f"decode_split_kernel<8,96,PagedCache<{BF16}>>": 60,
    "decode_attention_kernel<2,128>": 12,
}


def make_launch(**kw) -> Launch:
    ln = Launch(**kw)
    return dataclasses.replace(
        ln, spill_bytes=KNOWN_SPILLS.get(ln.signature, 0))


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# --- launch builders --------------------------------------------------------

def decode_split_launches(g: int, d: int, sets: int, n_split: int,
                          cache: str) -> tuple:
    """``decode_split.cuh:launch_gd``: the split grid (sets, n_split) of
    ``kThreads``, each CTA's partial (o_part, ml_part tile (set, split)),
    then the merge (sets, G) of D threads, each CTA one output row (set,
    g) from every split's partial.  Buffers: ``o`` (sets, G, D) tiled (1,
    1, D); ``o_part`` (sets, n_split, G, D) and ``ml_part`` (sets,
    n_split, G, 2), tiled one split's G rows.  A split past its slot's
    depth writes only (m, l) = (-inf, 0) and leaves o_part unwritten: the
    merge reads and drops it."""
    split = make_launch(
        kernel="decode_split_kernel",
        template=(str(g), str(d), f"{cache}<{BF16}>"),
        grid=(sets, n_split, 1), threads=DECODE_SPLIT_THREADS,
        launch_bound=DECODE_SPLIT_THREADS,
        static_smem=decode_split_smem(d),
        writes=lambda x, y, z: (("o_part", (x, y, 0, 0)),
                                ("ml_part", (x, y, 0, 0))),
        loops=("the split's keys, decode_split_chunk(D) a ring stage",))
    merge = _merge(("HeadRowsOut",), (sets, g, 1), d, n_split,
                   lambda x, y: (x, y, 0))
    return split, merge


def _merge(out_type: tuple, grid: tuple, d: int, n_split: int,
           o_tile) -> Launch:
    """``split_merge.cuh:merge_splits_kernel`` over grid (sets, R): CTA
    (set, r) reads every split's partial of set ``set`` and writes
    output row ``o_tile(set, r)``."""
    return make_launch(
        kernel="merge_splits_kernel", template=(BF16, *out_type),
        grid=grid, threads=d, launch_bound=None,
        dynamic_smem=merge_smem_bytes(n_split),
        writes=lambda x, y, z: (("o", o_tile(x, y)),),
        reads=lambda x, y, z: [(name, (x, s, 0, 0))
                               for s in range(n_split)
                               for name in ("o_part", "ml_part")],
        loops=("the row's splits, in order",))


def flash_split_launches(d: int, sets: int, n_split: int, rows: int,
                         cache: str, o_tile) -> tuple:
    """``flash_split.cuh:split_kv::launch``: the split grid (sets,
    n_split) of ``kThreads`` (partials tile (set, split) of R = G * Sq
    rows), then the merge (sets, R) of D threads; ``o_tile(set, r)`` is
    row r's output tile in the caller's layout (``SetRowsOut``)."""
    split = make_launch(
        kernel="flash_split_kernel", template=(str(d), f"{cache}<{BF16}>"),
        grid=(sets, n_split, 1), threads=SPLIT_THREADS,
        launch_bound=SPLIT_THREADS, static_smem=flash_split_smem(d),
        writes=lambda x, y, z: (("o_part", (x, y, 0, 0)),
                                ("ml_part", (x, y, 0, 0))),
        loops=(f"the split's keys, {SPLIT_CHUNK} a chunk",))
    merge = _merge(("SetRowsOut",), (sets, rows, 1), d, n_split, o_tile)
    return split, merge


def mma_launch(d: int, b: int, h: int, sq: int, causal: bool,
               cache: str, o_tile) -> Launch:
    """``flash_mma.cuh:mma_tile::launch``: grid (ceil(Sq / block_q),
    B * H) of ``kThreads`` with ``smem_bytes<D>`` of dynamic shared
    memory (opted in); CTA (x, y) takes q-tile x (the last first when
    causal) of head y % H of batch y // H; ``o_tile(b, head, q-tile)``
    is its output tile."""
    nq = ceil_div(sq, mma_block_q(d))

    def writes(x, y, z):
        qt = nq - 1 - x if causal else x
        return (("o", o_tile(y // h, y % h, qt)),)

    return make_launch(
        kernel="flash_mma_kernel", template=(str(d), f"{cache}<{BF16}>"),
        grid=(nq, b * h, 1), threads=MMA_THREADS, launch_bound=MMA_THREADS,
        dynamic_smem=mma_smem(d), opt_in=True, writes=writes,
        loops=(f"the visible keys, {MMA_BK} a tile through a "
               f"{MMA_STAGES}-stage ring",))


def split_buffers(sets: int, n_split: int, rows: int, d: int) -> tuple:
    """The split routes' float32 scratch: o_part (sets, n_split, R, D)
    and ml_part (sets, n_split, R, 2), tiled one split's R rows."""
    return (Buffer("o_part", (sets, n_split, rows, d), "float32",
                   "scratch", (1, 1, rows, d)),
            Buffer("ml_part", (sets, n_split, rows, 2), "float32",
                   "scratch", (1, 1, rows, 2)))


def tile_f32_launch(kernel: str, template: tuple, grid: tuple,
                    writes) -> Launch:
    """A float32 CUDA-core tile loop of ``attention_tile.cuh``
    (``flash_attention_kernel``, ``window_tile_kernel``): ``kTileThreads``
    threads and ``attend_tile``'s static shared memory."""
    d = int(template[1])
    return make_launch(kernel=kernel, template=template, grid=grid,
                   threads=TILE_THREADS, launch_bound=TILE_THREADS,
                   static_smem=tile_smem(d), writes=writes,
                   loops=(f"the visible keys, {TILE_BK} a tile",))


def attention_inputs(q_shape: tuple, kv_shape: tuple, dtype: str,
                     extra: tuple = ()) -> tuple:
    """The q, k, v input buffers, then ``extra`` (pos, pages)."""
    return (Buffer("q", q_shape, dtype, "input"),
            Buffer("k", kv_shape, dtype, "input"),
            Buffer("v", kv_shape, dtype, "input"), *extra)


def decode_instance(route: str, n_split: int, per: int, b: int, kvh: int,
                    g: int, d: int, dtype: str, cache: str,
                    loop_kernel: str, kv_shape: tuple,
                    extra: tuple) -> KernelInstance:
    """Either decode kernel's call (``decode_attention.cu``,
    ``paged_decode_attention.cu``): on the split route
    ``decode_split_launches`` over ``cache``, on the loop route
    ``loop_kernel<G, D>``, grid (B * KVH) of ``kDecodeThreads``, one CTA
    a (slot, KV head) writing its G rows.  ``o`` is (B * KVH, G, D), the
    reference contract's layout."""
    sets = b * kvh
    q_shape = (sets, g, d)
    ins = attention_inputs(q_shape, kv_shape, dtype, extra)
    if route == "split":
        o = Buffer("o", q_shape, dtype, "output", (1, 1, d))
        return KernelInstance(
            route, decode_split_launches(g, d, sets, n_split, cache),
            (*ins, o, *split_buffers(sets, n_split, g, d)),
            split=(n_split, per))
    o = Buffer("o", q_shape, dtype, "output", (1, g, d))
    loop = make_launch(
        kernel=loop_kernel, template=(str(g), str(d)), grid=(sets, 1, 1),
        threads=DECODE_LOOP_THREADS, launch_bound=DECODE_LOOP_THREADS,
        static_smem=decode_loop_smem(g, d),
        writes=lambda x, y, z: (("o", (x, 0, 0)),),
        loops=("positions 0..pos of the slot, a warp's share each",))
    return KernelInstance(route, (loop,), (*ins, o))


def window_instance(route: str, n_split: int, per: int, b: int, t: int,
                    h: int, kvh: int, d: int, dtype: str, cache: str,
                    kv_shape: tuple, extra: tuple) -> KernelInstance:
    """Either verify kernel's call through ``window_attention.cuh``: the
    tile route (``mma_launch``, causal, window rows at offset pos), the
    split route (``flash_split_launches``, rows r = t * G + g) or the
    float32 loop (``window_tile_kernel``, grid (ceil(T * G / kBQ), B *
    KVH), CTA (x, set) the flattened rows x * kBQ ..).  ``o`` is (B *
    KVH, T, G, D), the reference contract's layout."""
    g = h // kvh
    sets = b * kvh
    shape = (sets, t, g, d)
    ins = attention_inputs((b, t, h, d), kv_shape, dtype, extra)
    if route == "mma":
        bq = mma_block_q(d)
        o = Buffer("o", shape, dtype, "output", (1, bq, 1, d), masked=True)
        ln = mma_launch(d, b, h, t, True, cache,
                        lambda bb, hh, qt: (bb * kvh + hh // g, qt,
                                            hh % g, 0))
        return KernelInstance(route, (ln,), (*ins, o))
    if route == "split":
        o = Buffer("o", shape, dtype, "output", (1, 1, 1, d))
        lns = flash_split_launches(d, sets, n_split, t * g, cache,
                                   lambda x, r: (x, r // g, r % g, 0))
        return KernelInstance(
            route, lns, (*ins, o, *split_buffers(sets, n_split, t * g, d)),
            split=(n_split, per))
    o = Buffer("o", shape, dtype, "output", (1, 1, 1, d), masked=True)
    ln = tile_f32_launch(
        "window_tile_kernel", ("float", str(d), f"{cache}<float>"),
        (ceil_div(t * g, TILE_BQ), sets, 1),
        lambda x, y, z: [("o", (y, r // g, r % g, 0))
                         for r in range(x * TILE_BQ, (x + 1) * TILE_BQ)])
    return KernelInstance(route, (ln,), (*ins, o))


def static_smem(signature: str) -> int:
    """The static shared memory of any build of the port's kernels, by
    its ``Launch.signature`` (``kernel<args>``): what phase 29 holds
    every library's ptxas report to, launched or not."""
    base, _, rest = signature.partition("<")
    args = rest[:-1].split(",") if rest else []
    if base == "decode_split_kernel":
        return decode_split_smem(int(args[1]))
    if base in ("decode_attention_kernel", "paged_decode_attention_kernel"):
        return decode_loop_smem(int(args[0]), int(args[1]))
    if base == "flash_split_kernel":
        return flash_split_smem(int(args[0]))
    if base in ("flash_attention_kernel", "window_tile_kernel"):
        return tile_smem(int(args[1]))
    if base == "linear_scan_kernel":
        return scan_loop_smem(int(args[1]))
    if base == "int8_matmul_kernel":
        return SYNC_SMEM
    # dynamic shared memory only: the tile, wgmma, scan and merge kernels
    return 0
