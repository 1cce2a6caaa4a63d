"""Flash attention, causal or bidirectional: the CUDA kernels' wrapper
and their plain versions.

``flash_attention`` is the model-layout entry point that the prefill
(causal), whisper's encoder and its cross-attention (bidirectional,
Sq != Skv there) use.
A CPU tensor goes to ``flash_attention_plain`` (the copy of the
reference's ``flash_attention_jnp``); a CUDA tensor launches one of
three hand-written routes (``_route``, by dtype and by the G * Sq query
rows that share a KV head) or raises:

* bfloat16, G * Sq > 16: the tensor-core tile kernel
  (``csrc/flash_mma.cuh``) -- the LM prefill, whisper's encoder, every
  speculative admission;
* bfloat16, G * Sq <= 16: the split-KV kernel and its log-sum-exp merge
  (``csrc/flash_split.cuh``, ``csrc/split_merge.cuh``) -- whisper's
  cross-attention at decode (Sq 1) and prefill (Sq 4) and its decoder's
  4-row causal prefill; ``flash_attention_split_plain`` is its plain
  version;
* float32: the CUDA-core tile loop (``csrc/attention_tile.cuh``), a
  build the models do not run on the card.

No route is taken because another failed.  ``flash_attention.launches``
counts calls that launched a kernel (one per call, although the split
route runs two grids).

Replaces ``src/repro/kernels/flash_attention/flash_attention.py:
flash_attention_kernel`` (wrapper ``ops.py:flash_attention``) in both
forms of its ``causal`` switch.  The reference model runs its prefill,
encoder and cross-attention through the jnp ``flash_attention_jnp``;
the port runs these kernels there instead, held against that function.
The kernels mask the ragged tail themselves, so unlike the reference
wrapper this one pads nothing, and it takes whisper's 1,500 keys in the
bidirectional form, where the reference wrapper asserts
``causal or Skv % block_k == 0``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, count_launch

MASK_VALUE = -1e30

# The split-KV route takes a (batch, KV head)'s query rows when there are
# at most SPLIT_MAX_ROWS of them (one CTA holds them all); it streams keys
# in SPLIT_CHUNK-key chunks and aims at SPLIT_CTAS_PER_SM CTAs per SM.
SPLIT_MAX_ROWS = 16
SPLIT_CHUNK = 64
SPLIT_CTAS_PER_SM = 8
LOG2E = 1.4426950408889634


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Kernel-layout oracle, the copy of ``ref.py:flash_attention_ref``.

    q: (BH, G, Sq, D); k, v: (BH, Skv, D) -- plain softmax attention."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bgqd,bkd->bgqk", q.float(), k.float()) * scale
    if causal:
        mask = (torch.arange(skv, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask[None, None], s, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqk,bkd->bgqd", p, v.float())
    return o.to(q.dtype)


def _attend_block(q, k, v, bias, scale):
    """One (q-chunk x full-KV) attention with f32 softmax.

    q: (B, Cq, H, D); k, v: (B, S, KVH, D); bias broadcastable to
    (B, H, Cq, S)."""
    b, cq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, cq, kvh, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    s = s.reshape(b, h, cq, k.shape[1]) + bias
    p = torch.softmax(s, dim=-1)
    p = p.reshape(b, kvh, g, cq, k.shape[1])
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, cq, h, d).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool, chunk: int = 1024):
    """Model-layout plain version, the copy of
    ``models/layers.py:flash_attention_jnp`` (q and KV both from
    position 0): a loop over q chunks of ``chunk`` rows, full KV per
    chunk, so no S x S matrix is formed.

    q: (B, Sq, H, D); k, v: (B, Skv, KVH, D)."""
    sq, d = q.shape[1], q.shape[3]
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    kv_pos = torch.arange(skv, device=q.device)

    def bias_for(q_pos):
        if causal:
            m = kv_pos[None, :] <= q_pos[:, None]
        else:
            m = torch.ones((len(q_pos), skv), dtype=torch.bool,
                           device=q.device)
        return torch.where(m, 0.0, MASK_VALUE)[None, None]   # (1,1,Cq,S)

    if sq <= chunk:
        return _attend_block(q, k, v,
                             bias_for(torch.arange(sq, device=q.device)),
                             scale)
    outs = []
    for i in range(-(-sq // chunk)):
        qi = q[:, i * chunk:(i + 1) * chunk]
        pos = i * chunk + torch.arange(qi.shape[1], device=q.device)
        outs.append(_attend_block(qi, k, v, bias_for(pos), scale))
    return torch.cat(outs, dim=1)


def split_partials(q, k, v, *, causal: bool, keys_per_split: int,
                   offsets=None):
    """The split route's first pass, as the kernel computes it: the keys
    of each (batch, KV head) cut into ranges of ``keys_per_split``, and
    per range and query row the unnormalised f32 output o, the running
    max m of the scores in log2 units (times scale * log2(e)) and l =
    sum exp2(score - m).  A range with no visible key has m = -inf,
    l = 0, o = 0.

    q: (B, Sq, H, D); k, v: (B, Skv, KVH, D).  Rows are ordered (query
    t, head g) as r = t * G + g, at position t, or offsets[b] + t with
    ``offsets`` (B,) (a verify window's starts; the causal form then
    lets row r see keys <= offsets[b] + t).  Returns o (B, KVH, n_split,
    G * Sq, D), m and l (B, KVH, n_split, G * Sq)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = LOG2E / math.sqrt(d)
    qr = q.float().reshape(b, sq, kvh, g, d).permute(0, 2, 1, 3, 4)
    qr = qr.reshape(b, kvh, sq * g, d) * scale
    pos = torch.arange(sq, device=q.device).repeat_interleave(g)  # row -> t
    pos = pos.expand(b, -1)
    if offsets is not None:
        pos = pos + torch.as_tensor(offsets, device=q.device).reshape(b, 1)
    os_, ms, ls = [], [], []
    for k0 in range(0, skv, keys_per_split):
        kk = k[:, k0:k0 + keys_per_split].float().transpose(1, 2)
        vv = v[:, k0:k0 + keys_per_split].float().transpose(1, 2)
        s = torch.einsum("bhrd,bhkd->bhrk", qr, kk)
        if causal:
            keys = k0 + torch.arange(kk.shape[2], device=q.device)
            seen = keys[None, None, :] <= pos[:, :, None]     # (B, R, K)
            s = torch.where(seen[:, None], s, -math.inf)
        m = s.amax(-1)
        p = torch.exp2(s - torch.where(m == -math.inf, 0.0, m)[..., None])
        os_.append(torch.einsum("bhrk,bhkd->bhrd", p, vv))
        ms.append(m)
        ls.append(p.sum(-1))
    return torch.stack(os_, 2), torch.stack(ms, 2), torch.stack(ls, 2)


def merge_partials(o, m, l):
    """The split route's second pass (``csrc/split_merge.cuh``): M = max
    m, w = exp2(m - M), out = sum w o / max(sum w l, 1e-30) over the
    split axis (2).  Returns (B, KVH, R, D) in float32."""
    mx = m.amax(2, keepdim=True)
    w = torch.exp2(m - torch.where(mx == -math.inf, 0.0, mx))
    num = (w[..., None] * o).sum(2)
    return num / (w * l).sum(2).clamp_min(1e-30)[..., None]


def flash_attention_split_plain(q, k, v, *, causal: bool,
                                keys_per_split: int, offsets=None):
    """The split route's plain version: ``split_partials``, then
    ``merge_partials``, back in the model layout and ``q``'s dtype.
    q: (B, Sq, H, D); k, v: (B, Skv, KVH, D); ``offsets`` (B,): each
    slot's position of query row 0 (the verify kernels' window starts,
    with ``causal``), 0 without."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    o = merge_partials(*split_partials(q, k, v, causal=causal,
                                       keys_per_split=keys_per_split,
                                       offsets=offsets))
    o = o.reshape(b, kvh, sq, h // kvh, d).permute(0, 2, 1, 3, 4)
    return o.reshape(b, sq, h, d).to(q.dtype)


def _route(sq: int, skv: int, h: int, kvh: int, d: int, dtype,
           name: str = "flash_attention") -> str:
    """The device route of a call of ``name`` (flash, or either verify
    kernel with its window length T as ``sq``): ``"tile_f32"`` for
    float32, for bfloat16 ``"mma"`` (the tensor-core tile kernel) when
    more than ``SPLIT_MAX_ROWS`` query rows G * Sq share a KV head, else
    ``"split"`` (split-KV + merge).  Raises on what no route takes."""
    if d not in (64, 128):
        raise ValueError(f"{name}: D = {d} not in (64, 128)")
    if dtype == torch.float32:
        return "tile_f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"{name} takes float32 or bfloat16, got {dtype}")
    return "mma" if (h // kvh) * sq > SPLIT_MAX_ROWS else "split"


def _splits(n_sets: int, skv: int, n_sm: int = 132) -> tuple[int, int]:
    """(split count, keys per split) of the split route for ``n_sets``
    (batch, KV head) pairs over ``skv`` keys (a verify call's cache
    capacity): keys per split a multiple of ``SPLIT_CHUNK``, enough
    splits that the grid reaches ``SPLIT_CTAS_PER_SM`` CTAs per SM where
    the keys allow.  Shapes only: the layout never reads a position."""
    chunks = -(-skv // SPLIT_CHUNK)
    want = max(1, -(-SPLIT_CTAS_PER_SM * n_sm // n_sets))
    per = -(-chunks // min(want, chunks))
    return -(-chunks // per), per * SPLIT_CHUNK


def _check_aligned(*tensors, name: str = "flash_attention") -> None:
    """Every (batch, seq, head) row start 16-byte aligned, as the
    kernels' 16-byte loads need; raises where one is not."""
    for x in tensors:
        step = x.element_size()
        if x.data_ptr() % 16 or any(s * step % 16 for s in x.stride()[:3]):
            raise ValueError(
                f"{name}: rows of a {tuple(x.shape)} tensor with "
                f"strides {x.stride()} are not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def plan(name: str, sq: int, h: int, kvh: int, d: int, dtype,
         capacity: int, n_sets: int, n_sm: int) -> tuple[str, int, int]:
    """(route, split count, keys per split) of a call of ``name`` (flash,
    or either verify kernel with its window length T as ``sq``): the
    route ``_route`` names and, on the split route, the layout
    ``_splits`` gives for ``n_sets`` = B * KVH over ``capacity`` keys
    (Skv, or a verify call's cache capacity) on ``n_sm`` SMs (0, 0 on the
    other routes).  Shapes only: two calls of either verify kernel with
    equal shapes and capacity take the same route and split
    identically, whatever their positions."""
    route = _route(sq, capacity, h, kvh, d, dtype, name=name)
    if route != "split":
        return route, 0, 0
    return (route, *_splits(n_sets, capacity, n_sm))


def _entry(name: str, split: bool, n_ptr: int, n_int: int, n_flag: int):
    """The C entry point ``<name>_launch`` (``<name>_split_launch`` for
    the split route) with its argument types: ``n_ptr`` tensors ending
    in o (then o_part and ml_part), ``n_int`` sizes, 12 strides (the
    split count and keys per split), scale, ``n_flag`` ints (flash's
    causal), dtype, stream."""
    fn = getattr(build.library(name),
                 f"{name}_split_launch" if split else f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = ([_P] * (n_ptr + 2 * split) + [_I] * n_int
                       + [_L] * 12 + [_I] * (2 * split)
                       + [ctypes.c_float] + [_I] * (n_flag + 1) + [_P])
        fn.restype = _I
    return fn


def launch(name: str, q, kvh: int, capacity: int, kv, ptrs, sizes,
           kv_strides, flags=()):
    """Launch kernel ``name`` (``flash_attention``, ``verify_attention``
    or ``paged_verify_attention``) on q (B, Sq, H, D) and return o: the
    route and split layout of ``plan``, the 16-byte row alignment of q
    and the K/V tensors ``kv`` checked, float32 scratch on the split
    route.  ``ptrs``: the pointers between q and o in the C signature
    (a verify window's ``pos`` among them: never read here); ``sizes``:
    its ints; ``kv_strides``: its six K/V strides; ``flags``: its ints
    after the scale.  Raises where no route takes the call or a launch
    fails."""
    b, sq, h, d = q.shape
    route, n_split, per = plan(name, sq, h, kvh, d, q.dtype, capacity,
                               b * kvh, _sm_count(q.device.index))
    _check_aligned(q, *kv, name=name)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    head = (q.data_ptr(), *ptrs, o.data_ptr())
    strides = (*q.stride()[:3], *kv_strides, *o.stride()[:3])
    tail = (1.0 / math.sqrt(d), *flags, build.dtype_code(q),
            torch.cuda.current_stream(q.device).cuda_stream)
    split = route == "split"
    fn = _entry(name, split, len(head), len(sizes), len(flags))
    if split:
        rows = sq * (h // kvh)
        o_part = torch.empty((b * kvh, n_split, rows, d),
                             dtype=torch.float32, device=q.device)
        ml_part = torch.empty((b * kvh, n_split, rows, 2),
                              dtype=torch.float32, device=q.device)
        err = fn(*head, o_part.data_ptr(), ml_part.data_ptr(), *sizes,
                 *strides, n_split, per, *tail)
    else:
        err = fn(*head, *sizes, *strides, *tail)
    build.check(err, name)
    return o


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Sq, H, D); k, v: (B, Skv, KVH, D) with H % KVH == 0 and
    Skv >= 1; both sequences start at position 0.  ``causal`` lets query
    row i see keys j <= i; otherwise every row sees all Skv keys.
    Returns (B, Sq, H, D).  CPU tensors take the plain version; CUDA
    tensors (D in {64, 128}, float32 or bfloat16, every row start
    16-byte aligned) launch the route ``_route`` names -- the
    tensor-core tile kernel, the split-KV kernel or the float32 tile
    loop -- or raise."""
    if k.shape[1] < 1:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no path for {q.device}")
    b, sq, h, d = q.shape
    _, skv, kvh, dk = k.shape
    if (dk != d or v.shape != k.shape or k.shape[0] != b or h % kvh):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v dtypes differ")
    for x in (q, k, v):
        if x.device != q.device or x.stride(-1) != 1:
            raise ValueError("flash_attention: q, k, v must share a "
                             "device and have unit stride on D")
    o = launch("flash_attention", q, kvh, skv, (k, v),
               (k.data_ptr(), v.data_ptr()), (b, sq, skv, h, kvh, d),
               (*k.stride()[:3], *v.stride()[:3]), flags=(int(causal),))
    count_launch(flash_attention)
    return o


flash_attention.launches = 0
