"""Where the int8 GEMM's wgmma route spends its time: ablated copies.

  python -m repro_torch.launch.int8_ablation     # one CUDA card, nvcc

Each variant is a copy of ``kernels/csrc`` in which one part of
``int8_wgmma.cuh`` is switched off by a false runtime guard (the code
stays compiled, so registers and scheduling barely move) or the ring is
made shallower.  Each is built with the port's nvcc flags, run in its own
process at phase 3's two shapes of ``chip_smoke.py`` (tiny-kws: M 12,544,
K = N = 64, float32 out; a qwen3-1.7b FFN up-projection: M 1,024, K
2,048, N 6,144, bf16 out), and timed kernel-only by ``torch.profiler``
(20 calls, three times).  Only ``base`` computes the right output; the
others are instrumentation.  The card's name and power limit are
printed first; while ``base`` runs the LM shape in a steady loop,
``nvidia-smi`` reads the SM clock and the power draw.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

# the ablations: (old, new) text replacements in int8_wgmma.cuh
_PRODUCTS = "hopper::wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk);"
_TRANSPOSE = ("transpose_tile(raw + s * kWTile, wt + s * kWTile, t, "
              "K - kt * kBK,")
_STORE = ("hopper::tma_store_2d(&to, stage + sl * 8192, n0 + sl * kCols,")
_RING = "constexpr int kStages = 4;"
# the epilogue's staging needs 4 ring slots; the loads-only copies store
# nothing
_STAGING = ("static_assert(kStages * kWTile >= kConsumers / 128 * 64 * kBN "
            "* 4,\n              \"raw ring\");")


def _off(code: str) -> tuple[str, str]:
    return code, "if (M < 0) " + code


_LOADS = [_off(_PRODUCTS), _off(_TRANSPOSE), _off(_STORE), (_STAGING, "")]
VARIANTS = {
    "base": [],
    "no_transpose": [_off(_TRANSPOSE)],
    "no_products": [_off(_PRODUCTS)],
    "no_stores": [_off(_STORE)],
    "loads_only": _LOADS,
    "loads_only_ring3": _LOADS + [(_RING, "constexpr int kStages = 3;")],
    "loads_only_ring2": _LOADS + [(_RING, "constexpr int kStages = 2;")],
}
SHAPES = (("tiny", (12544, 64, 64), "float32"),
          ("lm", (1024, 2048, 6144), "bfloat16"))


def patched_source(name: str) -> str:
    """``int8_wgmma.cuh`` with the variant's edits (each must match the
    source exactly once)."""
    from repro_torch.kernels import build
    with open(os.path.join(build.CSRC, "int8_wgmma.cuh")) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} not found once")
        text = text.replace(old, new)
    return text


def build_variants(root: str) -> dict[str, str]:
    """Copy ``csrc`` into ``root/<variant>`` with the variant's edits and
    build every copy's ``int8_matmul.cu`` at once; returns the
    libraries' paths by variant."""
    from repro_torch.kernels import build
    jobs = {}
    for name in VARIANTS:
        src = os.path.join(root, name)
        shutil.copytree(build.CSRC, src)
        with open(os.path.join(src, "int8_wgmma.cuh"), "w") as f:
            f.write(patched_source(name))
        so = os.path.join(src, "libint8.so")
        jobs[name] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", so,
             os.path.join(src, "int8_matmul.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    return {name: so for name, (so, _) in jobs.items()}


def kernel_ms(torch, fn, reps: int = 20) -> float:
    """Kernel-only device ms per call of ``fn()`` (all CUDA kernels the
    profiler records over ``reps`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps


def clocks_under_load(torch, fn, seconds: float = 1.5) -> str:
    """``nvidia-smi``'s SM clock, its maximum and the power draw, read
    halfway through ``seconds`` of back-to-back calls of ``fn()``."""
    got = []

    def read():
        time.sleep(seconds / 2)
        got.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())

    reader = threading.Thread(target=read)
    reader.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    reader.join()
    return "clocks.sm, clocks.max.sm, power.draw = " + (got[0] if got
                                                        else "not read")


def time_variant(name: str, so: str) -> None:
    """Run the variant's wgmma entry point at ``SHAPES`` and print its
    kernel-only times (and, for ``base``, that it equals the plain
    version)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.int8_matmul import ops
    fn = ctypes.CDLL(so).int8_matmul_wgmma_launch
    fn.argtypes = ops.ARGTYPES["int8_matmul_wgmma_launch"]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    for tag, (m, k, n), dtype in SHAPES:
        out_dtype = getattr(torch, dtype)
        xq, sx = ops.quantize_int8(
            torch.randn((m, k), generator=gen, device=dev), axis=1)
        wq, sw = ops.quantize_int8(
            torch.randn((k, n), generator=gen, device=dev), axis=0)
        out = torch.empty((m, n), dtype=out_dtype, device=dev)

        def call():
            build.check(fn(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(),
                           sw.data_ptr(), out.data_ptr(), m, n, k,
                           build.dtype_code(out),
                           torch.cuda.current_stream().cuda_stream),
                        name)

        call()
        torch.cuda.synchronize()
        times = ", ".join(f"{kernel_ms(torch, call):.4f}" for _ in range(3))
        note = ""
        if name == "base":
            want = ops.int8_matmul_plain(xq, wq, sx, sw, out_dtype)
            note = f"; equal to plain: {torch.equal(out, want)}"
        print(f"{name:18s} {tag:4s} M={m} K={k} N={n} {dtype}: kernel-only "
              f"{times} ms{note}", flush=True)
        if name == "base" and tag == "lm":
            print(f"{name:18s} {tag:4s} under a steady loop: "
                  f"{clocks_under_load(torch, call)}", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--variant"]:
        time_variant(sys.argv[2], sys.argv[3])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("int8_ablation: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from repro_torch.kernels import build
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as root:
        for name, so in build_variants(root).items():
            # its own process: the copies share the kernels' names
            subprocess.run([sys.executable, "-m", __spec__.name,
                            "--variant", name, so], check=True, timeout=300)
    return 0


if __name__ == "__main__":
    sys.exit(main())
