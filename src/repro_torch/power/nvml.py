"""The H100's own energy counter, read through NVML.

The reference models every rail (``repro.hw``: "on a real cluster the
model is replaced by genuine telemetry").  On the card the port reads
that telemetry: the driver's NVML library (``libnvidia-ml.so.1``,
bound here with ``ctypes``; pynvml is not needed) keeps a cumulative
board-energy counter, ``nvmlDeviceGetTotalEnergyConsumption``, in mJ
since the driver loaded.  Board power covers the GPU and its HBM.

- ``NVML`` opens the library and finds the torch device's NVML handle
  through its PCI bus id (``CUDA_VISIBLE_DEVICES`` renumbers CUDA
  devices; NVML does not).  It reads the name, the enforced power
  limit, the instantaneous power reading and the energy counter.
- ``EnergySampler`` reads a counter (any ``reader() -> mJ``) on a
  thread at a fixed period between ``start()`` and ``stop()``;
  ``energy_j()`` is the counter's delta over that window and
  ``source(t0)`` a ``PowerSource``: piecewise-constant watts from the
  counter's differences, on seconds from ``t0``, clamped outside the
  window.  The trace comes from the counter, not from the power
  reading, which on Hopper is a windowed average: the trace's integral
  equals the counter's delta by construction.
- ``counter_period`` measures how often the counter moves, the figure
  a sampling period is chosen from.

There is no fallback: without the library, or for a device NVML does
not know, ``NVML`` raises; nothing here returns a modeled trace.
"""
from __future__ import annotations

import ctypes
import functools
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

LIBRARY = "libnvidia-ml.so.1"
NVML_SUCCESS = 0

# The trace's shortest step.  A reading's time can lag its value by a
# thread switch (milliseconds); over steps of a millisecond that lag
# would turn into spikes a 100 Hz stack samples at random, and over
# 10 ms steps it is a small share of each.
TRACE_RESOLUTION_S = 0.01


def pci_bus_id(device) -> str:
    """NVML's ``domain:bus:device.function`` id of a CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"NVML reads CUDA devices, not {str(dev)!r}")
    props = torch.cuda.get_device_properties(
        dev.index if dev.index is not None else torch.cuda.current_device())
    return (f"{props.pci_domain_id:08x}:{props.pci_bus_id:02x}:"
            f"{props.pci_device_id:02x}.0")


class NVML:
    """One card's NVML handle.  ``close()`` (or ``with``) shuts NVML
    down again."""

    def __init__(self, device="cuda"):
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError as e:
            raise RuntimeError(
                f"NVML: cannot open {LIBRARY} (the NVIDIA driver's "
                f"management library), so the card's energy cannot be "
                f"measured: {e}") from e
        lib.nvmlErrorString.argtypes = [ctypes.c_int]
        lib.nvmlErrorString.restype = ctypes.c_char_p
        for name, args in (
                ("nvmlInit_v2", []), ("nvmlShutdown", []),
                ("nvmlDeviceGetHandleByPciBusId_v2",
                 [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]),
                ("nvmlDeviceGetName",
                 [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint]),
                ("nvmlDeviceGetEnforcedPowerLimit",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]),
                ("nvmlDeviceGetPowerUsage",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        self._lib = lib
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self._open = True
        self.bus_id = pci_bus_id(device)
        self._handle = ctypes.c_void_p()
        try:
            self._check(lib.nvmlDeviceGetHandleByPciBusId_v2(
                self.bus_id.encode(), ctypes.byref(self._handle)),
                f"nvmlDeviceGetHandleByPciBusId_v2({self.bus_id})")
        except RuntimeError:
            self.close()
            raise
        self._energy = ctypes.c_ulonglong()
        self.counter_period_s: Optional[float] = None

    def _check(self, rc: int, call: str) -> None:
        if rc != NVML_SUCCESS:
            msg = self._lib.nvmlErrorString(rc).decode()
            raise RuntimeError(f"NVML ({LIBRARY}): {call} failed: {msg} "
                               f"(code {rc})")

    def _uint(self, fn, call: str) -> int:
        out = ctypes.c_uint()
        self._check(fn(self._handle, ctypes.byref(out)), call)
        return out.value

    def name(self) -> str:
        buf = ctypes.create_string_buffer(96)
        self._check(self._lib.nvmlDeviceGetName(self._handle, buf, 96),
                    "nvmlDeviceGetName")
        return buf.value.decode()

    def power_limit_w(self) -> float:
        """The enforced board power limit."""
        return self._uint(self._lib.nvmlDeviceGetEnforcedPowerLimit,
                          "nvmlDeviceGetEnforcedPowerLimit") / 1e3

    def power_w(self) -> float:
        """The board power reading (on Hopper a windowed average)."""
        return self._uint(self._lib.nvmlDeviceGetPowerUsage,
                          "nvmlDeviceGetPowerUsage") / 1e3

    def energy_mj(self) -> int:
        """Board energy since the driver loaded, in mJ."""
        self._check(self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(self._energy)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return self._energy.value

    def energy_meter(self) -> Callable[[], "EnergySampler"]:
        """A factory of ``EnergySampler`` over this card's counter (a
        SUT's ``energy_meter``), reading every half of the counter's own
        period (measured once here, ``counter_period``), and at most
        every millisecond."""
        if self.counter_period_s is None:
            self.counter_period_s = counter_period(self.energy_mj)
        return functools.partial(EnergySampler, self.energy_mj,
                                 period_s=max(self.counter_period_s / 2,
                                              1e-3))

    def close(self) -> None:
        if self._open:
            self._open = False
            self._check(self._lib.nvmlShutdown(), "nvmlShutdown")

    def __enter__(self) -> "NVML":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def counter_period(reader: Callable[[], float], *, seconds: float = 1.0,
                   poll_s: float = 5e-4,
                   clock: Callable[[], float] = time.monotonic) -> float:
    """Median seconds between the counter's changes, from polling
    ``reader`` every ``poll_s`` for ``seconds`` (the counter must move
    at least twice in that time)."""
    changes = []
    last = reader()
    t_end = clock() + seconds
    while clock() < t_end:
        time.sleep(poll_s)
        v = reader()
        if v != last:
            changes.append(clock())
            last = v
    if len(changes) < 3:
        raise RuntimeError(f"the energy counter moved {len(changes)} "
                           f"times in {seconds} s: no period to measure")
    return float(np.median(np.diff(changes)))


class EnergySampler:
    """Reads a cumulative energy counter (``reader() -> mJ``) every
    ``period_s`` on a thread between ``start()`` and ``stop()``; times
    are ``clock()`` seconds (``time.monotonic``, the serving engines'
    clock).  Use as ``with EnergySampler(...) as s:``.

    NVML's energy read takes milliseconds, and now and then a tenth of
    a second (``sampler_stall`` in ``chip_smoke.py``), so no reading
    waits on another:

    * the thread reads on a fixed schedule, the k-th reading due at
      ``k * period_s`` after the first: a slow read or a late wake-up
      delays that reading only, not every later one;
    * every reading is timed when its read begins (``t_s``) and keeps
      how long the read took (``read_s``): the counter's value comes
      from somewhere in between, so the readings bracket the energy
      from the first read's beginning to the last read's end
      (``bracket()``), and a slow first or last read widens it;
    * ``start()`` and ``stop()`` read on the calling thread; a thread
      reading still in progress when ``stop()`` reads is dropped.

    ``stop_s`` keeps when ``stop()`` was called, so a long gap between
    readings can be told apart: a slow read shows in ``read_s``, a late
    wake-up (the interpreter lock held elsewhere, a collection) in
    ``gaps()`` less the read before it, a late ``stop()`` in
    ``stop_s``."""

    def __init__(self, reader: Callable[[], float], *,
                 period_s: float = 0.01,
                 clock: Callable[[], float] = time.monotonic):
        self.reader = reader
        self.period_s = period_s
        self.clock = clock
        self.t_s: list[float] = []
        self.mj: list[float] = []
        self.read_s: list[float] = []
        self.stop_s: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _take(self) -> tuple[float, float, float]:
        """(clock before the read, mJ, clock after it)."""
        t = self.clock()
        mj = float(self.reader())
        return t, mj, self.clock()

    def _keep(self, t: float, mj: float, read_s: float) -> None:
        with self._lock:
            self.t_s.append(t)
            self.mj.append(mj)
            self.read_s.append(read_s)

    def _read(self) -> None:
        # the time first: a native reader releases the interpreter lock,
        # and taking it back can wait a switch interval (5 ms) behind
        # the serving thread, which a time read after would count
        t, mj, done = self._take()
        self._keep(t, mj, done - t)

    def _run(self) -> None:
        due = self.t_s[0]
        while True:
            due += self.period_s
            behind = self.clock() - due
            if behind > 0:              # past one or more readings' times:
                due += self.period_s * (behind // self.period_s)  # skip
            if self._stop.wait(max(0.0, due - self.clock())):
                return
            self._read()

    def start(self) -> "EnergySampler":
        if self._thread is not None:
            raise RuntimeError("EnergySampler.start: already started")
        self._read()
        self._thread = threading.Thread(target=self._run,
                                        name="energy-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            raise RuntimeError("EnergySampler.stop: never started")
        self.stop_s = self.clock()
        self._stop.set()
        t, mj, done = self._take()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            raise RuntimeError("EnergySampler.stop: the reader thread "
                               "did not end")
        with self._lock:                 # start()'s reading stays
            keep = [0] + [i for i in range(1, len(self.t_s))
                          if self.t_s[i] + self.read_s[i] <= t]
            self.t_s = [self.t_s[i] for i in keep]
            self.mj = [self.mj[i] for i in keep]
            self.read_s = [self.read_s[i] for i in keep]
        self._keep(t, mj, done - t)

    def gaps(self) -> np.ndarray:
        """Seconds between consecutive readings' times."""
        return np.diff(np.asarray(self.t_s, float))

    def bracket(self) -> tuple[float, float]:
        """(the first read's beginning, the last read's end): the
        counter's delta is the energy of a span inside this one that
        holds the first read's end to the last read's beginning."""
        return self.t_s[0], self.t_s[-1] + self.read_s[-1]

    def __enter__(self) -> "EnergySampler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def n_samples(self) -> int:
        return len(self.mj)

    def energy_j(self) -> float:
        """The counter's delta over the sampled window, in J."""
        return (self.mj[-1] - self.mj[0]) / 1e3

    def window_s(self) -> float:
        return self.t_s[-1] - self.t_s[0]

    def source(self, t0: float) -> Callable[[np.ndarray], np.ndarray]:
        """Watts at ``t`` seconds from ``t0`` (on ``clock``): between
        readings where the counter moved, at least
        ``TRACE_RESOLUTION_S`` apart, the energy it gained over the time
        it took; before the first and after the last reading, the first
        and last such interval's watts.  Its integral over the window
        equals ``energy_j()``."""
        if len(self.mj) < 2 or self.t_s[-1] <= self.t_s[0]:
            raise ValueError("EnergySampler.source: fewer than two "
                             "readings; start() and stop() the sampler "
                             "around the work first")
        t = np.asarray(self.t_s) - t0
        e = np.asarray(self.mj) / 1e3
        keep = [0]
        for i in range(1, len(e) - 1):     # where the counter moved, at
            if (e[i] != e[keep[-1]]         # least a resolution apart
                    and t[i] - t[keep[-1]] >= TRACE_RESOLUTION_S):
                keep.append(i)
        keep.append(len(e) - 1)
        t, e = t[keep], e[keep]
        dt = np.diff(t)
        watts = np.divide(np.diff(e), dt, out=np.zeros_like(dt),
                          where=dt > 0)
        edges = t[1:-1]

        def src(ts):
            ts = np.asarray(ts, float)
            return watts[np.searchsorted(edges, ts, side="right")]

        return src
