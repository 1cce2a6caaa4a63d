"""MLPerf Logging Library equivalent: standardized ``:::MLLOG`` events.

Both performance logs (run_start / run_stop / samples) and power logs
(timestamped samples in a uniform schema) are emitted in this format;
the result summarizer and compliance checker parse only this format —
the paper's "uniform logging format" requirement (§III-B).

Copied from the reference ``src/repro/core/mlperf_log.py``; only its imports
differ.
"""
from __future__ import annotations

import dataclasses
import io
import json
from typing import Any, Iterable, Optional

PREFIX = ":::MLLOG"
POWER_PREFIX = ":::MLPOWER"


@dataclasses.dataclass
class LogEvent:
    key: str
    value: Any
    time_ms: float
    namespace: str = "power"
    metadata: Optional[dict] = None

    def line(self, prefix: str = PREFIX) -> str:
        body = {"namespace": self.namespace, "time_ms": self.time_ms,
                "event_type": "POINT_IN_TIME", "key": self.key,
                "value": self.value, "metadata": self.metadata or {}}
        return f"{prefix} {json.dumps(body, sort_keys=True)}"


class MLPerfLogger:
    """Collects events; serializes/parses the standardized format."""

    def __init__(self, namespace: str = "power"):
        self.namespace = namespace
        self.events: list[LogEvent] = []

    def log(self, key: str, value: Any, time_ms: float,
            metadata: Optional[dict] = None) -> LogEvent:
        ev = LogEvent(key, value, time_ms, self.namespace, metadata)
        self.events.append(ev)
        return ev

    # convenience wrappers ------------------------------------------------
    def run_start(self, time_ms: float, **meta):
        return self.log("run_start", None, time_ms, meta)

    def run_stop(self, time_ms: float, **meta):
        return self.log("run_stop", None, time_ms, meta)

    def power_sample(self, time_ms: float, watts: float, *,
                     node: str = "sut", volts: float = 0.0,
                     amps: float = 0.0, source: str = "analyzer",
                     extra: Optional[dict] = None):
        """``extra`` carries channel metadata (domain kind/group and
        the ``boundary`` flag) the summarizer and compliance key on."""
        md = {"node": node, "volts": volts, "amps": amps,
              "source": source}
        if extra:
            md.update(extra)
        return self.log("power_w", watts, time_ms, md)

    def result(self, key: str, value: Any, time_ms: float, **meta):
        return self.log(key, value, time_ms, meta)

    # serialization --------------------------------------------------------
    def dump(self, fh: Optional[io.TextIOBase] = None,
             prefix: str = PREFIX) -> str:
        text = "\n".join(ev.line(prefix) for ev in self.events)
        if fh is not None:
            fh.write(text + "\n")
        return text

    def save(self, path: str, prefix: str = PREFIX):
        with open(path, "w") as f:
            self.dump(f, prefix)

    @staticmethod
    def parse(text_or_lines) -> list[LogEvent]:
        if isinstance(text_or_lines, str):
            lines: Iterable[str] = text_or_lines.splitlines()
        else:
            lines = text_or_lines
        out = []
        for line in lines:
            line = line.strip()
            for pre in (PREFIX, POWER_PREFIX):
                if line.startswith(pre):
                    body = json.loads(line[len(pre):].strip())
                    out.append(LogEvent(body["key"], body["value"],
                                        body["time_ms"],
                                        body.get("namespace", "power"),
                                        body.get("metadata")))
                    break
        return out

    @staticmethod
    def load(path: str) -> list[LogEvent]:
        with open(path) as f:
            return MLPerfLogger.parse(f.read())


def find_window(events: list[LogEvent]) -> tuple[float, float]:
    """Extract the [run_start, run_stop] execution window (ms)."""
    start = stop = None
    for ev in events:
        if ev.key == "run_start":
            start = ev.time_ms if start is None else min(start, ev.time_ms)
        elif ev.key == "run_stop":
            stop = ev.time_ms if stop is None else max(stop, ev.time_ms)
    if start is None or stop is None:
        raise ValueError("log missing run_start/run_stop")
    return start, stop
