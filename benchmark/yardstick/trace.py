"""Reduction of a `torch.profiler` window to what the per-layer metrics
read: the device's activities (kernels, copies, sets) and the host's ops,
as name and [start, end) in nanoseconds on the profiler's one clock, and
the benchmark's own spans.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

SPAN = "bench.call"


@dataclass
class Intervals:
    names: list[str]
    start: np.ndarray   # int64 ns
    end: np.ndarray

    @classmethod
    def of(cls, rows) -> "Intervals":
        rows = sorted(rows, key=lambda r: r[1])
        return cls([r[0] for r in rows], np.array([r[1] for r in rows], np.int64),
                   np.array([r[2] for r in rows], np.int64))

    def __len__(self) -> int:
        return len(self.names)

    def seconds(self, mask=None) -> float:
        d = self.end - self.start
        return float((d if mask is None else d[mask]).sum()) * 1e-9

    def matching(self, pattern: str) -> np.ndarray:
        rx = re.compile(pattern)
        return np.array([bool(rx.search(n)) for n in self.names], bool)


@dataclass
class Trace:
    device: Intervals    # every device activity
    host: Intervals      # host ops and runtime calls
    spans: Intervals     # the benchmark's SPAN around each call

    @property
    def window(self) -> tuple[int, int]:
        return int(self.spans.start.min()), int(self.spans.end.max())

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) * 1e-9

    def kernels(self) -> np.ndarray:
        """Mask of the device activities that are kernels (not copies or sets)."""
        return ~self.device.matching(r"^(Memcpy|Memset)")

    def owner(self, pattern: str) -> np.ndarray:
        """Mask of the kernels named by `pattern`, with each `finalize_kernel`
        that follows one of them on the device: the moment kernels end in
        that shared pass."""
        own = self.device.matching(pattern)
        fin = self.device.matching(r"finalize_kernel")
        kern = self.kernels()
        last = False
        for i in range(len(self.device)):
            if not kern[i]:
                continue
            if fin[i]:
                own[i] = last
            else:
                last = bool(own[i])
        return own

    def busy_s(self) -> float:
        lo, hi = self.window
        return union_ns(self.device.start, self.device.end, lo, hi) * 1e-9


def _event_rows(prof):
    """(device rows, host rows, span rows) of a finished profiler."""
    dev, host, spans = [], [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        row = (ev.name(), start, start + ev.duration_ns())
        on_device = ev.device_type() != torch.autograd.DeviceType.CPU
        if ev.name() == SPAN:
            if not on_device:
                spans.append(row)
        elif on_device:
            if not ev.is_user_annotation():
                dev.append(row)
        else:
            host.append(row)
    return dev, host, spans


def from_profiler(prof) -> Trace | None:
    """The trace of a finished profiler, or None when it recorded no device
    activity inside its spans."""
    dev, host, spans = _event_rows(prof)
    if not spans or not dev:
        return None
    tr = Trace(Intervals.of(dev), Intervals.of(host), Intervals.of(spans))
    lo, hi = tr.window
    inside = (tr.device.end > lo) & (tr.device.start < hi)
    return tr if inside.any() else None


def union_ns(start: np.ndarray, end: np.ndarray, lo: int, hi: int) -> int:
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    s, e = np.clip(start, lo, hi), np.clip(end, lo, hi)
    order = np.argsort(s, kind="stable")
    total, cur_s, cur_e = 0, None, None
    for a, b in zip(s[order], e[order]):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return int(total)


def idle_gaps(start: np.ndarray, end: np.ndarray, lo: int, hi: int) -> list[tuple[int, int]]:
    """The [a, b) stretches of [lo, hi) in which no interval runs."""
    order = np.argsort(start, kind="stable")
    gaps, t = [], lo
    for a, b in zip(start[order], end[order]):
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(a, b) for a, b in gaps if b > a]


def host_at(host: Intervals, points: list[int]) -> list[str]:
    """The innermost host op running at each of the sorted `points`, or
    "host:outside_any_op"; a sweep that keeps the stack of open ops."""
    out, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host.start[i] <= t:
            while stack and host.end[stack[-1]] <= host.start[i]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and host.end[stack[-1]] <= t:
            stack.pop()
        out.append(host.names[stack[-1]] if stack else "host:outside_any_op")
    return out


def clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]+", "_", name)[:64]


def breakdown(tr: Trace, top: int = 10) -> dict:
    """{"device_ops": the device activities that took most time, summed by
    name; "idle_gaps": the idle time of the device summed by what the host
    was doing at the middle of each gap}, seconds, `top` entries each."""
    lo, hi = tr.window
    ops: dict[str, float] = {}
    for n, a, b in zip(tr.device.names, tr.device.start, tr.device.end):
        d = (min(b, hi) - max(a, lo)) * 1e-9
        if d > 0:
            ops[clean(n)] = ops.get(clean(n), 0.0) + d
    gaps = idle_gaps(tr.device.start, tr.device.end, lo, hi)
    who = host_at(tr.host, [(a + b) // 2 for a, b in gaps])
    idle: dict[str, float] = {}
    for (a, b), n in zip(gaps, who):
        idle[clean(n)] = idle.get(clean(n), 0.0) + (b - a) * 1e-9
    pick = lambda d: [[k, float(v)] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": pick(ops), "idle_gaps": pick(idle)}
