"""The program's own spans in a traced window: one call on each pool batch
under torch.profiler, as `harness.traced_window` makes, keeping what
`trace._event_rows` drops there:

- the program's `ica.*` spans on the host (`utils/profiling.py::span`);
- their device-side images: for each span, the first start to the last end
  of the device activities launched while it was open on the host (the
  runtime call that launched an activity shares its correlation id), so a
  span's image covers the spans nested in it;
- every device activity (kernels, copies, sets);
- each call's `level_niters`, the per-level iteration counts of its pairs.

The profiler maps the card's timestamps onto the host's clock, and over a
window of seconds the two were seen to drift apart by milliseconds; so the
readers compare times on one clock only, and tie a device activity to a
span by its launch, never by where its time falls on the host's clock.

Every reader of these takes the one window through `of(run)`. A program
without the spans or the counts gives a window in which the readers find
nothing, and they read None.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import trace

PREFIX = "ica."
UNSEEN = -1   # a time the profiler did not record: an image or a launch


@dataclass
class Spans:
    host: trace.Intervals   # the program's spans on the host, outer before inner
    device: trace.Intervals  # every device activity, by start
    by_launch: np.ndarray   # device indices in the order of their launches
    own_lo: np.ndarray      # span i launched device[by_launch[own_lo[i]:own_hi[i]]]
    own_hi: np.ndarray
    image: np.ndarray       # [n, 2] int64 ns: each span's device-side image, or UNSEEN
    calls: int
    batch: int
    level_niters: list      # per call: the per-level [B] counts, coarsest first

    def named(self, name: str) -> np.ndarray:
        return np.array([n == name for n in self.host.names], bool)

    def imaged(self, name: str) -> np.ndarray:
        """Mask of the spans named `name` that have a device-side image."""
        return self.named(name) & (self.image[:, 0] != UNSEEN)

    def kernels(self) -> np.ndarray:
        return ~self.device.matching(r"^(Memcpy|Memset)")

    def busy_ns(self, i: int) -> int:
        """The device time of what span i launched: the union of those
        activities' intervals, on the device's clock alone."""
        own = self.by_launch[self.own_lo[i]:self.own_hi[i]]
        s, e = merge(self.device.start[own], self.device.end[own])
        return int((e - s).sum())


def merge(start: np.ndarray, end: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    if len(start) == 0:
        return start[:0], end[:0]
    order = np.argsort(start, kind="stable")
    s, reach = start[order], np.maximum.accumulate(end[order])
    first = np.ones(len(s), bool)
    first[1:] = s[1:] > reach[:-1]
    last = np.append(np.flatnonzero(first)[1:] - 1, len(s) - 1)
    return s[first], reach[last]


def from_rows(host_rows, device_rows, calls: int, batch: int, level_niters: list) -> Spans:
    """host_rows: (name, start, end) of the program's spans on the host;
    device_rows: (name, start, end, launch) of device activities, `launch`
    the host time of the runtime call that launched it, or UNSEEN."""
    host = trace.Intervals.of(sorted(host_rows, key=lambda r: (r[1], -r[2])))
    rows = sorted(device_rows, key=lambda r: r[1])
    device = trace.Intervals.of(rows)
    launched = np.array([r[3] for r in rows], np.int64)
    by_launch = np.argsort(launched, kind="stable")
    lo = np.searchsorted(launched[by_launch], host.start, side="left")
    hi = np.searchsorted(launched[by_launch], host.end, side="left")
    image = np.full((len(host), 2), UNSEEN, np.int64)
    for i, (a, b) in enumerate(zip(lo, hi)):
        if b > a:
            own = by_launch[a:b]
            image[i] = (device.start[own].min(), device.end[own].max())
    return Spans(host=host, device=device, by_launch=by_launch, own_lo=lo, own_hi=hi,
                 image=image, calls=calls, batch=batch, level_niters=level_niters)


def from_profiler(prof, calls: int, batch: int, level_niters: list) -> Spans | None:
    """The spans of a finished profiler, or None when it recorded no device
    activity."""
    host_rows, device_rows, launched = [], [], {}
    cpu = torch.autograd.DeviceType.CPU
    for ev in prof.profiler.kineto_results.events():
        on_device = ev.device_type() != cpu
        if ev.is_user_annotation():
            name = ev.name()
            if not on_device and name.startswith(PREFIX):
                host_rows.append((name, ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        elif on_device:
            device_rows.append((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                                ev.correlation_id()))
        elif ev.name().startswith("cu"):   # CUDA API calls: cudaLaunchKernel, cuLaunchKernel, ...
            launched[ev.correlation_id()] = ev.start_ns()
    device_rows = [(n, a, b, launched.get(c, UNSEEN)) for n, a, b, c in device_rows]
    if not device_rows:
        return None
    return from_rows(host_rows, device_rows, calls, batch, level_niters)


def window(run, attempts: int = 3) -> Spans | None:
    """One `align` call on each pool batch under torch.profiler, each ended
    by copying p to the host; a window in which the profiler recorded no
    device activity is run again."""
    if run.device.type != "cuda":
        return None
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        run.sync()
        kept = []
        with torch.profiler.profile(activities=acts) as prof:
            for b in run.pool:
                res = run.system(b.i1, b.i2, run.cfg)
                res.p.cpu()
                kept.append(getattr(res, "level_niters", ()))
        niters = [[n.cpu().numpy() for n in levels] for levels in kept]
        spans = from_profiler(prof, len(run.pool), run.cell.mix["batch"], niters)
        if spans is not None:
            return spans
    return None


def of(run) -> Spans | None:
    """The run's one window of the program's spans."""
    return run.cached("spans.window", lambda: window(run))
