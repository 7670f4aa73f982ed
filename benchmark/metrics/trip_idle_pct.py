"""trip_idle_pct: the share of the host time inside the program's
`ica.trip` spans in which no device activity runs, in %: one minus the
device time of what the trips launched over the trips' host time. A trip
ends in a host sync, so what it launched runs inside it and nothing else
does; the device time is read on the device's clock and the host time on
the host's (the two drift apart over a window). The spans' window
(benchmark/yardstick/spans.py)."""

import numpy as np

from benchmark.yardstick import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    trips = np.flatnonzero(sp.named("ica.trip"))
    if not len(trips):
        return None
    host = int((sp.host.end[trips] - sp.host.start[trips]).sum())
    return 100.0 * (1.0 - sum(sp.busy_ns(i) for i in trips) / host)
