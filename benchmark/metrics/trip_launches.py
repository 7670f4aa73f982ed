"""trip_launches: the kernels inside the device-side images of the
program's `ica.trip` spans over the number of those spans; the spans'
window (benchmark/yardstick/spans.py)."""

import numpy as np

from benchmark.yardstick import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    trips = sp.named("ica.trip")
    m = sp.imaged("ica.trip")
    if not m.any():
        return None
    kern = sp.kernels()
    ks, ke = sp.device.start[kern], sp.device.end[kern]   # sorted by start
    inside = 0
    for a, b in sp.image[m]:
        lo, hi = np.searchsorted(ks, a, side="left"), np.searchsorted(ks, b, side="right")
        inside += int((ke[lo:hi] <= b).sum())
    return inside / int(trips.sum())
