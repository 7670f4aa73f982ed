"""trip_host_ms: the mean host length of the program's `ica.trip` spans,
one solver trip each (K1 and the normal system, the update, the host sync);
the spans' window (benchmark/yardstick/spans.py)."""

from benchmark.yardstick import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    m = sp.named("ica.trip")
    if not m.any():
        return None
    return float((sp.host.end[m] - sp.host.start[m]).mean()) * 1e-6
