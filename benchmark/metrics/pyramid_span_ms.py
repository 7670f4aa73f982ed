"""pyramid_span_ms: per align call, the device-side image of the program's
`ica.pyramid` span (its first kernel's start to its last kernel's end),
the pyramid the call itself builds; the mean over the calls of the spans'
window (benchmark/yardstick/spans.py)."""

from benchmark.yardstick import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    m = sp.imaged("ica.pyramid")
    if not m.any():
        return None
    return float((sp.image[m, 1] - sp.image[m, 0]).mean()) * 1e-6
