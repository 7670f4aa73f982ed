"""level_setup_ms: per align call, the sum over the pyramid's levels of the
device-side images of the program's `ica.level.setup` spans (gradients,
band mask, moments and the level's system plan); the spans' window
(benchmark/yardstick/spans.py)."""

from benchmark.yardstick import spans


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    m = sp.imaged("ica.level.setup")
    if not m.any():
        return None
    return float((sp.image[m, 1] - sp.image[m, 0]).sum()) * 1e-6 / sp.calls
