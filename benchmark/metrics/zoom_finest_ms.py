"""zoom_finest_ms: per align call, the summed device-side images of the
finest `ica.pyramid.zoom` span of each pyramid the call builds (the first
zoom of each `build_pyramid`, from the frame to its first level: the
largest of the pyramid's dense per-axis products); the mean over the calls
of the spans' window (benchmark/yardstick/spans.py). Where the program has
no such span, it reads nothing."""

import numpy as np

from benchmark.yardstick import spans

PYRAMID, ZOOM = "ica.pyramid", "ica.pyramid.zoom"


def read(run):
    sp = spans.of(run)
    if sp is None:
        return None
    per_build = int(run.cell.config["nscales"]) - 1
    zooms = np.flatnonzero(sp.named(ZOOM))
    total, seen = 0, False
    for i in np.flatnonzero(sp.named(PYRAMID)):
        inside = zooms[(sp.host.start[zooms] >= sp.host.start[i])
                       & (sp.host.end[zooms] <= sp.host.end[i])]
        for z in inside[::per_build] if per_build > 0 else ():   # each build's first
            if sp.image[z, 0] != spans.UNSEEN:
                total += int(sp.image[z, 1] - sp.image[z, 0])
                seen = True
    return total * 1e-6 / sp.calls if seen else None
