"""The readers of the program's spans on a synthetic window: the device-side
image of a span as the device activities launched while it was open, the
kernels inside the trips' images, the share of the trips' host time their
own device work leaves idle, and the useful share of the solver's
pair-trips; and the readers' silence where the program has no spans."""

import types

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.yardstick import spans

READERS = ("pyramid_span_ms", "level_setup_ms", "trip_host_ms", "trip_launches",
           "trip_idle_pct", "active_pair_share")

# One call: the pyramid, one level of two trips, the final warp (ns).
HOST = [("ica.align", 0, 1000), ("ica.pyramid", 10, 100), ("ica.level", 100, 900),
        ("ica.level.setup", 110, 200), ("ica.trip.sync", 200, 220),
        ("ica.trip", 220, 500), ("ica.trip.system", 230, 300),
        ("ica.trip.update", 300, 480), ("ica.trip.sync", 480, 500),
        ("ica.trip", 500, 800), ("ica.trip.system", 510, 600),
        ("ica.trip.update", 600, 780), ("ica.trip.sync", 780, 800),
        ("ica.final_warp", 900, 990)]
# (name, start, end, host time of its launch); the last has no recorded launch.
DEVICE = [("pyramid_kernel", 40, 130, 20), ("setup_kernel", 150, 230, 120),
          ("Memcpy DtoH", 235, 240, 205), ("elementwise", 260, 300, 235),
          ("fused_iter_kernel", 300, 330, 250), ("solve", 330, 400, 310),
          ("compose", 410, 495, 400), ("Memcpy DtoH", 505, 510, 485),
          ("elementwise", 540, 560, 515), ("fused_iter_kernel", 560, 620, 530),
          ("solve", 625, 700, 610), ("compose", 700, 790, 700), ("Memcpy DtoH", 800, 805, 785),
          ("warp_planar_kernel", 930, 1000, 910), ("Memset", 1005, 1010, spans.UNSEEN)]


def window(host=HOST, niters=((2, 1, 0, 1),)):
    sp = spans.from_rows(list(reversed(host)), list(reversed(DEVICE)), calls=1, batch=4,
                         level_niters=[[np.array(n) for n in niters]])
    return sp, types.SimpleNamespace(cached=lambda key, make: sp)


def read(name, run):
    return harness.load_reader(name).read(run)


def test_images_cover_what_was_launched_inside():
    sp, _ = window()
    image = {(n, int(a)): tuple(int(v) for v in sp.image[i])
             for i, (n, a) in enumerate(zip(sp.host.names, sp.host.start))}
    assert image["ica.trip", 220] == (260, 510)
    assert image["ica.trip", 500] == (540, 805)
    assert image["ica.level", 100] == (150, 805)
    assert image["ica.align", 0] == (40, 1000)
    assert image["ica.pyramid", 10] == (40, 130)
    assert sp.host.names[0] == "ica.align"                   # outer before inner


def test_readers_on_a_synthetic_window():
    _, run = window()
    assert read("pyramid_span_ms", run) == pytest.approx(90e-6)
    assert read("level_setup_ms", run) == pytest.approx(80e-6)
    assert read("trip_host_ms", run) == pytest.approx(290e-6)
    assert read("trip_launches", run) == 4.0                 # the copies are no kernels
    busy = (140 + 85 + 5) + (80 + 165 + 5)
    assert read("trip_idle_pct", run) == pytest.approx(100.0 * (1 - busy / 580))
    assert read("active_pair_share", run) == pytest.approx(4 / (4 * 2))


def test_busy_takes_what_a_span_launched():
    """A span's device time is the union of what it launched, on the
    device's clock alone: the copy launched before the first trip, and the
    set-up kernel that runs on into it, are not the trip's."""
    sp, _ = window()
    busy = {(n, int(a)): sp.busy_ns(i) for i, (n, a) in enumerate(zip(sp.host.names, sp.host.start))}
    assert busy["ica.trip", 220] == 140 + 85 + 5 and busy["ica.trip", 500] == 80 + 165 + 5
    assert busy["ica.align", 0] == 90 + 80 + 5 + 230 + 250 + 70       # the unseen launch is no one's
    s, e = spans.merge(np.array([5, 0, 20, 8]), np.array([9, 4, 30, 12]))
    assert (s.tolist(), e.tolist()) == ([0, 5, 20], [4, 12, 30])


def test_silent_without_the_programs_spans():
    """A program with no spans and no level counts (the parent of this
    instrumentation) gives a window in which every reader reads None."""
    _, run = window(host=[], niters=())
    assert {name: read(name, run) for name in READERS} == dict.fromkeys(READERS)
    _, run = window(niters=())
    assert read("active_pair_share", run) is None
    cpu = types.SimpleNamespace(device=torch.device("cpu"))
    assert spans.window(cpu) is None
