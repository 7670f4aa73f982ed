"""k1_multiband_roofline: the least time the card could take for K1's useful
work in the traced window over the device time there of K1's generic-channel
instance (`fused_iter_kernel<0>`, the one that runs every channel count but
1 and 3) and the moment pass that follows it, in %.

The useful work is k1_roofline's, at the cell's channel count: one
pair-trip for each iteration a pair applied at a level (k1_roofline's
re-solve, shared through the run's cache), bytes and flops per pair-trip
from benchmark/yardstick/work.py. Where no kernel of that instance ran, it
reads nothing."""

import torch

from benchmark import harness
from benchmark.yardstick import peaks, work

K1_GENERIC = r"fused_iter_kernel<0>"


def read(run):
    tr = run.trace
    if tr is None or run.device.type != "cuda":
        return None
    pk = peaks.card_peaks(torch.cuda.get_device_name(run.device))
    own = tr.owner(K1_GENERIC)
    if pk is None or not own.any():
        return None
    level_trips = harness.load_reader("k1_roofline").level_trips
    c = run.cell.mix["channels"]
    robust = run.cell.config["robust"] != "QUADRATIC"
    least = 0.0
    for k in range(len(run.pool)):   # the traced window calls each batch once
        for h, w, n in level_trips(run, k):
            least += peaks.least_seconds(n * work.fused_iter_bytes(c, h, w, robust),
                                         n * h * w * work.fused_iter_flops_per_pixel(c, robust),
                                         pk)
    return 100.0 * least / tr.device.seconds(own)
