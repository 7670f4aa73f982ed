"""k3_roofline: the least time the card could take for the final warps of
the traced window (every pair once a call) over K3's device time there,
in %. Bytes and flops: benchmark/yardstick/work.py; peaks: peaks.py."""

import torch

from benchmark.yardstick import peaks, work

K3 = r"warp_planar_kernel"


def read(run):
    tr = run.trace
    if tr is None or run.device.type != "cuda":
        return None
    pk = peaks.card_peaks(torch.cuda.get_device_name(run.device))
    own = tr.device.matching(K3) & tr.kernels()
    if pk is None or not own.any():
        return None
    mix = run.cell.mix
    b, h, w, c = mix["batch"], mix["height"], mix["width"], mix["channels"]
    n = b * len(run.pool)   # the traced window calls each batch once
    least = peaks.least_seconds(n * work.warp_bytes(c, h, w),
                                n * h * w * work.warp_flops_per_pixel(c), pk)
    return 100.0 * least / tr.device.seconds(own)
