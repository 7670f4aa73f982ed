"""launches_per_trip: device kernels in the traced window over the K1
kernels in it."""

K1 = r"fused_iter_kernel"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    kern = tr.kernels()
    k1 = int((kern & tr.device.matching(K1)).sum())
    return int(kern.sum()) / k1 if k1 else None
