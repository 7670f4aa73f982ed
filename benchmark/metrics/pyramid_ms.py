"""pyramid_ms: CUDA events around the program's build_pyramid of both
images of a pool batch, cast as align casts them: per align call, the mean
over the pool's batches of three timings each, after one untimed build.
Measured after the traced window."""

import importlib

import torch


def read(run):
    if run.device.type != "cuda":
        return None
    pyr = importlib.import_module(f"{run.port.__name__}.ops.pyramid")
    cfg = run.cfg
    times = []
    for b in run.pool:
        i1, i2 = b.i1.to(torch.float32), b.i2.to(torch.float32)

        def both():
            pyr.build_pyramid(i1, cfg.nscales, cfg.nu, cfg.pyramid_method)
            pyr.build_pyramid(i2, cfg.nscales, cfg.nu, cfg.pyramid_method)

        both()
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            both()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        del i1, i2
    return sum(times) / len(times)
