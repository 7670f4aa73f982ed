"""Readings that the limits of `correct` are set from: the program's on many
seeds, and the control's, on the card at a cell's own size.

    python3 -m benchmark.control --workload <name> --seeds 1 2 3 \\
        --control reference_tf32_values --control-seeds 4 5 6

The control, `reference_tf32_values`, is the reference in float32 in the
program's place, computed in TF32, the nearest precision below the float32
with TF32 off that the configurations state: TF32 operands in every
product over pixels, every plane held at TF32's precision (align_ref.Arith).
Each seed builds its pool, warms up and makes one call on each pool batch,
as the first cycle of a window; the numbers of benchmark/check.py are
printed for it, one JSON line a seed. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace

import torch

from . import check, harness
from .reference import align_ref

CONTROLS = ("reference_tf32_values",)


def reference_in_place(cell):
    """A stand-in for the program's align: the reference in float32, in TF32."""
    def system(i1, i2, cfg):
        r = align_ref.align_ref(i1, i2, cell.config, dtype=torch.float32, max_rows=1,
                                rounding="tf32_values")
        return SimpleNamespace(p=r.p, diverged=r.diverged, niters=r.niters.int(), iw=r.iw,
                               di=r.di, valid=r.valid)
    return system


def readings(cell, port, seed: int, control: str | None, device) -> dict:
    system = port.align if control is None else reference_in_place(cell)
    run = harness.Run(cell=cell, seed=seed, seconds=0.0, device=device, system=system,
                      port=port, cfg=harness.align_config(port, cell.config),
                      t0=time.perf_counter())
    harness.set_up(run)
    picks = harness.check_pairs(run)
    trips = []
    for k in range(len(run.pool)):
        before = harness.k1_counter(port)
        host = harness.call(run, k, picks[k])
        trips.append(harness.k1_counter(port) - before)
        run.calls.append(harness.Call(batch=k, end=time.perf_counter(), host=host,
                                      k1_launches=0))
    values = check.readings(run, check.limits(cell.name)["p_gap_px"])
    return {"seed": seed, "control": control, "trips_per_batch": trips, **values}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", choices=CONTROLS, action="append", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    port = __import__(harness.PORT)
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    jobs = [(s, None) for s in args.seeds]
    jobs += [(s, c) for c in args.control for s in args.control_seeds]
    for seed, control in jobs:
        t = time.perf_counter()
        out = readings(cell, port, seed, control, device)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps({"workload": cell.name, **out}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
