"""Run a function on `world` ranks of one machine, each its own process.

    outs = run_ranks(fn, world, device="cpu", args={"i1": i1, "i2": i2},
                     kwargs={"tile": 2}, timeout_s=120)

Each rank is a fresh interpreter (start method `spawn`) that joins a
process group on a free local TCP port (`init_distributed`), calls
`fn(device, inputs, **kwargs)` and returns. `fn` must be a module-level
function of this package, so a rank imports nothing but the package.
Inputs and outputs travel as .npy files in a temporary directory: `args`
(a dict of arrays) is written once and every rank reads it as `inputs`;
`fn` returns a dict of arrays and numbers, which comes back per rank with
the kernels' launch counts of that rank.

A rank that raises, or a run that outlasts `timeout_s`, kills every rank
and raises here with the failing rank's traceback: no rank is left behind
in a collective.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import socket
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

__all__ = ["run_ranks", "raise_on_rank"]


def _free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, device: str, backend, timeout_s: float,
               threads: int, tmp: str, kwargs: dict) -> None:
    """Body of one rank's process: its outputs go to `tmp`, or the time and
    its traceback to `tmp/error{rank}.txt` and the exit code is 1."""
    out = Path(tmp)
    try:
        os.environ["LOCAL_RANK"] = str(rank)
        import torch
        import torch.distributed as dist

        from ..ops.kernels import fused_iter, normal_eq, warp, warp_floor
        from .sharded import init_distributed

        counted = {"fused_iter_moments": fused_iter, "warp_planar": warp,
                   "weighted_moments": normal_eq, "warp_floor": warp_floor}

        torch.set_num_threads(threads)
        dev = init_distributed(device, backend, timeout_s, init_method=f"tcp://127.0.0.1:{port}",
                               world_size=world, rank=rank)
        inputs = {p.stem[3:]: np.load(p) for p in out.glob("in_*.npy")}
        for m in counted.values():
            m.LAUNCHES = 0
        result = fn(dev, inputs, **kwargs)
        launches = {name: m.LAUNCHES for name, m in counted.items()}
        # Only after success: a failed rank leaves at once (its peers then
        # fail in their collectives, or the parent kills them).
        dist.destroy_process_group()
        scalars = {}
        for k, v in result.items():
            if isinstance(v, (np.ndarray, torch.Tensor)):
                v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
                np.save(out / f"out{rank}_{k}.npy", v)
            else:
                scalars[k] = v
        (out / f"meta{rank}.json").write_text(json.dumps({"scalars": scalars,
                                                          "launches": launches}))
    except BaseException:
        # The time of the failure leads the file: a rank that dies first
        # makes its peers fail in their collectives, and the parent reports
        # the first failure.
        (out / f"error{rank}.txt").write_text(f"{time.time()}\n{traceback.format_exc()}")
        raise SystemExit(1)


def run_ranks(fn, world: int, *, device: str = "cpu", backend: str | None = None,
              timeout_s: float = 300.0, args: dict | None = None, kwargs: dict | None = None,
              threads: int | None = None) -> list[dict]:
    """Run `fn(device, inputs, **kwargs)` on `world` ranks; return, per rank,
    {"out": {name: value}, "launches": {kernel: count}} (the kernels'
    LAUNCHES, set to 0 just before `fn`).

    device: "cpu" (gloo) or "cuda": rank r on cuda:(r mod the card count),
    NCCL by default, `backend="gloo"` to let several ranks share a card.
    threads: torch threads per rank (default: the cores over the ranks).
    Raises RuntimeError with the traceback of the rank that failed first
    when a rank fails, and TimeoutError when the run outlasts timeout_s; in
    both cases every rank is killed first.
    """
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    for attempt in range(3):
        try:
            return _run_once(fn, world, device, backend, timeout_s, args, kwargs, threads)
        except _PortTaken:
            # Another process took the free port before rank 0 bound it.
            if attempt == 2:
                raise


class _PortTaken(RuntimeError):
    pass


def _run_once(fn, world, device, backend, timeout_s, args, kwargs, threads) -> list[dict]:
    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="ica_ranks_") as tmp:
        for k, v in (args or {}).items():
            np.save(Path(tmp) / f"in_{k}.npy", np.asarray(v))
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, port, device, backend, timeout_s, threads, tmp,
                                   kwargs or {}), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs) if p.exitcode not in (None, 0)),
                              None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs) if p.exitcode not in (None, 0)),
                              None)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(30)
        if failed is not None:
            errors = []
            for r in range(world):
                err = Path(tmp) / f"error{r}.txt"
                if err.exists():
                    when, why = err.read_text().split("\n", 1)
                    errors.append((float(when), r, why))
            when, failed, why = min(errors, default=(0.0, failed,
                                                     f"exit code {procs[failed].exitcode}"))
            kind = _PortTaken if "address already in use" in why.lower() else RuntimeError
            raise kind(f"rank {failed} of {world} failed:\n{why}")
        if any(p.exitcode != 0 for p in procs):
            raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s")
        outs = []
        for r in range(world):
            meta = json.loads((Path(tmp) / f"meta{r}.json").read_text())
            arrays = {p.stem[len(f"out{r}_"):]: np.load(p)
                      for p in Path(tmp).glob(f"out{r}_*.npy")}
            outs.append({"out": {**arrays, **meta["scalars"]}, "launches": meta["launches"]})
        return outs


def raise_on_rank(device, inputs, *, rank: int) -> dict:
    """A rank body that checks `run_ranks` itself: rank `rank` raises while
    every other rank waits in an all-reduce that can never complete."""
    import torch
    import torch.distributed as dist

    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    t = torch.zeros(1, device=device)
    dist.all_reduce(t)
    return {"t": t}
