"""Multi-process launcher for sharded alignment: one process per device.

Under torchrun (it sets RANK, WORLD_SIZE, LOCAL_RANK and the rendezvous),
one command per host:

    torchrun --nproc-per-node N \
        -m inverse_compositional_algorithm_tpu_torch.parallel.launch \
        --batch-per-host 64 [--tile 2] [--height 388 --width 584]

or one command per process, with the rendezvous given:

    python -m inverse_compositional_algorithm_tpu_torch.parallel.launch \
        --coordinator <host0>:29500 --num-processes P --process-id i ...

Each host's `--batch-per-host` bench pairs are split over its pairs
groups (rounded up as the JAX launcher does); each rank makes its pairs
group's share (`eval.benchmarks.make_bench_batch`, seeded by the pairs
group, so the ranks of a tile group share their pairs), aligns it through
`align_sharded`, times
`--repeats` calls after a warm-up (CUDA events on a card), and rank 0
prints one JSON record: the JAX launcher's keys (without its TPU-era
`vs_numpy_baseline`), the largest corner displacement from the pairs'
ground truth, and the card's name and power limit. NCCL is the backend
on cards (one card per rank); `--backend gloo` lets several ranks share
one card, and `--device cpu` runs gloo ranks on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import socket

import torch
import torch.distributed as dist

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (omit under torchrun)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--batch-per-host", type=int, default=64,
                    help="pairs of each host, split over its pairs groups (rounded up "
                         "so that the global batch divides over the pairs axis)")
    ap.add_argument("--height", type=int, default=388)
    ap.add_argument("--width", type=int, default=584)
    ap.add_argument("--tile", type=int, default=1, help="row-tile axis size (spatial sharding)")
    ap.add_argument("--nscales", type=int, default=5)
    ap.add_argument("--transform", default="homography")
    ap.add_argument("--robust", default="charbonnier")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    from ..config import AlignConfig
    from ..eval.benchmarks import card_info, make_bench_batch
    from ..ops.normal_equations import RobustLoss
    from ..ops.transforms import TransformType, transform_points
    from .mesh import PAIRS_AXIS, make_mesh
    from .ranks import time_calls
    from .sharded import align_sharded, init_distributed

    owned = not dist.is_initialized()
    if owned:
        kw = {}
        if args.coordinator:
            kw = dict(init_method=f"tcp://{args.coordinator}", world_size=args.num_processes,
                      rank=args.process_id)
        dev = init_distributed(args.device, args.backend, **kw)
    elif args.device == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    try:
        world = dist.get_world_size()
        pairs = world // args.tile
        mesh = make_mesh(pairs=pairs, tile=args.tile, device_type=dev.type)
        cfg = AlignConfig(transform=TransformType[args.transform.upper()],
                          robust=RobustLoss[args.robust.upper()], nscales=args.nscales)
        names = [None] * world
        dist.all_gather_object(names, socket.gethostname())
        hosts = len(set(names))
        # As the JAX launcher (launch.py:109-112): each host's batch rounds
        # up to a multiple of pairs // gcd(pairs, hosts), so the global
        # batch divides over the pairs axis; each pairs group then aligns
        # its share of it.
        step = pairs // math.gcd(pairs, hosts)
        b_global = max(step, -(-args.batch_per_host // step) * step) * hosts
        b_local = b_global // pairs
        i1, i2, p_gt = make_bench_batch(b_local, args.height, args.width, cfg.transform,
                                        seed=mesh.get_local_rank(PAIRS_AXIS), device=dev)

        def call():
            return align_sharded(i1, i2, cfg, mesh=mesh, tile_rows=args.tile > 1)

        res = call()                              # warm-up (and the kernels' build)
        ms = torch.tensor([time_calls(call, args.repeats, dev)], dtype=torch.float64,
                          device=dev)
        res = call()
        finite = torch.tensor([int(torch.isfinite(res.error).all())], device=dev)
        # Accuracy: corner displacement against the pairs' ground truth.
        xs = [0.0, args.width - 1.0, 0.0, args.width - 1.0]
        ys = [0.0, 0.0, args.height - 1.0, args.height - 1.0]
        ax, ay = transform_points(res.p.double(), cfg.transform, xs, ys)
        bx, by = transform_points(torch.tensor(p_gt, dtype=torch.float64, device=dev),
                                  cfg.transform, xs, ys)
        corner = torch.hypot(ax - bx, ay - by).max().reshape(1)
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)           # the slowest rank paces the run
        dist.all_reduce(finite, op=dist.ReduceOp.MIN)
        dist.all_reduce(corner, op=dist.ReduceOp.MAX)
        pps = b_global / (float(ms) / 1e3)
        rec = {
            "hosts": hosts,
            "devices": world,
            "mesh": f"{pairs}x{args.tile} pairs x tile",
            "batch_global": b_global,
            "pairs_per_sec_global": pps,
            "pairs_per_sec_per_device": pps / world,
            "errors_finite": bool(finite),
            "max_corner_err_px": float(corner),
            "ms_per_call": float(ms),
            "device": dev.type,
            "backend": dist.get_backend(),
            "card": card_info()["nvidia_smi"] if dev.type == "cuda" else None,
        }
        if dist.get_rank() == 0:
            print(json.dumps(rec), flush=True)
        return rec
    finally:
        if owned:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
