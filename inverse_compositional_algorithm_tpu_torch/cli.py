"""Command-line interface of the PyTorch port (`ica-torch`).

Usage::

    python -m inverse_compositional_algorithm_tpu_torch.cli align I1.png I2.png \
        --transform homography --robust charbonnier --nscales 5 \
        --output transform.json --save-warped warped.png [--device cpu]

    python -m inverse_compositional_algorithm_tpu_torch.cli make-config config.ini
    python -m inverse_compositional_algorithm_tpu_torch.cli bench --help
    python -m inverse_compositional_algorithm_tpu_torch.cli eval --output EVAL.json

The JAX package's CLI (`ica-tpu`) with the same subcommands and flags, plus
`--device` (default cuda; `--device cpu` runs the plain path). `bench`
measures a CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .config import AlignConfig, read_config_file, write_config_file
from .models.api import align
from .ops.normal_equations import RobustLoss
from .ops.transforms import TransformType
from .utils.imageio import load_image, save_image


def _build_config(args) -> AlignConfig:
    if getattr(args, "config", None):
        cfg = read_config_file(args.config)["pyramidal_inverse_compositional_algorithm"]
    else:
        cfg = AlignConfig()
    over = {}
    if args.transform:
        over["transform"] = TransformType[args.transform.upper()]
    if args.robust:
        over["robust"] = RobustLoss[args.robust.upper()]
    for name in ("tol", "nscales", "nu", "delta", "max_iter"):
        v = getattr(args, name, None)
        if v is not None:
            over[name] = v
    if args.lam is not None:
        over["lam"] = args.lam
    if args.verbose:
        over["verbose"] = True
    return cfg.replace(**over).validate()


def cmd_align(args) -> int:
    i1 = load_image(args.image1)
    i2 = load_image(args.image2)
    cfg = _build_config(args)
    t0 = time.perf_counter()
    res = align(i1, i2, cfg, device=args.device)
    p = res.params(cfg).cpu()            # waits for the device
    elapsed = time.perf_counter() - t0
    out = {
        "transform": cfg.transform.name,
        "robust": cfg.robust.name,
        "nscales": cfg.nscales,
        "p": p.tolist(),
        "error": float(res.error),
        "iterations": int(res.niters),
        "diverged": bool(res.diverged),
        "seconds": elapsed,
        "device": str(res.p.device),
    }
    text = json.dumps(out, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text + "\n")
    print(text)
    if args.save_warped:
        save_image(res.iw, args.save_warped)
    if args.save_error:
        save_image(res.di, args.save_error)
    return 0


def cmd_make_config(args) -> int:
    write_config_file(args.path)
    print(f"wrote {args.path}")
    return 0


def cmd_bench(args) -> int:
    from .eval.benchmarks import run_benchmark

    result = run_benchmark(batch=args.batch, height=args.height, width=args.width,
                           transform=TransformType[args.transform.upper()],
                           robust=RobustLoss[args.robust.upper()],
                           nscales=args.nscales, repeats=args.repeats)
    print(json.dumps(result))
    return 0


def cmd_eval(args) -> int:
    from .eval.run_eval import main as run_eval_main

    run_eval_main(args.output, device=args.device)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ica-torch",
                                 description="inverse compositional alignment, "
                                             "PyTorch with CUDA kernels")
    sub = ap.add_subparsers(dest="cmd", required=True)

    al = sub.add_parser("align", help="align an image pair")
    al.add_argument("image1")
    al.add_argument("image2")
    al.add_argument("--config", help="reference-format INI file")
    al.add_argument("--transform", choices=[t.name.lower() for t in TransformType])
    al.add_argument("--robust", choices=[r.name.lower() for r in RobustLoss])
    al.add_argument("--tol", type=float)
    al.add_argument("--nscales", type=int)
    al.add_argument("--nu", type=float)
    al.add_argument("--delta", type=int)
    al.add_argument("--max-iter", dest="max_iter", type=int)
    al.add_argument("--lambda", dest="lam", type=float)
    al.add_argument("--output", help="write result JSON here")
    al.add_argument("--save-warped", help="write warped image")
    al.add_argument("--save-error", help="write error image")
    al.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    al.add_argument("-v", "--verbose", action="store_true")
    al.set_defaults(fn=cmd_align)

    mc = sub.add_parser("make-config", help="write a default INI config")
    mc.add_argument("path")
    mc.set_defaults(fn=cmd_make_config)

    be = sub.add_parser("bench", help="throughput benchmark on the CUDA card (one JSON line)")
    be.add_argument("--batch", type=int, default=16)
    be.add_argument("--height", type=int, default=388)
    be.add_argument("--width", type=int, default=584)
    be.add_argument("--transform", default="homography")
    be.add_argument("--robust", default="charbonnier")
    be.add_argument("--nscales", type=int, default=5)
    be.add_argument("--repeats", type=int, default=3)
    be.set_defaults(fn=cmd_bench)

    ev = sub.add_parser("eval", help="accuracy/speed sweeps (transforms, losses, depths)")
    ev.add_argument("--output", help="write the sweep record JSON here")
    ev.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ev.set_defaults(fn=cmd_eval)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
