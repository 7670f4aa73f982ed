"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), `device` and, with
--trace 1, `breakdown`; `checks` comes last. An earlier line (`setup`)
gives the split of the set-up, the peak memory and the card's power limit.
The numbers compared are also the last lines of standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Few host threads, so that the host paces the card alike in every run. The
# program builds its kernels into its own package directory, inside the
# checkout, in a checkout's first run only.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "2"


def fail(msg: str, code: int = 1):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    split = {"interpreter_s": time.perf_counter() - T0}

    t = time.perf_counter()
    import torch

    from . import harness
    split["torch_import_s"] = time.perf_counter() - t

    cell = harness.load_cell(args.workload)
    t = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        fail(f"{cell.name} needs {cell.chips} CUDA card(s); {n} available")
    split["cuda_count_s"] = time.perf_counter() - t
    torch.set_num_threads(2)
    t = time.perf_counter()
    try:
        port = __import__(harness.PORT)
    except ImportError as e:
        fail(f"the program under test is not importable here: {e}")
    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.empty(1, device=device)
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds, device=device,
                      system=port.align, port=port, cfg=harness.align_config(port, cell.config),
                      t0=T0)
    run.setup.update(split, port_and_context_s=time.perf_counter() - t)
    execute(run, trace=bool(args.trace))


def execute(run, trace: bool) -> dict:
    """Set-up, window, metrics and check of `run`; prints the result line
    and returns it."""
    import torch

    from . import check, harness

    harness.set_up(run)
    setup_s = time.perf_counter() - run.t0
    run.setup["setup_s"] = setup_s
    harness.window(run)
    found = harness.forbidden_modules()
    if found:
        fail(f"modules of JAX or of the JAX package are loaded: {found}")
    cuda = run.device.type == "cuda"
    run.memory_peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    if trace:
        harness.traced_window(run)
        metrics = harness.read_metrics(run, run.cell.per_layer)
    else:
        metrics = harness.read_metrics(run, run.cell.end_to_end)
    run.memo.clear()
    run.sync()
    print("setup " + json.dumps({
        "split_s": run.setup, "memory_peak_bytes": run.memory_peak,
        "power_limit": harness.power_limit() if cuda else None,
        "calls": len(run.calls), "pairs_per_call": run.cell.mix["batch"],
        "call_s": [round(b.end - a, 4) for a, b in zip(
            [run.window_start] + [c.end for c in run.calls[:-1]], run.calls)]}), flush=True)

    lims = check.limits(run.cell.name)
    values = check.readings(run, lims["p_gap_px"])
    correct, checks = check.judge(values, lims)
    if harness.forbidden_modules():
        fail(f"modules of JAX or of the JAX package are loaded: {harness.forbidden_modules()}")
    attempted = len(run.calls) * run.cell.mix["batch"]
    failed = int(sum(float((c.host[:, 8] > 0.5).sum()) for c in run.calls))
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": run.cell.chips, "memory_peak_bytes": int(run.memory_peak)}
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        line["breakdown"] = harness.trace_mod.breakdown(run.trace)
    line["checks"] = checks
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
