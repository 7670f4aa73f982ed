"""One run of one cell: set-up, the measured window, the traced window, the
metrics and the check of what the window produced.

A cell is found by its name in BENCHMARK.json; its configuration, traffic
mix and metrics are files found by their names (README of the layout in
PERF.md). Nothing here knows a particular cell.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .traffic.generate import Batch, load_mix, make_pool
from .yardstick import trace as trace_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PORT = "inverse_compositional_algorithm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "inverse_compositional_algorithm_tpu")


@dataclass
class Cell:
    name: str
    config: dict        # the configuration file's content
    mix: dict           # the traffic file's content
    chips: int
    end_to_end: list    # BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {spec_path.name}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name=name, config=json.loads((ROOT / conf["file"]).read_text()),
                mix=load_mix(w["traffic"]), chips=int(w["chips"]),
                end_to_end=mine(spec["end_to_end"]), per_layer=mine(spec["per_layer"]))


def align_config(port, cfg: dict):
    """The program's AlignConfig for a configuration file."""
    return port.AlignConfig(
        transform=port.TransformType[cfg["transform"]], robust=port.RobustLoss[cfg["robust"]],
        lam=float(cfg["lam"]), tol=float(cfg["tol"]), max_iter=int(cfg["max_iter"]),
        nscales=int(cfg["nscales"]), nu=float(cfg["nu"]), nanifoutside=bool(cfg["nanifoutside"]),
        delta=int(cfg["delta"]), delta_cap=bool(cfg["delta_cap"]),
        pyramid_method=cfg["pyramid_method"], precondition=bool(cfg["precondition"]),
        divergence_guard=bool(cfg["divergence_guard"]))


@dataclass
class Call:
    batch: int
    end: float            # host clock when p reached the host
    host: np.ndarray      # [B, 10]: p (8), diverged, finest niters
    k1_launches: int      # the program's K1 counter after the call


@dataclass
class Sampled:
    """The check's sample of one batch's first call in the window."""

    idx: torch.Tensor     # pairs
    iw: torch.Tensor
    di: torch.Tensor
    valid: torch.Tensor


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    device: torch.device
    system: object                 # the program's align
    port: object                   # the program's package
    cfg: object                    # its AlignConfig
    t0: float
    setup: dict = field(default_factory=dict)
    pool: list[Batch] = field(default_factory=list)
    calls: list[Call] = field(default_factory=list)
    window_start: float = 0.0
    k1_start: int = 0
    samples: dict = field(default_factory=dict)
    trace: trace_mod.Trace | None = None
    memory_peak: int = 0
    memo: dict = field(default_factory=dict)
    precision: dict = field(default_factory=dict)   # as set-up states it
    precision_drift: int = 0                        # calls that ended with other flags

    def cached(self, key: str, make):
        """`make()` once per run, for readers that share a probe."""
        if key not in self.memo:
            self.memo[key] = make()
        return self.memo[key]

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


PRECISION_FLAGS = {
    "matmul.allow_tf32": lambda: torch.backends.cuda.matmul.allow_tf32,
    "cudnn.allow_tf32": lambda: torch.backends.cudnn.allow_tf32,
    "float32_matmul_precision": torch.get_float32_matmul_precision,
    "matmul.fp32_precision": lambda: torch.backends.cuda.matmul.fp32_precision,
    "cudnn.conv.fp32_precision": lambda: torch.backends.cudnn.conv.fp32_precision,
    "fp32_precision": lambda: torch.backends.fp32_precision,
}


def precision_flags() -> dict:
    """torch's float32 precision flags as they stand; a flag that this torch
    lacks, or refuses to read, reads as the name of the error."""
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, get in PRECISION_FLAGS.items():
            try:
                out[name] = get()
            except Exception as e:  # noqa: BLE001 - the error's name is the reading
                out[name] = type(e).__name__
    return out


def set_precision(run: Run) -> None:
    """TF32 on or off as the configuration states, for cuBLAS and cuDNN."""
    tf32 = bool(run.cell.config["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    run.precision = precision_flags()
    if (run.precision["matmul.allow_tf32"], run.precision["cudnn.allow_tf32"]) != (tf32, tf32):
        raise RuntimeError(f"TF32 could not be set to {tf32}: {run.precision}")


def k1_counter(port) -> int:
    return sys.modules[f"{port.__name__}.ops.kernels.fused_iter"].LAUNCHES


def check_pairs(run: Run) -> list[np.ndarray]:
    rng = np.random.default_rng([run.seed % (1 << 64), 7])
    b = run.cell.mix["batch"]
    return [np.sort(rng.choice(b, min(b, run.cell.mix["check_pairs"]), replace=False))
            for _ in run.pool]


def call(run: Run, k: int, sample: np.ndarray | None = None):
    """One `align` call on pool batch k, ended by copying p (with the
    divergence flags and finest iteration counts) to the host."""
    b = run.pool[k]
    res = run.system(b.i1, b.i2, run.cfg)
    run.precision_drift += precision_flags() != run.precision
    host = torch.cat([res.p, res.diverged[:, None].to(res.p.dtype),
                      res.niters[:, None].to(res.p.dtype)], 1).cpu().numpy()
    if sample is not None:
        idx = torch.cat([torch.as_tensor(sample, device=res.p.device),
                         res.niters.argmax()[None]])
        run.samples[k] = Sampled(idx=idx.cpu(), iw=res.iw.index_select(0, idx),
                                 di=res.di.index_select(0, idx),
                                 valid=res.valid.index_select(0, idx))
    return host


def set_up(run: Run) -> None:
    set_precision(run)
    t = time.perf_counter()
    run.pool = make_pool(run.cell.mix, run.cell.config["transform"], run.seed, run.device)
    run.sync()
    run.setup["pool_s"] = time.perf_counter() - t
    t = time.perf_counter()
    picks = check_pairs(run)
    for k in range(2):   # the window's own path, sampling included; the same for every seed
        call(run, k % len(run.pool), picks[k % len(run.pool)])
    run.samples.clear()
    run.sync()
    run.setup["warmup_s"] = time.perf_counter() - t


def window(run: Run) -> None:
    """Calls back to back, cycling the pool, until `seconds` have passed; a
    call that ends after that is not counted."""
    picks = check_pairs(run)
    run.sync()
    run.k1_start = k1_counter(run.port)
    run.window_start = time.perf_counter()
    i = 0
    while True:
        k = i % len(run.pool)
        host = call(run, k, picks[k] if k not in run.samples else None)
        end = time.perf_counter()
        if end - run.window_start > run.seconds:
            break
        run.calls.append(Call(batch=k, end=end, host=host, k1_launches=k1_counter(run.port)))
        i += 1
    if len(run.calls) < len(run.pool):
        raise RuntimeError(f"the window held {len(run.calls)} whole calls, fewer than the "
                           f"pool's {len(run.pool)} batches: lengthen --seconds")


def traced_window(run: Run, attempts: int = 3) -> None:
    """One call on each pool batch under torch.profiler, each in a SPAN. A
    window in which the profiler recorded no device activity is run again."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        run.sync()
        with torch.profiler.profile(activities=acts) as prof:
            for k in range(len(run.pool)):
                with torch.profiler.record_function(trace_mod.SPAN):
                    call(run, k)
        run.trace = trace_mod.from_profiler(prof)
        if run.trace is not None:
            return
    raise RuntimeError(f"torch.profiler recorded no device activity in {attempts} windows")


def load_reader(name: str):
    """The reader module of metric `name`: metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(run: Run, entries: list) -> dict:
    """{name: {value, unit}} of the metrics whose readers found a value."""
    out = {}
    for m in entries:
        value = load_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
