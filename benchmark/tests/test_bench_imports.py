"""What the benchmark loads: neither JAX nor the JAX package anywhere, and
nothing of the program in the reference. Module names are compared by
their top-level name (the part before the first dot), whole."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "inverse_compositional_algorithm_tpu"}
PORT = "inverse_compositional_algorithm_tpu_torch"


def loaded_after(code: str) -> set[str]:
    """Top-level names of the modules a fresh interpreter holds after `code`."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_every_file_load_no_jax():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    code = "\n".join([
        "import benchmark.run, benchmark.harness as h, benchmark.check",
        "import benchmark.reference.align_ref, benchmark.traffic.generate as g",
        "import benchmark.yardstick.peaks, benchmark.yardstick.work, benchmark.yardstick.trace",
        f"import {PORT}",
        *[f"h.load_cell({w['name']!r})" for w in bench["workloads"]],
        *[f"h.load_reader({m!r})" for m in metrics],
    ])
    found = loaded_after(code)
    assert PORT in found
    assert not found & FORBIDDEN, found & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    found = loaded_after("import benchmark.reference.align_ref, benchmark.traffic.generate, "
                         "benchmark.yardstick.peaks, benchmark.yardstick.work")
    assert not found & (FORBIDDEN | {PORT}), found & (FORBIDDEN | {PORT})


def test_every_config_names_a_reference_that_loads_alone():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in bench["configs"]:
        ref = json.loads((ROOT / conf["file"]).read_text())["reference"]
        found = loaded_after(f"import benchmark.reference.{ref}")
        assert not found & (FORBIDDEN | {PORT})
