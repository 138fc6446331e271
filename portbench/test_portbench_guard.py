"""What the benchmark loads: no JAX, no JAX package, and a reference that
loads nothing of the program. In fresh subprocesses, since a test worker
may already hold JAX from the suite's conftest. CPU only."""
from __future__ import annotations

import json
import subprocess
import sys

from portbench import harness, manifest

ROOT = harness.ROOT
BENCH = manifest.load_benchmark(ROOT)

PROBE = r"""
import importlib, json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
for name in json.loads(sys.argv[2]):
    importlib.import_module(name)
from portbench import manifest
from pathlib import Path
for metric in json.loads(sys.argv[3]):
    manifest.reader(Path(sys.argv[1]), metric)
for cell in json.loads(sys.argv[4]):
    manifest.cell(Path(sys.argv[1]), cell)
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _start(modules, metrics=(), cells=()) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", PROBE, str(ROOT), json.dumps(list(modules)),
         json.dumps(list(metrics)), json.dumps(list(cells))],
        stdout=subprocess.PIPE, text=True)


def _loaded(proc: subprocess.Popen) -> set:
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0
    return set(json.loads(out.strip().splitlines()[-1]))


def test_nothing_loads_jax_and_the_reference_nothing_of_the_program():
    """In one process the harness, the port's modules it calls at run time,
    every metric reader, configuration and mix; in another the reference
    alone. No module whose top-level name is jax, jaxlib, flax or the JAX
    package `repro` (compared whole, so `repro_torch` passes), and nothing
    of the port in the reference's."""
    harness_proc = _start(
        ["portbench.harness", "portbench.calibrate",
         "repro_torch.serving.engine", "repro_torch.serving.scheduler",
         "repro_torch.serving.workloads", "repro_torch.obs.trace",
         "repro_torch.core.camera", "repro_torch.core.gaussians",
         "repro_torch.kernels.ops"],
        [m["name"] for m in BENCH["per_layer"]],
        [w["name"] for w in BENCH["workloads"]])
    reference_proc = _start(["portbench.reference.render"])
    tops = _loaded(harness_proc)
    assert "repro_torch" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)
    tops = _loaded(reference_proc)
    assert not tops & (set(harness.FORBIDDEN) | {"repro_torch"})


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "reprox", "numpy"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jaxlib.xla_client", "flax", "torch"]) == [
        "flax", "jaxlib", "repro"]
