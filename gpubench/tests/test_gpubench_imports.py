"""What the benchmark loads: nothing on the run path or in the reference
has the top-level name ``jax``, ``jaxlib``, ``flax`` or ``stvd`` (the JAX
package; ``stvd_torch`` is another name), the reference imports nothing of
the port, and without a card the run prints no result and fails."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from gpubench import harness

ROOT = harness.ROOT
PROBE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import conftest
from gpubench import harness, run
import gpubench.calibrate
here = conftest.Path(sys.argv[2])
conftest.shrink(here)
for cell in ("msvd.serve.bank", "msrvtt.serve.bank", "msvd.train"):
    conftest.measure(here, cell, seconds=0.3)
for m in list(harness.benchmark()["end_to_end"]) + list(
        harness.benchmark()["per_layer"]):
    harness.load_module("metrics", m["name"])
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def test_run_path_loads_no_jax(tmp_path):
    import shutil
    here = tmp_path / "gb"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(Path(__file__).parent), str(here)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "stvd_torch" in tops
    assert not tops & set(harness.FORBIDDEN_MODULES), tops


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_port():
    for path in (harness.HERE / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("stvd_torch", "gpubench") + \
                harness.FORBIDDEN_MODULES, (path, name)


def test_no_file_imports_jax_or_the_jax_package():
    for path in harness.HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN_MODULES, (
                path, name)


def test_without_a_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         "msvd.serve.bank", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
