"""What the benchmark loads: nothing of JAX or of the JAX package (top-level
names compared whole: the port's name begins with the package's), and a
reference free of the program. And the command's refusals: no card, no
port in the checkout."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "justrelax_tpu"}


def _loaded_after(code):
    """Top-level module names loaded by ``code`` in a fresh interpreter."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = """
import time, torch
from perfbench.core import harness
from perfbench.tests.test_perfbench_cells import TINY
for cell in [w["name"] for w in harness.benchmark()["workloads"]][:2]:
    cfg = harness.workload(cell)["config"]
    harness.run_cell(cell, 5, 0.0, 1, "cpu", time.perf_counter(), cfg_override=TINY[cfg])
import perfbench.control, perfbench.run
"""
    loaded = _loaded_after(code)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert "justrelax_tpu_torch" in loaded


def test_the_reference_is_free_of_the_program():
    code = "\n".join(f"import perfbench.reference.{m}" for m in
                     ("vep2d", "particles2d", "shearband", "vankeken"))
    loaded = _loaded_after(code)
    assert not loaded & (FORBIDDEN | {"justrelax_tpu_torch"})


def test_forbidden_names_compared_whole(monkeypatch):
    from perfbench.core import harness

    fake = type(sys)("fake")
    for name in ("justrelax_tpu_torch_x", "jaxtyping", "flaxen.core"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert not set(harness.forbidden_modules()) - {
        m.split(".")[0] for m in sys.modules} & FORBIDDEN
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "justrelax_tpu.models", fake)
    assert set(harness.forbidden_modules()) == before | {"justrelax_tpu"}


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "shearband2d-1024.f32",
         "--seed", "3000000007", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=600)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _command(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    out = _command(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "justrelax_tpu_torch" in out.stderr
