"""BENCHMARK.json against the rules its readers rely on, and every file
that a cell names found by its name."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from conftest import ROOT

from perfbench.bench import guard, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("perfbench/") and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
        assert m["name"].split(".")[0] in ("pairs_per_s", "setup_s")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m["workloads"]) <= set(CELLS)
        # the cells of a per-layer metric report the metric it moves
        moves = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moves.get("workloads", CELLS))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert {w["config"] for w in BENCH["workloads"]} == \
        {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_found_by_name(name):
    cell = manifest.cell(name)
    assert cell.config["name"] == cell.config_name
    assert set(cell.config["correct_limits"]) == {"dots_gap", "pos_gap"}
    assert cell.traffic["source"] == "generated"
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert {m["moves"] for m in cell.per_layer} <= names
    for m in cell.per_layer:
        assert callable(manifest.reader(m["name"]))


def test_a_split_quantity_shares_its_reader():
    assert manifest.reader("device.idle_share.dis").__module__ == \
        manifest.reader("device.idle_share").__module__


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        manifest.cell("no-such.cell")


def test_kernel_files():
    specs = manifest.kernels()
    assert {k["launch"] for k in specs} == {
        "poly_exp", "warp_bilinear", "box_blur_solve", "sample_patches",
        "sample_abs", "warp_planes"}
    from funscript_flow_tpu_torch.ops.cuda import KERNELS

    assert {k["launch"] for k in specs} == set(KERNELS)
    peaks = manifest.peaks()
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["f32_ops_per_s"] == 33.5e12


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["funscript_flow_tpu_torch.runner",
                                   "numpy", "jaxtyping"]) == []
    assert guard.forbidden_loaded(["funscript_flow_tpu.ops", "jax.numpy",
                                   "flax", "jaxlib.xla"]) == [
        "flax", "funscript_flow_tpu", "jax", "jaxlib"]


def test_a_run_loads_no_jax():
    """Everything a run imports, in a fresh interpreter: no module of
    JAX or of the JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import funscript_flow_tpu_torch.runner, funscript_flow_tpu_torch.ops.cuda\n"
        "import funscript_flow_tpu_torch.models.pipeline\n"
        "from perfbench.bench import cell, correct, trace, traffic, guard, manifest\n"
        "from perfbench.reference import clip\n"
        "import perfbench.control, perfbench.run\n"
        "for m in manifest.benchmark()['per_layer']: manifest.reader(m['name'])\n"
        "print(guard.forbidden_loaded())\n" % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "perfbench", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            src = open(os.path.join(ref, f)).read()
            assert "funscript_flow_tpu" not in src and "jax" not in src, f
