"""The PyTorch port stands alone: it imports nothing of JAX and nothing of
the JAX package, and its entry points run on CUDA unless asked for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import funscript_flow_tpu_torch as port

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "funscript_flow_tpu_torch"


def _port_modules():
    names = ["funscript_flow_tpu_torch"]
    for m in pkgutil.walk_packages([str(PKG)], "funscript_flow_tpu_torch."):
        names.append(m.name)
    return sorted(names)


def test_port_modules_listed():
    mods = _port_modules()
    for want in ("funscript_flow_tpu_torch.runner",
                 "funscript_flow_tpu_torch.cli",
                 "funscript_flow_tpu_torch.models.pipeline",
                 "funscript_flow_tpu_torch.models.dis",
                 "funscript_flow_tpu_torch.ops.farneback",
                 "funscript_flow_tpu_torch.ops.signal",
                 "funscript_flow_tpu_torch.ops.cuda.polyexp",
                 "funscript_flow_tpu_torch.ops.cuda.warp",
                 "funscript_flow_tpu_torch.ops.cuda.flow_step",
                 "funscript_flow_tpu_torch.io.decode",
                 "funscript_flow_tpu_torch.io.checkpoint",
                 "funscript_flow_tpu_torch.parallel.mesh",
                 "funscript_flow_tpu_torch.parallel.dp",
                 "funscript_flow_tpu_torch.parallel.signal_sp",
                 "funscript_flow_tpu_torch.utils.devprof",
                 "funscript_flow_tpu_torch.utils.backends",
                 "funscript_flow_tpu_torch.utils.logging",
                 "funscript_flow_tpu_torch.utils.config",
                 "funscript_flow_tpu_torch.runtime",
                 "funscript_flow_tpu_torch.runtime._build",
                 "funscript_flow_tpu_torch.worker",
                 "funscript_flow_tpu_torch.gui.app",
                 "funscript_flow_tpu_torch.gui.player",
                 "funscript_flow_tpu_torch.gui.preview",
                 "funscript_flow_tpu_torch.gui.manual"):
        assert want in mods


def test_native_runtime_loads_from_the_port_build_dir():
    """The port builds and loads its own pump library from
    build/funscript_flow_tpu_torch/, never the JAX package's
    funscript_flow_tpu/runtime/libframe_pump.so (checked in a fresh
    interpreter, by the files the process has mapped)."""
    code = (
        "import sys\n"
        "from funscript_flow_tpu_torch import runtime\n"
        "assert runtime.available(), runtime.unavailable_reason()\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(runtime.library_path())\n"
        "print('JAXSO', 'funscript_flow_tpu/runtime/' in maps)\n"
        "print('JAX', any(k == 'jax' or k.startswith('funscript_flow_tpu.')"
        " for k in sys.modules))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    lib, jaxso, jax = out.stdout.split("\n")[:3]
    assert Path(lib).parent == ROOT / "build" / "funscript_flow_tpu_torch"
    assert Path(lib).is_file()
    assert jaxso == "JAXSO False" and jax == "JAX False"
    assert not list((PKG / "runtime").glob("*.so"))


def test_import_whole_port_loads_no_jax():
    """Every port module, imported in a fresh interpreter, leaves jax and
    the JAX package out of sys.modules."""
    code = (
        "import importlib, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'jaxlib' or k == 'funscript_flow_tpu' "
        "or k.startswith('funscript_flow_tpu.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_import_statement(path):
    """No import statement of the port or of chip_smoke.py names jax or the
    JAX package (lazy imports inside functions included)."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "funscript_flow_tpu"), (path, n)


def test_default_device():
    assert port.default_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert port.default_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.default_device()
        with pytest.raises(RuntimeError):
            port.default_device("cuda")


def test_entry_points_default_to_cuda():
    """With no device argument, the entry points ask for CUDA and raise
    without it: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from funscript_flow_tpu_torch.models.pipeline import (
        FlowAnalyzer, StreamingFlowAnalyzer)
    from funscript_flow_tpu_torch.runner import process_video, run_headless
    from funscript_flow_tpu_torch.utils.params import Params

    with pytest.raises(RuntimeError):
        StreamingFlowAnalyzer()
    with pytest.raises(RuntimeError):
        FlowAnalyzer()
    with pytest.raises(RuntimeError):
        process_video("nope.mp4", Params(), lambda m: None)
    with pytest.raises(RuntimeError):
        run_headless("nope.mp4", Params(), log_path=os.devnull)
