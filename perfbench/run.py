#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on one NVIDIA GPU.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Set-up (imports, the CUDA context, the
kernel library, the cell's inputs made from the seed, a warm-up of every
window size the cell runs) is timed as ``setup_s``; then clips go through
``funscript_flow_tpu_torch.runner.process_video`` back to back, in whole
blocks of clips started while under ``--seconds`` (``pairs_per_s``). With
``--trace 1`` the run traces the blocks started in its first 5 s and
reports the per-layer metrics instead. Either way the clips' outputs are
then compared with the plain
reference (``perfbench/reference``), and the last line of standard output
is the result as one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error.

Exits non-zero with no result when CUDA is not available, when the
program (``funscript_flow_tpu_torch``) is not beside this folder, or when
a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def power_limit() -> str | None:
    """The card's name and power limit from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def main(argv=None) -> int:
    t_start = time.perf_counter() - _process_age()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import funscript_flow_tpu_torch.runner  # noqa: F401  (the program)
    from perfbench.bench import cell as cellmod, guard, manifest

    guard.check("at start-up")
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = cellmod.run(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=t_start)
    guard.check("before the result")
    card = power_limit()
    cellmod.say(f"card: {card}")
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["card"] = card
    # a clip that could not be compared reads inf, which JSON cannot hold
    line["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"])
                          else None, "limit": c["limit"]}
                      for k, c in res["checks"].items()}
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
