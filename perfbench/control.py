#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in bfloat16, the
precision below the configurations' float32, compared with the float32
reference exactly as a run compares the program. The benchmark's own
runs do not run it.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3

For each seed: the cell's frames made from the seed as a run makes them,
the clips a run would compare (the longest of the seed's first block and
one more drawn from the seed), then one JSON line per seed with the
numbers and the configuration's limits.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, device):
    """(numbers, limits) of the control on one seed."""
    import torch

    from perfbench.bench import correct, traffic as trafmod
    from perfbench.reference.clip import clip_actions, pair_signal

    params = cell.config["params"]
    tr = cell.traffic
    fps = float(tr["fps"])
    pool = trafmod.pool(tr, seed, device)
    block = list(itertools.islice(trafmod.plan(tr, seed),
                                  len(trafmod.block_lengths(tr))))
    rows = []
    for i in correct.sample(block, seed):
        frames = trafmod.clip_frames(pool, block[i], tr)
        dots, cuts = pair_signal(frames, params, device)
        ref = (dots, clip_actions(dots, cuts, params, fps, 1))
        cd, cc = pair_signal(frames, params, device, dtype=torch.bfloat16)
        rows.append(correct.compare(cd, clip_actions(cd, cc, params, fps, 1),
                                    ref))
    return correct.worst(rows), cell.config["correct_limits"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    from perfbench.bench import correct, manifest

    cell = manifest.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers, limits = readings(cell, seed, "cuda")
        fails = [k for k in correct.NUMBERS if not numbers[k] <= limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": "bf16", "numbers": numbers,
                          "limits": limits, "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
