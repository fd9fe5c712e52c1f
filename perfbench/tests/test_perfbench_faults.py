"""Whole runs of the harness on the CPU, past its look for a chip, with the
timed path broken underneath: each fault must read ``correct`` false, and
the unbroken program true.

The faults a cell can have: the flow returns its state unchanged (no
motion: zero flow), half of each window's pairs left out (their scalars
zeroed), one pair's signal altered where the flow program produces it,
and one action of the funscript altered where the runner writes it. A
cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import pytest
import torch

from conftest import SEED, tiny_cell

from perfbench.bench import cell as cellmod, manifest

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


def zero_flow(monkeypatch):
    from funscript_flow_tpu_torch.models import pipeline

    def still(f0, f1, cfg=None):
        z = torch.zeros(f0.shape, dtype=torch.float32, device=f0.device)
        return z, z.clone()

    monkeypatch.setattr(pipeline, "farneback_flow_planes", still)
    monkeypatch.setattr(pipeline, "dis_flow_planes", still)


def _wrap_program(monkeypatch, change):
    from funscript_flow_tpu_torch.models import pipeline

    orig = pipeline.flow_chunk_program

    def program(frames, n_pairs, cfg):
        res = orig(frames, n_pairs, cfg)
        with torch.inference_mode():  # the program's outputs are inference tensors
            change(res, n_pairs)
        return res

    monkeypatch.setattr(pipeline, "flow_chunk_program", program)


def half_batch(monkeypatch):
    def drop(res, n_pairs):
        half = n_pairs // 2
        res["dots"][half:] = 0.0
        res["cuts"][half:] = False
    _wrap_program(monkeypatch, drop)


def one_dot(monkeypatch):
    def alter(res, n_pairs):
        i = int(torch.argmax(res["dots"][:n_pairs].abs()))
        res["dots"][i] *= 1.5
    _wrap_program(monkeypatch, alter)


def one_action(monkeypatch):
    from funscript_flow_tpu_torch import runner

    orig = runner.write_funscript

    def write(path, actions):
        k = len(actions) // 2
        a = dict(actions[k], pos=(actions[k]["pos"] + 50) % 101)
        orig(path, actions[:k] + [a] + actions[k + 1:])

    monkeypatch.setattr(runner, "write_funscript", write)


FAULTS = {"zero_flow": zero_flow, "half_batch": half_batch,
          "one_dot": one_dot, "one_action": one_action}


def run_tiny(name):
    return cellmod.run(tiny_cell(name), SEED, 0.01, False, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_the_program_reads_correct(name):
    res = run_tiny(name)
    assert res["correct"], res["checks"]
    # the window is whole blocks (two clips each in the tiny cell)
    assert res["attempted"] == 2 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in
                                   manifest.cell(name).end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_reads_not_correct(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = run_tiny(name)
    assert not res["correct"], res["checks"]
