"""Shared fixtures of the benchmark's CPU tests: a cell of BENCHMARK.json
with its traffic cut to a few tiny clips, so that a whole run of the
harness fits a test on the CPU."""

from __future__ import annotations

import dataclasses
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 2**31 + 77  # wider than 32 signed bits, as benchmark seeds may be


def tiny_cell(name: str, frames: int = 30):
    """The cell ``name`` of BENCHMARK.json with its traffic cut to blocks
    of two clips of about ``frames`` frames."""
    from perfbench.bench import manifest

    cell = manifest.cell(name)
    tr = dict(cell.traffic, textures=2, scale_levels=32,
              clip_frames={"dist": "log_uniform", "min": frames,
                           "max": frames + 10, "strata": 2},
              warmup_frames=[frames])
    return dataclasses.replace(cell, traffic=tr)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    """Skips the test where this machine has no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card "
                    "(python3 -m pytest perfbench/tests -m cuda)")
    return torch.device("cuda")
