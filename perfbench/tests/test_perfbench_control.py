"""The control of the comparison (``perfbench/control.py``): the reference
in the program's place, in bfloat16, must fail the configuration's
limits. Here on a tiny cell on the CPU; with the ``cuda`` marker at the
cell's own size on the card, on three seeds:

    python3 -m pytest perfbench/tests -m cuda
"""

from __future__ import annotations

import pytest

from conftest import SEED, tiny_cell

from perfbench import control
from perfbench.bench import manifest

CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails_on_a_tiny_cell(name):
    numbers, limits = control.readings(tiny_cell(name, frames=16), SEED, "cpu")
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails_at_the_cells_size(name, cuda):
    cell = manifest.cell(name)
    for seed in (SEED, SEED + 1, SEED + 2):
        numbers, limits = control.readings(cell, seed, cuda)
        assert any(numbers[k] > limits[k] for k in limits), (seed, numbers)
