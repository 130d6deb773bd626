"""On the card: the control at a cell's own size fails the check.  Run
with ``python -m pytest -m card benchmark/tests`` on a machine with a
card; skipped elsewhere."""

import pytest

from benchmark import control, workload


@pytest.mark.card
def test_control_fails_at_the_cells_size(card):
    cell = workload.load_cell(workload.load_benchmark(), "ecoli.short")
    out = control.control_numbers(cell, 2**31 + 606, card)
    assert out["correct"] is False, out
