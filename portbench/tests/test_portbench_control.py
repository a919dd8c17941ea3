"""The fp8 control on the card at each cell's own size: the reference,
computed with every matmul's operands in float8 e4m3, takes the program's
place, and must fail one of the cell's limits while the program passes
them all. Run on a machine with a card:

    python -m pytest portbench/tests/test_portbench_control.py -q

(several minutes a cell: set-up, a short window, the reference and the
control)."""

import json
import time

import pytest

from portbench import harness
from portbench.spec import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(card, cell):
    res = harness.execute(cell, 2 ** 31 + 11, 5.0, False, card,
                          time.perf_counter(), ROOT, control=True)
    assert res["correct"], res["checks"]
    assert res["notes"]["control_correct"] is False, res["notes"]["control"]
