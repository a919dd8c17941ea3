"""One whole run of each cell on the card through the command, as the
benchmark's checks run it: a traced run, whose last line must carry the
cell's per-layer metrics, the device's busy and window seconds and a
breakdown. Run on a machine with a card:

    python -m pytest portbench/tests/test_portbench_card.py -q
"""

import json
import subprocess
import sys

import pytest

from portbench.spec import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_traced_run(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
         str(2 ** 32 + 3), "--seconds", "5", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    want = {m["name"] for m in BENCH["per_layer"]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    for m in res["metrics"].values():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 105
