"""The result line's shape, and the command's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.spec import ROOT
from portbench.tests import toy


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.toy_root(tmp_path_factory.mktemp("toy"))


def test_result_keys_and_checks_last(root):
    res = harness.execute("toy-yi.decode", 987654321012, 0.3, False,
                          torch.device("cpu"), 0.0, root)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert res["checks"]["gap"]["limit"] == 1e-3
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    json.loads(json.dumps(res))  # one JSON object
    assert res["attempted"] > 0 and res["failed"] == 0


def test_a_limit_below_the_reading_makes_the_run_incorrect(tmp_path):
    r = toy.toy_root(tmp_path, limit=-1.0)
    res = harness.execute("toy-glm.decode", 5, 0.3, False,
                          torch.device("cpu"), 0.0, r)
    assert res["correct"] is False


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "glm4-9b.decode-32k-b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _command(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder (no
    port) exits non-zero with no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _command(tmp_path, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
