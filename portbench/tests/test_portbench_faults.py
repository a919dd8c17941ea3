"""Whole runs with the timed path broken underneath (the card's look
skipped, a toy cell on the CPU): each fault a cell can have
(``portbench/faults.py``) must make ``correct`` come out false. The cells
run on one card, so no exchange between chips exists to leave out. The
same faults read on the card at the cells' own sizes and limits through
``python3 -m portbench.calibrate``."""

import pytest
import torch

from portbench import faults, harness
from portbench.tests import toy

SEED = 3 * 2 ** 31 + 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    # limits well above the sound runs' readings (0 at float32)
    return toy.toy_root(tmp_path_factory.mktemp("toy"), limit=1e-3)


def run(root, cell, seed=SEED):
    return harness.execute(cell, seed, 0.3, False, torch.device("cpu"), 0.0,
                           root)


@pytest.mark.parametrize("cell", ["toy-glm.decode", "toy-yi.decode"])
def test_sound_run_is_correct(root, cell):
    assert run(root, cell)["correct"]


@pytest.mark.parametrize("cell", ["toy-glm.decode", "toy-yi.decode"])
@pytest.mark.parametrize("fault", faults.DECODE)
def test_decode_fault_is_caught(root, cell, fault):
    with faults.planted(fault):
        for seed in (SEED, SEED + 1, SEED + 2):
            assert run(root, cell, seed)["correct"] is False, seed


@pytest.mark.parametrize("fault", faults.PREFILL)
def test_prefill_fault_is_caught(root, fault):
    with faults.planted(fault):
        assert run(root, "toy-glm.prefill")["correct"] is False
