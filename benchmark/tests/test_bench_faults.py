"""The comparison that decides ``correct``, with the timed path broken
underneath: a run of a toy cell on the CPU (the look for a card skipped)
with a fault planted in the program (harness/faults.py), once for each
fault the cell can have, must print ``correct`` false. One chip, so no
exchange between chips to leave out."""

import json

import pytest

import toy
from harness import faults


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return toy.make(str(tmp_path_factory.mktemp("faults")))


FAULTS = {"eval_sweep": sorted(faults.EVAL),
          "train_epochs": sorted(faults.TRAIN)}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in ("toy.eval_sweep", "toy.train_epochs",
                     "toych.eval_sweep", "toych.train_epochs")
    for f in FAULTS[c.split(".")[1]]])
def test_a_fault_makes_the_run_incorrect(checkout, cell, fault, capsys):
    kind = cell.split(".")[1]
    try:
        with faults.planted(kind, fault):
            rc, line = toy.run(checkout, cell, seed=2 ** 32 + 3,
                               capsys=capsys)
    except ZeroDivisionError:
        # the carry left at zero: the program's own finish divides by its
        # zero count, and the run ends with no result, which is no pass
        assert (kind, fault) == ("eval_sweep", "unchanged")
        return
    assert rc == 0
    assert line["correct"] is False, json.dumps(line["checks"])


@pytest.mark.parametrize("cell", ["toy.eval_sweep", "toy.train_epochs",
                                  "toych.eval_sweep", "toych.train_epochs"])
def test_the_same_run_without_a_fault_is_correct(checkout, cell, capsys):
    rc, line = toy.run(checkout, cell, seed=2 ** 32 + 3, capsys=capsys)
    assert rc == 0 and line["correct"] is True, json.dumps(line["checks"])
