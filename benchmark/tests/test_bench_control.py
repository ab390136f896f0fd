"""The control: the plain reference computed in float8 e4m3 (the
configuration computes in bfloat16) put in the program's place must come
out not correct, while the program, at the same seeds, comes out correct;
and so must every fault of harness/faults.py planted in the program, and
the faults read with the reference in the program's place. At a toy size
on the CPU, and (``cuda``) at each cell's own size on the card, on three
seeds."""

import json
import os

import pytest

import toy

SEEDS = (2 ** 31 + 101, 2 ** 32 + 7, 3 * 10 ** 9 + 19)
# readings that are not a fault's: the program's, and the tie window's
# probe (flips inside the window are the program's own rounding)
NOT_FAULTS = {"program", "tie_flip"}


def _limits(root, cell):
    path = os.path.join(root, "benchmark", "limits", cell + ".json")
    with open(path) as f:
        return json.load(f)["limits"]


def _judge(root, cell, device, seeds):
    import calibrate

    limits = _limits(root, cell)
    for row in calibrate.readings(cell, list(seeds), root, device,
                                  os.path.join(root, "benchmark")):
        fails = {who: [k for k, lim in limits.items() if not row[who][k]
                       <= lim] for who in row if isinstance(row[who], dict)
                 and set(limits) <= set(row[who])}
        assert fails["program"] == [], (row["seed"], row["program"])
        for who in set(fails) - NOT_FAULTS:
            assert fails[who], (row["seed"], who, row[who])


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return toy.make(str(tmp_path_factory.mktemp("control")))


@pytest.mark.parametrize("cell", ["toy.eval_sweep", "toy.train_epochs",
                                  "toych.eval_sweep", "toych.train_epochs"])
def test_the_control_fails_at_a_toy_size(checkout, cell):
    _judge(checkout, cell, "cpu", SEEDS[:2])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["int_rel_ch.eval-split",
                                  "int_rel_ch.train-b64", "int_ch.eval-split",
                                  "int_ch.train-b64"])
def test_the_control_fails_at_the_cells_size(card, cell):
    _judge(toy.ROOT, cell, card, SEEDS)
