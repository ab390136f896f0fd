"""The int_rels cell's pieces on the CPU: the hashed split at the cell's own
size (harness/split_rels.py), the fold's bytes (harness/fold_roofline.py),
the three new readers on a canned trace, and a toy int_rels cell
(tests/toy_rels.py) run through the kind ``eval_rels_sweep``: correct
untraced and traced, incorrect with each fault of the fold
(harness/faults_rels.py) and of the eval sweep that applies planted, and
the control failing where the program passes. On a card (``cuda``), the
control and the faults at the cell's own size."""

import json
import os

import numpy as np
import pytest

import toy
import toy_rels
from harness import faults, faults_rels
from harness.fold_roofline import fold_need
from harness.split_rels import make_rels_split
from harness.trace import NothingToRead
from test_bench_control import SEEDS, _judge
from test_bench_readers import reader, view

CELL = "int_rels.eval-split"
FOLD = "scatter_small_kernel(float const*, float*, int, int, int const*, int)"


def _cell_split(seed):
    cfg = json.load(open(os.path.join(toy.BENCH, "configs",
                                      "int_rels.json")))
    mix = json.load(open(os.path.join(toy.BENCH, "traffic",
                                      "eval-split-rels.json")))
    return make_rels_split(seed, mix["samples"], cfg["n_clips"],
                           cfg["n_tracks"], cfg["n_classes"], cfg["n_rels"],
                           cfg["rels_n_clips"], **mix["hashes"],
                           **mix["locality"])


def test_the_cells_split_has_the_assumed_hash_structure():
    """2,304 hashes, each with a sample, about 4.4 labelled samples a hash,
    one sample in 16 'None' with hash -1; the samples of a hash share its
    label and its context; no context empty; pools past 18 clips take the
    loader's stride; every seed the same sizes."""
    data, H = _cell_split(2 ** 31 + 11)
    h, lab = data["hash_rel"], data["rels_label"]
    assert H == 2304 and len(h) == 10789
    assert np.array_equal(np.unique(h[h >= 0]), np.arange(H))
    assert (h < 0).sum() == 10789 // 16 == 674
    assert np.all((lab == 15) == (h < 0))
    assert (h >= 0).sum() / H == pytest.approx(4.39, abs=0.01)
    order = np.argsort(h, kind="stable")
    hs, first = np.unique(h[order], return_index=True)
    lead = order[first][hs >= 0]
    same = data["feat_idx"][order, 1:] == data["feat_idx"][
        lead[np.searchsorted(hs[hs >= 0], h[order])], 1:]
    assert same[h[order] >= 0].all()
    for k in range(0, H, 97):
        assert len(set(lab[h == k])) == 1
    ctx = data["rels_mask"].sum(axis=(1, 2))
    assert ctx.min() >= 4 and ctx.max() == 18 and (ctx == 18).mean() > 0.2
    other, H2 = _cell_split(7)
    assert H2 == H and {k: v.shape for k, v in other.items()} == \
        {k: v.shape for k, v in data.items()}


def test_fold_bytes_of_a_hand_worked_batch():
    # 4 samples of 3 hashes (two on hash 2), one 'None' to the dump row 5:
    # ids and update rows read, rows {0, 2, 5} read and written
    moved, ops = fold_need(np.array([2, 0, -1, 2]), np.array([1, 3, 4, 1]),
                           5, 4, 4)
    assert moved == 4 * 4 + 4 * 4 * 4 + 2 * 3 * 4 * 4
    assert ops == 4 * 4


def test_fold_readers(tmp_path):
    v = view(tmp_path, [(FOLD, 1010, 10), (FOLD, 1050, 30)],
             counts={"fold_bound_s": 10e-6, "batches": 2})
    assert reader("rels_fold_roofline.eval").read(v) == pytest.approx(25.0)
    assert reader("rels_fold_ms.eval").read(v) == pytest.approx(0.02)
    v = view(tmp_path, [(FOLD, 1010, 10)], kind="cpu",
             counts={"batches": 1})
    assert reader("rels_fold_roofline.eval").read(v) is None


@pytest.mark.parametrize("name", ["rels_fold_roofline.eval",
                                  "rels_fold_ms.eval"])
def test_no_fold_kernel_is_a_loud_failure_not_a_zero(tmp_path, name):
    v = view(tmp_path, [("fused_ctx_pool_kernel", 1010, 30)],
             counts={"fold_bound_s": 1e-6, "batches": 1})
    with pytest.raises(NothingToRead, match="kernel in the traced window"):
        reader(name).read(v)


def test_rels_finish_reads_the_idle_inside_its_span(tmp_path):
    from test_bench_program_spans import view as span_view

    v = span_view(tmp_path, [("lirec.eval.rels_finish", 1010, 20)],
                  [(1012, 5)], counts={"sweeps": 2})
    assert reader("rels_finish_ms.eval").read(v) == pytest.approx(
        1e3 * 15e-6 / 2)
    v = span_view(tmp_path, [("lirec.eval.finish", 1010, 20)], [(1012, 5)],
                  counts={"sweeps": 2})
    assert reader("rels_finish_ms.eval").read(v) is None


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return toy_rels.make(str(tmp_path_factory.mktemp("toyrels")))


def test_an_untraced_run_is_correct(checkout, capsys):
    rc, line = toy.run(checkout, toy_rels.CELL, seed=2 ** 31 + 7,
                       capsys=capsys)
    assert rc == 0 and line["correct"] is True, json.dumps(line["checks"])
    assert set(line["metrics"]) == {"setup_s", "eval_clips_per_s.no_ctx"}
    assert set(line["checks"]) == set(toy_rels.LIMITS)


def test_a_traced_run_reads_the_programs_spans(checkout, capsys):
    rc, line = toy.run(checkout, toy_rels.CELL, seed=13, trace=1,
                       capsys=capsys)
    assert rc == 0 and line["correct"] is True
    metrics = line["metrics"]
    assert metrics["device_idle.eval.no_ctx"]["value"] == pytest.approx(100.0)
    assert metrics["rels_finish_ms.eval"]["value"] > 0
    # no kernel on the CPU: the kernel readers say so and are left out
    for name in ("rels_fold_roofline.eval", "rels_fold_ms.eval",
                 "pool_roofline.eval.no_ctx", "mfu.eval.no_ctx"):
        assert name not in metrics


@pytest.mark.parametrize("fault", sorted(faults_rels.RELS))
def test_a_fold_fault_makes_the_run_incorrect(checkout, fault, capsys):
    with faults_rels.planted(fault):
        rc, line = toy.run(checkout, toy_rels.CELL, seed=2 ** 32 + 3,
                           capsys=capsys)
    assert rc == 0
    assert line["correct"] is False, json.dumps(line["checks"])
    assert line["checks"]["table_gap"]["value"] > \
        line["checks"]["table_gap"]["limit"]


@pytest.mark.parametrize("fault", ["half_batch", "altered_scores",
                                   "unchanged"])
def test_an_eval_fault_makes_the_run_incorrect(checkout, fault, capsys):
    try:
        with faults.planted("eval_sweep", fault):
            rc, line = toy.run(checkout, toy_rels.CELL, seed=2 ** 32 + 3,
                               capsys=capsys)
    except ZeroDivisionError:
        # the carry left at zero: the program's finish divides by its zero
        # count, and the run ends with no result, which is no pass
        assert fault == "unchanged"
        return
    assert rc == 0
    assert line["correct"] is False, json.dumps(line["checks"])


def test_the_control_fails_at_a_toy_size(checkout):
    _judge(checkout, toy_rels.CELL, "cpu", SEEDS[:2])


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _judge(toy.ROOT, CELL, "cuda", SEEDS)
