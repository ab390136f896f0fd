"""The int_rels sweep's host finish (evaluation/packed.finish_from_carry on
a carry with the per-hash score table) against the finish as a per-hash
loop over RelationshipsAcc: each seen hash's row and label into its dicts,
then ``_compute``'s argsort of each row on its own. On the CPU, on host
carries made here: the accumulator's counts and confusion matrix, the
metric dict and the printed lines must be equal, and where no hash is
seen both must raise the same exception before a line prints. One case
runs the finish under the benchmark's ``recording_finish`` (loaded by
path), which reads the accumulator the finish filled."""

import importlib
import os
import sys

import numpy as np
import pytest

from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.evaluation import packed
from lirec_tpu_torch.evaluation.metrics import (
    MetricAccumulator, RelationshipsAcc,
)
from lirec_tpu_torch.evaluation.runner import summarize_metrics

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
T = config_lib.preset("int_rels").tasks


def _per_hash_finish(carry, t, n_rels, n_hashes, mode, verbose):
    """The finish with RelationshipsAcc filled one hash at a time and
    ranked by its own ``top1()``; returns the metric dict and the
    accumulator."""
    carry = {k: np.asarray(v) for k, v in carry.items()}
    prec = MetricAccumulator(n_rels=n_rels)
    prec.total = int(carry.get("total", 0))
    for host_attr, key in (("_top1", "top1"), ("_top3", "top3"),
                           ("_top5", "top5"), ("_top10", "top10")):
        setattr(prec, host_attr, int(carry[key]))
    prec_rels = RelationshipsAcc(n_rels=n_rels)
    for h in np.nonzero(carry["rels_seen"][:n_hashes])[0]:
        prec_rels._pr_probs[int(h)] = carry["rels_table"][h]
        prec_rels._gt[int(h)] = int(carry["rels_gt"][h])
    prec_rels.top1()
    avg_loss = float(carry["loss_sum"]) / int(carry["n_batches"])
    return summarize_metrics(t, prec, prec_rels, avg_loss, mode,
                             verbose), prec_rels


def _carry(table, gt, seen):
    """A host carry of the int_rels sweep over ``len(table) - 1`` hashes
    (the last row is the dump row), with interaction counters."""
    return {"loss_sum": np.float32(3.25), "n_batches": np.int64(13),
            "total": np.int64(800), "top1": np.int64(211),
            "top3": np.int64(402), "top5": np.int64(530),
            "top10": np.int64(701),
            "rels_table": np.asarray(table, np.float32),
            "rels_gt": np.asarray(gt, np.int64),
            "rels_seen": np.asarray(seen, np.int64)}


def _random(rng, n_hashes=2304, width=15):
    """Sums of sigmoid scores over 1-8 samples a hash, every hash seen."""
    seen = rng.integers(1, 9, n_hashes + 1)
    table = rng.random((n_hashes + 1, width)) * seen[:, None]
    return table, rng.integers(0, width, n_hashes + 1), seen


def _ranked(rng, ranks, width=15):
    """One row a rank in `ranks`: distinct scores, the label at that rank
    (0 = the highest)."""
    table = np.stack([rng.permutation(width) for _ in ranks]) * 0.5 + 1.0
    gt = [int(np.argsort(-row, kind="stable")[r]) for row, r in
          zip(table, ranks)]
    return table, gt


def _case(name):
    rng = np.random.default_rng(list(CASES).index(name) + 2600)
    if name in ("random", "recording"):
        return _random(rng), 2304
    if name == "narrow":  # fewer columns than the top-3
        return _random(rng, 300, 2), 300
    if name == "ties":
        # scores drawn from {0, 1, 2}: ties at every rank, and rows with
        # ranks 1-2 or 3-4 tied, the label on either of the pair
        table = rng.integers(0, 3, (600, 15)).astype(np.float32)
        gt = list(rng.integers(0, 15, 600))
        for lo, label in ((0, 0), (0, 1), (2, 0), (2, 1)):
            row = np.arange(15, 0, -1, dtype=np.float32)
            row[lo + 1] = row[lo]
            table = np.vstack([table, row[None]])
            gt.append(lo + label)
        table = np.vstack([table, np.zeros((1, 15), np.float32)])
        gt.append(0)
        return (table, gt, np.ones(len(table), np.int64)), len(table) - 1
    if name == "equal_rows":  # whole rows equal, every label
        table = np.full((31, 15), 0.5)
        table[15:30] = 0.0
        gt = list(range(15)) * 2 + [0]
        return (table, gt, np.ones(31, np.int64)), 30
    if name == "gt_rank":  # the label at rank 1, 2-3 and past 3
        ranks = [0, 1, 2, 3, 7, 14] * 20
        table, gt = _ranked(rng, ranks)
        table = np.vstack([table, np.zeros((1, 15))])
        return (table, gt + [0], np.ones(len(table), np.int64)), len(ranks)
    if name == "unseen":  # hashes without a sample score high and count not
        table, gt, seen = _random(rng, 500)
        seen[rng.random(501) < 0.4] = 0
        table[seen == 0] = 50.0
        return (table, gt, seen), 500
    if name == "dump_row":  # the filtered samples' row is never a hash
        table, gt, seen = _random(rng, 200)
        table[200], gt[200], seen[200] = 99.0, 3, 41
        return (table, gt, seen), 200
    if name == "none_seen":
        table, gt, seen = _random(rng, 100)
        seen[:100] = 0
        return (table, gt, seen), 100
    raise KeyError(name)


CASES = ("random", "narrow", "ties", "equal_rows", "gt_rank", "unseen",
         "dump_row", "none_seen", "recording")


def _run(finish, carry, n_rels, n_hashes, capsys):
    """(result or exception type, printed lines)."""
    try:
        out = finish(carry, T, n_rels, n_hashes, "test", True)
    except ZeroDivisionError as exc:
        out = type(exc)
    return out, capsys.readouterr().out


def _program_rels():
    """The benchmark's ``harness/program_rels``, loaded by path."""
    sys.path.insert(0, BENCH)
    try:
        return importlib.import_module("harness.program_rels")
    finally:
        sys.path.remove(BENCH)


@pytest.mark.parametrize("name", CASES)
def test_one_pass_finish_matches_the_per_hash_loop(name, capsys):
    """The finish's RelationshipsAcc holds the loop's ``total``, ``_top1``,
    ``_top3`` and ``conf_mat``; the metric dict and the printed lines are
    the loop's; with no hash seen both raise before a line prints. Under
    ``recording_finish`` the accumulator it records is the one filled."""
    (table, gt, seen), n_hashes = _case(name)
    carry = _carry(table, gt, seen)
    n_rels = carry["rels_table"].shape[1] + 1  # 'None' counted
    want, want_out = _run(_per_hash_finish, carry, n_rels, n_hashes, capsys)
    store = {}
    if name == "recording":
        with _program_rels().recording_finish(store):
            got, got_out = _run(packed.finish_from_carry, carry, n_rels,
                                n_hashes, capsys)
        assert store["carry"] is carry
    else:
        inner = packed.RelationshipsAcc

        class Recorded(inner):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                store["rels_acc"] = self

        packed.RelationshipsAcc = Recorded
        try:
            got, got_out = _run(packed.finish_from_carry, carry, n_rels,
                                n_hashes, capsys)
        finally:
            packed.RelationshipsAcc = inner
    assert packed.RelationshipsAcc is RelationshipsAcc
    assert got_out == want_out
    if name == "none_seen":
        assert want is got is ZeroDivisionError and got_out == ""
        return
    (want, want_acc), acc = want, store["rels_acc"]
    assert got == want and want_out.count("\n") == 6
    assert acc.total == want_acc.total == int((seen[:n_hashes] > 0).sum())
    assert (acc._top1, acc._top3) == (want_acc._top1, want_acc._top3)
    assert type(acc._top1) is int and type(acc._top3) is int
    np.testing.assert_array_equal(acc.conf_mat, want_acc.conf_mat)
    assert acc.conf_mat.dtype == want_acc.conf_mat.dtype
    assert (acc.top1(), acc.top3(), acc.total) == (
        want_acc.top1(), want_acc.top3(), want_acc.total)
