"""The means by which the two-rank data-parallel check holds the ranks'
gradient to one process's (lirec_tpu_torch/tools/dist_check.py), on the
CPU at a small size: the decisions a forward records, the comparison of a
whole batch's decisions with its halves', and the rows' shares of the
gradient that the check takes out of both sides.
"""

import pytest
import torch

from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.data.pipeline import local_batch
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.parallel.dist import DataMesh
from lirec_tpu_torch.tools import dist_check
from lirec_tpu_torch.train.loop import _to_device, step_generators, train_loss
from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables

B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decide(x):
    return torch.relu(x).amax(dim=1), torch.argmax(x, dim=-1)


def _record(fn, *args):
    with dist_check.DecisionRecorder() as rec:
        fn(*args)
    return rec.calls


def test_recorder_keeps_each_decision_in_call_order():
    """relu, amax and argmax are recorded with their decisions: the relu's
    sign mask, the amax's argmax along its dim, the argmax's result."""
    x = torch.tensor([[1.0, -2.0, 3.0], [-1.0, 5.0, 0.5]])
    calls = _record(_decide, x)
    assert [c[0] for c in calls] == ["relu", "amax", "argmax"]
    assert torch.equal(calls[0][1], x > 0)
    assert calls[1][1].tolist() == [2, 1] and calls[1][3] == 1
    assert calls[2][1].tolist() == [2, 1] and calls[2][3] == -1


def test_tied_rows_names_the_row_whose_decisions_differ():
    """A forward over two blocks of rows in which one row's input differs
    in one element: that row is named, with every decision that differs,
    and the gaps are that element's distance from each tie."""
    x = torch.randn(B, 5, generator=torch.Generator().manual_seed(0))
    x[5] = torch.tensor([0.2, -0.5, 0.9, 0.1, 0.3])
    y = x.clone()
    y[5, 2] = -1e-3  # its relu flips, and its argmax and amax move
    whole = _record(_decide, x)
    blocks = [_record(_decide, y[:4]), _record(_decide, y[4:])]
    got = dist_check.tied_rows(whole, blocks, B)
    assert got["rows"] == [5] and got["shared"] == 0
    assert got["differing"] == 3
    kinds = [(kind, row) for kind, _, _, row, _ in got["ties"]]
    assert kinds == [("relu", 5), ("amax", 5), ("argmax", 5)]
    scale = float(x.abs().max())
    assert got["ties"][0][4] == pytest.approx(0.9 / scale)
    assert got["ties"][2][4] == pytest.approx((0.9 - 0.3) / scale)


def test_tied_rows_counts_a_batch_level_decision_as_shared():
    """A decision over a tensor that every forward computes whole (not
    per row) belongs to no row: it is counted as shared."""
    table = torch.tensor([[0.5, -1.0], [2.0, 0.25]])
    other = table.clone()
    other[0, 0] = -0.5
    whole = _record(torch.relu, table)
    blocks = [_record(torch.relu, other), _record(torch.relu, table)]
    got = dist_check.tied_rows(whole, blocks, B)
    assert got["rows"] == [] and got["shared"] == 1


def test_tied_rows_refuses_forwards_of_another_structure():
    x = torch.randn(B, 3)
    with pytest.raises(ValueError, match="decisions"):
        dist_check.tied_rows(_record(_decide, x),
                             [_record(torch.relu, x[:4]),
                              _record(_decide, x[4:])], B)


def _small():
    cfg = config_lib.preset("int_rel_ch").with_dims(
        text_dim=32, visual_dim=64, joint_dim=256).with_runtime(
        compute_dtype="float32")
    bundle = create_model(cfg, 9, n_rels=6, seed=0, device="cpu")
    tables = {k: torch.from_numpy(v)
              for k, v in make_tables(bundle.spec, 64, 96).items()}
    return bundle, tables, make_batch(bundle.spec, B, 64, 96, seed=3)


def test_row_gradients_add_up_to_the_batch_gradient():
    """The rows' shares of the gradient (each row's own loss in the whole
    batch's forward over the batch's rows) add up to the mean loss's
    gradient within rtol 1e-6 of each tensor's scale; a half's shares,
    divided by the global batch's rows, add up to half of that half's
    mean-loss gradient."""
    bundle, tables, host = _small()
    batch = _to_device(host, "cpu")
    gens = lambda: step_generators(0, 0, "cpu")  # noqa: E731
    bundle.model.zero_grad(set_to_none=True)
    train_loss(bundle, batch, tables, gens(), deterministic=True).backward()
    want = {n: p.grad.clone() for n, p in bundle.model.named_parameters()}
    total = {n: torch.zeros_like(g) for n, g in want.items()}
    for row in range(B):
        share = dist_check.row_gradient(bundle, batch, tables, gens(), row)
        for n in total:
            total[n] += share[n]
    for n, g in want.items():
        scale = float(g.abs().max()) or 1.0
        assert float((total[n] - g).abs().max()) <= 1e-6 * scale, n
    half = _to_device(local_batch(host, DataMesh(2, 1)), "cpu")
    bundle.model.zero_grad(set_to_none=True)
    train_loss(bundle, half, tables, gens(), deterministic=True).backward()
    want = {n: p.grad.clone() / 2 for n, p in bundle.model.named_parameters()}
    total = {n: torch.zeros_like(g) for n, g in want.items()}
    for row in range(B // 2):
        share = dist_check.row_gradient(bundle, half, tables, gens(), row,
                                        count=B)
        for n in total:
            total[n] += share[n]
    for n, g in want.items():
        scale = float(g.abs().max()) or 1.0
        assert float((total[n] - g).abs().max()) <= 1e-6 * scale, n


def test_whole_and_halves_forwards_make_comparable_decisions():
    """The training forward over a batch and over its two halves records
    the same sequence of decisions, each either per row or batch-level,
    so that tied_rows can compare them; on the CPU any that differ sit
    within 1e-5 of their tie."""
    bundle, tables, host = _small()
    gens = lambda: step_generators(0, 0, "cpu")  # noqa: E731
    with torch.no_grad():
        whole = _record(train_loss, bundle, _to_device(host, "cpu"), tables,
                        gens(), True, True)
        blocks = [_record(train_loss, bundle,
                          _to_device(local_batch(host, DataMesh(2, r)),
                                     "cpu"), tables, gens(), True, True)
                  for r in range(2)]
    kinds = {c[0] for c in whole}
    assert {"relu", "argmax"} <= kinds
    got = dist_check.tied_rows(whole, blocks, B)
    assert got["shared"] == 0
    assert got["worst_gap"] <= 1e-5
