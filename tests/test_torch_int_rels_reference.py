"""The port's int_rels eval sweep (evaluation/packed.evaluate_packed under
the ``int_rels`` preset: MidFusionMultiClip with the gate, the per-hash
score table of RelationshipsAcc) against the benchmark's plain reference
of the configuration (``benchmark/reference/int_rels.py``, loaded by path;
plain PyTorch, float32, TF32 off, no import of the port), on the CPU at a
small size: joint 32, 6 classes, 4 relationship heads, R = 4 context
clips, 40 (pair, relationship) hashes over 3 full batches of 16 and a
ragged tail of 7, made by the benchmark's split generator
(``benchmark/harness/split_rels.py``) and seeded random weights and
tables. Also the span ``lirec.eval.rels_finish`` under a profiler and the
fold's dispatch record.

Tolerances, as a share of each tensor's largest element: float32 compute
2e-6, the parity contract's (the same f32 products and sums in another
order); bfloat16 compute 4.1e-3, the contract's bf16 bound (every product
rounds its operands to bf16 on both sides, and the port stores the
embedded ctx tables in bf16, which the reference does not), against the
reference with its products' operands rounded to bf16.
"""

import importlib
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.evaluation import packed
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.ops import dispatch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
C, NR, R, B = 6, 4, 4, 16
N_CLIPS, N_TRACKS = 160, 320
DIMS = dict(text_dim=16, visual_dim=24, joint_dim=32, mid_m_ints=6)
SPLIT = dict(hashes_per_movie=8, none_every=16, clips_per_movie=32,
             neighborhood=16, pool_range=(2, 6))
TOLERANCE = {"float32": 2e-6, "bfloat16": 4.1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU tanh, first run across several threads, has returned
    values ~4e-5 off; one thread keeps the comparison deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench():
    """The benchmark's reference of int_rels and its split generator,
    loaded by path (the benchmark's directory on the import path only
    while they load)."""
    sys.path.insert(0, BENCH)
    try:
        ref = importlib.import_module("reference.int_rels")
        split = importlib.import_module("harness.split_rels")
    finally:
        sys.path.remove(BENCH)
    return types.SimpleNamespace(ref=ref, split=split)


def _config(compute):
    cfg = config_lib.preset("int_rels").with_dims(**DIMS).with_tasks(
        rels_n_clips=R).with_optim(batch_size=B)
    return cfg.with_runtime(compute_dtype=compute)


def _ref_cfg(cfg):
    """The reference's configuration dict for the port's config."""
    d, t, o = cfg.dims, cfg.tasks, cfg.optim
    return {"ctx": t.ctx, "gates": t.gates, "text_dim": d.text_dim,
            "visual_dim": d.visual_dim, "track_dim": d.track_dim,
            "joint_dim": d.joint_dim, "mid_m_ints": d.mid_m_ints,
            "n_classes": C, "n_rels": NR, "margin": o.margin,
            "lymbda": o.lymbda}


def _inputs(bench, seed=11):
    data, n_hashes = bench.split.make_rels_split(
        seed, 3 * B + 7, N_CLIPS, N_TRACKS, C, NR, R, **SPLIT)
    g = torch.Generator().manual_seed(seed)
    tables = {"text": torch.randn(N_CLIPS, DIMS["text_dim"], generator=g),
              "visual": torch.randn(N_CLIPS, DIMS["visual_dim"],
                                    generator=g),
              "track": torch.randn(N_TRACKS, DIMS["visual_dim"],
                                   generator=g)}
    return data, n_hashes, tables


def _port(compute, data, n_hashes, tables):
    """The port's sweep: its metrics, its carry, each sample's outputs in
    order, and the model's weights."""
    cfg = _config(compute)
    bundle = create_model(cfg, C, n_rels=NR, seed=3, device="cpu")
    outs = []

    def apply(model, batch, *args, **kw):
        out = bundle.apply(model, batch, *args, **kw)
        outs.append({k: out[k].detach().float() for k in ("inters", "rels")})
        return out

    got = {}
    finish = packed.finish_from_carry

    def recorded(carry, *args, **kw):
        got["carry"] = carry
        return finish(carry, *args, **kw)

    stand_in = types.SimpleNamespace(n_classes=C, n_rels=NR + 1,
                                     hashidx_rels=range(n_hashes))
    packed.finish_from_carry = recorded
    try:
        got["metrics"] = packed.evaluate_packed(
            stand_in, bundle._replace(apply=apply), bundle.model, cfg,
            mode="test", verbose=False, data=data, tables=tables)
    finally:
        packed.finish_from_carry = finish
    got["outputs"] = {k: torch.cat([o[k] for o in outs]) for k in
                      ("inters", "rels")}
    got["weights"] = {k: v.detach().clone()
                      for k, v in bundle.model.state_dict().items()}
    return cfg, got


def _reference(bench, cfg, weights, data, n_hashes, tables, quant=None):
    """The reference over the split, batched as the sweep batches it."""
    ref, rc = bench.ref, _ref_cfg(cfg)
    counts, losses, outs = {}, [], []
    with torch.no_grad(), ref.no_tf32():
        emb = ref.embed_tables(weights, rc, tables, quant)
        for i in range(0, len(data["labels"]), B):
            b = {k: torch.as_tensor(v[i:i + B]) for k, v in data.items()}
            out = ref.forward_eval(weights, rc, emb, b["feat_idx"],
                                   b["rels_mask"], quant)
            losses.append(float(ref.loss(out, b, rc)))
            for k, v in ref.counters(out, b, rc).items():
                counts[k] = counts.get(k, 0) + v
            outs.append(out)
        outputs = {k: torch.cat([o[k] for o in outs]) for k in
                   ("inters", "rels")}
        sums, label, seen = ref.hash_sums(
            torch.sigmoid(outputs["rels"]), torch.as_tensor(data["hash_rel"]),
            torch.as_tensor(data["rels_label"]), n_hashes, NR)
        counts.update(ref.rels_counts(sums, label, seen))
    return {"loss": sum(losses) / len(losses), "counts": counts,
            "outputs": outputs, "table": sums.numpy(), "seen": seen.numpy(),
            "label": label.numpy(), "labels": data["labels"][:, 0, 0]}


def _gap(got, want) -> float:
    """The widest element gap, over the reference's largest element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request, bench):
    compute = request.param
    data, n_hashes, tables = _inputs(bench)
    cfg, got = _port(compute, data, n_hashes, tables)
    quant = bench.ref.bf16_quant if compute == "bfloat16" else None
    want = _reference(bench, cfg, got["weights"], data, n_hashes, tables,
                      quant)
    return compute, n_hashes, got, want


def test_the_split_has_the_hash_structure(bench):
    """Every hash has a labelled sample; 'None' samples carry hash -1; the
    samples of one hash share their label and their context; no context
    is empty; pools past R take the loader's stride."""
    data, n_hashes, _ = _inputs(bench)
    h, lab = data["hash_rel"], data["rels_label"]
    assert n_hashes == 40 and sorted(set(h[h >= 0])) == list(range(40))
    assert np.all((lab == NR) == (h < 0)) and (h < 0).sum() == 55 // 16
    for k in range(n_hashes):
        rows = np.nonzero(h == k)[0]
        assert len(set(lab[rows])) == 1
        assert all((data["feat_idx"][r, 1:] == data["feat_idx"][rows[0], 1:])
                   .all() for r in rows)
    assert data["rels_mask"].sum(axis=(1, 2)).min() >= 2
    assert data["rels_mask"].sum(axis=(1, 2)).max() == R


def _near(scores, labels, k, tol) -> int:
    """How many rows could go either way at top-k within `tol` of the
    scores' largest magnitude: those whose label's score lies that close
    to the k-th largest of the other scores."""
    scores = torch.as_tensor(np.asarray(scores, np.float64))
    labels = torch.as_tensor(np.asarray(labels)).long()
    k = min(k, scores.shape[1] - 1)
    at = scores.gather(1, labels[:, None])[:, 0]
    others = scores.scatter(1, labels[:, None], float("-inf"))
    kth = others.topk(k, dim=1).values[:, -1]
    return int(((at - kth).abs() <= tol * scores.abs().max()).sum())


def _count_slack(pair, key):
    """The rows (samples, or hashes) of the reference whose hit at `key`
    lies within the tolerance: a count may differ by that many."""
    compute, n_hashes, _, want = pair
    tol = TOLERANCE[compute]
    if key.startswith("rels_"):
        return _near(want["table"][want["seen"]], want["label"][want["seen"]],
                     int(key[len("rels_top"):]), tol)
    return _near(want["outputs"]["inters"], want["labels"],
                 int(key[len("top"):]), tol)


def test_metrics_match_the_reference(pair):
    """The metric dict: the loss within the tolerance, the interaction and
    relationship top-1 shares the reference's, but for the samples or
    hashes whose label's score lies within the tolerance of the best
    other (none in float32 here)."""
    compute, n_hashes, got, want = pair
    m, c = got["metrics"], want["counts"]
    assert abs(m["loss"] - want["loss"]) <= TOLERANCE[compute] * abs(
        want["loss"])
    assert abs(round(m["ints"] * c["total"]) - c["top1"]) \
        <= _count_slack(pair, "top1")
    assert abs(round(m["rels"] * n_hashes) - c["rels_top1"]) \
        <= _count_slack(pair, "rels_top1")
    assert c["n_hashes"] == n_hashes
    if compute == "float32":
        assert m["ints"] == c["top1"] / c["total"]
        assert m["rels"] == c["rels_top1"] / c["n_hashes"]


def test_counters_match_the_reference(pair):
    """The carry's interaction top-1/3/5/10 counts are the reference's, but
    for the samples within the tolerance of the k-th best other class."""
    _, _, got, want = pair
    carry = got["carry"]
    assert int(carry["total"]) == want["counts"]["total"]
    for k in ("top1", "top3", "top5", "top10"):
        assert abs(int(carry[k]) - want["counts"][k]) \
            <= _count_slack(pair, k), k


def test_table_holds_the_in_order_sums(pair):
    """The score table's hash rows are the reference's per-hash sums of
    the sigmoid scores in sample order, its labels and seen hashes the
    reference's."""
    compute, n_hashes, got, want = pair
    carry = got["carry"]
    assert _gap(carry["rels_table"][:n_hashes], want["table"]) \
        <= TOLERANCE[compute]
    assert np.array_equal(carry["rels_seen"][:n_hashes] > 0, want["seen"])
    assert np.array_equal(carry["rels_gt"][:n_hashes], want["label"])


def test_each_samples_scores_match_the_reference(pair):
    compute, _, got, want = pair
    for k in ("inters", "rels"):
        assert _gap(got["outputs"][k], want["outputs"][k]) \
            <= TOLERANCE[compute], k


def test_a_bf16_rounded_table_fails_the_f32_tolerance(bench):
    """The f32 comparison is tight enough to tell: the port's f32 table
    rounded to bfloat16 lies outside 2e-6 of the reference's sums."""
    data, n_hashes, tables = _inputs(bench)
    cfg, got = _port("float32", data, n_hashes, tables)
    want = _reference(bench, cfg, got["weights"], data, n_hashes, tables)
    table = torch.as_tensor(got["carry"]["rels_table"][:n_hashes])
    assert _gap(table, want["table"]) <= TOLERANCE["float32"]
    rounded = table.to(torch.bfloat16).float()
    assert _gap(rounded, want["table"]) > TOLERANCE["float32"]


def test_rels_finish_opens_under_the_profiler(bench, tmp_path):
    """Under torch.profiler the finish's per-hash fill and argsort lie in
    one ``lirec.eval.rels_finish`` span, inside ``lirec.eval.finish``;
    the metrics are those without the profiler."""
    data, n_hashes, tables = _inputs(bench)
    _, plain = _port("float32", data, n_hashes, tables)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, traced = _port("float32", data, n_hashes, tables)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    import json

    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    spans = {}
    for e in events:
        spans.setdefault(e["name"], []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    (a, b), = spans["lirec.eval.rels_finish"]
    assert any(lo <= a and b <= hi for lo, hi in spans["lirec.eval.finish"])
    assert traced["metrics"] == plain["metrics"]


def test_the_fold_is_recorded_once_a_sweep(bench):
    """The fold's dispatch record: the table's rows (hashes and the dump
    row), the updates a full batch folds (the rows and the batch) and the
    path; CPU tensors take the plain version."""
    data, n_hashes, tables = _inputs(bench)
    before = dispatch.decisions("eval_rels_fold").get("reference", 0)
    _port("float32", data, n_hashes, tables)
    assert dispatch.decisions("eval_rels_fold")["reference"] == before + 1
    rec = dispatch.last_dispatch("eval_rels_fold")
    assert rec["path"] == "reference"
    assert rec["shapes"] == {"rows": n_hashes + 1,
                             "updates": n_hashes + 1 + B, "width": NR,
                             "scatter_path": "small"}


def test_the_finish_is_recorded_once_a_sweep(bench):
    """The finish's dispatch record: one ranking pass a sweep, over the
    hashes the sweep saw and the table's width."""
    data, n_hashes, tables = _inputs(bench)
    before = dispatch.decisions("eval_rels_finish").get("one_pass", 0)
    _, got = _port("float32", data, n_hashes, tables)
    assert dispatch.decisions("eval_rels_finish")["one_pass"] == before + 1
    rec = dispatch.last_dispatch("eval_rels_finish")
    seen = int((got["carry"]["rels_seen"][:n_hashes] > 0).sum())
    assert seen == n_hashes
    assert rec["reason"] == "host carry"
    assert rec["shapes"] == {"hashes": seen, "width": NR}


@pytest.mark.parametrize("hashes,path", [(2304, "small"), (4096, "sorted")])
def test_the_fold_record_names_the_cards_path(hashes, path):
    """On a card the record names the launch ``scatter_path`` picks: at the
    benchmark's 2,304 hashes and B = 64 (2,369 updates into 2,305 rows of
    15) the one-launch path, past its threshold the sort."""
    packed._record_rels_fold(hashes + 1, 64, 15, torch.device("cuda"))
    rec = dispatch.last_dispatch("eval_rels_fold")
    assert rec["path"] == path and rec["shapes"] == {
        "rows": hashes + 1, "updates": hashes + 65, "width": 15,
        "scatter_path": path}
