"""The port's host spans (utils/profiling.span): nothing recorded and one
shared no-op while no profiler runs; under ``torch.profiler`` a
``user_annotation`` of the span's name in the Chrome trace, which is what
the benchmark's per-layer readers take them from. The eval sweep, the
epoch sweep, the index check and the Localizer emit their ``lirec.*``
spans, each phase inside the caller's span around the sweep, one after
another; the results under the profiler are those without it. On a card,
the CUDA graph's capture (the ``cuda`` marker)."""

import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.data.localize import Localizer
from lirec_tpu_torch.evaluation import packed
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.train.loop import check_batch
from lirec_tpu_torch.train.optim import make_optimizer
from lirec_tpu_torch.train.sweep import EpochSweep
from lirec_tpu_torch.utils import profiling
from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables
from lirec_tpu_torch.utils.profiling import span

EVAL_PHASES = ("tables", "embed", "localize", "stage", "zero", "replays",
               "tail", "fetch")
TRAIN_PHASES = ("check", "stack", "pin", "h2d", "replays", "fetch")
STAND_IN = types.SimpleNamespace(n_classes=9, n_rels=7, hashidx_rels=None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(device="cpu"):
    cfg = config_lib.preset("int_rel_ch").with_dims(
        text_dim=16, visual_dim=32, joint_dim=16).with_runtime(
        compute_dtype="float32")
    return cfg, create_model(cfg, 9, n_rels=6, seed=0, device=device)


def _split(spec, full=3, tail=3, B=4):
    parts = [make_batch(spec, B, 64, 96, seed=s) for s in range(full)]
    parts.append(make_batch(spec, tail, 64, 96, seed=full))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _traced(tmp_path, fn, card=False):
    """fn()'s result under torch.profiler, and the trace's host spans
    (user_annotation events) as [(name, start us, end us)]."""
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if card else [])
    with profile(activities=activities) as prof:
        out = fn()
        if card:
            torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return out, spans


def _named(spans, name):
    return [(a, b) for n, a, b in spans if n == name]


def _inside(spans, parent, names):
    """Every span of `names` is present and lies inside a span `parent`."""
    outer = _named(spans, parent)
    assert outer, parent
    for name in names:
        got = _named(spans, name)
        assert got, name
        for a, b in got:
            assert any(lo <= a and b <= hi for lo, hi in outer), name


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    """No profiler: every span is the same no-op object, and no
    record_function is made (entering and leaving it records nothing)."""
    assert not torch.autograd._profiler_enabled()

    def refuse(name):
        raise AssertionError("record_function(%r) made" % name)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = span("lirec.a"), span("lirec.b")
    assert a is b is profiling._OFF
    with a:
        with b:
            pass


def test_span_under_the_profiler_is_a_user_annotation(tmp_path):
    def work():
        with span("lirec.test.outer"):
            with span("lirec.test.inner"):
                return torch.ones(4).sum()

    out, spans = _traced(tmp_path, work)
    assert float(out) == 4.0
    assert len(_named(spans, "lirec.test.outer")) == 1
    _inside(spans, "lirec.test.outer", ["lirec.test.inner"])
    assert span("lirec.after") is profiling._OFF  # the profiler has stopped


def _eager_sweep(cfg, pb, data, tables):
    return packed.sweep_carry(STAND_IN, pb, pb.model, cfg, mode="test",
                              data=data, tables=tables, batch_size=4,
                              graph=False)


def _disjoint(spans, names):
    """The spans of `names` follow one another: none starts before the
    one before it (by start) has ended."""
    got = sorted((a, b) for n, a, b in spans if n in names)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(got, got[1:]))


def test_eager_eval_sweep_emits_every_phase_inside_its_span(tmp_path):
    """sweep_carry (eager, 3 full batches of 4 and a tail of 3), inside a
    span of the caller's: tables, embed, localize, stage, zero, replays,
    tail and fetch inside it by time, one after another and in that order
    of first start; fetch once (the host read and, over a mesh, the
    combination of the carries)."""
    cfg, pb = _model()
    data, tables = _split(pb.spec), make_tables(pb.spec, 64, 96)

    def call():
        with span("lirec.test.sweep"):
            return _eager_sweep(cfg, pb, data, tables)

    _, spans = _traced(tmp_path, call)
    names = ["lirec.eval." + p for p in EVAL_PHASES]
    _inside(spans, "lirec.test.sweep", names)
    _disjoint(spans, names)
    starts = [min(a for a, _ in _named(spans, n)) for n in names]
    assert starts == sorted(starts)
    assert len(_named(spans, "lirec.eval.fetch")) == 1
    assert not [n for n, _, _ in spans if n == "lirec.eval.sweep"]


def test_eval_sweep_under_the_profiler_gives_the_same_carry(tmp_path):
    cfg, pb = _model()
    data, tables = _split(pb.spec), make_tables(pb.spec, 64, 96)
    want = _eager_sweep(cfg, pb, data, tables)
    got, _ = _traced(tmp_path, lambda: _eager_sweep(cfg, pb, data, tables))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k


def test_evaluate_packed_emits_finish_after_the_sweep(tmp_path):
    cfg, pb = _model()
    data, tables = _split(pb.spec), make_tables(pb.spec, 64, 96)
    metrics, spans = _traced(tmp_path, lambda: packed.evaluate_packed(
        STAND_IN, pb, pb.model, cfg, mode="test", verbose=False, data=data,
        tables=tables, batch_size=4, graph=False))
    assert metrics
    (_, fetched), = _named(spans, "lirec.eval.fetch")
    (lo, hi), = _named(spans, "lirec.eval.finish")
    assert lo >= fetched


def test_epoch_sweep_emits_every_phase(tmp_path):
    """check_batch over an epoch's batches, then EpochSweep.run (eager on
    the CPU: ``pin`` covers ``_host`` without pinning) and fetch: check
    once a batch, and stack, pin, h2d, replays and fetch once a chunk,
    in the epoch's order."""
    cfg, pb = _model()
    batches = [make_batch(pb.spec, 4, 64, 96, seed=s) for s in range(3)]
    tables = {k: torch.from_numpy(v)
              for k, v in make_tables(pb.spec, 64, 96).items()}
    sweep = EpochSweep(pb, make_optimizer(pb.model.parameters(), 1e-3),
                       tables, 0, 4, sweep_max_steps=2)

    def epoch():
        for b in batches:
            check_batch(b, tables)
        return sweep.fetch(sweep.run(batches, 0))

    losses, spans = _traced(tmp_path, epoch)
    assert len(losses) == 3 and np.isfinite(losses).all()
    counts = {p: len(_named(spans, "lirec.train." + p))
              for p in TRAIN_PHASES}
    assert counts == {"check": 3, "stack": 2, "pin": 2, "h2d": 2,
                      "replays": 2, "fetch": 1}
    order = [min(a for a, _ in _named(spans, "lirec.train." + p))
             for p in TRAIN_PHASES]
    assert order == sorted(order)


def test_localizer_emits_its_span(tmp_path):
    _, pb = _model()
    batches = [make_batch(pb.spec, 4, 64, 96, seed=s) for s in range(2)]
    localizer = Localizer(pb.spec, 64, 96, force=True)
    out, spans = _traced(tmp_path, lambda: localizer.maybe_localize(batches))
    assert localizer.applied and "uniq_clip" in out[0]
    assert len(_named(spans, "lirec.localize")) == 1


@pytest.mark.cuda
def test_graph_spans_of_capture_and_replays(tmp_path):
    """On a card, StepGraph's capture is one lirec.graph.capture and a
    replay opens no span; the eval sweep's graph path puts the capture
    inside lirec.eval.replays (the first sweep captures, the second
    replays all 3 full batches), and no span is opened inside a capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lirec_tpu_torch.utils.graphs import StepGraph

    x = torch.zeros(4, device="cuda")

    def graph():
        g = StepGraph(lambda: x.add_(1), "cuda")
        for _ in range(2):
            g.replay()

    _, spans = _traced(tmp_path, graph, card=True)
    assert [n for n, _, _ in spans if n.startswith("lirec.")] == [
        "lirec.graph.capture"]
    assert float(x[0]) == 3.0  # warm-up, capture (no run), two replays

    cfg, pb = _model("cuda")
    data, tables = _split(pb.spec), make_tables(pb.spec, 64, 96)

    def sweeps():
        for _ in range(2):
            packed.sweep_carry(STAND_IN, pb, pb.model, cfg, mode="test",
                               data=data, tables=tables, batch_size=4,
                               graph=True)

    _, spans = _traced(tmp_path, sweeps, card=True)
    for p in EVAL_PHASES:
        assert _named(spans, "lirec.eval." + p), p
    assert len(_named(spans, "lirec.eval.replays")) == 2
    _inside(spans, "lirec.eval.replays", ["lirec.graph.capture"])
    assert len(_named(spans, "lirec.graph.capture")) == 1
    (lo, hi), = _named(spans, "lirec.graph.capture")
    assert not [n for n, a, b in spans
                if n.startswith("lirec.") and lo < a and b < hi]
