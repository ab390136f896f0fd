"""The readers of the program's own host spans (harness/spans.py and the
``*_idle_ms.*`` metrics) on canned profiler traces written here: the idle
seconds inside named spans, with device spans partly covering them;
nested and overlapping spans counted once; the window's clipping; the
division by the window's sweeps or epochs; the bubbles between the
operations of one CUDA graph replay left out, a replay found by its
operations' names where the host's launches put the first one; nothing
read where the window holds no such span; each metric module against its
entry."""

import json
import os

import pytest

from harness.cells import Spec, load_module
from harness.spans import NoSpans, gaps_between_launches, idle_in_spans_s
from harness.trace import NothingToRead, TraceView, load_events

from toy import BENCH, ROOT

EVAL = ("restart_idle_ms.eval", "replay_idle_ms.eval", "tail_idle_ms.eval")
TRAIN = ("staging_idle_ms.train", "replay_idle_ms.train")
NEW = EVAL + TRAIN + tuple(n + ".no_ctx" for n in EVAL + TRAIN)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0}


def view(tmp_path, host, kernels, counts=None, calls=()):
    """A window of 100 us (ts 1000-1100) inside a benchmark span, with the
    given program spans [(name, ts, dur)], kernels [(ts, dur)] or [(name,
    ts, dur)] and CUDA runtime calls [(name, ts, dur)]."""
    ev = [_x("bench.window", "user_annotation", 1000, 100),
          _x("bench.sweep", "user_annotation", 1000, 100)]
    ev += [_x(n, "user_annotation", ts, d) for n, ts, d in host]
    ev += [_x(*k[:1], "kernel", *k[1:]) if len(k) == 3
           else _x("k", "kernel", *k) for k in kernels]
    ev += [_x(n, "cuda_runtime", ts, d) for n, ts, d in calls]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return TraceView(load_events(str(path)), counts or {},
                     "NVIDIA H100 80GB HBM3", 0.0)


def reader(name):
    return load_module(os.path.join(BENCH, "metrics", name + ".py"),
                       "bench_metric_" + name)


def test_idle_inside_spans_less_the_device_spans(tmp_path):
    # stage 1010-1050; the card busy 1020-1030 and 1045-1060 (past the
    # span's end); a kernel outside every span does not count
    v = view(tmp_path, [("lirec.eval.stage", 1010, 40)],
             [(1020, 10), (1045, 15), (1070, 20)])
    assert idle_in_spans_s(v, ["lirec.eval.stage"]) == pytest.approx(25e-6)
    # two device spans on one stretch (overlapping kernels) count once
    v = view(tmp_path, [("lirec.eval.stage", 1010, 40)],
             [(1020, 10), (1025, 10)])
    assert idle_in_spans_s(v, ["lirec.eval.stage"]) == pytest.approx(25e-6)


def test_nested_and_overlapping_spans_count_once(tmp_path):
    host = [("lirec.eval.stage", 1010, 30), ("lirec.eval.zero", 1030, 20),
            ("lirec.eval.tables", 1015, 5), ("lirec.eval.stage", 1012, 10),
            ("lirec.eval.replays", 1060, 10)]
    v = view(tmp_path, host, [(1045, 30)])
    names = ["lirec.eval.stage", "lirec.eval.zero", "lirec.eval.tables"]
    # the union 1010-1050, less 1045-1050 on the card
    assert idle_in_spans_s(v, names) == pytest.approx(35e-6)
    # a name not asked for is not read, though inside the window
    assert idle_in_spans_s(v, ["lirec.eval.replays"]) == 0.0


def test_spans_clipped_to_the_window(tmp_path):
    host = [("lirec.train.pin", 950, 70), ("lirec.train.h2d", 1090, 60)]
    v = view(tmp_path, host, [(940, 100)])  # busy 1000-1040
    names = ["lirec.train.pin", "lirec.train.h2d"]
    assert idle_in_spans_s(v, names) == pytest.approx(10e-6)  # 1090-1100


def test_device_annotations_are_not_host_spans(tmp_path):
    """The profiler's copy of a span on the card's timeline
    (gpu_user_annotation) is not the host's span."""
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        _x("bench.window", "user_annotation", 1000, 100),
        _x("lirec.eval.stage", "user_annotation", 1010, 10),
        _x("lirec.eval.stage", "gpu_user_annotation", 1030, 40),
        _x("lirec.eval.zero", "gpu_user_annotation", 1030, 40)]}))
    v = TraceView(load_events(str(path)), {}, "NVIDIA H100 80GB HBM3", 0.0)
    assert idle_in_spans_s(v, ["lirec.eval.stage"]) == pytest.approx(10e-6)
    with pytest.raises(NothingToRead):
        idle_in_spans_s(v, ["lirec.eval.zero"])


# two replays of a graph of three operations (the second's middle one on a
# branch of its own, beside its first), a kernel of the host's between them
# and a set-up kernel before: the card idle 1000-1002, 1004-1005 (between
# launches), 1010-1012 (inside a replay), 1020-1030, 1035-1045, 1050-1051
# (inside) and 1060-1100
REPLAYS = [("lirec.train.replays", 1000, 100)]
KERNELS = [("fill", 1002, 2), ("gather", 1005, 5), ("gemm", 1012, 4),
           ("add", 1016, 4), ("seed", 1030, 5), ("gather", 1045, 5),
           ("gemm", 1046, 3), ("add", 1051, 9)]
CALLS = [("cudaLaunchKernel", 1000, 1), ("cudaStreamIsCapturing", 1001, 1),
         ("cudaGraphLaunch", 1003, 30), ("cudaLaunchKernel", 1029, 1),
         ("cudaGraphLaunch", 1040, 2), ("cudaEventRecord", 1050, 1)]


def test_bubbles_inside_a_replay_are_left_out(tmp_path):
    v = view(tmp_path, REPLAYS, KERNELS, calls=CALLS)
    assert gaps_between_launches(v) == [(1000, 1002), (1004, 1005),
                                        (1020, 1030), (1035, 1045),
                                        (1060, 1100)]
    assert idle_in_spans_s(v, ["lirec.train.replays"]) == pytest.approx(
        (2 + 1 + 10 + 10 + 40) * 1e-6)
    # without a graph launch, every stretch is the host's
    v = view(tmp_path, REPLAYS, KERNELS, calls=CALLS[:2])
    assert idle_in_spans_s(v, ["lirec.train.replays"]) == pytest.approx(
        (2 + 1 + 2 + 10 + 10 + 1 + 40) * 1e-6)


def test_a_replay_the_trace_lost_an_operation_of_counts_whole(tmp_path):
    """The second replay's branch operation missing from the trace: that
    replay is not found whole, and its bubble counts; the first's does
    not (a copy's memory kinds, which may read "Unknown" in one replay,
    do not tell replays apart)."""
    kernels = [k for k in KERNELS if k != ("gemm", 1046, 3)]
    v = view(tmp_path, REPLAYS, kernels, calls=CALLS)
    assert idle_in_spans_s(v, ["lirec.train.replays"]) == pytest.approx(
        (2 + 1 + 10 + 10 + 1 + 40) * 1e-6)
    kernels = [("Memset (Unknown)" if n == "gemm" and ts < 1040 else
                "Memset (Device)" if n == "gemm" else n, ts, d)
               for n, ts, d in KERNELS]
    v = view(tmp_path, REPLAYS, kernels, calls=CALLS)
    assert idle_in_spans_s(v, ["lirec.train.replays"]) == pytest.approx(
        (2 + 1 + 10 + 10 + 40) * 1e-6)


def test_replays_not_found_read_nothing(tmp_path):
    """Two of three replays differ from the first and the last: fewer than
    half are found whole, and a reader says so (NothingToRead, not a
    program without spans)."""
    kernels = [("g", 1005, 5), ("h", 1012, 4), ("g", 1035, 5),
               ("x", 1042, 4), ("g", 1065, 5), ("y", 1072, 4)]
    calls = [("cudaGraphLaunch", t, 1) for t in (1001, 1030, 1060)]
    v = view(tmp_path, REPLAYS, kernels, counts={"epochs": 1}, calls=calls)
    with pytest.raises(NothingToRead) as e:
        idle_in_spans_s(v, ["lirec.train.replays"])
    assert not isinstance(e.value, NoSpans)
    with pytest.raises(NothingToRead):
        reader("replay_idle_ms.train").read(v)


def test_launches_outside_the_window_are_not_matched(tmp_path):
    calls = CALLS + [("cudaLaunchKernel", 900, 1),
                     ("cudaGraphLaunch", 1100, 5)]
    v = view(tmp_path, REPLAYS, KERNELS, counts={"epochs": 1}, calls=calls)
    assert reader("replay_idle_ms.train").read(v) == pytest.approx(63e-3)


@pytest.mark.parametrize("name", EVAL + TRAIN)
def test_readers_divide_by_the_windows_units(tmp_path, name):
    """The eval readers per sweep, the train readers per epoch; each
    .no_ctx reader reads as its base."""
    spans = reader(name).SPANS
    host = [(n, 1010 + 10 * i, 5) for i, n in enumerate(spans)]
    v = view(tmp_path, host, [(1012, 1)], counts={"sweeps": 3, "epochs": 2})
    per = 3 if name in EVAL else 2
    want = 1e3 * (5 * len(spans) - 1) * 1e-6 / per
    assert reader(name).read(v) == pytest.approx(want)
    assert reader(name + ".no_ctx").read(v) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_nothing_read_without_the_programs_spans(tmp_path, name):
    """A program that opens none of the spans inside the window (one
    before it, others of other names) reads nothing: None, no raise."""
    v = view(tmp_path, [("lirec.other", 1010, 20),
                        ("lirec.eval.stage", 800, 50),
                        ("lirec.train.h2d", 800, 50)],
             [(1010, 5)], counts={"sweeps": 3, "epochs": 1})
    assert reader(name).read(v) is None
    with pytest.raises(NothingToRead):
        idle_in_spans_s(v, reader(name).SPANS)


@pytest.mark.parametrize("name", NEW)
def test_each_metric_module_matches_its_entry(name):
    spec = Spec(ROOT, BENCH)
    entry, = [m for m in spec.doc["per_layer"] if m["name"] == name]
    mod = spec.metric_module(entry)
    assert entry["source"] == "program_span" and entry["better"] == "lower"
    assert len(entry["workloads"]) == 1
    cell = entry["workloads"][0]
    assert cell.startswith("int_ch." if name.endswith(".no_ctx")
                           else "int_rel_ch.")
    assert cell.endswith(".eval-split" if ".eval" in name else ".train-b64")
    assert all(s.startswith("lirec.") for s in mod.SPANS)
