"""The per-layer metrics' readers on a canned profiler trace written here,
and the run's guard against JAX modules."""

import json
import os

import pytest

from harness.cells import Spec, load_module
from harness.runner import FORBIDDEN, forbidden_modules
from harness.trace import NothingToRead, TraceView, load_events, union_s

from toy import BENCH, ROOT

GEMM = ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_"
        "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas")
POOL = ("void (anonymous namespace)::fused_ctx_pool_kernel<__nv_bfloat16, "
        "false>(__nv_bfloat16 const*)")
SCATTER = ("void (anonymous namespace)::scatter_hot_kernel<__nv_bfloat16, "
           "3>((anonymous namespace)::Tables, long const*)")
SORT = "sort_count_kernel"


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0}


def canned(kernels):
    """A window of 100 us (ts 1000-1100) with a benchmark span inside,
    a program operation, and the given kernels [(name, ts, dur)]; a
    kernel before the window and an instant event are not read."""
    ev = [_x("bench.window", "user_annotation", 1000, 100),
          _x("bench.sweep", "user_annotation", 1002, 95),
          _x("cudaGraphLaunch", "cuda_runtime", 1060, 10),
          _x("early", "kernel", 900, 50),
          {"ph": "i", "name": "mark", "ts": 1001}]
    ev += [_x(n, "kernel", ts, d) for n, ts, d in kernels]
    return ev


def view(tmp_path, kernels, counts=None, kind="NVIDIA H100 80GB HBM3",
         capture_s=0.0):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": canned(kernels)}))
    return TraceView(load_events(str(path)), counts or {}, kind, capture_s)


def reader(name):
    return load_module(os.path.join(BENCH, "metrics", name + ".py"),
                       "bench_metric_" + name)


def test_union_of_spans():
    assert union_s([(0, 10), (5, 20), (30, 40)], 0, 100) == 30
    assert union_s([(0, 10), (5, 20), (30, 40)], 8, 35) == 17
    assert union_s([], 0, 10) == 0
    assert union_s([(3, 3), (4, 2)], 0, 10) == 0


def test_idle_share_from_the_union_inside_the_window(tmp_path):
    v = view(tmp_path, [("k1", 1010, 20), ("k2", 1020, 20), ("k3", 1090, 30)])
    assert v.window_s == pytest.approx(100e-6)
    assert v.busy_s == pytest.approx(40e-6)  # 1010-1040 and 1090-1100
    for name in ("device_idle.eval", "device_idle.train"):
        assert reader(name).read(v) == pytest.approx(60.0)
    # the gaps 1040-1090 and 1000-1010, named at their middles
    assert v.idle_gaps() == [
        ["bench.sweep > cudaGraphLaunch", pytest.approx(50e-6)],
        ["bench.sweep", pytest.approx(10e-6)]]
    assert v.top_ops()[0] == ["k1", pytest.approx(20e-6)]


def test_gemm_kernels_by_name(tmp_path):
    v = view(tmp_path, [(GEMM, 1010, 30), ("gemv2N_kernel<int>", 1050, 10),
                        ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64>",
                         1070, 5), ("elementwise_kernel", 1080, 10)],
             counts={"batches": 2, "steps": 5})
    assert reader("gemm_ms.eval").read(v) == pytest.approx(45e-3 / 2)
    assert reader("gemm_ms.train").read(v) == pytest.approx(45e-3 / 5)


def test_pool_roofline_reading(tmp_path):
    v = view(tmp_path, [(POOL, 1010, 40), (POOL, 1060, 40)],
             counts={"pool_bound_s": 20e-6})
    assert reader("pool_roofline.eval").read(v) == pytest.approx(25.0)


def test_scatter_roofline_reading(tmp_path):
    v = view(tmp_path, [(SORT, 1010, 10), (SCATTER, 1020, 30),
                        ("at::native::index_add", 1060, 30)],
             counts={"scatter_bound_s": 10e-6})
    assert reader("scatter_roofline.train").read(v) == pytest.approx(25.0)


@pytest.mark.parametrize("name", ["pool_roofline.eval",
                                  "scatter_roofline.train"])
def test_no_kernel_is_a_loud_failure_not_a_zero(tmp_path, name):
    v = view(tmp_path, [(GEMM, 1010, 30)],
             counts={"pool_bound_s": 1e-6, "scatter_bound_s": 1e-6})
    with pytest.raises(NothingToRead, match="kernel in the traced window"):
        reader(name).read(v)


def test_mfu_against_the_cards_peak(tmp_path):
    v = view(tmp_path, [(GEMM, 1010, 30)], counts={"flops": 989e12 * 1e-6})
    assert reader("mfu.eval").read(v) == pytest.approx(1.0)
    assert reader("mfu.train").read(
        view(tmp_path, [], counts={"flops": 1.0}, kind="cpu")) is None


def test_graph_capture_ms(tmp_path):
    assert reader("graph_capture_ms").read(
        view(tmp_path, [], capture_s=0.25)) == pytest.approx(250.0)
    assert reader("graph_capture_ms").read(view(tmp_path, [])) is None


def test_every_metric_module_matches_its_entry():
    spec = Spec(ROOT, BENCH)
    for m in spec.doc["per_layer"]:
        mod = spec.metric_module(m)
        assert callable(mod.read)


def test_the_guard_compares_whole_top_level_names():
    assert forbidden_modules(["lirec_tpu_torch", "lirec_tpu_torch.ops",
                              "numpy", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["jax.numpy", "lirec_tpu.config", "os"]) == [
        "jax", "lirec_tpu"]
    assert set(FORBIDDEN) >= {"jax", "jaxlib", "flax", "lirec_tpu"}
