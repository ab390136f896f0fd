"""The port's eval sweep (evaluation/packed.py), its triple-tier pool and
masked gather-sum (ops/gather_pool.py) and the eval CLI against the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go to both sides; weights cross
over with checkpoint.params_from_jax. The JAX Pallas kernels run in
interpret mode, as tests/test_ops.py runs them. Each side reads the
synthetic fixture with its own host tier. The CUDA kernels themselves are
held against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import os

import jax
import numpy as np
import pytest
import torch

from lirec_tpu import config as config_lib
from lirec_tpu.data import synthetic
from lirec_tpu.data.dataset import InteractionDataset
from lirec_tpu.evaluation import packed as jax_packed
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu.ops import gather_pool as jax_gp
from lirec_tpu_torch import config as port_config
from lirec_tpu_torch.checkpoint import params_from_jax
from lirec_tpu_torch.data import synthetic as port_synthetic
from lirec_tpu_torch.data.dataset import InteractionDataset as PortDataset
from lirec_tpu_torch.data.localize import localize_eval_ctx_triples
from lirec_tpu_torch.evaluation import packed as port_packed
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.models.tabular import EmbeddedTables, embed_all
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.ops.gather_pool import (
    KERNEL_NAMES,
    fused_ctx_pool_reference,
    fused_ctx_pool_triple,
    fused_ctx_pool_triple_reference,
    gather_masked_sum,
)

DIM_ARGS = ["--text-dim", "16", "--visual-dim", "32", "--text-layers", "4",
            "--joint-dim", "16", "--compute-dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU tanh, run for the first time across several threads, has
    been seen to return values ~4e-5 off; one thread keeps the plain
    versions deterministic at these tolerances."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the pools


def _triple_inputs(M=16, R=6, U=40, width=384, seed=0):
    rng = np.random.default_rng(seed)
    fused = rng.standard_normal((U, width)).astype(np.float32)
    tidx = rng.integers(0, U, (M, R)).astype(np.int32)
    mask = (rng.random((M, R)) < 0.5).astype(np.float32)
    mask[:, 1] = 1.0
    mask[0] = 0.0  # a row without context: the zero-divider guard
    return fused, tidx, mask


@pytest.mark.parametrize("guard", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_triple_pool_matches_jax_interpret(dtype, guard):
    """Segments 128 | 128 | 128 (the interpret kernel's 128-lane rule).
    bf16: the port pools the bf16-rounded table, JAX its f32 path on the
    same rounded values. rtol 2e-6: f32 sums in another order."""
    fused, tidx, mask = _triple_inputs()
    table = torch.from_numpy(fused).to(dtype)
    got = fused_ctx_pool_triple(table, torch.from_numpy(tidx),
                                torch.from_numpy(mask), guard).numpy()
    want = np.asarray(jax_gp.fused_ctx_pool_triple(
        table.float().numpy(), tidx, mask, 128, 128,
        guard_zero_divide=guard, force="interpret"))
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    assert np.isnan(got[0]).all() != guard
    rec = dispatch.last_dispatch(
        KERNEL_NAMES[("fused_ctx_pool_triple", dtype)])
    assert rec["path"] == "reference"


def test_triple_pool_is_the_three_table_pool_on_the_same_rows():
    """The fused rows of each entry's index triple, pooled by the triple
    plain version, against the 3-table plain version: within 1 ulp."""
    rng = np.random.default_rng(1)
    emb = EmbeddedTables(*(torch.from_numpy(
        rng.standard_normal((n, d)).astype(np.float32))
        for n, d in ((30, 64), (50, 32), (50, 32))))
    M, R = 12, 7
    idx = torch.from_numpy(np.stack(
        [rng.integers(0, n, (M, R)) for n in (30, 50, 50)], axis=-1
    ).astype(np.int32))
    mask = torch.from_numpy((rng.random((M, R)) < 0.6).astype(np.float32))
    mask[:, 0] = 1.0
    tri = idx.reshape(-1, 3).long()
    fused = torch.cat([emb.clip[tri[:, 0]], emb.tr1[tri[:, 1]],
                       emb.tr2[tri[:, 2]]], dim=-1)
    tidx = torch.arange(M * R, dtype=torch.int32).reshape(M, R)
    for guard in (True, False):
        got = fused_ctx_pool_triple_reference(fused, tidx, mask, guard)
        want = fused_ctx_pool_reference(emb, idx, mask, guard)
        np.testing.assert_array_max_ulp(got.numpy(), want.numpy(), maxulp=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_masked_sum_matches_jax_interpret(dtype):
    """Kernel 5's plain version against JAX's interpret kernel (f32 sums;
    bf16 tables go to JAX as their f32 values, and the port rounds its f32
    sum to bf16: within half a bf16 ulp of the sum)."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(
        rng.standard_normal((24, 256)).astype(np.float32)).to(dtype)
    idx = rng.integers(0, 24, (16, 5)).astype(np.int32)
    mask = (rng.random((16, 5)) < 0.5).astype(np.float32)
    got = gather_masked_sum(table, torch.from_numpy(idx),
                            torch.from_numpy(mask))
    assert got.dtype == dtype
    want = np.asarray(jax_gp.gather_masked_sum(
        table.float().numpy(), idx, mask, force="interpret"))
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                                   atol=1e-6)


# ------------------------------------------------------------ the sweep


def _cfg(lib, syn, root, preset, batch_size, compute="float32"):
    base = syn.make_config(root)
    cfg = lib.preset(preset, data_root=root)
    cfg = cfg.replace(dims=base.dims, paths=base.paths).with_runtime(
        compute_dtype=compute)
    return cfg.with_optim(batch_size=batch_size)


def _pair(root, preset, mode, batch_size, compute="float32"):
    """(JAX cfg, dataset, bundle), (port cfg, dataset, bundle) with the
    same weights."""
    sides = []
    for lib, syn, dataset in ((config_lib, synthetic, InteractionDataset),
                              (port_config, port_synthetic, PortDataset)):
        cfg = _cfg(lib, syn, root, preset, batch_size, compute)
        ds = dataset(cfg, mode=mode)
        ds.cache()
        if cfg.tasks.rels or cfg.tasks.rels_multitask:
            ds.init_relships()
        sides.append((cfg, ds))
    (jc, jd), (pc, pd) = sides
    n_rels = max(len(jd.rels_list) - 1, 0)
    jb = jax_create_model(jc, jd.n_classes, n_rels=n_rels)
    pb = create_model(pc, pd.n_classes, n_rels=n_rels, device="cpu")
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                          jb.params)))
    return (jc, jd, jb), (pc, pd, pb)


def _capture(monkeypatch, module, store, key):
    orig = module.finish_from_carry

    def wrapped(carry, *args, **kw):
        store[key] = {k: np.asarray(v) for k, v in carry.items()}
        return orig(carry, *args, **kw)

    monkeypatch.setattr(module, "finish_from_carry", wrapped)


@pytest.mark.parametrize("preset,mode,batch_size", [
    ("int_rel_ch", "test", 8),
    ("int_rel_ch", "test", 16),  # the ragged tail and the size-1 skip
    ("int_ch", "test", 8),
    ("int_rels", "val", 5),
    ("modalities", "val", 8),  # the plain branch with soft_gt, no ctx
])
def test_evaluate_packed_matches_jax(synth_root, monkeypatch, preset, mode,
                                     batch_size):
    """Each localisation tier on both sides: every integer counter of the
    carry equal, float metrics and sums at rtol 2e-6, atol 1e-7 (the JAX
    suite's tolerance across tiers, tests/test_packed_eval.py). The port's
    tiers give bitwise one carry; the dispatch record says which ran."""
    (jc, jd, jb), (pc, pd, pb) = _pair(synth_root, preset, mode, batch_size)
    carries = {}
    _capture(monkeypatch, jax_packed, carries, "jax")
    _capture(monkeypatch, port_packed, carries, "port")
    port_carries = []
    for tier in (False, "tables", "triple"):
        want = jax_packed.evaluate_packed(jd, jb, jb.params, jc, mode=mode,
                                          verbose=False, localize_ctx=tier)
        got = port_packed.evaluate_packed(pd, pb, pb.model, pc, mode=mode,
                                          verbose=False, localize_ctx=tier)
        if pc.tasks.ctx:
            rec = dispatch.last_dispatch("eval_ctx_localize")
            assert rec["path"] == ("on" if tier else "off")
            assert rec["reason"] == "forced"
            if tier:
                assert rec["shapes"]["tier"] == tier
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=2e-6,
                                       atol=1e-7, err_msg=key)
        j, p = carries["jax"], carries["port"]
        assert set(j) == set(p)
        for key, jv in j.items():
            pv = p[key]
            if key == "rels_seen":  # JAX: a flag; the port: a count
                np.testing.assert_array_equal(pv > 0, jv)
            elif key == "rels_gt":  # the label of every seen hash
                np.testing.assert_array_equal(pv[j["rels_seen"]],
                                              jv[j["rels_seen"]])
            elif jv.dtype.kind == "f":
                np.testing.assert_allclose(pv, jv, rtol=2e-6, atol=1e-7,
                                           err_msg=key)
            else:
                np.testing.assert_array_equal(pv, jv, err_msg=key)
        port_carries.append(p)
    for p in port_carries[1:]:
        for key, v in p.items():
            np.testing.assert_array_equal(v, port_carries[0][key], key)


def _capture_accumulators(monkeypatch, module, store, key):
    """Record the integer counters of the accumulators each side hands
    to summarize_metrics (read after it has summed them)."""
    orig = module.summarize_metrics

    def counters(acc):
        if acc is None:
            return None
        out = {k: v for k, v in vars(acc).items()
               if isinstance(v, (int, np.integer)) and k != "n_rels"}
        if hasattr(acc, "_gt"):  # RelationshipsAcc: labels per hash
            out["gt"] = dict(acc._gt)
            out["pr_probs"] = {h: p.copy() for h, p in acc._pr_probs.items()}
        return out

    def wrapped(t, prec, prec_rels, *args, **kw):
        res = orig(t, prec, prec_rels, *args, **kw)
        store[key] = (counters(prec), counters(prec_rels))
        return res

    monkeypatch.setattr(module, "summarize_metrics", wrapped)


@pytest.mark.parametrize("preset,mode,batch_size", [
    ("int_rel_ch", "test", 8),
    ("int_ch", "test", 8),
    ("int_rels", "val", 5),
    ("modalities", "val", 8),
])
def test_host_evaluate_matches_jax(synth_root, monkeypatch, preset, mode,
                                   batch_size):
    """The per-batch host loop (--host-eval) on both sides: every integer
    counter of the accumulators equal, the relationship scores and the
    metric dict within rtol 2e-6; and the port's host loop gives the port's
    packed sweep's metric dict."""
    from lirec_tpu.evaluation import runner as jax_runner
    from lirec_tpu_torch.evaluation import runner as port_runner

    (jc, jd, jb), (pc, pd, pb) = _pair(synth_root, preset, mode, batch_size)
    acc = {}
    _capture_accumulators(monkeypatch, jax_runner, acc, "jax")
    _capture_accumulators(monkeypatch, port_runner, acc, "port")
    want = jax_runner.evaluate(jd, jb, jb.params, jc, mode=mode,
                               verbose=False)
    got = port_runner.evaluate(pd, pb, pb.model, pc, mode=mode,
                               verbose=False)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=2e-6, atol=1e-7,
                                   err_msg=key)
    for j, p in zip(acc["jax"], acc["port"]):
        assert (j is None) == (p is None)
        if j is None:
            continue
        scores_j, scores_p = j.pop("pr_probs", {}), p.pop("pr_probs", {})
        assert p == j
        assert set(scores_p) == set(scores_j)
        for h in scores_j:
            np.testing.assert_allclose(scores_p[h], scores_j[h], rtol=2e-6,
                                       atol=1e-7)
    assert sum(acc["port"][0].values()) > 0  # the samples were counted
    packed = port_packed.evaluate_packed(pd, pb, pb.model, pc, mode=mode,
                                         verbose=False)
    assert set(packed) == set(got)
    for key in got:
        np.testing.assert_allclose(got[key], packed[key], rtol=2e-6,
                                   atol=1e-7, err_msg=key)


def test_eval_localize_auto_keeps_the_full_tables(synth_root):
    """localize_ctx=None on the port keeps the full tables, recorded as
    auto (the triple tier measured slower on the card); the plain pools
    (use_kernel=False) keep them too, recorded as forced; a forced tier's
    analysis is cached on the dataset; the same metrics throughout."""
    _, (pc, pd, pb) = _pair(synth_root, "int_rel_ch", "test", 8)

    def run(**kw):
        return port_packed.evaluate_packed(pd, pb, pb.model, pc, mode="test",
                                           verbose=False, **kw)

    auto = run()
    rec = dispatch.last_dispatch("eval_ctx_localize")
    assert rec["path"] == "off" and rec["reason"].startswith("auto")
    assert getattr(pd, "_eval_ctx_loc_cache", None) is None
    plain = run(use_kernel=False, localize_ctx="triple")
    rec = dispatch.last_dispatch("eval_ctx_localize")
    assert rec["path"] == "off" and rec["reason"] == "forced"
    triple = run(localize_ctx="triple")
    cached = pd._eval_ctx_loc_cache
    again = run(localize_ctx="triple")
    assert pd._eval_ctx_loc_cache is cached
    assert auto == plain == triple == again


def test_bf16_triple_forward_matches_jax(synth_root):
    """int_rel_ch in bf16 compute, one full batch of the split through the
    triple tier (bf16 fused table) against the JAX forward: logits within
    4.1e-3 (the port's bf16 ctx tables against JAX's f32 ones on the
    CPU)."""
    (jc, jd, jb), (pc, pd, pb) = _pair(synth_root, "int_rel_ch", "test", 8,
                                       compute="bfloat16")
    data = pd.materialize()
    B = 8
    tidx, triples = localize_eval_ctx_triples(data["feat_idx"], B, 1,
                                              pd.tables.track.shape[0])
    batch = {"feat_idx": data["feat_idx"][:B],
             "rels_mask": data["rels_mask"][:B]}
    tables = {k: torch.from_numpy(v) for k, v in pd.tables.as_dict().items()}
    with torch.inference_mode():
        embedded = embed_all(pb.model, pb.spec, tables)
        assert embedded["ctx"].clip.dtype == torch.bfloat16
        got = pb.apply(pb.model, dict(batch, ctx_tidx=tidx[:B],
                                      ctx_triples=triples[0]),
                       embedded=embedded)
    want = jb.apply(jb.params, batch, tables=jd.tables.as_dict())
    for key in ("inters", "rels"):
        err = np.abs(got[key].float().numpy() - np.asarray(want[key])).max()
        assert err <= 4.1e-3, (key, err)


# -------------------------------------------------------------- the CLI


def test_int_rel_ch_cli_on_the_cpu(synth_root, tmp_path):
    """The eval CLI with --device cpu on a reference-format checkpoint of
    seeded weights: finite metric dicts for both splits, the same with
    --host-eval; --mesh with --host-eval and --num-processes without
    --coordinator refuse with the JAX package's messages (--mesh 2x1 runs:
    tests/test_torch_dist_cli.py); --assembly-workers, which only the
    training batches use, and --ingest-cache (written, then loaded) leave
    the metrics as they are; --checkpoint-backend orbax and an Orbax
    checkpoint directory refuse to run."""
    from lirec_tpu_torch.cli import common, int_rel_ch

    ckpt = tmp_path / "weights.pth.tar"
    args = ["--data-root", synth_root, "--store-root", str(tmp_path / "st"),
            "--resume-path", str(ckpt), "--batch-size", "8", "--device",
            "cpu", "--quiet", "--sanity-check"] + DIM_ARGS
    cfg = common.config_from_args(
        "int_rel_ch", common.build_parser("int_rel_ch").parse_args(args))
    train_ds, _, _ = common.build_datasets(cfg, "int_rel_ch")
    model = create_model(cfg, train_ds.n_classes,
                         n_rels=max(len(train_ds.rels_list) - 1, 0),
                         seed=3, device="cpu").model
    torch.save({"state_dict": model.state_dict(), "epoch": 0}, ckpt)
    out = int_rel_ch.main(args)
    for split in ("val", "test"):
        assert set(out[split]) == {"total", "ints", "loss", "rels",
                                   "tracks", "joint"}
        assert all(np.isfinite(v) for v in out[split].values())
    host = int_rel_ch.main(args + ["--host-eval"])
    for split in ("val", "test"):
        assert set(host[split]) == set(out[split])
        for key, v in out[split].items():
            np.testing.assert_allclose(host[split][key], v, rtol=2e-6,
                                       atol=1e-7, err_msg=key)
    for extra, match in ((["--mesh", "2x1", "--host-eval"],
                          "drop --host-eval"),
                         (["--num-processes", "2"], "needs --coordinator"),
                         (["--checkpoint-backend", "orbax"], "orbax")):
        with pytest.raises(SystemExit, match=match):
            int_rel_ch.main(args + extra)
    assert int_rel_ch.main(args + ["--assembly-workers", "2"]) == out
    # an ingest artifact, written by the first run and loaded by the second
    art = str(tmp_path / "ingest.npz")
    for _ in range(2):
        assert int_rel_ch.main(args + ["--ingest-cache", art]) == out
    assert os.path.exists(art)
    bad = list(args)
    orbax = tmp_path / "2.ckpt"
    orbax.mkdir()  # the JAX package's Orbax checkpoints are directories
    bad[bad.index(str(ckpt))] = str(orbax)
    with pytest.raises(SystemExit, match="Orbax"):
        int_rel_ch.main(bad)


# ------------------------------------------- rels-only eval and details


def _rels_only_pair(root, compute="float32"):
    """int_rels on the val split with the first label choice, as the JAX
    package's tests/test_graph_api.py builds it, on both sides, with the
    same weights."""
    from lirec_tpu.data.dataset import first_choice
    from lirec_tpu_torch.data.dataset import first_choice as port_first

    sides = []
    for lib, syn, dataset, chooser in (
            (config_lib, synthetic, InteractionDataset, first_choice),
            (port_config, port_synthetic, PortDataset, port_first)):
        cfg = _cfg(lib, syn, root, "int_rels", 8, compute)
        ds = dataset(cfg, mode="val", label_chooser=chooser)
        ds.cache()
        ds.init_relships()
        sides.append((cfg, ds))
    (jc, jd), (pc, pd) = sides
    jb = jax_create_model(jc, jd.n_classes, n_rels=jd.n_rels - 1)
    pb = create_model(pc, pd.n_classes, n_rels=pd.n_rels - 1, device="cpu")
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                          jb.params)))
    return (jc, jd, jb), (pc, pd, pb)


def _capture_rels_updates(monkeypatch, module, store, key):
    """Record each RelationshipsAcc.update call: (logits, labels,
    hashes), one per flushed bucket."""
    orig = module.RelationshipsAcc.update
    calls = store.setdefault(key, [])

    def wrapped(self, pr_probs, gt, hashes):
        calls.append((np.array(pr_probs, np.float32), np.asarray(gt).copy(),
                      np.asarray(hashes).copy()))
        return orig(self, pr_probs, gt, hashes)

    monkeypatch.setattr(module.RelationshipsAcc, "update", wrapped)


@pytest.mark.parametrize("batch_size", [64, 3])
def test_rels_only_eval_matches_jax(synth_root, monkeypatch, batch_size):
    """evaluate_rels_only on both sides: rels_top1 / rels_top3 exactly
    equal, each flushed bucket's rels logits at f32 rtol 2e-6 with the
    same labels and hashes in the same order (B = 3: flushes at n = B and
    a last flush with n < B per bucket), the plain pool equal to the pool
    wrapper's path, and test_rels_multi_clip restored on both sides."""
    from lirec_tpu.evaluation import metrics as jax_metrics
    from lirec_tpu.evaluation import runner as jax_runner
    from lirec_tpu_torch.evaluation import metrics as port_metrics
    from lirec_tpu_torch.evaluation import runner as port_runner

    (jc, jd, jb), (pc, pd, pb) = _rels_only_pair(synth_root)
    calls = {}
    _capture_rels_updates(monkeypatch, jax_metrics, calls, "jax")
    _capture_rels_updates(monkeypatch, port_metrics, calls, "port")
    want = jax_runner.evaluate_rels_only(jd, jb, jb.params, jc,
                                         verbose=False,
                                         batch_size=batch_size)
    got = port_runner.evaluate_rels_only(pd, pb, pb.model, pc,
                                         verbose=False,
                                         batch_size=batch_size)
    assert got == want
    assert 0 < got["rels_top3"] and got["rels_top1"] <= got["rels_top3"]
    assert jd.test_rels_multi_clip is False
    assert pd.test_rels_multi_clip is False
    assert len(calls["port"]) == len(calls["jax"]) > 1
    for (pl, pg, ph), (jl, jg, jh) in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(pg, jg)
        np.testing.assert_array_equal(ph, jh)
        np.testing.assert_allclose(pl, jl, rtol=2e-6, atol=1e-7)
    if batch_size == 3:
        sizes = {len(g) for _, g, _ in calls["port"]}
        assert 3 in sizes and min(sizes) < 3
    plain = port_runner.evaluate_rels_only(pd, pb, pb.model, pc,
                                           verbose=False,
                                           batch_size=batch_size,
                                           use_kernel=False)
    assert plain == got


def test_rels_only_buckets_are_powers_of_two(synth_root, monkeypatch):
    """Each flushed bucket is [B, padded + 1, 3] / [B, padded, 1] with
    padded the next power of two >= the items' clip counts (at least 2),
    every pad row and clip has weight 0, and the buckets flush in sorted
    order at the end; the fixture's largest L is far below the kernels'
    MAX_CONTEXT."""
    from lirec_tpu_torch.evaluation import runner as port_runner
    from lirec_tpu_torch.ops.gather_pool import MAX_CONTEXT

    _, (pc, pd, pb) = _rels_only_pair(synth_root)
    pd.test_rels_multi_clip = True
    lengths = [pd[i]["feat_idx"].shape[0] - 1 for i in range(len(pd))]
    pd.test_rels_multi_clip = False
    from lirec_tpu_torch.models import tabular

    seen = []
    real = tabular.midfusion_tabular

    def spy(model, spec, tables, feat_idx, rels_mask, **kw):
        seen.append((tuple(feat_idx.shape), tuple(rels_mask.shape),
                     int(rels_mask.sum())))
        return real(model, spec, tables, feat_idx, rels_mask, **kw)

    monkeypatch.setattr(tabular, "midfusion_tabular", spy)
    port_runner.evaluate_rels_only(pd, pb, pb.model, pc, verbose=False,
                                   batch_size=4)
    pads = sorted({1 << max(1, L - 1).bit_length() for L in lengths})
    assert {s[0][1] - 1 for s in seen} == set(pads)
    for (fshape, mshape, _) in seen:
        assert fshape[0] == mshape[0] == 4 and fshape[2] == 3
        assert mshape == (4, fshape[1] - 1, 1)
    tail = [s[0][1] - 1 for s in seen[-len(pads):]]
    assert tail == sorted(tail)
    assert sum(s[2] for s in seen) > 0
    assert max(lengths) < MAX_CONTEXT


@pytest.mark.parametrize("preset,mode,batch_size", [
    ("modalities", "val", 8),
    ("int_rels", "val", 5),
    ("int_rel_ch", "test", 8),
])
def test_host_evaluate_details_match_jax(synth_root, preset, mode,
                                         batch_size):
    """evaluate(return_details=True): the confusion matrix equal to the
    JAX package's, and its accumulators (the relationship one where the
    preset has it) beside the metric dict."""
    from lirec_tpu.evaluation import runner as jax_runner
    from lirec_tpu_torch.evaluation import runner as port_runner

    (jc, jd, jb), (pc, pd, pb) = _pair(synth_root, preset, mode, batch_size)
    want = jax_runner.evaluate(jd, jb, jb.params, jc, mode=mode,
                               verbose=False, return_details=True)
    got = port_runner.evaluate(pd, pb, pb.model, pc, mode=mode,
                               verbose=False, return_details=True)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["conf_mat"], want["conf_mat"])
    assert got["conf_mat"].shape == (pd.n_classes, pd.n_classes)
    if preset != "int_rel_ch":  # the grounding presets fill no matrix
        assert got["conf_mat"].sum() > 0
    assert got["accumulator"].total == want["accumulator"].total
    if "rels_accumulator" in want:
        assert got["rels_accumulator"]._gt == want["rels_accumulator"]._gt
    plain = port_runner.evaluate(pd, pb, pb.model, pc, mode=mode,
                                 verbose=False)
    assert plain == {k: v for k, v in got.items() if k not in (
        "conf_mat", "accumulator", "rels_accumulator")}
