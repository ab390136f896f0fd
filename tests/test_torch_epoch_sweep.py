"""The port's one-dispatch sweeps on the CPU (train/sweep.py, train/loop.
train(epoch_sweep=...), evaluation/packed.sweep_carry(graph=...)): the
epoch sweep against the JAX package's epoch sweep and against the port's
own per-batch path, chunked against unchunked, ``epoch_sweep_used`` in
train() and in the training CLI's result as the JAX CLI reports it, the
paths ``dispatch.decisions("train_loop")`` records, and the pieces the
card's CUDA graphs are built from (the stacking, the slab staging against
it and its ``train_staging`` record, each call staging its own batches,
the index check and train() stopping at it before the sweep, the launch
counts a capture records, the capture-safe sampling, the optimizer's file
state).

The synthetic fixture is written under a fixed string-hash seed (as
tests/test_torch_train.py pins it), f32, tr_cat_distr off, torch on one
thread; dropout 0 against the JAX package (its masks come from another
key stream), 0.3 against the port's own per-batch path (the same
generators). Where the CUDA graphs themselves run is
tests/test_torch_cuda.py (the ``cuda`` marker).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lirec_tpu import config as config_lib
from lirec_tpu.cli.common import run_entry as jax_run_entry
from lirec_tpu.data import synthetic
from lirec_tpu.data.dataset import InteractionDataset
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu.train.loop import _stack_epoch_batches as jax_stack
from lirec_tpu.train.loop import train as jax_train
from lirec_tpu_torch import config as port_config
from lirec_tpu_torch.checkpoint import params_from_jax
from lirec_tpu_torch.data import synthetic as port_synthetic
from lirec_tpu_torch.data.dataset import InteractionDataset as PortDataset
from lirec_tpu_torch.data.pipeline import EpochIterator
from lirec_tpu_torch.models import losses
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.ops import dispatch
from lirec_tpu_torch.parallel.mesh import Mesh2D
from lirec_tpu_torch.train import loop as port_loop
from lirec_tpu_torch.train.loop import check_batch, check_indices, train
from lirec_tpu_torch.train.optim import file_state, load_state, make_optimizer
from lirec_tpu_torch.train.sweep import (
    SLAB_STEPS, EpochSweep, stack_epoch_batches,
)
from lirec_tpu_torch.utils.fake_batch import make_batch, make_tables
from lirec_tpu_torch.utils.graphs import take
from tests.jax_cache_guard import isolated_xla_cache  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM_ARGS = ["--text-dim", "16", "--visual-dim", "32", "--text-layers", "4",
            "--joint-dim", "16", "--compute-dtype", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pinned_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mg_sweep_pinned"))
    subprocess.run(
        [sys.executable, "-c", "import sys; from lirec_tpu.data import "
         "synthetic; synthetic.generate(sys.argv[1])", root],
        cwd=ROOT, check=True, env=dict(os.environ, PYTHONHASHSEED="7"))
    return root


def _setup(root, batch_size, port, dropout=0.0, epochs=2):
    cfg_lib, synth, dataset = ((port_config, port_synthetic, PortDataset)
                               if port else
                               (config_lib, synthetic, InteractionDataset))
    base = synth.make_config(root)
    cfg = cfg_lib.preset("int_rel_ch", data_root=root)
    cfg = cfg.replace(dims=base.dims, paths=base.paths).with_runtime(
        compute_dtype="float32").with_optim(
        batch_size=batch_size, epochs=epochs, save_model=False, lr=1e-3,
        dropout=dropout)
    ds = dataset(cfg, mode="train")
    ds.cache()
    ds.init_relships()
    return cfg, ds


def _port_run(root, batch_size, dropout=0.0, **kw):
    """(losses, final state_dict, train()'s result) of the port from the
    seeded initial weights."""
    cfg, ds = _setup(root, batch_size, True, dropout)
    pb = create_model(cfg, ds.n_classes,
                      n_rels=max(len(ds.rels_list) - 1, 0), device="cpu",
                      seed=0)
    out = train(cfg, pb, ds, verbose=False, **kw)
    return out["losses"], pb.model.state_dict(), out


def _assert_close_scaled(got, want, rel, name):
    """|got - want| <= rel * (|want| + max|want|) (as
    tests/test_torch_train.py holds parameters)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max()) if want.size else 0.0
    bad = np.abs(got - want) > rel * (np.abs(want) + scale)
    assert not bad.any(), "%s: %d of %d beyond the bound; worst %.3e" % (
        name, bad.sum(), bad.size, float(np.abs(got - want).max()))


def _assert_bitwise(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("batch_size", [7, 8])
def test_sweep_matches_the_jax_sweep(pinned_root, batch_size):
    """train(epoch_sweep=True) on both sides from the JAX package's initial
    weights, dropout 0, 2 epochs: batch 7 (22 samples, the size-1 leftover
    skipped: every batch full) and batch 8 (a last batch of 6, padded, so
    every batch carries a loss_weight on both sides). Losses and final
    parameters within rtol 1e-5 of scale."""
    cfg, ds = _setup(pinned_root, batch_size, False)
    n_rels = max(len(ds.rels_list) - 1, 0)
    jb = jax_create_model(cfg, ds.n_classes, n_rels=n_rels)
    want = jax_train(cfg, jb, ds, verbose=False, epoch_sweep=True)
    assert want["epoch_sweep_used"]
    pcfg, pds = _setup(pinned_root, batch_size, True)
    pb = create_model(pcfg, pds.n_classes, n_rels=n_rels, device="cpu")
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                          jb.params)))
    got = train(pcfg, pb, pds, verbose=False, epoch_sweep=True)
    assert got["epoch_sweep_used"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    final = params_from_jax(jax.tree.map(np.asarray, want["params"]))
    for name, p in pb.model.named_parameters():
        _assert_close_scaled(p.detach(), final[name], 1e-5, name)


@pytest.mark.parametrize("batch_size", [7, 8])
def test_sweep_is_the_per_batch_path_bit_for_bit(pinned_root, batch_size):
    """The sweep and the per-batch path with dropout 0.3 and the same step
    generators: the same losses and parameters bit for bit, at batch 7
    (every batch full) and at batch 8, where the sweep gives every batch a
    loss_weight of ones and the per-batch path gives one to the padded
    batch only. That case is bitwise too on the CPU: a weight of one
    multiplies exactly, the weighted sum adds the same terms in the same
    order, and torch's CPU mean is a sum divided by the count, as the
    weighted mean is (a card's mean multiplies by 1 / count instead, so
    there the two agree at power-of-two batch sizes)."""
    loss_b, state_b, out_b = _port_run(pinned_root, batch_size, 0.3,
                                       epoch_sweep=False)
    loss_s, state_s, out_s = _port_run(pinned_root, batch_size, 0.3,
                                       epoch_sweep=True)
    assert not out_b["epoch_sweep_used"] and out_s["epoch_sweep_used"]
    assert loss_s == loss_b
    _assert_bitwise(state_s, state_b)


@pytest.mark.parametrize("max_steps", [1, 2])
def test_chunked_sweep_is_the_unchunked_sweep(pinned_root, max_steps):
    """sweep_max_steps 1 and 2 (three batches an epoch: chunks of 1 and of
    2 + 1) against one chunk, dropout 0.3: bitwise, the step offsets keep
    the epoch's step index across chunks."""
    whole, whole_state, _ = _port_run(pinned_root, 8, 0.3)
    part, part_state, _ = _port_run(pinned_root, 8, 0.3,
                                    sweep_max_steps=max_steps)
    assert part == whole
    _assert_bitwise(part_state, whole_state)


def test_epoch_sweep_used_and_train_loop_decisions(pinned_root):
    """epoch_sweep_used is True by default and False under dense=True and
    epoch_sweep=False; dispatch.decisions("train_loop") counts "eager"
    once per chunk of the CPU sweep (reason "cpu tensors") and "per_batch"
    once per epoch of the per-batch path (reason "epoch_sweep off", or
    "dense batches")."""
    def run(**kw):
        before = dispatch.decisions("train_loop")
        out = _port_run(pinned_root, 8, **kw)[2]
        now = dispatch.decisions("train_loop")
        return out["epoch_sweep_used"], {
            p: now[p] - before.get(p, 0) for p in now
            if now[p] != before.get(p, 0)}, dispatch.last_dispatch(
            "train_loop")

    used, counted, last = run()
    assert used and counted == {"eager": 2}  # 2 epochs of one chunk
    assert last["reason"] == "cpu tensors"
    assert last["shapes"]["labels"] == (3, 8)
    used, counted, _ = run(sweep_max_steps=2)
    assert used and counted == {"eager": 4}
    used, counted, last = run(epoch_sweep=False)
    assert not used and counted == {"per_batch": 2}
    assert last["reason"] == "epoch_sweep off"
    used, counted, last = run(dense=True)
    assert not used and counted == {"per_batch": 2}
    assert last["reason"] == "dense batches"


def test_training_cli_reports_epoch_sweep_used_as_the_jax_cli(synth_root,
                                                              tmp_path):
    """The training CLI's result carries epoch_sweep_used under the JAX
    CLI's key, True by default and False with --per-batch-train, on both
    sides."""
    from lirec_tpu_torch.cli.common import run_entry

    for extra, want in (([], True), (["--per-batch-train"], False)):
        base = ["--data-root", synth_root, "--train", "--epochs", "1",
                "--batch-size", "8", "--quiet", "--store-root",
                str(tmp_path / ("s%d" % len(extra)))] + DIM_ARGS + extra
        got = run_entry("int_rel_ch", base + ["--device", "cpu"])["train"]
        jax_got = jax_run_entry("int_rel_ch", base)["train"]
        assert got["epoch_sweep_used"] is want
        assert jax_got["epoch_sweep_used"] is want
        assert set(jax_got) <= set(got)


def test_stacking_is_the_jax_packages(pinned_root):
    """stack_epoch_batches gives _stack_epoch_batches' arrays bit for bit,
    on an epoch of full batches (no loss_weight) and on one with a ragged
    batch (every batch weighted, the padded rows 0)."""
    _, ds = _setup(pinned_root, 8, True)
    for batch_size in (7, 8):
        batches = [b for b in EpochIterator(ds, batch_size, seed=0)
                   if len(b["labels"]) > 1]
        got = stack_epoch_batches(batches, batch_size)
        want = jax_stack(batches, batch_size)
        assert sorted(got) == sorted(want)
        assert ("loss_weight" in got) == (batch_size == 8)
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got["loss_weight"][-1, 6:].sum() == 0
    assert got["loss_weight"][:-1].min() == 1


def _tiny(mesh=None):
    """A narrow int_rel_ch on the CPU, its tables, and a maker of epoch
    sweeps at batch 4 of that model and one optimizer (under `mesh`, a
    Mesh2D of no process group: its rows only)."""
    cfg = port_config.preset("int_rel_ch").with_dims(
        text_dim=16, visual_dim=32, joint_dim=16).with_runtime(
        compute_dtype="float32")
    pb = create_model(cfg, 9, n_rels=6, seed=0, device="cpu")
    opt = make_optimizer(pb.model.parameters(), 1e-3)
    tables = {k: torch.from_numpy(v)
              for k, v in make_tables(pb.spec, 64, 96).items()}
    return pb, tables, lambda **kw: EpochSweep(pb, opt, tables, 0, 4,
                                               mesh=mesh, **kw)


def _epoch(spec, full, ragged=0, seed=0):
    """`full` batches of 4 and, where `ragged`, a last batch of that
    many."""
    out = [make_batch(spec, 4, 64, 96, seed=seed + s) for s in range(full)]
    if ragged:
        out.append(make_batch(spec, ragged, 64, 96, seed=seed + full))
    return out


# name: (full batches, rows of a ragged last batch (0: none),
# sweep_max_steps, this rank's (data axis, rank) or None)
STAGING = {
    "past_a_slab": (SLAB_STEPS + 3, 0, 512, None),
    "ragged_last": (SLAB_STEPS + 2, 3, 512, None),
    "chunked": (2 * SLAB_STEPS + 2, 3, SLAB_STEPS + 2, None),
    "one_slab": (3, 0, 512, None),
    "mesh_rank": (SLAB_STEPS + 2, 3, 512, (2, 1)),
}


@pytest.mark.parametrize("case", sorted(STAGING))
def test_slab_staging_is_the_stacking(case):
    """What each step of EpochSweep.run (eager, on the CPU) reads from the
    slab-staged device stack, and the stack after the call, are
    stack_epoch_batches' arrays of its chunk bit for bit, with the same
    keys and dtypes (this rank's rows under a mesh; a ragged last batch
    padded, every batch of its chunk weighted); the train_staging counter
    records each chunk's steps, the slab and its number of slabs."""
    full, ragged, max_steps, place = STAGING[case]
    mesh = None if place is None else Mesh2D(*place)
    pb, _, make = _tiny(mesh)
    sweep = make(sweep_max_steps=max_steps)
    seen = []

    def step(batch, tables, generators, tr_sum_max_flag=True):
        seen.append({k: v.clone() for k, v in batch.items()})
        return torch.tensor(float(len(seen)))

    sweep.step = step
    batches = _epoch(pb.spec, full, ragged)
    before = dispatch.decisions("train_staging").get("slabs", 0)
    losses = sweep.fetch(sweep.run(batches, 0))
    assert losses == [float(i + 1) for i in range(len(batches))]
    rows = slice(None) if mesh is None else slice(2 * place[1],
                                                  2 * place[1] + 2)
    chunks = [batches[c0:c0 + max_steps]
              for c0 in range(0, len(batches), max_steps)]
    c0 = 0
    for chunk in chunks:
        want = {k: v if k in ("uniq_clip", "uniq_track") else v[:, rows]
                for k, v in stack_epoch_batches(chunk, 4).items()}
        got = {k: np.stack([s[k].numpy() for s in seen[c0:c0 + len(chunk)]])
               for k in seen[c0]}
        assert sorted(got) == sorted(want)
        assert ("loss_weight" in want) == (ragged > 0 and chunk is chunks[-1])
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        c0 += len(chunk)
    (cap,) = sweep._captured.values()  # the last chunk's stack
    for k, v in want.items():
        np.testing.assert_array_equal(cap.stack[k][:len(chunk)].numpy(), v,
                                      err_msg=k)
    if ragged:
        assert want["loss_weight"][:-1].min() == 1
        np.testing.assert_array_equal(want["loss_weight"][-1],
                                      np.arange(4)[rows] < ragged)
    assert dispatch.decisions("train_staging")["slabs"] - before == len(chunks)
    last = dispatch.last_dispatch("train_staging")
    assert last["reason"] == "host stack"
    assert last["shapes"] == {"steps": len(chunk), "slab": SLAB_STEPS,
                              "slabs": -(-len(chunk) // SLAB_STEPS)}


def test_sweep_stages_each_calls_own_batches():
    """Two calls of one sweep with different batches of the same shapes
    (the second reusing the first's stacks) give the losses and the
    parameters of a fresh sweep for each call over the same model state,
    bit for bit: nothing the first call staged is read by the second."""
    got, want = [], []
    for fresh, out in ((False, got), (True, want)):
        pb, _, make = _tiny()
        sweep = make()
        for seed in (0, 100):
            if fresh:
                sweep = make()
            out.append(sweep.fetch(sweep.run(
                _epoch(pb.spec, SLAB_STEPS + 1, seed=seed), 0)))
        out.append({k: v.clone() for k, v in pb.model.state_dict().items()})
    assert got[0] == want[0] and got[1] == want[1] and got[0] != got[1]
    _assert_bitwise(got[2], want[2])


def _bad(batch, key, where, value):
    batch = {k: np.array(v) for k, v in batch.items()}
    batch[key][where] = value
    return batch


# name: (key, where, value, the message's start); the batch is localized
# to tables of 40 clip and 50 track rows, out of 64 and 96
BAD_IDS = {
    "clip_past_local": ("feat_idx", (1, 2, 3, 0), 40, "clip index"),
    "track_past_local": ("feat_idx", (0, 5, 0, 1), 50, "track index"),
    "second_track_past_local": ("feat_idx", (3, 0, 7, 2), 50,
                                "track index"),
    "negative_clip": ("feat_idx", (0, 0, 0, 0), -1, "clip index"),
    "negative_track": ("feat_idx", (2, 1, 1, 1), -1, "track index"),
    "negative_second_track": ("feat_idx", (1, 1, 1, 2), -3, "track index"),
    "uniq_clip_past_full": ("uniq_clip", (4,), 64, "uniq_clip"),
    "uniq_track_past_full": ("uniq_track", (0,), 96, "uniq_track"),
    "negative_uniq_clip": ("uniq_clip", (0,), -1, "uniq_clip"),
    "negative_uniq_track": ("uniq_track", (7,), -2, "uniq_track"),
}


def _local_batch(spec):
    batch = make_batch(spec, 4, 40, 50, seed=3)
    batch["uniq_clip"] = np.arange(40, dtype=np.int32)
    batch["uniq_track"] = np.arange(50, dtype=np.int32) + 46
    return batch


@pytest.mark.parametrize("case", sorted(BAD_IDS) + ["in_range", "dense",
                                                   "full_tables"])
def test_check_indices(case):
    """check_indices raises on an id past its table or negative, in the
    clip column and in either track column of feat_idx (against the
    batch-local tables) and in uniq_clip / uniq_track (against the full
    tables), naming the column and its range; an in-range batch passes,
    localized or against the full tables, and check_batch passes a dense
    batch (no row ids)."""
    pb, tables, _ = _tiny()
    batch = _local_batch(pb.spec)
    if case == "dense":
        check_batch({"features": np.zeros((4, 8), np.float32),
                     "labels": np.zeros(4, np.int64)}, tables)
        return
    if case == "full_tables":
        check_batch(make_batch(pb.spec, 4, 64, 96, seed=4), tables)
        return
    if case == "in_range":
        check_batch(batch, tables)
        return
    key, where, value, what = BAD_IDS[case]
    n = {"clip index": 40, "track index": 50, "uniq_clip": 64,
         "uniq_track": 96}[what]
    with pytest.raises(ValueError,
                       match=r"^%s out of range \[0, %d\)$" % (what, n)):
        check_indices(_bad(batch, key, where, value), 64, 96)


def test_a_bad_id_stops_train_before_the_sweep(pinned_root, monkeypatch):
    """train() with the epoch sweep, an out-of-range track id in the
    epoch's last batch: it raises at the index check, and EpochSweep.run
    is never reached."""
    collect = port_loop._collect_batches

    def corrupted(iterator):
        batches = collect(iterator)
        batches[-1] = _bad(batches[-1], "feat_idx", (0, 0, 0, 1), 10 ** 6)
        return batches

    def refuse(*args, **kw):
        raise AssertionError("EpochSweep.run reached")

    monkeypatch.setattr(port_loop, "_collect_batches", corrupted)
    monkeypatch.setattr(EpochSweep, "run", refuse)
    with pytest.raises(ValueError, match="track index out of range"):
        _port_run(pinned_root, 8, localize_tables=False)


def test_graphs_are_refused_off_the_card(pinned_root):
    """Asking for a CUDA graph with the model on the CPU raises, in the
    epoch sweep and in the eval sweep; nothing falls back to eager
    steps."""
    from lirec_tpu_torch.evaluation import packed

    cfg, ds = _setup(pinned_root, 8, True)
    pb = create_model(cfg, ds.n_classes,
                      n_rels=max(len(ds.rels_list) - 1, 0), device="cpu")
    opt = make_optimizer(pb.model.parameters(), 1e-3)
    with pytest.raises(ValueError, match="needs the model on a card"):
        EpochSweep(pb, opt, None, 0, 8, require_graph=True)
    before = dispatch.decisions("eval_sweep")
    packed.sweep_carry(ds, pb, pb.model, cfg, mode="train")
    assert dispatch.decisions("eval_sweep").get("eager", 0) == \
        before.get("eager", 0) + 1
    with pytest.raises(ValueError, match="needs the model on a card"):
        packed.sweep_carry(ds, pb, pb.model, cfg, mode="train", graph=True)


def test_a_capture_records_launches_for_its_replays():
    """Launches counted under recording_launches go to the capture's
    counts, not the process's; count_replay adds them once per replay."""
    dispatch.reset_launches()
    dispatch.count_launch("k")
    with dispatch.recording_launches() as captured:
        dispatch.count_launch("k")
        dispatch.count_launch("j")
    assert captured == {"k": 1, "j": 1}
    assert dispatch.launches() == {"k": 1}
    for _ in range(3):
        dispatch.count_replay(captured)
    assert dispatch.launches() == {"k": 4, "j": 3}
    dispatch.reset_launches()


def test_take_and_the_capture_safe_sample():
    """take(stack, index) is stack[i] for a one-element index tensor; the
    one-sample draw a capture uses (probs / Exp(1), argmax) picks what
    torch.multinomial picks from the same generator."""
    stack = torch.arange(24.0).reshape(4, 3, 2)
    for i in range(4):
        got = take(stack, torch.tensor([i]))
        assert torch.equal(got, stack[i]) and got.is_contiguous()
    rng = np.random.default_rng(0)
    for seed in range(20):
        probs = torch.softmax(torch.from_numpy(
            rng.standard_normal((7, 20)).astype(np.float32)), dim=1)
        want = torch.multinomial(
            probs, 1, generator=torch.Generator().manual_seed(seed))
        q = losses._exponential(probs.shape,
                                torch.Generator().manual_seed(seed),
                                probs.device, probs.dtype)
        assert torch.equal((probs / q).argmax(dim=-1), want.squeeze(1))


def test_optimizer_file_state_is_the_non_capturable_form():
    """On the CPU Adam is not capturable; a file state says capturable
    False, and load_state keeps the optimizer's own kind whatever the file
    says, with the step counts on the host."""
    model = torch.nn.Linear(3, 2)
    opt = make_optimizer(model.parameters(), 1e-2)
    assert opt.param_groups[0]["capturable"] is False
    model(torch.ones(4, 3)).sum().backward()
    opt.step()
    state = file_state(opt)
    assert state["param_groups"][0]["capturable"] is False
    state["param_groups"][0]["capturable"] = True  # as a card's optimizer
    other = make_optimizer(torch.nn.Linear(3, 2).parameters(), 1e-2)
    load_state(other, state)
    assert other.param_groups[0]["capturable"] is False
    for st in other.state.values():
        assert st["step"].device.type == "cpu" and float(st["step"]) == 1.0
