"""Shared entry-point plumbing of the CLIs (counterpart of
lirec_tpu/cli/common.py, ref `resume/*.py` catch_inner/pipeline).

Each entry point resolves a preset config, builds the split datasets with
the reference's split choices (`modalities`/`int_rels` build their nominal
train dataset from the **val** split, `int_ch`/`int_rel_ch` from the
**test** split; ref resume/modalties.py:21, int_rels.py:25, int_ch.py:22,
int_rel_ch.py:23), and then either
evaluates a checkpoint (a reference ``.pth.tar``, or a msgpack ``.ckpt``
file or an Orbax ``.ckpt`` directory of the JAX package) on the val and
test splits
(the packed sweep, evaluation/packed.py, or with ``--host-eval`` the
per-batch host loop, evaluation/runner.py) or, with ``--train`` /
``--resume-train``, trains (train/loop.py: the epoch sweep, or one step
per batch with ``--per-batch-train``; cadence evaluation, best-n
checkpoints, ``latest.pth.tar`` and the final ``<epochs-1>.pth.tar`` under
``--store-root``), all on ``--device`` (default: the card).
``--resume-train`` reads the weights, the Adam state and the epoch from
``--resume-path`` (a ``.pth.tar`` train state, or the JAX package's
msgpack ``.ckpt`` or Orbax directory) and starts at epoch + 1;
``--auto-resume`` does the same from ``<store-root>/latest.pth.tar``, else
from ``latest.ckpt`` (the JAX package's, or the port's own under
``--checkpoint-backend msgpack`` or ``orbax``, which write the JAX
package's msgpack files or Orbax directories: checkpoint/orbax_backend.py,
without orbax).

The process mesh (parallel/mesh.py), with the JAX package's flags:
``--mesh DxM`` in a single process spawns D * M local ranks (``cuda``: one
per visible card; ``--device cpu``: gloo processes); ``--num-processes N
--coordinator HOST:PORT --process-id R`` joins process R of an N-process
group (one per card, across nodes), with a data mesh of N unless
``--mesh`` lays the N out otherwise. Every rank trains or evaluates its
rows of every batch (by its data index) and the sweep is split over the
data axis; under a model axis (M > 1) training is tensor-parallel over
the M ranks of a row (a model axis that does not divide the sharded
widths is refused, naming them); only rank 0 prints and writes.

``--assembly-workers N`` assembles the train batches in N worker processes
where no assembly plan applies (the same batches; inside each rank under
``--mesh``), and ``--profile DIR`` writes a ``torch.profiler`` Chrome trace
of the training run and of each evaluation into DIR (utils/profiling.py:
``train.json``, ``val.json``, ``test.json``, with ``.rank<r>`` before
``.json`` in a data-parallel rank).

``--ingest-cache PATH`` (evaluation only) starts from a serialized ingest
artifact (data/artifact.py; written by ``lirec-tpu-torch-ingest`` or by the
JAX package's ``lirec-tpu-ingest``, the same file): loaded when it exists,
else the datasets are built and the artifact written, by rank 0 alone
under ``--mesh`` / ``--num-processes`` (the other ranks use the datasets
they built).

Every flag of the JAX package's CLIs parses and runs.
"""

from __future__ import annotations

import argparse
import os
import sys

from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.cli.serve import CHECKPOINT_SUFFIXES, load_checkpoint_state
from lirec_tpu_torch.data.dataset import InteractionDataset
from lirec_tpu_torch.evaluation.packed import evaluate_packed
from lirec_tpu_torch.evaluation.runner import MESH_HOST_EVAL, evaluate
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.models.spec import ModelSpec
from lirec_tpu_torch.parallel.dist import (
    in_rank, initialize_distributed, make_mesh, spawn,
)
from lirec_tpu_torch.parallel.mesh import check_model_axis

TRAIN_SPLIT = {
    "modalities": "val",
    "int_rels": "val",
    "int_ch": "test",
    "int_rel_ch": "test",
}

TRISTATE = {"auto": None, "on": True, "off": False}
# seconds a --mesh run's local ranks may take, start to end; None: no
# deadline (a hung collective still fails after dist.DEFAULT_TIMEOUT)
SPAWN_TIMEOUT = None


def build_parser(preset_name: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lirec-tpu-torch %s" % preset_name)
    p.add_argument("--data-root", required=True)
    p.add_argument("--store-root", default="")
    p.add_argument("--sanity-check", action="store_true",
                   help="one movie per split (ref README.md:52-53)")
    if preset_name in ("int_ch", "int_rel_ch"):
        p.add_argument("--tr-correct", action="store_true",
                       help="GT-track supervision (vs weak)")
    p.add_argument("--resume-path", default=None,
                   help=".pth.tar, or the JAX package's .ckpt (a msgpack "
                        "file or an Orbax directory); default: the "
                        "released checkpoint path for this preset under "
                        "<data-root>/models_release")
    p.add_argument("--train", action="store_true",
                   help="train instead of evaluating a checkpoint")
    p.add_argument("--resume-train", action="store_true",
                   help="load weights + optimizer + epoch from "
                        "--resume-path and continue training")
    p.add_argument("--auto-resume", action="store_true",
                   help="continue from <store-root>/latest.pth.tar if "
                        "present, else from the JAX package's latest.ckpt")
    p.add_argument("--metrics-log", default="",
                   help="append JSONL training telemetry to this path")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save a resumable latest.pth.tar (latest.ckpt "
                        "under msgpack and orbax) every N epochs")
    p.add_argument("--checkpoint-backend", default="torch",
                   choices=["torch", "msgpack", "orbax"],
                   help="train-state format: torch (.pth.tar), or the JAX "
                        "package's msgpack (.ckpt files) or orbax (.ckpt "
                        "directories)")
    p.add_argument("--cache-workers", type=int, default=0,
                   help="thread pool size for feature precompute IO")
    p.add_argument("--assembly-workers", type=int, default=0,
                   help="sample-assembly worker processes (the reference "
                        "ran 4 DataLoader workers); 0 = in-process. "
                        "Identical batches at any worker count")
    p.add_argument("--drop-last", action="store_true",
                   help="drop the leftover train batch (non-parity: the "
                        "reference trains on it)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None,
                   help="override the preset learning rate (ref 3e-5)")
    p.add_argument("--text-dim", type=int, default=768)
    p.add_argument("--visual-dim", type=int, default=2048)
    p.add_argument("--text-layers", type=int, default=12)
    p.add_argument("--joint-dim", type=int, default=512)
    p.add_argument("--compute-dtype", default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--eval-localize", choices=("auto", "on", "off"),
                   default="auto",
                   help="eval ctx localization (evaluation/packed.py): "
                        "pool each batch's context from its unique "
                        "embedded rows (on = the per-table tier). auto = "
                        "off: on the card the local tables cost more than "
                        "they save; metrics are identical either way")
    p.add_argument("--host-eval", action="store_true",
                   help="per-batch host eval loop instead of the packed "
                        "sweep (same metrics, slower; checkpoint eval and "
                        "the training cadence)")
    p.add_argument("--localize-tables", choices=("auto", "on", "off"),
                   default="auto",
                   help="batch-local table projection for training "
                        "(data/localize.py). auto = on when profitable at "
                        "the split's cardinality")
    p.add_argument("--per-batch-train", action="store_true",
                   help="one eager step per batch, each loss read after "
                        "its step, instead of the epoch sweep (train/"
                        "sweep.py: a CUDA graph of the step on a card)")
    for flag in ("--fast-prng", "--strict-prng"):
        p.add_argument(flag, action="store_true",
                       help="accepted for the JAX package's command lines: "
                            "the port draws dropout from one "
                            "torch.Generator stream, so it changes nothing")
    p.add_argument("--device", default="cuda",
                   help="torch device of the weights, tables and sweep")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--mesh", default="",
                   help="DATAxMODEL process mesh, e.g. 4x2: DATA x MODEL "
                        "processes, one per card; shards training (dp "
                        "over the batch, tp over joint_dim across a "
                        "row's MODEL processes) and the packed eval sweep")
    p.add_argument("--num-processes", type=int, default=0,
                   help="processes of a multi-node group (one per card)")
    p.add_argument("--coordinator", default="",
                   help="HOST:PORT of process 0 (or a file:// path)")
    p.add_argument("--process-id", type=int, default=-1,
                   help="this process's rank in the group")
    p.add_argument("--ingest-cache", default="",
                   help="eval-only: path to a serialized ingest artifact "
                        "(.npz). Loaded when present (skips graph mining "
                        "and feature pooling entirely); written after a "
                        "fresh ingest otherwise. Create offline with "
                        "`python -m lirec_tpu_torch.cli.ingest`.")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler Chrome trace of the "
                        "train/eval work into this directory")
    return p


def config_from_args(preset_name: str, args) -> config_lib.ExperimentConfig:
    kw = {}
    if hasattr(args, "tr_correct"):
        kw["tr_correct"] = args.tr_correct
    cfg = config_lib.preset(
        preset_name,
        data_root=args.data_root,
        store_root=args.store_root or os.path.join(args.data_root, "store"),
        sanity_check=args.sanity_check,
        **kw,
    )
    cfg = cfg.with_dims(
        text_dim=args.text_dim,
        visual_dim=args.visual_dim,
        text_layers=args.text_layers,
        joint_dim=args.joint_dim,
    )
    if args.epochs is not None:
        cfg = cfg.with_optim(epochs=args.epochs)
    if args.batch_size is not None:
        cfg = cfg.with_optim(batch_size=args.batch_size)
    if args.lr is not None:
        cfg = cfg.with_optim(lr=args.lr)
    if args.compute_dtype:
        cfg = cfg.with_runtime(compute_dtype=args.compute_dtype)
    if args.resume_path is not None:
        cfg = cfg.replace(resume_path=args.resume_path)
    if args.train or args.resume_train:
        cfg = cfg.replace(resume=False, resume_train=args.resume_train)
    return cfg


def build_datasets(cfg, preset_name: str, workers: int = 0):
    """Ingest the three split datasets with the reference's split quirks
    (the nominal 'train' dataset comes from TRAIN_SPLIT[preset])."""
    needs_rels = cfg.tasks.rels or cfg.tasks.rels_multitask
    train_ds = InteractionDataset(cfg, mode=TRAIN_SPLIT[preset_name])
    train_ds.cache(parallel_workers=workers)
    val_ds = InteractionDataset(cfg, mode="val")
    val_ds.n_classes = train_ds.n_classes
    val_ds.cache(parallel_workers=workers)
    test_ds = InteractionDataset(cfg, mode="test")
    test_ds.n_classes = train_ds.n_classes
    test_ds.cache(parallel_workers=workers)
    if needs_rels:
        train_ds.init_relships()
        val_ds.init_relships()
        test_ds.init_relships()
    return train_ds, val_ds, test_ds


def mesh_shape(args, preset_name: str):
    """(data, model) of --mesh / --num-processes, or None for one
    process, with the JAX package's checks and messages; a model axis
    that does not divide the preset's sharded widths is refused, naming
    them."""
    if args.num_processes > 1 and (args.process_id < 0
                                   or not args.coordinator):
        raise SystemExit("--num-processes needs --coordinator HOST:PORT "
                         "and --process-id")
    if not args.mesh:
        return (args.num_processes, 1) if args.num_processes > 1 else None
    if args.host_eval:
        raise SystemExit(MESH_HOST_EVAL)
    try:
        shape = tuple(int(x) for x in args.mesh.lower().split("x"))
    except ValueError:
        shape = ()
    if len(shape) != 2:
        raise SystemExit("--mesh expects DATAxMODEL, e.g. 4x2")
    data, model = shape
    n = data * model
    if n < 1:
        raise SystemExit("--mesh %s: each axis needs at least 1" % args.mesh)
    if model > 1:
        # the widths a model axis splits (no n_classes or n_rels needed)
        spec = ModelSpec.from_config(config_from_args(preset_name, args), 1)
        try:
            check_model_axis(spec, model)
        except ValueError as err:
            raise SystemExit("--mesh %s: %s" % (args.mesh, err))
    if args.num_processes > 1 and n != args.num_processes:
        raise SystemExit(
            "--mesh %dx%d needs %d processes, one per card; "
            "--num-processes is %d" % (data, model, n, args.num_processes))
    if args.num_processes <= 1 and not in_rank():
        import torch

        visible = (torch.cuda.device_count()
                   if torch.device(args.device).type == "cuda" else n)
        if n > visible:
            raise SystemExit("--mesh %dx%d needs %d devices; %d visible"
                             % (data, model, n, visible))
    return shape


def _train_state_path(cfg, args) -> str:
    """The train state a training run resumes from: --resume-path under
    --resume-train, else under --auto-resume <store-root>/latest.pth.tar
    if it exists, else the JAX package's latest.ckpt if it exists; "" for
    a run from epoch 0. latest.ckpt may be a msgpack file or an Orbax
    directory."""
    if cfg.resume_train and cfg.resume_path:
        return cfg.resume_path
    if not args.auto_resume:
        return ""
    for name in ("latest.pth.tar", "latest.ckpt"):
        latest = os.path.join(cfg.paths.store_root, name)
        if os.path.exists(latest):
            return latest
    return ""


def load_train_state_any(path: str, model, optimizer):
    """(state_dict, Adam state_dict or None, epoch) of a train state: the
    port's .pth.tar, or the JAX package's msgpack .ckpt file or Orbax
    directory with its optax state mapped to `optimizer` over `model`'s
    parameters."""
    from lirec_tpu_torch.checkpoint import load_jax_checkpoint
    from lirec_tpu_torch.checkpoint.saver import load_train_state

    if path.endswith(CHECKPOINT_SUFFIXES):
        return load_train_state(path)
    return load_jax_checkpoint(path, model, optimizer)


def run_entry(preset_name: str, argv=None) -> dict:
    import multiprocessing

    if multiprocessing.parent_process() is not None and not in_rank():
        # an unguarded launching script re-imported by a spawned process:
        # without this the child would run the entry again, and could join
        # the parent's process group
        raise RuntimeError(
            "run_entry re-executed inside a multiprocessing child: guard "
            "the launching script with `if __name__ == '__main__':` "
            "(spawned workers re-import __main__)")
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser(preset_name)
    args = parser.parse_args(argv)
    shape = mesh_shape(args, preset_name)
    if shape is None or shape[0] * shape[1] == 1:
        return _run(preset_name, args, None)
    if args.num_processes > 1:
        import torch.distributed

        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id, args.device)
        if not args.mesh and args.process_id == 0 and not args.quiet:
            print("no --mesh given: using data-only mesh %dx1" % shape[0])
        try:
            return _run(preset_name, args, make_mesh(shape))
        finally:
            torch.distributed.destroy_process_group()
    if in_rank():
        return _run(preset_name, args, make_mesh(shape))
    import torch

    # each rank runs this entry again, inside the group (in_rank)
    ranks = spawn(run_entry, shape[0] * shape[1],
                  devices=torch.device(args.device).type,
                  args=(preset_name, argv), timeout=SPAWN_TIMEOUT)
    return ranks[0].value


def _traced(args, mesh, name: str, fn, /, *fn_args, **kwargs):
    """fn(*fn_args, **kwargs) under a torch.profiler trace written to
    ``--profile``/<name>[.rank<r>].json when --profile is set."""
    from lirec_tpu_torch.utils.profiling import trace

    rank = None if mesh is None else mesh.process
    with trace(args.profile, device=args.device, name=name, rank=rank):
        return fn(*fn_args, **kwargs)


def _datasets(cfg, preset_name: str, args, mesh, verbose: bool):
    """The train, val and test datasets: from the --ingest-cache artifact
    where it exists, else built (and, with --ingest-cache, written to it by
    rank 0 alone: every rank of a mesh builds the same datasets, and two
    writers must not race on one file)."""
    from lirec_tpu_torch.data.artifact import load_ingest, save_ingest

    path = args.ingest_cache
    if path and not cfg.resume:
        raise SystemExit(
            "--ingest-cache serves the eval paths; training draws fresh "
            "per-epoch context subsets and needs the live dataset"
        )
    if path and os.path.exists(path):
        splits = load_ingest(path, cfg)
        if verbose:
            print("loaded ingest artifact: %s" % path)
        return splits["train"], splits["val"], splits["test"]
    datasets = build_datasets(cfg, preset_name, workers=args.cache_workers)
    if path and (mesh is None or mesh.lead):
        save_ingest(path, cfg, dict(zip(("train", "val", "test"),
                                        datasets)))
        if verbose:
            print("wrote ingest artifact: %s" % path)
    return datasets


def _run(preset_name: str, args, mesh) -> dict:
    """Evaluate or train in this process; with a `mesh`, as one of its
    ranks (every rank runs this; rank 0 prints). The evaluation of a
    checkpoint runs the whole model on every rank, the samples split over
    the data axis."""
    cfg = config_from_args(preset_name, args)
    resume_from = "" if cfg.resume else _train_state_path(cfg, args)
    verbose = not args.quiet and (mesh is None or mesh.lead)
    train_ds, val_ds, test_ds = _datasets(cfg, preset_name, args, mesh,
                                          verbose)
    n_rels = max(len(train_ds.rels_list) - 1, 0)
    bundle = create_model(cfg, train_ds.n_classes, n_rels=n_rels,
                          device=args.device)
    if not cfg.resume:
        return {"train": _train(cfg, args, bundle, train_ds, val_ds,
                                test_ds, resume_from, verbose, mesh)}
    if cfg.resume_path:
        bundle.model.load_state_dict(load_checkpoint_state(cfg.resume_path))
        if verbose:
            print("loaded checkpoint: %s" % cfg.resume_path)
    results = {}
    for mode, ds in (("val", val_ds), ("test", test_ds)):
        if verbose:
            print("testing on %s set" % ("validation" if mode == "val"
                                         else mode))
        if args.host_eval:
            results[mode] = _traced(args, mesh, mode, evaluate, ds, bundle,
                                    bundle.model, cfg, mode=mode,
                                    verbose=verbose)
        else:
            results[mode] = _traced(
                args, mesh, mode, evaluate_packed, ds, bundle, bundle.model,
                cfg, mode=mode, verbose=verbose,
                localize_ctx=TRISTATE[args.eval_localize], mesh=mesh,
            )
    return results


def _train(cfg, args, bundle, train_ds, val_ds, test_ds, resume_from,
           verbose, mesh) -> dict:
    """--train / --resume-train / --auto-resume: the epoch loop from epoch
    0, or from the epoch after the train state `resume_from`'s."""
    from lirec_tpu_torch.train.loop import train
    from lirec_tpu_torch.train.optim import load_state, make_optimizer

    optimizer = make_optimizer(bundle.model.parameters(), cfg.optim.lr,
                               cfg.optim.weight_decay)
    start_epoch = 0
    if resume_from:
        state_dict, opt_state, epoch = load_train_state_any(
            resume_from, bundle.model, optimizer)
        bundle.model.load_state_dict(state_dict)
        if opt_state:
            load_state(optimizer, opt_state)
        start_epoch = epoch + 1
        if verbose:
            print("resumed training state from %s (epoch %d)"
                  % (resume_from, epoch))
    out = _traced(
        args, mesh, "train", train,
        cfg, bundle, train_ds, val_dataset=val_ds, test_dataset=test_ds,
        optimizer=optimizer, verbose=verbose, start_epoch=start_epoch,
        metrics_log_path=args.metrics_log or None,
        checkpoint_every=args.checkpoint_every, drop_last=args.drop_last,
        host_eval=args.host_eval,
        localize_tables=TRISTATE[args.localize_tables],
        eval_localize=TRISTATE[args.eval_localize], mesh=mesh,
        checkpoint_backend=args.checkpoint_backend,
        assembly_workers=args.assembly_workers,
        epoch_sweep=False if args.per_batch_train else None,
    )
    return {"losses": out["losses"], "start_epoch": start_epoch,
            "final_path": out["final_path"],
            "epoch_sweep_used": out["epoch_sweep_used"],
            "localized_tables": out["localized_tables"]}
