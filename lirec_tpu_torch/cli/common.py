"""Shared entry-point plumbing of the eval CLIs (counterpart of
lirec_tpu/cli/common.py, ref `resume/*.py` catch_inner/pipeline).

Each entry point resolves a preset config, builds the split datasets with
the reference's split choices (`int_rels` builds its nominal train dataset
from the **val** split, `int_ch`/`int_rel_ch` from the **test** split; ref
resume/int_rels.py:25, int_ch.py:22, int_rel_ch.py:23), loads a reference
``.pth.tar`` checkpoint, and evaluates the val and test splits with the
packed sweep (evaluation/packed.py) on ``--device`` (default: the card).

The flags of features the port does not have yet are accepted and refuse
to run, naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import os

from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.cli.serve import CHECKPOINT_SUFFIXES, load_checkpoint_state
from lirec_tpu_torch.data.dataset import InteractionDataset
from lirec_tpu_torch.evaluation.packed import evaluate_packed
from lirec_tpu_torch.models.factory import create_model

TRAIN_SPLIT = {
    "int_rels": "val",
    "int_ch": "test",
    "int_rel_ch": "test",
}

# flag -> the ROADMAP.md queue 1 item that ports its feature
NOT_PORTED = {
    "train": "'CLI --train with cadence eval'",
    "resume_train": "'CLI --train with cadence eval'",
    "host_eval": "'--host-eval'",
    "ingest_cache": "'the remaining CLIs and ingest artifacts'",
    "mesh": "'multi-GPU'",
    "num_processes": "'multi-GPU'",
}


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
                   help="reference .pth.tar; default: the released "
                        "checkpoint path for this preset under "
                        "<data-root>/models_release")
    p.add_argument("--cache-workers", type=int, default=0,
                   help="thread pool size for feature precompute IO")
    p.add_argument("--batch-size", type=int, default=None)
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
    p.add_argument("--device", default="cuda",
                   help="torch device of the weights, tables and sweep")
    p.add_argument("--quiet", action="store_true")
    # not ported yet: accepted, then refused (run_entry)
    p.add_argument("--train", action="store_true",
                   help="not ported yet (refused)")
    p.add_argument("--resume-train", action="store_true",
                   help="not ported yet (refused)")
    p.add_argument("--host-eval", action="store_true",
                   help="not ported yet (refused)")
    p.add_argument("--ingest-cache", default="",
                   help="not ported yet (refused)")
    p.add_argument("--mesh", default="", help="not ported yet (refused)")
    p.add_argument("--num-processes", type=int, default=0,
                   help="not ported yet (refused)")
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
    if args.batch_size is not None:
        cfg = cfg.with_optim(batch_size=args.batch_size)
    if args.compute_dtype:
        cfg = cfg.with_runtime(compute_dtype=args.compute_dtype)
    if args.resume_path is not None:
        cfg = cfg.replace(resume_path=args.resume_path)
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


def load_checkpoint(path: str):
    """A reference .pth.tar -> the port's state_dict. The JAX package's
    msgpack and Orbax checkpoints are refused."""
    if os.path.isdir(path) or not path.endswith(CHECKPOINT_SUFFIXES):
        raise SystemExit(
            "lirec_tpu_torch reads reference .pth.tar checkpoints only; the "
            "JAX package's msgpack / Orbax formats wait for ROADMAP.md "
            "queue 1 'checkpoint writing': %r" % path
        )
    return load_checkpoint_state(path)


def run_entry(preset_name: str, argv=None) -> dict:
    args = build_parser(preset_name).parse_args(argv)
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag):
            raise SystemExit(
                "--%s is not ported to lirec_tpu_torch yet (ROADMAP.md "
                "queue 1 %s)" % (flag.replace("_", "-"), item)
            )
    cfg = config_from_args(preset_name, args)
    verbose = not args.quiet
    train_ds, val_ds, test_ds = build_datasets(
        cfg, preset_name, workers=args.cache_workers
    )
    n_rels = max(len(train_ds.rels_list) - 1, 0)
    bundle = create_model(cfg, train_ds.n_classes, n_rels=n_rels,
                          device=args.device)
    if cfg.resume_path:
        bundle.model.load_state_dict(load_checkpoint(cfg.resume_path))
        if verbose:
            print("loaded checkpoint: %s" % cfg.resume_path)
    localize = {"auto": None, "on": True, "off": False}[args.eval_localize]
    results = {}
    for mode, ds in (("val", val_ds), ("test", test_ds)):
        if verbose:
            print("testing on %s set" % ("validation" if mode == "val"
                                         else mode))
        results[mode] = evaluate_packed(
            ds, bundle, bundle.model, cfg, mode=mode, verbose=verbose,
            localize_ctx=localize,
        )
    return results
