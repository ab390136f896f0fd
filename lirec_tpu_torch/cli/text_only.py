"""Text-only ablation entry point (train or evaluate) on the port
(counterpart of lirec_tpu/cli/text_only.py).

The reference ships this pipeline without an entry script
(`text_utils/classification_dataloader.py` is only importable). The
Modalities model runs with modality 't' on the pooled dialog vectors of
data/text_dataset.py: ``--train`` trains it (train/loop.py; its cadence
evaluation takes the host loop, as the dataset has no packed split), else
the val and test splits are evaluated (evaluation/runner.evaluate) with the
weights of ``--resume-path`` (a ``.pth.tar``, or the JAX package's
msgpack ``.ckpt``), all on ``--device`` (default: the card).

    python -m lirec_tpu_torch.cli.text_only --data-root <root> [--train]
        [--resume-path <x.pth.tar | x.ckpt>] [--device cpu]
"""

from __future__ import annotations

import argparse

from lirec_tpu_torch.cli.serve import load_checkpoint_state
from lirec_tpu_torch.data.text_dataset import TextOnlyDataset, preset_text_only
from lirec_tpu_torch.evaluation.runner import evaluate
from lirec_tpu_torch.models.factory import create_model
from lirec_tpu_torch.train.loop import train as train_loop


def main(argv=None):
    p = argparse.ArgumentParser(prog="lirec-tpu-torch text_only")
    p.add_argument("--data-root", required=True)
    p.add_argument("--store-root", default="")
    p.add_argument("--sanity-check", action="store_true")
    p.add_argument("--inter-class", default="m", choices=["t", "v", "m"])
    p.add_argument("--train", action="store_true")
    p.add_argument("--resume-path", default="",
                   help=".pth.tar or the JAX package's .ckpt")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--text-dim", type=int, default=768)
    p.add_argument("--text-layers", type=int, default=12)
    p.add_argument("--joint-dim", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="torch device of the weights, tables and steps")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    cfg = preset_text_only(
        data_root=args.data_root,
        store_root=args.store_root or args.data_root + "/store_text",
        sanity_check=args.sanity_check,
        inter_class=args.inter_class,
    )
    cfg = cfg.with_dims(
        text_dim=args.text_dim, visual_dim=0,
        text_layers=args.text_layers, joint_dim=args.joint_dim,
    ).with_runtime(compute_dtype="float32")
    if args.epochs is not None:
        cfg = cfg.with_optim(epochs=args.epochs)
    if args.batch_size is not None:
        cfg = cfg.with_optim(batch_size=args.batch_size)

    verbose = not args.quiet
    train_ds = TextOnlyDataset(cfg, mode="train")
    train_ds.cache()
    val_ds = TextOnlyDataset(cfg, mode="val")
    val_ds.cache()
    test_ds = TextOnlyDataset(cfg, mode="test")
    test_ds.cache()

    bundle = create_model(cfg, train_ds.n_classes, device=args.device)
    results = {}
    if args.train:
        out = train_loop(
            cfg, bundle, train_ds, val_dataset=val_ds, test_dataset=test_ds,
            verbose=verbose,
        )
        results["train"] = {"losses": out["losses"]}
    else:
        if args.resume_path:
            bundle.model.load_state_dict(load_checkpoint_state(
                args.resume_path))
        results["val"] = evaluate(
            val_ds, bundle, bundle.model, cfg, mode="val", verbose=verbose
        )
        results["test"] = evaluate(
            test_ds, bundle, bundle.model, cfg, mode="test", verbose=verbose
        )
    return results


def script() -> int:
    """Console-script wrapper: main() returns data for programmatic use;
    setuptools wrappers sys.exit() the return value, so exit 0 here."""
    main()
    return 0


if __name__ == "__main__":
    main()
