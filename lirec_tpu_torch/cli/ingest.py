"""Offline ingest: serialize a preset's packed splits to one artifact
(counterpart of lirec_tpu/cli/ingest.py: the same flags and the same file,
which either package's eval CLIs load with ``--ingest-cache``).

Replaces the reference's hours-long lazy caching pass
(ref classification_dataloader.py:139-186 ``cache()`` + the per-row .npy
memoization maze under ``<visual_path>/cached/``) with ONE emitted file:
deduplicated feature tables + per-split materialized index tensors
(SURVEY.md §7.2). Eval entry points then start cold in seconds via
``--ingest-cache``:

    python -m lirec_tpu_torch.cli.ingest --data-root D --preset int_rel_ch \
        --out D/ingest_int_rel_ch.npz
    python -m lirec_tpu_torch.cli.int_rel_ch --data-root D \
        --ingest-cache D/ingest_int_rel_ch.npz

It builds the datasets on the host alone (numpy; no card is used).
"""

from __future__ import annotations

import argparse

from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.cli.common import TRAIN_SPLIT, build_datasets
from lirec_tpu_torch.data.artifact import save_ingest


def main(argv=None) -> str:
    p = argparse.ArgumentParser(prog="lirec-tpu-torch ingest")
    p.add_argument("--data-root", required=True)
    p.add_argument("--preset", required=True, choices=sorted(TRAIN_SPLIT))
    p.add_argument("--out", required=True, help="artifact path (.npz)")
    p.add_argument("--sanity-check", action="store_true")
    p.add_argument("--tr-correct", action="store_true",
                   help="int_ch/int_rel_ch: GT-track supervision variant")
    p.add_argument("--cache-workers", type=int, default=0,
                   help="thread pool size for feature precompute IO")
    p.add_argument("--text-dim", type=int, default=768)
    p.add_argument("--visual-dim", type=int, default=2048)
    p.add_argument("--text-layers", type=int, default=12)
    p.add_argument("--joint-dim", type=int, default=512)
    args = p.parse_args(argv)

    kw = {}
    if args.preset in ("int_ch", "int_rel_ch"):
        kw["tr_correct"] = args.tr_correct
    cfg = config_lib.preset(
        args.preset, data_root=args.data_root,
        sanity_check=args.sanity_check, **kw,
    ).with_dims(
        text_dim=args.text_dim, visual_dim=args.visual_dim,
        text_layers=args.text_layers, joint_dim=args.joint_dim,
    )
    train_ds, val_ds, test_ds = build_datasets(
        cfg, args.preset, workers=args.cache_workers
    )
    save_ingest(
        args.out, cfg, {"train": train_ds, "val": val_ds, "test": test_ds}
    )
    print("wrote ingest artifact: %s" % args.out)
    return args.out


def script() -> int:
    """Console-script wrapper: main() returns the artifact path for
    programmatic use; setuptools wrappers sys.exit() the return value, so
    exit 0 here (same pattern as extract_text.script)."""
    main()
    return 0


if __name__ == "__main__":
    main()
