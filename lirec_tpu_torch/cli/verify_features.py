"""Feature relocation + integrity checking
(ref `text_utils/save_contextualizied.py`; a copy of
lirec_tpu/cli/verify_features.py).

- ``copy``: move contextualized text features between storage roots,
  skipping files that already exist at the destination.
- ``check``: verify every scene's ``token2idx`` line count matches its
  embedding row count (ref save_contextualizied.py:54-73).
"""

from __future__ import annotations

import argparse
import os
import os.path as ops
import shutil
import sys

import numpy as np


def copy_features(src_root: str, dst_root: str, verbose: bool = True) -> int:
    n = 0
    for root, _dirs, files in os.walk(src_root):
        rel = ops.relpath(root, src_root)
        for filename in files:
            if not filename.endswith((".npy", ".token2idx")):
                continue
            dst_dir = ops.join(dst_root, rel)
            dst = ops.join(dst_dir, filename)
            if ops.exists(dst):
                continue
            os.makedirs(dst_dir, exist_ok=True)
            shutil.copy2(ops.join(root, filename), dst)
            n += 1
            if verbose:
                print("copied %s" % ops.join(rel, filename), file=sys.stderr)
    return n


def check_token2idx(text_root: str, verbose: bool = True):
    """Return list of (scene, n_tokens, n_rows) mismatches."""
    bad = []
    n_checked = 0
    for root, _dirs, files in os.walk(text_root):
        for filename in files:
            if not filename.endswith(".token2idx"):
                continue
            stem = filename[: -len(".token2idx")]
            npy_path = ops.join(root, stem + ".npy")
            if not ops.exists(npy_path):
                bad.append((stem, None, None))
                continue
            with open(ops.join(root, filename)) as f:
                n_tokens = sum(1 for line in f if line.strip())
            n_rows = np.load(npy_path, mmap_mode="r").shape[0]
            n_checked += 1
            if n_tokens != n_rows:
                bad.append((stem, n_tokens, int(n_rows)))
    if verbose:
        print(
            "checked %d scenes, %d mismatches" % (n_checked, len(bad)),
            file=sys.stderr,
        )
        for stem, n_tok, n_row in bad:
            print("MISMATCH %s: tokens=%s rows=%s" % (stem, n_tok, n_row),
                  file=sys.stderr)
    return bad


def main(argv=None):
    p = argparse.ArgumentParser(prog="lirec-tpu-torch verify_features")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("copy")
    pc.add_argument("--src", required=True)
    pc.add_argument("--dst", required=True)
    pk = sub.add_parser("check")
    pk.add_argument("--text-root", required=True)
    args = p.parse_args(argv)
    if args.cmd == "copy":
        return copy_features(args.src, args.dst)
    return check_token2idx(args.text_root)


if __name__ == "__main__":
    main()


def script() -> int:
    """Console-script wrapper: main() returns data for programmatic use;
    setuptools wrappers sys.exit() the return value, so exit 0 here."""
    main()
    return 0
