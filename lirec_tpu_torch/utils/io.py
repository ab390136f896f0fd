"""Atomic file writes for shared feature caches.

The 2-level feature cache (data/mixed.py, data/text.py — the TPU-side
equivalent of ref mixed_features.py:55-65 `np.save` memoization) is warmed
lazily by whoever reads first. Under multi-process training every process
on a host (and every host on a shared filesystem) warms the same paths
concurrently; a plain ``np.save`` exposes partially written files to
concurrent readers (`EOFError: No data left in file`). Writing to a unique
temp file in the target directory and ``os.replace``-ing it in (atomic on
POSIX) makes the cache safe under any number of concurrent writers — the
worst case is redundant recomputation, never a torn read.
"""

from __future__ import annotations

import os
import uuid

import numpy as np

__all__ = ["atomic_np_save"]


def atomic_np_save(path: str, arr: np.ndarray) -> None:
    """``np.save`` with atomic publication (temp file + rename).

    ``path`` should carry the ``.npy`` suffix already; writing through a
    file object stops numpy from appending another one to the temp name.
    """
    tmp = "%s.tmp.%d.%s" % (path, os.getpid(), uuid.uuid4().hex[:8])
    try:
        with open(tmp, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
