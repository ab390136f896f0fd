"""Disk cache for precompiled assembly plans (counterpart of
lirec_tpu/data/plan_cache.py, the same file format and gates).

`build_plan` costs ~28 s at real-data scale (21k samples) on one core —
a stub `__getitem__` pass over every sample plus Python site enumeration
(BENCH.md "host batch assembly"). The plan is a pure function of the
dataset's *index* structures (it never reads feature values), so it can
be serialized once and reloaded in ~a second by every later process:
training restarts, eval runs, benches, and CI all skip the build.

Safety model (a stale plan would silently produce wrong batches, the
exact failure class ops/dispatch.py exists to kill):

1. **Fingerprint** — blake2b over a pickle of the dataset's full state
   minus the float feature tables (whose index maps ARE hashed): every
   structure the build reads is covered. Any mismatch -> rebuild.
2. **Load-time spot check** — K samples (dynamic and static) are
   assembled through the loaded plan (native AND numpy executors) and
   compared bitwise against the per-sample `__getitem__` path. Any
   mismatch -> the cache file is discarded and the plan rebuilt.
3. Every hit/miss/reject decision is recorded via `ops.dispatch`
   (kernel "assembly_plan_cache") — never silent.

Opt out with ``LIREC_TPU_NO_PLAN_CACHE=1`` (the in-memory build path is
unchanged). Files live next to the feature cache:
``<visual_features>/cached/plans/<mode>_<fingerprint>.npz``, beside the
JAX package's. The fingerprint pickles the dataset's state, which names
its classes' modules, so the two packages' fingerprints of the same data
differ and neither finds the other's file under its own name; a file
that does reach the other package's loader is held to the same
fingerprint check and spot check (tests/test_torch_plan_cache.py).
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import uuid
from typing import Dict, Optional

import numpy as np

from lirec_tpu_torch.ops import dispatch

__all__ = ["dataset_fingerprint", "cache_path", "save_plan", "load_plan",
           "get_or_build"]

PLAN_CACHE_VERSION = 1
_VERIFY_SAMPLES = 4  # per class (dynamic / static), per executor
_MAX_BYTES = 4 * 1024**3  # the plans directory's budget before pruning


def dataset_fingerprint(ds) -> str:
    """Hash of everything plan building reads.

    The reduced state is the dataset's pickle state with the two
    float-heavy members replaced: `tables` keeps only its dims, row
    counts and key->row index maps (what `_enumerate_sites` reads);
    `features` (raw per-scene readers with float caches) is dropped —
    the packed `__getitem__` never touches raw features. `rng` is
    dropped because its consumption state is irrelevant to the plan
    (every assembly path receives explicit per-sample generators).
    """
    state = dict(ds.__getstate__())
    state.pop("rng", None)
    state.pop("features", None)
    tb = state.pop("tables", None)
    chooser = state.pop("label_chooser", None)
    reduced = {
        "version": PLAN_CACHE_VERSION,
        "state": state,
        "tables": None
        if tb is None
        else (
            tb.text_dim, tb.visual_dim, tb.track_dim,
            tb.n_clip_rows, tb.n_track_rows,
            tb._clip_index, tb._track_index,
        ),
        "chooser": "%s.%s" % (
            getattr(chooser, "__module__", ""),
            getattr(chooser, "__name__", repr(chooser)),
        ),
    }
    blob = pickle.dumps(reduced, protocol=4)
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


def cache_path(ds, fingerprint: str) -> Optional[str]:
    """Cache file location, or None when the dataset has no usable root."""
    root = getattr(getattr(ds.cfg, "paths", None), "data_root", "")
    if not root:
        return None
    base = os.path.join(
        ds.cfg.paths.visual_features, "cached", "plans"
    )
    return os.path.join(base, "%s_%s.npz" % (ds.mode, fingerprint))


def save_plan(path: str, plan, fingerprint: str) -> None:
    """Serialize `plan` atomically (temp file + rename, like
    utils.io.atomic_np_save — concurrent writers race benignly)."""
    code, prog_off, prog_idx = plan.encoded()
    sample_ids = np.fromiter(
        (i for i in sorted(prog_idx, key=prog_idx.get)),
        dtype=np.int64, count=len(prog_idx),
    )
    meta = json.dumps(
        {
            "version": PLAN_CACHE_VERSION,
            "fingerprint": fingerprint,
            "n_samples": plan.n_samples,
            "static_keys": sorted(plan.static),
        }
    )
    arrays = {
        "meta": np.frombuffer(meta.encode(), dtype=np.uint8),
        "pool": plan.pool,
        "code": code,
        "prog_off": prog_off,
        "sample_ids": sample_ids,
    }
    for k, v in plan.static.items():
        arrays["static::" + k] = v
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = "%s.tmp.%d.%s" % (path, os.getpid(), uuid.uuid4().hex[:8])
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _record(path: str, reason: str, n: int) -> None:
    dispatch.record(
        "assembly_plan_cache", path, reason, {"n_samples": n}
    )


def load_plan(path: str, fingerprint: str, ds):
    """Load, validate, and spot-check a cached plan; None on any doubt
    (callers rebuild — wrong batches are never worth 28 saved seconds)."""
    from lirec_tpu_torch.data.plan import AssemblyPlan

    n = len(ds)
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if (
                meta.get("version") != PLAN_CACHE_VERSION
                or meta.get("fingerprint") != fingerprint
                or meta.get("n_samples") != n
            ):
                _record("rebuild", "cache-mismatch", n)
                return None
            static = {
                k[len("static::"):]: z[k]
                for k in z.files
                if k.startswith("static::")
            }
            if sorted(static) != meta.get("static_keys"):
                _record("rebuild", "cache-mismatch", n)
                return None
            plan = AssemblyPlan.from_encoded(
                static, z["code"], z["prog_off"], z["sample_ids"],
                z["pool"], n,
            )
    except Exception:
        _record("rebuild", "cache-unreadable", n)
        return None
    if not _spot_check(plan, ds):
        _record("rebuild", "cache-verify-failed", n)
        try:
            os.remove(path)
        except OSError:
            pass
        return None
    _record("disk-cache", "hit+verified", n)
    try:
        os.utime(path, None)  # refresh LRU position for pruning
    except OSError:
        pass
    return plan


def _spot_check(plan, ds) -> bool:
    """Bitwise-compare K dynamic + K static samples, through BOTH
    executors, against the per-sample `__getitem__` truth."""
    from lirec_tpu_torch.data.pipeline import collate

    try:
        dyn = sorted(plan.programs)[:_VERIFY_SAMPLES]
        static_ids = [i for i in range(len(ds)) if i not in plan.programs][
            :_VERIFY_SAMPLES
        ]
        ids = np.array(dyn + static_ids, dtype=np.int64)
        if ids.size == 0:
            return True
        seed, epoch = 0, 0
        truth = collate(
            [
                ds.__getitem__(
                    int(i), np.random.default_rng((seed, epoch, int(i)))
                )
                for i in ids
            ]
        )
        # the assemble calls are INSIDE the try: a malformed-but-readable
        # blob (bad op encoding, out-of-range pool offset) must reject
        # and rebuild, not crash the caller
        for use_native in (True, False):
            got = plan.assemble(ids, seed, epoch, use_native=use_native)
            if sorted(got) != sorted(truth):
                return False
            for k in truth:
                if got[k].dtype != truth[k].dtype or not np.array_equal(
                    got[k], truth[k]
                ):
                    return False
        return True
    except Exception:
        return False


def get_or_build(ds):
    """The dataset-facing entry: cached load if possible, else build
    (+ save). Returns the plan or None (plan-incompatible dataset)."""
    from lirec_tpu_torch.data import plan as plan_lib

    # shared gate — never serve a cached plan to a dataset build_plan
    # itself would refuse
    if not plan_lib.plan_compatible(ds):
        return plan_lib.build_plan(ds)

    disabled = bool(os.environ.get("LIREC_TPU_NO_PLAN_CACHE"))
    fp = None
    if not disabled:
        try:
            fp = dataset_fingerprint(ds)
        except Exception:
            fp = None  # unpicklable custom dataset state: build in-memory
    path = cache_path(ds, fp) if fp else None
    if path and os.path.exists(path):
        plan = load_plan(path, fp, ds)
        if plan is not None:
            return plan
    plan = plan_lib.build_plan(ds)
    if plan is not None and path:
        try:
            save_plan(path, plan, fp)
            _record("disk-cache", "built+saved", len(ds))
            # plans are ~100-200 MB at real scale; stale fingerprints
            # (changed data/config) would otherwise accumulate forever
            prune(os.path.dirname(path))
        except Exception:
            _record("build", "cache-unwritable", len(ds))
    elif plan is not None:
        _record("build", "cache-disabled" if disabled else "no-cache-root",
                len(ds))
    return plan


def prune(dir_path: str, max_bytes: int = _MAX_BYTES) -> None:
    """Drop least-recently-used entries once the directory exceeds its
    budget (entries are rebuilt on the next miss; correctness unaffected).
    A copy of lirec_tpu/utils/aot_cache.prune."""
    try:
        entries = []
        for name in os.listdir(dir_path):
            if ".tmp." in name:
                continue  # another process's in-flight atomic write
            p = os.path.join(dir_path, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, p))
        total = sum(s for _, s, _ in entries)
        if total <= max_bytes:
            return
        for _, size, p in sorted(entries):
            try:
                os.remove(p)
            except OSError:
                continue
            total -= size
            if total <= max_bytes:
                break
    except OSError:
        pass
