"""ctypes bindings for the native ingest library, with lazy build and
graceful numpy fallback (callers check `available()`)."""

from __future__ import annotations

import ctypes
import os
from typing import List

import numpy as np

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("LIREC_TPU_NO_NATIVE"):
        return None
    try:
        from lirec_tpu_torch.native.build import build

        path = build()
        lib = ctypes.CDLL(path)
        i64, f32 = ctypes.c_int64, ctypes.c_float
        fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.roi_pool_tracks.argtypes = [
            fp, i64, i64, i64, i64, fp, i64, f32, f32, f32, fp,
        ]
        lib.temporal_max.argtypes = [fp, i64, i64, fp]
        lib.pack_rows.argtypes = [fp, i64, fp, i64, fp, i64, ip, i64, fp]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def check_width(features: np.ndarray, visual_dim: int) -> None:
    """Refuse I3D features [T, C, h, w] whose C is not `visual_dim` (a
    dataset configured for another feature width than the files have)."""
    if features.shape[1] != visual_dim:
        raise ValueError(
            "roi_pool_tracks: the features have %d channels "
            "(features.shape[1]) but visual_dim is %d; the dataset's "
            "visual_dim must be the feature files' width"
            % (features.shape[1], visual_dim))


def roi_pool_tracks(
    features: np.ndarray,
    track: List[dict],
    resolution: List[int],
    sampling_fr: float,
    visual_dim: int,
) -> np.ndarray:
    """Drop-in for data.visual.roi_pool_tracks (same semantics). The
    features' channel count must be `visual_dim`: the native op writes C
    columns per row into rows `visual_dim` wide."""
    check_width(features, visual_dim)
    lib = _load()
    feats = np.ascontiguousarray(features, dtype=np.float32)
    elems = np.array(
        [[e["x"], e["y"], e["w"], e["h"], e["frame"]] for e in track],
        dtype=np.float32,
    ).reshape(-1, 5)
    out = np.zeros((len(track), visual_dim), dtype=np.float32)
    if len(track) == 0:
        return out
    T, C, H, W = feats.shape
    lib.roi_pool_tracks(
        feats, T, C, H, W,
        np.ascontiguousarray(elems), len(track),
        float(resolution[0]), float(resolution[1]), float(sampling_fr),
        out,
    )
    return out


def temporal_max(x: np.ndarray) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.shape[1], dtype=np.float32)
    lib.temporal_max(x, x.shape[0], x.shape[1], out)
    return out


def pack_rows(
    text: np.ndarray,
    visual: np.ndarray,
    track: np.ndarray,
    idx: np.ndarray,
) -> np.ndarray:
    lib = _load()
    text = np.ascontiguousarray(text, dtype=np.float32)
    visual = np.ascontiguousarray(visual, dtype=np.float32)
    track = np.ascontiguousarray(track, dtype=np.float32)
    flat_idx = np.ascontiguousarray(idx.reshape(-1, 3), dtype=np.int32)
    n = flat_idx.shape[0]
    row_dim = text.shape[1] + visual.shape[1] + 2 * track.shape[1]
    out = np.empty((n, row_dim), dtype=np.float32)
    lib.pack_rows(
        text, text.shape[1], visual, visual.shape[1], track, track.shape[1],
        flat_idx, n, out,
    )
    return out.reshape(idx.shape[:-1] + (row_dim,))


# ------------------------------------------------- batch-assembly engine

_asm_lib = None
_asm_tried = False


def _load_assembly():
    global _asm_lib, _asm_tried
    if _asm_tried:
        return _asm_lib
    _asm_tried = True
    if os.environ.get("LIREC_TPU_NO_NATIVE"):
        return None
    try:
        from lirec_tpu_torch.native.build import build_assembly

        lib = ctypes.CDLL(build_assembly())
        i64, u32 = ctypes.c_int64, ctypes.c_uint32
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.assemble_epoch.argtypes = [
            i64p, i64p, i64p, u32p, i64, u32, u32, i32p,
            i32p, i64, i32p, i64, i32p, i64, i32p, i64, i32p, i64,
        ]
        lib.assemble_epoch.restype = ctypes.c_int
        lib.rng_selftest.argtypes = [
            u32, u32, u32, i64, u64p, i64, i64, i64p, i64, i64, i64p,
        ]
        _asm_lib = lib
    except Exception:
        _asm_lib = None
    return _asm_lib


def assembly_available() -> bool:
    return _load_assembly() is not None


def assemble_epoch(
    code: np.ndarray,
    prog_off: np.ndarray,
    pos: np.ndarray,
    sample_id: np.ndarray,
    seed: int,
    epoch: int,
    pool: np.ndarray,
    outs,
    strides,
) -> None:
    """Run the site programs for one epoch's dynamic samples (data/plan.py)."""
    lib = _load_assembly()
    args = [
        np.ascontiguousarray(code, np.int64),
        np.ascontiguousarray(prog_off, np.int64),
        np.ascontiguousarray(pos, np.int64),
        np.ascontiguousarray(sample_id, np.uint32),
        len(pos), seed, epoch,
        np.ascontiguousarray(pool, np.int32),
    ]
    for a, s in zip(outs, strides):
        assert a.dtype == np.int32 and a.flags.c_contiguous
        args.extend([a, int(s)])
    rc = lib.assemble_epoch(*args)
    if rc != 0:
        raise RuntimeError("native assembly engine failed (rc=%d)" % rc)


def rng_selftest(
    seed: int, epoch: int, i: int, n_raw: int, n_int: int, int_bound: int,
    choice_pop: int, choice_k: int,
):
    """Raw draw chain from the native engine, for fuzzing against numpy."""
    lib = _load_assembly()
    raw = np.zeros(max(n_raw, 1), np.uint64)
    ints = np.zeros(max(n_int, 1), np.int64)
    ch = np.zeros(max(choice_k, 1), np.int64)
    lib.rng_selftest(
        seed, epoch, i, n_raw, raw, n_int, int_bound, ints,
        choice_pop, choice_k, ch,
    )
    return raw[:n_raw], ints[:n_int], ch[:choice_k]
