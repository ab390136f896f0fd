"""Batch-local feature-table projection (train-path FLOP dedup).

At real-split cardinality the hybrid train path's table-level first
layers (models/hybrid.project_tables) dominate the step: every step runs
the first-layer GEMMs over ALL deduplicated table rows (12k clip / 25k
track rows at real scale — ~550 GFLOP fwd+bwd ≈ 3 ms of the 7.6 ms
step), yet a B=64 batch references only the rows its samples touch: a
sample's track rows come from its few character names and its context
clips from per-(pair, rel) pools (ref classification_dataloader.py:
291-616 via data/dataset.py).

Localizing a batch — gathering the unique raw rows once on device and
remapping ``feat_idx`` to local slots — makes the table-MLP GEMMs, their
backward weight-grad GEMMs, and the scatter-accumulate VJP all run at
batch-unique size instead of table size. Per-row math is unchanged
(row-independent GEMMs) and the dropout stream is untouched (masks are
drawn post-gather in per-use order, models/hybrid.py), so the training
trajectory matches the full-table path to float tolerance
(tests/test_localize.py). Measured: real-scale train 7.63 → 4.63 ms/step,
cardinality-independent from there (BENCH.md).

Host cost: one bitmap pass per batch (~1 ms at B=64 — NOT np.unique's
sort), overlapped with the async epoch-sweep dispatch like the rest of
batch assembly. Capacities are static per compiled program: unique
counts are padded to rounded capacities that only grow (monotonic across
epochs — at most a handful of recompiles per run), and localization
auto-disables when the batch-unique rows are not meaningfully smaller
than the tables (the profitability gate below), so toy-scale runs keep
the plain path.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "Localizer", "localize_batch", "batch_unique_counts",
    "localize_eval_ctx", "localize_eval_ctx_triples",
]

# pad capacities to multiples of this (static shapes; avoids a recompile
# per epoch when the max unique count wobbles)
_ROUND = 256
# localize only when the batch-unique first-layer work is at most this
# fraction of the full-table work (below that, the extra raw-row gather
# isn't worth the bookkeeping)
_PROFIT_FRAC = 0.75


def _round_up(n: int, cap: int) -> int:
    return min(int(np.ceil(max(n, 1) / _ROUND)) * _ROUND, cap)


def _unique_remap(ids: np.ndarray, n_rows: int):
    """(sorted unique ids, ids remapped to their unique-list slots).

    Bitmap-based: O(n_rows + ids.size) vectorized passes instead of
    np.unique's sort — ~6x faster at the real-scale batch shape, and this
    runs on the host for every train batch."""
    present = np.zeros(n_rows, bool)
    flat = ids.ravel()
    present[flat] = True
    uniq = np.flatnonzero(present).astype(np.int32)
    remap = np.empty(n_rows, np.int32)
    remap[uniq] = np.arange(uniq.size, dtype=np.int32)
    return uniq, remap[flat].reshape(ids.shape)


def _analyze(batch: Dict, n_clips: int, n_tracks: int):
    """One pass: (uniq_clip, uniq_track, remapped feat_idx) — unpadded."""
    fi = np.asarray(batch["feat_idx"])
    uc, inv_c = _unique_remap(fi[..., 0], n_clips)
    ut, inv_t = _unique_remap(fi[..., 1:], n_tracks)
    nfi = np.empty_like(fi, dtype=np.int32)
    nfi[..., 0] = inv_c
    nfi[..., 1:] = inv_t
    return uc, ut, nfi


def batch_unique_counts(batch: Dict) -> tuple:
    """(n_unique_clip, n_unique_track) for one host batch."""
    fi = np.asarray(batch["feat_idx"])
    return (
        int(np.unique(fi[..., 0]).size),
        int(np.unique(fi[..., 1:]).size),
    )


def localize_batch(batch: Dict, cap_clip: int, cap_track: int,
                   n_clips: Optional[int] = None,
                   n_tracks: Optional[int] = None) -> Optional[Dict]:
    """Remap one host batch's feat_idx to batch-local table slots.

    Returns a new batch with ``feat_idx`` pointing into ``uniq_clip``
    [cap_clip] / ``uniq_track`` [cap_track] (padded with row 0), or None
    if the unique counts exceed the capacities (caller grows and retries).
    """
    fi = np.asarray(batch["feat_idx"])
    uc, ut, nfi = _analyze(
        batch,
        int(fi[..., 0].max()) + 1 if n_clips is None else n_clips,
        int(fi[..., 1:].max()) + 1 if n_tracks is None else n_tracks,
    )
    if uc.size > cap_clip or ut.size > cap_track:
        return None
    return _emit(batch, nfi, uc, ut, cap_clip, cap_track)


def _emit(batch, nfi, uc, ut, cap_clip, cap_track) -> Dict:
    out = dict(batch)
    out["feat_idx"] = nfi
    out["uniq_clip"] = _pad_ids(uc, cap_clip)
    out["uniq_track"] = _pad_ids(ut, cap_track)
    return out


def _pad_ids(ids: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros(cap, np.int32)
    out[: ids.size] = ids
    return out


def localize_eval_ctx(feat_idx: np.ndarray, batch_size: int, n_full: int,
                      n_clips: int, n_tracks: int):
    """Per-batch ctx-row localization for the packed EVAL sweep.

    The fused ctx kernel (ops/gather_pool.fused_ctx_pool) is ~2.7x faster
    when the embedded ctx tables are VMEM-resident; past real-split
    cardinality they are not, and eval drops to the HBM-DMA tier. But a
    batch's CONTEXT slots (feat_idx[..., 1:, :] — slot 0 is the ints/GT
    row and stays global) reference only a few thousand unique rows, and
    the eval split is FIXED — so the per-batch unique sets are computed
    once here, and the sweep gathers each batch's rows into a small local
    table the kernel keeps in VMEM at ANY table cardinality
    (evaluation/packed.py wires it; models/factory.py applies it).

    feat_idx: [N, (T,) 1+R, 3] int32 over the whole split. Returns
    (new_feat_idx, uniq_clip [n_full, cap_c], uniq_track [n_full, cap_t])
    where new_feat_idx's slots 1..R are remapped to local-table positions
    for the first ``n_full * batch_size`` samples (tail rows untouched —
    the ragged tail runs the plain path). Unique sets are computed over
    every id present (padding included), so each remapped id is < cap.
    """
    fi = np.array(feat_idx, dtype=np.int32)  # copy: slots 1..R rewritten
    ucs, uts = [], []
    for b in range(n_full):
        rows = fi[b * batch_size : (b + 1) * batch_size]
        ctx = rows[..., 1:, :]
        uc, inv_c = _unique_remap(ctx[..., 0], n_clips)
        ut, inv_t = _unique_remap(ctx[..., 1:], n_tracks)
        ctx[..., 0] = inv_c
        ctx[..., 1:] = inv_t
        ucs.append(uc)
        uts.append(ut)
    cap_c = max(1, -(-max(u.size for u in ucs) // 8) * 8)
    cap_t = max(1, -(-max(u.size for u in uts) // 8) * 8)
    return (
        fi,
        np.stack([_pad_ids(u, cap_c) for u in ucs]),
        np.stack([_pad_ids(u, cap_t) for u in uts]),
    )


def localize_eval_ctx_triples(feat_idx: np.ndarray, batch_size: int,
                              n_full: int, n_tracks: int):
    """Per-batch (clip, tr1, tr2) TRIPLE dedup for the eval sweep.

    The per-table localization above still leaves the fused ctx kernel
    issuing THREE dynamic row gathers per context entry, and the r4-final
    trace showed the VMEM tier is gather-ISSUE-bound (225 us/batch vs an
    86 us packed-bytes roofline). Deduplicating whole index triples lets
    the sweep gather each batch's unique FUSED rows [clip|tr1|tr2] into
    one local table (models/factory.apply_model) and the kernel
    (ops/gather_pool.fused_ctx_pool_triple) issue ONE gather per entry.

    feat_idx: [N, (T,) 1+R, 3] int32 over the whole split (slot 0 is the
    ints/GT row and stays global; it is NOT rewritten here). Returns
    (ctx_tidx [N, (T,) R] int32 — triple-table positions for the first
    ``n_full * batch_size`` rows, zeros for the ragged tail, which runs
    the plain path — and triples [n_full, cap_u, 3] int32, zero-padded).
    Unique sets include masked/padding entries, so every tidx is < cap_u.
    """
    fi = np.asarray(feat_idx)
    R = fi.shape[-2] - 1
    tidx = np.zeros(fi.shape[:-2] + (R,), np.int32)
    nt = np.int64(n_tracks)
    tris = []
    for b in range(n_full):
        rows = fi[b * batch_size : (b + 1) * batch_size][..., 1:, :]
        rows = rows.astype(np.int64)
        key = (rows[..., 0] * nt + rows[..., 1]) * nt + rows[..., 2]
        uniq, inv = np.unique(key, return_inverse=True)
        tidx[b * batch_size : (b + 1) * batch_size] = inv.reshape(
            key.shape
        ).astype(np.int32)
        tris.append(
            np.stack(
                [
                    (uniq // (nt * nt)).astype(np.int32),
                    ((uniq // nt) % nt).astype(np.int32),
                    (uniq % nt).astype(np.int32),
                ],
                axis=-1,
            )
        )
    cap = max(1, -(-max(t.shape[0] for t in tris) // 8) * 8)
    triples = np.zeros((n_full, cap, 3), np.int32)
    for b, t in enumerate(tris):
        triples[b, : t.shape[0]] = t
    return tidx, triples


class Localizer:
    """Stateful per-run localization: measures capacities from the data,
    grows them monotonically, and applies the profitability gate once
    per growth against the table cardinalities."""

    def __init__(self, spec, n_clips: int, n_tracks: int,
                 force: Optional[bool] = None):
        self.cap_clip = 0
        self.cap_track = 0
        self.n_clips = int(n_clips)
        self.n_tracks = int(n_tracks)
        # FLOP weight of one table row in the first-layer GEMMs: the clip
        # row feeds the txt+vis MLPs, a track row feeds the two track MLPs
        self._w_clip = int(spec.text_dim) + int(spec.visual_dim)
        self._w_track = 2 * int(spec.track_dim)
        self.force = force
        self.enabled = force is not False
        self.applied = False  # any batch localized this run (telemetry)

    def _profitable(self) -> bool:
        if self.force is True:
            return True
        local = self.cap_clip * self._w_clip + self.cap_track * self._w_track
        full = self.n_clips * self._w_clip + self.n_tracks * self._w_track
        return local < _PROFIT_FRAC * full

    def maybe_localize(self, batches: List[Dict]) -> List[Dict]:
        """Localize an epoch's batches, or return them unchanged when
        disabled/unprofitable. All batches of a call share the current
        capacities (uniform stacked shapes for the epoch sweep)."""
        from lirec_tpu_torch.ops import dispatch
        from lirec_tpu_torch.utils.profiling import span

        if not self.enabled or not batches or "feat_idx" not in batches[0]:
            return batches
        with span("lirec.localize"):
            # single analysis pass per batch; padding waits for the
            # capacities
            infos = [_analyze(b, self.n_clips, self.n_tracks)
                     for b in batches]
            mc = max((uc.size for uc, _, _ in infos), default=1)
            mt = max((ut.size for _, ut, _ in infos), default=1)
            self.cap_clip = max(self.cap_clip, _round_up(mc, self.n_clips))
            self.cap_track = max(self.cap_track,
                                 _round_up(mt, self.n_tracks))
            shapes = {
                "caps": (self.cap_clip, self.cap_track),
                "tables": (self.n_clips, self.n_tracks),
            }
            if not self._profitable():
                if self.force is not True:
                    # cardinality won't shrink; stop measuring
                    self.enabled = False
                dispatch.record(
                    "localize_tables", "off",
                    "batch-unique rows not under %.0f%% of table rows"
                    % (100 * _PROFIT_FRAC), shapes,
                )
                return batches
            out = [
                _emit(b, nfi, uc, ut, self.cap_clip, self.cap_track)
                for b, (uc, ut, nfi) in zip(batches, infos)
            ]
            self.applied = True
            dispatch.record(
                "localize_tables", "on",
                "forced" if self.force is True else "profitable", shapes,
            )
            return out
