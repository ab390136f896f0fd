"""Whole-epoch batch assembly: precompiled sample plans + exact PRNG replay.

`InteractionDataset.__getitem__` (the reference per-sample hot path, ref
`mixed_utils/classification_dataloader.py:291-616`) costs ~0.1 ms/sample of
Python — at real-data scale that exceeds the device train step per epoch
(BENCH.md "host-side epoch assembly"). The key observation: per epoch, the
only *data-dependent* content in a sample is driven by a handful of PRNG
draws (multi-label relationship choices, `rng.choice` context subsampling);
everything else is a pure function of the dataset, computable ONCE.

This module compiles each sample into a static base (stacked arrays over
all samples) plus a small "site program": an ordered list of draw sites,
each with one precomputed patch per possible outcome. Epoch assembly is
then one bulk fancy-index over the base plus patch execution for the
dynamic samples only — in C++ (native/assembly.cpp, a bit-exact
reimplementation of numpy's SeedSequence->PCG64->Generator draw chain) or
in a numpy fallback executor. Both produce *bitwise-identical* batches to
the per-sample Python path under the `(seed, epoch, i)` per-sample stream
contract (tests/test_assembly_plan.py), so the fast path is default-on.

Supported: any cached dataset whose `label_chooser` is the default
`random_choice` and whose per-sample control flow matches the reference's
(anything else returns None and callers keep the per-sample path).
"""

from __future__ import annotations

from itertools import permutations
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["AssemblyPlan", "build_plan", "plan_compatible"]

# patchable output arrays, by fixed id (order matters for the C++ ABI)
PATCH_ARRAYS = ("feat_idx", "labels", "rels_label", "rels_mask", "hash_rel")
OP_SET, OP_BLOCK, OP_GATHER = 0, 1, 2


class _StubRng:
    """Deterministic stand-in Generator for the static base build: always
    picks outcome 0 / the identity context subset. Regions it influences
    are exactly the dynamic-site regions, all fully overwritten by patches."""

    def integers(self, n):
        return 0

    def choice(self, n, size, replace=True):
        assert not replace
        return np.arange(size)


class _Site:
    """One draw site: `L` label outcomes (draw iff L > 1), each outcome a
    (choice_length, ops) pair; ops fully overwrite the site's region."""

    __slots__ = ("L", "outcomes")

    def __init__(self, L: int, outcomes: List[Tuple[int, List[tuple]]]):
        self.L = L
        self.outcomes = outcomes


class _PoolBuilder:
    """Deduplicating int32 constant pool (blocks + gather row tables)."""

    def __init__(self):
        self.chunks: List[np.ndarray] = []
        self.offset = 0
        self._memo: Dict[bytes, int] = {}
        # per-dict_key caches: the same (movie, ch1, ch2[, rel]) context
        # list is visited by MANY sites — converting/hashing it once cuts
        # plan-build time ~2x at 20k-sample scale
        self.ctx_arrays: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}
        self.ctx_offsets: Dict[Tuple, int] = {}

    def add(self, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr, dtype=np.int32).ravel()
        key = arr.tobytes()
        off = self._memo.get(key)
        if off is None:
            off = self.offset
            self._memo[key] = off
            self.chunks.append(arr)
            self.offset += arr.size
        return off

    def add_rows(self, dict_key, rows_i32: np.ndarray) -> int:
        off = self.ctx_offsets.get(dict_key)
        if off is None:
            off = self.add(rows_i32)
            self.ctx_offsets[dict_key] = off
        return off

    def rows_gts(self, ds, dict_key, rows, gts):
        ent = self.ctx_arrays.get(dict_key)
        if ent is None:
            n = len(rows)
            ent = (
                np.asarray(rows, np.int32).reshape(n, 3)
                if n else np.zeros((0, 3), np.int32),
                np.asarray(gts, np.int32).reshape(-1),
            )
            self.ctx_arrays[dict_key] = ent
        return ent

    def finalize(self) -> np.ndarray:
        if not self.chunks:
            return np.zeros(1, np.int32)
        return np.concatenate(self.chunks)


class _LazyPrograms:
    """Mapping sample-id -> site list, decoded on demand from the flat
    int64 `encoded()` blob (disk-cached plans skip the Python build
    entirely; the numpy executor is the only consumer that needs decoded
    sites, and it only ever asks for the samples it touches)."""

    def __init__(self, code: np.ndarray, prog_off: np.ndarray,
                 sample_ids: np.ndarray):
        self._code = code
        self._off = {int(i): int(o) for i, o in zip(sample_ids, prog_off)}
        self._decoded: Dict[int, List[_Site]] = {}

    def __contains__(self, i) -> bool:
        return i in self._off

    def __len__(self) -> int:
        return len(self._off)

    def __iter__(self):
        return iter(self._off)

    def __getitem__(self, i: int) -> List[_Site]:
        sites = self._decoded.get(i)
        if sites is None:
            sites = _decode_sample(self._code, self._off[i])
            self._decoded[i] = sites
        return sites


_OP_LEN = {OP_SET: 4, OP_BLOCK: 5, OP_GATHER: 6}


def _decode_sample(code: np.ndarray, p: int) -> List[_Site]:
    """Inverse of `AssemblyPlan.encoded()` for one sample's blob."""
    sites: List[_Site] = []
    n_sites = int(code[p])
    p += 1
    for _ in range(n_sites):
        header = p
        L = int(code[p])
        n_outc = int(code[p + 1])
        end_rel = int(code[p + 2])
        outcomes: List[Tuple[int, List[tuple]]] = []
        for oi in range(n_outc):
            q = header + int(code[p + 3 + oi])
            choice_len = int(code[q])
            n_ops = int(code[q + 1])
            q += 2
            ops: List[tuple] = []
            for _ in range(n_ops):
                ln = _OP_LEN[int(code[q])]
                ops.append(tuple(int(x) for x in code[q : q + ln]))
                q += ln
            outcomes.append((choice_len, ops))
        sites.append(_Site(L, outcomes))
        p = header + end_rel
    return sites


class AssemblyPlan:
    def __init__(
        self,
        static: Dict[str, np.ndarray],
        programs,
        pool: np.ndarray,
        strides: Dict[str, int],
        n_samples: int,
    ):
        self.static = static
        self.programs = programs  # sample idx -> site list (dict or lazy)
        self.pool = pool
        self.strides = strides  # flat int32 elements per sample, per array
        self.n_samples = n_samples
        self._encoded = None
        self.last_engine = None  # 'native' | 'numpy' (observability)

    @classmethod
    def from_encoded(
        cls,
        static: Dict[str, np.ndarray],
        code: np.ndarray,
        prog_off: np.ndarray,
        sample_ids: np.ndarray,
        pool: np.ndarray,
        n_samples: int,
    ) -> "AssemblyPlan":
        """Rebuild a plan from its serialized arrays (data/plan_cache.py)
        without re-running the Python site enumeration."""
        strides = {
            k: int(np.prod(static[k].shape[1:], dtype=np.int64))
            for k in PATCH_ARRAYS
            if k in static
        }
        plan = cls(
            static,
            _LazyPrograms(code, prog_off, sample_ids),
            pool,
            strides,
            n_samples,
        )
        plan._encoded = (
            np.ascontiguousarray(code, dtype=np.int64),
            np.ascontiguousarray(prog_off, dtype=np.int64),
            {int(i): n for n, i in enumerate(sample_ids)},
        )
        return plan

    @property
    def n_dynamic(self) -> int:
        return len(self.programs)

    # -- epoch assembly ----------------------------------------------------

    def assemble(
        self, order: np.ndarray, seed, epoch, use_native: bool = True
    ) -> Dict[str, np.ndarray]:
        """Assemble the epoch's samples (in `order`) into stacked arrays,
        bitwise-identical to
        ``collate([ds[i, default_rng((seed, epoch, i))] for i in order])``."""
        order = np.asarray(order, dtype=np.int64)
        out = {k: v[order] for k, v in self.static.items()}
        dyn = [
            (pos, int(i))
            for pos, i in enumerate(order)
            if int(i) in self.programs
        ]
        if not dyn:
            self.last_engine = "static"
            return out
        # by array id (PATCH_ARRAYS order); absent arrays stay None
        flat = [
            out[k].reshape(len(order), -1) if k in out else None
            for k in PATCH_ARRAYS
        ]
        if (
            use_native
            and _native_ok()
            and _u32_ok(seed)
            and _u32_ok(epoch)
        ):
            self._run_native(flat, dyn, int(seed), int(epoch))
            self.last_engine = "native"
        else:
            self._run_numpy(flat, dyn, seed, epoch)
            self.last_engine = "numpy"
        return out

    def assemble_with_rng(
        self, order: np.ndarray, rng: np.random.Generator
    ) -> Dict[str, np.ndarray]:
        """Shared-generator assembly: bitwise-identical to
        ``collate([ds[i, rng] for i in order])`` — the `materialize()`
        contract, where ONE generator chains through samples in order
        (static samples consume no draws, so only dynamic ones step it)."""
        order = np.asarray(order, dtype=np.int64)
        out = {k: v[order] for k, v in self.static.items()}
        dyn = [
            (pos, int(i))
            for pos, i in enumerate(order)
            if int(i) in self.programs
        ]
        if dyn:
            flat = [
                out[k].reshape(len(order), -1) if k in out else None
                for k in PATCH_ARRAYS
            ]
            self._run_numpy(flat, dyn, None, None, shared_rng=rng)
            self.last_engine = "numpy-chained"
        else:
            self.last_engine = "static"
        return out

    # -- numpy executor ----------------------------------------------------

    def _run_numpy(self, flat, dyn, seed, epoch, shared_rng=None) -> None:
        pool = self.pool
        for pos, i in dyn:
            rng = shared_rng or np.random.default_rng((seed, epoch, i))
            for site in self.programs[i]:
                k = int(rng.integers(site.L)) if site.L > 1 else 0
                choice_len, ops = site.outcomes[k]
                chosen = (
                    rng.choice(choice_len, _nrows(ops), replace=False)
                    if choice_len
                    else None
                )
                for op in ops:
                    kind = op[0]
                    if kind == OP_SET:
                        _, arr, off, val = op
                        flat[arr][pos, off] = val
                    elif kind == OP_BLOCK:
                        _, arr, off, poff, cnt = op
                        flat[arr][pos, off : off + cnt] = pool[
                            poff : poff + cnt
                        ]
                    else:  # OP_GATHER: chosen rows from the site row table
                        _, arr, off, poff, rowlen, nrows = op
                        idx = (
                            (chosen[:, None] * rowlen
                             + np.arange(rowlen)[None, :])
                            .ravel()
                        )
                        flat[arr][
                            pos, off : off + nrows * rowlen
                        ] = pool[poff + idx]

    # -- native executor ---------------------------------------------------

    def encoded(self):
        """Flat int64 encoding of the site programs (for the C++ engine).

        Layout per sample: [n_sites, site...]; site: [L, n_outc,
        end_rel, outc_rel_off_0..n-1] then the outcome blobs; outcome:
        [choice_len, n_ops, ops...]; ops: SET[kind,arr,off,val],
        BLOCK[kind,arr,off,pool_off,count],
        GATHER[kind,arr,off,pool_off,rowlen,nrows]."""
        if self._encoded is not None:
            return self._encoded
        code: List[int] = []
        sample_ids = sorted(self.programs)
        prog_off = []
        for i in sample_ids:
            prog_off.append(len(code))
            sites = self.programs[i]
            code.append(len(sites))
            for site in sites:
                n_outc = len(site.outcomes)
                header_at = len(code)
                code.append(site.L)
                code.append(n_outc)
                code.append(0)  # end_rel backpatch
                off_slots = len(code)
                code.extend([0] * n_outc)
                for oi, (choice_len, ops) in enumerate(site.outcomes):
                    code[off_slots + oi] = len(code) - header_at
                    code.append(choice_len)
                    code.append(len(ops))
                    for op in ops:
                        code.extend(op)
                code[header_at + 2] = len(code) - header_at
        self._encoded = (
            np.array(code, dtype=np.int64),
            np.array(prog_off, dtype=np.int64),
            {i: n for n, i in enumerate(sample_ids)},
        )
        return self._encoded

    def _run_native(self, flat, dyn, seed: int, epoch: int) -> None:
        from lirec_tpu_torch.native import bindings

        code, prog_off, prog_idx = self.encoded()
        pos_arr = np.array([p for p, _ in dyn], dtype=np.int64)
        sid_arr = np.array([i for _, i in dyn], dtype=np.uint32)
        poff_arr = np.array(
            [prog_off[prog_idx[i]] for _, i in dyn], dtype=np.int64
        )
        ptrs, strides = [], []
        for a in flat:
            if a is None:
                a = np.zeros((1, 1), np.int32)
                strides.append(0)
            else:
                assert a.dtype == np.int32 and a.flags.c_contiguous
                strides.append(a.shape[1])
            ptrs.append(a)
        bindings.assemble_epoch(
            code, poff_arr, pos_arr, sid_arr, seed, epoch,
            self.pool, ptrs, strides,
        )


def _nrows(ops) -> int:
    for op in ops:
        if op[0] == OP_GATHER:
            return op[5]
    raise AssertionError("choice outcome without a gather op")


def _u32_ok(v) -> bool:
    try:
        return 0 <= int(v) < 2**32
    except (TypeError, ValueError):
        return False


def _native_ok() -> bool:
    from lirec_tpu_torch.native import bindings

    return bindings.assembly_available()


# ---------------------------------------------------------------- builder


def _collate_prealloc(ds, stub) -> Dict[str, np.ndarray]:
    """collate() semantics over the whole split without its two extra
    copies: at 20k+ samples `np.stack` of per-sample arrays plus the
    dtype `astype` dominated plan build (27.4 of 44.9 s profiled —
    stack re-copies everything, astype copies it again). Preallocating
    the [n, ...] arrays at their FINAL dtype and assigning per sample
    casts on write: one copy total. Dtype rules match collate exactly
    (bool stays bool, any int -> int32, anything else -> float32)."""
    n = len(ds)
    first = ds.__getitem__(0, stub)
    out: Dict[str, np.ndarray] = {}
    for key, val in first.items():
        val = np.asarray(val)
        dt = (
            np.bool_ if val.dtype == bool
            else np.int32 if val.dtype.kind in "iu"
            else np.float32
        )
        out[key] = np.empty((n,) + val.shape, dt)
        out[key][0] = val
    nkeys = len(out)
    for i in range(1, n):
        sample = ds.__getitem__(i, stub)
        # collate() raised on any per-sample surprise (missing key, shape
        # mismatch) and build_plan fell back to the per-sample path; a
        # silent np.empty row of garbage must never replace that, so the
        # guards stay explicit (broadcast assignment would accept scalars)
        if len(sample) != nkeys:
            raise KeyError(
                "sample %d keys %s != sample 0 keys %s"
                % (i, sorted(sample), sorted(out))
            )
        for key, val in sample.items():
            if np.shape(val) != out[key].shape[1:]:
                raise ValueError(
                    "sample %d key %r shape %s != %s"
                    % (i, key, np.shape(val), out[key].shape[1:])
                )
            out[key][i] = val
    return out


def plan_compatible(ds) -> bool:
    """Static gate shared by build_plan and the disk cache
    (data/plan_cache.py): a cached plan must never be served to a
    dataset the builder itself would refuse."""
    from lirec_tpu_torch.data.dataset import random_choice

    return (
        getattr(ds, "_cached", False)
        and not getattr(ds, "test_rels_multi_clip", False)
        and ds.label_chooser is random_choice
        and len(ds) > 0
    )


def build_plan(ds) -> Optional[AssemblyPlan]:
    """Compile `ds` into an AssemblyPlan, or None when the dataset's
    assembly isn't plan-compatible (non-default label chooser,
    test_rels_multi_clip mode, uncached, or any per-sample surprise —
    callers then keep the per-sample path)."""
    if not plan_compatible(ds):
        return None
    try:
        stub = _StubRng()
        base = _collate_prealloc(ds, stub)
        pool = _PoolBuilder()
        programs: Dict[int, List[_Site]] = {}
        for i in range(len(ds)):
            sites = _enumerate_sites(ds, i, pool)
            if sites:
                programs[i] = sites
        strides = {
            k: int(np.prod(base[k].shape[1:], dtype=np.int64))
            for k in PATCH_ARRAYS
            if k in base
        }
        plan = AssemblyPlan(base, programs, pool.finalize(), strides, len(ds))
        plan.encoded()
        # building touched millions of temporaries; collect NOW so the
        # first assembled epochs don't absorb a multi-second gen2 GC pass
        # over the (large, long-lived) dataset + plan object graphs
        import gc

        gc.collect()
        return plan
    except Exception:
        return None


def _context_outcome(
    ds, dict_key, rows, gts, pool: _PoolBuilder, row0, gt0,
    with_gt: bool,
) -> Tuple[int, np.ndarray, Optional[np.ndarray], np.ndarray, Optional[int]]:
    """Mirror `_context_indices` content for one resolved outcome.

    Returns (choice_len, feat_block, gt_block, mask, rows_pool_off):
    choice_len == 0 -> static feat_block/gt_block; else the caller emits a
    GATHER from rows_pool_off (and gt gather) with row 0 set separately.
    """
    R = ds.rels_n_clips
    length = len(rows)
    rows_i32, gts_i32 = pool.rows_gts(ds, dict_key, rows, gts)
    if length > R and ds.mode == "train":
        return (
            length, None, None, np.ones(R, np.int32),
            pool.add_rows(dict_key, rows_i32),
        )
    feat = np.zeros((R + 1, 3), np.int32)
    gt = np.zeros(R + 1, np.int32)
    mask = np.zeros(R, np.int32)
    if length:
        if length <= R:
            mask[:length] = 1
            feat[1 : length + 1] = rows_i32
            gt[1 : length + 1] = gts_i32
        else:  # eval: fixed stride
            chosen = (
                ds.context_idxs[dict_key]
                if len(dict_key) == 4
                else ds.context_idxs_none[dict_key]
            )
            feat[1:] = rows_i32[chosen]
            gt[1:] = gts_i32[chosen]
            mask[:] = 1
    feat[0] = row0
    gt[0] = gt0
    return 0, feat, (gt if with_gt else None), mask, None


def _gts_for(ds, dict_key) -> np.ndarray:
    if dict_key is None:
        return np.zeros(0, np.int64)
    return (
        ds.movie_ch1_ch2_rel_inter[dict_key]
        if len(dict_key) == 4
        else ds.movie_ch1_ch2_none_inter[dict_key]
    )


def _enumerate_sites(ds, idx_pair: int, pool: _PoolBuilder) -> List[_Site]:
    """Mirror `InteractionDataset.__getitem__`'s draw sites for one sample,
    in exact rng-consumption order (dataset.py:510-737)."""
    t = ds.cfg.tasks
    R = ds.rels_n_clips
    idx, triplet_idx = ds.idxs_with_triplets[idx_pair]
    inter = ds.interactions[idx]
    movie_idx = inter.video_descr["movie"]
    scene_idx = inter.video_descr["scene"][0]
    clip_row = ds.tables.clip_row(idx)
    sites: List[_Site] = []

    if not (ds.tracks and len(inter.triplets)):
        return sites
    if not t.rels_multitask:
        return sites  # no draws anywhere (int_ch / modalities presets)

    gt_tr = [0, 0]
    for positional_idx, track_name in inter.triplets[triplet_idx].items():
        gt_tr[0 if positional_idx == 0 else 1] = ds.tables.track_row(
            (idx, track_name)
        )

    tr_max = bool(t.tr_maximize)
    # flat int32 offsets per patch array (collate shapes):
    #  tr_max: feat_idx [H, R+1, 3], rels_label [H], rels_mask [H, R]
    #  int_rels: feat_idx [R+1, 3], labels [R+1, 1], rels_label scalar,
    #            rels_mask [R, 1]
    def feat_off(h):
        return h * (R + 1) * 3 if tr_max else 0

    def mask_off(h):
        return h * R if tr_max else 0

    # -- GT site (dataset.py:557-601) -----------------------------------
    labels_list = inter.relships.get(triplet_idx)
    gt_outcomes: List[Tuple[int, List[tuple]]] = []
    names = (
        labels_list if labels_list else ["None"]
    )  # _choose: falsy -> "None", no draw
    L = len(names)
    gt_dynamic = L > 1
    for rel_name in names:
        rels_label = ds.rels2idx[rel_name]
        ops: List[tuple] = [(OP_SET, 2, 0, rels_label)]
        choice_len = 0
        if t.rels_multi_clip:
            if len(inter.triplets[triplet_idx]) == 2:
                name1 = inter.triplets[triplet_idx][0]
                name2 = inter.triplets[triplet_idx][1]
                if rel_name == "None":
                    ops.append((OP_SET, 4, 0, -1))  # hash_rel
                    dict_key = (movie_idx, name1, name2)
                    rows = ds.movie_ch1_ch2_none[dict_key]
                    if len(rows) == 0:
                        # GT row is its own context (dataset.py:570-578)
                        feat = np.zeros((R + 1, 3), np.int32)
                        mask = np.zeros(R, np.int32)
                        mask[0] = 1
                        feat[1] = (clip_row, gt_tr[0], gt_tr[1])
                        gt = np.zeros(R + 1, np.int32)
                        gt[1] = _label_of(ds, inter)
                        feat[0] = (clip_row, gt_tr[0], gt_tr[1])
                        gt[0] = _label_of(ds, inter)
                        spec = (0, feat, gt, mask, None)
                    else:
                        spec = _context_outcome(
                            ds, dict_key, rows, _gts_for(ds, dict_key),
                            pool,
                            (clip_row, gt_tr[0], gt_tr[1]),
                            _label_of(ds, inter), True,
                        )
                else:
                    dict_key = (movie_idx, name1, name2, rel_name)
                    ops.append(
                        (OP_SET, 4, 0, ds.hashidx_rels[dict_key])
                    )
                    spec = _context_outcome(
                        ds, dict_key, ds.movie_ch1_ch2_rel[dict_key],
                        _gts_for(ds, dict_key), pool,
                        (clip_row, gt_tr[0], gt_tr[1]),
                        _label_of(ds, inter), True,
                    )
                choice_len = _emit_gt_context(
                    ds, pool, ops, spec, dict_key, tr_max,
                    feat_off(0), mask_off(0), clip_row, gt_tr, inter,
                )
            else:
                # single-person GT: tiled context (dataset.py:591-598) is
                # outcome-independent; only the label varies
                ops.append((OP_SET, 4, 0, -1))
        gt_outcomes.append((choice_len, ops))
    if gt_dynamic or any(cl for cl, _ in gt_outcomes):
        sites.append(_Site(L, gt_outcomes))

    if not (tr_max and ds.triplets):
        return sites

    # -- non-GT two-person hypotheses (dataset.py:633-666) ----------------
    n_hyp = ds._max_n_tripl
    mem_counter = 1
    for name1, name2 in permutations(inter.id2names.values(), 2):
        if len(inter.triplets[triplet_idx]) == 2:
            if (
                name1 == inter.triplets[triplet_idx][0]
                and name2 == inter.triplets[triplet_idx][1]
            ):
                continue
        if mem_counter >= n_hyp:
            continue  # cap reached: __getitem__ stops counting too (:655)
        h = mem_counter
        mem_counter += 1
        tr1 = ds.tables.track_row((idx, name1))
        tr2 = ds.tables.track_row((idx, name2))
        site = _hypothesis_site(
            ds, pool, movie_idx, scene_idx, name1, name2,
            clip_row, tr1, tr2, feat_off(h), h, mask_off(h),
        )
        if site is not None:
            sites.append(site)
    return sites


def _emit_gt_context(
    ds, pool, ops, spec, dict_key, tr_max, f_off, m_off, clip_row, gt_tr,
    inter,
):
    """Emit the GT context ops; returns the outcome's choice length."""
    R = ds.rels_n_clips
    choice_len, feat, gt, mask, rows_off = spec
    if choice_len:
        ops.append(
            (
                OP_BLOCK, 0, f_off,
                pool.add(np.asarray([clip_row, gt_tr[0], gt_tr[1]], np.int32)),
                3,
            )
        )
        ops.append((OP_GATHER, 0, f_off + 3, rows_off, 3, R))
        if not tr_max:
            # labels = context_gt [R+1, 1]
            gts = pool.ctx_arrays[dict_key][1]  # cached by _context_outcome
            ops.append(
                (
                    OP_BLOCK, 1, 0,
                    pool.add(np.asarray([_label_of(ds, inter)], np.int32)), 1,
                )
            )
            ops.append((OP_GATHER, 1, 1, pool.add(gts), 1, R))
    else:
        ops.append((OP_BLOCK, 0, f_off, pool.add(feat), feat.size))
        if not tr_max and gt is not None:
            ops.append((OP_BLOCK, 1, 0, pool.add(gt), gt.size))
    ops.append((OP_BLOCK, 3, m_off, pool.add(mask), mask.size))
    return choice_len


def _hypothesis_site(
    ds, pool, movie_idx, scene_idx, name1, name2, clip_row, tr1, tr2,
    f_off, h, m_off,
) -> Optional[_Site]:
    """Mirror `_hypothesis_context` (dataset.py:744-784) as a site; None if
    the hypothesis is fully static (no draws possible)."""
    R = ds.rels_n_clips
    pair = (name1, name2)
    hyp_triple = np.asarray([clip_row, tr1, tr2], np.int32)

    def none_outcome():
        feat = np.empty((R + 1, 3), np.int32)
        feat[:] = hyp_triple
        mask = np.zeros(R, np.int32)
        mask[0] = 1
        ops = [
            (OP_SET, 2, h, ds.rels2idx["None"]),
            (OP_BLOCK, 0, f_off, pool.add(feat), feat.size),
            (OP_BLOCK, 3, m_off, pool.add(mask), mask.size),
        ]
        return (0, ops)

    if pair not in ds.rels[movie_idx]:
        return None  # "None", deterministic -> static in base
    scene_labels = ds.rels[movie_idx][pair].scene_labels(scene_idx)
    names = scene_labels if scene_labels else ["None"]
    L = len(names)
    any_choice = False
    outcomes: List[Tuple[int, List[tuple]]] = []
    for rel_name in names:
        if rel_name == "None":
            outcomes.append(none_outcome())
            continue
        dict_key = (movie_idx, name1, name2, rel_name)
        rows = ds.movie_ch1_ch2_rel[dict_key]
        spec = _context_outcome(
            ds, dict_key, rows, _gts_for(ds, dict_key), pool,
            (0, 0, 0), 0, False,
        )
        choice_len, feat, _gt, mask, rows_off = spec
        ops = [(OP_SET, 2, h, ds.rels2idx[rel_name])]
        if choice_len:
            any_choice = True
            ops.append(
                (OP_BLOCK, 0, f_off, pool.add(np.zeros(3, np.int32)), 3)
            )
            ops.append((OP_GATHER, 0, f_off + 3, rows_off, 3, R))
        else:
            ops.append((OP_BLOCK, 0, f_off, pool.add(feat), feat.size))
        ops.append((OP_BLOCK, 3, m_off, pool.add(mask), mask.size))
        outcomes.append((choice_len, ops))
    if L <= 1 and not any_choice:
        return None
    return _Site(L, outcomes)


def _label_of(ds, inter) -> int:
    return int(ds._label_of(inter))
