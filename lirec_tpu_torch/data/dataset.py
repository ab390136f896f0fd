"""Sample assembly: the reference `__getitem__` contract, index-packed.

This reimplements the reference's central dataset (ref
`mixed_utils/classification_dataloader.py`) with one structural change for
TPU: instead of materializing `[20, 19, 6912]` float rows per sample, every
unique fused clip row and track row lives once in small **feature tables**,
and samples carry int32 **index triples** `(clip_row, track1_row, track2_row)`
per (hypothesis, context slot). Row 0 of each table is zeros, so padded /
missing entries are index 0. `to_dense()` gathers the exact reference layout
`[text | visual | track1 | track2]` for parity tests and the dense eval path.

Reference quirks reproduced on purpose (each marked inline):
- the 20-hypothesis cap (ref :177) and hypothesis enumeration order;
- `gt_tracks[1] = mem_counter - 1` for bidirectional pairs in tr_maximize
  mode — off by one, pointing at the row *before* the reversed-GT
  hypothesis (ref :451-453); the single-person branch uses the correct
  `mem_counter` (ref :528);
- nearest-scene relationship imputation whose `min_dist` is never updated,
  so the *last* candidate relationship always wins (ref :93-102);
- `just_zeros` not being updated by the half-empty single-name rows (the
  reference checks a stale variable there, ref :553);
- non-rels tr_maximize mode tiles the clip features into all 20 hypothesis
  rows, valid or not (ref :334).
"""

from __future__ import annotations

from collections import defaultdict
from itertools import permutations
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from lirec_tpu_torch.data import annotations as ann_lib
from lirec_tpu_torch.data import vocab as vocab_lib
from lirec_tpu_torch.data.mixed import MixedFeatureReader

__all__ = ["FeatureTables", "InteractionDataset", "first_choice"]


def _nested_list_dict():
    return defaultdict(list)


def first_choice(labels: Sequence[str], rng: np.random.Generator) -> str:
    """Deterministic multi-label chooser (used by parity tests)."""
    return labels[0]


def random_choice(labels: Sequence[str], rng: np.random.Generator) -> str:
    if len(labels) == 1:
        return labels[0]
    return labels[int(rng.integers(len(labels)))]


class FeatureTables:
    """Deduplicated fused-feature tables; row 0 of each is zeros."""

    def __init__(self, text_dim: int, visual_dim: int, track_dim: int):
        self.text_dim = text_dim
        self.visual_dim = visual_dim
        self.track_dim = track_dim
        self._clip_rows: List[np.ndarray] = [np.zeros(text_dim + visual_dim)]
        self._track_rows: List[np.ndarray] = [np.zeros(track_dim)]
        self._clip_index: Dict[object, int] = {}
        self._track_index: Dict[object, int] = {}
        self.text: Optional[np.ndarray] = None
        self.visual: Optional[np.ndarray] = None
        self.track: Optional[np.ndarray] = None
        self.track_nonzero: Optional[np.ndarray] = None

    def add_clip_row(self, key: object, row: np.ndarray) -> int:
        if key in self._clip_index:
            return self._clip_index[key]
        idx = len(self._clip_rows)
        self._clip_rows.append(np.asarray(row).ravel())
        self._clip_index[key] = idx
        return idx

    def add_track_row(self, key: object, row: np.ndarray) -> int:
        if key in self._track_index:
            return self._track_index[key]
        idx = len(self._track_rows)
        self._track_rows.append(np.asarray(row).ravel())
        self._track_index[key] = idx
        return idx

    def clip_row(self, key: object) -> int:
        return self._clip_index[key]

    def track_row(self, key: object) -> int:
        return self._track_index[key]

    def finalize(self) -> None:
        clip = np.stack(self._clip_rows).astype(np.float32)
        self.text = clip[:, : self.text_dim]
        self.visual = clip[:, self.text_dim :]
        self.track = np.stack(self._track_rows).astype(np.float32)
        self.track_nonzero = np.abs(self.track).sum(axis=1) > 0

    def as_dict(self) -> Dict[str, np.ndarray]:
        """The {'text','visual','track'} arrays the model layer consumes."""
        return {"text": self.text, "visual": self.visual, "track": self.track}

    @property
    def n_clip_rows(self) -> int:
        return len(self._clip_rows)

    @property
    def n_track_rows(self) -> int:
        return len(self._track_rows)


class InteractionDataset:
    """Mixed-feature multi-task dataset (ref MixedFeaturesDataset)."""

    def __init__(
        self,
        cfg,
        mode: str = "train",
        label_chooser: Callable = random_choice,
        cache_features_to_disk: bool = False,
    ):
        self.cfg = cfg
        self.mode = mode
        self.label_chooser = label_chooser
        t = cfg.tasks
        self.rng = np.random.default_rng(cfg.optim.seed)
        self.test_rels_multi_clip = False

        interactions_vocab, self.inter2idx = vocab_lib.load_interaction_names(
            cfg.paths.labeled_interactions
        )
        self.inter2mgd, self.mgd2idx = vocab_lib.load_merged_interactions(
            cfg.paths.merged_interactions
        )
        self.interidx2mgdidx = vocab_lib.build_interidx_to_mgdidx(
            self.inter2idx, self.inter2mgd, self.mgd2idx, t.inter_class
        )
        self.n_classes = (
            len(self.mgd2idx) if t.merged
            else len(interactions_vocab[t.inter_class])
        )
        # eval always assembles tracks (ref classification_dataloader.py:42-44)
        self.tracks = t.tracks if mode == "train" else True
        self.triplets = t.tr_maximize
        self._max_n_tripl = 0
        self.rels_n_clips = 0
        self.movie_idxs = vocab_lib.load_split(
            cfg.paths.split, mode, cfg.runtime.sanity_check
        )

        mined = ann_lib.mine_interactions(
            cfg.paths,
            movie_idxs=self.movie_idxs,
            inter_class=t.inter_class,
            with_rels=(t.rels or t.rels_multitask),
        )
        self.interactions = mined.interactions
        self.rels = mined.rels
        self.rels_list = mined.rels_list if (t.rels or t.rels_multitask) else []
        self.rels_opp = mined.rels_opp if (t.rels or t.rels_multitask) else {}

        resolutions = vocab_lib.load_orig_resolutions(cfg.paths.orig_res)

        self.features: Dict[Tuple[str, int], MixedFeatureReader] = {}
        self.idxs_with_triplets: List[Tuple[int, int]] = []
        self.mv_sc_tr2triplidx: Dict[Tuple, int] = {}
        self.mv2sc2intersid: Dict[str, Dict[int, List[int]]] = {}
        # module-level factory (not a lambda) so the dataset pickles into
        # assembly workers (data/pipeline.AssemblyPool)
        self.pair2scenes: Dict[Tuple, Dict[int, List[int]]] = defaultdict(
            _nested_list_dict
        )
        movie_scene = set()
        for inter in self.interactions:
            movie_idx = inter.video_descr["movie"]
            scene_idx = inter.video_descr["scene"][0]
            self.mv2sc2intersid.setdefault(movie_idx, defaultdict(list))[
                scene_idx
            ].append(inter.id)
            if not self.tracks or len(inter.triplets) == 0:
                self.idxs_with_triplets.append((inter.id, 0))
                self.mv_sc_tr2triplidx[(movie_idx, scene_idx, 0)] = (
                    len(self.idxs_with_triplets) - 1
                )
            else:
                for triplet_idx in inter.triplets:
                    self.idxs_with_triplets.append((inter.id, triplet_idx))
                    if len(inter.triplets[triplet_idx]) == 2:
                        name1 = inter.triplets[triplet_idx][0]
                        name2 = inter.triplets[triplet_idx][1]
                        self.pair2scenes[(movie_idx, name1, name2)][
                            scene_idx
                        ].append(inter.id)
                        self.pair2scenes[(movie_idx, name2, name1)][
                            scene_idx
                        ].append(inter.id)
                        if t.rels_multi_clip:
                            self._impute_unlabeled_scene(
                                inter, triplet_idx, movie_idx, scene_idx,
                                (name1, name2),
                            )
            if (movie_idx, scene_idx) not in movie_scene:
                self.features[(movie_idx, scene_idx)] = MixedFeatureReader(
                    movie_idx,
                    scene_idx,
                    inter.video_descr["fname"][0],
                    cfg=cfg,
                    resolution=resolutions.get(movie_idx),
                    cache_to_disk=cache_features_to_disk,
                )
                movie_scene.add((movie_idx, scene_idx))

        self.iou2_clips = vocab_lib.load_iou2_clips(cfg.paths.intersected)
        self.rels2idx: Dict[str, int] = {}
        self.idx2rels: Dict[int, str] = {}
        self.n_rels = 0
        self.tables = FeatureTables(
            cfg.dims.text_dim, cfg.dims.visual_dim, cfg.dims.track_dim
        )
        self._cached = False

    # -- relationship imputation (ref :86-102) ---------------------------

    def _impute_unlabeled_scene(
        self, inter, triplet_idx, movie_idx, scene_idx, sn
    ) -> None:
        movie_rels = self.rels[movie_idx]
        if sn not in movie_rels or scene_idx in movie_rels[sn].scenes:
            return
        hist = movie_rels[sn]
        if len(hist.rel2scenes) == 1:
            hist.append_scene(None, scene_idx)
            movie_rels[(sn[1], sn[0])].append_scene(None, scene_idx)
            inter.relships[triplet_idx] = [hist.rels_name]
        else:
            # Reference bug kept: min_dist is never updated, so every
            # candidate passes `distance < inf` and the LAST relationship in
            # iteration order wins (ref classification_dataloader.py:93-99).
            min_dist = float("inf")
            update_rels_name = None
            for rels, rel_scenes in hist.rel2scenes.items():
                distance = min(
                    abs(np.min(rel_scenes) - scene_idx),
                    abs(np.max(rel_scenes) - scene_idx),
                )
                if distance < min_dist:
                    update_rels_name = rels
            hist.append_scene(update_rels_name, scene_idx)
            movie_rels[(sn[1], sn[0])].append_scene(
                self.rels_opp[update_rels_name], scene_idx
            )
            inter.relships[triplet_idx] = [update_rels_name]

    # -- vocab -------------------------------------------------------------

    def init_relships(self) -> None:
        """Relationship vocabulary; 'None' must land last
        (ref classification_dataloader.py:124-135)."""
        self.rels_list = list(reversed(sorted(self.rels_list)))
        for idx, relship in enumerate(self.rels_list):
            self.rels2idx[relship] = idx
            self.idx2rels[idx] = relship
        assert self.rels2idx["None"] == len(self.rels_list) - 1
        self.n_rels = len(self.rels_list)

    # -- precompute ----------------------------------------------------------

    def cache(self, parallel_workers: int = 0) -> None:
        """Precompute every fused row into the tables
        (ref classification_dataloader.py:139-186).

        With ``parallel_workers > 1``, per-(movie, scene) feature reading
        (the np.load + pooling that dominates on real data) runs in a
        thread pool; table row indices are still assigned in the
        deterministic sequential order below.
        """
        t = self.cfg.tasks
        if parallel_workers > 1:
            self._warm_readers(parallel_workers)
        for idx, triplet_idx in self.idxs_with_triplets:
            inter = self.interactions[idx]
            movie_idx = inter.video_descr["movie"]
            scene_idx = inter.video_descr["scene"][0]
            # backfill relationship labels recorded for this scene
            # (ref :149-156)
            if (
                len(inter.triplets.get(triplet_idx, ())) == 2
                and triplet_idx not in inter.relships
                and t.rels_multi_clip
            ):
                pair = (
                    inter.triplets[triplet_idx][0],
                    inter.triplets[triplet_idx][1],
                )
                if pair in self.rels[movie_idx]:
                    hist = self.rels[movie_idx][pair]
                    if scene_idx in hist.scenes:
                        inter.relships[triplet_idx] = hist._scene2rel[scene_idx]

            reader = self.features[(movie_idx, scene_idx)]
            row = reader.get_features_by_time(inter.time_node, idx=idx)
            self.tables.add_clip_row(idx, row)
            if self.tracks and len(inter.triplets):
                # the reference caches GT-triplet tracks here and the rest
                # lazily in __getitem__; we cache every participant's track
                # row up front (superset, same values).
                for name in inter.id2names.values():
                    trow = reader.get_features_by_track(
                        inter.ftracks[name], idx=(idx, name), name=name
                    )
                    self.tables.add_track_row((idx, name), trow)
        self._max_n_tripl = self.cfg.tasks.n_hypotheses  # hard cap (ref :177)
        for reader in self.features.values():
            reader.free()
        if t.rels_multi_clip:
            self.rels_n_clips = t.rels_n_clips
            self._cache_relationships()
        self.tables.finalize()
        self._cached = True

    def _warm_readers(self, workers: int) -> None:
        """Populate each scene reader's memoized rows concurrently (numpy IO
        and pooling release the GIL). Memo dict writes are per-reader and
        the later sequential pass only reads memoized values, so table
        ordering is unaffected."""
        from concurrent.futures import ThreadPoolExecutor

        by_scene: Dict[Tuple[str, int], List] = defaultdict(list)
        seen = set()
        for idx, _triplet_idx in self.idxs_with_triplets:
            if idx in seen:
                continue
            seen.add(idx)
            inter = self.interactions[idx]
            key = (inter.video_descr["movie"], inter.video_descr["scene"][0])
            by_scene[key].append(inter)

        def warm(key):
            reader = self.features[key]
            for inter in by_scene[key]:
                reader.get_features_by_time(inter.time_node, idx=inter.id)
                if self.tracks and len(inter.triplets):
                    for name in inter.id2names.values():
                        reader.get_features_by_track(
                            inter.ftracks[name], idx=(inter.id, name),
                            name=name,
                        )
            reader.free()

        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(warm, by_scene))

    def _context_eval_stride(self, length: int) -> List[int]:
        # stable eval subsampling (ref :229)
        idxs = list(range(0, length, length // self.rels_n_clips))[
            : self.rels_n_clips
        ]
        assert len(idxs) == self.rels_n_clips
        return idxs

    def _cache_relationships(self) -> None:
        """Context index matrices per (movie, ch1, ch2, rel)
        (ref classification_dataloader.py:188-262)."""
        self.movie_ch1_ch2_rel: Dict[Tuple, List[Tuple[int, int, int]]] = {}
        self.movie_ch1_ch2_rel_inter: Dict[Tuple, np.ndarray] = {}
        self.hashidx_rels: Dict[Tuple, int] = {}
        self.hashrels_idx: Dict[int, Tuple] = {}
        self.context_idxs: Dict[Tuple, List[int]] = {}
        hash_idx = 0
        cached_pairs = set()
        for movie_id in self.rels:
            for pair in self.rels[movie_id]:
                for pair_rel, pair_scenes in self.rels[movie_id][
                    pair
                ].rel2scenes.items():
                    dict_key = (movie_id, pair[0], pair[1], pair_rel)
                    # movie-scoped, unlike the reference's global name-pair
                    # set (ref :204,243): with cross-movie character-name
                    # collisions the reference would exclude the pair from
                    # the None-cache and then KeyError in __getitem__
                    # (classification_dataloader.py:374); scoping by movie
                    # is identical wherever the reference doesn't crash
                    cached_pairs.add((movie_id, pair))
                    if dict_key not in self.hashidx_rels:
                        self.hashidx_rels[dict_key] = hash_idx
                        self.hashrels_idx[hash_idx] = dict_key
                        hash_idx += 1
                    rows: List[Tuple[int, int, int]] = []
                    inter_classes: List[int] = []
                    for scene_id in pair_scenes:
                        for inter_id in self.mv2sc2intersid[movie_id][scene_id]:
                            inter = self.interactions[inter_id]
                            if (
                                pair[0] in inter.name2id
                                and pair[1] in inter.name2id
                            ):
                                rows.append(
                                    (
                                        self.tables.clip_row(inter_id),
                                        self.tables.track_row(
                                            (inter_id, pair[0])
                                        ),
                                        self.tables.track_row(
                                            (inter_id, pair[1])
                                        ),
                                    )
                                )
                                inter_classes.append(
                                    self.mgd2idx[
                                        self.inter2mgd[
                                            inter.inter_node["name"]
                                        ]
                                    ]
                                )
                    self.movie_ch1_ch2_rel[dict_key] = rows
                    self.movie_ch1_ch2_rel_inter[dict_key] = np.array(
                        inter_classes, dtype=int
                    )
                    if self.mode != "train" and len(rows) > self.rels_n_clips:
                        self.context_idxs[dict_key] = self._context_eval_stride(
                            len(rows)
                        )
        self._cache_none_rels(cached_pairs)

    def _cache_none_rels(self, cached_pairs) -> None:
        """Context matrices for pairs with no labeled relationship
        (ref classification_dataloader.py:237-262)."""
        self.movie_ch1_ch2_none: Dict[Tuple, List[Tuple[int, int, int]]] = {}
        self.movie_ch1_ch2_none_inter: Dict[Tuple, np.ndarray] = {}
        self.context_idxs_none: Dict[Tuple, List[int]] = {}
        for key, scenes2inters in self.pair2scenes.items():
            movie_idx, name1, name2 = key
            if (movie_idx, (name1, name2)) in cached_pairs:
                continue
            rows: List[Tuple[int, int, int]] = []
            inter_classes: List[int] = []
            for scene_id, inter_ids in scenes2inters.items():
                for inter_id in inter_ids:
                    inter = self.interactions[inter_id]
                    rows.append(
                        (
                            self.tables.clip_row(inter_id),
                            self.tables.track_row((inter_id, name1)),
                            self.tables.track_row((inter_id, name2)),
                        )
                    )
                    inter_classes.append(
                        self.mgd2idx[self.inter2mgd[inter.inter_node["name"]]]
                    )
            self.movie_ch1_ch2_none[key] = rows
            self.movie_ch1_ch2_none_inter[key] = np.array(inter_classes, dtype=int)
            if self.mode != "train" and len(rows) > self.rels_n_clips:
                self.context_idxs_none[key] = self._context_eval_stride(len(rows))

    # -- sample assembly ------------------------------------------------------

    def __len__(self) -> int:
        if self.test_rels_multi_clip:
            return len(self.hashidx_rels)
        return len(self.idxs_with_triplets)

    def _label_of(self, inter) -> int:
        t = self.cfg.tasks
        pos = 0 if t.inter_class == "all" else 2
        label = self.inter2idx[inter.inter_node["name"]][pos]
        if t.merged:
            label = int(self.interidx2mgdidx[label])
        return label

    def _context_indices(
        self, dict_key, rows, rng
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(feat_idx [R+1,3], context_gt [R+1,1], rels_mask [R,1]) for a
        cached context list; slot 0 left empty for the GT row."""
        R = self.rels_n_clips
        feat_idx = np.zeros((R + 1, 3), dtype=np.int32)
        context_gt = np.zeros((R + 1, 1), dtype=int)
        rels_mask = np.zeros((R, 1), dtype=int)
        length = len(rows)
        gts = (
            self.movie_ch1_ch2_rel_inter[dict_key]
            if len(dict_key) == 4
            else self.movie_ch1_ch2_none_inter[dict_key]
        )
        if length == 0:
            return feat_idx, context_gt, rels_mask
        if length <= R:
            rels_mask[:length] = 1
            feat_idx[1 : length + 1] = np.asarray(rows, dtype=np.int32)
            context_gt[1 : length + 1] = gts.reshape(-1, 1)
        else:
            if self.mode == "train":
                chosen = rng.choice(length, R, replace=False)
            else:
                chosen = (
                    self.context_idxs[dict_key]
                    if len(dict_key) == 4
                    else self.context_idxs_none[dict_key]
                )
            feat_idx[1:] = np.asarray(rows, dtype=np.int32)[chosen]
            context_gt[1:] = gts[chosen].reshape(-1, 1)
            rels_mask[:] = 1
        return feat_idx, context_gt, rels_mask

    def _track_is_nonzero(self, key) -> bool:
        return bool(self.tables.track_nonzero[self.tables.track_row(key)])

    def __getitem__(self, idx_pair: int, rng: Optional[np.random.Generator] = None):
        """Assemble one sample as index tensors + labels/masks.

        Follows ref classification_dataloader.py:291-616 step for step; see
        module docstring for the dense layout equivalence.
        """
        assert self._cached, "call cache() first"
        rng = rng or self.rng
        t = self.cfg.tasks
        d = self.cfg.dims
        output: Dict[str, np.ndarray] = {}

        if self.test_rels_multi_clip:
            # one item per (pair, rel) hash with ALL its clips (ref :293-303)
            dict_key = self.hashrels_idx[idx_pair]
            rows = self.movie_ch1_ch2_rel[dict_key]
            feat_idx = np.zeros((len(rows) + 1, 3), dtype=np.int32)
            feat_idx[1:] = np.asarray(rows, dtype=np.int32)
            output["rels_label"] = self.rels2idx[dict_key[3]]
            output["feat_idx"] = feat_idx
            output["rels_mask"] = np.ones((len(rows), 1), dtype=int)
            return output

        idx, triplet_idx = self.idxs_with_triplets[idx_pair]
        inter = self.interactions[idx]
        movie_idx = inter.video_descr["movie"]
        scene_idx = inter.video_descr["scene"][0]
        label = self._label_of(inter)
        output["labels"] = label
        clip_row = self.tables.clip_row(idx)

        n_hyp = self._max_n_tripl
        R = self.rels_n_clips

        if self.tracks and len(inter.triplets):
            # GT track pair (hypothesis 0; ref :336-353)
            gt_tr = [0, 0]  # table rows for slots (track1, track2)
            for positional_idx, track_name in inter.triplets[triplet_idx].items():
                gt_tr[0 if positional_idx == 0 else 1] = self.tables.track_row(
                    (idx, track_name)
                )
            gt_pair_nonzero = bool(
                self.tables.track_nonzero[gt_tr[0]]
                or self.tables.track_nonzero[gt_tr[1]]
            )
            output["just_zeros"] = not gt_pair_nonzero

            if t.rels_multitask:
                output["rels_label"] = self.rels2idx[
                    self._choose(inter.relships.get(triplet_idx), rng)
                ]
                if t.rels_multi_clip:
                    if len(inter.triplets[triplet_idx]) == 2:
                        name1 = inter.triplets[triplet_idx][0]
                        name2 = inter.triplets[triplet_idx][1]
                        rel_name = self.idx2rels[output["rels_label"]]
                        if rel_name == "None":
                            output["hash_rel"] = -1
                            dict_key = (movie_idx, name1, name2)
                            rows = self.movie_ch1_ch2_none[dict_key]
                            if len(rows) == 0:
                                # no recorded clips: the GT row itself is the
                                # context (ref :377-380)
                                context_idx = np.zeros((R + 1, 3), np.int32)
                                context_gt = np.zeros((R + 1, 1), int)
                                rels_mask = np.zeros((R, 1), int)
                                rels_mask[0] = 1
                                context_idx[1] = (clip_row, gt_tr[0], gt_tr[1])
                                context_gt[1] = label
                            else:
                                context_idx, context_gt, rels_mask = (
                                    self._context_indices(dict_key, rows, rng)
                                )
                        else:
                            dict_key = (movie_idx, name1, name2, rel_name)
                            output["hash_rel"] = self.hashidx_rels[dict_key]
                            context_idx, context_gt, rels_mask = (
                                self._context_indices(
                                    dict_key, self.movie_ch1_ch2_rel[dict_key], rng
                                )
                            )
                    else:
                        # single-person GT: context = tiled GT row (ref :412-416)
                        output["hash_rel"] = -1
                        context_idx = np.empty((R + 1, 3), np.int32)
                        context_idx[:] = (clip_row, gt_tr[0], gt_tr[1])
                        context_gt = np.full((R + 1, 1), label, int)
                        rels_mask = np.zeros((R, 1), int)
                        rels_mask[0] = 1
                    # GT at slot 0 (ref :419-420)
                    context_idx[0] = (clip_row, gt_tr[0], gt_tr[1])
                    context_gt[0] = label

            if t.tr_maximize:
                if t.rels_multitask:
                    mem_idx = np.zeros((n_hyp, R + 1, 3), dtype=np.int32)
                    mem_idx[0] = context_idx
                    output["rels_mask"] = rels_mask
                else:
                    # non-rels mode: clip part tiled into every row (ref :334)
                    mem_idx = np.zeros((n_hyp, 1, 3), dtype=np.int32)
                    mem_idx[:, 0, 0] = clip_row
                    mem_idx[0, 0, 1:] = gt_tr
                mem_counter = 1
            elif t.rels_multi_clip:
                output["feat_idx"] = context_idx
                output["labels"] = context_gt
                output["rels_mask"] = rels_mask
            else:
                output["feat_idx"] = np.array(
                    [[clip_row, gt_tr[0], gt_tr[1]]], dtype=np.int32
                )

            if self.triplets:
                gt_tracks = [0, 0]
                just_zeros = True
                if t.rels_multitask:
                    rels_labs = np.zeros(n_hyp, dtype=int)
                    rels_labs[0] = output["rels_label"]
                    rels_masks = np.zeros((n_hyp, R), dtype=int)
                    rels_masks[0] = rels_mask.reshape(-1)

                # two-person hypotheses over all directed name pairs (ref :448)
                for name1, name2 in permutations(inter.id2names.values(), 2):
                    if len(inter.triplets[triplet_idx]) == 2:
                        if (
                            name1 == inter.triplets[triplet_idx][0]
                            and name2 == inter.triplets[triplet_idx][1]
                        ):
                            continue
                        if (
                            inter.bi
                            and name1 == inter.triplets[triplet_idx][1]
                            and name2 == inter.triplets[triplet_idx][0]
                        ):
                            # reference off-by-one kept: slot points at the
                            # row BEFORE this reversed-GT hypothesis (ref :453)
                            gt_tracks[1] = mem_counter - 1
                    tr1 = self.tables.track_row((idx, name1))
                    tr2 = self.tables.track_row((idx, name2))
                    if (
                        self.tables.track_nonzero[tr1]
                        or self.tables.track_nonzero[tr2]
                    ):
                        just_zeros = False
                    if mem_counter < n_hyp:
                        if t.rels_multitask:
                            ctx_idx, r_mask, rel_name = self._hypothesis_context(
                                movie_idx, scene_idx, name1, name2,
                                clip_row, tr1, tr2, rng,
                            )
                            mem_idx[mem_counter] = ctx_idx
                            rels_labs[mem_counter] = self.rels2idx[rel_name]
                            rels_masks[mem_counter] = r_mask
                        else:
                            mem_idx[mem_counter, 0, 1:] = (tr1, tr2)
                        mem_counter += 1

                # single-person GT with reversed direction (ref :513-540)
                if len(inter.triplets[triplet_idx]) == 1:
                    position, gt_name = list(
                        inter.triplets[triplet_idx].items()
                    )[0]
                    row = self.tables.track_row((idx, gt_name))
                    wrong = (0, row) if position == 0 else (row, 0)
                    if self.tables.track_nonzero[row]:
                        just_zeros = False
                    if mem_counter < n_hyp:
                        if inter.bi:
                            gt_tracks[1] = mem_counter  # correct here (ref :528)
                        if t.rels_multitask:
                            rels_labs[mem_counter] = self.rels2idx["None"]
                            mem_idx[mem_counter] = (
                                clip_row, wrong[0], wrong[1],
                            )  # broadcast over the R+1 context rows
                            rels_masks[mem_counter, 0] = 1
                        else:
                            mem_idx[mem_counter, 0, 1:] = wrong
                        mem_counter += 1

                # half-empty rows: each name alone in slot 0 then slot 1
                # (ref :543-569); note just_zeros is deliberately NOT updated
                # here, matching the reference's stale-variable check (ref :553)
                for name1 in inter.id2names.values():
                    if (
                        len(inter.triplets[triplet_idx]) == 1
                        and name1 == gt_name
                    ):
                        continue
                    row = self.tables.track_row((idx, name1))
                    if mem_counter < n_hyp - 1:
                        if t.rels_multitask:
                            for half in ((row, 0), (0, row)):
                                rels_labs[mem_counter] = self.rels2idx["None"]
                                mem_idx[mem_counter] = (
                                    clip_row, half[0], half[1],
                                )  # broadcast over the R+1 context rows
                                rels_masks[mem_counter, 0] = 1
                                mem_counter += 1
                        else:
                            mem_idx[mem_counter, 0, 1:] = (row, 0)
                            mem_idx[mem_counter + 1, 0, 1:] = (0, row)
                            mem_counter += 2

                output["just_zeros"] = just_zeros
                output["gt_tracks"] = np.array(gt_tracks)
                output["n_names"] = len(inter.id2names)
                if t.tr_maximize:
                    output["feat_idx"] = mem_idx
                    mem_mask = np.zeros(n_hyp)
                    mem_mask[:mem_counter] = 1
                    output["mem_mask"] = mem_mask
                    if t.rels_multitask:
                        output["rels_label"] = rels_labs
                        output["rels_mask"] = rels_masks
        elif self.tracks:
            raise ValueError(
                "interaction %d has no participants but tracks are enabled"
                % idx
            )
        else:
            output["feat_idx"] = np.array([[clip_row, 0, 0]], dtype=np.int32)

        if t.multilab_weights:
            self._add_multilab_weights(output, inter, movie_idx, scene_idx)
        if t.soft_gt:
            self._add_soft_labels(output, inter, movie_idx, scene_idx, label)
        return output

    def _choose(self, labels, rng) -> str:
        if not labels:
            return "None"
        return self.label_chooser(labels, rng)

    def _hypothesis_context(
        self, movie_idx, scene_idx, name1, name2, clip_row, tr1, tr2, rng
    ):
        """Context block for a non-GT hypothesis (ref :471-503)."""
        R = self.rels_n_clips
        pair = (name1, name2)
        hyp_triple = (clip_row, tr1, tr2)
        if pair in self.rels[movie_idx]:
            scene_labels = self.rels[movie_idx][pair].scene_labels(scene_idx)
            rel_name = self._choose(scene_labels, rng)  # ref scene2rel (:71-75)
            if rel_name == "None":
                ctx_idx = np.empty((R + 1, 3), np.int32)
                ctx_idx[:] = hyp_triple
                r_mask = np.zeros(R, int)
                r_mask[0] = 1
                return ctx_idx, r_mask, rel_name
            dict_key = (movie_idx, name1, name2, rel_name)
            rows = self.movie_ch1_ch2_rel[dict_key]
            ctx_idx = np.zeros((R + 1, 3), np.int32)
            r_mask = np.zeros(R, int)
            length = len(rows)
            if length <= R:
                r_mask[:length] = 1
                ctx_idx[1 : length + 1] = np.asarray(rows, np.int32)
            else:
                if self.mode == "train":
                    chosen = rng.choice(length, R, replace=False)
                else:
                    chosen = self.context_idxs[dict_key]
                ctx_idx[1:] = np.asarray(rows, np.int32)[chosen]
                r_mask[:] = 1
            # NOTE: the reference leaves row 0 of non-GT hypothesis contexts
            # EMPTY (zeros) in this branch (ref :482-492) — the hypothesis's
            # own features only enter via the ints branch, not the context.
            return ctx_idx, r_mask, rel_name
        rel_name = "None"
        ctx_idx = np.empty((R + 1, 3), np.int32)
        ctx_idx[:] = hyp_triple
        r_mask = np.zeros(R, int)
        r_mask[0] = 1
        return ctx_idx, r_mask, rel_name

    def _add_multilab_weights(self, output, inter, movie_idx, scene_idx) -> None:
        """Zero out IoU-overlapping classes (ref :590-601)."""
        t = self.cfg.tasks
        weights = np.ones(self.n_classes)
        weights_axl = np.ones(len(self.interidx2mgdidx))
        overlaps = self.iou2_clips.get((movie_idx, scene_idx), {}).get(
            inter.inter_node["name"], []
        )
        for soft_name in overlaps:
            if soft_name not in self.inter2idx:
                continue
            if (
                t.inter_class != "all"
                and "tvm"[self.inter2idx[soft_name][1]] != t.inter_class
            ):
                continue
            inter_idx = self.inter2idx[soft_name][
                0 if t.inter_class == "all" else 2
            ]
            weights_axl[inter_idx] = 0
            weights[self.interidx2mgdidx[inter_idx]] = 0
        output["multilab_weights"] = weights
        output["multilab_weights_axl"] = weights_axl

    def _add_soft_labels(self, output, inter, movie_idx, scene_idx, label) -> None:
        """Soft-GT label sets (ref :603-615)."""
        t = self.cfg.tasks
        soft_labels = np.ones(self.n_classes) * -1
        soft_labels[0] = label
        sf_idx = 1
        overlaps = self.iou2_clips.get((movie_idx, scene_idx), {}).get(
            inter.inter_node["name"], []
        )
        for soft_name in overlaps:
            if soft_name not in self.inter2idx:
                continue
            if (
                t.inter_class != "all"
                and "tvm"[self.inter2idx[soft_name][1]] != t.inter_class
            ):
                continue
            inter_idx = self.inter2idx[soft_name][
                0 if t.inter_class == "all" else 2
            ]
            soft_labels[sf_idx] = self.interidx2mgdidx[inter_idx]
            sf_idx += 1
        output["soft_labels"] = soft_labels

    def __getstate__(self):
        # the assembly plan and materialized split are large rebuildable
        # caches — don't ship them into spawned assembly workers
        state = dict(self.__dict__)
        state.pop("_assembly_plan", None)
        state.pop("_materialized", None)
        state.pop("_eval_ctx_loc_cache", None)
        return state

    # -- precompiled epoch assembly ----------------------------------------

    def assembly_plan(self):
        """Lazily-built `data.plan.AssemblyPlan` (None if unsupported).

        The plan assembles whole epochs bitwise-identically to this
        class's per-sample path at ~100x the speed (see data/plan.py);
        invalidated if the label chooser is swapped after building.

        Disk-cached across processes (data/plan_cache.py): the ~28 s
        build at real scale is paid once per dataset content, then
        reloaded in ~a second with a fingerprint + bitwise spot-check
        gate (LIREC_TPU_NO_PLAN_CACHE=1 opts out)."""
        import os

        from lirec_tpu_torch.data import plan_cache

        if os.environ.get("LIREC_TPU_NO_PLAN"):
            return None
        cached = getattr(self, "_assembly_plan", None)
        if cached is not None and cached[0] is self.label_chooser:
            return cached[1]
        plan = plan_cache.get_or_build(self)
        self._assembly_plan = (self.label_chooser, plan)
        return plan

    # -- whole-split materialization ---------------------------------------

    def materialize(
        self, rng: Optional[np.random.Generator] = None,
        cache: bool = True,
    ) -> Dict[str, np.ndarray]:
        """Assemble every sample once into stacked arrays.

        Eval batching then becomes pure slicing (the per-sample Python
        assembly runs at ~10k samples/s on one core — 8x slower than the
        device eval step). Eval-mode results are cached on the dataset:
        the sample contract is deterministic given the dataset's RNG
        stream, mirroring the reference's seed-once-then-iterate behavior.
        """
        if rng is not None:
            cache = False  # an explicit RNG always means fresh draws
        if cache and getattr(self, "_materialized", None) is not None:
            return self._materialized
        rng = rng or np.random.default_rng((self.cfg.optim.seed, 0x5A11))
        plan = self.assembly_plan() if not self.test_rels_multi_clip else None
        if plan is not None:
            # bitwise-identical shared-rng plan path (data/plan.py) —
            # static samples consume no draws either way
            batch = plan.assemble_with_rng(np.arange(len(self)), rng)
        else:
            from lirec_tpu_torch.data.pipeline import collate

            batch = collate(
                [self.__getitem__(i, rng) for i in range(len(self))]
            )
        if cache and self.mode != "train":
            self._materialized = batch
        return batch

    def to_dense(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Gather index triples into the reference float layout
        ``[..., text | visual | track1 | track2]``."""
        out = dict(sample)
        idx = sample["feat_idx"]
        tb = self.tables
        feats = np.concatenate(
            [
                tb.text[idx[..., 0]],
                tb.visual[idx[..., 0]],
                tb.track[idx[..., 1]],
                tb.track[idx[..., 2]],
            ],
            axis=-1,
        )
        # match reference shapes: tr_maximize non-rels mode is [20, mlp_dim]
        t = self.cfg.tasks
        if t.tr_maximize and not t.rels_multitask:
            feats = feats[:, 0, :]
        out["features"] = feats
        del out["feat_idx"]
        return out
