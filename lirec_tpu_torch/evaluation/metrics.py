"""Evaluation metric accumulators (counterpart of
lirec_tpu/evaluation/metrics.py, ref `utils/evaluation.py`): a copy of its
numpy host code, with the reference's exact counting semantics and the
quirks it keeps bug-for-bug:

- `rels_top1` divides by `total` (the non-zero sample count), not
  `total_rels`: the second definition at evaluation.py:359 shadows the one
  at :353.
- the second-GT-slot pass counts `cls_top1`/`rels_top1` only for samples the
  first slot got wrong (ref :162,260), and `trks_top1` only when the
  class-conditioned track prediction missed slot 0 AND slot 1 is set
  (ref :160-163).
- joint `top1` credits slot 1 only when the track prediction missed slot 0
  (ref :255,261-271).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np

__all__ = ["_sigmoid", "MetricAccumulator", "RelationshipsAcc"]


def _sigmoid(x: np.ndarray) -> np.ndarray:
    """Sigmoid preserving the input float dtype (counterpart of
    lirec_tpu/evaluation/metrics._sigmoid: the reference's scipy `expit`
    keeps float32, so float32 saturation and ties are part of parity;
    float64 inputs stay float64)."""
    dtype = x.dtype if np.issubdtype(x.dtype, np.floating) else np.float64
    out = np.clip(x, -500, 500).astype(dtype)
    return 1.0 / (1.0 + np.exp(-out))


def _float_copy(x: np.ndarray) -> np.ndarray:
    """Writable float copy preserving float32/float64."""
    x = np.asarray(x)
    dtype = x.dtype if np.issubdtype(x.dtype, np.floating) else np.float64
    return np.array(x, dtype=dtype)


class MetricAccumulator:
    """Counter state matching the reference `Precision` object."""

    def __init__(self, n_rels: int = 0):
        self._top1 = 0
        self._top3 = 0
        self._top5 = 0
        self._top10 = 0
        self._top1_sf = 0
        self._top5_sf = 0
        self._trks_top1 = 0
        self._cls_top1 = 0
        self._rels_top1 = 0
        self.total = 0
        self.total_cl = 0
        self.total_rels = 0
        self.n_rels = n_rels
        # multilabel P/R counters (ref evaluation.py:279-294)
        self._tp = 0
        self._fp_tp = 0
        self._fn_tp = 0
        # timing stats (ref evaluation.py:296-303)
        self._times_tp: list = []
        self._times_f: list = []
        # per-(movie, pair) relationship score sums (ref :47,273-277)
        self.movie_paar = defaultdict(lambda: np.zeros(max(n_rels, 1)))
        self._rels_global = 0

    # -- plain top-k (ref evaluation.py:68-107) -------------------------

    def update_probs(
        self,
        pr_probs: np.ndarray,
        gt: np.ndarray,
        soft_labels: Optional[np.ndarray] = None,
        conf_mat: Optional[np.ndarray] = None,
        top_n_labels: int = 0,
    ):
        pr_probs = np.asarray(pr_probs)
        gt = np.asarray(gt).reshape(-1)
        self.total += len(gt)
        pr_classes = np.argsort(-pr_probs, axis=1)
        self._top1 += int(np.sum(pr_classes[:, 0] == gt))
        self._top3 += int(np.sum((pr_classes[:, :3] == gt[:, None]).any(axis=1)))
        self._top5 += int(np.sum((pr_classes[:, :5] == gt[:, None]).any(axis=1)))
        self._top10 += int(np.sum((pr_classes[:, :10] == gt[:, None]).any(axis=1)))
        if soft_labels is not None:
            # first top-5 prediction inside the soft set decides both
            # counters (ref :87-94)
            for idx, top5 in enumerate(pr_classes[:, :5]):
                soft = soft_labels[idx]
                for rank, pred in enumerate(top5):
                    if pred in soft:
                        if rank == 0:
                            self._top1_sf += 1
                        self._top5_sf += 1
                        break
        if conf_mat is not None:
            for gt_label, pr_label in zip(gt, pr_classes[:, 0]):
                conf_mat[gt_label, pr_label] += 1
            return conf_mat
        if top_n_labels:
            # (top-n classes, their probabilities) per sample (ref :102-107)
            top = pr_classes[:, :top_n_labels]
            probs = np.take_along_axis(pr_probs, top, axis=1)
            return top, probs
        return None

    # -- grounding (ref evaluation.py:114-177) ---------------------------

    def update_probs_max_tracks(
        self,
        pr_probs: np.ndarray,
        gt_tracks: np.ndarray,
        gt_classes: np.ndarray,
        mask: np.ndarray,
        just_zeros: np.ndarray,
    ) -> None:
        logits = _float_copy(pr_probs)
        gt_tracks = np.asarray(gt_tracks).astype(int)
        gt_classes = np.asarray(gt_classes).astype(int).reshape(-1)
        mask = np.asarray(mask).astype(bool)
        nz = ~np.asarray(just_zeros).astype(bool)

        logits[~mask] = -np.inf
        s_all = _sigmoid(logits)  # [B, T, C]; masked rows -> 0
        B = s_all.shape[0]
        rows = np.arange(B)
        g0, g1 = gt_tracks[:, 0], gt_tracks[:, 1]
        has2 = g1 != 0

        self.total += int(nz.sum())
        self.total_cl += B

        # class accuracy at the GT slots (all samples; ref :152-162)
        l0 = np.argmax(s_all[rows, g0, :], axis=1)
        l1 = np.argmax(s_all[rows, g1, :], axis=1)
        correct0 = l0 == gt_classes
        self._cls_top1 += int(correct0.sum())
        self._cls_top1 += int((~correct0 & (l1 == gt_classes)).sum())

        # class-conditioned track choice (non-zero samples; ref :137,160-163)
        col = s_all[rows, :, gt_classes]  # [B, T]
        pr_track = np.argmax(col, axis=1)
        hit0 = pr_track == g0
        hit1 = has2 & ~hit0 & (pr_track == g1)
        self._trks_top1 += int((nz & hit0).sum()) + int((nz & hit1).sum())

        # joint (track, class) argmax (ref :144-147,166-175)
        flat = s_all.reshape(B, -1)
        arg = np.argmax(flat, axis=1)
        C = s_all.shape[2]
        t_star, c_star = arg // C, arg % C
        joint0 = (c_star == gt_classes) & (t_star == g0)
        joint1 = has2 & ~hit0 & (c_star == gt_classes) & (t_star == g1)
        self._top1 += int((nz & joint0).sum()) + int((nz & joint1).sum())

    # -- grounding + relationships (ref evaluation.py:179-271) ----------

    def update_probs_max_tracks_rels(
        self,
        pr_probs_cl: np.ndarray,
        pr_probs_rels: np.ndarray,
        gt_classes: np.ndarray,
        gt_rels: np.ndarray,
        gt_tracks: np.ndarray,
        mask: np.ndarray,
        just_zeros: np.ndarray,
        rels_sample_idx: np.ndarray,
    ) -> None:
        """rels_sample_idx: indices of samples whose GT-slot relationship is
        not 'None' (the reference's `rels_mask` nonzero tensor)."""
        cl = _float_copy(pr_probs_cl)
        rl = _float_copy(pr_probs_rels)
        gt_tracks = np.asarray(gt_tracks).astype(int)
        gt_classes = np.asarray(gt_classes).astype(int).reshape(-1)
        gt_rels = np.asarray(gt_rels).astype(int)  # [B, T]
        mask = np.asarray(mask).astype(bool)
        nz = ~np.asarray(just_zeros).astype(bool)
        ridx = np.asarray(rels_sample_idx).astype(int).reshape(-1)

        cl[~mask] = -np.inf
        rl[~mask] = -np.inf
        B, T, C = cl.shape
        rows = np.arange(B)
        g0, g1 = gt_tracks[:, 0], gt_tracks[:, 1]
        has2 = g1 != 0
        K = len(ridx)

        self.total += int(nz.sum())
        self.total_cl += B
        self.total_rels += K

        s_cl = _sigmoid(cl)
        # 'None' column appended AFTER the sigmoid -> its score is 0 (ref :220)
        s = _sigmoid(rl)
        s_rl = np.concatenate(
            [s, np.zeros((B, T, 1), s.dtype)], axis=2
        )
        R1 = s_rl.shape[2]
        rel0 = gt_rels[rows, 0]  # GT-slot relationship label (ref :200)

        # class accuracy at GT slots (ref :241-257)
        l0 = np.argmax(s_cl[rows, g0, :], axis=1)
        l1 = np.argmax(s_cl[rows, g1, :], axis=1)
        correct0 = l0 == gt_classes
        self._cls_top1 += int(correct0.sum())
        self._cls_top1 += int((~correct0 & (l1 == gt_classes)).sum())

        # relationship accuracy at GT slots, rels-subset only (ref :243-260)
        if K:
            r_rl = rl[ridx]  # raw logits; argmax is sigmoid-invariant
            rg0, rg1 = g0[ridx], g1[ridx]
            p0 = np.argmax(r_rl[np.arange(K), rg0, :], axis=1)
            p1 = np.argmax(r_rl[np.arange(K), rg1, :], axis=1)
            gt_now0 = gt_rels[ridx, rg0]
            gt_now1 = gt_rels[ridx, rg1]
            rcorrect0 = p0 == gt_now0
            self._rels_top1 += int(rcorrect0.sum())
            self._rels_top1 += int((~rcorrect0 & (p1 == gt_now1)).sum())

        # class+rel-conditioned track choice (ref :221-222)
        col = s_cl[rows, :, gt_classes] + s_rl[rows, :, rel0]
        pr_track = np.argmax(col, axis=1)
        hit0 = pr_track == g0
        hit1 = has2 & ~hit0 & (pr_track == g1)
        self._trks_top1 += int((nz & hit0).sum()) + int((nz & hit1).sum())

        # joint (track, class, rel) argmax (ref :229-235 materializes the
        # [B,T,C,R] tiled sum — ~165 MB/batch at real dims). The sum is
        # separable, so it decomposes exactly, ties included: the flattened
        # argmax is t-major then c then r, and within a track the first
        # lexicographic maximizing (c, r) is (argmax_c, argmax_r).
        max_c = s_cl.max(axis=2)  # [B, T]
        max_r = s_rl.max(axis=2)  # [B, T]
        t_star = np.argmax(max_c + max_r, axis=1)
        c_star = np.argmax(s_cl[rows, t_star, :], axis=1)
        r_star = np.argmax(s_rl[rows, t_star, :], axis=1)
        jmatch = (c_star == gt_classes) & (r_star == rel0)
        joint0 = jmatch & (t_star == g0)
        joint1 = has2 & ~hit0 & jmatch & (t_star == g1)
        self._top1 += int((nz & joint0).sum()) + int((nz & joint1).sum())

    # -- counting from device-side predictions ----------------------------

    def update_from_predictions(
        self,
        preds: Dict[str, np.ndarray],
        gt_classes: np.ndarray,
        gt_tracks: np.ndarray,
        just_zeros: np.ndarray,
        gt_rels: Optional[np.ndarray] = None,
        rels_sample_idx: Optional[np.ndarray] = None,
    ) -> None:
        """Same counters as update_probs_max_tracks[_rels], fed by the
        argmaxes computed on device (evaluation/device_metrics.py)."""
        gt_classes = np.asarray(gt_classes).astype(int).reshape(-1)
        gt_tracks = np.asarray(gt_tracks).astype(int)
        nz = ~np.asarray(just_zeros).astype(bool)
        B = len(gt_classes)
        rows = np.arange(B)
        g0, g1 = gt_tracks[:, 0], gt_tracks[:, 1]
        has2 = g1 != 0
        cls_argmax = np.asarray(preds["cls_argmax"]).astype(int)
        pr_track = np.asarray(preds["pr_track"]).astype(int)
        t_star = np.asarray(preds["t_star"]).astype(int)
        c_star = np.asarray(preds["c_star"]).astype(int)

        self.total += int(nz.sum())
        self.total_cl += B

        l0 = cls_argmax[rows, g0]
        l1 = cls_argmax[rows, g1]
        correct0 = l0 == gt_classes
        self._cls_top1 += int(correct0.sum())
        self._cls_top1 += int((~correct0 & (l1 == gt_classes)).sum())

        if gt_rels is not None and rels_sample_idx is not None:
            gt_rels = np.asarray(gt_rels).astype(int)
            ridx = np.asarray(rels_sample_idx).astype(int).reshape(-1)
            K = len(ridx)
            self.total_rels += K
            if K:
                rels_argmax = np.asarray(preds["rels_argmax"]).astype(int)
                rg0, rg1 = g0[ridx], g1[ridx]
                p0 = rels_argmax[ridx, rg0]
                p1 = rels_argmax[ridx, rg1]
                gt_now0 = gt_rels[ridx, rg0]
                gt_now1 = gt_rels[ridx, rg1]
                rcorrect0 = p0 == gt_now0
                self._rels_top1 += int(rcorrect0.sum())
                self._rels_top1 += int((~rcorrect0 & (p1 == gt_now1)).sum())

        hit0 = pr_track == g0
        hit1 = has2 & ~hit0 & (pr_track == g1)
        self._trks_top1 += int((nz & hit0).sum()) + int((nz & hit1).sum())

        jmatch = c_star == gt_classes
        if gt_rels is not None:
            r_star = np.asarray(preds["r_star"]).astype(int)
            jmatch = jmatch & (r_star == gt_rels[rows, 0])
        joint0 = jmatch & (t_star == g0)
        joint1 = has2 & ~hit0 & jmatch & (t_star == g1)
        self._top1 += int((nz & joint0).sum()) + int((nz & joint1).sum())

    # -- accessors (ref evaluation.py:329-363) ---------------------------

    def top1(self) -> float:
        return self._top1 / self.total

    def top3(self) -> float:
        return self._top3 / self.total

    def top5(self) -> float:
        return self._top5 / self.total

    def top1_sf(self) -> float:
        return self._top1_sf / self.total

    def top5_sf(self) -> float:
        return self._top5_sf / self.total

    def trks_top1(self) -> float:
        return self._trks_top1 / self.total

    def cls_top1(self) -> float:
        return self._cls_top1 / self.total_cl

    def rels_top1(self) -> float:
        # reference bug kept: divides by `total`, not `total_rels`
        # (evaluation.py:359 shadows :353)
        return self._rels_top1 / self.total

    def top10(self) -> float:
        return self._top10 / self.total

    # -- multilabel thresholded precision/recall (ref :279-294) ----------

    def multiclasses_update(self, pr: np.ndarray, gt: np.ndarray,
                            thr: float = 0.3) -> None:
        pr = _sigmoid(np.asarray(pr))
        gt = np.asarray(gt)
        pred = (pr >= thr).astype(float)
        self._tp += int(np.sum(pred[gt == 1] == gt[gt == 1]))
        self._fp_tp += int(np.sum(pred))
        self._fn_tp += int(np.sum(gt))

    def precision(self) -> float:
        return self._tp / self._fp_tp

    def recall(self) -> float:
        return self._tp / self._fn_tp

    # -- exact-set multilabel top-k (ref :306-318) -----------------------

    def multiclass_max_update(self, pr: np.ndarray, gt: np.ndarray) -> None:
        pr = np.asarray(pr)
        gt = np.asarray(gt)
        for i in range(pr.shape[0]):
            n_labels = int(gt[i].sum())
            pred = np.sort(np.argsort(pr[i])[-n_labels:])
            true = np.sort(np.where(gt[i])[0])
            self._top1 += int(np.sum(pred == true))
            self.total += len(true)

    # -- prediction-time stats (ref :296-303) ----------------------------

    def times_update(self, pr_time: np.ndarray, gt_positions: np.ndarray) -> None:
        pr_time = np.asarray(pr_time)
        gt_positions = np.asarray(gt_positions)
        self._times_tp += list(pr_time[gt_positions == 1].ravel())
        self._times_f += list(pr_time[gt_positions != 1].ravel())

    def time_mean(self):
        return np.mean(self._times_tp), np.mean(self._times_f)

    def time_var(self):
        return np.var(self._times_tp), np.var(self._times_f)

    # -- embedding nearest-label (ref :321-327) --------------------------

    @staticmethod
    def closest_label(output: np.ndarray, embedded_labels: np.ndarray,
                      ret_dist: bool = False):
        t2v = np.asarray(output)[:, 0, :]
        emb = np.asarray(embedded_labels)
        dists = (
            -2 * t2v @ emb.T
            + (emb ** 2).sum(axis=1)
            + (t2v ** 2).sum(axis=1)[:, None]
        )
        order = np.argsort(dists, axis=1)
        return (order, dists) if ret_dist else order

    # -- per-pair global relationship vote (ref :273-277,362-363) --------

    def movie_rels(self) -> None:
        for _pair_id, scores in self.movie_paar.items():
            if int(np.argmax(scores)) == 0:
                self._rels_global += 1

    def rels_global(self) -> float:
        return self._rels_global / len(self.movie_paar)


class RelationshipsAcc:
    """Per-(pair, rel)-hash score accumulation across clips
    (ref evaluation.py:367-417)."""

    def __init__(self, n_rels: int):
        self.total = 0
        self._pr_probs: Dict[int, np.ndarray] = {}
        self._gt: Dict[int, int] = {}
        self._top1 = 0
        self._top3 = 0
        self.conf_mat = np.zeros((n_rels, n_rels))

    def update(self, pr_probs: np.ndarray, gt: np.ndarray, hashes) -> None:
        pr_probs = _sigmoid(_float_copy(pr_probs))
        gt = np.asarray(gt).astype(int).reshape(-1)
        hashes = np.asarray(hashes).astype(int).reshape(-1)
        assert len(pr_probs) == len(gt)
        assert -1 not in hashes
        for i, h in enumerate(hashes):
            h = int(h)
            if h in self._gt:
                self._pr_probs[h] += pr_probs[i]
            else:
                self._gt[h] = int(gt[i])
                self._pr_probs[h] = pr_probs[i].copy()

    def _compute(self) -> None:
        self.total = len(self._gt)
        for h, gt in self._gt.items():
            order = np.argsort(-self._pr_probs[h])
            self.conf_mat[gt, order[0]] += 1
            if gt == order[0]:
                self._top1 += 1
                self._top3 += 1
            elif gt in order[:3]:
                self._top3 += 1

    def top1(self) -> float:
        if self.total == 0:
            self._compute()
        return self._top1 / self.total

    def top3(self) -> float:
        if self.total == 0:
            self._compute()
        return self._top3 / self.total
