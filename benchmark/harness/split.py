"""The benchmark's frozen generator of a split: structured packed samples
with the real loader's index locality, made from a seed.

A frozen, vectorised copy of ``make_structured_batch`` in
``lirec_tpu_torch/utils/fake_batch.py`` (same model of the data, drawn in
whole arrays instead of a loop per sample, so not bit for bit the
original's draws). Imports nothing of the program.

The model of the data (the real loader, ref classification_dataloader.py
291-616): the clip and track tables are cut into movies of
``clips_per_movie`` clips and twice that in tracks. Each sample picks a
movie, a ``neighborhood`` of its clips, 2-6 character track rows, and per
hypothesis a context pool of ``pool_range`` clips from the neighborhood,
each with two neighborhood track rows. Every hypothesis shares the
sample's ground-truth clip (slot 0); hypothesis t pairs the names of the
t-th ordered pair (cycling). Every seed gives the same sizes: only the
values move.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np

__all__ = ["make_split", "split_batches"]


def _pair_table(max_names: int, n_hyp: int) -> np.ndarray:
    """[max_names + 1, n_hyp, 2]: for n names, the (a, b) of hypothesis t,
    the ordered pairs a != b in order, cycled."""
    out = np.zeros((max_names + 1, n_hyp, 2), np.int64)
    for n in range(2, max_names + 1):
        pairs = [(a, b) for a, b in itertools.product(range(n), repeat=2)
                 if a != b]
        for t in range(n_hyp):
            out[n, t] = pairs[t % len(pairs)]
    return out


def make_split(seed: int, n_samples: int, n_clips: int, n_tracks: int,
               n_classes: int, n_rels: int, rels_n_clips: int = 18,
               n_hypotheses: int = 20, clips_per_movie: int = 256,
               neighborhood: int = 48, pool_range=(4, 24),
               names_range=(2, 6), context: bool = True
               ) -> Dict[str, np.ndarray]:
    """`n_samples` packed samples in int_rel_ch's layout (feat_idx [N, T,
    1 + R, 3]), or with context=False in int_ch's ([N, T, 1, 3], no
    rels_mask). `n_rels`: the model's relationship heads (labels run over
    n_rels + 1 values, the last 'None')."""
    rng = np.random.default_rng(seed)
    N, T, R = n_samples, n_hypotheses, rels_n_clips
    cpm = min(clips_per_movie, n_clips)
    n_movies = max(1, n_clips // cpm)
    tpm = max(2, n_tracks // n_movies)
    nb = min(neighborhood, cpm)
    if nb < R:
        raise ValueError("a neighborhood of %d clips cannot fill %d context "
                         "slots" % (nb, R))

    movie = rng.integers(0, n_movies, N)
    c0, t0 = movie * cpm, movie * tpm
    # a neighborhood of nb distinct clips of the movie: the first nb of a
    # random order of its cpm clips
    order = np.argsort(rng.random((N, cpm), dtype=np.float32), axis=1)
    hood = c0[:, None] + order[:, :nb]                        # [N, nb]
    hood_tracks = t0[:, None, None] + rng.integers(0, tpm, (N, nb, 2))
    n_names = rng.integers(names_range[0], names_range[1] + 1, N)
    name_tracks = t0[:, None] + rng.integers(0, tpm, (N, names_range[1]))
    pairs = _pair_table(names_range[1], T)[n_names]           # [N, T, 2]
    rows = np.arange(N)[:, None]

    feat_idx = np.zeros((N, T, R + 1, 3), np.int32)
    feat_idx[:, :, 0, 0] = hood[:, :1]
    feat_idx[:, :, 0, 1] = name_tracks[rows, pairs[..., 0]]
    feat_idx[:, :, 0, 2] = name_tracks[rows, pairs[..., 1]]
    # per hypothesis a pool of `take` distinct neighborhood clips
    take = np.minimum(rng.integers(pool_range[0], pool_range[1] + 1, (N, T)),
                      R)
    picks = np.argsort(rng.random((N, T, nb), dtype=np.float32),
                       axis=2)[:, :, :R]                      # [N, T, R]
    rels_mask = (np.arange(R)[None, None, :] < take[..., None]).astype(
        np.int32)
    n_ix = np.arange(N)[:, None, None]
    ctx_clip = hood[n_ix, picks]
    ctx_tracks = hood_tracks[n_ix, picks]                     # [N, T, R, 2]
    keep = rels_mask.astype(bool)
    feat_idx[:, :, 1:, 0] = np.where(keep, ctx_clip, 0)
    feat_idx[:, :, 1:, 1] = np.where(keep, ctx_tracks[..., 0], 0)
    feat_idx[:, :, 1:, 2] = np.where(keep, ctx_tracks[..., 1], 0)

    mem_mask = (np.arange(T)[None, :]
                < rng.integers(3, T + 1, N)[:, None]).astype(np.float32)
    gt_tracks = np.zeros((N, 2), np.int32)
    second = rng.random(N) < 0.4
    gt_tracks[:, 1] = np.where(second, rng.integers(1, 6, N), 0)
    out = {
        "feat_idx": feat_idx,
        "mem_mask": mem_mask,
        "rels_mask": rels_mask,
        "labels": rng.integers(0, n_classes, N).astype(np.int32),
        "rels_label": rng.integers(0, n_rels + 1, (N, T)).astype(np.int32),
        "gt_tracks": gt_tracks,
        "just_zeros": rng.random(N) < 0.1,
        "hash_rel": rng.integers(-1, 50, N).astype(np.int32),
        "multilab_weights": (rng.random((N, n_classes)) < 0.95).astype(
            np.float32),
    }
    if not context:
        del out["rels_mask"]
        out["feat_idx"] = np.ascontiguousarray(feat_idx[:, :, :1])
    return out


def split_batches(split: Dict[str, np.ndarray], batch_size: int
                  ) -> List[Dict[str, np.ndarray]]:
    """The split cut into consecutive batches of `batch_size` rows (the
    last one ragged)."""
    n = len(split["labels"])
    return [{k: v[i:i + batch_size] for k, v in split.items()}
            for i in range(0, n, batch_size)]
