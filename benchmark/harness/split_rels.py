"""The benchmark's generator of a split with relationship hashes, in the
int_rels model's layout (the joint interaction and relationship model
without the grounding), made from a seed. Imports nothing of the program.

The model of the data (the real loader, ref classification_dataloader.py
188-262 and 356-420, as data/dataset.py ports it): the clip and track
tables are cut into movies of ``clips_per_movie`` clips and twice that in
tracks. A movie holds ``hashes_per_movie`` (pair, relationship) hashes;
each hash has a label among the model's relationships and its own pool of
``pool_range`` clips from a ``neighborhood`` of the movie's clips, each
with the pair's two track rows (``movie_ch1_ch2_rel``). Every hash has at
least one sample; the rest of the samples are spread over the hashes at
random, in random order. A sample's ground-truth row (slot 0) is one of
its hash's clips; its context (slots 1..R) is the hash's pool, all of it
where it holds at most R clips, else the loader's eval stride over it, so
the samples of one hash share their context as the loader's do. One sample
in ``none_every`` is labelled 'None' (the label n_rels, hash -1) and
draws its context from a pool of its own (``movie_ch1_ch2_none``). No
context is empty. Every seed gives the same sizes: only the values move.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["make_rels_split"]


def _stride(length: int, R: int) -> np.ndarray:
    """The loader's eval subsample of a context of `length` > R clips (ref
    classification_dataloader.py:229): R positions at a stride."""
    return np.arange(0, length, length // R)[:R]


def _pools(rng, n: int, movie: np.ndarray, cpm: int, tpm: int, nb: int,
           pool_range) -> tuple:
    """n pools of clips from a neighborhood of each one's movie: (rows [n,
    pool_range[1], 3] of (clip, track, track), sizes [n])."""
    sizes = rng.integers(pool_range[0], pool_range[1] + 1, n)
    order = np.argsort(rng.random((n, cpm), dtype=np.float32), axis=1)
    hood = order[:, :nb]
    pick = np.argsort(rng.random((n, nb), dtype=np.float32),
                      axis=1)[:, :pool_range[1]]
    rows = np.zeros((n, pool_range[1], 3), np.int64)
    rows[..., 0] = movie[:, None] * cpm + np.take_along_axis(hood, pick, 1)
    rows[..., 1:] = movie[:, None, None] * tpm + rng.integers(
        0, tpm, (n, pool_range[1], 2))
    return rows, sizes


def _context(rows: np.ndarray, sizes: np.ndarray, R: int):
    """Each pool's context as the loader's eval assembles it: ([n, R, 3]
    rows, [n, R] mask)."""
    n = len(sizes)
    ctx = np.zeros((n, R, 3), np.int64)
    mask = np.zeros((n, R), np.int32)
    for k in range(n):
        s = int(sizes[k])
        take = np.arange(s) if s <= R else _stride(s, R)
        ctx[k, :len(take)] = rows[k, take]
        mask[k, :len(take)] = 1
    return ctx, mask


def make_rels_split(seed: int, n_samples: int, n_clips: int, n_tracks: int,
                    n_classes: int, n_rels: int, rels_n_clips: int = 18,
                    hashes_per_movie: int = 48, none_every: int = 16,
                    clips_per_movie: int = 256, neighborhood: int = 48,
                    pool_range=(4, 24)) -> Tuple[Dict[str, np.ndarray], int]:
    """(split, n_hashes): `n_samples` packed samples in the int_rels
    layout, feat_idx [N, 1 + R, 3], rels_mask [N, R, 1], labels [N, 1 + R,
    1] (slot 0 the sample's interaction, the context slots' their clips'),
    rels_label [N] (n_rels: 'None'), hash_rel [N] (-1 for 'None'),
    just_zeros [N], multilab_weights [N, n_classes]; and the split's hash
    count. `n_rels`: the model's relationship heads."""
    rng = np.random.default_rng(seed)
    N, R = n_samples, rels_n_clips
    cpm = min(clips_per_movie, n_clips)
    n_movies = max(1, n_clips // cpm)
    tpm = max(2, n_tracks // n_movies)
    nb = min(neighborhood, cpm)
    if nb < pool_range[1]:
        raise ValueError("a neighborhood of %d clips cannot fill a pool of "
                         "%d" % (nb, pool_range[1]))
    H = n_movies * hashes_per_movie
    n_none = N // none_every
    if N - n_none < H:
        raise ValueError("%d labelled samples cannot cover %d hashes"
                         % (N - n_none, H))

    # the hashes: a movie, a label, a pool and its context each
    h_movie = np.repeat(np.arange(n_movies), hashes_per_movie)
    h_label = rng.integers(0, n_rels, H)
    h_rows, h_size = _pools(rng, H, h_movie, cpm, tpm, nb, pool_range)
    h_ctx, h_mask = _context(h_rows, h_size, R)

    # the samples: every hash once, the rest at random, the 'None' ones
    # last; then shuffled
    hashes = np.concatenate([np.arange(H),
                             rng.integers(0, H, N - n_none - H),
                             np.full(n_none, -1)])
    hashes = hashes[rng.permutation(N)]
    lab = hashes >= 0
    h = np.where(lab, hashes, 0)
    n_movie = np.where(lab, h_movie[h], rng.integers(0, n_movies, N))
    # the 'None' samples' own pools
    o_rows, o_size = _pools(rng, N, n_movie, cpm, tpm, nb, pool_range)
    o_rows[lab], o_size[lab] = h_rows[h[lab]], h_size[h[lab]]
    ctx, mask = h_ctx[h], h_mask[h]
    none_ctx, none_mask = _context(o_rows[~lab], o_size[~lab], R)
    ctx[~lab], mask[~lab] = none_ctx, none_mask
    # the ground-truth row: one clip of the sample's pool
    gt_at = (rng.random(N) * o_size).astype(np.int64)
    gt = o_rows[np.arange(N), gt_at]

    feat_idx = np.zeros((N, R + 1, 3), np.int32)
    feat_idx[:, 0] = gt
    feat_idx[:, 1:] = np.where(mask[..., None] > 0, ctx, 0)
    labels = np.zeros((N, R + 1, 1), np.int32)
    labels[:, 0, 0] = rng.integers(0, n_classes, N)
    labels[:, 1:, 0] = np.where(mask > 0, rng.integers(0, n_classes, (N, R)),
                                0)
    return {
        "feat_idx": feat_idx,
        "rels_mask": mask[..., None].astype(np.int32),
        "labels": labels,
        "rels_label": np.where(lab, h_label[h], n_rels).astype(np.int32),
        "hash_rel": hashes.astype(np.int32),
        "just_zeros": rng.random(N) < 0.1,
        "multilab_weights": (rng.random((N, n_classes)) < 0.95).astype(
            np.float32),
    }, H
