"""In-memory fake packed batches/tables (no disk), for compile checks,
sharding dry runs, and benchmarks."""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["make_tables", "make_batch", "make_structured_batch"]


def make_tables(
    spec, n_clips: int, n_tracks: int, seed: int = 0, dtype=np.float32
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "text": rng.standard_normal((n_clips, spec.text_dim)).astype(dtype),
        "visual": rng.standard_normal((n_clips, spec.visual_dim)).astype(dtype),
        "track": rng.standard_normal((n_tracks, spec.track_dim)).astype(dtype),
    }


def make_batch(
    spec,
    batch_size: int,
    n_clips: int,
    n_tracks: int,
    rels_n_clips: int = 18,
    n_hypotheses: int = 20,
    seed: int = 1,
) -> Dict[str, np.ndarray]:
    """A packed batch with the full int_rel_ch key set and plausible masks."""
    rng = np.random.default_rng(seed)
    B, T, R = batch_size, n_hypotheses, rels_n_clips
    C, NR = spec.n_classes, spec.n_rels
    feat_idx = np.stack(
        [
            rng.integers(0, n_clips, (B, T, R + 1)),
            rng.integers(0, n_tracks, (B, T, R + 1)),
            rng.integers(0, n_tracks, (B, T, R + 1)),
        ],
        axis=-1,
    ).astype(np.int32)
    mem_mask = np.zeros((B, T), np.float32)
    for i in range(B):
        mem_mask[i, : rng.integers(3, T + 1)] = 1
    rels_mask = (rng.random((B, T, R)) < 0.4).astype(np.int32)
    rels_mask[:, :, 0] = 1
    gt_tracks = np.zeros((B, 2), np.int32)
    second = rng.random(B) < 0.4
    gt_tracks[second, 1] = rng.integers(1, 6, int(second.sum()))
    return {
        "feat_idx": feat_idx,
        "mem_mask": mem_mask,
        "rels_mask": rels_mask,
        "labels": rng.integers(0, C, B).astype(np.int32),
        "rels_label": rng.integers(0, NR + 1, (B, T)).astype(np.int32),
        "gt_tracks": gt_tracks,
        "just_zeros": (rng.random(B) < 0.1),
        "hash_rel": rng.integers(-1, 50, B).astype(np.int32),
        "multilab_weights": (rng.random((B, C)) < 0.95).astype(np.float32),
    }


def make_structured_batch(
    spec,
    batch_size: int,
    n_clips: int,
    n_tracks: int,
    rels_n_clips: int = 18,
    n_hypotheses: int = 20,
    seed: int = 1,
    clips_per_movie: int = 256,
    neighborhood: int = 48,
    pool_range=(4, 24),
    names_range=(2, 6),
) -> Dict[str, np.ndarray]:
    """A packed batch with the REAL dataset's index locality.

    ``make_batch`` draws feat_idx IID over the whole tables, which is the
    right stress for kernel-dispatch gates but misrepresents the data for
    batch-local table projection (data/localize.py): in the real loader
    (data/dataset.py.__getitem__, ref classification_dataloader.py:
    291-616) every hypothesis of a sample shares the sample's GT clip,
    its track rows come from the interaction's few character names, and
    context rows are drawn from per-(pair, rel) pools of the SAME movie's
    clips (each contributing the pair's <=2 track rows).

    Modeled here: clip/track tables are partitioned into movies
    (``clips_per_movie`` clips, 2x that in tracks); each sample picks a
    movie, a ``neighborhood`` of its clips (the clips its characters
    share scenes in), 2-6 character track rows, and per-hypothesis
    context pools of ``pool_range`` rows drawn from the neighborhood with
    two neighborhood track rows each. The resulting batch-unique counts
    (~a few thousand rows vs tens of thousands of table rows) are the
    quantity the localization win depends on — report them next to any
    number measured with this generator.
    """
    rng = np.random.default_rng(seed)
    B, T, R = batch_size, n_hypotheses, rels_n_clips
    C, NR = spec.n_classes, spec.n_rels
    cpm = min(clips_per_movie, n_clips)
    n_movies = max(1, n_clips // cpm)
    tpm = max(2, n_tracks // n_movies)
    nb = min(neighborhood, cpm)

    feat_idx = np.zeros((B, T, R + 1, 3), np.int32)
    rels_mask = np.zeros((B, T, R), np.int32)
    for s in range(B):
        m = rng.integers(0, n_movies)
        c0, t0 = m * cpm, m * tpm
        hood = c0 + rng.choice(cpm, size=nb, replace=False)
        # two track rows per neighborhood clip (the pair's tracks there)
        hood_tracks = t0 + rng.integers(0, tpm, size=(nb, 2))
        gt_clip = hood[0]
        n_names = rng.integers(names_range[0], names_range[1] + 1)
        name_tracks = t0 + rng.integers(0, tpm, size=n_names)
        pairs = [
            (a, b)
            for a in range(n_names)
            for b in range(n_names)
            if a != b
        ]
        for t in range(T):
            a, b = pairs[t % len(pairs)]
            feat_idx[s, t, 0] = (gt_clip, name_tracks[a], name_tracks[b])
            pool = rng.integers(pool_range[0], pool_range[1] + 1)
            take = min(pool, R)
            picks = rng.choice(nb, size=take, replace=False)
            feat_idx[s, t, 1 : take + 1, 0] = hood[picks]
            feat_idx[s, t, 1 : take + 1, 1:] = hood_tracks[picks]
            rels_mask[s, t, :take] = 1

    mem_mask = np.zeros((B, T), np.float32)
    for i in range(B):
        mem_mask[i, : rng.integers(3, T + 1)] = 1
    gt_tracks = np.zeros((B, 2), np.int32)
    second = rng.random(B) < 0.4
    gt_tracks[second, 1] = rng.integers(1, 6, int(second.sum()))
    return {
        "feat_idx": feat_idx,
        "mem_mask": mem_mask,
        "rels_mask": rels_mask,
        "labels": rng.integers(0, C, B).astype(np.int32),
        "rels_label": rng.integers(0, NR + 1, (B, T)).astype(np.int32),
        "gt_tracks": gt_tracks,
        "just_zeros": (rng.random(B) < 0.1),
        "hash_rel": rng.integers(-1, 50, B).astype(np.int32),
        "multilab_weights": (rng.random((B, C)) < 0.95).astype(np.float32),
    }
