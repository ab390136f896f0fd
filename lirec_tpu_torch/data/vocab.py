"""Label vocabularies and split/metadata files.

Reproduces the on-disk formats and index-assignment order of the reference
loaders (ref `utils/util_functions.py:321-438,441-451,603-609`):

- ``all_train_set.txt``: one interaction per line, ``<name words> <count>
  <class>`` where class is ``t|v|m``; global indices are assigned in
  first-seen-class-then-line order, skipping the synthetic ``all`` bucket.
- ``merged_interactions.txt``: tab-separated ``merged_name\\traw1\\traw2...``;
  merged index = line number.
- ``intersections/intersected_*.csv``: visually-overlapping class lists.
- ``split.json``: ``{"train": [...], "val": [...], "test": [...]}``.
- ``relships_many2_15.txt`` / ``relships_15_opp.txt``: relationship mapping
  to 15 classes + per-class opposite direction.
"""

from __future__ import annotations

import csv
import json
import os
import re
from collections import defaultdict

import numpy as np
from typing import Dict, List, Tuple

# One smoke-test movie per split, matching the reference's hard-coded
# sanity_check short-circuit (ref utils/util_functions.py:322-327).
SANITY_MOVIES = {"train": "tt0108160", "val": "tt0108160", "test": "tt0120338"}
INTER_CLASS2IDX = {"t": 0, "v": 1, "m": 2}


def load_interaction_names(
    path: str,
    idx2inter_ret: bool = False,
):
    """Return (per-class interaction lists incl. 'all', name -> (global_idx,
    class_idx, local_idx)). Ref utils/util_functions.py:333-357.

    ``idx2inter_ret=True`` additionally returns the reverse map
    ``(class_letter, local_idx) -> name`` (ref :345-356; used by the text
    dataset's html debug mode)."""
    interactions: Dict[str, List[str]] = defaultdict(list)
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            cls = parts[-1]
            name = " ".join(parts[:-2])
            interactions[cls].append(name)
            interactions["all"].append(name)
    inter2idx: Dict[str, Tuple[int, int, int]] = {}
    idx2inter: Dict[Tuple[str, int], str] = {}
    global_idx = 0
    for cls, names in interactions.items():
        if cls == "all":
            continue
        for local_idx, name in enumerate(names):
            inter2idx[name] = (global_idx, INTER_CLASS2IDX[cls], local_idx)
            idx2inter[(cls, local_idx)] = name
            global_idx += 1
    if idx2inter_ret:
        return dict(interactions), inter2idx, idx2inter
    return dict(interactions), inter2idx


def load_merged_interactions(
    path: str,
) -> Tuple[Dict[str, str], Dict[str, int]]:
    """Return (raw name -> merged name, merged name -> merged idx).
    Ref utils/util_functions.py:360-372."""
    inter2mgd: Dict[str, str] = {}
    mgd2idx: Dict[str, int] = {}
    with open(path, "r") as f:
        for line_idx, line in enumerate(f):
            parts = line.rstrip("\n").split("\t")
            merged, raws = parts[0], parts[1:]
            mgd2idx[merged] = line_idx
            for raw in raws:
                inter2mgd[raw] = merged
    return inter2mgd, mgd2idx


def _read_iou_csv(path: str) -> Dict[str, List[str]]:
    iou: Dict[str, List[str]] = {}
    with open(path, "r") as f:
        for row in csv.reader(f):
            if row:
                iou[row[0]] = row[1:]
    return iou


def load_iou2_any(intersected_dir: str) -> Dict[str, List[str]]:
    """Global visually-overlapping-class map. Ref util_functions.py:375-381."""
    return _read_iou_csv(os.path.join(intersected_dir, "intersected_any.csv"))


def load_iou2_movies(intersected_dir: str) -> Dict[str, Dict[str, List[str]]]:
    """Per-movie overlap maps. Ref util_functions.py:384-396."""
    out = {}
    pattern = re.compile(r"intersected_(tt\d*)\.csv")
    for filename in os.listdir(intersected_dir):
        m = pattern.fullmatch(filename)
        if m is None:
            continue
        out[m.group(1)] = _read_iou_csv(os.path.join(intersected_dir, filename))
    return out


def load_iou2_clips(
    intersected_dir: str,
) -> Dict[Tuple[str, int], Dict[str, List[str]]]:
    """Per-(movie, scene) overlap maps. Ref util_functions.py:398-411."""
    out = {}
    pattern = re.compile(r"intersected_(tt\d*)_(\d*)\.csv")
    for filename in os.listdir(intersected_dir):
        m = pattern.fullmatch(filename)
        if m is None:
            continue
        key = (m.group(1), int(m.group(2)))
        out[key] = _read_iou_csv(os.path.join(intersected_dir, filename))
    return out


def load_split(path: str, mode: str, sanity_check: bool = False) -> List[str]:
    """Movie ids of a split; sanity mode returns one fixed movie per split
    (ref utils/util_functions.py:321-330)."""
    if sanity_check:
        return [SANITY_MOVIES["test" if mode == "test" else "train"]]
    with open(path, "r") as f:
        return json.load(f)[mode]


def load_relships(
    to15_path: str, opp_path: str
) -> Tuple[Dict[str, str], Dict[str, str]]:
    """(raw relationship name -> 15-class name, class -> opposite class).
    Ref utils/util_functions.py:427-438."""
    rels_to_15: Dict[str, str] = {}
    rels_opp: Dict[str, str] = {}
    with open(to15_path, "r") as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                rels_to_15[" ".join(parts[:-1])] = parts[-1]
    with open(opp_path, "r") as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                rels_opp[parts[0]] = parts[1]
    return rels_to_15, rels_opp


def load_merged_clips(path: str) -> Dict[str, Dict[int, str]]:
    """Multi-scene clip -> representative scene mapping; lines of
    ``movie_id scene_id-1 clip_name`` (ref utils/util_functions.py:441-451)."""
    merged: Dict[str, Dict[int, str]] = defaultdict(dict)
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 3 or "---" in parts[2]:
                continue
            merged[parts[0]][int(parts[1]) + 1] = parts[2]
    return dict(merged)


def load_orig_resolutions(path: str) -> Dict[str, List[int]]:
    """movie -> [height, width] (ref utils/util_functions.py:603-609)."""
    out = {}
    with open(path, "r") as f:
        for line in f:
            movie, h, w = line.strip().split()
            out[movie] = [int(h), int(w)]
    return out


def build_interidx_to_mgdidx(
    inter2idx: Dict[str, Tuple[int, int, int]],
    inter2mgd: Dict[str, str],
    mgd2idx: Dict[str, int],
    inter_class: str,
):
    """Raw-interaction-index -> merged-index array.

    Reproduces the reference mapping including its collision quirk: for
    inter_class != 'all' the *local* index is used as the array position, so
    same-local-index entries from different classes overwrite each other in
    file iteration order (ref classification_dataloader.py:116-122); the
    dataset only looks up indices of its own class, so collisions are benign.
    """
    arr = np.zeros(len(inter2idx), dtype=int)
    pos = 0 if inter_class == "all" else -1
    for name, idxs in inter2idx.items():
        arr[idxs[pos]] = mgd2idx[inter2mgd[name]]
    return arr
