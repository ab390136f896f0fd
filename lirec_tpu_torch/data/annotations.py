"""Interaction mining over MovieGraphs clip graphs.

Builds the framework's central annotation object — an interaction instance
with its time window, participating characters, directed name-pair
hypotheses ("triplets"), windowed face tracks, and relationship history —
with the exact semantics of the reference's `AnnotatedInter` /
`load_annotated_inter` (ref `utils/util_functions.py:53-239,454-600`).

Randomness (multi-label relationship imputation) is drawn from an explicit
`numpy.random.Generator` instead of the reference's reseeded global RNG
(ref util_functions.py:461, 73, 236).
"""

from __future__ import annotations

import json
import os
import os.path as ops
from collections import Counter, defaultdict
from itertools import combinations
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from lirec_tpu_torch.data import graphs as graphs_lib
from lirec_tpu_torch.data import vocab as vocab_lib

__all__ = [
    "RelationshipHistory",
    "InteractionSample",
    "MiningResult",
    "load_face_tracks",
    "mine_interactions",
]


class RelationshipHistory:
    """Per-(movie, ordered name pair) relationship labels across scenes
    (ref utils/util_functions.py:53-75)."""

    def __init__(self, rels_name: str, scene_idx: int):
        self.rels_name = rels_name
        self.scenes = {scene_idx}
        self.rel2scenes: Dict[str, List[int]] = defaultdict(list)
        self._scene2rel: Dict[int, List[str]] = defaultdict(list)
        self.rel2scenes[rels_name].append(scene_idx)
        self._scene2rel[scene_idx].append(rels_name)

    def append_scene(self, rels_name: Optional[str], scene_idx: int) -> None:
        # None means "extend with the current label" (ref :62-69)
        if rels_name not in (self.rels_name, None):
            self.rels_name = rels_name
        if scene_idx in self.scenes and self.rels_name in self._scene2rel[scene_idx]:
            return
        self.scenes.add(scene_idx)
        self.rel2scenes[self.rels_name].append(scene_idx)
        self._scene2rel[scene_idx].append(self.rels_name)

    def scene2rel(self, scene_idx: int, rng: np.random.Generator) -> str:
        if scene_idx in self._scene2rel:
            labels = self._scene2rel[scene_idx]
            if len(labels) == 1:
                return labels[0]
            return labels[int(rng.integers(len(labels)))]
        return "None"

    def scene_labels(self, scene_idx: int) -> List[str]:
        return list(self._scene2rel.get(scene_idx, ()))


class InteractionSample:
    """One annotated interaction (ref utils/util_functions.py:79-239)."""

    def __init__(self, clip: graphs_lib.ClipGraph, node_id: int):
        self.inter_node = clip.G.node[node_id]
        self.video_descr = clip.video
        self.time_node: Optional[dict] = None
        self.ftracks: Dict[str, list] = defaultdict(list)
        self.id2names: Dict[int, str] = {}
        self.name2id: Dict[str, int] = {}
        self.bi = False
        self.id: Optional[int] = None
        self.triplets: Dict[int, Dict[int, str]] = {}
        self.relships: Dict[int, List[str]] = {}
        self._find_time(clip, node_id)
        self._find_names(clip, node_id)

    def _find_time(self, clip: graphs_lib.ClipGraph, node_id: int) -> None:
        for neighbor in clip.G.neighbors(node_id):
            if clip.G.node[neighbor].get("type") == "time":
                self.time_node = clip.G.node[neighbor]
                # Data fix carried over from the reference for a broken
                # annotation (ref util_functions.py:103-106).
                if (
                    self.video_descr["movie"] == "tt0119822"
                    and "scene-006.ss-0045.es-0048" in self.video_descr["fname"][0]
                    and clip.G.node[neighbor].get("start") == 9
                ):
                    self.time_node = {"start": 8, "end": 9, "type": "time"}
                break

    def _find_names(self, clip: graphs_lib.ClipGraph, node_id: int) -> None:
        for entity in clip.get_node_ids_of_type("entity"):
            if clip.G.has_edge(node_id, entity) or clip.G.has_edge(entity, node_id):
                name = clip.G.node[entity]["name"].lower()
                self.name2id[name] = entity
                self.id2names[entity] = name

    def order_names(self, clip: graphs_lib.ClipGraph, node_id: int) -> None:
        """Enumerate directed participant pairs; fall back to single-person
        entries when no pair is connected (ref util_functions.py:128-155)."""
        counter = 0
        for id1, id2 in combinations(self.name2id.values(), 2):
            # NOTE: reference resets `bi` per pair, so only the LAST pair's
            # bidirectionality survives (ref :132-135); kept bug-for-bug.
            self.bi = (
                clip.G.has_edge(id1, node_id)
                and clip.G.has_edge(node_id, id2)
                and clip.G.has_edge(id2, node_id)
                and clip.G.has_edge(node_id, id1)
            )
            name1, name2 = self.id2names[id1], self.id2names[id2]
            if clip.G.has_edge(id1, node_id) and clip.G.has_edge(node_id, id2):
                self.triplets[counter] = {0: name1, 1: name2}
                counter += 1
            if clip.G.has_edge(id2, node_id) and clip.G.has_edge(node_id, id1):
                self.triplets[counter] = {0: name2, 1: name1}
                counter += 1
        if not self.triplets:
            for name_id in self.name2id.values():
                if clip.G.has_edge(name_id, node_id):
                    self.triplets[counter] = {0: self.id2names[name_id]}
                    counter += 1
                if clip.G.has_edge(node_id, name_id):
                    self.triplets[counter] = {1: self.id2names[name_id]}
                    counter += 1

    def add_face_tracks(self, tracks: dict) -> None:
        """Clip per-name face tracks to the interaction time window via
        binary search (ref util_functions.py:157-187)."""
        if self.time_node is None:
            for name in self.id2names.values():
                self.ftracks.setdefault(name, [])
            return
        for idx, track in enumerate(tracks["ftracks"]):
            track_name = tracks["names"][idx] if idx < len(tracks["names"]) else None
            for name in self.id2names.values():
                if track_name is not None and (
                    track_name in name.split() or track_name == name
                ):
                    break
            else:
                continue
            if not track:
                continue
            start_time = max(self.time_node["start"], track[0]["timestamp"])
            end_time = min(self.time_node["end"], track[-1]["timestamp"])
            if start_time >= end_time:
                continue

            def lower_bound(point: float) -> int:
                left, right = 0, len(track) - 1
                while left < right:
                    mid = (left + right) >> 1
                    if track[mid]["timestamp"] >= point:
                        right = mid
                    else:
                        left = mid + 1
                return left

            self.ftracks[name] += track[lower_bound(start_time): lower_bound(end_time) + 1]
        for name in self.id2names.values():
            if name not in self.ftracks:
                self.ftracks[name] = []

    def add_relationships(
        self,
        clip: graphs_lib.ClipGraph,
        node_id: int,
        dict_rel: Dict[Tuple[str, str], RelationshipHistory],
        rels_15: Dict[str, str],
        rels_opp: Dict[str, str],
    ) -> Dict[Tuple[str, str], RelationshipHistory]:
        """Record directed relationship edges for this clip and backfill the
        sample's per-triplet labels (ref util_functions.py:189-232)."""
        scene_idx = clip.video["scene"][0]
        for rel_node in clip.get_node_ids_of_type("relationship"):
            rel_name = rels_15[clip.G.node[rel_node]["name"]]
            for tripl_id, triplet in self.triplets.items():
                if len(triplet) != 2:
                    continue
                name1, name2 = triplet[0], triplet[1]
                id1, id2 = self.name2id[name1], self.name2id[name2]
                if clip.G.has_edge(id1, rel_node) and clip.G.has_edge(rel_node, id2):
                    fwd, bwd = (name1, name2), (name2, name1)
                elif clip.G.has_edge(id2, rel_node) and clip.G.has_edge(rel_node, id1):
                    fwd, bwd = (name2, name1), (name1, name2)
                else:
                    continue
                if fwd in dict_rel:
                    dict_rel[fwd].append_scene(rel_name, scene_idx)
                    dict_rel[bwd].append_scene(rels_opp[rel_name], scene_idx)
                else:
                    dict_rel[fwd] = RelationshipHistory(rel_name, scene_idx)
                    dict_rel[bwd] = RelationshipHistory(rels_opp[rel_name], scene_idx)
        # carry every known pair's current label into this scene (ref :221-223)
        for hist in dict_rel.values():
            if scene_idx not in hist.scenes:
                hist.append_scene(None, scene_idx)
        for tripl_id, triplet in self.triplets.items():
            if len(triplet) == 1:
                continue
            key = (triplet[0], triplet[1])
            if key in dict_rel:
                self.relships[tripl_id] = dict_rel[key]._scene2rel[scene_idx]
        return dict_rel

    def get_relship_by_id(self, triplet_id: int, rng: np.random.Generator) -> str:
        if triplet_id in self.relships:
            labels = self.relships[triplet_id]
            if len(labels) == 1:
                return labels[0]
            return labels[int(rng.integers(len(labels)))]
        return "None"


def load_face_tracks(
    ftrack_ids_dir: str, ftracks_dir: str, movie_idxs: Sequence[str]
) -> Dict[Tuple[str, str], dict]:
    """Per-(movie, scene-basename) face tracks with resolved character names
    (ref utils/util_functions.py:570-600)."""
    out: Dict[Tuple[str, str], dict] = {}
    for movie_idx in movie_idxs:
        ids_path = ops.join(ftrack_ids_dir, "%s.json" % movie_idx)
        try:
            with open(ids_path, "r") as f:
                ftracks_ids = json.load(f)
        except FileNotFoundError:
            ftracks_ids = {}
        movie_dir = ops.join(ftracks_dir, movie_idx)
        if not os.path.isdir(movie_dir):
            continue
        for scene_file in os.listdir(movie_dir):
            with open(ops.join(movie_dir, scene_file), "r") as f:
                ftracks = json.load(f)["ftracks"]
            scene_key = ops.splitext(scene_file)[0]
            if scene_key in ftracks_ids:
                names = [
                    name.lower() if name is not None else None
                    for name in ftracks_ids[scene_key]
                ]
                out[(movie_idx, scene_key)] = {
                    "ftracks": ftracks, "names": names, "check": ["+", ()],
                }
            elif not ftracks:
                out[(movie_idx, scene_key)] = {
                    "ftracks": ftracks, "names": [], "check": ["+", ()],
                }
            else:
                out[(movie_idx, scene_key)] = {
                    "ftracks": ftracks,
                    "names": ["other"] * len(ftracks),
                    "check": ["-", (movie_idx, scene_key, len(ftracks))],
                }
    return out


class MiningResult:
    def __init__(
        self,
        interactions: List[InteractionSample],
        rels: Dict[str, Dict[Tuple[str, str], RelationshipHistory]],
        rels_list: List[str],
        rels_opp: Dict[str, Optional[str]],
    ):
        self.interactions = interactions
        self.rels = rels
        self.rels_list = rels_list
        self.rels_opp = rels_opp

    def stats(self) -> Dict[str, object]:
        rel_counter: Dict[str, int] = defaultdict(int)
        for movie_rels in self.rels.values():
            for hist in movie_rels.values():
                rel_counter[hist.rels_name] += 1
        return {
            "n_interactions": len(self.interactions),
            "interaction_census": Counter(
                s.inter_node["name"] for s in self.interactions
            ),
            "relationship_census": dict(rel_counter),
        }


def mine_interactions(
    paths,
    movie_idxs: Union[str, List[str]] = "all",
    node_types: Tuple[str, ...] = ("interactions", "summary"),
    inter_class: str = "all",
    with_rels: bool = False,
) -> MiningResult:
    """Walk clip graphs and build `InteractionSample`s
    (ref utils/util_functions.py:454-567).

    `paths` is a `lirec_tpu_torch.config.Paths`. Note `node_types` entries are
    matched with the same substring semantics as the reference ('interactions'
    matches 'interaction' nodes; see graphs.ClipGraph.get_node_ids_of_type).
    """
    if movie_idxs is None:
        return MiningResult([], defaultdict(dict), [], {})
    if inter_class == "all":
        inter_names = set(
            vocab_lib.load_interaction_names(paths.labeled_interactions)[1]
        )
    else:
        inter_names = set(
            vocab_lib.load_interaction_names(paths.labeled_interactions)[0][
                inter_class
            ]
        )
    merged_clips = vocab_lib.load_merged_clips(paths.merged_videos)
    graphs_is_dir = os.path.isdir(paths.annotations)
    if isinstance(movie_idxs, str) and movie_idxs != "all":
        movie_list = [movie_idxs]
    elif movie_idxs == "all":
        if graphs_is_dir:
            movie_list = [
                f[: -len(".json")]
                for f in sorted(os.listdir(paths.annotations))
                if f.endswith(".json")
            ]
        else:
            # pickle source: enumerate its movies so face tracks load too
            movie_list = list(
                graphs_lib.load_mg_pickle(paths.annotations_pickle)
            )
    else:
        movie_list = list(movie_idxs)

    ftracks = load_face_tracks(paths.ftrack_ids, paths.ftracks, movie_list)
    rels_15, rels_opp = vocab_lib.load_relships(
        paths.relships2_15, paths.relships_opp
    )
    graph_source = (
        paths.annotations
        if os.path.isdir(paths.annotations)
        else paths.annotations_pickle
    )

    interactions: List[InteractionSample] = []
    dict_rels: Dict[str, Dict[Tuple[str, str], RelationshipHistory]] = defaultdict(dict)
    inter_id = 0
    for movie in graphs_lib.iter_movies(graph_source, movie_list):
        for clip in movie.clip_graphs.values():
            # merged multi-scene clips collapse to their representative scene
            # (ref util_functions.py:489-495)
            if len(clip.video["fname"]) > 1:
                for scene_idx in clip.video["scene"]:
                    if scene_idx in merged_clips.get(movie.imdb_key, {}):
                        clip.video["scene"] = [scene_idx]
                        clip.video["fname"] = [merged_clips[movie.imdb_key][scene_idx]]
                        break
                else:
                    continue
            for node_type in node_types:
                for node_id in clip.get_node_ids_of_type(node_type):
                    if clip.G.node[node_id]["name"] not in inter_names:
                        continue
                    sample = InteractionSample(clip, node_id)
                    scene_key = ops.splitext(clip.video["fname"][0])[0]
                    tracks = ftracks.get(
                        (movie.imdb_key, scene_key),
                        {
                            "ftracks": [],
                            "names": [],
                            "check": ["-", (movie.imdb_key, scene_key, "no file")],
                        },
                    )
                    sample.order_names(clip, node_id)
                    sample.add_face_tracks(tracks)
                    dict_rels[movie.imdb_key] = sample.add_relationships(
                        clip, node_id, dict_rels[movie.imdb_key], rels_15, rels_opp
                    )
                    sample.id = inter_id
                    inter_id += 1
                    interactions.append(sample)

    rels_opp_out: Dict[str, Optional[str]] = dict(rels_opp)
    rels_opp_out["None"] = None
    rels_list = list(rels_opp_out.keys())
    if with_rels:
        return MiningResult(interactions, dict_rels, rels_list, rels_opp_out)
    return MiningResult(interactions, defaultdict(dict), rels_list, rels_opp_out)
