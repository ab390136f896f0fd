"""MovieGraphs clip/movie graphs over a minimal typed digraph.

The reference consumes a pickle of networkx-1.11 graphs
(ref `moviegraphs/py3loader/GraphClasses.py`, `utils/util_functions.py:414-424`).
This module reimplements only what the annotation-mining layer needs — typed
nodes, directed edges, successor/edge queries — with no networkx dependency,
and loads either:

- a directory of per-movie clip-graph JSON dumps (the original MovieGraphs
  annotation format, ref `GraphClasses.py:60-73`): one
  ``<movie>.json`` file holding a list of clip-graph dicts, or
- the ``mg3.pkl`` pickle, via a compatibility shim (`load_mg_pickle`).

Insertion order of nodes is preserved; the reference relied on dict order for
hypothesis enumeration, so all downstream orderings are deterministic given
the file order.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from collections import OrderedDict, defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Union

__all__ = [
    "Digraph",
    "ClipGraph",
    "MovieGraph",
    "load_graphs",
    "iter_movies",
    "get_relationship_directions",
    "load_movie_graph",
]


def get_relationship_directions(vocab: dict) -> Dict[str, str]:
    """relationship value -> 'directed' | 'undirected', from a MovieGraphs
    vocabulary dict (ref GraphClasses.py:44-58, which reads the global
    ``data_loaders.VOCAB``; here the vocab is an argument).

    Deliberate fix: the reference builds the dict but falls off the end
    without returning it (its only caller is commented out, so the bug is
    invisible there); this returns the mapping.
    """
    rel_directions: Dict[str, str] = {}
    for group in vocab.get("relationships", []):
        for entry in group.get("values", []):
            desc = entry.get("description", "")
            if "(directed)" in desc:
                rel_directions[entry["value"]] = "directed"
            elif "(undirected)" in desc:
                rel_directions[entry["value"]] = "undirected"
    return rel_directions


def load_movie_graph(movie: str, user_dirs: Sequence[str],
                     castlist: Optional[List[dict]] = None) -> "MovieGraph":
    """Build a MovieGraph from per-user annotation JSON dumps
    (ref GraphClasses.py:21-41: copy latest annots across users, then one
    ClipGraph per scene JSON with chids attached).

    Each directory in ``user_dirs`` is one annotator's dump for ``movie``
    (files named ``<sid>.json`` or ``scene-<sid>*.json``). When several
    users annotated the same scene, the most recently modified file wins —
    the behavior of the reference's ``copy_latest_annots``. Unparseable
    files are skipped with a warning (ref :38-39).
    """
    def scene_key(fname: str):
        """Normalized scene id: '5.json' and 'scene-5.json' (or
        'scene-005...') name the SAME scene, and numeric ids order
        numerically (2 before 10), not lexicographically."""
        stem = fname.split(".")[0]
        if stem.startswith("scene-"):
            stem = stem[len("scene-"):]
        return int(stem) if stem.isdigit() else stem

    latest: Dict[object, str] = {}  # scene key -> newest path
    for d in user_dirs:
        if not os.path.isdir(d):
            continue
        for fname in sorted(os.listdir(d)):
            if not fname.endswith(".json"):
                continue
            path = os.path.join(d, fname)
            key = scene_key(fname)
            if key not in latest or (
                os.path.getmtime(path) > os.path.getmtime(latest[key])
            ):
                latest[key] = path

    movie_graph = MovieGraph(movie, castlist=castlist)
    order = sorted(latest.items(), key=lambda kv: (isinstance(kv[0], str), kv[0]))
    for sid, path in order:
        try:
            with open(path) as f:
                graph_json = json.load(f)
            clip = ClipGraph(graph_json)
            if castlist is not None:
                clip.add_chid_to_entities(castlist)
            movie_graph.add_clip_graph(sid, clip)
        except (ValueError, KeyError):
            warnings.warn(
                "Failed to load or create CG from json file: %s" % path
            )
    return movie_graph


class Digraph:
    """Directed graph with per-node attribute dicts (insertion-ordered)."""

    def __init__(self) -> None:
        self.node: Dict[int, dict] = {}
        self._succ: Dict[int, set] = {}
        self._pred: Dict[int, set] = {}

    def add_node(self, nid: int, **attrs) -> None:
        if nid in self.node:
            self.node[nid].update(attrs)
        else:
            self.node[nid] = dict(attrs)
            self._succ[nid] = set()
            self._pred[nid] = set()

    def add_edge(self, u: int, v: int) -> None:
        if u in self.node and v in self.node:
            self._succ[u].add(v)
            self._pred[v].add(u)

    def has_edge(self, u: int, v: int) -> bool:
        return u in self._succ and v in self._succ[u]

    def neighbors(self, nid: int) -> List[int]:
        """Successors, matching networkx DiGraph.neighbors semantics."""
        return list(self._succ.get(nid, ()))

    def predecessors(self, nid: int) -> List[int]:
        return list(self._pred.get(nid, ()))

    def nodes(self) -> List[int]:
        return list(self.node)

    def edges(self) -> List[tuple]:
        """All (u, v) directed edges, u in insertion order."""
        return [(u, v) for u in self.node for v in sorted(self._succ[u])]

    def __contains__(self, nid: int) -> bool:
        return nid in self.node

    def __len__(self) -> int:
        return len(self.node)


class ClipGraph:
    """Story graph of one video clip.

    Construction from the MovieGraphs JSON dump follows the reference's node
    typing rules (ref GraphClasses.py:91-153): entity nodes keep
    ``name``/``node_id``; attribute nodes split ``subtype:text``; time nodes
    keep ``start``/``end``; situation/scene become synthetic nodes -1/-2.
    """

    def __init__(self, graph_json: dict):
        self.situation = graph_json.get("situation", "")
        self.scene_label = graph_json.get("scene", "")
        self.description = graph_json.get("sentence_description", "")
        self._set_video(graph_json["video"])
        self._build(graph_json)

    def _set_video(self, video_fnames: Union[str, Sequence[str]]) -> None:
        # video filename(s) look like ".../<movie>/scene-002.ss-0009.es-0020.mp4"
        # (ref GraphClasses.py:75-90); scene/ss/es parsed from the basename.
        if isinstance(video_fnames, str):
            video_fnames = [video_fnames]
        self.video = {"movie": "", "fname": [], "scene": [], "ss": 9999, "es": -1}
        movie = ""
        for vf in video_fnames:
            head, movie, fname = vf.rsplit("/", 2) if vf.count("/") >= 2 else (
                "",
                vf.rsplit("/", 2)[0] if "/" in vf else "",
                vf.rsplit("/", 1)[-1],
            )
            sc, ss, es = (
                int(part.split("-")[1]) for part in fname.split(".")[0:3]
            )
            self.video["fname"].append(fname)
            self.video["scene"].append(sc)
            self.video["ss"] = min(self.video["ss"], ss)
            self.video["es"] = max(self.video["es"], es)
        self.video["movie"] = movie

    def _build(self, graph_json: dict) -> None:
        G = Digraph()
        for node in graph_json.get("nodes", []):
            if not str(node.get("name", "")).strip():
                continue
            nid = node["id"]
            if nid in G:
                warnings.warn(
                    "duplicate node id %r in %s" % (nid, self.video["fname"])
                )
                continue
            ntype = node["type"]
            if ntype == "entity":
                G.add_node(nid, name=node["name"], node_id=node.get("node_id"))
            elif ntype == "attribute":
                subtype, text = "", node["name"]
                if ":" in node["name"]:
                    subtype, text = node["name"].split(":", 1)
                G.add_node(nid, name=text, subtype=subtype)
            elif ntype == "time":
                if "t_start" in node and "t_end" in node:
                    G.add_node(
                        nid,
                        name=node["name"],
                        start=node["t_start"],
                        end=node["t_end"],
                    )
                else:
                    G.add_node(nid, name=node["name"])
            else:
                G.add_node(nid, name=node["name"])
            G.add_node(
                nid,
                origtext=node["name"],
                type=ntype,
                pos=(node.get("x", 0), node.get("y", 0)),
            )
        if self.situation:
            G.add_node(
                -1, origtext=self.situation, name=self.situation,
                type="situation", pos=(0, 0),
            )
        if self.scene_label:
            G.add_node(
                -2, origtext=self.scene_label, name=self.scene_label,
                type="scene", pos=(0, 10),
            )
        for edge in graph_json.get("edges", []):
            if edge["source"] in G and edge["target"] in G:
                G.add_edge(edge["source"], edge["target"])
            else:
                warnings.warn(
                    "edge endpoint missing: %r -> %r"
                    % (edge["source"], edge["target"])
                )
        self.G = G

    # -- queries used by annotation mining ---------------------------------

    def node_type(self, nid: int) -> Optional[str]:
        attrs = self.G.node.get(nid)
        return attrs.get("type") if attrs else None

    def node_name(self, nid: int) -> Optional[str]:
        attrs = self.G.node.get(nid)
        return attrs.get("name") if attrs else None

    def get_node_ids_of_type(self, ntypes) -> List[int]:
        """Node ids whose type is `in` ntypes.

        Deliberately uses Python ``in`` so a *string* argument does substring
        matching — the reference depends on this: mining passes the string
        ``'interactions'``, which matches ``'interaction'`` nodes only by
        substring (ref GraphClasses.py:215-218, util_functions.py:455,507).
        """
        return [nid for nid in self.G.node if self.node_type(nid) in ntypes]

    # -- analysis/query API (ref GraphClasses.py:209-360) ------------------

    def get_nodes_of_type(self, ntype: str) -> List[str]:
        """Names of all nodes of exactly this type (ref :209-213)."""
        return [
            attrs["name"]
            for attrs in self.G.node.values()
            if attrs.get("type") == ntype
        ]

    def get_node_type_dict(self, ntypes=None):
        """type -> list of node names (ref :220-232)."""
        from collections import defaultdict

        if not ntypes:
            ntypes = {attrs.get("type") for attrs in self.G.node.values()}
        out = defaultdict(list)
        for ntype in ntypes:
            out[ntype] = self.get_nodes_of_type(ntype)
        return out

    def get_neighbors(
        self, nid: int, ntypes=None, return_names: bool = False,
        return_ntypes: bool = False,
    ):
        """Successors, optionally filtered by type / decorated with
        names/types (ref :234-255)."""
        ids = self.G.neighbors(nid)
        if ntypes:
            ids = [n for n in ids if self.node_type(n) in ntypes]
        if return_names and return_ntypes:
            return [(n, self.node_name(n), self.node_type(n)) for n in ids]
        if return_names:
            return [(n, self.node_name(n)) for n in ids]
        if return_ntypes:
            return [(n, self.node_type(n)) for n in ids]
        return ids

    def verify_node_name(self, nid: int, expected: str) -> bool:
        """True iff the node exists and carries this name (the verify form
        of ref GraphClasses.py:175-190)."""
        return self.node_name(nid) == expected and nid in self.G

    def get_topic(self, nid: int) -> List[str]:
        """Topic names attached to an interaction (ref :257-261)."""
        return [name for _n, name in self.get_neighbors(
            nid, ntypes=["topic"], return_names=True)]

    def get_aux_info(self, nid: Optional[int] = None, ntypes=(),
                     return_names: bool = True):
        """Auxiliary nodes (situation/scene/... types) for the clip or a
        node's neighborhood (ref :263-286, simplified to the query surface)."""
        if nid is None:
            ids = self.get_node_ids_of_type(ntypes) if ntypes else list(
                self.G.node
            )
        else:
            ids = [n for n in self.get_neighbors(nid, ntypes=ntypes or None)]
        if return_names:
            return [(n, self.node_name(n)) for n in ids]
        return ids

    def get_characters(self, only_entities: bool = False) -> List[str]:
        """Entity names in the clip (ref :308-334, simplified to the
        entity-node surface)."""
        del only_entities
        return self.get_nodes_of_type("entity")

    def find_all_triplets(
        self, int_or_rel: str = "relationship",
        collapse_bidirectional: bool = False, return_names: bool = False,
    ):
        """(entity, interaction/relationship, entity) directed triplets
        (ref :336-360)."""
        triplets = []
        entity_ids = set(self.get_node_ids_of_type("entity"))
        for mid in self.get_node_ids_of_type(int_or_rel):
            sources = [
                n for n in self.G.predecessors(mid) if n in entity_ids
            ]
            targets = [
                n for n in self.G.neighbors(mid) if n in entity_ids
            ]
            for s in sources:
                for t in targets:
                    if s == t:
                        continue
                    if collapse_bidirectional and (t, mid, s) in triplets:
                        continue
                    triplets.append((s, mid, t))
        if return_names:
            return [
                (self.node_name(s), self.node_name(m), self.node_name(t))
                for s, m, t in triplets
            ]
        return triplets

    def check_graph_contains_attribute(self, ch_node: int, subtype: str,
                                       val=None) -> bool:
        """Does this character have an attribute of the given subtype
        (optionally with a given value)? (ref :362-377)"""
        for n in self.get_neighbors(ch_node, ntypes=["attribute"]):
            attrs = self.G.node[n]
            if attrs.get("subtype") == subtype and (
                val is None or attrs.get("name") == val
            ):
                return True
        return False

    def check_graph_contains_relationship(self, ch_node_pair, val=None) -> bool:
        """Directed relationship between a character pair (ref :379-393)."""
        a, b = ch_node_pair
        for s, mid, t in self.find_all_triplets("relationship"):
            if (s, t) == (a, b) and (
                val is None or self.node_name(mid) == val
            ):
                return True
        return False

    def find_all_entity_attribute_pairs(self, subtypes=(), return_names=False):
        """(entity, attribute) node pairs, optionally filtered by attribute
        subtype (ref GraphClasses.py:288-306)."""
        pairs = []
        for eid in self.get_node_ids_of_type("entity"):
            for aid in set(self.G.neighbors(eid)) | set(
                self.G.predecessors(eid)
            ):
                attrs = self.G.node[aid]
                if attrs.get("type") != "attribute":
                    continue
                if subtypes and attrs.get("subtype") not in subtypes:
                    continue
                pairs.append((eid, aid))
        if return_names:
            return [
                (self.node_name(e), self.G.node[a].get("subtype"),
                 self.node_name(a))
                for e, a in pairs
            ]
        return pairs

    def new_nodeid(self) -> int:
        """Smallest unused non-negative node id (ref :395-399)."""
        used = set(self.G.node)
        nid = 0
        while nid in used:
            nid += 1
        return nid

    # -- authoring/castlist API (runs when building the graph pickle, never
    # at train/eval time; ref GraphClasses.py:155-174,424-474,572-590) ------

    def add_chid_to_entities(self, castlist: List[dict]) -> None:
        """Attach the castlist character id to every entity node: the
        entity's ``node_id`` indexes the castlist; out-of-range ids are
        unlisted characters, marked '---' (ref :155-166)."""
        for nid in self.G.nodes():
            if self.node_type(nid) == "entity":
                node_id = self.G.node[nid].get("node_id")
                if node_id is not None and node_id < len(castlist):
                    self.G.node[nid]["chid"] = castlist[node_id]["chid"]
                else:
                    self.G.node[nid]["chid"] = "---"

    def check_chid_mappings(self, castlist: List[dict],
                            verbose: bool = True) -> List[tuple]:
        """Entity -> chid -> castlist-name audit table (ref :168-174,
        which only prints; returned here so callers can assert on it)."""
        rows = []
        for nid in self.G.nodes():
            if self.node_type(nid) == "entity":
                chid = self.G.node[nid].get("chid")
                names = [c["name"] for c in castlist if c["chid"] == chid]
                rows.append((nid, self.node_name(nid), chid, names))
                if verbose:
                    print("%4d | %-40s | %-15s | %s" % rows[-1])
        return rows

    def resolve_edges(self, rel_directions: Optional[Dict[str, str]] = None
                      ) -> None:
        """Fix up missing edge information (ref :424-474):

        1. make entity<->attribute edges bidirectional;
        2. flag redundant same-name relationship/interaction nodes between
           the same entity pair (`check_triplets_collapse`);
        3. (transitivity collapse: not implemented in the reference either);
        4. force relationships the vocabulary marks undirected to be
           bidirectional, and reject undirected edges on directed ones.
        """
        # 1. attributes bidirectional (ref :433-438)
        for u, v in list(self.G.edges()):
            tu, tv = self.node_type(u), self.node_type(v)
            if tu == "entity" and tv == "attribute":
                self.G.add_edge(v, u)
            if tv == "entity" and tu == "attribute":
                self.G.add_edge(u, v)

        # 2. redundant mediator nodes (ref :440-455). Deliberate fix: the
        # reference compares t1[2] == t1[0] (a self-loop, which
        # find_all_triplets already excludes, so its check can never fire —
        # its own TODO notes the bug); the intended t1[2] == t2[0] is used.
        self.check_triplets_collapse("relationship")
        self.check_triplets_collapse("interaction")

        # 4. vocabulary-declared directions (ref :461-474)
        if rel_directions:
            rel_triplets = self.find_all_triplets("relationship")
            for e1, rel, e2 in rel_triplets:
                direction = rel_directions.get(self.node_name(rel))
                if direction == "directed":
                    if (e2, rel, e1) in rel_triplets:
                        raise RuntimeError(
                            "should be directed, was undirected")
                elif direction == "undirected":
                    if (e2, rel, e1) not in rel_triplets:
                        self.G.add_edge(e2, rel)
                        self.G.add_edge(rel, e1)

    def check_triplets_collapse(self, t_type: str) -> None:
        """Raise when two distinct same-name ``t_type`` nodes mediate the
        same entity pair in opposite directions — they should be one node
        (ref :440-452)."""
        import itertools

        triplets = self.find_all_triplets(t_type)
        for t1, t2 in itertools.combinations(triplets, 2):
            if (
                t1[1] != t2[1]
                and t1[0] == t2[2]
                and t1[2] == t2[0]
                and self.node_name(t1[1]) == self.node_name(t2[1])
            ):
                raise RuntimeError("Unnecessary extra %s node." % t_type)

    def fix_spelling(self, spell_checker) -> None:
        """Normalize every label through an injected spell checker
        (ref GraphClasses.py:476-509).

        Each label is lower-cased, split into ``\\w+`` words, each word
        replaced by ``spell_checker.correction(word)``, and re-joined with
        single spaces — so punctuation inside labels is dropped, exactly as
        in the reference. Changed labels print ORI/FIX lines. Applies to
        ``situation``, ``scene_label``, then attribute, interaction, and
        relationship node names in that order (three separate passes, like
        the reference, so the ORI/FIX print order matches). The checker is
        duck-typed (`correction(word) -> word`) and injected, as in the
        reference signature.
        """

        def fix_label(tag):
            original, corrected = [], []
            for word in re.findall(r"\w+", tag.lower()):
                original.append(word)
                corrected.append(spell_checker.correction(word))
            if corrected != original:
                # change report byte-parity with the reference (the golden
                # test compares captured stdout verbatim)
                print("ORI:", original)
                print("FIX:", corrected)
            return " ".join(corrected)

        self.situation = fix_label(self.situation)
        self.scene_label = fix_label(self.scene_label)
        for ntype in ("attribute", "interaction", "relationship"):
            for n in self.G.nodes():
                if self.node_type(n) == ntype:
                    self.G.node[n]["name"] = fix_label(self.G.node[n]["name"])

    def lemmatize(self, lemmatizer=None) -> None:
        """In-place lemmatization of all graph components
        (ref GraphClasses.py:514-525).

        The reference delegates to a module-global ``lemmatizer`` whose
        import is commented out of the release (ref GraphClasses.py:18), so
        calling the reference method raises ``NameError``. The protocol it
        expects is preserved here via injection: any object providing
        ``lemmatize_situation``/``lemmatize_scene`` (str -> str) and
        ``lemmatize_all_interactions``/``_attributes``/``_relationships``
        (graph mutated in place — node names may change, nodes may be
        deleted). With no lemmatizer the failure mode matches the
        reference's.
        """
        if lemmatizer is None:
            raise NameError(
                "lemmatize() needs a lemmatizer object: the reference's "
                "'lemmatizer' module is absent from the release "
                "(ref GraphClasses.py:18 comments out its import)"
            )
        self.situation = lemmatizer.lemmatize_situation(self.situation)
        self.scene_label = lemmatizer.lemmatize_scene(self.scene_label)
        lemmatizer.lemmatize_all_interactions(self.G)
        lemmatizer.lemmatize_all_attributes(self.G)
        lemmatizer.lemmatize_all_relationships(self.G)

    def pprint(self) -> None:
        """Pretty-print the clip graph summary (ref :572-590)."""
        print("Clips:", self.video["fname"])
        print("Situation:", self.situation)
        print("Scene label:", self.scene_label)
        print("Description:", self.description[:80])
        print("Graph information:")
        for label, ntype in (
            ("Characters", "entity"),
            ("Relationships", "relationship"),
            ("Interactions", "interaction"),
            ("Attributes", "attribute"),
            ("Actions", "action"),
        ):
            count = sum(
                1 for n in self.G.nodes() if self.node_type(n) == ntype
            )
            print("  %s: %d" % (label, count))


class MovieGraph:
    """All clip graphs of one movie (ref GraphClasses.py:588-614)."""

    def __init__(self, imdb_key: str, castlist: Optional[List[dict]] = None):
        self.imdb_key = imdb_key
        if castlist:
            self.castlist = castlist
        self.clip_graphs: "OrderedDict[int, ClipGraph]" = OrderedDict()

    def attach_information(self, castlist=None, mergers=None,
                           scenes_gt=None, sid_clip=None) -> None:
        """Attach authoring-side metadata after construction
        (ref GraphClasses.py:601-609)."""
        if castlist:
            self.castlist = castlist
        if mergers:
            self.mergers = mergers
        if scenes_gt:
            self.scenes_gt = scenes_gt
        if sid_clip:
            self.sid_clip = sid_clip

    def add_clip_graph(self, idx: int, clip: ClipGraph) -> None:
        self.clip_graphs[idx] = clip

    def count_occurrences(self):
        """node type -> name -> count across all clips
        (ref GraphClasses.py:870+)."""
        from collections import Counter, defaultdict

        counts = defaultdict(Counter)
        for clip in self.clip_graphs.values():
            for attrs in clip.G.node.values():
                counts[attrs.get("type")][attrs.get("name")] += 1
        return {k: dict(v) for k, v in counts.items()}

    def characters(self):
        """All entity names seen across the movie."""
        names = set()
        for clip in self.clip_graphs.values():
            names.update(clip.get_characters())
        return sorted(names)

    # -- annotation preprocessing (ref GraphClasses.py:615-855) ------------

    def cleanup_empty(self, scenes_gt: Optional[dict] = None,
                      verbose: bool = False) -> int:
        """Drop empty clip graphs and (given a scenes_gt usability map)
        mostly-empty N/A-marked ones (ref :615-638). Returns #dropped."""
        before = len(self.clip_graphs)
        for sid in list(self.clip_graphs):
            cg = self.clip_graphs[sid]
            if not cg.situation and len(cg.G) == 0:
                del self.clip_graphs[sid]
        if scenes_gt:
            for sid, info in scenes_gt.items():
                if info.get("use") or sid not in self.clip_graphs:
                    continue
                cg = self.clip_graphs[sid]
                if len(cg.G) < 3 or not cg.situation:
                    del self.clip_graphs[sid]
        dropped = before - len(self.clip_graphs)
        if verbose:
            print("cleanup: %d -> %d clip graphs" % (before, len(self.clip_graphs)))
        return dropped

    def merge_clips(self, mergers, sid_clip, verbose: bool = False) -> dict:
        """Merge annotation groups spanning several scene ids: labels go to
        the largest graph, video info covers all member clips (ref :640-694)."""
        stats = {"zero": 0, "one": 0, "more": 0}
        for group in mergers:
            present = [s for s in group if s in self.clip_graphs]
            if not present:
                stats["zero"] += 1
                continue
            fnames = [sid_clip[s] for s in group if s in sid_clip]
            if len(present) == 1:
                stats["one"] += 1
                self.clip_graphs[present[0]]._set_video(fnames)
                continue
            stats["more"] += 1
            keep = max(present, key=lambda s: len(self.clip_graphs[s].G))
            situations, scenes, descriptions = [], [], []
            for s in present:
                cg = self.clip_graphs[s]
                situations.append(cg.situation)
                scenes.append(cg.scene_label)
                descriptions.append(cg.description)
                if s != keep:
                    del self.clip_graphs[s]
            kept = self.clip_graphs[keep]
            kept.situation = "; ".join(sorted(set(situations)))
            kept.scene_label = "; ".join(sorted(set(scenes)))
            kept.description = " ".join(descriptions)
            kept._set_video(fnames)
        if verbose:
            print("mergers:", stats)
        return stats

    STATIC_ATTRIBUTE_SUBTYPES = ("age", "gen", "eth", "pro")

    def mine_static_info(self) -> dict:
        """Per-scene static attribute/relationship observations, keyed by
        character name (ref :706-767)."""
        info = {"att": defaultdict(list), "rel": defaultdict(list)}
        for sid, cg in self.clip_graphs.items():
            for name, subtype, value in cg.find_all_entity_attribute_pairs(
                subtypes=self.STATIC_ATTRIBUTE_SUBTYPES, return_names=True
            ):
                info["att"][name].append((sid, subtype, value))
            for s, mid, t in cg.find_all_triplets("relationship"):
                info["rel"][(cg.node_name(s), cg.node_name(t))].append(
                    (sid, cg.node_name(mid))
                )
        self.static_info = {k: dict(v) for k, v in info.items()}
        return self.static_info

    def propagate_static_labels(self, verbose: bool = False) -> int:
        """Attach each character's majority static attribute (per subtype) to
        every clip they appear in without one (ref :769-855, simplified to
        name identity). Returns #attribute nodes added."""
        from collections import Counter

        info = getattr(self, "static_info", None) or self.mine_static_info()
        majority: Dict[tuple, str] = {}
        for name, observations in info["att"].items():
            by_subtype: Dict[str, Counter] = defaultdict(Counter)
            for _sid, subtype, value in observations:
                by_subtype[subtype][value] += 1
            for subtype, counter in by_subtype.items():
                majority[(name, subtype)] = counter.most_common(1)[0][0]
        added = 0
        for sid, cg in self.clip_graphs.items():
            for eid in cg.get_node_ids_of_type("entity"):
                name = cg.node_name(eid)
                have = {
                    subtype
                    for _e, subtype, _v in cg.find_all_entity_attribute_pairs(
                        subtypes=self.STATIC_ATTRIBUTE_SUBTYPES,
                        return_names=True,
                    )
                    if _e == name
                }
                for (mname, subtype), value in majority.items():
                    if mname != name or subtype in have:
                        continue
                    nid = cg.new_nodeid()
                    cg.G.add_node(
                        nid, name=value, subtype=subtype, type="attribute",
                        origtext="%s:%s" % (subtype, value), pos=(0, 0),
                    )
                    cg.G.add_edge(eid, nid)
                    added += 1
        if verbose:
            print("propagated %d static attribute nodes" % added)
        return added


def _movie_from_json(imdb_key: str, clips_json: list) -> MovieGraph:
    movie = MovieGraph(imdb_key)
    for idx, graph_json in enumerate(clips_json):
        try:
            clip = ClipGraph(graph_json)
        except (KeyError, ValueError) as err:
            warnings.warn("failed to build clip graph %d of %s: %s" % (idx, imdb_key, err))
            continue
        movie.add_clip_graph(idx, clip)
    return movie


def load_graphs(path: str) -> "OrderedDict[str, MovieGraph]":
    """Load all movie graphs from a JSON directory or an mg3-style pickle."""
    if os.path.isdir(path):
        movies: "OrderedDict[str, MovieGraph]" = OrderedDict()
        for filename in sorted(os.listdir(path)):
            if not filename.endswith(".json"):
                continue
            imdb_key = filename[: -len(".json")]
            with open(os.path.join(path, filename), "r") as f:
                movies[imdb_key] = _movie_from_json(imdb_key, json.load(f))
        return movies
    return load_mg_pickle(path)


def iter_movies(
    path: str, movie_idxs: Union[str, List[str]] = "all"
) -> Iterator[MovieGraph]:
    """Yield movie graphs, optionally restricted to given imdb keys
    (ref utils/util_functions.py:414-424)."""
    if os.path.isdir(path):
        if movie_idxs == "all":
            names = [
                f[: -len(".json")]
                for f in sorted(os.listdir(path))
                if f.endswith(".json")
            ]
        elif isinstance(movie_idxs, list):
            names = movie_idxs
        else:
            names = [movie_idxs]
        for imdb_key in names:
            with open(os.path.join(path, imdb_key + ".json"), "r") as f:
                yield _movie_from_json(imdb_key, json.load(f))
        return
    movies = load_mg_pickle(path)
    if movie_idxs == "all":
        yield from movies.values()
    elif isinstance(movie_idxs, list):
        for key in movie_idxs:
            yield movies[key]
    else:
        yield movies[movie_idxs]


# -- mg3.pkl compatibility ---------------------------------------------------


class _ShimUnpickler:
    """Loads the reference's mg3.pkl without networkx/GraphClasses installed.

    The pickle stores GraphClasses.MovieGraph/ClipGraph instances whose state
    includes networkx-1.11 DiGraph internals (plain dicts ``node``, ``adj``,
    ``succ``, ``pred``). Shim classes absorb ``__dict__`` and are converted
    to this module's types.
    """

    @staticmethod
    def load(path: str) -> "OrderedDict[str, MovieGraph]":
        import io
        import pickle

        class _Shim:
            def __init__(self, *a, **k):
                pass

            def __setstate__(self, state):
                self.__dict__.update(state)

        class _Unpickler(pickle.Unpickler):
            def find_class(self, module, name):
                if "networkx" in module or "GraphClasses" in module:
                    return type(name, (_Shim,), {})
                return super().find_class(module, name)

        with open(path, "rb") as f:
            raw = _Unpickler(io.BufferedReader(f), encoding="latin1").load()

        movies: "OrderedDict[str, MovieGraph]" = OrderedDict()
        for imdb_key, shim_movie in raw.items():
            movie = MovieGraph(getattr(shim_movie, "imdb_key", imdb_key))
            for idx, shim_clip in getattr(shim_movie, "clip_graphs", {}).items():
                clip = ClipGraph.__new__(ClipGraph)
                clip.situation = getattr(shim_clip, "situation", "")
                clip.scene_label = getattr(shim_clip, "scene_label", "")
                clip.description = getattr(shim_clip, "description", "")
                clip.video = shim_clip.video
                shim_g = shim_clip.G
                G = Digraph()
                node_attrs = getattr(shim_g, "node", None) or getattr(
                    shim_g, "_node", {}
                )
                adj = getattr(shim_g, "adj", None) or getattr(
                    shim_g, "succ", None
                ) or getattr(shim_g, "_adj", {})
                for nid, attrs in node_attrs.items():
                    G.add_node(nid, **attrs)
                for u, targets in adj.items():
                    for v in targets:
                        G.add_edge(u, v)
                clip.G = G
                movie.add_clip_graph(idx, clip)
            movies[imdb_key] = movie
        return movies


def load_mg_pickle(path: str) -> "OrderedDict[str, MovieGraph]":
    return _ShimUnpickler.load(path)
