"""Synthetic MovieGraphs-format fixture generator.

The reference consumes an 80 GB feature drop that is not available here; this
module writes a miniature dataset in the *exact same on-disk layout* (ref
`mixed_utils/update_arg_pars.py:33-67` path map, `README.md:16-24`):

```
<root>/others/{all_train_set.txt, merged_interactions.txt, split.json,
               relships_many2_15.txt, relships_15_opp.txt,
               use_vid_for_moviegraphs, org_res.txt, graphs/<movie>.json}
<root>/intersections/intersected_{any,<movie>,<movie>_<scene>}.csv
<root>/dialogs/<movie>/<clip>.webvtt
<root>/frame2time/<movie>/<clip>.matidx
<root>/features/spat_i3d/<movie>/<clip>.npy             [T, C, h, w]
<root>/features/bert/bert_base/<movie>/<movie>_<sss>.{npy,token2idx}
<root>/ftracks/<movie>/<clip>.json
<root>/ftrack_ids/<movie>.json
```

Movie ids intentionally include the reference's hard-coded sanity-check
movies (ref utils/util_functions.py:322-327) so smoke mode works unchanged.
"""

from __future__ import annotations

import json
import os
import os.path as ops
from typing import Dict, List

import numpy as np

from lirec_tpu_torch import config as config_lib

__all__ = ["SyntheticSpec", "generate", "make_config"]

RAW_INTERACTIONS = [
    ("talks to", "t"),
    ("asks", "t"),
    ("informs", "t"),
    ("explains to", "t"),
    ("walks with", "v"),
    ("hugs", "v"),
    ("watches", "v"),
    ("kisses", "v"),
    ("greets", "m"),
    ("helps", "m"),
    ("argues with", "m"),
    ("listens to", "m"),
]
MERGED_GROUPS = {
    "communicates": ["talks to", "asks", "informs", "explains to"],
    "moves with": ["walks with"],
    "shows affection": ["hugs", "kisses"],
    "observes": ["watches", "listens to"],
    "greets": ["greets"],
    "helps": ["helps"],
    "argues with": ["argues with"],
}
RAW_RELS = {
    "good friend": "friend",
    "friend": "friend",
    "mother": "parent",
    "father": "parent",
    "son": "child",
    "boss": "boss",
    "worker": "worker",
    "husband": "spouse",
    "wife": "spouse",
}
REL_OPPOSITES = {
    "friend": "friend",
    "parent": "child",
    "child": "parent",
    "boss": "worker",
    "worker": "boss",
    "spouse": "spouse",
}
CAST = ["alice smith", "bob jones", "carol lee"]


class SyntheticSpec:
    def __init__(
        self,
        movies: Dict[str, List[int]] = None,
        duration: int = 12,
        fps: int = 16,
        grid_hw=(3, 4),
        resolution=(240, 320),
        text_dim: int = 16,
        visual_dim: int = 32,
        text_layers: int = 4,
        seed: int = 0,
        scenes: List[int] = None,
        extra_rel_p: float = 0.0,
    ):
        # split -> movies; ids match the reference sanity movies
        self.movies = movies or {
            "train": ["tt0108160"],
            "val": ["tt1454029"],
            "test": ["tt0120338"],
        }
        self.duration = duration
        self.fps = fps
        self.grid_hw = grid_hw
        self.resolution = resolution
        self.text_dim = text_dim
        self.visual_dim = visual_dim
        self.text_layers = text_layers
        self.seed = seed
        # per-movie scene ids; more scenes -> recurring pairs accumulate
        # >rels_n_clips context clips, exercising train-time subsampling
        self.scenes = scenes or [2, 4, 6, 8, 10, 12, 14, 16]
        # probability of a second relationship label on the same pair in a
        # scene (multi-label scenes drive the train-time label draws)
        self.extra_rel_p = extra_rel_p


def make_config(root: str, spec: SyntheticSpec = None, **kw) -> config_lib.ExperimentConfig:
    """ExperimentConfig pointing at a generated synthetic root."""
    spec = spec or SyntheticSpec()
    cfg = config_lib.ExperimentConfig(
        paths=config_lib.Paths(data_root=root, store_root=ops.join(root, "store")),
        dims=config_lib.Dims(
            text_dim=spec.text_dim,
            visual_dim=spec.visual_dim,
            text_layers=spec.text_layers,
            joint_dim=16,
        ),
    )
    for key, val in kw.items():
        cfg = cfg.replace(**{key: val})
    return cfg


def _scene_fname(scene: int, duration: int) -> str:
    return "scene-%03d.ss-0000.es-%04d.mp4" % (scene, duration)


def _write_vocab(root: str) -> None:
    others = ops.join(root, "others")
    os.makedirs(others, exist_ok=True)
    with open(ops.join(others, "all_train_set.txt"), "w") as f:
        for name, cls in RAW_INTERACTIONS:
            f.write("%s %d %s\n" % (name, 10, cls))
    with open(ops.join(others, "merged_interactions.txt"), "w") as f:
        for merged, raws in MERGED_GROUPS.items():
            f.write("\t".join([merged] + raws) + "\n")
    with open(ops.join(others, "relships_many2_15.txt"), "w") as f:
        for raw, cls in RAW_RELS.items():
            f.write("%s %s\n" % (raw, cls))
    with open(ops.join(others, "relships_15_opp.txt"), "w") as f:
        for cls, opp in REL_OPPOSITES.items():
            f.write("%s %s\n" % (cls, opp))
    with open(ops.join(others, "use_vid_for_moviegraphs"), "w") as f:
        f.write("")


def _clip_graph_json(
    movie: str,
    scene: int,
    spec: SyntheticSpec,
    rng: np.random.Generator,
) -> dict:
    """One clip graph: 3 entities, 1-2 interactions with time nodes, one
    relationship edge; occasionally bidirectional."""
    duration = spec.duration
    fname = _scene_fname(scene, duration)
    nodes, edges = [], []
    # 2- or 3-person clips: with 2 entities the reference's per-pair `bi`
    # reset quirk (ref util_functions.py:132) lets bidirectionality survive
    n_cast = 2 if rng.random() < 0.5 else 3
    for eid, name in enumerate(CAST[:n_cast], start=1):
        nodes.append({"id": eid, "name": name, "type": "entity", "node_id": eid})

    n_inters = int(rng.integers(1, 4))
    raw_names = [RAW_INTERACTIONS[int(rng.integers(len(RAW_INTERACTIONS)))][0]
                 for _ in range(n_inters)]
    pairs = []
    for k, inter_name in enumerate(raw_names):
        inter_id, time_id = 10 + k, 20 + k
        nodes.append({"id": inter_id, "name": inter_name, "type": "interaction"})
        start = int(rng.integers(0, duration - 4))
        end = int(start + rng.integers(3, min(8, duration - start)))
        nodes.append(
            {
                "id": time_id, "name": "t", "type": "time",
                "t_start": start, "t_end": end,
            }
        )
        edges.append({"source": inter_id, "target": time_id})
        if rng.random() < 0.5:  # bias toward a recurring pair for long contexts
            a, b = 1, 2
        else:
            a, b = (int(x) for x in rng.permutation(n_cast)[:2] + 1)
        pairs.append((a, b))
        edges.append({"source": a, "target": inter_id})
        edges.append({"source": inter_id, "target": b})
        if rng.random() < 0.5:  # bidirectional
            edges.append({"source": b, "target": inter_id})
            edges.append({"source": inter_id, "target": a})
        if n_cast == 3 and rng.random() < 0.3:  # occasional third participant
            c = int(({1, 2, 3} - {a, b}).pop())
            edges.append({"source": c, "target": inter_id})

    rel_raw = list(RAW_RELS)[int(rng.integers(len(RAW_RELS)))]
    nodes.append({"id": 30, "name": rel_raw, "type": "relationship"})
    # bias the relationship onto an actual interaction pair so GT
    # relationship labels are frequently non-None
    if pairs and rng.random() < 0.7:
        ra, rb = pairs[0]
    else:
        ra, rb = 1, 2
    edges.append({"source": ra, "target": 30})
    edges.append({"source": 30, "target": rb})
    if rng.random() < spec.extra_rel_p:
        # second relationship label on the same pair: the scene becomes
        # multi-label and sample assembly draws which one to use
        other = list(RAW_RELS)[int(rng.integers(len(RAW_RELS)))]
        nodes.append({"id": 31, "name": other, "type": "relationship"})
        edges.append({"source": ra, "target": 31})
        edges.append({"source": 31, "target": rb})

    return {
        "situation": "synthetic",
        "scene": "synthetic scene",
        "sentence_description": "synthetic clip",
        "video": ["videos/%s/%s" % (movie, fname)],
        "nodes": nodes,
        "edges": edges,
    }


def _write_movie(root: str, movie: str, scenes: List[int], spec: SyntheticSpec,
                 rng: np.random.Generator) -> None:
    duration, fps = spec.duration, spec.fps
    gh, gw = spec.grid_hw
    res_h, res_w = spec.resolution

    clips = []
    ftrack_ids: Dict[str, List[str]] = {}
    os.makedirs(ops.join(root, "others", "graphs"), exist_ok=True)
    for sub in ("dialogs", "frame2time", "ftracks"):
        os.makedirs(ops.join(root, sub, movie), exist_ok=True)
    os.makedirs(ops.join(root, "features", "spat_i3d", movie), exist_ok=True)
    os.makedirs(ops.join(root, "features", "bert", "bert_base", movie), exist_ok=True)
    os.makedirs(ops.join(root, "ftrack_ids"), exist_ok=True)
    os.makedirs(ops.join(root, "intersections"), exist_ok=True)

    movie_inter_names = set()
    scene_inter_names: Dict[int, set] = {}
    for scene in scenes:
        graph = _clip_graph_json(movie, scene, spec, rng)
        clips.append(graph)
        inter_names = {
            n["name"] for n in graph["nodes"] if n["type"] == "interaction"
        }
        scene_inter_names[scene] = inter_names
        movie_inter_names |= inter_names
        fname = _scene_fname(scene, duration)
        stem = ops.splitext(fname)[0]

        # frame2time (.matidx): one line per frame at `fps`
        n_frames = duration * fps
        with open(ops.join(root, "frame2time", movie, stem + ".matidx"), "w") as f:
            for frame in range(n_frames + 1):
                f.write("%d %.3f\n" % (frame, frame / fps))

        # I3D features: [T, C, h, w]; T covers int(frame * sampling_fr) range
        t_feat = int(n_frames * 0.0625) + 1
        feats = rng.standard_normal(
            (t_feat, spec.visual_dim, gh, gw)
        ).astype(np.float32)
        np.save(ops.join(root, "features", "spat_i3d", movie, stem + ".npy"), feats)

        # dialogs: one block every ~3 seconds
        blocks = []
        t = 0
        texts = ["Hello there my friend.", "How are you doing?",
                 "I am fine thanks.", "Let us go now."]
        while t + 2 < duration:
            blocks.append(
                "00:00:%02d.000 --> 00:00:%02d.000\n%s\n"
                % (t, t + 2, texts[len(blocks) % len(texts)])
            )
            t += 3
        with open(ops.join(root, "dialogs", movie, stem + ".webvtt"), "w") as f:
            f.write("WEBVTT\n\n" + "\n".join(blocks))

        # BERT token features + token2idx: one [CLS]-opened range per block
        tokens_per_block = 4
        n_tokens = len(blocks) * tokens_per_block
        raw = rng.standard_normal(
            (n_tokens, spec.text_layers * spec.text_dim)
        ).astype(np.float32)
        np.save(
            ops.join(root, "features", "bert", "bert_base", movie,
                     "%s_%03d.npy" % (movie, scene)),
            raw,
        )
        with open(
            ops.join(root, "features", "bert", "bert_base", movie,
                     "%s_%03d.token2idx" % (movie, scene)), "w"
        ) as f:
            idx = 0
            for _ in blocks:
                f.write("[CLS] %d\n" % idx)
                idx += 1
                for tok in range(tokens_per_block - 1):
                    f.write("word%d %d\n" % (tok, idx))
                    idx += 1

        # face tracks: one per cast member with 60% probability
        tracks, names = [], []
        for name in CAST:
            if rng.random() < 0.6:
                t0 = float(rng.integers(0, duration - 3))
                elems = []
                for j in range(int(rng.integers(3, 6))):
                    ts = min(t0 + j, duration - 1)
                    elems.append(
                        {
                            "x": float(rng.uniform(0, res_w)),
                            "y": float(rng.uniform(0, res_h)),
                            "w": float(rng.uniform(20, 60)),
                            "h": float(rng.uniform(20, 60)),
                            "frame": int(ts * fps),
                            "timestamp": ts,
                        }
                    )
                tracks.append(elems)
                names.append(name.split()[0])  # first name, as in ftrack_ids
        with open(ops.join(root, "ftracks", movie, stem + ".json"), "w") as f:
            json.dump({"ftracks": tracks}, f)
        ftrack_ids[stem] = names

        # per-scene intersected classes: every inter name present, sometimes
        # overlapping another class
        with open(
            ops.join(root, "intersections",
                     "intersected_%s_%d.csv" % (movie, scene)), "w"
        ) as f:
            for name in inter_names:
                others = (
                    [RAW_INTERACTIONS[int(rng.integers(len(RAW_INTERACTIONS)))][0]]
                    if rng.random() < 0.5
                    else []
                )
                f.write(",".join([name] + others) + "\n")

    with open(ops.join(root, "others", "graphs", movie + ".json"), "w") as f:
        json.dump(clips, f)
    with open(ops.join(root, "ftrack_ids", movie + ".json"), "w") as f:
        json.dump(ftrack_ids, f)
    with open(
        ops.join(root, "intersections", "intersected_%s.csv" % movie), "w"
    ) as f:
        for name in movie_inter_names:
            f.write("%s\n" % name)


def generate(root: str, spec: SyntheticSpec = None) -> config_lib.ExperimentConfig:
    """Write the full synthetic dataset and return a config for it."""
    spec = spec or SyntheticSpec()
    rng = np.random.default_rng(spec.seed)
    os.makedirs(root, exist_ok=True)
    _write_vocab(root)

    scenes_by_movie: Dict[str, List[int]] = {}
    split = {}
    for mode, movies in spec.movies.items():
        split[mode] = movies
        for movie in movies:
            scenes_by_movie[movie] = list(spec.scenes)
    with open(ops.join(root, "others", "split.json"), "w") as f:
        json.dump(split, f)
    with open(ops.join(root, "others", "org_res.txt"), "w") as f:
        for movie in scenes_by_movie:
            f.write("%s %d %d\n" % (movie, spec.resolution[0], spec.resolution[1]))

    all_names = set()
    for movie, scenes in scenes_by_movie.items():
        _write_movie(root, movie, scenes, spec, rng)
        all_names |= {name for name, _ in RAW_INTERACTIONS}
    with open(ops.join(root, "intersections", "intersected_any.csv"), "w") as f:
        for name in sorted(all_names):
            f.write("%s\n" % name)

    return make_config(root, spec)
