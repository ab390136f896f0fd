"""Bridge to run the actual reference implementation (at
$LIREC_TPU_REFERENCE; unset or empty means absent, there is no default
path) on the synthetic fixtures — the
`convert-checkpoint --verify` activation check. A copy of
lirec_tpu/compat/reference.py; ``write_mg_pickle`` reads the port's
data/graphs.py.

This does NOT copy reference code — it imports it. The reference needs:
- a `plotly` module (unused import) -> stubbed;
- argv-free import of its argparse singleton -> argv patched;
- an `mg3.pkl` of networkx-1.11-style graphs -> built from the synthetic
  JSON graphs with a DiGraph shim exposing the 1.11 API (.node, .has_edge,
  .neighbors).

Everything here is test-only plumbing; skipped when the reference tree is
absent.
"""

from __future__ import annotations

import os
import pickle
import sys
import types

REFERENCE = os.environ.get("LIREC_TPU_REFERENCE", "")


def reference_available() -> bool:
    return bool(REFERENCE) and os.path.isdir(REFERENCE)


class ShimDiGraph:
    """networkx-1.11-compatible directed graph for pickling into mg3.pkl."""

    def __init__(self):
        self.node = {}
        self.adj = {}

    def nodes(self):
        return list(self.node)

    def neighbors(self, n):
        return list(self.adj.get(n, ()))

    def has_edge(self, u, v):
        return u in self.adj and v in self.adj[u]


_ref_modules = None


def import_reference():
    """Import reference modules once, with plotly stub + argv patch."""
    global _ref_modules
    if _ref_modules is not None:
        return _ref_modules
    if not reference_available():
        raise FileNotFoundError(
            "no reference tree at %r (set LIREC_TPU_REFERENCE)" % REFERENCE)
    for name in ("plotly", "plotly.graph_objs", "plotly.graph_objs.layout"):
        if name not in sys.modules:
            sys.modules[name] = types.ModuleType(name)
    if "pytorch_pretrained_bert" not in sys.modules:
        bert_stub = types.ModuleType("pytorch_pretrained_bert")
        bert_stub.BertTokenizer = object
        bert_stub.BertModel = object
        bert_stub.BertForMaskedLM = object
        sys.modules["pytorch_pretrained_bert"] = bert_stub
    sys.modules["plotly.graph_objs.layout"].scene = object()
    sys.modules["plotly"].graph_objs = sys.modules["plotly.graph_objs"]
    sys.modules["plotly.graph_objs"].layout = sys.modules[
        "plotly.graph_objs.layout"
    ]
    argv = sys.argv
    sys.argv = ["bridge"]
    if REFERENCE not in sys.path:
        sys.path.insert(0, REFERENCE)
    if os.path.join(REFERENCE, "moviegraphs", "py3loader") not in sys.path:
        sys.path.insert(0, os.path.join(REFERENCE, "moviegraphs", "py3loader"))
    try:
        import GraphClasses  # noqa: F401 (py3loader)
        from utils.arg_pars import opt  # noqa: F401
        import utils.util_functions as ref_utils
        import mixed_utils.classification_dataloader as ref_dataset
        import mlp.model as ref_model
        import mlp.test as ref_test
        import utils.evaluation as ref_eval
    finally:
        sys.argv = argv
    _ref_modules = types.SimpleNamespace(
        opt=opt,
        GraphClasses=GraphClasses,
        utils=ref_utils,
        dataset=ref_dataset,
        model=ref_model,
        test=ref_test,
        evaluation=ref_eval,
    )
    return _ref_modules


def write_mg_pickle(cfg) -> str:
    """Build others/mg3.pkl from the synthetic JSON graphs using reference
    MovieGraph/ClipGraph classes around ShimDiGraph instances."""
    from lirec_tpu_torch.data import graphs as my_graphs

    ref = import_reference()
    movies = my_graphs.load_graphs(cfg.paths.annotations)
    out = {}
    for imdb_key, movie in movies.items():
        ref_movie = ref.GraphClasses.MovieGraph(imdb_key)
        for idx, clip in movie.clip_graphs.items():
            ref_clip = ref.GraphClasses.ClipGraph.__new__(
                ref.GraphClasses.ClipGraph
            )
            ref_clip.situation = clip.situation
            ref_clip.scene_label = clip.scene_label
            ref_clip.description = clip.description
            ref_clip.video = {k: (list(v) if isinstance(v, list) else v)
                              for k, v in clip.video.items()}
            g = ShimDiGraph()
            for nid, attrs in clip.G.node.items():
                g.node[nid] = dict(attrs)
                g.adj[nid] = {v: {} for v in clip.G.neighbors(nid)}
            ref_clip.G = g
            ref_movie.add_clip_graph(idx, ref_clip)
        out[imdb_key] = ref_movie
    path = cfg.paths.annotations_pickle
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return path


def configure_opt(cfg) -> None:
    """Point the reference's `opt` singleton at the synthetic root with the
    given config's dims/flags (mirrors mixed_utils/update_arg_pars.update)."""
    ref = import_reference()
    opt = ref.opt
    p, d, t, o, r = cfg.paths, cfg.dims, cfg.tasks, cfg.optim, cfg.runtime
    opt.device = "cpu"
    opt.seed = o.seed
    opt.data_root = p.data_root
    opt.dialogs_path = p.dialogs
    opt.frame2time_path = p.frame2time
    opt.labeled_interactions = p.labeled_interactions
    opt.merged_interactions = p.merged_interactions
    opt.annotations = p.annotations_pickle
    opt.split_path = p.split
    opt.intersected = p.intersected
    opt.relships2_15 = p.relships2_15
    opt.relships_opp = p.relships_opp
    opt.merged_videos = p.merged_videos
    opt.ftack_ids = p.ftrack_ids
    opt.ftracks = p.ftracks
    opt.orig_res = p.orig_res
    opt.visual_path = p.visual_features
    opt.text_path = p.text_features
    opt.text_dim = d.text_dim
    opt.text_layers = d.text_layers
    opt.visual_dim = d.visual_dim
    opt.track_dim = d.track_dim
    opt.mlp_dim = d.mlp_dim
    opt.joint_dim = d.joint_dim
    opt.mid_m_ints = d.mid_m_ints
    opt.sampling_fr = r.sampling_fr
    opt.contextualization = r.contextualization
    opt.spat_pool = r.spat_pool
    opt.tf_crop = r.tf_crop
    opt.pool_features = r.pool_features
    opt.sanity_check = r.sanity_check
    opt.inter_class = t.inter_class
    opt.feature_type = t.feature_type
    opt.modality = t.modality
    opt.merged = t.merged
    opt.multilab_weights = t.multilab_weights
    opt.soft_gt = t.soft_gt
    opt.tracks = t.tracks
    opt.mod_check = t.mod_check
    opt.tr_maximize = t.tr_maximize
    opt.tr_correct = t.tr_correct
    opt.tr_cat_distr = t.tr_cat_distr
    opt.tr_max_neg = t.tr_max_neg
    opt.tr_sum_max = t.tr_sum_max
    opt.tr_sum_max_flag = t.tr_sum_max_flag
    opt.rels = t.rels
    opt.rels_multitask = t.rels_multitask
    opt.rels_multi_clip = t.rels_multi_clip
    opt.rels_n_clips = t.rels_n_clips
    opt.ints = 1 if t.ints else 0
    opt.ctx = 1 if t.ctx else 0
    opt.gates = 1 if t.gates else 0
    opt.lymbda = o.lymbda
    opt.margin = o.margin
    opt.tr_margin = o.tr_margin
    opt.dropout = o.dropout
    opt.lr = o.lr
    opt.weight_decay = o.weight_decay
    opt.batch_size = o.batch_size
    opt.num_workers = 0
    opt.rels_dim = 0
    opt.rels_maximize = False


class legacy_byte_masks:
    """Scoped torch-1.1 compatibility: the reference indexes with ByteTensor
    masks (ref mlp/model.py:459-460 etc.), which torch 2.x rejects. Mapping
    ByteTensor/.byte() to bool preserves the original semantics (masks are
    only ever 0/1)."""

    def __enter__(self):
        import torch

        self._byte_tensor = torch.ByteTensor
        self._byte = torch.Tensor.byte
        torch.ByteTensor = lambda arr: torch.as_tensor(arr, dtype=torch.bool)
        torch.Tensor.byte = lambda self: self.to(torch.bool)
        return self

    def __exit__(self, *exc):
        import torch

        torch.ByteTensor = self._byte_tensor
        torch.Tensor.byte = self._byte
        return False


class first_element_choice:
    """Context manager forcing np.random.choice -> first element, to align
    the reference's global-RNG multi-label draws with our injected
    deterministic chooser."""

    def __enter__(self):
        import numpy as np

        self._orig = np.random.choice
        np.random.choice = lambda a, *args, **kw: (
            np.asarray(a).ravel()[0] if not args and not kw else self._orig(
                a, *args, **kw
            )
        )
        return self

    def __exit__(self, *exc):
        import numpy as np

        np.random.choice = self._orig
        return False


def transplant_params(ref, cfg, n_classes, n_rels, params, train_mode=False):
    """Fresh reference torch model with a JAX-layout params pytree loaded
    (kernel transposition + the gates_ints.fc_out flattening)."""
    import numpy as np
    import torch

    configure_opt(cfg)
    if cfg.tasks.mod_check:
        model = import_reference().model.Modalities(n_classes=n_classes)
    elif cfg.tasks.tr_maximize:
        model = import_reference().model.MidFusionMultiClipMaxTracks(
            n_classes=n_classes, n_rels=n_rels
        )
    else:
        model = import_reference().model.MidFusionMultiClip(
            n_classes=n_classes, n_rels=n_rels
        )
    sd = model.state_dict()
    for name in list(sd):
        base, kind = name.rsplit(".", 1)
        key = "gates_ints" if base == "gates_ints.fc_out" else base
        arr = np.asarray(params[key]["kernel" if kind == "weight" else "bias"])
        sd[name] = torch.tensor(arr.T if kind == "weight" else arr)
    model.load_state_dict(sd)
    return model.train() if train_mode else model.eval()
