"""Immutable, typed experiment configuration.

The reference drives everything through a parse-at-import argparse singleton
that entry scripts mutate imperatively (reference `utils/arg_pars.py:184`,
`resume/int_rel_ch.py:91-121`, `mixed_utils/update_arg_pars.py:19-73`). Here
the same *resolved* parameter sets are frozen dataclasses; the four
`resume/*` entry points ship as named presets.

Every dimension is configurable so tests can run miniature synthetic data,
but defaults reproduce the reference contract exactly:
feature row = [text 768 | clip-visual 2048 | track1 2048 | track2 2048]
= 6912 (ref `mixed_utils/update_arg_pars.py:36-50`), 20 track-pair
hypotheses (ref `classification_dataloader.py:177`), 18 context clips + 1 GT
slot (ref `classification_dataloader.py:329`).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, replace
from typing import Tuple

__all__ = [
    "Paths",
    "Dims",
    "Tasks",
    "Optim",
    "Runtime",
    "ExperimentConfig",
    "preset",
    "PRESETS",
]


@dataclass(frozen=True)
class Paths:
    """Resolved data locations (ref `mixed_utils/update_arg_pars.py:33-67`)."""

    data_root: str = ""
    store_root: str = ""

    # Relative locations under data_root; joined by __post_init__-style
    # accessors so a single data_root relocates everything (same layout as
    # the reference's 80 GB feature drop).
    def join(self, *parts: str) -> str:
        return os.path.join(self.data_root, *parts)

    @property
    def dialogs(self) -> str:
        return self.join("dialogs")

    @property
    def frame2time(self) -> str:
        return self.join("frame2time")

    @property
    def labeled_interactions(self) -> str:
        return self.join("others", "all_train_set.txt")

    @property
    def merged_interactions(self) -> str:
        return self.join("others", "merged_interactions.txt")

    @property
    def annotations(self) -> str:
        # Directory of per-movie clip-graph JSON dumps (the format the
        # reference's mg3.pkl pickle was built from; ref
        # `moviegraphs/py3loader/GraphClasses.py:60-73`). An mg3.pkl file is
        # also accepted (see data/graphs.py).
        return self.join("others", "graphs")

    @property
    def annotations_pickle(self) -> str:
        return self.join("others", "mg3.pkl")

    @property
    def split(self) -> str:
        return self.join("others", "split.json")

    @property
    def intersected(self) -> str:
        return self.join("intersections")

    @property
    def relships2_15(self) -> str:
        return self.join("others", "relships_many2_15.txt")

    @property
    def relships_opp(self) -> str:
        return self.join("others", "relships_15_opp.txt")

    @property
    def merged_videos(self) -> str:
        return self.join("others", "use_vid_for_moviegraphs")

    @property
    def ftrack_ids(self) -> str:
        return self.join("ftrack_ids")

    @property
    def ftracks(self) -> str:
        return self.join("ftracks")

    @property
    def orig_res(self) -> str:
        return self.join("others", "org_res.txt")

    @property
    def visual_features(self) -> str:
        return self.join("features", "spat_i3d")

    @property
    def text_features(self) -> str:
        return self.join("features", "bert", "bert_base")

    @property
    def models_release(self) -> str:
        return self.join("models_release")


@dataclass(frozen=True)
class Dims:
    """Feature/model dimensionalities (ref `update_arg_pars.py:36-50`)."""

    text_dim: int = 768
    visual_dim: int = 2048
    text_layers: int = 12
    joint_dim: int = 512
    mid_m_ints: int = 6  # gate output = joint_dim * mid_m_ints (ref model.py:137)

    @property
    def track_dim(self) -> int:
        return self.visual_dim

    @property
    def mlp_dim(self) -> int:
        return self.text_dim + self.visual_dim + 2 * self.track_dim

    @property
    def fused_dim(self) -> int:
        """Width of the tri-modal fused embedding (txt + vis + 2 half tracks)."""
        return 3 * self.joint_dim


@dataclass(frozen=True)
class Tasks:
    """Task/branch switches (ref `utils/arg_pars.py` + resume/* overrides)."""

    modality: str = "m"  # m | t | v (Modalities model only)
    feature_type: str = "m"  # which features ingest loads: m | t | v
    inter_class: str = "all"  # all | t | v | m
    merged: bool = True  # 324 raw -> 101 merged classes
    ints: bool = True
    ctx: bool = False
    gates: bool = False
    tracks: bool = True
    mod_check: bool = False  # use the Modalities model
    soft_gt: bool = False
    multilab_weights: bool = True
    tr_maximize: bool = False  # track-hypothesis maximization (grounding)
    tr_correct: bool = False  # GT-track supervision vs weak
    tr_cat_distr: bool = False  # sample positive hypothesis categorically
    tr_max_neg: bool = False
    tr_sum_max: bool = False  # curriculum: flip tr_sum_max_flag at epoch 20
    tr_sum_max_flag: bool = True  # default True (store_false flag, arg_pars.py:114)
    rels: bool = False
    rels_multitask: bool = False
    rels_multi_clip: bool = False
    rels_n_clips: int = 18
    n_hypotheses: int = 20  # hard cap, ref classification_dataloader.py:177

    def __post_init__(self):
        # The dataset's relationship-context assembly only defines
        # context_idx/rels_mask under rels_multitask+rels_multi_clip, so the
        # flags must stay coupled the way every reference entry point couples
        # them (resume/int_rels.py, resume/int_rel_ch.py set both together).
        if self.rels_multi_clip and not self.rels_multitask:
            raise ValueError("rels_multi_clip requires rels_multitask")
        if self.rels_multitask and self.tr_maximize and not self.rels_multi_clip:
            raise ValueError(
                "rels_multitask + tr_maximize requires rels_multi_clip "
                "(hypothesis rows carry per-clip relationship context)"
            )


@dataclass(frozen=True)
class Optim:
    """Training hyperparameters (ref `utils/arg_pars.py:93,112,136,149-156`)."""

    lr: float = 3e-5
    weight_decay: float = 1e-5
    dropout: float = 0.3
    epochs: int = 100
    batch_size: int = 64
    margin: float = 0.101
    tr_margin: float = 0.101
    lymbda: float = 1.0
    seed: int = 0
    test_fr: int = 2
    save_model: bool = True
    save_model_often: bool = False
    keep_best_n: int = 4  # ModelSaver policy, ref utils/model_saver.py:18


@dataclass(frozen=True)
class Runtime:
    """Ingest + execution knobs."""

    contextualization: str = "second-to-last"
    sampling_fr: float = 0.0625
    pool_features: str = "max"  # max | sum | avg | mix
    spat_pool: bool = True
    tf_crop: bool = True
    sanity_check: bool = False
    compute_dtype: str = "bfloat16"  # matmul input dtype on TPU
    param_dtype: str = "float32"
    data_axis: str = "data"
    model_axis: str = "model"
    mesh_shape: Tuple[int, ...] = (1, 1)  # (data, model)
    use_native_ingest: bool = True  # C++ host ops when available
    # 'rbg' PRNG generates dropout masks ~6x faster on TPU (train step
    # 9.6 -> 8.0 ms at B=64). Default since r2: masks validated as
    # unbiased/uncorrelated at the real shapes (tests/test_prng.py;
    # PARITY.md 'dropout PRNG'). --strict-prng restores threefry.
    fast_prng: bool = True


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "experiment"
    paths: Paths = field(default_factory=Paths)
    dims: Dims = field(default_factory=Dims)
    tasks: Tasks = field(default_factory=Tasks)
    optim: Optim = field(default_factory=Optim)
    runtime: Runtime = field(default_factory=Runtime)
    resume: bool = False
    resume_train: bool = False
    resume_path: str = ""

    def replace(self, **kw) -> "ExperimentConfig":
        return replace(self, **kw)

    def with_tasks(self, **kw) -> "ExperimentConfig":
        return replace(self, tasks=replace(self.tasks, **kw))

    def with_dims(self, **kw) -> "ExperimentConfig":
        return replace(self, dims=replace(self.dims, **kw))

    def with_optim(self, **kw) -> "ExperimentConfig":
        return replace(self, optim=replace(self.optim, **kw))

    def with_runtime(self, **kw) -> "ExperimentConfig":
        return replace(self, runtime=replace(self.runtime, **kw))

    def describe(self) -> str:
        return "\n".join(
            "%s: %s" % (f.name, getattr(self, f.name))
            for f in dataclasses.fields(self)
        )


def _base(data_root: str, store_root: str, sanity_check: bool) -> ExperimentConfig:
    cfg = ExperimentConfig(
        paths=Paths(data_root=data_root, store_root=store_root),
        runtime=Runtime(sanity_check=sanity_check),
    )
    # sanity mode evaluates the 'm' class subset on one movie per split
    # (ref resume/modalties.py:91-94, utils/util_functions.py:322-327)
    inter_class = "m" if sanity_check else "all"
    return cfg.with_tasks(inter_class=inter_class)


def preset_modalities(
    data_root: str = "", store_root: str = "", sanity_check: bool = False
) -> ExperimentConfig:
    """Tri-modal interaction model eval (ref `resume/modalties.py:79-110`).

    Checkpoint: models_release/mod_all.pth.tar; model=Modalities;
    loss=MaxMarginCrossEntropyLoss; soft-GT top-1/5 metrics.
    """
    cfg = _base(data_root, store_root, sanity_check)
    cfg = cfg.with_tasks(
        mod_check=True, ints=True, modality="m", tracks=True, soft_gt=True
    )
    return cfg.replace(
        name="modalities",
        resume=True,
        resume_path=os.path.join(
            cfg.paths.models_release, "mod_all.pth.tar"
        ) if data_root else "",
    )


def preset_int_rels(
    data_root: str = "", store_root: str = "", sanity_check: bool = False
) -> ExperimentConfig:
    """Interactions + relationships eval (ref `resume/int_rels.py:88-124`).

    Checkpoint: int_rel.pth.tar; model=MidFusionMultiClip;
    loss=MultiTaskMaxMargin; 18-clip relationship context.
    """
    cfg = _base(data_root, store_root, sanity_check)
    cfg = cfg.with_tasks(
        tracks=True,
        rels_multitask=True,
        rels_multi_clip=True,
        rels_n_clips=18,
        ints=True,
        gates=True,
        ctx=True,
    )
    return cfg.replace(
        name="int_rels",
        resume=True,
        resume_path=os.path.join(
            cfg.paths.models_release, "int_rel.pth.tar"
        ) if data_root else "",
    )


def preset_int_ch(
    data_root: str = "",
    store_root: str = "",
    sanity_check: bool = False,
    tr_correct: bool = False,
) -> ExperimentConfig:
    """Interactions + character grounding eval (ref `resume/int_ch.py:77-130`).

    Checkpoint: {gt|weak}_int_ch_sum_max.pth.tar;
    model=MidFusionMultiClipMaxTracks (ctx off); loss=MarginLoss.
    """
    cfg = _base(data_root, store_root, sanity_check)
    cfg = cfg.with_tasks(
        tr_maximize=True,
        tracks=True,
        ints=True,
        ctx=False,
        rels_multitask=False,
        rels_multi_clip=False,
        gates=False,
        rels_n_clips=18,
        tr_correct=tr_correct,
    )
    ckpt = "gt_int_ch_sum_max.pth.tar" if tr_correct else "weak_int_ch_sum_max.pth.tar"
    return cfg.replace(
        name="int_ch",
        resume=True,
        resume_path=os.path.join(cfg.paths.models_release, ckpt) if data_root else "",
    )


def preset_int_rel_ch(
    data_root: str = "",
    store_root: str = "",
    sanity_check: bool = False,
    tr_correct: bool = False,
) -> ExperimentConfig:
    """Joint int + rel + grounding eval (ref `resume/int_rel_ch.py:87-124`).

    Checkpoint: {gt|weak}_int_rel_ch_sum_max.pth.tar;
    model=MidFusionMultiClipMaxTracks; loss=MarginTrackRelsLoss.
    """
    cfg = _base(data_root, store_root, sanity_check)
    cfg = cfg.with_tasks(
        tr_maximize=True,
        tracks=True,
        ints=True,
        ctx=True,
        rels_multitask=True,
        rels_multi_clip=True,
        gates=True,
        rels_n_clips=18,
        tr_correct=tr_correct,
    )
    ckpt = (
        "gt_int_rel_ch_sum_max.pth.tar"
        if tr_correct
        else "weak_int_rel_ch_sum_max.pth.tar"
    )
    return cfg.replace(
        name="int_rel_ch",
        resume=True,
        resume_path=os.path.join(cfg.paths.models_release, ckpt) if data_root else "",
    )


PRESETS = {
    "modalities": preset_modalities,
    "int_rels": preset_int_rels,
    "int_ch": preset_int_ch,
    "int_rel_ch": preset_int_rel_ch,
}


def preset(name: str, **kw) -> ExperimentConfig:
    try:
        return PRESETS[name](**kw)
    except KeyError:
        raise KeyError(
            "unknown preset %r; available: %s" % (name, sorted(PRESETS))
        ) from None
