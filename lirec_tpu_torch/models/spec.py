"""Static model specification derived from an ExperimentConfig.

Counterpart of ``lirec_tpu/models/spec.py`` (which cannot be imported
without jax: its package ``__init__`` pulls in the JAX models). Same
fields, same meaning.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelSpec:
    n_classes: int
    n_rels: int = 0  # model-head rels (excludes 'None'; ref resume/int_rels.py:42)
    text_dim: int = 768
    visual_dim: int = 2048
    track_dim: int = 2048
    joint_dim: int = 512
    mid_m_ints: int = 6
    modality: str = "m"
    ints: bool = True
    ctx: bool = False
    gates: bool = False
    tracks: bool = True
    mod_check: bool = False
    tr_maximize: bool = False
    rels_multitask: bool = False
    dropout: float = 0.3
    compute_dtype: str = "float32"

    @property
    def mlp_dim(self) -> int:
        return self.text_dim + self.visual_dim + 2 * self.track_dim

    @property
    def gate_out_dim(self) -> int:
        return self.joint_dim * self.mid_m_ints

    @classmethod
    def from_config(cls, cfg, n_classes: int, n_rels: int = 0) -> "ModelSpec":
        d, t = cfg.dims, cfg.tasks
        return cls(
            n_classes=n_classes,
            n_rels=n_rels,
            text_dim=d.text_dim,
            visual_dim=d.visual_dim,
            track_dim=d.track_dim,
            joint_dim=d.joint_dim,
            mid_m_ints=d.mid_m_ints,
            modality=t.modality,
            ints=t.ints,
            ctx=t.ctx,
            gates=t.gates,
            tracks=t.tracks,
            mod_check=t.mod_check,
            tr_maximize=t.tr_maximize,
            rels_multitask=t.rels_multitask,
            dropout=cfg.optim.dropout,
            compute_dtype=cfg.runtime.compute_dtype,
        )
