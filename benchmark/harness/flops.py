"""Model FLOPs from a configuration's published shapes: 2 m n k for every
matrix product the work needs. The embedding MLPs run once per table row
at eval (no dropout there, so every row's embedding is shared by its
uses) and once per distinct row a batch references in training; the
context branch's second layers run after its masked mean (they commute
with it). Elementwise work is not counted."""

from __future__ import annotations

from typing import Dict

__all__ = ["embed_flops", "head_flops", "second_flops", "eval_sweep_flops",
           "train_step_flops"]


def _first(cfg: Dict, n_clip_rows: int, n_track_rows: int) -> int:
    """The first layers of one branch over clip and track rows."""
    j = cfg["joint_dim"]
    return 2 * j * (n_clip_rows * (cfg["text_dim"] + cfg["visual_dim"])
                    + n_track_rows * 2 * cfg["track_dim"])


def second_flops(cfg: Dict, rows: int) -> int:
    """The second layers of one branch over `rows` rows."""
    j = cfg["joint_dim"]
    return 2 * rows * (2 * j * j + 2 * j * (j // 2))


def _branches(cfg: Dict) -> int:
    return 2 if cfg["ctx"] else 1


def embed_flops(cfg: Dict) -> int:
    """Every branch's two-layer MLPs over every row of the tables."""
    j = cfg["joint_dim"]
    second = (2 * cfg["n_clips"] * 2 * j * j
              + 2 * cfg["n_tracks"] * 2 * j * (j // 2))
    return _branches(cfg) * (_first(cfg, cfg["n_clips"], cfg["n_tracks"])
                             + second)


def head_flops(cfg: Dict, rows: int) -> int:
    """The gate and the heads over `rows` hypothesis rows."""
    j = cfg["joint_dim"]
    head_in = 3 * j
    out = 0
    if cfg["gates"]:
        head_in = j * cfg["mid_m_ints"]
        out += 2 * rows * 6 * j * head_in
    out += 2 * rows * head_in * cfg["n_classes"]
    if cfg["ctx"]:
        out += 2 * rows * 3 * j * cfg["n_rels"]
    return out


def eval_sweep_flops(cfg: Dict, n_samples: int) -> int:
    """One sweep of `n_samples` samples: the tables embedded once, then the
    gate and the heads of every hypothesis row."""
    return embed_flops(cfg) + head_flops(cfg, n_samples * cfg["n_hypotheses"])


def train_step_flops(cfg: Dict, batch: int, clip_rows: int,
                     track_rows: int) -> int:
    """One training step, forward and backward, of `batch` samples whose
    indices reference `clip_rows` / `track_rows` distinct table rows: the
    first layers over those rows (forward and weight gradients: the tables
    take none), the second layers, the gate and the heads (forward, weight
    and input gradients)."""
    rows = batch * cfg["n_hypotheses"]
    first = _branches(cfg) * _first(cfg, clip_rows, track_rows)
    rest = _branches(cfg) * second_flops(cfg, rows) + head_flops(cfg, rows)
    return 2 * first + 3 * rest
