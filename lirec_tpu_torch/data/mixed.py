"""Fused (text + visual + tracks) per-clip feature rows.

Reproduces the reference fusion (ref `mixed_utils/mixed_features.py`): for a
time window, text tokens are max-pooled and visual frames are max-pooled
(after spatial mean), then hstacked as ``[text | visual]``; per-track
features are temporally max-pooled to one ``[1, track_dim]`` row. Rows are
memoized in memory and optionally on disk under ``<visual_dir>/cached/``.
"""

from __future__ import annotations

import os
import os.path as ops
from typing import Dict, List, Optional, Tuple

import numpy as np

from lirec_tpu_torch.data.text import TextFeatureReader
from lirec_tpu_torch.data.visual import VisualFeatureReader

__all__ = ["MixedFeatureReader"]


class MixedFeatureReader:
    """Per-(movie, scene) fused feature access with two-level caching."""

    def __init__(
        self,
        video_idx: str,
        scene_idx: int,
        fname: str,
        *,
        cfg,
        resolution: Optional[List[int]] = None,
        cache_to_disk: bool = False,
    ):
        self.video_idx = video_idx
        self.scene_idx = scene_idx
        self.fname = fname
        self.cfg = cfg
        self.cache_to_disk = cache_to_disk
        feature_type = cfg.tasks.feature_type
        self.visual = (
            VisualFeatureReader(
                video_idx,
                scene_idx,
                fname,
                visual_dir=cfg.paths.visual_features,
                frame2time_dir=cfg.paths.frame2time,
                visual_dim=cfg.dims.visual_dim,
                sampling_fr=cfg.runtime.sampling_fr,
                resolution=resolution,
                spat_pool=cfg.runtime.spat_pool,
                tf_crop=cfg.runtime.tf_crop,
            )
            if feature_type in ("m", "v")
            else None
        )
        self.textual = (
            TextFeatureReader(
                video_idx,
                scene_idx,
                fname,
                text_dir=cfg.paths.text_features,
                dialogs_dir=cfg.paths.dialogs,
                text_dim=cfg.dims.text_dim,
                text_layers=cfg.dims.text_layers,
                contextualization=cfg.runtime.contextualization,
            )
            if feature_type in ("m", "t")
            else None
        )
        self._time_cache: Dict[object, np.ndarray] = {}
        self._track_cache: Dict[object, np.ndarray] = {}

    # -- time-window rows ----------------------------------------------------

    def _time_disk_path(self, time_node) -> str:
        base = ops.join(
            self.cfg.paths.visual_features,
            "cached",
            "time",
            self.cfg.tasks.feature_type,
            self.video_idx,
        )
        tag = "_".join(str(time_node).split())
        stem = ops.splitext(self.fname)[0]
        return ops.join(base, "%s_time_%s.npy" % (stem, tag))

    def get_features_by_time(self, time_node=None, idx=None) -> np.ndarray:
        """One fused row [1, text_dim + visual_dim] for a time window
        (ref mixed_features.py:37-67)."""
        if idx is not None and idx in self._time_cache:
            return self._time_cache[idx]
        disk_path = self._time_disk_path(time_node) if self.cache_to_disk else None
        if disk_path is not None and ops.exists(disk_path):
            row = np.load(disk_path)
            if idx is not None:
                self._time_cache[idx] = row
            return row

        parts = []
        if self.textual is not None:
            tokens = self.textual.get_features_by_time(time_node)
            parts.append(np.max(tokens, axis=0).reshape(1, -1))
        if self.visual is not None:
            frames = self.visual.get_features_by_time(time_node)
            parts.append(np.max(frames, axis=0, keepdims=True))
        row = np.hstack(parts)

        if disk_path is not None:
            from lirec_tpu_torch.utils.io import atomic_np_save

            os.makedirs(ops.dirname(disk_path), exist_ok=True)
            atomic_np_save(disk_path, row)
        if idx is not None:
            self._time_cache[idx] = row
        return row

    # -- track rows ------------------------------------------------------

    def get_features_by_track(self, track=None, idx=None, name: str = "") -> np.ndarray:
        """One pooled row [1, track_dim] for a face track; zeros for empty
        tracks (ref mixed_features.py:84-112)."""
        if idx is not None and idx in self._track_cache:
            return self._track_cache[idx]
        if track is not None and len(track) == 0:
            row = np.zeros((1, self.cfg.dims.visual_dim))
            if idx is not None:
                self._track_cache[idx] = row
            return row
        per_elem = self.visual.get_features_by_track(track)
        row = np.max(per_elem, axis=0, keepdims=True)
        if idx is not None:
            self._track_cache[idx] = row
        return row

    # -- relationship context matrices ------------------------------------

    def create_pair_context_mat(
        self, clips: List[Tuple[object, object, object]]
    ) -> Optional[np.ndarray]:
        """[n_clips, mlp_dim] rows of cached (clip, track1, track2) features
        (ref mixed_features.py:115-125). All ids must already be cached."""
        if len(clips) == 0:
            return None
        d = self.cfg.dims
        mat = np.zeros((len(clips), d.text_dim + d.visual_dim + 2 * d.track_dim))
        for i, (time_idx, track1_idx, track2_idx) in enumerate(clips):
            mat[i] = np.hstack(
                (
                    self.get_features_by_time(idx=time_idx),
                    self.get_features_by_track(idx=track1_idx),
                    self.get_features_by_track(idx=track2_idx),
                )
            ).ravel()
        return mat

    def free(self) -> None:
        """Drop raw feature arrays after caching (ref mixed_features.py:127-131)."""
        if self.visual is not None:
            self.visual.free()
        if self.textual is not None:
            self.textual.free()
