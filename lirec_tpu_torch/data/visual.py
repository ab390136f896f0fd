"""I3D visual feature access: time-window slicing and face-track ROI pooling.

Reproduces the reference's windowing math exactly (ref
`visual_utils/visual_features.py`): frame<->time maps come from `.matidx`
files; `sampling_fr=0.0625` rescales frame indices into the 16x-downsampled
feature timeline; track features blow face bboxes up to person bboxes with
fixed ratios (FH 0.10-0.25, FW 0.35-0.65) and mean-pool the covered grid.

The per-element ROI loop optionally dispatches to the C++ native ingest op
(`lirec_tpu_torch.native`) when available.
"""

from __future__ import annotations

import os.path as ops
import re
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

__all__ = ["VisualFeatureReader", "roi_pool_tracks"]

# Face-to-person bbox expansion ratios (ref visual_features.py:115-117).
FH0, FH1 = 0.10, 0.25
FW0, FW1 = 0.35, 0.65


def roi_pool_tracks(
    features: np.ndarray,
    track: List[dict],
    resolution: List[int],
    sampling_fr: float,
    visual_dim: int,
) -> np.ndarray:
    """Per-track-element person-bbox mean pooling over the feature grid
    (ref visual_features.py:105-135). features: [T, C, h, w]."""
    out = np.zeros((len(track), visual_dim), dtype=features.dtype)
    hgrid, wgrid = features.shape[2], features.shape[3]
    sh, sw = hgrid / resolution[0], wgrid / resolution[1]
    n_frames = features.shape[0]
    for i, elem in enumerate(track):
        # face bbox in half-resolution coords (ref :120)
        fx, fy = elem["x"] / 2.0, elem["y"] / 2.0
        fw, fh = elem["w"] / 2.0, elem["h"] / 2.0
        pw, ph = fw / (FW1 - FW0), fh / (FH1 - FH0)
        px, py = fx - FW0 * pw, fy - FH0 * ph
        spx, spw = px * sw, pw * sw
        spy, sph = py * sh, ph * sh
        x0 = max(0, int(np.floor(spx)))
        x1 = min(int(wgrid), int(np.ceil(spx + spw)))
        y0 = max(0, int(np.floor(spy)))
        y1 = min(int(hgrid), int(np.ceil(spy + sph)))
        frame_idx = int(elem["frame"] * sampling_fr)
        if frame_idx == n_frames:
            continue
        region = features[frame_idx][:, y0:y1, x0:x1].reshape(visual_dim, -1)
        out[i] = region.mean(axis=1)
    return out


class VisualFeatureReader:
    """Lazy per-(movie, scene) I3D spatial feature access."""

    def __init__(
        self,
        video_idx: str,
        scene_idx: int,
        fname: str,
        *,
        visual_dir: str,
        frame2time_dir: str,
        visual_dim: int,
        sampling_fr: float = 0.0625,
        resolution: Optional[List[int]] = None,
        spat_pool: bool = True,
        tf_crop: bool = True,
        ext_frame2time: str = "matidx",
    ):
        self.video_idx = video_idx
        self.scene_idx = "%03d" % scene_idx
        self.fname = re.search(r"(.*)\.mp4", fname).group(1)
        self.visual_dir = visual_dir
        self.visual_dim = visual_dim
        self.sampling_fr = sampling_fr
        self.resolution = resolution
        self.spat_pool = spat_pool
        self.tf_crop = tf_crop
        self.features: Optional[np.ndarray] = None
        self.frame2time: Dict[int, int] = {}
        self.time2frame: Dict[int, List[int]] = defaultdict(list)
        self._read_frame2time(frame2time_dir, ext_frame2time)

    def _read_frame2time(self, frame2time_dir: str, ext: str) -> None:
        # `.matidx` lines: "<frame> <seconds.fraction>"; seconds truncated
        # (ref visual_features.py:45-54).
        path = ops.join(frame2time_dir, self.video_idx, "%s.%s" % (self.fname, ext))
        with open(path, "r") as f:
            for line in f:
                frame_str, time_str = line.strip().split()
                frame = int(frame_str)
                time = int(time_str.split(".")[0])
                self.frame2time[frame] = time
                self.time2frame[time].append(frame)

    def _load(self) -> np.ndarray:
        if self.features is None:
            self.features = np.load(
                ops.join(self.visual_dir, self.video_idx, "%s.npy" % self.fname)
            )
        return self.features

    def free(self) -> None:
        self.features = None

    def get_features_by_time(self, time_node: Optional[dict] = None) -> np.ndarray:
        """Spatially-pooled features for a time window
        (ref visual_features.py:60-103). Returns [T_window, C]."""
        feats4d = self._load()
        pooled = feats4d.reshape(feats4d.shape[0], feats4d.shape[1], -1).mean(axis=2)
        if time_node is None:
            return pooled
        if "start" not in time_node or "end" not in time_node:
            # Degenerate time node; reference returns the raw 4-D array here
            # (ref :96-97) which crashes downstream in mixed mode — we return
            # the full pooled range instead.
            return pooled
        start_frames = self.time2frame[int(time_node["start"])]
        if not start_frames:
            raise IndexError(
                "no frames at t=%s for %s/%s"
                % (time_node["start"], self.video_idx, self.fname)
            )
        start = start_frames[0]
        end_time = int(time_node["end"])
        if end_time not in self.time2frame:
            end_time -= 1  # rounding slack (ref :80-81)
        end = self.time2frame[end_time][-1]
        if self.sampling_fr < 1:
            start = int(start * self.sampling_fr)
            end = int(end * self.sampling_fr)
            step = 1
        else:
            step = int(self.sampling_fr)
        if end >= pooled.shape[0]:
            return pooled[range(start, pooled.shape[0], step)]
        return pooled[range(start, end + 1, step)]

    def get_features_by_track(self, track: List[dict]) -> np.ndarray:
        """ROI-pooled per-element features [len(track), C]
        (ref visual_features.py:105-143)."""
        feats4d = self._load()
        if self.tf_crop:
            if self.resolution is None:
                raise ValueError(
                    "tf_crop needs the original movie resolution for %s"
                    % self.video_idx
                )
            try:
                from lirec_tpu_torch.native import bindings as native
            except Exception:
                native = None
            if native is not None and native.available():
                return native.roi_pool_tracks(
                    feats4d, track, self.resolution, self.sampling_fr,
                    self.visual_dim,
                )
            return roi_pool_tracks(
                feats4d, track, self.resolution, self.sampling_fr, self.visual_dim
            )
        frame_range = []
        for elem in track:
            frame_idx = int(elem["frame"] * self.sampling_fr)
            if frame_idx == feats4d.shape[0]:
                continue
            frame_range.append(frame_idx)
        return feats4d[list(np.unique(frame_range))]
