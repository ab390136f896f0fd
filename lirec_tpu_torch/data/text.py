"""Dialog (BERT) feature access: WebVTT parsing, token alignment,
contextualization.

Reproduces the reference semantics (ref `text_utils/text_features.py`,
`text_utils/feature_extraction.py:83-145`):

- WebVTT timestamps are parsed to whole seconds; a narration ending in
  ``...`` merges its time range with the following block.
- Token ranges per utterance come from ``[CLS]`` boundaries in the
  ``token2idx`` files written at extraction time.
- Raw per-token embeddings are stored as ``[n_tokens, layers*dim]`` and
  contextualized by one of: second-to-last | last | sum-all | sum-last-4 |
  cat-last-4.
- A window with no overlapping dialog yields a zero vector.
"""

from __future__ import annotations

import os
import os.path as ops
import re
from typing import Iterator, List, Optional

import numpy as np

__all__ = [
    "TimeSpan",
    "TextFeatureReader",
    "parse_webvtt_times",
    "split_dialog_blocks",
    "clean_dialog_block",
    "contextualize",
]


class TimeSpan:
    def __init__(self, start: int, end: int):
        self.start = start
        self.end = end

    def overlaps(self, start: float, end: float) -> bool:
        # any overlap including containment (ref text_features.py:24-31)
        return (
            self.start <= start <= self.end
            or self.start <= end <= self.end
            or (start <= self.start and end >= self.end)
        )

    def contains(self, point: float) -> bool:
        return self.start <= point <= self.end


_TS = re.compile(r"(\d*):(\d*):(\d*)\.?\d*")


def _to_seconds(time_str: str) -> int:
    m = _TS.match(time_str)
    return int(m.group(1)) * 3600 + int(m.group(2)) * 60 + int(m.group(3))


def parse_webvtt_times(text: str) -> List[TimeSpan]:
    """Timestamp spans with `...`-continuation merging
    (ref text_features.py:66-83)."""
    times: List[TimeSpan] = []
    pending_merge = False
    for line in text.split("\n"):
        stripped = line.strip()
        if stripped.endswith("..."):
            pending_merge = True
        elif "-->" in line:
            parts = stripped.split()
            start, end = _to_seconds(parts[0]), _to_seconds(parts[-1])
            if pending_merge and times:
                times[-1].end = end
                pending_merge = False
            else:
                times.append(TimeSpan(start, end))
        elif pending_merge and stripped:
            pending_merge = False
    return times


def split_dialog_blocks(text: str) -> Iterator[List[str]]:
    """Group raw dialog lines per timestamp block, merging `...` continuations
    (ref text_utils/feature_extraction.py:83-110)."""
    in_block = False
    subtext = [""]
    for line in text.strip().split("\n"):
        if line == "" and in_block:
            if subtext[-1].strip().endswith("..."):
                subtext[-1] = re.sub(r"\.\.\.", " ", subtext[-1].strip())
                in_block = False
            else:
                yield subtext
                in_block, subtext = False, [""]
        if in_block:
            if line.startswith("-"):
                if not subtext[0]:
                    subtext = []
                subtext.append(line)
            else:
                subtext[-1] += line + " "
        if "-->" in line:
            in_block = True
    yield subtext


def clean_dialog_block(subtext: List[str]):
    """Strip stage directions / markup, add [CLS]/[SEP], and build 2-sentence
    sliding windows for multi-speaker blocks
    (ref text_utils/feature_extraction.py:113-145)."""
    start, sep = ["[CLS]"], ["[SEP]"]

    def _erase(narration: str) -> str:
        narration = narration.strip()
        narration = re.sub(r"\([^\)]+\)", "", narration)
        narration = re.sub(r"\[[^\]]+\]", "", narration)
        narration = re.sub(r"</?i>", "", narration)
        narration = re.sub(r"<.+?>", "", narration)
        return narration

    cleaned: List[List[str]] = []
    for narration in subtext:
        narration = _erase(narration)
        if narration.startswith("-"):
            narration = narration[1:]
        if narration == "":
            return ""
        cleaned.append(narration.split() + sep)
    if len(cleaned) <= 1:
        return [" ".join(start + cleaned[0])]
    return [
        " ".join(start + cleaned[i] + cleaned[i + 1])
        for i in range(len(cleaned) - 1)
    ]


def contextualize(
    features: np.ndarray, mode: str, text_dim: int, n_last: int = 4
) -> np.ndarray:
    """[n_tokens, layers, dim] -> contextualized per-token embeddings
    (ref text_features.py:180-193)."""
    if mode == "second-to-last":
        return features[:, -2, :]
    if mode == "last":
        return features[:, -1, :]
    if mode == "sum-all":
        return features.sum(axis=1)
    if mode == "sum-last-4":
        return features[:, -n_last:, :].sum(axis=1)
    if mode == "cat-last-4":
        return features[:, -n_last:, :].reshape(-1, text_dim * n_last)
    raise ValueError("unknown contextualization %r" % mode)


class TextFeatureReader:
    """Lazy per-(movie, scene) BERT token feature access."""

    def __init__(
        self,
        video_idx: str,
        scene_idx: int,
        fname: str,
        *,
        text_dir: str,
        dialogs_dir: str,
        text_dim: int,
        text_layers: int = 12,
        contextualization: str = "second-to-last",
        ext_dialog: str = "webvtt",
        cache_to_disk: bool = True,
    ):
        self.video_idx = video_idx
        self.scene_idx = "%03d" % scene_idx
        self.fname = re.search(r"(.*)\.mp4", fname).group(1)
        self.text_dir = text_dir
        self.text_dim = text_dim
        self.text_layers = text_layers
        self.contextualization = contextualization
        self.cache_to_disk = cache_to_disk
        self.features: Optional[np.ndarray] = None
        self.tokens: List[str] = []
        self.times: List[TimeSpan] = []
        self.dialogs: List = []
        self.time_idx2token_range: List[List[int]] = []
        self._read_times(dialogs_dir, ext_dialog)
        self._read_token_ranges()

    def _read_times(self, dialogs_dir: str, ext: str) -> None:
        path = ops.join(dialogs_dir, self.video_idx, "%s.%s" % (self.fname, ext))
        with open(path, "rb") as f:
            text = f.read().decode("unicode_escape")
        self.times = parse_webvtt_times(text)
        for block in split_dialog_blocks(text):
            self.dialogs.append(clean_dialog_block(block))

    def _read_token_ranges(self) -> None:
        # token2idx: one token per line; [CLS] opens a new utterance range
        # (ref text_features.py:91-104).
        path = ops.join(
            self.text_dir,
            self.video_idx,
            "%s_%s.token2idx" % (self.video_idx, self.scene_idx),
        )
        start = 0
        line_idx = -1
        with open(path, "r") as f:
            for line_idx, line in enumerate(f):
                self.tokens.append(line.split()[0])
                if "[CLS]" in line:
                    if line_idx:
                        self.time_idx2token_range.append(list(range(start, line_idx)))
                    start = line_idx
        if line_idx >= 0:
            self.time_idx2token_range.append(list(range(start, line_idx + 1)))

    def _zero_row(self) -> np.ndarray:
        width = (
            self.text_dim * 4
            if self.contextualization.endswith("4")
            else self.text_dim
        )
        return np.zeros((1, width))

    def _load(self) -> np.ndarray:
        if self.features is not None:
            return self.features
        ctx_path = ops.join(
            self.text_dir,
            self.contextualization,
            self.video_idx,
            "%s_%s.npy" % (self.video_idx, self.scene_idx),
        )
        if ops.exists(ctx_path):
            self.features = np.load(ctx_path)
            return self.features
        raw_path = ops.join(
            self.text_dir,
            self.video_idx,
            "%s_%s.npy" % (self.video_idx, self.scene_idx),
        )
        raw = np.load(raw_path).reshape(-1, self.text_layers, self.text_dim)
        self.features = contextualize(raw, self.contextualization, self.text_dim)
        if self.cache_to_disk:
            from lirec_tpu_torch.utils.io import atomic_np_save

            os.makedirs(ops.dirname(ctx_path), exist_ok=True)
            atomic_np_save(ctx_path, self.features)
        return self.features

    def free(self) -> None:
        self.features = None

    def get_features_by_time(
        self, time_node: Optional[dict] = None, with_dialog: bool = False
    ):
        """Token features for utterances overlapping the window; zero vector
        when none do (ref text_features.py:140-178).

        ``with_dialog=True`` additionally returns the window's dialog lines
        joined with ``</br>`` — the reference's ``html=`` debug mode
        (ref text_features.py:140-178), which is BROKEN there: its
        found-tokens path (ref :166-167) returns a bare array that the
        html caller tuple-unpacks (ref text_utils/classification_dataloader
        .py:60), so the common case crashes or silently destructures rows.
        Here every path returns the (features, dialog) pair.
        """
        features = self._load()

        def dialog_of(idxs):
            lines = []
            for i in idxs:
                if i < len(self.dialogs) and self.dialogs[i]:
                    block = self.dialogs[i]
                    lines.append(
                        block[0] if isinstance(block, (list, tuple)) else block
                    )
            return "</br>".join(str(x) for x in lines)

        if (
            time_node is None
            or "start" not in time_node
            or "end" not in time_node
        ):
            if with_dialog:
                return features, dialog_of(range(len(self.times)))
            return features
        tokens_range: List[int] = []
        dialog_idxs: List[int] = []
        for time_idx, span in enumerate(self.times):
            if time_idx >= len(self.time_idx2token_range):
                break
            if span.overlaps(time_node["start"], time_node["end"]):
                tokens_range += self.time_idx2token_range[time_idx]
                dialog_idxs.append(time_idx)
        if tokens_range:
            if with_dialog:
                return features[tokens_range], dialog_of(dialog_idxs)
            return features[tokens_range]
        if with_dialog:
            return self._zero_row(), ""
        return self._zero_row()

    def get_features_by_track(self, track: List[dict]) -> np.ndarray:
        """Token features at the first track element's timestamps
        (ref text_features.py:195-208)."""
        features = self._load()
        tokens_range: List[int] = []
        for elem in track:
            for time_idx, span in enumerate(self.times):
                if time_idx >= len(self.time_idx2token_range):
                    break
                if span.contains(elem["timestamp"]):
                    tokens_range += self.time_idx2token_range[time_idx]
            if tokens_range:
                return features[tokens_range]
            return self._zero_row()
        return self._zero_row()
