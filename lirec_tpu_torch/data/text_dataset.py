"""Text-only ablation dataset (ref `text_utils/classification_dataloader.py`).

One pooled dialog vector per interaction with its local (per-class) label.
Emits the same packed representation as the mixed dataset — a text table +
``feat_idx`` rows — so the Modalities model (modality='t') and the training
loop work unchanged. Configure with `preset_text_only` (dims: mlp = text,
ref `text_utils/update_arg_pars.py:16-54`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from lirec_tpu_torch import config as config_lib
from lirec_tpu_torch.data import annotations as ann_lib
from lirec_tpu_torch.data import vocab as vocab_lib
from lirec_tpu_torch.data.dataset import FeatureTables
from lirec_tpu_torch.data.text import TextFeatureReader

__all__ = ["TextOnlyDataset", "preset_text_only", "TEXT_SANITY_MOVIE"]

# ref text_utils/classification_dataloader.py:30-31
TEXT_SANITY_MOVIE = "tt1454029"


def preset_text_only(
    data_root: str = "", store_root: str = "", sanity_check: bool = False,
    inter_class: str = "m",
) -> config_lib.ExperimentConfig:
    """Resolved text-only config (ref text_utils/update_arg_pars.py)."""
    cfg = config_lib.ExperimentConfig(
        name="text_only",
        paths=config_lib.Paths(data_root=data_root, store_root=store_root),
        dims=config_lib.Dims(visual_dim=0),
        runtime=config_lib.Runtime(sanity_check=sanity_check),
    )
    return cfg.with_tasks(
        modality="t",
        feature_type="t",
        inter_class=inter_class,
        merged=False,
        tracks=False,
        mod_check=True,
        multilab_weights=False,
        soft_gt=False,
    )


class TextOnlyDataset:
    """Text-only ablation dataset (ref text_utils/classification_dataloader).

    ``html=True`` mirrors the reference's debug mode: samples carry a
    ``meta`` dict (window dialog + ``<movie>_<scene>`` fname) and
    ``idx2inter`` maps local label ids back to interaction names
    (ref :18-25,59-70). The reference's html mode is broken end to end
    (its TextFeatures html return skips the found-tokens path, ref
    text_features.py:166-167); here it works on every path. Debug mode is
    for direct sample indexing — the string meta doesn't collate into
    batches.
    """

    def __init__(self, cfg, mode: str = "train", html: bool = False):
        self.cfg = cfg
        self.mode = mode
        self.html = html
        t = cfg.tasks
        if html:
            interactions_vocab, self.inter2idx, self.idx2inter = (
                vocab_lib.load_interaction_names(
                    cfg.paths.labeled_interactions, idx2inter_ret=True
                )
            )
        else:
            interactions_vocab, self.inter2idx = (
                vocab_lib.load_interaction_names(
                    cfg.paths.labeled_interactions
                )
            )
        self.n_classes = len(interactions_vocab[t.inter_class])
        self.n_rels = 0
        self.rels_list: list = []
        if cfg.runtime.sanity_check:
            self.movie_idxs = [TEXT_SANITY_MOVIE]
        else:
            self.movie_idxs = vocab_lib.load_split(cfg.paths.split, mode)
        mined = ann_lib.mine_interactions(
            cfg.paths,
            movie_idxs=self.movie_idxs,
            node_types=("interaction", "summary"),
            inter_class=t.inter_class,
        )
        self.interactions = mined.interactions
        self.readers: Dict = {}
        for inter in self.interactions:
            key = (inter.video_descr["movie"], inter.video_descr["scene"][0])
            if key not in self.readers:
                self.readers[key] = TextFeatureReader(
                    key[0],
                    key[1],
                    inter.video_descr["fname"][0],
                    text_dir=cfg.paths.text_features,
                    dialogs_dir=cfg.paths.dialogs,
                    text_dim=cfg.dims.text_dim,
                    text_layers=cfg.dims.text_layers,
                    contextualization=cfg.runtime.contextualization,
                    cache_to_disk=False,
                )
        self.tables = FeatureTables(cfg.dims.text_dim, 0, 0)
        self._cached = False

    def _pool(self, tokens: np.ndarray) -> np.ndarray:
        mode = self.cfg.runtime.pool_features
        if mode in ("max", "mix"):
            return tokens.max(axis=0)
        if mode == "sum":
            return tokens.sum(axis=0)
        if mode == "avg":
            return tokens.mean(axis=0)
        raise ValueError("unknown pool_features %r" % mode)

    def cache(self) -> None:
        self._meta: Dict[int, Dict[str, str]] = {}
        for inter in self.interactions:
            key = (inter.video_descr["movie"], inter.video_descr["scene"][0])
            if self.html:
                tokens, dialog = self.readers[key].get_features_by_time(
                    inter.time_node, with_dialog=True
                )
                # ref text_utils/classification_dataloader.py:66-68
                self._meta[inter.id] = {
                    "dialog": dialog,
                    "fname": "%s_%s" % (key[0], key[1]),
                }
            else:
                tokens = self.readers[key].get_features_by_time(
                    inter.time_node
                )
            self.tables.add_clip_row(inter.id, self._pool(tokens))
        for reader in self.readers.values():
            reader.free()
        self.tables.finalize()
        self._cached = True

    def init_relships(self) -> None:  # API parity with the mixed dataset
        pass

    def __len__(self) -> int:
        return len(self.interactions)

    def __getitem__(self, idx: int, rng=None) -> Dict[str, np.ndarray]:
        assert self._cached, "call cache() first"
        inter = self.interactions[idx]
        # local per-class label (ref text classification_dataloader.py:64)
        label = self.inter2idx[inter.inter_node["name"]][2]
        out = {
            "feat_idx": np.array(
                [[self.tables.clip_row(inter.id), 0, 0]], np.int32
            ),
            "labels": label,
            "multilab_weights": np.ones(self.n_classes, np.float32),
        }
        if self.html:
            out["meta"] = self._meta[inter.id]  # ref :66-70
        return out

    def to_dense(self, sample: Dict) -> Dict:
        out = dict(sample)
        out["features"] = self.tables.text[sample["feat_idx"][..., 0]]
        del out["feat_idx"]
        return out
