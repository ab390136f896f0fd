"""Serialized ingest artifact: packed splits + feature tables in one file
(a copy of lirec_tpu/data/artifact.py, the same file format).

The reference re-runs its whole caching pass on every cold start —
``MixedFeaturesDataset.cache()`` (ref classification_dataloader.py:139-186)
re-mines the MovieGraphs pickle and re-pools every feature row, hours at
the real 80 GB scale, memoized only as per-row ``.npy`` files. Here the
entire ingest result — the deduplicated ``FeatureTables`` plus each
split's materialized fixed-shape index tensors (the exact arrays the
packed eval sweep consumes) — serializes to ONE compressed ``.npz``;
loading it skips graph mining, annotation walking, and feature pooling
entirely and is byte-identical to a fresh ingest (tested in
tests/test_torch_ingest.py).

The layout fingerprint is JSON of the config's ``tasks``, ``dims`` and
``sanity_check`` and names no module, so one artifact serves this package
and the JAX package alike: each loads the other's file.

Produced by ``lirec-tpu-torch-ingest`` (cli/ingest.py) or transparently by
``--ingest-cache PATH`` on the eval entry points.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List

import numpy as np

__all__ = ["save_ingest", "load_ingest", "PackedSplit", "fingerprint"]

_FORMAT_VERSION = 1


def fingerprint(cfg) -> str:
    """Layout-affecting config state: a mismatched artifact must not load
    (the packed tensor shapes and table row assignment depend on these)."""
    return json.dumps(
        {
            "version": _FORMAT_VERSION,
            "tasks": dataclasses.asdict(cfg.tasks),
            "dims": dataclasses.asdict(cfg.dims),
            "sanity_check": bool(cfg.runtime.sanity_check),
        },
        sort_keys=True,
    )


class _TablesView:
    """as_dict()-compatible stand-in for data.dataset.FeatureTables."""

    def __init__(self, text, visual, track):
        self.text = text
        self.visual = visual
        self.track = track

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {"text": self.text, "visual": self.visual, "track": self.track}


class PackedSplit:
    """A loaded split: everything the eval paths read from a dataset.

    Works with both ``evaluate_packed`` (n_classes/n_rels/hashidx_rels/
    materialize/tables) and the host ``evaluate`` loop (BatchIterator's
    materialized fast path). Training needs fresh per-epoch randomness and
    keeps using the live ``InteractionDataset``.
    """

    test_rels_multi_clip = False

    def __init__(self, mode: str, data: Dict[str, np.ndarray],
                 tables: _TablesView, n_classes: int, n_rels: int,
                 n_hashes: int, rels_list: List[str]):
        self.mode = mode
        self._data = data
        self.tables = tables
        self.n_classes = n_classes
        self.n_rels = n_rels
        self.hashidx_rels = tuple(range(n_hashes))
        self.rels_list = list(rels_list)

    def __len__(self) -> int:
        return len(self._data["labels"])

    def materialize(self, rng=None, cache: bool = True) -> Dict[str, np.ndarray]:
        return self._data


def save_ingest(path: str, cfg, splits: Dict[str, object]) -> None:
    """Write {role: dataset} (cached, init_relships'd) to one ``.npz``."""
    arrays: Dict[str, np.ndarray] = {}
    meta = {"fingerprint": fingerprint(cfg), "splits": {}}
    for role, ds in splits.items():
        data = ds.materialize()
        for key, val in data.items():
            arrays["data/%s/%s" % (role, key)] = np.asarray(val)
        for key, val in ds.tables.as_dict().items():
            arrays["tables/%s/%s" % (role, key)] = np.asarray(val)
        meta["splits"][role] = {
            "mode": ds.mode,
            "n_classes": int(ds.n_classes),
            "n_rels": int(ds.n_rels),
            "n_hashes": len(getattr(ds, "hashidx_rels", ()) or ()),
            "rels_list": list(getattr(ds, "rels_list", ()) or ()),
        }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8
    ).copy()
    # a temporary name of this process's own: a process of the JAX package
    # writing the same artifact uses path + ".tmp.npz"
    tmp = "%s.tmp.%d.npz" % (path, os.getpid())
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)  # atomic: a crashed save never half-loads


def load_ingest(path: str, cfg=None) -> Dict[str, PackedSplit]:
    """Load an artifact back into {role: PackedSplit}; verifies the
    layout fingerprint when ``cfg`` is given."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        if cfg is not None and meta["fingerprint"] != fingerprint(cfg):
            raise ValueError(
                "ingest artifact %s was built for a different config "
                "(tasks/dims/sanity mismatch); re-run `lirec-tpu-torch-"
                "ingest`" % path
            )
        out: Dict[str, PackedSplit] = {}
        for role, info in meta["splits"].items():
            data = {
                key.split("/", 2)[2]: z[key]
                for key in z.files
                if key.startswith("data/%s/" % role)
            }
            tables = _TablesView(
                z["tables/%s/text" % role],
                z["tables/%s/visual" % role],
                z["tables/%s/track" % role],
            )
            out[role] = PackedSplit(
                mode=info["mode"], data=data, tables=tables,
                n_classes=info["n_classes"], n_rels=info["n_rels"],
                n_hashes=info["n_hashes"], rels_list=info["rels_list"],
            )
    return out
