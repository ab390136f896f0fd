"""The system under test: ``lirec_tpu_torch``'s model of a configuration,
with the weights the benchmark made. The only place, with the traffic
kinds, that imports the program."""

from __future__ import annotations

import contextlib
from typing import Dict

__all__ = ["build", "stand_in", "recording_embeddings", "OutputRecorder"]

# the configuration file's keys that the program's preset must also hold
_PRESET_DIMS = ("text_dim", "visual_dim", "joint_dim", "mid_m_ints")
_PRESET_OPTIM = ("dropout", "lr", "weight_decay", "tr_margin", "lymbda")
_PRESET_TASKS = ("ctx", "gates", "tr_maximize", "tr_correct",
                 "tr_cat_distr", "tr_max_neg", "rels_n_clips",
                 "n_hypotheses")


def build(cfg: Dict, weights: Dict, device, batch_size: int):
    """(the program's config, its ModelBundle) for configuration `cfg`: the
    program's preset at the file's widths and compute type, its model
    loaded with `weights` (the reference's names). Raises where the preset
    and the file disagree on what the reference computes."""
    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.models.factory import create_model

    pc = config_lib.preset(cfg["preset"]).with_dims(
        **{k: cfg[k] for k in _PRESET_DIMS}).with_optim(
        batch_size=batch_size).with_runtime(
        compute_dtype=cfg["compute_dtype"])
    have = {"track_dim": pc.dims.track_dim}
    have.update({k: getattr(pc.optim, k) for k in _PRESET_OPTIM})
    have.update({k: getattr(pc.tasks, k) for k in _PRESET_TASKS})
    want = {k: cfg[k] for k in have}
    if have != want:
        raise ValueError("preset %r holds %s; the configuration file says %s"
                         % (cfg["preset"], have, want))
    bundle = create_model(pc, cfg["n_classes"], n_rels=cfg["n_rels"], seed=0,
                          device=device)
    bundle.model.load_state_dict(weights, strict=True)
    return pc, bundle


def stand_in(cfg: Dict):
    """What the eval sweep reads of a dataset: the interaction classes and
    the relationship labels ('None' counted), no relationship hashes."""
    import types

    return types.SimpleNamespace(n_classes=cfg["n_classes"],
                                 n_rels=cfg["n_rels"] + 1,
                                 hashidx_rels=None)


@contextlib.contextmanager
def recording_embeddings(store: Dict):
    """Inside the block, each call of the program's
    ``models/tabular.embed_all`` (the eval sweep embeds its tables with it
    once a sweep) leaves its output in ``store["embedded"]``, the latest
    call's only."""
    from lirec_tpu_torch.models import tabular

    inner = tabular.embed_all

    def embed_all(*args, **kw):
        store["embedded"] = out = inner(*args, **kw)
        return out

    tabular.embed_all = embed_all
    try:
        yield store
    finally:
        tabular.embed_all = inner


class OutputRecorder:
    """The eval sweep's per-sample outputs, as its step makes them.

    ``bundle`` is the program's bundle with its ``apply`` wrapped: after
    the model's forward, the wrapper copies each output head ("inters",
    "rels") of a full batch into row `counter` of a device buffer
    [n_full, B, ...] and advances the device counter. The wrapper runs
    where the step runs, so the CUDA graph that the sweep captures holds
    the copies and every replay writes its batch's outputs (two copies
    and an add a batch, on buffers a few MB a head). A batch of another
    size (the sweep's ragged tail, an eager step) is kept as it is.
    ``reset()`` before each sweep: the full batches then land in order.
    """

    def __init__(self, bundle, n_full: int, batch_size: int, device):
        import torch

        self.n_full, self.batch_size = n_full, batch_size
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)
        self.full: Dict = {}
        self.tail: Dict = {}
        inner = bundle.apply

        def apply(model, batch, *args, **kw):
            out = inner(model, batch, *args, **kw)
            heads = {k: out[k].detach() for k in ("inters", "rels")
                     if out.get(k) is not None}
            if next(iter(heads.values())).shape[0] != batch_size:
                self.tail = {k: v.clone() for k, v in heads.items()}
                return out
            for k, v in heads.items():
                if k not in self.full:
                    self.full[k] = torch.zeros((n_full,) + tuple(v.shape),
                                               dtype=v.dtype, device=device)
                self.full[k].index_copy_(0, self.counter, v[None])
            self.counter.add_(1)
            return out

        self.bundle = bundle._replace(apply=apply)

    def reset(self) -> None:
        self.counter.zero_()
        self.tail = {}

    def outputs(self) -> Dict:
        """{"full": {head: [n_full, B, ...]}, "tail": {head: [n, ...]}}:
        what the latest sweep wrote."""
        return {"full": dict(self.full), "tail": dict(self.tail)}
