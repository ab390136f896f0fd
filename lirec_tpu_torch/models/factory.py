"""Model selection (counterpart of lirec_tpu/models/factory.py).

This slice ports the eval forward over packed index batches and embedded
feature tables: the mid-fusion presets (``int_rel_ch``, ``int_ch``,
``int_rels``). The losses, the dense and training forwards, the modalities
model and the ctx-localisation batch keys are later slices, and say so.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from lirec_tpu_torch.models import tabular
from lirec_tpu_torch.models.midfusion import init_midfusion
from lirec_tpu_torch.models.spec import ModelSpec

__all__ = ["ModelBundle", "create_model", "apply_model"]

_LATER_KEYS = ("uniq_clip", "ctx_triples", "ctx_uniq_clip")


def apply_model(
    model: nn.Module,
    spec: ModelSpec,
    batch: Dict,
    tables: Optional[Dict] = None,
    embedded: Optional[Dict] = None,
    use_kernel: bool = True,
) -> Dict:
    """Eval forward of a packed batch (``feat_idx`` index triples resolved
    against ``tables``, or against their ``embedded`` form from
    models/tabular.embed_all). use_kernel=False takes the plain ctx pool."""
    if "feat_idx" not in batch:
        raise NotImplementedError(
            "lirec_tpu_torch ports the packed eval forward only; dense "
            "`features` batches come with the training slice"
        )
    later = [k for k in _LATER_KEYS if k in batch]
    if later:
        raise NotImplementedError(
            "batch-local table keys %s are not ported yet (eval-sweep slice)"
            % later
        )
    if spec.mod_check:
        raise NotImplementedError("the modalities model is not ported yet")
    device = next(model.parameters()).device
    feat_idx = torch.as_tensor(batch["feat_idx"], dtype=torch.int32,
                               device=device)
    rels_mask = batch.get("rels_mask")
    if rels_mask is not None:
        rels_mask = torch.as_tensor(rels_mask, dtype=torch.float32,
                                    device=device)
    forward = (
        tabular.midfusion_maxtracks_tabular if spec.tr_maximize
        else tabular.midfusion_tabular
    )
    return forward(model, spec, tables, feat_idx, rels_mask,
                   embedded=embedded, use_kernel=use_kernel)


class ModelBundle(NamedTuple):
    spec: ModelSpec
    model: nn.Module
    apply: Callable  # apply(model, batch, tables=None, embedded=None, ...)


def create_model(cfg, n_classes: int, n_rels: int = 0,
                 seed: Optional[int] = None, device=None) -> ModelBundle:
    """Build (spec, model, apply) for a config. The weights are drawn from
    a CPU ``torch.Generator`` seeded with `seed` (default
    ``cfg.optim.seed``) and then moved to `device`."""
    spec = ModelSpec.from_config(cfg, n_classes, n_rels)
    if spec.mod_check:
        raise NotImplementedError("the modalities model is not ported yet")
    gen = torch.Generator().manual_seed(
        cfg.optim.seed if seed is None else seed
    )
    model = init_midfusion(spec, gen)
    if device is not None:
        model = model.to(device)

    def apply_fn(model, batch, tables=None, embedded=None, **kw):
        return apply_model(model, spec, batch, tables=tables,
                           embedded=embedded, **kw)

    return ModelBundle(spec=spec, model=model, apply=apply_fn)
