"""Model and loss selection (counterpart of lirec_tpu/models/factory.py).

Ported: the packed forwards of the mid-fusion presets (``int_rel_ch``,
``int_ch``, ``int_rels``): at eval the embed-then-gather path over
embedded tables (models/tabular.py), in training the hybrid path
(models/hybrid.py), with the batch-local tables of data/localize.py; and
the loss each preset trains with. The dense forwards, the modalities model
and the eval ctx-localisation batch keys are later slices, and say so.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from lirec_tpu_torch.models import hybrid, tabular
from lirec_tpu_torch.models import losses as losses_lib
from lirec_tpu_torch.models.midfusion import init_midfusion
from lirec_tpu_torch.models.spec import ModelSpec

__all__ = ["ModelBundle", "create_model", "apply_model"]

_LATER_KEYS = ("ctx_triples", "ctx_uniq_clip")


def apply_model(
    model: nn.Module,
    spec: ModelSpec,
    batch: Dict,
    tables: Optional[Dict] = None,
    embedded: Optional[Dict] = None,
    use_kernel: bool = True,
    deterministic: bool = True,
    rng: Optional[torch.Generator] = None,
    use_tabular: Optional[bool] = None,
) -> Dict:
    """Forward of a packed batch (``feat_idx`` index triples resolved
    against ``tables``, or at eval against their ``embedded`` form from
    models/tabular.embed_all).

    At eval (deterministic, the default) the embed-then-gather path runs;
    use_tabular=False, or deterministic=False with a dropout generator
    `rng`, runs the hybrid training forward. A batch carrying
    ``uniq_clip``/``uniq_track`` (data/localize.py) first gathers those raw
    table rows, and its ``feat_idx`` points into them. use_kernel=False
    takes the plain ctx pool (eval) or the plain scatter in the backward
    (training), for comparisons.
    """
    if "feat_idx" not in batch:
        raise NotImplementedError(
            "lirec_tpu_torch ports the packed forwards only; dense "
            "`features` batches are not ported yet"
        )
    later = [k for k in _LATER_KEYS if k in batch]
    if later:
        raise NotImplementedError(
            "batch-local table keys %s are not ported yet (eval-sweep slice)"
            % later
        )
    if spec.mod_check:
        raise NotImplementedError("the modalities model is not ported yet")
    if use_tabular is None:
        use_tabular = deterministic
    device = next(model.parameters()).device
    if tables is not None and "uniq_clip" in batch:
        # batch-local tables: the first layers (and their backward) run
        # over the batch's unique rows instead of the whole tables
        uc = torch.as_tensor(batch["uniq_clip"], device=device).long()
        ut = torch.as_tensor(batch["uniq_track"], device=device).long()
        tables = {"text": tables["text"][uc], "visual": tables["visual"][uc],
                  "track": tables["track"][ut]}
    feat_idx = torch.as_tensor(batch["feat_idx"], dtype=torch.int32,
                               device=device)
    rels_mask = batch.get("rels_mask")
    if rels_mask is not None:
        rels_mask = torch.as_tensor(rels_mask, dtype=torch.float32,
                                    device=device)
    if use_tabular:
        forward = (
            tabular.midfusion_maxtracks_tabular if spec.tr_maximize
            else tabular.midfusion_tabular
        )
        return forward(model, spec, tables, feat_idx, rels_mask,
                       embedded=embedded, use_kernel=use_kernel)
    forward = (
        hybrid.midfusion_maxtracks_hybrid if spec.tr_maximize
        else hybrid.midfusion_hybrid
    )
    return forward(model, spec, tables, feat_idx, rels_mask,
                   deterministic=deterministic, rng=rng,
                   use_kernel=use_kernel)


def _make_loss(cfg, n_rels: int) -> Callable:
    """The loss a config trains with (ref mlp/model.py:578-597):
    loss(outputs, batch, rng=None, tr_sum_max_flag=None) -> scalar."""
    t, o = cfg.tasks, cfg.optim

    def flag(tr_sum_max_flag):
        return t.tr_sum_max_flag if tr_sum_max_flag is None else \
            tr_sum_max_flag

    if t.tr_maximize and t.rels_multitask:
        def loss(outputs, batch, rng=None, tr_sum_max_flag=None):
            return losses_lib.margin_track_rels_loss(
                outputs, batch, n_rels, tr_margin=o.tr_margin,
                lymbda=o.lymbda, tr_correct=t.tr_correct,
                tr_cat_distr=t.tr_cat_distr, tr_max_neg=t.tr_max_neg,
                tr_sum_max_flag=flag(tr_sum_max_flag), rng=rng,
            )
    elif t.tr_maximize:
        def loss(outputs, batch, rng=None, tr_sum_max_flag=None):
            return losses_lib.margin_loss(
                outputs, batch, tr_margin=o.tr_margin,
                tr_correct=t.tr_correct, tr_cat_distr=t.tr_cat_distr,
                tr_max_neg=t.tr_max_neg,
                tr_sum_max_flag=flag(tr_sum_max_flag), rng=rng,
            )
    elif t.rels_multitask:
        def loss(outputs, batch, rng=None, tr_sum_max_flag=None):
            return losses_lib.multitask_max_margin_loss(
                outputs, batch, n_rels, margin=o.margin, lymbda=o.lymbda,
                ints=t.ints, ctx=t.ctx,
            )
    else:
        def loss(outputs, batch, rng=None, tr_sum_max_flag=None):
            return losses_lib.max_margin_ce_loss(outputs, batch,
                                                 margin=o.margin)
    return loss


class ModelBundle(NamedTuple):
    spec: ModelSpec
    model: nn.Module
    apply: Callable  # apply(model, batch, tables=None, embedded=None, ...)
    loss: Callable  # loss(outputs, batch, rng=None, tr_sum_max_flag=None)


def create_model(cfg, n_classes: int, n_rels: int = 0,
                 seed: Optional[int] = None, device=None) -> ModelBundle:
    """Build (spec, model, apply, loss) for a config. The weights are drawn from
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

    return ModelBundle(spec=spec, model=model, apply=apply_fn,
                       loss=_make_loss(cfg, n_rels))
