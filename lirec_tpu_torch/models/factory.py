"""Model and loss selection (counterpart of lirec_tpu/models/factory.py).

Ported: the packed forwards of the mid-fusion presets (``int_rel_ch``,
``int_ch``, ``int_rels``) and of the Modalities model (``modalities``, the
text-only ablation): at eval the embed-then-gather path over embedded
tables (models/tabular.py) with the eval sweep's ctx localisation keys, in
training the hybrid path (models/hybrid.py), with the batch-local tables
of data/localize.py; the dense forwards over reference-layout
``features`` rows (models/midfusion.py, models/modalities.py), the JAX
package's parity oracle; and the loss each preset trains with.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn

from lirec_tpu_torch.models import hybrid, tabular
from lirec_tpu_torch.models import losses as losses_lib
from lirec_tpu_torch.models.blocks import slices_from_dense
from lirec_tpu_torch.models.midfusion import (
    init_midfusion, midfusion_forward, midfusion_maxtracks_forward,
)
from lirec_tpu_torch.models.modalities import (
    init_modalities, modalities_forward,
)
from lirec_tpu_torch.models.spec import ModelSpec

__all__ = ["ModelBundle", "create_model", "apply_model"]


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
    context_group=None,
) -> Dict:
    """Forward of a packed batch (``feat_idx`` index triples resolved
    against ``tables``, or at eval against their ``embedded`` form from
    models/tabular.embed_all), or of a dense one (``features`` rows in the
    reference layout; `tables`, `embedded`, `use_kernel` and
    `use_tabular` do not apply, and no kernel runs).

    At eval (deterministic, the default) the embed-then-gather path runs;
    use_tabular=False, or deterministic=False with a dropout generator
    `rng`, runs the hybrid training forward. A batch carrying
    ``uniq_clip``/``uniq_track`` (data/localize.py) first gathers those raw
    table rows, and its ``feat_idx`` points into them. At eval a batch
    carrying ``ctx_triples``/``ctx_tidx`` (the triple tier) or
    ``ctx_uniq_clip``/``ctx_uniq_track`` (the per-table tier) of
    data/localize.localize_eval_ctx[_triples] pools its context from
    batch-local embedded ctx rows. use_kernel=False takes the plain ctx
    pool (eval) or the plain scatter in the backward (training), for
    comparisons. The Modalities model (``spec.mod_check``) reads slot 0
    of ``feat_idx`` only and launches no kernel.

    `context_group` (a process group; the JAX package's ``context_axis``):
    the eval forward's context pool runs over the group, each process
    pooling a contiguous block of the R ctx slots with the masked-sum
    kernel (models/tabular._ctx_branch_context); every process passes the
    same batch and gets the whole output. The triple tier stays off under
    it, as in the JAX package.
    """
    if "feat_idx" not in batch:
        return _apply_dense(model, spec, batch, deterministic, rng)
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
    if spec.mod_check:
        if use_tabular:
            return tabular.modalities_tabular(model, spec, tables, feat_idx,
                                              embedded=embedded)
        return hybrid.modalities_hybrid(model, spec, tables, feat_idx,
                                        deterministic=deterministic, rng=rng)
    if use_tabular:
        ctx_triple = None
        if (embedded is not None and spec.ctx and "ctx_triples" in batch
                and context_group is None):
            # triple tier: this batch's unique fused [clip | tr1 | tr2]
            # rows in one local table, one row gather per context entry;
            # feat_idx stays global (slot 0, the ints row, is untouched)
            tri = torch.as_tensor(batch["ctx_triples"], device=device).long()
            ctx = embedded["ctx"]
            fused = torch.cat([ctx.clip[tri[:, 0]], ctx.tr1[tri[:, 1]],
                               ctx.tr2[tri[:, 2]]], dim=-1)
            ctx_triple = (fused, torch.as_tensor(batch["ctx_tidx"],
                                                 device=device))
        if embedded is not None and "ctx_uniq_clip" in batch:
            # per-table tier: feat_idx slots 1..R already point into this
            # batch's unique embedded ctx rows; slot 0 stays global
            uc = torch.as_tensor(batch["ctx_uniq_clip"], device=device).long()
            ut = torch.as_tensor(batch["ctx_uniq_track"],
                                 device=device).long()
            ctx = embedded["ctx"]
            embedded = dict(embedded, ctx=tabular.EmbeddedTables(
                ctx.clip[uc], ctx.tr1[ut], ctx.tr2[ut]))
        forward = (
            tabular.midfusion_maxtracks_tabular if spec.tr_maximize
            else tabular.midfusion_tabular
        )
        return forward(model, spec, tables, feat_idx, rels_mask,
                       embedded=embedded, use_kernel=use_kernel,
                       ctx_triple=ctx_triple, context_group=context_group)
    forward = (
        hybrid.midfusion_maxtracks_hybrid if spec.tr_maximize
        else hybrid.midfusion_hybrid
    )
    return forward(model, spec, tables, feat_idx, rels_mask,
                   deterministic=deterministic, rng=rng,
                   use_kernel=use_kernel)


def _apply_dense(model: nn.Module, spec: ModelSpec, batch: Dict,
                 deterministic: bool, rng: Optional[torch.Generator]) -> Dict:
    """The dense forwards (the features branch of the JAX package's
    apply_model): the Modalities model reads the GT row, MaxTracks a
    ctx-off [B, T, D] batch as [B, T, 1, D]."""
    device = next(model.parameters()).device
    s = slices_from_dense(torch.as_tensor(batch["features"],
                                          dtype=torch.float32,
                                          device=device), spec)
    if spec.mod_check:
        if s.text.dim() == 3:  # [B, 1, D] -> the GT row
            s = s.index(slice(None), 0)
        return modalities_forward(model, spec, s, deterministic, rng)
    rels_mask = batch.get("rels_mask")
    if rels_mask is not None:
        rels_mask = torch.as_tensor(rels_mask, dtype=torch.float32,
                                    device=device)
    if spec.tr_maximize:
        if s.text.dim() == 3:  # ctx-off dense [B, T, D] -> [B, T, 1, D]
            s = type(s)(*(a[:, :, None, :] for a in s))
        return midfusion_maxtracks_forward(model, spec, s, rels_mask,
                                           deterministic, rng)
    return midfusion_forward(model, spec, s, rels_mask, deterministic, rng)


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
                 seed: Optional[int] = None, device="cuda") -> ModelBundle:
    """Build (spec, model, apply, loss) for a config. The weights are drawn from
    a CPU ``torch.Generator`` seeded with `seed` (default
    ``cfg.optim.seed``) and then moved to `device` (the card unless the
    caller asks for the CPU)."""
    spec = ModelSpec.from_config(cfg, n_classes, n_rels)
    gen = torch.Generator().manual_seed(
        cfg.optim.seed if seed is None else seed
    )
    init = init_modalities if spec.mod_check else init_midfusion
    model = init(spec, gen).to(device)

    def apply_fn(model, batch, tables=None, embedded=None, **kw):
        return apply_model(model, spec, batch, tables=tables,
                           embedded=embedded, **kw)

    return ModelBundle(spec=spec, model=model, apply=apply_fn,
                       loss=_make_loss(cfg, n_rels))
