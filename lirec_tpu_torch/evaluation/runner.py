"""The per-batch host evaluation loop, the relationship-only multi-clip
evaluation and the metric summary (counterparts of ``evaluate``,
``evaluate_rels_only`` and ``summarize_metrics`` of
lirec_tpu/evaluation/runner.py, ref ``mlp/test.py:17-145``).

``evaluate`` (``--host-eval``) embeds the tables once, runs the eval
forward and the loss per batch on the model's device and fills the host
accumulators (evaluation/metrics.py) in the JAX package's branch order;
the grounding presets take their argmaxes on the device
(``device_metrics.grounding_predictions``). It gives the metric dict of
the packed sweep (evaluation/packed.py), batch for batch: the same
batches, the same skip of size-1 batches, and the same fixed loss
generator (seeded 0 before every loss, as the sweep seeds it). Eager
launches run ahead of the host until a ``.cpu()`` waits, so the JAX
package's PIPELINE_DEPTH queue is a plain loop here. With
``return_details`` it also returns the confusion matrix and the filled
accumulators, as the JAX package's does.

``evaluate_rels_only`` scores every (pair, relationship) hash over all its
clips (ref ``test_rels_multi_clip`` mode): the items stream into
power-of-two buckets of clips, each flushed at the batch size through the
eval forward, whose ctx pool is the CUDA kernel on the card (kernel 1 on
f32 tables, kernel 2 on bf16) at M = the batch size and R = the bucket.

With ``dense=True`` the loop runs over dense batches (each sample's
``features`` rows in the reference layout, data/pipeline.BatchIterator's
dense layout) through the dense forwards: no tables and no ``embed_all``.

The host loop does not run over a data mesh: only the packed sweep is
sharded over processes (``MESH_HOST_EVAL``, the JAX package's refusal).

Not ported: ``jit_apply``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["evaluate", "evaluate_rels_only", "summarize_metrics",
           "MESH_HOST_EVAL"]

MESH_HOST_EVAL = "--mesh only shards the packed eval sweep; drop --host-eval"

MODEL_KEYS = ("features", "feat_idx", "rels_mask")


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _device_tables(tables: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(tables[k], dtype=torch.float32, device=device)
            for k in ("text", "visual", "track")}


class _Bucket:
    """One power-of-two bucket of rels-only items: [B, padded + 1, 3]
    index triples and [B, padded, 1] weights, rows filled up to n (padded
    rows and clips are table row 0 with weight 0)."""

    def __init__(self, B: int, padded: int):
        self.feat = np.zeros((B, padded + 1, 3), np.int32)
        self.mask = np.zeros((B, padded, 1), np.int32)
        self.labels = np.zeros(B, int)
        self.hashes = np.zeros(B, int)
        self.n = 0

    def add(self, i: int, item: Dict) -> None:
        L = item["feat_idx"].shape[0] - 1
        row = self.n
        self.feat[row] = 0
        self.feat[row, : L + 1] = item["feat_idx"]
        self.mask[row] = 0
        self.mask[row, :L, 0] = item["rels_mask"][:, 0]
        self.labels[row] = item["rels_label"]
        self.hashes[row] = i
        self.n += 1


def evaluate_rels_only(
    dataset, bundle, model, cfg, verbose: bool = True, batch_size: int = 0,
    use_kernel: bool = True,
) -> Dict[str, float]:
    """Relationship-only eval over (pair, rel) hashes with ALL their clips
    (ref ``test_rels_multi_clip`` mode, classification_dataloader.py:
    293-303); returns {'rels_top1', 'rels_top3'}.

    Items stream one at a time into buckets of the next power of two >=
    their clip count L (at least 2); a bucket is evaluated when it holds
    ``batch_size`` items (default ``cfg.optim.batch_size``), the rest in
    bucket order at the end, and the padded rows are sliced off before the
    accumulator sees them, as in the JAX package. The tables are embedded
    once (the weights are frozen) and each bucket runs the non-maxtracks
    eval forward (models/tabular.midfusion_tabular) on `model`'s device.
    use_kernel=False takes the plain ctx pool, for comparisons.
    ``dataset.test_rels_multi_clip`` is restored on the way out."""
    import dataclasses

    from lirec_tpu_torch.evaluation.metrics import RelationshipsAcc
    from lirec_tpu_torch.models.tabular import embed_all, midfusion_tabular
    from lirec_tpu_torch.ops import dispatch

    B = batch_size or cfg.optim.batch_size
    device = next(model.parameters()).device
    # items are [L+1, 3] whatever the preset: the non-maxtracks forward
    flat_spec = dataclasses.replace(bundle.spec, tr_maximize=False)
    dispatch.record("eval_loop", "rels_only", "rels", {"batch_size": B})
    was = dataset.test_rels_multi_clip
    dataset.test_rels_multi_clip = True
    try:
        acc = RelationshipsAcc(n_rels=dataset.n_rels)
        model.eval()
        with torch.inference_mode():
            embedded = embed_all(
                model, flat_spec,
                _device_tables(dataset.tables.as_dict(), device))

            def flush(bucket: _Bucket) -> None:
                if not bucket.n:
                    return
                out = midfusion_tabular(
                    model, flat_spec, None,
                    torch.from_numpy(bucket.feat).to(device),
                    torch.from_numpy(bucket.mask).to(device),
                    embedded=embedded, use_kernel=use_kernel)
                acc.update(_host(out["rels"])[: bucket.n],
                           bucket.labels[: bucket.n],
                           bucket.hashes[: bucket.n])
                bucket.n = 0

            buckets: Dict[int, _Bucket] = {}
            for i in range(len(dataset)):
                item = dataset[i]
                L = item["feat_idx"].shape[0] - 1
                padded = 1 << max(1, L - 1).bit_length()  # next pow2 >= L
                bucket = buckets.get(padded)
                if bucket is None:
                    bucket = buckets[padded] = _Bucket(B, padded)
                bucket.add(i, item)
                if bucket.n == B:
                    flush(bucket)
            for padded in sorted(buckets):
                flush(buckets[padded])
        out = {"rels_top1": acc.top1(), "rels_top3": acc.top3()}
        if verbose:
            print("RELS-ONLY rels@top1: %f" % out["rels_top1"])
            print("RELS-ONLY rels@top3: %f" % out["rels_top3"])
        return out
    finally:
        dataset.test_rels_multi_clip = was


def evaluate(
    dataset,
    bundle,
    model,
    cfg,
    mode: str = "val",
    tables: Optional[Dict] = None,
    verbose: bool = True,
    return_details: bool = False,
    mesh=None,
    dense: bool = False,
) -> Dict[str, float]:
    """One evaluation pass of `model` (on its own device) over `dataset`;
    returns {'total', 'ints'[, 'rels'][, 'tracks', 'joint'], 'loss'} (ref
    test.py:138-145). `tables` default to the dataset's; numpy arrays or
    tensors; dense=True takes dense batches and no tables. return_details=True adds 'conf_mat' (the [n_classes,
    n_classes] confusion matrix of the presets that fill it),
    'accumulator' and, where there is one, 'rels_accumulator'. A data
    mesh of more than one process is refused (MESH_HOST_EVAL)."""
    if mesh is not None and mesh.size > 1:
        raise ValueError(MESH_HOST_EVAL)
    from lirec_tpu_torch.data.pipeline import BatchIterator
    from lirec_tpu_torch.evaluation.device_metrics import (
        grounding_predictions,
    )
    from lirec_tpu_torch.evaluation.metrics import (
        MetricAccumulator, RelationshipsAcc,
    )
    from lirec_tpu_torch.models.tabular import embed_all
    from lirec_tpu_torch.ops import dispatch

    t = cfg.tasks
    n_rels = dataset.n_rels
    prec = MetricAccumulator(n_rels=n_rels)
    prec_rels = RelationshipsAcc(n_rels=n_rels) if t.rels_multitask else None
    conf_mat = np.zeros((dataset.n_classes, dataset.n_classes))
    losses = []
    device = next(model.parameters()).device
    if tables is None and not dense:
        tables = dataset.tables.as_dict()
    it = BatchIterator(dataset, cfg.optim.batch_size, shuffle=False,
                       dense=dense)
    dispatch.record("eval_loop", "host", mode,
                    {"batch_size": cfg.optim.batch_size, "dense": dense})
    loss_rng = (torch.Generator(device=device) if t.tr_cat_distr
                else None)
    model.eval()
    with torch.inference_mode():
        embedded = None
        if not dense:
            tables = _device_tables(tables, device)
            embedded = embed_all(model, bundle.spec, tables)
        for batch in it:
            if len(np.atleast_1d(batch["labels"])) == 1:
                continue  # ref test.py:38-39
            dev = {k: torch.as_tensor(np.asarray(v)).to(device)
                   for k, v in batch.items()}
            out = bundle.apply(model, {k: dev[k] for k in MODEL_KEYS
                                       if k in dev},
                               tables=tables, embedded=embedded)
            rng = None if loss_rng is None else loss_rng.manual_seed(0)
            losses.append(float(bundle.loss(out, dev, rng=rng)))
            B = len(batch["labels"])
            if t.soft_gt:
                conf_mat = prec.update_probs(
                    _host(out["inters"]).reshape(B, -1), batch["labels"],
                    soft_labels=batch["soft_labels"], conf_mat=conf_mat)
            elif t.tr_maximize:
                if not t.ints:
                    continue  # nothing to count, as in the JAX package
                preds = grounding_predictions(
                    out["inters"], dev["mem_mask"], dev["labels"],
                    pr_probs_rels=out["rels"] if t.ctx else None,
                    gt_rels=dev["rels_label"] if t.ctx else None)
                preds = {k: v.cpu().numpy() for k, v in preds.items()}
                kw = {}
                if t.ctx:
                    # samples whose GT-slot relationship is labeled (ref
                    # test.py:62)
                    kw = dict(gt_rels=batch["rels_label"],
                              rels_sample_idx=np.nonzero(
                                  batch["rels_label"][:, 0] - n_rels + 1)[0])
                prec.update_from_predictions(
                    preds, gt_classes=batch["labels"],
                    gt_tracks=batch["gt_tracks"],
                    just_zeros=batch["just_zeros"], **kw)
            elif t.rels_multitask:
                if t.ints:
                    inters = _host(out["inters"]).reshape(
                        B, -1, dataset.n_classes)[:, 0]
                    conf_mat = prec.update_probs(
                        inters, batch["labels"][:, 0].reshape(-1),
                        conf_mat=conf_mat)
                if t.ctx:
                    valid = np.nonzero(batch["rels_label"] - n_rels + 1)[0]
                    if len(valid):
                        prec_rels.update(_host(out["rels"])[valid],
                                         batch["rels_label"][valid],
                                         batch["hash_rel"][valid])
            else:
                conf_mat = prec.update_probs(
                    _host(out["inters"]).reshape(B, -1), batch["labels"],
                    conf_mat=conf_mat)
    avg_loss = float(np.mean(losses)) if losses else 0.0
    out = summarize_metrics(t, prec, prec_rels, avg_loss, mode, verbose)
    if return_details:
        out["conf_mat"] = conf_mat
        out["accumulator"] = prec
        if prec_rels is not None:
            out["rels_accumulator"] = prec_rels
    return out


def summarize_metrics(
    t, prec, prec_rels, avg_loss: float, mode: str, verbose: bool
) -> Dict[str, float]:
    """Printed lines + ModelSaver metric dict from filled accumulators
    (ref test.py:100-145)."""

    def log(msg):
        if verbose:
            print(msg)

    out_val = out_ints = out_rels = out_tr = out_joint = 0.0
    if t.ints:
        log("%s loss: %f" % (mode.upper(), avg_loss))
        log("%s pr@1: %f" % (mode.upper(), prec.top1()))
        if not t.tr_maximize:
            log("%s pr@5: %f" % (mode.upper(), prec.top5()))
        out_ints = prec.top1()
        out_joint = prec.top1()
        out_val += out_ints
    if t.soft_gt:
        log("%s pr soft@1 %f" % (mode.upper(), prec.top1_sf()))
        log("%s pr soft@5 %f" % (mode.upper(), prec.top5_sf()))
    if t.tr_maximize:
        out_ints = prec.cls_top1()
        out_tr = prec.trks_top1()
        out_val = out_val + out_tr + out_ints
        log("%s pr@trks: %f" % (mode.upper(), prec.trks_top1()))
        log("%s pr@cls: %f" % (mode.upper(), prec.cls_top1()))
        if t.ctx:
            out_rels = prec.rels_top1()
            log("%s pr@rels: %f" % (mode.upper(), prec.rels_top1()))
            out_val += out_rels
    if t.rels_multitask and t.ctx and not t.tr_maximize:
        out_rels = prec_rels.top1()
        out_val += out_rels
        log("%s rels@top1: %f" % (mode.upper(), prec_rels.top1()))
        log("%s rels@top3: %f" % (mode.upper(), prec_rels.top3()))
        log("%s rel+int: %f" % (mode.upper(), out_val))

    out = {"total": out_val, "ints": out_ints, "loss": avg_loss}
    if t.rels_multitask:
        out["rels"] = out_rels
    if t.tr_maximize:
        out["tracks"] = out_tr
        out["joint"] = out_joint
    return out
