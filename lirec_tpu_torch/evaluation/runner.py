"""Metric summary of an evaluation (counterpart of
``lirec_tpu/evaluation/runner.summarize_metrics``). The per-batch host
loop ``evaluate`` (``--host-eval``) is not ported."""

from __future__ import annotations

from typing import Dict

__all__ = ["summarize_metrics"]


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
