"""Faults planted in the program, for the check that the comparison
catches them: the benchmark's tests run a cell with each of them on the
CPU, and ``calibrate.py`` reads them at a cell's own size on the card.
Each is a context manager that swaps one function of the program for a
broken one and puts it back on exit.

Eval sweep (evaluation/packed's step): its carry left unchanged; half of
each batch left out (the step over the first half of the rows); the
answer altered where it is made (the grounding's predicted track, and
the model's interaction scores of each batch's first sample). Training
(train/loop's step): its state left unchanged; half of each batch left
out; each batch's first label altered. One chip, so no exchange between
chips to leave out.
"""

from __future__ import annotations

import contextlib

__all__ = ["EVAL", "TRAIN", "planted"]


def rows(batch, n):
    """The first n rows of every per-sample key of a batch (the local
    tables' row lists are per batch, and stay whole)."""
    return {k: v if k in ("uniq_clip", "uniq_track") else v[:n]
            for k, v in batch.items()}


@contextlib.contextmanager
def _swapped(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _eval_step(wrap):
    """evaluation/packed's step, as `wrap(step)` makes it."""
    from lirec_tpu_torch.evaluation import packed

    def make(real):
        def builder(*args, **kw):
            init, step = real(*args, **kw)
            broken = wrap(step)
            broken.loss_generator = step.loss_generator
            return init, broken
        return builder

    return _swapped(packed, "device_sweep_builder", make)


def eval_unchanged():
    def wrap(step):
        def kept(model, tables, embedded, carry, batch):
            return carry
        return kept
    return _eval_step(wrap)


def eval_half():
    def wrap(step):
        def half(model, tables, embedded, carry, batch):
            n = batch["labels"].shape[0]
            return step(model, tables, embedded, carry,
                        rows(batch, max(n // 2, 1)))
        return half
    return _eval_step(wrap)


def eval_altered_track():
    from lirec_tpu_torch.evaluation import device_metrics

    def make(real):
        def altered(*args, **kw):
            out = real(*args, **kw)
            out["pr_track"] = (out["pr_track"] + 1) % args[0].shape[1]
            return out
        return altered

    return _swapped(device_metrics, "grounding_predictions", make)


def eval_altered_scores():
    from lirec_tpu_torch.models import factory

    def make(real):
        def apply(*args, **kw):
            out = dict(real(*args, **kw))
            ints = out["inters"].clone()
            ints[0] = ints[0].roll(1, dims=-1)
            out["inters"] = ints
            return out
        return apply

    return _swapped(factory, "apply_model", make)


def _train_step(wrap):
    """train/loop's step, as `wrap(step, bundle)` makes it."""
    from lirec_tpu_torch.train import loop

    def make(real):
        def make_step(bundle, optimizer, *args, **kw):
            return wrap(real(bundle, optimizer, *args, **kw), bundle)
        return make_step

    return _swapped(loop, "make_train_step", make)


def train_unchanged():
    import torch

    def wrap(step, bundle):
        def kept(batch, *args, **kw):
            before = [p.detach().clone() for p in bundle.model.parameters()]
            loss = step(batch, *args, **kw)
            with torch.no_grad():
                for p, b in zip(bundle.model.parameters(), before):
                    p.copy_(b)
            return loss
        return kept
    return _train_step(wrap)


def train_half():
    def wrap(step, bundle):
        def half(batch, *args, **kw):
            return step(rows(batch, batch["labels"].shape[0] // 2), *args,
                        **kw)
        return half
    return _train_step(wrap)


def train_altered():
    def wrap(step, bundle):
        def altered(batch, *args, **kw):
            labels = batch["labels"].clone()
            labels[0] = (labels[0] + 1) % bundle.spec.n_classes
            return step(dict(batch, labels=labels), *args, **kw)
        return altered
    return _train_step(wrap)


EVAL = {"unchanged": eval_unchanged, "half_batch": eval_half,
        "altered_track": eval_altered_track,
        "altered_scores": eval_altered_scores}
TRAIN = {"unchanged": train_unchanged, "half_batch": train_half,
         "altered": train_altered}


def planted(kind: str, name: str):
    """The fault `name` of a traffic kind ("eval_sweep", "train_epochs")."""
    return {"eval_sweep": EVAL, "train_epochs": TRAIN}[kind][name]()
