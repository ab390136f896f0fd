"""The plain reference (benchmark/reference) held against lirec_tpu_torch at
a toy size on the CPU, with float32 compute in the program so that only the
order of sums differs. The test imports both; the reference imports
nothing of the program."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from harness import program, weights
from harness.split import make_split
from reference import plain

from toy import BENCH, TOY_DIMS, TOY_LOCALITY

ATOL = 1e-5


def _cfg(name):
    cfg = json.load(open(os.path.join(BENCH, "configs", name + ".json")))
    cfg.update(TOY_DIMS, compute_dtype="float32")
    return cfg


def _setup(name, seed=11, n=8):
    cfg = _cfg(name)
    w = weights.make_weights(plain.param_shapes(cfg), seed, "cpu")
    tables = weights.make_tables(cfg, seed, "cpu")
    data = make_split(seed, n, cfg["n_clips"], cfg["n_tracks"],
                      cfg["n_classes"], cfg["n_rels"], context=cfg["ctx"],
                      **TOY_LOCALITY)
    pc, bundle = program.build(cfg, w, "cpu", n)
    batch = {k: torch.as_tensor(v) for k, v in data.items()}
    return cfg, w, tables, batch, pc, bundle


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(BENCH, "reference")
    for f in os.listdir(ref_dir):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, f)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("lirec_tpu_torch", "lirec_tpu",
                                               "jax", "harness"), (f, n)


@pytest.mark.parametrize("name", ["int_rel_ch", "int_ch"])
def test_parameter_names_are_the_programs(name):
    cfg, w, _, _, _, bundle = _setup(name)
    have = {k: tuple(v.shape) for k, v in bundle.model.state_dict().items()}
    assert have == dict(plain.param_shapes(cfg))


@pytest.mark.parametrize("name", ["int_rel_ch", "int_ch"])
def test_eval_forward_loss_and_counters(name):
    from lirec_tpu_torch.evaluation.device_metrics import (
        grounding_predictions)
    from lirec_tpu_torch.evaluation.packed import _grounding_counters
    from lirec_tpu_torch.models.tabular import embed_all

    cfg, w, tables, batch, _, bundle = _setup(name)
    with torch.no_grad():
        emb = embed_all(bundle.model, bundle.spec, tables)
        keys = ("feat_idx", "rels_mask")
        out = bundle.apply(bundle.model, {k: batch[k] for k in keys
                                          if k in batch},
                           tables=tables, embedded=emb, use_kernel=False)
        ref = plain.forward_eval(w, cfg, plain.embed_tables(w, cfg, tables),
                                 batch["feat_idx"], batch.get("rels_mask"))
        for k in ("inters", "rels"):
            if cfg["ctx"] or k == "inters":
                assert torch.allclose(out[k], ref[k], atol=ATOL), k
        assert torch.allclose(bundle.loss(out, batch),
                              plain.grounding_loss(ref, batch, cfg),
                              rtol=1e-5)
        preds = grounding_predictions(
            out["inters"], batch["mem_mask"], batch["labels"],
            pr_probs_rels=out["rels"] if cfg["ctx"] else None,
            gt_rels=batch["rels_label"] if cfg["ctx"] else None)
        got = _grounding_counters(
            preds, batch["labels"], batch["gt_tracks"], batch["just_zeros"],
            gt_rels=batch["rels_label"] if cfg["ctx"] else None,
            n_rels=cfg["n_rels"] + 1)
        want = plain.counters(ref, batch, cfg)
        assert {k: int(v) for k, v in got.items()} == want


@pytest.mark.parametrize("name", ["int_rel_ch", "int_ch"])
def test_training_forward_with_the_same_dropout(name):
    cfg, w, tables, batch, _, bundle = _setup(name)
    seed = 2 ** 33 + 5
    out = bundle.apply(bundle.model, {k: batch[k] for k in
                                      ("feat_idx", "rels_mask")
                                      if k in batch},
                       tables=tables, deterministic=False,
                       rng=torch.Generator().manual_seed(seed),
                       use_tabular=False, use_kernel=False)
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref = plain.forward_rows(leaves, cfg, tables, batch["feat_idx"],
                             batch.get("rels_mask"),
                             torch.Generator().manual_seed(seed))
    assert torch.allclose(out["inters"], ref["inters"], atol=ATOL)
    loss = bundle.loss(out, batch)
    ref_loss = plain.grounding_loss(ref, batch, cfg)
    assert torch.allclose(loss, ref_loss, rtol=1e-5)
    loss.backward()
    grads = torch.autograd.grad(ref_loss, list(leaves.values()))
    for (n, p), g in zip(bundle.model.named_parameters(), grads):
        assert torch.allclose(p.grad, g, atol=1e-6, rtol=1e-4), n


def test_adam_step_is_torchs():
    p = {"a": torch.randn(5, 3, generator=torch.Generator().manual_seed(1))}
    q = torch.nn.Parameter(p["a"].clone())
    opt = torch.optim.Adam([q], lr=3e-5, weight_decay=1e-5)
    state = {}
    for i in range(3):
        g = torch.randn(5, 3, generator=torch.Generator().manual_seed(10 + i))
        q.grad = g.clone()
        opt.step()
        plain.adam_step(p, {"a": g}, state, 3e-5, 1e-5)
    assert torch.allclose(p["a"], q.detach(), atol=1e-9, rtol=1e-6)


def test_fp8_control_rounds_and_passes_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    q = plain.fp8_quant(x)
    err = ((q - x).abs().max() / x.abs().max()).detach()
    assert 1e-3 < float(err) < 0.07
    q.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert np.isfinite(float(plain.fp8_quant(torch.zeros(4)).sum()))
