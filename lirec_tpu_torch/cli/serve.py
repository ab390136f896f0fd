"""Inference server: HTTP/JSON around the eager PyTorch eval forward.

Counterpart of lirec_tpu/cli/serve.py, with the same flags, JSON schema,
validation, error strings and status codes:

    POST /predict   {"samples": [{"feat_idx": [[c,t1,t2] x (1+R)] x T,
                                  "rels_mask": [[0/1 x R] x T]}, ...]}
      -> {"predictions": [{"interactions": [{"label": i, "score": s} topk],
                           "relationships": [...],
                           "track_scores": [...], "best_track": t}, ...]}
    GET  /healthz   -> {"status": "ok", ...}

Feature tables are embedded once at start-up (models/tabular.embed_all) on
the engine's device; each request is one forward at its own batch size.
There is no batch-size bucketing and no executable cache: eager PyTorch
compiles nothing per shape (the JAX server padded to power-of-two buckets
to bound XLA compiles).

    python -m lirec_tpu_torch.cli.serve --data-root <root> [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict

import numpy as np
import torch

from lirec_tpu_torch.evaluation.metrics import _sigmoid as sigmoid
from lirec_tpu_torch.models.tabular import embed_all


class InferenceEngine:
    """Eval forward over fixed feature tables embedded once on `device`."""

    def __init__(self, bundle, tables, *, device, topk: int = 5,
                 max_batch: int = 64):
        self.device = torch.device(device)
        self.bundle = bundle._replace(model=bundle.model.to(self.device).eval())
        self.topk = topk
        self.max_batch = max_batch
        spec = bundle.spec
        self.n_clip_rows = int(tables["text"].shape[0])
        self.n_track_rows = int(tables["track"].shape[0])
        # fixed request geometry: only the batch dim varies
        self.n_hyps = 20 if spec.tr_maximize else 1
        self.n_ctx = (18 + 1) if spec.ctx else 1
        with torch.inference_mode():
            dev_tables = {
                k: torch.as_tensor(np.asarray(tables[k], np.float32),
                                   device=self.device)
                for k in ("text", "visual", "track")
            }
            # the raw tables are not needed once embedded
            self.embedded = embed_all(self.bundle.model, spec, dev_tables)
        self._lock = threading.Lock()

    def warm(self, batch_sizes) -> None:
        """Run the forward once per batch size (row 0 of every table is
        valid, so all-zero requests are): the first real request then pays
        neither the kernel build nor the library start-up."""
        for b in sorted({min(int(x), self.max_batch) for x in batch_sizes}):
            feat_idx = np.zeros((b, self.n_hyps, self.n_ctx, 3), np.int32)
            rels_mask = np.zeros((b, self.n_hyps, self.n_ctx - 1), np.int32)
            if not self.bundle.spec.tr_maximize:
                feat_idx = feat_idx[:, 0]
                rels_mask = rels_mask[:, 0]
            self.predict(feat_idx, rels_mask)

    def _validate(self, feat_idx: np.ndarray, rels_mask: np.ndarray) -> None:
        if self.bundle.spec.tr_maximize:
            expect = (self.n_hyps, self.n_ctx, 3)
            mask_expect = (self.n_hyps, self.n_ctx - 1)
        else:
            expect = (self.n_ctx, 3)
            mask_expect = (self.n_ctx - 1,)
        if feat_idx.shape[1:] != expect:
            raise ValueError(
                "feat_idx must be [B, %s] for this preset; got %s"
                % (", ".join(map(str, expect)), feat_idx.shape)
            )
        if self.n_ctx > 1 and rels_mask.shape[1:] != mask_expect:
            raise ValueError(
                "rels_mask must be [B, %s]; got %s"
                % (", ".join(map(str, mask_expect)), rels_mask.shape)
            )
        # the gathers (and the CUDA pool kernel) do not check indices:
        # reject out-of-range ones here
        clip = feat_idx[..., 0]
        trk = feat_idx[..., 1:]
        if clip.min() < 0 or clip.max() >= self.n_clip_rows:
            raise ValueError(
                "clip index out of range [0, %d)" % self.n_clip_rows
            )
        if trk.min() < 0 or trk.max() >= self.n_track_rows:
            raise ValueError(
                "track index out of range [0, %d)" % self.n_track_rows
            )

    def predict(self, feat_idx: np.ndarray, rels_mask: np.ndarray):
        """feat_idx [B, T, 1+R, 3]; rels_mask [B, T, R] -> per-sample topk."""
        B = feat_idx.shape[0]
        if B > self.max_batch:
            raise ValueError("batch too large: %d > %d" % (B, self.max_batch))
        self._validate(feat_idx, rels_mask)
        batch = {"feat_idx": np.asarray(feat_idx, np.int32),
                 "rels_mask": np.asarray(rels_mask, np.int32)}
        with self._lock, torch.inference_mode():
            out = self.bundle.apply(self.bundle.model, batch,
                                    embedded=self.embedded)
            inters = out["inters"].cpu().numpy().astype(np.float64)
            rels = out.get("rels")
            if rels is not None:
                rels = rels.cpu().numpy().astype(np.float64)
        if inters.ndim == 2:  # non-maxtracks presets: [B, C] -> [B, 1, C]
            inters = inters[:, None, :]
            if rels is not None:
                rels = rels[:, None, :]

        results = []
        for b in range(B):
            s_cl = sigmoid(inters[b])  # [T, C]
            track_scores = s_cl.max(axis=1)
            best_track = int(track_scores.argmax())
            class_scores = s_cl[best_track]
            top_cls = np.argsort(-class_scores)[: self.topk]
            item = {
                "track_scores": [round(float(x), 6) for x in track_scores],
                "best_track": best_track,
                "interactions": [
                    {"label": int(i), "score": round(float(class_scores[i]), 6)}
                    for i in top_cls
                ],
            }
            if rels is not None:
                s_r = sigmoid(rels[b])[min(best_track, rels.shape[1] - 1)]
                top_r = np.argsort(-s_r)[: self.topk]
                item["relationships"] = [
                    {"label": int(i), "score": round(float(s_r[i]), 6)}
                    for i in top_r
                ]
            results.append(item)
        return results


def make_handler(engine: InferenceEngine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "n_classes": engine.bundle.spec.n_classes,
                    "n_rels": engine.bundle.spec.n_rels,
                    "max_batch": engine.max_batch,
                })
            else:
                self._send(404, {"error": "unknown path %s" % self.path})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path %s" % self.path})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                # Cap the body before reading it: the largest legal request is
                # max_batch samples of [20, 19, 3] int indices (+ masks), well
                # under 1 MB/sample as JSON text.
                max_body = max(1, engine.max_batch) << 20
                if length < 0 or length > max_body:
                    # negative Content-Length would make read() block
                    # until EOF, parking the handler thread
                    self._send(413, {
                        "error": "request body %d bytes exceeds %d"
                        % (length, max_body)
                    })
                    return
                payload = json.loads(self.rfile.read(length) or b"{}")
                samples = payload["samples"]
                feat_idx = np.asarray(
                    [s["feat_idx"] for s in samples], np.int32
                )
                if all("rels_mask" in s for s in samples):
                    rels_mask = np.asarray(
                        [s["rels_mask"] for s in samples], np.int32
                    )
                else:  # context-free presets don't need a mask
                    rels_mask = np.zeros((len(samples), 1), np.int32)
                if feat_idx.ndim not in (3, 4) or feat_idx.shape[-1] != 3:
                    raise ValueError(
                        "feat_idx must be [T, 1+R, 3] (maxtracks presets) or "
                        "[1+R, 3] per sample; got %s" % (feat_idx.shape,)
                    )
                results = engine.predict(feat_idx, rels_mask)
                self._send(200, {"predictions": results})
            except (KeyError, ValueError, TypeError) as err:
                self._send(400, {"error": str(err)})
            except Exception as err:  # runtime/CUDA errors -> clean 500
                self._send(500, {"error": "%s: %s" % (type(err).__name__, err)})

    return Handler


CHECKPOINT_SUFFIXES = (".pth.tar", ".pth", ".tar")


def load_checkpoint_state(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file -> the port's state_dict: a reference (or the
    port's own) ``.pth.tar``, or a msgpack file of the JAX package
    (``.ckpt``, read by checkpoint/msgpack.py without flax). The JAX
    package's Orbax directories need orbax.checkpoint, which imports jax,
    and are refused."""
    from lirec_tpu_torch.checkpoint import (
        load_jax_checkpoint, load_torch_checkpoint,
    )

    if os.path.isdir(path):
        raise ValueError(
            "%r is an Orbax checkpoint directory of the JAX package; "
            "lirec_tpu_torch reads .pth.tar and msgpack .ckpt files" % path)
    if path.endswith(CHECKPOINT_SUFFIXES):
        state, _ = load_torch_checkpoint(path)
        return state
    state, _, _ = load_jax_checkpoint(path)
    return state


def build_engine_from_args(args) -> InferenceEngine:
    from lirec_tpu_torch import config as config_lib
    from lirec_tpu_torch.data.dataset import InteractionDataset
    from lirec_tpu_torch.models.factory import create_model

    cfg = config_lib.preset(args.preset, data_root=args.data_root)
    cfg = cfg.with_dims(
        text_dim=args.text_dim, visual_dim=args.visual_dim,
        text_layers=args.text_layers, joint_dim=args.joint_dim,
    )
    ds = InteractionDataset(cfg, mode=args.split)
    ds.cache(parallel_workers=args.cache_workers)
    if cfg.tasks.rels or cfg.tasks.rels_multitask:
        ds.init_relships()
    bundle = create_model(cfg, ds.n_classes, n_rels=max(ds.n_rels - 1, 0),
                          device=args.device)
    if args.resume_path:
        bundle.model.load_state_dict(load_checkpoint_state(args.resume_path))
    return InferenceEngine(bundle, ds.tables.as_dict(), device=args.device,
                           topk=args.topk, max_batch=args.max_batch)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lirec-tpu-torch serve")
    p.add_argument("--data-root", required=True)
    p.add_argument("--preset", default="int_rel_ch")
    p.add_argument("--split", default="test")
    p.add_argument("--resume-path", default="")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8900)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--cache-workers", type=int, default=0)
    p.add_argument("--text-dim", type=int, default=768)
    p.add_argument("--visual-dim", type=int, default=2048)
    p.add_argument("--text-layers", type=int, default=12)
    p.add_argument("--joint-dim", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="torch device the tables and weights live on")
    p.add_argument("--warm-buckets", default="1",
                   help="comma-separated batch sizes run once at startup "
                        "(the first request then skips the kernel build); "
                        "empty string disables")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    engine = build_engine_from_args(args)
    if args.warm_buckets:
        sizes = [int(x) for x in args.warm_buckets.split(",") if x]
        print("warming predict batch sizes %s..." % sizes)
        engine.warm(sizes)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(engine))
    print("serving on http://%s:%d" % (args.host, args.port))
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
