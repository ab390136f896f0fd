"""The port's HTTP server, driven over a real socket as tests/test_serve.py
drives the JAX one, and held against the JAX InferenceEngine on the same
weights, tables and requests."""

import http.client
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from lirec_tpu import config as config_lib
from lirec_tpu.cli.serve import InferenceEngine as JaxEngine
from lirec_tpu.models.factory import create_model as jax_create_model
from lirec_tpu.utils.fake_batch import make_batch, make_tables
from lirec_tpu_torch.checkpoint import params_from_jax
from lirec_tpu_torch.cli.serve import (
    InferenceEngine,
    build_engine_from_args,
    make_handler,
    make_parser,
)
from lirec_tpu_torch.models.factory import create_model

N_CLIPS, N_TRACKS = 32, 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU tanh, run for the first time across several threads, has
    been seen to return values ~4e-5 off; one thread keeps the plain
    versions deterministic at these tolerances."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(preset, topk=3, max_batch=8):
    cfg = config_lib.preset(preset, data_root="/tmp/x")
    cfg = cfg.with_dims(text_dim=16, visual_dim=32, joint_dim=16)
    cfg = cfg.with_runtime(compute_dtype="float32")
    jb = jax_create_model(cfg, 9, n_rels=6)
    pb = create_model(cfg, 9, n_rels=6)
    pb.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                          jb.params)))
    tables = make_tables(jb.spec, N_CLIPS, N_TRACKS, seed=1)
    return (InferenceEngine(pb, tables, device="cpu", topk=topk,
                            max_batch=max_batch),
            JaxEngine(jb, tables, topk=topk, max_batch=max_batch))


@pytest.fixture(scope="module")
def server():
    engine, jax_engine = _engines("int_rel_ch")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(engine))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield "http://127.0.0.1:%d" % httpd.server_port, engine, jax_engine
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _samples(batch):
    return [
        {"feat_idx": batch["feat_idx"][i].tolist(),
         "rels_mask": batch["rels_mask"][i].tolist()}
        for i in range(batch["feat_idx"].shape[0])
    ]


def _same_ranking(got, want):
    """Scores within 1e-5 (both round to 6 decimals; f32 logits agree to
    ~1e-6); labels equal wherever the neighbouring scores differ by more
    than 1e-4, so that a near-tie cannot flip the order."""
    gs = [x["score"] for x in got]
    ws = [x["score"] for x in want]
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    for i in range(len(ws)):
        gaps = [abs(ws[i] - ws[j]) for j in (i - 1, i + 1)
                if 0 <= j < len(ws)]
        if all(g > 1e-4 for g in gaps):
            assert got[i]["label"] == want[i]["label"], (i, got, want)


def _assert_matches_jax(preds, jax_preds):
    assert len(preds) == len(jax_preds)
    for p, j in zip(preds, jax_preds):
        np.testing.assert_allclose(p["track_scores"], j["track_scores"],
                                   rtol=0, atol=1e-5)
        top = np.sort(j["track_scores"])[::-1]
        if len(top) == 1 or top[0] - top[1] > 1e-4:
            assert p["best_track"] == j["best_track"]
        if p["best_track"] == j["best_track"]:
            _same_ranking(p["interactions"], j["interactions"])
            if "relationships" in j:
                _same_ranking(p["relationships"], j["relationships"])


def test_healthz(server):
    base, _, _ = server
    with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
        payload = json.loads(resp.read())
    assert payload == {"status": "ok", "n_classes": 9, "n_rels": 6,
                       "max_batch": 8}


@pytest.mark.parametrize("B", [1, 3, 8])
def test_predict_matches_jax_engine(server, B):
    base, _, jax_engine = server
    batch = make_batch(jax_engine.bundle.spec, B, N_CLIPS, N_TRACKS,
                       seed=10 + B)
    status, payload = _post(base + "/predict", {"samples": _samples(batch)})
    assert status == 200
    preds = payload["predictions"]
    for p in preds:
        assert len(p["interactions"]) == 3 and len(p["relationships"]) == 3
        assert 0 <= p["best_track"] < 20
        assert all(0 <= x["score"] <= 1 for x in p["interactions"])
    _assert_matches_jax(preds, jax_engine.predict(batch["feat_idx"],
                                                  batch["rels_mask"]))


def test_predict_bad_requests(server):
    base, _, _ = server
    status, payload = _post(base + "/predict", {"nope": 1})
    assert status == 400 and "error" in payload
    status, payload = _post(base + "/predict", {"samples": [{"feat_idx": [1]}]})
    assert status == 400
    status, payload = _post(base + "/missing", {})
    assert status == 404
    status, payload = _post(base + "/predict", {"samples": _samples(
        make_batch(server[2].bundle.spec, 9, N_CLIPS, N_TRACKS))})
    assert status == 400 and payload["error"] == "batch too large: 9 > 8"


def test_rejects_bad_geometry_and_indices(server):
    """Out-of-range indices answer 400 with the JAX server's message: the
    CUDA pool kernel does not check them."""
    base, _, jax_engine = server
    batch = make_batch(jax_engine.bundle.spec, 1, N_CLIPS, N_TRACKS, seed=5)
    good = _samples(batch)[0]
    bad = json.loads(json.dumps(good))
    bad["feat_idx"][0][0][0] = 10**9
    status, payload = _post(base + "/predict", {"samples": [bad]})
    assert status == 400
    assert payload["error"] == "clip index out of range [0, %d)" % N_CLIPS
    bad = json.loads(json.dumps(good))
    bad["feat_idx"][3][7][2] = -1
    status, payload = _post(base + "/predict", {"samples": [bad]})
    assert status == 400
    assert payload["error"] == "track index out of range [0, %d)" % N_TRACKS
    bad = json.loads(json.dumps(good))
    bad["feat_idx"] = [row[:5] for row in bad["feat_idx"]]
    status, payload = _post(base + "/predict", {"samples": [bad]})
    assert status == 400 and payload["error"].startswith("feat_idx must be")


def test_oversized_body_rejected_before_read(server):
    base, _, _ = server
    req = urllib.request.Request(
        base + "/predict", data=b"x" * 1024,
        headers={"Content-Type": "application/json",
                 "Content-Length": str(9 << 20)},  # > max_batch(8) << 20
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            status, payload = resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        status, payload = err.code, json.loads(err.read())
    assert status == 413 and "exceeds" in payload["error"]


def test_negative_content_length_rejected(server):
    host = server[0].split("//")[1]
    conn = http.client.HTTPConnection(host, timeout=10)
    conn.putrequest("POST", "/predict", skip_accept_encoding=True)
    conn.putheader("Content-Type", "application/json")
    conn.putheader("Content-Length", "-1")
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 413
    conn.close()


def test_non_maxtracks_preset_matches_jax_engine():
    """int_rels (no hypothesis axis, unguarded pool) serves too."""
    engine, jax_engine = _engines("int_rels", topk=2)
    batch = make_batch(engine.bundle.spec, 2, N_CLIPS, N_TRACKS, seed=4)
    feat_idx = np.asarray(batch["feat_idx"][:, 0])  # [B, 1+R, 3]
    rels_mask = np.asarray(batch["rels_mask"][:, 0])  # [B, R]
    out = engine.predict(feat_idx, rels_mask)
    assert len(out) == 2 and out[0]["best_track"] == 0
    _assert_matches_jax(out, jax_engine.predict(feat_idx, rels_mask))


def test_warm_runs_each_batch_size(server):
    _, engine, _ = server
    engine.warm([1, 3, 100])  # clamped to max_batch
    out = engine.predict(np.zeros((2, 20, 19, 3), np.int32),
                         np.zeros((2, 20, 18), np.int64))
    assert len(out) == 2


def test_build_engine_from_args(synth_root):
    """The CLI's own builder on the synthetic MovieGraphs fixture."""
    args = make_parser().parse_args([
        "--data-root", synth_root, "--text-dim", "16", "--visual-dim", "32",
        "--text-layers", "4", "--joint-dim", "16", "--device", "cpu",
        "--topk", "2",
    ])
    engine = build_engine_from_args(args)
    assert engine.device.type == "cpu"
    spec = engine.bundle.spec
    assert (spec.text_dim, spec.visual_dim, spec.joint_dim) == (16, 32, 16)
    batch = make_batch(spec, 2, engine.n_clip_rows, engine.n_track_rows)
    out = engine.predict(batch["feat_idx"], batch["rels_mask"])
    assert len(out) == 2 and len(out[0]["interactions"]) == 2
