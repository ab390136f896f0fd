"""The port's offline tools against the JAX package's, on the synthetic
fixture: ``extract-text`` (lirec_tpu_torch/cli/extract_text.py) writes the
same files byte for byte, ``verify-features`` (copy / check) and
``graphs-demo`` print and return what the JAX CLIs do. The cases of
tests/test_offline_tools.py, each run through both packages.
"""

import os
import os.path as ops

import numpy as np
import pytest

from lirec_tpu.cli import extract_text as jax_extract
from lirec_tpu.cli import graphs_demo as jax_graphs_demo
from lirec_tpu.cli import verify_features as jax_verify
from lirec_tpu_torch.cli import extract_text, graphs_demo, verify_features


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = ops.join(d, f)
            with open(path, "rb") as fh:
                out[ops.relpath(path, root)] = fh.read()
    return out


def _extract_args(root, out_dir, extra=()):
    return ["--data-root", root, "--out-dir", out_dir, "--backend", "fake",
            "--text-dim", "8", "--text-layers", "2", "--quiet"] + list(extra)


def test_extract_text_fake_backend_writes_the_jax_tree(synth_root, tmp_path):
    """--backend fake: the port's tree is the JAX CLI's, byte for byte
    (the same .npy and .token2idx files); a second run extracts nothing
    (resumable); the token2idx line count is the embedding row count."""
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    n_want = jax_extract.main(_extract_args(synth_root, want_dir))
    n_got = extract_text.main(_extract_args(synth_root, got_dir,
                                            ["--device", "cpu"]))
    assert n_got == n_want > 0
    want, got = _tree(want_dir), _tree(got_dir)
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name
    assert extract_text.main(_extract_args(synth_root, got_dir)) == 0
    movie_dir = ops.join(got_dir, "tt0108160")
    npys = sorted(f for f in os.listdir(movie_dir) if f.endswith(".npy"))
    emb = np.load(ops.join(movie_dir, npys[0]))
    assert emb.shape[1] == 16  # layers * dim
    with open(ops.join(movie_dir, npys[0][:-4] + ".token2idx")) as f:
        n_tokens = sum(1 for line in f if line.strip())
    assert n_tokens == emb.shape[0]


def test_extract_sliding_window_no_duplicate_sep(tmp_path):
    """Multi-speaker blocks: each window appends only its second segment,
    in both packages' extract (the same token2idx file)."""
    d = tmp_path / "dialogs" / "tt0000001"
    d.mkdir(parents=True)
    (d / "scene-001.ss-0000.es-0010.webvtt").write_text(
        "WEBVTT\n\n00:00:01.000 --> 00:00:04.000\n"
        "- First speaker line.\n- Second speaker here.\n- Third one too.\n\n"
    )
    texts = []
    for mod in (jax_extract, extract_text):
        out = tmp_path / mod.__name__.split(".")[0]
        mod.extract(str(tmp_path / "dialogs"), str(out),
                    mod.FakeEncoder(2, 4), verbose=False)
        texts.append((out / "tt0000001" / "tt0000001_001.token2idx")
                     .read_text())
    assert texts[0] == texts[1]
    tokens = [line.split()[0] for line in texts[1].splitlines()]
    assert tokens.count("[CLS]") == 1
    for a, b in zip(tokens, tokens[1:]):
        assert not (a == "[SEP]" and b == "[SEP]"), tokens
    assert tokens.count("[SEP]") == 3


def _tiny_bert(path):
    """A randomly initialised two-layer BERT of width 8 and a vocabulary
    of the fixture's words, saved as a local model directory."""
    import torch
    from transformers import BertConfig, BertModel

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "-", ".", ",",
             "i", "you", "the", "a", "is", "it", "what", "no", "yes"]
    os.makedirs(path)
    with open(ops.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    torch.manual_seed(0)
    BertModel(BertConfig(vocab_size=len(vocab), hidden_size=8,
                         num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=16)).save_pretrained(path)


def test_extract_text_transformers_backend_on_the_cpu(synth_root, tmp_path):
    """--backend transformers --device cpu over a local two-layer BERT
    (no weights are downloaded): the JAX CLI's tree, byte for byte. Skips
    where the transformers package is not installed."""
    pytest.importorskip("transformers")
    model = str(tmp_path / "bert")
    _tiny_bert(model)
    args = ["--data-root", synth_root, "--backend", "transformers",
            "--model-path", model, "--text-dim", "8", "--text-layers", "2",
            "--quiet"]
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    n = jax_extract.main(args + ["--out-dir", want_dir])
    assert extract_text.main(args + ["--out-dir", got_dir, "--device",
                                     "cpu"]) == n > 0
    want, got = _tree(want_dir), _tree(got_dir)
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name


def test_verify_features_copy_and_check(synth_root, tmp_path, capsys):
    """copy and check through both packages: the same counts, the same
    mismatches and the same lines on stderr."""
    src = ops.join(synth_root, "features", "bert", "bert_base")
    outs = []
    for name, mod in (("jax", jax_verify), ("port", verify_features)):
        dst = str(tmp_path / name)
        n = mod.main(["copy", "--src", src, "--dst", dst])
        again = mod.copy_features(src, dst, verbose=False)  # idempotent
        clean = mod.main(["check", "--text-root", dst])
        # a scene of the first movie (other tests may add directories
        # beside the movies of the session's fixture)
        movie = sorted(d for d in os.listdir(dst) if d.startswith("tt"))[0]
        files = sorted(f for f in os.listdir(ops.join(dst, movie))
                       if f.endswith(".npy"))
        path = ops.join(dst, movie, files[0])
        np.save(path, np.load(path)[:-1])
        bad = mod.main(["check", "--text-root", dst])
        err = capsys.readouterr().err.replace(str(tmp_path / name), "DST")
        outs.append((n, again, clean, bad, err))
    assert outs[1] == outs[0]
    n, again, clean, bad, _ = outs[1]
    assert n > 0 and again == 0 and clean == [] and len(bad) == 1


@pytest.mark.parametrize("extra,code", [([], 0), (["--movie", "nope"], 1),
                                        (["--clip", "9999"], 1)])
def test_graphs_demo_prints_what_the_jax_cli_prints(synth_cfg, capsys,
                                                    extra, code):
    """The py3loader startup.py equivalent (census, cast, one clip's
    pprint): the same stdout, stderr and return code as the JAX CLI."""
    outs = []
    for main in (jax_graphs_demo.main, graphs_demo.main):
        ret = main([synth_cfg.paths.annotations] + extra)
        captured = capsys.readouterr()
        outs.append((ret, captured.out, captured.err))
    assert outs[1] == outs[0]
    assert outs[1][0] == code
    if code == 0:
        assert "movies with graphs" in outs[1][1]
        assert "Selected movie:" in outs[1][1]
        assert "Graph information:" in outs[1][1]
