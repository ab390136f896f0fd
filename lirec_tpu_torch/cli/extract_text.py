"""Offline dialog (BERT) feature extraction
(ref `text_utils/feature_extraction.py`; counterpart of
lirec_tpu/cli/extract_text.py, its flags and its files, plus ``--device``).

Walks the dialogs tree, cleans/segments each WebVTT file (2-sentence sliding
windows for multi-speaker blocks), runs a BERT encoder, and writes per-scene
``<movie>_<sss>.npy`` ([n_tokens, layers*dim]) + ``.token2idx`` files in the
reference's exact format. Extraction is resumable and multi-machine-safe via
existence checks and a shuffled work order (ref :55-57,162-169).

Backends:
- ``--backend transformers``: local HuggingFace BERT (``--model-path``: a
  local directory, nothing is downloaded), run on ``--device`` (default:
  the card);
- ``--backend fake``: deterministic hash-based embeddings for plumbing tests
  and synthetic-data regeneration.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import os.path as ops
import re
import sys

import numpy as np

from lirec_tpu_torch.data.text import clean_dialog_block, split_dialog_blocks


def iter_dialog_files(dialogs_dir: str, ext: str):
    for root, _dirs, files in os.walk(dialogs_dir):
        for filename in sorted(files):
            if filename.endswith(ext):
                yield root, filename


def scene_key(root: str, filename: str):
    movie = re.search(r"(tt\d+)", root).group(1)
    scene = re.search(r"scene-(\d+)\.", filename).group(1)
    return movie, "%s_%03d" % (movie, int(scene))


class FakeEncoder:
    """Deterministic per-token embeddings (seeded by token text)."""

    def __init__(self, layers: int, dim: int):
        self.layers = layers
        self.dim = dim

    def encode(self, sentence: str):
        tokens = sentence.split()
        out = np.zeros((len(tokens), self.layers * self.dim), np.float32)
        for i, tok in enumerate(tokens):
            seed = int.from_bytes(
                hashlib.sha1(tok.lower().encode()).digest()[:4], "little"
            )
            out[i] = np.random.default_rng(seed).standard_normal(
                self.layers * self.dim
            )
        return tokens, out


class TransformersEncoder:
    """BERT's last `layers` hidden states per token, the model and the
    token ids on `device`; the states come back as numpy."""

    def __init__(self, model_path: str, layers: int, dim: int,
                 device: str = "cuda"):
        import torch
        from transformers import BertModel, BertTokenizer

        self.torch = torch
        self.device = torch.device(device)
        self.tokenizer = BertTokenizer.from_pretrained(model_path)
        self.model = BertModel.from_pretrained(
            model_path, output_hidden_states=True
        ).eval().to(self.device)
        self.layers = layers
        self.dim = dim

    def encode(self, sentence: str):
        torch = self.torch
        tokens = self.tokenizer.tokenize(sentence)
        ids = self.tokenizer.convert_tokens_to_ids(tokens)
        with torch.no_grad():
            out = self.model(torch.tensor([ids], device=self.device))
        # hidden_states: embeddings + one per layer; keep the last `layers`
        # and concatenate per token ([n_tok, layers*dim], ref :193-203)
        states = out.hidden_states[-self.layers:]
        stacked = torch.cat([s[0] for s in states], dim=-1).cpu().numpy()
        return tokens, stacked.astype(np.float32)


def extract(
    dialogs_dir: str,
    out_dir: str,
    encoder,
    ext: str = "webvtt",
    shuffle_seed: int = 0,
    verbose: bool = True,
) -> int:
    work = list(iter_dialog_files(dialogs_dir, ext))
    rng = np.random.default_rng(shuffle_seed)
    rng.shuffle(work)  # naive multi-machine sharding (ref :162-164)
    n_done = 0
    for root, filename in work:
        movie, key = scene_key(root, filename)
        os.makedirs(ops.join(out_dir, movie), exist_ok=True)
        npy_path = ops.join(out_dir, movie, key + ".npy")
        t2i_path = ops.join(out_dir, movie, key + ".token2idx")
        if ops.exists(npy_path) and ops.exists(t2i_path):
            continue  # resumable (ref :56-57,167-169)
        with open(ops.join(root, filename), "rb") as f:
            text = f.read().decode("unicode_escape")
        embeddings = None
        token_lines = []
        total = 0
        for block in split_dialog_blocks(text):
            cleaned = clean_dialog_block(block)
            if not cleaned:
                continue
            for sent_idx, sentence in enumerate(cleaned):
                tokens, emb = encoder.encode(sentence)
                if sent_idx == 0:
                    keep = len(tokens)
                else:
                    # sliding 2-sentence windows: only the second segment —
                    # tokens AFTER the window's first [SEP] — is new
                    # (ref feature_extraction.py:177-191)
                    first_sep = (
                        tokens.index("[SEP]") if "[SEP]" in tokens
                        else len(tokens) - 1
                    )
                    keep = len(tokens) - (first_sep + 1)
                if keep <= 0:
                    continue
                embeddings = (
                    emb[-keep:]
                    if embeddings is None
                    else np.vstack([embeddings, emb[-keep:]])
                )
                for tok in tokens[-keep:]:
                    token_lines.append("%s %d" % (tok, total))
                    total += 1
        if embeddings is None:
            embeddings = np.zeros((0, encoder.layers * encoder.dim), np.float32)
        # Both files publish atomically, t2i before the npy: the resume
        # check requires BOTH, so a crash or a concurrent writer (the
        # reference's existence-check multi-machine sharding, ref :162-169)
        # can never surface a torn pair or a truncated t2i.
        import uuid

        from lirec_tpu_torch.utils.io import atomic_np_save

        t2i_tmp = "%s.tmp.%d.%s" % (t2i_path, os.getpid(), uuid.uuid4().hex[:8])
        with open(t2i_tmp, "w") as f:
            f.write("\n".join(token_lines) + ("\n" if token_lines else ""))
        os.replace(t2i_tmp, t2i_path)
        atomic_np_save(npy_path, embeddings)
        n_done += 1
        if verbose:
            print("%d/%d %s" % (n_done, len(work), key), file=sys.stderr)
    return n_done


def main(argv=None):
    p = argparse.ArgumentParser(prog="lirec-tpu-torch extract_text")
    p.add_argument("--data-root", required=True)
    p.add_argument("--out-dir", default="",
                   help="default <data-root>/features/bert/bert_base")
    p.add_argument("--backend", default="transformers",
                   choices=["transformers", "fake"])
    p.add_argument("--model-path", default="bert-base-uncased")
    p.add_argument("--text-dim", type=int, default=768)
    p.add_argument("--text-layers", type=int, default=12)
    p.add_argument("--ext", default="webvtt")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the transformers backend's model")
    args = p.parse_args(argv)
    out_dir = args.out_dir or ops.join(
        args.data_root, "features", "bert", "bert_base"
    )
    if args.backend == "fake":
        encoder = FakeEncoder(args.text_layers, args.text_dim)
    else:
        encoder = TransformersEncoder(
            args.model_path, args.text_layers, args.text_dim, args.device
        )
    n = extract(
        ops.join(args.data_root, "dialogs"), out_dir, encoder,
        ext=args.ext, verbose=not args.quiet,
    )
    if not args.quiet:
        print("extracted %d scenes" % n, file=sys.stderr)
    return n


if __name__ == "__main__":
    main()


def script() -> int:
    """Console-script wrapper: main() returns data for programmatic use;
    setuptools wrappers sys.exit() the return value, so exit 0 here."""
    main()
    return 0
