"""Convert released PyTorch checkpoints to the JAX package's msgpack format
(counterpart of lirec_tpu/cli/convert_checkpoint.py: the same flags, plus
``--device``, and the same file).

    python -m lirec_tpu_torch.cli.convert_checkpoint --src mod_all.pth.tar \\
        --dst mod_all.ckpt [--verify --preset int_rel_ch]

The ``.pth.tar`` (ref `utils/util_functions.py:274-281` checkpoint format)
is read with ``torch.load``, its weights laid out as the JAX package's
params tree (``checkpoint.convert.params_to_jax``, in the state dict's
order) and written as ``{"params", "extra": {"epoch"}}`` by
``checkpoint/msgpack.to_bytes``: byte for byte the file of the JAX
package's ``save_params`` (lirec_tpu/checkpoint/saver.py), which its
``load_params`` reads and this package's eval CLIs read as well.

``--verify`` additionally loads the SAME .pth.tar into the live torch
reference (--reference, default: $LIREC_TPU_REFERENCE; without either
``--verify`` is refused), runs this package's model (on
``--device``) and the reference's on a seeded fixture batch, and compares
the outputs. Dims and head sizes are inferred from the checkpoint tensors;
only the model family needs ``--preset``.
"""

from __future__ import annotations

import argparse
import sys


def _infer_cfg(preset: str, state_dict):
    """ExperimentConfig + (n_classes, n_rels) from checkpoint shapes (the
    weights are [out, in])."""
    from lirec_tpu_torch import config as config_lib

    text_dim = state_dict["txt_ints.weight"].shape[1]
    visual_dim = state_dict["vis_ints.weight"].shape[1]
    joint_dim = state_dict["txt_ints.weight"].shape[0]
    n_classes = state_dict["out_ints.weight"].shape[0]
    n_rels = (
        state_dict["out_ctx.weight"].shape[0]
        if "out_ctx.weight" in state_dict else 0
    )
    cfg = config_lib.preset(preset, data_root="/nonexistent")
    cfg = cfg.with_dims(
        text_dim=text_dim, visual_dim=visual_dim, joint_dim=joint_dim
    ).with_runtime(compute_dtype="float32")
    return cfg, n_classes, n_rels


def _layers(state_dict):
    return sorted({key.rsplit(".", 1)[0] for key in state_dict})


def verify_checkpoint(src: str, preset: str, reference: str,
                      batch: int = 3, seed: int = 0,
                      atol: float = 2e-5, rtol: float = 1e-4,
                      device: str = "cuda") -> dict:
    """Forward-activation comparison: the checkpoint's weights through
    this package's model (on `device`) vs the same .pth.tar through the
    live torch reference, on one seeded fixture batch. Returns per-output
    max-abs-diff; raises on mismatch."""
    from lirec_tpu_torch.compat import reference as bridge

    default, bridge.REFERENCE = bridge.REFERENCE, reference
    try:
        if not bridge.reference_available():
            raise SystemExit(
                "--verify needs the reference repo at %r (set --reference "
                "or LIREC_TPU_REFERENCE)" % reference
            )
        return _verify(bridge, src, preset, batch, seed, atol, rtol, device)
    finally:
        bridge.REFERENCE = default


def _verify(bridge, src, preset, batch, seed, atol, rtol, device):
    import numpy as np
    import torch

    from lirec_tpu_torch.checkpoint import load_torch_checkpoint
    from lirec_tpu_torch.models.factory import create_model

    state_dict, _meta = load_torch_checkpoint(src)
    cfg, n_classes, n_rels = _infer_cfg(preset, state_dict)
    t, d = cfg.tasks, cfg.dims
    bundle = create_model(cfg, n_classes, n_rels=n_rels, device=device)
    if set(state_dict) != set(bundle.model.state_dict()):
        raise SystemExit(
            "checkpoint layer structure does not match preset %r "
            "(checkpoint: %s / model: %s)"
            % (preset, _layers(state_dict),
               _layers(bundle.model.state_dict()))
        )
    bundle.model.load_state_dict(state_dict)

    rng = np.random.default_rng(seed)
    B, T, R = batch, t.n_hypotheses, t.rels_n_clips
    if t.mod_check or (not t.tr_maximize and not t.rels_multi_clip):
        feats = rng.standard_normal((B, 1, d.mlp_dim)).astype(np.float32)
        inp = {"features": feats}
        tinp = {"features": torch.tensor(feats)}
    elif t.tr_maximize and t.rels_multitask:
        feats = rng.standard_normal((B, T, R + 1, d.mlp_dim)).astype(
            np.float32
        )
        mask = (rng.random((B, T, R)) < 0.5).astype(np.float32)
        inp = {"features": feats, "rels_mask": mask}
        tinp = {
            "features": torch.tensor(feats, dtype=torch.float64),
            "rels_mask": torch.tensor(mask),
        }
    elif t.tr_maximize:
        feats = rng.standard_normal((B, T, d.mlp_dim)).astype(np.float32)
        inp = {"features": feats}
        tinp = {"features": torch.tensor(feats, dtype=torch.float64)}
    else:  # int_rels: [B, R+1, mlp_dim] multi-clip context
        feats = rng.standard_normal((B, R + 1, d.mlp_dim)).astype(np.float32)
        mask = (rng.random((B, R, 1)) < 0.5).astype(np.float32)
        mask[:, 0] = 1  # the dataset guarantees >=1 context clip
        inp = {"features": feats, "rels_mask": mask}
        tinp = {
            "features": torch.tensor(feats, dtype=torch.float64),
            "rels_mask": torch.tensor(mask),
        }

    with torch.no_grad():
        out = bundle.apply(bundle.model, inp)
    # the reference loads the ORIGINAL state_dict (its own load path, ref
    # utils/util_functions.py:274-281) — NOT this package's converted
    # weights transplanted back, which would cancel any conversion bug
    bridge.configure_opt(cfg)
    ref = bridge.import_reference()
    if t.mod_check:
        ref_model = ref.model.Modalities(n_classes=n_classes)
    elif t.tr_maximize:
        kw = {"n_rels": n_rels} if n_rels else {}
        ref_model = ref.model.MidFusionMultiClipMaxTracks(
            n_classes=n_classes, **kw
        )
    else:
        ref_model = ref.model.MidFusionMultiClip(
            n_classes=n_classes, n_rels=n_rels
        )
    raw = torch.load(src, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw) if hasattr(raw, "get") else raw
    sd = {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in sd.items()
    }
    ref_model.load_state_dict(sd)
    ref_model.eval()
    with torch.no_grad():
        ref_out = ref_model(tinp)

    diffs = {}
    for key, mine in out.items():
        theirs = ref_out.get(key) if hasattr(ref_out, "get") else None
        if theirs is None or mine is None:
            continue  # e.g. the reference returns rels=None without ctx
        theirs = theirs.numpy()
        mine = mine.float().cpu().numpy()
        diffs[key] = float(np.max(np.abs(mine - theirs)))
        np.testing.assert_allclose(
            mine, theirs, atol=atol, rtol=rtol,
            err_msg="output %r diverges between the converted params and "
                    "the torch reference" % key,
        )
    if not diffs:
        raise SystemExit("verify compared no outputs — preset mismatch?")
    return diffs


def convert(src: str, dst: str):
    """Write `src`'s weights as the JAX package's ``save_params`` file at
    `dst`; returns (state_dict, metadata incl. epoch)."""
    from lirec_tpu_torch.checkpoint import load_torch_checkpoint
    from lirec_tpu_torch.checkpoint.saver import save_params

    state_dict, meta = load_torch_checkpoint(src)
    save_params(dst, state_dict, extra={"epoch": meta.get("epoch")})
    return state_dict, meta


def main(argv=None):
    from lirec_tpu_torch.compat.reference import REFERENCE

    p = argparse.ArgumentParser(prog="lirec-tpu-torch convert_checkpoint")
    p.add_argument("--src", required=True, help=".pth.tar source")
    p.add_argument("--dst", required=True, help=".ckpt msgpack destination")
    p.add_argument("--verify", action="store_true",
                   help="compare forward activations vs the live torch "
                        "reference after converting")
    p.add_argument("--preset", default="int_rel_ch",
                   choices=["modalities", "int_rels", "int_ch",
                            "int_rel_ch"],
                   help="model family for --verify (dims and head sizes "
                        "are inferred from the checkpoint)")
    p.add_argument("--reference", default=REFERENCE,
                   help="reference repo path for --verify")
    p.add_argument("--device", default="cuda",
                   help="torch device of this package's model under "
                        "--verify")
    args = p.parse_args(argv)

    state_dict, meta = convert(args.src, args.dst)
    layers = _layers(state_dict)
    print(
        "converted %s -> %s (%d layers, %d arrays, epoch=%s)"
        % (args.src, args.dst, len(layers), len(state_dict),
           meta.get("epoch")),
        file=sys.stderr,
    )
    result = {"layers": len(layers), "epoch": meta.get("epoch")}
    if args.verify:
        diffs = verify_checkpoint(args.src, args.preset, args.reference,
                                  device=args.device)
        print(
            "verify ok vs torch reference (%s): max |diff| %s"
            % (args.preset,
               ", ".join("%s=%.2e" % kv for kv in sorted(diffs.items()))),
            file=sys.stderr,
        )
        result["verify"] = diffs
    return result


if __name__ == "__main__":
    main()


def script() -> int:
    """Console-script wrapper: main() returns data for programmatic use;
    setuptools wrappers sys.exit() the return value, so exit 0 here."""
    main()
    return 0
