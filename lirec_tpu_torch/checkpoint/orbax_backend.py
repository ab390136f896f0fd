"""The JAX package's Orbax checkpoints (counterpart of
lirec_tpu/checkpoint/orbax_backend.py: ``save`` and ``restore``), read and
written without jax, orbax, tensorstore or a zstd package.

A checkpoint is a directory, as ``orbax.checkpoint.PyTreeCheckpointer``
leaves it:

* ``_METADATA``: the tree (``tree_metadata``: per leaf, the tuple of its
  path keys, each with its ``key_type``, 2 for a dict key or a
  namedtuple field and 1 for a sequence index, and its ``value_type``:
  ``"jax.Array"``, ``"scalar"`` (the epoch) or ``"None"``, optax's empty
  states, which are not deserialised), with ``use_ocdbt`` and not
  ``use_zarr3``;
* ``_sharding``, ``array_metadatas/process_0`` and
  ``_CHECKPOINT_METADATA``, which Orbax's own restore reads;
* an OCDBT store (checkpoint/ocdbt.py) of zarr v2 arrays, one per leaf,
  under the leaf's dotted path: ``<name>/.zarray`` and the chunks
  ``<name>/0.0``..., each chunk a zstd frame (native/zstd.cpp).

The trees are the flax state-dict form checkpoint/convert.py works on:
nested dicts of numpy arrays (``params_to_jax``, ``opt_state_to_jax``),
sequences as dicts keyed "0", "1", ... and an empty optax state as {}.
numpy has no bfloat16, so a bf16 leaf is read as its uint16 words and
becomes a ``torch.bfloat16`` tensor; a ``torch.bfloat16`` leaf is written
as Orbax writes a bf16 array.

``save`` writes into a temporary directory beside the target and renames
it into place, replacing a checkpoint already there (Orbax's
``force=True``). Its chunks are zstd frames of raw blocks: native/zstd.cpp
has no compressor, so the files are about 8% larger than Orbax's level-1
ones on normal f32 weights. Orbax, tensorstore and any zstd decoder read
them.
"""

from __future__ import annotations

import base64
import json
import os
import os.path as ops
import shutil
import time
from typing import Dict, Tuple

import numpy as np
import torch

from lirec_tpu_torch.checkpoint import ocdbt
from lirec_tpu_torch.native import bindings

__all__ = ["save", "restore", "tree_metadata"]

METADATA = "_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
           "PyTreeCheckpointHandler")
DICT_KEY, SEQUENCE_KEY = 2, 1
# the sharding Orbax records for a single-process host array
SHARDING = json.dumps({"sharding_type": "SingleDeviceSharding",
                       "device_str": "TFRT_CPU_0"})


# --------------------------------------------------------------- writing

def _is_sequence(tree: dict) -> bool:
    """A dict in the state-dict form of a tuple: keys "0".."n-1"."""
    return bool(tree) and set(tree) == {str(i) for i in range(len(tree))}


def _leaves(tree, path=()):
    """(path of (key, key_type), leaf) in Orbax's order; an empty dict is
    a leaf (an empty optax state)."""
    if isinstance(tree, dict) and tree:
        seq = _is_sequence(tree)
        keys = sorted(tree, key=int) if seq else sorted(tree)
        for k in keys:
            yield from _leaves(tree[k], path + (
                (k, SEQUENCE_KEY if seq else DICT_KEY),))
    else:
        yield path, tree


def _array(leaf) -> Tuple[np.ndarray, str]:
    """(C-ordered host array, zarr dtype string) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().to("cpu")
        if leaf.dtype == torch.bfloat16:
            words = leaf.contiguous().view(torch.int16).numpy().view(np.uint16)
            return words, "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)  # (ascontiguousarray would make a 0-d array 1-d)
    return np.array(arr, order="C", copy=not arr.flags.c_contiguous), \
        arr.dtype.str


def _zarray(shape, dtype: str) -> bytes:
    return json.dumps({
        "chunks": list(shape), "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".", "dtype": dtype, "fill_value": None,
        "filters": None, "order": "C", "shape": list(shape),
        "zarr_format": 2}, separators=(",", ":")).encode()


def tree_metadata(tree: Dict) -> Dict:
    """The ``tree_metadata`` of ``_METADATA`` for `tree`, as Orbax's
    writer gives it."""
    out = {}
    for path, leaf in _leaves(tree):
        keys = tuple(k for k, _ in path)
        if isinstance(leaf, dict) or leaf is None:
            value = {"value_type": "None", "skip_deserialize": True}
        elif isinstance(leaf, (int, float)):
            value = {"value_type": "scalar", "skip_deserialize": False}
        else:
            value = {"value_type": "jax.Array", "skip_deserialize": False,
                     "write_shape": list(np.shape(leaf))}
        out[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in path],
            "value_metadata": value}
    return out


def save(path: str, params: Dict, opt_state=None, epoch: int = 0) -> None:
    """Write {'params', 'epoch'[, 'opt_state']} as an Orbax checkpoint
    directory at `path`, replacing one already there."""
    payload = {"params": params, "epoch": int(epoch)}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    path = ops.abspath(path)
    start = time.time_ns()
    items, arrays = {}, []
    for keys, leaf in _leaves(payload):
        if isinstance(leaf, dict) or leaf is None:
            continue
        name = ".".join(k for k, _ in keys)
        scalar = isinstance(leaf, (int, float))
        arr, dtype = _array(np.int64(leaf) if isinstance(leaf, int) else
                            np.float64(leaf) if scalar else leaf)
        chunk = "0" if arr.ndim == 0 else ".".join("0" * arr.ndim)
        items[(name + "/.zarray").encode()] = _zarray(arr.shape, dtype)
        items[("%s/%s" % (name, chunk)).encode()] = bindings.zstd_frame(arr)
        if not scalar:
            arrays.append((name, list(arr.shape)))
    tmp = "%s.orbax-tmp-%d" % (path, os.getpid())
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(ops.join(tmp, "array_metadatas"))
    ocdbt.write_store(tmp, items)

    def dump(name: str, obj, **kw) -> None:
        with open(ops.join(tmp, name), "w") as f:
            json.dump(obj, f, **kw)

    dump(METADATA, {"tree_metadata": tree_metadata(payload),
                    "use_ocdbt": True, "use_zarr3": False,
                    "store_array_data_equal_to_fill_value": True,
                    "custom_metadata": None})
    dump("_sharding", {
        base64.b64encode(name.encode()).decode(): SHARDING
        for name, _ in arrays}, separators=(",", ":"))
    dump(ops.join("array_metadatas", "process_0"), {"array_metadatas": [
        {"array_metadata": {"param_name": name, "write_shape": shape,
                            "chunk_shape": shape, "ext_metadata": None}}
        for name, shape in arrays]})
    dump("_CHECKPOINT_METADATA", {
        "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": start, "commit_timestamp_nsecs":
        time.time_ns(), "custom_metadata": {}})
    if ops.lexists(path):
        old = "%s.orbax-old-%d" % (path, os.getpid())
        os.replace(path, old)
        os.replace(tmp, path)
        if ops.isdir(old):
            shutil.rmtree(old)
        else:
            os.remove(old)
    else:
        os.replace(tmp, path)


# --------------------------------------------------------------- reading

def _fill(meta: dict, dtype: np.dtype):
    value = meta.get("fill_value")
    if value is None:
        return 0
    if meta["dtype"] == "bfloat16":
        return int(torch.tensor(float(value), dtype=torch.bfloat16)
                   .view(torch.int16)) & 0xFFFF
    return dtype.type(float(value) if isinstance(value, str) else value)


def _read_array(store: ocdbt.Reader, name: str, path: str):
    """The zarr v2 array `name` of `store`: a numpy array, or a
    torch.bfloat16 tensor for a bf16 one."""
    key = (name + "/.zarray").encode()
    if key not in store:
        raise ValueError("%s: no array %r in the checkpoint's store"
                         % (path, name))
    meta = json.loads(store.read(key))
    if meta.get("zarr_format") != 2:
        raise ValueError("%s: %s is zarr format %r; zarr v2 is read"
                         % (path, name, meta.get("zarr_format")))
    if meta.get("filters"):
        raise ValueError("%s: %s has zarr filters %r; none are read"
                         % (path, name, meta["filters"]))
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError("%s: %s is compressed with %r; zstd is read"
                         % (path, name, compressor.get("id")))
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype(np.uint16 if bf16 else meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta, dtype), dtype)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        ckey = ("%s/%s" % (name, sep.join(map(str, index)) if index
                           else "0")).encode()
        if ckey not in store:
            continue  # a chunk never written holds the fill value
        raw = store.read(ckey)
        if compressor is not None:
            try:
                raw = bindings.zstd_decompress(raw, chunk_bytes)
            except ValueError as err:
                raise ValueError("%s: chunk %s: %s" % (path, ckey.decode(),
                                                      err)) from None
        raw = np.frombuffer(raw, np.uint8)
        if raw.size != chunk_bytes:
            raise ValueError("%s: chunk %s holds %d bytes, not %d"
                             % (path, ckey.decode(), raw.size, chunk_bytes))
        chunk = raw.view(dtype).reshape(chunks, order=order)
        at = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(index, chunks, shape))
        out[at] = chunk[tuple(slice(0, a.stop - a.start) for a in at)]
    if not dtype.isnative:
        out = out.astype(dtype.newbyteorder("="))
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def restore(path: str, opt_state: bool = True) -> Tuple[Dict, object, int]:
    """(params, opt_state, epoch) of the Orbax checkpoint at `path`, the
    trees in the state-dict form; ``opt_state=False`` reads the params and
    the epoch only (Orbax's ``partial_restore``), and opt_state is then
    None, as it is where the checkpoint has none. The tree comes from
    ``_METADATA``: no template is needed."""
    path = ops.abspath(path)
    if not ops.exists(ops.join(path, METADATA)):
        raise ValueError("%s: no %s; not an Orbax checkpoint directory"
                         % (path, METADATA))
    with open(ops.join(path, METADATA)) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError("%s: an Orbax checkpoint without OCDBT or in zarr "
                         "v3; the OCDBT store of zarr v2 arrays is read"
                         % path)
    store = ocdbt.Reader(path)
    tree: Dict = {}
    for spec in meta["tree_metadata"].values():
        keys = [k["key"] for k in spec["key_metadata"]]
        if keys[0] == "opt_state" and not opt_state:
            continue
        value = spec["value_metadata"]
        if value.get("skip_deserialize") or value["value_type"] == "None":
            leaf = {}
        else:
            leaf = _read_array(store, ".".join(keys), path)
            if value["value_type"] == "scalar":
                leaf = leaf.item()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree.get("params"), tree.get("opt_state"), int(
        tree.get("epoch", 0))

