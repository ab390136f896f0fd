"""OCDBT key-value stores, the format in which Orbax keeps a checkpoint's
arrays (tensorstore's ``ocdbt`` format), read and written without
tensorstore.

A store is a directory. ``manifest.ocdbt`` holds the store's config and
its versions; the newest version names the root of a b+tree whose nodes,
and the values too large to sit in a leaf, lie at (offset, length) in
data files under ``d/``. Orbax's writer leaves one sub-store per process,
``ocdbt.process_<N>/``, and a top-level tree whose nodes refer to those
sub-stores' data files.

Every manifest and node is one file region laid out as

    magic      u32 big-endian  (0x0cdb3a2a manifest, 0x0cdb20de node)
    length     u64 little-endian, the whole region
    version    varint (0)
    compression u8 (0 none, 1 zstd)
    body       (a zstd frame under compression 1)
    crc32c     u32 little-endian, of every byte before it

and its body is made of varints and columns:

* manifest: config (uuid[16], manifest_kind, max_inline_value_bytes,
  max_decoded_node_bytes, version_tree_arity_log2 u8, compression
  (0, or 1 and a zstd level i32)), a data file table, the versions
  (n; generation, root height u8, root's data file / offset / length,
  num_keys, num_tree_bytes, num_indirect_value_bytes, commit time u64,
  each a column of n), and the version tree nodes (not followed: the
  newest version is always in the manifest itself);
* data file table: n; the length each path shares with the one before
  (n - 1); each path's suffix length; each base path length; then the
  suffixes. A path is its base path and a relative path, both relative
  to the base path of the file that holds the table (its "transitive"
  base): a node read from ``ocdbt.process_0/d/x`` names its files
  relative to ``ocdbt.process_0/``;
* node: height u8, a data file table, n entries; the key each shares
  with the one before (n - 1), the key suffix lengths, in an interior
  node the subtree's common prefix lengths, the key suffixes; then in a
  leaf the value lengths, the value kinds (0 inline, 1 in a data file),
  the data file and offset of each value held out of line, and the inline
  values; in an interior node each child's data file, offset and length
  and its subtree's num_keys, num_tree_bytes and num_indirect_value_bytes.
  Keys below an interior entry are stored without the prefix the entry
  shares with its whole subtree.

Every checksum is checked on read. The writer writes one version of a
single-process store: the values over ``max_inline_value_bytes`` and the
nodes in one data file, its bodies in zstd frames of raw blocks
(native/zstd.cpp has no compressor), with the config Orbax gives its
stores, so that tensorstore and Orbax open it as their own.
"""

from __future__ import annotations

import os
import os.path as ops
import struct
import time
import uuid
from typing import Dict, Iterable, List, Tuple

from lirec_tpu_torch.native import bindings

__all__ = ["Reader", "write_store", "MAX_INLINE_VALUE_BYTES"]

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
NO_ROOT = (1 << 64) - 1
# the config Orbax gives its stores
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


class FormatError(ValueError):
    """A store that is not a well-formed OCDBT store."""


# ------------------------------------------------------------- decoding

class _Body:
    """A cursor over a decoded manifest or node body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, why: str):
        raise FormatError("%s: %s at body byte %d" % (self.what, why,
                                                      self.pos))

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail("truncated (%d bytes wanted)" % n)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.data):
                self.fail("truncated varint")
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def data_files(self, transitive: str) -> List[Tuple[str, str]]:
        """A data file table -> [(base path, relative path)], the base
        paths prefixed with `transitive`."""
        n = self.varint()
        shared = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        base = self.varints(n)
        files, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                self.fail("data file path shares more than its predecessor")
            path = prev[:shared[i]] + self.take(suffix[i])
            prev = path
            if base[i] > len(path):
                self.fail("base path longer than its path")
            files.append((transitive + path[:base[i]].decode(),
                          path[base[i]:].decode()))
        return files

    def keys(self, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
        shared = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        common = self.varints(n) if interior else [0] * n
        keys, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                self.fail("key shares more than its predecessor")
            prev = prev[:shared[i]] + self.take(suffix[i])
            keys.append(prev)
        return keys, common


def _decode_region(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node region, checked."""
    if len(raw) < 18:
        raise FormatError("%s: %d bytes, shorter than any region"
                          % (what, len(raw)))
    got_magic, = struct.unpack(">I", raw[:4])
    if got_magic != magic:
        raise FormatError("%s: magic %08x, not %08x" % (what, got_magic,
                                                         magic))
    length, = struct.unpack("<Q", raw[4:12])
    if length != len(raw):
        raise FormatError("%s: header says %d bytes, region has %d"
                          % (what, length, len(raw)))
    want, = struct.unpack("<I", raw[-4:])
    got = bindings.crc32c(raw[:-4])
    if want != got:
        raise FormatError("%s: crc32c %08x, the bytes give %08x"
                          % (what, want, got))
    head = _Body(raw[:-4], what)
    head.pos = 12
    version = head.varint()
    if version != 0:
        raise FormatError("%s: format version %d (0 is read)"
                          % (what, version))
    compression = head.u8()
    body = raw[head.pos:-4]
    if compression == 0:
        return body
    if compression != 1:
        raise FormatError("%s: compression %d (0 or 1 is read)"
                          % (what, compression))
    size = bindings.zstd_content_size(body)
    if size is None:  # the frame does not state its size: grow to fit
        size = 8 * len(body) + 1024
        while True:
            try:
                return bindings.zstd_decompress(body, size).tobytes()
            except ValueError as err:
                if "past the buffer" not in str(err) or (
                        size >= MAX_DECODED_NODE_BYTES):
                    raise FormatError("%s: %s" % (what, err)) from None
                size = min(4 * size, MAX_DECODED_NODE_BYTES)
    try:
        return bindings.zstd_decompress(body, size).tobytes()
    except ValueError as err:
        raise FormatError("%s: %s" % (what, err)) from None


class _Ref:
    """Where a value or node lies: a data file (its base and relative path)
    and a byte range."""

    __slots__ = ("base", "path", "offset", "length")

    def __init__(self, base: str, path: str, offset: int, length: int):
        self.base, self.path = base, path
        self.offset, self.length = offset, length


class Reader:
    """The newest version of the store at `root`: ``keys()``,
    ``read(key)`` and ``items()``, keys and values as bytes."""

    def __init__(self, root: str):
        self.root = root
        path = ops.join(root, MANIFEST)
        with open(path, "rb") as f:
            body = _Body(_decode_region(f.read(), MANIFEST_MAGIC, path), path)
        self.uuid = body.take(16)
        kind = body.varint()
        if kind != 0:
            body.fail("manifest kind %d (only the single-file manifest, 0, "
                      "is read)" % kind)
        self.max_inline_value_bytes = body.varint()
        self.max_decoded_node_bytes = body.varint()
        self.version_tree_arity_log2 = body.u8()
        method = body.varint()
        if method == 1:
            body.take(4)  # the zstd level
        elif method != 0:
            body.fail("compression method %d" % method)
        files = body.data_files("")
        n = body.varint()
        if n == 0:
            body.fail("no version")
        generation = body.varints(n)
        height = [body.u8() for _ in range(n)]
        file_id = body.varints(n)
        offset = body.varints(n)
        length = body.varints(n)
        self.num_keys = body.varints(n)[-1]
        body.varints(2 * n)  # num_tree_bytes, num_indirect_value_bytes
        body.take(8 * n)  # commit times
        self.generation = generation[-1]
        self._values: Dict[bytes, object] = {}
        if offset[-1] == NO_ROOT:
            return  # an empty store
        if file_id[-1] >= len(files):
            body.fail("root in data file %d of %d" % (file_id[-1],
                                                      len(files)))
        base, rel = files[file_id[-1]]
        self._walk(_Ref(base, rel, offset[-1], length[-1]), height[-1], b"")
        if len(self._values) != self.num_keys:
            raise FormatError("%s: the tree holds %d keys, the manifest says "
                              "%d" % (path, len(self._values),
                                      self.num_keys))

    def _region(self, ref: _Ref) -> bytes:
        path = ops.join(self.root, ref.base, ref.path)
        with open(path, "rb") as f:
            f.seek(ref.offset)
            raw = f.read(ref.length)
        if len(raw) != ref.length:
            raise FormatError("%s: %d bytes at %d wanted, the file ends first"
                              % (path, ref.length, ref.offset))
        return raw

    def _walk(self, ref: _Ref, height: int, prefix: bytes) -> None:
        what = "%s@%d" % (ops.join(ref.base, ref.path), ref.offset)
        body = _Body(_decode_region(self._region(ref), NODE_MAGIC, what),
                     what)
        if body.u8() != height:
            body.fail("node of another height than its parent names")
        files = body.data_files(ref.base)
        n = body.varint()
        keys, common = body.keys(n, interior=height > 0)
        if height > 0:
            file_id = body.varints(n)
            offset = body.varints(n)
            length = body.varints(n)
            body.varints(3 * n)  # the subtrees' statistics
            for i in range(n):
                if file_id[i] >= len(files):
                    body.fail("child in data file %d of %d"
                              % (file_id[i], len(files)))
                base, rel = files[file_id[i]]
                self._walk(_Ref(base, rel, offset[i], length[i]), height - 1,
                           prefix + keys[i][:common[i]])
            return
        size = body.varints(n)
        kind = [body.u8() for _ in range(n)]
        out_of_line = [i for i in range(n) if kind[i] == 1]
        if any(k > 1 for k in kind):
            body.fail("value kind other than 0 and 1")
        file_id = body.varints(len(out_of_line))
        offset = body.varints(len(out_of_line))
        for j, i in enumerate(out_of_line):
            if file_id[j] >= len(files):
                body.fail("value in data file %d of %d" % (file_id[j],
                                                          len(files)))
            base, rel = files[file_id[j]]
            self._values[prefix + keys[i]] = _Ref(base, rel, offset[j],
                                                  size[i])
        for i in range(n):
            if kind[i] == 0:
                self._values[prefix + keys[i]] = body.take(size[i])
        if body.pos != len(body.data):
            body.fail("%d bytes after the leaf's values"
                      % (len(body.data) - body.pos))

    def keys(self) -> List[bytes]:
        return sorted(self._values)

    def __contains__(self, key: bytes) -> bool:
        return key in self._values

    def read(self, key: bytes) -> bytes:
        value = self._values[key]
        return self._region(value) if isinstance(value, _Ref) else value

    def items(self) -> Iterable[Tuple[bytes, bytes]]:
        for key in self.keys():
            yield key, self.read(key)


# ------------------------------------------------------------- encoding

def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(values: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in values)


def _region(magic: int, body: bytes) -> bytes:
    frame = bindings.zstd_frame(body)
    length = 4 + 8 + 1 + 1 + len(frame) + 4
    head = struct.pack(">I", magic) + struct.pack("<Q", length) + b"\0\x01"
    raw = head + frame
    return raw + struct.pack("<I", bindings.crc32c(raw))


def _data_files(paths: List[str]) -> bytes:
    """A data file table of paths relative to the store's root (base
    paths empty)."""
    enc = [p.encode() for p in paths]
    shared = []
    for a, b in zip(enc, enc[1:]):
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        shared.append(k)
    suffix = [p[k:] for p, k in zip(enc, [0] + shared)]
    return (_varint(len(enc)) + _varints(shared)
            + _varints(len(s) for s in suffix) + _varints(0 for _ in enc)
            + b"".join(suffix))


def _keys(keys: List[bytes]) -> Tuple[bytes, bytes, bytes]:
    shared = []
    for a, b in zip(keys, keys[1:]):
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        shared.append(k)
    suffix = [key[k:] for key, k in zip(keys, [0] + shared)]
    return (_varints(shared), _varints(len(s) for s in suffix),
            b"".join(suffix))


def _leaf(entries: List[Tuple[bytes, object]], data_path: str) -> bytes:
    """entries: (key, inline bytes or (offset, length) in `data_path`)."""
    keys = [k for k, _ in entries]
    shared, suffix_len, suffixes = _keys(keys)
    lengths = [len(v) if isinstance(v, bytes) else v[1] for _, v in entries]
    kinds = bytes(0 if isinstance(v, bytes) else 1 for _, v in entries)
    ind = [v for _, v in entries if not isinstance(v, bytes)]
    return (b"\0" + _data_files([data_path] if ind else [])
            + _varint(len(entries)) + shared + suffix_len + suffixes
            + _varints(lengths) + kinds + _varints(0 for _ in ind)
            + _varints(off for off, _ in ind)
            + b"".join(v for _, v in entries if isinstance(v, bytes)))


def _interior(height: int, children: List[dict], data_path: str) -> bytes:
    keys = [c["first"] for c in children]
    shared, suffix_len, suffixes = _keys(keys)
    return (bytes([height]) + _data_files([data_path])
            + _varint(len(children)) + shared + suffix_len
            + _varints(0 for _ in children) + suffixes
            + _varints(0 for _ in children)
            + _varints(c["offset"] for c in children)
            + _varints(c["length"] for c in children)
            + _varints(c["num_keys"] for c in children)
            + _varints(c["tree_bytes"] for c in children)
            + _varints(c["indirect_bytes"] for c in children))


def _groups(items: list, limit: int, cost) -> List[list]:
    """`items` cut, in order, into runs whose summed cost stays under
    `limit` (a margin kept for a node's fixed fields); at least two runs
    where there is more than one item and they do not fit in one."""
    groups, size = [[]], 0
    for item in items:
        c = cost(item)
        if groups[-1] and size + c > limit - 64:
            groups.append([])
            size = 0
        groups[-1].append(item)
        size += c
    return [g for g in groups if g]


def write_store(root: str, items: Dict[bytes, object],
                max_inline_value_bytes: int = MAX_INLINE_VALUE_BYTES,
                max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES) -> None:
    """Write `items` (key -> bytes-like) as a new single-version store at
    `root` (a directory, created; it must hold no store yet). Values over
    `max_inline_value_bytes` go to the data file, each written as it is
    reached; the tree's nodes follow them there."""
    os.makedirs(ops.join(root, "d"), exist_ok=True)
    if ops.exists(ops.join(root, MANIFEST)):
        raise FileExistsError("%s already holds an OCDBT store" % root)
    data_path = "d/%s" % uuid.uuid4().hex
    keys = sorted(items)
    offset = 0
    indirect = 0
    tree_bytes = 0
    with open(ops.join(root, data_path), "wb") as data:
        entries = []
        for key in keys:
            value = items[key]
            n = memoryview(value).nbytes
            if n > max_inline_value_bytes:
                data.write(value)
                entries.append((key, (offset, n)))
                offset += n
                indirect += n
            else:
                entries.append((key, bytes(value)))

        def put(node: bytes) -> Tuple[int, int]:
            nonlocal offset, tree_bytes
            raw = _region(NODE_MAGIC, node)
            data.write(raw)
            at, offset = offset, offset + len(raw)
            tree_bytes += len(raw)
            return at, len(raw)

        # leaves of at most max_decoded_node_bytes (a margin for the
        # columns), then interior levels until one node is left
        level = []
        for group in _groups(entries, max_decoded_node_bytes, lambda e: (
                len(e[0]) + 40 + (len(e[1]) if isinstance(e[1], bytes)
                                  else 0))):
            before = tree_bytes
            at, length = put(_leaf(group, data_path))
            level.append({
                "first": group[0][0], "offset": at, "length": length,
                "num_keys": len(group), "tree_bytes": tree_bytes - before,
                "indirect_bytes": sum(v[1] for _, v in group
                                      if not isinstance(v, bytes))})
        height = 0
        while len(level) > 1:
            height += 1
            upper = []
            for group in _groups(level, max_decoded_node_bytes,
                                 lambda c: len(c["first"]) + 60):
                before = tree_bytes
                at, length = put(_interior(height, group, data_path))
                upper.append({
                    "first": group[0]["first"], "offset": at,
                    "length": length,
                    "num_keys": sum(c["num_keys"] for c in group),
                    "tree_bytes": tree_bytes - before + sum(
                        c["tree_bytes"] for c in group),
                    "indirect_bytes": sum(c["indirect_bytes"]
                                          for c in group)})
            level = upper
    if level:
        root_ref = (0, level[0]["offset"], level[0]["length"])
    else:
        root_ref = (0, NO_ROOT, NO_ROOT)
    body = (uuid.uuid4().bytes + _varint(0) + _varint(max_inline_value_bytes)
            + _varint(max_decoded_node_bytes)
            + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(1)
            + struct.pack("<i", 0) + _data_files([data_path])
            + _varint(1) + _varint(1) + bytes([height])
            + _varints(root_ref) + _varint(len(keys))
            + _varint(tree_bytes) + _varint(indirect)
            + struct.pack("<Q", time.time_ns()) + _varint(0))
    with open(ops.join(root, MANIFEST), "wb") as f:
        f.write(_region(MANIFEST_MAGIC, body))

