"""OCDBT, the key-value database that orbax checkpoints are stored in
(tensorstore's `ocdbt` key-value store), read and written without tensorstore.

`OcdbtReader(root)` opens the database at directory `root`: its
`manifest.ocdbt` (the configuration, the newest versions inline, and the
version tree of older ones), then the b-tree of the newest version
(interior nodes down to leaves, keys prefix-coded under each subtree's
common prefix).  Values are inline in a leaf or indirect (a data file,
offset and length); every data file is memory-mapped once.  Data-file
paths are relative to `root` and may name another database's directory,
as the root of an orbax checkpoint names `ocdbt.process_0/d/...`.
`list()` gives the keys in order, `read(key)` a value.

`write_database(root, items)` writes the layout tensorstore reads: one
data file holding the values above the inline limit and one b-tree leaf,
and a manifest with a single version.  Manifests, version-tree nodes and
b-tree nodes are each a header (magic, length, format version 0,
compression), a zstd frame (or the raw body) and a CRC-32C.

Refused by name: numbered manifests (`manifest.<n>` files, which orbax
does not write), format versions other than 0, compression other than
none or zstd, and every malformed structure.
"""

import mmap
import os
import struct
import threading
import time
import uuid
from typing import Dict, List, Mapping, Tuple

from straps_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_NODE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1             # offset and length of an empty tree
MAX_INLINE_VALUE_BYTES = 1024       # tensorstore's defaults, as orbax writes them
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


class OcdbtError(ValueError):
    pass


class _Body:
    """A cursor over a decoded node or manifest body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, why: str):
        raise OcdbtError(f"{self.what}: {why}")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            if self.pos >= len(self.data):
                self.fail("truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail("truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8s(self, n: int) -> List[int]:
        return list(self.take(n))

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.take(8 * n)))

    def data_files(self) -> List[str]:
        """The data file table: paths prefix-coded against the previous one."""
        n = self.varint()
        prefix = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        base = self.varints(n)
        paths, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev) or base[i] > prefix[i] + suffix[i]:
                self.fail("bad data file table")
            prev = prev[:prefix[i]] + self.take(suffix[i])
            paths.append(prev.decode())
        return paths

    def file_id(self, files: List[str], i: int) -> str:
        if i >= len(files):
            self.fail(f"data file {i} outside its table of {len(files)}")
        return files[i]

    def end(self):
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes after the end")


def _decode(raw, magic: int, what: str) -> _Body:
    """Header, body and CRC-32C of a manifest or node -> its body."""
    raw = memoryview(raw)
    if len(raw) < 18:
        raise OcdbtError(f"{what}: truncated")
    got_magic, length = struct.unpack(">I", raw[:4])[0], struct.unpack("<Q", raw[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(raw):
        raise OcdbtError(f"{what}: length {length} in its header, {len(raw)} on disk")
    if zstd.crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    head = _Body(bytes(raw[12:24]), what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} (only 0 is read)")
    body = raw[12 + head.pos:-4]
    if compression == 1:
        body = zstd.decompress(body)
    elif compression == 0:
        body = bytes(body)
    else:
        raise OcdbtError(f"{what}: compression format {compression} (none and zstd are read)")
    return _Body(body, what)


def _encode(body: bytes, magic: int) -> bytes:
    """A body as a node or manifest: header, a zstd frame of raw blocks,
    CRC-32C."""
    frame = zstd.frame_raw(body)
    length = 4 + 8 + 2 + len(frame) + 4
    out = struct.pack(">I", magic) + struct.pack("<Q", length) + b"\x00\x01" + frame
    return out + struct.pack("<I", zstd.crc32c(out))


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        if v < 0x80:
            out.append(v)
            return bytes(out)
        out.append((v & 0x7F) | 0x80)
        v >>= 7


class OcdbtReader:
    """The newest version of the OCDBT database at `root` (a directory)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._maps: Dict[str, mmap.mmap] = {}
        self._lock = threading.Lock()
        path = os.path.join(self.root, "manifest.ocdbt")
        if not os.path.exists(path):
            raise OcdbtError(f"{self.root}: no manifest.ocdbt (not an OCDBT database)")
        with open(path, "rb") as f:
            body = _decode(f.read(), MANIFEST_MAGIC, path)
        self.config = self._config(body)
        self._versions, self._version_nodes = self._version_entries(body, manifest=True)
        body.end()
        self._index: Dict[bytes, Tuple] = {}
        newest = self._versions[-1] if self._versions else None
        if newest is not None and newest["root"] is not None:
            self._walk(newest["root"], newest["root_height"], b"")

    @staticmethod
    def _config(body: _Body) -> dict:
        cfg = {"uuid": body.take(16).hex()}
        kind = body.varint()
        if kind != 0:
            body.fail(f"manifest kind {kind} (numbered manifests are not read; "
                      "orbax writes single-file manifests)")
        cfg["max_inline_value_bytes"] = body.varint()
        cfg["max_decoded_node_bytes"] = body.varint()
        cfg["version_tree_arity_log2"] = body.take(1)[0]
        method = body.varint()
        if method == 1:
            cfg["compression"] = {"id": "zstd", "level": struct.unpack("<i", body.take(4))[0]}
        elif method == 0:
            cfg["compression"] = {"id": "none"}
        else:
            body.fail(f"compression method {method}")
        return cfg

    def _version_entries(self, body: _Body, manifest: bool):
        """A manifest's inline versions and version-node references, or a
        version-tree leaf's versions."""
        files = body.data_files()
        n = body.varint()
        gen = body.varints(n)
        height = body.u8s(n)
        fid = body.varints(n)
        off, length = body.varints(n), body.varints(n)
        keys, tree_bytes, indirect = body.varints(n), body.varints(n), body.varints(n)
        commit = body.u64s(n)
        versions = []
        for i in range(n):
            empty = off[i] == MISSING and length[i] == MISSING
            versions.append({
                "generation_number": gen[i], "root_height": height[i], "commit_time": commit[i],
                "root": None if empty else (body.file_id(files, fid[i]), off[i], length[i]),
                "statistics": {"num_keys": keys[i], "num_tree_bytes": tree_bytes[i],
                               "num_indirect_value_bytes": indirect[i]}})
        nodes = []
        if manifest:
            m = body.varint()
            gen, fid = body.varints(m), body.varints(m)
            off, length, ngen = body.varints(m), body.varints(m), body.varints(m)
            commit, height = body.u64s(m), body.u8s(m)
            nodes = [{"generation_number": gen[i], "height": height[i],
                      "location": (body.file_id(files, fid[i]), off[i], length[i]),
                      "num_generations": ngen[i], "commit_time": commit[i]} for i in range(m)]
        return versions, nodes

    def versions(self) -> List[dict]:
        """Every version, oldest first: the version tree's leaves, then the
        manifest's inline versions."""
        out = []

        def walk(node):
            body = _decode(self._slice(node["location"]), VERSION_NODE_MAGIC,
                           f"version node {node['location']}")
            body.take(1)                                   # arity log2
            height = body.take(1)[0]
            if height == 0:
                versions, _ = self._version_entries(body, manifest=False)
                out.extend(versions)
            else:
                files = body.data_files()
                n = body.varint()
                gen, fid = body.varints(n), body.varints(n)
                off, length, ngen = body.varints(n), body.varints(n), body.varints(n)
                commit = body.u64s(n)
                for i in range(n):
                    walk({"location": (body.file_id(files, fid[i]), off[i], length[i]),
                          "generation_number": gen[i], "num_generations": ngen[i],
                          "commit_time": commit[i], "height": height - 1})
            body.end()

        for node in self._version_nodes:
            walk(node)
        return out + self._versions

    def _map(self, path: str) -> mmap.mmap:
        with self._lock:                  # readers on several threads map a file once
            if path not in self._maps:
                if os.path.isabs(path) or ".." in path.split("/"):
                    raise OcdbtError(f"{self.root}: data file {path!r} lies outside the "
                                     f"database")
                with open(os.path.join(self.root, path), "rb") as f:
                    size = os.fstat(f.fileno()).st_size
                    self._maps[path] = mmap.mmap(f.fileno(), size, access=mmap.ACCESS_READ) \
                        if size else b""
            return self._maps[path]

    def _slice(self, location) -> memoryview:
        path, offset, length = location
        data = self._map(path)
        if offset + length > len(data):
            raise OcdbtError(f"{path}: [{offset}, {offset + length}) past its "
                             f"{len(data)} bytes")
        return memoryview(data)[offset:offset + length]

    def _walk(self, location, height: int, prefix: bytes):
        body = _decode(self._slice(location), BTREE_NODE_MAGIC, f"b-tree node {location}")
        if body.take(1)[0] != height:
            body.fail(f"height differs from its parent's record ({height})")
        files = body.data_files()
        n = body.varint()
        key_prefix = [0] + body.varints(n - 1) if n else []
        key_suffix = body.varints(n)
        common = body.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if key_prefix[i] > len(prev):
                body.fail("key prefix longer than the previous key")
            prev = prev[:key_prefix[i]] + body.take(key_suffix[i])
            keys.append(prev)
        if height:
            fid, off, length = body.varints(n), body.varints(n), body.varints(n)
            body.varints(3 * n)                            # subtree statistics
            body.end()
            for i in range(n):
                if common[i] > len(keys[i]):
                    body.fail("subtree prefix longer than its key")
                self._walk((body.file_id(files, fid[i]), off[i], length[i]), height - 1,
                           prefix + keys[i][:common[i]])
            return
        lengths, kinds = body.varints(n), body.u8s(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k > 1 for k in kinds):
            body.fail(f"value kind {max(kinds)}")
        fid, off = body.varints(len(indirect)), body.varints(len(indirect))
        for j, i in enumerate(indirect):
            self._index[prefix + keys[i]] = (body.file_id(files, fid[j]), off[j], lengths[i])
        for i in range(n):
            if kinds[i] == 0:
                self._index[prefix + keys[i]] = body.take(lengths[i])
        body.end()

    def list(self) -> List[bytes]:
        return sorted(self._index)

    def view(self, key: bytes):
        """The value of `key` without a copy (bytes or a memoryview of its
        data file); KeyError when absent."""
        where = self._index[key]
        return where if isinstance(where, bytes) else self._slice(where)

    def read(self, key: bytes) -> bytes:
        return bytes(self.view(key))


def write_database(root: str, items: Mapping[bytes, object]) -> None:
    """Write `items` (key -> bytes-like value) as a new OCDBT database at
    directory `root`: values above `MAX_INLINE_VALUE_BYTES` in one data
    file `d/<name>`, followed by one b-tree leaf holding every key, then
    `manifest.ocdbt` naming that leaf as generation 1."""
    db_uuid = uuid.uuid4()
    data_rel = f"d/{db_uuid.hex}"
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    keys = sorted(items)
    lengths, kinds, offsets, inline = [], [], [], []
    offset = 0
    with open(os.path.join(root, data_rel), "wb") as f:
        for k in keys:
            v = memoryview(items[k]).cast("B")
            lengths.append(len(v))
            if len(v) > MAX_INLINE_VALUE_BYTES:
                kinds.append(1)
                offsets.append(offset)
                f.write(v)
                offset += len(v)
            else:
                kinds.append(0)
                inline.append(bytes(v))
        n_indirect = sum(kinds)
        body = bytearray(b"\x00")                            # height 0
        body += _table([data_rel] if n_indirect else [])
        body += _varint(len(keys))
        common = [0] + [_common(a, b) for a, b in zip(keys, keys[1:])]
        for c in common[1:]:
            body += _varint(c)
        for k, c in zip(keys, common):
            body += _varint(len(k) - c)
        for k, c in zip(keys, common):
            body += k[c:]
        for v in lengths:
            body += _varint(v)
        body += bytes(kinds)
        body += b"".join(_varint(0) for _ in range(n_indirect))
        body += b"".join(_varint(o) for o in offsets)
        body += b"".join(inline)
        if len(body) > MAX_DECODED_NODE_BYTES:
            raise OcdbtError(f"{len(keys)} keys make a b-tree leaf of {len(body)} bytes, "
                             f"above {MAX_DECODED_NODE_BYTES}")
        node = _encode(bytes(body), BTREE_NODE_MAGIC)
        f.write(node)
    manifest = bytearray(db_uuid.bytes)
    manifest += b"\x00" + _varint(MAX_INLINE_VALUE_BYTES) + _varint(MAX_DECODED_NODE_BYTES)
    manifest += bytes([VERSION_TREE_ARITY_LOG2]) + b"\x01" + struct.pack("<i", 0)
    manifest += _table([data_rel])
    manifest += _varint(1)                                    # one version
    manifest += _varint(1) + b"\x00" + _varint(0)             # generation 1, height 0, file 0
    manifest += _varint(offset) + _varint(len(node))
    manifest += _varint(len(keys)) + _varint(len(node)) + _varint(offset)
    manifest += struct.pack("<Q", time.time_ns())
    manifest += _varint(0)                                    # no version-tree nodes
    tmp = os.path.join(root, "manifest.ocdbt.tmp")
    with open(tmp, "wb") as f:
        f.write(_encode(bytes(manifest), MANIFEST_MAGIC))
    os.replace(tmp, os.path.join(root, "manifest.ocdbt"))


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _table(paths: List[str]) -> bytes:
    """A data file table (no path prefix coding, no base paths)."""
    out = _varint(len(paths))
    out += b"".join(_varint(0) for _ in paths[1:])
    out += b"".join(_varint(len(p.encode())) for p in paths)
    out += b"".join(_varint(0) for _ in paths)
    return out + b"".join(p.encode() for p in paths)
