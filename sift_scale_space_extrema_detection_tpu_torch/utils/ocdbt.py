"""Read an OCDBT database, and the zarr v2 arrays in it, from a directory.

OCDBT is tensorstore's key-value format, in which orbax stores every array
of a checkpoint (as zarr v2: a ``<name>/.zarray`` JSON and one compressed
chunk per grid cell). This module reads it in plain Python and numpy, where
no tensorstore is installed.

The layout, as tensorstore writes it:

- Every manifest, B-tree node and version-tree node is encoded alike: a
  big-endian 4-byte magic (``0x0cdb3a2a``, ``0x0cdb20de``, ``0x0cdb1234``),
  the encoded length as a little-endian u64, the format version (varint,
  0), the compression method (varint: 0 none, 1 zstd), the body, and a
  little-endian CRC-32C of every byte before it.
- ``manifest.ocdbt`` holds the configuration, then (for the "single"
  manifest kind) a data-file table, the newest versions inline, and
  references to version-tree nodes holding the older ones. The "numbered"
  kind keeps the versions in the newest ``manifest.<16 hex digits>``.
- Each version names its B-tree root by (data file, offset, length). A node
  holds its own data-file table (paths relative to the base path of the
  file the node lies in), then its entries column by column; keys are
  prefix-compressed, and an interior entry strips its subtree's common
  prefix from the keys below it. A leaf value is inline or a (data file,
  offset, length) reference. Data files carry no checksum of their own.

Entry points: :class:`Database` (opened once, then :meth:`Database.keys`,
:meth:`Database.read`, :meth:`Database.items`), :func:`list_keys`,
:func:`read` and :func:`read_zarr_v2`. Every inconsistency raises a
``ValueError`` naming the file.
"""

from __future__ import annotations

import bisect
import gzip
import itertools
import json
import math
import os
import re
import struct
import zlib

import numpy as np

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_TREE_MAGIC = 0x0CDB1234
_MISSING = (1 << 64) - 1  # the length of a missing (empty tree) root reference


def _crc_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, what: str) -> ValueError:
        return ValueError(f"ocdbt: {self.where}: {what} (at byte {self.pos} of the body)")

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.data):
                raise self.fail("truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise self.fail(f"truncated: {n} bytes wanted")
        self.pos += n
        return self.data[self.pos - n : self.pos]

    def u8s(self, n: int) -> list[int]:
        return list(self.raw(n))

    def u64s(self, n: int) -> list[int]:
        return list(struct.unpack(f"<{n}Q", self.raw(8 * n)))

    def end(self) -> None:
        if self.pos != len(self.data):
            raise self.fail(f"{len(self.data) - self.pos} bytes after the last field")


def _decode(encoded: bytes, magic: int, where: str) -> bytes:
    """The body of one encoded manifest or node, its envelope checked."""
    if len(encoded) < 18:
        raise ValueError(f"ocdbt: {where}: {len(encoded)} bytes is too short for an encoded node")
    (found,) = struct.unpack_from(">I", encoded, 0)
    if found != magic:
        raise ValueError(f"ocdbt: {where}: magic {found:#010x}, expected {magic:#010x}")
    (length,) = struct.unpack_from("<Q", encoded, 4)
    if length != len(encoded):
        raise ValueError(f"ocdbt: {where}: length field {length}, the node has {len(encoded)} bytes")
    (crc,) = struct.unpack_from("<I", encoded, len(encoded) - 4)
    if crc32c(encoded[:-4]) != crc:
        raise ValueError(f"ocdbt: {where}: CRC-32C mismatch")
    head = _Reader(encoded[12:-4], where)
    version = head.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {where}: format version {version}, only 0 is read")
    method = head.varint()
    body = head.data[head.pos :]
    if method == 0:
        return body
    if method == 1:
        try:
            return zstd.decompress(body)
        except ValueError as e:
            raise ValueError(f"ocdbt: {where}: {e}") from None
    raise ValueError(f"ocdbt: {where}: compression method {method}, only 0 (none) and 1 (zstd)")


def _data_files(r: _Reader, transitive: str) -> list[str]:
    """A data-file table: each file's path relative to the database root."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise r.fail("a data-file path shares more than the previous path")
        full = prev[: prefix[i]] + r.raw(suffix[i])
        if base[i] > len(full):
            raise r.fail("a data-file base path longer than its path")
        prev = full
        path = transitive + full.decode()
        parts = path.split("/")
        if path.startswith("/") or ".." in parts:
            raise r.fail(f"data-file path {path!r} leaves the database")
        paths.append((transitive + full[: base[i]].decode(), path))
    return paths


class Database:
    """An OCDBT database on disk, read at its newest version."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._files: dict[str, bytes] = {}
        manifest = os.path.join(self.path, "manifest.ocdbt")
        if not os.path.isfile(manifest):
            raise ValueError(f"ocdbt: {self.path} holds no manifest.ocdbt")
        r = self._open("manifest.ocdbt", MANIFEST_MAGIC)
        self.config = self._config(r)
        if self.config["manifest_kind"] == 1:
            numbered = sorted(
                f for f in os.listdir(self.path) if re.fullmatch(r"manifest\.[0-9a-f]{16}", f)
            )
            if not numbered:
                raise ValueError(f"ocdbt: {manifest}: a numbered manifest with no versions")
            r = self._open(numbered[-1], MANIFEST_MAGIC)
            # A numbered manifest holds the "single" kind's layout.
            if self._config(r) != {**self.config, "manifest_kind": 0}:
                raise r.fail("a numbered manifest whose configuration differs")
        elif self.config["manifest_kind"] != 0:
            raise r.fail(f"manifest kind {self.config['manifest_kind']}")
        files = _data_files(r, "")
        self.versions = self._version_leaf(r, files)
        self._version_nodes = self._version_refs(r, files, with_height=True)
        r.end()
        if self.versions:
            self.root = self.versions[-1]
        else:
            newest = self.all_versions()
            self.root = newest[-1] if newest else None

    # ---- files ----------------------------------------------------------
    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            full = os.path.join(self.path, rel)
            try:
                with open(full, "rb") as f:
                    self._files[rel] = f.read()
            except OSError as e:
                raise ValueError(f"ocdbt: {full}: {e.strerror}") from None
        return self._files[rel]

    def _range(self, ref) -> bytes:
        _, rel, offset, length = ref
        data = self._file(rel)
        if offset + length > len(data):
            raise ValueError(
                f"ocdbt: {os.path.join(self.path, rel)}: bytes [{offset}, {offset + length}) lie "
                f"past its end ({len(data)})"
            )
        return data[offset : offset + length]

    def _open(self, rel: str, magic: int) -> _Reader:
        where = os.path.join(self.path, rel)
        return _Reader(_decode(self._file(rel), magic, where), where)

    def _open_ref(self, ref, magic: int) -> _Reader:
        base, rel, offset, length = ref
        where = f"{os.path.join(self.path, rel)} [{offset}, {offset + length})"
        return _Reader(_decode(self._range(ref), magic, where), where)

    # ---- manifest and version tree -------------------------------------
    @staticmethod
    def _config(r: _Reader) -> dict:
        config = {
            "uuid": r.raw(16).hex(),
            "manifest_kind": r.varint(),
            "max_inline_value_bytes": r.varint(),
            "max_decoded_node_bytes": r.varint(),
            "version_tree_arity_log2": r.u8s(1)[0],
            "compression": r.varint(),
        }
        if config["compression"] == 1:
            config["zstd_level"] = struct.unpack("<i", r.raw(4))[0]
        elif config["compression"] != 0:
            raise r.fail(f"configured compression {config['compression']}")
        return config

    @staticmethod
    def _refs(r: _Reader, files, n: int):
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        refs = []
        for i, o, ln in zip(ids, offsets, lengths):
            if i >= len(files):
                raise r.fail(f"data file {i} of a table of {len(files)}")
            refs.append((*files[i], o, ln))
        return refs

    def _version_leaf(self, r: _Reader, files) -> list[dict]:
        n = r.varint()
        gens, heights = r.varints(n), r.u8s(n)
        refs = self._refs(r, files, n)
        stats = [r.varints(n) for _ in range(3)]
        times = r.u64s(n)
        return [
            {"generation": g, "height": h, "root": None if ref[3] == _MISSING else ref,
             "num_keys": k, "commit_time": t}
            for g, h, ref, k, t in zip(gens, heights, refs, stats[0], times)
        ]

    def _version_refs(self, r: _Reader, files, with_height: bool, height: int = 0) -> list:
        n = r.varint()
        gens = r.varints(n)
        refs = self._refs(r, files, n)
        counts = r.varints(n)
        r.u64s(n)  # commit times
        heights = r.u8s(n) if with_height else [height - 1] * n
        return list(zip(gens, refs, counts, heights))

    def all_versions(self) -> list[dict]:
        """Every version the manifest reaches, oldest first (the
        version-tree nodes, then the inline ones)."""
        out = []
        for _, ref, _, height in self._version_nodes:
            out += self._walk_versions(ref, height)
        return out + self.versions

    def _walk_versions(self, ref, height: int) -> list[dict]:
        r = self._open_ref(ref, VERSION_TREE_MAGIC)
        arity, found = r.u8s(2)
        if arity != self.config["version_tree_arity_log2"] or found != height:
            raise r.fail(f"version-tree node of arity {arity} and height {found}, expected "
                         f"{self.config['version_tree_arity_log2']} and {height}")
        files = _data_files(r, ref[0])
        if height == 0:
            versions = self._version_leaf(r, files)
            r.end()
            return versions
        children = self._version_refs(r, files, with_height=False, height=height)
        r.end()
        return [v for _, child, _, h in children for v in self._walk_versions(child, h)]

    # ---- B-tree ---------------------------------------------------------
    def _node(self, ref, height: int):
        """``(height, entries)`` of the B-tree node at ``ref``: for a leaf,
        ``(key, value)`` with value bytes or a data reference; for an
        interior node, ``(key, common_prefix_length, child_ref)``."""
        r = self._open_ref(ref, BTREE_MAGIC)
        found = r.u8s(1)[0]
        if found != height:
            raise r.fail(f"B-tree node of height {found}, its parent says {height}")
        files = _data_files(r, ref[0])
        n = r.varint()
        prefix = [0] + r.varints(n - 1) if n else []
        suffix = r.varints(n)
        common = r.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                raise r.fail("a key shares more than the previous key")
            prev = prev[: prefix[i]] + r.raw(suffix[i])
            keys.append(prev)
        if height:
            children = self._refs(r, files, n)
            for _ in range(3):
                r.varints(n)  # statistics: keys, tree bytes, indirect value bytes
            r.end()
            for k, c in zip(keys, common):
                if c > len(k):
                    raise r.fail("a subtree prefix longer than its key")
            return list(zip(keys, common, children))
        lengths = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            raise r.fail(f"value kind {max(kinds)}")
        # An indirect value's reference is (data file, offset); its length
        # is the value's.
        m = kinds.count(1)
        ids, offsets = r.varints(m), iter(r.varints(m))
        if any(i >= len(files) for i in ids):
            raise r.fail(f"data file {max(ids)} of a table of {len(files)}")
        ids = iter(ids)
        values = [
            (*files[next(ids)], next(offsets), length) if kind else r.raw(length)
            for length, kind in zip(lengths, kinds)
        ]
        r.end()
        return list(zip(keys, values))

    def _walk(self, ref, height: int, prefix: bytes):
        entries = self._node(ref, height)
        if height == 0:
            for key, value in entries:
                yield prefix + key, value
            return
        for key, common, child in entries:
            yield from self._walk(child, height - 1, prefix + key[:common])

    def _value(self, value) -> bytes:
        return value if isinstance(value, bytes) else self._range(value)

    def keys(self) -> list[str]:
        """Every key of the newest version, in order."""
        if self.root is None or self.root["root"] is None:
            return []
        return [k.decode() for k, _ in self._walk(self.root["root"], self.root["height"], b"")]

    def items(self) -> dict[str, bytes]:
        """Every ``key: value`` of the newest version."""
        if self.root is None or self.root["root"] is None:
            return {}
        return {k.decode(): self._value(v)
                for k, v in self._walk(self.root["root"], self.root["height"], b"")}

    def get(self, key: str) -> bytes | None:
        """The value of ``key``, or ``None`` where the database has none."""
        if self.root is None or self.root["root"] is None:
            return None
        want = key.encode()
        ref, height, prefix = self.root["root"], self.root["height"], b""
        while True:
            entries = self._node(ref, height)
            rel = want[len(prefix) :]
            if height == 0:
                for k, v in entries:
                    if k == rel:
                        return self._value(v)
                return None
            i = bisect.bisect_right([k for k, _, _ in entries], rel) - 1
            if i < 0:
                return None
            k, common, ref = entries[i]
            prefix += k[:common]
            if not want.startswith(prefix):
                return None
            height -= 1

    def read(self, key: str) -> bytes:
        """The value of ``key``; ``KeyError`` where there is none."""
        value = self.get(key)
        if value is None:
            raise KeyError(f"ocdbt: {self.path} holds no key {key!r}")
        return value


def list_keys(path: str) -> list[str]:
    """Every key of the OCDBT database at ``path``, at its newest version."""
    return Database(path).keys()


def read(path: str, key: str) -> bytes:
    """The value of ``key`` in the OCDBT database at ``path``."""
    return Database(path).read(key)


_COMPRESSORS = {
    "zstd": zstd.decompress,
    "zlib": zlib.decompress,
    "gzip": gzip.decompress,
}


def _fill(value, dtype: np.dtype):
    if isinstance(value, str):
        value = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}.get(value, value)
    return np.asarray(value).astype(dtype)


def read_zarr_v2(db, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of an OCDBT database (a :class:`Database`
    or its path), with its own dtype, shape and order."""
    if not isinstance(db, Database):
        db = Database(db)
    where = f"{db.path}: {name}"
    meta = json.loads(db.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"ocdbt: {where}: zarr_format {meta.get('zarr_format')}, only 2 is read")
    if meta.get("filters"):
        raise ValueError(f"ocdbt: {where}: zarr filters {meta['filters']} are not read")
    compressor = meta.get("compressor")
    if compressor is None:
        decompress = bytes
    elif compressor.get("id") in _COMPRESSORS:
        decompress = _COMPRESSORS[compressor["id"]]
    else:
        raise ValueError(f"ocdbt: {where}: zarr compressor {compressor.get('id')!r} is not read")
    if not isinstance(meta["dtype"], str):
        raise ValueError(f"ocdbt: {where}: structured zarr dtype {meta['dtype']} is not read")
    dtype = np.dtype(meta["dtype"])
    if dtype.hasobject:
        raise ValueError(f"ocdbt: {where}: object dtype {meta['dtype']} is not read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    separator = meta.get("dimension_separator", ".")
    if len(chunks) != len(shape) or order not in ("C", "F") or separator not in (".", "/"):
        raise ValueError(f"ocdbt: {where}: chunks {chunks}, order {order!r}, separator "
                         f"{separator!r} do not describe a regular grid")
    out = np.empty(shape, dtype)
    if out.size == 0:
        return out
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for index in itertools.product(*grid):
        key = f"{name}/" + (separator.join(map(str, index)) if index else "0")
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        raw = db.get(key)
        if raw is None:
            if meta.get("fill_value") is None:
                raise ValueError(f"ocdbt: {where}: chunk {key!r} is missing and fill_value is null")
            out[region] = _fill(meta["fill_value"], dtype)
            continue
        try:
            raw = decompress(raw)
        except (ValueError, zlib.error, OSError, EOFError) as e:
            raise ValueError(f"ocdbt: {where}: chunk {key!r}: {e}") from None
        if len(raw) != chunk_bytes:
            raise ValueError(f"ocdbt: {where}: chunk {key!r} holds {len(raw)} bytes, "
                             f"expected {chunk_bytes}")
        block = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    return out
