"""A Parquet reader in numpy, for flat tables of scalar columns.

It reads what Argoverse 2 scenario logs hold and what pandas'
`DataFrame.to_parquet` writes through pyarrow with its defaults or the usual
writer settings: the Thrift compact protocol of the footer and the page
headers, several row groups and several pages per column chunk, data pages
v1 and v2, definition levels of OPTIONAL columns (the RLE / bit-packed
hybrid), the encodings PLAIN, PLAIN_DICTIONARY and RLE_DICTIONARY (and RLE
for booleans, as data pages v2 carry them), the
physical types BOOLEAN, INT32, INT64, FLOAT, DOUBLE and BYTE_ARRAY (read as
UTF-8 text), and the codecs UNCOMPRESSED, SNAPPY (a raw snappy decoder of its
own) and GZIP (zlib). Anything else (another codec, encoding or type, a
nested or repeated column, a null value) raises a ValueError that names it.

Format reference: the Apache Parquet format specification (parquet.thrift)
and the snappy format description; no third-party code.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, List

import numpy as np

MAGIC = b"PAR1"

CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI", 5: "LZ4",
          6: "ZSTD", 7: "LZ4_RAW"}
ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
             5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
             8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
TYPES = {0: "BOOLEAN", 1: "INT32", 2: "INT64", 3: "INT96", 4: "FLOAT", 5: "DOUBLE",
         6: "BYTE_ARRAY", 7: "FIXED_LEN_BYTE_ARRAY"}
FIXED = {1: np.dtype("<i4"), 2: np.dtype("<i8"), 4: np.dtype("<f4"), 5: np.dtype("<f8")}
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
REQUIRED, OPTIONAL = 0, 1
DATA_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 2, 3


# -- Thrift compact protocol -------------------------------------------------

class _Thrift:
    """Decodes Thrift compact-protocol structs into {field id: value} dicts;
    a field this module does not use is read and left unused, whatever its
    type (statistics, page indexes, key-value metadata)."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf, self.pos = buf, pos

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def value(self, kind: int):
        if kind in (1, 2):            # a boolean in a collection is one byte
            return self.byte() == 1
        if kind == 3:
            return struct.unpack_from("<b", self.buf, self._skip(1))[0]
        if kind in (4, 5, 6):
            return self.zigzag()
        if kind == 7:
            return struct.unpack_from("<d", self.buf, self._skip(8))[0]
        if kind == 8:
            n = self.varint()
            return bytes(self.buf[self._skip(n):self.pos])
        if kind in (9, 10):
            head = self.byte()
            n, elem = head >> 4, head & 0x0F
            if n == 15:
                n = self.varint()
            return [self.value(elem) for _ in range(n)]
        if kind == 11:
            n = self.varint()
            if n == 0:
                return {}
            kv = self.byte()
            return {self.value(kv >> 4): self.value(kv & 0x0F) for _ in range(n)}
        if kind == 12:
            return self.struct()
        raise ValueError(f"parquet: unknown Thrift compact type {kind}")

    def _skip(self, n: int) -> int:
        start = self.pos
        self.pos += n
        return start

    def struct(self) -> dict:
        out, fid = {}, 0
        while True:
            head = self.byte()
            if head == 0:
                return out
            kind, delta = head & 0x0F, head >> 4
            fid = fid + delta if delta else self.zigzag()
            # a struct field's boolean lives in its type nibble
            out[fid] = (kind == 1) if kind in (1, 2) else self.value(kind)


# -- snappy ------------------------------------------------------------------

def snappy_decompress(buf: bytes) -> bytes:
    """Raw (unframed) snappy: a varint length, then literals and copies."""
    t = _Thrift(buf)
    n = t.varint()
    out = bytearray()
    pos, end = t.pos, len(buf)
    while pos < end:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                                   # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(buf[pos:pos + nb], "little")
                pos += nb
            ln += 1
            out += buf[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:                                   # copy, 11-bit offset
            ln = 4 + ((tag >> 2) & 7)
            off = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        else:                                           # copy, 16- or 32-bit offset
            ln = (tag >> 2) + 1
            nb = 2 if kind == 2 else 4
            off = int.from_bytes(buf[pos:pos + nb], "little")
            pos += nb
        if off == 0 or off > len(out):
            raise ValueError("parquet: corrupt snappy stream (copy before the start)")
        start = len(out) - off
        if off >= ln:
            out += out[start:start + ln]
        else:                                           # the copy overlaps its output
            chunk = bytes(out[start:])
            out += (chunk * (ln // off + 1))[:ln]
    if len(out) != n:
        raise ValueError(f"parquet: snappy stream gave {len(out)} bytes, its header says {n}")
    return bytes(out)


def _decompress(codec: int, data: bytes, size: int) -> bytes:
    if codec == 0:
        out = data
    elif codec == 1:
        out = snappy_decompress(data)
    elif codec == 2:
        out = zlib.decompress(data, 16 + zlib.MAX_WBITS)
    else:
        raise ValueError(f"parquet: unsupported compression codec "
                         f"{CODECS.get(codec, codec)}")
    if len(out) != size:
        raise ValueError(f"parquet: a page decompressed to {len(out)} bytes, expected {size}")
    return out


# -- encodings ---------------------------------------------------------------

def _unpack_bits(data: bytes, width: int, count: int) -> np.ndarray:
    """`count` little-endian bit-packed integers of `width` bits."""
    if width == 0:
        return np.zeros(count, np.int64)
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little")
    bits = bits[:count * width].reshape(count, width).astype(np.int64)
    return bits @ (np.int64(1) << np.arange(width, dtype=np.int64))


def rle_hybrid(data: bytes, pos: int, end: int, width: int, count: int) -> np.ndarray:
    """`count` values of the RLE / bit-packed hybrid in data[pos:end]."""
    t = _Thrift(data, pos)
    runs: List[np.ndarray] = []
    got, nbytes = 0, (width + 7) // 8
    while got < count:
        if t.pos >= end:
            raise ValueError("parquet: RLE / bit-packed run ends before its values")
        head = t.varint()
        if head & 1:                                    # bit-packed groups of 8
            n = (head >> 1) * 8
            start = t._skip((head >> 1) * width)
            run = _unpack_bits(data[start:t.pos], width, n)
        else:
            n = head >> 1
            value = int.from_bytes(data[t._skip(nbytes):t.pos], "little")
            run = np.full(n, value, np.int64)
        runs.append(run)
        got += len(run)
    return np.concatenate(runs)[:count] if runs else np.zeros(0, np.int64)


def _plain(ptype: int, data: bytes, pos: int, count: int, name: str):
    """`count` PLAIN values from data[pos:]."""
    if ptype in FIXED:
        return np.frombuffer(data, FIXED[ptype], count, pos)
    if ptype == 0:
        bits = np.unpackbits(np.frombuffer(data, np.uint8, (count + 7) // 8, pos),
                             bitorder="little")
        return bits[:count].astype(bool)
    if ptype == 6:
        out = np.empty(count, object)
        for i in range(count):
            (n,) = struct.unpack_from("<I", data, pos)
            out[i] = data[pos + 4:pos + 4 + n].decode("utf-8")
            pos += 4 + n
        return out
    raise ValueError(f"parquet: column {name!r} has the unsupported physical type "
                     f"{TYPES.get(ptype, ptype)}")


# -- pages and columns -------------------------------------------------------

def _column_chunk(buf: bytes, meta: dict, name: str, ptype: int, max_def: int) -> list:
    """The values of one column chunk, as a list of arrays (one per page)."""
    codec = meta[4]
    if codec not in (0, 1, 2):
        raise ValueError(f"parquet: column {name!r} uses the unsupported compression codec "
                         f"{CODECS.get(codec, codec)}")
    num_values = meta[5]
    pos = min(meta[11], meta[9]) if meta.get(11) else meta[9]
    dictionary, pages, got = None, [], 0
    while got < num_values:
        t = _Thrift(buf, pos)
        head = t.struct()
        kind, size, csize = head[1], head[2], head[3]
        body = buf[t.pos:t.pos + csize]
        pos = t.pos + csize
        if kind == DICTIONARY_PAGE:
            dh = head[7]
            if dh.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                raise ValueError(f"parquet: column {name!r}: unsupported dictionary encoding "
                                 f"{ENCODINGS.get(dh[2], dh[2])}")
            dictionary = _plain(ptype, _decompress(codec, body, size), 0, dh[1], name)
            continue
        if kind == DATA_PAGE:
            dh = head[5]
            n, encoding = dh[1], dh[2]
            data = _decompress(codec, body, size)
            vpos = 0
            if max_def:
                (ln,) = struct.unpack_from("<I", data, 0)
                levels = rle_hybrid(data, 4, 4 + ln, 1, n)
                vpos = 4 + ln
        elif kind == DATA_PAGE_V2:
            dh = head[8]
            n, encoding = dh[1], dh[4]
            dlen, rlen = dh.get(5, 0), dh.get(6, 0)
            if rlen:
                raise ValueError(f"parquet: column {name!r} has repetition levels "
                                 "(a nested column)")
            levels = rle_hybrid(body, 0, dlen, 1, n) if max_def else None
            values = body[dlen:]
            if dh.get(7, True):
                values = _decompress(codec, values, size - dlen)
            data, vpos = values, 0
        else:
            raise ValueError(f"parquet: column {name!r} has a page of unsupported type {kind}")
        present = n if not max_def else int(levels.sum())
        if present != n:
            raise ValueError(f"parquet: column {name!r} holds {n - present} null values")
        if encoding == PLAIN:
            vals = _plain(ptype, data, vpos, n, name)
        elif encoding == RLE and ptype == 0:           # booleans, length-prefixed
            (ln,) = struct.unpack_from("<I", data, vpos)
            vals = rle_hybrid(data, vpos + 4, vpos + 4 + ln, 1, n).astype(bool)
        elif encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            if dictionary is None:
                raise ValueError(f"parquet: column {name!r}: dictionary page missing")
            width = data[vpos]
            vals = dictionary[rle_hybrid(data, vpos + 1, len(data), width, n)]
        else:
            raise ValueError(f"parquet: column {name!r} uses the unsupported encoding "
                             f"{ENCODINGS.get(encoding, encoding)}")
        pages.append(vals)
        got += n
    return pages


def read_parquet(path: Path | str) -> Dict[str, np.ndarray]:
    """{column name: numpy array} of a flat Parquet file, in file order.
    Strings come back as an object array of str."""
    buf = Path(path).read_bytes()
    if len(buf) < 12 or buf[:4] != MAGIC or buf[-4:] != MAGIC:
        raise ValueError(f"parquet: {path} is not a Parquet file")
    (footer,) = struct.unpack_from("<I", buf, len(buf) - 8)
    meta = _Thrift(buf, len(buf) - 8 - footer).struct()
    schema = meta[2]
    root, leaves = schema[0], schema[1:]
    if any(5 in s and s[5] for s in leaves) or root.get(5) != len(leaves):
        raise ValueError(f"parquet: {path} has nested columns")
    columns = []
    for s in leaves:
        name = s[4].decode("utf-8")
        if s.get(3, REQUIRED) not in (REQUIRED, OPTIONAL):
            raise ValueError(f"parquet: column {name!r} is repeated")
        columns.append((name, s[1], int(s.get(3, REQUIRED) == OPTIONAL)))
    chunks: Dict[str, list] = {name: [] for name, _, _ in columns}
    for group in meta.get(4, []):
        for (name, ptype, max_def), chunk in zip(columns, group[1]):
            if ptype not in TYPES or TYPES[ptype] in ("INT96", "FIXED_LEN_BYTE_ARRAY"):
                raise ValueError(f"parquet: column {name!r} has the unsupported physical type "
                                 f"{TYPES.get(ptype, ptype)}")
            chunks[name] += _column_chunk(buf, chunk[3], name, ptype, max_def)
    out = {}
    for name, ptype, _ in columns:
        parts = chunks[name]
        if parts:
            out[name] = np.concatenate(parts)
        else:
            out[name] = np.zeros(0, object if ptype == 6 else FIXED.get(ptype, bool))
    return out
