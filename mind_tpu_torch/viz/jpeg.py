"""A baseline JPEG encoder in numpy, for the frames of viz/video.py's MJPEG
AVI.

Baseline sequential JFIF: YCbCr with 4:2:0 chroma subsampling (2 x 2
means), an 8 x 8 DCT as matrix products, the Annex K quantization tables
scaled to the requested quality as the IJG library scales them (quality 85,
the video's, is also PIL's default subsampling), the standard Huffman
tables of Annex K.3, and 0xFF byte stuffing. The entropy coder builds every
block's symbols at once and packs their bits with numpy.

Format reference: ITU-T T.81 (ISO/IEC 10918-1) and the JFIF 1.02
specification; no third-party code.
"""

from __future__ import annotations

import struct

import numpy as np

# Annex K.1 / K.2 quantization tables, natural (row-major) order
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    *[99] * 32])

# Annex K.3 Huffman tables: (code counts for lengths 1-16, symbols)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
    0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3,
    0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8,
    0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
    0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18,
    0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA,
    0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7,
    0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])

# natural index of each zigzag position: anti-diagonals, alternating direction
ZIGZAG = np.array(sorted(range(64), key=lambda n: (n // 8 + n % 8,
                                                   (n // 8) if (n // 8 + n % 8) % 2 else n % 8)))
# the same positions in a transposed block
ZIGZAG_T = (ZIGZAG % 8) * 8 + ZIGZAG // 8
# orthonormal 8-point DCT-II: F = C @ block @ C.T is T.81's FDCT
_K = np.arange(8)
DCT = (np.sqrt(np.where(_K == 0, 1 / 8, 2 / 8))[:, None] * np.cos(
    (2 * _K[None, :] + 1) * _K[:, None] * np.pi / 16)).astype(np.float32)
ZRL, EOB = 0xF0, 0x00
# JFIF's RGB -> YCbCr (Cb and Cr centred on 0; Y is shifted by -128 after)
RGB_TO_YCC = np.array([[0.299, 0.587, 0.114],
                       [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]], np.float32)


def quant_tables(quality: int):
    """(luma, chroma) tables in natural order at an IJG quality 1-100
    (jpeg_quality_scaling; baseline values clamped to 1-255)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((base * scale + 50) // 100, 1, 255) for base in (LUMA_Q, CHROMA_Q))


def _codes(table):
    """(code, length) per symbol of a canonical Huffman table, as two
    256-entry arrays."""
    counts, symbols = table
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


_TABLES = [(_codes(DC_LUMA), _codes(AC_LUMA)), (_codes(DC_CHROMA), _codes(AC_CHROMA))]


def _magnitude(v: np.ndarray):
    """(size category, its extra bits) of each value (T.81 F.1.2.1)."""
    size = np.zeros(v.shape, np.int64)
    a = np.abs(v)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return size, np.where(v < 0, v + (1 << size) - 1, v)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[rows/8, cols/8, 8, 8] blocks of a plane."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _entropy(zz: np.ndarray, comp: np.ndarray) -> bytes:
    """The entropy-coded segment of quantized zigzag blocks `zz` [N, 64] in
    scan order, `comp` [N] their component (0 Y, 1 Cb, 2 Cr)."""
    n = len(zz)
    chroma = (comp > 0).astype(np.int64)
    dc = zz[:, 0].astype(np.int64)
    diff = np.empty(n, np.int64)
    for c in range(3):
        sel = np.flatnonzero(comp == c)
        diff[sel] = np.diff(dc[sel], prepend=0)
    events = []                                      # (sort key, code, length)

    def emit(key, table_of, kind, symbol, extra=None, extra_len=None):
        code = np.where(table_of, _TABLES[1][kind][0][symbol], _TABLES[0][kind][0][symbol])
        length = np.where(table_of, _TABLES[1][kind][1][symbol], _TABLES[0][kind][1][symbol])
        if extra is not None:
            code, length = (code << extra_len) | extra, length + extra_len
        events.append((key, code, length))

    stride = 65 * 17
    blk = np.arange(n)
    size, extra = _magnitude(diff)
    emit(blk * stride, chroma, 0, size, extra, size)
    b, p = np.nonzero(zz[:, 1:])
    p = p + 1
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev = np.where(first, 0, np.concatenate([[0], p[:-1]]))
    run = p - prev - 1
    for j in range(3):                               # runs of 16 zeros (at most 3 in 63)
        z = run >= 16 * (j + 1)
        emit(b[z] * stride + p[z] * 17 + j, chroma[b[z]], 1, np.full(z.sum(), ZRL))
    size, extra = _magnitude(zz[b, p].astype(np.int64))
    emit(b * stride + p * 17 + 16, chroma[b], 1, ((run % 16) << 4) | size, extra, size)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, p)                        # the last nonzero AC of each block
    e = last < 63
    emit(blk[e] * stride + 64 * 17, chroma[e], 1, np.full(e.sum(), EOB))

    key = np.concatenate([ev[0] for ev in events])
    order = np.argsort(key, kind="stable")
    code = np.concatenate([ev[1] for ev in events])[order]
    length = np.concatenate([ev[2] for ev in events])[order]
    total = int(length.sum())
    ev = np.repeat(np.arange(len(code)), length)
    pos = np.arange(total) - np.repeat(np.cumsum(length) - length, length)
    bits = ((code[ev] >> (length[ev] - 1 - pos)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])     # pad with 1s
    data = np.packbits(bits)
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def encode_jpeg(rgb: np.ndarray, quality: int = 85) -> bytes:
    """Baseline 4:2:0 JFIF bytes of an 8-bit RGB image [H, W, 3]."""
    h, w, _ = rgb.shape
    ph, pw = -h % 16, -w % 16
    x = rgb.astype(np.float32)
    if ph or pw:
        x = np.pad(x, ((0, ph), (0, pw), (0, 0)), mode="edge")
    ycc = x.reshape(-1, 3) @ RGB_TO_YCC.T + np.float32([-128, 0, 0])
    y, cb, cr = (ycc[:, k].reshape(x.shape[:2]) for k in range(3))
    half = lambda p: (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]) * 0.25
    q_luma, q_chroma = quant_tables(quality)
    my, mx = y.shape[0] // 16, y.shape[1] // 16

    def coded(plane, q):
        """Quantized zigzag coefficients [rows/8, cols/8, 64] of a plane's
        blocks X: Z = X C^T, then (Z^T C^T) = (C X C^T)^T over all blocks
        at once, read in zigzag order through the transpose."""
        b = _blocks(plane)
        n = b.shape[0] * b.shape[1]
        z = (b.reshape(n * 8, 8) @ DCT.T).reshape(n, 8, 8).transpose(0, 2, 1)
        f = (z.reshape(n * 8, 8) @ DCT.T).reshape(n, 64)[:, ZIGZAG_T]
        f /= q[ZIGZAG].astype(np.float32)
        return np.trunc(f + np.copysign(np.float32(0.5), f)).astype(np.int32).reshape(
            b.shape[0], b.shape[1], 64)

    ly = coded(y, q_luma).reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        my, mx, 4, 64)
    lcb, lcr = (coded(half(p), q_chroma).reshape(my, mx, 1, 64) for p in (cb, cr))
    zz = np.concatenate([ly, lcb, lcr], axis=2).reshape(-1, 64)      # MCU: Y Y Y Y Cb Cr
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)

    def dht(cls_id, table):
        counts, symbols = table
        return bytes([cls_id, *counts, *symbols])

    header = (b"\xff\xd8"
              + _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
              + _segment(0xFFDB, bytes([0, *q_luma[ZIGZAG]]) + bytes([1, *q_chroma[ZIGZAG]]))
              + _segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3)
                         + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
              + _segment(0xFFC4, dht(0x00, DC_LUMA) + dht(0x10, AC_LUMA)
                         + dht(0x01, DC_CHROMA) + dht(0x11, AC_CHROMA))
              + _segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return header + _entropy(zz, comp) + b"\xff\xd9"
