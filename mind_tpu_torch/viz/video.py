"""Pure-Python MJPEG/AVI video writer (the port's copy of
mind_tpu/viz/video.py, with PIL replaced by viz/raster.py's PNG reader and
viz/jpeg.py's encoder).

The reference assembles its one user-visible deliverable — a playable video —
by shelling out to ffmpeg (reference simulator.py:128-131). Where no ffmpeg
is installed, `write_mjpeg_avi` builds a playable AVI container directly:
each PNG frame is JPEG-encoded and wrapped in a RIFF/AVI structure
(avih + strl headers, `movi` chunk list, `idx1` index). MJPEG-in-AVI is the
simplest container every mainstream player (VLC, mpv, ffplay, QuickTime via
ffmpeg libs, browsers via conversion) still decodes.

Format references: the public AVI RIFF spec (msdn AVIMAINHEADER /
AVISTREAMHEADER / BITMAPINFOHEADER layouts). No third-party code.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, List, Tuple

from mind_tpu_torch.viz.jpeg import encode_jpeg
from mind_tpu_torch.viz.raster import read_png


def numeric_frame_sort(names: Iterable[str], prefix: str = "frame_",
                       suffix: str = ".png") -> List[str]:
    """Order frame filenames by their numeric counter. A plain
    lexicographic sort scrambles videos once the %03d counter grows a
    digit ('frame_1000' < 'frame_999' as strings)."""
    import os.path as osp

    def key(p):
        b = osp.basename(p)
        return int(b[len(prefix):-len(suffix)])

    return sorted(names, key=key)


def _jpeg_frames(png_paths: Iterable[str], quality: int) -> Tuple[List[bytes], int, int]:
    frames = []
    size = None
    for p in png_paths:
        rgb = read_png(p)[..., :3]
        if size is None:
            # JPEG wants even dimensions for some decoders; crop by <=1px
            h, w = rgb.shape[:2]
            size = (w - w % 2, h - h % 2)
        frames.append(encode_jpeg(rgb[:size[1], :size[0]], quality))
    if size is None:
        raise ValueError("no frames")
    return frames, size[0], size[1]


def write_mjpeg_avi(png_paths: List[str], out_path: str, fps: int = 25,
                    quality: int = 85) -> str:
    """Encode PNG frame files into a playable MJPEG AVI at `out_path`."""
    frames, width, height = _jpeg_frames(png_paths, quality)
    n = len(frames)
    max_size = max(len(f) for f in frames)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) % 2 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        body = fourcc + payload
        pad = b"\x00" if len(body) % 2 else b""
        return b"LIST" + struct.pack("<I", len(body)) + body + pad

    # AVIMAINHEADER (56 bytes after fourcc/size)
    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        1_000_000 // fps,     # dwMicroSecPerFrame
        max_size * fps,       # dwMaxBytesPerSec
        0,                    # dwPaddingGranularity
        0x10,                 # dwFlags: AVIF_HASINDEX
        n,                    # dwTotalFrames
        0,                    # dwInitialFrames
        1,                    # dwStreams
        max_size,             # dwSuggestedBufferSize
        width, height,
        0, 0, 0, 0,           # dwReserved
    )

    # AVISTREAMHEADER
    strh = struct.pack(
        "<4s4sIHHIIIIIIIIhhhh",
        b"vids", b"MJPG",
        0,                    # dwFlags
        0, 0,                 # wPriority, wLanguage
        0,                    # dwInitialFrames
        1, fps,               # dwScale, dwRate -> fps
        0, n,                 # dwStart, dwLength
        max_size,             # dwSuggestedBufferSize
        0xFFFFFFFF,           # dwQuality (default)
        0,                    # dwSampleSize
        0, 0, width & 0x7FFF, height & 0x7FFF,  # rcFrame l,t,r,b
    )

    # BITMAPINFOHEADER
    strf = struct.pack(
        "<IiiHH4sIiiII",
        40, width, height, 1, 24, b"MJPG",
        width * height * 3, 0, 0, 0, 0,
    )

    hdrl = lst(b"hdrl",
               chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_chunks = []
    index = []
    offset = 4  # relative to the start of the 'movi' fourcc
    for f in frames:
        c = chunk(b"00dc", f)
        movi_chunks.append(c)
        index.append(struct.pack("<4sIII", b"00dc", 0x10, offset, len(f)))
        offset += len(c)
    movi = lst(b"movi", b"".join(movi_chunks))
    idx1 = chunk(b"idx1", b"".join(index))

    body = b"AVI " + hdrl + movi + idx1
    with open(out_path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return out_path


def probe_avi(path: str) -> dict:
    """Minimal validity probe of an AVI file (used by tests): checks the
    RIFF signature, walks the chunk tree, and returns frame count/dims."""
    with open(path, "rb") as fh:
        data = fh.read()
    assert data[:4] == b"RIFF", "not a RIFF file"
    assert data[8:12] == b"AVI ", "not an AVI"
    riff_size = struct.unpack("<I", data[4:8])[0]
    assert riff_size + 8 == len(data), "RIFF size mismatch"

    info = {"frames": 0, "width": None, "height": None,
            "index_entries": 0, "jpeg_ok": True}
    pos = 12
    while pos + 8 <= len(data):
        fourcc = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        if fourcc == b"LIST":
            kind = data[pos + 8:pos + 12]
            if kind in (b"hdrl", b"movi", b"strl"):
                inner = pos + 12
                end = pos + 8 + size
                while inner + 8 <= end:
                    fc = data[inner:inner + 4]
                    sz = struct.unpack("<I", data[inner + 4:inner + 8])[0]
                    if fc == b"avih":
                        hdr = data[inner + 8:inner + 8 + 56]
                        vals = struct.unpack("<IIIIIIIIII", hdr[:40])
                        info["frames"] = vals[4]
                        info["width"], info["height"] = vals[8], vals[9]
                    elif fc == b"00dc":
                        payload = data[inner + 8:inner + 8 + sz]
                        if not (payload[:2] == b"\xff\xd8"
                                and payload[-2:] == b"\xff\xd9"):
                            info["jpeg_ok"] = False
                    # LIST sub-chunks (strl) are skipped whole like any chunk
                    inner += 8 + sz + (sz % 2)
        elif fourcc == b"idx1":
            info["index_entries"] = size // 16
        pos += 8 + size + (size % 2)
    return info
