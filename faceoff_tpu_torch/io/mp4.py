"""The ISO base media file format (ISO/IEC 14496-12/-14) around one
`mp4v` video track, read and written with the standard library and numpy.

Reading walks the boxes wherever `moov` lies (cv2's writer puts it after
`mdat`), takes the sample table (`stsz`, `stsc`, `stco` or `co64`,
`stts`, `stss`), the size and timescale (`tkhd`, `mdhd`, the sample entry)
and the `mp4v` entry's `esds` DecoderSpecificInfo, which holds the
VOS/VO/VOL headers, or the `avc1`/`avc3` entry's `avcC` record (H.264's
NAL length size and parameter sets, io/h264.py). Any other sample entry
raises naming its codec.

Writing lays out `ftyp` (isom), `mdat`, then `moov`: `mvhd`, one `trak`
with `tkhd` and `mdia` (`mdhd`, `hdlr` vide, `minf` (`vmhd`, `dinf`/`dref`,
`stbl`: `stsd` mp4v + `esds` with object type 0x20, `stts`, `stss`, `stsc`,
`stsz`, `stco`)). The media timescale is the frame rate, one tick a frame.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_NAMES = {b"hvc1": "HEVC (hvc1)", b"hev1": "HEVC (hev1)",
          b"av01": "AV1 (av01)", b"vp09": "VP9 (vp09)",
          b"mjpa": "motion JPEG (mjpa)", b"jpeg": "JPEG (jpeg)",
          b"s263": "H.263 (s263)"}
MP4V_OBJECT_TYPE = 0x20  # MPEG-4 Visual (ISO/IEC 14496-2)
AVC_ENTRIES = (b"avc1", b"avc3")


@dataclass
class Track:
    """The video track of an MP4: each sample's bytes (in file order),
    the sync (key frame) flags, the size, timescale and sample durations,
    the DecoderSpecificInfo (mp4v) or avcC record (avc1, avc3), and the
    sample entry's codec."""

    width: int
    height: int
    timescale: int
    durations: np.ndarray
    sync: np.ndarray
    samples: List[bytes]
    dsi: bytes
    codec: str = "mp4v"


def sniff(path: str) -> Optional[str]:
    """"mp4" or "avi" by content, as cv2 decides: an `ftyp` box (or a
    leading `moov`/`mdat`/`free`) against a RIFF AVI header."""
    with open(path, "rb") as fh:
        head = fh.read(12)
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return "avi"
    if head[4:8] in (b"ftyp", b"moov", b"mdat", b"free", b"wide"):
        return "mp4"
    return None


def _boxes(data: bytes, lo: int, hi: int):
    """(type, body start, body end) of the boxes in data[lo:hi]."""
    pos = lo
    while pos + 8 <= hi:
        size, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = pos + 8
        if size == 1:
            size = struct.unpack(">Q", data[body: body + 8])[0]
            body += 8
        elif size == 0:
            size = hi - pos
        if size < body - pos or pos + size > hi:
            raise ValueError(f"box {kind!r} at {pos} overruns its parent")
        yield kind, body, pos + size
        pos += size


def _find(data: bytes, lo: int, hi: int, path: Sequence[bytes]):
    """Body bounds of each box along `path` under data[lo:hi]."""
    for kind, b, e in _boxes(data, lo, hi):
        if kind == path[0]:
            if len(path) == 1:
                yield b, e
            else:
                yield from _find(data, b, e, path[1:])


def _one(data, lo, hi, path, where):
    for b, e in _find(data, lo, hi, path):
        return b, e
    raise ValueError(f"{where}: no {b'/'.join(path).decode()} box")


def _descriptor(data: bytes, pos: int) -> Tuple[int, int, int]:
    """(tag, body start, body end) of an MPEG-4 descriptor."""
    tag = data[pos]
    pos += 1
    size = 0
    for _ in range(4):
        byte = data[pos]
        pos += 1
        size = (size << 7) | (byte & 0x7F)
        if not byte & 0x80:
            break
    return tag, pos, pos + size


def _esds_dsi(data: bytes, lo: int, hi: int, where: str) -> bytes:
    """The DecoderSpecificInfo of an esds body (after version/flags)."""
    tag, b, e = _descriptor(data, lo + 4)
    if tag != 3:
        raise ValueError(f"{where}: esds without an ES descriptor")
    flags = data[b + 2]
    pos = b + 3
    if flags & 0x80:
        pos += 2
    if flags & 0x40:
        pos += 1 + data[pos]
    if flags & 0x20:
        pos += 2
    while pos < e:
        tag, db, de = _descriptor(data, pos)
        if tag == 4:
            if data[db] != MP4V_OBJECT_TYPE:
                raise ValueError(
                    f"{where}: esds object type 0x{data[db]:02x} is not "
                    f"MPEG-4 Visual (0x20); the port reads only mp4v")
            pos = db + 13
            while pos < de:
                tag, sb, se = _descriptor(data, pos)
                if tag == 5:
                    return data[sb:se]
                pos = se
            break
        pos = de
    raise ValueError(f"{where}: esds holds no DecoderSpecificInfo")


def read_mp4(path: str, max_frames: Optional[int] = None) -> Track:
    """The `mp4v`, `avc1` or `avc3` video track of an MP4 file. Other
    codecs raise a ValueError naming them."""
    data = Path(path).read_bytes()
    moov = _one(data, 0, len(data), [b"moov"], path)
    track = None
    for tb, te in _find(data, *moov, [b"trak"]):
        hb, he = _one(data, tb, te, [b"mdia", b"hdlr"], path)
        if data[hb + 8: hb + 12] == b"vide":
            track = (tb, te)
            break
    if track is None:
        raise ValueError(f"{path}: no video track")
    mdhd_b, _ = _one(data, *track, [b"mdia", b"mdhd"], path)
    if data[mdhd_b] == 1:
        timescale = struct.unpack(">I", data[mdhd_b + 20: mdhd_b + 24])[0]
    else:
        timescale = struct.unpack(">I", data[mdhd_b + 12: mdhd_b + 16])[0]
    stbl = _one(data, *track, [b"mdia", b"minf", b"stbl"], path)
    sb, se = _one(data, *stbl, [b"stsd"], path)
    count = struct.unpack(">I", data[sb + 4: sb + 8])[0]
    if count < 1:
        raise ValueError(f"{path}: empty stsd")
    size, kind = struct.unpack(">I4s", data[sb + 8: sb + 16])
    entry = (sb + 16, sb + 8 + size)
    if kind != b"mp4v" and kind not in AVC_ENTRIES:
        name = _NAMES.get(kind, repr(kind.decode("latin-1")))
        raise ValueError(
            f"{path}: video codec {name}; the port reads MPEG-4 Part 2 "
            f"(mp4v) and H.264 (avc1, avc3) only. HEVC input waits for "
            f"its own decoder (ROADMAP.md, Queue 1 item 7b)")
    width, height = struct.unpack(">HH", data[entry[0] + 24: entry[0] + 28])
    if kind == b"mp4v":
        eb, ee = _one(data, entry[0] + 78, entry[1], [b"esds"], path)
        dsi = _esds_dsi(data, eb, ee, path)
    else:
        found = list(_find(data, entry[0] + 78, entry[1], [b"avcC"]))
        if not found:
            raise ValueError(f"{path}: video codec H.264 ({kind.decode()}) "
                             f"without its avcC box (the decoder "
                             f"configuration record)")
        dsi = data[found[0][0]: found[0][1]]
    b, _ = _one(data, *stbl, [b"stsz"], path)
    fixed, n = struct.unpack(">II", data[b + 4: b + 12])
    sizes = (np.full(n, fixed, np.int64) if fixed else
             np.frombuffer(data, ">u4", n, b + 12).astype(np.int64))
    chunk_offsets = None
    for b, _ in _find(data, *stbl, [b"stco"]):
        k = struct.unpack(">I", data[b + 4: b + 8])[0]
        chunk_offsets = np.frombuffer(data, ">u4", k, b + 8).astype(np.int64)
    for b, _ in _find(data, *stbl, [b"co64"]):
        k = struct.unpack(">I", data[b + 4: b + 8])[0]
        chunk_offsets = np.frombuffer(data, ">u8", k, b + 8).astype(np.int64)
    if chunk_offsets is None:
        raise ValueError(f"{path}: no stco or co64 box")
    b, _ = _one(data, *stbl, [b"stsc"], path)
    k = struct.unpack(">I", data[b + 4: b + 8])[0]
    stsc = np.frombuffer(data, ">u4", 3 * k, b + 8).reshape(k, 3)
    offsets = np.zeros(n, np.int64)
    s = 0
    for i in range(len(chunk_offsets)):
        # samples per chunk: from the last stsc entry whose first chunk
        # (1-based) is at most this one
        j = np.searchsorted(stsc[:, 0], i + 1, side="right") - 1
        per = int(stsc[j, 1]) if j >= 0 else 0
        pos = chunk_offsets[i]
        for _ in range(per):
            if s >= n:
                break
            offsets[s] = pos
            pos += sizes[s]
            s += 1
    if s != n:
        raise ValueError(f"{path}: the chunk table covers {s} of {n} "
                         f"samples")
    durations = np.ones(n, np.int64)
    for b, _ in _find(data, *stbl, [b"stts"]):
        k = struct.unpack(">I", data[b + 4: b + 8])[0]
        runs = np.frombuffer(data, ">u4", 2 * k, b + 8).reshape(k, 2)
        durations = np.repeat(runs[:, 1], runs[:, 0]).astype(np.int64)[:n]
    sync = np.ones(n, bool)
    for b, _ in _find(data, *stbl, [b"stss"]):
        k = struct.unpack(">I", data[b + 4: b + 8])[0]
        sync[:] = False
        sync[np.frombuffer(data, ">u4", k, b + 8).astype(np.int64) - 1] = True
    keep = n if max_frames is None else min(n, max_frames)
    samples = [data[o: o + z] for o, z in zip(offsets[:keep], sizes[:keep])]
    return Track(width, height, timescale, durations[:keep], sync[:keep],
                 samples, dsi, kind.decode())


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _desc(tag: int, body: bytes) -> bytes:
    n = len(body)
    size = bytes([0x80 | ((n >> 21) & 0x7F), 0x80 | ((n >> 14) & 0x7F),
                  0x80 | ((n >> 7) & 0x7F), n & 0x7F])
    return bytes([tag]) + size + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def write_mp4(path: str, samples: Sequence[bytes], sync: Sequence[bool],
              width: int, height: int, fps: int, dsi: bytes,
              co64: bool = False) -> None:
    """One `mp4v` track of `samples` (each one VOP) at `fps`, sync flags
    marking the I-VOPs, `dsi` the VOS/VO/VOL headers. Chunk offsets are
    64-bit (`co64`) when the file needs them or `co64` asks for them."""
    if not samples:
        raise ValueError("no frames to write")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(samples)
    sizes = [len(s) for s in samples]
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 512),
                b"isomiso2mp41")
    mdat_body = b"".join(samples)
    large = 16 + len(mdat_body) > 0xFFFFFFFF
    mdat = (struct.pack(">I4sQ", 1, b"mdat", 16 + len(mdat_body)) if large
            else struct.pack(">I4s", 8 + len(mdat_body), b"mdat"))
    first = len(ftyp) + len(mdat)
    duration_ms = n * 1000 // fps
    avg = int(sum(sizes) * 8 * fps / n)
    es = _desc(3, struct.pack(">HB", 1, 0) + _desc(
        4, struct.pack(">BB", MP4V_OBJECT_TYPE, 0x11)
        + max(sizes).to_bytes(3, "big") + struct.pack(">II", avg, avg)
        + _desc(5, dsi)) + _desc(6, b"\x02"))
    mp4v = _box(b"mp4v", b"\0" * 6, struct.pack(">H", 1), b"\0" * 16,
                struct.pack(">HHIIIH", width, height, 0x480000, 0x480000, 0,
                            1), b"\0" * 32, struct.pack(">Hh", 24, -1),
                _full(b"esds", 0, 0, es))
    pos = first
    offsets = []
    for z in sizes:
        offsets.append(pos)
        pos += z
    co = (_full(b"co64", 0, 0, struct.pack(">I", n),
                np.asarray(offsets, ">u8").tobytes()) if large or co64 else
          _full(b"stco", 0, 0, struct.pack(">I", n),
                np.asarray(offsets, ">u4").tobytes()))
    keys = [i + 1 for i, k in enumerate(sync) if k]
    stbl = _box(
        b"stbl",
        _full(b"stsd", 0, 0, struct.pack(">I", 1), mp4v),
        _full(b"stts", 0, 0, struct.pack(">III", 1, n, 1)),
        _full(b"stss", 0, 0, struct.pack(">I", len(keys)),
              np.asarray(keys, ">u4").tobytes()),
        _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1)),
        _full(b"stsz", 0, 0, struct.pack(">II", 0, n),
              np.asarray(sizes, ">u4").tobytes()),
        co)
    minf = _box(b"minf", _full(b"vmhd", 0, 1, b"\0" * 8),
                _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                                    _full(b"url ", 0, 1))), stbl)
    mdia = _box(b"mdia",
                _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, fps, n,
                                                 0x55C4, 0)),
                _full(b"hdlr", 0, 0, struct.pack(">I4s", 0, b"vide"),
                      b"\0" * 12, b"VideoHandler\0"), minf)
    tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0,
                                            duration_ms),
                 b"\0" * 8, struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX,
                 struct.pack(">II", width << 16, height << 16))
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000,
                                            duration_ms),
                 struct.pack(">IH", 0x10000, 0x100), b"\0" * 10, _MATRIX,
                 b"\0" * 24, struct.pack(">I", 2))
    moov = _box(b"moov", mvhd, _box(b"trak", tkhd, mdia))
    with open(path, "wb") as fh:
        fh.write(ftyp)
        fh.write(mdat)
        fh.write(mdat_body)
        fh.write(moov)
