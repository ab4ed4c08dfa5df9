"""Sample videos and image grids without OpenCV, counterpart of
`faceoff_tpu/io/video.py`.

Videos are uncompressed RIFF AVI files: one video stream of 24-bit BI_RGB
frames (top-down BGR rows, marked by a negative height, padded to four
bytes; each frame a key frame; an idx1 index), written and read with the
standard library; ffmpeg reads them. The JAX
package writes mp4 through cv2's encoder; these files are larger and
lossless, and players read them as they are. Grids are PNG files
(`io/image.py`).
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from faceoff_tpu_torch.io.image import write_png

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


def _to_uint8(frame) -> np.ndarray:
    f = np.asarray(frame)
    if f.dtype != np.uint8:
        f = np.clip(np.rint(f * 255.0), 0, 255).astype(np.uint8)
    return f


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    pad = b"\0" if len(body) % 2 else b""
    return fourcc + struct.pack("<I", len(body)) + body + pad


def _list(kind: bytes, body: bytes) -> bytes:
    return _chunk(b"LIST", kind + body)


def save_frames_as_video(
    frames: Sequence[np.ndarray], video_path: str, fps: int = 25
) -> None:
    """Write float [0, 1] or uint8 RGB frames (H, W, 3) as an uncompressed
    AVI at `fps`."""
    if len(frames) == 0:
        raise ValueError("no frames to write")
    os.makedirs(os.path.dirname(video_path) or ".", exist_ok=True)
    first = _to_uint8(frames[0])
    h, w = first.shape[:2]
    row = (w * 3 + 3) & ~3
    size = row * h
    movi, index = [], []
    offset = 4  # idx1 offsets count from the 'movi' fourcc
    for frame in frames:
        f = _to_uint8(frame)
        if f.shape != (h, w, 3):
            raise ValueError(f"frame of shape {f.shape}, expected {(h, w, 3)}")
        body = np.zeros((h, row), np.uint8)
        body[:, : w * 3] = f[:, :, ::-1].reshape(h, w * 3)
        movi.append(_chunk(b"00db", body.tobytes()))
        index.append(struct.pack("<4sIII", b"00db", _AVIIF_KEYFRAME, offset,
                                 size))
        offset += 8 + size + size % 2
    n = len(frames)
    avih = struct.pack("<IIIIIIIIII4I", round(1e6 / fps), size * fps, 0,
                       _AVIF_HASINDEX, n, 0, 1, size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"DIB ", 0, 0, 0, 0,
                       1, fps, 0, n, size, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    body = (hdrl + _list(b"movi", b"".join(movi))
            + _chunk(b"idx1", b"".join(index)))
    Path(video_path).write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body))
                                 + b"AVI " + body)


def _walk(data: bytes, start: int, end: int):
    """(fourcc, body start, body end) of the chunks in data[start:end],
    depth first through the hdrl, strl and movi lists."""
    pos = start
    while pos + 8 <= end:
        fourcc, size = struct.unpack("<4sI", data[pos: pos + 8])
        body = pos + 8
        if fourcc == b"LIST" and data[body: body + 4] in (
                b"hdrl", b"strl", b"movi"):
            yield from _walk(data, body + 4, body + size)
        else:
            yield fourcc, body, body + size
        pos = body + size + size % 2


def read_video_frames(
    video_path: str, max_frames: Optional[int] = None
) -> List[np.ndarray]:
    """Read an uncompressed 24-bit AVI into a list of uint8 RGB frames."""
    data = Path(video_path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{video_path}: not an AVI file")
    width = height = None
    frames: List[np.ndarray] = []
    for fourcc, lo, hi in _walk(data, 12, len(data)):
        if fourcc == b"strf":
            _, width, height, _, bits, comp = struct.unpack(
                "<IiiHHI", data[lo: lo + 20])
            if bits != 24 or comp != 0:
                raise ValueError(f"{video_path}: only uncompressed 24-bit "
                                 f"frames are read")
        elif fourcc in (b"00db", b"00dc"):
            if width is None:
                raise ValueError(f"{video_path}: frames before strf")
            if max_frames is not None and len(frames) >= max_frames:
                break
            h, w = abs(height), width
            row = (w * 3 + 3) & ~3
            img = np.frombuffer(data[lo: lo + row * h], np.uint8)
            img = img.reshape(h, row)[:, : w * 3].reshape(h, w, 3)
            if height > 0:  # bottom-up rows
                img = img[::-1]
            frames.append(np.ascontiguousarray(img[..., ::-1]))
    return frames


def save_image_grid(
    frames: Sequence[np.ndarray], path: str, nrow: Optional[int] = None
) -> None:
    """Tile frames (uint8 or [0, 1] float RGB) into one PNG grid of
    `nrow` rows (half the frames' count by default)."""
    if len(frames) == 0:
        raise ValueError("no frames")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs = [_to_uint8(f) for f in frames]
    n = len(arrs)
    nrow = nrow or max(n // 2, 1)
    ncol = (n + nrow - 1) // nrow
    h, w = arrs[0].shape[:2]
    grid = np.zeros((nrow * h, ncol * w, 3), np.uint8)
    for i, a in enumerate(arrs):
        r, c = divmod(i, ncol)
        grid[r * h: (r + 1) * h, c * w: (c + 1) * w] = a
    write_png(path, grid)
