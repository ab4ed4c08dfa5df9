"""Videos and image grids without OpenCV, counterpart of
`faceoff_tpu/io/video.py`.

An .mp4 name is written as the JAX package writes it through cv2: an MP4
file (`io/mp4.py`) holding MPEG-4 Part 2 `mp4v` video (`io/mpeg4.py`),
encoded on `device` (CUDA unless named: the kernels of
`ops/mpeg4_cuda.py` and the C++ entropy coder; on the CPU their plain
versions). Other names get a RIFF AVI with one video stream, written and
read with the standard library: uncompressed (24-bit BI_RGB frames,
top-down BGR rows marked by a negative height, padded to four bytes) or
motion JPEG (`codec="mjpg"`: each frame a JPEG that nvJPEG encodes on the
card, fourcc MJPG). Every AVI frame is a key frame and the file has an
idx1 index; ffmpeg and cv2 read both. Readers find the format by content,
as cv2 does. Besides what the port writes they read MPEG-4 Part 2 in
either container: the Simple and Advanced Simple Profiles (B-VOPs, MPEG
quantisation, quarter-pel; in AVI the fourccs of Xvid, DivX and FFmpeg,
packed B-frames included), frame for frame as cv2 returns them
(`io/mpeg4.py` says what it still refuses), and H.264 Constrained
Baseline in MP4 (`avc1`, `avc3`: io/h264.py, which says what it refuses),
decoded on `device` (CUDA unless named) as cv2 returns it. An MP4 or AVI
of another codec (HEVC, H.264 in AVI, ...) raises naming it. MJPEG on the
CPU (no JPEG codec there) raises. Grids are PNG files (`io/image.py`).
"""

from __future__ import annotations

import functools
import os
import struct
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.io import h264, mp4, mpeg4
from faceoff_tpu_torch.io.image import (decode_jpeg_bytes, encode_jpeg,
                                        write_png)

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10
_MJPG = struct.unpack("<I", b"MJPG")[0]
# AVI fourccs of MPEG-4 Part 2 video (Xvid, DivX 5, FFmpeg)
MPEG4_FOURCCS = (b"XVID", b"xvid", b"DIVX", b"divx", b"DX50", b"FMP4",
                 b"MP4V", b"mp4v")
_MPEG4 = {struct.unpack("<I", f)[0] for f in MPEG4_FOURCCS}
CODECS = ("raw", "mjpg")
_NO_MJPG_CPU = ("motion-JPEG AVI is encoded and decoded by nvJPEG on a "
                "CUDA device only (ROADMAP.md, Queue 1 item 7b); on the "
                "CPU write codec='raw'")


def _to_uint8(frame) -> np.ndarray:
    f = frame.cpu().numpy() if isinstance(frame, torch.Tensor) else \
        np.asarray(frame)
    if f.dtype != np.uint8:
        f = np.clip(np.rint(f * 255.0), 0, 255).astype(np.uint8)
    return f


def _chunk(fourcc: bytes, body: bytes) -> bytes:
    pad = b"\0" if len(body) % 2 else b""
    return fourcc + struct.pack("<I", len(body)) + body + pad


def _list(kind: bytes, body: bytes) -> bytes:
    return _chunk(b"LIST", kind + body)


def is_mp4_name(path: str) -> bool:
    return str(path).lower().endswith(".mp4")


def write_avi(video_path: str, frames: Sequence[bytes], width: int,
              height: int, fps: int = 25, codec: str = "raw") -> None:
    """The AVI container around frames already coded: for "raw" each is
    a BI_RGB body (height rows of BGR padded to four bytes, top-down);
    for "mjpg" each is one JPEG's bytes."""
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")
    if len(frames) == 0:
        raise ValueError("no frames to write")
    os.makedirs(os.path.dirname(video_path) or ".", exist_ok=True)
    mjpg = codec == "mjpg"
    tag = b"00dc" if mjpg else b"00db"
    image_size = ((width * 3 + 3) & ~3) * height
    movi, index = [], []
    offset = 4  # idx1 offsets count from the 'movi' fourcc
    for body in frames:
        movi.append(_chunk(tag, body))
        index.append(struct.pack("<4sIII", tag, _AVIIF_KEYFRAME, offset,
                                 len(body)))
        offset += 8 + len(body) + len(body) % 2
    n = len(frames)
    largest = max(len(b) for b in frames)
    avih = struct.pack("<IIIIIIIIII4I", round(1e6 / fps), largest * fps, 0,
                       _AVIF_HASINDEX, n, 0, 1, largest, width, height,
                       0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids",
                       b"MJPG" if mjpg else b"DIB ", 0, 0, 0, 0, 1, fps,
                       0, n, largest, 0xFFFFFFFF, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHHIIiiII", 40, width,
                       height if mjpg else -height, 1, 24,
                       _MJPG if mjpg else 0, image_size, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    body = (hdrl + _list(b"movi", b"".join(movi))
            + _chunk(b"idx1", b"".join(index)))
    Path(video_path).write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body))
                                 + b"AVI " + body)


def _raw_body(f: np.ndarray, h: int, w: int) -> bytes:
    row = (w * 3 + 3) & ~3
    body = np.zeros((h, row), np.uint8)
    body[:, : w * 3] = f[:, :, ::-1].reshape(h, w * 3)
    return body.tobytes()


def _device_frames(frames, dev: torch.device) -> List[torch.Tensor]:
    """Each float [0, 1] or uint8 RGB frame as a uint8 tensor on `dev`."""
    out = []
    for frame in frames:
        if isinstance(frame, torch.Tensor):
            f = frame.to(dev)
            if f.dtype != torch.uint8:
                f = (f.float() * 255.0).round().clamp(0, 255).to(torch.uint8)
        else:
            f = torch.from_numpy(_to_uint8(frame)).to(dev)
        out.append(f)
    return out


def _save_mp4(frames, video_path: str, fps: int, device: DeviceLike
              ) -> None:
    """Write frames as an `mp4v` MP4, encoded on `device` (CUDA unless
    named) at mpeg4.DEFAULT_QSCALE."""
    if len(frames) == 0:
        raise ValueError("no frames to write")
    dev = resolve_device(device)
    frames = _device_frames(frames, dev)
    h, w = frames[0].shape[:2]
    for f in frames:
        if tuple(f.shape) != (h, w, 3):
            raise ValueError(f"frame of shape {tuple(f.shape)}, expected "
                             f"{(h, w, 3)}")
    samples, sync, dsi, _ = mpeg4.encode(frames, fps)
    mp4.write_mp4(video_path, samples, sync, w, h, fps, dsi)


def save_frames_as_video(
    frames, video_path: str, fps: int = 25, *, codec: str = "raw",
    device: DeviceLike = None,
) -> None:
    """Write float [0, 1] or uint8 RGB frames (H, W, 3) at `fps`: for an
    .mp4 name as `mp4v` (encoded on `device`; `codec` is ignored), else
    as an AVI, uncompressed, or with codec "mjpg" as motion JPEG encoded by nvJPEG on
    `device` (CUDA unless named; frames on the card are encoded where they
    lie)."""
    if is_mp4_name(video_path):
        _save_mp4(frames, video_path, fps, device)
        return
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}; one of {CODECS}")
    if len(frames) == 0:
        raise ValueError("no frames to write")
    if codec == "mjpg":
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise RuntimeError(_NO_MJPG_CPU)
        bodies = []
        for frame in frames:
            if not (isinstance(frame, torch.Tensor)
                    and frame.dtype == torch.uint8):
                frame = torch.from_numpy(_to_uint8(frame))
            bodies.append(encode_jpeg(frame.to(dev)))
        h, w = frames[0].shape[:2]
        write_avi(video_path, bodies, w, h, fps, "mjpg")
        return
    first = _to_uint8(frames[0])
    h, w = first.shape[:2]
    bodies = []
    for frame in frames:
        f = _to_uint8(frame)
        if f.shape != (h, w, 3):
            raise ValueError(f"frame of shape {f.shape}, expected {(h, w, 3)}")
        bodies.append(_raw_body(f, h, w))
    write_avi(video_path, bodies, w, h, fps, "raw")


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


def read_avi(video_path: str, max_frames: Optional[int] = None):
    """read_avi_stream without the fourcc."""
    return read_avi_stream(video_path, max_frames)[:4]


def read_avi_stream(video_path: str, max_frames: Optional[int] = None):
    """The coded frames of an AVI: (codec "raw", "mjpg" or "mpeg4",
    width, height, list of each frame's bytes; an MPEG-4 stream's every
    chunk, whatever `max_frames`, since its display order needs them,
    fourcc). A raw height below zero marks top-down rows. MPEG-4 Part 2
    extra data in `strf` (the VOL, where the file keeps it there) comes
    before the first frame's bytes, where FFmpeg's decoder reads it
    too. Another codec raises naming its fourcc."""
    data = Path(video_path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{video_path}: not an AVI file")
    width = height = codec = None
    extra = fourcc_of = b""
    frames: List[bytes] = []
    for fourcc, lo, hi in _walk(data, 12, len(data)):
        if fourcc == b"strf":
            size, width, height, _, bits, comp = struct.unpack(
                "<IiiHHI", data[lo: lo + 20])
            fourcc_of = struct.pack("<I", comp)
            if comp == _MJPG:
                codec = "mjpg"
            elif comp in _MPEG4:
                codec = "mpeg4"
                extra = data[lo + 40: min(lo + size, hi)] if size > 40 \
                    else b""
            elif bits == 24 and comp == 0:
                codec = "raw"
            else:
                name = struct.pack("<I", comp).decode("latin-1")
                raise ValueError(
                    f"{video_path}: AVI video codec {name!r}; the port "
                    f"reads uncompressed 24-bit, motion JPEG and MPEG-4 "
                    f"Part 2 ({b', '.join(MPEG4_FOURCCS).decode()}) "
                    f"frames. Others wait for their own decoder "
                    f"(ROADMAP.md, Queue 1 item 7b)")
        elif fourcc in (b"00db", b"00dc"):
            if width is None:
                raise ValueError(f"{video_path}: frames before strf")
            if (max_frames is not None and len(frames) >= max_frames
                    and codec != "mpeg4"):
                break
            frames.append(data[lo:hi])
    if codec is None:
        raise ValueError(f"{video_path}: no video stream format")
    if extra and frames:
        frames[0] = extra + frames[0]
    return codec, width, height, frames, fourcc_of


def _decode_raw(body: bytes, width: int, height: int) -> np.ndarray:
    h, w = abs(height), width
    row = (w * 3 + 3) & ~3
    img = np.frombuffer(body[: row * h], np.uint8)
    img = img.reshape(h, row)[:, : w * 3].reshape(h, w, 3)
    if height > 0:  # bottom-up rows
        img = img[::-1]
    return np.ascontiguousarray(img[..., ::-1])


def _mpeg4_frames(bodies: Sequence[bytes], dev: torch.device,
                  max_frames: Optional[int] = None,
                  fourcc: bytes = b"") -> torch.Tensor:
    """MPEG-4 Part 2 frames of an AVI (the VOL in the first chunk)."""
    if not bodies:
        raise ValueError("an MPEG-4 AVI without frames")
    vol = mpeg4.parse_vol(bodies[0])
    return mpeg4.decode(bodies, vol, dev, max_frames=max_frames,
                        fourcc=fourcc)


def decode_frames(codec: str, width: int, height: int,
                  bodies: Sequence[bytes], device: DeviceLike = None
                  ) -> Union[List[np.ndarray], torch.Tensor]:
    """Frames of `read_avi`: raw ones as a list of uint8 RGB arrays when
    no device or the CPU is named, else (and motion JPEG and MPEG-4
    always, decoded on the CUDA device unless the CPU is named) one (N,
    H, W, 3) uint8 tensor on the device."""
    if codec == "mpeg4":
        return _mpeg4_frames(bodies, resolve_device(device))
    if codec == "mjpg":
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise RuntimeError(_NO_MJPG_CPU)
        if not bodies:
            return torch.empty((0, abs(height), width, 3), dtype=torch.uint8,
                               device=dev)
        return torch.stack(decode_jpeg_bytes(bodies, dev))
    frames = [_decode_raw(b, width, height) for b in bodies]
    if device is None or torch.device(device).type == "cpu":
        return frames
    dev = resolve_device(device)
    if not frames:
        return torch.empty((0, abs(height), width, 3), dtype=torch.uint8,
                           device=dev)
    return torch.from_numpy(np.stack(frames)).to(dev)


def _mp4_decoder(video_path: str):
    """The decoder of an MP4's video track, chosen by the track's codec:
    io/mpeg4 for `mp4v` (its VOL checked against the track), io/h264 for
    `avc1`/`avc3`. Returns (decode, iter_decode) bound to the track, each
    to be called with the device (decode also with `max_frames`)."""
    track = mp4.read_mp4(video_path)
    if track.codec != "mp4v":
        config = h264.parse_avcc(track.dsi)
        return (functools.partial(h264.decode, track.samples, config),
                functools.partial(h264.iter_decode, track.samples, config))
    vol = mpeg4.parse_vol(track.dsi)
    if (vol.width, vol.height) != (track.width, track.height):
        raise ValueError(f"{video_path}: the VOL's {vol.width}x{vol.height}"
                         f" differs from the track's {track.width}x"
                         f"{track.height}")
    kw = dict(sync=track.sync, headers=track.dsi)
    return (functools.partial(mpeg4.decode, track.samples, vol, **kw),
            functools.partial(mpeg4.iter_decode, track.samples, vol, **kw))


def _is_mp4(video_path: str) -> bool:
    kind = mp4.sniff(video_path)
    if kind is None:
        raise ValueError(f"{video_path}: neither an MP4 nor an AVI file")
    return kind == "mp4"


def read_video_frames(
    video_path: str, max_frames: Optional[int] = None,
    device: DeviceLike = None,
) -> Union[List[np.ndarray], torch.Tensor]:
    """Read a video's frames (the first `max_frames` in display order),
    its format found by content. MPEG-4 Part 2, in an MP4 or an AVI, and
    H.264 in an MP4 decode on `device` (CUDA unless named) into one (N,
    H, W, 3) uint8 tensor. An uncompressed AVI gives a list of uint8 RGB
    arrays when no device or the CPU is named; with a CUDA device (which
    motion JPEG needs, and takes when none is named) one (N, H, W, 3)
    uint8 tensor on the card."""
    if _is_mp4(video_path):
        decode, _ = _mp4_decoder(video_path)
        return decode(resolve_device(device), max_frames=max_frames)
    codec, width, height, bodies, fourcc = read_avi_stream(video_path,
                                                           max_frames)
    if codec == "mpeg4":
        return _mpeg4_frames(bodies, resolve_device(device), max_frames,
                             fourcc)
    return decode_frames(codec, width, height, bodies, device)


def video_frame_chunks(video_path: str, chunk_frames: int,
                       device: DeviceLike = None) -> Iterator[torch.Tensor]:
    """A video's frames in chunks of at most `chunk_frames`, each one
    (n, H, W, 3) uint8 tensor on `device` (CUDA unless named), decoded
    chunk by chunk (MPEG-4 in batches that start at its key frames where
    they can, the last anchor carried between them; H.264 likewise from
    its IDR pictures, the reference pictures still held carried)."""
    dev = resolve_device(device)
    parts = None
    if _is_mp4(video_path):
        _, iter_decode = _mp4_decoder(video_path)
        parts = iter_decode(dev)
    else:
        codec, width, height, bodies, fourcc = read_avi_stream(video_path)
        if codec == "mpeg4":
            parts = mpeg4.iter_decode(bodies, mpeg4.parse_vol(bodies[0]),
                                      dev, fourcc=fourcc)
    if parts is not None:
        pending: List[torch.Tensor] = []
        held = 0
        for part in parts:
            pending.append(part)
            held += part.shape[0]
            while held >= chunk_frames:
                whole = torch.cat(pending)
                yield whole[:chunk_frames]
                pending, held = [whole[chunk_frames:]], held - chunk_frames
        if held:
            yield torch.cat(pending)
        return
    for lo in range(0, len(bodies), chunk_frames):
        part = decode_frames(codec, width, height,
                             bodies[lo: lo + chunk_frames], dev)
        if isinstance(part, list):
            part = torch.from_numpy(np.stack(part))
        yield part


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
