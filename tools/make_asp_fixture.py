"""Write the MPEG-4 Advanced Simple Profile fixtures of the port's decoder
and cv2's decode of each.

    python tools/make_asp_fixture.py

Runs off the card: it needs cv2, the JAX package's environment and
FFmpeg 5's `libavcodec.so.59` (its `mpeg4` and `libxvid` encoders, driven
through ctypes). Writes under tests/data_torch/, each from
`faceoff_tpu_torch.data.synthetic.video_frames` with a fixed seed:

  asp_bframes.mp4     mpeg4, bf=2, H.263 quantisation, half-pel; 104 x 104,
                      24 frames, g=12 (direct mode, skipped B macroblocks,
                      edges that are no multiple of 16, two GOPs)
  asp_qpel_mpegq.mp4  mpeg4, bf=2, +qpel, mpeg_quant=1; 104 x 104, 24 frames
  asp_xvid.avi        libxvid, bf=2, mpeg_quant=1, +qpel: fourcc XVID, the
                      packed bitstream libxvid hands out for AVI (a P-VOP
                      and a B-VOP in one chunk, then an N-VOP placeholder),
                      Xvid's user data (FFmpeg's Xvid IDCT)
  asp_720p.mp4        mpeg4, bf=2, +qpel, mpeg_quant=1; 1280 x 720, 12
                      frames (the clip drawn at 360 px and scaled up, as
                      footage is smoother than the generator's noise at
                      720p), the least qscale from 4 up that keeps the
                      file under 300 KB

The MP4s carry the headers in the esds (the encoder's global header, as
FFmpeg's mp4 muxer asks for it) and `ctts`/`edts` giving display order as
FFmpeg's muxer writes them for B-frames. Beside each file an .npz holds
cv2's RGB decode of it, read through `faceoff_tpu.io.video.
read_video_frames`, as digests (the port decodes all four bit for bit as
cv2 does, and the frames themselves would not fit the tests' data
budget): `sha256`, one digest of each decoded frame's bytes, `count` and
`shape`.
"""

from __future__ import annotations

import ctypes
import hashlib
import struct
import sys
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from faceoff_tpu.io.video import read_video_frames  # noqa: E402
from faceoff_tpu_torch.data.synthetic import video_frames  # noqa: E402
from faceoff_tpu_torch.io import mp4, mpeg4  # noqa: E402
from faceoff_tpu_torch.io import video as tvideo  # noqa: E402

OUT = REPO / "tests" / "data_torch"
FPS = 25
MAX_720P_BYTES = 300_000

_P = ctypes.c_void_p
_AV = ctypes.CDLL("libavcodec.so.59")
_UTIL = ctypes.CDLL("libavutil.so.57")
for _name, _res, _args in (
        ("avcodec_find_encoder_by_name", _P, [ctypes.c_char_p]),
        ("avcodec_alloc_context3", _P, [_P]),
        ("avcodec_open2", ctypes.c_int, [_P, _P, _P]),
        ("avcodec_send_frame", ctypes.c_int, [_P, _P]),
        ("avcodec_receive_packet", ctypes.c_int, [_P, _P]),
        ("avcodec_free_context", None, [_P]),
        ("avcodec_parameters_alloc", _P, []),
        ("avcodec_parameters_from_context", ctypes.c_int, [_P, _P]),
        ("av_packet_alloc", _P, []),
        ("av_packet_unref", None, [_P])):
    _fn = getattr(_AV, _name)
    _fn.restype, _fn.argtypes = _res, _args
for _name, _res, _args in (
        ("av_opt_set", ctypes.c_int,
         [_P, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]),
        ("av_frame_alloc", _P, []),
        ("av_frame_get_buffer", ctypes.c_int, [_P, ctypes.c_int]),
        ("av_frame_free", None, [_P])):
    _fn = getattr(_UTIL, _name)
    _fn.restype, _fn.argtypes = _res, _args

_SEARCH_CHILDREN = 1
_EAGAIN, _EOF = -11, -0x20464F45  # AVERROR(EAGAIN), AVERROR_EOF
_PIX_YUV420P = 0
# AVFrame (libavutil 57): data[8] at 0, linesize[8] at 64, width, height
# at 104, 108, format at 116, pts at 136. AVPacket (libavcodec 59): pts at
# 8, dts at 16, data at 24, size at 32, flags at 40. AVCodecParameters:
# extradata at 16, extradata_size at 24.


def _i32(p: int, off: int) -> int:
    return ctypes.c_int32.from_address(p + off).value


def _set_i32(p: int, off: int, v: int) -> None:
    ctypes.c_int32.from_address(p + off).value = v


def encode(frames: np.ndarray, codec: str, opts: dict, global_header: bool
           ) -> Tuple[List[Tuple[bytes, int, int, bool]], bytes]:
    """Encode (N, H, W, 3) uint8 RGB frames with libavcodec's `codec` and
    AVOptions `opts`: ([(packet, pts, dts, key)], extradata)."""
    n, h, w, _ = frames.shape
    enc = _AV.avcodec_find_encoder_by_name(codec.encode())
    if not enc:
        raise RuntimeError(f"no encoder {codec}")
    ctx = _AV.avcodec_alloc_context3(enc)
    base = {"video_size": f"{w}x{h}", "pixel_format": "yuv420p",
            "time_base": f"1/{FPS}",
            "threads": "1"}
    if global_header:
        base["flags"] = "+global_header"
    for k, v in list(base.items()) + list(opts.items()):
        r = _UTIL.av_opt_set(ctx, k.encode(), str(v).encode(),
                             _SEARCH_CHILDREN)
        if r < 0:
            raise RuntimeError(f"{codec}: option {k}={v} refused ({r})")
    r = _AV.avcodec_open2(ctx, enc, None)
    if r < 0:
        raise RuntimeError(f"avcodec_open2({codec}) failed ({r})")
    frame = _UTIL.av_frame_alloc()
    pkt = _AV.av_packet_alloc()
    out: List[Tuple[bytes, int, int, bool]] = []

    def drain():
        while True:
            r = _AV.avcodec_receive_packet(ctx, pkt)
            if r in (_EAGAIN, _EOF):
                return
            if r < 0:
                raise RuntimeError(f"avcodec_receive_packet: {r}")
            data = ctypes.c_void_p.from_address(pkt + 24).value
            size = _i32(pkt, 32)
            pts = ctypes.c_int64.from_address(pkt + 8).value
            dts = ctypes.c_int64.from_address(pkt + 16).value
            key = bool(_i32(pkt, 40) & 1)
            out.append((ctypes.string_at(data, size), pts, dts, key))
            _AV.av_packet_unref(pkt)

    for i in range(n):
        _set_i32(frame, 104, w)
        _set_i32(frame, 108, h)
        _set_i32(frame, 116, _PIX_YUV420P)
        if _UTIL.av_frame_get_buffer(frame, 32) < 0:
            raise RuntimeError("av_frame_get_buffer failed")
        planes = mpeg4.rgb_to_yuv420(torch.from_numpy(frames[i:i + 1]), h,
                                     w)
        for plane, p in enumerate(p[0].numpy() for p in planes):
            dst = ctypes.c_void_p.from_address(frame + 8 * plane).value
            stride = _i32(frame, 64 + 4 * plane)
            for row in range(p.shape[0]):
                ctypes.memmove(dst + row * stride, p[row].ctypes.data,
                               p.shape[1])
        ctypes.c_int64.from_address(frame + 136).value = i
        if _AV.avcodec_send_frame(ctx, frame) < 0:
            raise RuntimeError("avcodec_send_frame failed")
        drain()
        fp = ctypes.c_void_p(frame)
        _UTIL.av_frame_free(ctypes.byref(fp))
        frame = _UTIL.av_frame_alloc()
    _AV.avcodec_send_frame(ctx, None)
    drain()
    par = _AV.avcodec_parameters_alloc()
    _AV.avcodec_parameters_from_context(par, ctx)
    ext = ctypes.c_void_p.from_address(par + 16).value
    extradata = ctypes.string_at(ext, _i32(par, 24)) if ext else b""
    cp = ctypes.c_void_p(ctx)
    _AV.avcodec_free_context(ctypes.byref(cp))
    return out, extradata


def write_mp4_reordered(path: Path, packets, w: int, h: int, dsi: bytes
                        ) -> None:
    """An mp4v MP4 of packets in decode order: the port's writer, then a
    `ctts` (composition offsets pts - dts, shifted to be non-negative,
    as FFmpeg's mov muxer writes them) in the sample table and an `edts`
    whose edit starts at the first displayed frame."""
    samples = [p[0] for p in packets]
    sync = [p[3] for p in packets]
    mp4.write_mp4(str(path), samples, sync, w, h, FPS, dsi)
    pts = np.asarray([p[1] for p in packets], np.int64)
    dts = np.arange(len(packets), dtype=np.int64)
    shift = int(max(0, (dts - pts).max()))
    offs = pts - dts + shift
    runs: List[List[int]] = []
    for o in offs.tolist():
        if runs and runs[-1][1] == o:
            runs[-1][0] += 1
        else:
            runs.append([1, o])
    ctts = mp4._full(b"ctts", 0, 0, struct.pack(">I", len(runs)),
                     b"".join(struct.pack(">II", c, o) for c, o in runs))
    data = bytearray(path.read_bytes())
    n = len(packets)
    elst = mp4._full(b"elst", 0, 0, struct.pack(">IIiHH", 1, n * 1000 // FPS,
                                                 shift, 1, 0))
    edts = mp4._box(b"edts", elst)
    # grow stbl, minf, mdia, trak and moov around the new boxes
    moov = data.index(b"moov") - 4
    stss = data.index(b"stss") - 4
    data[stss:stss] = ctts
    tkhd = data.index(b"tkhd") - 4
    tkhd_end = tkhd + struct.unpack(">I", data[tkhd: tkhd + 4])[0]
    data[tkhd_end:tkhd_end] = edts
    for kind, grow in ((b"moov", len(ctts) + len(edts)),
                       (b"trak", len(ctts) + len(edts)),
                       (b"mdia", len(ctts)), (b"minf", len(ctts)),
                       (b"stbl", len(ctts))):
        at = data.index(kind, moov) - 4
        size = struct.unpack(">I", data[at: at + 4])[0]
        data[at: at + 4] = struct.pack(">I", size + grow)
    path.write_bytes(bytes(data))


def write_avi_mpeg4(path: Path, packets, w: int, h: int,
                    fourcc: bytes = b"XVID") -> None:
    """An AVI of MPEG-4 Part 2 packets, one `00dc` chunk each, as FFmpeg's
    avi muxer stores them (fourcc XVID; BITMAPINFOHEADER with no extra
    data; key frames flagged in idx1)."""
    tag = b"00dc"
    movi, index = [], []
    offset = 4
    for body, _, _, key in packets:
        movi.append(tvideo._chunk(tag, body))
        index.append(struct.pack("<4sIII", tag, 0x10 if key else 0, offset,
                                 len(body)))
        offset += 8 + len(body) + len(body) % 2
    n = len(packets)
    largest = max(len(p[0]) for p in packets)
    avih = struct.pack("<IIIIIIIIII4I", round(1e6 / FPS), largest * FPS, 0,
                       0x10, n, 0, 1, largest, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc.lower()
                       if fourcc == b"XVID" else fourcc, 0, 0, 0, 0, 1, FPS,
                       0, n, largest, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24,
                       struct.unpack("<I", fourcc)[0], w * h * 3, 0, 0, 0, 0)
    hdrl = tvideo._list(b"hdrl", tvideo._chunk(b"avih", avih) + tvideo._list(
        b"strl", tvideo._chunk(b"strh", strh) + tvideo._chunk(b"strf", strf)))
    body = (hdrl + tvideo._list(b"movi", b"".join(movi))
            + tvideo._chunk(b"idx1", b"".join(index)))
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI "
                     + body)


def _store(path: Path) -> int:
    decoded = np.stack(read_video_frames(str(path)))
    digests = np.asarray([hashlib.sha256(f.tobytes()).hexdigest()
                          for f in decoded])
    np.savez_compressed(path.with_suffix(".npz"), sha256=digests,
                        count=np.int64(len(decoded)),
                        shape=np.asarray(decoded.shape[1:], np.int64))
    return len(decoded)


def _clip(n: int, h: int, w: int, seed: int, draw: int = 0) -> np.ndarray:
    """n frames of h x w, drawn at `draw` px (the larger side by default)
    and scaled bilinearly to the larger side."""
    side = max(h, w)
    frames = video_frames(n, draw or side, seed=seed)[0]
    if draw and draw != side:
        frames = torch.nn.functional.interpolate(
            frames.permute(0, 3, 1, 2).float(), size=(side, side),
            mode="bilinear", align_corners=False).round().clamp(0, 255)
        frames = frames.to(torch.uint8).permute(0, 2, 3, 1)
    return np.ascontiguousarray(frames.numpy()[:, :h, :w])


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    small = _clip(24, 104, 104, 21)
    plans = [
        ("asp_bframes.mp4", small, "mpeg4",
         {"bf": 2, "g": 12, "flags": "+qscale", "global_quality": 4 * 118}),
        ("asp_qpel_mpegq.mp4", small, "mpeg4",
         {"bf": 2, "g": 12, "flags": "+qscale+qpel", "mpeg_quant": 1,
          "global_quality": 4 * 118}),
        ("asp_xvid.avi", small, "libxvid",
         {"bf": 2, "g": 12, "mpeg_quant": 1, "flags": "+qscale+qpel",
          "global_quality": 4 * 118}),
    ]
    for name, frames, codec, opts in plans:
        path = OUT / name
        n, h, w, _ = frames.shape
        if name.endswith(".avi"):
            packets, _ = encode(frames, codec, opts, global_header=False)
            write_avi_mpeg4(path, packets, w, h)
        else:
            packets, dsi = encode(frames, codec, opts, global_header=True)
            write_mp4_reordered(path, packets, w, h, dsi)
        count = _store(path)
        print(name, path.stat().st_size, "bytes,", len(packets),
              "packets of", n, "frames; cv2 reads", count)
    big = _clip(12, 720, 1280, 22, draw=360)
    for q in range(4, 32):
        packets, dsi = encode(big, "mpeg4",
                              {"bf": 2, "g": 12, "flags": "+qscale+qpel",
                               "mpeg_quant": 1, "global_quality": q * 118},
                              global_header=True)
        if sum(len(p[0]) for p in packets) < MAX_720P_BYTES - 4096:
            break
    path = OUT / "asp_720p.mp4"
    write_mp4_reordered(path, packets, 1280, 720, dsi)
    count = _store(path)
    print(path.name, path.stat().st_size, "bytes at qscale", q, ";",
          len(packets), "packets; cv2 reads", count)


if __name__ == "__main__":
    main()
