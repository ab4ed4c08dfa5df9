"""Write the H.264 Constrained Baseline fixtures of the port's decoder and
cv2's decode of each.

    python tools/make_h264_fixture.py

Runs off the card: it needs cv2, the JAX package's environment and
FFmpeg 5's `libavcodec.so.59` with its `libx264` encoder, driven through
ctypes as tools/make_asp_fixture.py drives it. Writes under
tests/data_torch/, each from `faceoff_tpu_torch.data.synthetic.
video_frames` with a fixed seed:

  h264_cb.mp4        avc1; profile=baseline, ref=3, keyint 12 (two IDRs),
                     default deblocking, every partition down to 4 x 4;
                     104 x 104 (the SPS crops 112 x 112), 24 frames, a
                     face that moves fast and a second clip pasted over
                     parts of some frames, so that P pictures hold intra
                     macroblocks
  h264_slices.mp4    avc1; slices=3, deblock=-2:1, constrained-intra=1;
                     104 x 104, 24 frames
  h264_avc3_vui.mp4  avc3: no parameter sets in the avcC, SPS and PPS in
                     band before every IDR (repeat-headers); fullrange=on,
                     colormatrix=bt709, no-deblock; 104 x 104, 12 frames
  h264_720p.mp4      avc1; 1280 x 720 (the SPS crops 1280 x 736), 24
                     frames (the clip drawn at 360 px and scaled up), the
                     least qp from 24 up that keeps the file under 300 KB

The MP4s hold one track with no edit list, the samples' NAL units behind
4-byte lengths. Beside each file an .npz holds cv2's RGB decode of it,
read through `faceoff_tpu.io.video.read_video_frames`, as digests:
`sha256` (one digest of each decoded frame's bytes), `count` and `shape`.
"""

from __future__ import annotations

import struct
import sys
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

from make_asp_fixture import OUT, FPS, _clip, _store, encode  # noqa: E402
from faceoff_tpu_torch.io import mp4  # noqa: E402

MAX_720P_BYTES = 300_000
_BASE = ("ref=3:keyint=12:min-keyint=12:scenecut=0:bframes=0:"
         "partitions=all")


def annexb_units(data: bytes) -> List[bytes]:
    """The NAL units of an Annex B byte stream (start codes dropped)."""
    out, i = [], data.find(b"\0\0\1")
    while i >= 0:
        j = data.find(b"\0\0\1", i + 3)
        unit = data[i + 3: j if j >= 0 else len(data)]
        out.append(unit.rstrip(b"\0") if j >= 0 else unit)
        i = j
    return [u for u in out if u]


def avcc(sps: Sequence[bytes], pps: Sequence[bytes], profile: bytes
         ) -> bytes:
    """An AVCDecoderConfigurationRecord with 4-byte NAL lengths."""
    body = bytes([1, profile[0], profile[1], profile[2], 0xFF,
                  0xE0 | len(sps)])
    body += b"".join(struct.pack(">H", len(s)) + s for s in sps)
    body += bytes([len(pps)]) + b"".join(struct.pack(">H", len(p)) + p
                                         for p in pps)
    return body


def write_mp4_avc(path: Path, samples: Sequence[bytes], sync: Sequence[bool],
                  width: int, height: int, config: bytes, kind: bytes
                  ) -> None:
    """One `avc1`/`avc3` track: the port's mp4v writer, its sample entry
    then replaced by `kind` with an `avcC` box holding `config`."""
    mp4.write_mp4(str(path), samples, sync, width, height, FPS, b"\0")
    data = bytearray(path.read_bytes())
    at = data.index(b"mp4v") - 4
    size = struct.unpack(">I", data[at: at + 4])[0]
    old = bytes(data[at: at + size])
    visual = old[8: 8 + 78]
    entry = mp4._box(kind, visual, mp4._box(b"avcC", config))
    data[at: at + size] = entry
    grow = len(entry) - size
    stsd = data.index(b"stsd") - 4
    for box in (b"moov", b"trak", b"mdia", b"minf", b"stbl"):
        b = data.index(box, data.index(b"moov") - 4) - 4
        data[b: b + 4] = struct.pack(">I", struct.unpack(
            ">I", data[b: b + 4])[0] + grow)
    data[stsd: stsd + 4] = struct.pack(">I", struct.unpack(
        ">I", data[stsd: stsd + 4])[0] + grow)
    path.write_bytes(bytes(data))


def make(path: Path, frames: np.ndarray, params: str, in_band: bool,
         extra: dict = None) -> Tuple[int, int]:
    """Encode `frames` with libx264 (`params` its x264-params) into an
    avc1 MP4 (or with `in_band` an avc3 one whose avcC holds no parameter
    sets); returns (bytes, cv2's frame count)."""
    h, w = frames.shape[1:3]
    opts = {"profile": "baseline", "x264-params": params}
    opts.update(extra or {})
    packets, extradata = encode(frames, "libx264", opts,
                                global_header=not in_band)
    head = annexb_units(extradata)
    sps = [u for u in head if u[0] & 0x1F == 7]
    pps = [u for u in head if u[0] & 0x1F == 8]
    samples = []
    for body, _, _, _ in packets:
        units = annexb_units(body)
        if not in_band:
            units = [u for u in units if u[0] & 0x1F not in (7, 8)]
        else:
            sps = sps or [u for u in units if u[0] & 0x1F == 7]
        samples.append(b"".join(struct.pack(">I", len(u)) + u
                                for u in units))
    sync = [p[3] for p in packets]
    config = avcc([] if in_band else sps, [] if in_band else pps,
                  sps[0][1:4])
    write_mp4_avc(path, samples, sync, w, h, config,
                  b"avc3" if in_band else b"avc1")
    return path.stat().st_size, _store(path)


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    small = _clip(24, 104, 104, 31)
    # a second clip pasted over the left half of frames 5-8 and 17-19:
    # new content that P pictures code as intra macroblocks
    other = _clip(24, 104, 104, 33)
    small[5:9, :, :56] = other[5:9, :, :56]
    small[17:20, 40:, :] = other[17:20, 40:, :]
    fast = np.concatenate([small[::2], small[1::2][::-1]])
    plans = [
        ("h264_cb.mp4", fast, _BASE + ":qp=26", False, None),
        ("h264_slices.mp4", small, _BASE + ":qp=24:slices=3:deblock=-2,1"
         ":constrained-intra=1", False, None),
        ("h264_avc3_vui.mp4", small[:12], _BASE + ":qp=28:repeat-headers=1"
         ":fullrange=on:colormatrix=bt709:no-deblock=1", True,
         {"color_range": "pc", "colorspace": "bt709"}),
    ]
    for name, frames, params, in_band, extra in plans:
        size, count = make(OUT / name, frames, params, in_band, extra)
        print(name, size, "bytes; cv2 reads", count)
    big = _clip(24, 720, 1280, 32, draw=360)
    for qp in range(24, 52, 2):
        size, count = make(OUT / "h264_720p.mp4", big,
                           _BASE + f":qp={qp}", False, None)
        if size < MAX_720P_BYTES:
            break
    print("h264_720p.mp4", size, "bytes at qp", qp, "; cv2 reads", count)


if __name__ == "__main__":
    main()
