"""Image files without an image library: PNG through numpy and zlib, JPEG
through nvJPEG on CUDA.

`read_png` decodes 8-bit, non-interlaced grey and RGB PNGs, with all five
row filters (None, Sub, Up, Average, Paeth). Runs of None and Sub rows
decode together as one numpy cumulative sum, Up rows a row at a time;
Average and Paeth rows depend on the pixel
to their left and decode byte by byte, which is slow but exact (libpng,
and so cv2, writes such rows). `write_png` writes None or Sub rows; Sub
rows decode as a cumulative sum, so the port's own files read fast.

JPEG goes through nvJPEG, the CUDA toolkit's codec, through the C shim
`csrc/jpeg.cu` (built at first use by `ops/cuda_build.py`, linked with
-lnvjpeg), on a CUDA device: `decode_jpeg_bytes` (nvJPEG's batched
decoder), `decode_jpeg_batch` (files, one a call of it) and
`decode_jpeg_window` (one batched call; the window padded and resized on
the card) return RGB interleaved uint8 tensors on the card; `encode_jpeg`
and `write_jpeg` encode at cv2.imwrite's defaults (quality 95, 4:2:0). Each calling thread has its own nvJPEG
state, so loader threads decode at once. There is no JPEG codec on the
CPU: asked for one, these raise.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from faceoff_tpu_torch.device import DeviceLike, resolve_device
from faceoff_tpu_torch.ops import cuda_build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # colour type -> samples a pixel
JPEG_SOURCE = cuda_build.CSRC / "jpeg.cu"

# JPEG images decoded and encoded through nvJPEG in this process
jpeg_decodes = 0
jpeg_encodes = 0

_jpeg_lib: Optional[ctypes.CDLL] = None
_jpeg_lock = threading.Lock()  # loading the shim
_count_lock = threading.Lock()  # the counts above

PathLike = Union[str, Path]


# -- PNG --------------------------------------------------------------------


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length: pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends before its IEND chunk")


def _unfilter_slow(kind: int, raw: np.ndarray, prior: np.ndarray,
                   bpp: int) -> np.ndarray:
    """Average (3) or Paeth (4) rows, byte by byte."""
    line = bytearray(raw.tobytes())
    up = prior.tobytes()
    n = len(line)
    for i in range(n):
        left = line[i - bpp] if i >= bpp else 0
        if kind == 3:
            pred = (left + up[i]) >> 1
        else:
            above, corner = up[i], (up[i - bpp] if i >= bpp else 0)
            p = left + above - corner
            pa, pb, pc = abs(p - left), abs(p - above), abs(p - corner)
            if pa <= pb and pa <= pc:
                pred = left
            elif pb <= pc:
                pred = above
            else:
                pred = corner
        line[i] = (line[i] + pred) & 0xFF
    return np.frombuffer(bytes(line), np.uint8)


def read_png(path: PathLike) -> np.ndarray:
    """Decode an 8-bit non-interlaced grey or RGB PNG: (H, W) or
    (H, W, 3) uint8."""
    data = Path(path).read_bytes()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced grey or RGB PNGs are read "
            f"(bit depth {depth}, colour type {colour}, interlace "
            f"{interlace})")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{height} rows of {stride + 1}")
    raw = raw.reshape(height, stride + 1)
    kinds, rows = raw[:, 0], raw[:, 1:]
    if kinds.max() > 4:
        raise ValueError(f"{path}: unknown PNG row filter {kinds.max()}")
    out = np.empty((height, stride), np.uint8)
    y = 0
    while y < height:
        kind = int(kinds[y])
        if kind <= 1:
            # a run of None and Sub rows needs no prior row: decode at once
            end = y + 1
            while end < height and kinds[end] <= 1:
                end += 1
            block = rows[y:end]
            sub = kinds[y:end] == 1
            out[y:end] = block
            out[y:end][sub] = np.cumsum(
                block[sub].reshape(-1, width, bpp), axis=1,
                dtype=np.uint8).reshape(-1, stride)
            y = end
            continue
        prior = out[y - 1] if y else np.zeros(stride, np.uint8)
        if kind == 2:
            out[y] = rows[y] + prior
        else:
            out[y] = _unfilter_slow(kind, rows[y], prior, bpp)
        y += 1
    return out.reshape(height, width, bpp)[..., 0] if bpp == 1 else \
        out.reshape(height, width, bpp)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: PathLike, image: np.ndarray, *,
              row_filter: str = "sub") -> None:
    """Write a uint8 (H, W) grey or (H, W, 3) RGB image as PNG, every row
    with the None or the Sub filter."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    height, width = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    rows = img.reshape(height, width, bpp)
    if row_filter == "sub":
        body = np.diff(rows, axis=1, prepend=np.zeros((height, 1, bpp),
                                                      np.uint8))
        kind = 1
    elif row_filter == "none":
        body, kind = rows, 0
    else:
        raise ValueError(f"unknown row filter {row_filter!r}")
    lines = np.concatenate(
        [np.full((height, 1), kind, np.uint8), body.reshape(height, -1)],
        axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 0 if bpp == 1 else 2,
                       0, 0, 0)
    Path(path).write_bytes(
        PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(lines.tobytes()))
        + _chunk(b"IEND", b""))


# -- JPEG through nvJPEG ----------------------------------------------------


# |nvJPEG - cv2| in uint8 levels, (max, mean) by chroma sampling, set from
# the card (PERF.md: 4 / 0.53 and 66 / 5.01; chip_smoke.py and
# tests/test_torch_cuda.py hold the fixtures to it). At 4:4:4 the decoders
# differ only in their integer IDCTs and colour conversion, a few levels.
# At 4:2:0 they also upsample the half-resolution chroma differently
# (cv2's libjpeg-turbo interpolates it with its "fancy" triangle filter),
# so at a sharp colour edge of the face a pixel can take its chroma from
# the other side of the edge: up to the edge's contrast there, a few
# levels on average. A wrong channel order, pitch or sampling shows as
# tens of levels on average.
JPEG_TOL = {"444": (8, 1.0), "420": (96, 6.5)}
# cv2.imwrite's defaults, which the encoder takes: quality 95, 4:2:0
JPEG_QUALITY = 95
_CSS_420 = 2  # nvjpegChromaSubsampling_t NVJPEG_CSS_420


def build_jpeg() -> Path:
    """Compile the nvJPEG shim unless this source is already built."""
    return cuda_build.build(JPEG_SOURCE, "faceoff_jpeg", libs=("nvjpeg",))


def load_jpeg() -> ctypes.CDLL:
    """Build if needed, then load the shim once per process."""
    global _jpeg_lib
    with _jpeg_lock:
        if _jpeg_lib is None:
            lib = ctypes.CDLL(str(build_jpeg()))
            lib.faceoff_jpeg_info.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t] + [ctypes.c_void_p] * 4
            lib.faceoff_jpeg_decode_batch.argtypes = [
                ctypes.c_int] + [ctypes.c_void_p] * 5
            lib.faceoff_jpeg_encode.argtypes = [
                ctypes.c_void_p] + [ctypes.c_int] * 5 + [
                ctypes.c_void_p, ctypes.c_void_p]
            lib.faceoff_jpeg_encode_take.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
            for fn in (lib.faceoff_jpeg_info, lib.faceoff_jpeg_decode_batch,
                       lib.faceoff_jpeg_encode,
                       lib.faceoff_jpeg_encode_take):
                fn.restype = ctypes.c_int
            _jpeg_lib = lib
    return _jpeg_lib


def _raise(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"nvJPEG {what} failed with status {status}")


def jpeg_info(data: bytes) -> dict:
    """width, height, components and nvJPEG's chroma subsampling code of
    one JPEG's bytes (needs the CUDA build)."""
    lib = load_jpeg()
    vals = [ctypes.c_int() for _ in range(4)]
    _raise(lib.faceoff_jpeg_info(data, len(data),
                                 *[ctypes.byref(v) for v in vals]),
           "nvjpegGetImageInfo")
    w, h, comps, sub = (v.value for v in vals)
    return {"width": w, "height": h, "components": comps,
            "subsampling": sub}


def _check_out(out: torch.Tensor) -> None:
    if out.device.type != "cuda" or out.dtype != torch.uint8 or \
            out.dim() != 3 or out.shape[2] != 3 or not out.is_contiguous():
        raise ValueError("JPEG frames decode into contiguous (H, W, 3) "
                         "uint8 CUDA tensors")


def _cuda_device(device: DeviceLike, what: str) -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(
            f"JPEG frames {what} through nvJPEG on a CUDA device only; the "
            f"port has no JPEG codec on the CPU (write the frames as PNG "
            f"to read them there)")
    return dev


def decode_jpeg_bytes(datas: Sequence[bytes],
                      device: DeviceLike = None) -> List[torch.Tensor]:
    """Decode JPEG images' bytes with nvJPEG's batched decoder into RGB
    (H, W, 3) uint8 tensors on `device` (CUDA unless named). Waits for
    the decodes before it returns."""
    dev = _cuda_device(device, "decode")
    out = []
    for data in datas:
        info = jpeg_info(data)
        out.append(torch.empty((info["height"], info["width"], 3),
                               dtype=torch.uint8, device=dev))
    _decode_batch(list(datas), out)
    return out


def _decode_batch(datas: List[bytes], outs: List[torch.Tensor]) -> None:
    global jpeg_decodes
    n = len(datas)
    if n == 0:
        return
    for o in outs:
        _check_out(o)
    lib = load_jpeg()
    ptrs = (ctypes.c_char_p * n)(*datas)
    lengths = (ctypes.c_size_t * n)(*[len(d) for d in datas])
    dst = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    pitches = (ctypes.c_int * n)(*[o.shape[1] * 3 for o in outs])
    dev = outs[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        _raise(lib.faceoff_jpeg_decode_batch(
            n, ctypes.cast(ptrs, ctypes.c_void_p), lengths, dst, pitches,
            stream), "batched decode")
    with _count_lock:
        jpeg_decodes += n


def decode_jpeg_batch(paths: Sequence[PathLike],
                      device: DeviceLike = None) -> List[torch.Tensor]:
    """Decode JPEG files with nvJPEG into RGB interleaved (H, W, 3) uint8
    tensors on `device` (CUDA unless named), one file a call of
    `decode_jpeg_bytes`. Waits for the decodes before it returns."""
    dev = _cuda_device(device, "decode")
    return [decode_jpeg_bytes([Path(p).read_bytes()], dev)[0]
            for p in paths]


def decode_jpeg_window(paths: Sequence[PathLike], resolution: int,
                       device: DeviceLike = None) -> torch.Tensor:
    """A window of JPEG frames as one (N, res, res, 3) uint8 tensor on
    `device` (CUDA unless named), the counterpart of the JAX package's
    native `fo_load_frames`: nvJPEG's batched decoder, then each frame
    padded to a square and resized on the card with
    `geometry.resize_frame`'s integers. Frames already res x res decode
    straight into the window."""
    from faceoff_tpu_torch.data.geometry import resize_frame_tensor

    dev = _cuda_device(device, "decode")
    datas = [Path(p).read_bytes() for p in paths]
    window = torch.empty((len(datas), resolution, resolution, 3),
                         dtype=torch.uint8, device=dev)
    outs, resized = [], []
    for i, data in enumerate(datas):
        info = jpeg_info(data)
        if (info["height"], info["width"]) == (resolution, resolution):
            outs.append(window[i])
        else:
            outs.append(torch.empty((info["height"], info["width"], 3),
                                    dtype=torch.uint8, device=dev))
            resized.append(i)
    _decode_batch(datas, outs)
    for i in resized:
        window[i] = resize_frame_tensor(outs[i], resolution)
    return window


def encode_jpeg(frame, quality: int = JPEG_QUALITY,
                device: DeviceLike = None) -> bytes:
    """One (H, W, 3) uint8 RGB frame as JPEG bytes, encoded by nvJPEG on
    the card at `quality` with 4:2:0 chroma (cv2.imwrite's defaults). A
    CUDA tensor is encoded where it lies; a numpy array or CPU tensor is
    copied to `device` (CUDA unless named) first."""
    global jpeg_encodes
    if isinstance(frame, torch.Tensor) and frame.device.type == "cuda":
        img = frame
    else:
        dev = _cuda_device(device, "encode")
        img = torch.as_tensor(np.asarray(frame) if not isinstance(
            frame, torch.Tensor) else frame).to(dev)
    if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, got "
                         f"{tuple(img.shape)} {img.dtype}")
    img = img.contiguous()
    lib = load_jpeg()
    h, w = img.shape[:2]
    length = ctypes.c_size_t()
    stream = torch.cuda.current_stream(img.device).cuda_stream
    with torch.cuda.device(img.device):
        _raise(lib.faceoff_jpeg_encode(
            img.data_ptr(), w, h, w * 3, quality, _CSS_420,
            ctypes.byref(length), stream), "encode")
        buf = ctypes.create_string_buffer(length.value)
        _raise(lib.faceoff_jpeg_encode_take(buf, length.value, stream),
               "bitstream")
    with _count_lock:
        jpeg_encodes += 1
    return buf.raw[: length.value]


def write_jpeg(path: PathLike, frame, quality: int = JPEG_QUALITY,
               device: DeviceLike = None) -> None:
    """Write one (H, W, 3) uint8 RGB frame as a JPEG file through
    `encode_jpeg`."""
    Path(path).write_bytes(encode_jpeg(frame, quality, device))


def read_image(path: PathLike, device: DeviceLike = None) -> np.ndarray:
    """An RGB (H, W, 3) uint8 frame from a PNG (grey replicated to three
    channels) or a JPEG decoded by nvJPEG on `device` (CUDA unless named;
    a JPEG on the CPU raises, as `decode_jpeg_batch` does)."""
    path = str(path)
    if path.lower().endswith((".jpg", ".jpeg")):
        return decode_jpeg_batch([path], device)[0].cpu().numpy()
    img = read_png(path)
    return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img
