"""H.264 (ISO/IEC 14496-10) Constrained Baseline video, the `avc1`/`avc3`
tracks of MP4 files that cv2's FFmpeg reads for the JAX package
(`faceoff_tpu/io/video.py`), decoded without FFmpeg.

The decoder is split into a host half and four device stages in integer
arithmetic (`ops/h264_cuda.py`):

    samples -> NAL units -> parameter sets and slice headers, picture
    order counts, reference marking and RefPicList0 (scan: sequential,
    cheap) -> each picture's macroblock layer (this module's plain
    parser, or csrc/h264.cu's on host threads) -> records -> H1 residual
    (a batch) -> for each picture in decode order: H2 inter_predict, H3
    intra_reconstruct (a wavefront), H4 deblock (a wavefront) -> crop ->
    RGB

The records of a batch of F pictures with M macroblocks each:
  mb (F, M, MB_FIELDS) int32: kind (H_SKIP, H_INTER, H_I4, H_I16, H_PCM),
      QP_Y (the running QP for skipped and I_PCM macroblocks),
      chroma_qp_index_offset, the Intra16x16 and chroma prediction modes,
      the slice's number in its picture, disable_deblocking_filter_idc,
      FilterOffsetA and B, constrained_intra_pred_flag, the sixteen
      Intra4x4 modes (4 bits each, 4x4 blocks in raster order), the row
      of the I_PCM samples;
  blk (F, M, 16, 4) int32, per 4x4 luma block in raster order: the
      quarter-pel vector (x, y), the reference resolved to a picture
      slot (-1 intra) and total_coeff;
  coef (NB, 16) int16: the levels of each coded block, 4x4 raster order
      (the chroma DC's four first);
  bmap (F, M, 27) int32: the row of coef of each block (-1 none): 0-15
      luma 4x4 in raster order, 16 the Intra16x16 DC, 17/18 the Cb/Cr
      DC, 19-22 the Cb AC, 23-26 the Cr AC (2x2 raster);
  pcm (NP, 384) uint8: I_PCM samples (256 luma, 64 Cb, 64 Cr).
Slots index the batch's planes: the carried reference pictures, then the
batch's own pictures in decode order.

Decoded: I and P slices with CAVLC and the 4x4 transform; several slices
a picture; up to 16 reference frames, long-term references and memory
management operations 1-6; pic_order_cnt_type 0, 1 and 2; frame
cropping; I_PCM; constrained_intra_pred_flag; the loop filter with its
slice offsets, disable_deblocking_filter_idc 0 and 1; parameter sets in
the avcC (avc1) or in band (avc3). Refused by name (ROADMAP.md, Queue 1
item 7b): CABAC, B, SP and SI slices, the 8x8 transform, scaling
matrices, weighted prediction, field coding (PAFF, MBAFF), chroma formats
other than 4:2:0, bit depths above 8, slice groups (FMO), arbitrary
slice order, disable_deblocking_filter_idc 2, gaps in frame_num and
picture order counts that do not rise in decode order between IDRs
(Baseline output is then no longer decode order). Redundant slices are
dropped, as FFmpeg drops them.

The decode is exact (H.264 decoding is bit-exact by the standard): the
port's YUV equals FFmpeg's, and io/mpeg4.yuv420_to_rgb (FFmpeg's fixed
point, limited range) or yuv420_to_rgb_full (full range) gives cv2's RGB
bit for bit.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from faceoff_tpu_torch.io import mpeg4
from faceoff_tpu_torch.io.mpeg4 import BitReader, BitstreamError, Vlc
from faceoff_tpu_torch.ops import h264_cuda as K
from faceoff_tpu_torch.ops.h264_cuda import (BLK_FIELDS, H_I4, H_I16, H_INTER,
                                             H_PCM, H_SKIP, MB_FIELDS, NBLK,
                                             F_ALPHA, F_BETA, F_CIP, F_CMODE,
                                             F_FILTER, F_I16, F_KIND,
                                             F_MODES, F_PCM, F_QP, F_QPC,
                                             F_SLICE)


def _unsupported(what: str) -> BitstreamError:
    return BitstreamError(
        f"H.264 stream uses {what}, which the port's decoder does not read "
        f"(ROADMAP.md, Queue 1 item 7b)")


# --- the bit layer ------------------------------------------------------------

def unescape(nal: bytes) -> bytes:
    """A NAL unit's RBSP: every emulation-prevention byte (the 03 of
    00 00 03) removed, before any bit is read."""
    return nal.replace(b"\0\0\3", b"\0\0") if b"\0\0\3" in nal else nal


def split_sample(sample: bytes, length_size: int) -> List[bytes]:
    """The NAL units of an MP4 sample, each behind a big-endian length of
    `length_size` bytes."""
    out, pos = [], 0
    while pos + length_size <= len(sample):
        n = int.from_bytes(sample[pos: pos + length_size], "big")
        pos += length_size
        if n == 0:
            continue
        if pos + n > len(sample):
            raise BitstreamError(f"NAL unit of {n} bytes overruns its "
                                 f"sample at {pos}")
        out.append(sample[pos: pos + n])
        pos += n
    return out


class Reader(BitReader):
    """An RBSP reader: fixed-length fields, Exp-Golomb ue/se/te, and the
    position of the rbsp_stop_one_bit."""

    def __init__(self, rbsp: bytes, pos: int = 0):
        super().__init__(rbsp, pos)
        end = len(rbsp)
        while end and rbsp[end - 1] == 0:
            end -= 1
        last = rbsp[end - 1] if end else 0
        # the stop bit: the last 1 of the RBSP
        self.trail = end * 8 - 1 - ((last & -last).bit_length() - 1) \
            if end else 0

    def ue(self) -> int:
        v = self.peek(32)
        if v == 0:
            raise BitstreamError(f"Exp-Golomb code too long at bit "
                                 f"{self.pos}")
        lz = 32 - v.bit_length()
        self.pos += lz
        return self.read(lz + 1) - 1

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def te(self, cmax: int) -> int:
        return 1 - self.read(1) if cmax == 1 else self.ue()

    def more_data(self) -> bool:
        return self.pos < self.trail

    def check(self) -> None:
        if self.pos > self.trail:
            raise BitstreamError("slice data overruns its NAL unit")


# --- parameter sets ---------------------------------------------------------------

HIGH_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134,
                 135)


@dataclass
class Sps:
    profile: int
    sps_id: int
    log2_max_frame_num: int
    poc_type: int
    log2_max_poc_lsb: int = 0
    delta_pic_order_always_zero: int = 0
    offset_for_non_ref_pic: int = 0
    offset_for_top_to_bottom_field: int = 0
    offset_for_ref_frame: Tuple[int, ...] = ()
    max_num_ref_frames: int = 0
    mb_width: int = 0
    mb_height: int = 0
    crop: Tuple[int, int, int, int] = (0, 0, 0, 0)  # left right top bottom
    full_range: int = 0
    matrix: int = 2  # matrix_coefficients (2: unspecified)

    @property
    def width(self) -> int:
        return 16 * self.mb_width - 2 * (self.crop[0] + self.crop[1])

    @property
    def height(self) -> int:
        return 16 * self.mb_height - 2 * (self.crop[2] + self.crop[3])


@dataclass
class Pps:
    pps_id: int
    sps_id: int
    bottom_field_pic_order: int
    num_ref_idx_default: int
    pic_init_qp: int
    chroma_qp_index_offset: int
    deblocking_filter_control: int
    constrained_intra_pred: int
    redundant_pic_cnt_present: int


def parse_sps(rbsp: bytes) -> Sps:
    r = Reader(rbsp, 8)
    profile = r.read(8)
    r.read(16)  # constraint flags, level_idc
    sps_id = r.ue()
    if profile in HIGH_PROFILES:
        if r.ue() != 1:
            raise _unsupported("a chroma format other than 4:2:0")
        if r.ue() or r.ue():
            raise _unsupported("bit depths above 8")
        if r.read(1):
            raise _unsupported("the lossless transform bypass")
        if r.read(1):
            raise _unsupported("scaling matrices")
    log2_fn = r.ue() + 4
    sps = Sps(profile, sps_id, log2_fn, r.ue())
    if sps.poc_type == 0:
        sps.log2_max_poc_lsb = r.ue() + 4
    elif sps.poc_type == 1:
        sps.delta_pic_order_always_zero = r.read(1)
        sps.offset_for_non_ref_pic = r.se()
        sps.offset_for_top_to_bottom_field = r.se()
        sps.offset_for_ref_frame = tuple(r.se() for _ in range(r.ue()))
    elif sps.poc_type != 2:
        raise BitstreamError(f"pic_order_cnt_type {sps.poc_type}")
    sps.max_num_ref_frames = r.ue()
    r.read(1)  # gaps_in_frame_num_value_allowed_flag (gaps are refused)
    sps.mb_width = r.ue() + 1
    sps.mb_height = r.ue() + 1
    if not r.read(1):
        raise _unsupported("field coding (frame_mbs_only_flag 0: PAFF or "
                           "MBAFF)")
    r.read(1)  # direct_8x8_inference_flag
    if r.read(1):
        sps.crop = (r.ue(), r.ue(), r.ue(), r.ue())
    if r.read(1):  # VUI: only the colour fields are read
        if r.read(1) and r.read(8) == 255:
            r.read(32)
        if r.read(1):
            r.read(1)
        if r.read(1):
            r.read(3)
            sps.full_range = r.read(1)
            if r.read(1):
                r.read(16)
                sps.matrix = r.read(8)
    return sps


def parse_pps(rbsp: bytes) -> Pps:
    r = Reader(rbsp, 8)
    pps_id, sps_id = r.ue(), r.ue()
    if r.read(1):
        raise _unsupported("CABAC (entropy_coding_mode_flag 1)")
    bottom = r.read(1)
    if r.ue():
        raise _unsupported("slice groups (FMO)")
    n_l0 = r.ue() + 1
    r.ue()
    if r.read(1):
        raise _unsupported("weighted prediction")
    r.read(2)  # weighted_bipred_idc: B slices are refused
    qp = 26 + r.se()
    r.se()
    pps = Pps(pps_id, sps_id, bottom, n_l0, qp, r.se(), r.read(1),
              r.read(1), r.read(1))
    if r.more_data():
        if r.read(1):
            raise _unsupported("the 8x8 transform (transform_8x8_mode_flag)")
        if r.read(1):
            raise _unsupported("scaling matrices")
        if r.se() != pps.chroma_qp_index_offset:
            raise _unsupported("a second chroma QP offset")
    return pps


@dataclass
class AvcConfig:
    """An avcC record: the NAL length size and its parameter sets."""

    length_size: int
    sps: List[bytes]
    pps: List[bytes]


def parse_avcc(data: bytes) -> AvcConfig:
    if len(data) < 7 or data[0] != 1:
        raise BitstreamError("avcC: not an AVCDecoderConfigurationRecord")
    length_size = (data[4] & 3) + 1
    pos = 6
    sets: List[List[bytes]] = [[], []]
    counts = [data[5] & 0x1F]
    for k in range(2):
        if k == 1:
            counts.append(data[pos])
            pos += 1
        for _ in range(counts[k]):
            n = struct.unpack(">H", data[pos: pos + 2])[0]
            sets[k].append(data[pos + 2: pos + 2 + n])
            pos += 2 + n
    return AvcConfig(length_size, sets[0], sets[1])


# --- slice headers, picture order and the reference pictures -------------------

SLICE_P, SLICE_I = 0, 2


@dataclass
class Slice:
    """One slice: its RBSP, where its data starts, its header's fields and
    RefPicList0 as pictures' decode indices."""

    rbsp: bytes
    data_bit: int
    kind: int
    first_mb: int
    qp: int
    num_ref: int
    disable_filter: int
    alpha: int
    beta: int
    pps: Pps
    refs: List[int] = field(default_factory=list)


@dataclass
class Picture:
    idr: bool
    frame_num: int
    poc: int
    reference: bool
    slices: List[Slice] = field(default_factory=list)
    mmco5: bool = False


@dataclass
class _Ref:
    pic: int
    frame_num: int
    long_idx: int = -1  # LongTermFrameIdx, -1 short-term

    def pic_num(self, cur: int, max_fn: int) -> int:
        """PicNum (FrameNumWrap) of a short-term frame while frame_num
        `cur` decodes."""
        return self.frame_num - max_fn if self.frame_num > cur \
            else self.frame_num


class _Header:
    """The fields of a slice header the scan reads."""

    def __init__(self, r: Reader, nal_type: int, nal_ref_idc: int,
                 sps_of: Dict[int, Sps], pps_of: Dict[int, Pps]):
        self.first_mb = r.ue()
        kind = r.ue() % 5
        if kind in (1, 3, 4):
            raise _unsupported({1: "B slices", 3: "SP slices",
                                4: "SI slices"}[kind])
        self.kind = kind
        pps_id = r.ue()
        if pps_id not in pps_of:
            raise BitstreamError(f"slice names a missing PPS {pps_id}")
        self.pps = pps = pps_of[pps_id]
        if pps.sps_id not in sps_of:
            raise BitstreamError(f"PPS names a missing SPS {pps.sps_id}")
        self.sps = sps = sps_of[pps.sps_id]
        self.frame_num = r.read(sps.log2_max_frame_num)
        self.idr = nal_type == 5
        if self.idr:
            r.ue()
        self.poc_lsb = self.delta_bottom = 0
        self.delta = [0, 0]
        if sps.poc_type == 0:
            self.poc_lsb = r.read(sps.log2_max_poc_lsb)
            if pps.bottom_field_pic_order:
                self.delta_bottom = r.se()
        elif sps.poc_type == 1 and not sps.delta_pic_order_always_zero:
            self.delta[0] = r.se()
            if pps.bottom_field_pic_order:
                self.delta[1] = r.se()
        self.redundant = r.ue() if pps.redundant_pic_cnt_present else 0
        self.num_ref = pps.num_ref_idx_default
        self.mods: List[Tuple[int, int]] = []
        if kind == SLICE_P:
            if r.read(1):
                self.num_ref = r.ue() + 1
            if self.num_ref > 32:
                raise BitstreamError(f"num_ref_idx_l0_active {self.num_ref}")
            if r.read(1):
                while True:
                    op = r.ue()
                    if op == 3:
                        break
                    if op > 3:
                        raise BitstreamError(f"modification_of_pic_nums_idc"
                                             f" {op}")
                    self.mods.append((op, r.ue()))
        self.no_output_prior = self.long_term = 0
        self.mmco: Optional[List[Tuple[int, ...]]] = None
        if nal_ref_idc:
            if self.idr:
                self.no_output_prior = r.read(1)
                self.long_term = r.read(1)
            elif r.read(1):
                self.mmco = []
                while True:
                    op = r.ue()
                    if op == 0:
                        break
                    if op > 6:
                        raise BitstreamError(f"memory_management_control_"
                                             f"operation {op}")
                    a = r.ue() if op in (1, 2, 3) else 0
                    b = r.ue() if op in (3, 4, 6) else 0
                    self.mmco.append((op, a, b))
        self.qp = pps.pic_init_qp + r.se()
        if not 0 <= self.qp <= 51:
            raise BitstreamError(f"slice QP {self.qp}")
        self.disable_filter, self.alpha, self.beta = 0, 0, 0
        if pps.deblocking_filter_control:
            self.disable_filter = r.ue()
            if self.disable_filter == 2:
                raise _unsupported("disable_deblocking_filter_idc 2 (no "
                                   "filtering across slice edges)")
            if self.disable_filter > 2:
                raise BitstreamError(f"disable_deblocking_filter_idc "
                                     f"{self.disable_filter}")
            if self.disable_filter != 1:
                self.alpha, self.beta = 2 * r.se(), 2 * r.se()
        self.data_bit = r.pos


class _Dpb:
    """The reference pictures (8.2.4, 8.2.5): sliding window, memory
    management operations, RefPicList0."""

    def __init__(self):
        self.refs: List[_Ref] = []
        self.max_long = -1  # MaxLongTermFrameIdx, -1 "no long-term"

    def list0(self, h: _Header) -> List[int]:
        max_fn = 1 << h.sps.log2_max_frame_num
        cur = h.frame_num
        short = sorted((r for r in self.refs if r.long_idx < 0),
                       key=lambda r: r.pic_num(cur, max_fn), reverse=True)
        longs = sorted((r for r in self.refs if r.long_idx >= 0),
                       key=lambda r: r.long_idx)
        lst: List[Optional[_Ref]] = (short + longs)[:h.num_ref]
        lst += [None] * (h.num_ref - len(lst))
        pred = cur
        idx = 0
        for op, value in h.mods:
            if op < 2:
                diff = value + 1
                no_wrap = pred - diff if op == 0 else pred + diff
                if no_wrap < 0:
                    no_wrap += max_fn
                elif no_wrap >= max_fn:
                    no_wrap -= max_fn
                pred = no_wrap
                num = no_wrap - max_fn if no_wrap > cur else no_wrap
                pick = [r for r in self.refs if r.long_idx < 0
                        and r.pic_num(cur, max_fn) == num]
            else:
                pick = [r for r in self.refs if r.long_idx == value]
            if not pick:
                raise BitstreamError("a reference list modification names "
                                     "a picture not held for reference")
            lst = lst[:idx] + [pick[0]] + [
                r for r in lst[idx:] if r is not pick[0]]
            lst = lst[:h.num_ref]
            idx += 1
        return [-1 if r is None else r.pic for r in lst]

    def mark(self, h: _Header, pic: int) -> None:
        max_fn = 1 << h.sps.log2_max_frame_num
        cur = h.frame_num
        if h.idr:
            self.refs = []
            if h.long_term:
                self.max_long = 0
                self.refs.append(_Ref(pic, cur, 0))
            else:
                self.max_long = -1
                self.refs.append(_Ref(pic, cur))
            return
        current_long = -1
        if h.mmco is not None:
            def by_pic_num(num):
                for r in self.refs:
                    if r.long_idx < 0 and r.pic_num(cur, max_fn) == num:
                        return r
                return None

            for op, a, b in h.mmco:
                if op in (1, 3):
                    r = by_pic_num(cur - (a + 1))
                    if r is None:
                        continue
                    if op == 1:
                        self.refs.remove(r)
                    else:
                        self.refs = [x for x in self.refs
                                     if x.long_idx != b or x is r]
                        r.long_idx = b
                elif op == 2:
                    self.refs = [x for x in self.refs if x.long_idx != a]
                elif op == 4:
                    self.max_long = b - 1
                    self.refs = [x for x in self.refs
                                 if x.long_idx <= self.max_long]
                elif op == 5:
                    self.refs = []
                    self.max_long = -1
                elif op == 6:
                    self.refs = [x for x in self.refs if x.long_idx != b]
                    current_long = b
        else:
            limit = max(h.sps.max_num_ref_frames, 1)
            short = [r for r in self.refs if r.long_idx < 0]
            if len(self.refs) >= limit and short:
                self.refs.remove(min(short, key=lambda r: r.pic_num(
                    cur, max_fn)))
        frame_num = 0 if any(op == 5 for op, _, _ in h.mmco or ()) else cur
        self.refs.append(_Ref(pic, frame_num, current_long))


@dataclass
class Stream:
    """A scanned stream: its SPS (one coded size), the pictures in decode
    (= output) order, and after each picture the decode indices of the
    pictures held for reference."""

    sps: Sps
    pictures: List[Picture]
    held: List[List[int]]


def scan(samples: Sequence[bytes], config: AvcConfig,
         max_pictures: Optional[int] = None) -> Stream:
    """The sequential pass over the slice headers in decode order:
    parameter sets (the avcC's, then in band), picture order counts,
    reference marking and each slice's RefPicList0. Raises on what the
    port does not decode."""
    sps_of: Dict[int, Sps] = {}
    pps_of: Dict[int, Pps] = {}
    for s in config.sps:
        sp = parse_sps(unescape(s))
        sps_of[sp.sps_id] = sp
    for p in config.pps:
        pp = parse_pps(unescape(p))
        pps_of[pp.pps_id] = pp
    pictures: List[Picture] = []
    held: List[List[int]] = []
    dpb = _Dpb()
    first_sps: Optional[Sps] = None
    # picture order count state
    prev_msb = prev_lsb = 0
    prev_fn_offset = prev_fn = 0
    prev_ref_fn = 0
    last_poc: Optional[int] = None
    cur: Optional[Picture] = None
    cur_h: Optional[_Header] = None
    cur_msb = cur_fn_offset = 0
    next_mb = 0

    def finish():
        nonlocal cur, cur_h, prev_msb, prev_lsb, prev_fn_offset, prev_fn
        nonlocal prev_ref_fn, last_poc
        if cur is None:
            return
        h = cur_h
        pic = len(pictures)
        if cur.reference:
            dpb.mark(h, pic)
        mmco5 = cur.mmco5
        if h.sps.poc_type == 0 and cur.reference:
            if mmco5:
                prev_msb, prev_lsb = 0, 0
            else:
                prev_msb, prev_lsb = cur_msb, h.poc_lsb
        prev_fn_offset = 0 if mmco5 else cur_fn_offset
        prev_fn = 0 if mmco5 else h.frame_num
        if cur.reference:
            prev_ref_fn = 0 if mmco5 else h.frame_num
        last_poc = None if mmco5 else cur.poc
        pictures.append(cur)
        held.append([r.pic for r in dpb.refs])
        cur, cur_h = None, None

    for sample in samples:
        for nal in split_sample(sample, config.length_size):
            if nal[0] & 0x80:
                raise BitstreamError("forbidden_zero_bit set")
            nal_type = nal[0] & 0x1F
            ref_idc = (nal[0] >> 5) & 3
            if nal_type == 7:
                sp = parse_sps(unescape(nal))
                sps_of[sp.sps_id] = sp
                continue
            if nal_type == 8:
                pp = parse_pps(unescape(nal))
                pps_of[pp.pps_id] = pp
                continue
            if nal_type in (2, 3, 4):
                raise _unsupported("data partitioning")
            if nal_type in (20, 21):
                raise _unsupported("SVC/MVC extensions")
            if nal_type not in (1, 5):
                continue
            rbsp = unescape(nal)
            r = Reader(rbsp, 8)
            h = _Header(r, nal_type, ref_idc, sps_of, pps_of)
            if h.redundant:
                continue
            sps = h.sps
            if first_sps is None:
                first_sps = sps
            elif (first_sps.mb_width, first_sps.mb_height) != (
                    sps.mb_width, sps.mb_height):
                raise _unsupported("a change of picture size within the "
                                   "stream")
            if h.first_mb == 0:
                finish()
                if max_pictures is not None and len(pictures) >= \
                        max_pictures:
                    return Stream(first_sps, pictures, held)
                if not h.idr and not pictures:
                    raise BitstreamError("the stream does not start with "
                                         "an IDR picture")
                max_fn = 1 << sps.log2_max_frame_num
                if not h.idr and h.frame_num not in (
                        prev_ref_fn, (prev_ref_fn + 1) % max_fn):
                    raise _unsupported("gaps in frame_num")
                cur = Picture(h.idr, h.frame_num, 0, ref_idc != 0)
                cur.mmco5 = any(op == 5 for op, _, _ in h.mmco or ())
                cur_h = h
                next_mb = -1
                # 8.2.1: picture order count
                if h.idr:
                    prev_msb = prev_lsb = prev_fn_offset = 0
                fn_offset = 0 if h.idr else (
                    prev_fn_offset + max_fn if prev_fn > h.frame_num
                    else prev_fn_offset)
                cur_fn_offset, cur_msb = fn_offset, 0
                if sps.poc_type == 0:
                    max_lsb = 1 << sps.log2_max_poc_lsb
                    lsb = h.poc_lsb
                    if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                        msb = prev_msb + max_lsb
                    elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                        msb = prev_msb - max_lsb
                    else:
                        msb = prev_msb
                    cur_msb = msb
                    top = msb + lsb
                    poc = min(top, top + h.delta_bottom)
                elif sps.poc_type == 1:
                    n = len(sps.offset_for_ref_frame)
                    absn = fn_offset + h.frame_num if n else 0
                    if ref_idc == 0 and absn > 0:
                        absn -= 1
                    expected = 0
                    if absn > 0:
                        cycle, within = divmod(absn - 1, n)
                        expected = cycle * sum(sps.offset_for_ref_frame) \
                            + sum(sps.offset_for_ref_frame[:within + 1])
                    if ref_idc == 0:
                        expected += sps.offset_for_non_ref_pic
                    top = expected + h.delta[0]
                    bottom = top + sps.offset_for_top_to_bottom_field \
                        + h.delta[1]
                    poc = min(top, bottom)
                else:
                    poc = 0 if h.idr else 2 * (fn_offset + h.frame_num) - (
                        ref_idc == 0)
                cur.poc = poc
                if not h.idr and last_poc is not None and poc <= last_poc:
                    raise _unsupported(
                        "a picture order count that falls in decode order "
                        "outside an IDR (output would differ from decode "
                        "order)")
            elif cur is None:
                raise BitstreamError("a slice continues no picture")
            elif (h.frame_num, h.idr) != (cur.frame_num, cur.idr):
                raise BitstreamError("a slice's frame_num differs from its "
                                     "picture's")
            if h.first_mb <= next_mb:
                raise _unsupported("arbitrary slice order")
            refs = dpb.list0(h) if h.kind == SLICE_P else []
            cur.slices.append(Slice(rbsp, h.data_bit, h.kind, h.first_mb,
                                    h.qp, h.num_ref, h.disable_filter,
                                    h.alpha, h.beta, h.pps, refs))
            # the macroblocks a slice covers are known only after its
            # data is parsed (parse_picture checks that slices tile the
            # picture); here they only have to rise
            next_mb = h.first_mb
    finish()
    if first_sps is None:
        raise BitstreamError("no slice in the stream")
    return Stream(first_sps, pictures, held)


# --- CAVLC tables (Tables 9-5, 9-7, 9-8, 9-9, 9-10) -------------------------

COEFF_TOKEN_LEN = (
    (1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7,
     13, 11, 10, 8, 13, 13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14,
     13, 15, 15, 14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16,
     16, 16, 16, 16, 16, 16, 16),
    (2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5,
     9, 8, 8, 6, 11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12,
     12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14,
     13, 14, 14, 14, 14),
    (4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4,
     7, 6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9,
     9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10),
    (6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0) + (6,) * 56,
)
COEFF_TOKEN_BITS = (
    (1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4,
     15, 6, 5, 4, 11, 14, 5, 4, 8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12,
     15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12,
     4, 6, 5, 8),
    (3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5, 6,
     7, 6, 5, 8, 15, 6, 5, 4, 11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8,
     10, 9, 8, 15, 14, 13, 12, 11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1, 7, 6,
     5, 4),
    (15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11,
     11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9, 8, 15, 14, 13, 13, 11, 14, 10, 12,
     15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11, 10,
     5, 8, 7, 6, 1, 4, 3, 2),
    (3, 0, 0, 0, 0, 1, 0, 0, 4, 5, 6, 0) + tuple(range(8, 64)),
)
CHROMA_DC_TOKEN_LEN = (2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8,
                       7)
CHROMA_DC_TOKEN_BITS = (1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2,
                        0)
TOTAL_ZEROS_LEN = (
    (1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9),
    (3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6),
    (4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6),
    (5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5),
    (4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5),
    (6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6),
    (6, 5, 3, 3, 3, 2, 3, 4, 3, 6),
    (6, 4, 5, 3, 2, 2, 3, 3, 6),
    (6, 6, 4, 2, 2, 3, 2, 5),
    (5, 5, 3, 2, 2, 2, 4),
    (4, 4, 3, 3, 1, 3),
    (4, 4, 2, 1, 3),
    (3, 3, 1, 2),
    (2, 2, 1),
    (1, 1),
)
TOTAL_ZEROS_BITS = (
    (1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1),
    (7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0),
    (5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0),
    (3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0),
    (5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0),
    (1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0),
    (1, 1, 5, 4, 3, 3, 2, 1, 1, 0),
    (1, 1, 1, 3, 3, 2, 2, 1, 0),
    (1, 0, 1, 3, 2, 1, 1, 1),
    (1, 0, 1, 3, 2, 1, 1),
    (0, 1, 1, 2, 1, 3),
    (0, 1, 1, 1, 1),
    (0, 1, 1, 1),
    (0, 1, 1),
    (0, 1),
)
CHROMA_DC_ZEROS_LEN = ((1, 2, 3, 3), (1, 2, 2), (1, 1))
CHROMA_DC_ZEROS_BITS = ((1, 1, 1, 0), (1, 1, 0), (1, 0))
RUN_LEN = ((1, 1), (1, 2, 2), (2, 2, 2, 2), (2, 2, 2, 3, 3), (2, 2, 3, 3, 3, 3),
           (2, 3, 3, 3, 3, 3, 3), (3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10,
                                   11))
RUN_BITS = ((1, 0), (1, 1, 0), (3, 2, 1, 0), (3, 2, 1, 1, 0), (3, 2, 3, 2, 1, 0),
            (3, 0, 1, 3, 2, 5, 4), (7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1))
# coded_block_pattern's me(v) mapping (Table 9-4, chroma 4:2:0)
CBP_INTRA = (47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
             16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
             8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41)
CBP_INTER = (0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
             14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
             17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41)
ZIGZAG4 = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
# luma4x4BlkIdx -> raster index of the 4x4 block (y * 4 + x)
BLK_RASTER = (0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15)


def _vlc(lens: Sequence[int], bits: Sequence[int],
         syms: Sequence) -> Vlc:
    codes = [(b, n) for b, n in zip(bits, lens) if n]
    return Vlc(codes, [s for s, n in zip(syms, lens) if n])


@lru_cache(maxsize=None)
def tables():
    """The CAVLC decoding tables: coeff_token for the four nC ranges and
    chroma DC (symbols total_coeff * 4 + trailing_ones), total_zeros by
    total_coeff (4x4 and chroma DC), run_before by zerosLeft."""
    tok = tuple(_vlc(COEFF_TOKEN_LEN[i], COEFF_TOKEN_BITS[i], range(68))
                for i in range(4))
    tok_dc = _vlc(CHROMA_DC_TOKEN_LEN, CHROMA_DC_TOKEN_BITS, range(20))
    tz = tuple(_vlc(n, b, range(len(n))) for n, b in
               zip(TOTAL_ZEROS_LEN, TOTAL_ZEROS_BITS))
    tz_dc = tuple(_vlc(n, b, range(len(n))) for n, b in
                  zip(CHROMA_DC_ZEROS_LEN, CHROMA_DC_ZEROS_BITS))
    run = tuple(_vlc(n, b, range(len(n))) for n, b in zip(RUN_LEN, RUN_BITS))
    return tok, tok_dc, tz, tz_dc, run


def residual_block(r: Reader, nc: int, max_coeff: int
                   ) -> Tuple[int, List[int]]:
    """residual_block_cavlc (9.2): (TotalCoeff, the max_coeff levels in
    scan order). nC -1 is chroma DC."""
    tok, tok_dc, tz, tz_dc, run = tables()
    sym = r.vlc(tok_dc if nc < 0 else tok[0 if nc < 2 else 1 if nc < 4
                                          else 2 if nc < 8 else 3])
    tc, t1 = sym >> 2, sym & 3
    coeff = [0] * max_coeff
    if tc == 0:
        return 0, coeff
    if tc > max_coeff:
        raise BitstreamError(f"{tc} coefficients in a block of {max_coeff}")
    levels = [0] * tc
    suffix = 1 if tc > 10 and t1 < 3 else 0
    for i in range(tc):
        if i < t1:
            levels[i] = -1 if r.read(1) else 1
            continue
        v = r.peek(32)
        prefix = 32 - v.bit_length() if v else 32
        if prefix > 31:
            raise BitstreamError("level_prefix too long")
        r.pos += prefix + 1
        code = min(15, prefix) << suffix
        if suffix > 0 or prefix >= 14:
            size = 4 if prefix == 14 and suffix == 0 else (
                prefix - 3 if prefix >= 15 else suffix)
            if size:
                code += r.read(size)
        if prefix >= 15 and suffix == 0:
            code += 15
        if prefix >= 16:
            code += (1 << (prefix - 3)) - 4096
        if i == t1 and t1 < 3:
            code += 2
        lv = (code + 2) >> 1 if code % 2 == 0 else (-code - 1) >> 1
        levels[i] = lv
        if suffix == 0:
            suffix = 1
        if abs(lv) > (3 << (suffix - 1)) and suffix < 6:
            suffix += 1
    zeros = 0
    if tc < max_coeff:
        zeros = r.vlc(tz_dc[tc - 1] if nc < 0 else tz[tc - 1])
    pos = tc + zeros - 1
    if pos >= max_coeff:
        raise BitstreamError("total_zeros beyond the block")
    for i in range(tc):
        coeff[pos] = levels[i]
        step = 0
        if i < tc - 1 and zeros > 0:
            step = r.vlc(run[min(zeros, 7) - 1])
            zeros -= step
        pos -= step + 1
    if pos < -1:
        raise BitstreamError("run_before beyond the block")
    return tc, coeff


# --- the macroblock layer (the plain parser) -------------------------------------

# P macroblock partitions: (count, width, height) of mb_type 0-3
P_PARTS = ((1, 16, 16), (2, 16, 8), (2, 8, 16), (4, 8, 8))
# sub_mb_type 0-3: (count, width, height)
SUB_PARTS = ((1, 8, 8), (2, 8, 4), (2, 4, 8), (4, 4, 4))


class PictureParser:
    """The macroblock layer of one picture's slices (7.3.5, 8.3.1.1,
    8.4.1, 9.2) into its records; `slot` maps a decode index to a slot of
    the batch."""

    def __init__(self, sps: Sps, slot: Dict[int, int]):
        self.w, self.h = sps.mb_width, sps.mb_height
        m = self.w * self.h
        self.slot = slot
        self.mb = np.zeros((m, MB_FIELDS), np.int32)
        self.mb[:, F_PCM] = -1
        self.blk = np.zeros((m, 16, BLK_FIELDS), np.int32)
        self.bmap = np.full((m, NBLK), -1, np.int32)
        self.coef: List[List[int]] = []
        self.pcm: List[bytes] = []
        self.kind = [-1] * m
        self.slice_of = [-1] * m
        self.modes: List[Optional[List[int]]] = [None] * m
        self.tc = [[0] * 16 for _ in range(m)]
        self.tcc = [[0] * 8 for _ in range(m)]
        self.mv = [[(0, 0)] * 16 for _ in range(m)]
        self.ref = [[-1] * 16 for _ in range(m)]

    # neighbours ----------------------------------------------------------
    def _nb(self, addr: int, dx: int, dy: int) -> int:
        """The address of the macroblock at (dx, dy) from `addr` when it is
        available (same slice, decoded), else -1."""
        x, y = addr % self.w + dx, addr // self.w + dy
        if not (0 <= x < self.w and 0 <= y < self.h):
            return -1
        n = y * self.w + x
        return n if self.slice_of[n] == self.cur_slice and n < addr else -1

    def _store_coef(self, addr: int, b: int, raster: List[int]) -> None:
        if any(raster):
            self.bmap[addr, b] = len(self.coef)
            self.coef.append(raster)

    def _nc_luma(self, addr: int, raster: int) -> int:
        bx, by = raster & 3, raster >> 2
        if bx:
            na = self.tc[addr][raster - 1]
            ha = True
        else:
            a = self._nb(addr, -1, 0)
            ha = a >= 0
            na = self.tc[a][raster + 3] if ha else 0
        if by:
            nb = self.tc[addr][raster - 4]
            hb = True
        else:
            b = self._nb(addr, 0, -1)
            hb = b >= 0
            nb = self.tc[b][raster + 12] if hb else 0
        if ha and hb:
            return (na + nb + 1) >> 1
        return na if ha else nb if hb else 0

    def _nc_chroma(self, addr: int, c: int, k: int) -> int:
        bx, by = k & 1, k >> 1
        base = 4 * c
        if bx:
            ha, na = True, self.tcc[addr][base + k - 1]
        else:
            a = self._nb(addr, -1, 0)
            ha = a >= 0
            na = self.tcc[a][base + k + 1] if ha else 0
        if by:
            hb, nb = True, self.tcc[addr][base + k - 2]
        else:
            b = self._nb(addr, 0, -1)
            hb = b >= 0
            nb = self.tcc[b][base + k + 2] if hb else 0
        if ha and hb:
            return (na + nb + 1) >> 1
        return na if ha else nb if hb else 0

    # motion vectors ------------------------------------------------------
    def _part(self, addr: int, xn: int, yn: int, done: List[bool]):
        """(available, refIdx, mv) of the partition covering luma (xn, yn)
        relative to the current macroblock (6.4.12; refIdx -1 and a zero
        vector for intra or unavailable ones)."""
        if yn > 15 or (xn > 15 and yn >= 0):
            return False, -1, (0, 0)
        if 0 <= xn <= 15 and 0 <= yn:
            b = (yn >> 2) * 4 + (xn >> 2)
            if not done[b]:
                return False, -1, (0, 0)
            return True, self.ref[addr][b], self.mv[addr][b]
        dx = -1 if xn < 0 else (1 if xn > 15 else 0)
        dy = -1 if yn < 0 else 0
        n = self._nb(addr, dx, dy)
        if n < 0:
            return False, -1, (0, 0)
        b = ((yn & 15) >> 2) * 4 + ((xn & 15) >> 2)
        if self.kind[n] in (H_I4, H_I16, H_PCM):
            return True, -1, (0, 0)
        return True, self.ref[n][b], self.mv[n][b]

    def _mvp(self, addr, x, y, w, h, ref, shape, done):
        a = self._part(addr, x - 1, y, done)
        b = self._part(addr, x, y - 1, done)
        c = self._part(addr, x + w, y - 1, done)
        if not c[0]:
            c = self._part(addr, x - 1, y - 1, done)
        if shape == 1:  # 16x8
            if y == 0 and b[1] == ref:
                return b[2]
            if y == 8 and a[1] == ref:
                return a[2]
        elif shape == 2:  # 8x16
            if x == 0 and a[1] == ref:
                return a[2]
            if x == 8 and c[1] == ref:
                return c[2]
        if not b[0] and not c[0] and a[0]:
            b = c = a
        same = [n for n in (a, b, c) if n[1] == ref]
        if len(same) == 1:
            return same[0][2]
        return tuple(sorted((a[2][i], b[2][i], c[2][i]))[1] for i in (0, 1))

    def _set_part(self, addr, x, y, w, h, ref, mv, done):
        for by in range(y >> 2, (y + h) >> 2):
            for bx in range(x >> 2, (x + w) >> 2):
                b = by * 4 + bx
                self.ref[addr][b] = ref
                self.mv[addr][b] = mv
                done[b] = True

    # the slice -----------------------------------------------------------
    def parse_slice(self, sl: Slice, number: int, sps: Sps) -> int:
        """Parses one slice's macroblocks; returns the address after its
        last."""
        r = Reader(sl.rbsp, sl.data_bit)
        self.cur_slice = number
        self.sl = sl
        m = self.w * self.h
        addr = sl.first_mb
        qp = sl.qp
        more = True
        while more:
            if addr >= m:
                raise BitstreamError("slice data beyond the picture")
            if sl.kind == SLICE_P:
                run = r.ue()
                if addr + run > m:
                    raise BitstreamError("mb_skip_run beyond the picture")
                for _ in range(run):
                    self._skip(addr, qp)
                    addr += 1
                if run:
                    more = r.more_data()
                    if not more:
                        break
                    if addr >= m:
                        raise BitstreamError("slice data beyond the picture")
            qp = self._macroblock(r, addr, qp)
            addr += 1
            more = r.more_data()
        r.check()
        return addr

    def _common(self, addr: int, kind: int, qp: int) -> None:
        sl = self.sl
        self.kind[addr] = kind
        self.slice_of[addr] = self.cur_slice
        row = self.mb[addr]
        row[F_KIND] = kind
        row[F_QP] = qp
        row[F_QPC] = sl.pps.chroma_qp_index_offset
        row[F_SLICE] = self.cur_slice
        row[F_FILTER] = sl.disable_filter
        row[F_ALPHA] = sl.alpha
        row[F_BETA] = sl.beta
        row[F_CIP] = sl.pps.constrained_intra_pred

    def _slot_of(self, ref_idx: int) -> int:
        pic = self.sl.refs[ref_idx] if ref_idx < len(self.sl.refs) else -1
        if pic < 0:
            raise BitstreamError(f"ref_idx {ref_idx} names no reference "
                                 f"picture")
        return self.slot[pic]

    def _skip(self, addr: int, qp: int) -> None:
        self.slice_of[addr] = self.cur_slice
        self.kind[addr] = H_SKIP
        done = [False] * 16
        a = self._part(addr, -1, 0, done)
        b = self._part(addr, 0, -1, done)
        if (not a[0] or not b[0] or (a[1] == 0 and a[2] == (0, 0))
                or (b[1] == 0 and b[2] == (0, 0))):
            mv = (0, 0)
        else:
            mv = self._mvp(addr, 0, 0, 16, 16, 0, 0, done)
        self._set_part(addr, 0, 0, 16, 16, 0, mv, done)
        self._common(addr, H_SKIP, qp)
        self._store_blocks(addr)

    def _store_blocks(self, addr: int) -> None:
        blk = self.blk[addr]
        for b in range(16):
            ref = self.ref[addr][b]
            blk[b, 0], blk[b, 1] = self.mv[addr][b]
            blk[b, 2] = -1 if ref < 0 else self._slot_of(ref)
            blk[b, 3] = self.tc[addr][b]

    def _macroblock(self, r: Reader, addr: int, qp: int) -> int:
        sl = self.sl
        mb_type = r.ue()
        if sl.kind == SLICE_P:
            if mb_type < 5:
                return self._inter(r, addr, qp, mb_type)
            mb_type -= 5
        if mb_type > 25:
            raise BitstreamError(f"mb_type {mb_type}")
        self.ref[addr] = [-1] * 16
        self.mv[addr] = [(0, 0)] * 16
        if mb_type == 25:  # I_PCM
            r.pos = (r.pos + 7) & ~7
            start = r.pos >> 3
            self.mb[addr, F_PCM] = len(self.pcm)
            self.pcm.append(r.data[start: start + 384])
            r.pos += 384 * 8
            self._common(addr, H_PCM, qp)
            self.tc[addr] = [16] * 16
            self.tcc[addr] = [16] * 8
            self._store_blocks(addr)
            return qp
        i16 = mb_type > 0
        kind = H_I16 if i16 else H_I4
        self.kind[addr] = kind
        self.slice_of[addr] = self.cur_slice
        row = self.mb[addr]
        if not i16:
            modes = [0] * 16
            cip = sl.pps.constrained_intra_pred
            for k in range(16):
                raster = BLK_RASTER[k]
                pred = self._pred_mode(addr, raster, modes, cip)
                if r.read(1):
                    mode = pred
                else:
                    rem = r.read(3)
                    mode = rem if rem < pred else rem + 1
                modes[raster] = mode
            self.modes[addr] = modes
            lo = hi = 0
            for b in range(8):
                lo |= modes[b] << (4 * b)
                hi |= modes[8 + b] << (4 * b)
            row[F_MODES] = lo - (1 << 32) if lo >> 31 else lo
            row[F_MODES + 1] = hi - (1 << 32) if hi >> 31 else hi
        else:
            t = mb_type - 1
            row[F_I16] = t % 4
        cmode = r.ue()
        if cmode > 3:
            raise BitstreamError(f"intra_chroma_pred_mode {cmode}")
        row[F_CMODE] = cmode
        if i16:
            cbp = ((t // 4) % 3) << 4 | (15 if t >= 12 else 0)
        else:
            code = r.ue()
            if code > 47:
                raise BitstreamError(f"coded_block_pattern {code}")
            cbp = CBP_INTRA[code]
        return self._residual(r, addr, qp, cbp, kind)

    def _pred_mode(self, addr: int, raster: int, modes: List[int],
                   cip: int) -> int:
        """predIntra4x4PredMode (8.3.1.1)."""
        got = []
        for dx, dy in ((-1, 0), (0, -1)):
            bx, by = (raster & 3) + dx, (raster >> 2) + dy
            if 0 <= bx and 0 <= by:
                got.append(modes[by * 4 + bx])
                continue
            n = self._nb(addr, dx if bx < 0 else 0, dy if by < 0 else 0)
            if n < 0 or (cip and self.kind[n] in (H_SKIP, H_INTER)):
                return 2
            got.append(self.modes[n][(by & 3) * 4 + (bx & 3)]
                       if self.kind[n] == H_I4 else 2)
        return min(got)

    def _inter(self, r: Reader, addr: int, qp: int, mb_type: int) -> int:
        sl = self.sl
        self.slice_of[addr] = self.cur_slice
        self.kind[addr] = H_INTER
        self.modes[addr] = None
        done = [False] * 16
        n_ref = sl.num_ref
        if mb_type < 3:
            count, w, h = P_PARTS[mb_type]
            refs = [r.te(n_ref - 1) if n_ref > 1 else 0
                    for _ in range(count)]
            for k in range(count):
                x, y = (0, 8 * k) if mb_type == 1 else (8 * k, 0) \
                    if mb_type == 2 else (0, 0)
                if refs[k] >= n_ref:
                    raise BitstreamError(f"ref_idx {refs[k]}")
                p = self._mvp(addr, x, y, w, h, refs[k], mb_type, done)
                mv = (p[0] + r.se(), p[1] + r.se())
                self._set_part(addr, x, y, w, h, refs[k], mv, done)
        else:
            subs = [r.ue() for _ in range(4)]
            if max(subs) > 3:
                raise BitstreamError(f"sub_mb_type {max(subs)}")
            refs = [r.te(n_ref - 1) if n_ref > 1 and mb_type == 3 else 0
                    for _ in range(4)]
            for k in range(4):
                if refs[k] >= n_ref:
                    raise BitstreamError(f"ref_idx {refs[k]}")
                x0, y0 = 8 * (k & 1), 8 * (k >> 1)
                count, w, h = SUB_PARTS[subs[k]]
                for j in range(count):
                    x = x0 + (w * j if w == 4 and h == 8 else
                              4 * (j & 1) if w == 4 else 0)
                    y = y0 + (h * j if w == 8 and h == 4 else
                              4 * (j >> 1) if h == 4 and w == 4 else 0)
                    p = self._mvp(addr, x, y, w, h, refs[k], 0, done)
                    mv = (p[0] + r.se(), p[1] + r.se())
                    self._set_part(addr, x, y, w, h, refs[k], mv, done)
        code = r.ue()
        if code > 47:
            raise BitstreamError(f"coded_block_pattern {code}")
        return self._residual(r, addr, qp, CBP_INTER[code], H_INTER)

    def _residual(self, r: Reader, addr: int, qp: int, cbp: int,
                  kind: int) -> int:
        luma, chroma = cbp & 15, cbp >> 4
        if luma or chroma or kind == H_I16:
            delta = r.se()
            if not -26 <= delta <= 25:
                raise BitstreamError(f"mb_qp_delta {delta}")
            qp = (qp + delta + 52) % 52
        self._common(addr, kind, qp)
        tc = self.tc[addr] = [0] * 16
        self.tcc[addr] = [0] * 8
        if kind == H_I16:
            _, levels = residual_block(r, self._nc_luma(addr, 0), 16)
            self._store_coef(addr, 16, _unzig(levels, 0))
        for k in range(16):
            raster = BLK_RASTER[k]
            if not luma >> (k >> 2) & 1:
                continue
            nc = self._nc_luma(addr, raster)
            if kind == H_I16:
                n, levels = residual_block(r, nc, 15)
                raster_levels = _unzig(levels, 1)
            else:
                n, levels = residual_block(r, nc, 16)
                raster_levels = _unzig(levels, 0)
            tc[raster] = n
            self._store_coef(addr, raster, raster_levels)
        if chroma:
            for c in range(2):
                _, levels = residual_block(r, -1, 4)
                self._store_coef(addr, 17 + c, levels + [0] * 12)
        if chroma == 2:
            for c in range(2):
                for k in range(4):
                    n, levels = residual_block(
                        r, self._nc_chroma(addr, c, k), 15)
                    self.tcc[addr][4 * c + k] = n
                    self._store_coef(addr, 19 + 4 * c + k, _unzig(levels, 1))
        self._store_blocks(addr)
        return qp


def _unzig(levels: List[int], start: int) -> List[int]:
    """Levels in scan order from position `start` -> a 4x4 block in
    raster order."""
    out = [0] * 16
    for i, v in enumerate(levels):
        out[ZIGZAG4[i + start]] = v
    return out


def parse_picture(pic: Picture, sps: Sps, slot: Dict[int, int]):
    """One picture's records (the plain parser): mb (M, MB_FIELDS), blk
    (M, 16, 4), bmap (M, 27), coef (n, 16), pcm (n, 384)."""
    p = PictureParser(sps, slot)
    end = 0
    for number, sl in enumerate(pic.slices):
        if sl.first_mb != end:
            raise _unsupported("arbitrary slice order")
        end = p.parse_slice(sl, number, sps)
    if end != p.w * p.h:
        raise BitstreamError(f"the slices cover {end} of {p.w * p.h} "
                             f"macroblocks")
    coef = np.asarray(p.coef, np.int16).reshape(-1, 16)
    pcm = np.frombuffer(b"".join(p.pcm), np.uint8).reshape(-1, 384)
    return p.mb, p.blk, p.bmap, coef, pcm


# --- the decode pipeline ------------------------------------------------------------

# The device bytes a batch of pictures may take while it decodes: the
# most whole IDR periods whose working set (WORK_BYTES a pixel of the
# coded picture: planes, residuals, records, the colour conversion's
# int32 planes) fits in BATCH_BYTES, as io/mpeg4 batches its VOPs.
BATCH_BYTES = 4 << 30
WORK_BYTES = 64


def batch_pictures(sps: Sps) -> int:
    return max(1, BATCH_BYTES // (WORK_BYTES * 256 * sps.mb_width
                                  * sps.mb_height))


def assemble(parts):
    """Stack parse_picture's records of F pictures into a batch's: mb,
    blk, bmap (coef rows offset), coef, pcm (I_PCM rows offset), as
    numpy."""
    mbs, blks, bmaps, coefs, pcms = [], [], [], [], []
    nc = npcm = 0
    for mb, blk, bmap, coef, pcm in parts:
        mb = mb.copy()
        bmap = np.where(bmap >= 0, bmap + nc, -1).astype(np.int32)
        mb[:, F_PCM] = np.where(mb[:, F_PCM] >= 0, mb[:, F_PCM] + npcm, -1)
        nc += len(coef)
        npcm += len(pcm)
        mbs.append(mb)
        blks.append(blk)
        bmaps.append(bmap)
        coefs.append(coef)
        pcms.append(pcm)
    return (np.stack(mbs), np.stack(blks), np.stack(bmaps),
            np.concatenate(coefs).reshape(-1, 16),
            np.concatenate(pcms).reshape(-1, 384))


def summary(mb: np.ndarray) -> np.ndarray:
    """(F, 3) bool: whether each picture holds inter macroblocks, intra
    ones (I_PCM included), and macroblocks its loop filter runs on."""
    kind = mb[..., F_KIND]
    return np.stack([(kind <= H_INTER).any(1), (kind >= H_I4).any(1),
                     (mb[..., F_FILTER] == 0).any(1)], 1)


def entropy_decode(stream: Stream, lo: int, hi: int, slot: Dict[int, int],
                   dev: torch.device):
    """The records of pictures [lo, hi) on `dev` (mb, blk, bmap, coef,
    pcm) and their summary on the host: the C++ parser on CUDA (one copy
    to the card), the plain Python one on the CPU."""
    if dev.type == "cuda":
        return K.parse_batch(stream, lo, hi, slot, dev)
    recs = assemble([parse_picture(stream.pictures[f], stream.sps, slot)
                     for f in range(lo, hi)])
    return tuple(torch.from_numpy(a) for a in recs), summary(recs[0])


def reconstruct(recs, info: np.ndarray, planes: Sequence[torch.Tensor],
                first: int, mb_width: int) -> None:
    """The device half of a batch: H1 once, then for each picture in
    decode order (slot first + f) H2 where it has inter macroblocks, H3
    where it has intra ones and H4 where its loop filter runs."""
    mb, blk, bmap, coef, pcm = recs
    res_y, res_c = K.residual(coef, bmap, mb, mb_width)
    for f in range(mb.shape[0]):
        out = first + f
        has_inter, has_intra, filtered = info[f]
        if has_inter:
            K.inter_predict(planes, out, mb[f], blk[f], res_y[f], res_c[f],
                            mb_width)
        if has_intra:
            K.intra_reconstruct(planes, out, mb[f], pcm, res_y[f], res_c[f],
                                mb_width)
        if filtered:
            K.deblock(planes, out, mb[f], blk[f], mb_width)


def to_rgb(planes: Sequence[torch.Tensor], sps: Sps) -> torch.Tensor:
    """The cropped pictures of Y, U, V planes (N, ...) as RGB, converted
    as cv2's FFmpeg converts them: in FFmpeg's fixed point with the
    coefficients swscale derives from the VUI's matrix and range
    (mpeg4.rgb_coefficients; BT.601 limited range without a VUI)."""
    left, _, top, _ = sps.crop
    y, u, v = planes
    return mpeg4.yuv420_to_rgb(
        y[:, 2 * top:, 2 * left:], u[:, top:, left:], v[:, top:, left:],
        sps.height, sps.width,
        mpeg4.rgb_coefficients(sps.matrix, bool(sps.full_range)))


def iter_decode(samples: Sequence[bytes], config: AvcConfig,
                dev: torch.device, max_frames: Optional[int] = None
                ) -> Iterator[torch.Tensor]:
    """Decode pictures batch_pictures() at a time, each batch starting at
    an IDR where one lies in reach, the reference pictures still held
    carried between batches: yields (n, H, W, 3) uint8 RGB tensors on
    `dev`, the frames in decode order (which is output order here)."""
    stream = scan(samples, config, max_frames)
    sps = stream.sps
    n = len(stream.pictures)
    sync = [p.idr for p in stream.pictures]
    h16, w16 = 16 * sps.mb_height, 16 * sps.mb_width
    carry: Dict[int, Tuple[torch.Tensor, ...]] = {}
    for lo, hi in mpeg4.batches(n, sync, batch_pictures(sps)):
        want = sorted({r for p in stream.pictures[lo:hi] for sl in p.slices
                       for r in sl.refs if 0 <= r < lo})
        missing = [r for r in want if r not in carry]
        if missing:
            raise BitstreamError(f"pictures {missing} are referenced after "
                                 f"they left the buffer")
        slot = {r: i for i, r in enumerate(want)}
        first = len(want)
        slot.update({lo + f: first + f for f in range(hi - lo)})
        s = first + hi - lo
        planes = [torch.zeros((s, h16, w16), dtype=torch.uint8, device=dev),
                  torch.zeros((s, h16 // 2, w16 // 2), dtype=torch.uint8,
                              device=dev),
                  torch.zeros((s, h16 // 2, w16 // 2), dtype=torch.uint8,
                              device=dev)]
        for r, i in slot.items():
            if r < lo:
                for p, c in zip(planes, carry[r]):
                    p[i] = c
        with mpeg4.plain_threads(dev):
            recs, info = entropy_decode(stream, lo, hi, slot, dev)
            reconstruct(recs, info, planes, first, sps.mb_width)
            rgb = to_rgb([p[first:] for p in planes], sps)
        held = set(stream.held[hi - 1])
        carry = {r: tuple(p[slot[r]].clone() for p in planes)
                 for r in held if r in slot}
        yield rgb


def decode(samples: Sequence[bytes], config: AvcConfig, dev: torch.device,
           max_frames: Optional[int] = None) -> torch.Tensor:
    """Decode into (N, H, W, 3) uint8 RGB frames on `dev`; with
    `max_frames`, the first that many, decoding only those pictures."""
    out = list(iter_decode(samples, config, dev, max_frames))
    if not out:
        raise BitstreamError("no picture in the stream")
    return torch.cat(out)
