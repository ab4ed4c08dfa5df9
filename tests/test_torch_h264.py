"""The port's H.264 Constrained Baseline input (`io/mp4.py`'s avc1/avc3
entries, `io/h264.py`, `io/video.py`'s dispatch, the plain versions of
`ops/h264_cuda.py`) against the JAX package's cv2 path
(`faceoff_tpu/io/video.py`, FFmpeg's h264 decoder), on the CPU:

  * the fixtures of tools/make_h264_fixture.py (avc1 with three
    references, two IDRs, cropping and intra macroblocks in P pictures;
    three slices a picture with constrained intra prediction and filter
    offsets; avc3 with its parameter sets in band, full range and
    BT.709): the port's frames equal cv2's in count, order and pixels.
    Tolerance 0, derived: H.264 decoding is exact by the standard, and
    the port converts YUV to RGB in FFmpeg's fixed point with the
    coefficients swscale derives from the VUI;
  * each stored .npz is cv2's decode, the 720p fixture's too;
  * max_frames and video_frame_chunks (batches cut so that reference
    pictures are carried) against the whole decode;
  * preprocessing's crop stage of both packages on h264_cb.mp4;
  * every refused feature raises a ValueError naming it and citing
    ROADMAP.md Queue 1 item 7b, on parameter sets and slice headers
    written bit by bit here (with emulation prevention).
"""

from __future__ import annotations

import hashlib
import struct
from functools import lru_cache
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from faceoff_tpu.io import video as jvideo
from faceoff_tpu.preprocess import detectors as jdet
from faceoff_tpu.preprocess import face_crop as jcrop
from faceoff_tpu_torch.io import h264, mp4, mpeg4
from faceoff_tpu_torch.io import video as tvideo
from faceoff_tpu_torch.ops import h264_cuda as K
from faceoff_tpu_torch.preprocess import face_crop as tcrop

CPU = torch.device("cpu")
DATA = Path(__file__).resolve().parent / "data_torch"
SMALL = ("h264_cb.mp4", "h264_slices.mp4", "h264_avc3_vui.mp4")
ITEM = r"ROADMAP\.md, Queue 1 item 7b"


@pytest.fixture(autouse=True)
def one_thread():
    with mpeg4.plain_threads(CPU):
        yield


@lru_cache(maxsize=None)
def _port(name: str) -> np.ndarray:
    return tvideo.read_video_frames(str(DATA / name), device=CPU).numpy()


@lru_cache(maxsize=None)
def _cv2(name: str) -> np.ndarray:
    return np.stack(jvideo.read_video_frames(str(DATA / name)))


# -- the fixtures against cv2 -------------------------------------------------


@pytest.mark.parametrize("name", SMALL)
def test_fixture_decodes_as_cv2(name):
    """Each 104-px fixture: the port's frames equal cv2's in count, order
    and every pixel, and the fixture holds what it is there for."""
    got, want = _port(name), _cv2(name)
    assert got.shape == want.shape
    for f in range(len(want)):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"frame {f}")
    track = mp4.read_mp4(str(DATA / name))
    config = h264.parse_avcc(track.dsi)
    stream = h264.scan(track.samples, config)
    sps, pics = stream.sps, stream.pictures
    assert (sps.width, sps.height, sps.crop) == (104, 104, (0, 4, 0, 4))
    slices = [s for p in pics for s in p.slices]
    if name == "h264_cb.mp4":
        assert track.codec == "avc1" and sum(p.idr for p in pics) == 2
        assert max(s.num_ref for s in slices) == 3
        assert {len(set(s.refs)) for s in slices if s.kind == 0} >= {3}
        recs, info = h264.entropy_decode(stream, 0, len(pics),
                                         {i: i for i in range(len(pics))},
                                         CPU)
        kind = recs[0][..., K.F_KIND].numpy()
        p_pics = [i for i, p in enumerate(pics) if not p.idr]
        assert (kind[p_pics] >= K.H_I4).sum() >= 20
        assert (kind == K.H_I16).any() and (kind == K.H_SKIP).any()
        # sub-8x8 partitions: vectors that differ inside an 8x8 quadrant
        mv = recs[1][..., :2].numpy().reshape(len(pics), -1, 2, 2, 2, 2, 2)
        assert (mv[:, :, :, 0] != mv[:, :, :, 1]).any()
    elif name == "h264_slices.mp4":
        assert all(len(p.slices) == 3 for p in pics)
        assert {(s.alpha, s.beta) for s in slices} == {(-4, 2)}
        assert all(s.pps.constrained_intra_pred for s in slices)
    else:
        assert track.codec == "avc3"
        assert config.sps == [] and config.pps == []
        assert (sps.full_range, sps.matrix) == (1, 1)
        assert all(s.disable_filter == 1 for s in slices)


@pytest.mark.parametrize("name", SMALL + ("h264_720p.mp4",))
def test_stored_decode_is_cv2s(name):
    """The .npz beside each fixture holds cv2's decode of it."""
    z = np.load(DATA / name.replace(".mp4", ".npz"))
    want = _cv2(name)
    assert int(z["count"]) == len(want)
    assert tuple(z["shape"]) == want.shape[1:]
    assert list(z["sha256"]) == [hashlib.sha256(
        np.ascontiguousarray(f).tobytes()).hexdigest() for f in want]


def test_fixtures_exercise_emulation_prevention():
    """The fixtures' NAL units hold emulation-prevention bytes, which the
    port strips before reading a bit; unescape removes exactly the 03 of
    each 00 00 03."""
    n = sum(u.count(b"\0\0\3") for name in SMALL
            for s in mp4.read_mp4(str(DATA / name)).samples
            for u in h264.split_sample(s, 4))
    assert n > 0
    assert h264.unescape(b"\1\0\0\3\0\0\0\3\1\0\0\3") == b"\1\0\0\0\0\0\1\0\0"


def test_max_frames_and_chunks_equal_the_whole(monkeypatch):
    """h264_cb.mp4 (an IDR at 0 and 12): max_frames gives the first
    frames; video_frame_chunks in chunks of 5 frames, decoded 5 pictures
    a batch (so reference pictures are carried into batches that start
    after an IDR and before one), gives the whole decode."""
    path = str(DATA / "h264_cb.mp4")
    whole = _port("h264_cb.mp4")
    part = tvideo.read_video_frames(path, max_frames=7, device=CPU).numpy()
    np.testing.assert_array_equal(part, whole[:7])
    monkeypatch.setattr(h264, "batch_pictures", lambda sps: 5)
    chunks = list(tvideo.video_frame_chunks(path, 5, device=CPU))
    assert [len(c) for c in chunks] == [5, 5, 5, 5, 4]
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), whole)


def test_crop_stage_equals_jax(tmp_path, monkeypatch):
    """process_video of both packages on h264_cb.mp4 (the port decoding
    it, the JAX package through cv2): the same clips, of the same lengths;
    the frames the port hands its writer are cv2.resize of the JAX stage's
    crops (its detector on cv2's frames, its segments and boxes) bit for
    bit. Both write lossy mp4v, so the written clips are compared by
    length."""
    path = str(DATA / "h264_cb.mp4")
    frames = _cv2("h264_cb.mp4")
    handed = {}

    def save(clip, out, *args, **kwargs):
        handed[out] = np.stack([np.asarray(f) for f in clip])
        return save_frames(clip, out, *args, **kwargs)

    save_frames = tcrop.save_frames_as_video
    monkeypatch.setattr(tcrop, "save_frames_as_video", save)
    written = tcrop.process_video(path, str(tmp_path / "t"), min_frames=8,
                                  resolution=64, device=CPU)
    jax_written = jcrop.process_video(path, str(tmp_path / "j"),
                                      detector=jdet.HeuristicDetector(),
                                      min_frames=8, resolution=64)
    boxes = [jdet.HeuristicDetector().detect(f) for f in frames]
    want = jcrop.segment_stable_boxes(boxes, min_frames=8)
    assert len(written) == len(jax_written) == len(want) >= 1
    for ours, theirs, (start, end, box) in zip(written, jax_written, want):
        x1, y1, x2, y2 = jcrop.square_crop_box(box, frames[0].shape)
        ref = np.stack([cv2.resize(f[y1:y2, x1:x2], (64, 64))
                        for f in frames[start:end]])
        np.testing.assert_array_equal(handed[ours], ref)
        assert len(tvideo.read_video_frames(ours, device=CPU)) == len(
            jvideo.read_video_frames(theirs)) == end - start


# -- refusals, on streams written bit by bit ---------------------------------


class Writer:
    """An RBSP bit writer with Exp-Golomb codes; nal() adds the header
    and emulation prevention."""

    def __init__(self):
        self.bits = []

    def u(self, n, v):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def ue(self, v):
        k = (v + 1).bit_length()
        return self.u(k - 1, 0).u(k, v + 1)

    def se(self, v):
        return self.ue(2 * v - 1 if v > 0 else -2 * v)

    def nal(self, kind, ref_idc=3):
        bits = self.bits + [1]
        bits += [0] * (-len(bits) % 8)
        raw = bytes(int("".join(map(str, bits[i: i + 8])), 2)
                    for i in range(0, len(bits), 8))
        out, zeros = bytearray(), 0
        for b in raw:
            if zeros >= 2 and b <= 3:
                out.append(3)
                zeros = 0
            out.append(b)
            zeros = zeros + 1 if b == 0 else 0
        return bytes([(ref_idc << 5) | kind]) + bytes(out)


def sps(profile=66, chroma=1, depth=0, scaling=0, frame_mbs_only=1,
        poc_type=0, mbw=3, refs=2, poc_cycle=(3,), non_ref_offset=-1):
    w = Writer().u(8, profile).u(8, 0).u(8, 30).ue(0)
    if profile in h264.HIGH_PROFILES:
        w.ue(chroma)
        if chroma == 3:
            w.u(1, 0)
        w.ue(depth).ue(depth).u(1, 0).u(1, scaling)
        if scaling:
            w.u(8, 0)
    w.ue(0).ue(poc_type)  # log2_max_frame_num 4
    if poc_type == 0:
        w.ue(0)  # log2_max_pic_order_cnt_lsb 4
    elif poc_type == 1:
        w.u(1, 0).se(non_ref_offset).se(0).ue(len(poc_cycle))
        for off in poc_cycle:
            w.se(off)
    w.ue(refs).u(1, 0).ue(mbw - 1).ue(0).u(1, frame_mbs_only)
    if not frame_mbs_only:
        w.u(1, 0)
    return w.u(1, 1).u(1, 0).u(1, 0).nal(7)


def pps(cabac=0, groups=0, weighted=0, t8x8=None, scaling=0):
    w = Writer().ue(0).ue(0).u(1, cabac).u(1, 0).ue(groups)
    if groups:
        w.ue(0)
    w.ue(0).ue(0).u(1, weighted).u(2, 0).se(0).se(0).se(0)
    w.u(1, 1).u(1, 0).u(1, 0)
    if t8x8 is not None:
        w.u(1, t8x8).u(1, scaling).se(0)
    return w.nal(8)


def slice_(kind=2, idr=True, frame_num=0, poc=0, first_mb=0, idc=0,
           ref_idc=3, num_ref=None, mods=(), mmco=None, long_term=0,
           poc_type=0):
    """A slice header (and one stop bit for its data): `mods` are
    (modification_of_pic_nums_idc, value) pairs, `mmco` (operation,
    values...) tuples, `poc` the order count's lsb (type 0) or
    delta_pic_order_cnt[0] (type 1)."""
    w = Writer().ue(first_mb).ue(kind).ue(0).u(4, frame_num)
    if idr:
        w.ue(0)
    if poc_type == 0:
        w.u(4, poc)
    elif poc_type == 1:
        w.se(poc)
    if kind == 0:
        w.u(1, num_ref is not None)
        if num_ref is not None:
            w.ue(num_ref - 1)
        w.u(1, bool(mods))
        for op, value in mods:
            w.ue(op).ue(value)
        if mods:
            w.ue(3)
    if ref_idc and idr:
        w.u(1, 0).u(1, long_term)
    elif ref_idc:
        w.u(1, mmco is not None)
        for op, *values in mmco or ():
            w.ue(op)
            for v in values:
                w.ue(v)
        if mmco is not None:
            w.ue(0)
    w.se(0).ue(idc)
    if idc != 1:
        w.se(0).se(0)
    return w.u(1, 1).nal(5 if idr else 1, ref_idc)


def _scan(units, sps_=None, pps_=None):
    sample = b"".join(struct.pack(">I", len(u)) + u for u in units)
    config = h264.AvcConfig(4, [sps_ or sps()], [pps_ or pps()])
    return h264.scan([sample], config)


REFUSALS = [
    ("CABAC", dict(pps_=pps(cabac=1))),
    ("B slices", dict(units=[slice_(kind=1)])),
    ("SP slices", dict(units=[slice_(kind=3)])),
    ("SI slices", dict(units=[slice_(kind=4)])),
    ("the 8x8 transform", dict(pps_=pps(t8x8=1))),
    ("scaling matrices", dict(pps_=pps(t8x8=0, scaling=1))),
    ("scaling matrices", dict(sps_=sps(profile=100, scaling=1))),
    ("weighted prediction", dict(pps_=pps(weighted=1))),
    (r"field coding \(frame_mbs_only_flag 0",
     dict(sps_=sps(frame_mbs_only=0))),
    ("a chroma format other than 4:2:0", dict(sps_=sps(profile=100,
                                                       chroma=2))),
    ("bit depths above 8", dict(sps_=sps(profile=110, depth=2))),
    (r"slice groups \(FMO\)", dict(pps_=pps(groups=1))),
    ("arbitrary slice order", dict(units=[
        slice_(first_mb=0), slice_(first_mb=2), slice_(first_mb=1)])),
    ("disable_deblocking_filter_idc 2", dict(units=[slice_(idc=2)])),
    ("gaps in frame_num", dict(units=[
        slice_(), slice_(kind=0, idr=False, frame_num=2, poc=4)])),
    ("a picture order count that falls", dict(units=[
        slice_(), slice_(kind=0, idr=False, frame_num=1, poc=4),
        slice_(kind=0, idr=False, frame_num=2, poc=2)])),
]


@pytest.mark.parametrize("feature,case", REFUSALS,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(REFUSALS)])
def test_refusals_raise_by_name(feature, case):
    """Each feature the port does not decode raises a ValueError naming
    it and citing ROADMAP.md Queue 1 item 7b."""
    case = dict(case)
    units = case.pop("units", [slice_()])
    with pytest.raises(ValueError, match=feature) as err:
        _scan(units, **case)
    assert "Queue 1 item 7b" in str(err.value)


def test_written_streams_scan_when_nothing_is_refused():
    """The writer's own stream (an IDR, then P pictures whose order counts
    rise, three slices in order) scans: the refusals above come from the
    feature named, not from the writer."""
    stream = _scan([slice_(), slice_(first_mb=1), slice_(first_mb=2),
                    slice_(kind=0, idr=False, frame_num=1, poc=2),
                    slice_(kind=0, idr=False, frame_num=2, poc=4)])
    assert [len(p.slices) for p in stream.pictures] == [3, 1, 1]
    assert [p.poc for p in stream.pictures] == [0, 2, 4]
    # one active reference (the PPS default): the latest picture
    assert stream.pictures[2].slices[0].refs == [1]


def test_reference_lists_follow_marking_and_modification():
    """RefPicList0 by hand (8.2.4, 8.2.5) on a stream of five reference
    frames: short-term pictures by descending PicNum, then long-term ones
    by LongTermPicNum; a modification moving frame_num 1 first; MMCO 1
    dropping a short-term picture, 4 and 6 making the current one
    long-term, 2 dropping it again; the sliding window dropping the
    oldest short-term picture when the buffer is full."""
    P = dict(kind=0, idr=False)
    units = [
        slice_(),                                          # 0
        slice_(frame_num=1, poc=2, **P),                   # 1
        slice_(frame_num=2, poc=4, **P),                   # 2
        slice_(frame_num=3, poc=6, num_ref=3, **P),        # 3
        slice_(frame_num=4, poc=8, num_ref=3, mods=[(0, 2)], **P),  # 4
        slice_(frame_num=5, poc=10, num_ref=4,
               mmco=[(1, 3), (4, 1), (6, 0)], **P),        # 5
        slice_(frame_num=6, poc=12, num_ref=5, **P),       # 6
        slice_(frame_num=7, poc=14, num_ref=5, **P),       # 7
        slice_(frame_num=8, poc=0, num_ref=5, mmco=[(2, 0)], **P),  # 8
        slice_(frame_num=9, poc=2, num_ref=5, **P),        # 9
    ]
    stream = _scan(units, sps(refs=5))
    lists = [p.slices[0].refs for p in stream.pictures]
    assert lists[3] == [2, 1, 0]
    assert lists[4] == [1, 3, 2]            # frame_num 1 moved first
    assert lists[5] == [4, 3, 2, 1]
    # picture 5 dropped picture 1 (PicNum 5 - 4) and became long-term 0
    assert lists[6] == [4, 3, 2, 0, 5]
    # the buffer was full: marking picture 6 slid the window over
    # picture 0, marking picture 7 over picture 2
    assert lists[7] == [6, 4, 3, 2, 5]
    assert sorted(stream.held[7]) == [3, 4, 5, 6, 7]
    # picture 8 dropped long-term 0 (picture 5); its order count wraps
    assert lists[9] == [8, 7, 6, 4, 3]
    assert [p.poc for p in stream.pictures] == [
        0, 2, 4, 6, 8, 10, 12, 14, 16, 18]


def test_order_count_type_1_by_hand():
    """pic_order_cnt_type 1 (8.2.1.2) with offset_for_ref_frame (3) and
    offset_for_non_ref_pic -1: an IDR, a reference P, a non-reference P
    (delta 2), a reference P give 0, 3, 2 + 2, 6."""
    units = [slice_(poc_type=1),
             slice_(kind=0, idr=False, frame_num=1, poc_type=1),
             slice_(kind=0, idr=False, frame_num=2, poc=2, ref_idc=0,
                    poc_type=1),
             slice_(kind=0, idr=False, frame_num=2, poc_type=1)]
    stream = _scan(units, sps(poc_type=1))
    assert [p.poc for p in stream.pictures] == [0, 3, 4, 6]
    assert [p.reference for p in stream.pictures] == [True, True, False,
                                                      True]
    # the non-reference picture is never in a list
    assert stream.pictures[3].slices[0].refs == [1]


def _avc_mp4(path, samples, width, height, config):
    """An avc1 MP4 of `samples`: the port's mp4v writer with its sample
    entry swapped for avc1 + avcC (as tools/make_h264_fixture.py does)."""
    mp4.write_mp4(str(path), samples, [True] + [False] * (len(samples) - 1),
                  width, height, 25, b"\0")
    data = bytearray(path.read_bytes())
    at = data.index(b"mp4v") - 4
    size = struct.unpack(">I", data[at: at + 4])[0]
    entry = mp4._box(b"avc1", bytes(data[at + 8: at + 86]),
                     mp4._box(b"avcC", config))
    data[at: at + size] = entry
    for box in (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"stsd"):
        b = data.index(box) - 4
        data[b: b + 4] = struct.pack(">I", struct.unpack(
            ">I", data[b: b + 4])[0] + len(entry) - size)
    path.write_bytes(bytes(data))


def test_pcm_macroblocks_decode_as_cv2(tmp_path):
    """A stream written bit by bit: an IDR of two I_PCM macroblocks
    (samples byte-aligned after the mb_type) and a P picture skipping
    both, which predicts from them: the port decodes it as cv2 does."""
    rng = np.random.default_rng(3)
    w = Writer().ue(0).ue(2).ue(0).u(4, 0).ue(0).u(4, 0).u(1, 0).u(1, 0)
    w.se(0).ue(0).se(0).se(0)
    for _ in range(2):
        w.ue(25)
        w.u(-len(w.bits) % 8, 0)
        for v in rng.integers(0, 256, 384):
            w.u(8, int(v))
    idr = w.nal(5)
    p = Writer().ue(0).ue(0).ue(0).u(4, 1).u(4, 2).u(1, 0).u(1, 0).u(1, 0)
    p.se(0).ue(0).se(0).se(0).ue(2)
    units = [sps(mbw=2), pps(), idr, p.nal(1)]
    config = bytes([1, 66, 0, 30, 0xFF, 0xE1]) + struct.pack(
        ">H", len(units[0])) + units[0] + bytes([1]) + struct.pack(
        ">H", len(units[1])) + units[1]
    samples = [struct.pack(">I", len(u)) + u for u in units[2:]]
    path = tmp_path / "pcm.mp4"
    _avc_mp4(path, samples, 32, 16, config)
    got = tvideo.read_video_frames(str(path), device=CPU).numpy()
    want = np.stack(jvideo.read_video_frames(str(path)))
    assert got.shape == want.shape == (2, 16, 32, 3)
    np.testing.assert_array_equal(got, want)
    stream = h264.scan(mp4.read_mp4(str(path)).samples,
                       h264.parse_avcc(config))
    recs, _ = h264.entropy_decode(stream, 0, 2, {0: 0, 1: 1}, CPU)
    assert recs[0][0, :, K.F_KIND].tolist() == [K.H_PCM] * 2
    assert recs[4].shape == (2, 384)


def test_hevc_is_refused_by_name(tmp_path):
    """An MP4 whose sample entry is hvc1 raises naming HEVC and the
    ROADMAP entry; avc1 is read."""
    good = DATA / "h264_cb.mp4"
    bad = tmp_path / "hevc.mp4"
    bad.write_bytes(good.read_bytes().replace(b"avc1", b"hvc1"))
    with pytest.raises(ValueError, match=r"HEVC \(hvc1\).*" + ITEM):
        tvideo.read_video_frames(str(bad), device=CPU)
    assert mp4.read_mp4(str(good)).codec == "avc1"
