"""The port's MPEG-4 Part 2 Advanced Simple Profile input (`io/mpeg4.py`,
`io/video.py`, the plain versions of `ops/mpeg4_cuda.py`) against the JAX
package's cv2 path (`faceoff_tpu/io/video.py`, FFmpeg), on the CPU:

  * the fixtures of tools/make_asp_fixture.py (B-VOPs with direct mode and
    skipped macroblocks, MPEG quantisation, quarter-pel, Xvid's packed AVI,
    720p): the port's frames equal cv2's in count, order and pixels, bit
    for bit. Tolerance 0, derived: the port decodes as FFmpeg does where
    FFmpeg chooses (its simple IDCT, and for streams whose user data
    names Xvid the Xvid IDCT; no mismatch control on intra blocks;
    references padded from the decoded macroblocks; its packed-B-frame,
    N-VOP and output-order rules), and converts YUV to RGB in FFmpeg's
    fixed point;
  * hand-worked blocks of the plain V1 (MPEG quantisation and mismatch
    control), V2/V5 (the mirrored 8-tap filter) and V5 (an interpolated
    macroblock whose sums are odd), and direct mode's vectors;
  * a VOL with loaded matrices, parsed and decoded as cv2 decodes it;
  * batches cut next to B-VOPs, N-VOPs, vectors reaching below the
    picture, max_frames in display order, each against the whole or cv2;
  * the refusals that stay (interlacing, S-VOPs, data partitioning).
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from faceoff_tpu.io import video as jvideo
from faceoff_tpu_torch.io import mp4, mpeg4
from faceoff_tpu_torch.io import video as tvideo
from faceoff_tpu_torch.ops import mpeg4_cuda as K

CPU = torch.device("cpu")
DATA = Path(__file__).resolve().parent / "data_torch"
SMALL = ("asp_bframes.mp4", "asp_qpel_mpegq.mp4", "asp_xvid.avi")


@pytest.fixture(autouse=True)
def one_thread():
    with mpeg4.plain_threads(CPU):
        yield


def _stream(name: str):
    """(samples, vol, headers, fourcc) of a fixture."""
    path = str(DATA / name)
    if name.endswith(".avi"):
        _, _, _, bodies, fourcc = tvideo.read_avi_stream(path)
        return bodies, mpeg4.parse_vol(bodies[0]), b"", fourcc
    track = mp4.read_mp4(path)
    return track.samples, mpeg4.parse_vol(track.dsi), track.dsi, b""


def _digests(frames: np.ndarray):
    return [hashlib.sha256(np.ascontiguousarray(f).tobytes()).hexdigest()
            for f in frames]


# -- the fixtures against cv2 -------------------------------------------------


@pytest.mark.parametrize("name", SMALL)
def test_fixture_decodes_as_cv2(name):
    """Each 104-px fixture: the port's frames equal cv2's in count, order
    and every pixel (tolerance 0, see the module docstring), and hold what
    the fixture is there for."""
    path = str(DATA / name)
    want = np.stack(jvideo.read_video_frames(path))
    got = tvideo.read_video_frames(path, device=CPU).numpy()
    assert got.shape == want.shape
    for f in range(len(want)):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"frame {f}")
    samples, vol, headers, fourcc = _stream(name)
    plan = mpeg4.plan_stream(samples, vol, headers, fourcc)
    assert (plan.kind == mpeg4.VOP_B).sum() >= 10 and not vol.low_delay
    rows = np.stack([plan.kind, plan.trb, plan.trd], 1)
    recs = mpeg4.parse_batch(plan.data, vol, rows, plan.quirks.direct_16)
    bmb = recs[4]
    direct = (bmb[:, :, 3] & 3) == 3
    assert direct.any() and (bmb[:, :, 3] == K.B_BWD).any()
    # co-located macroblocks that were not coded: a forward copy at 0
    assert ((bmb[:, :, 3] == K.B_FWD) & (bmb[:, :, 4:20] == 0).all(2)
            & (bmb[:, :, 2] == 0)).any()
    if name == "asp_bframes.mp4":
        assert not vol.quant_type and not vol.quarter_sample
        assert plan.kind[:4].tolist() == [0, 1, 3, 3]
        assert (plan.trb[2:4].tolist(), plan.trd[2:4].tolist()) == (
            [1, 2], [3, 3])
        assert list(np.nonzero(plan.kind == mpeg4.VOP_I)[0])[:2] == [0, 10]
    else:
        assert vol.quant_type == 1 and vol.quarter_sample
        assert ((bmb[:, :, 3] & K.B_8X8) != 0).any()
        assert (recs[1][:, :, 4:12] % 4 != 0).any()  # quarter positions
    if name.endswith(".mp4"):  # display order from the stream, not these
        data = (DATA / name).read_bytes()
        assert b"ctts" in data and b"edts" in data
    if name == "asp_xvid.avi":
        assert fourcc == b"XVID"
        assert plan.quirks == mpeg4.Quirks(packed=True, xvid_idct=True)
        # 22 packets: the stashed B-VOPs take the places of the N-VOPs
        assert len(samples) == len(plan.show) == len(want) == 22
        assert sum(len(s) <= mpeg4.MAX_NVOP_SIZE for s in samples) > 0


@pytest.mark.parametrize("name", SMALL + ("asp_720p.mp4",))
def test_stored_decode_is_cv2s(name):
    """The digests beside each fixture are cv2's decode of it (what
    chip_smoke.py holds the card's decode to); the port's decode gives
    them too (the 720p fixture's first four frames)."""
    path = str(DATA / name)
    z = np.load(DATA / (name.rsplit(".", 1)[0] + ".npz"))
    want = np.stack(jvideo.read_video_frames(path))
    assert len(want) == int(z["count"])
    assert tuple(want.shape[1:]) == tuple(z["shape"])
    assert _digests(want) == list(z["sha256"])
    n = 4 if name == "asp_720p.mp4" else None
    got = tvideo.read_video_frames(path, max_frames=n, device=CPU).numpy()
    assert _digests(got) == list(z["sha256"][:n])


# -- hand-worked blocks -------------------------------------------------------


def test_mpeg_dequantisation_by_hand():
    """F = (2 l + k) W qp / 16 truncated toward zero (k = 0 intra, sign(l)
    inter), the intra DC by the dc_scaler, saturation, and mismatch
    control on inter blocks only (flip the last value's least bit where
    the block's sum is even)."""
    mats = torch.tensor([K.DEFAULT_INTRA_MATRIX, K.DEFAULT_INTER_MATRIX])
    lv = torch.zeros((3, 64), dtype=torch.int16)
    lv[0, 0], lv[0, 1] = 12, 3            # intra, qp 4
    lv[1, 63] = -2                        # inter, qp 5: odd sum
    lv[2, 63], lv[2, 8] = -2, 1           # inter, qp 5: even sum
    f = K.dequantize_mpeg_plain(lv, torch.tensor([4, 5, 5]),
                                torch.tensor([True, False, False]),
                                torch.tensor([True, True, False]), mats)
    assert f[0, 0] == 12 * 8               # dc_scaler(4) = 8
    assert f[0, 1] == (2 * 3 * 17 * 4) >> 4 == 25  # 25.5 truncated
    assert f[1, 63] == -((5 * 33 * 5) >> 4) == -51  # -51.56 truncated
    assert f[1].sum() % 2 == 1             # odd: no flip
    assert f[2, 8] == (3 * 17 * 5) >> 4 == 15  # W[1][0] = 17
    assert f[2, 63] == -51 ^ 1 == -52      # -51 + 15 is even: flipped
    big = torch.full((1, 64), 2000, dtype=torch.int16)
    g = K.dequantize_mpeg_plain(big, torch.tensor([31]),
                                torch.tensor([False]), torch.tensor([True]),
                                mats)
    assert (g[0, :63] == 2047).all() and g[0, 63] == 2046  # saturated


def test_direct_mode_vectors_by_hand():
    """MVF = TRB c / TRD + d, MVB = (TRB - TRD) c / TRD where d is 0, else
    MVF - c; every division truncates toward zero."""
    fwd, bwd = mpeg4.direct_vectors([(5, -3)], (0, 1), 1, 3)
    assert fwd == [(1, 0)]      # 5 / 3 = 1; -3 / 3 + 1 = 0
    assert bwd == [(-3, 3)]     # -10 / 3 = -3 (not -4); 0 - -3 = 3
    fwd, bwd = mpeg4.direct_vectors([(-7, 7)], (0, 0), 2, 3)
    assert fwd == [(-4, 4)] and bwd == [(2, -2)]  # -14 / 3 = -4; 7 / 3 = 2


def _planes(values, n_mb=1):
    """Slots of constant planes of one 16 x 16 macroblock: Y, U, V."""
    return [torch.stack([torch.full((16 * n_mb, 16), v, dtype=torch.uint8)
                         for v in values]),
            torch.stack([torch.full((8 * n_mb, 8), v, dtype=torch.uint8)
                         for v in values]),
            torch.stack([torch.full((8 * n_mb, 8), v, dtype=torch.uint8)
                         for v in values])]


def test_interpolated_macroblock_rounds_odd_sums_up():
    """An interpolated macroblock (forward and backward) of references 10
    and 13: (10 + 13 + 1) >> 1 = 12 everywhere, plus the residual, clipped
    (V5 always predicts with rounding 0); a backward-only one takes 13."""
    for qpel in (False, True):
        planes = _planes([10, 13, 0])
        bmb = torch.zeros((2, 1, K.B_FIELDS), dtype=torch.int32)
        bmb[:, 0, 0] = K.MB_INTER
        bmb[0, 0, 3] = K.B_FWD | K.B_BWD
        bmb[1, 0, 3] = K.B_BWD
        bmb[0, 0, 4:20] = 2 if qpel else 1  # x and y: a half / quarter pel
        res = torch.zeros((2, 1, 6, 64), dtype=torch.int16)
        res[0, 0, 0, 0], res[0, 0, 4, 1] = 300, -20
        items = torch.tensor([[0, 0, 1, 2]], dtype=torch.int32)
        K.bidir_compensate_plain(planes, bmb, res, items, 16, 16, qpel)
        y, u = planes[0][2], planes[1][2]
        assert y[0, 0] == 255 and (y.flatten()[1:] == 12).all()
        assert u[0, 1] == 0 and u[0, 0] == 12 and u[1:].eq(12).all()
        items = torch.tensor([[1, 0, 1, 2]], dtype=torch.int32)
        K.bidir_compensate_plain(planes, bmb, None, items, 16, 16, qpel)
        assert (planes[0][2] == 13).all() and (planes[2][2] == 13).all()


def test_quarter_pel_filter_mirrors_taps_at_the_block_edge():
    """The half sample between samples 0 and 1 of a row of an 8 x 8 block
    reads taps -3 .. 4, those left of the block mirrored (-1 -> 0, -2 ->
    1, -3 -> 2); between samples 7 and 8 taps 9, 10, 11 mirror to 8, 7, 6:
    worked by hand on one row, against qpel_block's."""
    s = [0, 40, 100, 180, 60, 250, 30, 90, 200, 255, 0, 0]
    ref = torch.tensor(s[:9], dtype=torch.int64).expand(9, 9).clone()
    got = K.qpel_block(ref, torch.tensor([0]), torch.tensor([0]),
                       torch.tensor([2]), torch.tensor([0]), 8, 9, 9, 0)
    left = (20 * (s[0] + s[1]) - 6 * (s[0] + s[2]) + 3 * (s[1] + s[3])
            - (s[2] + s[4]) + 16) >> 5
    right = (20 * (s[7] + s[8]) - 6 * (s[6] + s[8]) + 3 * (s[5] + s[7])
             - (s[4] + s[6]) + 16) >> 5
    assert got[0, 0, 0] == min(max(left, 0), 255)
    assert got[0, 0, 7] == min(max(right, 0), 255)
    # a quarter position is the mean of the half sample and its neighbour
    q = K.qpel_block(ref, torch.tensor([0]), torch.tensor([0]),
                     torch.tensor([1]), torch.tensor([0]), 8, 9, 9, 1)
    half1 = min(max((20 * (s[0] + s[1]) - 6 * (s[0] + s[2])
                     + 3 * (s[1] + s[3]) - (s[2] + s[4]) + 15) >> 5, 0), 255)
    assert q[0, 0, 0] == (half1 + s[0]) >> 1  # rounding type 1


# -- loaded matrices ----------------------------------------------------------


def _custom_matrices():
    intra = tuple(min(255, v + (i % 7)) for i, v in
                  enumerate(K.DEFAULT_INTRA_MATRIX))
    inter = [K.DEFAULT_INTER_MATRIX[i] + 3 for i in range(64)]
    for i in range(40, 64):  # a tail that repeats in zigzag order
        inter[mpeg4.ZIGZAG[i]] = 50
    return intra, tuple(inter)


def test_loaded_matrix_vol_parses_back():
    """load_intra_quant_mat / load_nonintra_quant_mat written with
    BitWriter (zigzag order, a 0 ending the inter one early, its last
    value repeated) read back as written; default ones load nothing."""
    intra, inter = _custom_matrices()
    vol = mpeg4.Vol(104, 104, 25, low_delay=False, quant_type=1,
                    quarter_sample=True, intra_matrix=intra,
                    inter_matrix=inter)
    dsi = mpeg4.write_vol_headers(vol)
    back = mpeg4.parse_vol(dsi)
    assert back == vol
    assert back.intra_matrix == intra and back.inter_matrix == inter
    plain = mpeg4.write_vol_headers(dataclasses.replace(
        vol, intra_matrix=K.DEFAULT_INTRA_MATRIX,
        inter_matrix=K.DEFAULT_INTER_MATRIX))
    # the intra matrix's 64 values, the inter one's 40 and its 0, two flags
    assert len(dsi) - len(plain) in (64 + 41, 64 + 41 + 1)


def test_loaded_matrices_decode_as_cv2(tmp_path):
    """The quarter-pel fixture's VOPs behind a VOL that loads other
    matrices: cv2 and the port decode the same (other) frames."""
    track = mp4.read_mp4(str(DATA / "asp_qpel_mpegq.mp4"))
    vol = mpeg4.parse_vol(track.dsi)
    intra, inter = _custom_matrices()
    dsi = mpeg4.write_vol_headers(dataclasses.replace(
        vol, intra_matrix=intra, inter_matrix=inter))
    path = str(tmp_path / "m.mp4")
    mp4.write_mp4(path, track.samples, list(track.sync), 104, 104, 25, dsi)
    want = np.stack(jvideo.read_video_frames(path))
    got = tvideo.read_video_frames(path, device=CPU).numpy()
    assert got.shape == want.shape == (24, 104, 104, 3)
    np.testing.assert_array_equal(got, want)
    usual = tvideo.read_video_frames(str(DATA / "asp_qpel_mpegq.mp4"),
                                     device=CPU).numpy()
    assert (got != usual).any(1).any(1).any(1).all()


# -- batches, N-VOPs, edges, max_frames ---------------------------------------


@pytest.mark.parametrize("batch", [2, 4, 5])
def test_batches_cut_next_to_b_vops_decode_as_the_whole(monkeypatch, batch):
    """Batches of a few VOPs: a cut never falls before a B-VOP (so each
    batch holds both anchors of its B-VOPs, or carries the past one), the
    last anchor of a batch leaves after the next batch's B-VOPs, and the
    frames equal one batch's for the whole stream."""
    samples, vol, headers, _ = _stream("asp_qpel_mpegq.mp4")
    whole = mpeg4.decode(samples, vol, CPU, headers=headers)
    plan = mpeg4.plan_stream(samples, vol, headers)
    cuts = mpeg4.batches(len(samples), None, batch, plan.kind)
    assert len(cuts) > 4
    assert all(plan.kind[lo] != mpeg4.VOP_B for lo, _ in cuts)
    monkeypatch.setattr(mpeg4, "batch_vops", lambda _vol: batch)
    parts = list(mpeg4.iter_decode(samples, vol, CPU, headers=headers))
    assert len(parts) == len(cuts)
    assert torch.equal(torch.cat(parts), whole)


def _simple_stream(vol, n_p, seed=0, vector=(0, 0)):
    """An I-VOP of random blocks then n_p P-VOPs of one vector each."""
    rng = np.random.default_rng(seed)
    n = vol.n_mb
    mb0 = np.zeros((n, mpeg4.MB_FIELDS), np.int32)
    mb0[:, 0], mb0[:, 1] = mpeg4.MB_INTRA, 4
    coef = np.zeros((n, 6, 64), np.int16)
    coef[:, :, 0] = rng.integers(30, 220, (n, 6)) // 8
    coef[:, :, 1:10] = rng.integers(-6, 7, (n, 6, 9))
    out = [mpeg4.write_vop([mpeg4.VOP_I, 0, 4, 1, 0, 0], mb0, coef, vol)]
    for j in range(n_p):
        mb = np.zeros((n, mpeg4.MB_FIELDS), np.int32)
        mb[:, 0], mb[:, 1] = mpeg4.MB_INTER, 4
        mb[:, 4::2], mb[:, 5::2] = vector
        lv = np.zeros((n, 6, 64), np.int16)
        lv[:, 0, 0] = rng.integers(-3, 4, n)
        out.append(mpeg4.write_vop([mpeg4.VOP_P, 0, 4, 1, 0, j + 1], mb, lv,
                                   vol))
    return out


def test_not_coded_vops_count_as_cv2_counts(tmp_path):
    """N-VOPs (vop_coded 0) in the middle show no frame, as FFmpeg
    decodes them; one at the end shows the last picture again."""
    vol = mpeg4.Vol(48, 32, 25)
    i, p1, p2 = _simple_stream(vol, 2)
    nvop = mpeg4.write_vop([mpeg4.VOP_SKIP, 0, 1, 1, 0, 3],
                           np.zeros((vol.n_mb, mpeg4.MB_FIELDS), np.int32),
                           np.zeros((vol.n_mb, 6, 64), np.int16), vol)
    for samples, n in (([i, nvop, p1, nvop, p2], 3),
                       ([i, p1, nvop, p2, nvop], 4)):
        path = str(tmp_path / f"n{n}.mp4")
        mp4.write_mp4(path, samples, [True] + [False] * 4, 48, 32, 25,
                      mpeg4.write_vol_headers(vol))
        want = np.stack(jvideo.read_video_frames(path))
        got = tvideo.read_video_frames(path, device=CPU).numpy()
        assert len(want) == len(got) == n
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qpel", [False, True])
def test_references_are_padded_from_the_decoded_macroblocks(tmp_path, qpel):
    """Vectors that point below a 104-px picture read the reference's
    decoded rows 104 .. 111 (FFmpeg pads from the macroblocks, not from
    the VOP's height, except for old encoders' streams): equal to cv2;
    clamping at the VOP's height would differ by tens of levels."""
    vol = mpeg4.Vol(104, 104, 25, quarter_sample=qpel, low_delay=True)
    samples = _simple_stream(vol, 1, seed=1,
                             vector=(0, 13 if qpel else 7))
    path = str(tmp_path / "e.mp4")
    mp4.write_mp4(path, samples, [True, False], 104, 104, 25,
                  mpeg4.write_vol_headers(vol))
    want = np.stack(jvideo.read_video_frames(path))
    got = tvideo.read_video_frames(path, device=CPU).numpy()
    np.testing.assert_array_equal(got, want)
    visible = mpeg4.Quirks(visible_edge=True)
    plan = mpeg4.plan_stream(samples, vol)
    rows = np.stack([plan.kind, plan.trb, plan.trd], 1)
    recs = mpeg4.entropy_decode(samples, vol, CPU, rows)
    planes = mpeg4.reconstruct(recs, vol, None, visible)
    other = mpeg4.yuv420_to_rgb(*[p[2:3] for p in planes], 104, 104)
    assert int((other[0].int() - torch.from_numpy(want[1]).int()).abs()
               .max()) > 20


def test_max_frames_counts_in_display_order():
    """The first n frames in display order, as cv2 returns them: with
    B-VOPs these need samples beyond the n-th."""
    path = str(DATA / "asp_bframes.mp4")
    want = np.stack(jvideo.read_video_frames(path, max_frames=5))
    got = tvideo.read_video_frames(path, max_frames=5, device=CPU).numpy()
    assert got.shape[0] == 5
    np.testing.assert_array_equal(got, want)
    chunks = list(tvideo.video_frame_chunks(path, 10, CPU))
    assert [c.shape[0] for c in chunks] == [10, 10, 4]


def test_intra_blocks_take_no_mismatch_control_as_ffmpeg():
    """Where FFmpeg departs from ISO/IEC 14496-2: it applies no mismatch
    control to intra blocks (its encoder's reconstruction neither), and
    the port decodes as it does. With the standard's control on intra
    blocks every frame of the quarter-pel fixture would differ from cv2's,
    by at most 4 levels: the bound of the departure."""
    path = str(DATA / "asp_qpel_mpegq.mp4")
    want = np.stack(jvideo.read_video_frames(path))
    orig = K.dequantize_mpeg_plain

    def standard(levels, qp, intra, luma, matrices):
        f = orig(levels, qp, intra, luma, matrices)
        flip = intra & (f.sum(1) % 2 == 0)
        f[:, 63] = torch.where(flip, f[:, 63] ^ 1, f[:, 63])
        return f

    K.dequantize_mpeg_plain = standard
    try:
        got = tvideo.read_video_frames(path, device=CPU).numpy()
    finally:
        K.dequantize_mpeg_plain = orig
    diff = np.abs(got.astype(int) - want).max((1, 2, 3))
    assert (diff > 0).all() and diff.max() <= 4, diff.tolist()


# -- what stays refused -------------------------------------------------------


def _vol_bits(interlaced=0, sprite=0, partitioned=0) -> bytes:
    """A verid-2 VOL with the given flags, written field by field."""
    bw = mpeg4.BitWriter()
    bw.put(0x120, 32)
    for v, n in ((0, 1), (17, 8), (1, 1), (2, 4), (1, 3), (1, 4), (1, 1),
                 (1, 2), (0, 1), (0, 1), (0, 2), (1, 1), (25, 16), (1, 1),
                 (0, 1), (1, 1), (64, 13), (1, 1), (48, 13), (1, 1),
                 (interlaced, 1), (1, 1), (sprite, 2), (0, 1), (0, 1),
                 (0, 1), (1, 1), (1, 1), (partitioned, 1), (0, 1), (0, 1),
                 (0, 1), (0, 1)):
        bw.put(v, n)
    bw.stuff()
    return bw.bytes()


@pytest.mark.parametrize("flags,name", [
    ({"interlaced": 1}, "interlacing"),
    ({"sprite": 2}, "sprites or GMC"),
    ({"partitioned": 1}, "data partitioning"),
])
def test_refusals_that_stay_raise_by_name(flags, name):
    """Interlacing, sprites/GMC and data partitioning raise a
    BitstreamError naming the feature and Queue 1 item 7b; the same VOL
    without the flag parses."""
    assert mpeg4.parse_vol(_vol_bits()).quant_type == 0
    with pytest.raises(mpeg4.BitstreamError, match=name) as err:
        mpeg4.parse_vol(_vol_bits(**flags))
    assert "Queue 1 item 7b" in str(err.value)


def test_avi_of_another_codec_raises_naming_its_fourcc(tmp_path):
    """The Xvid fixture with its strf compression set to H264: refused,
    naming the fourcc and Queue 1 item 7b."""
    data = (DATA / "asp_xvid.avi").read_bytes()
    at = data.index(b"strf") + 8 + 16  # BITMAPINFOHEADER.biCompression
    assert data[at: at + 4] == b"XVID"
    bad = tmp_path / "h264.avi"
    bad.write_bytes(data[:at] + b"H264" + data[at + 4:])
    with pytest.raises(ValueError, match="'H264'.*Queue 1 item 7b"):
        tvideo.read_video_frames(str(bad), device=CPU)


def test_s_vops_raise_by_name():
    """An S-VOP (vop_coding_type 3) raises naming it, whether the VOP is
    parsed or the stream planned."""
    vol = mpeg4.Vol(32, 32, 25)
    svop = bytes([0, 0, 1, 0xB6, 0xD0, 0x60, 0, 0])
    with pytest.raises(mpeg4.BitstreamError, match="S-VOPs"):
        mpeg4.parse_vop(svop, vol)
    with pytest.raises(mpeg4.BitstreamError, match="Queue 1 item 7b"):
        mpeg4.plan_stream([svop], vol)
