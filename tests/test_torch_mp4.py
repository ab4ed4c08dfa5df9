"""The port's mp4 in and out (`io/mp4.py`, `io/mpeg4.py`, the plain
versions of `ops/mpeg4_cuda.py`) against the JAX package's cv2 path
(`faceoff_tpu/io/video.py`, FFmpeg's `mp4v`), on the CPU:

  * the container: a round trip, cv2's layout (`moov` after `mdat`),
    64-bit chunk offsets, the refusal of an H.264 (avc1) entry without
    its avcC record and of HEVC;
  * the decoder on files that `faceoff_tpu.io.video.save_frames_as_video`
    writes: the port's frames equal cv2's bit for bit. Tolerance 0,
    derived: the I-VOPs already agree exactly (the port converts YUV to
    RGB in FFmpeg's fixed point, as cv2 does) and the port's IDCT is the
    integer simple IDCT that FFmpeg decodes its own streams with, so no
    mismatch drifts through the P-VOPs;
  * the encoder read by the JAX package: the same frame count and size,
    PSNR no more than 1 dB below cv2's own `mp4v` round trip, bytes a
    frame at most twice cv2's, and the port's decode equal to the
    encoder's reconstruction bit for bit;
  * every VLC table entry and the three TCOEF escape modes through the
    plain writer and reader;
  * streams cv2's writer never emits (four vectors a macroblock, AC
    prediction, video packets with resync markers, DQUANT, the DC coded
    as a TCOEF), built with the plain writer, decoded by the port and by
    cv2 alike (tolerance 0, as above), and a not-coded VOP.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from faceoff_tpu.io import video as jvideo
from faceoff_tpu_torch.data.synthetic import video_frames
from faceoff_tpu_torch.io import mp4, mpeg4
from faceoff_tpu_torch.io import video as tvideo

CPU = torch.device("cpu")
DATA = Path(__file__).resolve().parent / "data_torch"


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return float(10 * np.log10(255 ** 2 / mse))


def _boxes(data: bytes, lo: int = 0, hi: int = None):
    hi = len(data) if hi is None else hi
    return [kind for kind, _, _ in mp4._boxes(data, lo, hi)]


# -- the container ------------------------------------------------------------


@pytest.mark.parametrize("co64", [False, True])
def test_container_round_trip(tmp_path, co64):
    """write_mp4 -> read_mp4 gives the samples, key frames, size and
    timescale back, with 32- or 64-bit chunk offsets; cv2 reads both."""
    frames = video_frames(14, 48, seed=2)[0]
    samples, sync, dsi, recon = mpeg4.encode(frames, 25, return_recon=True)
    path = str(tmp_path / "a.mp4")
    mp4.write_mp4(path, samples, sync, 48, 48, 25, dsi, co64=co64)
    data = Path(path).read_bytes()
    assert _boxes(data) == [b"ftyp", b"mdat", b"moov"]
    assert (b"co64" in data) == co64 and (b"stco" in data) != co64
    assert mp4.sniff(path) == "mp4"
    track = mp4.read_mp4(path)
    assert track.samples == samples and track.dsi == dsi
    assert list(track.sync) == sync == [True] + [False] * 11 + [True, False]
    assert (track.width, track.height, track.timescale) == (48, 48, 25)
    assert list(track.durations) == [1] * 14
    assert mp4.read_mp4(path, max_frames=3).samples == samples[:3]
    got = np.stack(jvideo.read_video_frames(path))
    np.testing.assert_array_equal(got, recon.numpy())


def test_reads_the_fixture_in_cv2s_layout():
    """The committed fixture (cv2's writer): moov after mdat, an edit
    list, GOV headers in the key samples; decoded equal to cv2's stored
    decode."""
    path = str(DATA / "face_mp4v.mp4")
    data = Path(path).read_bytes()
    top = _boxes(data)
    assert top.index(b"moov") > top.index(b"mdat")
    track = mp4.read_mp4(path)
    vol = mpeg4.parse_vol(track.dsi)
    assert (vol.width, vol.height, len(track.samples)) == (104, 104, 24)
    assert list(np.nonzero(track.sync)[0]) == [0, 12]
    assert track.samples[0][:4] == b"\0\0\1\xb3"  # a GOV header first
    want = np.load(DATA / "face_mp4v.npz")["frames"]
    got = tvideo.read_video_frames(path, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    chunks = list(tvideo.video_frame_chunks(path, 10, CPU))
    assert [c.shape[0] for c in chunks] == [10, 10, 4]
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), want)


def test_refuses_h264_naming_the_codec(tmp_path):
    """An MP4 whose sample entry is avc1 (a hand-built H.264 moov with no
    avcC record) or hev1 raises a ValueError naming the codec, whatever
    its name."""
    frames = video_frames(2, 32, seed=1)[0]
    samples, sync, dsi, _ = mpeg4.encode(frames, 25)
    good = str(tmp_path / "g.mp4")
    mp4.write_mp4(good, samples, sync, 32, 32, 25, dsi)
    for kind, name in ((b"avc1", "H.264 (avc1)"), (b"hev1", "HEVC (hev1)")):
        bad = tmp_path / f"clip_{kind.decode()}.mov"
        bad.write_bytes(Path(good).read_bytes().replace(b"mp4v", kind))
        assert mp4.sniff(str(bad)) == "mp4"
        with pytest.raises(ValueError, match=name.replace("(", r"\(")
                           .replace(")", r"\)").replace(".", r"\.")):
            tvideo.read_video_frames(str(bad), device=CPU)


# -- the decoder against cv2 ------------------------------------------------------


@pytest.mark.parametrize("size,seed", [(64, 1), (104, 4), (104, 7)])
def test_decoder_equals_cv2_on_cv2_files(tmp_path, size, seed):
    """24 frames (two of cv2's GOPs) of a drifting synthetic face, so that
    the vectors are not zero, written by the JAX package: the port's
    decode equals cv2's, frame by frame, bit for bit."""
    frames = video_frames(24, size, seed=seed)[0].numpy()
    path = str(tmp_path / "j.mp4")
    jvideo.save_frames_as_video(list(frames), path)
    track = mp4.read_mp4(path)
    vol = mpeg4.parse_vol(track.dsi)
    vop, mb, _, _ = mpeg4.parse_vops(track.samples, vol)
    assert (vop[:, 0] == mpeg4.VOP_P).sum() == 22
    assert np.abs(mb[:, :, 4:12]).max() > 0  # the face moves
    want = np.stack(jvideo.read_video_frames(path))
    got = tvideo.read_video_frames(path, device=CPU).numpy()
    assert got.shape == want.shape == (24, size, size, 3)
    for f in range(24):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"frame {f}")


# -- the encoder read by the JAX package --------------------------------------------


@pytest.mark.parametrize("size", [104, 256])
def test_encoder_read_by_jax_package(tmp_path, size):
    """The port's writer (default qscale) against cv2's own mp4v round
    trip of the same 24 frames (seed 4): cv2 reads the port's file with
    the same count and size and as the port decodes it; PSNR at most
    1 dB below cv2's, bytes a frame at most twice cv2's; the port's
    decode equals the encoder's reconstruction bit for bit."""
    frames = video_frames(24, size, seed=4)[0]
    ours = str(tmp_path / "t.mp4")
    theirs = str(tmp_path / "j.mp4")
    tvideo.save_frames_as_video(frames, ours, device=CPU)
    jvideo.save_frames_as_video(list(frames.numpy()), theirs)
    back = np.stack(jvideo.read_video_frames(ours))
    assert back.shape == (24, size, size, 3)
    got = tvideo.read_video_frames(ours, device=CPU)
    np.testing.assert_array_equal(back, got.numpy())
    *_, recon = mpeg4.encode(frames, 25, return_recon=True)
    assert torch.equal(got, recon)
    src = frames.numpy()
    cv = np.stack(jvideo.read_video_frames(theirs))
    psnr_port = np.mean([_psnr(a, b) for a, b in zip(src, back)])
    psnr_cv2 = np.mean([_psnr(a, b) for a, b in zip(src, cv)])
    bytes_port = sum(map(len, mp4.read_mp4(ours).samples)) / 24
    bytes_cv2 = sum(map(len, mp4.read_mp4(theirs).samples)) / 24
    print(f"{size} px, 24 frames: the port {bytes_port:.2f} bytes a frame, "
          f"{psnr_port:.2f} dB; cv2 {bytes_cv2:.2f} bytes, {psnr_cv2:.2f} dB")
    assert psnr_port >= psnr_cv2 - 1.0, (psnr_port, psnr_cv2)
    assert bytes_port <= 2 * bytes_cv2, (bytes_port, bytes_cv2)


# -- batches and the quantiser -----------------------------------------------------


def test_batch_vops_fits_whole_gops_in_the_budget():
    """A batch is the most whole GOPs within BATCH_BYTES, and one GOP for
    a frame too large for even that."""
    for w, h in ((1280, 720), (256, 256), (104, 104)):
        vol = mpeg4.Vol(w, h, 25)
        n = mpeg4.batch_vops(vol)
        per = mpeg4.WORK_BYTES * 256 * vol.n_mb
        assert n % mpeg4.GOP == 0 and n * per <= mpeg4.BATCH_BYTES
        assert (n + mpeg4.GOP) * per > mpeg4.BATCH_BYTES
    assert mpeg4.batch_vops(mpeg4.Vol(16384, 16384, 25)) == mpeg4.GOP


@pytest.mark.parametrize("batch,use_sync", [(12, True), (5, True),
                                            (5, False)])
def test_batches_give_the_whole_clips_bits_and_frames(monkeypatch, batch,
                                                      use_sync):
    """Encoding and decoding in batches smaller than the clip (whole GOPs,
    or 5 VOPs that cut GOPs, with and without the key-frame flags, so the
    last reconstruction is carried into the next batch mid-GOP) gives the
    bytes and frames of one batch for the whole clip."""
    frames = video_frames(26, 48, seed=3)[0]
    samples, sync, dsi, recon = mpeg4.encode(frames, 25, return_recon=True)
    vol = mpeg4.parse_vol(dsi)
    whole = mpeg4.decode(samples, vol, CPU, sync)
    assert torch.equal(whole, recon)
    monkeypatch.setattr(mpeg4, "batch_vops", lambda _vol: batch)
    if batch % mpeg4.GOP == 0:
        got, got_sync, _, got_recon = mpeg4.encode(frames, 25,
                                                   return_recon=True)
        assert got == samples and got_sync == sync
        assert torch.equal(got_recon, recon)
    parts = list(mpeg4.iter_decode(samples, vol, CPU,
                                   sync if use_sync else None))
    assert max(p.shape[0] for p in parts) <= batch
    assert torch.equal(torch.cat(parts), whole)


def test_a_coarser_qscale_writes_fewer_bytes_and_decodes_to_its_recon():
    """encode's qscale: at 12 the stream is smaller and further from the
    frames than at the default, and decodes to its own reconstruction."""
    frames = video_frames(13, 48, seed=5)[0]
    out = {}
    for q in (mpeg4.DEFAULT_QSCALE, 12):
        samples, sync, dsi, recon = mpeg4.encode(frames, 25, qscale=q,
                                                 return_recon=True)
        back = mpeg4.decode(samples, mpeg4.parse_vol(dsi), CPU, sync)
        assert torch.equal(back, recon)
        out[q] = (sum(map(len, samples)),
                  np.mean([_psnr(a, b) for a, b in
                           zip(frames.numpy(), back.numpy())]))
    assert out[12][0] < out[mpeg4.DEFAULT_QSCALE][0]
    assert out[12][1] < out[mpeg4.DEFAULT_QSCALE][1]
    with pytest.raises(ValueError, match="qscale 32"):
        mpeg4.encode(frames, 25, qscale=32)


# -- the tables ------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["MCBPC_I", "MCBPC_P", "CBPY", "DC_LUMA",
                                  "DC_CHROMA", "MVD"])
def test_every_vlc_entry_round_trips(name):
    codes = getattr(mpeg4, name)
    bw = mpeg4.BitWriter()
    for code in codes:
        bw.put(*code)
    br = mpeg4.BitReader(bw.bytes())
    vlc = mpeg4.Vlc(codes)
    assert [br.vlc(vlc) for _ in codes] == list(range(len(codes)))


def _escape_mode(table, last, run, level) -> int:
    """0 for a plain code, else the escape mode the writer used."""
    bw = mpeg4.BitWriter()
    mpeg4.put_tcoef(bw, table, last, run, level)
    bits = "".join(bw.parts)
    esc = format(mpeg4.ESCAPE[0], f"0{mpeg4.ESCAPE[1]}b")
    if not bits.startswith(esc) or (last, run, abs(level)) in table.encode:
        return 0
    rest = bits[len(esc):]
    return 1 if rest[0] == "0" else (2 if rest[1] == "0" else 3)


@pytest.mark.parametrize("kind", ["inter", "intra"])
def test_every_tcoef_entry_and_the_three_escapes_round_trip(kind):
    """Every (last, run, level) of the table with both signs, then events
    that only the escapes reach: level beyond LMAX (mode 1), a run longer
    than the table's with level 1 (mode 2: run beyond RMAX) and fixed
    length (mode 3, up to 2047 and run 63)."""
    table = mpeg4.INTER_TCOEF if kind == "inter" else mpeg4.INTRA_TCOEF
    events = [(last, run, s * level) for last, run, level in table.symbols
              for s in (1, -1)]
    want_modes = {}
    for last in (0, 1):
        lmax, rmax = table.lmax[last], table.rmax[last]
        for run in (0, 1, len(lmax) - 1):
            e = (last, run, lmax[run] + 1)
            want_modes[e] = 1
        for e in ((last, rmax[1] + 1, -1), (last, rmax[1] + 3, 1)):
            want_modes[e] = 2
        for e in ((last, 0, lmax[0] * 2 + 5), (last, 63, 2),
                  (last, 5, -2047), (last, 40, 2047)):
            want_modes[e] = 3
    events += list(want_modes)
    for e, mode in want_modes.items():
        assert _escape_mode(table, *e) == mode, e
    bw = mpeg4.BitWriter()
    for e in events:
        mpeg4.put_tcoef(bw, table, *e)
    br = mpeg4.BitReader(bw.bytes())
    vlc = mpeg4._TCOEF_VLC[id(table)]
    got = [mpeg4._read_tcoef(br, table, vlc) for _ in events]
    assert got == events


@pytest.mark.parametrize("fcode", [1, 2, 3])
def test_vector_differences_and_dc_round_trip(fcode):
    f32 = 32 << (fcode - 1)
    diffs = list(range(-f32, f32))
    bw = mpeg4.BitWriter()
    for d in diffs:
        mpeg4.put_mvd(bw, d, fcode)
    dcs = [0, 1, -1, 255, -255, 256, -2047, 2047]
    for d in dcs:
        mpeg4.put_dc(bw, d, True)
        mpeg4.put_dc(bw, d, False)
    br = mpeg4.BitReader(bw.bytes())
    assert [mpeg4._read_mv(br, 0, fcode) for _ in diffs] == diffs
    for d in dcs:
        for luma in (True, False):
            size = br.vlc(mpeg4._DC_VLC[not luma])
            v = br.read(size) if size else 0
            if size and not v >> (size - 1):
                v -= (1 << size) - 1
            if size > 8:
                br.marker()
            assert v == d


# -- what cv2's writer never emits ----------------------------------------------------


def _random_records(rng, vol: mpeg4.Vol, n: int):
    """Records of n VOPs (an I then P-VOPs) that use four vectors, AC
    prediction, video packets and DQUANT: (vops, mbs, coefs, packets).
    Levels stay where |F| = qp (2 |l| + 1) <= 2047 (qp <= 16, |l| <= 60):
    the standard saturates larger ones, FFmpeg does not."""
    m_count = vol.n_mb
    vops, mbs, coefs, packets = [], [], [], []
    for f in range(n):
        kind = mpeg4.VOP_I if f == 0 else mpeg4.VOP_P
        qp = int(rng.integers(4, 14))
        # rounding type 0: FFmpeg averages the half-pel samples of rounding
        # type 1 with approximate SIMD unless asked for bit exactness (up
        # to 3 levels off on these noisy blocks); cv2's own streams, whose
        # P-VOPs alternate the type, are held exactly above
        vops.append([kind, 0, qp, 2, 0, f])
        starts = sorted(int(m) for m in rng.choice(
            np.arange(1, m_count), 3, replace=False))
        mb = np.zeros((m_count, mpeg4.MB_FIELDS), np.int32)
        coef = np.zeros((m_count, 6, 64), np.int16)
        running, first = qp, 0
        for m in range(m_count):
            if m in starts:
                running = int(rng.integers(3, 14))
                first = m
            modes = ([mpeg4.MB_INTRA] if kind == mpeg4.VOP_I else
                     [mpeg4.MB_SKIP, mpeg4.MB_INTER, mpeg4.MB_INTER,
                      mpeg4.MB_INTRA])
            mode = int(rng.choice(modes))
            four = mode == mpeg4.MB_INTER and rng.random() < 0.5
            mqp = running
            if m != first and mode != mpeg4.MB_SKIP and not four:
                mqp = int(np.clip(running + rng.choice(
                    [0, 0, -1, 1, -2, 2]), 1, 16))
            running = mqp if mode != mpeg4.MB_SKIP else running
            mb[m, 0], mb[m, 1] = mode, mqp
            mx = m % vol.mb_width
            # cv2 takes a stale left predictor at a packet's first
            # macroblock (the standard: none): no AC prediction there
            left_out = mx > 0 and m - 1 < first
            mb[m, 3] = int(mode == mpeg4.MB_INTRA and not left_out
                           and rng.random() < 0.7)
            if mode == mpeg4.MB_INTER:
                v = rng.integers(-24, 25, (4 if four else 1, 2))
                mb[m, 4:12] = np.resize(v, (4, 2)).reshape(-1)
            if mode == mpeg4.MB_SKIP:
                continue
            for b in range(6):
                lv = np.zeros(64, np.int16)
                k = int(rng.integers(0, 6))
                pos = rng.integers(1, 64, k)
                lv[pos] = rng.integers(-40, 41, k)
                if rng.random() < 0.1:  # escape mode 3, within 2047
                    lv[int(rng.integers(1, 64))] = int(rng.integers(-60, 61))
                if mode == mpeg4.MB_INTRA:
                    scale = mpeg4.dc_scaler(mqp, b < 4)
                    lv[0] = int(rng.integers(300, 1700)) // scale
                coef[m, b] = lv
        mbs.append(mb)
        coefs.append(coef)
        packets.append(starts)
    return np.asarray(vops, np.int32), mbs, coefs, packets


@pytest.mark.parametrize("thr", [0, 7])
def test_streams_cv2s_writer_never_emits(tmp_path, thr):
    """Six VOPs at 96 x 64 with four vectors, AC prediction (both
    alternate scans), video packets that start mid-row, DQUANT, and with
    thr 7 the intra DC coded as a TCOEF: the port's decode equals cv2's
    bit for bit, and the records parse back as written."""
    rng = np.random.default_rng(100 + thr)
    vol = mpeg4.Vol(96, 64, 25, resync_marker_disable=False)
    vops, mbs, coefs, packets = _random_records(rng, vol, 6)
    samples = [mpeg4.write_vop(v, mb, c, vol, packets=p, thr=thr)
               for v, mb, c, p in zip(vops, mbs, coefs, packets)]
    path = str(tmp_path / "s.mp4")
    mp4.write_mp4(path, samples, [True] + [False] * 5, 96, 64, 25,
                  mpeg4.write_vol_headers(vol))
    vop, mb, _, _ = mpeg4.parse_vops(samples, vol)
    assert vop[:, 2].tolist() == vops[:, 2].tolist()
    modes = np.stack(mbs)[:, :, 0]
    assert ((mb[:, :, 0] == mpeg4.MB_SKIP) == (modes == mpeg4.MB_SKIP)).all()
    four = (mb[:, :, 4:12].reshape(6, -1, 4, 2) != mb[:, :, 4:6].reshape(
        6, -1, 1, 2)).any((2, 3))
    assert four.any() and mb[:, :, 3].any()
    np.testing.assert_array_equal(mb[:, :, 4:12], np.stack(mbs)[:, :, 4:12])
    want = np.stack(jvideo.read_video_frames(path))
    got = tvideo.read_video_frames(path, device=CPU).numpy()
    assert got.shape == want.shape == (6, 64, 96, 3)
    for f in range(6):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"VOP {f}")


def test_not_coded_vop_repeats_the_previous_frame():
    frames = video_frames(3, 32, seed=3)[0]
    samples, _, dsi, recon = mpeg4.encode(frames, 25, return_recon=True)
    vol = mpeg4.parse_vol(dsi)
    skip = mpeg4.write_vop([mpeg4.VOP_SKIP, 0, 1, 1, 0, 3],
                           np.zeros((vol.n_mb, mpeg4.MB_FIELDS), np.int32),
                           np.zeros((vol.n_mb, 6, 64), np.int16), vol)
    got = mpeg4.decode(samples + [skip], vol, CPU)
    assert torch.equal(got[:3], recon) and torch.equal(got[3], got[2])


def test_refusals_name_the_feature():
    """A VOL with data partitioning and an S-VOP (sprites, GMC) raise
    naming what the decoder does not read (B-VOPs are read since the
    Advanced Simple Profile: tests/test_torch_mpeg4_asp.py)."""
    vol = mpeg4.Vol(32, 32, 25)
    dsi = bytearray(mpeg4.write_vol_headers(vol))
    bits = "".join(format(b, "08b") for b in dsi)
    # data_partitioned is the bit after resync_marker_disable
    i = bits.rindex("0000000100100000") + 16  # VOL start code
    br = mpeg4.BitReader(bytes(dsi), i)
    mpeg4._parse_vol_body(br)
    flag = br.pos - 2  # data_partitioned, then scalability
    bits = bits[:flag] + "1" + bits[flag + 1:]
    bad = int(bits, 2).to_bytes(len(dsi), "big")
    with pytest.raises(ValueError, match="data partitioning"):
        mpeg4.parse_vol(bad)
    svop = bytes([0, 0, 1, 0xB6, 0b11000000, 0, 0])
    with pytest.raises(ValueError, match="S-VOPs"):
        mpeg4.parse_vop(svop, vol)
