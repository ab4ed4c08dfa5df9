"""The port on the card: the warp kernels (forward and backward) and the
VQ kernels against their plain versions, the serving path and a training
step on CUDA against the same on the CPU, nvJPEG on the committed
fixtures, the copy to the card, a resume through the command line, and
the swap: the warp of a swap chunk and the swap command line's device
pipeline; the GAN stage: its kernels at the path's shapes and a
mocoganhd pair's launches; the functional streaming push and a serving
bundle exported for the card; VQVAE_B2F's training forward (its six
quantizers through the VQ kernels) and the shardmap step in a one-rank
NCCL group against the plain step; the training quantizer's plain
route (--no_pallas: no VQ launch, repeatable sums); mp4: kernels V1-V4
against their plain versions at every call of a round trip, V1-V4 on
adversarial inputs
(every qp, levels at the clamps, rows that wrap int16, columns that take
64 bits, bidx in any order; every half-pel phase, both rounding types,
vectors far outside the picture, residuals at the int16 extremes; ties,
shifts past the search range, every border clamp, both DC clamps, the
largest coefficients), and the C++ entropy coder against the Python
one; the Advanced Simple Profile: V1's MPEG and Xvid forms, V2 at
quarter-pel and V5 at every call of the fixtures' decodes and on
adversarial inputs, the C++ coder's B-VOPs against the Python one;
kernels A and B at the edges of their designs: components across
tile borders, ragged and odd sizes, full-foreground and serpentine 720p
frames, an odd mask address; no point, counts of points no multiple of a
block's, points beyond every border, dropped pyramid levels; H.264: H1-H4
(csrc/h264.cu) against their plain versions at every call of the 104-px
fixtures' decodes and on adversarial inputs (QP 0 and 51 with maximal
levels; vectors crossing each picture edge by 1-64 px at every
quarter-pel phase; all-intra and mixed pictures with slices of one
macroblock; every bS at both QP extremes), and the C++ macroblock parser
against the Python one on all four fixtures.

Marked `cuda`; each test skips where there is no CUDA device. The file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.data.resident import (corpus_from_arrays,
                                             make_resident_prepare)
from faceoff_tpu_torch.data.synthetic import (draw_face, face_landmarks,
                                              synthetic_corpus)
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.models.lpips import init_lpips
from faceoff_tpu_torch.ops import vq as V
from faceoff_tpu_torch.ops import vq_cuda
from faceoff_tpu_torch.ops import warp as W
from faceoff_tpu_torch.ops import warp_cuda
from faceoff_tpu_torch.serve import (StreamingSwapper, SwapSession,
                                     load_bundle, make_stream_steps,
                                     save_bundle)
from faceoff_tpu_torch.train.state import create_train_state, make_optimizer
from faceoff_tpu_torch.train.train_step import make_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,h,w,c,oh,ow", [(1, 256, 256, 3, 256, 256),
                                           (4, 64, 96, 3, 40, 200)])
def test_kernel_matches_plain(cuda, n, h, w, c, oh, ow):
    rng = np.random.default_rng(5)
    imgs = rng.uniform(-1, 1, (n, h, w, c)).astype(np.float32)
    xs = rng.uniform(-3, w + 2, (n, oh, ow)).astype(np.float32)
    ys = rng.uniform(-3, h + 2, (n, oh, ow)).astype(np.float32)
    xs[:, ::3] = np.round(xs[:, ::3])
    args = [torch.from_numpy(a).to(cuda) for a in (imgs, xs, ys)]
    before = warp_cuda.launches
    got = W.batched_bilinear_warp(*args)
    torch.cuda.synchronize()
    assert warp_cuda.launches == before + 1
    ref = W._bilinear_sample(*args)
    assert (got - ref).abs().max().item() <= 1e-5


def test_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.zeros((1, 8, 8, 3), device=cuda)
    g = torch.zeros((1, 8, 8), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        warp_cuda.bilinear_warp(x.half(), g, g)
    with pytest.raises(ValueError, match="contiguous"):
        warp_cuda.bilinear_warp(x, g.transpose(1, 2), g)
    with pytest.raises(ValueError, match="CUDA tensor"):
        warp_cuda.bilinear_warp(x, g.cpu(), g)


def test_swap_session_on_card_matches_cpu(cuda):
    """A tiny float32 SwapSession gives the same frames on both devices
    (TF32 off), with one kernel launch per push on the card."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(channel=16, n_res_block=1, n_res_channel=8,
                      embed_dim=8, n_embed=32)
    cpu_model = VQVAE(cfg, dtype=torch.float32, device="cpu")
    gpu_model = VQVAE(cfg, dtype=torch.float32, device=cuda)
    frames = []
    for i in range(5):
        lms = face_landmarks((32 + i, 32), 14.0)
        img = draw_face(torch.full((64, 64, 3), 30, dtype=torch.uint8), lms,
                        (205, 165, 135))
        frames.append((img, lms))
    outs = {}
    for name, model in (("cpu", cpu_model), ("cuda", gpu_model)):
        device = model.quantize_t.embed.device
        sess = SwapSession(model, height=64, width=64, device=device)
        before = warp_cuda.launches
        got = sess.push_many([f for f, _ in frames], [l for _, l in frames],
                             [f for f, _ in frames[::-1]],
                             [l for _, l in frames[::-1]])
        got += sess.flush()
        if name == "cuda":
            assert warp_cuda.launches == before + 5
        outs[name] = torch.stack(got).cpu()
    torch.testing.assert_close(outs["cuda"], outs["cpu"], atol=2e-4, rtol=1e-3)


def test_functional_push_and_export_on_card(cuda, tmp_path):
    """On the card: make_stream_steps' push equals StreamingSwapper.push
    bitwise, a push under CUDA's sync debug mode reads nothing back, and
    a tiny bf16 bundle exported for cuda reproduces the eager model."""
    cfg = ModelConfig(channel=16, n_res_block=1, n_res_channel=8,
                      embed_dim=8, n_embed=32)
    model = VQVAE(cfg, dtype=torch.bfloat16, device=cuda)
    video = torch.rand((1, 5, 32, 32, 6), generator=torch.Generator()
                       .manual_seed(3)).to(cuda) * 2 - 1
    init, push, flush, delay, _ = make_stream_steps(model, device=cuda)
    sw = StreamingSwapper(model, height=32, width=32, device=cuda)
    state, outs = init(1, 32, 32), []
    for t in range(5):
        state, out = push(state, video[:, t])
        got = sw.push(video[:, t])
        if t >= delay:
            assert torch.equal(got, out)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        push(state, video[:, 0])
    finally:
        torch.cuda.set_sync_debug_mode("default")

    meta = save_bundle(str(tmp_path), model, frames=5, size=32)
    assert meta["platforms"] == ["cuda"]
    bundle = load_bundle(str(tmp_path))
    with torch.no_grad():
        want = model(video)[0][..., :3]
    torch.testing.assert_close(bundle.offline(video), want, atol=2e-4,
                               rtol=1e-3)
    state_a, state_b = init(1, 32, 32), bundle.init_state()
    for t in range(5):
        state_a, a = push(state_a, video[:, t])
        state_b, b = bundle.push(state_b, video[:, t])
        torch.testing.assert_close(b, a, atol=2e-4, rtol=1e-3)
    for _ in range(delay):
        state_a, a = flush(state_a, torch.tensor(5, dtype=torch.int32,
                                                 device=cuda))
        state_b, b = bundle.flush(state_b, 5)
        torch.testing.assert_close(b, a, atol=2e-4, rtol=1e-3)


def _check_vq(x, e, out):
    """Indices equal to the plain version's except within float32 rounding
    of a tie (margin 2 (D+1) u (|x|@|E| + ||E||^2/2) per row,
    u = 2^-24); quant an exact copy of the picked codes; counts exact;
    sums within 2 c_k u sum|x| of the plain sums of the same indices."""
    idx, quant, counts, sums = out
    d, k = e.shape
    ref_idx = V.vq_assign_plain(x, e)[0]
    hn = 0.5 * (e * e).sum(0)
    scores = x @ e - hn
    margin = 2 * (d + 1) * 2.0 ** -24 * (x.abs() @ e.abs() + hn).amax(1)
    top2 = scores.topk(2, dim=1).values
    picked = scores.gather(1, idx.long()[:, None])[:, 0]
    differ = idx != ref_idx
    assert not bool((differ & (top2[:, 0] - top2[:, 1] > margin)).any())
    assert bool((top2[:, 0] - picked <= margin).all())
    assert torch.equal(quant, e.t()[idx.long()])
    own_counts, own_sums = V.vq_stats(x, idx, k)
    assert torch.equal(counts, own_counts)
    _, abs_sums = V.vq_stats(x.abs(), idx, k)
    assert bool(((sums - own_sums).abs()
                 <= 2 * counts * 2.0 ** -24 * abs_sums + 1e-30).all())


@pytest.mark.parametrize("n,d,k", [(524288, 64, 512), (1001, 8, 16),
                                   (3000, 64, 2500), (777, 13, 300),
                                   (4096, 224, 64)])
def test_vq_kernels_match_plain(cuda, n, d, k):
    """`_check_vq` at the training step's bottom shape, a ragged N, K
    above one tile of the earlier kernels, D not a multiple of 8 with K
    not a multiple of the 64-code tile, and the widest D."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((n, d), generator=gen, device=cuda)
    e = torch.randn((d, k), generator=gen, device=cuda)
    before = (vq_cuda.assign_launches, vq_cuda.stats_launches)
    out = V.vq_assign(x, e)
    torch.cuda.synchronize()
    assert (vq_cuda.assign_launches, vq_cuda.stats_launches) == (
        before[0] + 1, before[1] + 1)
    _check_vq(x, e, out)


def test_vq_exact_tie_goes_to_the_lower_index_by_the_rescore(cuda):
    """Codes 5 and 300 are equal: every row nearest to them scores both
    the same, so the split product cannot certify it, the float32
    re-score takes it, and the lower index, 5, wins."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(11)
    d, k = 64, 512
    e = torch.randn((d, k), generator=gen, device=cuda)
    e[:, 300] = e[:, 5]
    near = e[:, 5][None] + 1e-3 * torch.randn((200, d), generator=gen,
                                               device=cuda)
    x = torch.cat([near, torch.randn((4000, d), generator=gen, device=cuda)])
    idx, quant, flagged = vq_cuda.assign_rows_flagged(x, e)
    torch.cuda.synchronize()
    assert int(flagged) >= 200
    assert bool((idx[:200] == 5).all()) and not bool((idx == 300).any())
    _check_vq(x, e, (idx, quant, *vq_cuda.code_stats(x, idx, k)))


def test_vq_hot_code_statistics(cuda):
    """90 % of the rows sit on one code, so its segment is thousands of
    chunks long: counts exact, sums within the rounding bound."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(12)
    n, d, k = 200000, 64, 512
    e = torch.randn((d, k), generator=gen, device=cuda)
    x = torch.randn((n, d), generator=gen, device=cuda)
    hot = torch.rand((n,), generator=gen, device=cuda) < 0.9
    x[hot] = e[:, 17][None] + 1e-2 * x[hot]
    out = V.vq_assign(x, e)
    torch.cuda.synchronize()
    assert out[2][17].item() >= 0.85 * n
    _check_vq(x, e, out)


def test_vq_statistics_are_the_same_in_every_launch(cuda):
    """The statistics add in an order fixed by their inputs: repeated
    launches on the same rows, with a hot code of thousands of chunks, a
    K of the tiled regime, and a K whose sort counters do not fit in
    shared memory, give bitwise equal counts and sums."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    for n, d, k in ((200000, 64, 512), (65536, 64, 4096), (5000, 7, 33),
                    (20000, 8, 70000)):
        x = torch.randn((n, d), generator=gen, device=cuda)
        idx = torch.randint(0, k, (n,), generator=gen, device=cuda)
        idx[: n // 2] = 3
        idx = idx.to(torch.int32)
        first = vq_cuda.code_stats(x, idx, k)
        for _ in range(3):
            again = vq_cuda.code_stats(x, idx, k)
            assert torch.equal(again[0], first[0])
            assert torch.equal(again[1], first[1])
        # against the plain sums within the rounding bound of two
        # summations of c_k terms, 2 c_k u sum|x| per entry
        counts, sums = V.vq_stats(x, idx, k)
        _, abs_sums = V.vq_stats(x.abs(), idx, k)
        assert torch.equal(first[0], counts)
        tol = 2 * counts[None, :] * 2.0 ** -24 * abs_sums + 1e-30
        assert bool(((first[1] - sums).abs() <= tol).all())


def test_vq_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="CUDA tensor"):
        vq_cuda.vq_assign(x.cpu(), torch.zeros((8, 3), device=cuda))
    with pytest.raises(ValueError, match="unsupported sizes"):
        vq_cuda.vq_assign(torch.zeros((4, 300), device=cuda),
                          torch.zeros((300, 3), device=cuda))
    with pytest.raises(ValueError, match="want flat"):
        vq_cuda.vq_assign(x, torch.zeros((5, 3), device=cuda))


def test_warp_on_perturbation_grids_matches_plain(cuda):
    """The training step's warp: 8 frames at the grids `perturb_clip`
    builds from one draw, through `warp_with_grid` (the kernel on the
    card) and through the plain version: 1e-5, the kernel phase's limit
    in chip_smoke.py."""
    gen = torch.Generator().manual_seed(5)
    faces = torch.rand((8, 64, 64, 3), generator=gen)
    eyes = 64 * (0.4 + 0.2 * torch.rand((8, 2), generator=gen))
    xs, ys, _ = W.perturbation_grids(W.draw_perturbation(gen, 8), 64, 64,
                                     eyes)
    xs, ys = xs.contiguous(), ys.contiguous()
    before = warp_cuda.launches
    out = W.warp_with_grid(faces.to(cuda), xs.to(cuda), ys.to(cuda))
    torch.cuda.synchronize()
    assert warp_cuda.launches == before + 1
    ref = W._bilinear_sample(faces, xs, ys)
    assert (out.cpu() - ref).abs().max().item() <= 1e-5


def test_warp_backward_matches_autograd(cuda):
    """The backward kernel's three gradients against autograd through the
    plain warp, at coordinates reaching past every border: 1e-4 (atomic
    adds of a few float32 terms in another order)."""
    rng = np.random.default_rng(6)
    n, h, w, c, oh, ow = 3, 40, 56, 3, 48, 44
    imgs = rng.uniform(-1, 1, (n, h, w, c)).astype(np.float32)
    xs = rng.uniform(-3, w + 2, (n, oh, ow)).astype(np.float32)
    ys = rng.uniform(-3, h + 2, (n, oh, ow)).astype(np.float32)
    xs[:, ::4] = np.round(xs[:, ::4])
    g = rng.normal(size=(n, oh, ow, c)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda).requires_grad_(True)
            for a in (imgs, xs, ys)]
    gt = torch.from_numpy(g).to(cuda)
    before = warp_cuda.backward_launches
    W.batched_bilinear_warp(*args).backward(gt)
    torch.cuda.synchronize()
    assert warp_cuda.backward_launches == before + 1
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    ref = torch.autograd.grad(W._bilinear_sample(*leaves), leaves, gt)
    for a, r in zip(args, ref):
        assert (a.grad - r).abs().max().item() <= 1e-4


def _tile_grids(kind, n, h, w, oh, ow, seed):
    """Sampling grids for the backward's tile paths: "mixed" are affine
    grids (scale 0.8-1.25, rotation up to 0.3 rad) with one tile
    stretched past two corners of the image, so that fitting and
    direct tiles mix; "direct" shrinks the image 3.2x, so that no tile's
    footprint fits."""
    rng = np.random.default_rng(seed)
    oy, ox = np.mgrid[0:oh, 0:ow].astype(np.float32)
    xs = np.empty((n, oh, ow), np.float32)
    ys = np.empty((n, oh, ow), np.float32)
    for f in range(n):
        if kind == "direct":
            xs[f], ys[f] = 3.2 * ox + 1.0, 3.2 * oy + 0.5
            continue
        ang, s = rng.uniform(-0.3, 0.3), rng.uniform(0.8, 1.25)
        tx, ty = rng.uniform(-0.2, 0.2, 2) * (w, h)
        xs[f] = s * (np.cos(ang) * ox - np.sin(ang) * oy) + tx + 2
        ys[f] = s * (np.sin(ang) * ox + np.cos(ang) * oy) + ty + 2
    if kind == "mixed":
        xs[-1, 16, 16], ys[-1, 16, 16] = -40.0, -40.0
        xs[-1, 17, 17], ys[-1, 17, 17] = w + 40.0, h + 40.0
        edges = np.array([-1.0, -0.5, 0.0, w - 1.0, w - 0.5, w], np.float32)
        xs[0, 0, :len(edges)] = edges
    return xs, ys


@pytest.mark.parametrize("kind", ["mixed", "direct"])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_warp_tile_paths_match_plain(cuda, kind, c):
    """Forward (1e-5 against the plain version) and backward (1e-4 against
    autograd) with C = 1, 3, 4, on grids where the backward's tiles mix
    shared-memory and direct splats ("mixed": 2 x 64 x 80 images into
    40 x 56 grids) or all splat directly ("direct": 100 x 100 into
    30 x 30); neither output width is a multiple of the 16-pixel tile and
    both output grids differ in size from the source."""
    n, h, w, oh, ow = (2, 64, 80, 40, 56) if kind == "mixed" else (
        1, 100, 100, 30, 30)
    rng = np.random.default_rng(c)
    xs, ys = _tile_grids(kind, n, h, w, oh, ow, seed=c)
    imgs = rng.uniform(-1, 1, (n, h, w, c)).astype(np.float32)
    g = rng.normal(size=(n, oh, ow, c)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda).requires_grad_(True)
            for a in (imgs, xs, ys)]
    fits = warp_cuda.tile_footprints(args[1], args[2], h, w, c)[1]
    if kind == "mixed":
        assert bool(fits.any()) and not bool(fits.all())
    else:
        assert not bool(fits.any())
    gt = torch.from_numpy(g).to(cuda)
    before = (warp_cuda.launches, warp_cuda.backward_launches)
    out = W.batched_bilinear_warp(*args)
    out.backward(gt)
    torch.cuda.synchronize()
    assert (warp_cuda.launches, warp_cuda.backward_launches) == (
        before[0] + 1, before[1] + 1)
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    ref = W._bilinear_sample(*leaves)
    assert (out - ref).abs().max().item() <= 1e-5
    for a, r in zip(args, torch.autograd.grad(ref, leaves, gt)):
        assert (a.grad - r).abs().max().item() <= 1e-4


def test_train_step_on_card_matches_cpu(cuda):
    """Two float32 steps without TF32 of a tiny VQVAE with LPIPS, from the
    same weights and prepared batches, on both devices: losses 1e-3
    relative; parameters within Adam's 2 lr per step of each other and
    99% of them within 1e-5; the VQ kernels ran on the card. The batches
    are prepared once on the CPU, so the warp kernel does not run here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(channel=16, n_res_block=1, n_res_channel=8,
                      embed_dim=8, n_embed=32)
    frames, lms, n_frames = synthetic_corpus(2, 6, 32, seed=1)
    prep = make_resident_prepare(
        corpus_from_arrays(frames, lms, n_frames, device="cpu"), 1, 2)
    gen = torch.Generator().manual_seed(0)
    batches = [prep(gen, torch.as_tensor(frames), torch.as_tensor(lms))
               for _ in range(2)]
    results = {}
    for dev in ("cpu", cuda):
        model = VQVAE(cfg, dtype=torch.float32, device=dev)
        lpips = init_lpips(device=dev, dtype=torch.float32)
        state = create_train_state(
            model, make_optimizer(model.parameters(), 1e-3))
        step = make_train_step(model, lpips=lpips,
                               compute_dtype=torch.float32)
        before = (vq_cuda.assign_launches, vq_cuda.stats_launches)
        losses = []
        for b in batches:
            state, m = step(state, {k: v.to(dev) for k, v in b.items()})
            losses.append(m["loss"].item())
        if dev != "cpu":
            assert (vq_cuda.assign_launches, vq_cuda.stats_launches) == (
                before[0] + 4, before[1] + 4)
        results[str(dev)] = (losses, {n: p.detach().cpu() for n, p in
                                      model.named_parameters()})
    (l_cpu, p_cpu), (l_gpu, p_gpu) = results["cpu"], results[str(cuda)]
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-3)
    diffs = torch.cat([(p_gpu[k] - p_cpu[k]).abs().ravel() for k in p_cpu])
    assert diffs.max().item() <= 2 * 1e-3 * 2 + 1e-6
    assert (diffs <= 1e-5).float().mean().item() >= 0.99


def test_nvjpeg_decodes_the_fixtures(cuda):
    from pathlib import Path

    from faceoff_tpu_torch.io import image

    data = Path(__file__).resolve().parent / "data_torch"
    # |nvJPEG - cv2| in levels, (max, mean): io/image.py states and
    # explains the tolerance
    for name, (max_tol, mean_tol) in image.JPEG_TOL.items():
        got = image.decode_jpeg_batch([data / f"face_{name}.jpg"], cuda)[0]
        ref = np.load(data / f"face_{name}.npy").astype(np.int64)
        assert got.device.type == "cuda" and got.dtype == torch.uint8
        diff = np.abs(got.cpu().numpy().astype(np.int64) - ref)
        assert diff.max() <= max_tol and diff.mean() <= mean_tol, name


def test_prefetch_to_device_on_card(cuda):
    from faceoff_tpu_torch.data.pipeline import prefetch_to_device

    batches = [{"x": np.arange(12, dtype=np.float32).reshape(3, 4) + i}
               for i in range(5)]
    got = list(prefetch_to_device(iter(batches), cuda))
    assert len(got) == 5
    for b, g in zip(batches, got):
        assert g["x"].device.type == "cuda"
        np.testing.assert_array_equal(g["x"].cpu().numpy(), b["x"])


def test_cli_resume_on_card(cuda, tmp_path):
    """The command line on the card at 32 px, narrow widths: a run
    checkpointing every 2 steps, and its step-4 checkpoint resumed to
    step 6, are equal at step 6 bit for bit, parameters and buffers
    (every kernel of the step adds in a fixed order)."""
    import shutil

    from faceoff_tpu_torch.cli.train_faceoff_perceptual import main
    from faceoff_tpu_torch.data.synthetic import generate_dataset

    root = str(tmp_path / "ds")
    generate_dataset(root, n_videos=4, n_frames=6, size=32, seed=4)

    def run(name, *extra):
        return main(["--data_root", root, "--resident_data", "--size", "32",
                     "--batch_size", "2", "--train_frames", "3",
                     "--val_frames", "3", "--channel", "16",
                     "--n_res_channel", "8", "--embed_dim", "8",
                     "--n_embed", "16", "--epoch", "3", "--validate_at", "2",
                     "--sched", "cycle", "--num_workers", "2",
                     "--sample_folder", str(tmp_path / f"s_{name}"), *extra],
                    device=cuda)

    straight = run("a", "--checkpoint_dir", str(tmp_path / "ck_a"))
    ck_a = next(tmp_path.glob("ck_a_*"))
    ck_b = tmp_path / "ck_b"
    ck_b.mkdir()
    shutil.copy(ck_a / "ckpt_00000004.pt", ck_b)
    resumed = run("b", "--ckpt", "latest", "--checkpoint_dir", str(ck_b))
    assert resumed.global_step == straight.global_step == 6
    sa = straight.state.model.state_dict()
    sb = resumed.state.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_swap_chunk_warp_matches_plain(cuda):
    """The warp of a swap chunk (`cli/swap.py --device_pipeline`, 32
    frames at 256 px) at the grids of Umeyama similarities between two
    synthetic faces, against the plain version (1e-5)."""
    from faceoff_tpu_torch.ops.swap import _STABLE

    rng = np.random.default_rng(9)
    lms = np.stack([np.stack([
        face_landmarks(tuple(rng.uniform(90, 166, 2)), rng.uniform(46, 72),
                       rng.uniform(-10, 10)) for _ in range(2)])
        for _ in range(32)]).astype(np.float32)
    lms = torch.from_numpy(lms)
    ms = W.umeyama_similarity(lms[:, 0, _STABLE], lms[:, 1, _STABLE])
    xs, ys = (t.contiguous().to(cuda) for t in
              W.affine_grid(W.invert_affine(ms), 256, 256))
    imgs = torch.from_numpy(rng.uniform(0, 1, (32, 256, 256, 3))
                            .astype(np.float32)).to(cuda)
    before = warp_cuda.launches
    got = W.batched_bilinear_warp(imgs, xs, ys)
    torch.cuda.synchronize()
    assert warp_cuda.launches == before + 1
    assert (got - W._bilinear_sample(imgs, xs, ys)).abs().max().item() <= 1e-5


def test_swap_cli_device_pipeline_on_card(cuda, tmp_path):
    """`cli/swap.py --device_pipeline` on the card at 32 px, narrow widths:
    one warp launch a chunk (12 frames in chunks of 8: 2), and its source
    and background streams equal the CPU run's within the kernel's
    tolerance (1e-5) except where the composite's hull masks round a
    pixel differently (at most 1 % of the values)."""
    from faceoff_tpu_torch.cli import swap
    from faceoff_tpu_torch.data.synthetic import generate_dataset
    from faceoff_tpu_torch.io.checkpoint import CheckpointManager
    from faceoff_tpu_torch.train.state import create_train_state

    generate_dataset(str(tmp_path / "ds"), 2, 12, 32, seed=3)
    model = VQVAE(ModelConfig(channel=16, n_res_channel=8, embed_dim=8,
                              n_embed=16), dtype=torch.float32, device="cpu")
    CheckpointManager(str(tmp_path / "ck")).save(1, create_train_state(model))
    runs = {}
    for name, dev in (("cpu", "cpu"), ("cuda", cuda)):
        before = warp_cuda.launches
        runs[name] = swap.main(
            ["--source", str(tmp_path / "ds" / "video_000"),
             "--target", str(tmp_path / "ds" / "video_001"),
             "--checkpoint_dir", str(tmp_path / "ck"), "--size", "32",
             "--chunk", "8", "--device_pipeline", "--channel", "16",
             "--n_res_channel", "8", "--embed_dim", "8", "--n_embed", "16",
             "--out", str(tmp_path / f"o_{name}.avi")], device=dev)
        if name == "cuda":
            assert warp_cuda.launches == before + 2
    for key in ("sources", "backgrounds"):
        a = np.stack(runs["cpu"][key])
        b = np.stack(runs["cuda"][key])
        assert (np.abs(a - b) > 1e-5).mean() <= 0.01, key


def test_gan_path_kernels_match_plain(cuda):
    """The kernels at the GAN path's shapes (B 1, T 16, 256 px): the
    assignment and statistics at (65536, 64, 512) and (16384, 64, 512),
    the assignment alone (the disc step's forward) equal to the pair's
    assignment, and the perturbation warp of 16 frames at 256 px."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(14)
    e = torch.randn((64, 512), generator=gen, device=cuda)
    for n in (65536, 16384):
        x = torch.randn((n, 64), generator=gen, device=cuda)
        out = V.vq_assign(x, e)
        idx, quant = V.vq_assign_rows(x, e)
        torch.cuda.synchronize()
        _check_vq(x, e, out)
        assert torch.equal(idx, out[0]) and torch.equal(quant, out[1])
    g = torch.Generator().manual_seed(15)
    faces = torch.rand((16, 256, 256, 3), generator=g)
    eyes = 256 * (0.4 + 0.2 * torch.rand((16, 2), generator=g))
    xs, ys, _ = W.perturbation_grids(W.draw_perturbation(g, 16), 256, 256,
                                     eyes)
    xs, ys = xs.contiguous(), ys.contiguous()
    out = W.warp_with_grid(faces.to(cuda), xs.to(cuda), ys.to(cuda))
    torch.cuda.synchronize()
    assert (out.cpu() - W._bilinear_sample(faces, xs, ys)).abs().max() <= 1e-5


def test_plain_route_on_card_launches_nothing_and_repeats(cuda,
                                                         monkeypatch):
    """The training quantizer with the kernel route off (--no_pallas) on
    CUDA: no VQ kernel launches, the plain statistics of the same inputs
    bitwise equal twice (the float64 one-hot sums, 3 blocks of rows
    here), within float32 rounding of float64 sums of the same rows
    (4 u of each sum's absolute terms), with indices equal to the
    kernel route's but for float32 ties (`_check_vq`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(V, "STATS_CHUNK_ELEMS", 6000 * 512)
    gen = torch.Generator(device=cuda).manual_seed(16)
    e = torch.randn((64, 512), generator=gen, device=cuda)
    x = torch.randn((2, 8, 32, 32, 64), generator=gen, device=cuda)
    cb = V.VQCodebook(e, torch.ones(512, device=cuda), e.clone())
    before = (vq_cuda.assign_launches, vq_cuda.stats_launches)
    runs = [V.vq_quantize_train(cb, x, use_kernels=False) for _ in range(2)]
    for update in (True, False):
        V.vq_quantize_train(cb, x, update=update, use_kernels=False)
    torch.cuda.synchronize()
    assert (vq_cuda.assign_launches, vq_cuda.stats_launches) == before
    for a, b in zip(runs[0][3], runs[1][3]):
        assert torch.equal(a, b)
    flat = x.reshape(-1, 64)
    _check_vq(flat, e, V.vq_assign(flat, e))
    idx = runs[0][1].reshape(-1)
    _, sums = V.vq_stats(flat, idx, 512)
    exact = torch.zeros((512, 64), dtype=torch.float64, device=cuda)
    exact.index_add_(0, idx.long(), flat.double())
    absum = torch.zeros((512, 64), dtype=torch.float64, device=cuda)
    absum.index_add_(0, idx.long(), flat.double().abs())
    err = (sums.double() - exact.t()).abs()
    assert bool((err <= 4 * 2.0 ** -24 * absum.t() + 1e-30).all())


def test_gan_pair_launches_on_card(cuda):
    """One mocoganhd gen/disc pair on a resident corpus at narrow widths:
    4 assignment, 2 statistics and 2 warp launches, finite losses, and
    the disc step leaves the codebooks bitwise as they were."""
    from faceoff_tpu_torch.models.discriminators import (
        MultiscaleDiscriminator2D, MultiscaleDiscriminator3D)
    from faceoff_tpu_torch.train import gan

    frames, lms, n = synthetic_corpus(2, 10, 64, seed=3, device=cuda)
    corpus = corpus_from_arrays(frames, lms, n, device=cuda)
    model = VQVAE(ModelConfig(channel=32), dtype=torch.float32, device=cuda)
    g = torch.Generator().manual_seed(4)
    d_img = MultiscaleDiscriminator2D(ndf=8, device=cuda, generator=g)
    d_3d = MultiscaleDiscriminator3D(ndf=8, n_frames=6, device=cuda,
                                     generator=g)
    state = gan.create_gan_state(create_train_state(model), d_img, d_3d)
    gen_step, disc_step = gan.make_gan_steps(
        model, d_img, d_3d, sample_frames=6,
        prepare_fn=make_resident_prepare(corpus, 1, 8))
    raw = {"frames": corpus.frames, "landmarks": corpus.landmarks}
    before = (vq_cuda.assign_launches, vq_cuda.stats_launches,
              warp_cuda.launches)
    state, gm = gen_step(state, raw)
    codebooks = {k: v.clone() for k, v in model.state_dict().items()
                 if k.startswith("quantize_")}
    state, dm = disc_step(state, raw)
    torch.cuda.synchronize()
    after = (vq_cuda.assign_launches, vq_cuda.stats_launches,
             warp_cuda.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (4, 2, 2)
    assert all(np.isfinite(float(v)) for v in {**gm, **dm}.values())
    for k, v in codebooks.items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_multiscale_discriminator_input_gradient_matches_cpu(cuda, kind):
    """The multiscale discriminators' gradient with respect to their
    channels-last input, float32 without TF32, on the card against the
    CPU: 1e-5 of its largest magnitude; and a second backward on the card
    (cuDNN's deterministic algorithms, as the GAN steps run) is bitwise
    equal to the first. (CUDA's avg_pool2d backward on a
    channels-last input is wrong in PyTorch 2.11, and its avg_pool3d
    backward adds with atomics; the discriminators pool with
    `avg_pool3`.)"""
    from faceoff_tpu_torch.models.discriminators import (
        MultiscaleDiscriminator2D, MultiscaleDiscriminator3D)
    from faceoff_tpu_torch.train.gan import cudnn_deterministic

    torch.backends.cudnn.allow_tf32 = False
    shape = (1, 64, 64, 6) if kind == "2d" else (1, 3, 64, 64, 6)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(16))
    grads = []
    for dev in ("cpu", cuda, cuda):
        cls = (MultiscaleDiscriminator2D if kind == "2d"
               else MultiscaleDiscriminator3D)
        disc = cls(ndf=8, device=dev,
                   generator=torch.Generator().manual_seed(17))
        xx = x.detach().to(dev).requires_grad_(True)

        @cudnn_deterministic
        def backward():
            out = disc(xx)
            torch.stack([(f[-1] ** 2).mean() for f in out]).sum().backward()

        backward()
        grads.append(xx.grad.cpu())
    err = float((grads[1] - grads[0]).abs().max() / grads[0].abs().max())
    assert err <= 1e-5, err
    assert torch.equal(grads[1], grads[2])


def test_b2f_train_forward_launches_on_card(cuda):
    """VQVAE_B2F's training forward at narrow widths: each of its six
    quantizers assigns through the VQ kernels (6 assignment and 6
    statistics launches), and the float32 reconstruction, latent loss and
    EMA codebooks match the CPU's from the same weights (1e-4 of the
    largest magnitude; codebooks rtol 1e-4 atol 1e-5)."""
    from faceoff_tpu_torch.models.vqvae_b2f import VQVAE_B2F

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    widths = dict(channel=32, n_res_block=1, n_res_channel=8, embed_dim=16,
                  n_embed=64)
    cpu = VQVAE_B2F(dtype=torch.float32, device="cpu", **widths)
    card = VQVAE_B2F(dtype=torch.float32, device=cuda, **widths)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(5)
    xs = tuple(torch.rand((4, 64, 64, 3), generator=g) * 2 - 1
               for _ in range(3))
    before = (vq_cuda.assign_launches, vq_cuda.stats_launches)
    with torch.no_grad():
        dec, diff = card(tuple(x.to(cuda) for x in xs), train=True)
        torch.cuda.synchronize()
        after = (vq_cuda.assign_launches, vq_cuda.stats_launches)
        ref_dec, ref_diff = cpu(xs, train=True)
    assert (after[0] - before[0], after[1] - before[1]) == (6, 6)
    scale = float(ref_dec.abs().max())
    assert float((dec.cpu() - ref_dec).abs().max()) <= 1e-4 * scale
    assert abs(float(diff) - float(ref_diff)) <= 1e-4 * abs(float(ref_diff))
    for k, v in cpu.state_dict().items():
        if k.split(".")[-1] in ("embed", "cluster_size", "embed_avg"):
            np.testing.assert_allclose(card.state_dict()[k].cpu().numpy(),
                                       v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


_NCCL_ONE_RANK = """
import socket, torch
from faceoff_tpu_torch.config import ModelConfig
from faceoff_tpu_torch.models import VQVAE
from faceoff_tpu_torch.parallel import collectives
from faceoff_tpu_torch.train.shardmap_step import make_shardmap_train_step
from faceoff_tpu_torch.train.state import create_train_state, make_optimizer
from faceoff_tpu_torch.train.train_step import make_train_step
from faceoff_tpu_torch.ops import vq_cuda

with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
collectives.initialize_distributed(f"127.0.0.1:{port}", 1, 0)
assert torch.distributed.get_backend() == "nccl"
g = torch.Generator().manual_seed(3)
gt = torch.rand((2, 4, 64, 64, 3), generator=g) * 2 - 1
batch = {"input": torch.cat([gt, gt.flip(2)], -1).cuda(), "gt": gt.cuda()}
states = []
for shard in (False, True):
    model = VQVAE(ModelConfig(channel=32), dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(model.parameters(), 3e-4))
    step = (make_shardmap_train_step(model, perceptual_loss_weight=0.0)
            if shard else make_train_step(model, perceptual_loss_weight=0.0))
    before = vq_cuda.assign_launches
    for _ in range(2):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    assert vq_cuda.assign_launches - before == 4
    states.append((model.state_dict(), {k: float(v) for k, v in m.items()}))
(a, ma), (b, mb) = states
assert ma == mb, (ma, mb)
for k in a:
    assert torch.equal(a[k], b[k]), k
collectives.destroy()
print("ok")
"""


def test_shardmap_step_one_nccl_rank_matches_plain_step(cuda):
    """The shardmap step in a one-rank NCCL group against the plain step
    from the same weights, two bf16 steps: parameters, codebooks and
    metrics bitwise equal (an all-reduce over one rank is the identity,
    and the card's step repeats bit for bit). In a child process, so that
    the process group dies with it."""
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-c", _NCCL_ONE_RANK],
                          cwd=Path(__file__).resolve().parent.parent,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), (
        proc.stdout[-3000:] + proc.stderr[-3000:])


# -- offline preprocessing: kernels A (ccl) and B (pyr_lk), nvJPEG's
# encoder and window decoder, stage 1 on the card -------------------------


def _textured(gen, h, w):
    """A smooth random texture (bicubic upsampling of noise) with noise on
    top, uint8 (h, w)."""
    noise = torch.rand((1, 1, h // 8 + 2, w // 8 + 2), generator=gen) * 255
    img = torch.nn.functional.interpolate(noise, size=(h, w), mode="bicubic",
                                          align_corners=False)[0, 0]
    img = img + torch.randn((h, w), generator=gen) * 8
    return img.clamp(0, 255).round().to(torch.uint8)


@pytest.mark.parametrize("b,h,w,p", [(3, 37, 53, 0.5), (2, 720, 1280, 0.45),
                                     (1, 720, 1280, 0.6), (2, 1, 1, 1.0),
                                     (1, 33, 65, 0.0)])
def test_ccl_kernel_equals_plain(cuda, b, h, w, p):
    """Kernel A against its plain version: labels (each component's
    smallest flat index), the stats table in cv2's order, the per-frame
    counts and the largest component, all exactly equal; one launch."""
    from faceoff_tpu_torch.ops import ccl_cuda

    gen = torch.Generator().manual_seed(b * h + w)
    masks = ((torch.rand((b, h, w), generator=gen) < p).to(torch.uint8)
             * 255)
    want = ccl_cuda.connected_components_plain(masks)
    before = ccl_cuda.launches
    got = ccl_cuda.connected_components(masks.to(cuda))
    torch.cuda.synchronize()
    assert ccl_cuda.launches == before + 1
    for name, g, w_ in zip(got._fields, got, want):
        assert torch.equal(g.cpu(), w_), name
    assert torch.equal(ccl_cuda.largest(got, b).cpu(),
                       ccl_cuda.largest(want, b))


def test_ccl_kernel_at_its_capacity(cuda):
    """Kernel A's table holds B * ceil(H / 2) * ceil(W / 2) components, one
    a 2 x 2 block; a mask of isolated pixels at every even row and column
    of odd sizes fills it exactly, and the table equals the plain
    version's."""
    from faceoff_tpu_torch.ops import ccl_cuda

    b, h, w = 2, 33, 47
    masks = torch.zeros((b, h, w), dtype=torch.uint8)
    masks[:, ::2, ::2] = 1
    want = ccl_cuda.connected_components_plain(masks)
    got = ccl_cuda.connected_components(masks.to(cuda))
    assert got.stats.shape[0] == b * ((h + 1) // 2) * ((w + 1) // 2)
    for name, g, w_ in zip(got._fields, got, want):
        assert torch.equal(g.cpu(), w_), name


def _ccl_equal(cuda, masks):
    """Kernel A on `masks` against its plain version: every Components
    field and `largest` exactly equal; one launch."""
    from faceoff_tpu_torch.ops import ccl_cuda

    want = ccl_cuda.connected_components_plain(masks)
    before = ccl_cuda.launches
    got = ccl_cuda.connected_components(masks.to(cuda))
    torch.cuda.synchronize()
    assert ccl_cuda.launches == before + 1
    for name, g, w_ in zip(got._fields, got, want):
        assert torch.equal(g.cpu(), w_), name
    b = masks.shape[0]
    assert torch.equal(ccl_cuda.largest(got, b).cpu(),
                       ccl_cuda.largest(want, b))


def _tile_crossing(kind, b, h, w):
    """Masks whose components cross kernel A's 32 x 64 pixel tiles (16 x
    32 blocks of 2 x 2) in every direction: lines along rows, columns and
    both diagonals one pixel wide, 2 x 2 checkers that join only through
    block corners, rings, and noise."""
    ys = torch.arange(h)[:, None]
    xs = torch.arange(w)[None, :]
    if kind == "rows":
        m = ys % 5 == 2
    elif kind == "cols":
        m = xs % 7 == 3
    elif kind == "diag":
        m = (xs - ys) % 9 == 0
    elif kind == "antidiag":
        m = (xs + ys) % 11 == 0
    elif kind == "checker":
        m = ((ys // 2) + (xs // 2)) % 2 == 0
    elif kind == "pixel_checker":
        m = (ys + xs) % 2 == 0
    elif kind == "rings":
        r = ((ys - h / 2) ** 2 + (xs - w / 3) ** 2).sqrt()
        m = (r.round() % 6) == 0
    else:
        gen = torch.Generator().manual_seed(h * w)
        return ((torch.rand((b, h, w), generator=gen) < 0.52)
                .to(torch.uint8) * 255)
    m = m.expand(b, h, w).clone()
    m[1:] = m[1:].flip(-1)  # another layout in the other frames
    return m.to(torch.uint8) * 255


@pytest.mark.parametrize("kind", ["rows", "cols", "diag", "antidiag",
                                  "checker", "pixel_checker", "rings",
                                  "noise"])
def test_ccl_kernel_across_tile_borders(cuda, kind):
    """Kernel A where components cross tile borders in every direction
    (the border launch's W, NW, N and NE joins, and the block corners that
    only a diagonal pixel pair links), against its plain version."""
    _ccl_equal(cuda, _tile_crossing(kind, 2, 97, 161))


@pytest.mark.parametrize("b,h,w", [(1, 1, 77), (1, 77, 1), (1, 1, 1280),
                                   (1, 720, 1), (2, 33, 65), (1, 31, 63),
                                   (3, 66, 130), (1, 35, 97), (2, 2, 2),
                                   (1, 3, 1), (4, 64, 96)])
def test_ccl_kernel_ragged_sizes(cuda, b, h, w):
    """Kernel A when H or W is not a multiple of the tile, of 4 bytes or of
    2 (odd sizes take the byte-wise mask loads and label stores), single
    rows and columns, against its plain version."""
    gen = torch.Generator().manual_seed(b * 10007 + h * 101 + w)
    masks = ((torch.rand((b, h, w), generator=gen) < 0.55).to(torch.uint8)
             * 7)
    _ccl_equal(cuda, masks)


def test_ccl_kernel_odd_mask_address(cuda):
    """Kernel A on a contiguous view that starts at an odd byte: the
    16-bit mask loads are not taken, the result is the plain version's."""
    from faceoff_tpu_torch.ops import ccl_cuda

    gen = torch.Generator().manual_seed(9)
    flat = ((torch.rand((2 * 40 * 64 + 1,), generator=gen) < 0.5)
            .to(torch.uint8))
    masks = flat[1:].view(2, 40, 64)
    want = ccl_cuda.connected_components_plain(masks)
    got = ccl_cuda.connected_components(flat.to(cuda)[1:].view(2, 40, 64))
    for name, g, w_ in zip(got._fields, got, want):
        assert torch.equal(g.cpu(), w_), name


def test_ccl_kernel_full_foreground(cuda):
    """Kernel A on two all-foreground 720p frames (one component a frame,
    the case where the first form sent every pixel's atomics to one slot),
    against its plain version."""
    _ccl_equal(cuda, torch.full((2, 720, 1280), 255, dtype=torch.uint8))


@pytest.mark.parametrize("transpose", [False, True])
def test_ccl_kernel_serpentine(cuda, transpose):
    """Kernel A on a one-pixel-wide serpentine over whole 720p frames
    (every other row, joined at alternate ends; or the same along
    columns): one component a frame through the longest union chains. The
    plain version's propagation would take minutes here, so the result is
    checked against what it must be: each frame one component rooted at
    its first pixel, the whole frame its box, its area the pixels set."""
    from faceoff_tpu_torch.ops import ccl_cuda

    b, h, w = 2, 720, 1280
    m = torch.zeros((b, h, w), dtype=torch.uint8)
    m[:, 0::2, :] = 1
    odd = torch.arange(1, h, 2)
    m[:, odd, torch.where((odd // 2) % 2 == 0, w - 1, 0)] = 1
    if transpose:
        m = m[:, : w // 2 + 1].transpose(1, 2).contiguous()
        b, h, w = m.shape
    got = ccl_cuda.connected_components(m.to(cuda))
    first = torch.arange(b) * (h * w)
    fg = m.bool()
    assert torch.equal(got.labels.cpu(), torch.where(
        fg, first[:, None, None].to(torch.int32).expand(b, h, w),
        torch.full((b, h, w), -1, dtype=torch.int32)))
    assert torch.equal(got.frame.cpu(), torch.arange(b))
    assert torch.equal(got.root.cpu(), first)
    area = fg.sum((1, 2))
    assert torch.equal(got.stats.cpu(), torch.stack(
        [torch.zeros(b, dtype=torch.int64), torch.zeros(b, dtype=torch.int64),
         torch.full((b,), w), torch.full((b,), h), area], 1))
    assert torch.equal(got.counts.cpu(), torch.ones(b, dtype=torch.int64))


@pytest.mark.parametrize("h,w,n", [(256, 256, 68), (97, 131, 40),
                                   (40, 300, 25)])
def test_lk_kernel_matches_plain(cuda, h, w, n):
    """Kernel B against its plain version at ragged sizes (the last drops
    pyramid levels smaller than the window), points inside, near and
    beyond the borders, on a frame and its shift: statuses equal, points
    within 1e-3 px (both do the same IEEE float32 steps on the same
    integer sums; bitwise equal expected); one launch for forward and
    backward."""
    from faceoff_tpu_torch.ops import lk_cuda

    gen = torch.Generator().manual_seed(h + w)
    a = _textured(gen, h, w)
    b = torch.roll(a, (1, 2), (0, 1))
    pts = (torch.rand((n, 2), generator=gen)
           * torch.tensor([w + 30.0, h + 30.0]) - 15).to(torch.float32)
    pa, pb = lk_cuda.build_pyramid(a), lk_cuda.build_pyramid(b)
    want = lk_cuda.pyr_lk_plain(pa, pb, pts)
    ca, cb = lk_cuda.build_pyramid(a.to(cuda)), lk_cuda.build_pyramid(
        b.to(cuda))
    for x, y in ((pa, ca), (pb, cb)):
        assert torch.equal(x.img, y.img.cpu())
        assert torch.equal(x.deriv, y.deriv.cpu())
    before = lk_cuda.launches
    got = lk_cuda.pyr_lk(ca, cb, pts.to(cuda))
    torch.cuda.synchronize()
    assert lk_cuda.launches == before + 1
    assert torch.equal(got.st_fwd.cpu(), want.st_fwd)
    assert torch.equal(got.st_back.cpu(), want.st_back)
    for g, w_ in ((got.fwd, want.fwd), (got.back, want.back),
                  (got.fb, want.fb)):
        assert (g.cpu() - w_).abs().max().item() <= 1e-3


def _lk_equal(cuda, a, b, pts):
    """Kernel B against its plain version: statuses equal, points within
    1e-3 px; one launch."""
    from faceoff_tpu_torch.ops import lk_cuda

    pa, pb = lk_cuda.build_pyramid(a), lk_cuda.build_pyramid(b)
    want = lk_cuda.pyr_lk_plain(pa, pb, pts)
    ca, cb = lk_cuda.build_pyramid(a.to(cuda)), lk_cuda.build_pyramid(
        b.to(cuda))
    before = lk_cuda.launches
    got = lk_cuda.pyr_lk(ca, cb, pts.to(cuda))
    torch.cuda.synchronize()
    assert lk_cuda.launches == before + 1
    assert torch.equal(got.st_fwd.cpu(), want.st_fwd)
    assert torch.equal(got.st_back.cpu(), want.st_back)
    for g, w_ in ((got.fwd, want.fwd), (got.back, want.back),
                  (got.fb, want.fb)):
        assert g.shape == w_.shape
        if w_.numel():
            assert (g.cpu() - w_).abs().max().item() <= 1e-3
    return pa


@pytest.mark.parametrize("n", [0, 1, 3, 5, 33, 130])
def test_lk_kernel_point_counts(cuda, n):
    """Kernel B with no point, one point and counts that are no multiple of
    the points a CUDA block takes (a warp a point), on a 256 px frame and
    its shift."""
    gen = torch.Generator().manual_seed(n + 1)
    a = _textured(gen, 256, 256)
    b = torch.roll(a, (2, -1), (0, 1))
    pts = (torch.rand((n, 2), generator=gen) * 200 + 28).to(torch.float32)
    _lk_equal(cuda, a, b, pts)


def test_lk_kernel_points_beyond_the_borders(cuda):
    """Kernel B on points at, just beyond and far beyond every border of
    the frame (each level's [-win, size) test, at the start and during
    the iterations), against its plain version."""
    gen = torch.Generator().manual_seed(17)
    h, w = 120, 160
    a = _textured(gen, h, w)
    b = torch.roll(a, (3, 4), (0, 1))
    edge = [-40.0, -31.0, -21.0, -10.5, -1.0, 0.0, 0.5, 10.0]
    xs = edge + [w - 1.0, w - 0.5, w + 0.0, w + 9.5, w + 10.5, w + 30.0,
                 1e4, -1e4]
    ys = edge + [h - 1.0, h - 0.5, h + 0.0, h + 9.5, h + 10.5, h + 30.0,
                 1e4, -1e4]
    pts = torch.tensor([(x, h / 2) for x in xs] + [(w / 2, y) for y in ys]
                       + list(zip(xs, ys)), dtype=torch.float32)
    _lk_equal(cuda, a, b, pts)


@pytest.mark.parametrize("h,w", [(24, 24), (30, 90), (50, 50), (47, 400),
                                 (90, 45)])
def test_lk_kernel_dropped_levels(cuda, h, w):
    """Kernel B on frames whose pyramid drops its upper levels (a level
    whose side is no more than the window is dropped, with those above
    it): one to three levels instead of four."""
    gen = torch.Generator().manual_seed(h * w)
    a = _textured(gen, h, w)
    b = torch.roll(a, (1, 1), (0, 1))
    pts = (torch.rand((20, 2), generator=gen)
           * torch.tensor([w - 1.0, h - 1.0])).to(torch.float32)
    pa = _lk_equal(cuda, a, b, pts)
    assert len(pa.sizes) < 4


def _face_frames(n, h, w, device, cx=0.5):
    """n frames (h, w) of a synthetic face drifting about x = cx * w over
    a dark background, uint8 on `device`."""
    from faceoff_tpu_torch.data.synthetic import draw_faces, face_landmarks

    lms = np.stack([face_landmarks((w * cx + 3 * np.sin(0.2 * f), h / 2),
                                   min(h, w) * 0.25)
                    for f in range(n)])
    bg = torch.full((n, h, w, 3), 40, dtype=torch.uint8, device=device)
    return draw_faces(bg, torch.from_numpy(lms).to(device), (200, 160, 140))


def test_nvjpeg_encode_round_trip(cuda):
    """encode_jpeg (quality 95, 4:2:0) then decode_jpeg_bytes on the card:
    the decoded frames within the 4:2:0 decoder tolerance of io/image.py
    of the frames given (chroma at half resolution moves sharp colour
    edges by up to their contrast; the rest is a few levels)."""
    from faceoff_tpu_torch.io import image

    frames = _face_frames(3, 256, 256, cuda)
    before = image.jpeg_encodes
    datas = [image.encode_jpeg(f) for f in frames]
    assert image.jpeg_encodes == before + 3
    assert all(d[:2] == b"\xff\xd8" for d in datas)
    info = image.jpeg_info(datas[0])
    assert (info["width"], info["height"]) == (256, 256)
    back = image.decode_jpeg_bytes(datas, cuda)
    max_tol, mean_tol = image.JPEG_TOL["420"]
    for g, f in zip(back, frames):
        diff = (g.to(torch.int32) - f.to(torch.int32)).abs()
        assert diff.max().item() <= max_tol
        assert diff.float().mean().item() <= mean_tol


def test_decode_jpeg_window_equals_batch_and_resize(cuda, tmp_path):
    """decode_jpeg_window against decode_jpeg_batch + resize_frame on the
    host, at the frames' own size (decoded straight into the window) and
    at a smaller resolution and a mixed window (padded and resized on the
    card): bit for bit."""
    from pathlib import Path

    from faceoff_tpu_torch.data.geometry import resize_frame
    from faceoff_tpu_torch.io import image

    data = Path(__file__).resolve().parent / "data_torch"
    paths = sorted(data.glob("face256_*.jpg"))
    wide = tmp_path / "wide.jpg"
    image.write_jpeg(wide, _face_frames(1, 72, 130, cuda)[0])
    for res, window in ((256, paths), (96, paths[:3] + [wide] + paths[3:])):
        got = image.decode_jpeg_window(window, res, cuda)
        assert got.shape == (len(window), res, res, 3)
        refs = image.decode_jpeg_batch(window, cuda)
        want = np.stack([resize_frame(r.cpu().numpy(), res) for r in refs])
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_resident_corpus_stages_a_mixed_video(cuda, tmp_path):
    """build_resident_corpus on the card from a video whose frames are
    JPEGs of the corpus's size, a wider JPEG and a PNG: the JPEGs in one
    batched window, the PNG on the host; each frame bit for bit what
    load_frame gives."""
    import shutil
    from pathlib import Path
    from types import SimpleNamespace

    from faceoff_tpu_torch.data.dataset import load_frame
    from faceoff_tpu_torch.data.resident import build_resident_corpus
    from faceoff_tpu_torch.io import image

    data = Path(__file__).resolve().parent / "data_torch"
    video = tmp_path / "video"
    video.mkdir()
    for i, p in enumerate(sorted(data.glob("face256_*.jpg"))[:3]):
        shutil.copy(p, video / f"{i:05d}.jpg")
    image.write_jpeg(video / "00003.jpg", _face_frames(1, 72, 130, cuda)[0])
    image.write_png(video / "00004.png",
                    _face_frames(1, 256, 256, "cpu")[0].numpy())
    lms = np.random.default_rng(0).uniform(0, 256, (5, 68, 2))
    for i in range(5):
        np.savez(video / f"{i:05d}_landmarks.npz",
                 landmark=lms[i].astype(np.float32))
    before = image.jpeg_decodes
    corpus = build_resident_corpus(
        SimpleNamespace(videos=[str(video)], resolution=256), device=cuda)
    assert image.jpeg_decodes == before + 4
    want = np.stack([load_frame(str(video / f"{i:05d}_landmarks.npz"), 256,
                                cuda)[0] for i in range(5)])
    np.testing.assert_array_equal(corpus.frames[0].cpu().numpy(), want)
    np.testing.assert_array_equal(corpus.landmarks[0].cpu().numpy(),
                                  lms.astype(np.float32))


def test_process_video_on_card_equals_cpu(cuda, tmp_path):
    """Stage 1 on CUDA and on the CPU from one raw AVI with a cut: the
    same detection boxes, segments and clip lengths; the clips (mp4v,
    kernels on the card, their plain versions on the CPU, all integer
    arithmetic) equal bit for bit."""
    from faceoff_tpu_torch.io.video import (read_video_frames,
                                            save_frames_as_video)
    from faceoff_tpu_torch.preprocess import detectors, face_crop

    frames = torch.cat([_face_frames(24, 180, 240, "cpu"),
                        _face_frames(20, 180, 240, "cpu", cx=0.3)])
    raw = str(tmp_path / "raw.avi")
    save_frames_as_video(list(frames.numpy()), raw)
    boxes = detectors.HeuristicDetector(device="cpu").detect_batch(frames)
    assert detectors.HeuristicDetector(device=cuda).detect_batch(
        frames.to(cuda)) == boxes
    out = {}
    for dev in ("cpu", cuda):
        paths = face_crop.process_video(raw, str(tmp_path / str(dev)),
                                        min_frames=10, resolution=64,
                                        device=dev)
        out[str(dev)] = [read_video_frames(p, device=dev) for p in paths]
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert len(cpu) == len(gpu) == 2
    for c, g in zip(cpu, gpu):
        assert torch.equal(g.cpu(), c)


# -- mp4: kernels V1-V4 of csrc/mpeg4.cu and the C++ entropy coder ----------

_MP4_STAGES = ("dequant_idct", "motion_compensate", "motion_search",
               "fdct_quant")


@pytest.mark.parametrize("h,w", [(104, 104), (144, 176)])
def test_mpeg4_kernels_equal_plain_at_every_call(cuda, h, w, monkeypatch):
    """An mp4v round trip of 24 frames (two GOPs) on the card, each
    stage's kernel held against its plain version at every call, bit for
    bit; the decode equals the encoder's reconstruction."""
    from faceoff_tpu_torch.data.synthetic import video_frames
    from faceoff_tpu_torch.io import mpeg4
    from faceoff_tpu_torch.ops import mpeg4_cuda as K

    held = {k: 0 for k in _MP4_STAGES}

    def hold(name):
        fn, plain = getattr(K, name), getattr(K, name + "_plain")

        def run(*args):
            if name == "motion_compensate":
                planes = [p.clone() for p in args[0]]
                plain(planes, *args[1:])
                out = fn(*args)
                assert all(torch.equal(a, b) for a, b in zip(args[0], planes))
            elif name == "dequant_idct":
                want = plain(*args[:3], args[3].clone())
                out = fn(*args)
                assert torch.equal(out, want)
            else:
                out = fn(*args)
                assert torch.equal(out, plain(*args))
            held[name] += 1
            return out
        return run

    for name in _MP4_STAGES:
        monkeypatch.setattr(K, name, hold(name))
    frames = video_frames(24, max(h, w), seed=3, device=cuda)[0][:, :h, :w]
    before = dict(K.launches)
    samples, sync, dsi, recon = mpeg4.encode(frames.contiguous(), 25,
                                             return_recon=True)
    got = mpeg4.decode(samples, mpeg4.parse_vol(dsi), cuda, sync=sync)
    assert torch.equal(got, recon)
    assert all(held.values())
    assert all(K.launches[k] > before[k] for k in _MP4_STAGES)


def test_mpeg4_host_coder_equals_python(cuda):
    """The C++ parser on the committed fixture (cv2's stream) and the C++
    writer on the encoder's records equal the Python coder."""
    from pathlib import Path

    from faceoff_tpu_torch.data.synthetic import video_frames
    from faceoff_tpu_torch.io import mp4, mpeg4
    from faceoff_tpu_torch.ops import mpeg4_cuda as K

    fixture = Path(__file__).resolve().parent / "data_torch" / "face_mp4v.mp4"
    track = mp4.read_mp4(str(fixture))
    vol = mpeg4.parse_vol(track.dsi)
    want = mpeg4.parse_vops(track.samples, vol)
    got = K.parse_vops(track.samples, vol.as_ints(), vol.n_mb, cuda)
    assert np.array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.cpu().numpy(), w)
    frames = mpeg4.decode(track.samples, vol, cuda)
    assert np.array_equal(frames.cpu().numpy(), np.load(
        fixture.with_suffix(".npz"))["frames"])
    clip = video_frames(24, 64, seed=2, device=cuda)[0]
    yuv = mpeg4.rgb_to_yuv420(clip, 64, 64)
    vol = mpeg4.Vol(64, 64, 25)
    vop, mb, levels, _ = mpeg4.encode_gops(yuv, 0, vol,
                                           mpeg4.DEFAULT_QSCALE)
    assert K.write_vops(vop, mb, levels, vol.as_ints(), vol.n_mb) == \
        mpeg4.write_vops(vop, mb.cpu().numpy(), levels.cpu().numpy(), vol)


def test_mpeg4_batches_on_the_card_equal_the_cpu(cuda, monkeypatch):
    """On the card, batches of 5 VOPs (GOPs cut, the reconstruction
    carried mid-GOP) decode the file the CPU writes as the CPU decodes
    it, and encode in one-GOP batches the bytes the CPU writes."""
    from faceoff_tpu_torch.data.synthetic import video_frames
    from faceoff_tpu_torch.io import mpeg4

    cpu = torch.device("cpu")
    frames = video_frames(26, 48, seed=3)[0]
    samples, sync, dsi, recon = mpeg4.encode(frames, 25, return_recon=True)
    vol = mpeg4.parse_vol(dsi)
    monkeypatch.setattr(mpeg4, "batch_vops", lambda _vol: 5)
    got = mpeg4.decode(samples, vol, cuda)
    assert torch.equal(got.cpu(), mpeg4.decode(samples, vol, cpu))
    assert torch.equal(got.cpu(), recon)
    monkeypatch.setattr(mpeg4, "batch_vops", lambda _vol: mpeg4.GOP)
    assert mpeg4.encode(frames.to(cuda), 25)[0] == samples


# -- V3 and V4 on adversarial inputs, bit for bit against the plain ----------

def _shifted_frames(rng, h, w, shifts):
    """Frame 0 cut from a noise texture, then the same cut moved by each
    (dy, dx) of `shifts`: P-VOPs against frame 0 whose best vectors are
    known (within +-16) or out of range."""
    pad = 24
    base = rng.integers(0, 256, (h + 2 * pad, w + 2 * pad), dtype=np.uint8)
    cuts = [(0, 0)] + list(shifts)
    return np.stack([base[pad + dy: pad + dy + h, pad + dx: pad + dx + w]
                     for dy, dx in cuts])


@pytest.mark.parametrize("case", ["flat", "shifted", "noise", "100x60",
                                  "smooth"])
def test_mpeg4_motion_search_adversarial(cuda, case):
    """V3 against motion_search_plain bit for bit: flat planes (every
    candidate ties at SAD 0, so the order alone decides), frames shifted
    by known vectors (+-16 and past the range) with interior macroblocks,
    uniform noise, a 100x60 picture in 112x64 planes (the clamps at every
    border), a smooth pattern moved by half pels (the half-pel step and
    the intra test decide); every case several P-VOPs a launch."""
    from faceoff_tpu_torch.ops import mpeg4_cuda as K

    rng = np.random.default_rng(7)
    width = height = None
    if case == "flat":
        y = np.full((3, 48, 96), 77, np.uint8)
        y[2] = 200
        items = [[1, 0], [0, 1], [2, 0]]
    elif case == "shifted":
        y = _shifted_frames(rng, 144, 176, [(16, -16), (-16, 16), (3, 5),
                                            (20, -1), (-7, -19), (0, 17)])
        items = [[0, k] for k in range(1, 7)]
    elif case == "noise":
        y = rng.integers(0, 256, (3, 96, 128), dtype=np.uint8)
        items = [[1, 0], [2, 1], [0, 2]]
    elif case == "100x60":
        y = rng.integers(0, 256, (3, 64, 112), dtype=np.uint8)
        items = [[1, 0], [0, 1], [2, 1]]
        width, height = 100, 60
    else:
        yy, xx = np.mgrid[0:96, 0:160]
        y = np.stack([128 + 60 * np.sin((xx + 0.5 * k) / 7.0)
                      * np.cos((yy - 1.5 * k) / 5.0) for k in range(3)]
                     ).astype(np.uint8)
        items = [[1, 0], [2, 1], [2, 0]]
    n, h16, w16 = y.shape
    width, height = width or w16, height or h16
    planes = torch.from_numpy(y).to(cuda)
    it = torch.tensor(items, dtype=torch.int32, device=cuda)
    before = K.launches["motion_search"]
    got = K.motion_search(planes, it, width, height)
    assert K.launches["motion_search"] == before + 1
    want = K.motion_search_plain(planes.cpu(), it.cpu(), width, height)
    assert torch.equal(got.cpu(), want)
    if case == "shifted":  # the shifts within range are found exactly
        m = (h16 // 16) * (w16 // 16)
        hit = (got[2, :, 1:].cpu() == torch.tensor([-10, -6])).all(1)
        assert int(hit.sum()) > m // 2


def _fdct_patterns(n_mb):
    """Per macroblock (source, prediction) 16 x 16 patterns: residuals of
    +255 and -255 everywhere (intra: white and black, the DC levels that
    clamp to 254 and to 1), +-255 in the sign pattern of DCT basis
    products (the largest coefficients), a checkerboard, noise, and a
    zero residual."""
    from faceoff_tpu_torch.ops import mpeg4_cuda as K

    rng = np.random.default_rng(11)
    c = np.sign(K.FDCT[:, np.arange(16) % 8])
    out = []
    for i in range(n_mb):
        k = i % 8
        if k == 0:
            s, p = np.full((16, 16), 255), np.zeros((16, 16))
        elif k == 1:
            s, p = np.zeros((16, 16)), np.full((16, 16), 255)
        elif k in (2, 3, 4):
            u, v = [(1, 1), (7, 3), (2, 5)][k - 2]
            s = np.where(np.outer(c[v], c[u]) >= 0, 255, 0)
            p = 255 - s
        elif k == 5:
            s = np.where((np.add.outer(np.arange(16), np.arange(16)) % 2)
                         == 0, 255, 0)
            p = 255 - s
        elif k == 6:
            s, p = rng.integers(0, 256, (16, 16)), rng.integers(0, 256,
                                                                (16, 16))
        else:
            s = rng.integers(0, 256, (16, 16))
            p = s
        out.append((s.astype(np.uint8), p.astype(np.uint8)))
    return out


@pytest.mark.parametrize("qp", [1, 4, 5, 8, 9, 24, 25, 31])
def test_mpeg4_fdct_quant_adversarial(cuda, qp):
    """V4 against fdct_quant_plain bit for bit at each qp where the DC
    scaler changes branch, intra and inter macroblocks side by side, on
    the patterns of _fdct_patterns (largest coefficients, clamped DC
    levels), two items a launch. (A level never reaches the 2047 clamp
    from 8-bit samples: |F| <= mpeg4_cuda.F_MAX = 2039, so |level| <=
    1019; tests/test_torch_mpeg4_arith.py shows it.)"""
    from faceoff_tpu_torch.ops import mpeg4_cuda as K

    h16, w16 = 32, 128
    mbw = w16 // 16
    n_mb = (h16 // 16) * mbw
    src = [np.zeros((3, h16, w16), np.uint8),
           np.zeros((3, h16 // 2, w16 // 2), np.uint8),
           np.zeros((3, h16 // 2, w16 // 2), np.uint8)]
    pred = [np.zeros_like(p) for p in src]
    for m, (s, p) in enumerate(_fdct_patterns(n_mb)):
        my, mx = divmod(m, mbw)
        for slot in range(3):
            src[0][slot, my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16] = s
            pred[0][slot, my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16] = p
            for c in (1, 2):
                src[c][slot, my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = \
                    s[::2, ::2]
                pred[c][slot, my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = \
                    p[::2, ::2]
    mb = np.zeros((2, n_mb, 12), np.int32)
    mb[:, :, 1] = qp
    mb[0, :, 0] = np.where(np.arange(n_mb) % 2 == 0, 2, 1)
    mb[1, :, 0] = np.where(np.arange(n_mb) % 2 == 0, 1, 2)
    mb[1, ::4, 0] = 2
    items = [[0, 1], [2, 0]]
    args = ([torch.from_numpy(a).to(cuda) for a in src],
            [torch.from_numpy(a).to(cuda) for a in pred],
            torch.from_numpy(mb).to(cuda),
            torch.tensor(items, dtype=torch.int32, device=cuda))
    before = K.launches["fdct_quant"]
    got = K.fdct_quant(*args)
    assert K.launches["fdct_quant"] == before + 1
    want = K.fdct_quant_plain([a.cpu() for a in args[0]],
                              [a.cpu() for a in args[1]], args[2].cpu(),
                              args[3].cpu())
    assert torch.equal(got.cpu(), want)
    if qp < 5:  # intra white and black blocks reach both DC clamps
        dc = want[..., 0][torch.from_numpy(mb[..., 0] == 2)]
        assert (dc == 254).any() and (dc == 1).any()


# -- V1 and V2 on adversarial inputs, bit for bit against the plain ----------

def _idct_levels(rng, nb):
    """(nb, 64) int16 levels by block j % 8: {0, +-1, +-2, +-2047} at
    random, DC-only rows, +-2047 everywhere (rows that wrap int16, columns
    past COL_SAFE), a 254 DC with 2047 AC in row 0 (the 64-bit column
    pass), zeros, uniform, sparse, one +-2047 coefficient."""
    out = np.zeros((nb, 64), np.int64)
    for j in range(nb):
        k = j % 8
        if k == 0:
            out[j] = rng.choice([0, 0, 1, -1, 2, -2, 2047, -2047], 64)
        elif k == 1:
            out[j, ::8] = rng.integers(-2048, 2048, 8)
        elif k == 2:
            out[j] = rng.choice([2047, -2047], 64)
        elif k == 3:
            out[j, 0], out[j, 2] = 254, 2047
            out[j, 1] = rng.integers(-2047, 2048)
            out[j, 8:16] = rng.integers(-2047, 2048, 8)
        elif k == 5:
            out[j] = rng.integers(-2048, 2048, 64)
        elif k == 6:
            out[j] = np.where(rng.random(64) < 0.15,
                              rng.integers(-300, 301, 64), 0)
        elif k == 7:
            out[j, rng.integers(64)] = rng.choice([2047, -2047])
    return out.astype(np.int16)


def test_mpeg4_dequant_idct_adversarial(cuda):
    """V1 against dequant_idct_plain bit for bit: every qp 1..31 intra and
    inter, luma and chroma blocks, the level patterns of _idct_levels
    (some blocks' columns take the 64-bit pass), bidx a random order of
    most rows, the rows it does not name keeping their values."""
    from faceoff_tpu_torch.ops import mpeg4_cuda as K

    rng = np.random.default_rng(21)
    F, M = 2, 62
    mb = np.zeros((F, M, 12), np.int32)
    mb[:, :, 1] = 1 + np.arange(M) % 31
    mb[:, :, 0] = np.where((np.arange(M)[None] // 31 + np.arange(F)[:, None])
                           % 2 == 0, K.MB_INTRA, K.MB_INTER)
    rows = F * M * 6
    bidx = rng.permutation(rows)[: rows - 40].astype(np.int32)
    levels = _idct_levels(rng, len(bidx))
    out0 = rng.integers(-32768, 32768, (F, M, 6, 64)).astype(np.int16)
    cpu = [torch.from_numpy(a) for a in (levels, bidx, mb)]
    qp, intra, luma = K._block_params(cpu[1], cpu[2])
    wide = K._idct_rows(K.dequantize_plain(cpu[0], qp, intra, luma)
                        .view(-1, 8, 8)).abs().amax(1) > K.COL_SAFE
    assert wide.any() and not wide.all()
    want = K.dequant_idct_plain(*cpu, torch.from_numpy(out0.copy()))
    before = K.launches["dequant_idct"]
    got = K.dequant_idct(*(t.to(cuda) for t in cpu),
                         torch.from_numpy(out0).to(cuda))
    assert K.launches["dequant_idct"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("size,res_kind", [
    ((104, 104, 112, 112), None), ((104, 104, 112, 112), "extreme"),
    ((176, 144, 176, 144), "extreme"), ((176, 144, 176, 144), None),
    ((1280, 720, 1280, 720), "extreme")])
def test_mpeg4_motion_compensate_adversarial(cuda, size, res_kind):
    """V2 against motion_compensate_plain bit for bit: skip, inter and
    intra macroblocks mixed, four distinct vectors a macroblock whose
    chroma sums cover all 16 residues, every half-pel phase, vectors
    reaching up to 200 half pels past every side of the picture (104 x
    104 in 112-pixel planes: the taps clamp to the picture, not the
    plane), both rounding types, items with no reference, the residual
    None or at the int16 extremes; several items a launch."""
    from faceoff_tpu_torch.ops import mpeg4_cuda as K

    width, height, w16, h16 = size
    rng = np.random.default_rng(width + height)
    n_mb = (h16 // 16) * (w16 // 16)
    G, F = 4, 5
    slots = 2 * G + 1
    planes = [rng.integers(0, 256, (slots, h16, w16), dtype=np.uint8),
              rng.integers(0, 256, (slots, h16 // 2, w16 // 2),
                           dtype=np.uint8),
              rng.integers(0, 256, (slots, h16 // 2, w16 // 2),
                           dtype=np.uint8)]
    mb = np.zeros((F, n_mb, 12), np.int32)
    mb[..., 0] = rng.choice([K.MB_SKIP, K.MB_INTER, K.MB_INTER, K.MB_INTRA],
                            (F, n_mb))
    near = rng.integers(-40, 41, (F, n_mb, 8))
    far = rng.integers(-2 * max(w16, h16) - 200, 2 * max(w16, h16) + 201,
                       (F, n_mb, 8))
    mb[..., 4:12] = np.where(rng.random((F, n_mb, 8)) < 0.2, far, near)
    sums = mb[..., 4:12:2].sum(-1)
    assert len(np.unique(sums & 15)) == 16
    assert len(np.unique(mb[..., 4:12] & 1)) == 2
    items = np.asarray([[1, 0, 5, 0], [2, 1, 6, 1], [4, -1, 7, 0],
                        [0, 2, 8, 1]], np.int32)
    res = None
    if res_kind:
        res = rng.choice([-32768, 32767, -256, 256, -255, 255, -1, 0, 1, 77],
                         (F, n_mb, 6, 64)).astype(np.int16)
    want = [torch.from_numpy(p.copy()) for p in planes]
    K.motion_compensate_plain(want, torch.from_numpy(mb),
                              None if res is None else torch.from_numpy(res),
                              torch.from_numpy(items), width, height)
    got = [torch.from_numpy(p).to(cuda) for p in planes]
    before = K.launches["motion_compensate"]
    K.motion_compensate(got, torch.from_numpy(mb).to(cuda),
                        None if res is None else torch.from_numpy(res).to(cuda),
                        torch.from_numpy(items).to(cuda), width, height)
    assert K.launches["motion_compensate"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# -- mp4, Advanced Simple Profile: V1's MPEG and Xvid forms, V2 at
# quarter-pel, V5, and the C++ coder's B-VOPs ---------------------------------

_ASP = ("asp_bframes.mp4", "asp_qpel_mpegq.mp4", "asp_xvid.avi",
        "asp_720p.mp4")


def _asp_stream(name):
    from pathlib import Path

    from faceoff_tpu_torch.io import mp4, mpeg4
    from faceoff_tpu_torch.io import video as tvideo

    path = Path(__file__).resolve().parent / "data_torch" / name
    if name.endswith(".avi"):
        _, _, _, bodies, fourcc = tvideo.read_avi_stream(str(path))
        return path, bodies, mpeg4.parse_vol(bodies[0]), b"", fourcc
    track = mp4.read_mp4(str(path))
    return path, track.samples, mpeg4.parse_vol(track.dsi), track.dsi, b""


@pytest.mark.parametrize("name", _ASP)
def test_mpeg4_asp_kernels_equal_plain_at_every_call(cuda, name,
                                                     monkeypatch):
    """Each Advanced Simple Profile fixture decoded on the card: V1 (H.263
    or MPEG quantisation, simple or Xvid IDCT), V2 (half- or quarter-pel)
    and V5 each held against its plain version at every call, bit for
    bit; the frames equal cv2's stored decode (its digests)."""
    import hashlib

    from faceoff_tpu_torch.io import video as tvideo
    from faceoff_tpu_torch.ops import mpeg4_cuda as K

    held = {}

    def hold(stage):
        fn, plain = getattr(K, stage), getattr(K, stage + "_plain")

        def run(*args):
            if stage == "dequant_idct":
                want = plain(*args[:3], args[3].clone(), *args[4:])
                out = fn(*args)
                assert torch.equal(out, want)
            else:
                planes = [p.clone() for p in args[0]]
                plain(planes, *args[1:])
                out = fn(*args)
                assert all(torch.equal(a, b)
                           for a, b in zip(args[0], planes))
            held[stage] = held.get(stage, 0) + 1
            return out
        return run

    for stage in ("dequant_idct", "motion_compensate", "bidir_compensate"):
        monkeypatch.setattr(K, stage, hold(stage))
    path = _asp_stream(name)[0]
    got = tvideo.read_video_frames(str(path), device=cuda).cpu().numpy()
    z = np.load(path.with_suffix(".npz"))
    assert len(got) == int(z["count"])
    assert [hashlib.sha256(np.ascontiguousarray(f).tobytes()).hexdigest()
            for f in got] == list(z["sha256"])
    assert held.get("bidir_compensate") and held.get("dequant_idct")


@pytest.mark.parametrize("fields,mpeg,xvid", [
    (12, False, True), (12, True, False), (12, True, True),
    (20, False, False), (20, False, True), (20, True, False),
    (20, True, True)])
def test_mpeg4_dequant_idct_asp_forms_adversarial(cuda, fields, mpeg, xvid):
    """V1's Advanced Simple Profile forms against dequant_idct_plain bit
    for bit: anchor (12 fields) and B-VOP (20) records, MPEG quantisation
    with loaded matrices of 1..255 (mismatch control on inter blocks),
    the Xvid IDCT; every qp, levels at the clamps, rows that wrap int16."""
    from faceoff_tpu_torch.ops import mpeg4_cuda as K

    rng = np.random.default_rng(fields + 2 * mpeg + xvid)
    F, M = 2, 62
    mb = np.zeros((F, M, fields), np.int32)
    mb[:, :, 1] = 1 + np.arange(M) % 31
    mb[:, :, 0] = rng.choice([K.MB_INTRA, K.MB_INTER, K.MB_INTER4V],
                             (F, M)) if fields == 12 else K.MB_INTER
    rows = F * M * 6
    bidx = rng.permutation(rows)[: rows - 40].astype(np.int32)
    levels = _idct_levels(rng, len(bidx))
    mats = (torch.from_numpy(rng.integers(1, 256, (2, 64)).astype(np.int32))
            if mpeg else None)
    out0 = rng.integers(-32768, 32768, (F, M, 6, 64)).astype(np.int16)
    cpu = [torch.from_numpy(a) for a in (levels, bidx, mb)]
    want = K.dequant_idct_plain(*cpu, torch.from_numpy(out0.copy()), mats,
                                xvid)
    before = K.launches["dequant_idct"]
    got = K.dequant_idct(*(t.to(cuda) for t in cpu),
                         torch.from_numpy(out0).to(cuda), mats, xvid)
    assert K.launches["dequant_idct"] == before + 1
    assert torch.equal(got.cpu(), want)


def _cross_edges(vec, mbw, mbh, ew, eh, unit, start):
    """Aim the vectors (G, M, 16) of the macroblocks along each side of
    the picture so that each block's window (17 or 9 columns from its
    origin, the vector's unit pels a sample) crosses that edge of the ew x
    eh clamp box by 1, 2, ... 24 px in turn; the phases stay as drawn."""
    i = start
    for g in range(vec.shape[0]):
        sides = [(0, [r * mbw for r in range(mbh)]),
                 (1, [r * mbw + mbw - 1 for r in range(mbh)]),
                 (2, list(range(mbw))),
                 (3, [(mbh - 1) * mbw + c for c in range(mbw)])]
        for side, ms in sides:
            for m in ms:
                k = 1 + i % 24
                i += 1
                my, mx = divmod(m, mbw)
                for p in range(8):
                    b = p % 4
                    size = 16 if b == 0 else 8
                    o = (mx * 16 + 8 * (b & 1) if side < 2
                         else my * 16 + 8 * (b >> 1))
                    edge = ew if side < 2 else eh
                    t = -k if side in (0, 2) else edge + k - size - 1
                    c = 2 * p + (side >= 2)
                    vec[g, m, c] = unit * (t - o) + vec[g, m, c] % unit
    return i


@pytest.mark.parametrize("shape", [
    (112, 112, 104, 104), (1280, 720, 1280, 720), (208, 144, 201, 137),
    (96, 64, 95, 63), (128, 96, 113, 81)],
    ids=["104in112", "720p", "13cols_edge7", "edge1", "edge15"])
@pytest.mark.parametrize("qpel,rule", [(True, 0), (True, 1), (True, 2),
                                       (False, 0)])
def test_mpeg4_qpel_and_bidir_adversarial(cuda, shape, qpel, rule):
    """V2 at quarter-pel and V5 against their plain versions bit for bit:
    skip, inter, four-vector and intra macroblocks (V2), every direction
    and the 8 x 8 form (V5), every quarter-pel (fx, fy) phase pair in 16 x
    16 and 8 x 8 blocks, vectors far past every side of the picture and
    windows that cross each edge of the clamp box by 1-24 px (where a wide
    read gives way to clamped bytes), both rounding types (V2), each
    quarter-pel chroma rule, residuals at the int16 extremes or None. The
    pictures: 104 x 104 in 112-pixel planes, 1280 x 720, 13 macroblock
    columns (not a multiple of the macroblocks a CUDA block takes), and
    clamp boxes 1, 7 and 15 px inside the planes on each side
    (visible_edge)."""
    from faceoff_tpu_torch.ops import mpeg4_cuda as K

    w16, h16, ew, eh = shape
    rng = np.random.default_rng(7 + rule + 10 * qpel + w16 + ew)
    mbw, mbh = w16 // 16, h16 // 16
    n_mb = mbw * mbh
    assert n_mb % K.QPEL_MBS or w16 != 208
    G = 4
    slots = 2 * G + 2
    planes = [rng.integers(0, 256, (slots, h16, w16), dtype=np.uint8),
              rng.integers(0, 256, (slots, h16 // 2, w16 // 2),
                           dtype=np.uint8),
              rng.integers(0, 256, (slots, h16 // 2, w16 // 2),
                           dtype=np.uint8)]
    near = rng.integers(-40, 41, (G, n_mb, 16))
    far = rng.integers(-500, 501, (G, n_mb, 16))
    vec = np.where(rng.random((G, n_mb, 16)) < 0.2, far, near)
    # vector pair p of the i-th macroblock at phase (i + 4 p) % 16 (fx the
    # low two bits): item 0's first 16 one-vector macroblocks and item 1's
    # first 4 four-vector ones take every phase pair
    unit = 4 if qpel else 2
    phase = (np.arange(G * n_mb).reshape(G, n_mb, 1)
             + 4 * np.arange(8)) % 16
    vec[..., 0::2] += phase % 4 % unit - vec[..., 0::2] % unit
    vec[..., 1::2] += phase // 4 % unit - vec[..., 1::2] % unit
    _cross_edges(vec, mbw, mbh, ew, eh, unit, rule)
    res = rng.choice([-32768, 32767, -256, 256, -1, 0, 1, 77],
                     (G, n_mb, 6, 64)).astype(np.int16)
    mb = np.zeros((G, n_mb, 12), np.int32)
    mb[..., 0] = rng.choice([K.MB_SKIP, K.MB_INTER, K.MB_INTER4V,
                             K.MB_INTRA], (G, n_mb))
    mb[0, :16, 0] = K.MB_INTER
    mb[1, :4, 0] = K.MB_INTER4V
    mb[..., 4:12] = vec[..., :8]
    bmb = np.zeros((G, n_mb, K.B_FIELDS), np.int32)
    bmb[..., 0] = K.MB_INTER
    bmb[..., 3] = rng.choice([1, 2, 3, 5, 6, 7], (G, n_mb))
    bmb[0, :16, 3] = K.B_FWD | K.B_BWD
    bmb[1, :4, 3] = K.B_FWD | K.B_BWD | K.B_8X8
    bmb[..., 4:20] = vec
    if qpel:
        assert len(np.unique((vec[0, :16, 0] & 3) * 4
                             + (vec[0, :16, 1] & 3))) == 16
        assert len(np.unique((vec[1, :4, 0:8:2] & 3) * 4
                             + (vec[1, :4, 1:8:2] & 3))) == 16
    for stage, rec, items in (
            ("motion_compensate", mb,
             [[0, 0, 2, 0], [1, 1, 3, 1], [2, -1, 4, 0], [3, 0, 5, 1]]),
            ("bidir_compensate", bmb,
             [[0, 0, 1, 6], [1, 1, 0, 7], [2, 0, 1, 8], [3, 1, 0, 9]])):
        if stage == "motion_compensate" and not qpel:
            continue  # the half-pel V2 has its own test above
        for r in (res, None):
            items_t = torch.tensor(items, dtype=torch.int32)
            want = [torch.from_numpy(p.copy()) for p in planes]
            getattr(K, stage + "_plain")(
                want, torch.from_numpy(rec),
                None if r is None else torch.from_numpy(r), items_t, ew,
                eh, qpel, rule)
            got = [torch.from_numpy(p).to(cuda) for p in planes]
            before = K.launches[stage]
            getattr(K, stage)(got, torch.from_numpy(rec).to(cuda),
                              None if r is None else
                              torch.from_numpy(r).to(cuda),
                              items_t.to(cuda), ew, eh, qpel, rule)
            assert K.launches[stage] == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("name", _ASP)
def test_mpeg4_host_coder_equals_python_asp(cuda, name):
    """The C++ parser (anchors, then the B-VOPs reading their future
    anchor's records) equals the Python one on each fixture, records and
    blocks, B-VOPs' apart."""
    from faceoff_tpu_torch.io import mpeg4
    from faceoff_tpu_torch.ops import mpeg4_cuda as K

    _, samples, vol, headers, fourcc = _asp_stream(name)
    plan = mpeg4.plan_stream(samples, vol, headers, fourcc)
    rows = np.stack([plan.kind, plan.trb, plan.trd], 1).astype(np.int32)
    want = mpeg4.parse_batch(plan.data, vol, rows, plan.quirks.direct_16)
    got = K.parse_batch(plan.data, vol.as_ints(), vol.n_mb, cuda, rows,
                        plan.quirks.direct_16)
    assert np.array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.cpu().numpy(), w)


# -- H.264 ----------------------------------------------------------------------

_H264 = ("h264_cb.mp4", "h264_slices.mp4", "h264_avc3_vui.mp4")


def _h264_stream(name, max_pictures=None):
    from pathlib import Path
    from faceoff_tpu_torch.io import h264, mp4
    track = mp4.read_mp4(str(Path(__file__).resolve().parent / "data_torch"
                             / name))
    return h264.scan(track.samples, h264.parse_avcc(track.dsi), max_pictures)


@pytest.mark.parametrize("name", _H264)
def test_h264_kernels_equal_plain_at_every_call(cuda, name, monkeypatch):
    """Each 104-px fixture decoded on the card (five pictures a batch, so
    reference pictures are carried): every H1-H4 call equals its plain
    version on the same inputs, and the frames equal the CPU decode."""
    from pathlib import Path
    from faceoff_tpu_torch.io import h264
    from faceoff_tpu_torch.io import video as tvideo
    from faceoff_tpu_torch.ops import h264_cuda as K

    monkeypatch.setattr(h264, "batch_pictures", lambda sps: 5)
    calls = {}
    for stage in ("residual", "inter_predict", "intra_reconstruct",
                  "deblock"):
        fn, plain = getattr(K, stage), getattr(K, stage + "_plain")

        def run(*args, fn=fn, plain=plain, stage=stage):
            if stage == "residual":
                want = plain(*args)
                got = fn(*args)
            else:
                want = [p.clone() for p in args[0]]
                plain(want, *args[1:])
                fn(*args)
                got = args[0]
            for g, w in zip(got, want):
                assert torch.equal(g, w), stage
            calls[stage] = calls.get(stage, 0) + 1
            return got if stage == "residual" else None

        monkeypatch.setattr(K, stage, run)
    path = str(Path(__file__).resolve().parent / "data_torch" / name)
    got = tvideo.read_video_frames(path, device=cuda)
    want = tvideo.read_video_frames(path, device="cpu")
    assert torch.equal(got.cpu(), want)
    assert calls["residual"] >= 3 and calls["inter_predict"] >= 10
    assert calls["intra_reconstruct"] >= 2
    if name != "h264_avc3_vui.mp4":
        assert calls["deblock"] >= 10


@pytest.mark.parametrize("name", _H264 + ("h264_720p.mp4",))
def test_h264_host_parser_equals_python(cuda, name):
    """The C++ macroblock parser equals the Python one record for record
    (the 720p fixture's first IDR period)."""
    from faceoff_tpu_torch.io import h264
    from faceoff_tpu_torch.ops import h264_cuda as K

    stream = _h264_stream(name, 12 if "720" in name else None)
    n = len(stream.pictures)
    slot = {i: i for i in range(n)}
    got, got_info = K.parse_batch(stream, 0, n, slot, cuda)
    want, want_info = h264.entropy_decode(stream, 0, n, slot,
                                          torch.device("cpu"))
    assert np.array_equal(got_info, want_info)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _h264_records(rng, n, mbw, mbh, kinds, qps):
    from faceoff_tpu_torch.ops import h264_cuda as K
    m = mbw * mbh
    mb = np.zeros((n, m, K.MB_FIELDS), np.int32)
    mb[..., K.F_KIND] = rng.choice(kinds, (n, m))
    mb[..., K.F_QP] = rng.choice(qps, (n, m))
    mb[..., K.F_QPC] = rng.integers(-12, 13, (n, m))
    return mb


@pytest.mark.parametrize("qps", [(0,), (51,), tuple(range(52))])
def test_h264_residual_adversarial(cuda, qps):
    """H1 at QP 0, 51 and all between, levels at the int16 extremes on
    every block of every kind (the int32 arithmetic wraps alike in both),
    a 720p batch of two pictures: bit for bit."""
    from faceoff_tpu_torch.ops import h264_cuda as K

    rng = np.random.default_rng(len(qps))
    mbw, mbh, n = 80, 45, 2
    mb = _h264_records(rng, n, mbw, mbh, [K.H_SKIP, K.H_INTER, K.H_I4,
                                          K.H_I16, K.H_PCM], qps)
    present = rng.random((n, mbw * mbh, K.NBLK)) < 0.7
    bmap = np.where(present, np.cumsum(present).reshape(present.shape) - 1,
                    -1).astype(np.int32)
    coef = rng.choice([-32768, -32767, -1, 0, 1, 255, 32767],
                      (int(present.sum()), 16)).astype(np.int16)
    args = [torch.from_numpy(a).to(cuda) for a in (coef, bmap, mb)]
    got = K.residual(*args, mbw)
    want = K.residual_plain(*args, mbw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mbw,mbh", [(7, 7), (80, 45), (13, 3)])
def test_h264_inter_predict_adversarial(cuda, mbw, mbh):
    """H2 with vectors crossing each edge of the coded picture by 1-64 px
    at every quarter-pel (and eighth-pel chroma) phase, three reference
    slots, residuals at +-400 and the int16 extremes, intra and skipped
    macroblocks among the inter ones: bit for bit."""
    from faceoff_tpu_torch.ops import h264_cuda as K

    rng = np.random.default_rng(mbw)
    m = mbw * mbh
    hl, wl = 16 * mbh, 16 * mbw
    planes = [torch.from_numpy(rng.integers(0, 256, (4, hl // s, wl // s))
                               .astype(np.uint8)).to(cuda)
              for s in (1, 2, 2)]
    mb = _h264_records(rng, 1, mbw, mbh, [K.H_SKIP, K.H_INTER, K.H_INTER,
                                          K.H_I4], [26])[0]
    blk = np.zeros((m, 16, 4), np.int32)
    k = m * 16
    phase = np.arange(k) % 16
    over = rng.integers(1, 65, k)
    edge = rng.integers(0, 4, k)
    x = np.where(edge == 0, -over - 16, np.where(edge == 1, wl + over,
                                                 rng.integers(0, wl, k)))
    y = np.where(edge == 2, -over - 16, np.where(edge == 3, hl + over,
                                                 rng.integers(0, hl, k)))
    mbx = (np.arange(k) // 16 % mbw) * 16
    mby = (np.arange(k) // 16 // mbw) * 16
    blk[..., 0] = (4 * (x - mbx) + phase // 4).reshape(m, 16)
    blk[..., 1] = (4 * (y - mby) + phase % 4).reshape(m, 16)
    blk[..., 2] = rng.integers(0, 3, (m, 16))
    ry = rng.choice([-32768, -400, -3, 0, 5, 400, 32767], (hl, wl))
    rc = rng.choice([-32768, -400, -3, 0, 5, 400, 32767],
                    (2, hl // 2, wl // 2))
    args = [torch.from_numpy(a.astype(t)).to(cuda) for a, t in (
        (mb, np.int32), (blk, np.int32), (ry, np.int16), (rc, np.int16))]
    want = [p.clone() for p in planes]
    K.inter_predict_plain(want, 3, *args, mbw)
    K.inter_predict(planes, 3, *args, mbw)
    for g, w in zip(planes, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed,mbw,mbh,cip,slices", [
    (1, 80, 45, 0, 1), (2, 80, 45, 1, 7), (3, 9, 4, 0, 36), (4, 7, 7, 1, 1),
    (5, 37, 1, 0, 1), (6, 23, 2, 1, 3), (7, 120, 68, 0, 5),
    (8, 13, 45, 1, 2)])
def test_h264_intra_reconstruct_adversarial(cuda, seed, mbw, mbh, cip,
                                            slices):
    """H3 on random pictures of every intra mode the neighbours allow,
    I_PCM, inter macroblocks, slices (36 of one macroblock each: nothing
    is available) and constrained intra prediction, a 720p and a
    1920x1088 picture among them, and heights of 1, 2 and 45 macroblock
    rows (not multiples of the rows a thread block): bit for bit."""
    from test_torch_h264_kernels import _intra_case
    from faceoff_tpu_torch.ops import h264_cuda as K

    mb, pcm, planes, ry, rc = _intra_case(seed, mbw, mbh, cip, slices)
    got = [torch.from_numpy(p).unsqueeze(0).to(cuda) for p in planes]
    args = [torch.from_numpy(a).to(cuda) for a in (mb, pcm, ry, rc)]
    want = [p.clone() for p in got]
    K.intra_reconstruct_plain(want, 0, *args, mbw)
    K.intra_reconstruct(got, 0, *args, mbw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed,mbw,mbh,cip", [(1, 80, 45, 0), (2, 80, 45, 1),
                                             (3, 120, 68, 1), (4, 41, 9, 0),
                                             (5, 2048, 2, 0)])
def test_h264_intra_reconstruct_sparse_p(cuda, seed, mbw, mbh, cip):
    """H3 on P pictures: runs of 20-300 inter and skipped macroblocks
    (whole rows among them) between single intra or I_PCM ones and short
    runs of them, with and without constrained intra prediction, rows of
    MAX_MB_WIDTH = 2048 macroblocks (every word of H3's row masks) among
    them: bit for bit."""
    from test_torch_h264_kernels import _intra_case
    from faceoff_tpu_torch.ops import h264_cuda as K

    rng = np.random.default_rng(100 + seed)
    m = mbw * mbh
    kinds = np.empty(m, np.int64)
    i = 0
    while i < m:
        run = int(rng.integers(20, 301))
        kinds[i: i + run] = rng.choice([K.H_INTER, K.H_SKIP], min(run, m - i))
        i += run
        n_intra = int(rng.choice([1, 1, 2, 5]))
        kinds[i: i + n_intra] = rng.choice([K.H_I4, K.H_I16, K.H_PCM],
                                           min(n_intra, max(m - i, 0)),
                                           p=[.6, .3, .1])
        i += n_intra
    mb, pcm, planes, ry, rc = _intra_case(seed, mbw, mbh, cip, 1, kinds)
    assert 0 < (mb[:, K.F_KIND] >= K.H_I4).sum() < m // 10
    got = [torch.from_numpy(p).unsqueeze(0).to(cuda) for p in planes]
    args = [torch.from_numpy(a).to(cuda) for a in (mb, pcm, ry, rc)]
    want = [p.clone() for p in got]
    K.intra_reconstruct_plain(want, 0, *args, mbw)
    K.intra_reconstruct(got, 0, *args, mbw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed,mbw,mbh,slices,off", [
    (1, 80, 1, 1, 0.0), (2, 33, 2, 3, 0.3), (3, 80, 45, 9, 0.5),
    (4, 120, 68, 6, 0.3), (5, 17, 45, 45, 0.6), (6, 2048, 2, 5, 0.4)])
def test_h264_deblock_slices_and_shapes(cuda, seed, mbw, mbh, slices, off):
    """H4 on pictures cut into slices, each with its own
    disable_deblocking_filter_idc (0 or 1, a share `off` of them 1),
    filter offsets and chroma QP offset, every macroblock kind and bS:
    heights of 1, 2 and 45 macroblock rows (not multiples of the rows a
    thread block), a 1920x1088 picture, rows of MAX_MB_WIDTH = 2048
    macroblocks (every word of H4's row masks), runs of filter-off
    macroblocks and whole rows of them: bit for bit."""
    from faceoff_tpu_torch.ops import h264_cuda as K

    rng = np.random.default_rng(seed)
    m = mbw * mbh
    mb = _h264_records(rng, 1, mbw, mbh, [K.H_SKIP, K.H_INTER, K.H_INTER,
                                          K.H_I4, K.H_I16, K.H_PCM],
                       tuple(range(10, 52)))[0]
    bounds = np.sort(rng.choice(np.arange(1, m), slices - 1, replace=False))
    sl = np.searchsorted(bounds, np.arange(m), side="right")
    per = rng.random(slices) < off
    mb[:, K.F_SLICE] = sl
    mb[:, K.F_FILTER] = per[sl]
    mb[:, K.F_ALPHA] = (2 * rng.integers(-6, 7, slices))[sl]
    mb[:, K.F_BETA] = (2 * rng.integers(-6, 7, slices))[sl]
    mb[:, K.F_QPC] = rng.integers(-12, 13, slices)[sl]
    blk = np.zeros((m, 16, 4), np.int32)
    blk[..., :2] = rng.integers(-6, 7, (m, 16, 2))
    blk[..., 2] = rng.integers(0, 3, (m, 16))
    blk[..., 3] = (rng.random((m, 16)) < 0.2) * rng.integers(1, 16, (m, 16))
    planes = [torch.from_numpy(np.clip(128 + rng.integers(
        -12, 13, (2, 16 * mbh // s, 16 * mbw // s)), 0, 255).astype(
            np.uint8)).to(cuda) for s in (1, 2, 2)]
    args = [torch.from_numpy(a).to(cuda) for a in (mb, blk)]
    want = [p.clone() for p in planes]
    before = planes[0][1].clone()
    K.deblock_plain(want, 1, *args, mbw)
    K.deblock(planes, 1, *args, mbw)
    for g, w in zip(planes, want):
        assert torch.equal(g, w)
    assert per.all() or not torch.equal(planes[0][1], before)


@pytest.mark.parametrize("qps", [(0,), (51,), (0, 17, 30, 51)])
def test_h264_deblock_adversarial(cuda, qps):
    """H4 on a 720p picture of every macroblock kind, every bS, smooth
    samples (so most lines filter), QP 0 and 51, offsets at +-12,
    slices that do not filter: bit for bit."""
    from faceoff_tpu_torch.ops import h264_cuda as K

    rng = np.random.default_rng(len(qps) + qps[0])
    mbw, mbh = 80, 45
    m = mbw * mbh
    mb = _h264_records(rng, 1, mbw, mbh, [K.H_SKIP, K.H_INTER, K.H_INTER,
                                          K.H_I4, K.H_I16, K.H_PCM], qps)[0]
    mb[:, K.F_FILTER] = rng.random(m) < 0.1
    mb[:, K.F_ALPHA] = rng.choice([-12, 0, 12], m)
    mb[:, K.F_BETA] = rng.choice([-12, 0, 12], m)
    blk = np.zeros((m, 16, 4), np.int32)
    blk[..., :2] = rng.integers(-5, 6, (m, 16, 2))
    blk[..., 2] = rng.integers(0, 2, (m, 16))
    blk[..., 3] = (rng.random((m, 16)) < 0.2) * 3
    planes = [torch.from_numpy(np.clip(128 + rng.integers(
        -10, 11, (1, 16 * mbh // s, 16 * mbw // s)), 0, 255).astype(
            np.uint8)).to(cuda) for s in (1, 2, 2)]
    args = [torch.from_numpy(a).to(cuda) for a in (mb, blk)]
    want = [p.clone() for p in planes]
    K.deblock_plain(want, 0, *args, mbw)
    K.deblock(planes, 0, *args, mbw)
    for g, w in zip(planes, want):
        assert torch.equal(g, w)
