"""The port on the card: the warp kernels (forward and backward) and the
VQ kernels against their plain versions, the serving path and a training
step on CUDA against the same on the CPU, nvJPEG on the committed
fixtures, the copy to the card, a resume through the command line, and
the swap: the warp of a swap chunk and the swap command line's device
pipeline; the GAN stage: its kernels at the path's shapes and a
mocoganhd pair's launches; the functional streaming push and a serving
bundle exported for the card; VQVAE_B2F's training forward (its six
quantizers through the VQ kernels) and the shardmap step in a one-rank
NCCL group against the plain step.

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
