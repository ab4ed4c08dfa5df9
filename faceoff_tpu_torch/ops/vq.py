"""EMA vector quantization, the counterpart of `faceoff_tpu/ops/vq.py`.

Nearest-code assignment by squared L2 distance, written as
argmax_j (x . e_j - 0.5 ||e_j||^2) with the scores in float32; ties go to
the lowest index, as `jnp.argmax` and `torch.argmax` both do.

Training (`vq_quantize_train`) assigns, quantizes and gathers the EMA
statistics in one call of `vq_assign`: a CUDA tensor goes to the
hand-written kernels (`ops/vq_cuda.py`, `csrc/vq.cu`) at every codebook
size, a CPU tensor to `vq_assign_plain` beside it, which is also the
kernels' reference. `use_kernels=False` (`ModelConfig.use_pallas_vq`
off, the CLIs' --no_pallas) sends every device to `vq_assign_plain`, as
the JAX package's `use_pallas=False` takes its XLA path. The JAX package
also sends codebooks above 2048 codes to XLA instead of its Pallas
kernel (`faceoff_tpu/ops/vq.py:204-210`); that crossover was measured on
a TPU v5e and is not carried over.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from faceoff_tpu_torch.ops import vq_cuda
from faceoff_tpu_torch.parallel import collectives


class VQCodebook(NamedTuple):
    """EMA codebook state for one quantizer level.

    embed:        (dim, n_embed) float32 — current codebook.
    cluster_size: (n_embed,)     float32 — EMA of per-code counts.
    embed_avg:    (dim, n_embed) float32 — EMA of per-code input sums.
    """

    embed: torch.Tensor
    cluster_size: torch.Tensor
    embed_avg: torch.Tensor

    @property
    def dim(self) -> int:
        return self.embed.shape[0]

    @property
    def n_embed(self) -> int:
        return self.embed.shape[1]


def init_codebook(
    generator: torch.Generator, dim: int, n_embed: int,
    device: Optional[torch.device] = None,
) -> VQCodebook:
    """Standard-normal codebook drawn on the generator's device; the EMA
    average starts as a copy of it and the counts at zero."""
    embed = torch.randn((dim, n_embed), generator=generator,
                        device=generator.device)
    if device is not None:
        embed = embed.to(device)
    return VQCodebook(embed, torch.zeros(n_embed, device=embed.device),
                      embed.clone())


def nearest_code(flat: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """flat (N, dim), embed (dim, n_embed) -> (N,) int64 nearest indices."""
    e = embed.to(torch.float32)
    scores = flat.to(torch.float32) @ e
    scores = scores - 0.5 * (e * e).sum(dim=0)[None, :]
    return torch.argmax(scores, dim=-1)


def codebook_lookup(indices: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Embed indices: (...,) int -> (..., dim)."""
    return F.embedding(indices, embed.t())


def vq_lookup(
    codebook: VQCodebook, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize activations x (..., dim).

    Returns (quantized in x's dtype, indices, diff) where diff is the
    commitment term mean((q - x)^2) in float32. The straight-through form
    x + (q - x) is kept so that the values round as the JAX package's do.
    """
    flat = x.reshape(-1, codebook.dim)
    indices = nearest_code(flat, codebook.embed).reshape(x.shape[:-1])
    quant = codebook_lookup(indices, codebook.embed).to(x.dtype)
    diff = torch.mean((quant.to(torch.float32) - x.to(torch.float32)) ** 2)
    quant = x + (quant - x).detach()
    return quant, indices, diff


# elements of one block of vq_stats' float64 one-hot on CUDA (256 MiB)
STATS_CHUNK_ELEMS = 1 << 25


def vq_stats(
    flat: torch.Tensor, indices: torch.Tensor, n_embed: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat (N, dim), indices (N,) -> (counts (n_embed,), sums
    (dim, n_embed)), float32.

    On the CPU the sums are an index_add_, which adds the rows in order
    and needs no (N, K) buffer. On CUDA index_add_ adds with atomics, in
    an order that changes from run to run, and index_put_'s sorted sums
    add a code's rows one after another in one warp (the codes of a young
    codebook crowd into a few, so a call took hundreds of ms). There the
    sums are the JAX package's one-hot product instead, in float64 over
    STATS_CHUNK_ELEMS-element blocks of rows added in order: the same
    product on the same inputs gives the same bits, so a run and its
    resume repeat bit for bit, as the statistics kernel does; float64
    sums are finer than float32's and no TF32 setting reaches them."""
    idx = indices.reshape(-1).long()
    counts = torch.bincount(idx, minlength=n_embed).to(torch.float32)
    f32 = flat.to(torch.float32)
    if f32.device.type == "cpu":
        sums = torch.zeros((n_embed, f32.shape[1]), dtype=torch.float32)
        return counts, sums.index_add_(0, idx, f32).t().contiguous()
    codes = torch.arange(n_embed, device=f32.device)
    sums = torch.zeros((f32.shape[1], n_embed), dtype=torch.float64,
                       device=f32.device)
    rows = max(1, STATS_CHUNK_ELEMS // n_embed)
    for lo in range(0, idx.shape[0], rows):
        hot = (idx[lo:lo + rows, None] == codes).to(torch.float64)
        sums += f32[lo:lo + rows].t().to(torch.float64) @ hot
    return counts, sums.to(torch.float32)


def vq_assign_plain(
    flat: torch.Tensor, embed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the VQ kernels, with the return signature of
    `faceoff_tpu/ops/vq_pallas.vq_assign`: flat (N, D), embed (D, K) ->
    (idx (N,) int32, quant (N, D) f32, counts (K,) f32, sums (D, K) f32),
    all in float32 whatever the inputs and any autocast."""
    with torch.autocast(flat.device.type, enabled=False):
        x32 = flat.detach().to(torch.float32)
        e32 = embed.detach().to(torch.float32)
        idx = nearest_code(x32, e32)
        quant = codebook_lookup(idx, e32)
        counts, sums = vq_stats(x32, idx, e32.shape[1])
    return idx.to(torch.int32), quant, counts, sums


def vq_assign(
    flat: torch.Tensor, embed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assignment, quantized rows and EMA statistics at any codebook size:
    a CPU tensor takes `vq_assign_plain`, any other device the CUDA
    kernels, which raise on what they cannot take."""
    if flat.device.type == "cpu":
        return vq_assign_plain(flat, embed)
    return vq_cuda.vq_assign(flat, embed)


def vq_assign_rows(
    flat: torch.Tensor, embed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The assignment half of `vq_assign` alone: (idx (N,) int32, quant
    (N, D) f32), for a training-mode forward whose statistics would be
    thrown away. A CPU tensor takes the plain version, any other device
    the assignment kernel."""
    if flat.device.type == "cpu":
        idx, quant, _, _ = vq_assign_plain(flat, embed)
        return idx, quant
    return vq_cuda.assign_rows(flat.detach().to(torch.float32).contiguous(),
                               embed.detach().to(torch.float32).contiguous())


def vq_ema_update(
    codebook: VQCodebook,
    counts: torch.Tensor,
    sums: torch.Tensor,
    *,
    decay: float = 0.99,
    eps: float = 1e-5,
    process_group=None,
) -> VQCodebook:
    """One EMA step of the codebook from assignment statistics: EMA of the
    counts and sums, Laplace-smoothed counts, codebook = sums / counts.
    With a `process_group` the statistics are this process's and are
    summed over the group first (one all-reduce of both), as the JAX
    function psums them over its `axis_name`, so every process takes the
    same step."""
    counts = counts.detach()
    sums = sums.detach()
    if process_group is not None:
        k = counts.numel()
        both = torch.cat([counts.reshape(-1), sums.reshape(-1)])
        torch.distributed.all_reduce(both, group=process_group)
        counts, sums = both[:k], both[k:].reshape(sums.shape)
    cluster_size = codebook.cluster_size * decay + counts * (1.0 - decay)
    embed_avg = codebook.embed_avg * decay + sums * (1.0 - decay)
    n = torch.sum(cluster_size)
    smoothed = (cluster_size + eps) / (n + codebook.n_embed * eps) * n
    embed = embed_avg / smoothed[None, :]
    return VQCodebook(embed, cluster_size, embed_avg)


def revive_dead_codes(
    codebook: VQCodebook,
    x: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    usage_threshold: float = 1e-3,
    rows: Optional[torch.Tensor] = None,
    process_group=None,
    time_parallel: int = 1,
) -> VQCodebook:
    """Re-seed codes whose EMA usage fell below `usage_threshold` with
    rows of x (..., dim) taken as (N, dim): code j takes row `rows[j]`,
    drawn uniformly from `generator` unless given. Revived codes restart
    at count 1. With a `process_group`, x is this process's block: the
    blocks are gathered into the global rows first and every process
    draws from them with its generator, which must be seeded alike on
    every process, so that the codebooks stay identical. Over a data x
    time mesh (`time_parallel` > 1) x is (B, T, ..., dim), this process's
    block of clips and frames, and the rows are gathered in the
    one-process (B, T, ...) order (`collectives.all_gather_clips`), so
    that the draw picks the rows a one-process revive on the global batch
    picks."""
    if process_group is not None:
        x = collectives.all_gather_clips(x.detach(), process_group,
                                         time_parallel)
    flat = x.reshape(-1, codebook.dim)
    n_embed = codebook.n_embed
    if rows is None:
        rows = torch.randint(0, flat.shape[0], (n_embed,),
                             generator=generator, device=generator.device)
    rows = rows.to(flat.device).long()
    dead = codebook.cluster_size < usage_threshold
    replacements = flat.detach().to(torch.float32)[rows].t()
    embed = torch.where(dead[None, :], replacements, codebook.embed)
    embed_avg = torch.where(dead[None, :], replacements, codebook.embed_avg)
    cluster_size = torch.where(
        dead, torch.ones_like(codebook.cluster_size), codebook.cluster_size)
    return VQCodebook(embed, cluster_size, embed_avg)


def vq_quantize_train(
    codebook: VQCodebook,
    x: torch.Tensor,
    *,
    decay: float = 0.99,
    eps: float = 1e-5,
    update: bool = True,
    process_group=None,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, VQCodebook]:
    """Training-mode quantization of x (..., dim): lookup, straight-through
    gradient and EMA update. Returns (quantized in x's dtype, indices,
    diff, new codebook); diff = mean((q - x)^2) in float32 carries the
    commitment gradient to x. With update=False the statistics are not
    gathered and the codebook comes back as it was: the quantized values
    are the same, as the JAX package's are when its caller drops the EMA
    update. `process_group`: see `vq_ema_update`. `use_kernels=False`
    takes `vq_assign_plain` on every device, where `vq_assign` and
    `vq_assign_rows` send a CUDA tensor to the kernels (the JAX function's
    `use_pallas=False` and True)."""
    flat = x.reshape(-1, codebook.dim)
    if not update:
        if use_kernels:
            indices, quant_flat = vq_assign_rows(flat, codebook.embed)
        else:
            indices, quant_flat, _, _ = vq_assign_plain(flat, codebook.embed)
        quant = quant_flat.reshape(x.shape).to(x.dtype)
        diff = torch.mean((quant.to(torch.float32)
                           - x.to(torch.float32)) ** 2)
        return (x + (quant - x).detach(), indices.reshape(x.shape[:-1]),
                diff, codebook)
    assign = vq_assign if use_kernels else vq_assign_plain
    indices, quant_flat, counts, sums = assign(flat, codebook.embed)
    quant = quant_flat.reshape(x.shape).to(x.dtype)
    indices = indices.reshape(x.shape[:-1])
    diff = torch.mean((quant.to(torch.float32) - x.to(torch.float32)) ** 2)
    quant_st = x + (quant - x).detach()
    new_codebook = vq_ema_update(codebook, counts, sums, decay=decay, eps=eps,
                                 process_group=process_group)
    return quant_st, indices, diff, new_codebook


def codebook_perplexity(indices: torch.Tensor, n_embed: int) -> torch.Tensor:
    """exp(entropy) of the empirical code usage, a codebook-health metric."""
    counts = torch.bincount(indices.reshape(-1).long(), minlength=n_embed)
    probs = counts.to(torch.float32) / max(indices.numel(), 1)
    return torch.exp(-torch.sum(probs * torch.log(probs + 1e-10)))
