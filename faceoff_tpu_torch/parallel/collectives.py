"""Process-level distributed helpers, counterpart of
`faceoff_tpu/parallel/collectives.py`.

The JAX package drives every local chip from one process and puts its
collectives inside compiled programs. PyTorch's idiom is one process a
GPU over `torch.distributed`: NCCL between CUDA devices, gloo between CPU
processes. Without a process group every helper here is the one-process
identity (world 1, rank 0, primary), as the JAX helpers are on one host.

`initialize_distributed` joins the group from explicit flags (the JAX
CLIs' --coordinator_address/--num_processes/--process_id) or from the
standard `torchrun` environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK); with neither it stays one process. `enable_compilation_cache` has
no counterpart: it turns on XLA's compilation cache, and the port
compiles no XLA programs (its CUDA kernels build once per process with
nvcc, `ops/cuda_build.py`).

The tensor helpers take a `group`: None means the default (world)
group. `all_reduce_mean` and `all_reduce_sum` are differentiable
(`torch.distributed.nn`), so that statistics reduced inside a forward
(BatchNorm, the RaLSGAN batch means) carry their gradient to every rank,
as a `psum` inside a JAX program does.

Compute over a clip sharded in time (a mesh with `time > 1`) adds
`mesh_groups`, which builds each process's time and data groups, and
`halo_exchange`, the differentiable swap of edge frames between time
neighbours that XLA's SPMD partitioner inserts around the JAX package's
Conv3D postnets when their frame axis is sharded.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from faceoff_tpu_torch.device import DeviceLike, resolve_device

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device: DeviceLike = None,
                           timeout_s: float = 600.0) -> None:
    """Join the process group: over `tcp://coordinator_address` with
    `num_processes` and `process_id` when all three are given (a partial
    set raises), else from the torchrun environment when it is set, else
    stay one process. The backend is NCCL when this process's device
    (`device`, CUDA unless named) is CUDA, gloo otherwise; a CUDA process
    takes the GPU of its LOCAL_RANK (else its rank modulo the GPUs it
    sees). A second call is a no-op."""
    if _initialized():
        return
    flags = {"coordinator_address": coordinator_address,
             "num_processes": num_processes, "process_id": process_id}
    given = {k: v for k, v in flags.items() if v is not None}
    if given and len(given) != len(flags):
        missing = sorted(set(flags) - set(given))
        raise ValueError("explicit multi-process coordination needs all "
                         "three flags; missing: "
                         + ", ".join("--" + m for m in missing))
    if given:
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        print("single-process run (no coordination flags and no torchrun "
              "environment: distributed init skipped)", flush=True)
        return
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        backend = "nccl"
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def destroy() -> None:
    """Leave the process group, if there is one."""
    if _initialized():
        dist.destroy_process_group()


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints and samples."""
    return get_rank() == 0


def default_group():
    """The world group once this process has joined a process group (of
    any size: a one-process group runs the collectives too, each the
    identity), else None, the helpers' and the models' 'no collective'."""
    return dist.group.WORLD if _initialized() else None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of x over the group's processes, differentiable."""
    if not _initialized():
        return x
    import torch.distributed.nn.functional as dnn

    return dnn.all_reduce(x, op=dist.ReduceOp.SUM,
                          group=group if group is not None
                          else dist.group.WORLD)


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of x over the group's processes, differentiable (the JAX
    package's `pmean`)."""
    if not _initialized():
        return x
    n = dist.get_world_size(group)
    return all_reduce_sum(x, group) / n


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenate every process's x (equal shapes) along axis 0 in rank
    order: the global batch of per-process blocks. Not differentiable."""
    if not _initialized():
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def all_gather_clips(x: torch.Tensor, group=None,
                     time: int = 1) -> torch.Tensor:
    """The whole (B, T, ...) batch on every process, from each process's
    (B/data, T/time, ...) block of a data x time mesh over `group` (rank
    r holds clip block r // time and frame block r % time, as
    `parallel.mesh.Mesh` lays them out); with time 1, `all_gather_rows`.
    The result is in the one-process (B, T, ...) order. Not
    differentiable."""
    rows = all_gather_rows(x, group)
    if time == 1 or rows is x:
        return rows
    b, t = x.shape[:2]
    blocks = rows.reshape((-1, time, b, t) + tuple(x.shape[2:]))
    return blocks.transpose(1, 2).reshape((-1, time * t)
                                          + tuple(x.shape[2:]))


def mesh_groups(mesh):
    """(time group, data group) of this process on a data x time `mesh`
    (`parallel.mesh.Mesh`): the processes that hold the same clips (one
    `data_index`, every frame block) and those that hold the same frame
    block of every clip. Every process builds every group, in one order
    (`dist.new_group` is collective); without a process group both are
    None."""
    if not _initialized():
        return None, None
    mine = {}
    for d in range(mesh.data):
        ranks = [d * mesh.time + k for k in range(mesh.time)]
        group = dist.new_group(ranks)
        if d == mesh.data_index:
            mine["time"] = group
    for k in range(mesh.time):
        ranks = [d * mesh.time + k for d in range(mesh.data)]
        group = dist.new_group(ranks)
        if k == mesh.time_index:
            mine["data"] = group
    return mine["time"], mine["data"]


def _exchange(to_prev: torch.Tensor, to_next: torch.Tensor, group):
    """Send `to_prev` to the previous process of the time group and
    `to_next` to the next, in one batch of point-to-point operations;
    return (what the previous sent, what the next sent), zeros where the
    clip ends. Both tensors have one shape, as every block of a time
    group does."""
    ranks = dist.get_process_group_ranks(group)
    i = ranks.index(dist.get_rank())
    from_prev = torch.zeros_like(to_prev)
    from_next = torch.zeros_like(to_prev)
    ops = []
    if i > 0:
        ops += [dist.P2POp(dist.isend, to_prev, ranks[i - 1], group),
                dist.P2POp(dist.irecv, from_prev, ranks[i - 1], group)]
    if i + 1 < len(ranks):
        ops += [dist.P2POp(dist.isend, to_next, ranks[i + 1], group),
                dist.P2POp(dist.irecv, from_next, ranks[i + 1], group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev, from_next


class _HaloExchange(torch.autograd.Function):
    """Forward: this block's first `width` frames go to the previous time
    process and its last to the next. Backward: the reverse exchange, so
    that the gradient of a received halo frame is added to its sender's
    gradient of that frame."""

    @staticmethod
    def forward(ctx, x, time_axis, group, width):
        ctx.time_axis, ctx.group, ctx.width = time_axis, group, width
        ctx.save_for_backward(x)
        t = x.shape[time_axis]
        return _exchange(x.narrow(time_axis, 0, width).contiguous(),
                         x.narrow(time_axis, t - width, width).contiguous(),
                         group)

    @staticmethod
    def backward(ctx, g_prev, g_next):
        # g_prev is the gradient of the previous process's last frames:
        # it goes back there; what comes back is the gradient of ours
        g_first, g_last = _exchange(g_prev.contiguous(), g_next.contiguous(),
                                    ctx.group)
        axis, w = ctx.time_axis, ctx.width
        x, = ctx.saved_tensors
        t = x.shape[axis]
        grad = torch.zeros_like(x)  # x's layout, as its other gradients
        grad.narrow(axis, 0, w).add_(g_first)
        grad.narrow(axis, t - w, w).add_(g_last)
        return grad, None, None, None


def halo_exchange(x: torch.Tensor, time_axis: int, group,
                  width: int = 1):
    """(halo_prev, halo_next): the last `width` frames of the previous
    block of the clip and the first `width` of the next, from this
    process's time neighbours in `group` (a time group of
    `mesh_groups`), each of x's shape with `width` frames on `time_axis`.
    The clip's first and last blocks get zeros for the missing neighbour,
    which is what 'same' padding gives the unsharded convolution.
    Differentiable: the backward returns each halo's gradient to the
    process that sent it. Every process of the group must call it (and
    run its backward) in the same order. NCCL on CUDA, gloo on the
    CPU."""
    t = x.shape[time_axis]
    if t < width:
        raise ValueError(f"a block of {t} frames cannot give a halo of "
                         f"{width}")
    return _HaloExchange.apply(x, time_axis, group, width)


def run_on_primary(fn) -> None:
    """fn() on process 0 alone, every process waiting at a barrier before
    and after it (the checkpoint writes); on one process, just fn()."""
    many = get_world_size() > 1
    if many:
        dist.barrier()
    if is_primary():
        fn()
    if many:
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """`obj` of process `src` on every process (the run-name nonce)."""
    if not _initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def synchronize(device: DeviceLike = None) -> None:
    """A barrier over every process; on one process, wait for the
    device's queued work (the JAX helper's one-process degradation)."""
    if _initialized():
        dist.barrier()
        return
    dev = resolve_device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elif dev is None and torch.cuda.is_available():
        torch.cuda.synchronize()


def all_reduce_gradients(params, group=None) -> None:
    """Replace every parameter's .grad by its mean over the group, in one
    all-reduce of the gradients flattened together (the JAX package's
    `pmean` of the gradient tree). Parameters without a gradient are
    skipped; every process must hold gradients for the same ones."""
    if not _initialized():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def all_reduce_metrics(metrics, group=None):
    """The mean over the group of a dict of 0-d tensors (one all-reduce);
    other values pass through."""
    if not _initialized():
        return metrics
    keys = [k for k, v in metrics.items()
            if torch.is_tensor(v) and v.dim() == 0 and v.is_floating_point()]
    if not keys:
        return metrics
    dev = metrics[keys[0]].device
    flat = torch.stack([metrics[k].detach().to(dev, torch.float32)
                        for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    out = dict(metrics)
    out.update({k: flat[i] for i, k in enumerate(keys)})
    return out

