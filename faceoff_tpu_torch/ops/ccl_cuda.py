"""Connected components of a batch of masks (`csrc/ccl.cu`), with the
plain torch version beside the kernel.

This replaces `cv2.connectedComponentsWithStats` (8-connectivity) at
`faceoff_tpu/preprocess/detectors.py:59` (the skin detector) and `:390`
(the landmark seed's skin mask); no PyTorch call computes it. Both callers
read only each component's area and bounding box, cv2's label order (the
first component of the largest area wins `np.argmax`) and the pixels of
one chosen component, so that is what `connected_components` returns.

cv2's label order: its default 8-way algorithm numbers components by the
first 2 x 2 block (block-raster order) that they touch, with the key
(y // 2) * ceil(W / 2) + x // 2, not by their first pixel. Under
8-connectivity all foreground pixels of one 2 x 2 block belong to one
component, so the key of each component is unique; both versions order by
its minimum.

The root of a component is its smallest flat pixel index (over the whole
batch); kernel and plain version agree on it, so their results are equal.
On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. `launches` counts the kernel's launches.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from faceoff_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "ccl.cu"

# kernel launches made through the wrapper in this process, and their
# mask shapes (B, H, W)
launches = 0
launch_shapes: collections.Counter = collections.Counter()

_lib: Optional[ctypes.CDLL] = None
_count_lock = threading.Lock()  # preprocessing threads launch at once


class Components(NamedTuple):
    """The components of a batch of B masks of H x W.

    labels (B, H, W) int32: the flat index over the batch of the root
    pixel of each foreground pixel's component, -1 off the mask. The
    table has one row per component, sorted by frame and then by cv2's
    label order: frame (K,) int64, root (K,) int64, stats (K, 5) int64 in
    cv2's CC_STAT layout (left, top, width, height, area). counts (B,)
    int64: the components of each frame."""

    labels: torch.Tensor
    frame: torch.Tensor
    root: torch.Tensor
    stats: torch.Tensor
    counts: torch.Tensor


def library_path() -> Path:
    return cuda_build.library_path(SOURCE, "faceoff_ccl")


def build() -> Path:
    """Compile the kernel library unless this source is already built."""
    return cuda_build.build(SOURCE, "faceoff_ccl")


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.faceoff_ccl
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(masks: torch.Tensor) -> None:
    if masks.dim() != 3 or masks.dtype != torch.uint8:
        raise ValueError(f"masks must be (B, H, W) uint8, got "
                         f"{tuple(masks.shape)} {masks.dtype}")
    if masks.numel() >= 2 ** 31:
        raise ValueError(f"{masks.numel()} pixels: flat indices must fit "
                         f"int32; split the batch")


def _table(labels: torch.Tensor, tab: torch.Tensor, n_frames: int,
           hw: int) -> Components:
    """The component table from `tab` (7, K): each root's flat index, x0,
    y0, x1, y1, area and block key, the K columns in any order."""
    tab = tab.to(torch.int64)
    # sort by frame, then by the block key (unique within a frame)
    root = tab[0]
    order = torch.argsort(root - root % hw + tab[6])
    tab = tab[:, order]
    frame = tab[0] // hw
    stats = tab[1:6].T.clone()  # x0, y0, x1, y1, area
    stats[:, 2:4] -= stats[:, 0:2] - 1
    counts = torch.zeros((n_frames,), dtype=torch.int64, device=tab.device)
    counts.index_add_(0, frame, torch.ones_like(frame))
    return Components(labels, frame, tab[0], stats, counts)


def connected_components_plain(masks: torch.Tensor) -> Components:
    """The plain torch version: 8-connected components of the nonzero
    pixels of (B, H, W) uint8 masks. Min-label propagation with hooking
    and pointer jumping (each round hooks every root onto the least label
    around its pixels, then jumps every pointer to its root) until no
    label moves; the labels end at each component's smallest flat
    index."""
    _check(masks)
    b, h, w = masks.shape
    n = masks.numel()
    dev = masks.device
    fg = masks.reshape(-1) != 0
    big = n  # the background's label: larger than any index
    lab = torch.where(fg, torch.arange(n, device=dev),
                      torch.full((n,), big, device=dev))
    pix = torch.nonzero(fg).reshape(-1)
    while True:
        grid = torch.nn.functional.pad(lab.view(b, h, w), (1, 1, 1, 1),
                                       value=big)
        m = lab.view(b, h, w).clone()
        for dy in range(3):
            for dx in range(3):
                m = torch.minimum(m, grid[:, dy: dy + h, dx: dx + w])
        m = m.reshape(-1)[pix]
        before = lab.clone()
        lab.scatter_reduce_(0, lab[pix], m, "amin")
        lab[pix] = torch.minimum(lab[pix], m)
        while True:  # pointer jumping to the roots
            nxt = lab[lab[pix]]
            if torch.equal(nxt, lab[pix]):
                break
            lab[pix] = nxt
        if torch.equal(lab, before):
            break
    labels = torch.where(fg, lab, torch.full_like(lab, -1))
    labels = labels.to(torch.int32).view(b, h, w)
    roots, slot = torch.unique(lab[pix], return_inverse=True)
    k = roots.numel()
    local = pix % (h * w)
    ys, xs = local // w, local % w
    key = (ys // 2) * ((w + 1) // 2) + xs // 2

    def reduce(v, how, fill):
        out = torch.full((k,), fill, dtype=torch.int64, device=dev)
        return out.scatter_reduce_(0, slot, v, how)

    top = 2 ** 62
    tab = torch.stack([roots, reduce(xs, "amin", top),
                       reduce(ys, "amin", top), reduce(xs, "amax", -1),
                       reduce(ys, "amax", -1),
                       torch.bincount(slot, minlength=k),
                       reduce(key, "amin", top)])
    return _table(labels, tab, b, h * w)


def launch_kernel(masks: torch.Tensor):
    """The kernel alone on (B, H, W) uint8 CUDA masks: labels (B, H, W)
    int32, count (1,) int32 (the components K) and table (7, capacity)
    int32, whose rows (root, x0, y0, x1, y1, area, block key) are valid
    in their first K columns, in no particular order. No host sync."""
    global launches
    _check(masks)
    if masks.device.type != "cuda":
        raise ValueError(f"masks on {masks.device}: the kernel takes CUDA "
                         f"tensors")
    masks = masks.contiguous()
    b, h, w = masks.shape
    dev = masks.device
    # one component at most a 2 x 2 block, the kernel's node (ccl.cu)
    capacity = b * ((h + 1) // 2) * ((w + 1) // 2)
    lib = load()
    labels = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    parent = torch.empty((capacity,), dtype=torch.int32, device=dev)
    bits = torch.empty((capacity,), dtype=torch.uint8, device=dev)
    stats = torch.empty((6, capacity), dtype=torch.int32, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    table = torch.empty((7, capacity), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        status = lib.faceoff_ccl(masks.data_ptr(), labels.data_ptr(),
                                 parent.data_ptr(), bits.data_ptr(),
                                 stats.data_ptr(), count.data_ptr(),
                                 table.data_ptr(), capacity, b, h, w, stream)
    if status != 0:
        raise RuntimeError(f"ccl kernel launch failed: cudaError "
                           f"{status - 1000}")
    with _count_lock:
        launches += 1
        launch_shapes[(b, h, w)] += 1
    return labels, count, table


def connected_components(masks: torch.Tensor) -> Components:
    """8-connected components of (B, H, W) uint8 masks (nonzero is
    foreground): the kernel and its table on a CUDA tensor, the plain
    version on a CPU tensor."""
    _check(masks)
    if masks.device.type == "cpu":
        return connected_components_plain(masks)
    labels, count, table = launch_kernel(masks)
    b, h, w = masks.shape
    return _table(labels, table[:, : int(count.item())], b, h * w)


def largest(comps: Components, n_frames: int) -> torch.Tensor:
    """Per frame, the table row of the component that `np.argmax` over
    cv2's areas picks (the largest, the first in cv2's order on a tie),
    or -1 where the frame has none: (B,) int64."""
    dev = comps.frame.device
    k = comps.frame.numel()
    area = comps.stats[:, 4]
    best = torch.full((n_frames,), -1, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, comps.frame, area, "amax")
    rows = torch.arange(k, device=dev)
    first = torch.full((n_frames,), k, dtype=torch.int64, device=dev)
    hit = area == best[comps.frame]
    first.scatter_reduce_(0, comps.frame[hit], rows[hit], "amin")
    return torch.where(first == k, torch.full_like(first, -1), first)


def component_mask(comps: Components, frame: int, row: int) -> torch.Tensor:
    """The (H, W) bool mask of table row `row`'s component in `frame`."""
    return comps.labels[frame] == comps.root[row].to(torch.int32)
