"""Spatial partitioning: each image's rows sharded over a space group of
ranks (port of `tf_eager_object_detection_tpu/parallel/spatial.py`).

JAX puts the images in with sharding ("batch", "space") and lets GSPMD
insert the halo `collective-permute`s of every conv window wider than 1x1
and the all-gather of the stride-16 map. PyTorch has no partitioner, so
the port does both by hand:

- Groups. The default group's W ranks form dp = W // sp batch groups of sp
  ranks; rank r is at batch index r // sp and space index r % sp (space
  is the inner axis, as JAX's `reshape(dp, sp)`). `make_spatial_groups`
  builds the space and batch sub-groups, and refuses an sp that does not
  divide W before any collective.
- The owner rule. At every level of the extractor, space rank s owns rows
  [floor(s * H / sp), floor((s + 1) * H / sp)) of that level's height H
  (`owner_rows`). The input height must be divisible by sp, as in JAX;
  deeper levels may split unevenly (608 / 16 = 38 rows at sp = 4).
- Halos. A layer that mixes rows (`models/layers.py`: the SAME and
  fixed-pad convolutions, the max pools, the strided subsample) asks the
  active `RowShard` for the input rows that its output rows read:
  output rows [o0, o1) read [o0 * stride - top, (o1 - 1) * stride - top +
  kernel), padding outside [0, H) (zeros, -inf for a max pool).
  `fetch_rows` gets them: every rank all-gathers one slab of the rows
  that the other ranks read from it (`halo_plan`, pure index arithmetic),
  and its backward returns each fetched row's gradient to its owner, which
  adds it (an all-reduce of the slabs' gradients).
- The gather. The extractor's outputs (C4 / VGG16 `feats`, FPN's c2..c5)
  are gathered whole on every rank (`gather_rows`), and the RPN, the
  proposals, the samplers, the crops and the RoI head run on every rank of
  the space group with the same draws (those of its batch index). The
  gather's backward sums the map's gradient over the space group and keeps
  the rank's own rows.
- Gradients. A replicated tail parameter's gradient is the same on the sp
  ranks of a batch group; an extractor parameter's is, on each rank, sp
  times its rows' part (the gather's summed backward). DDP over the whole
  world sums both over W = dp * sp ranks and divides by W: sp * sum_d g_d
  / W for the first, sum_d (sp * sum_s g_ds) / W for the second, the mean
  over the batch groups of each batch group's gradient in both cases,
  which is the gradient of the global batch's loss (`parallel/mesh.py`).

The row-mixing layers learn their input's global height from its local
row count (`RowShard.height`): every strided layer of the extractors maps
H to ceil(H / 2), so the levels' heights are ceil(H0 / 2^l), and a
`RowShard` refuses an image height at which two levels of the extractor
would leave some rank the same number of rows, or no row.

Collectives: `all_gather` (halo slabs, the gather) and `all_reduce` (their
backward), on the space group. Gloo takes CUDA tensors for both.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tf_eager_object_detection_tpu_torch.ops.sampling import TrainDraws
from tf_eager_object_detection_tpu_torch.parallel.mesh import make_parallel_train_step
from tf_eager_object_detection_tpu_torch.parallel import multihost
from tf_eager_object_detection_tpu_torch.parallel.multihost import (
    DEFAULT_TIMEOUT_S,
    local_batch_slice,
)

__all__ = ["owner_rows", "read_window", "halo_plan", "fetch_rows", "gather_rows", "RowShard",
           "SpatialGroups", "make_spatial_groups", "shard_batch", "make_spatial_train_step",
           "make_spatial_predict", "make_spatial_im_detect_batch", "sharded_extractor", "join"]


# --------------------------------------------------------- index arithmetic
def owner_rows(index: int, size: int, height: int) -> Tuple[int, int]:
    """[lo, hi) rows of a level of `height` rows that space rank `index` of
    `size` owns."""
    return index * height // size, (index + 1) * height // size


def read_window(out_rows: Tuple[int, int], kernel: int, stride: int, top: int) -> Tuple[int, int]:
    """The input rows [lo, hi) that output rows [o0, o1) of a window of
    `kernel` rows at `stride`, after `top` rows of padding, read (rows
    outside the input are padding)."""
    o0, o1 = out_rows
    return o0 * stride - top, (o1 - 1) * stride - top + kernel


@functools.lru_cache(maxsize=1024)
def halo_plan(windows: Tuple[Tuple[int, int], ...], height: int) -> Tuple[Tuple[int, ...], ...]:
    """Per rank, the global rows it sends: those of its own rows that
    another rank's window reads, ascending. `windows[r]` = rank r's
    [lo, hi) of a level of `height` rows, owned by the owner rule."""
    size = len(windows)
    owner = [0] * height
    for q in range(size):
        lo, hi = owner_rows(q, size, height)
        owner[lo:hi] = [q] * (hi - lo)
    sends: List[set] = [set() for _ in range(size)]
    for r, (lo, hi) in enumerate(windows):
        for j in range(max(lo, 0), min(hi, height)):
            if owner[j] != r:
                sends[owner[j]].add(j)
    return tuple(tuple(sorted(s)) for s in sends)


@functools.lru_cache(maxsize=1024)
def _window_index(windows, height, rank, plan):
    """For rank `rank`'s window: (index of the rows above its own rows, the
    [a, b) local slice of its own rows, index of the rows below) into the
    all-gathered slabs followed by one fill row (index size * slab). An
    index is the slab position of the row in its owner's slab, or the fill
    row outside the map."""
    size = len(windows)
    slab = max(len(s) for s in plan)
    where = {j: q * slab + i for q, rows in enumerate(plan) for i, j in enumerate(rows)}
    lo, hi = windows[rank]
    own_lo, own_hi = owner_rows(rank, size, height)
    fill = size * slab

    def index(a, b):
        return tuple(where[j] if 0 <= j < height else fill for j in range(a, b))

    a = max(lo, own_lo)
    return index(lo, min(hi, own_lo)), (a - own_lo, max(min(hi, own_hi), a) - own_lo), \
        index(max(lo, own_hi), hi)


def fetch_rows(x: torch.Tensor, windows: Sequence[Tuple[int, int]], height: int, rank: int,
               exchange, fill: float = 0.0) -> torch.Tensor:
    """Rows [lo, hi) = `windows[rank]` of a row-sharded NCHW map of `height`
    rows, of which this rank holds `x` (its owned rows), `fill` outside
    [0, height).

    `windows` holds every rank's window, so that each rank knows, without
    asking, which of its rows the others read (`halo_plan`).
    `exchange(slab)` -> every rank's slab, concatenated along the rows in
    rank order (`_AllGather`; a test passes one that reads a whole map).
    Where no rank reads another's rows, nothing is exchanged."""
    windows = tuple(tuple(w) for w in windows)
    plan = halo_plan(windows, height)
    slab = max(len(s) for s in plan)
    above, (a, b), below = _window_index(windows, height, rank, plan)
    batch, channels, _, width = x.shape
    if slab:
        own_lo = owner_rows(rank, len(windows), height)[0]
        send = torch.as_tensor([j - own_lo for j in plan[rank]], dtype=torch.long,
                               device=x.device)
        mine = x.index_select(2, send)
        received = exchange(F.pad(mine, (0, 0, 0, slab - mine.shape[2])))
    else:
        received = x.new_empty((batch, channels, 0, width))
    source = torch.cat([received, x.new_full((batch, channels, 1, width), fill)], 2)

    def rows(idx):
        if not idx:
            return x.new_empty((batch, channels, 0, width))
        return source.index_select(2, torch.as_tensor(idx, dtype=torch.long, device=x.device))

    return torch.cat([rows(above), x[:, :, a:b], rows(below)], 2)


def gather_rows(x: torch.Tensor, height: int, rank: int, size: int, exchange,
                dim: int) -> torch.Tensor:
    """The whole map of `height` rows along `dim` from each rank's owned
    rows `x` (`exchange` as `fetch_rows`'s, along `dim`)."""
    counts = [owner_rows(q, size, height) for q in range(size)]
    most = max(hi - lo for lo, hi in counts)
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, most - x.shape[dim]]
    whole = exchange(F.pad(x, pad))
    return torch.cat([whole.narrow(dim, q * most, hi - lo) for q, (lo, hi) in enumerate(counts)],
                     dim)


class _AllGather(torch.autograd.Function):
    """Each rank's tensor (one shape on every rank) -> all of them,
    concatenated along `dim` in rank order. The backward sums the gradient
    over the group (an all-reduce) and returns this rank's part."""

    @staticmethod
    def forward(ctx, x, dim, groups, kind):
        ctx.dim, ctx.groups, ctx.kind = dim, groups, kind
        parts = [torch.empty_like(x) for _ in range(groups.sp)]
        dist.all_gather(parts, x.contiguous(), group=groups.space)
        groups.record(kind, "all_gather", parts)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        groups = ctx.groups
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=groups.space)
        groups.record(ctx.kind, "all_reduce", [grad])
        return grad.chunk(groups.sp, ctx.dim)[groups.space_index], None, None, None


# ------------------------------------------------------------------ groups
class SpatialGroups:
    """This rank's place in a dp x sp layout of the default group: its space
    group (the sp ranks sharing an image's rows), its batch group (the dp
    ranks at its space index), and their sizes and indices. `traffic`, when
    a list, collects (kind, collective, bytes) of every exchange: kind is
    "halo" or "gather", bytes the collective's output on this rank."""

    def __init__(self, space, batch, sp: int, dp: int, space_index: int, batch_index: int):
        self.space, self.batch = space, batch
        self.sp, self.dp = sp, dp
        self.space_index, self.batch_index = space_index, batch_index
        self.traffic: Optional[list] = None

    def record(self, kind: str, collective: str, tensors) -> None:
        if self.traffic is not None:
            self.traffic.append((kind, collective,
                                 sum(t.numel() * t.element_size() for t in tensors)))


def join(sp: int, device="cuda"):
    """Join the default group from torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) for the command lines' `--spatial_partition
    sp` -> this rank's device (`multihost.local_device`). Refuses, before
    joining, without that environment and where sp does not divide its
    world size."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(f"spatial_partition={sp} runs one process a rank of a process group: "
                           f"launch with torchrun --standalone --nproc_per_node {sp} (or a "
                           "multiple of it) -m tf_eager_object_detection_tpu_torch.scripts...")
    world = int(os.environ["WORLD_SIZE"])
    if world % sp:
        raise ValueError(f"spatial_partition={sp} does not divide the world size {world}")
    device = multihost.local_device(device)
    multihost.initialize(device=device)
    return device


def make_spatial_groups(sp: int, timeout_s: float = DEFAULT_TIMEOUT_S) -> SpatialGroups:
    """Space and batch sub-groups of the default group for a space extent
    `sp`: every rank calls `dist.new_group` for every group, in one order.
    Refuses an sp that does not divide the world size before any of them."""
    if not dist.is_initialized():
        raise RuntimeError("spatial partitioning runs over the default process group: call "
                           "parallel.multihost.initialize first (launch with torchrun "
                           "--standalone --nproc_per_node N)")
    rank, world = dist.get_rank(), dist.get_world_size()
    if sp < 1 or world % sp:
        raise ValueError(f"spatial_partition={sp} does not divide the world size {world}")
    dp = world // sp
    timeout = datetime.timedelta(seconds=timeout_s)
    space = batch = None
    for d in range(dp):
        group = dist.new_group([d * sp + s for s in range(sp)], timeout=timeout)
        if rank // sp == d:
            space = group
    for s in range(sp):
        group = dist.new_group([d * sp + s for d in range(dp)], timeout=timeout)
        if rank % sp == s:
            batch = group
    return SpatialGroups(space, batch, sp, dp, rank % sp, rank // sp)


class RowShard:
    """A rank's rows of the row-sharded maps of one extractor pass, for the
    layers of `models/layers.py` (`row_sharded`): the image has `height`
    rows, the extractor `levels` stride-2 stages, each level ceil(H / 2^l)
    rows, split by the owner rule. Refuses a height that sp does not
    divide, and one at which a rank would own no row of a level or the
    same number of rows at two levels (a layer could not tell its input's
    level from its rows)."""

    def __init__(self, groups: SpatialGroups, height: int, levels: int):
        sp = groups.sp
        if height % sp:
            raise ValueError(f"image height {height} not divisible by spatial_partition={sp}")
        heights = [-(-height // 2 ** level) for level in range(levels + 1)]
        for r in range(sp):
            counts = [hi - lo for lo, hi in (owner_rows(r, sp, h) for h in heights)]
            if min(counts) < 1 or len(set(counts)) < len(counts):
                raise ValueError(f"image height {height} is too small to shard over "
                                 f"spatial_partition={sp}: at levels of {heights} rows, rank "
                                 f"{r} would own {counts} rows")
        self.groups = groups
        self._heights = {hi - lo: h for h in heights
                         for lo, hi in [owner_rows(groups.space_index, sp, h)]}

    def height(self, rows: int) -> int:
        """The global height of a level whose local map has `rows` rows."""
        return self._heights[rows]

    def owned(self, height: int) -> Tuple[int, int]:
        return owner_rows(self.groups.space_index, self.groups.sp, height)

    def window(self, x: torch.Tensor, height: int, out_height: int, kernel: int, stride: int,
               top: int, fill: float = 0.0) -> torch.Tensor:
        """The input rows that this rank's rows of an `out_height`-row output
        read, for a window of `kernel` rows at `stride` after `top` rows of
        padding: this rank's part of a NCHW map of `height` rows, with the
        halo rows fetched from their owners and `fill` outside the map."""
        sp = self.groups.sp
        windows = tuple(read_window(owner_rows(r, sp, out_height), kernel, stride, top)
                        for r in range(sp))
        return fetch_rows(x, windows, height, self.groups.space_index,
                          lambda slab: _AllGather.apply(slab, 2, self.groups, "halo"), fill)

    def gather(self, out):
        """The extractor's NHWC output (a tensor or a tuple of them) from this
        rank's rows to the whole maps."""
        if isinstance(out, tuple):
            return tuple(self.gather(t) for t in out)
        groups = self.groups
        return gather_rows(out, self.height(out.shape[1]), groups.space_index, groups.sp,
                           lambda t: _AllGather.apply(t, 1, groups, "gather"), 1)


@contextlib.contextmanager
def sharded_extractor(detector, shard: RowShard):
    """Run `detector`'s extractor on a rank's rows under `shard` for the
    duration (a remat recompute in the backward included)."""
    detector.row_shard = shard
    try:
        yield
    finally:
        detector.row_shard = None


# -------------------------------------------------------------- the steps
def shard_batch(batch, groups: SpatialGroups):
    """The global batch (images [B, H, W, 3] and the per-image arrays, the
    same on every rank) -> this rank's part: the rows of its batch index
    (`local_batch_slice`, which refuses a B that dp does not divide) and,
    of their images, the rows its space index owns (an H that sp does not
    divide is refused)."""
    images = batch[0]
    lo, hi = local_batch_slice(int(images.shape[0]), groups.batch_index, groups.dp)
    height = int(images.shape[1])
    if height % groups.sp:
        raise ValueError(f"image height {height} not divisible by spatial_partition={groups.sp}")
    r0, r1 = owner_rows(groups.space_index, groups.sp, height)
    return (images[lo:hi, r0:r1],) + tuple(t[lo:hi] for t in batch[1:])


def make_spatial_train_step(detector, optimizer, groups: SpatialGroups):
    """-> step(batch, draws=None) -> metrics over a dp x sp layout.

    batch = the global batch (images, image_hw, gt_boxes, gt_mask,
    gt_labels), numpy or tensors, the same on every rank; the step takes
    this rank's part (`shard_batch`) and runs `make_parallel_train_step`'s
    DDP step with the extractor row-sharded, fed the global batch's draws
    (`TrainDraws`, a `torch.Generator`, or None for the detector's own),
    of which it keeps the rows of its batch index. Metrics are those of
    the rank's batch group."""
    step = make_parallel_train_step(detector, optimizer,
                                    batch_shard=(groups.batch_index, groups.dp))

    def spatial_step(batch, draws=None):
        height, width = (int(d) for d in batch[0].shape[1:3])
        local = shard_batch(batch, groups)
        shard = RowShard(groups, height, detector.extractor_levels)
        if not isinstance(draws, TrainDraws):
            draws = detector.sample_draws(detector.generator if draws is None else draws,
                                          int(batch[0].shape[0]), (height, width))
        with sharded_extractor(detector, shard):
            return step(local, draws)

    spatial_step.ddp = step.ddp
    return spatial_step


def _sharded_call(detector, groups: SpatialGroups, call, images, row_axis: int, *args):
    """`call(this rank's rows of images, *args)` with the extractor
    row-sharded over the space group (the rows taken on the host where
    `images` is numpy)."""
    height = int(images.shape[row_axis])
    shard = RowShard(groups, height, detector.extractor_levels)
    lo, hi = shard.owned(height)
    with sharded_extractor(detector, shard):
        return call(images[(slice(None),) * row_axis + (slice(lo, hi),)], *args)


def make_spatial_predict(detector, groups: SpatialGroups):
    """-> predict(image [H, W, 3], image_hw) -> `Detections`, the detector's
    `predict` with the image's rows sharded over the space group: each rank
    takes its rows of the image and every rank returns the whole image's
    detections."""
    return lambda image, image_hw: _sharded_call(detector, groups, detector.predict, image, 0,
                                                 image_hw)


def make_spatial_im_detect_batch(detector, groups: SpatialGroups):
    """-> im_detect_batch(images [B, H, W, 3], image_hw, scales), the
    detector's with the images' rows sharded over the space group, as
    `make_spatial_predict`'s."""
    return lambda images, image_hw, scales: _sharded_call(
        detector, groups, detector.im_detect_batch, images, 1, image_hw, scales)
