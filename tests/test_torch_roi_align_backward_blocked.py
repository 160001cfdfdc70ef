"""A plain model of the CUDA RoIAlign backward's work split
(csrc/roi_align_backward.cu: K5, and K3 when launched with one plane), held
against the port's plain backward, the JAX einsum VJP and the Pallas
kernels' VJPs in interpret mode.

The CUDA kernel runs one block per (roi, group of kRows sample rows), a grid
of B * N * ceil(S / kRows) blocks; a block whose roi is invalid, or on a
level outside the pyramid, exits at once. A unit is 4 channels (a float4)
when C % 4 == 0 and g and every gradient plane are 16-byte aligned, else one
channel. The block's 128 threads take its (row r, unit q) elements
e = r * units + q, thread t the e = t, t + 128, ...; a thread loads the g
units of its row's samples, then walks them in order, keeping in registers
the sums r_a, r_b of w_x * g of the two current columns a and a + 1 (a
sample's column taps; a tap past the plane weighs 0 and adds nothing): when
a sample's first column moves on by one,
column a is complete and r_b becomes r_a; when it jumps (or moves back, for
a roi with x2 < x1), both are. A complete column's sum, unless it is all
exactly zero, is added as w_y * sum to each of the row's taps of nonzero
weight w_y with one reduction each. With `combine=False` (a counterfactual
the kernel does not build: the design before the walk) every sample's taps
are complete at once: one reduction per live tap.

`blocked_backward` below does the same steps on the CPU in numpy and counts
every (roi, sample, tap, channel) term it adds, so the tests can show that
every term is added exactly once. It lives here, not in the package: its
sample arithmetic is a numpy float32 copy of `sample_coord` and `taps` of
csrc/roi_align_common.cuh, not the port's torch code, so it is an oracle of
the kernel's algorithm independent of the plain version.

Inputs are numpy-seeded: dense N(0, 1) g, and the training path's
pool-sparse g (the backward of the port's `max_pool_2x2_same`, three of
every four samples of a channel exactly zero). The JAX functions run as
tests/test_torch_roi_align_backward.py runs them: planes of a 64x64 bucket
(coordinates below 16 cells), one image per Pallas call, rois inside the
Pallas kernels' 64-cell window.

Tolerance: each cell within 1e-5 of sum |g * w| over the terms it adds (the
port's plain backward of |g|), the tolerance of the kernel on the card: the
model, like the kernel's float reductions, adds the terms in another order
than the plain version's matmuls. Against the JAX oracles an atol of 1e-5 is
added, that of tests/test_torch_roi_align_backward.py: XLA:CPU contracts the
JAX coordinate arithmetic into fused multiply-adds, so a sample lies an ulp
(below 1e-6 cells here) away from the port's and its weights move by that
much.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu.ops.pallas.roi_align_pallas import (
    _einsum_equiv,
    pallas_roi_align_multilevel,
    pallas_roi_align_window,
)
from tf_eager_object_detection_tpu_torch.ops import roi_align as port
from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_cuda import vectorizable

F32 = np.float32
K_THREADS = 128  # kThreads of the source
K_ROWS = 2  # kRows
EDGE_EPS = F32(1e-3)  # kEdgeEps of roi_align_common.cuh
STRIDES = (4, 8, 16, 32)
BUCKET = (64, 64)
IH = np.asarray([58.0, 44.0], F32)  # valid extents below the bucket
IW = np.asarray([59.0, 34.0], F32)
TAPS = ((0, 0), (0, 1), (1, 0), (1, 1))  # (row tap, column tap)


def sample_coord(lo, hi, dim, stride, crop):
    """`sample_coord` for i < crop in float32 -> (clamped coords [crop], inside [crop])."""
    last = np.ceil(F32(dim) / F32(stride)) - F32(1)
    g = last / F32(dim)
    c1, c2 = F32(lo) * g, F32(hi) * g
    recip = F32(1) / F32(crop - 1)
    v = c1 + ((c2 - c1) * np.arange(crop, dtype=F32)) * recip
    inside = (v >= -EDGE_EPS) & (v <= last + EDGE_EPS)
    return np.minimum(np.maximum(v, F32(0)), last), inside


def taps(v, size):
    """`taps`: cell indices [2, crop] (clamped to the plane) and tent weights
    [2, crop], 0 for a tap on a cell past the plane."""
    c0 = np.floor(v)
    cells = np.stack([c0, c0 + 1]).astype(np.int64)
    w = np.stack([np.maximum(F32(0), F32(1) - np.abs(v - c0)),
                  np.maximum(F32(0), F32(1) - np.abs(v - (c0 + F32(1))))])
    return np.minimum(cells, size - 1), np.where(cells < size, w, F32(0))


def thread_elements(total):
    """The (row, unit) elements e the block's threads take, in the kernel's
    loop order: thread t takes e = t, t + 128, ..."""
    t = np.arange(K_THREADS)[:, None]
    e = t + K_THREADS * np.arange(-(-total // K_THREADS))[None, :]
    return e[e < total]


def blocked_backward(g, plane_shapes, rois, levels, valid, ih, iw, crop, strides,
                     k_rows=K_ROWS, vec=True, combine=True):
    """The kernel's steps on the CPU -> (gradient planes, stats).

    stats: `terms` [B*N, S, S, 4, C] the number of times each (roi, sample,
    tap, channel) term was added, `reductions` the reductions issued (of
    4-channel units when `vec`, else of channels), `blocks` the blocks that
    did work, `covered` whether the threads of every block took each of its
    (row, unit) elements exactly once.
    """
    b, n = rois.shape[:2]
    c = g.shape[-1]
    lanes = 4 if vec else 1
    assert c % lanes == 0
    units = c // lanes
    dfs = [np.zeros(s, F32) for s in plane_shapes]
    terms = np.zeros((b * n, crop, crop, 4, c), np.int32)
    stats = dict(reductions=0, blocks=0, covered=True)
    groups = -(-crop // k_rows)
    for block in range(b * n * groups):
        roi, group = divmod(block, groups)
        bi, ri = divmod(roi, n)
        lvl = int(levels[bi, ri])
        if not valid[bi, ri] or not 0 <= lvl < len(plane_shapes):
            continue  # the block exits at once
        stats["blocks"] += 1
        first = group * k_rows
        rows = min(k_rows, crop - first)
        e = thread_elements(rows * units)
        stats["covered"] &= e.size == rows * units and bool((np.bincount(e) == 1).all())
        h, w = plane_shapes[lvl][1:3]
        x1, y1, x2, y2 = rois[bi, ri]
        xs, x_in = sample_coord(x1, x2, iw[bi], strides[lvl], crop)
        ys, y_in = sample_coord(y1, y2, ih[bi], strides[lvl], crop)
        (ix, wx), (iy, wy) = taps(xs, w), taps(ys, h)
        for i in range(first, first + rows):
            if y_in[i]:  # the row's threads, all units at once
                stats["reductions"] += walk_row(
                    dfs[lvl][bi], terms[roi, i], g[bi, ri, i].reshape(crop, units, lanes),
                    iy[:, i], wy[:, i], ix, wx, x_in, combine)
    return dfs, dict(stats, terms=terms)


def walk_row(plane, terms, g, iy, wy, ix, wx, x_in, combine):
    """One sample row's walk for every unit (g [S, units, lanes]) -> the
    reductions issued. terms: [S, 4, C] counts of the row's terms."""
    units, lanes = g.shape[1:]
    issued = 0

    def add_column(x, r, members):
        nonlocal issued
        live = (r != 0).any(-1)  # a sum that is all zero adds nothing
        if not live.any():
            return
        ch = (np.nonzero(live)[0][:, None] * lanes + np.arange(lanes)).ravel()
        for ty in (0, 1):
            if wy[ty] != 0:
                plane[iy[ty], x, ch] += (wy[ty] * r[live]).ravel()
                issued += int(live.sum())
                for j, tx in members:
                    terms[j, TAPS.index((ty, tx)), ch] += 1

    zero = np.zeros((units, lanes), F32)
    a, ra, rb, in_a, in_b = -2, zero, zero, [], []
    for j in range(g.shape[0]):
        if not x_in[j]:
            continue
        if not combine or ix[0, j] != a:
            add_column(a, ra, in_a)
            if combine and ix[0, j] == a + 1:
                ra, in_a = rb, in_b
            else:
                add_column(a + 1, rb, in_b)
                ra, in_a = zero, []
            rb, in_b = zero, []
            a = int(ix[0, j])
        if wx[0, j] != 0:  # 0 only past the plane, where the kernel adds +-0
            ra, in_a = ra + wx[0, j] * g[j], in_a + [(j, 0)]
        if wx[1, j] != 0:
            rb, in_b = rb + wx[1, j] * g[j], in_b + [(j, 1)]
    add_column(a, ra, in_a)
    add_column(a + 1, rb, in_b)
    return issued


def expected_terms(g, plane_shapes, rois, levels, valid, ih, iw, crop, strides, vec=True):
    """The (roi, sample, tap, channel) terms of the gradient -> (every term:
    valid rois on a level of the pyramid, samples inside on both axes, taps
    of nonzero weight; the live ones, of a unit of g that is not all zero).
    The kernel adds each live term once; its walk also adds the zero terms
    of a column whose sum is live, and with its combining off it adds none."""
    b, n, c = rois.shape[0], rois.shape[1], g.shape[-1]
    lanes = 4 if vec else 1
    unit_live = (g.reshape(b, n, crop, crop, c // lanes, lanes) != 0).any(-1)
    live = np.repeat(unit_live, lanes, -1)  # [B, N, S, S, C]
    every = np.zeros((b * n, crop, crop, 4, c), bool)
    for bi in range(b):
        for ri in range(n):
            lvl = int(levels[bi, ri])
            if not valid[bi, ri] or not 0 <= lvl < len(plane_shapes):
                continue
            h, w = plane_shapes[lvl][1:3]
            x1, y1, x2, y2 = rois[bi, ri]
            xs, x_in = sample_coord(x1, x2, iw[bi], strides[lvl], crop)
            ys, y_in = sample_coord(y1, y2, ih[bi], strides[lvl], crop)
            (_, wx), (_, wy) = taps(xs, w), taps(ys, h)
            for t, (dy, dx) in enumerate(TAPS):
                on = (y_in[:, None] & x_in[None, :]) & (wy[dy][:, None] * wx[dx][None, :] != 0)
                every[bi * n + ri, :, :, t] = on[..., None]
    return every, every & live.reshape(b * n, crop, crop, 1, c)


def _planes(rng, b, c, bucket=BUCKET):
    return [rng.randn(b, -(-bucket[0] // s), -(-bucket[1] // s), c).astype(F32) for s in STRIDES]


def _rois(rng, b, n, kind):
    """xyxy rois inside each image: spread; piled on a few cells; or with the
    edge cases (whole extent, bottom-right corner, aspect 30) in front."""
    h, w = IH.min(), IW.min()
    if kind == "overlap":
        x1, y1 = 8 + rng.uniform(0, 3, (b, n)), 6 + rng.uniform(0, 3, (b, n))
        side = rng.uniform(3, 12, (b, n, 2))
    else:
        x1, y1 = rng.uniform(0, w - 4, (b, n)), rng.uniform(0, h - 4, (b, n))
        side = rng.uniform(4, 40, (b, n, 2))
    rois = np.stack([x1, y1, np.minimum(x1 + side[..., 0], w - 1),
                     np.minimum(y1 + side[..., 1], h - 1)], -1).astype(F32)
    if kind == "edges":
        for i in range(b):
            rois[i, :3] = [[0, 0, IW[i] - 1, IH[i] - 1], [IW[i] - 6, IH[i] - 5, IW[i] - 1,
                                                          IH[i] - 1], [1, 10, 31, 11]]
    return rois


def _fixture(seed, c, crop, kind="spread", n=8, outside=True):
    """Planes, rois, levels (with a level outside the pyramid when `outside`),
    valid (with invalid rois), and dense g [2, n, S, S, C]."""
    rng = np.random.RandomState(seed)
    b = 2
    planes = _planes(rng, b, c)
    rois = _rois(rng, b, n, kind)
    levels = rng.randint(0, 4, (b, n)).astype(np.int64)
    if outside:
        levels[0, -1], levels[1, -2] = 4, -1
    valid = rng.uniform(size=(b, n)) > 0.2
    valid[1, -1] = False
    g = rng.randn(b, n, crop, crop, c).astype(F32)
    return planes, rois, levels, valid, g


def _pool_sparse(planes, rois, levels, valid, crop, seed):
    """The training path's g: the backward of the port's 2x2 SAME max pool for
    an N(0, 1) gradient of the pooled crops."""
    crops = port.roi_align_multilevel_reference(
        [torch.from_numpy(p) for p in planes], *_t(rois, levels, valid, IH, IW), crop, STRIDES,
    ).requires_grad_()
    pooled = port.max_pool_2x2_same(crops)
    cot = np.random.RandomState(seed).randn(*pooled.shape).astype(F32)
    (g,) = torch.autograd.grad(pooled, crops, torch.from_numpy(cot))
    return g.numpy()


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _plain(g, planes, rois, levels, valid, crop, ih=IH, iw=IW):
    """The port's plain backward of g and of |g| (the tolerance's scale)."""
    args = (*_t(rois, levels, valid, ih, iw), crop, STRIDES)
    ps = [torch.from_numpy(p) for p in planes]
    ref = port.roi_align_multilevel_reference_backward(torch.from_numpy(g), ps, *args)
    scale = port.roi_align_multilevel_reference_backward(torch.from_numpy(np.abs(g)), ps, *args)
    return [r.numpy() for r in ref], [m.numpy() for m in scale]


def _close(got, want, scale, atol=0.0):
    for k, (d, r, m) in enumerate(zip(got, want, scale)):
        assert d.shape == r.shape, k
        err = np.abs(d - np.asarray(r))
        limit = 1e-5 * m + atol
        assert (err <= limit).all(), (k, float(err.max()), float((err - limit).max()))


def _model(g, planes, rois, levels, valid, crop, ih=IH, iw=IW, **kw):
    """The model's planes and stats, after checking that every live term was
    added once and no other term more than once."""
    shapes = [p.shape for p in planes]
    dfs, stats = blocked_backward(g, shapes, rois, levels, valid, ih, iw, crop, STRIDES, **kw)
    assert stats["covered"]
    every, live = expected_terms(g, shapes, rois, levels, valid, ih, iw, crop, STRIDES,
                                 vec=kw.get("vec", True))
    added = stats["terms"].astype(bool)
    assert stats["terms"].max() <= 1 and (added >= live).all() and (added <= every).all()
    return dfs, stats


@pytest.mark.parametrize("g_kind", ["dense", "pool_sparse"])
@pytest.mark.parametrize("crop", [7, 14])
@pytest.mark.parametrize("c", [4, 42, 256])
def test_model_matches_plain_backward(c, crop, g_kind):
    """Every term added once; the planes equal the port's plain backward, with
    the walk's combining on and off. S = 7 splits into row groups of 2
    unevenly; C = 42 takes the scalar path; pool-sparse g skips its zero
    units."""
    planes, rois, levels, valid, g = _fixture(c * crop, c, crop, kind="edges")
    if g_kind == "pool_sparse":
        g = _pool_sparse(planes, rois, levels, valid, crop, seed=c)
    vec = c % 4 == 0
    dfs, stats = _model(g, planes, rois, levels, valid, crop, vec=vec)
    ref, scale = _plain(g, planes, rois, levels, valid, crop)
    _close(dfs, ref, scale)
    on_pyramid = valid & (levels >= 0) & (levels < 4)
    assert stats["blocks"] == int(on_pyramid.sum()) * -(-crop // K_ROWS)
    flat, uncombined = _model(g, planes, rois, levels, valid, crop, vec=vec, combine=False)
    _close(flat, ref, scale)
    lanes = 4 if vec else 1
    assert uncombined["reductions"] == int(uncombined["terms"].sum()) // lanes  # one a live tap
    assert stats["reductions"] < uncombined["reductions"]  # combining pays
    if g_kind == "pool_sparse":
        # a channel is zero at three of every four samples (at 33 of 49 when
        # S = 7: SAME padding leaves the last row and column alone in their
        # windows), a float4 unit (four channels, picked independently) at
        # about a third of them
        _, dense = blocked_backward(np.where(g == 0, F32(1), g), [p.shape for p in planes], rois,
                                    levels, valid, IH, IW, crop, STRIDES, vec=vec, combine=False)
        assert uncombined["reductions"] <= (0.8 if vec else 0.35) * dense["reductions"]


@pytest.mark.parametrize("k_rows", [1, 3, 5, 14])
def test_row_groups_do_not_change_the_sum(k_rows):
    """kRows that split S = 14 evenly and unevenly (and a block per roi):
    the same terms, the same gradient within the tolerance."""
    planes, rois, levels, valid, g = _fixture(40 + k_rows, 8, 14, kind="edges")
    dfs, stats = _model(g, planes, rois, levels, valid, 14, k_rows=k_rows)
    ref, scale = _plain(g, planes, rois, levels, valid, 14)
    _close(dfs, ref, scale)


@pytest.mark.parametrize("kind", ["wide", "reversed"])
def test_rows_that_share_no_column(kind):
    """Rois ~120 cells wide on P2 (samples ~9 cells apart: no two share a
    column) and rois with x2 < x1 (columns that shrink along a row: both
    columns are complete whenever the first moves, so only samples that
    share their first column combine): the sums stay right."""
    rng = np.random.RandomState(8)
    ih, iw = np.asarray([60.0], F32), np.asarray([500.0], F32)
    planes = _planes(rng, 1, 8, bucket=(64, 512))
    rois = np.asarray([[[5, 5, 480, 20], [10, 30, 400, 58], [0, 0, 499, 59], [40, 10, 80, 50],
                        [100, 20, 130, 40], [3, 3, 20, 12]]], F32)
    if kind == "reversed":
        rois = rois[..., [2, 1, 0, 3]]
    levels = np.zeros((1, 6), np.int64)
    valid = np.ones((1, 6), bool)
    g = rng.randn(1, 6, 14, 14, 8).astype(F32)
    dfs, stats = _model(g, planes, rois, levels, valid, 14, ih=ih, iw=iw)
    _, uncombined = _model(g, planes, rois, levels, valid, 14, ih=ih, iw=iw, combine=False)
    ref, scale = _plain(g, planes, rois, levels, valid, 14, ih=ih, iw=iw)
    _close(dfs, ref, scale)
    assert uncombined["reductions"] > stats["reductions"] > 0.5 * uncombined["reductions"]


def test_heavy_overlap_matches_plain_backward():
    """Every roi piled on a few cells: many reductions into one cell."""
    planes, rois, levels, valid, g = _fixture(7, 16, 14, kind="overlap", n=24, outside=False)
    levels[:] = 0
    dfs, _ = _model(g, planes, rois, levels, valid, 14)
    ref, scale = _plain(g, planes, rois, levels, valid, 14)
    _close(dfs, ref, scale)
    assert float(np.abs(dfs[0]).max()) > 0


def test_invalid_and_outside_rois_add_nothing():
    """Rois with valid == 0 or a level outside the pyramid take no block's
    work: their g changes nothing."""
    planes, rois, levels, valid, g = _fixture(11, 8, 14)
    off = ~(valid & (levels >= 0) & (levels < 4))
    assert off.sum() >= 3
    dfs, _ = _model(g, planes, rois, levels, valid, 14)
    noisy = g.copy()
    noisy[off] = 1e6
    again, _ = _model(noisy, planes, rois, levels, valid, 14)
    for d, e in zip(dfs, again):
        np.testing.assert_array_equal(d, e)


def _past_the_planes(seed, c=8):
    """80x80 and 72x72 images on the planes of a 64x64 bucket: a sample's
    last valid cell lies past the plane's last. The first two rois of each
    image are its whole extent and its bottom-right corner, on P2."""
    rng = np.random.RandomState(seed)
    planes = _planes(rng, 2, c)
    ih = iw = np.asarray([80.0, 72.0], F32)
    x1, y1 = rng.uniform(0, 70, (2, 12)), rng.uniform(0, 70, (2, 12))
    side = rng.uniform(4, 60, (2, 12, 2))
    rois = np.stack([x1, y1, np.minimum(x1 + side[..., 0], 79),
                     np.minimum(y1 + side[..., 1], 79)], -1).astype(F32)
    rois[:, :2] = [[0, 0, 79, 79], [60, 58, 79, 79]]
    levels = rng.randint(0, 4, (2, 12)).astype(np.int64)
    levels[:, :2] = 0
    valid = np.ones((2, 12), bool)
    g = rng.randn(2, 12, 14, 14, c).astype(F32)
    return planes, rois, levels, valid, ih, iw, g


def _band(rois, levels, valid, ih, iw, planes, crop=14):
    """Per roi and sample [B, N, S, S]: whether the sample lies past its
    plane's last cell h - 1 on an axis but before cell h (the band where the
    tent over the plane's cells gives the last cell 1 - (v - (h - 1)))."""
    out = np.zeros(rois.shape[:2] + (crop, crop), bool)
    for k, (p, s) in enumerate(zip(planes, STRIDES)):
        on = ((levels == k) & valid)[..., None, None]
        for bi in range(rois.shape[0]):
            for ri in range(rois.shape[1]):
                ys, _ = sample_coord(rois[bi, ri, 1], rois[bi, ri, 3], ih[bi], s, crop)
                xs, _ = sample_coord(rois[bi, ri, 0], rois[bi, ri, 2], iw[bi], s, crop)
                by = (ys > p.shape[1] - 1 + EDGE_EPS) & (ys < p.shape[1])
                bx = (xs > p.shape[2] - 1 + EDGE_EPS) & (xs < p.shape[2])
                out[bi, ri] |= (by[:, None] | bx[None, :]) & on[bi, ri]
    return out


@pytest.mark.parametrize("vec", [True, False], ids=["float4", "scalar"])
def test_image_past_the_planes_adds_clamped_taps_to_the_last_cell(vec):
    """Image extents past the planes: a tap on a cell past the plane weighs 0
    (its index clamped to the plane, so nothing is written past it), and the
    walk equals the port's plain backward, whose tent runs over the plane's
    own cells; every live term once. (The name is older than the rule: the
    kernels used to put a clamped tap's weight on the plane's last cell.)"""
    planes, rois, levels, valid, ih, iw, g = _past_the_planes(60)
    xs, _ = sample_coord(79.0, 79.0, 80.0, STRIDES[0], 14)
    cells, wt = taps(xs, planes[0].shape[2])
    assert (xs > planes[0].shape[2] - 1).all() and (wt == 0).all()  # past the plane: weight 0
    assert (cells == planes[0].shape[2] - 1).all()  # clamped to the plane
    dfs, _ = _model(g, planes, rois, levels, valid, 14, ih=ih, iw=iw, vec=vec)
    ref, scale = _plain(g, planes, rois, levels, valid, 14, ih=ih, iw=iw)
    _close(dfs, ref, scale)
    assert _band(rois, levels, valid, ih, iw, planes).any()  # the partial tent is exercised


def _pallas_ml(planes, rois, levels, valid, ih, iw):
    """`pallas_roi_align_multilevel` in interpret mode, one image per call."""
    return jnp.concatenate([pallas_roi_align_multilevel(
        tuple(p[i:i + 1] for p in planes), jnp.asarray(rois[i:i + 1]),
        jnp.asarray(levels[i:i + 1]), jnp.asarray(ih[i:i + 1]), jnp.asarray(iw[i:i + 1]), 14,
        strides=STRIDES, valid=jnp.asarray(valid[i:i + 1].astype(np.int32)), interpret=True,
    ) for i in range(rois.shape[0])])


@pytest.mark.parametrize("seed", [61, 62])
def test_plain_past_the_planes_matches_pallas_k4_and_k5(seed):
    """Image extents past the planes: the port's plain forward against the
    Pallas K4 (`pallas_roi_align_multilevel`, interpret mode, one image per
    call), which clips a sample to the valid extent and takes its tent over
    the zero-padded plane, within atol 1e-5; the plain backward against that
    call's VJP (K5) within 1e-5 of sum |g * w| plus atol 1e-5 (XLA's
    contracted coordinate arithmetic); the kernels' walk equals both."""
    planes, rois, levels, valid, ih, iw, g = _past_the_planes(seed)
    args = (*_t(rois, levels, valid, ih, iw), 14, STRIDES)
    plain = port.roi_align_multilevel_reference([torch.from_numpy(p) for p in planes], *args)
    jp = tuple(jnp.asarray(p) for p in planes)
    want, vjp = jax.vjp(lambda ps: _pallas_ml(ps, rois, levels, valid, ih, iw), jp)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    (want_d,) = vjp(jnp.asarray(g))
    ref, scale = _plain(g, planes, rois, levels, valid, 14, ih=ih, iw=iw)
    _close(ref, [np.asarray(w) for w in want_d], scale, atol=1e-5)
    dfs, _ = _model(g, planes, rois, levels, valid, 14, ih=ih, iw=iw)
    _close(dfs, [np.asarray(w) for w in want_d], scale, atol=1e-5)
    assert _band(rois, levels, valid, ih, iw, planes).any()


def test_plain_past_the_planes_against_jax_einsum():
    """Image extents past the planes, against JAX's einsum RoIAlign
    (`_einsum_equiv`, `crop_and_resize` on boxes normalized by the plane):
    its in-range test runs over the plane, not the valid extent, so it
    zeroes a whole sample past the plane's last cell. Past cell h both give
    0; between h - 1 and h the port (as the Pallas kernel) gives the last
    cell 1 - (v - (h - 1)) and JAX's einsum gives 0. So the forwards agree
    within atol 1e-5 on every sample outside that band, the einsum is 0 on
    the band, and the port is not; the backwards agree where g is 0 on the
    band."""
    planes, rois, levels, valid, ih, iw, g = _past_the_planes(63)
    band = _band(rois, levels, valid, ih, iw, planes)
    assert band.any()

    def einsum(ps):
        return sum(_einsum_equiv(p, jnp.asarray(rois), jnp.asarray(((levels == k) & valid)
                                                                    .astype(F32)),
                                 jnp.asarray(ih), jnp.asarray(iw), 14, s)
                   for k, (p, s) in enumerate(zip(ps, STRIDES)))

    args = (*_t(rois, levels, valid, ih, iw), 14, STRIDES)
    plain = port.roi_align_multilevel_reference([torch.from_numpy(p) for p in planes],
                                                *args).numpy()
    want, vjp = jax.vjp(einsum, tuple(jnp.asarray(p) for p in planes))
    want = np.asarray(want)
    np.testing.assert_allclose(plain[~band], want[~band], rtol=0, atol=1e-5)
    assert (want[band] == 0).all() and np.abs(plain[band]).max() > 0.1
    g_off_band = np.where(band[..., None], F32(0), g)
    (want_d,) = vjp(jnp.asarray(g_off_band))
    ref, scale = _plain(g_off_band, planes, rois, levels, valid, 14, ih=ih, iw=iw)
    _close(ref, [np.asarray(w) for w in want_d], scale, atol=1e-5)


@pytest.mark.parametrize("c,offset,want", [(4, 0, True), (256, 0, True), (42, 0, False),
                                           (256, 1, False)])
def test_vec_decision(c, offset, want):
    """The wrapper's float4 choice: C % 4 == 0 and every pointer 16-byte
    aligned; a gradient 4 bytes off alignment takes the scalar path."""
    g = torch.zeros(2 * 3 * 14 * 14 * c + offset)[offset:].view(2, 3, 14, 14, c)
    planes = [torch.zeros(2, 16, 16, c), torch.zeros(2, 8, 8, c)]
    assert vectorizable(planes, g) == want


@pytest.mark.parametrize("g_kind", ["dense", "pool_sparse"])
def test_model_matches_jax_einsum_vjp(g_kind):
    """Against the VJP of JAX's einsum RoIAlign (`_einsum_equiv`, one call per
    level with that level's valid rois active), on both paths."""
    planes, rois, levels, valid, g = _fixture(21, 12, 14, kind="edges")
    if g_kind == "pool_sparse":
        g = _pool_sparse(planes, rois, levels, valid, 14, seed=3)

    def einsum(ps):
        return sum(_einsum_equiv(p, jnp.asarray(rois), jnp.asarray(((levels == k) & valid)
                                                                    .astype(F32)),
                                 jnp.asarray(IH), jnp.asarray(IW), 14, s)
                   for k, (p, s) in enumerate(zip(ps, STRIDES)))

    _, vjp = jax.vjp(einsum, tuple(jnp.asarray(p) for p in planes))
    (want,) = vjp(jnp.asarray(g))
    _, scale = _plain(g, planes, rois, levels, valid, 14)
    for vec in (True, False):
        dfs, _ = _model(g, planes, rois, levels, valid, 14, vec=vec)
        _close(dfs, [np.asarray(w) for w in want], scale, atol=1e-5)


@pytest.mark.parametrize("g_kind", ["dense", "pool_sparse"])
def test_model_matches_pallas_k5_vjp(g_kind):
    """Against `jax.vjp` through `pallas_roi_align_multilevel` (VJP
    `_ml_backward`, kernel `_ml_bwd_kernel`) in interpret mode, one image per
    Pallas call."""
    planes, rois, levels, valid, g = _fixture(31, 8, 14, outside=False)
    if g_kind == "pool_sparse":
        g = _pool_sparse(planes, rois, levels, valid, 14, seed=4)
    b = rois.shape[0]

    def pallas(ps):
        return jnp.concatenate([pallas_roi_align_multilevel(
            tuple(p[i:i + 1] for p in ps), jnp.asarray(rois[i:i + 1]),
            jnp.asarray(levels[i:i + 1]), jnp.asarray(IH[i:i + 1]), jnp.asarray(IW[i:i + 1]), 14,
            strides=STRIDES, valid=jnp.asarray(valid[i:i + 1].astype(np.int32)), interpret=True,
        ) for i in range(b)])

    _, vjp = jax.vjp(pallas, tuple(jnp.asarray(p) for p in planes))
    (want,) = vjp(jnp.asarray(g))
    dfs, _ = _model(g, planes, rois, levels, valid, 14)
    _, scale = _plain(g, planes, rois, levels, valid, 14)
    _close(dfs, [np.asarray(w) for w in want], scale, atol=1e-5)


@pytest.mark.parametrize("level", [0, 2])
def test_model_as_k3_matches_pallas_window_vjp(level):
    """Launched with one plane (levels all 0, valid = active): K3, against
    `jax.vjp` through `pallas_roi_align_window` with `level_stride` (VJP
    `_pallas_backward`, kernel `_bwd_kernel`) in interpret mode, one image
    per Pallas call, on pool-sparse g."""
    planes, rois, levels, valid, _ = _fixture(50 + level, 8, 14, outside=False)
    g = _pool_sparse(planes, rois, levels, valid, 14, seed=level)
    active = (levels == level) & valid
    feat, stride = planes[level], STRIDES[level]
    b = rois.shape[0]

    def pallas(f):
        return jnp.concatenate([pallas_roi_align_window(
            f[i:i + 1], jnp.asarray(rois[i:i + 1]), jnp.asarray(active[i:i + 1].astype(np.int32)),
            jnp.asarray(IH[i:i + 1]), jnp.asarray(IW[i:i + 1]), 14, interpret=True,
            level_stride=stride,
        ) for i in range(b)])

    _, vjp = jax.vjp(pallas, jnp.asarray(feat))
    (want,) = vjp(jnp.asarray(g))
    (df,), _ = blocked_backward(g, [feat.shape], rois, np.zeros_like(levels), active, IH, IW, 14,
                                (stride,))
    args = (*_t(rois, np.zeros_like(levels), active, IH, IW), 14, (stride,))
    (scale,) = port.roi_align_multilevel_reference_backward(torch.from_numpy(np.abs(g)),
                                                            [torch.from_numpy(feat)], *args)
    _close([df], [np.asarray(want)], [scale.numpy()], atol=1e-5)
    assert float(np.abs(df).max()) > 0
