"""The port's RPN and RoI target samplers against the JAX package's, on the CPU.

JAX draws its random numbers inside `anchor_target` / `proposal_target`; the
test rebuilds them from the same key (the samplers' own `split`s, then
`uniform`, and for the with-replacement draw the Gumbel noise that
`categorical` adds to its logits) and hands them to the port. Two images
per port call, one JAX call per image.

Labels, slot indices (the sampled rois) and validity must match exactly;
regression targets and weights within atol 1e-6 (the box encoding's log and
divisions round differently in XLA:CPU and torch). Each case asserts the
condition it is named for.
"""

import jax
import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu.ops import sampling as jax_sampling
from tf_eager_object_detection_tpu_torch.core.boxes import pairwise_iou
from tf_eager_object_detection_tpu_torch.ops import sampling

TARGET_TOL = dict(rtol=0, atol=1e-6)
B = 2


def _boxes(rng, n, h, w, lo=8.0, hi=120.0):
    x1 = rng.uniform(-10, w - lo, n)
    y1 = rng.uniform(-10, h - lo, n)
    return np.stack([x1, y1, x1 + rng.uniform(lo, hi, n), y1 + rng.uniform(lo, hi, n)],
                    -1).astype(np.float32)


def _near(rng, boxes, n, jitter):
    """n jittered copies of `boxes` (high IoU with them)."""
    base = boxes[rng.randint(0, len(boxes), n)]
    return (base + rng.uniform(-jitter, jitter, (n, 4))).astype(np.float32)


def _gt(rng, b, g, n_valid, h, w):
    gt = np.zeros((b, g, 4), np.float32)
    mask = np.zeros((b, g), bool)
    labels = np.zeros((b, g), np.int32)
    for i in range(b):
        gt[i, :n_valid] = _boxes(rng, n_valid, h - 40, w - 40, lo=30.0, hi=80.0) + 20.0
        mask[i, :n_valid] = True
        labels[i, :n_valid] = rng.randint(1, 21, n_valid)
    return gt, mask, labels


# ------------------------------------------------------------- anchor_target
def _anchor_draws(key, a):
    k_fg, k_bg = jax.random.split(key)
    return np.asarray(jax.random.uniform(k_fg, (a,))), np.asarray(jax.random.uniform(k_bg, (a,)))


ANCHOR_CASES = {
    # name: (anchors near gt, random anchors, valid gt, total, max_pos)
    "bg_plentiful": (10, 400, 3, 64, 32),
    "fg_cap_hit": (120, 300, 3, 64, 16),
    "empty_gt": (40, 300, 0, 64, 32),
    "fewer_anchors_than_samples": (20, 30, 2, 256, 128),
}


@pytest.mark.parametrize("case", sorted(ANCHOR_CASES))
def test_anchor_target_matches_jax(case):
    n_near, n_rand, n_gt, total, max_pos = ANCHOR_CASES[case]
    rng = np.random.RandomState(len(case))
    h, w = 200, 240
    gt, mask, _ = _gt(rng, B, 6, n_gt, h, w)
    anchors = np.concatenate([_near(rng, gt[0, :max(n_gt, 1)], n_near, 4.0),
                              _boxes(rng, n_rand, h, w)])
    a = len(anchors)
    ih = np.asarray([h, h - 30], np.int32)
    iw = np.asarray([w, w - 50], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(len(case) + 100), B)
    kw = dict(total_num_samples=total, max_pos_samples=max_pos, target_means=(0.1, 0, 0, -0.1),
              target_stds=(1.0, 1.0, 2.0, 2.0))
    want = [jax_sampling.anchor_target(anchors, gt[i], mask[i], ih[i], iw[i], keys[i], **kw)
            for i in range(B)]
    fg_pri, bg_pri = (torch.from_numpy(np.stack(x)) for x in
                      zip(*[_anchor_draws(keys[i], a) for i in range(B)]))
    got = sampling.anchor_target(torch.from_numpy(anchors), *map(torch.from_numpy, (gt, mask)),
                                 torch.from_numpy(ih), torch.from_numpy(iw), fg_pri, bg_pri, **kw)
    for i in range(B):
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(want[i].labels))
        for name in ("bbox_targets", "in_weights", "out_weights"):
            np.testing.assert_allclose(getattr(got, name)[i].numpy(),
                                       np.asarray(getattr(want[i], name)), **TARGET_TOL)
    labels = got.labels.numpy()
    fg, bg = (labels == 1).sum(1), (labels == 0).sum(1)
    if case == "fg_cap_hit":
        assert (fg == max_pos).all()
    if case == "empty_gt":
        assert (fg == 0).all() and (bg == total).all()
    if case == "bg_plentiful":
        assert (fg + bg == total).all() and (fg < max_pos).all()
    if case == "fewer_anchors_than_samples":
        assert (fg + bg < total).all() and (fg + bg > 0).all()


# ----------------------------------------------------------- proposal_target
def _proposal_draws(key, r, s):
    k_fg, k_bg, k_wr = jax.random.split(key, 3)
    return (np.asarray(jax.random.uniform(k_fg, (r,))), np.asarray(jax.random.uniform(k_bg, (r,))),
            np.asarray(jax.random.gumbel(k_wr, (s, r))))


def _proposal_case(case, rng, h, w):
    """(rois [B, R, 4], roi_mask [B, R], gt, gt_mask, gt_labels, S, max_pos)."""
    s, max_pos = 32, 8
    gt, mask, labels = _gt(rng, B, 5, 3, h, w)
    n_valid = {"fg_cap_hit": 60, "bg_plentiful": 60, "bg_exactly_at_quota": 32,
               "bg_scarce": 14, "no_bg_at_all": 20, "fewer_rois_than_slots": 20,
               "empty_gt": 40}[case]
    r = 20 if case == "fewer_rois_than_slots" else 64
    rois = np.zeros((B, r, 4), np.float32)
    roi_mask = np.zeros((B, r), bool)
    for i in range(B):
        n_fg = {"fg_cap_hit": 20, "bg_exactly_at_quota": 6, "no_bg_at_all": n_valid}.get(case, 4)
        near = _near(rng, gt[i, :3], n_fg, 2.0)
        far = _boxes(rng, n_valid - n_fg, 60, 60, lo=4.0, hi=20.0) + [w - 60, 0, w - 60, 0]
        rois[i, :n_valid] = np.concatenate([near, far])[rng.permutation(n_valid)]
        roi_mask[i, :n_valid] = True
    if case == "empty_gt":
        mask[:] = False
    return rois, roi_mask, gt, mask, labels, s, max_pos


PROPOSAL_CASES = ["fg_cap_hit", "bg_plentiful", "bg_exactly_at_quota", "bg_scarce",
                  "no_bg_at_all", "fewer_rois_than_slots", "empty_gt"]


@pytest.mark.parametrize("strict", [False, True], ids=["own_label", "strict_class_column"])
@pytest.mark.parametrize("case", PROPOSAL_CASES)
def test_proposal_target_matches_jax(case, strict):
    rng = np.random.RandomState(PROPOSAL_CASES.index(case))
    rois, roi_mask, gt, mask, labels, s, max_pos = _proposal_case(case, rng, 160, 200)
    r = rois.shape[1]
    keys = jax.random.split(jax.random.PRNGKey(7 + PROPOSAL_CASES.index(case)), B)
    kw = dict(num_classes=21, total_num_samples=s, max_pos_samples=max_pos,
              target_means=(0.0, 0.05, 0.0, 0.0), target_stds=(0.1, 0.1, 0.2, 0.2),
              strict_class_column=strict)
    want = [jax_sampling.proposal_target(rois[i], roi_mask[i], gt[i], mask[i], labels[i], keys[i],
                                         **kw) for i in range(B)]
    draws = [torch.from_numpy(np.stack(x)) for x in
             zip(*[_proposal_draws(keys[i], r, s) for i in range(B)])]
    got = sampling.proposal_target(*map(torch.from_numpy, (rois, roi_mask, gt, mask, labels)),
                                   *draws, **kw)
    for i in range(B):
        np.testing.assert_array_equal(got.rois[i].numpy(), np.asarray(want[i].rois))
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(want[i].labels))
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(want[i].valid))
        for name in ("bbox_targets", "in_weights", "out_weights"):
            np.testing.assert_allclose(getattr(got, name)[i].numpy(),
                                       np.asarray(getattr(want[i], name)), **TARGET_TOL)

    # the condition each case is named for, from the port's own IoUs
    iou = pairwise_iou(torch.from_numpy(rois), torch.from_numpy(gt), torch.from_numpy(mask))
    best = torch.where(torch.from_numpy(mask)[:, None, :], iou, torch.full_like(iou, -1.0))
    best = torch.where(torch.from_numpy(roi_mask), best.max(-1).values, torch.full((B, r), -1.0))
    n_fg = (best >= 0.5).sum(1).clamp_max(max_pos)
    n_bg = ((best < 0.5) & (best >= 0.0)).sum(1)
    need = s - n_fg
    checks = {
        "fg_cap_hit": (n_fg == max_pos).all() and (n_bg >= need).all(),
        "bg_plentiful": (n_bg > need).all(),
        "bg_exactly_at_quota": (n_bg == need).all(),
        "bg_scarce": ((n_bg > 0) & (n_bg < need)).all(),
        "no_bg_at_all": (n_bg == 0).all() and (n_fg > 0).all(),
        "fewer_rois_than_slots": r < s,
        "empty_gt": (n_fg == 0).all() and (n_bg == 0).all(),
    }
    assert bool(checks[case])
    assert (got.labels.numpy() > 0).sum(1).tolist() == n_fg.tolist()


def test_train_draws_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    d = sampling.TrainDraws.sample(gen, 2, 100, 30, 8)
    assert [tuple(t.shape) for t in d] == [(2, 100), (2, 100), (2, 30), (2, 30), (2, 8, 30)]
    for t in d[:4]:
        assert float(t.min()) >= 0.0 and float(t.max()) < 1.0
    assert bool(torch.isfinite(d.roi_bg_gumbel).all())
