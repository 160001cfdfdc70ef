"""The port's detection losses against the JAX package's, values and gradients.

Same numpy inputs into `ops/losses.py` of both; gradients from `jax.grad`
and torch autograd. Cases: no mask, a partial mask and an all-masked one,
at the RPN's shapes (sigma 3, sum over dims (0, 1) of one image's [A, 4])
and the RoI head's (sigma 1, dim (1,) over [N, 4 * classes]).

Tolerances: values and gradients rtol 1e-5, atol 1e-7. log-softmax and the
reductions sum in another order in XLA:CPU and torch; the smooth-L1 branch
choice (|diff| < 1 / sigma^2) is the same comparison in float32 in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu.ops import losses as jax_losses
from tf_eager_object_detection_tpu_torch.ops import losses

TOL = dict(rtol=1e-5, atol=1e-7)
MASKS = ["none", "partial", "all_masked"]


def _labels_and_weights(rng, n, classes, mask):
    labels = rng.randint(0, classes, n).astype(np.int32)
    if mask == "none":
        return labels, None
    keep = rng.uniform(size=n) < 0.4 if mask == "partial" else np.zeros(n, bool)
    labels = np.where(keep, labels, -1).astype(np.int32)  # masked rows carry -1, as in the RPN
    return labels, keep


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("n,classes", [(300, 2), (64, 21)], ids=["rpn", "roi"])
def test_cls_loss_and_grad_match_jax(n, classes, mask):
    rng = np.random.RandomState(n + classes + len(mask))
    logits = (rng.randn(n, classes) * 3).astype(np.float32)
    labels, keep = _labels_and_weights(rng, n, classes, mask)
    if mask == "none":
        labels = np.maximum(labels, 0)

    def jax_fn(x):
        return jax_losses.cls_loss(x, jnp.asarray(labels),
                                   None if keep is None else jnp.asarray(keep))

    want, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = losses.cls_loss(x, torch.from_numpy(labels),
                          None if keep is None else torch.from_numpy(keep))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **TOL)
    if mask == "all_masked":
        assert got.item() == 0.0 and not x.grad.any()


def _box_case(rng, shape, mask):
    pred = (rng.randn(*shape) * 0.5).astype(np.float32)
    targets = (rng.randn(*shape) * 0.5).astype(np.float32)
    rows = {"none": np.ones(shape[0], bool), "partial": rng.uniform(size=shape[0]) < 0.3,
            "all_masked": np.zeros(shape[0], bool)}[mask]
    in_w = np.broadcast_to(rows[:, None], shape).astype(np.float32)
    out_w = np.full(shape, 1.0 / max(rows.sum(), 1), np.float32)
    return pred, targets, in_w, out_w


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("shape,sigma,dim", [((500, 4), 3.0, (0, 1)), ((64, 84), 1.0, (1,))],
                         ids=["rpn", "roi"])
def test_smooth_l1_loss_and_grad_match_jax(shape, sigma, dim, mask):
    rng = np.random.RandomState(shape[0] + len(mask))
    pred, targets, in_w, out_w = _box_case(rng, shape, mask)

    def jax_fn(p):
        return jax_losses.smooth_l1_loss(p, jnp.asarray(targets), jnp.asarray(in_w),
                                         jnp.asarray(out_w), sigma=sigma, dim=dim)

    want, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = losses.smooth_l1_loss(p, *map(torch.from_numpy, (targets, in_w, out_w)),
                                sigma=sigma, dim=dim)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), **TOL)
    # both branches of the smooth-L1 are exercised where rows are kept
    if mask != "all_masked":
        small = np.abs(in_w * (pred - targets)) < 1.0 / sigma**2
        assert small[in_w > 0].any() and not small[in_w > 0].all()


def test_batched_losses_are_per_image_losses():
    """A leading batch dimension gives each image's loss (the FPN loss sums
    the RPN's per image and takes the mean over images)."""
    rng = np.random.RandomState(11)
    logits = torch.from_numpy(rng.randn(3, 50, 2).astype(np.float32))
    labels = torch.from_numpy(rng.randint(-1, 2, (3, 50)))
    per_image = losses.cls_loss(logits, labels, labels >= 0)
    for i in range(3):
        torch.testing.assert_close(per_image[i], losses.cls_loss(logits[i], labels[i],
                                                                 labels[i] >= 0))
    pred, targets, in_w = (torch.from_numpy(rng.randn(3, 50, 4).astype(np.float32))
                           for _ in range(3))
    out_w = torch.full((3, 50, 4), 0.02)
    batched = losses.smooth_l1_loss(pred, targets, in_w, out_w, sigma=3.0, dim=(1, 2))
    singles = [losses.smooth_l1_loss(pred[i], targets[i], in_w[i], out_w[i], sigma=3.0,
                                     dim=(0, 1)) for i in range(3)]
    torch.testing.assert_close(batched, torch.stack(singles).mean())
