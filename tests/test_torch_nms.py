"""The port's plain NMS (ops/nms.py) against the JAX package's NMS.

Every case is index-exact: the set of kept original indices must be equal.
Inputs come from numpy seeds and go through both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu.ops import nms as jax_nms
from tf_eager_object_detection_tpu.ops.pallas.nms_pallas import pallas_nms_alive
from tf_eager_object_detection_tpu_torch.ops import nms as torch_nms


def _rand(rng, n, size=500.0):
    x1 = rng.uniform(0, size - 1, n)
    y1 = rng.uniform(0, size - 1, n)
    w = rng.uniform(1, 150, n)
    h = rng.uniform(1, 150, n)
    return np.stack(
        [x1, y1, np.minimum(x1 + w, size), np.minimum(y1 + h, size)], 1
    ).astype(np.float32)


def _cluster_mix(rng, n):
    """~40% of boxes are jittered copies of 64 centers, so suppression chains
    cross many block boundaries; 10% of the slots are invalid."""
    base = _rand(rng, n)
    centers = _rand(rng, 64)
    idx = rng.choice(n, n * 2 // 5, replace=False)
    base[idx] = centers[rng.randint(0, 64, len(idx))] + rng.uniform(
        -4, 4, (len(idx), 4)
    ).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, n // 10, replace=False)] = False
    return base, valid


def _kept_set(order, alive, n):
    got = np.zeros(n, bool)
    got[np.asarray(order)[np.asarray(alive)]] = True
    return got


def _port_kept(boxes, scores, valid, thr, max_out):
    """Kept original indices from the port's plain sorted-box NMS."""
    order = np.argsort(-np.where(valid, scores, -np.inf), kind="stable")
    alive = torch_nms.nms_alive_sorted(
        torch.from_numpy(boxes[order])[None],
        torch.from_numpy(valid[order])[None],
        thr,
        max_out,
    )[0].numpy()
    return _kept_set(order, alive, len(boxes)), order, alive


def _xla_kept(boxes, scores, valid, thr, max_out):
    alive, order = jax_nms.nms_keep_mask(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thr, max_out
    )
    return _kept_set(order, alive, len(boxes))


@pytest.mark.parametrize(
    "n,max_out,thr",
    [(100, 40, 0.5), (300, 100, 0.7), (513, 513, 0.4), (3000, 800, 0.6)],
)
def test_plain_nms_matches_pallas_and_xla(n, max_out, thr):
    rng = np.random.RandomState(n)
    boxes = _rand(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = np.ones(n, bool)
    got, order, _ = _port_kept(boxes, scores, valid, thr, max_out)

    alive_p = pallas_nms_alive(
        jnp.asarray(boxes[order]), jnp.asarray(valid), thr, max_out, interpret=True
    )
    np.testing.assert_array_equal(got, _kept_set(order, alive_p, n))
    np.testing.assert_array_equal(got, _xla_kept(boxes, scores, valid, thr, max_out))
    assert 0 < got.sum() <= max_out


def test_plain_nms_respects_validity_and_clusters():
    rng = np.random.RandomState(1)
    centers = _rand(rng, 8)
    boxes = np.concatenate(
        [centers + rng.uniform(-3, 3, (8, 4)).astype(np.float32) for _ in range(30)]
    )
    scores = rng.uniform(0, 1, len(boxes)).astype(np.float32)
    valid = np.zeros(len(boxes), bool)
    valid[:150] = True
    got, order, _ = _port_kept(boxes, scores, valid, 0.5, 60)

    alive_p = pallas_nms_alive(
        jnp.asarray(boxes[order]), jnp.asarray(valid[order]), 0.5, 60, interpret=True
    )
    np.testing.assert_array_equal(got, _kept_set(order, alive_p, len(boxes)))
    np.testing.assert_array_equal(got, _xla_kept(boxes, scores, valid, 0.5, 60))
    assert not got[~valid].any()


def test_plain_nms_rpn_serving_size_matches_xla():
    """[1, 6000] -> 300 at 0.7, the RPN test-time shape (against the XLA path
    only: the Pallas interpreter is slow at this size)."""
    rng = np.random.RandomState(6000)
    boxes, valid = _cluster_mix(rng, 6000)
    scores = rng.uniform(0, 1, 6000).astype(np.float32)
    got, _, _ = _port_kept(boxes, scores, valid, 0.7, 300)
    np.testing.assert_array_equal(got, _xla_kept(boxes, scores, valid, 0.7, 300))
    assert got.sum() == 300


def test_batched_per_class_nms_matches_vmapped_jax():
    """[20, 300] -> 50 at 0.3: the class-batched per-class NMS of one image,
    against the JAX non_max_suppression vmapped over classes."""
    rng = np.random.RandomState(20)
    c, n = 20, 300
    boxes = np.stack([_cluster_mix(rng, n)[0] for _ in range(c)])
    scores = rng.uniform(0, 1, (c, n)).astype(np.float32)
    scores[:, ::7] = 0.5  # exact ties: broken by index in both
    valid = rng.uniform(0, 1, (c, n)) < 0.8

    idx_t, ok_t = torch_nms.non_max_suppression(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 50, 0.3
    )
    idx_j, ok_j = jax.vmap(
        lambda b, s, v: jax_nms.non_max_suppression(b, s, v, 50, 0.3)
    )(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


def test_non_max_suppression_without_valid_and_short_output():
    """valid=None means all valid; fewer survivors than slots pads with 0/False."""
    rng = np.random.RandomState(7)
    centers = _rand(rng, 3)
    boxes = np.concatenate([centers + rng.uniform(-1, 1, (3, 4)).astype(np.float32)
                            for _ in range(5)])
    scores = rng.uniform(0, 1, len(boxes)).astype(np.float32)
    idx_t, ok_t = torch_nms.non_max_suppression(
        torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None], None, 10, 0.5
    )
    idx_j, ok_j = jax_nms.non_max_suppression(
        jnp.asarray(boxes), jnp.asarray(scores), None, 10, 0.5
    )
    np.testing.assert_array_equal(ok_t[0].numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(idx_t[0].numpy(), np.asarray(idx_j))
    assert 0 < int(ok_t.sum()) < 10
