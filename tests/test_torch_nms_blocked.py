"""A plain model of the CUDA NMS kernel's word-blocked scan (csrc/nms.cu),
held index-exact against the JAX package's NMS and the port's plain NMS.

The CUDA kernel builds a [B, K, W] suppression bitmask (W = ceil(K / 64),
bit j of word t of row i set when box c = 64 t + j comes after box i and
overlaps it), then walks the W words of each row in order. In iteration w
one warp ORs the column-w words of the rows kept in word w-1 into word w's
`removed` bits and resolves word w's 64 boxes as the fixpoint of
keep <- live & ~(OR of the diagonal rows of keep), keeping its first boxes
up to `max_output` even inside a word, while the other warps OR the rows
kept in word w-1 into words w+1 and later.
`blocked_scan` below does the same steps on the CPU. It lives here, not in
the package: the package's plain version (`nms_alive_sorted_reference`) is
blockwise like the JAX XLA path, so this model is a second, independent
oracle for the kernel's algorithm.

Inputs are numpy-seeded and go through the JAX Pallas kernel in interpret
mode (`pallas_nms_alive`), the JAX XLA path (`nms_alive_sorted`) and the
port's plain version; every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_eager_object_detection_tpu.ops import nms as jax_nms
from tf_eager_object_detection_tpu.ops.pallas.nms_pallas import pallas_nms_alive
from tf_eager_object_detection_tpu_torch.ops import nms as torch_nms

WORD = 64
FULL = (1 << WORD) - 1


def suppression_mask(boxes: np.ndarray, thr: float) -> np.ndarray:
    """[B, K, 4] score-sorted boxes -> [B, K, W] uint64 bitmask, built with the
    port's `_nms_iou`: bit j of word t of row i <=> c = 64 t + j > i and
    iou(i, c) > thr."""
    b, k, _ = boxes.shape
    words = -(-k // WORD)
    t = torch.from_numpy(boxes)
    over = (torch_nms._nms_iou(t, t) > torch.tensor(thr, dtype=torch.float32)).numpy()
    over &= np.triu(np.ones((k, k), bool), 1)
    padded = np.zeros((b, k, words * WORD), bool)
    padded[..., :k] = over
    packed = np.packbits(padded.reshape(b, k, words, WORD), axis=-1, bitorder="little")
    return packed.view("<u8")[..., 0]


def blocked_scan(mask: np.ndarray, valid: np.ndarray, max_output: int):
    """The kernel's stage 2 on the CPU -> (alive [B, K] bool, words visited per row)."""
    b, k, words = mask.shape
    alive = np.zeros((b, k), bool)
    visited = []
    for row in range(b):
        slots = np.ones(words * WORD, bool)  # invalid slots and the tail start removed
        slots[:k] = ~valid[row]
        removed = np.packbits(slots.reshape(words, WORD), axis=-1,
                              bitorder="little").view("<u8")[:, 0].copy()
        kept = 0
        w = 0
        prev = []  # the boxes kept in word w-1
        for w in range(words):
            dead = int(removed[w])
            for i in prev:  # warp 0: word w-1's rows at column w
                dead |= int(mask[row, i, w])
            live = ~dead & FULL
            keep = live  # the word's greedy set: the fixpoint of keep <- live & ~sup(keep)
            while True:
                sup = 0
                for bit in range(WORD):
                    if keep >> bit & 1:
                        sup |= int(mask[row, w * WORD + bit, w])
                nxt = live & ~sup
                if nxt == keep:
                    break
                keep = nxt
            # stop at max_output, even inside the word
            keep = [w * WORD + bit for bit in range(WORD) if keep >> bit & 1][:max_output - kept]
            kept += len(keep)
            if prev and w + 1 < words:  # the other warps: word w-1's rows forward
                removed[w + 1:] |= np.bitwise_or.reduce(mask[row, prev, w + 1:], axis=0)
            alive[row, keep] = True
            if kept >= max_output:
                break
            prev = keep
        visited.append(w + 1)
    return alive, visited


def _random(rng, b, k, size=500.0, side=(1, 150)):
    x1 = rng.uniform(0, size - 1, (b, k))
    y1 = rng.uniform(0, size - 1, (b, k))
    w = rng.uniform(*side, (b, k))
    h = rng.uniform(*side, (b, k))
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def _clustered(rng, b, k, invalid=0.1):
    """~40% jittered copies of 16 centers (chains that cross words), `invalid` share off."""
    boxes = _random(rng, b, k)
    for i in range(b):
        idx = rng.choice(k, k * 2 // 5, replace=False)
        centers = _random(rng, 1, 16)[0]
        boxes[i, idx] = centers[rng.randint(0, 16, len(idx))] + rng.uniform(-4, 4, (len(idx), 4))
    return boxes, rng.uniform(0, 1, (b, k)) >= invalid


def _disjoint(b, k):
    """A grid of 10x10 boxes 20 px apart: no pair overlaps."""
    p = np.arange(k)
    one = np.stack([(p % 50) * 20.0, (p // 50) * 20.0, (p % 50) * 20.0 + 10,
                    (p // 50) * 20.0 + 10], -1).astype(np.float32)
    return np.repeat(one[None], b, 0), np.ones((b, k), bool)


def _case(name):
    """(boxes [B, K, 4] score-sorted, valid [B, K], thr, max_output)."""
    rng = np.random.RandomState(sum(map(ord, name)))
    if name == "cap_mid_word":
        boxes, valid = _clustered(rng, 1, 300)
        return boxes, valid, 0.5, 37
    if name == "cap_at_word_boundary":  # the 128th kept box is the last of word 1
        boxes, valid = _disjoint(1, 256)
        return boxes, valid, 0.5, 128
    if name == "k_not_word_multiple":
        boxes, valid = _clustered(rng, 2, 201)
        return boxes, valid, 0.6, 150
    if name == "k_one":
        return _random(rng, 1, 1), np.ones((1, 1), bool), 0.5, 1
    if name == "all_invalid":
        return _random(rng, 1, 130), np.zeros((1, 130), bool), 0.5, 20
    if name == "all_identical":  # one kept: every later copy overlaps it
        boxes = np.repeat(np.asarray([[[40, 50, 140, 170]]], np.float32), 200, 1)
        return boxes, np.ones((1, 200), bool), 0.7, 50
    if name == "no_overlaps_cap_early":
        boxes, valid = _disjoint(1, 500)
        return boxes, valid, 0.3, 100
    if name == "threshold_zero_chains":  # any overlap suppresses: long chains in each word
        boxes, valid = _clustered(rng, 1, 257, invalid=0.3)
        return boxes, valid, 0.0, 257
    if name == "per_class_b20":
        boxes, valid = _clustered(rng, 20, 300, invalid=0.2)
        return boxes, valid, 0.3, 50
    if name == "rpn_like":
        boxes, valid = _clustered(rng, 1, 1000)
        return boxes, valid, 0.7, 300
    raise KeyError(name)


CASES = ["cap_mid_word", "cap_at_word_boundary", "k_not_word_multiple", "k_one", "all_invalid",
         "all_identical", "no_overlaps_cap_early", "threshold_zero_chains", "per_class_b20",
         "rpn_like"]


def _model(boxes, valid, thr, max_out):
    return blocked_scan(suppression_mask(boxes, thr), valid, max_out)


@pytest.mark.parametrize("name", CASES)
def test_blocked_scan_matches_port_plain_version(name):
    boxes, valid, thr, max_out = _case(name)
    got, _ = _model(boxes, valid, thr, max_out)
    ref = torch_nms.nms_alive_sorted_reference(
        torch.from_numpy(boxes), torch.from_numpy(valid), thr, max_out).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not (got & ~valid).any()
    assert (got.sum(-1) <= max_out).all()


@pytest.mark.parametrize("name", CASES)
def test_blocked_scan_matches_jax_xla(name):
    boxes, valid, thr, max_out = _case(name)
    got, _ = _model(boxes, valid, thr, max_out)
    want = jax.vmap(lambda bx, v: jax_nms.nms_alive_sorted(bx, v, thr, max_out, impl="xla"))(
        jnp.asarray(boxes), jnp.asarray(valid))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("name", [c for c in CASES if c not in ("per_class_b20", "rpn_like")]
                         + ["per_class_b20_rows"])
def test_blocked_scan_matches_jax_pallas_interpret(name):
    """Against the TPU kernel itself in interpret mode (one row per call; the
    per-class case on four of its rows, the interpreter being slow)."""
    boxes, valid, thr, max_out = _case(name.removesuffix("_rows"))
    rows = range(4) if name.endswith("_rows") else range(boxes.shape[0])
    got, _ = _model(boxes, valid, thr, max_out)
    for r in rows:
        want = pallas_nms_alive(jnp.asarray(boxes[r]), jnp.asarray(valid[r]), thr, max_out,
                                interpret=True)
        np.testing.assert_array_equal(got[r], np.asarray(want))


def test_blocked_scan_with_score_ties_matches_jax_keep_mask():
    """Exact score ties, sorted stably (ties by index, as TF): the kept
    original indices equal JAX `nms_keep_mask`'s, which sorts for itself."""
    rng = np.random.RandomState(11)
    boxes, valid = _clustered(rng, 1, 260)
    scores = rng.choice(np.float32([0.9, 0.5, 0.25]), 260)  # three score values
    order = np.argsort(-np.where(valid[0], scores, -np.inf), kind="stable")
    got, _ = _model(boxes[:, order], valid[:, order], 0.5, 90)
    alive, jorder = jax_nms.nms_keep_mask(jnp.asarray(boxes[0]), jnp.asarray(scores),
                                          jnp.asarray(valid[0]), 0.5, 90)
    np.testing.assert_array_equal(order, np.asarray(jorder))
    np.testing.assert_array_equal(got[0], np.asarray(alive))


@pytest.mark.parametrize("name,words", [("cap_at_word_boundary", 2),
                                        ("no_overlaps_cap_early", 2),
                                        ("all_invalid", 3), ("k_one", 1)])
def test_blocked_scan_stops_at_the_cap(name, words):
    """The scan visits ceil(cap / 64) words when nothing is suppressed, and
    every word when the cap is never reached."""
    boxes, valid, thr, max_out = _case(name)
    alive, visited = _model(boxes, valid, thr, max_out)
    assert visited == [words]
    assert alive.sum() == min(max_out, valid.sum())


def test_suppression_mask_layout():
    """Bit j of word t of row i is the strict-upper IoU test of (i, 64 t + j)."""
    boxes, _ = _clustered(np.random.RandomState(5), 1, 150)
    mask = suppression_mask(boxes, 0.4)
    assert mask.shape == (1, 150, 3) and mask.dtype == np.uint64
    t = torch.from_numpy(boxes)
    want = (torch_nms._nms_iou(t, t) > 0.4).numpy()[0] & np.triu(np.ones((150, 150), bool), 1)
    bits = np.unpackbits(mask[0].view(np.uint8).reshape(150, 3, 8), axis=-1,
                         bitorder="little").reshape(150, 192)
    np.testing.assert_array_equal(bits[:, :150].astype(bool), want)
    assert not bits[:, 150:].any()
