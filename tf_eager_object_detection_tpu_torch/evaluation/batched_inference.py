"""Bucket-grouped batched eval inference
(port of `tf_eager_object_detection_tpu/evaluation/batched_inference.py`).

Groups the stream by padded bucket shape and flushes bucket-uniform batches
through `detector.im_detect_batch`, so the backbone and the RPN NMS run once
per batch. Results are yielded per image.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np

__all__ = ["batched_im_detect"]


def batched_im_detect(
    detector, items: Iterable, batch_size: int = 8
) -> Iterator[Tuple[int, tuple, tuple]]:
    """Yields (stream_index, item, (softmax, deltas, rois, roi_valid)).

    `items` yields host-side tuples whose first three entries are
    (padded_image [Hp, Wp, 3], image_hw [2], scale); further entries ride
    along untouched. A final partial batch is padded by repeating its last
    element, and padded rows are dropped before yielding. Yield order is
    batch-completion order, NOT stream order: index by `stream_index`.
    """

    def flush(group):
        padded = [it for _, it in group]
        padded += [padded[-1]] * (batch_size - len(padded))
        images = np.stack([it[0] for it in padded])
        hws = np.stack([it[1] for it in padded])
        scales = np.asarray([it[2] for it in padded], np.float32)
        sm, deltas, rois, roi_valid = detector.im_detect_batch(images, hws, scales)
        for i, (idx, item) in enumerate(group):
            yield idx, item, (sm[i], deltas[i], rois[i], roi_valid[i])

    pending: dict = {}
    for idx, item in enumerate(items):
        key = tuple(item[0].shape[:2])
        pending.setdefault(key, []).append((idx, item))
        if len(pending[key]) == batch_size:
            yield from flush(pending.pop(key))
    for group in pending.values():
        yield from flush(group)
