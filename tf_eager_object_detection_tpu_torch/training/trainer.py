"""Training loop (port of `tf_eager_object_detection_tpu/training/trainer.py`).

Per step: a padded batch -> `make_train_step`; every
`logging_every_n_steps` print the losses and the learning rate as
`step {n} lr=... k=v ...`; every `summary_every_n_steps` write the scalars
and the ground-truth and predicted-box overlays to the metric writer; every
`saving_every_n_steps`, and at the end of each epoch, save a checkpoint.
Restore precedence: an explicit checkpoint directory, else the latest step
in the training directory, else the seeded init with the pretrained
backbone of `backbone_weights` where given.

One device; data parallelism, multiple hosts and spatial partitioning are
not ported yet (ROADMAP item 8). The step count lives on the host, and a
step reads nothing back from the device except at logging and summary
steps. The samplers' random numbers of step n come from `draws(n)` where
the caller gives that callable, else from a `torch.Generator` on the
detector's device seeded with `seed + 1`.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from tf_eager_object_detection_tpu_torch.training.checkpoints import CheckpointManager
from tf_eager_object_detection_tpu_torch.training.metrics import MetricWriter
from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step

__all__ = ["Trainer", "prefetch"]

_BATCH_KEYS = ("images", "image_hw", "gt_boxes", "gt_mask", "gt_labels")


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Run the host-side batch pipeline (decode, preprocessing, padding) in
    a background thread, `size` batches ahead of the training loop.

    An error of the pipeline is re-raised in the consumer, so an epoch never
    ends early in silence; only an error at interpreter teardown is
    swallowed. Closing the generator stops the thread after the batch it is
    making, and closes `iterator`.
    """
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
            put(done)
        except BaseException as exc:  # noqa: BLE001 - re-raised in the consumer
            if sys.is_finalizing():
                return
            put(exc)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None and not sys.is_finalizing():
                close()  # a pipeline's own threads stop with it

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=60)


class Trainer:
    def __init__(
        self,
        detector,
        train_dir: str,
        logging_every_n_steps: int = 100,
        summary_every_n_steps: int = 100,
        saving_every_n_steps: int = 5000,
        restore_ckpt_path: Optional[str] = None,
        seed: int = 0,
        draws: Optional[Callable[[int], object]] = None,
        backbone_weights: Optional[str] = None,
    ):
        """`detector` is re-initialized from `seed` (`init_params`), its
        backbone loaded from `backbone_weights` where given
        (`ref_import/cli.py::load_backbone_weights`), then restored from
        `restore_ckpt_path` or the latest checkpoint in `train_dir`, which
        takes precedence over both. `draws(step)` -> the `TrainDraws` of the
        1-based step, for a caller that must fix them (a parity test)."""
        self.det = detector
        detector.init_params(seed)
        if backbone_weights:
            from tf_eager_object_detection_tpu_torch.ref_import.cli import load_backbone_weights

            load_backbone_weights(detector, backbone_weights)
        self.optimizer = make_optimizer(detector.cfg, detector)
        self.step_fn = make_train_step(detector, self.optimizer)
        self.lr_schedule = self.optimizer.schedule
        self.ckpt = CheckpointManager(train_dir)
        restore = CheckpointManager(restore_ckpt_path) if restore_ckpt_path else self.ckpt
        restore.restore(detector, self.optimizer)
        self.writer = MetricWriter(train_dir)
        self.logging_every = logging_every_n_steps
        self.summary_every = summary_every_n_steps
        self.saving_every = saving_every_n_steps
        self.draws = draws
        self.generator = torch.Generator(device=detector.device).manual_seed(seed + 1)

    @property
    def step(self) -> int:
        return self.optimizer.count

    def _to_device(self, batch: dict):
        dev = self.det.device
        return tuple(torch.as_tensor(np.asarray(batch[k])).to(dev, non_blocking=True)
                     for k in _BATCH_KEYS)

    def train_one_epoch(self, batches: Iterator[dict], steps: Optional[int] = None):
        t_start = time.time()
        n = 0
        for batch in batches:
            step = self.optimizer.count + 1
            draws = self.draws(step) if self.draws is not None else self.generator
            metrics = self.step_fn(self._to_device(batch), draws)
            n += 1
            if step % self.logging_every == 0:
                vals = {k: float(v) for k, v in metrics.items()}
                print(f"step {step} lr={self.lr_schedule(step):.2e} "
                      + " ".join(f"{k}={v:.4f}" for k, v in vals.items()), flush=True)
            if step % self.summary_every == 0:
                vals = {k: float(v) for k, v in metrics.items()}
                vals["learning_rate"] = float(self.lr_schedule(step))
                self.writer.write_scalars(step, vals)
                self._write_gt_overlay(step, batch)
                self._write_pred_overlay(step, batch)
            if step % self.saving_every == 0:
                self.ckpt.save(self.det, self.optimizer)
            if steps is not None and n >= steps:
                break
        dt = time.time() - t_start
        print(f"epoch finished: {n} steps in {dt:.1f}s ({n / max(dt, 1e-9):.2f} steps/s)")

    def _bgr_means(self):
        return self.det.cfg.get("bgr_pixel_means", (103.939, 116.779, 123.68))

    def _write_gt_overlay(self, step: int, batch: dict):
        """Ground-truth boxes drawn on the batch's first image."""
        try:
            from tf_eager_object_detection_tpu_torch.utils.visual import show_one_image

            mask = np.asarray(batch["gt_mask"][0])
            boxes = np.asarray(batch["gt_boxes"][0])[mask]
            labels = np.asarray(batch["gt_labels"][0])[mask]
            overlay = show_one_image(np.asarray(batch["images"][0]), boxes, labels.tolist(),
                                     bgr_means=self._bgr_means())
            self.writer.write_image(step, "gt_boxes", overlay)
        except Exception as exc:
            self._warn_overlay_once("gt", exc)

    def _write_pred_overlay(self, step: int, batch: dict):
        """The detector's boxes on the batch's first image, beside the gt ones."""
        try:
            from tf_eager_object_detection_tpu_torch.utils.visual import show_one_image

            det = self.det.predict(batch["images"][0], batch["image_hw"][0])
            thr = self.det.cfg.get("show_image_score_threshold", 0.3)
            scores = det.scores.cpu().numpy()
            keep = det.valid.cpu().numpy() & (scores >= thr)
            if not keep.any():
                return
            tags = [f"{int(lab)}:{s:.2f}"
                    for lab, s in zip(det.labels.cpu().numpy()[keep], scores[keep])]
            overlay = show_one_image(np.asarray(batch["images"][0]),
                                     det.boxes.cpu().numpy()[keep], tags,
                                     bgr_means=self._bgr_means())
            self.writer.write_image(step, "pred_boxes", overlay)
        except Exception as exc:
            self._warn_overlay_once("pred", exc)

    def _warn_overlay_once(self, kind: str, exc: Exception):
        """An overlay never stops training, but a broken one says so once."""
        warned = getattr(self, "_overlay_warned", set())
        if kind not in warned:
            warned.add(kind)
            self._overlay_warned = warned
            print(f"warning: {kind}-box overlay summary failed: {exc!r}", flush=True)

    def train(self, batches: Iterator[dict], epochs: int, steps_per_epoch: int):
        batches = prefetch(batches)
        try:
            for epoch in range(epochs):
                print(f"epoch {epoch + 1}/{epochs}")
                self.train_one_epoch(batches, steps_per_epoch)
                self.ckpt.save(self.det, self.optimizer)
        finally:
            batches.close()
            self.close()

    def close(self):
        self.writer.close()
        self.ckpt.close()
