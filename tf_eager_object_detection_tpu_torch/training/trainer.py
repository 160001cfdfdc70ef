"""Training loop (port of `tf_eager_object_detection_tpu/training/trainer.py`).

Per step: a padded batch -> `make_train_step`; every
`logging_every_n_steps` print the losses and the learning rate as
`step {n} lr=... k=v ...`; every `summary_every_n_steps` write the scalars
and the ground-truth and predicted-box overlays to the metric writer; every
`saving_every_n_steps`, and at the end of each epoch, save a checkpoint.
Restore precedence: an explicit checkpoint directory, else the latest step
in the training directory, else the seeded init with the pretrained
backbone of `backbone_weights` where given.

The step count lives on the host, and a step reads nothing back from the
device except at logging and summary steps. The samplers' random numbers
of step n come from `draws(n)` where the caller gives that callable, else
from a `torch.Generator` on the detector's device seeded with `seed + 1`.

`data_parallel=True` or `multihost=True` trains over the default process
group (`parallel/multihost.py::initialize` first; the port makes no
difference between one host and several): every rank is fed the same
global batch stream, takes its rows of each batch (`local_batch_slice`,
which refuses a batch the world size does not divide, on every rank
before the step's first collective) and the global batch's draws, which
`parallel/mesh.py::make_parallel_train_step` slices, and steps in
lockstep. At logging and summary steps only, one `all_reduce` averages
the metrics over the ranks, so that rank 0 prints and writes the global
batch's losses; only rank 0 prints, writes the metric events and the
overlays (its `predict` runs on the detector itself). Every rank takes
part in a checkpoint save and restore (`CheckpointManager(distributed=
True)`).

`spatial_partition=N` > 1 trains over the default group as dp = W // N
batch groups of N ranks that share each image's rows
(`parallel/spatial.py`): every rank is fed the global batch stream, and
the spatial step takes the rows of its batch index and, of their images,
the rows of its space index. It refuses a world size that N does not
divide (before any collective), a global batch that dp does not divide
and an image height that N does not divide (at the step, on every rank,
before its first collective), and, as JAX, `multihost`. The metrics are
averaged over the batch group (the ranks of a space group compute the
same ones); the overlays' `predict` runs on rank 0 alone, on the whole
image, as JAX's does.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from tf_eager_object_detection_tpu_torch.parallel.mesh import make_parallel_train_step
from tf_eager_object_detection_tpu_torch.parallel.multihost import local_batch_slice
from tf_eager_object_detection_tpu_torch.parallel.spatial import (
    make_spatial_groups,
    make_spatial_train_step,
)
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
        data_parallel: bool = False,
        multihost: bool = False,
        spatial_partition: int = 1,
    ):
        """`detector` is re-initialized from `seed` (`init_params`), its
        backbone loaded from `backbone_weights` where given
        (`ref_import/cli.py::load_backbone_weights`), then restored from
        `restore_ckpt_path` or the latest checkpoint in `train_dir`, which
        takes precedence over both. `draws(step)` -> the `TrainDraws` of the
        1-based step (of the global batch under data parallelism), for a
        caller that must fix them (a parity test)."""
        spatial = int(spatial_partition) > 1
        if spatial and multihost:
            raise ValueError("spatial_partition with multihost is not supported: spatial "
                             "partitioning targets one host with more GPUs than images")
        self.parallel = bool(data_parallel or multihost or spatial)
        if self.parallel and not dist.is_initialized():
            raise RuntimeError("data_parallel / multihost / spatial_partition train over the "
                               "default process group: call parallel.multihost.initialize "
                               "first (launch with torchrun --standalone --nproc_per_node N)")
        self.rank, self.world = (dist.get_rank(), dist.get_world_size()) if self.parallel else (0, 1)
        # refuses a world size that spatial_partition does not divide
        self.groups = make_spatial_groups(int(spatial_partition)) if spatial else None
        self.is_primary = self.rank == 0
        self.det = detector
        detector.init_params(seed)
        if backbone_weights:
            from tf_eager_object_detection_tpu_torch.ref_import.cli import load_backbone_weights

            load_backbone_weights(detector, backbone_weights)
        self.optimizer = make_optimizer(detector.cfg, detector)
        if spatial:
            self.step_fn = make_spatial_train_step(detector, self.optimizer, self.groups)
        elif self.parallel:
            self.step_fn = make_parallel_train_step(detector, self.optimizer)
        else:
            self.step_fn = make_train_step(detector, self.optimizer)
        self.lr_schedule = self.optimizer.schedule
        self.ckpt = CheckpointManager(train_dir, distributed=self.parallel)
        restore = (CheckpointManager(restore_ckpt_path, distributed=self.parallel)
                   if restore_ckpt_path else self.ckpt)
        restore.restore(detector, self.optimizer)
        self.writer = MetricWriter(train_dir) if self.is_primary else None
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

    def _step(self, batch: dict, step: int) -> dict:
        """One step on `batch`: under data parallelism the global batch, of
        which this rank takes its rows (the step samples or slices the
        global batch's draws); under spatial partitioning the spatial step
        takes them."""
        draws = self.draws(step) if self.draws is not None else self.generator
        if self.groups is not None:
            return self.step_fn(tuple(np.asarray(batch[k]) for k in _BATCH_KEYS), draws)
        if self.parallel:
            lo, hi = local_batch_slice(len(batch["images"]), self.rank, self.world)
            batch = {k: np.asarray(batch[k])[lo:hi] for k in _BATCH_KEYS}
        return self.step_fn(self._to_device(batch), draws)

    def _mean_over_ranks(self, metrics: dict) -> dict:
        """The metrics averaged over the ranks (over a batch group under
        spatial partitioning): one all_reduce, which every rank makes at the
        same steps."""
        if not self.parallel:
            return metrics
        vals = torch.stack([v.float() for v in metrics.values()])
        group, n = (self.groups.batch, self.groups.dp) if self.groups else (None, self.world)
        dist.all_reduce(vals, group=group)
        return dict(zip(metrics, vals / n))

    def train_one_epoch(self, batches: Iterator[dict], steps: Optional[int] = None):
        t_start = time.time()
        n = 0
        for batch in batches:
            step = self.optimizer.count + 1
            metrics = self._step(batch, step)
            n += 1
            log, summary = step % self.logging_every == 0, step % self.summary_every == 0
            if log or summary:
                metrics = self._mean_over_ranks(metrics)
            if log and self.is_primary:
                vals = {k: float(v) for k, v in metrics.items()}
                print(f"step {step} lr={self.lr_schedule(step):.2e} "
                      + " ".join(f"{k}={v:.4f}" for k, v in vals.items()), flush=True)
            if summary and self.is_primary:
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
        if self.is_primary:
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
                if self.is_primary:
                    print(f"epoch {epoch + 1}/{epochs}")
                self.train_one_epoch(batches, steps_per_epoch)
                self.ckpt.save(self.det, self.optimizer)
        finally:
            batches.close()
            self.close()

    def close(self):
        if self.writer is not None:
            self.writer.close()
        self.ckpt.close()
