"""One rank of a data-parallel check of the port, and the parent's side.

    python tests/torch_ddp_worker.py SPEC.json RANK

A child imports the port and torch only, never JAX, sets torch to one
thread before any work, joins a gloo group over the spec's `init_method`
(a `file://` store: no port is bound) with the spec's collective timeout,
and writes what it computed to `<out>/rank<R>.npz`. Modes:

- `step`: one `make_parallel_train_step` step on this rank's rows of the
  global batch in `inputs` (an `.npz` of the five batch arrays and the
  global `TrainDraws`), from the weights `build_detector` makes; saves the
  metrics, each parameter's digest and whether the frozen parameters kept
  their bits, and on rank 0 every parameter and momentum trace.
- `trainer`: `Trainer(data_parallel=True)` over the TFRecords of the spec
  for `steps` steps (a checkpoint at the end), then a fresh two-rank
  `Trainer` on the same directory; saves the step counts, whether the
  restored parameters and traces equal the trained ones bit for bit, and
  the trained parameters' digests.
- `indivisible`: a `Trainer(data_parallel=True)` step on a global batch of
  3 images, which must raise ValueError on every rank.
- `spatial`: the cases of the spec in order over one dp x sp layout
  (`make_spatial_groups(sp)`): `step` cases take one
  `make_spatial_train_step` step on the global batch of `inputs` with its
  draws, and save the metrics, the parameters' digests, the rows that
  the hooked extractor layers saw and the exchanges' bytes; the case's
  `reference_rank` then takes the port's single-process step at the
  global batch from the same weights and draws, on its one thread, and
  saves its metrics and the largest difference of each updated parameter
  from the spatial step's, relative to the tensor's largest value; with
  `save_params`, rank 0 saves the updated parameters. `predict` cases run
  `make_spatial_predict` on each image of `inputs`, and the reference rank
  the detector's own `predict`. `trainer` cases train a
  `Trainer(spatial_partition=sp)` for the global batches of `inputs`, then
  feed it a batch of one image, which must raise ValueError.

`run_processes(cmds, ...)` starts commands with their output in files,
waits for all of them up to a deadline, kills every one that is left,
and raises with their output if any failed or timed out
(`start_processes` and `wait_processes` split it, so that the parent can
work while the children run).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)
BATCH_KEYS = ("images", "image_hw", "gt_boxes", "gt_mask", "gt_labels")
# a collective that waits longer than this fails instead of hanging
COLLECTIVE_TIMEOUT_S = 120.0


def child_env() -> dict:
    """The children's environment: the port on the path, one thread."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    return env


def start_processes(cmds, log_dir, timeout_s: float, envs=None):
    """Start `cmds` at once (their output in files of `log_dir`) -> the
    handle `wait_processes` takes; their deadline is `timeout_s` from now.
    `envs[i]` is added to command i's environment."""
    os.makedirs(log_dir, exist_ok=True)
    procs, logs = [], []
    for i, cmd in enumerate(cmds):
        log = open(os.path.join(log_dir, f"proc{i}.log"), "w+")
        logs.append(log)
        env = dict(child_env(), **(envs[i] if envs else {}))
        procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
                                      env=env))
    return procs, logs, time.monotonic() + timeout_s


def run_processes(cmds, log_dir, timeout_s: float, expect_ok=True):
    """Run `cmds` at once -> [(returncode, output)]; kills all of them at
    the deadline and raises with their output. With `expect_ok`, a non-zero
    exit raises too."""
    return wait_processes(start_processes(cmds, log_dir, timeout_s), expect_ok)


def wait_processes(started, expect_ok=True):
    """Wait for the processes of `start_processes` up to their deadline ->
    [(returncode, output)], as `run_processes`."""
    procs, logs, deadline = started
    timed_out = False
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outputs = []
    for log in logs:
        log.seek(0)
        outputs.append(log.read())
        log.close()
    results = [(p.returncode, out) for p, out in zip(procs, outputs)]
    if timed_out or (expect_ok and any(rc != 0 for rc, _ in results)):
        what = "timed out" if timed_out else "failed"
        report = "\n".join(f"--- process {i} (rc {rc}) ---\n{out[-4000:]}"
                           for i, (rc, out) in enumerate(results))
        raise AssertionError(f"processes {what}:\n{report}")
    return results


def run_ranks(spec: dict, tmp_dir, world: int = 2, timeout_s: float = 300.0, expect_ok=True):
    """`world` children of this module on `spec` (written to `tmp_dir`),
    over a file store in `tmp_dir` -> their (returncode, output)."""
    return wait_processes(start_ranks(spec, tmp_dir, world, timeout_s), expect_ok)


def start_ranks(spec: dict, tmp_dir, world: int = 2, timeout_s: float = 300.0):
    """`run_ranks` without the wait: -> the handle of `wait_processes`."""
    tmp_dir = str(tmp_dir)
    spec = dict(spec, world=world, init_method=f"file://{os.path.join(tmp_dir, 'store')}",
                out=spec.get("out", tmp_dir))
    path = os.path.join(tmp_dir, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    cmds = [[sys.executable, WORKER, path, str(r)] for r in range(world)]
    return start_processes(cmds, os.path.join(tmp_dir, "logs"), timeout_s)


def build_detector(spec: dict, device="cpu"):
    """The detector of a spec: `model_factory` at the spec's seed, the JAX
    `.npz` of `weights` loaded where given, or with `random_biases` (a
    seed) random biases and frozen-BatchNorm statistics as
    `torch_shared.numpy_params` draws them, then the RPN score layer scaled
    by `rpn_score_scale` (so that random-weight proposals separate)."""
    import torch

    from tf_eager_object_detection_tpu_torch.models.layers import FrozenBatchNorm

    from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
    from tf_eager_object_detection_tpu_torch.training.checkpoints import load_params

    det = model_factory(spec["model_type"], spec["backbone"], spec["cfg"], device=device,
                        seed=spec.get("seed", 0))
    if spec.get("weights"):
        load_params(spec["weights"], det)
    if spec.get("random_biases") is not None:
        gen = torch.Generator().manual_seed(spec["random_biases"])
        with torch.no_grad():
            for name, mod in det.named_modules():
                if isinstance(mod, FrozenBatchNorm):
                    gain = 0.2 if name.endswith("_3_bn") else 1.0  # keeps the residual stream
                    for buf, draw in (("gamma", lambda t: (0.8 + 0.4 * t.uniform_(generator=gen))
                                       * gain), ("beta", lambda t: 0.1 * t.normal_(generator=gen)),
                                      ("moving_mean", lambda t: 0.1 * t.normal_(generator=gen)),
                                      ("moving_variance",
                                       lambda t: 0.5 + t.uniform_(generator=gen))):
                        getattr(mod, buf).copy_(draw(torch.empty_like(getattr(mod, buf))))
                elif getattr(mod, "bias", None) is not None and isinstance(mod.bias, torch.Tensor):
                    mod.bias.copy_(0.1 * torch.randn(mod.bias.shape, generator=gen))
    scale = spec.get("rpn_score_scale", 1.0)
    if scale != 1.0:
        with torch.no_grad():
            det.rpn_head.rpn_score_conv.weight.mul_(scale)
    return det


def save_inputs(path, batch, draws) -> None:
    """The global batch (five arrays) and its `TrainDraws` to one `.npz`."""
    import numpy as np

    arrays = {k: np.asarray(v) for k, v in zip(BATCH_KEYS, batch)}
    for name, t in zip(draws._fields, draws):
        if t is not None:
            arrays["draws_" + name] = t.numpy()
    np.savez(path, **arrays)


def load_inputs(path):
    import numpy as np
    import torch

    from tf_eager_object_detection_tpu_torch.ops.sampling import TrainDraws

    data = np.load(path)
    batch = [data[k] for k in BATCH_KEYS]
    draws = TrainDraws(*(torch.from_numpy(data["draws_" + f]) if "draws_" + f in data else None
                         for f in TrainDraws._fields))
    return batch, draws


def digest(t) -> str:
    """The SHA-256 of a tensor's bytes: equal digests, equal bits."""
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()


def _step(spec, rank, world):
    import numpy as np
    import torch

    from tf_eager_object_detection_tpu_torch.parallel.mesh import make_parallel_train_step
    from tf_eager_object_detection_tpu_torch.parallel.multihost import local_batch_slice
    from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer

    det = build_detector(spec)
    frozen = {n: p.detach().clone() for n, p in det.named_parameters() if not p.requires_grad}
    opt = make_optimizer(det.cfg, det)
    step = make_parallel_train_step(det, opt)
    batch, draws = load_inputs(spec["inputs"])
    lo, hi = local_batch_slice(len(batch[0]), rank, world)
    t0 = time.perf_counter()
    metrics = step([a[lo:hi] for a in batch], draws)
    out = {"seconds": time.perf_counter() - t0}
    out.update({"metric/" + k: float(v) for k, v in metrics.items()})
    params = dict(det.named_parameters())
    out.update({"digest/" + n: digest(p) for n, p in params.items()})
    if rank == 0:  # the other ranks' parameters are compared by their digests
        out.update({"param/" + n: p.detach().numpy() for n, p in params.items()})
        out.update({"trace/" + n: t.numpy() for n, t in opt.trace.items()})
    out["frozen_unchanged"] = all(torch.equal(t, params[n]) for n, t in frozen.items())
    out["n_frozen"] = len(frozen)
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **out)


def _data_cfg(spec):
    return {"model_config": spec["cfg"], "batch_size": spec["global_batch"],
            "preprocessing_type": "caffe", "seed": spec.get("seed", 0),
            "tf_records_list": spec["records"]}


def _train_and_restore(spec, rank, world):
    import numpy as np

    from tf_eager_object_detection_tpu_torch.data.dataset_factory import dataset_factory
    from tf_eager_object_detection_tpu_torch.training.trainer import Trainer

    det = build_detector(spec)
    trainer = Trainer(det, spec["train_dir"], logging_every_n_steps=1, summary_every_n_steps=1,
                      saving_every_n_steps=spec["steps"], seed=spec.get("seed", 0),
                      data_parallel=True)
    trainer.train(dataset_factory("pascal", "train", _data_cfg(spec)), 1, spec["steps"])
    params = {n: digest(p) for n, p in det.named_parameters()}
    traces = {n: digest(t) for n, t in trainer.optimizer.trace.items()}
    fresh = build_detector(dict(spec, seed=spec.get("seed", 0) + 7))
    restored = Trainer(fresh, spec["train_dir"], logging_every_n_steps=1000, seed=5,
                       data_parallel=True)
    out = {"count": trainer.optimizer.count, "restored_count": restored.optimizer.count,
           "n_traces": len(traces),
           "restored_equal": params == {n: digest(p) for n, p in fresh.named_parameters()}
           and traces == {n: digest(t) for n, t in restored.optimizer.trace.items()}}
    out.update({"digest/" + n: d for n, d in params.items()})
    restored.close()
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **out)


def _indivisible(spec, rank, world):
    import numpy as np

    from tf_eager_object_detection_tpu_torch.training.trainer import Trainer

    trainer = Trainer(build_detector(spec), spec["train_dir"], logging_every_n_steps=1,
                      data_parallel=True)
    batch, _ = load_inputs(spec["inputs"])
    trainer.train_one_epoch(iter([{k: np.asarray(v)[:3] for k, v in zip(BATCH_KEYS, batch)}]), 1)


def _hook_rows(det, names):
    """Forward pre-hooks recording the rows of each named layer's input."""
    seen = {}
    modules = dict(det.named_modules())
    for name in names:
        modules[name].register_forward_pre_hook(
            lambda mod, args, name=name: seen.setdefault(name, []).append(int(args[0].shape[-2])))
    return seen


def _spatial_step(case, groups, rank):
    from tf_eager_object_detection_tpu_torch.parallel.spatial import make_spatial_train_step
    from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer

    batch, draws = load_inputs(case["inputs"])
    det = build_detector(case)
    opt = make_optimizer(det.cfg, det)
    step = make_spatial_train_step(det, opt, groups)
    seen = _hook_rows(det, case.get("hooks", ()))
    groups.traffic = []
    t0 = time.perf_counter()
    metrics = step(batch, draws)
    out = {"seconds": time.perf_counter() - t0}
    traffic, groups.traffic = groups.traffic, None
    for kind in ("halo", "gather"):
        out[f"bytes/{kind}"] = sum(n for k, _, n in traffic if k == kind)
    out.update({"metric/" + k: float(v) for k, v in metrics.items()})
    out.update({"seen/" + k: v for k, v in seen.items()})
    params = {n: p.detach().clone() for n, p in det.named_parameters()}
    out.update({"digest/" + n: digest(p) for n, p in params.items()})
    if case.get("save_params") and rank == 0:
        out.update({"param/" + n: p.numpy() for n, p in params.items()})
    del det, opt, step
    if rank == case.get("reference_rank", 0):
        out.update(_against_single(case, batch, draws, params))
    return out


def _single_step(case, batch, draws):
    """(metrics, parameters before, after) of the port's single-process step."""
    from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
    from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step

    det = build_detector(case)
    before = {n: p.detach().clone() for n, p in det.named_parameters()}
    metrics = make_train_step(det, make_optimizer(det.cfg, det))(batch, draws)
    return ({k: float(v) for k, v in metrics.items()}, before,
            {n: p.detach().clone() for n, p in det.named_parameters()})


def _against_single(case, batch, draws, params):
    """The spatial step's updated `params` against the single-process step
    at the global batch on the same weights and draws: that step's metrics,
    each tensor's largest difference relative to its largest value (`gap`),
    which tensors the step updates, and the difference of all the updates
    relative to their norm (`gap_norm`)."""
    import numpy as np

    metrics, before, want = _single_step(case, batch, draws)
    out = {"ref_metric/" + k: v for k, v in metrics.items()}
    names = sorted(want)
    out["names"] = np.asarray(names)
    out["gap"] = np.asarray([float((params[n] - want[n]).abs().max())
                             / (float(want[n].abs().max()) + 1e-8) for n in names])
    out["updated"] = np.asarray([not bool((want[n] == before[n]).all()) for n in names])
    update = sum(float((want[n] - before[n]).double().square().sum()) for n in names)
    out["gap_norm"] = (sum(float((params[n] - want[n]).double().square().sum())
                           for n in names) / update) ** 0.5
    return out


def _spatial_predict(case, groups, rank):
    import torch

    from tf_eager_object_detection_tpu_torch.parallel.spatial import make_spatial_predict

    batch, _ = load_inputs(case["inputs"])
    images, image_hw = batch[0], batch[1]
    det = build_detector(case)
    predict = make_spatial_predict(det, groups)
    out = {}
    for i in range(len(images)):
        got = predict(images[i], image_hw[i])
        out.update({f"got/{i}/{k}": torch.as_tensor(v).cpu().numpy()
                    for k, v in got._asdict().items()})
        if rank == case.get("reference_rank", 0):
            want = det.predict(images[i], image_hw[i])
            out.update({f"want/{i}/{k}": torch.as_tensor(v).cpu().numpy()
                        for k, v in want._asdict().items()})
    return out


def _spatial_trainer(case, groups, rank):
    import numpy as np

    from tf_eager_object_detection_tpu_torch.training.trainer import Trainer

    batch, _ = load_inputs(case["inputs"])
    arrays = dict(zip(BATCH_KEYS, batch))
    trainer = Trainer(build_detector(case), case["train_dir"], logging_every_n_steps=1,
                      summary_every_n_steps=1000, saving_every_n_steps=1000,
                      spatial_partition=groups.sp)
    trainer.train_one_epoch(iter([arrays, arrays]), steps=2)
    out = {"count": trainer.optimizer.count, "space": groups.sp, "batch": trainer.groups.dp}
    try:
        trainer.train_one_epoch(iter([{k: v[:1] for k, v in arrays.items()}]), steps=1)
        out["refused"] = ""
    except ValueError as exc:
        out["refused"] = str(exc)
    out["count_after"] = trainer.optimizer.count
    trainer.close()
    return out


SPATIAL_CASES = {"step": _spatial_step, "predict": _spatial_predict, "trainer": _spatial_trainer}


def _spatial(spec, rank, world):
    import numpy as np

    from tf_eager_object_detection_tpu_torch.parallel.spatial import make_spatial_groups

    groups = make_spatial_groups(spec["sp"], timeout_s=spec.get("timeout_s",
                                                                COLLECTIVE_TIMEOUT_S))
    out = {}
    for case in spec["cases"]:
        t0 = time.perf_counter()
        got = SPATIAL_CASES[case["kind"]](case, groups, rank)
        got["case_seconds"] = time.perf_counter() - t0
        out.update({f"{case['name']}/{k}": v for k, v in got.items()})
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **out)


MODES = {"step": _step, "trainer": _train_and_restore, "indivisible": _indivisible,
         "spatial": _spatial}


def main(spec_path: str, rank: int) -> None:
    import torch

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    from tf_eager_object_detection_tpu_torch.parallel import multihost

    world = spec["world"]
    multihost.initialize(init_method=spec["init_method"], num_processes=world, process_id=rank,
                         device="cpu", timeout_s=spec.get("timeout_s", COLLECTIVE_TIMEOUT_S))
    try:
        MODES[spec["mode"]](spec, rank, world)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
