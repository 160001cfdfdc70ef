"""Spatial partitioning of the port (`parallel/spatial.py`) over gloo ranks on the CPU.

Each image's rows are sharded over the ranks of a space group; the
extractor's row-mixing layers fetch their halo rows from the ranks that
own them, its outputs are gathered whole, and DDP over the whole world
averages the gradients (tests/test_torch_spatial_layers.py holds each
layer alone). The ranks are children of `tests/torch_ddp_worker.py` (a
fresh interpreter each, one thread, no JAX, a `file://` store, every
collective timing out after 120 s, killed at a deadline); one launch runs
several checks, and the parent meanwhile computes what it compares them
with.

Weights: numpy draws in JAX's layout for Faster R-CNN ResNet-50 (C4)
(`torch_shared.numpy_params`: lecun-normal kernels, random biases and
frozen-BatchNorm statistics), the RPN score layer x20 so that random-weight
proposals separate; VGG16 and FPN take the port's seeded init with random
biases and BatchNorm statistics drawn alike in the worker. With zero
biases (the stock init) an updated bias is its update alone, and a bias
gradient, a sum of terms that mostly cancel, moves by 2-3e-4 of its
largest value between two orders of summation: the single-process step at
1 and at 4 threads differs by that much, and so does the spatial step.

Tolerances (JAX's tests/test_spatial.py, plus a check of the update):

- C4 ResNet-50 and VGG16 at sp = 2, B = 1, with `tpu_remat` too, and a
  2 x 2 (dp x sp) step at B = 2, against the port's single-process step on
  the same weights and draws at the global batch: losses rtol 1e-4, counts
  equal, every updated parameter within 1e-4 of its largest value, and all
  the updates within 1e-4 of their norm; FPN ResNet-50 at 128x128, sp = 2:
  2e-4, 1e-3 and 1e-3. Every trainable tensor is updated, the ranks'
  parameters are bit-equal, and the exchanges moved bytes.
- The same C4 step against JAX's `make_spatial_train_step` on a (1, 2) mesh
  of the suite's virtual CPU devices, with JAX's draws rebuilt for the port
  (tests/test_torch_faster_rcnn_train.py): losses rtol 1e-4, counts equal,
  each trainable tensor's update within GRAD_TOL = 2e-3 of its largest
  value (the first momentum step's update is lr times the gradient plus
  the weight decay, and 2e-3 is the port-vs-JAX gradient tolerance of that
  file).
- The extractor is partitioned: a forward pre-hook on the first conv and
  on a conv4 conv sees this rank's rows of its level, never the whole map.
- Predict: the spatial `predict` against the per-image `predict` on the
  same rank: validity and labels equal, boxes rtol 1e-4 / atol 1e-3,
  scores rtol 1e-4 / atol 1e-5.
- `Trainer(spatial_partition=2)` over 4 ranks runs dp = 2 for 2 steps with
  finite losses, and a batch of one image is refused on every rank
  ("not divisible"), before any collective.
- `infer --spatial_partition 2` on two ranks (torchrun's environment, a
  free `tcp://127.0.0.1` port, retried once) prints the plain run's lines.
"""

import os
import re
import shutil
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from jax.sharding import NamedSharding, PartitionSpec as P

from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu.parallel.mesh import replicate as jax_replicate
from tf_eager_object_detection_tpu.parallel.spatial import (
    make_spatial_mesh,
    make_spatial_train_step as jax_spatial_train_step,
    shard_batch as jax_shard_batch,
)
from tf_eager_object_detection_tpu.training.optimizer import make_optimizer as jax_optimizer
from tf_eager_object_detection_tpu.training.train_step import TrainState
from tf_eager_object_detection_tpu_torch.config.config_factory import (
    apply_config_overrides,
    config_factory,
)
from tf_eager_object_detection_tpu_torch.models.heads import reshuffle_frcnn_scores
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops.sampling import TrainDraws
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import parameter_tree_from_jax
from tf_eager_object_detection_tpu_torch.training.checkpoints import save_params
from test_torch_cli import TINY
from test_torch_faster_rcnn_train import KEY, POST_NMS, PRE_NMS, ROI_SAMPLES
from test_torch_faster_rcnn_train import _batch as c4_batch
from test_torch_faster_rcnn_train import _config as c4_config
from test_torch_faster_rcnn_train import jax_draws
from torch_ddp_worker import (
    run_processes,
    save_inputs,
    start_processes,
    start_ranks,
    wait_processes,
)
from torch_shared import numpy_params, shared

PKG = "tf_eager_object_detection_tpu_torch.scripts"
TIMEOUT_S = 400.0
WEIGHT_SEED = 3
# C4's numpy draws: at this seed the RPN scores separate at the pre-NMS cut
# (1.3e-2; 7.6e-5 at seed 3), so that JAX and the port keep the same proposals
C4_SEED = 1
RPN_SCORE_SCALE = 20.0
GRAD_TOL = 2e-3
C4_HOOKS = ("extractor.conv1_conv", "extractor.conv4_block1_2_conv")
# (losses rtol, each updated parameter, the updates' norm), as JAX's tests
TOLS = {"c4": (1e-4, 1e-4, 1e-4), "c4_remat": (1e-4, 1e-4, 1e-4),
        "vgg16": (1e-4, 1e-4, 1e-4), "fpn": (2e-4, 1e-3, 1e-3), "c4_2x2": (1e-4, 1e-4, 1e-4)}


def _fpn_config():
    cfg = dict(config_factory("pascal", "fpn"))
    cfg.update(rpn_proposal_train_pre_nms_sample_number=PRE_NMS,
               rpn_proposal_train_after_nms_sample_number=POST_NMS,
               rpn_total_sample_number=64, rpn_pos_sample_max_number=32,
               roi_total_sample_number=ROI_SAMPLES, roi_pos_sample_max_number=8,
               tpu_image_buckets=[[128, 128]], image_min_size=128, image_max_size=128,
               tpu_max_gt_boxes=8)
    return cfg


def _c4_weights(tmp_path_factory):
    """Path of the C4 weights (JAX layout, numpy draws, RPN score layer x20),
    written once per session."""
    def make():
        jdet = jax_factory("faster_rcnn", "resnet50", c4_config())
        flat = numpy_params(jdet, C4_SEED)
        flat["rpn_head/rpn_score_conv/kernel"] *= RPN_SCORE_SCALE
        path = str(tmp_path_factory.mktemp("spatial_weights") / "c4.npz")
        np.savez(path, **flat)
        return path

    return shared(tmp_path_factory, "torch_spatial_c4_weights", make)


def _c4_case(name, weights, inputs, **extra):
    return dict(name=name, kind="step", model_type="faster_rcnn", backbone="resnet50",
                cfg=c4_config(), weights=weights, inputs=inputs, **extra)


def _jax_spatial_step(weights, batch):
    """JAX's spatial train step on a (1, 2) mesh from the same weights ->
    (metrics, the updated parameters under the port's names)."""
    cfg = c4_config()
    flat = dict(np.load(weights))
    jdet = jax_factory("faster_rcnn", "resnet50", cfg)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))
    opt = jax_optimizer(cfg, params, "resnet50", "faster_rcnn")
    mesh = make_spatial_mesh(dp=1, sp=2)
    step = jax_spatial_train_step(jdet, opt, mesh)
    state = jax_replicate(TrainState(params, opt.init(params), jnp.zeros((), jnp.int32)), mesh)
    key = jax.device_put(jax.random.PRNGKey(KEY), NamedSharding(mesh, P()))
    state, metrics = step(state, jax_shard_batch(tuple(jnp.asarray(a) for a in batch), mesh),
                          key)
    new = {k: np.asarray(v) for k, v in flatten_dict(state.params, sep="/").items()}
    return ({k: float(v) for k, v in metrics.items()},
            {n: t.numpy() for n, t in parameter_tree_from_jax(new).items()},
            {n: t.numpy() for n, t in parameter_tree_from_jax(flat).items()})


def _premise(weights, batch):
    """The RPN foreground probabilities of the valid anchors, sorted, of the
    port's C4 on `weights` (the proposals separate at the pre-NMS cut)."""
    det = model_factory("faster_rcnn", "resnet50", c4_config(), device="cpu")
    from tf_eager_object_detection_tpu_torch.training.checkpoints import load_params

    load_params(weights, det)
    with torch.no_grad():
        _, score_map, _ = det._backbone_rpn(torch.from_numpy(batch[0]))
    h, w = (int(d) for d in batch[1][0])
    probs = reshuffle_frcnn_scores(score_map, det.num_anchors)[0].reshape(8, 8, -1)
    return np.sort(probs[:-(-h // 16), :-(-w // 16)].reshape(-1).numpy())[::-1]


def _ranks(tmp, world):
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(world)]


def _step_summary(ranks, name, reference_rank):
    """A step case's results: the reference rank's, the metrics averaged
    over the ranks (a rank's are its batch group's, the same on the sp
    ranks of a group: the mean over all ranks is the mean over the groups,
    the global batch's)."""
    ref = ranks[reference_rank]
    digests = [{k: str(v) for k, v in r.items() if k.startswith(f"{name}/digest/")}
               for r in ranks]
    out = {k[len(name) + 1:]: ref[k] for k in ref if k.startswith(name + "/")
           and not k.startswith((f"{name}/digest/", f"{name}/param/"))}
    for k in [k for k in out if k.startswith("metric/")]:
        out[k] = float(np.mean([float(r[f"{name}/{k}"]) for r in ranks]))
    out["ranks_equal"] = bool(digests[0]) and all(d == digests[0] for d in digests)
    out["seen_all"] = {k.split("/", 2)[2]: [int(r[k][0]) for r in ranks]
                       for k in ref if k.startswith(f"{name}/seen/")}
    return out


def _sp2_run(tmp, weights):
    """Two ranks, sp = 2: C4, C4 with remat, VGG16 and FPN steps, and the
    spatial predict; meanwhile the parent runs JAX's spatial step."""
    tmp = str(tmp)
    batch1 = c4_batch(1)
    a = 8 * 8 * 9
    save_inputs(os.path.join(tmp, "c4.npz"), batch1,
                jax_draws(jax.random.PRNGKey(KEY), 1, a, POST_NMS, ROI_SAMPLES))
    vgg_cfg = c4_config()
    keep = vgg_cfg["roi_head_keep_dropout_rate"]
    gen = torch.Generator().manual_seed(7)
    save_inputs(os.path.join(tmp, "vgg16.npz"), (batch1[0] * 50.0,) + tuple(batch1[1:]),
                TrainDraws.sample(gen, 1, a, POST_NMS, ROI_SAMPLES, (keep, 4096)))
    fpn_cfg = _fpn_config()
    fpn = model_factory("fpn", "resnet50", fpn_cfg, device="cpu")
    save_inputs(os.path.join(tmp, "fpn.npz"), batch1, fpn.sample_draws(gen, 1, (128, 128)))
    del fpn
    save_inputs(os.path.join(tmp, "predict.npz"), c4_batch(2),
                TrainDraws.sample(gen, 2, a, POST_NMS, ROI_SAMPLES))
    inputs = {k: os.path.join(tmp, f"{k}.npz") for k in ("c4", "vgg16", "fpn", "predict")}
    remat_cfg = dict(c4_config(), tpu_remat=True)
    cases = [
        _c4_case("c4", weights, inputs["c4"], hooks=C4_HOOKS, save_params=True,
                 reference_rank=0),
        dict(_c4_case("c4_remat", weights, inputs["c4"], reference_rank=1), cfg=remat_cfg),
        dict(name="vgg16", kind="step", model_type="faster_rcnn", backbone="vgg16", cfg=vgg_cfg,
             random_biases=WEIGHT_SEED, rpn_score_scale=RPN_SCORE_SCALE, inputs=inputs["vgg16"],
             hooks=("extractor.block1_conv1", "extractor.block4_conv1"), reference_rank=1),
        dict(name="fpn", kind="step", model_type="fpn", backbone="resnet50", cfg=fpn_cfg,
             random_biases=WEIGHT_SEED, rpn_score_scale=RPN_SCORE_SCALE, inputs=inputs["fpn"],
             reference_rank=0),
        dict(_c4_case("predict", weights, inputs["predict"], reference_rank=0), kind="predict",
             cfg=dict(c4_config(), rpn_proposal_test_pre_nms_sample_number=PRE_NMS,
                      rpn_proposal_test_after_nms_sample_number=POST_NMS)),
    ]
    handle = start_ranks(dict(mode="spatial", sp=2, cases=cases), tmp, world=2,
                         timeout_s=TIMEOUT_S)
    try:
        jax_metrics, jax_params, start = _jax_spatial_step(weights, batch1)
        premise = _premise(weights, batch1)
    finally:
        wait_processes(handle)
    ranks = _ranks(tmp, 2)
    out = {name: _step_summary(ranks, name, case["reference_rank"])
           for name, case in ((c["name"], c) for c in cases) if case["kind"] == "step"}
    port = {k[len("c4/param/"):]: v for k, v in ranks[0].items() if k.startswith("c4/param/")}
    out["jax"] = {"metrics": jax_metrics, "premise": premise, "update_gap": {
        n: float(np.abs((port[n] - start[n]) - (w - start[n])).max())
        / max(float(np.abs(w - start[n]).max()), 1e-30)
        for n, w in jax_params.items() if not np.array_equal(w, start[n])}}
    out["predict"] = {k[len("predict/"):]: v for k, v in ranks[0].items()
                      if k.startswith(("predict/got/", "predict/want/"))}
    shutil.rmtree(tmp)
    return out


@pytest.fixture(scope="module")
def sp2(tmp_path_factory):
    weights = _c4_weights(tmp_path_factory)
    return shared(tmp_path_factory, "torch_spatial_sp2",
                  lambda: _sp2_run(tmp_path_factory.mktemp("spatial_sp2"), weights))


def _dp2x2_run(tmp, weights):
    """Four ranks, dp = 2 x sp = 2: a C4 step at B = 2, then the Trainer."""
    tmp = str(tmp)
    batch2 = c4_batch(2)
    save_inputs(os.path.join(tmp, "c4.npz"), batch2,
                jax_draws(jax.random.PRNGKey(KEY), 2, 8 * 8 * 9, POST_NMS, ROI_SAMPLES))
    cases = [_c4_case("c4_2x2", weights, os.path.join(tmp, "c4.npz"), reference_rank=0),
             dict(_c4_case("trainer", weights, os.path.join(tmp, "c4.npz")), kind="trainer",
                  train_dir=os.path.join(tmp, "logs"))]
    results = wait_processes(start_ranks(dict(mode="spatial", sp=2, cases=cases), tmp, world=4,
                                         timeout_s=TIMEOUT_S))
    ranks = _ranks(tmp, 4)
    out = _step_summary(ranks, "c4_2x2", 0)
    out["trainer"] = [{k[len("trainer/"):]: (v.item() if v.ndim == 0 else v) for k, v in r.items()
                       if k.startswith("trainer/")} for r in ranks]
    out["outputs"] = [o for _, o in results]
    shutil.rmtree(tmp)
    return out


@pytest.fixture(scope="module")
def dp2x2(tmp_path_factory):
    weights = _c4_weights(tmp_path_factory)
    return shared(tmp_path_factory, "torch_spatial_dp2x2",
                  lambda: _dp2x2_run(tmp_path_factory.mktemp("spatial_dp2x2"), weights))


def _assert_step_matches_single(got, name):
    rtol, param_tol, norm_tol = TOLS[name]
    assert got["ranks_equal"], name
    for k in [k for k in got if k.startswith("ref_metric/")]:
        metric = k.split("/", 1)[1]
        if metric.startswith("num_"):
            assert float(got["metric/" + metric]) == float(got[k]), (name, metric)
        else:
            np.testing.assert_allclose(float(got["metric/" + metric]), float(got[k]), rtol=rtol,
                                       err_msg=f"{name} {metric}")
    assert float(got["ref_metric/num_rpn_fg"]) > 0 and float(got["ref_metric/total_loss"]) > 0
    worst = int(np.argmax(got["gap"]))
    assert got["gap"][worst] <= param_tol, (name, str(got["names"][worst]), got["gap"][worst])
    assert float(got["gap_norm"]) <= norm_tol, (name, float(got["gap_norm"]))
    # every trainable tensor moved, as in the single step
    assert got["updated"].sum() > 0
    assert got["bytes/halo"] > 0 and got["bytes/gather"] > 0


@pytest.mark.parametrize("name", ["c4", "c4_remat", "vgg16", "fpn"])
def test_spatial_step_matches_single_process(sp2, name):
    _assert_step_matches_single(sp2[name], name)


def test_spatial_dp_step_matches_single_process(dp2x2):
    _assert_step_matches_single(dp2x2, "c4_2x2")


def test_spatial_step_matches_jax_spatial_step(sp2):
    """The port's C4 step at sp = 2 against JAX's on a (1, 2) mesh."""
    got, ref = sp2["c4"], sp2["jax"]
    p = ref["premise"]  # the proposals separate at the pre-NMS cut in both frameworks
    assert p[PRE_NMS - 1] - p[PRE_NMS] > 1e-4
    for k, v in ref["metrics"].items():
        if k.startswith("num_"):
            assert float(got["metric/" + k]) == v, k
        else:
            np.testing.assert_allclose(float(got["metric/" + k]), v, rtol=1e-4, err_msg=k)
    gaps = ref["update_gap"]
    assert len(gaps) == int(got["updated"].sum())
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_TOL, (worst, gaps[worst])


def test_extractor_sees_only_its_rows(sp2):
    """No rank runs the extractor on the whole image: the first conv sees
    64 of the 128 image rows on each rank, conv4's first 3x3 conv 4 of the
    8 rows of its level (the halo rows are fetched inside the layer)."""
    for case, levels in (("c4", {C4_HOOKS[0]: 128, C4_HOOKS[1]: 8}),
                         ("vgg16", {"extractor.block1_conv1": 128,
                                    "extractor.block4_conv1": 16})):
        seen = sp2[case]["seen_all"]
        assert set(seen) == set(levels), (case, seen)
        for layer, height in levels.items():
            assert seen[layer] == [height // 2, height // 2], (case, layer, seen[layer])


def test_spatial_predict_matches_per_image_predict(sp2):
    got = sp2["predict"]
    for i in range(2):
        g = {k: got[f"got/{i}/{k}"] for k in ("boxes", "scores", "labels", "valid")}
        w = {k: got[f"want/{i}/{k}"] for k in ("boxes", "scores", "labels", "valid")}
        np.testing.assert_array_equal(g["valid"], w["valid"])
        v = w["valid"]
        assert v.any()
        np.testing.assert_array_equal(g["labels"][v], w["labels"][v])
        np.testing.assert_allclose(g["boxes"][v], w["boxes"][v], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(g["scores"][v], w["scores"][v], rtol=1e-4, atol=1e-5)


def test_trainer_spatial_partition_trains_and_refuses_an_indivisible_batch(dp2x2):
    for r in dp2x2["trainer"]:
        assert (r["space"], r["batch"], r["count"], r["count_after"]) == (2, 2, 2, 2), r
        assert "not divisible" in str(r["refused"]), r
    rank0 = dp2x2["outputs"][0]
    steps = [line for line in rank0.splitlines() if line.startswith("step ")]
    assert len(steps) == 2
    losses = [float(tok.split("=")[1]) for line in steps for tok in line.split()
              if tok.startswith("total_loss=")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    for out in dp2x2["outputs"][1:]:
        assert not [line for line in out.splitlines() if line.startswith("step ")]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _infer_run(tmp):
    """`infer` plain and `infer --spatial_partition 2` on two ranks."""
    from PIL import Image

    cfg = apply_config_overrides(dict(config_factory("pascal", "faster_rcnn")), TINY)
    det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu", seed=3)
    with torch.no_grad():  # class scores of random weights spread
        det.roi_head.roi_head_score.weight.mul_(10.0)
    save_params(str(tmp / "params.npz"), det)
    rng = np.random.RandomState(5)
    img = rng.randint(0, 60, (96, 120, 3), np.uint8)
    img[8:70, 10:90] = [210, 40, 40]
    Image.fromarray(img).save(tmp / "img.png")  # png: lossless, identical reload
    cmd = [sys.executable, "-m", f"{PKG}.infer", str(tmp / "params.npz"), str(tmp / "img.png"),
           "--score_threshold", "0.0", "--device", "cpu"]
    for ov in TINY:
        cmd += ["--config_override", ov]
    plain = run_processes([cmd], str(tmp / "plain"), TIMEOUT_S)[0][1]
    for attempt in range(2):
        port = str(_free_port())
        envs = [dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=port) for r in range(2)]
        try:
            spatial = wait_processes(start_processes([cmd + ["--spatial_partition", "2"]] * 2,
                                                     str(tmp / f"sp{attempt}"), TIMEOUT_S, envs))
            break
        except AssertionError as exc:
            if attempt or "EADDRINUSE" not in str(exc) and "already in use" not in str(exc):
                raise
    return plain, [out for _, out in spatial]


def test_infer_spatial_partition_prints_the_plain_lines(tmp_path):
    plain, (rank0, rank1) = _infer_run(tmp_path)

    def lines(out):  # "<class name> <score>  [x1, y1, x2, y2]"
        return [line for line in out.splitlines() if re.match(r"^ *\S+ \d\.\d{3}  \[", line)]

    assert lines(plain) and lines(rank0) == lines(plain), (plain[-2000:], rank0[-2000:])
    assert not lines(rank1)
