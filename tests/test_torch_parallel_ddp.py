"""The port's data-parallel train step in two processes against one process, on the CPU.

Two gloo ranks (`tests/torch_ddp_worker.py`, a `file://` store, one
thread each, collectives time out after 120 s, the parent kills both
after 300 s) each take b = 1 image of a global batch of 2 and the global
batch's draws, and step once through `parallel/mesh.py::
make_parallel_train_step`; the parent takes the port's single step at
B = 2 on the same weights (`model_factory` at seed 0, the RPN score layer
scaled by 20 so that random-weight proposals separate), batch and draws:

- `vgg16_remat`: Faster R-CNN VGG16 at JAX's `_small_cfg` of
  tests/test_parallel.py (a 64x64 bucket, 4 gt slots) with anchor scales
  (2, 4, 8), so that anchors fit inside the image; its draws carry the
  RoI head's dropout masks, so the masks' rows are sliced too; with
  `tpu_remat`, whose extractor recomputes its activations in the backward
  (`checkpoint(..., use_reentrant=False)`) under DDP's hooks;
- `fpn`: FPN ResNet-50 at a 128x128 bucket and small counts (the plain
  versions of K4 and K5: the CPU kernels of the `tf_eager_od` operators).
The trainer and command-line tests (tests/test_torch_parallel_trainer.py)
train Faster R-CNN ResNet-50 (C4) over two ranks.

Held, on one thread in the parent as in the ranks (the CPU's convolutions
sum in an order that depends on the batch size and the thread count):

- the losses (the mean of the ranks' metrics) rtol 1e-5, counts too;
- the momentum traces bit-equal to those of one step on the mean of the
  two images' own gradients, computed in the parent at B = 1 each: the
  all-reduce is exactly that mean (observed: 0.0 on every tensor);
- the traces within 1e-4 of each tensor's largest value of the B = 2
  step's, or where the CPU's B = 2 convolutions already differ from the
  two B = 1 ones by more (`spread`, measured in the parent), within that
  spread: observed worst 8.4e-6 (VGG16's block5_conv3), 1.8e-6 (FPN's
  build_p2) and 2.1e-4 for C4 (`roi_head.conv5_block1_0_conv.bias`; its
  conv5 head runs on B * S RoI crops at once, 64 against 32 a rank);
- every parameter within 1e-5 absolute (JAX tests/test_parallel.py's
  bound; observed worst 3.0e-8); the two ranks' parameters bit-equal; the
  frozen parameters (VGG16's blocks 1-2; FPN freezes none) bit-equal to
  the start.

Against JAX: the same VGG16 DP-2 step (the port's seeded weights carried
into JAX by the bridge, JAX's draws rebuilt from its key, as in
tests/test_torch_faster_rcnn_train.py and tests/test_torch_vgg16.py)
against JAX `make_parallel_train_step` over `make_mesh(2)` at B = 2, with
tests/test_torch_faster_rcnn_train.py's tolerances: losses rtol 1e-4,
counts exact, traces within GRAD_TOL = 2e-3 of each tensor's largest
value, parameters atol 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu.parallel.mesh import (
    make_mesh,
    make_parallel_train_step as jax_parallel_step,
    replicate,
    shard_batch,
)
from tf_eager_object_detection_tpu.training.optimizer import make_optimizer as jax_optimizer
from tf_eager_object_detection_tpu.training.train_step import TrainState
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    flat_params_from_state_dict,
    parameter_tree_from_jax,
)
from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step
from test_torch_faster_rcnn_train import jax_draws
from test_torch_vgg16 import jax_dropout_keep
from torch_ddp_worker import build_detector, run_ranks, save_inputs
from torch_shared import shared

LOSS_RTOL = 1e-5
TRACE_TOL = 1e-4
HALVES_TOL = 0.0  # bit-equal
PARAM_ATOL = 1e-5
GRAD_TOL = 2e-3
KEY = 7
B = 2
JAX_CASE = "vgg16_remat"


def _small_cfg(**extra):
    """JAX tests/test_parallel.py::_small_cfg, anchor scales (2, 4, 8)."""
    cfg = dict(config_factory("pascal", "faster_rcnn"))
    cfg.update(
        rpn_proposal_train_pre_nms_sample_number=256,
        rpn_proposal_train_after_nms_sample_number=64,
        roi_total_sample_number=32,
        roi_pos_sample_max_number=8,
        rpn_total_sample_number=64,
        rpn_pos_sample_max_number=32,
        tpu_image_buckets=[[64, 64]],
        tpu_max_gt_boxes=4,
        scales=[2, 4, 8],
        **extra,
    )
    return cfg


def _fpn_cfg():
    cfg = dict(config_factory("pascal", "fpn"))
    cfg.update(
        rpn_proposal_train_pre_nms_sample_number=512,
        rpn_proposal_train_after_nms_sample_number=64,
        rpn_total_sample_number=64,
        rpn_pos_sample_max_number=32,
        roi_total_sample_number=32,
        roi_pos_sample_max_number=8,
        tpu_image_buckets=[[128, 128]],
        tpu_max_gt_boxes=4,
    )
    return cfg


CASES = {
    "vgg16_remat": dict(model_type="faster_rcnn", backbone="vgg16",
                        cfg=_small_cfg(tpu_remat=True)),
    "fpn": dict(model_type="fpn", backbone="resnet50", cfg=_fpn_cfg()),
}


def _batch(cfg):
    """JAX tests/test_parallel.py::_batch at B = 2, scaled to the bucket."""
    h, w = cfg["tpu_image_buckets"][0]
    k = h / 64.0
    rng = np.random.RandomState(0)
    images = rng.randn(B, h, w, 3).astype(np.float32)
    hw = np.asarray([[h, w], [h, w - 8]], np.int32)
    gt = np.zeros((B, 4, 4), np.float32)
    gt[:, 0] = np.asarray([8.0, 8.0, 40.0, 44.0]) * k
    gt[:, 1] = np.asarray([20.0, 28.0, 60.0, 54.0]) * k
    mask = np.zeros((B, 4), bool)
    mask[:, :2] = True
    labels = np.zeros((B, 4), np.int32)
    labels[:, 0] = 3
    labels[:, 1] = 11
    return images, hw, gt, mask, labels


def _spec(name):
    return dict(CASES[name], mode="step", seed=0, rpn_score_scale=20.0)


def _jax_detector_and_draws(spec, det):
    """The JAX detector of a spec and JAX `loss_fn`'s draws under KEY at
    B = 2 (its samplers' numbers and, for VGG16, its dropout masks), with
    the port's weights carried over."""
    cfg = spec["cfg"]
    jdet = jax_factory(spec["model_type"], spec["backbone"], cfg)
    # copies: jnp.asarray may alias the numpy views of the port's tensors,
    # which the port's own step then updates in place
    params = jax.tree_util.tree_map(
        jnp.array, unflatten_dict(flat_params_from_state_dict(det.state_dict()), sep="/"))
    h, w = cfg["tpu_image_buckets"][0]
    a = det.sample_draws(torch.Generator(), 1, (h, w)).anchor_fg.shape[1]
    s = cfg["roi_total_sample_number"]
    key = jax.random.PRNGKey(KEY)
    draws = jax_draws(key, B, a, cfg["rpn_proposal_train_after_nms_sample_number"], s)
    if det.roi_dropout is not None:
        draws = draws._replace(dropout_keep=jax_dropout_keep(jdet, params["roi_head"], key, B, s))
    return jdet, params, draws


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _halves_trace(spec, batch, draws):
    """The momentum trace after one step on the mean of the two images'
    own gradients (each image's loss and backward at B = 1, in this
    process): what the two ranks compute, without processes."""
    det = build_detector(spec)
    opt = make_optimizer(spec["cfg"], det)
    opt.zero_grad()
    s = spec["cfg"]["roi_total_sample_number"]
    for r in range(B):
        total, _ = det.loss_fn(*(a[r:r + 1] for a in batch), draws.rows(r, r + 1, s))
        total.backward()
    for p in opt.params:
        if p.grad is not None:
            p.grad /= B
    opt.step()
    return {n: t.numpy() for n, t in opt.trace.items()}


def _run_case(name, tmp):
    """Two ranks and the single step of one case -> the reduced comparison,
    for JAX_CASE also against JAX. The parent's steps run on one thread, as
    the ranks do: the CPU's convolutions sum in an order that depends on
    the thread count too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _compare_case(name, tmp)
    finally:
        torch.set_num_threads(threads)


def _compare_case(name, tmp):
    spec = _spec(name)
    det = build_detector(spec)
    batch = _batch(spec["cfg"])
    if spec["model_type"] == "faster_rcnn":  # JAX's own draws: reused against JAX
        jdet, jparams, draws = _jax_detector_and_draws(spec, det)
    else:
        h, w = spec["cfg"]["tpu_image_buckets"][0]
        draws = det.sample_draws(torch.Generator().manual_seed(KEY), B, (h, w))
    inputs = os.path.join(tmp, "inputs.npz")
    save_inputs(inputs, batch, draws)
    run_ranks(dict(spec, inputs=inputs), tmp)
    before = {n: p.detach().clone() for n, p in det.named_parameters()}
    opt = make_optimizer(spec["cfg"], det)
    metrics = make_train_step(det, opt)(batch, draws)
    halves = _halves_trace(spec, batch, draws)
    ranks = [np.load(os.path.join(tmp, f"rank{r}.npz")) for r in range(2)]
    params = {n: p.detach().numpy() for n, p in det.named_parameters()}
    out = {
        "single": {k: float(v) for k, v in metrics.items()},
        "ranks": [{k[7:]: float(r[k]) for k in r.files if k.startswith("metric/")}
                  for r in ranks],
        "param_err": {n: float(np.abs(ranks[0]["param/" + n] - p).max())
                      for n, p in params.items()},
        "trace_err": {n: _rel(ranks[0]["trace/" + n], t.numpy()) for n, t in opt.trace.items()},
        "halves_err": {n: _rel(ranks[0]["trace/" + n], t) for n, t in halves.items()},
        "spread": {n: _rel(halves[n], t.numpy()) for n, t in opt.trace.items()},
        "trace_names": sorted(n[6:] for n in ranks[0].files if n.startswith("trace/")),
        "ranks_equal": {n: str(ranks[0]["digest/" + n]) == str(ranks[1]["digest/" + n])
                        for n in params},
        "frozen": sorted(n for n, p in det.named_parameters() if not p.requires_grad),
        "frozen_unchanged": [bool(r["frozen_unchanged"]) for r in ranks],
        "single_frozen_unchanged": all(torch.equal(before[n], p) for n, p in
                                       det.named_parameters() if not p.requires_grad),
        "seconds": [float(r["seconds"]) for r in ranks],
    }
    if name == JAX_CASE:
        out["jax"] = _against_jax(spec, jdet, jparams, ranks[0], out["trace_names"])
    for r in range(2):  # VGG16's rank 0 file is 1.1 GB: nothing is kept
        os.remove(os.path.join(tmp, f"rank{r}.npz"))
    return out


def _against_jax(spec, jdet, params, rank0, trace_names):
    """JAX `make_parallel_train_step` over `make_mesh(2)` at B = 2 from the
    port's starting weights (`params`) -> its metrics and, per tensor, rank
    0's parameter error (absolute) and trace error (relative to the
    tensor's largest value) against it."""
    cfg = spec["cfg"]
    opt = jax_optimizer(cfg, params, spec["backbone"], spec["model_type"])
    mesh = make_mesh(2)
    state = replicate(TrainState(params, opt.init(params), jnp.zeros((), jnp.int32)), mesh)
    rng = jax.device_put(jax.random.PRNGKey(KEY),
                         jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    batch = shard_batch(tuple(jnp.asarray(a) for a in _batch(cfg)), mesh)
    state, metrics = jax_parallel_step(jdet, opt, mesh)(state, batch, rng)
    want_params = parameter_tree_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(state.params, sep="/").items()})
    want_trace = parameter_tree_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(state.opt_state.trace, sep="/").items()})
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "param_err": {n: float(np.abs(rank0["param/" + n] - w.numpy()).max())
                      for n, w in want_params.items()},
        "trace_err": {n: _rel(rank0["trace/" + n], want_trace[n].numpy()) for n in trace_names},
    }


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    name = request.param

    def compute():
        return _run_case(name, str(tmp_path_factory.mktemp(f"ddp_{name}")))

    return name, shared(tmp_path_factory, f"torch_ddp_step_{name}", compute)


def test_losses_are_the_single_steps(case):
    _, got = case
    assert got["single"]["total_loss"] > 0 and got["single"]["num_proposals"] > 0
    for k, v in got["single"].items():
        mean = (got["ranks"][0][k] + got["ranks"][1][k]) / 2
        np.testing.assert_allclose(mean, v, rtol=LOSS_RTOL, atol=0, err_msg=k)


def test_traces_are_the_mean_of_the_ranks_gradients(case):
    """The all-reduce is the mean of the two images' own gradients."""
    _, got = case
    assert got["trace_names"] == sorted(got["halves_err"])
    worst = max(got["halves_err"].items(), key=lambda kv: kv[1])
    assert worst[1] <= HALVES_TOL, worst


def test_traces_and_parameters_are_the_single_steps(case):
    """Traces within TRACE_TOL of the B = 2 step's, or, where the CPU's
    B = 2 and B = 1 convolutions already differ by more (`spread`, measured
    in one process), within that difference and HALVES_TOL."""
    _, got = case
    assert got["trace_names"] == sorted(got["trace_err"])
    over = {n: (e, got["spread"][n]) for n, e in got["trace_err"].items()
            if e > max(TRACE_TOL, got["spread"][n] + HALVES_TOL)}
    assert not over, over
    worst = max(got["param_err"].items(), key=lambda kv: kv[1])
    assert worst[1] <= PARAM_ATOL, worst


def test_ranks_bit_equal_and_frozen_unchanged(case):
    name, got = case
    assert all(got["ranks_equal"].values()), [n for n, ok in got["ranks_equal"].items() if not ok]
    assert bool(got["frozen"]) == (CASES[name]["model_type"] == "faster_rcnn")  # FPN: none
    assert got["frozen_unchanged"] == [True, True]
    assert got["single_frozen_unchanged"]
    assert not set(got["frozen"]) & set(got["trace_names"])


def test_dp2_step_matches_jax_mesh(tmp_path_factory):
    """The port's VGG16 DP-2 step against JAX's over `make_mesh(2)`."""
    got = shared(tmp_path_factory, f"torch_ddp_step_{JAX_CASE}",
                 lambda: _run_case(JAX_CASE, str(tmp_path_factory.mktemp(f"ddp_{JAX_CASE}"))))
    ref = got["jax"]
    port = {k: (got["ranks"][0][k] + got["ranks"][1][k]) / 2 for k in got["ranks"][0]}
    assert set(port) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        if k.startswith("num_"):
            assert port[k] == v, k
        else:
            np.testing.assert_allclose(port[k], v, rtol=1e-4, err_msg=k)
    assert set(ref["param_err"]) == set(got["param_err"])
    worst = max(ref["param_err"].items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-6, worst
    worst = max(ref["trace_err"].items(), key=lambda kv: kv[1])
    assert worst[1] <= GRAD_TOL, worst
