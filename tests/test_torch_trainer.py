"""The port's `Trainer` against the JAX `Trainer`, on the CPU, and `prefetch`.

Both trainers train Faster R-CNN ResNet-50 (C4) for STEPS steps on the
same JPEG TFRecords (a procedural rehearsal tree written by the port's
`generate` and `create_pascal_tf_records`), each through its own
`dataset_factory("pascal", "train", ...)`, `prefetch`, `train` (checkpoint
at the end) and `close`. The config is cut as in
tests/test_torch_faster_rcnn_train.py: a 128x128 bucket (the 600x800
images resize to 96x128), anchor scales (2, 4, 8), small proposal and
sample counts, and the "tf" preprocessing (pixels in [-1, 1]: with caffe's
+-128 the random network's logits run into the hundreds and saturate the
RPN scores). Both start from one JAX `init_params` (the RPN score layer
scaled by 20 so that random-weight proposals separate at the pre-NMS cut,
which the test asserts at every step) carried into the port by the weight
bridge. The port gets the JAX trainer's draws through
its `draws(step)` hook: the key chain `PRNGKey(seed + 1)` split once a
step, then the C4 `loss_fn`'s `split(key, b + 1)[:b]` and the samplers'
own splits. Each trainer's step function is wrapped to record its metrics.

Tolerances (those of tests/test_torch_faster_rcnn_train.py where they
apply): losses rtol 1e-4, finite, and counts exact at every step; after
each step, the momentum traces within STEP_TOL of their tensor's largest
value and each parameter's change since the start (lr times the sum of the
traces) within STEP_TOL of its tensor's largest change; frozen parameters
unchanged, bit for bit. STEP_TOL is GRAD_TOL = 2e-3 after the first step,
as for one step there. A float32 gradient of a 50-layer network sums in
another order at every layer, and how far that moves it depends on the
input: the second step's image moves the traces by up to 5.5e-3 of their
largest value (observed), so after it the tolerance is 1e-2.
"""

import hashlib
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tf_eager_object_detection_tpu.data.dataset_factory import dataset_factory as jax_datasets
from tf_eager_object_detection_tpu.models.model_factory import model_factory as jax_factory
from tf_eager_object_detection_tpu.training.train_step import TrainState
from tf_eager_object_detection_tpu.training.trainer import Trainer as JaxTrainer
from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
from tf_eager_object_detection_tpu_torch.core.anchors import valid_anchor_mask
from tf_eager_object_detection_tpu_torch.data.dataset_factory import dataset_factory
from tf_eager_object_detection_tpu_torch.data.voc import create_pascal_tf_records
from tf_eager_object_detection_tpu_torch.models.heads import reshuffle_frcnn_scores
from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
from tf_eager_object_detection_tpu_torch.ops.sampling import TrainDraws
from tf_eager_object_detection_tpu_torch.ref_import.from_jax import (
    load_jax_params,
    parameter_tree_from_jax,
)
from tf_eager_object_detection_tpu_torch.scripts.voc_rehearsal import generate
from tf_eager_object_detection_tpu_torch.training.trainer import Trainer, prefetch

from torch_shared import shared

GRAD_TOL = 2e-3
# after step 1: GRAD_TOL (the gradients of one step); after step 2, whose
# gradients are those of other images: observed 5.5e-3 (trace of
# extractor.conv4_block2_3_conv.weight), held to 1e-2
STEP_TOL = {1: GRAD_TOL, 2: 1e-2}
RPN_SCORE_SCALE = 20.0
STEPS = 2
SEED = 5
PRE_NMS, POST_NMS, ROI_SAMPLES = 256, 64, 32


def tiny_config():
    cfg = dict(config_factory("pascal", "faster_rcnn"))
    cfg.update(
        scales=[2, 4, 8],
        rpn_proposal_train_pre_nms_sample_number=PRE_NMS,
        rpn_proposal_train_after_nms_sample_number=POST_NMS,
        rpn_total_sample_number=64,
        rpn_pos_sample_max_number=32,
        roi_total_sample_number=ROI_SAMPLES,
        roi_pos_sample_max_number=8,
        rpn_proposal_test_pre_nms_sample_number=100,
        rpn_proposal_test_after_nms_sample_number=20,
        tpu_image_buckets=[[128, 128]],
        image_min_size=128,
        image_max_size=128,
        tpu_max_gt_boxes=16,
    )
    return cfg


def jax_draws(key, b, a, r, s) -> TrainDraws:
    """The random numbers JAX Faster R-CNN `loss_fn` draws from `key` (as
    in tests/test_torch_faster_rcnn_train.py)."""
    out = []
    for rng_i in jax.random.split(key, b + 1)[:b]:
        r_at, r_pt = jax.random.split(rng_i)
        k_fg, k_bg = jax.random.split(r_at)
        p_fg, p_bg, p_wr = jax.random.split(r_pt, 3)
        out.append([jax.random.uniform(k_fg, (a,)), jax.random.uniform(k_bg, (a,)),
                    jax.random.uniform(p_fg, (r,)), jax.random.uniform(p_bg, (r,)),
                    jax.random.gumbel(p_wr, (s, r))])
    return TrainDraws(*(torch.from_numpy(np.stack([np.asarray(x) for x in f])) for f in zip(*out)))


def trainer_draws(seed, steps, num_anchors):
    """draws(step) of the JAX trainer's key chain: PRNGKey(seed + 1), split
    once a step."""
    rng, keys = jax.random.PRNGKey(seed + 1), []
    for _ in range(steps):
        rng, step_rng = jax.random.split(rng)
        keys.append(step_rng)
    a = (128 // 16) ** 2 * num_anchors
    return lambda step: jax_draws(keys[step - 1], 1, a, POST_NMS, ROI_SAMPLES)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("rehearsal")
    generate(str(root / "VOCdevkit" / "VOC2007"), n_train=4, n_test=20, seed=0)
    return create_pascal_tf_records(str(root / "VOCdevkit"), "2007", "trainval",
                                    str(root / "tfrecords"), num_shards=2)


def _data_cfg(cfg, records):
    return {"model_config": cfg, "tf_records_list": records, "batch_size": 1, "seed": SEED,
            "preprocessing_type": "tf"}


def _recording(step_fn, out, snapshot):
    """`step_fn` that also appends (metrics as floats, snapshot(result)) to
    `out` (the JAX step returns (state, metrics), the port's the metrics)."""
    def step(*args):
        result = step_fn(*args)
        metrics = result[-1] if isinstance(result, tuple) else result
        out.append(({k: float(v) for k, v in metrics.items()}, snapshot(result)))
        return result
    return step


def _jax_snapshot(result):
    """(params, momentum trace) of a JAX step's new state, as port-named arrays."""
    state = jax.device_get(result[0])
    flat = flatten_dict(state.params, sep="/")
    return ({k: v.numpy() for k, v in parameter_tree_from_jax(flat).items()},
            {k: v.numpy() for k, v in
             parameter_tree_from_jax(_find_trace(state.opt_state)).items()})


def _compare(want, got, init, frozen):
    """Per tensor, for the parameters (their change since `init`) and the
    traces: (largest |got - want|, largest |want|); per frozen parameter,
    whether it kept its bits."""
    (want_p, want_t), (got_p, got_t) = want, got
    assert got_p.keys() == want_p.keys() == init.keys()
    return {
        "params": {n: (float(np.abs(got_p[n] - want_p[n]).max()),
                       float(np.abs(want_p[n] - init[n]).max()))
                   for n in want_p if n not in frozen},
        "frozen": {n: bool(np.array_equal(got_p[n], init[n])) for n in frozen},
        "trace": {n: (float(np.abs(got_t[n] - want_t[n]).max()), float(np.abs(want_t[n]).max()))
                  for n in got_t},
        "trace_names": set(got_t) == set(got_p) - frozen,
    }


def _digest(t):
    return hashlib.sha256(t.detach().numpy().tobytes()).hexdigest()


def _run_both(records, logs_root):
    """Both trainers' metrics, and after each step the comparison of their
    parameters and traces (`_compare`)."""
    cfg = tiny_config()
    jdet = jax_factory("faster_rcnn", "resnet50", cfg)
    jtrainer = JaxTrainer(jdet, os.path.join(logs_root, "jax"), logging_every_n_steps=1,
                          summary_every_n_steps=1000, saving_every_n_steps=1000, seed=SEED)
    flat = {k: np.array(v) for k, v in flatten_dict(jax.device_get(jtrainer.state.params),
                                                    sep="/").items()}
    flat["rpn_head/rpn_score_conv/kernel"] *= RPN_SCORE_SCALE
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_dict(flat, sep="/"))
    jtrainer.state = TrainState(params, jtrainer.optimizer.init(params), jnp.zeros((), jnp.int32))
    jax_steps = []
    jtrainer.step_fn = _recording(jtrainer.step_fn, jax_steps, _jax_snapshot)
    jtrainer.train(jax_datasets("pascal", "train", _data_cfg(cfg, records)), 1, STEPS)
    shutil.rmtree(os.path.join(logs_root, "jax"))  # its checkpoint (~200 MB) is not read

    det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu")
    logs = os.path.join(logs_root, "port")
    trainer = Trainer(det, logs, logging_every_n_steps=1, summary_every_n_steps=1000,
                      saving_every_n_steps=1000, seed=SEED,
                      draws=trainer_draws(SEED, STEPS, det.num_anchors))
    load_jax_params(trainer.det, flat)
    port_steps, margins = [], []
    recording = _recording(trainer.step_fn, port_steps, lambda _: (
        {n: p.detach().numpy().copy() for n, p in det.named_parameters()},
        {n: t.numpy().copy() for n, t in trainer.optimizer.trace.items()}))

    def step_fn(batch, draws):
        margins.append(pre_nms_margin(det, *batch[:2]))
        return recording(batch, draws)

    trainer.step_fn = step_fn
    trainer.train(dataset_factory("pascal", "train", _data_cfg(cfg, records)), 1, STEPS)

    init = {k: v.numpy() for k, v in parameter_tree_from_jax(flat).items()}
    frozen = {n for n, p in det.named_parameters() if not p.requires_grad}
    return dict(
        jax_metrics=[m for m, _ in jax_steps], port_metrics=[m for m, _ in port_steps],
        compared=[_compare(j, p, init, frozen) for (_, j), (_, p) in zip(jax_steps, port_steps)],
        jax_step=int(jax.device_get(jtrainer.state.step)), port_step=trainer.step,
        margins=margins, logs=logs,
        final={n: _digest(p) for n, p in det.named_parameters()},
    )


def run_both(records, tmp_path_factory):
    """`_run_both` once for the test session."""
    return shared(tmp_path_factory, "torch_trainer_run",
                  lambda: _run_both(records, str(tmp_path_factory.mktemp("trainer_logs"))))


@torch.no_grad()
def pre_nms_margin(det, images, image_hw):
    """The gap between the RPN foreground probabilities ranked PRE_NMS and
    PRE_NMS + 1 among the valid anchors of a one-image batch."""
    _, score_map, _ = det._backbone_rpn(images)
    probs = reshuffle_frcnn_scores(score_map, det.num_anchors)
    cells = -(-image_hw.long() // 16)
    valid = valid_anchor_mask(8, 8, det.num_anchors, cells[:, 0], cells[:, 1])
    p = torch.sort(probs[valid], descending=True).values
    return float(p[PRE_NMS - 1] - p[PRE_NMS])


def _find_trace(opt_state):
    """The momentum trace inside an optax state (its `trace` field)."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "trace")):
        if hasattr(leaf, "trace"):
            return {k: np.asarray(v) for k, v in flatten_dict(leaf.trace, sep="/").items()}
    raise AssertionError("no momentum trace in the JAX optimizer state")


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_losses_and_counts_match_jax_trainer(records, tmp_path_factory, step):
    run = run_both(records, tmp_path_factory)
    assert len(run["jax_metrics"]) == len(run["port_metrics"]) == STEPS
    ref, got = run["jax_metrics"][step - 1], run["port_metrics"][step - 1]
    assert set(got) == set(ref)
    assert all(np.isfinite(v) for v in ref.values()), ref
    for k, v in ref.items():
        if k.startswith("num_"):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    assert ref["num_rpn_fg"] > 0 and ref["num_roi_fg"] > 0
    assert run["margins"][step - 1] > 1e-4  # the premise: the pre-NMS cut separates


@pytest.mark.parametrize("step", range(1, STEPS + 1))
def test_params_and_momentum_after_each_step_match_jax_trainer(records, tmp_path_factory, step):
    run = run_both(records, tmp_path_factory)
    assert run["port_step"] == run["jax_step"] == STEPS
    tol = STEP_TOL[step]
    compared = run["compared"][step - 1]
    assert compared["trace_names"]
    assert compared["frozen"] and all(compared["frozen"].values())
    for kind in ("params", "trace"):
        bad = {n: (d, m) for n, (d, m) in compared[kind].items() if d > tol * m}
        assert not bad, f"{kind} beyond {tol} of their tensor's largest value: {bad}"


def test_trainer_writes_checkpoint_log_and_metrics(records, tmp_path_factory, capsys):
    """The end-of-epoch checkpoint and the event file, a restore by a fresh
    trainer, and the `step n lr=...` log line of the JAX trainer's format."""
    run = run_both(records, tmp_path_factory)
    files = sorted(os.listdir(run["logs"]))
    assert f"ckpt_{STEPS:08d}.pt" in files
    assert any(f.startswith("events.out.tfevents.") for f in files)
    det = model_factory("faster_rcnn", "resnet50", tiny_config(), device="cpu")
    trainer = Trainer(det, run["logs"], logging_every_n_steps=1, seed=SEED)
    try:
        assert trainer.step == STEPS  # restored from the directory
        for name, p in det.named_parameters():
            assert _digest(p) == run["final"][name], name
        capsys.readouterr()
        batches = dataset_factory("pascal", "train", _data_cfg(tiny_config(), records))
        trainer.train_one_epoch(batches, steps=1)
        batches.close()
        line = capsys.readouterr().out.splitlines()[0]
        assert line.startswith(f"step {STEPS + 1} lr=1.00e-03 rpn_cls_loss=")
        fields = dict(kv.split("=") for kv in line.split()[2:])
        assert set(fields) == set(run["port_metrics"][0]) | {"lr"}
    finally:
        trainer.close()


def _pipeline(n, fail_at=None):
    for i in range(n):
        if i == fail_at:
            raise ValueError(f"corrupt record {i}")
        yield i


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_yields_every_item_in_order(size):
    assert list(prefetch(_pipeline(7), size=size)) == list(range(7))


@pytest.mark.parametrize("fail_at", [0, 3])
def test_prefetch_reraises_a_pipeline_error(fail_at):
    got = []
    with pytest.raises(ValueError, match=f"corrupt record {fail_at}"):
        for item in prefetch(_pipeline(7, fail_at)):
            got.append(item)
    assert got == list(range(fail_at))


def test_prefetch_close_stops_the_thread_and_closes_the_pipeline():
    closed = []

    def pipeline():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.append(True)

    it = prefetch(pipeline())
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert closed == [True]
