"""The port stands without JAX and never falls back silently.

Each check runs in a fresh interpreter so that nothing this test process
imported (JAX included) leaks into what is checked.
"""

import ast
import os
import subprocess
import sys
import tempfile
import textwrap

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what the port must not have loaded: JAX, flax, or any module of the JAX package
_NO_JAX = """
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "flax", "tf_eager_object_detection_tpu"))
        assert not leaked, leaked
"""


def _run(code: str) -> subprocess.CompletedProcess:
    # no visible GPU, no CUDA toolkit and an empty kernel build directory,
    # whatever the machine has
    with tempfile.TemporaryDirectory() as build_dir:
        env = dict(os.environ, PYTHONPATH=_ROOT, CUDA_VISIBLE_DEVICES="",
                   CUDA_HOME=os.path.join(_ROOT, "no-such-cuda"), PATH="/usr/bin:/bin",
                   TF_EAGER_OD_TORCH_BUILD_DIR=build_dir)
        return subprocess.run(
            [sys.executable, "-c", textwrap.dedent(code)],
            cwd=_ROOT, env=env, capture_output=True, text=True, timeout=300,
        )


def test_port_predicts_on_cpu_without_importing_jax():
    proc = _run(
        """
        import sys
        import numpy as np
        from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
        from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
        from tf_eager_object_detection_tpu_torch.evaluation.batched_inference import (
            batched_im_detect,
        )
        from tf_eager_object_detection_tpu_torch.ops.kernels import build, nms_cuda

        cfg = dict(config_factory("pascal", "faster_rcnn"))
        cfg.update(rpn_proposal_test_pre_nms_sample_number=100,
                   rpn_proposal_test_after_nms_sample_number=20,
                   max_objects_per_image=5, max_objects_per_class_per_image=5)
        det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu")
        img = np.random.RandomState(0).randn(64, 96, 3).astype(np.float32)
        out = det.predict(img, [60, 90])
        assert out.boxes.shape == (5, 4) and bool(out.valid.any())
        items = [(img, np.array([60, 90]), 1.0)] * 3
        got = list(batched_im_detect(det, items, batch_size=2))
        assert sorted(i for i, _, _ in got) == [0, 1, 2]
        assert nms_cuda.NMS_KERNEL.launches == 0  # CPU tensors take the plain version
""" + _NO_JAX + """
        print("OK")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_fpn_predicts_on_cpu_without_importing_jax():
    proc = _run(
        """
        import sys
        import numpy as np
        from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
        from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
        from tf_eager_object_detection_tpu_torch.evaluation.batched_inference import (
            batched_im_detect,
        )
        from tf_eager_object_detection_tpu_torch.ops.kernels import nms_cuda, roi_align_cuda

        cfg = dict(config_factory("pascal", "fpn"))
        cfg.update(rpn_proposal_test_pre_nms_sample_number=100,
                   rpn_proposal_test_after_nms_sample_number=20,
                   max_objects_per_image=5, max_objects_per_class_per_image=5)
        det = model_factory("fpn", "resnet50", cfg, device="cpu")
        img = np.random.RandomState(0).randn(64, 128, 3).astype(np.float32)
        out = det.predict(img, [60, 120])
        assert out.boxes.shape == (5, 4) and bool(out.valid.any())
        items = [(img, np.array([60, 120]), 1.0)] * 3
        got = list(batched_im_detect(det, items, batch_size=2))
        assert sorted(i for i, _, _ in got) == [0, 1, 2]
        # CPU tensors take the plain versions
        assert nms_cuda.NMS_KERNEL.launches == 0
        assert roi_align_cuda.ROI_ALIGN_KERNEL.launches == 0
""" + _NO_JAX + """
        print("OK")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


@pytest.mark.parametrize("model_type", ["faster_rcnn", "fpn"])
def test_default_device_is_cuda_and_raises_without_one(model_type):
    proc = _run(
        f"""
        import torch
        assert not torch.cuda.is_available()
        from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
        from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
        try:
            model_factory("{model_type}", "resnet50", config_factory("pascal", "{model_type}"))
        except RuntimeError as e:
            assert "cuda" in str(e).lower(), e
            print("RAISED")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "RAISED"


def test_cuda_without_a_gpu_raises():
    proc = _run(
        """
        import torch
        assert not torch.cuda.is_available()
        from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
        from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
        try:
            model_factory("faster_rcnn", "resnet50", config_factory("pascal", "faster_rcnn"),
                          device="cuda")
        except RuntimeError as e:
            assert "cuda" in str(e).lower(), e
            print("RAISED")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "RAISED"


def test_kernel_wrapper_imports_without_nvcc_and_refuses_cpu_tensors():
    proc = _run(
        """
        import torch
        from tf_eager_object_detection_tpu_torch.ops.kernels.nms_cuda import NMS_KERNEL
        try:
            NMS_KERNEL(torch.zeros(1, 8, 4), torch.ones(1, 8, dtype=torch.bool), 0.5, 4)
        except ValueError as e:
            assert "CUDA" in str(e)
        else:
            raise SystemExit("CPU tensors reached the CUDA kernel")
        try:
            NMS_KERNEL.load()
        except RuntimeError as e:
            assert "nvcc not found" in str(e), e
            print("NO-NVCC")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "NO-NVCC"
    assert not os.path.exists(os.path.join(_ROOT, "no-such-cuda"))


def test_roi_align_wrapper_imports_without_nvcc_and_refuses_cpu_tensors():
    proc = _run(
        """
        import torch
        from tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_cuda import (
            ROI_ALIGN_KERNEL,
        )
        planes = [torch.zeros(1, 8, 8, 4), torch.zeros(1, 4, 4, 4)]
        args = (planes, torch.zeros(1, 3, 4), torch.zeros(1, 3, dtype=torch.long),
                torch.ones(1, 3, dtype=torch.bool), torch.full((1,), 30.0),
                torch.full((1,), 30.0), 14, (4, 8))
        try:
            ROI_ALIGN_KERNEL(*args)
        except ValueError as e:
            assert "CUDA" in str(e)
        else:
            raise SystemExit("CPU tensors reached the CUDA kernel")
        assert ROI_ALIGN_KERNEL.launches == 0
        try:
            ROI_ALIGN_KERNEL.load()
        except RuntimeError as e:
            assert "nvcc not found" in str(e), e
            print("NO-NVCC")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "NO-NVCC"


def test_trainer_checkpoints_and_clis_import_without_jax():
    proc = _run(
        """
        import sys
        from tf_eager_object_detection_tpu_torch.training import checkpoints, trainer
        from tf_eager_object_detection_tpu_torch.ref_import import cli
        from tf_eager_object_detection_tpu_torch.utils import visual
        from tf_eager_object_detection_tpu_torch.scripts import (
            eval_pascal, generate_pascal_tf_records, infer, train, voc_rehearsal,
        )
        for mod in (eval_pascal, infer, train, voc_rehearsal):
            try:
                mod.main(["--help"] if mod is not voc_rehearsal else ["gen", "--help"])
            except SystemExit as e:
                assert e.code == 0
""" + _NO_JAX + """
        print("OK")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_parallel_modules_import_without_jax():
    """`parallel/` (`spatial.py` included) loads no JAX, and neither does the
    data-parallel tests' worker (its children must start without it); a
    group of one joins without torchrun's environment, and the data-parallel
    and spatial (sp = 1) steps take a step over it."""
    proc = _run(
        """
        import sys
        sys.path.insert(0, "tests")
        import numpy as np
        import torch
        from tf_eager_object_detection_tpu_torch.parallel import mesh, multihost, spatial
        import torch_ddp_worker
        from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
        from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
        from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer

        assert multihost.initialize(device="cpu", timeout_s=60) == (0, 1)
        assert multihost.is_primary() and multihost.local_batch_slice(4, 0, 1) == (0, 4)
        cfg = dict(config_factory("pascal", "faster_rcnn"))
        cfg.update(scales=[2, 4, 8], tpu_image_buckets=[[64, 64]], tpu_max_gt_boxes=2,
                   rpn_proposal_train_pre_nms_sample_number=64,
                   rpn_proposal_train_after_nms_sample_number=16, roi_total_sample_number=8)
        det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu")
        step = mesh.make_parallel_train_step(det, make_optimizer(cfg, det))
        batch = (np.zeros((1, 64, 64, 3), np.float32), np.array([[64, 64]]),
                 np.array([[[8.0, 8.0, 40.0, 40.0], [0, 0, 0, 0]]], np.float32),
                 np.array([[True, False]]), np.array([[3, 0]]))
        metrics = step(batch, torch.Generator().manual_seed(0))
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        det = model_factory("faster_rcnn", "resnet50", cfg, device="cpu")
        groups = spatial.make_spatial_groups(1, timeout_s=60)
        step = spatial.make_spatial_train_step(det, make_optimizer(cfg, det), groups)
        metrics = step(batch, torch.Generator().manual_seed(0))
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        multihost.shutdown()
""" + _NO_JAX + """
        print("OK")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_vgg16_and_slim_fpn_run_on_cpu_without_importing_jax():
    """VGG16 Faster R-CNN serves and takes a training step (its dropout
    masks drawn with the samplers'), and a slim-style FPN serves, with no
    JAX loaded."""
    proc = _run(
        """
        import sys
        import numpy as np
        import torch
        from tf_eager_object_detection_tpu_torch.config.config_factory import config_factory
        from tf_eager_object_detection_tpu_torch.models.backbones.vgg import Vgg16RoiHead
        from tf_eager_object_detection_tpu_torch.models.backbones.resnet import (
            SlimResNetBackbone,
        )
        from tf_eager_object_detection_tpu_torch.models.model_factory import model_factory
        from tf_eager_object_detection_tpu_torch.training.optimizer import make_optimizer
        from tf_eager_object_detection_tpu_torch.training.train_step import make_train_step

        small = dict(rpn_proposal_test_pre_nms_sample_number=100,
                     rpn_proposal_test_after_nms_sample_number=20,
                     rpn_proposal_train_pre_nms_sample_number=100,
                     rpn_proposal_train_after_nms_sample_number=20, rpn_total_sample_number=32,
                     roi_total_sample_number=8, max_objects_per_image=5,
                     max_objects_per_class_per_image=5, scales=[2, 4, 8])
        cfg = dict(config_factory("pascal", "faster_rcnn"), **small)
        det = model_factory("faster_rcnn", "vgg16", cfg, device="cpu")
        assert isinstance(det.roi_head, Vgg16RoiHead) and not det.training
        img = np.random.RandomState(0).randn(64, 96, 3).astype(np.float32) * 50
        assert det.predict(img, [60, 90]).boxes.shape == (5, 4)
        gt = np.array([[[5, 5, 40, 50]]], np.float32)
        batch = (img[None], np.array([[60, 90]]), gt, np.array([[True]]), np.array([[3]]))
        m = make_train_step(det, make_optimizer(cfg, det))(batch, torch.Generator().manual_seed(0))
        assert all(np.isfinite(float(v)) for v in m.values())
        fcfg = dict(config_factory("pascal", "fpn"), tpu_fpn_backbone_style="slim",
                    rpn_proposal_test_pre_nms_sample_number=100,
                    rpn_proposal_test_after_nms_sample_number=20, max_objects_per_image=5,
                    max_objects_per_class_per_image=5)
        fdet = model_factory("fpn", "resnet50", fcfg, device="cpu")
        assert isinstance(fdet.extractor, SlimResNetBackbone)
        assert fdet.predict(img, [60, 90]).boxes.shape == (5, 4)
""" + _NO_JAX + """
        print("OK")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_importers_run_without_h5py_tensorflow_or_jax():
    """The card's machine has neither h5py nor tensorflow: the importers and
    the command lines import without them, the `.h5` and TF-checkpoint
    loaders raise ImportError naming their package, and the `.pth` ->
    pickle path works."""
    proc = _run(
        """
        import os, sys, tempfile
        sys.modules["h5py"] = None  # import h5py -> ImportError
        sys.modules["tensorflow"] = None
        import numpy as np
        import torch
        from tf_eager_object_detection_tpu_torch.ref_import import (
            cli, importers, name_maps, pytorch_convert,
        )
        from tf_eager_object_detection_tpu_torch.scripts import infer, train

        tree = {"extractor": {"conv1_conv": {"kernel": np.zeros((7, 7, 3, 64), np.float32)}}}
        try:
            importers.load_keras_h5(tree, "w.h5", ("extractor",))
            raise SystemExit("no ImportError")
        except ImportError as e:
            assert "h5py" in str(e), e
        try:
            importers.load_tf_checkpoint_dict("model.ckpt")
            raise SystemExit("no ImportError")
        except ImportError as e:
            assert "tensorflow" in str(e), e
        with tempfile.TemporaryDirectory() as d:
            torch.save({"w": torch.ones(2, 3, 1, 1)}, os.path.join(d, "m.pth"))
            out = pytorch_convert.convert_pth_to_dict(os.path.join(d, "m.pth"),
                                                      os.path.join(d, "m.pkl"))
            assert pytorch_convert.load_pickle_dict(os.path.join(d, "m.pkl"))["w"].shape == \
                (1, 1, 3, 2) == out["w"].shape
        assert len(name_maps.resnet_tf_faster_rcnn_map(50)) > 100
        leaked = [m for m in ("h5py", "tensorflow") if sys.modules.get(m) is not None]
        assert not leaked, leaked
""" + _NO_JAX + """
        print("OK")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_operator_library_and_export_import_without_jax():
    """The `tf_eager_od` operators, `serving/export.py` and
    `scripts/export.py` load no JAX; the operators are registered."""
    proc = _run(
        """
        import sys
        import torch
        from tf_eager_object_detection_tpu_torch.ops.kernels import library
        from tf_eager_object_detection_tpu_torch.serving import export
        from tf_eager_object_detection_tpu_torch.scripts import export as export_cli
        for name in ("nms_alive_sorted", "roi_align", "roi_align_backward"):
            assert hasattr(torch.ops.tf_eager_od, name), name
        try:
            export_cli.main(["--help"])
        except SystemExit as e:
            assert e.code == 0
""" + _NO_JAX + """
        print("OK")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_chip_smoke_imports_only_the_port():
    proc = _run(
        """
        import sys
        import chip_smoke
        """ + _NO_JAX + """
        assert "tf_eager_object_detection_tpu_torch.models.faster_rcnn" in sys.modules
        assert "tf_eager_object_detection_tpu_torch.models.fpn" in sys.modules
        assert "tf_eager_object_detection_tpu_torch.ops.kernels.roi_align_cuda" in sys.modules
        assert "tf_eager_object_detection_tpu_torch.ref_import.importers" in sys.modules
        assert "tf_eager_object_detection_tpu_torch.ref_import.pytorch_convert" in sys.modules
        assert not any(sys.modules.get(m) for m in ("h5py", "tensorflow"))
        print("OK")
        """
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"


def _port_sources():
    pkg = os.path.join(_ROOT, "tf_eager_object_detection_tpu_torch")
    paths = [os.path.join(_ROOT, "chip_smoke.py"), os.path.join(_ROOT, "kernel_ab.py")]
    for d, _, files in os.walk(pkg):
        paths += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(paths)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_import_of_jax_or_the_jax_package(path):
    """Every import statement, including those inside functions."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "flax", "tf_eager_object_detection_tpu")]
    assert not bad, bad


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_module_level_import_of_h5py_or_tensorflow(path):
    """The card's machine has neither: a module of the port (or
    `chip_smoke.py`) may import them only inside the function that reads
    their format."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names, todo = [], list(tree.body)
    while todo:  # what runs at import: every statement outside a function body
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        todo += list(ast.iter_child_nodes(node))
    bad = [n for n in names if n.split(".")[0] in ("h5py", "tensorflow")]
    assert not bad, bad
