"""PyTorch / CUDA port of `tf_eager_object_detection_tpu` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here keeps
the name of its JAX counterpart and is held against it by
`tests/test_torch_*.py`. This package imports torch and numpy, never jax,
and nothing of the JAX package.

    from tf_eager_object_detection_tpu_torch.models.model_factory import (
        model_factory,
    )
"""

__version__ = "0.1.0"
