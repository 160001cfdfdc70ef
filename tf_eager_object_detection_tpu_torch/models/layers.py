"""Shared layers (port of `tf_eager_object_detection_tpu/models/layers.py`).

Modules here take NCHW tensors; the NHWC <-> NCHW change happens at the
entry and exit of the backbone and the heads.

Compute dtype, as a flax module's `dtype`: `Conv2d`, `SameConv2d` and
`Linear` keep float32 parameters and cast their input, weight and bias to
their `compute_dtype` inside `forward`, so a bfloat16 layer returns
bfloat16 and its parameters' gradients come back float32 through the cast.
A float32 layer given a bfloat16 input computes in float32 on the exact
upcast, as flax promotes a layer that has no `dtype`. `FrozenBatchNorm`
computes its scale and shift in float32 and applies them in the input's
dtype. `max_pool_same` is keras 'SAME' max pooling (the extra row and
column of an odd side on the bottom and right, padded with -inf).

Row sharding (`parallel/spatial.py`): inside `row_sharded(shard)` the
layers that mix rows (`SameConv2d` and `Conv2d` with a window or a stride
along the rows, `MaxPool2d`, `max_pool_same`, `subsample`) take a rank's
rows of a map whose rows are split over ranks, and return its rows of the
output. Each reads its padding from the map's global height (`shard.height`
of its local rows), not from the local shard, and convolves the rows that
its output rows read, halo included (`shard.window`: rows of other ranks
fetched from them, the padding's zeros or -inf outside the map). Outside
the context, nothing changes.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv2d", "FrozenBatchNorm", "Linear", "MaxPool2d", "SameConv2d", "max_pool_same",
           "resolve_compute_dtype", "row_sharded", "subsample"]

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's `tpu_compute_dtype` ("float32" or "bfloat16")."""
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"unknown tpu_compute_dtype {name!r}: expected one of "
                         f"{sorted(_COMPUTE_DTYPES)}")
    return _COMPUTE_DTYPES[name]


class FrozenBatchNorm(nn.Module):
    """Affine-only batch norm over frozen statistics, NCHW.

    The statistics are buffers under the flax parameter names, so the weight
    bridge maps them one to one. epsilon matches keras ResNet (1.001e-5).
    """

    def __init__(self, channels: int, epsilon: float = 1.001e-5):
        super().__init__()
        self.epsilon = epsilon
        self.register_buffer("gamma", torch.ones(channels))
        self.register_buffer("beta", torch.zeros(channels))
        self.register_buffer("moving_mean", torch.zeros(channels))
        self.register_buffer("moving_variance", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.reciprocal(torch.sqrt(self.moving_variance + self.epsilon))
        scale = (self.gamma * inv).to(x.dtype)
        shift = (self.beta - self.moving_mean * self.gamma * inv).to(x.dtype)
        return x * scale[:, None, None] + shift[:, None, None]


def _same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF/flax 'SAME' padding (before, after) along one axis."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


_ROW_SHARD: contextvars.ContextVar = contextvars.ContextVar("row_shard", default=None)


@contextlib.contextmanager
def row_sharded(shard):
    """Run the enclosed layers on a rank's rows of row-sharded maps
    (`shard`: a `parallel/spatial.py::RowShard`)."""
    token = _ROW_SHARD.set(shard)
    try:
        yield
    finally:
        _ROW_SHARD.reset(token)


def _rows_read(x: torch.Tensor, kernel: int, stride: int, top, out_height, fill=0.0):
    """Under `row_sharded`, for a window of `kernel` rows at `stride`: this
    rank's rows of x [B, C, h, W] with the halo rows its output rows read
    (the global padding included) -> (rows, True). `top(H)` and
    `out_height(H)` are the padding above and the output rows of a map of
    H rows. Otherwise, and for a 1x1 window at stride 1, (x, False)."""
    shard = _ROW_SHARD.get()
    if shard is None or (kernel == 1 and stride == 1):
        return x, False
    height = shard.height(x.shape[-2])
    return shard.window(x, height, out_height(height), kernel, stride, top(height), fill), True


def subsample(x: torch.Tensor, step: int) -> torch.Tensor:
    """Every `step`-th row and column of [B, C, H, W], from the first."""
    if step == 1:
        return x
    x, _ = _rows_read(x, 1, step, lambda h: 0, lambda h: -(-h // step))
    return x[:, :, ::step, ::step]


class MaxPool2d(nn.MaxPool2d):
    """nn.MaxPool2d (-inf padding) that takes row-sharded maps."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s, p = self.kernel_size, self.stride, self.padding
        x, sharded = _rows_read(x, k, s, lambda h: p, lambda h: (h + 2 * p - k) // s + 1,
                                float("-inf"))
        return F.max_pool2d(x, k, s, (0, p) if sharded else p)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Max pool of [B, C, H, W] with TF 'SAME' padding: -inf where the
    window passes the edge, the odd one on the bottom / right, unlike torch's
    symmetric pooling padding."""
    x, sharded = _rows_read(x, window, stride, lambda h: _same_padding(h, window, stride)[0],
                            lambda h: -(-h // stride), float("-inf"))
    top, bottom = (0, 0) if sharded else _same_padding(x.shape[-2], window, stride)
    left, right = _same_padding(x.shape[-1], window, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class Conv2d(nn.Conv2d):
    """nn.Conv2d (fixed padding) computing in `compute_dtype`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding)
        self.compute_dtype = compute_dtype

    def _cast(self, x: torch.Tensor):
        d = self.compute_dtype
        return x.to(d), self.weight.to(d), self.bias.to(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = self._cast(x)
        (k, _), (s, _), (p, q) = self.kernel_size, self.stride, self.padding
        x, sharded = _rows_read(x, k, s, lambda h: p, lambda h: (h + 2 * p - k) // s + 1)
        return F.conv2d(x, w, b, self.stride, (0, q) if sharded else self.padding)


class SameConv2d(Conv2d):
    """Conv2d with TF 'SAME' padding, computed from the input size.

    Symmetric padding goes to the convolution itself; an asymmetric one (odd
    extents at stride 2, extra on the bottom/right) is padded explicitly.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = self._cast(x)
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        x, sharded = _rows_read(x, kh, sh, lambda h: _same_padding(h, kh, sh)[0],
                                lambda h: -(-h // sh))
        top, bottom = (0, 0) if sharded else _same_padding(x.shape[-2], kh, sh)
        left, right = _same_padding(x.shape[-1], kw, sw)
        if top == bottom and left == right:
            return F.conv2d(x, w, b, self.stride, (top, left))
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w, b, self.stride)


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype`."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))
