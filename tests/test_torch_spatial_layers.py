"""The row-mixing layers of the port on row-sharded maps, in one process.

`parallel/spatial.py` splits a map's rows over the ranks of a space group
(the owner rule: rank s of sp owns rows [floor(s * H / sp), floor((s + 1)
* H / sp))), and each layer that mixes rows fetches the halo rows its
output rows read (`fetch_rows`). Here every rank runs in this process in
turn, under a fake `RowShard` whose exchange reads the other ranks' slabs
from the whole input map instead of all-gathering them; everything else is
the port's own code: the halo plan, the window index, the fill rows, the
layers' padding read from the global height.

For each layer of Design step 3 of the port's spatial partitioning (SAME
convolutions, fixed-pad convolutions, -inf max pools, the strided
subsample) at heights even, odd, 38 (608 / 16) and 10 (FPN's p6 at 640),
over 2, 3 and 4 ranks (uneven owner ranges included):

- the ranks' outputs, concatenated, equal the unsharded layer's output
  within 1e-6 (float32, lecun-normal weights: outputs of the order of 1,
  which the CPU's convolutions at another height sum in another order, a
  few units in the last place apart);
- with a random upstream gradient on each rank's rows of the output, the
  input gradients that reach the whole map (each rank's own rows and, via
  the fake exchange, the halo rows it fetched, added at their owners)
  equal the unsharded input gradient within 1e-6.

The index arithmetic is also checked on its own: the owner rule covers
every row once, and the halo plan sends exactly the rows another rank's
window reads.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tf_eager_object_detection_tpu_torch.models.layers import (
    Conv2d,
    MaxPool2d,
    SameConv2d,
    max_pool_same,
    row_sharded,
    subsample,
)
from tf_eager_object_detection_tpu_torch.parallel.spatial import (
    fetch_rows,
    halo_plan,
    owner_rows,
    read_window,
)

TOL = 1e-6
HEIGHTS = [16, 15, 38, 10]
RANKS = [2, 3, 4]


class FakeShard:
    """A `RowShard` of one level for rank `rank`: its exchange returns every
    rank's slab read from `whole`, the unsharded input map."""

    def __init__(self, whole: torch.Tensor, rank: int, size: int):
        self.whole, self.rank, self.size = whole, rank, size

    def height(self, rows):
        lo, hi = owner_rows(self.rank, self.size, self.whole.shape[2])
        assert rows == hi - lo, (rows, lo, hi)
        return self.whole.shape[2]

    def window(self, x, height, out_height, kernel, stride, top, fill=0.0):
        windows = tuple(read_window(owner_rows(r, self.size, out_height), kernel, stride, top)
                        for r in range(self.size))
        plan = halo_plan(windows, height)
        slab = max(len(s) for s in plan)

        def exchange(mine):
            assert mine.shape[2] == slab
            parts = []
            for rows in plan:
                part = self.whole[:, :, list(rows)].to(mine.dtype)
                parts.append(F.pad(part, (0, 0, 0, slab - len(rows))))
            return torch.cat(parts, 2)

        return fetch_rows(x, windows, height, self.rank, exchange, fill)


def _conv(kernel, stride, padding=None):
    torch.manual_seed(kernel * 10 + stride)
    if padding is None:
        layer = SameConv2d(3, 4, kernel, stride)
    else:
        layer = Conv2d(3, 4, kernel, stride, padding)
    with torch.no_grad():  # lecun normal, as the port's init: outputs of the order of 1
        layer.weight.normal_(std=layer.weight[0].numel() ** -0.5)
        layer.bias.normal_(std=0.1)
    return layer


LAYERS = {
    "same_3x3_s1": lambda: _conv(3, 1),
    "same_3x3_s2": lambda: _conv(3, 2),
    "same_1x1_s2": lambda: _conv(1, 2),
    "same_7x7_s2": lambda: _conv(7, 2),
    "stem_7x7_s2_pad3": lambda: _conv(7, 2, 3),
    "slim_3x3_s2_pad1": lambda: _conv(3, 2, 1),
    "slim_3x3_s1_pad1": lambda: _conv(3, 1, 1),
    "stem_maxpool_3_s2_pad1": lambda: MaxPool2d(3, stride=2, padding=1),
    "vgg_maxpool_same_2_s2": lambda: (lambda x: max_pool_same(x, 2, 2)),
    "maxpool_same_3_s2": lambda: (lambda x: max_pool_same(x, 3, 2)),
    "shortcut_subsample_2": lambda: (lambda x: subsample(x, 2)),
}


def _sharded_run(layer, x, size, grads):
    """Every rank's output rows, concatenated, and the gradient at the whole
    map of sum over ranks <output rows, their upstream gradient>."""
    whole = x.detach().clone().requires_grad_(True)
    outs = []
    for rank in range(size):
        lo, hi = owner_rows(rank, size, x.shape[2])
        with row_sharded(FakeShard(whole, rank, size)):
            outs.append(layer(whole[:, :, lo:hi]))
    out = torch.cat(outs, 2)
    (out * grads).sum().backward()
    return out.detach(), whole.grad


@pytest.mark.parametrize("size", RANKS)
@pytest.mark.parametrize("height", HEIGHTS)
@pytest.mark.parametrize("name", list(LAYERS))
def test_sharded_layer_equals_unsharded(name, height, size):
    layer = LAYERS[name]()
    rng = np.random.RandomState(height * 7 + size)
    x = torch.from_numpy(rng.randn(2, 3, height, 11).astype(np.float32))
    whole = x.clone().requires_grad_(True)
    want = layer(whole)
    grads = torch.from_numpy(rng.randn(*want.shape).astype(np.float32))
    (want * grads).sum().backward()
    # every rank owns at least one output row, as `RowShard` requires
    assert all(np.diff([owner_rows(r, size, want.shape[2])[0] for r in range(size + 1)]) > 0)
    got, got_grad = _sharded_run(layer, x, size, grads)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_grad.numpy(), whole.grad.numpy(), rtol=0, atol=TOL)


@pytest.mark.parametrize("size", RANKS)
@pytest.mark.parametrize("height", HEIGHTS + [608, 38 * 16])
def test_owner_rule_covers_every_row_once(height, size):
    rows = [owner_rows(r, size, height) for r in range(size)]
    assert rows[0][0] == 0 and rows[-1][1] == height
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    counts = [hi - lo for lo, hi in rows]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("kernel,stride,top", [(3, 1, 1), (7, 2, 3), (1, 2, 0), (3, 2, 1)])
@pytest.mark.parametrize("height,size", [(38, 4), (10, 4), (15, 2), (64, 3)])
def test_halo_plan_sends_what_the_windows_read(kernel, stride, top, height, size):
    out_height = (height + 2 * top - kernel) // stride + 1
    windows = tuple(read_window(owner_rows(r, size, out_height), kernel, stride, top)
                    for r in range(size))
    plan = halo_plan(windows, height)
    for q, rows in enumerate(plan):
        lo, hi = owner_rows(q, size, height)
        assert all(lo <= j < hi for j in rows)
        wanted = {j for r, (a, b) in enumerate(windows) if r != q
                  for j in range(max(a, lo), min(b, hi))}
        assert set(rows) == wanted
