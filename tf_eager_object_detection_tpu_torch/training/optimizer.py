"""Optimizers of the reference trainer (port of `tf_eager_object_detection_tpu/training/optimizer.py`).

- piecewise-constant learning rate over `learning_rate_multi_decay_steps` /
  `learning_rate_multi_lrs`, switching one step after each boundary (the
  reference's `tf.train.piecewise_constant` keeps a value up to and
  including its boundary), in float32 as optax computes it; a step reads
  it at the count of the steps before it (0 for the first);
- per element of a trainable tensor, the optimizer's input is
  `u = g + 2*wd*p` on decayed weights (keras l2(wd) contributes 2*wd*p),
  then `u *= 2` on biases when `learning_rate_bias_double`;
- `optimizer_type='momentum'`: `t' = u + mu*t`, `p -= lr*t'` (as
  `p + (-lr)*t'`), the JAX package's fused rule in its order of
  operations;
- `optimizer_type='adam'`: the JAX chain's `optax.adam(lr)` (b1 0.9, b2
  0.999, eps 1e-8, eps_root 0): `m' = (1-b1)*u + b1*m`,
  `v' = (1-b2)*u**2 + b2*v`, bias corrections `1 - b**n` in float32 with
  n the 1-based step count, `p += (-lr) * (m'/c1) / (sqrt(v'/c2) + eps)`;
- frozen tensors (`models/freeze.py`: requires_grad=False) take no update
  and have no state.

The update runs as a few `torch._foreach_*` passes over the parameter
lists, and reads nothing back to the host: the step count and the learning
rate live on the host.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from tf_eager_object_detection_tpu_torch.models.freeze import trainable_mask, weight_decay_mask

__all__ = ["make_lr_schedule", "make_optimizer", "MomentumOptimizer", "AdamOptimizer"]


def make_lr_schedule(cfg: Dict[str, Any]):
    """step (int) -> learning rate (a float32 value as a Python float)."""
    lrs = list(cfg["learning_rate_multi_lrs"])
    steps = list(cfg["learning_rate_multi_decay_steps"])
    # optax multiplies the float32 value by each passed boundary's scale
    scales = sorted((int(s) + 1, np.float32(lrs[i + 1] / lrs[i])) for i, s in enumerate(steps))
    first = np.float32(lrs[0])

    def schedule(step: int) -> float:
        v = first
        for threshold, scale in scales:
            if step >= threshold:
                v = np.float32(scale * v)
        return float(v)

    return schedule


class _Optimizer:
    """What both rules share: the trainable parameters, the decay and bias
    masks, the schedule, the step count and the per-parameter state
    tensors (`SLOTS`, each {name: tensor}, zeros at the start as in JAX)."""

    SLOTS: tuple = ()

    def __init__(self, cfg: Dict[str, Any], detector: torch.nn.Module):
        self.schedule = make_lr_schedule(cfg)
        self.wd2 = 2.0 * cfg["weight_decay"]
        self.bias_double = bool(cfg.get("learning_rate_bias_double", False))
        trainable = trainable_mask(detector)
        decayed = weight_decay_mask(detector)
        self.names = [n for n, p in detector.named_parameters() if trainable[n] and p.requires_grad]
        params = dict(detector.named_parameters())
        self.params = [params[n] for n in self.names]
        self.decayed = [decayed[n] for n in self.names]
        self.doubled = [self.bias_double and n.endswith(".bias") for n in self.names]
        for slot in self.SLOTS:
            setattr(self, slot, {n: torch.zeros_like(params[n]) for n in self.names})
        self.count = 0

    @property
    def lr(self) -> float:
        return self.schedule(self.count)

    def state_dict(self) -> Dict[str, Any]:
        """{slot: {name: tensor}, ..., "count": int}: the state tensors (the
        tensors themselves, not copies) and the step count."""
        return {**{slot: dict(getattr(self, slot)) for slot in self.SLOTS}, "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy state tensors of the same slots, names and shapes into place
        and set the step count; raises on any other set of names."""
        slots = set(state) - {"count"}
        if slots != set(self.SLOTS):
            raise KeyError(f"optimizer state slots {sorted(slots)}, expected {list(self.SLOTS)}")
        for slot in self.SLOTS:
            mine, theirs = getattr(self, slot), state[slot]
            if set(theirs) != set(mine):
                unexpected = sorted(set(theirs) - set(mine))
                missing = sorted(set(mine) - set(theirs))
                raise KeyError(f"{slot}: unexpected {unexpected[:8]}, missing {missing[:8]}")
            for name, t in mine.items():
                if tuple(theirs[name].shape) != tuple(t.shape):
                    raise ValueError(f"{slot} {name}: shape {tuple(theirs[name].shape)}, "
                                     f"expected {tuple(t.shape)}")
                t.copy_(theirs[name])
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _inputs(self) -> list:
        """u per trainable tensor: the gradient, plus 2*wd*p where decayed,
        times 2 on a doubled bias."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        decay_idx = [i for i, d in enumerate(self.decayed) if d]
        u = list(grads)
        if decay_idx:
            decayed = torch._foreach_mul([self.params[i] for i in decay_idx], self.wd2)
            summed = torch._foreach_add([grads[i] for i in decay_idx], decayed)
            for i, v in zip(decay_idx, summed):
                u[i] = v
        double_idx = [i for i, d in enumerate(self.doubled) if d]
        if double_idx:
            for i, v in zip(double_idx, torch._foreach_mul([u[i] for i in double_idx], 2.0)):
                u[i] = v
        return u


class MomentumOptimizer(_Optimizer):
    """The fused momentum rule over a detector's trainable parameters.

    `step()` applies one update from the parameters' `.grad` and advances
    the step count; `trace` maps each trainable parameter's name to its
    momentum buffer.
    """

    SLOTS = ("trace",)

    def __init__(self, cfg: Dict[str, Any], detector: torch.nn.Module):
        super().__init__(cfg, detector)
        self.momentum = cfg["optimizer_momentum"]

    @torch.no_grad()
    def step(self) -> None:
        u = self._inputs()
        traces = [self.trace[n] for n in self.names]
        torch._foreach_mul_(traces, self.momentum)
        torch._foreach_add_(traces, u)  # t' = u + mu*t
        torch._foreach_add_(self.params, torch._foreach_mul(traces, -self.lr))
        self.count += 1


class AdamOptimizer(_Optimizer):
    """`optax.adam(lr)` after the decay and bias-double stages, as the JAX
    chain runs it, over a detector's trainable parameters: `mu` and `nu`
    map each one's name to its first and second moment."""

    SLOTS = ("mu", "nu")
    B1, B2, EPS = 0.9, 0.999, 1e-8

    @torch.no_grad()
    def step(self) -> None:
        u = self._inputs()
        mu = [self.mu[n] for n in self.names]
        nu = [self.nu[n] for n in self.names]
        lr = self.lr
        # m' = (1 - b1) * u + b1 * m, v' = (1 - b2) * u**2 + b2 * v
        torch._foreach_mul_(mu, self.B1)
        torch._foreach_add_(mu, torch._foreach_mul(u, 1.0 - self.B1))
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(u, u), 1.0 - self.B2))
        self.count += 1
        n = np.float32(self.count)
        c1 = float(np.float32(1.0) - np.float32(self.B1) ** n)
        c2 = float(np.float32(1.0) - np.float32(self.B2) ** n)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(denom, self.EPS)
        update = torch._foreach_div(torch._foreach_div(mu, c1), denom)
        torch._foreach_add_(self.params, torch._foreach_mul(update, -lr))


_OPTIMIZERS = {"momentum": MomentumOptimizer, "adam": AdamOptimizer}


def make_optimizer(cfg: Dict[str, Any], detector: torch.nn.Module):
    """The optimizer of `cfg` (`optimizer_type` 'momentum', the default, or
    'adam') over `detector`'s trainable parameters."""
    opt_type = cfg.get("optimizer_type", "momentum")
    if opt_type not in _OPTIMIZERS:
        raise ValueError(f"optimizer_type={opt_type!r}: expected 'momentum' or 'adam'")
    return _OPTIMIZERS[opt_type](cfg, detector)
