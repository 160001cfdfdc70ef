"""Optimizer of the reference trainer (port of `tf_eager_object_detection_tpu/training/optimizer.py`).

- piecewise-constant learning rate over `learning_rate_multi_decay_steps` /
  `learning_rate_multi_lrs`, switching one step after each boundary (the
  reference's `tf.train.piecewise_constant` keeps a value up to and
  including its boundary), in float32 as optax computes it;
- SGD with momentum, per element of a trainable tensor:
  `u = g + 2*wd*p` on decayed weights (keras l2(wd) contributes 2*wd*p),
  `u *= 2` on biases when `learning_rate_bias_double`, `t' = u + mu*t`,
  `p -= lr*t'` (as `p + (-lr)*t'`), the JAX package's fused rule in its
  order of operations;
- frozen tensors (`models/freeze.py`: requires_grad=False) take no update.

The update runs as a few `torch._foreach_*` passes over the parameter
lists, and reads nothing back to the host: the step count and the learning
rate live on the host.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from tf_eager_object_detection_tpu_torch.models.freeze import trainable_mask, weight_decay_mask

__all__ = ["make_lr_schedule", "make_optimizer", "MomentumOptimizer"]


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


class MomentumOptimizer:
    """The fused momentum rule over a detector's trainable parameters.

    `step()` applies one update from the parameters' `.grad` and advances
    the step count; `trace` maps each trainable parameter's name to its
    momentum buffer (zeros at the start, as in JAX).
    """

    def __init__(self, cfg: Dict[str, Any], detector: torch.nn.Module):
        self.schedule = make_lr_schedule(cfg)
        self.wd2 = 2.0 * cfg["weight_decay"]
        self.mu = cfg["optimizer_momentum"]
        self.bias_double = bool(cfg.get("learning_rate_bias_double", False))
        trainable = trainable_mask(detector)
        decayed = weight_decay_mask(detector)
        self.names = [n for n, p in detector.named_parameters() if trainable[n] and p.requires_grad]
        params = dict(detector.named_parameters())
        self.params = [params[n] for n in self.names]
        self.decayed = [decayed[n] for n in self.names]
        self.doubled = [self.bias_double and n.endswith(".bias") for n in self.names]
        self.trace = {n: torch.zeros_like(params[n]) for n in self.names}
        self.count = 0

    @property
    def lr(self) -> float:
        return self.schedule(self.count)

    def state_dict(self) -> Dict[str, Any]:
        """{"trace": {name: tensor}, "count": int}: the momentum traces (the
        tensors themselves, not copies) and the step count."""
        return {"trace": dict(self.trace), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy traces of the same names and shapes into place and set the
        step count; raises on any other set of names."""
        trace = state["trace"]
        if set(trace) != set(self.trace):
            unexpected = sorted(set(trace) - set(self.trace))
            missing = sorted(set(self.trace) - set(trace))
            raise KeyError(f"momentum traces: unexpected {unexpected[:8]}, missing {missing[:8]}")
        for name, t in self.trace.items():
            if tuple(trace[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: trace of shape {tuple(trace[name].shape)}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(trace[name])
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
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
        traces = [self.trace[n] for n in self.names]
        torch._foreach_mul_(traces, self.mu)
        torch._foreach_add_(traces, u)  # t' = u + mu*t
        torch._foreach_add_(self.params, torch._foreach_mul(traces, -self.lr))
        self.count += 1


def make_optimizer(cfg: Dict[str, Any], detector: torch.nn.Module) -> MomentumOptimizer:
    """The optimizer of `cfg` over `detector`'s trainable parameters."""
    opt_type = cfg.get("optimizer_type", "momentum")
    if opt_type == "adam":
        raise NotImplementedError(
            "optimizer_type='adam' is not ported yet (ROADMAP item 10)"
        )
    if opt_type != "momentum":
        raise ValueError(f"optimizer_type={opt_type!r}: expected 'momentum' or 'adam'")
    return MomentumOptimizer(cfg, detector)
