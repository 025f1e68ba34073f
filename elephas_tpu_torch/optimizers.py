"""Keras's Adam as a ``torch.optim.Optimizer``.

The reference's builders compile ``keras.optimizers.Adam(lr)``, whose
update (``keras/src/optimizers/adam.py``, ``Adam.update_step``) is, at step
``t`` and with every quantity in the variable's dtype::

    alpha = lr * sqrt(1 - beta_2**t) / (1 - beta_1**t)
    m += (g - m) * (1 - beta_1)
    v += (g*g - v) * (1 - beta_2)
    var -= m * alpha / (sqrt(v) + epsilon)          # epsilon = 1e-7

``torch.optim.Adam`` puts epsilon inside the bias correction and defaults
it to 1e-8, so it drifts from the reference within a few steps. This class
writes the Keras update out, one parameter at a time, with explicit state
and no fused or multi-tensor path.
"""

from __future__ import annotations

import numpy as np
import torch


class Adam(torch.optim.Optimizer):
    """Keras's Adam (no amsgrad, weight decay or clipping). State per
    parameter: ``step``, ``m`` and ``v``, as Keras keeps its iteration
    count, momentums and velocities.

    Keras applies an update to every trainable variable; a parameter whose
    ``grad`` is ``None`` takes a zero gradient here, as it would there."""

    def __init__(self, params, lr: float = 1e-3, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-7):
        if lr <= 0 or not 0 <= beta_1 < 1 or not 0 <= beta_2 < 1 or epsilon <= 0:
            raise ValueError(
                f"bad Adam settings: lr={lr}, beta_1={beta_1}, beta_2={beta_2}, "
                f"epsilon={epsilon}"
            )
        super().__init__(params, dict(lr=lr, beta_1=beta_1, beta_2=beta_2,
                                      epsilon=epsilon))

    @staticmethod
    def _alpha(lr, beta_1, beta_2, step, dtype) -> float:
        """``lr·sqrt(1−β₂ᵗ)/(1−β₁ᵗ)`` in the parameter's float type, on the
        host (each operation rounded as Keras's ops round it)."""
        f = np.dtype(str(dtype).split(".")[-1]).type
        one, t = f(1), f(step)
        return float(f(lr) * np.sqrt(one - f(beta_2) ** t) / (one - f(beta_1) ** t))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, eps = group["beta_1"], group["beta_2"], group["epsilon"]
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["m"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["v"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["step"] += 1
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                m, v = state["m"], state["v"]
                alpha = self._alpha(group["lr"], b1, b2, state["step"], p.dtype)
                m.add_((g - m) * (1 - b1))
                v.add_((g * g - v) * (1 - b2))
                p.sub_(m * alpha / (torch.sqrt(v) + eps))
        return loss
