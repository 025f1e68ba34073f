"""Keras's Adam, SGD and RMSprop as ``torch.optim.Optimizer``s, and
:func:`deserialize` of the dict ``keras.optimizers.serialize`` writes.

The reference's builders compile ``keras.optimizers.Adam(lr)`` (ResNet:
``keras.optimizers.SGD(lr, momentum=0.9)``, see :class:`SGD`); its
``ElephasEstimator`` takes any serialized optimizer and ``"rmsprop"``
when none is given (:class:`RMSprop`). Adam's
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

import inspect
import json

import numpy as np
import torch

_TODO = ("{} is not ported yet (ROADMAP.md, Queue A item 2: the port reads "
         "Keras's Adam, SGD and RMSprop without weight decay, clipping, EMA, "
         "amsgrad or nesterov)")


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


class SGD(torch.optim.Optimizer):
    """Keras's SGD (no Nesterov momentum, weight decay or clipping). Its
    update (``keras/src/optimizers/sgd.py``, ``SGD.update_step``), in the
    variable's dtype::

        m = m * momentum - g * lr; var += m      # momentum != 0
        var -= g * lr                            # momentum == 0

    ``torch.optim.SGD`` keeps ``buf = μ·buf + g`` and steps ``p −= lr·buf``,
    which rounds differently; so the update is written out here, one
    parameter at a time. State per parameter: ``m`` (with momentum). A
    parameter whose ``grad`` is ``None`` takes a zero gradient, as in
    :class:`Adam`."""

    def __init__(self, params, lr: float = 0.01, momentum: float = 0.0):
        if lr <= 0 or not 0 <= momentum <= 1:
            raise ValueError(f"bad SGD settings: lr={lr}, momentum={momentum}")
        super().__init__(params, dict(lr=lr, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, mu = group["lr"], group["momentum"]
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if mu == 0:
                    p.sub_(g * lr)
                    continue
                state = self.state[p]
                if not state:
                    state["m"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                m = state["m"]
                m.mul_(mu).sub_(g * lr)
                p.add_(m)
        return loss


class RMSprop(torch.optim.Optimizer):
    """Keras's RMSprop (``keras/src/optimizers/rmsprop.py``,
    ``RMSprop.update_step``), in the variable's dtype::

        v = rho * v + (1 - rho) * g * g
        a = rho * a + (1 - rho) * g                  # centered
        d = v - a * a + epsilon   (centered)  or  v + epsilon
        inc = lr * g / sqrt(d)
        m = momentum * m + inc; var -= m             # momentum > 0
        var -= inc                                   # momentum == 0

    ``torch.optim.RMSprop`` puts epsilon outside the square root. State
    per parameter: ``velocity``, and ``average_gradient`` (centered) and
    ``momentum`` (momentum > 0), all starting at zero as in Keras."""

    def __init__(self, params, lr: float = 1e-3, rho: float = 0.9, momentum: float = 0.0,
                 epsilon: float = 1e-7, centered: bool = False):
        if lr <= 0 or not 0 <= rho < 1 or not 0 <= momentum <= 1 or epsilon <= 0:
            raise ValueError(f"bad RMSprop settings: lr={lr}, rho={rho}, "
                             f"momentum={momentum}, epsilon={epsilon}")
        super().__init__(params, dict(lr=lr, rho=rho, momentum=momentum, epsilon=epsilon,
                                      centered=bool(centered)))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, rho, mu, eps = group["lr"], group["rho"], group["momentum"], group["epsilon"]
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["velocity"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    if group["centered"]:
                        state["average_gradient"] = torch.zeros_like(p)
                    if mu > 0:
                        state["momentum"] = torch.zeros_like(p)
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                v = state["velocity"]
                v.copy_(rho * v + (1 - rho) * (g * g))
                if group["centered"]:
                    a = state["average_gradient"]
                    a.copy_(rho * a + (1 - rho) * g)
                    denominator = v - a * a + eps
                else:
                    denominator = v + eps
                increment = (lr * g) / torch.sqrt(denominator)
                if mu > 0:
                    m = state["momentum"]
                    m.copy_(mu * m + increment)
                    p.sub_(m)
                else:
                    p.sub_(increment)
        return loss


# Keras config keys read into the constructors, and the keys that must sit
# at their neutral value
_KERAS_OPTIMIZERS = {
    "Adam": (Adam, {"learning_rate": "lr", "beta_1": "beta_1", "beta_2": "beta_2",
                    "epsilon": "epsilon"}, {"amsgrad": False}),
    "SGD": (SGD, {"learning_rate": "lr", "momentum": "momentum"}, {"nesterov": False}),
    "RMSprop": (RMSprop, {"learning_rate": "lr", "rho": "rho", "momentum": "momentum",
                          "epsilon": "epsilon", "centered": "centered"}, {}),
}
_NEUTRAL = {"weight_decay": None, "clipnorm": None, "global_clipnorm": None,
            "clipvalue": None, "use_ema": False, "loss_scale_factor": None,
            "gradient_accumulation_steps": None}


def deserialize(config, params) -> torch.optim.Optimizer:
    """The optimizer over ``params`` that ``config`` describes: the dict
    ``keras.optimizers.serialize`` writes, ``{"class_name": ...,
    "config": {...}}``, or its JSON text. Adam, SGD and RMSprop are read;
    any other class, and a setting the port does not take (weight decay,
    clipping, EMA, amsgrad, nesterov, a learning-rate schedule), raises
    ``NotImplementedError`` naming its ROADMAP item."""
    if isinstance(config, str):
        config = json.loads(config)
    name = config.get("class_name")
    if name not in _KERAS_OPTIMIZERS:
        raise NotImplementedError(_TODO.format(f"the optimizer {name!r}"))
    cls, keys, neutral = _KERAS_OPTIMIZERS[name]
    settings = config.get("config") or {}
    for key, value in {**_NEUTRAL, **neutral}.items():
        if settings.get(key, value) != value:
            raise NotImplementedError(_TODO.format(f"{name}({key}={settings[key]!r})"))
    if isinstance(settings.get("learning_rate"), dict):
        raise NotImplementedError(_TODO.format(f"{name} with a learning-rate schedule"))
    return cls(params, **{ours: settings[theirs] for theirs, ours in keys.items()
                          if theirs in settings})


def hyperparameters(optimizer: torch.optim.Optimizer) -> dict:
    """The keyword arguments that rebuild ``optimizer``'s class with its
    defaults (``torch.optim.Optimizer.load_state_dict`` adds keys of its
    own, such as ``differentiable``, that the constructors here do not
    take)."""
    taken = inspect.signature(type(optimizer)).parameters
    return {k: v for k, v in optimizer.defaults.items() if k in taken}
