"""The update of ``torch.optim.Adam`` and ``torch.optim.SGD`` as a function of
tensors, so that a traced training step (``_compile.jit``) holds it, as the
JAX package's jitted steps hold ``optimizer.update``
(``gpflow_tpu/parallel/trainer.py:245-323``, ``gpflow_tpu/utilities/misc.py:120-134``).

``Update.of(optimizer, params)`` works on the optimizer's own ``state``
(Adam's ``exp_avg``, ``exp_avg_sq`` and ``step``, SGD's ``momentum_buffer``),
so that ``state_dict`` and ``load_state_dict`` see the tensors that the steps
update. ``params`` are the tensors that the optimizer was built over, in the
order in which the caller passes them and their gradients; the optimizer's
parameter groups may hold them in another order (each parameter keeps its
group's hyperparameters). A step is three calls:

* ``prepare()``, on the host: the state a parameter needs (made as
  ``torch.optim`` makes it at its first step) and the scalars of this step,
  tensors, so that a trace takes them as inputs and a new learning rate
  replays it: Adam's step size and the square root of its second bias
  correction, computed from the step count in Python floats as
  ``torch.optim.Adam``'s single-tensor step computes them, in a CPU tensor
  (read by a CUDA operation it is a host scalar: no synchronisation);
  SGD's negated learning rate, a 0-d tensor on the parameter's device, made
  again only when the learning rate changes;
* ``apply(params, grads, state, scalars)``, the update in place, in the
  order of operations of ``torch.optim``'s single-tensor step (``lerp_``,
  ``mul_``/``addcmul_``, ``sqrt``/division/``add_``, then ``addcdiv_``, here
  its CPU arithmetic in three operations, since its factor is a tensor;
  SGD's ``add_(grad, alpha=-lr)`` as ``addcmul_(grad, -lr)``, the same
  fused multiply-add); it returns which parameters had a gradient and, for
  SGD's first step with momentum, the new momentum buffers;
* ``commit(...)``, on the host: the step counts of those parameters, and the
  new buffers into the state.

On the CPU the update equals ``torch.optim``'s single-tensor step to the
bit. The other hyperparameters (betas, eps, weight decay, maximize, SGD's
momentum, dampening and nesterov) are statics of a trace: changing one
traces the step again. Another optimizer class, Adam or SGD with an option
that this function does not cover (``amsgrad``, ``capturable``,
``differentiable``, ``fused``, decoupled weight decay, a tensor learning
rate), or parameter groups that are not ``params`` (a subset of them, or
other tensors) has no ``Update`` (``of`` returns None): its ``step()`` runs
outside the trace.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.optim.optimizer import _get_scalar_dtype

__all__ = ["Update"]

State = List[Dict[str, torch.Tensor]]


def _plain(group: Dict[str, Any]) -> bool:
    return (not group.get("differentiable") and not group.get("fused") and not group.get("capturable")
            and not isinstance(group["lr"], torch.Tensor))


class Update:
    """The update of one optimizer's parameters (see the module docstring)."""

    def __init__(self, optimizer: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                 groups: Sequence[Dict[str, Any]]) -> None:
        self.optimizer = optimizer
        self.adam = type(optimizer) is torch.optim.Adam
        self.params: List[torch.Tensor] = list(params)
        self.groups: List[Dict[str, Any]] = list(groups)  # each parameter's group
        self._neg_lr: Dict[int, Tuple[Any, torch.Tensor]] = {}  # SGD: by parameter, (lr, dtype, device) and -lr

    @classmethod
    def of(cls, optimizer: Optional[torch.optim.Optimizer], params: Sequence[torch.Tensor]) -> Optional["Update"]:
        """The update of ``optimizer`` over ``params`` (see the module
        docstring), or None where its ``step()`` must run."""
        if optimizer is None:
            return None
        group_of = {id(p): g for g in optimizer.param_groups for p in g["params"]}
        if len(group_of) != len(params) or any(group_of.get(id(p)) is None for p in params):
            return None  # the groups are not the caller's tensors: apply could not pair them
        if type(optimizer) is torch.optim.Adam:
            ok = all(_plain(g) and not g["amsgrad"] and not g.get("decoupled_weight_decay")
                     and not any(isinstance(b, torch.Tensor) for b in g["betas"]) for g in optimizer.param_groups)
        elif type(optimizer) is torch.optim.SGD:
            ok = all(_plain(g) for g in optimizer.param_groups)
        else:
            ok = False
        return cls(optimizer, params, [group_of[id(p)] for p in params]) if ok else None

    def statics(self) -> Tuple[Any, ...]:
        """What a trace of ``apply`` reads as constants: the hyperparameters."""
        keys = ("betas", "eps", "weight_decay", "maximize") if self.adam else (
            "momentum", "dampening", "nesterov", "weight_decay", "maximize")
        return tuple(tuple(g[k] for k in keys) for g in self.groups)

    def prepare(self) -> Tuple[State, List[Optional[torch.Tensor]]]:
        """The state tensors that ``apply`` updates, by parameter, and this
        step's scalars."""
        state, scalars = [], []
        for i, (p, g) in enumerate(zip(self.params, self.groups)):
            s = self.optimizer.state[p]
            if self.adam:
                if not s:
                    s["step"] = torch.tensor(0.0, dtype=_get_scalar_dtype())  # on the host, as torch.optim keeps it
                    s["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    s["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                beta1, beta2 = g["betas"]
                step = float(s["step"]) + 1  # a CPU tensor: no synchronisation
                step_size = g["lr"] / (1 - beta1 ** step)
                bias_correction2_sqrt = (1 - beta2 ** step) ** 0.5
                state.append({"exp_avg": s["exp_avg"], "exp_avg_sq": s["exp_avg_sq"]})
                scalars.append(torch.tensor([-step_size, bias_correction2_sqrt], dtype=torch.float64))
            else:
                buf = s.get("momentum_buffer")
                state.append({} if buf is None else {"momentum_buffer": buf})
                key = (g["lr"], p.dtype, p.device)
                if self._neg_lr.get(i, (None,))[0] != key:
                    # rounded to the parameter's type as torch.optim's alpha is
                    self._neg_lr[i] = key, torch.full((), -g["lr"], dtype=p.dtype, device=p.device)
                scalars.append(self._neg_lr[i][1])
        return state, scalars

    def apply(self, params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]], state: State,
              scalars: Sequence[Optional[torch.Tensor]]) -> Tuple[Tuple[bool, ...], Tuple[Optional[torch.Tensor], ...]]:
        """The update of ``params`` in place from ``grads`` (None: the
        parameter is left, as ``torch.optim`` leaves a parameter without a
        gradient); returns which had a gradient and SGD's new momentum
        buffers (None where it had one or takes none)."""
        new_buffers: List[Optional[torch.Tensor]] = []
        with torch.no_grad():
            for p, grad, s, scalar, g in zip(params, grads, state, scalars, self.groups):
                new_buffers.append(None)
                if grad is None:
                    continue
                if g["maximize"]:
                    grad = -grad
                if g["weight_decay"] != 0:
                    grad = grad.add(p, alpha=g["weight_decay"])
                if self.adam:
                    beta1, beta2 = g["betas"]
                    exp_avg, exp_avg_sq = s["exp_avg"], s["exp_avg_sq"]
                    exp_avg.lerp_(grad, 1 - beta1)
                    exp_avg_sq.mul_(beta2).addcmul_(grad, grad, value=1 - beta2)
                    neg_step_size, bias_correction2_sqrt = scalar.to(p.dtype).unbind()
                    denom = (exp_avg_sq.sqrt() / bias_correction2_sqrt).add_(g["eps"])
                    # addcdiv_(exp_avg, denom, value=-step_size) as the CPU computes it,
                    # self + (value * t1) / t2, with the value a tensor
                    p.add_(exp_avg * neg_step_size / denom)
                    continue
                if g["momentum"] != 0:
                    buf = s.get("momentum_buffer")
                    if buf is None:
                        buf = new_buffers[-1] = grad.detach().clone()
                    else:
                        buf.mul_(g["momentum"]).add_(grad, alpha=1 - g["dampening"])
                    grad = grad.add(buf, alpha=g["momentum"]) if g["nesterov"] else buf
                p.addcmul_(grad, scalar)  # add_(grad, alpha=-lr), with the rate an input
        return tuple(gr is not None for gr in grads), tuple(new_buffers)

    def commit(self, present: Sequence[bool], new_buffers: Sequence[Optional[torch.Tensor]]) -> None:
        """After a step: the counts of the parameters that had a gradient, and
        SGD's new momentum buffers into the state."""
        for p, had, buf in zip(self.params, present, new_buffers):
            s = self.optimizer.state[p]
            if had and self.adam:
                s["step"] += 1
            if buf is not None:
                s["momentum_buffer"] = buf

    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """One eager update of the optimizer's own parameters."""
        state, scalars = self.prepare()
        self.commit(*self.apply(self.params, grads, state, scalars))
