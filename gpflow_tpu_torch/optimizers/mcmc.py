"""MCMC over a model's parameters (counterpart of ``gpflow_tpu/optimizers/mcmc.py``).

``SamplingHelper`` exposes the unconstrained values of parameters that carry
priors as the chain state, and a pure ``target_log_prob_fn`` of that state:
the model's log posterior density plus the log-det-Jacobians of the
parameters' transforms. ``run_hmc`` samples such a target with Hamiltonian
Monte Carlo, optionally adapting the step size during burn-in by dual
averaging (Hoffman and Gelman 2014). The chain runs on the state's device,
one replay of a traced step (``_compile.jit``) per step: the momenta and
the accept draws come from a ``torch.Generator`` there, and the accept
test, the selection of the state and the adaptation are device
operations, so no step waits for the device.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from .. import _compile
from .._compile import jit
from ..base import Parameter, functionalize

__all__ = ["SamplingHelper", "run_hmc"]

State = Tuple[torch.Tensor, ...]


class SamplingHelper:
    """Bridges a model's Parameters and a sampler over their unconstrained
    values (``gpflow_tpu/optimizers/mcmc.py:24-88``)::

        helper = SamplingHelper(model.log_posterior_density, model.trainable_parameters)
        samples, log_probs = run_hmc(helper.target_log_prob_fn, helper.current_state,
                                     num_samples=500, num_burnin_steps=300, step_size=0.01)
        constrained = helper.convert_to_constrained_values(samples)
    """

    def __init__(self, target_log_prob_fn: Callable[[], torch.Tensor], parameters: Sequence[Parameter]) -> None:
        if not all(isinstance(p, Parameter) and p.prior is not None for p in parameters):
            raise ValueError("`parameters` should only contain gpflow_tpu_torch.Parameter objects with priors")
        self._parameters = tuple(parameters)
        self._model_log_prob_fn = target_log_prob_fn

    @property
    def current_state(self) -> State:
        """Copies of the parameters' unconstrained values: the chain's start."""
        return tuple(p.unconstrained.detach().clone() for p in self._parameters)

    @property
    def target_log_prob_fn(self) -> Callable[..., torch.Tensor]:
        """A pure function of the unconstrained state: the log posterior
        density plus the summed forward log-det-Jacobians of the transforms
        (the change of variables to the unconstrained space). The state's
        tensors stand in for the parameters only during the call."""
        parameters = self._parameters
        model_log_prob_fn = self._model_log_prob_fn

        def _posterior_plus_jacobians() -> torch.Tensor:
            log_prob = model_log_prob_fn()
            for p in parameters:
                log_prob = log_prob + torch.sum(p.transform.forward_log_det_jacobian(p.unconstrained))
            return log_prob

        fn = functionalize(_posterior_plus_jacobians, parameters)

        def _target_log_prob_fn(*unconstrained: torch.Tensor) -> torch.Tensor:
            return fn(unconstrained)

        return _target_log_prob_fn

    def convert_to_constrained_values(self, hmc_samples: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        """The sampled unconstrained values through the parameters' transforms."""
        return [p.transform.forward(sample) for sample, p in zip(hmc_samples, self._parameters)]

    def assign_values(self, state: Sequence[torch.Tensor]) -> None:
        """Writes an unconstrained state into the parameters."""
        for p, v in zip(self._parameters, state):
            p.assign_unconstrained(v)


def _value_and_grad(target_log_prob_fn: Callable[..., torch.Tensor], q: State) -> Tuple[torch.Tensor, State]:
    """The target at q and its gradient with respect to each part of q (zero
    for a part the target does not read)."""
    q = tuple(qi.detach().requires_grad_(True) for qi in q)
    with torch.enable_grad():
        logp = target_log_prob_fn(*q)
        grads = torch.autograd.grad(logp, q, allow_unused=True)
    return logp.detach(), tuple(torch.zeros_like(qi) if g is None else g for qi, g in zip(q, grads))


def _leapfrog(
    value_and_grad: Callable[[State], Tuple[torch.Tensor, State]],
    q: State,
    p: State,
    g: State,
    step: torch.Tensor,
    num_leapfrog_steps: int,
) -> Tuple[State, State, torch.Tensor, State]:
    """``num_leapfrog_steps`` leapfrog steps from position q and momentum p,
    g the gradient at q (``gpflow_tpu/optimizers/mcmc.py:121-133``). Returns
    the new position and momentum and the target and its gradient at the
    new position: ``num_leapfrog_steps`` evaluations of the gradient."""
    p = tuple(pi + 0.5 * step * gi for pi, gi in zip(p, g))
    for _ in range(num_leapfrog_steps - 1):
        q = tuple(qi + step * pi for qi, pi in zip(q, p))
        _, g = value_and_grad(q)
        p = tuple(pi + step * gi for pi, gi in zip(p, g))
    q = tuple(qi + step * pi for qi, pi in zip(q, p))
    logp, g = value_and_grad(q)
    p = tuple(pi + 0.5 * step * gi for pi, gi in zip(p, g))
    return q, p, logp, g


def _kinetic(p: State) -> torch.Tensor:
    return sum(0.5 * torch.sum(torch.square(pi)) for pi in p)


def _hmc_step(
    target_log_prob_fn: Callable[..., torch.Tensor],
    generator: torch.Generator,
    num_leapfrog_steps: int,
    da_mu: float,
    target_accept: float,
    q: State,
    g: State,
    logp: torch.Tensor,
    log_step: torch.Tensor,
    log_step_avg: torch.Tensor,
    h_stat: torch.Tensor,
    da: torch.Tensor,
) -> Tuple[State, State, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One HMC step from position q with its gradient g and target logp
    (``gpflow_tpu/optimizers/mcmc.py:137-181``): a standard normal momentum
    for each part of q, ``num_leapfrog_steps`` leapfrog steps of size
    exp(log_step), the Metropolis test on the energy (a trajectory whose
    energy is not finite is rejected) against a uniform draw, and the
    selection of q, g and logp; then the dual-averaging update of the
    step-size statistics from ``da`` (1 - eta, eta, sqrt(t) / gamma, w and
    1 - w of step t, computed on the host), which the caller keeps during an
    adapting chain's burn-in only, as the JAX package's ``jnp.where(in_burnin,
    ...)`` does: one signature serves every step. The draws go through
    ``_compile.randn`` and ``_compile.rand``, so that a replay of a trace of
    this step draws them afresh from ``generator``, in this order."""
    device = q[0].device

    def value_and_grad(state: State) -> Tuple[torch.Tensor, State]:
        return _value_and_grad(target_log_prob_fn, state)

    p0 = tuple(_compile.randn(qi.shape, generator=generator, dtype=qi.dtype, device=device) for qi in q)
    q_new, p_new, logp_new, g_new = _leapfrog(value_and_grad, q, p0, g, torch.exp(log_step), num_leapfrog_steps)
    log_accept = (logp_new - _kinetic(p_new)) - (logp - _kinetic(p0))
    log_accept = torch.where(torch.isfinite(log_accept), log_accept, -math.inf)
    u = _compile.rand((), generator=generator, dtype=logp.dtype, device=device)
    accept = torch.log(u) < log_accept
    q = tuple(torch.where(accept, qn, qo) for qn, qo in zip(q_new, q))
    g = tuple(torch.where(accept, gn, go) for gn, go in zip(g_new, g))
    logp = torch.where(accept, logp_new, logp)
    # dual averaging (Hoffman and Gelman 2014, Algorithm 5)
    accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
    h_stat = da[0] * h_stat + da[1] * (target_accept - accept_prob)
    log_step = da_mu - da[2] * h_stat
    log_step_avg = da[3] * log_step + da[4] * log_step_avg
    return q, g, logp, log_step, log_step_avg, h_stat


def run_hmc(
    target_log_prob_fn: Callable[..., torch.Tensor],
    current_state: Sequence[torch.Tensor],
    num_samples: int,
    num_burnin_steps: int = 0,
    step_size: float = 0.01,
    num_leapfrog_steps: int = 10,
    generator: Optional[torch.Generator] = None,
    thin: int = 1,
    adapt_step_size: bool = False,
    target_accept: float = 0.75,
) -> Tuple[State, torch.Tensor]:
    """Hamiltonian Monte Carlo over a tuple-state target
    (``gpflow_tpu/optimizers/mcmc.py:91-216``). Returns the kept samples, one
    tensor [num_samples, ...] per part of the state, and their log
    probabilities [num_samples]; a sample is kept after each ``thin`` steps
    that follow the ``num_burnin_steps`` steps, and only kept samples are
    stored.

    Each step (``_hmc_step``) draws a standard normal momentum, runs
    ``num_leapfrog_steps`` leapfrog steps and accepts by the Metropolis test
    on the energy; a trajectory whose energy is not finite (a failed
    Cholesky gives NaN) is rejected. The gradient at the current state is
    carried from the step before, so a step evaluates the gradient
    ``num_leapfrog_steps`` times. ``adapt_step_size=True`` tunes the step
    toward ``target_accept`` during burn-in by dual averaging and freezes
    the averaged step from the first step after it. The draws come from
    ``generator``, else from a new generator on the state's device seeded 0.

    The step is traced once by ``_compile.jit`` and replayed at every step,
    as the JAX package jits its scan of ``hmc_step``; the dual-averaging
    scalars of step t are computed on the host and passed in as a CPU
    tensor, the host keeps the step-size statistics during burn-in only, and
    the kept samples are copied outside the trace. A target that cannot be
    traced raises ``TraceError``."""
    q = tuple(s.detach() for s in current_state)
    device = q[0].device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    logp, g = _value_and_grad(target_log_prob_fn, q)
    f_dtype = logp.dtype
    # dual-averaging constants (Hoffman and Gelman 2014, Algorithm 5)
    da_mu = math.log(10.0 * step_size)
    da_gamma, da_t0, da_kappa = 0.05, 10.0, 0.75
    log_step = torch.full((), math.log(step_size), dtype=f_dtype, device=device)
    log_step_avg = log_step.clone()
    h_stat = torch.zeros((), dtype=f_dtype, device=device)

    def hmc_step(q: State, g: State, logp: torch.Tensor, log_step: torch.Tensor, log_step_avg: torch.Tensor,
                 h_stat: torch.Tensor, da: torch.Tensor) -> Tuple[Any, ...]:
        return _hmc_step(target_log_prob_fn, generator, num_leapfrog_steps, da_mu, target_accept, q, g, logp,
                         log_step, log_step_avg, h_stat, da)

    step = jit(hmc_step)
    samples = tuple(torch.empty((num_samples,) + qi.shape, dtype=qi.dtype, device=device) for qi in q)
    log_probs = torch.empty((num_samples,), dtype=f_dtype, device=device)
    frozen = torch.zeros((5,), dtype=f_dtype)  # the scalars of a step that does not adapt (its update is dropped)
    for i in range(num_burnin_steps + num_samples * thin):
        t = i + 1 if i < num_burnin_steps else 0  # 1-based step of the burn-in, 0 after it
        adapt = adapt_step_size and t > 0
        da = frozen
        if adapt:
            eta, w = 1.0 / (t + da_t0), t ** (-da_kappa)
            # on the host, as Python floats rounded once to the chain's type: no device work
            da = torch.tensor([1.0 - eta, eta, math.sqrt(t) / da_gamma, w, 1.0 - w], dtype=f_dtype)
        # during burn-in the adapted step, after it the frozen average
        used = log_step_avg if adapt_step_size and t == 0 else log_step
        q, g, logp, *statistics = step(q, g, logp, used, log_step_avg, h_stat, da)
        if adapt:
            log_step, log_step_avg, h_stat = statistics

        kept = i - num_burnin_steps + 1
        if kept > 0 and kept % thin == 0:
            j = kept // thin - 1
            for out, qi in zip(samples, q):
                out[j].copy_(qi)
            log_probs[j].copy_(logp)
    return samples, log_probs
