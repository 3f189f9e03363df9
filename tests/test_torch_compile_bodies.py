"""The bodies that the JAX package traces and the port now traces too, on the
CPU, in float64, at small sizes and one torch thread: ``run_hmc``'s step,
the optimizer's update inside ``DataParallelTrainer``'s and
``training_loop``'s traced step (the trainer's also on a one-rank mesh),
and CGLB's conjugate-gradient loop as a traced ``while_loop`` with a
``cond`` restart.

For each: the Python body runs once per signature; a value change replays
and a shape or static change traces again; the traced result equals the
eager port's (the same function without ``jit``, reached by monkeypatching)
to the bit; and it equals the JAX package's jitted function within 1e-12.
HMC's draws differ between the packages (ROADMAP Queue 3, "the draws"), so
HMC meets JAX through its steps fed one momentum and one uniform on both
sides; the port's replayed draws are fresh at every step and equal to the
eager chain's."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch
from gpflow_tpu.base import functionalize as jax_functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import _compile, config, kernels, likelihoods, priors
from gpflow_tpu_torch._compile import TraceError, jit
from gpflow_tpu_torch._optim import Update
from gpflow_tpu_torch.models import CGLB, SGPMC, SVGP
from gpflow_tpu_torch.models import cglb as cglb_module
from gpflow_tpu_torch.optimizers import SamplingHelper, Scipy, mcmc, run_hmc
from gpflow_tpu_torch.parallel import DataParallelTrainer
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict, training_loop
from gpflow_tpu_torch.utilities import read_values as port_read_values
from .test_torch_environment import one_thread, reference_jit  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

N, D, M = 20, 2, 5
_rng = np.random.RandomState(0)
X = _rng.randn(N, D)
Y = np.sin(X[:, :1]) + 0.1 * _rng.randn(N, 1)
Yb = (Y > 0).astype(float)
Z = X[:M].copy()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _equal(got, want):
    """Equal to the bit: every tensor of two (nested) results."""
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _equal(got[k], want[k])
    else:
        g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        w = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
        np.testing.assert_array_equal(g, w)


def _close(got, want, rtol=1e-12, scale=None):
    """Within ``rtol``, an absolute ``rtol * scale`` (by default the largest
    |want|) for entries near zero."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.max(np.abs(want)), 1e-300) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _counting(monkeypatch, owner, name):
    """Counts the calls of ``owner.name`` (a body run)."""
    calls = []
    original = getattr(owner, name)

    @functools.wraps(original)
    def counted(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(owner, name, counted)
    return calls


def _jits(monkeypatch, module):
    """The ``jit`` objects that ``module`` makes, kept as it makes them."""
    made = []

    def keeping(fun, **kwargs):
        made.append(jit(fun, **kwargs))
        return made[-1]

    monkeypatch.setattr(module, "jit", keeping)
    return made


# --- run_hmc ----------------------------------------------------------------------------

# a two-part target: x [3] Gaussian with precisions, y [2, 2] a smooth
# non-Gaussian density, written once for each package
PREC = np.array([1.0, 4.0, 0.5])


def _target(x, y):
    return -0.5 * torch.sum(_t(PREC) * x ** 2) - torch.sum(torch.log(torch.cosh(y))) - 0.1 * torch.sum(y ** 4)


def _jax_target(x, y):
    return -0.5 * jnp.sum(PREC * x ** 2) - jnp.sum(jnp.log(jnp.cosh(y))) - 0.1 * jnp.sum(y ** 4)


STATE = (np.array([0.3, -0.2, 1.0]), np.array([[0.5, -0.4], [0.1, 0.2]]))
HMC_RUNS = {"adapting": {"num_burnin_steps": 4, "num_samples": 3, "adapt_step_size": True, "thin": 1},
            "fixed, thin 2": {"num_burnin_steps": 2, "num_samples": 3, "adapt_step_size": False, "thin": 2}}


def _chain(options, traced, monkeypatch, target=_target, state=STATE):
    """A seeded chain, traced (as ``run_hmc`` runs) or eager (``jit`` the
    identity); the step body's runs, the jits made, and each step's draws."""
    with monkeypatch.context() as mp:
        calls = _counting(mp, mcmc, "_hmc_step")
        made = []
        if traced:
            made = _jits(mp, mcmc)
        else:
            mp.setattr(mcmc, "jit", lambda fun: fun)
        drawn = []
        original = _compile.draws

        def recording(specs):
            drawn.append(original(specs))
            return drawn[-1]

        mp.setattr(_compile, "draws", recording)
        out = run_hmc(target, tuple(_t(s) for s in state), step_size=0.2, num_leapfrog_steps=3,
                      generator=torch.Generator().manual_seed(5), **options)
    return out, len(calls), made, drawn


@pytest.mark.parametrize("run", sorted(HMC_RUNS))
def test_run_hmc_traces_each_step_signature_once_and_replays_the_eager_bits(run, monkeypatch):
    options = HMC_RUNS[run]
    steps = options["num_burnin_steps"] + options["num_samples"] * options["thin"]
    traced, calls, made, drawn = _chain(options, True, monkeypatch)
    # one signature: burn-in and after it differ in values (the scalars, which statistics the host keeps)
    assert calls == 1 and len(made) == 1 and made[0].trace_count == 1
    eager, eager_calls, _, _ = _chain(options, False, monkeypatch)
    assert eager_calls == steps
    _equal(traced, eager)
    # every step's draws are the replay's inputs, drawn afresh: the momentum's
    # two parts, then the uniform, as the eager step draws them
    assert len(drawn) == steps and all(len(d) == 3 for d in drawn)
    generator = torch.Generator().manual_seed(5)
    for d in drawn:
        want = [torch.randn(s.shape, generator=generator, dtype=torch.float64) for s in STATE]
        want.append(torch.rand((), generator=generator, dtype=torch.float64))
        _equal(d, want)
    assert not torch.equal(drawn[0][0], drawn[1][0])
    samples, log_probs = traced
    assert samples[1].shape == (options["num_samples"], 2, 2) and log_probs.shape == (options["num_samples"],)


def test_run_hmc_on_a_model_replays_the_eager_bits(monkeypatch):
    """SGPMC (Bernoulli, Z frozen) through ``SamplingHelper``: the model's
    data and its frozen Z are constants of the trace, the state's tensors go
    in the parameters' place."""
    results = []
    for traced in (True, False):
        k = kernels.Matern32(lengthscales=[0.8, 1.3])
        k.variance.prior = priors.LogNormal(0.0, 1.0)
        k.lengthscales.prior = priors.LogNormal(0.0, 1.0)
        m = SGPMC((X, Yb), kernel=k, likelihood=likelihoods.Bernoulli(), inducing_variable=Z.copy())
        m.inducing_variable.Z.trainable = False
        with monkeypatch.context() as mp:
            calls = _counting(mp, SGPMC, "log_posterior_density")
            helper = SamplingHelper(m.log_posterior_density, m.trainable_parameters)
            if not traced:
                mp.setattr(mcmc, "jit", lambda fun: fun)
            results.append(run_hmc(helper.target_log_prob_fn, helper.current_state, num_samples=2,
                                   num_burnin_steps=1, step_size=0.05, num_leapfrog_steps=2,
                                   generator=torch.Generator().manual_seed(1), adapt_step_size=True))
        # the value and gradient at the start, then 2 a step: once when traced
        assert len(calls) == (1 + 2 if traced else 1 + 3 * 2)
    _equal(results[0], results[1])


def test_run_hmc_steps_match_the_jitted_jax_steps(monkeypatch):
    """One burn-in step that adapts and two kept steps, each fed the same
    momentum and uniform on both sides: JAX's ``run_hmc`` (its scan, jitted)
    with ``jax.random.normal`` and ``uniform`` giving them, the port's with
    ``_compile.draws`` giving them."""
    rng = np.random.RandomState(7)
    momentum = {s.shape: rng.randn(*s.shape) for s in STATE}
    u = 0.4
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(momentum[tuple(shape)], dtype))
        mp.setattr(jax.random, "uniform", lambda key, shape, dtype: jnp.full(shape, u, dtype))
        want = gpflow_tpu.optimizers.run_hmc(_jax_target, tuple(jnp.asarray(s) for s in STATE), num_samples=2,
                                            num_burnin_steps=1, step_size=0.2, num_leapfrog_steps=3,
                                            key=jax.random.PRNGKey(0), adapt_step_size=True)
    fed = [_t(momentum[s.shape]) for s in STATE] + [torch.tensor(u, dtype=torch.float64)]
    monkeypatch.setattr(_compile, "draws", lambda specs: [f.clone() for f in fed])
    got = run_hmc(_target, tuple(_t(s) for s in STATE), num_samples=2, num_burnin_steps=1, step_size=0.2,
                  num_leapfrog_steps=3, adapt_step_size=True)
    (gx, gy), glp = got
    (wx, wy), wlp = want
    for g, w in ((gx, wx), (gy, wy), (glp, wlp)):
        _close(g, w)
    assert not np.allclose(np.asarray(wx[0]), STATE[0])  # the steps moved: the test compares trajectories


def test_run_hmc_refuses_a_target_that_reads_a_value_on_the_host():
    def target(x, y):
        return _target(x, y) * float(torch.sum(x))

    with pytest.raises(TraceError, match="reads a tensor's value on the host"):
        run_hmc(target, tuple(_t(s) for s in STATE), num_samples=1, step_size=0.1, num_leapfrog_steps=2)


# --- the trainer and training_loop -----------------------------------------------------------

OPTIMIZERS = {
    "adam": lambda params: torch.optim.Adam(params, lr=0.01, betas=(0.9, 0.999), eps=1e-8),
    "sgd": lambda params: torch.optim.SGD(params, lr=0.05),
    "sgd momentum": lambda params: torch.optim.SGD(params, lr=0.05, momentum=0.9, dampening=0.1, nesterov=False),
}
JAX_OPTIMIZERS = {"adam": optax.adam(0.01), "sgd": optax.sgd(0.05)}


def _svgp(likelihood="Gaussian"):
    """A JAX SVGP and its port with the same values (Matern52), q(u) drawn
    from a seed: at q_mu = 0, q_sqrt = I the lengthscale's gradient is 0, and
    Adam's first step, g / (|g| + eps), turns a rounding error of it into
    one of 1e-11 in the step."""
    pl = {"Gaussian": lambda: likelihoods.Gaussian(0.1), "Bernoulli": likelihoods.Bernoulli}[likelihood]()
    pm = SVGP(kernel=kernels.Matern52(lengthscales=0.8), likelihood=pl, inducing_variable=Z.copy(), num_data=N)
    jl = {"Gaussian": lambda: gpflow_tpu.likelihoods.Gaussian(0.1),
          "Bernoulli": gpflow_tpu.likelihoods.Bernoulli}[likelihood]()
    jm = gpflow_tpu.models.SVGP(kernel=gpflow_tpu.kernels.Matern52(lengthscales=0.8), likelihood=jl,
                                inducing_variable=Z.copy(), num_data=N)
    rng = np.random.RandomState(11)
    jm.q_mu.assign(0.5 * rng.randn(M, 1))
    jm.q_sqrt.assign((np.tril(0.2 * rng.randn(M, M), -1) + np.diag(0.5 + rng.rand(M)))[None])
    load_jax_values(pm, read_values(jm))
    return jm, pm


def _no_step(monkeypatch):
    """``torch.optim``'s own step raises: the update must run in the trace."""
    for cls in (torch.optim.Adam, torch.optim.SGD):
        monkeypatch.setattr(cls, "step", lambda self, closure=None: pytest.fail("torch.optim's step() ran"))


def _opt_state(optimizer):
    return {i: dict(s) for i, s in optimizer.state_dict()["state"].items()}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_trainer_traces_the_update_once_per_signature_and_replays_the_eager_bits(name, monkeypatch):
    calls = _counting(monkeypatch, SVGP, "_training_loss")
    _no_step(monkeypatch)
    results = []
    for traced in (True, False):
        _, pm = _svgp()
        trainer = DataParallelTrainer(pm, OPTIMIZERS[name])
        assert trainer._update is not None
        if not traced:
            trainer._traced = trainer._model_step
        trainer.stage_data((X, Y))
        del calls[:]
        out = [trainer.run_steps_sampled(2, 8, torch.Generator().manual_seed(1)),
               trainer.step((X[:8], Y[:8])),
               trainer.run_steps((np.stack([X[:8], X[8:16]]), np.stack([Y[:8], Y[8:16]])))]
        # SGD with momentum: the first step makes its buffers, a signature of its own
        signatures = 2 if name == "sgd momentum" else 1
        if traced:
            assert len(calls) == signatures and trainer._traced.trace_count == signatures
            trainer.optimizer.param_groups[0]["lr"] = 0.02  # a value: an input of the trace
            trainer.step((X[:8], Y[:8]))
            assert trainer._traced.trace_count == signatures
            trainer.step((X[:5], Y[:5]))  # another shape
            assert trainer._traced.trace_count == signatures + 1
        else:
            assert len(calls) == 5
            trainer.optimizer.param_groups[0]["lr"] = 0.02
            trainer.step((X[:8], Y[:8]))
            trainer.step((X[:5], Y[:5]))
        out += [port_read_values(pm), _opt_state(trainer.optimizer)]
        results.append(out)
    _equal(results[0], results[1])


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_trainer_steps_match_the_jax_trainers_multi_step(name):
    """Three steps of ``run_steps`` on stacked batches against the JAX
    trainer's ``multi_step`` (its scan of steps, the optax update inside, on
    a one-device mesh): the losses and the parameters after them."""
    jm, pm = _svgp("Bernoulli")
    batches = (np.stack([X[:8], X[8:16], X[4:12]]), np.stack([Yb[:8], Yb[8:16], Yb[4:12]]))
    jt = gpflow_tpu.parallel.DataParallelTrainer(jm, JAX_OPTIMIZERS[name], mesh=gpflow_tpu.parallel.make_mesh(1))
    want = jt.run_steps(batches)
    jt.finalize()
    pt = DataParallelTrainer(pm, OPTIMIZERS[name])
    got = pt.run_steps(batches)
    assert pt._traced.trace_count == 1
    _close(got, want)
    values = read_values(jm)
    for k, v in port_read_values(pm).items():
        _close(v, values[k])


def test_trainer_state_round_trips_with_the_update_in_the_trace():
    """``state_dict`` reads the optimizer's own tensors that the replays
    update: a trainer restored from it takes the next steps to the bit."""
    _, pm = _svgp()
    trainer = DataParallelTrainer(pm, OPTIMIZERS["adam"])
    trainer.run_steps((np.stack([X[:8], X[8:16]]), np.stack([Y[:8], Y[8:16]])))
    saved = trainer.state_dict()
    assert len(saved) == len(trainer._params) + 3 * len(trainer._params)  # step and two moments each
    _, other = _svgp()
    restored = DataParallelTrainer(other, OPTIMIZERS["adam"])
    restored.load_state_dict(saved)
    _equal(restored.state_dict(), saved)
    batch = (X[4:12], Y[4:12])
    _equal([restored.step(batch), port_read_values(other)], [trainer.step(batch), port_read_values(pm)])


def test_trainer_with_another_optimizer_steps_outside_the_trace(monkeypatch):
    calls = _counting(monkeypatch, torch.optim.RMSprop, "step")
    results = []
    for traced in (True, False):
        _, pm = _svgp()
        trainer = DataParallelTrainer(pm, lambda params: torch.optim.RMSprop(params, lr=0.01))
        assert trainer._update is None
        if not traced:
            trainer._traced = trainer._model_step
        results.append([trainer.run_steps((np.stack([X[:8], X[8:16]]), np.stack([Y[:8], Y[8:16]]))),
                        port_read_values(pm)])
    assert len(calls) == 4
    _equal(results[0], results[1])


@pytest.fixture
def one_rank_mesh():
    """``make_mesh()`` with no process group: a one-rank gloo group on a
    ``HashStore``, destroyed after the test."""
    import torch.distributed as dist

    from gpflow_tpu_torch.parallel import make_mesh

    started = not dist.is_initialized()
    yield make_mesh()
    if started:
        dist.destroy_process_group()


@pytest.mark.parametrize("kw", [{}, {"natgrad_gamma": 0.1, "natgrad_fused": True}], ids=["plain", "fused natgrad"])
def test_trainer_on_a_one_rank_mesh_replays_the_bits_without_one(kw, one_rank_mesh):
    """The step traced on a one-rank mesh (its collectives copies) gives the
    losses, the parameters and the optimizer's state of the traced step
    without a mesh, to the bit, each with one trace; so does its loss."""
    results = []
    for mesh in (one_rank_mesh, None):
        _, pm = _svgp("Bernoulli" if kw else "Gaussian")
        trainer = DataParallelTrainer(pm, OPTIMIZERS["adam"], mesh=mesh, **kw)
        out = [trainer.run_steps((np.stack([X[:8], X[8:16]]), np.stack([Yb[:8], Yb[8:16]]))),
               trainer.step((X[4:12], Yb[4:12])), trainer.loss((X[:8], Yb[:8])), trainer.loss((X[8:16], Yb[8:16]))]
        assert (trainer._traced.trace_count, trainer._loss.trace_count) == (1, 1)
        results.append(out + [port_read_values(pm), _opt_state(trainer.optimizer)])
    _equal(results[0], results[1])


def _gathered_object(value):
    import torch.distributed as dist

    out = [None]
    dist.all_gather_object(out, value)
    return value


@pytest.mark.parametrize("read", [float, _gathered_object], ids=["float", "all_gather_object"])
def test_a_mesh_step_that_reads_a_value_on_the_host_raises(read, one_rank_mesh, monkeypatch):
    """A float of a tensor, or a collective of Python objects (which pickles
    its tensor), in a mesh step: no eager step in its place, the parameters
    stay as they were."""
    _, pm = _svgp()
    loss = SVGP._training_loss
    monkeypatch.setattr(SVGP, "_training_loss", lambda self, batch: loss(self, batch) * read(self.q_mu.value[0, 0]))
    trainer = DataParallelTrainer(pm, OPTIMIZERS["adam"], mesh=one_rank_mesh)
    before = port_read_values(pm)
    with pytest.raises(TraceError, match="on the host"):
        trainer.step((X[:8], Y[:8]))
    _equal(port_read_values(pm), before)
    assert not hasattr(pm, "_row_blocks")


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("kw", [{"compile": True}, {"use_scan": True}])
def test_training_loop_traces_the_update_and_replays_the_eager_bits(kw, name, monkeypatch):
    _no_step(monkeypatch)
    histories, states = [], []
    for options in (kw, {}):
        _, pm = _svgp()
        runs = [0]

        def closure():
            runs[0] += 1
            return pm.training_loss((X, Y))

        histories.append(training_loop(closure, OPTIMIZERS[name], var_list=pm.trainable_parameters, maxiter=4,
                                       **options))
        states.append(port_read_values(pm))
        signatures = 2 if name == "sgd momentum" else 1
        assert runs[0] == (signatures if options else 4)
    _equal(histories[0], histories[1])
    _equal(states[0], states[1])


def _two_groups(cls, **kwargs):
    """A factory of two parameter groups that hold the caller's tensors in
    reversed order, the first with a learning rate of its own."""
    def factory(params):
        params = list(params)[::-1]
        return cls([{"params": params[:1], "lr": 0.03}, {"params": params[1:]}], **kwargs)

    return factory


GROUPED = {
    "adam, two groups reversed": _two_groups(torch.optim.Adam, lr=0.01),
    "sgd momentum, two groups reversed": _two_groups(torch.optim.SGD, lr=0.05, momentum=0.9),
    "adam over a subset": lambda params: torch.optim.Adam(list(params)[1:], lr=0.01),
}


@pytest.mark.parametrize("name", sorted(GROUPED))
def test_training_loop_pairs_the_factorys_groups_with_its_tensors(name, monkeypatch):
    """The update pairs each tensor with its own state and group, whatever
    order the factory's parameter groups hold them in: the traced
    ``training_loop`` equals a hand loop of ``torch.optim``'s ``step()`` to
    the bit. A factory over a subset of the tensors has no ``Update``: its
    ``step()`` runs outside the trace, as the hand loop's."""
    subset = name.endswith("subset")
    cls = torch.optim.SGD if name.startswith("sgd") else torch.optim.Adam
    results = []
    for hand in (False, True):
        _, pm = _svgp()
        params = pm.trainable_parameters
        tensors = [p.unconstrained for p in params]
        if hand:
            opt = GROUPED[name](tensors)
            assert (Update.of(opt, tensors) is None) == subset
            history = []
            for _ in range(3):
                loss = pm.training_loss((X, Y))
                for t, g in zip(tensors, torch.autograd.grad(loss, tensors)):
                    t.grad = g
                opt.step()
                history.append(loss.detach())
            history = torch.stack(history)
        else:
            with monkeypatch.context() as mp:
                steps = _counting(mp, cls, "step")
                history = training_loop(lambda: pm.training_loss((X, Y)), GROUPED[name], var_list=params,
                                        maxiter=3, compile=True)
            assert len(steps) == (3 if subset else 0)
        results.append([history, port_read_values(pm)])
    _equal(results[0], results[1])


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_training_loop_matches_the_jax_scan(name):
    jm, pm = _svgp()
    want = gpflow_tpu.utilities.training_loop(lambda: jm.training_loss((X, Y)), JAX_OPTIMIZERS[name],
                                              var_list=jm.trainable_parameters, maxiter=3, use_scan=True)
    got = training_loop(lambda: pm.training_loss((X, Y)), OPTIMIZERS[name], var_list=pm.trainable_parameters,
                        maxiter=3, use_scan=True)
    _close(got, want)
    values = read_values(jm)
    for k, v in port_read_values(pm).items():
        _close(v, values[k])


# --- CGLB ------------------------------------------------------------------------------------

Y2 = np.c_[Y, np.cos(X[:, 1:]) + 0.1 * _rng.randn(N, 1)]  # two outputs: the CG's columns step alone
CHUNKS = {"dense": None, "matrix-free": 10}


def _cglb(pkg, chunk, Y=Y2):
    kw = {} if chunk is None else {"matrix_free_chunk": chunk}
    return pkg.models.CGLB((X, Y), kernel=pkg.kernels.Matern52(lengthscales=[0.8, 1.2]),
                           inducing_variable=Z.copy(), cg_tolerance=1e-9, restart_cg_iters=3, **kw)


def _value_and_grads(loss, model):
    return loss.detach(), torch.autograd.grad(loss, [p.unconstrained for p in model.trainable_parameters])


@pytest.mark.parametrize("mode", sorted(CHUNKS))
def test_cglb_closure_traces_once_and_replays_the_eager_bits(mode, monkeypatch):
    """Three evaluations with value changes between them: the traced closure
    runs its body once and writes no v back; the eager closure, its v reset
    to the start before each call (it writes v back), gives the same bits
    and CG iterations; a static change traces again."""
    calls = _counting(monkeypatch, cglb_module, "_cglb_conjugate_gradient")
    results = []
    for traced in (True, False):
        m = _cglb(gpflow_tpu_torch, CHUNKS[mode])
        start = m.aux_vec.numpy()
        closure = m.training_loss_closure(compile=traced)
        del calls[:]
        out = []
        for step in range(3):
            if not traced:
                m.aux_vec.assign(start)
            out.append(_value_and_grads(closure(), m) + (m.cg_iterations,))
            m.kernel.variance.assign(1.0 + 0.5 * step)  # a value change
        assert len(calls) == (1 if traced else 3)
        if traced:
            assert type(m.cg_iterations) is int and m._cg_iterations.device.type == "cpu"
            np.testing.assert_array_equal(m.aux_vec.numpy(), start)  # no write-back in a replay
            assert closure.traced.trace_count == 1
            if mode == "dense":
                m._restart_cg_iters = 4  # a static
                closure()
                assert closure.traced.trace_count == 2
        else:
            assert not np.array_equal(m.aux_vec.numpy(), start)  # the eager write-back
        results.append(out)
    assert all(o[-1] > 3 for o in results[0])  # the CG ran past a restart
    _equal(results[0], results[1])


@pytest.mark.parametrize("mode", sorted(CHUNKS))
def test_cglb_under_scipy_traces_once_and_replays_the_eager_bits(mode):
    """``Scipy``'s evaluations of CGLB at three points, traced (one trace
    for all) and eager (v reset to the start before each, as a replay
    leaves it)."""
    values = []
    for compile_ in (True, False):
        m = _cglb(gpflow_tpu_torch, CHUNKS[mode])
        start = m.aux_vec.numpy()
        opt = Scipy()
        func = opt.eval_func(m.training_loss, m.trainable_variables, compile=compile_)
        x0 = opt.initial_parameters(m.trainable_variables)
        out = []
        for shift in (0.0, 0.1, -0.2):
            m.aux_vec.assign(start)
            out.append(func(x0 + shift))
        if compile_:
            assert next(iter(opt.compile_cache.values()))[0].traced.trace_count == 1
        values.append(out)
    _equal(values[0], values[1])


@pytest.mark.parametrize("mode", sorted(CHUNKS))
def test_cglb_matches_the_jitted_jax_objective(mode):
    """The traced closure's value and gradients against ``jax.jit`` of the
    JAX package's (its CG a ``lax.while_loop``, v not written back under
    ``jit``), from the same v."""
    jm, pm = _cglb(gpflow_tpu, CHUNKS[mode]), _cglb(gpflow_tpu_torch, CHUNKS[mode])
    load_jax_values(pm, read_values(jm))
    jp, pp = jax_parameter_dict(jm), parameter_dict(pm)
    paths = sorted(k for k, p in pp.items() if p.trainable)
    fn = reference_jit(jax.value_and_grad(jax_functionalize(jm.training_loss, [jp[k] for k in paths])))
    want_loss, want_grads = fn(tuple(jp[k].unconstrained_variable for k in paths))
    loss = pm.training_loss_closure()()
    grads = torch.autograd.grad(loss, [pp[k].unconstrained for k in paths])
    _close(loss, want_loss)
    scale = max(float(np.max(np.abs(np.asarray(w)))) for w in want_grads)
    for g, w in zip(grads, want_grads):
        _close(g, w, scale=scale)
    assert not np.any(np.asarray(jm.aux_vec.unconstrained_variable)) and not np.any(pm.aux_vec.numpy())


def test_cglb_loop_launches_as_eager(monkeypatch):
    """On the CPU a counting implementation of each kernel's op stands in
    for K1 and K2: a replay of the matrix-free CGLB's value and gradient
    launches K1 for Kuu, Kuf and each block of every CG matvec inside the
    loop's node, then twice for each block of the bound's K v (forward and
    the checkpoint's backward), as the eager call does; K2 for Matern52's
    backward of Kuu, Kuf and each rebuilt block."""
    from gpflow_tpu_torch.ops import pallas_distance as pd

    counts = {"K1": 0, "K2": 0}

    def k1(family, Xs, Zs, variance, alpha):
        counts["K1"] += 1
        return pd.stationary_forward_plain(family, Xs, Zs, variance.reshape(()), alpha)

    def k2(family, Xs, Zs, variance, g):
        counts["K2"] += 1
        return pd.stationary_wgrad_plain(family, Xs, Zs, variance.reshape(()), g)

    lib = torch.library.Library("gpflow_tpu_torch", "IMPL")
    lib.impl("stationary_k1", k1, "CPU")
    lib.impl("stationary_k2", k2, "CPU")
    monkeypatch.setattr(pd, "_check_on_card", lambda *args: None)
    pd.set_pallas_enabled(True)
    try:
        config.set_default_float(torch.float32)
        try:
            m = CGLB((X.astype(np.float32), Y2.astype(np.float32)), kernel=kernels.Matern52(lengthscales=[0.8, 1.2]),
                     inducing_variable=Z.astype(np.float32), matrix_free_chunk=10, restart_cg_iters=3, cg_tolerance=1e-4)
        finally:
            config.set_default_float(torch.float64)
        start = m.aux_vec.numpy()
        blocks = -(-N // 10)
        results = []
        for closure in (m.training_loss_closure(compile=False), m.training_loss_closure(), m.training_loss_closure()):
            m.aux_vec.assign(start)
            before = dict(counts)
            results.append(_value_and_grads(closure(), m))
            it = m.cg_iterations
            matvecs = 1 + it + it // 3  # the first residual, one an iteration, one more at each restart
            assert counts["K1"] - before["K1"] == 2 + blocks * (matvecs + 2)
            assert counts["K2"] - before["K2"] == 2 + blocks
        assert it > 3
        _equal(results[0], results[1])
        _equal(results[1], results[2])
    finally:
        pd.set_pallas_enabled(None)
        lib._destroy()


# --- the loop and branch operators -------------------------------------------------------------


def test_while_loop_and_cond_trace_replay_and_refuse_what_they_cannot_hold():
    """``_compile.while_loop`` and ``cond`` eagerly and replayed, with a
    Module and a tensor passed in ``captured``: a value change replays the
    loop's node; a body that closes over a traced tensor instead, or draws
    inside the loop, raises with its reason."""
    from gpflow_tpu_torch.base import Module, Parameter

    class Scale(Module):
        def __init__(self):
            super().__init__()
            self.w = Parameter(np.array([0.5, 2.0]))

    def run(scale, x, limit):
        t = x * 2.0  # a traced tensor in a trace

        def keep_going(i, v, scale, t):
            return (torch.sum(torch.abs(v)) < limit) & (i < 50)

        def body(i, v, scale, t):
            v = _compile.cond(i % 2 == 0, lambda v, scale, t: v * scale.w.value + t, lambda v, scale, t: v - 0.1 * t,
                              (v,), (scale, t))
            return i + 1, v

        with torch.no_grad():
            return _compile.while_loop(keep_going, body, (torch.zeros((), dtype=torch.int64), x.clone()),
                                       (scale, t))

    scale, x = Scale(), _t(np.array([0.1, -0.3]))
    traced = jit(run)
    for limit in (30.0, 30.0):
        _equal(traced(scale, x, limit), run(scale, x, limit))
        scale.w.assign(np.array([0.6, 1.5]))
    assert traced.trace_count == 1

    def closes_over(x):
        t = x * 2.0
        return _compile.while_loop(lambda v: torch.sum(v) < 10.0, lambda v: (v + t,), (x.clone(),))

    with pytest.raises(TraceError, match="reads a traced tensor that it was not given"):
        jit(closes_over)(x)

    def draws_inside(x):
        g = torch.Generator().manual_seed(0)
        return _compile.while_loop(
            lambda v: torch.sum(v) < 10.0,
            lambda v: (v + _compile.rand((2,), generator=g, dtype=v.dtype, device=v.device),), (x.clone(),))

    with pytest.raises(TraceError, match="draws from a generator"):
        jit(draws_inside)(x)


def test_over_tensors_recomputes_a_checkpointed_block_from_its_forwards_tensors(monkeypatch):
    """A checkpointed block over a kernel's tensors (``_compile.over_tensors``,
    as CGLB's matrix-free blocks) under ``functionalize``: the forward, whose
    slots hold the tensors it is given, runs without the walk; the
    recomputation in the backward, after the parameters' own tensors are
    back, puts the forward's in their place, so that the gradient equals the
    block's without the checkpoint."""
    from torch.utils.checkpoint import checkpoint

    from gpflow_tpu_torch.base import functionalize

    k = kernels.Matern52(lengthscales=[0.8, 1.2])
    x = _t(X)
    params = list(k.trainable_parameters)
    walks = _counting(monkeypatch, _compile, "_capture_walk")

    def loss(checkpointed):
        if not checkpointed:
            return torch.sum(k.K(x, x[:7]) ** 2)
        block, tensors = _compile.over_tensors(lambda a, b, kern: kern.K(a, b) ** 2, 2, (k,))
        del walks[:]
        out = torch.sum(checkpoint(block, x, x[:7], *tensors, use_reentrant=False, preserve_rng_state=False))
        assert not walks  # the forward
        return out

    grads = []
    for checkpointed in (True, False):
        del walks[:]
        values = [(1.1 * p.unconstrained.detach()).requires_grad_(True) for p in params]  # not the parameters' own
        out = functionalize(lambda: loss(checkpointed), params)(values)
        grads.append(torch.autograd.grad(out, values))
        assert bool(walks) == checkpointed  # the recomputation put the forward's tensors back
    _equal(grads[0], grads[1])
