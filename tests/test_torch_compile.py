"""The port's compile layer (``gpflow_tpu_torch/_compile.py``) and the five
sites that trace with it, against the eager port and the JAX package on the
CPU, in float64, at small sizes and one torch thread.

For each site (``training_loss_closure``, ``Scipy``, ``NaturalGradient``,
``DataParallelTrainer`` without a mesh, ``training_loop``): the body runs
once over many calls of one signature; a shape, dtype or static change
traces again and a value change does not; the traced result equals the
eager port's to the bit and the jitted JAX function's within 1e-12; a
Monte-Carlo likelihood's draws are fresh at every replay and equal to the
eager draws. Then ``jit`` itself: the key, the cache bound and what it
refuses, with a reason."""
import functools

import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
from gpflow_tpu.base import functionalize as jax_functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import _compile, config, kernels, likelihoods
from gpflow_tpu_torch._compile import TraceError, jit
from gpflow_tpu_torch.base import Module, Parameter
from gpflow_tpu_torch.models import CGLB, GPR, SVGP
from gpflow_tpu_torch.optimizers import NaturalGradient, Scipy, natgrad
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


def _svgp(likelihood="Gaussian", whiten=True):
    """A JAX SVGP and its port with the same values (Matern52, so that both
    kernels' routes run); for GaussianMC, whose draws differ between the
    packages, the port's alone."""
    pl = {"Gaussian": lambda: likelihoods.Gaussian(0.1), "Bernoulli": likelihoods.Bernoulli,
          "GaussianMC": lambda: likelihoods.GaussianMC(0.1)}[likelihood]()
    pm = SVGP(kernel=kernels.Matern52(lengthscales=0.8), likelihood=pl, inducing_variable=Z.copy(),
              whiten=whiten, num_data=N)
    if likelihood == "GaussianMC":
        return None, pm
    jl = {"Gaussian": lambda: gpflow_tpu.likelihoods.Gaussian(0.1),
          "Bernoulli": gpflow_tpu.likelihoods.Bernoulli}[likelihood]()
    jm = gpflow_tpu.models.SVGP(kernel=gpflow_tpu.kernels.Matern52(lengthscales=0.8), likelihood=jl,
                                inducing_variable=Z.copy(), whiten=whiten, num_data=N)
    load_jax_values(pm, read_values(jm))
    return jm, pm


def _gpr():
    jm = gpflow_tpu.models.GPR((X, Y), kernel=gpflow_tpu.kernels.Matern52(lengthscales=[0.8, 1.2]))
    pm = GPR((X, Y), kernel=kernels.Matern52(lengthscales=[0.8, 1.2]))
    return jm, pm


def _grads(loss, model):
    return torch.autograd.grad(loss, [p.unconstrained for p in model.trainable_parameters])


def _paths(jm, pm):
    """The trainable Parameters of both models, in one order of their paths."""
    jp, pp = jax_parameter_dict(jm), parameter_dict(pm)
    paths = sorted(k for k, p in pp.items() if p.trainable)
    assert paths == sorted(k for k, p in jp.items() if p.trainable)
    return [jp[k] for k in paths], [pp[k] for k in paths]


def _jax_value_and_grads(params, closure):
    fn = reference_jit(jax.value_and_grad(jax_functionalize(closure, params)))
    return fn(tuple(p.unconstrained_variable for p in params))


def _counting(monkeypatch, cls, name):
    """Counts the calls of ``cls.name`` (a body run)."""
    calls = []
    original = getattr(cls, name)

    @functools.wraps(original)
    def counted(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(cls, name, counted)
    return calls


# --- training_loss_closure ------------------------------------------------------------


def test_closure_traces_once_and_replays_the_eager_bits(monkeypatch):
    calls = _counting(monkeypatch, SVGP, "_training_loss")
    results = []
    for compile_ in (True, False):
        _, pm = _svgp("Gaussian")
        closure = pm.training_loss_closure((X, Y), compile=compile_)
        del calls[:]
        out = []
        for step in range(4):
            loss = closure()
            out.append((loss, _grads(loss, pm)))
            pm.kernel.variance.assign(1.0 + 0.25 * step)  # a value change between calls
        assert len(calls) == (1 if compile_ else 4)
        results.append(out)
        if compile_:
            assert closure.traced.trace_count == 1
    _equal(results[0], results[1])


def test_closure_of_minibatches_retraces_only_on_a_new_signature():
    _, pm = _svgp()
    batches = iter([(X[:10], Y[:10]), (X[10:], Y[10:]), (X[:7], Y[:7]), (X[:10].astype(np.float32), Y[:10]),
                    (X[:10], Y[:10])])
    closure = pm.training_loss_closure(batches)
    counts = []
    for _ in range(5):
        closure()
        counts.append(closure.traced.trace_count)
    # new values: no trace; 7 rows: a trace; float32 X: a trace
    assert counts == [1, 1, 2, 3, 3]
    traced = pm.training_loss_closure((_t(X[:10]), _t(Y[:10])))
    traced()
    traced()
    assert traced.traced.trace_count == 1
    pm.whiten = False  # a static change
    traced()
    assert traced.traced.trace_count == 2


def test_closure_matches_the_jitted_jax_closure():
    jm, pm = _svgp("Gaussian", whiten=False)
    loss = pm.training_loss_closure((X, Y))()
    jax_params, port_params = _paths(jm, pm)
    # the JAX closure (jitted) inside one jitted value and gradient
    want_loss, want_grads = _jax_value_and_grads(jax_params, jm.training_loss_closure((X, Y)))
    _close(loss, want_loss)
    scale = max(float(np.max(np.abs(np.asarray(w)))) for w in want_grads)  # one gradient's scale
    for g, w in zip(torch.autograd.grad(loss, [p.unconstrained for p in port_params]), want_grads):
        _close(g, w, scale=scale)


def test_closure_draws_fresh_and_as_eager():
    _, pm = _svgp("GaussianMC")
    _, eager = _svgp("GaussianMC")
    closure = pm.training_loss_closure((X, Y))
    got = [closure() for _ in range(3)]
    want = [eager.training_loss_closure((X, Y), compile=False)() for _ in range(3)]
    _equal(got, want)
    assert closure.traced.trace_count == 1 and float(got[0]) != float(got[1])
    # the draws are inputs of the trace: the graph holds no generator (torch 2.11 cannot put one
    # in a graph)
    gm = next(iter(closure.traced.cache.values())).gm
    assert len(gm.draw_specs) == 1
    held = [getattr(gm, n.target) for n in gm.graph.nodes if n.op == "get_attr"]
    args = [a for n in gm.graph.nodes for a in (*n.args, *n.kwargs.values())]
    assert not any(isinstance(v, torch.Generator) for v in held + args)


# --- Scipy ----------------------------------------------------------------------------


def test_scipy_traces_once_and_replays_the_eager_bits():
    results, models = [], []
    for compile_ in (True, False):
        _, pm = _gpr()
        runs = [0]

        def closure():
            runs[0] += 1
            return pm.training_loss()

        opt = Scipy()
        result = opt.minimize(closure, pm.trainable_variables, compile=compile_, options={"maxiter": 8})
        results.append(result)
        models.append(pm)
        if compile_:
            assert runs[0] == 1 and result.nfev > 1  # one trace for every evaluation
            pm.kernel.variance.assign(1.3)  # a value change: the cached trace, from the new start
            again = opt.minimize(closure, pm.trainable_variables, options={"maxiter": 8})
            assert runs[0] == 1 and np.isfinite(again.fun)
        else:
            assert runs[0] == result.nfev
    assert results[0].nfev == results[1].nfev
    np.testing.assert_array_equal(results[0].x, results[1].x)
    assert results[0].fun == results[1].fun


def test_scipy_cache_is_keyed_as_jax_and_bounded_at_two():
    models = [_gpr()[1] for _ in range(3)]
    opt = Scipy()
    assert opt.compile_cache_size == 2
    for m in models:
        opt.minimize(m.training_loss, m.trainable_variables, options={"maxiter": 2})
    assert len(opt.compile_cache) == 2
    assert all(entry[0].traced.trace_count == 1 for entry in opt.compile_cache.values())
    m = models[-1]
    # another set of variables (a static of the key): another trace
    opt.minimize(m.training_loss, m.kernel.trainable_variables, options={"maxiter": 2})
    assert len(opt.compile_cache) == 2
    assert [entry[0].traced.trace_count for entry in opt.compile_cache.values()] == [1, 1]
    # compile=False is its own entry, and traces nothing
    opt.minimize(m.training_loss, m.trainable_variables, compile=False, options={"maxiter": 2})
    assert not hasattr(list(opt.compile_cache.values())[-1][0], "traced")


def test_scipy_evaluation_matches_jax():
    jm, pm = _gpr()
    jax_params, port_params = _paths(jm, pm)
    x0 = Scipy().initial_parameters(port_params)
    np.testing.assert_array_equal(x0, gpflow_tpu.optimizers.Scipy().initial_parameters(jax_params))
    got = Scipy().eval_func(pm.training_loss, port_params)(x0)
    want = gpflow_tpu.optimizers.Scipy().eval_func(jm.training_loss, jax_params)(x0)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_scipy_draws_fresh_and_as_eager():
    values = []
    for compile_ in (True, False):
        _, pm = _svgp("GaussianMC")
        closure = pm.training_loss_closure((X, Y), compile=False)
        func = Scipy().eval_func(closure, pm.trainable_variables, compile=compile_)
        x0 = Scipy().initial_parameters(pm.trainable_variables)
        values.append([func(x0) for _ in range(3)])
    _equal(values[0], values[1])
    assert values[0][0][0] != values[0][1][0]


def test_scipy_runs_cglb_eagerly_and_its_trace_raises():
    """``Scipy`` traces CGLB's objective once and replays it, a trace of it
    does not raise, and a traced evaluation does not write v back into
    ``aux_vec`` (as the JAX package under ``jit``), where an eager one does;
    ``cg_iterations`` is a host int after a replay as after an eager run."""
    m = CGLB((X, Y), kernel=kernels.SquaredExponential(), inducing_variable=Z.copy())
    assert not hasattr(CGLB, "untraced") and not hasattr(_compile, "untraced_reason")
    opt = Scipy()
    result = opt.minimize(m.training_loss, m.trainable_variables, options={"maxiter": 2})
    assert np.isfinite(result.fun) and result.nfev > 1
    assert list(opt.compile_cache.values())[0][0].traced.trace_count == 1
    assert not np.any(m.aux_vec.numpy())  # no write-back from the replays
    assert type(m.cg_iterations) is int and m.cg_iterations > 0
    closure = m.training_loss_closure()
    with torch.no_grad():
        traced = jit(lambda model: model._training_loss())(m)
        assert torch.equal(closure(), traced) and not np.any(m.aux_vec.numpy())
        eager = m.training_loss_closure(compile=False)()
    _equal(eager, traced)
    assert np.all(np.isfinite(m.aux_vec.numpy())) and np.any(m.aux_vec.numpy())  # the eager write-back


# --- NaturalGradient --------------------------------------------------------------------


def test_natgrad_step_traces_once_and_replays_the_eager_bits(monkeypatch):
    calls = _counting(monkeypatch, NaturalGradient, "_natgrad_values_with_ok")
    values = []
    for compile_ in (True, False):
        _, pm = _svgp("Gaussian")
        opt = NaturalGradient(gamma=0.05, compile=compile_)
        loss = lambda: pm.training_loss((X, Y))  # noqa: E731
        del calls[:]
        for step in range(4):
            opt.gamma = 0.05 * (step + 1)  # annealed: an input, not a static
            opt.minimize(loss, [(pm.q_mu, pm.q_sqrt)])
            pm.kernel.lengthscales.assign(0.8 + 0.1 * step)  # a value change
        assert len(calls) == (1 if compile_ else 4)
        values.append(port_read_values(pm))
    _equal(values[0], values[1])


def test_natgrad_retraces_on_a_new_batch_shape_and_bounds_its_cache(monkeypatch):
    calls = _counting(monkeypatch, NaturalGradient, "_natgrad_values_with_ok")
    _, pm = _svgp("Gaussian")
    opt = NaturalGradient(gamma=0.05)
    # a call whose batch has another shape runs the closure twice (to find that out, then to trace)
    batches = iter([(X[:10], Y[:10]), (X[10:], Y[10:]), (X[5:15], Y[5:15]), (X[:7], Y[:7]), (X[7:14], Y[7:14])])
    loss = lambda: pm.training_loss(next(batches))  # noqa: E731
    opt.minimize(loss, [(pm.q_mu, pm.q_sqrt)])  # two draws: the discovery trace and the traced one
    opt.minimize(loss, [(pm.q_mu, pm.q_sqrt)])  # new values: the same step
    assert len(calls) == 1
    opt.minimize(loss, [(pm.q_mu, pm.q_sqrt)])  # 7 rows: another step
    assert len(calls) == 2
    # a lambda made anew at each call over the same objects finds the first one's traces
    kept = len(opt._compiled_steps)
    for _ in range(2):
        opt.minimize(lambda: pm.training_loss((X, Y)), [(pm.q_mu, pm.q_sqrt)])
    assert len(opt._compiled_steps) == kept + 1
    # the bound: 16 closures' traces, the oldest out first
    opt._compiled_steps.clear()
    closures = [lambda k=k: pm.training_loss((X, Y)) for k in range(17)]  # distinct defaults: distinct closures
    monkeypatch.setattr(natgrad, "_CompiledStep", _CheapStep)
    for closure in closures:
        opt.minimize(closure, [(pm.q_mu, pm.q_sqrt)])
    assert len(opt._compiled_steps) == 16
    assert [entry.loss_fn for entry in opt._compiled_steps.values()] == closures[1:]


class _CheapStep:
    """A compiled step that keeps the values, for the cache's bound alone."""

    def __init__(self, opt, loss_fn, variables, xis):
        self.loss_fn, self.others = loss_fn, ()
        self.first = (lambda *args: args[:len(variables)], [], [])


def test_natgrad_matches_the_jitted_jax_step():
    jm, pm = _svgp("Bernoulli", whiten=False)
    jax_opt, port_opt = gpflow_tpu.optimizers.NaturalGradient(gamma=0.1), NaturalGradient(gamma=0.1)
    jax_loss, port_loss = (lambda: jm.training_loss((X, Yb))), (lambda: pm.training_loss((X, Yb)))
    jax_opt.minimize(jax_loss, [(jm.q_mu, jm.q_sqrt)])
    port_opt.minimize(port_loss, [(pm.q_mu, pm.q_sqrt)])
    want = read_values(jm)
    for k, v in port_read_values(pm).items():
        _close(v, want[k])


def test_natgrad_draws_fresh_and_as_eager():
    values = []
    for compile_ in (True, False):
        _, pm = _svgp("GaussianMC")
        opt = NaturalGradient(gamma=0.1, compile=compile_)
        states = []
        for _ in range(3):
            opt.minimize(lambda: pm.training_loss((X, Y)), [(pm.q_mu, pm.q_sqrt)])
            states.append(pm.q_mu.numpy())
        values.append(states)
    _equal(values[0], values[1])


# --- DataParallelTrainer ----------------------------------------------------------------


def _eager(trainer):
    """The trainer with its step run eagerly, as on a mesh."""
    trainer._traced = trainer._model_step
    return trainer


@pytest.mark.parametrize("mode", ["adam", "sequential", "fused"])
def test_trainer_traces_once_and_replays_the_eager_bits(mode, monkeypatch):
    calls = _counting(monkeypatch, SVGP, "_training_loss")
    kw = {"adam": {}, "sequential": {"natgrad_gamma": 0.1}, "fused": {"natgrad_gamma": 0.1, "natgrad_fused": True}}
    results = []
    for traced in (True, False):
        _, pm = _svgp("Gaussian")
        trainer = DataParallelTrainer(pm, **kw[mode])
        if not traced:
            _eager(trainer)
        trainer.stage_data((X, Y))
        del calls[:]
        out = [trainer.run_steps_sampled(2, 8, torch.Generator().manual_seed(1)),
               trainer.step((X[:8], Y[:8])),
               trainer.run_steps((np.stack([X[:8], X[8:16]]), np.stack([Y[:8], Y[8:16]])))]
        per_body = 2 if mode == "sequential" else 1  # the sequential step takes two forward passes
        out.append(port_read_values(pm))
        if traced:
            assert len(calls) == per_body and trainer._traced.trace_count == 1
            if mode == "adam":
                trainer.step((X[:5], Y[:5]))  # another shape
                assert trainer._traced.trace_count == 2
            elif mode == "fused":
                trainer._natgrad.gamma = 0.05  # a static of the key
                trainer.step((X[:8], Y[:8]))
                assert trainer._traced.trace_count == 2
        else:
            assert len(calls) == per_body * 5
        results.append(out)
    _equal(results[0], results[1])


def test_trainer_step_matches_the_jax_trainer():
    """The traced step without the optimizer's update (the loss and the
    gradients the update takes) against the jitted JAX value and gradient of
    the loss that the JAX trainer's step takes."""
    jm, pm = _svgp("Bernoulli")
    pt = DataParallelTrainer(pm)
    batch = (_t(X[:8]), _t(Yb[:8]))
    loss, grads, *_ = pt._traced(pm, batch, None, None)
    want_loss, want_grads = _jax_value_and_grads(jm.trainable_parameters,
                                                 lambda: jm._training_loss((X[:8], Yb[:8])))
    paths = {id(p): k for k, p in parameter_dict(pm).items()}
    jax_paths = {id(p): k for k, p in jax_parameter_dict(jm).items()}
    want = {jax_paths[id(p)]: g for p, g in zip(jm.trainable_parameters, want_grads)}
    scale = max(float(np.max(np.abs(np.asarray(w)))) for w in want_grads)
    for p, g in zip(pt._train_params, grads):
        _close(g, want[paths[id(p)]], scale=scale)
    _close(loss, want_loss)
    _close(pt.step(batch), loss)


def test_trainer_draws_fresh_and_as_eager():
    results = []
    for traced in (True, False):
        _, pm = _svgp("GaussianMC")
        trainer = DataParallelTrainer(pm)
        if not traced:
            _eager(trainer)
        results.append([trainer.step((X, Y)) for _ in range(3)])
    _equal(results[0], results[1])
    assert float(results[0][0]) != float(results[0][1])


# --- training_loop ----------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{"compile": True}, {"use_scan": True}])
def test_training_loop_traces_once_and_replays_the_eager_bits(kw):
    histories, states = [], []
    for options in (kw, {}):
        _, pm = _svgp("Gaussian")
        runs = [0]

        def closure():
            runs[0] += 1
            return pm.training_loss((X, Y))

        histories.append(training_loop(closure, var_list=pm.trainable_parameters, maxiter=5, **options))
        states.append(port_read_values(pm))
        assert runs[0] == (1 if options else 5)
    _equal(histories[0], histories[1])
    _equal(states[0], states[1])
    # a hand Adam loop takes the same steps
    _, pm = _svgp("Gaussian")
    tensors = [p.unconstrained for p in pm.trainable_parameters]
    opt = torch.optim.Adam(tensors, lr=0.01, betas=(0.9, 0.999), eps=1e-8)
    hand = []
    for _ in range(5):
        loss = pm.training_loss((X, Y))
        for t, g in zip(tensors, torch.autograd.grad(loss, tensors)):
            t.grad = g
        opt.step()
        hand.append(loss.detach())
    _equal(histories[0], torch.stack(hand))


def test_training_loop_matches_the_jitted_jax_loop():
    jm, pm = _svgp("Gaussian")
    want = gpflow_tpu.utilities.training_loop(lambda: jm.training_loss((X, Y)), var_list=jm.trainable_parameters,
                                              maxiter=3, compile=True)
    got = training_loop(lambda: pm.training_loss((X, Y)), var_list=pm.trainable_parameters, maxiter=3,
                        compile=True)
    _close(got, want)


def test_training_loop_draws_fresh_and_as_eager():
    histories = []
    for options in ({"use_scan": True}, {}):
        _, pm = _svgp("GaussianMC")
        histories.append(training_loop(pm.training_loss_closure((X, Y), compile=False),
                                       var_list=pm.trainable_parameters, maxiter=3, **options))
    _equal(histories[0], histories[1])


# --- jit itself ---------------------------------------------------------------------------


class _Holder(Module):
    def __init__(self):
        super().__init__()
        self.p = Parameter(np.array([1.0, 2.0]))
        self.items = [torch.ones(2, dtype=torch.float64), "tag", 3]
        self.table = {"a": np.arange(2.0), "mode": "fast"}


def _holder_sum(m, x, scale=1.0):
    return (torch.sum(m.p.value * x) * scale + torch.sum(m.items[0]) * m.items[2]
            + torch.sum(torch.as_tensor(m.table["a"])))


def test_jit_key_statics_values_and_the_cache_bound():
    runs = []

    def body(m, x, scale=1.0):
        runs.append(1)
        return _holder_sum(m, x, scale)

    f = jit(body, cache_size=3)
    m = _Holder()
    x = torch.ones(2, dtype=torch.float64)
    with torch.no_grad():
        assert float(f(m, x)) == float(_holder_sum(m, x))
        m.p.assign([3.0, 4.0])  # values: no trace
        m.items[0] = torch.full((2,), 2.0, dtype=torch.float64)
        assert float(f(m, x)) == float(_holder_sum(m, x)) and f.trace_count == 1
        other = _Holder()
        assert float(f(other, x)) == float(_holder_sum(other, x)) and f.trace_count == 1  # the same structure
        m.items[2] = 4  # a static
        f(m, x)
        f(m, x, scale=2.0)  # a static argument
        f(m, x.float())  # a dtype
        f(m, x[:1])  # a shape
        assert float(f(m, x[:1])) == float(_holder_sum(m, x[:1]))
    assert f.trace_count == 5 and len(f.cache) == 3 and len(runs) == 5


def test_jit_gradient_reaches_the_arguments_and_only_through_a_scalar():
    m = _Holder()
    loss = jit(lambda mod, x: torch.sum(mod.p.value ** 2 * x))(m, torch.ones(2, dtype=torch.float64))
    (g,) = torch.autograd.grad(loss, [m.p.unconstrained])
    _equal(g, torch.tensor([2.0, 4.0], dtype=torch.float64))
    vector = jit(lambda mod: mod.p.value * 2.0)(m)
    with pytest.raises(TraceError, match="not one scalar"):
        vector.sum().backward()
    with pytest.raises(TraceError, match="not among its arguments"):
        jit(lambda x: torch.sum(m.p.value * x))(torch.ones(2, dtype=torch.float64, requires_grad=True))


def test_jit_refuses_host_reads_and_backward_with_a_reason():
    x = torch.ones(3, dtype=torch.float64)
    with pytest.raises(TraceError, match="reads a tensor's value on the host"):
        jit(lambda t: t * float(t.sum()))(x)
    with pytest.raises(TraceError, match="reads a tensor's value on the host"):
        jit(lambda t: t + torch.as_tensor(np.asarray(t)))(x)
    m = _Holder()

    def backward(mod):
        loss = torch.sum(mod.p.value ** 2)
        loss.backward()
        return loss

    with pytest.raises(TraceError, match="backward"):
        jit(backward)(m)

    def caches(mod):
        mod.cache = mod.p.value * 2
        return mod.cache

    with pytest.raises(TraceError, match="stored a traced tensor"):
        jit(caches)(m)


def test_a_cache_filled_inside_a_trace_holds_real_tensors():
    """A likelihood's Gauss-Hermite grid is cast to the loss's dtype at its
    first use: where that use is inside a trace, the cached grid must be a
    real tensor, which a later eager call reads."""
    from torch._subclasses.fake_tensor import FakeTensor

    pm = SVGP(kernel=kernels.SquaredExponential(), likelihood=likelihoods.MultiClass(3),
              inducing_variable=Z.copy(), num_latent_gps=3, num_data=N).to(dtype=torch.float32)
    labels = np.random.RandomState(3).randint(0, 3, (N, 1))
    batch = (_t(X).float(), _t(labels).float())
    loss = pm.training_loss_closure(batch)()
    assert not any(isinstance(t, FakeTensor) for grid in pm.likelihood._gh._grids.values() for t in grid)
    with torch.no_grad():
        _equal(pm.training_loss(batch), loss)


def test_jit_launch_counts_are_those_of_the_eager_call(monkeypatch):
    """On the CPU a counting implementation of each kernel's op stands in
    for K1 and K2, so that a replay is seen to launch them as the eager call
    does: a Matern52 SVGP's loss and gradient take K1 twice (Kuu, Kuf) and
    K2 twice."""
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
            pm = SVGP(kernel=kernels.Matern52(lengthscales=0.8), likelihood=likelihoods.Gaussian(0.1),
                      inducing_variable=Z.astype(np.float32), num_data=N)
        finally:
            config.set_default_float(torch.float64)
        data = (_t(X).float(), _t(Y).float())
        closure = pm.training_loss_closure(data)
        eager = pm.training_loss_closure(data, compile=False)
        results = []
        for f in (eager, closure, closure, eager):
            before = dict(counts)
            loss = f()
            results.append((loss, _grads(loss, pm)))
            assert (counts["K1"] - before["K1"], counts["K2"] - before["K2"]) == (2, 2)
        assert closure.traced.trace_count == 1
        _equal(results[0], results[1])
    finally:
        pd.set_pallas_enabled(None)
        lib._destroy()
