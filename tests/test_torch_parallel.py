"""``gpflow_tpu_torch.parallel`` on a gloo group of 4 ranks on the CPU, held
to the JAX package on a mesh of 4 of its 8 virtual CPU devices
(``tests/conftest.py``), on the same numpy inputs, in float64.

One module-scoped fixture spawns the 4 ranks (``start_method="spawn"``, a
``FileStore`` under the test's temporary directory, so workers that run side
by side share no port). Every rank runs every path once and writes its
results; the tests compare rank 0's with the JAX package's and check that
every rank holds the same. The paths are ``dryrun_multichip``'s: the sharded
SVGP step, N-sharded SGPR, the data x latent multioutput SVGP step, the
fused natural-gradient Bernoulli step, the hybrid mesh, the N-sharded
matrix-free CGLB and sharded serving; beside them GPR, VGP, the GPLVM's
preserved Parameter, the Bayesian GPLVM's psi sums, a checkpoint saved on
{"data": 4} and restored on {"data": 2, "latent": 2}, and the validation
errors. Losses and gradients are held at rtol 1e-10: XLA's all-reduce and
gloo's sum the ranks' partial sums in their own orders, so the results agree
to float64 round-off, not to the bit.

The rank processes import this module, which therefore imports no JAX at
its top: the JAX side is built inside the tests.
"""
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

from gpflow_tpu_torch import config

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

WORLD = 4
RTOL = 1e-10
rng = np.random.RandomState(0)
N, D, M, B = 256, 3, 8, 64
X = rng.randn(N, D)
Y = np.sin(X[:, :1]) + 0.1 * rng.randn(N, 1)
L_OUT = 4
Y_MO = np.concatenate([Y + 0.1 * i for i in range(L_OUT)], axis=1)
XC = rng.randn(N, 2)
YC = (rng.rand(N, 1) < 1 / (1 + np.exp(-(np.sin(2 * XC[:, :1]) + XC[:, 1:])))).astype(float)
XT = rng.randn(64, D)
Y_LV = rng.randn(40, 4)
X_LV = rng.randn(40, 2)
STEPS = 3
# a q(u) away from the prior, where the gradient of every parameter is
# well away from zero
Q_MU = 0.5 * rng.randn(M, L_OUT)
Q_SQRT = np.tril(0.1 * rng.randn(L_OUT, M, M)) + 0.7 * np.eye(M)
LR = 1e-4


def _stack(a):
    return np.stack([a[:B]] * STEPS)


def _svgp(pkg):
    return pkg.models.SVGP(
        kernel=pkg.kernels.SquaredExponential(), likelihood=pkg.likelihoods.Gaussian(0.1),
        inducing_variable=X[:M].copy(), num_data=N, q_mu=Q_MU[:, :1], q_sqrt=Q_SQRT[:1],
    )


def _multioutput(pkg, latents=L_OUT):
    ks = [pkg.kernels.SquaredExponential(lengthscales=1.0 + 0.1 * i) for i in range(latents)]
    ivs = pkg.inducing_variables.SeparateIndependentInducingVariables(
        [pkg.inducing_variables.InducingPoints(X[i * M:(i + 1) * M].copy()) for i in range(latents)]
    )
    kernel = pkg.kernels.LinearCoregionalization(ks, W=np.eye(L_OUT, latents) + 0.1)
    return pkg.models.SVGP(kernel=kernel, likelihood=pkg.likelihoods.Gaussian(0.1),
                           inducing_variable=ivs, num_data=N, num_latent_gps=latents,
                           q_mu=Q_MU[:, :latents], q_sqrt=Q_SQRT[:latents])


def _bernoulli(pkg):
    return pkg.models.SVGP(
        kernel=pkg.kernels.Matern52(), likelihood=pkg.likelihoods.Bernoulli(),
        inducing_variable=XC[:16].copy(), num_data=N,
    )


V0 = 0.1 * rng.randn(1, N)


def _with_v(model):
    model.aux_vec.assign(V0)
    return model


def _cglb_cg(pkg):
    return pkg.models.CGLB((X, Y), kernel=pkg.kernels.SquaredExponential(lengthscales=np.ones(D)),
                           inducing_variable=X[:M].copy(), cg_tolerance=1e-6, max_cg_iters=100, matrix_free_chunk=32)


INTERNAL = {
    "sgpr": lambda pkg: pkg.models.SGPR((X, Y), kernel=pkg.kernels.SquaredExponential(),
                                        inducing_variable=X[:M].copy(), noise_variance=0.1),
    # at a fixed v, as tests/test_torch_cglb.py holds the two packages (their
    # CG loops stop at the tolerance after their own round-off)
    "cglb": lambda pkg: _with_v(pkg.models.CGLB((X, Y), kernel=pkg.kernels.SquaredExponential(lengthscales=np.ones(D)),
                                                inducing_variable=X[:M].copy(), v_grad_optimization=True,
                                                matrix_free_chunk=32)),
    "gpr": lambda pkg: pkg.models.GPR((X[:B], Y[:B]), kernel=pkg.kernels.SquaredExponential(), noise_variance=0.1),
    "vgp": lambda pkg: pkg.models.VGP((X[:B], Y[:B]), kernel=pkg.kernels.SquaredExponential(),
                                      likelihood=pkg.likelihoods.Gaussian(0.1)),
    "gplvm": lambda pkg: pkg.models.GPLVM(Y_LV, latent_dim=2, X_data_mean=X_LV.copy()),
    "bgplvm": lambda pkg: pkg.models.BayesianGPLVM(
        Y_LV, X_data_mean=X_LV.copy(), X_data_var=0.5 * np.ones_like(X_LV),
        kernel=pkg.kernels.SquaredExponential(lengthscales=np.ones(2)), inducing_variable=X_LV[:5].copy()),
}


# --- the ranks ----------------------------------------------------------------


def _np(t):
    return t.detach().cpu().numpy().copy()


def _paths(model):
    from gpflow_tpu_torch.utilities import parameter_dict

    return {id(p): path for path, p in parameter_dict(model).items()}


def _value_and_grads(model, loss, params, grads):
    paths = _paths(model)
    return float(loss.detach()), {paths[id(p)]: _np(g) for p, g in zip(params, grads)}


def _trainer_value_and_grads(t, batch):
    """The trainer's loss and its gradients at its current state, as a step
    takes them, the latent-split ones gathered."""
    params = list(t.model.trainable_parameters)
    with t._on_mesh():
        loss = t.model._training_loss(t.shard(batch))
        grads = t._grads(loss, [t._leaf(p) for p in params])
    split = [t._split.get(id(p)) for p in params]
    grads = [g if s is None else t._latents.gather(g, s[1]) for g, s in zip(grads, split)]
    return _value_and_grads(t.model, loss, params, grads)


class _Collectives(TorchDispatchMode):
    """Counts the collectives (``c10d`` operations) run inside it."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func.namespace == "c10d"
        return func(*args, **(kwargs or {}))


def _error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _rank_paths(tmp):
    import gpflow_tpu_torch as gt
    from gpflow_tpu_torch.parallel import (
        DataParallelTrainer, make_hybrid_mesh, make_mesh, replicated, shard_batch, shard_internal_data,
        sharded_predict_f,
    )
    from gpflow_tpu_torch.utilities import read_values

    sgd = lambda lr, momentum=0.0: (lambda ps: torch.optim.SGD(ps, lr=lr, momentum=momentum))  # noqa: E731
    out = {}
    data4 = make_mesh(4)
    grid = make_mesh(shape={"data": 2, "latent": 2})
    out["mesh"] = (data4.mesh.tolist(), grid.mesh.tolist(), grid.mesh_dim_names,
                   [repr(p) for p in replicated(grid)], [repr(p) for p in shard_batch(grid, "latent")])

    # the sharded SVGP step
    t = DataParallelTrainer(_svgp(gt), sgd(LR), mesh=data4)
    out["svgp"] = _trainer_value_and_grads(t, (X[:B], Y[:B]))
    with _Collectives() as c:
        out["svgp_steps"] = _np(t.run_steps((_stack(X), _stack(Y))))
    out["collectives", "svgp step"] = c.count / STEPS
    out["svgp_values"] = read_values(t.model)
    out["svgp_presharded"] = float(t.loss(t.shard((X[:B], Y[:B])), presharded=True))

    # the data x latent multioutput step
    t = DataParallelTrainer(_multioutput(gt), sgd(LR), mesh=grid, latent_axis="latent")
    out["latent"] = _trainer_value_and_grads(t, (X[:B], Y_MO[:B]))
    with _Collectives() as c:
        out["latent_steps"] = _np(t.run_steps((_stack(X), _stack(Y_MO))))
    out["collectives", "data x latent step"] = c.count / STEPS
    t.finalize()
    out["latent_values"] = read_values(t.model)

    # the fused natural-gradient Bernoulli step
    t = DataParallelTrainer(_bernoulli(gt), sgd(10 * LR), mesh=data4, natgrad_gamma=0.3, natgrad_fused=True)
    out["natgrad"] = _trainer_value_and_grads(t, (XC[:B], YC[:B]))
    with _Collectives() as c:
        out["natgrad_steps"] = _np(t.run_steps((_stack(XC), _stack(YC))))
    out["collectives", "fused natural-gradient step"] = c.count / STEPS
    out["natgrad_values"] = read_values(t.model)
    out["natgrad_rejections"] = t.natgrad_rejections

    # natural gradients on latent-split q(u): the conversions see L/l latent GPs
    t = DataParallelTrainer(_multioutput(gt), sgd(LR), mesh=grid, latent_axis="latent", natgrad_gamma=0.1)
    out["latent_natgrad_steps"] = _np(t.run_steps((_stack(X), _stack(Y_MO))))
    t.finalize()
    out["latent_natgrad_values"] = read_values(t.model)

    # the hybrid mesh
    hybrid = make_hybrid_mesh(ici={"data": 2}, dcn={"data": 2})
    out["hybrid_mesh"] = hybrid.mesh.tolist()
    t = DataParallelTrainer(_svgp(gt), sgd(LR), mesh=hybrid)
    out["hybrid_steps"] = _np(t.run_steps((_stack(X), _stack(Y))))

    # the internal-data models
    for name, build in INTERNAL.items():
        model = shard_internal_data(build(gt), data4)
        params = list(model.trainable_parameters)
        with _Collectives() as c:
            loss = model.training_loss()
            grads = torch.autograd.grad(loss, [p.unconstrained for p in params])
        out[name] = _value_and_grads(model, loss, params, grads)
        out["collectives", name] = c.count
        if name == "gplvm":
            out["gplvm_parameter"] = (isinstance(model.data[0], gt.Parameter),
                                      any(p is model.data[0] for p in model.trainable_parameters),
                                      tuple(model.data[1].shape))
    # the CG path: its dot products and K-matvecs split, against the whole model on this rank
    for split in (False, True):
        model = _cglb_cg(gt)
        model = shard_internal_data(model, data4) if split else model
        params = list(model.trainable_parameters)
        loss = model.training_loss()
        out["cglb_cg", split] = _value_and_grads(model, loss, params,
                                                 torch.autograd.grad(loss, [p.unconstrained for p in params]))
        out["cglb_cg_iterations", split] = model.cg_iterations
    sgpr = shard_internal_data(INTERNAL["sgpr"](gt), data4)
    out["sgpr_predict"] = tuple(_np(t) for t in sgpr.predict_f(XT))

    # serving
    model = _svgp(gt)
    out["serving"] = tuple(_np(t) for t in sharded_predict_f(model, XT, data4))
    out["serving_posterior"] = tuple(_np(t) for t in sharded_predict_f(model.posterior(), XT, data4))

    # a checkpoint saved on {"data": 4}, restored on {"data": 2, "latent": 2}
    path = os.path.join(tmp, "ckpt")
    t = DataParallelTrainer(_multioutput(gt), sgd(LR, 0.9), mesh=data4)
    first = _np(t.run_steps((_stack(X), _stack(Y_MO))))
    t.save_state(path)
    t = DataParallelTrainer(_multioutput(gt), sgd(LR, 0.9), mesh=grid, latent_axis="latent")
    t.load_state(path)
    out["checkpoint_steps"] = np.concatenate([first, _np(t.run_steps((_stack(X), _stack(Y_MO))))])

    # the validation errors
    out["errors"] = {
        "divisible": _error(lambda: DataParallelTrainer(_multioutput(gt, 3), mesh=grid, latent_axis="latent")),
        "not an axis": _error(lambda: DataParallelTrainer(_svgp(gt), latent_axis="latent")),
        "not an axis, mesh": _error(lambda: DataParallelTrainer(_svgp(gt), mesh=data4, latent_axis="latent")),
        "not in ici axes": _error(lambda: make_hybrid_mesh(ici={"data": 2}, dcn={"batch": 2})),
        "needs": _error(lambda: make_hybrid_mesh(ici={"data": 8}, dcn={"data": 2})),
        "slices": _error(lambda: make_hybrid_mesh(ici={"data": 2}, dcn={"data": 3}, devices=_SLICED)),
        "per slice": _error(lambda: make_hybrid_mesh(ici={"data": 8}, devices=_SLICED)),
        "requested but only": _error(lambda: make_mesh(num_devices=WORLD + 1)),
        "internal-data": _error(lambda: shard_internal_data(_svgp(gt), data4)),
        "uneven rows": _error(lambda: DataParallelTrainer(_svgp(gt), mesh=data4).step((X[:6], Y[:6]))),
    }
    with config.as_context(config.Config(device="cuda")):
        out["errors"]["gloo with cuda"] = _error(lambda: make_mesh())
    return out


class _Device:
    """A device of the JAX package's kind: an id and the slice it sits in."""

    def __init__(self, i, slice_index):
        self.id, self.slice_index = i, slice_index


# 2 slices x 4 devices, as tests/gpflow_tpu/test_parallel.py:530 has them
_SLICED = [_Device(i, i // 4) for i in range(8)]


def _rank_main(rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world)
    try:
        result = _rank_paths(out_dir)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ranks"))
    mp.start_processes(_rank_main, args=(WORLD, os.path.join(tmp, "store"), tmp), nprocs=WORLD,
                       join=True, start_method="spawn")
    out = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# --- the JAX side ----------------------------------------------------------------


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _close_dicts(got, want, rtol=RTOL):
    """Each entry within rtol of the largest entry of them all (a gradient
    whose exact value is 0 comes out as round-off of the others')."""
    assert sorted(got) == sorted(want)
    scale = max(np.max(np.abs(np.asarray(v, dtype=float))) for v in want.values())
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], dtype=float), np.asarray(want[k], dtype=float),
                                   rtol=rtol, atol=rtol * scale, err_msg=k)


def _jax():
    import jax
    import optax

    import gpflow_tpu
    from gpflow_tpu import parallel

    return jax, optax, gpflow_tpu, parallel


def _jax_value_and_grads(model, loss_of, *args):
    """The loss and the gradients of the trainable parameters, by path, of
    a jitted function of the model (so that sharded data stays sharded)."""
    jax, _, gpflow_tpu, _ = _jax()
    from gpflow_tpu.utilities import parameter_dict

    value, grad_model = jax.jit(jax.value_and_grad(loss_of))(model, *args)
    trainable = {path for path, p in parameter_dict(model).items() if p.trainable}
    grads = {path: np.asarray(p.unconstrained_variable) for path, p in parameter_dict(grad_model).items()}
    return float(value), {k: v for k, v in grads.items() if k in trainable}


def _check(result, want):
    _close(result[0], want[0])
    _close_dicts(result[1], want[1])


def test_every_rank_holds_the_same(ranks):
    for r in ranks[1:]:
        for key in ("svgp", "latent", "natgrad", "sgpr", "cglb", "gpr", "vgp", "gplvm", "bgplvm"):
            np.testing.assert_array_equal(r[key][0], ranks[0][key][0])
            for k in ranks[0][key][1]:
                np.testing.assert_array_equal(r[key][1][k], ranks[0][key][1][k])
        for key in ("svgp_steps", "latent_steps", "natgrad_steps", "checkpoint_steps", "hybrid_steps"):
            np.testing.assert_array_equal(r[key], ranks[0][key])
        for a, b in zip(r["serving"], ranks[0]["serving"]):
            np.testing.assert_array_equal(a, b)


def test_meshes_and_placements(ranks):
    jax, _, _, parallel = _jax()
    data4, grid, names, rep, shard = ranks[0]["mesh"]
    assert data4 == [d.id for d in parallel.make_mesh(4).devices.flat]
    assert np.array_equal(grid, [[d.id for d in row] for row in parallel.make_mesh(shape={"data": 2, "latent": 2}).devices])
    assert names == ("data", "latent")
    assert rep == ["Replicate()", "Replicate()"] and shard == ["Replicate()", "Shard(dim=0)"]
    hybrid = parallel.make_hybrid_mesh(ici={"data": 2}, dcn={"data": 2}, devices=jax.devices()[:WORLD])
    assert ranks[0]["hybrid_mesh"] == [d.id for d in hybrid.devices.flat]


def test_sharded_svgp_step(ranks):
    jax, optax, gpflow_tpu, parallel = _jax()
    model = _svgp(gpflow_tpu)
    trainer = parallel.DataParallelTrainer(model, optimizer=optax.sgd(LR), mesh=parallel.make_mesh(4), donate=False)
    batch = trainer.shard((X[:B], Y[:B]))
    _check(ranks[0]["svgp"], _jax_value_and_grads(model, lambda m, b: m.training_loss(b), batch))
    _close(ranks[0]["svgp_steps"], trainer.run_steps((_stack(X), _stack(Y))))
    trainer.finalize()
    _close_dicts(ranks[0]["svgp_values"], gpflow_tpu.utilities.read_values(model))
    _close(ranks[0]["svgp_presharded"], model.training_loss((X[:B], Y[:B])))


def test_data_by_latent_multioutput_step(ranks):
    jax, optax, gpflow_tpu, parallel = _jax()
    model = _multioutput(gpflow_tpu)
    mesh = parallel.make_mesh(shape={"data": 2, "latent": 2})
    trainer = parallel.DataParallelTrainer(model, optimizer=optax.sgd(LR), mesh=mesh, latent_axis="latent",
                                           donate=False)
    _check(ranks[0]["latent"], _jax_value_and_grads(model, lambda m, b: m.training_loss(b),
                                                    trainer.shard((X[:B], Y_MO[:B]))))
    _close(ranks[0]["latent_steps"], trainer.run_steps((_stack(X), _stack(Y_MO))))
    trainer.finalize()
    _close_dicts(ranks[0]["latent_values"], gpflow_tpu.utilities.read_values(model))


def test_fused_natgrad_bernoulli_step(ranks):
    jax, optax, gpflow_tpu, parallel = _jax()
    model = _bernoulli(gpflow_tpu)
    trainer = parallel.DataParallelTrainer(model, optimizer=optax.sgd(10 * LR), mesh=parallel.make_mesh(4),
                                           natgrad_gamma=0.3, natgrad_fused=True, donate=False)
    _check(ranks[0]["natgrad"], _jax_value_and_grads(model, lambda m, b: m.training_loss(b),
                                                     trainer.shard((XC[:B], YC[:B]))))
    _close(ranks[0]["natgrad_steps"], trainer.run_steps((_stack(XC), _stack(YC))))
    trainer.finalize()
    _close_dicts(ranks[0]["natgrad_values"], gpflow_tpu.utilities.read_values(model))
    assert ranks[0]["natgrad_rejections"] == trainer.natgrad_rejections == 0


def test_natgrad_on_latent_split_state(ranks):
    jax, optax, gpflow_tpu, parallel = _jax()
    model = _multioutput(gpflow_tpu)
    trainer = parallel.DataParallelTrainer(model, optimizer=optax.sgd(LR),
                                           mesh=parallel.make_mesh(shape={"data": 2, "latent": 2}),
                                           latent_axis="latent", natgrad_gamma=0.1, donate=False)
    _close(ranks[0]["latent_natgrad_steps"], trainer.run_steps((_stack(X), _stack(Y_MO))))
    trainer.finalize()
    _close_dicts(ranks[0]["latent_natgrad_values"], gpflow_tpu.utilities.read_values(model))


def test_hybrid_mesh_step(ranks):
    jax, optax, gpflow_tpu, parallel = _jax()
    mesh = parallel.make_hybrid_mesh(ici={"data": 2}, dcn={"data": 2}, devices=jax.devices()[:WORLD])
    trainer = parallel.DataParallelTrainer(_svgp(gpflow_tpu), optimizer=optax.sgd(LR), mesh=mesh, donate=False)
    _close(ranks[0]["hybrid_steps"], trainer.run_steps((_stack(X), _stack(Y))))
    _close(ranks[0]["hybrid_steps"], ranks[0]["svgp_steps"])


@pytest.mark.parametrize("name", ["sgpr", "cglb", "gpr", "vgp", "gplvm"])
def test_sharded_internal_data(ranks, name):
    jax, _, gpflow_tpu, parallel = _jax()
    model = parallel.shard_internal_data(INTERNAL[name](gpflow_tpu), parallel.make_mesh(4))
    _check(ranks[0][name], _jax_value_and_grads(model, lambda m: m.training_loss()))


def test_cglb_conjugate_gradient_split(ranks):
    """CGLB's CG with its dot products summed over the ranks and its
    K-matvecs in row blocks, against the whole model on one rank: the same
    iterations and bound. The gradient depends on v to first order, and a
    CG stopped at its tolerance carries a change of summation order to
    ~5e-7 of it (the whole model with its rows permuted moves it by 4.9e-7
    at these inputs), so it is held at 1e-6."""
    assert ranks[0]["cglb_cg_iterations", True] == ranks[0]["cglb_cg_iterations", False] > 1
    _close(ranks[0]["cglb_cg", True][0], ranks[0]["cglb_cg", False][0])
    _close_dicts(ranks[0]["cglb_cg", True][1], ranks[0]["cglb_cg", False][1], rtol=1e-6)


def test_bayesian_gplvm_psi_sums(ranks):
    """The JAX package's ``shard_internal_data`` cannot take the Bayesian
    GPLVM (its data is one array, which the tuple of rows breaks), so the
    port's split psi sums are held to the JAX package's whole model."""
    jax, _, gpflow_tpu, _ = _jax()
    _check(ranks[0]["bgplvm"], _jax_value_and_grads(INTERNAL["bgplvm"](gpflow_tpu), lambda m: m.training_loss()))


def test_shard_internal_data_keeps_the_gplvm_parameter(ranks):
    assert ranks[0]["gplvm_parameter"] == (True, True, (Y_LV.shape[0] // WORLD, Y_LV.shape[1]))


def test_sharded_sgpr_predict(ranks):
    jax, _, gpflow_tpu, parallel = _jax()
    model = parallel.shard_internal_data(INTERNAL["sgpr"](gpflow_tpu), parallel.make_mesh(4))
    for got, want in zip(ranks[0]["sgpr_predict"], model.predict_f(XT)):
        _close(got, want)


@pytest.mark.parametrize("posterior", [False, True])
def test_sharded_serving(ranks, posterior):
    jax, _, gpflow_tpu, parallel = _jax()
    model = _svgp(gpflow_tpu)
    target = model.posterior() if posterior else model
    want = parallel.sharded_predict_f(target, XT, mesh=parallel.make_mesh(4))
    for got, w in zip(ranks[0]["serving_posterior" if posterior else "serving"], want):
        _close(got, w)


def test_checkpoint_across_mesh_shapes(ranks):
    """Three momentum steps on {"data": 4}, the state saved, restored on
    {"data": 2, "latent": 2} and three more: the JAX package's unbroken six
    steps on its 4-device mesh."""
    jax, optax, gpflow_tpu, parallel = _jax()
    trainer = parallel.DataParallelTrainer(_multioutput(gpflow_tpu), optimizer=optax.sgd(LR, momentum=0.9),
                                           mesh=parallel.make_mesh(4), donate=False)
    want = trainer.run_steps((np.concatenate([_stack(X)] * 2), np.concatenate([_stack(Y_MO)] * 2)))
    _close(ranks[0]["checkpoint_steps"], want)


@pytest.mark.parametrize("key", ["divisible", "not an axis", "not an axis, mesh", "not in ici axes", "needs",
                                 "slices", "per slice", "requested but only", "internal-data"])
def test_validation_errors_as_the_jax_package(ranks, key):
    """The errors of ``tests/gpflow_tpu/test_parallel.py:329, :530, :549``
    and the others of the reference, raised by both packages."""
    jax, optax, gpflow_tpu, parallel = _jax()
    grid = parallel.make_mesh(shape={"data": 2, "latent": 2})
    sliced = _SLICED
    calls = {
        "divisible": lambda: parallel.DataParallelTrainer(_multioutput(gpflow_tpu, 3), mesh=grid,
                                                          latent_axis="latent"),
        "not an axis": lambda: parallel.DataParallelTrainer(_svgp(gpflow_tpu), latent_axis="latent"),
        "not an axis, mesh": lambda: parallel.DataParallelTrainer(_svgp(gpflow_tpu), mesh=parallel.make_mesh(4),
                                                                  latent_axis="latent"),
        "not in ici axes": lambda: parallel.make_hybrid_mesh(ici={"data": 2}, dcn={"batch": 2}),
        "needs": lambda: parallel.make_hybrid_mesh(ici={"data": 8}, dcn={"data": 2}),
        "slices": lambda: parallel.make_hybrid_mesh(ici={"data": 2}, dcn={"data": 3}, devices=sliced),
        "per slice": lambda: parallel.make_hybrid_mesh(ici={"data": 8}, devices=sliced),
        "requested but only": lambda: parallel.make_mesh(num_devices=len(jax.devices()) + 1),
        "internal-data": lambda: parallel.shard_internal_data(_svgp(gpflow_tpu)),
    }
    pattern = key.split(",")[0].replace("per slice", "per\\s+slice")
    with pytest.raises(ValueError, match=pattern):
        calls[key]()
    got = ranks[0]["errors"][key]
    assert got.startswith("ValueError") and __import__("re").search(pattern, got), got


def test_the_ports_own_refusals(ranks):
    """A mesh over CUDA tensors on a gloo group, and a batch whose rows do
    not split evenly over the data axis (the JAX package's sharding refuses
    it too), raise."""
    errors = ranks[0]["errors"]
    assert errors["gloo with cuda"].startswith("ValueError") and "nccl" in errors["gloo with cuda"]
    assert errors["uneven rows"].startswith("ValueError") and "divisible" in errors["uneven rows"]


# The collectives of one evaluation (a model's value and gradient, or a
# trainer's step) on the 4 ranks. The trainer sums its gradients in one
# all-reduce a step (and one more over a latent axis); a model split by
# shard_internal_data runs one all-reduce in the backward at each read of a
# Parameter (the read rule of gpflow_tpu_torch._sharding), beside the sums
# over its rows. CGLB's matrix-free blocks read the kernel's Parameters once
# a block, so its count grows with a rank's rows over matrix_free_chunk (here
# 64 rows in blocks of 32).
COLLECTIVES = {
    "svgp step": 3, "fused natural-gradient step": 3, "data x latent step": 10,
    "sgpr": 19, "cglb": 36, "gpr": 8, "vgp": 12, "gplvm": 8, "bgplvm": 23,
}


@pytest.mark.parametrize("path", sorted(COLLECTIVES))
def test_collectives_per_evaluation(ranks, path):
    assert ranks[0]["collectives", path] == COLLECTIVES[path]


# --- the path without a mesh ---------------------------------------------------------

# The objective (float.hex) and a digest of its gradients' bytes at fixed
# inputs, as the code before the mesh paths (commit ba21e8f) computed them on
# the CPU: a model that no mesh touches computes the same bits. The CG
# iterations too; for the trainer without a mesh, a digest of its losses
# and parameters after three steps. The digests hold for one torch build on
# one CPU: another BLAS or instruction set may round otherwise.
UNSHARDED = {
    ("svgp", "SquaredExponential", "float32"): ("0x1.d38b580000000p+22", "8531fbaec095dc93"),
    ("svgp", "Matern52", "float32"): ("0x1.c615e20000000p+22", "de48a3374a2117ab"),
    ("svgp", "SquaredExponential", "float64"): ("0x1.cec9638b19882p+22", "d268622ce3082202"),
    ("svgp", "Matern52", "float64"): ("0x1.ba6295da89e4cp+22", "52dd64d4ebb0707f"),
    ("gpr",): ("0x1.323b451db46f4p+6", "ce1cc0a7249db692"),
    ("sgpr",): ("0x1.a56f10e368974p+9", "b1ccf23971745a3c"),
    ("cglb",): ("0x1.4bbebca389359p+7", "d710d2a79043347a", 8),
    ("trainer", "adam", "float32"): "94bbc696e98e9cd6",
    ("trainer", "adam", "float64"): "078121cca07c874e",
    ("trainer", "natgrad", "float32"): "98e37121d668d175",
    ("trainer", "natgrad", "float64"): "cc46078759cd97f2",
    ("trainer", "natgrad_fused", "float32"): "3261577f9f6eea40",
    ("trainer", "natgrad_fused", "float64"): "f62736cb2c1c7a31",
}


def _digest(loss, params):
    import hashlib

    grads = torch.autograd.grad(loss, [p.unconstrained for p in params])
    return float(loss.detach()).hex(), hashlib.sha256(b"".join(_np(g).tobytes() for g in grads)).hexdigest()[:16]


def _bytes_digest(tensors):
    import hashlib

    return hashlib.sha256(b"".join(_np(t).tobytes() for t in tensors)).hexdigest()[:16]


def _unsharded_cases():
    """The flagship's objective (SVGP, M = 16 of its D = 8 and B = 64 rows,
    whitened full q_sqrt) in float32 and float64, GPR, SGPR and the
    matrix-free CGLB's; three trainer steps without a mesh: Adam on a
    Gaussian SVGP, the sequential and the fused natural-gradient steps on a
    Bernoulli one."""
    import gpflow_tpu_torch as gt
    from gpflow_tpu_torch import kernels, likelihoods, models
    from gpflow_tpu_torch.parallel import DataParallelTrainer, adam

    rs = np.random.RandomState(3)
    X8 = rs.rand(256, 8) * 4
    Y8 = np.sin(X8.sum(1, keepdims=True)) + 0.1 * rs.randn(256, 1)
    out = {}
    for dtype in (torch.float32, torch.float64):
        for kernel in ("SquaredExponential", "Matern52"):
            with config.as_context(config.Config(float=dtype, device="cpu")):
                npd = np.float32 if dtype == torch.float32 else np.float64
                m = models.SVGP(getattr(kernels, kernel)(lengthscales=[1.0] * 8), likelihoods.Gaussian(0.1),
                                X8[:16].astype(npd), num_data=10 ** 6, q_mu=(0.3 * rs.randn(16, 1)).astype(npd),
                                q_sqrt=(np.tril(0.1 * rs.randn(1, 16, 16)) + np.eye(16)).astype(npd))
                batch = (torch.tensor(X8[:64], dtype=dtype), torch.tensor(Y8[:64], dtype=dtype))
                out["svgp", kernel, str(dtype)[6:]] = _digest(m.training_loss(batch), m.trainable_parameters)
    m = models.GPR((X8[:64], Y8[:64]), kernels.SquaredExponential(lengthscales=np.ones(8)), noise_variance=0.1)
    out["gpr",] = _digest(m.training_loss(), m.trainable_parameters)
    m = models.SGPR((X8[:128], Y8[:128]), kernels.SquaredExponential(lengthscales=np.ones(8)), X8[:16].copy(),
                    noise_variance=0.1)
    out["sgpr",] = _digest(m.training_loss(), m.trainable_parameters)
    m = models.CGLB((X8[:128], Y8[:128]), kernels.Matern52(lengthscales=np.ones(8)), X8[:16].copy(),
                    noise_variance=0.1, matrix_free_chunk=32, cg_tolerance=1e-3)
    out["cglb",] = _digest(m.training_loss(), m.trainable_parameters) + (m.cg_iterations,)
    rs = np.random.RandomState(4)
    Xs = rs.rand(3, 64, 8) * 4
    Ys = np.sin(Xs.sum(-1, keepdims=True)) + 0.1 * rs.randn(3, 64, 1)
    for how, kwargs in (("adam", {}), ("natgrad", {"natgrad_gamma": 0.1}),
                        ("natgrad_fused", {"natgrad_gamma": 0.1, "natgrad_fused": True})):
        for dtype in (torch.float32, torch.float64):
            with config.as_context(config.Config(float=dtype, device="cpu")):
                npd = np.float32 if dtype == torch.float32 else np.float64
                lik, Y = (likelihoods.Gaussian(0.1), Ys) if how == "adam" else (likelihoods.Bernoulli(), Ys > 0)
                m = models.SVGP(kernels.Matern52(lengthscales=[1.0] * 8), lik, X8[:16].astype(npd), num_data=10 ** 6)
                t = DataParallelTrainer(m, adam(1e-2), **kwargs)
                losses = t.run_steps((Xs.astype(npd), Y.astype(npd)))
                out["trainer", how, str(dtype)[6:]] = _bytes_digest([losses] + [p.unconstrained for p in m.trainable_parameters])
    assert gt.Parameter._read_hook is None
    return out


def test_the_unsharded_path_is_unchanged():
    assert _unsharded_cases() == UNSHARDED
