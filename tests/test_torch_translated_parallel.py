"""The JAX package's ``tests/gpflow_tpu/test_parallel.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names. The JAX file's claims are about a mesh of 8
virtual CPU devices: each test body runs on every rank of a gloo group of 8
CPU ranks (``on_ranks``; the module fixture ``rank_outcomes`` starts them
once, with ``start_method="spawn"`` and one thread each), and its case holds
rank 0's outcome and the ranks' agreement. Beside a card the ranks stay on
the host's CPU.

The idioms of a single-controller JAX mesh map to the port's SPMD ranks:

* ``DataParallelTrainer(model, ...)`` without a mesh trains on the JAX
  package's mesh over every device; the port's default is no mesh (ROADMAP
  Queue 3, ``parallel/``), so each such call passes ``mesh=make_mesh()``;
* ``optax.adam`` and ``optax.sgd`` are the support module's ``adam`` and
  ``sgd``, which a trainer takes as its optimizer factory;
* a JAX ``Mesh``'s ``devices`` and ``axis_names`` are the ``DeviceMesh``'s
  ``mesh`` (the ranks) and ``mesh_dim_names``; ``len(jax.devices())`` is the
  group's size; ``jax.device_put`` with ``shard_batch``'s sharding is
  ``distribute_tensor`` with its placements;
* an array's ``sharding.device_set`` and ``addressable_shards`` are
  ``device_set`` and ``addressable_shards``, which ask every rank; the
  trainer's ``params``, ``vparams`` and ``opt_state``, global arrays in JAX,
  are ``global_state``'s leaves, each whole with its ``sharding.spec``;
* the optimized HLO of a jitted function or of the trainer's
  ``_train_step.lower(...)`` is ``collective_trace``: the collectives that
  running it once issues, by their HLO names;
* swapping ``_unconstrained`` to differentiate is ``functionalize``.

Sharded-training tests on the virtual 8-device CPU mesh (SURVEY.md §4.9).
"""
import numpy as np
import pytest
import torch
from torch.distributed.tensor import distribute_tensor

import gpflow_tpu_torch
from gpflow_tpu_torch import kernels, likelihoods
from gpflow_tpu_torch.base import functionalize
from gpflow_tpu_torch.models import SVGP
from gpflow_tpu_torch.parallel import DataParallelTrainer, make_mesh, shard_batch
from .test_torch_translated_support import (  # noqa: F401
    adam, addressable_shards, asarray, collective_trace, deviation, device_set, global_state, grad, jit,
    on_ranks, rank_outcomes, seeded_generator, sgd, translated_test_environment, tree_leaves,
)

rng = np.random.RandomState(0)
N, D, M = 256, 3, 8
X = rng.randn(N, D)
Y = np.sin(X[:, :1]) + 0.1 * rng.randn(N, 1)


def _svgp():
    return SVGP(
        kernel=kernels.SquaredExponential(),
        likelihood=likelihoods.Gaussian(0.1),
        inducing_variable=X[:M].copy(),
        num_data=N,
    )


@on_ranks
def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.mesh.numel() == 8


@on_ranks
def test_sharded_loss_matches_single_device():
    model = _svgp()
    trainer = DataParallelTrainer(model, optimizer=adam(1e-2), mesh=make_mesh())
    batch = (X, Y)
    sharded_loss = float(trainer.loss(batch))
    local_loss = float(model.training_loss(batch))
    np.testing.assert_allclose(sharded_loss, local_loss, rtol=1e-10)


@on_ranks
def test_sharded_training_improves_and_finalizes():
    model = _svgp()
    trainer = DataParallelTrainer(model, optimizer=adam(5e-2), mesh=make_mesh())
    batch = trainer.shard((X, Y))
    first = float(trainer.step(batch, presharded=True))
    for _ in range(30):
        last = float(trainer.step(batch, presharded=True))
    assert last < first - 1.0
    trainer.finalize()
    # model now holds the trained (post-update) parameters
    np.testing.assert_allclose(
        float(model.training_loss((X, Y))), float(trainer.loss((X, Y))), rtol=1e-8
    )


@on_ranks
def test_sharded_gradients_match_single_device():
    model = _svgp()
    trainer = DataParallelTrainer(model, optimizer=sgd(0.1), donate=False, mesh=make_mesh())
    batch = (X, Y)

    # one sharded SGD step
    trainer.step(batch)
    sharded_params = [np.asarray(p) for p in global_state(trainer).params]

    # manual single-device SGD step
    model2 = _svgp()
    params = model2.trainable_parameters

    def loss_fn(unc):
        return functionalize(lambda: model2.training_loss(batch), params)(unc)

    grads = grad(loss_fn)(tuple(p.unconstrained for p in params))
    expected = [np.asarray(p.unconstrained.detach() - 0.1 * g) for p, g in zip(params, grads)]
    for s, e in zip(sharded_params, expected):
        np.testing.assert_allclose(s, e, rtol=1e-8, atol=1e-10)


@on_ranks
def test_batch_actually_sharded():
    mesh = make_mesh()
    sharding = shard_batch(mesh)
    xb = distribute_tensor(asarray(X), mesh, sharding)
    assert len(device_set(xb)) == 8


@on_ranks
def test_sharded_natgrad_adam_classification():
    """natgrad_gamma: the natural-gradient step on (q_mu, q_sqrt) runs inside
    the same jitted sharded program as the Adam step on hyperparameters."""
    from gpflow_tpu_torch import likelihoods as lk

    rngc = np.random.RandomState(1)
    Nc = 256
    Xc = rngc.randn(Nc, 2)
    p = 1 / (1 + np.exp(-(np.sin(2 * Xc[:, 0]) + Xc[:, 1])))
    Yc = (rngc.rand(Nc) < p).astype(float)[:, None]
    model = SVGP(
        kernel=kernels.SquaredExponential(),
        likelihood=lk.Bernoulli(),
        inducing_variable=Xc[:16].copy(),
        num_data=Nc,
    )
    trainer = DataParallelTrainer(
        model, optimizer=adam(0.03), natgrad_gamma=0.3, mesh=make_mesh()
    )
    before = float(trainer.loss((Xc, Yc)))
    xs = np.stack([Xc] * 10)
    ys = np.stack([Yc] * 10)
    losses = trainer.run_steps((xs, ys))
    after = float(np.asarray(losses)[-1])
    assert np.isfinite(after)
    assert after < before - 5
    trainer.finalize()
    np.testing.assert_allclose(
        float(model.training_loss((Xc, Yc))), float(trainer.loss((Xc, Yc))), rtol=1e-8
    )
    # q_mu must have been moved by the natgrad step
    assert np.abs(model.q_mu.numpy()).max() > 1e-3


@on_ranks
def test_shard_internal_data_sgpr_loss_and_grads_match():
    """SGPR with N row-sharded: identical loss/grads to unsharded; the
    compiled objective contains an ICI collective (the A A^T psum)."""
    from gpflow_tpu_torch.models import SGPR
    from gpflow_tpu_torch.parallel import shard_internal_data

    def build():
        return SGPR((X, Y), kernel=kernels.SquaredExponential(), inducing_variable=X[:M].copy())

    ref, sharded = build(), build()
    shard_internal_data(sharded)
    assert len(device_set(sharded.data[0])) == 8

    np.testing.assert_allclose(
        float(sharded.training_loss()), float(ref.training_loss()), rtol=1e-10
    )

    def loss_of(model):
        params = model.trainable_parameters

        def f(unc):
            return functionalize(model.training_loss, params)(unc)

        return jit(grad(f)), tuple(p.unconstrained for p in params)

    g_ref_fn, unc = loss_of(ref)
    g_sh_fn, unc_sh = loss_of(sharded)
    for a, b in zip(g_ref_fn(unc), g_sh_fn(unc_sh)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-10)

    # the sharded objective must actually distribute: the model must flow
    # through jit ARGUMENTS (as training_loss_closure does) — closure capture
    # bakes data as constants and loses the sharding. Look for a collective.
    hlo = collective_trace(lambda m: m._training_loss(), sharded)
    assert "all-reduce" in hlo or "all-gather" in hlo


@on_ranks
def test_shard_internal_data_rejects_external_data_models():
    from gpflow_tpu_torch.parallel import shard_internal_data

    with pytest.raises(ValueError, match="internal-data"):
        shard_internal_data(_svgp())


@on_ranks
def test_sharded_predict_f_matches_local():
    from gpflow_tpu_torch.models import GPR
    from gpflow_tpu_torch.parallel import sharded_predict_f

    model = GPR((X[:64], Y[:64]), kernel=kernels.SquaredExponential())
    Xnew = rng.randn(40, D)
    mean_s, var_s = sharded_predict_f(model, Xnew)
    mean_l, var_l = model.predict_f(Xnew)
    assert len(device_set(mean_s)) == 8
    np.testing.assert_allclose(np.asarray(mean_s), np.asarray(mean_l), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(var_s), np.asarray(var_l), rtol=1e-9)


@on_ranks
def test_natgrad_rejection_counter():
    """A deliberately huge gamma makes every natgrad step leave the cone: the
    state must stay finite and the trainer must count the rejections."""
    from gpflow_tpu_torch import likelihoods as lk

    rngr = np.random.RandomState(2)
    Xr = rngr.randn(64, 2)
    Yr = (rngr.rand(64, 1) < 0.5).astype(float)
    model = SVGP(
        kernel=kernels.SquaredExponential(),
        likelihood=lk.Bernoulli(),
        inducing_variable=Xr[:8].copy(),
        num_data=64,
    )
    trainer = DataParallelTrainer(model, optimizer=adam(0.01), natgrad_gamma=1e6, mesh=make_mesh())
    assert trainer.natgrad_rejections == 0
    for _ in range(3):
        loss = trainer.step((Xr, Yr))
        assert np.isfinite(float(loss))
    # at gamma=1e6 most steps leave the cone (a step whose direction makes
    # nat2 even more negative-definite can still legitimately be accepted)
    assert trainer.natgrad_rejections >= 2
    trainer.finalize()
    assert np.isfinite(model.q_mu.numpy()).all()
    assert np.isfinite(model.q_sqrt.numpy()).all()


@on_ranks
def test_sharded_natgrad_heteroskedastic_two_latents():
    """natgrad_gamma with L=2 latent GPs (heteroskedastic likelihood):
    exercises the batched [L, M, M] natural-parameter conversions inside the
    sharded step."""
    from gpflow_tpu_torch import likelihoods as lk
    from gpflow_tpu_torch.kernels import SeparateIndependent, SquaredExponential
    from gpflow_tpu_torch.inducing_variables import (
        SeparateIndependentInducingVariables,
        InducingPoints,
    )

    rngh = np.random.RandomState(4)
    Nh = 128
    Xh = np.linspace(0, 4, Nh)[:, None]
    scale = np.exp(0.3 * Xh - 1)
    Yh = np.sin(2 * Xh) + scale * rngh.randn(Nh, 1)

    Z = Xh[::16].copy()
    model = SVGP(
        kernel=SeparateIndependent([SquaredExponential(), SquaredExponential()]),
        likelihood=lk.HeteroskedasticTFPConditional(),
        inducing_variable=SeparateIndependentInducingVariables(
            [InducingPoints(Z.copy()), InducingPoints(Z.copy())]
        ),
        num_data=Nh,
        num_latent_gps=2,
    )
    assert model.q_sqrt.value.shape == (2, len(Z), len(Z))

    trainer = DataParallelTrainer(
        model, optimizer=adam(0.02), natgrad_gamma=0.1, mesh=make_mesh()
    )
    before = float(trainer.loss((Xh, Yh)))
    xs = np.stack([Xh] * 20)
    ys = np.stack([Yh] * 20)
    losses = np.asarray(trainer.run_steps((xs, ys)))
    assert np.isfinite(losses).all()
    assert losses[-1] < before - 1
    trainer.finalize()
    # both latents' variational parameters moved
    assert np.abs(model.q_mu.numpy()).max() > 1e-3


def _multioutput_svgp(L=4, M=8):
    from gpflow_tpu_torch.kernels import SeparateIndependent, SquaredExponential
    from gpflow_tpu_torch.inducing_variables import (
        SeparateIndependentInducingVariables,
        InducingPoints,
    )

    ks = [SquaredExponential(lengthscales=1.0 + 0.1 * i) for i in range(L)]
    ivs = SeparateIndependentInducingVariables(
        [InducingPoints(X[i * M : (i + 1) * M].copy()) for i in range(L)]
    )
    Ym = np.concatenate([Y] * L, axis=1)
    return (
        SVGP(
            kernel=SeparateIndependent(ks),
            likelihood=likelihoods.Gaussian(0.1),
            inducing_variable=ivs,
            num_data=N,
            num_latent_gps=L,
        ),
        Ym,
    )


@on_ranks
def test_latent_axis_2d_mesh_matches_1d():
    """data x latent 2-D mesh: losses identical to the replicated 1-D run,
    variational state actually sharded over the latent axis."""
    batch_of = lambda Ym: (X[:64], Ym[:64])

    m1, Ym = _multioutput_svgp()
    t1 = DataParallelTrainer(m1, optimizer=adam(0.01), mesh=make_mesh())
    l1 = [float(t1.step(batch_of(Ym))) for _ in range(4)]

    m2, _ = _multioutput_svgp()
    mesh = make_mesh(shape={"data": 2, "latent": 4})
    t2 = DataParallelTrainer(
        m2, optimizer=adam(0.01), mesh=mesh, latent_axis="latent"
    )
    l2 = [float(t2.step(batch_of(Ym))) for _ in range(4)]
    np.testing.assert_allclose(l1, l2, rtol=1e-8)

    q_sqrt_leaf = next(p for p in global_state(t2).params if p.ndim == 3)
    spec = q_sqrt_leaf.sharding.spec
    assert spec and spec[0] == "latent"
    q_mu_leaf = next(p for p in global_state(t2).params if p.ndim == 2 and p.shape == (M, 4))
    assert tuple(q_mu_leaf.sharding.spec) in ((None, "latent"),)

    t2.finalize()
    mu, _ = m2.predict_f(X[:8])
    assert np.isfinite(np.asarray(mu)).all()


@on_ranks
def test_latent_axis_with_natgrad():
    m, Ym = _multioutput_svgp()
    mesh = make_mesh(shape={"data": 4, "latent": 2})
    t = DataParallelTrainer(
        m, optimizer=adam(0.02), mesh=mesh, latent_axis="latent",
        natgrad_gamma=0.1,
    )
    before = float(t.loss((X, Ym)))
    xs = np.stack([X[:64]] * 10)
    ys = np.stack([Ym[:64]] * 10)
    losses = np.asarray(t.run_steps((xs, ys)))
    assert np.isfinite(losses).all()
    assert losses[-1] < before
    assert t.natgrad_rejections == 0


@on_ranks
def test_latent_axis_validation_errors():
    m, _ = _multioutput_svgp(L=3)
    mesh = make_mesh(shape={"data": 4, "latent": 2})
    with pytest.raises(ValueError, match="divisible"):
        DataParallelTrainer(m, mesh=mesh, latent_axis="latent")
    m1 = _svgp()
    with pytest.raises(ValueError, match="not an axis"):
        DataParallelTrainer(m1, latent_axis="latent", mesh=make_mesh())


@on_ranks
def test_run_steps_sampled_device_data():
    """On-device batch sampling: staged dataset, in-graph uniform indices,
    losses finite and decreasing; results deterministic given the key."""
    model = _svgp()
    trainer = DataParallelTrainer(model, optimizer=adam(0.02), mesh=make_mesh())
    trainer.stage_data((X, Y))

    before = float(trainer.loss((X, Y)))
    l1 = np.asarray(trainer.run_steps_sampled(20, 64, generator=seeded_generator(7)))
    assert l1.shape == (20,)
    assert np.isfinite(l1).all()
    assert float(trainer.loss((X, Y))) < before

    # same key, fresh trainer -> identical loss trajectory
    model2 = _svgp()
    trainer2 = DataParallelTrainer(model2, optimizer=adam(0.02), mesh=make_mesh())
    trainer2.stage_data((X, Y))
    l2 = np.asarray(trainer2.run_steps_sampled(20, 64, generator=seeded_generator(7)))
    np.testing.assert_allclose(l1, l2, rtol=1e-10)

    # without staging it refuses
    trainer3 = DataParallelTrainer(_svgp(), optimizer=adam(0.02), mesh=make_mesh())
    with pytest.raises(ValueError, match="stage_data"):
        trainer3.run_steps_sampled(2, 8)


@on_ranks
def test_latent_axis_opt_state_sharded():
    """Adam's mu/nu for the latent-sharded q_mu/q_sqrt must themselves be
    latent-sharded — jitted optimizer.init lowers zeros_like to a
    data-independent broadcast, so the trainer re-places the state
    explicitly (each device must hold L/l of the [L, M, M] state, not a
    full replicated copy)."""
    m, _ = _multioutput_svgp()
    mesh = make_mesh(shape={"data": 2, "latent": 4})
    tr = DataParallelTrainer(
        m, optimizer=adam(0.01), mesh=mesh, latent_axis="latent"
    )
    q_sqrt_shape = next(p.shape for p in global_state(tr).params if p.ndim == 3)
    state_leaves = tree_leaves(global_state(tr).opt_state)
    sharded = [l for l in state_leaves if getattr(l, "ndim", 0) == 3 and l.shape == q_sqrt_shape]
    assert sharded, "expected adam mu/nu leaves matching q_sqrt's shape"
    for leaf in sharded:
        assert leaf.sharding.spec and leaf.sharding.spec[0] == "latent", leaf.sharding


@on_ranks
def test_natgrad_fused_converges_like_sequential():
    """natgrad_fused=True: one backward for both gradient sets. Per-step
    trajectories differ from the sequential mode (simultaneous vs
    staggered update) but both converge on the same problem."""
    from gpflow_tpu_torch import likelihoods as lk

    rngc = np.random.RandomState(3)
    Nc = 256
    Xc = rngc.randn(Nc, 2)
    p = 1 / (1 + np.exp(-(np.sin(2 * Xc[:, 0]) + Xc[:, 1])))
    Yc = (rngc.rand(Nc) < p).astype(float)[:, None]

    def run(fused):
        model = SVGP(
            kernel=kernels.SquaredExponential(),
            likelihood=lk.Bernoulli(),
            inducing_variable=Xc[:16].copy(),
            num_data=Nc,
        )
        trainer = DataParallelTrainer(
            model, optimizer=adam(0.03), natgrad_gamma=0.3,
            natgrad_fused=fused, mesh=make_mesh(),
        )
        xs, ys = np.stack([Xc] * 25), np.stack([Yc] * 25)
        losses = np.asarray(trainer.run_steps((xs, ys)))
        assert np.isfinite(losses).all()
        return losses

    seq, fus = run(False), run(True)
    # reported losses differ in convention (sequential evaluates after the
    # natgrad update, fused before any update), so compare only progress:
    # both converge to essentially the same objective
    assert fus[-1] < fus[0] - 5
    assert abs(fus[-1] - seq[-1]) < 0.15 * abs(seq[0] - seq[-1])


@on_ranks
def test_dp_step_hlo_has_collectives_and_sharded_batch():
    """Guard against silent replication: the compiled dp train
    step must (a) receive B/n-per-device batch shards and (b) contain
    cross-device all-reduce collectives in its optimized HLO. A sharding
    regression to full replication passes numeric checks but fails here."""
    model = _svgp()
    trainer = DataParallelTrainer(model, optimizer=adam(1e-2), mesh=make_mesh())
    batch = trainer.shard((X, Y))

    for arr in batch:
        shard_shapes = {tuple(s.data.shape) for s in addressable_shards(arr)}
        assert shard_shapes == {(N // 8,) + arr.shape[1:]}, (
            f"batch axis not sharded 8-way: {shard_shapes}"
        )

    hlo = collective_trace(trainer._train_step, batch)
    assert "all-reduce" in hlo, "dp step compiled without cross-device collectives"


@on_ranks
def test_latent_axis_2d_hlo_has_collectives():
    """Same guard for the 2-D (data x latent) mesh path."""
    mesh = make_mesh(shape={"data": 4, "latent": 2})
    mo, Ym = _multioutput_svgp(L=2, M=8)
    trainer = DataParallelTrainer(
        mo, optimizer=adam(1e-2), mesh=mesh, latent_axis="latent"
    )
    batch = trainer.shard((X[:32], Ym[:32]))
    assert "all-reduce" in collective_trace(trainer._train_step, batch)


@on_ranks
def test_shard_internal_data_gpr_and_vgp_match_unsharded():
    """Exact-GP path (SURVEY 7.1): GPR and VGP with K(X, X) rows built
    sharded must reproduce the unsharded objective exactly and compile with
    an ICI collective."""
    from gpflow_tpu_torch.models import GPR, VGP
    from gpflow_tpu_torch.parallel import shard_internal_data

    Xs, Ys = X[:64], Y[:64]

    gpr_ref = GPR((Xs, Ys), kernel=kernels.SquaredExponential(), noise_variance=0.1)
    gpr_sh = GPR((Xs, Ys), kernel=kernels.SquaredExponential(), noise_variance=0.1)
    shard_internal_data(gpr_sh)
    assert len(device_set(gpr_sh.data[0])) == 8
    np.testing.assert_allclose(
        float(gpr_sh.training_loss()), float(gpr_ref.training_loss()), rtol=1e-10
    )
    hlo = collective_trace(lambda m: m._training_loss(), gpr_sh)
    assert "all-reduce" in hlo or "all-gather" in hlo

    vgp_ref = VGP((Xs, Ys), kernel=kernels.SquaredExponential(),
                  likelihood=likelihoods.Gaussian(0.1))
    vgp_sh = VGP((Xs, Ys), kernel=kernels.SquaredExponential(),
                 likelihood=likelihoods.Gaussian(0.1))
    shard_internal_data(vgp_sh)
    np.testing.assert_allclose(
        float(vgp_sh.training_loss()), float(vgp_ref.training_loss()), rtol=1e-10
    )


@on_ranks
def test_shard_internal_data_preserves_gplvm_parameter():
    """GPLVM stores its TRAINABLE latent X inside model.data; sharding must
    leave the Parameter intact (only the observed Y gets distributed)."""
    from gpflow_tpu_torch.base import Parameter
    from gpflow_tpu_torch.models import GPLVM
    from gpflow_tpu_torch.parallel import shard_internal_data

    Yl = rng.randn(40, 4)
    m = GPLVM(Yl, latent_dim=2)
    shard_internal_data(m)
    assert isinstance(m.data[0], Parameter)
    assert any(p is m.data[0] for p in m.trainable_parameters)
    assert len(device_set(m.data[1])) == 8
    assert np.isfinite(float(m.training_loss()))


@on_ranks
def test_make_hybrid_mesh_layout_and_training():
    """DCN-aware hybrid mesh: logical shape = ici * dcn per axis; on a
    single granule (this CPU mesh) it degenerates to a reshape, and a
    trainer built on it matches the plain-mesh run exactly."""
    from gpflow_tpu_torch.parallel import make_hybrid_mesh

    mesh = make_hybrid_mesh(ici={"data": 2, "latent": 2}, dcn={"data": 2})
    assert mesh.mesh_dim_names == ("data", "latent")
    assert tuple(mesh.mesh.shape) == (4, 2)
    assert len({int(d) for d in mesh.mesh.flatten()}) == 8

    # dcn axis must be declared in ici (size-1 ici for pure-DCN axes)
    with pytest.raises(ValueError, match="not in ici axes"):
        make_hybrid_mesh(ici={"data": 2}, dcn={"batch": 2})
    with pytest.raises(ValueError, match="needs"):
        make_hybrid_mesh(ici={"data": 8}, dcn={"data": 2})

    model = _svgp()
    t_plain = DataParallelTrainer(model, optimizer=adam(0.01), mesh=make_mesh())
    l_plain = [float(t_plain.step((X[:64], Y[:64]))) for _ in range(3)]

    model2 = _svgp()
    hmesh = make_hybrid_mesh(ici={"data": 4}, dcn={"data": 2})
    t_hyb = DataParallelTrainer(model2, optimizer=adam(0.01), mesh=hmesh)
    l_hyb = [float(t_hyb.step((X[:64], Y[:64]))) for _ in range(3)]
    np.testing.assert_allclose(l_plain, l_hyb, rtol=1e-10)


@on_ranks
def test_make_hybrid_mesh_multislice_selection_errors():
    """Slice-aware device selection: requesting more DCN granules than
    slices, or more per-slice devices than a slice has, must raise clearly
    instead of silently collapsing the layout."""
    from gpflow_tpu_torch.parallel import make_hybrid_mesh

    class _Dev:
        def __init__(self, i, s):
            self.id, self.slice_index = i, s

    # 2 slices x 4 devices
    devs = [_Dev(i, i // 4) for i in range(8)]
    with pytest.raises(ValueError, match="slices"):
        make_hybrid_mesh(ici={"data": 2}, dcn={"data": 3}, devices=devs)
    with pytest.raises(ValueError, match="per\\s+slice"):
        # 8 ICI devices per slice requested but each slice has only 4
        make_hybrid_mesh(ici={"data": 8}, devices=devs)


@on_ranks
def test_make_mesh_rejects_oversubscription():
    """num_devices > available must raise like the shape= path does
    (silent truncation halved the mesh and broke batch divisibility
    assumptions without signal)."""
    with pytest.raises(ValueError, match="requested but only"):
        make_mesh(num_devices=torch.distributed.get_world_size() + 1)


@deviation("parallel/")
@on_ranks
def test_trainer_leaves_argument_never_aliases_donated_params():
    """The jitted step donates (params, vparams, opt_state); the leaves
    argument must NOT carry the same buffers (aliased
    donated inputs only worked via dead-code elimination and would fail with
    a donated-buffer execute error if any path read them)."""
    model = _svgp()
    trainer = DataParallelTrainer(model, optimizer=adam(1e-2), mesh=make_mesh())
    assert all(trainer._static_leaves[i] is None for i in trainer._train_idx)
    param_ids = {id(p) for p in global_state(trainer).params} | {id(p) for p in global_state(trainer).vparams}
    assert not any(
        id(l) in param_ids for l in trainer._static_leaves if l is not None
    )
    # two consecutive donated steps + a loss eval still work and finalize
    l1 = float(trainer.step((X, Y)))
    l2 = float(trainer.step((X, Y)))
    assert np.isfinite(l1) and np.isfinite(l2)
    trainer.finalize()


@deviation("parallel/")
@on_ranks
def test_trainer_rejection_tracking_noop_without_natgrad():
    """No natgrad => no per-step device scalars are retained
    (the pending list grew one buffer per step for a counter that is
    identically zero)."""
    model = _svgp()
    trainer = DataParallelTrainer(model, optimizer=adam(1e-2), mesh=make_mesh())
    for _ in range(3):
        trainer.step((X, Y))
    assert trainer._pending_rejections == []
    assert trainer.natgrad_rejections == 0


@pytest.mark.parametrize("seed", range(6))
@on_ranks
def test_sharded_training_fuzz_matches_single_device(seed):
    """Randomized (mesh x model x batch x natgrad) configs: the sharded
    trainer's loss trajectory must equal a single-device trainer started
    from an identical model, to f64 accuracy."""
    r = np.random.RandomState(100 + seed)
    kind = ["svgp", "svgp_bern", "multioutput"][r.randint(3)]
    data_size = int(r.choice([2, 4, 8]))
    B = int(r.choice([4, 8]) * data_size)
    steps = 3

    if kind == "multioutput":
        L = int(r.choice([2, 4]))
        model, Ym = _multioutput_svgp(L=L, M=8)
        data = (X[:B], Ym[:B])
        natgrad = None
        use_latent = bool(r.randint(2))
        mesh = (
            make_mesh(shape={"data": data_size, "latent": min(L, 8 // data_size)})
            if use_latent and data_size < 8
            else make_mesh(num_devices=data_size)
        )
        latent_axis = "latent" if (use_latent and data_size < 8) else None
    else:
        if kind == "svgp_bern":
            model = SVGP(
                kernel=kernels.SquaredExponential(),
                likelihood=likelihoods.Bernoulli(),
                inducing_variable=X[:8].copy(),
                num_data=N,
            )
            data = (X[:B], (Y[:B] > 0).astype(float))
        else:
            model = _svgp()
            data = (X[:B], Y[:B])
        natgrad = float(r.choice([0.0, 0.1, 0.3])) or None
        mesh = make_mesh(num_devices=data_size)
        latent_axis = None

    model_ref = gpflow_tpu_torch.utilities.deepcopy(model)
    kw = dict(optimizer=adam(0.02))
    if natgrad:
        kw["natgrad_gamma"] = natgrad
    t_sharded = DataParallelTrainer(model, mesh=mesh, latent_axis=latent_axis, **kw)
    t_single = DataParallelTrainer(model_ref, mesh=make_mesh(num_devices=1), **kw)
    ls = [float(t_sharded.step(data)) for _ in range(steps)]
    lr = [float(t_single.step(data)) for _ in range(steps)]
    np.testing.assert_allclose(ls, lr, rtol=1e-8, err_msg=f"config: {kind}, "
                               f"mesh={mesh.shape}, B={B}, natgrad={natgrad}")
    t_sharded.finalize()
    t_single.finalize()
    # parameters: slightly looser than the losses — Adam's sqrt(v)+eps
    # normalization amplifies f64 psum reduction-order differences between
    # mesh sizes by ~1/sqrt(v), so 1e-8-grade losses give ~1e-7 params
    for p, q in zip(model.all_parameters, model_ref.all_parameters):
        np.testing.assert_allclose(
            np.asarray(p.value), np.asarray(q.value), rtol=1e-6, atol=1e-9
        )


@on_ranks
def test_shard_internal_data_matrix_free_cglb_matches_unsharded():
    """Matrix-free CGLB with N row-sharded (the SURVEY §5
    'sharded N×N exact-GP path' end-state): the chunked v @ K(x, xc) matvec
    contracts over the sharded data axis (per-device partial products +
    psum). Loss must be identical to single-device and the compiled matvec
    must contain a cross-device collective."""
    from gpflow_tpu_torch.models import CGLB
    from gpflow_tpu_torch.parallel import shard_internal_data

    def build():
        return CGLB(
            (X, Y), kernel=kernels.SquaredExponential(lengthscales=np.ones(D)),
            inducing_variable=X[:M].copy(), cg_tolerance=0.1, max_cg_iters=20,
            matrix_free_chunk=32,
        )

    ref, sharded = build(), build()
    shard_internal_data(sharded)
    assert len(device_set(sharded.data[0])) == 8

    l_ref = float(ref.training_loss_closure(compile=True)())
    l_sh = float(sharded.training_loss_closure(compile=True)())
    np.testing.assert_allclose(l_sh, l_ref, rtol=1e-10)

    # the matvec itself (not just the SGPR-common terms) must distribute:
    # isolate the K-operator and check its HLO for a collective
    def matvec_norm(m):
        mv = m._kmat_operator()
        v = torch.ones((1, m.data[0].shape[0]), dtype=m.data[0].dtype)
        return torch.sum(mv(v) ** 2)

    hlo = collective_trace(matvec_norm, sharded)
    assert "all-reduce" in hlo or "all-gather" in hlo, (
        "sharded matrix-free matvec compiled without cross-device collectives"
    )
    # full objective too
    hlo_obj = collective_trace(lambda m: m._training_loss(), sharded)
    assert "all-reduce" in hlo_obj


@on_ranks
def test_sharded_predict_f_posterior_matches_local():
    """sharded_predict_f over a CACHED posterior (the serving path in
    dryrun_multichip path 7) matches the local posterior predictions."""
    from gpflow_tpu_torch.parallel import sharded_predict_f

    model = _svgp()
    posterior = model.posterior()
    Xt = rng.randn(64, D)
    mean_l, var_l = posterior.predict_f(Xt)
    mean_s, var_s = sharded_predict_f(posterior, Xt)
    np.testing.assert_allclose(np.asarray(mean_s), np.asarray(mean_l), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(var_s), np.asarray(var_l), rtol=1e-10, atol=1e-12)


@on_ranks
def test_checkpoint_roundtrip_across_mesh_shapes(tmp_path):
    """Save sharded training state mid-run on an 8-device mesh, restore onto
    a 4-device mesh, continue — losses must match an unbroken run
    (reference checkpoint story
    saving_and_loading.pct.py:103-190)."""
    batches8 = (np.stack([X[i * 32 % (N - 32):][:32] for i in range(6)]),
                np.stack([Y[i * 32 % (N - 32):][:32] for i in range(6)]))

    # unbroken run: 6 steps on the 8-device mesh
    model_a = _svgp()
    tr_a = DataParallelTrainer(model_a, optimizer=adam(5e-2),
                               mesh=make_mesh(8), donate=False)
    losses_a = np.asarray(tr_a.run_steps(batches8))

    # broken run: 3 steps on 8 devices, checkpoint, restore onto 4 devices
    model_b = _svgp()
    tr_b = DataParallelTrainer(model_b, optimizer=adam(5e-2),
                               mesh=make_mesh(8), donate=False)
    first3 = (batches8[0][:3], batches8[1][:3])
    last3 = (batches8[0][3:], batches8[1][3:])
    losses_b1 = np.asarray(tr_b.run_steps(first3))
    tr_b.save_state(str(tmp_path / "ckpt"))

    model_c = _svgp()  # fresh (untrained) model — state must come from disk
    tr_c = DataParallelTrainer(model_c, optimizer=adam(5e-2),
                               mesh=make_mesh(4), donate=False)
    tr_c.load_state(str(tmp_path / "ckpt"))
    losses_b2 = np.asarray(tr_c.run_steps(last3))

    np.testing.assert_allclose(
        np.concatenate([losses_b1, losses_b2]), losses_a, rtol=1e-6
    )
    # finalize writes restored+trained values back into the fresh model
    tr_c.finalize()
    np.testing.assert_allclose(
        float(model_c.training_loss((X, Y))), float(tr_c.loss((X, Y))), rtol=1e-8
    )


@on_ranks
def test_checkpoint_rejects_structure_mismatch(tmp_path):
    model = _svgp()
    tr = DataParallelTrainer(model, optimizer=adam(5e-2), donate=False, mesh=make_mesh())
    tr.save_state(str(tmp_path / "ckpt2"))
    other = DataParallelTrainer(_svgp(), optimizer=sgd(0.1), donate=False, mesh=make_mesh())
    with pytest.raises(ValueError, match="leaves|structure"):
        other.load_state(str(tmp_path / "ckpt2"))
