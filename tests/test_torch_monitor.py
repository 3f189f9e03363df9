"""``monitor`` of gpflow_tpu_torch on the CPU: the cases of
``tests/gpflow_tpu/test_monitor.py`` on a port GPR (task scheduling and
argument routing, each TensorBoard task, shared writers, ``Scipy``'s Monitor
hook), and the event files of both packages' tasks from the same values,
read back with TensorBoard's reader: the same tags, steps and scalars."""
import sys

import numpy as np
import pytest
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

import gpflow_tpu
import gpflow_tpu.monitor as jax_monitor
from gpflow_tpu.utilities import read_values as jax_read_values
from gpflow_tpu_torch import config, kernels, likelihoods
from gpflow_tpu_torch.models import GPR, SVGP
from gpflow_tpu_torch.monitor import (
    ExecuteCallback,
    ImageToTensorBoard,
    ModelToTensorBoard,
    Monitor,
    MonitorTask,
    MonitorTaskGroup,
    ScalarToTensorBoard,
    ToTensorBoard,
)
from gpflow_tpu_torch.optimizers import Scipy
from gpflow_tpu_torch.utilities import load_jax_values, training_loop

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

NUM_DATA = 20


def _data():
    rng = np.random.RandomState(0)
    return rng.randn(NUM_DATA, 2), rng.randn(NUM_DATA, 2)


@pytest.fixture
def model():
    return GPR(_data(), kernel=kernels.SquaredExponential(lengthscales=[1.0, 2.0]), noise_variance=0.01)


@pytest.fixture(autouse=True)
def _close_writers():
    yield
    ToTensorBoard.close_all_writers()
    jax_monitor.ToTensorBoard.close_all_writers()


@pytest.fixture
def monitor(model, tmp_path):
    log_dir = str(tmp_path)
    return Monitor(
        MonitorTaskGroup(
            [ModelToTensorBoard(log_dir, model), ScalarToTensorBoard(log_dir, model.log_marginal_likelihood, "lml")],
            period=2,
        ),
        MonitorTaskGroup(ExecuteCallback(lambda: print("foo")), period=1),
    )


def _events(log_dir):
    acc = EventAccumulator(str(log_dir), size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    scalars = {tag: [(e.step, e.value) for e in acc.Scalars(tag)] for tag in acc.Tags()["scalars"]}
    return scalars, {tag: len(acc.Images(tag)) for tag in acc.Tags()["images"]}


def _dir_size(d) -> int:
    return sum(f.stat().st_size for f in d.glob("**/*") if f.is_file())


def test_execute_callback_argument_routing(capsys):
    def cb1(x=None, **_):
        assert x is not None
        print(x)

    def cb3(y=None, **_):
        assert y is not None
        print(y)

    monitor = Monitor(MonitorTaskGroup([ExecuteCallback(cb1), ExecuteCallback(lambda **_: print(2))]),
                      MonitorTaskGroup(ExecuteCallback(cb3)))
    monitor(0, x=1, y=3)
    assert capsys.readouterr().out == "1\n2\n3\n"


@pytest.mark.parametrize("n_tasks", [None, 1, 2])
def test_monitor_task_group_takes_a_task_or_tasks(n_tasks):
    calls = []
    tasks = ExecuteCallback(lambda: calls.append(1))
    if n_tasks is not None:
        tasks = [ExecuteCallback(lambda: calls.append(1)) for _ in range(n_tasks)]
    group = MonitorTaskGroup(tasks, period=2)
    assert isinstance(group.tasks, list)
    group(0)
    group(1)
    Monitor(group)(2)
    assert len(calls) == 2 * (n_tasks or 1)


def test_periodicity_group(capsys):
    often = MonitorTaskGroup([ExecuteCallback(lambda: print("a", end=" ")),
                              ExecuteCallback(lambda: print("b", end=" "))], period=1)
    seldom = MonitorTaskGroup([ExecuteCallback(lambda: print("X", end=" "))], period=3)
    monitor = Monitor(often, seldom)
    for i in range(7):
        monitor(i)
    assert capsys.readouterr().out == "a b X a b a b a b X a b a b a b X "


def test_scalar_to_tensorboard_arguments(tmp_path):
    ScalarToTensorBoard(str(tmp_path), lambda x=None: 2 * x, "scalar")(0, x=1.0)
    task = ScalarToTensorBoard(str(tmp_path), lambda x=None: 0.0, "other")
    with pytest.raises(TypeError, match="unexpected keyword argument 'y'"):
        task(0, y=1.0)
    scalars, _ = _events(tmp_path)
    assert scalars == {"scalar": [(0, 2.0)]}


def test_model_to_tensorboard_keyword_filter_and_max_size(model, tmp_path):
    recorded = []

    class SpyModelTask(ModelToTensorBoard):
        def _summarize_parameter(self, name, value):
            recorded.append(name)
            super()._summarize_parameter(name, value)

    SpyModelTask(str(tmp_path), model, keywords_to_monitor=["kernel"])(0)
    assert sorted(recorded) == ["kernel.lengthscales", "kernel.variance"]
    recorded.clear()
    SpyModelTask(str(tmp_path), model, keywords_to_monitor=["*"], max_size=1)(1)
    assert sorted(recorded) == ["kernel.lengthscales", "kernel.variance", "likelihood.variance"]
    scalars, _ = _events(tmp_path)
    assert sorted(scalars) == ["kernel.lengthscales[0]", "kernel.lengthscales[1]", "kernel.variance",
                               "likelihood.variance"]
    assert [step for step, _ in scalars["kernel.lengthscales[1]"]] == [0]


def test_logdir_grows_during_training(monitor, model, tmp_path):
    monitor(0)
    size_before = _dir_size(tmp_path)
    assert size_before > 0
    training_loop(model.training_loss, maxiter=2)
    for step in range(1, 3):
        monitor(step)
    assert _dir_size(tmp_path) > size_before


def test_writer_close_and_evict(tmp_path):
    d1, d2 = str(tmp_path / "run1"), str(tmp_path / "run2")
    t1, t2 = ScalarToTensorBoard(d1, lambda: 1.0, "a"), ScalarToTensorBoard(d2, lambda: 2.0, "b")
    assert ScalarToTensorBoard(d1, lambda: 1.0, "c").file_writer is t1.file_writer  # one writer per directory
    t1(0)
    t2(0)
    assert d1 in ToTensorBoard.writers and d2 in ToTensorBoard.writers
    ToTensorBoard.close_writer(d1)
    assert d1 not in ToTensorBoard.writers and d2 in ToTensorBoard.writers
    ToTensorBoard.close_writer(d1)  # idempotent
    ScalarToTensorBoard(d1, lambda: 3.0, "a")(1)
    ToTensorBoard.close_all_writers()
    assert ToTensorBoard.writers == {}


def test_image_to_tensorboard_writes_one_image_per_call(tmp_path):
    import matplotlib

    def plot(fig, axes):
        for ax in axes.ravel():
            ax.plot([0.0, 1.0], [0.0, 1.0])

    before = matplotlib.get_backend()
    task = ImageToTensorBoard(str(tmp_path), plot, "grid", fig_kw=dict(figsize=(4, 4)),
                              subplots_kw=dict(sharex=True, nrows=2, ncols=2))
    task(0)
    assert matplotlib.get_backend() == before
    ToTensorBoard.close_all_writers()
    assert _events(tmp_path) == ({}, {"grid": 1})


@pytest.mark.parametrize("module, task", [("torch.utils.tensorboard", "ScalarToTensorBoard"),
                                          ("matplotlib", "ImageToTensorBoard")])
def test_missing_package_raises_import_error_naming_it(monkeypatch, tmp_path, module, task):
    monkeypatch.setitem(sys.modules, module, None)
    package = "tensorboard" if module.endswith("tensorboard") else "matplotlib"
    args = {"ScalarToTensorBoard": (lambda: 0.0, "s"), "ImageToTensorBoard": (lambda fig, ax: None,)}[task]
    with pytest.raises(ImportError, match=f"needs the {package} package"):
        getattr(sys.modules["gpflow_tpu_torch.monitor"], task)(str(tmp_path / "x"), *args)


def _svgp_pair():
    rng = np.random.RandomState(3)
    X = rng.rand(8, 2)
    jm = gpflow_tpu.models.SVGP(kernel=gpflow_tpu.kernels.Matern52(lengthscales=[0.7, 1.3, 0.4]),
                                likelihood=gpflow_tpu.likelihoods.Gaussian(0.2),
                                inducing_variable=np.c_[X[:4], rng.rand(4)], num_data=8)
    pm = SVGP(kernel=kernels.Matern52(lengthscales=np.ones(3)), likelihood=likelihoods.Gaussian(1.0),
              inducing_variable=np.zeros((4, 3)), num_data=8)
    load_jax_values(pm, jax_read_values(jm))
    return jm, pm


@pytest.mark.parametrize("keywords, max_size", [(None, 3), (["*"], -1), (["kernel"], 2)])
def test_event_files_match_the_jax_package(tmp_path, keywords, max_size):
    """ModelToTensorBoard and ScalarToTensorBoard in both packages, on
    models with the same values, write the same tags, steps and scalars."""
    jm, pm = _svgp_pair()
    out = {}
    for name, mod, m in (("jax", jax_monitor, jm), ("torch", sys.modules["gpflow_tpu_torch.monitor"], pm)):
        log_dir = str(tmp_path / name)
        counter = iter(range(100))
        monitor = mod.Monitor(
            mod.MonitorTaskGroup(mod.ModelToTensorBoard(log_dir, m, keywords_to_monitor=keywords,
                                                        max_size=max_size), period=2),
            mod.MonitorTaskGroup(mod.ScalarToTensorBoard(log_dir, lambda: 0.25 * next(counter), "metric")),
        )
        for step in range(5):
            monitor(step)
        mod.ToTensorBoard.close_all_writers()
        out[name] = _events(log_dir)
    assert out["torch"] == out["jax"]
    scalars, _ = out["torch"]
    assert scalars["metric"] == [(i, 0.25 * i) for i in range(5)]
    assert all([s for s, _ in v] == [0, 2, 4] for k, v in scalars.items() if k != "metric")


def test_scipy_monitor_as_step_callback(monitor, model):
    Scipy().minimize(model.training_loss, model.trainable_variables, step_callback=monitor,
                     options={"maxiter": 3})


def test_scipy_calls_the_monitor_with_the_step_alone(model):
    """A Monitor as ``step_callback`` is called once per iteration with the
    step alone, and sees the current iterate, as in the JAX package."""
    seen = {}
    for name, mod, gpr in (("jax", jax_monitor, gpflow_tpu.models.GPR), ("torch", None, None)):
        calls = []
        if name == "jax":
            m = gpr(_data(), kernel=gpflow_tpu.kernels.SquaredExponential(lengthscales=[1.0, 2.0]),
                    noise_variance=0.01)
            opt, task_base, mon, group = gpflow_tpu.optimizers.Scipy(), mod.MonitorTask, mod.Monitor, \
                mod.MonitorTaskGroup
        else:
            m, opt, task_base, mon, group = model, Scipy(), MonitorTask, Monitor, MonitorTaskGroup

        class Record(task_base):
            def run(self, **kwargs):
                calls.append((self.current_step, kwargs, float(np.ravel(m.kernel.lengthscales.numpy())[0])))

        res = opt.minimize(m.training_loss, m.trainable_variables, step_callback=mon(group(Record(), period=1)),
                           options={"maxiter": 10})
        assert [c[0] for c in calls] == list(range(res.nit)) and all(c[1] == {} for c in calls)
        assert calls[-1][2] == float(np.ravel(m.kernel.lengthscales.numpy())[0])
        assert len({round(c[2], 12) for c in calls}) > 1
        seen[name] = np.array([c[2] for c in calls])
    assert seen["torch"].shape == seen["jax"].shape
    np.testing.assert_allclose(seen["torch"], seen["jax"], rtol=1e-6)
