"""What the translated JAX test files share (``tests/test_torch_translated_<stem>.py``).

Each of those files is one of the JAX package's test files that import jax
or optax, with the JAX idioms replaced one for one and nothing else changed:
the same numpy draws, oracles, tolerances, test names and ids. This module
holds the replacements:

* ``DEVICE``: the device the files build on, named by
  ``GPFLOW_TPU_TORCH_REFERENCE_DEVICE`` ("cpu" unless set), so that the same
  files run on the card;
* ``X64``, the keywords that make ``torch.ones``, ``torch.eye`` and the like
  build what ``jnp.ones``, ``jnp.eye`` and the like build;
* ``asarray`` for ``jnp.asarray``: a tensor on ``DEVICE`` that keeps a numpy
  array's dtype, and takes Python numbers and lists as float64 (the JAX
  package's tests run with x64 on);
* ``seeded_generator`` for a PRNG key, which the port's samplers take as
  ``generator=``;
* ``polyval`` for ``jnp.polyval`` and ``solve_triangular`` for
  ``jax.scipy.linalg.solve_triangular``;
* ``grad``, ``value_and_grad`` and ``vjp`` for ``jax.grad``,
  ``jax.value_and_grad`` and ``jax.vjp``, through ``torch.autograd.grad``
  (``argnums`` for several positional arguments; a Module argument through
  ``base.functionalize``, its gradient a module of the same treedef);
* ``jit`` for ``jax.jit``: the port's ``_compile.jit``, which traces the
  function once per input signature and replays the trace; its
  ``on_trace`` is the statement a JAX test runs at trace time where the
  test says that its trace count stands for shapes, run in the traced body;
* ``tree_flatten``, ``tree_unflatten``, ``tree_map`` and ``tree_leaves``
  for ``jax.tree_util``'s over a Module: the leaves are ``functionalize``'s
  flat values (the Parameters' unconstrained tensors), the ``TreeDef`` the
  structure and a copy of the module to rebuild from;
* ``adam`` and ``sgd`` for ``optax.adam`` and ``optax.sgd``: ``torch.optim.Adam``
  and ``torch.optim.SGD`` with the same learning rate, behind optax's
  ``init`` and ``update``, and a factory that a ``DataParallelTrainer``
  takes;
* ``on_ranks`` with the module fixture ``rank_outcomes``, the 8-rank
  runner: a test over the JAX package's 8 virtual devices runs on every
  rank of a gloo group of ``RANKS`` CPU ranks; ``device_set``,
  ``addressable_shards``, ``collective_trace`` and ``global_state`` read
  what the JAX tests read of a sharded array, of a compiled program's
  collectives and of the trainer's global state;
* ``translated_test_environment``, an autouse fixture of module scope that
  each file imports, so that it holds for the file's module fixtures too:
  the shape checks on, as ``tests/conftest.py`` turns
  them on for the JAX package, and ``np.asarray`` of a tensor read through
  ``.detach().cpu()``, as the conformance plugin does (ROADMAP Queue 3, "the
  output side of F3"), with ``test_torch_environment.THREADS`` threads of
  torch's pool: the JAX tests' arrays are small, and the suite's other
  workers run beside them.

A JAX test that the port cannot meet by design carries ``deviation(name)``:
a strict xfail whose reason names a deviation of ROADMAP Queue 3 (the rows
of ``DEVIATIONS``), so that the case fails while the deviation stands and
fails the run once it does not.

It holds no test.
"""
import collections
import copy
import datetime
import importlib
import inspect
import itertools
import os
import pickle
import time
import types
import traceback

import numpy as np
import pytest
import torch

from gpflow_tpu_torch import _compile, config
from gpflow_tpu_torch.base import Module, Parameter, functionalize
from gpflow_tpu_torch.utilities.shapes import get_enable_check_shapes, set_enable_check_shapes

from .test_torch_reference_plugin import DEVICE_VARIABLE
from .test_torch_environment import THREADS

DEVICE = torch.device(os.environ.get(DEVICE_VARIABLE, "cpu"))
config.set_default_device(DEVICE.type)
# A tensor factory's keywords for what ``jnp.ones``, ``jnp.eye`` and the
# like build: float64 (x64 is on) on DEVICE.
X64 = {"dtype": torch.float64, "device": DEVICE}

# ROADMAP Queue 3's deviations that the translated tests meet, by name.
DEVIATIONS = {
    "the draws": (
        "the port draws from a torch.Generator, and nothing is traced: equal inputs do not give equal draws, "
        "and a call without a generator is never refused"
    ),
    # A Parameter's value and an entry point's result are tensors.
    "the output side of F3": (
        "entry points and a Parameter's value return tensors on the module's device, never numpy values"
    ),
    "parameter equality": (
        "== and != on a Parameter compare identity, as torch compares modules; the JAX package's compare values "
        "elementwise"
    ),
    # The JAX trainer's bookkeeping of donated buffers and pending scalars.
    "parallel/": (
        "the port's trainer donates nothing and counts rejected natural-gradient steps in one device scalar: "
        "the JAX trainer's _static_leaves, _train_idx and _pending_rejections have no counterpart"
    ),
    # GPFLOW_TPU_DISABLE_X64 and the bf16 tiers of the JAX package.
    "the matmul tiers": (
        "GPFLOW_TPU_DISABLE_X64 is accepted and switches nothing: arrays keep their float64, and "
        "GPFLOW_TPU_FAST_MATMUL's tiers are TF32 on CUDA"
    ),
}


def deviation(name):
    """The mark of a JAX test that fails on the port as the deviation
    ``name`` says."""
    return pytest.mark.xfail(strict=True, reason=f"deviation {name}: {DEVIATIONS[name]}")


_TENSOR_ARRAY = torch.Tensor.__array__


def _tensor_array(tensor, *args, **kwargs):
    return _TENSOR_ARRAY(tensor.detach().cpu(), *args, **kwargs)


@pytest.fixture(scope="module", autouse=True)
def translated_test_environment():
    array, checks, threads = torch.Tensor.__array__, get_enable_check_shapes(), torch.get_num_threads()
    torch.Tensor.__array__ = _tensor_array
    set_enable_check_shapes(True)
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(threads)
    set_enable_check_shapes(checks)
    torch.Tensor.__array__ = array


def asarray(value, dtype=None):
    """``jnp.asarray``: a tensor passes through; anything else becomes a
    tensor on ``DEVICE`` in its numpy dtype; with ``dtype``, in that dtype."""
    if isinstance(value, torch.Tensor):
        return value if dtype is None else value.to(dtype)
    return torch.as_tensor(np.asarray(value), dtype=dtype, device=DEVICE)


def solve_triangular(a, b, lower=False):
    """``jax.scipy.linalg.solve_triangular`` (no transposes)."""
    return torch.linalg.solve_triangular(a, b, upper=not lower)


def seeded_generator(seed):
    """A PRNG key (``jax.random.PRNGKey(seed)``): a ``torch.Generator`` on
    ``DEVICE`` seeded with ``seed`` (ROADMAP Queue 3, "The draws")."""
    return torch.Generator(device=DEVICE).manual_seed(seed)


def polyval(coeffs, x):
    """``jnp.polyval``: the polynomial of ``coeffs`` (highest power first) at
    ``x``, by Horner's rule."""
    out = torch.zeros_like(x)
    for c in coeffs:
        out = out * x + c
    return out


class _TorchOptimizer:
    """An optax-style (``init``, ``update``) pair over a ``torch.optim``
    optimizer: ``update`` steps the optimizer on copies of the parameters
    and returns the change of each, which the caller adds, as optax's
    updates are added."""

    def __init__(self, cls, learning_rate):
        self.cls, self.learning_rate = cls, learning_rate

    def init(self, params):
        leaves = [asarray(p).detach().clone() for p in params]
        return leaves, self.cls(leaves, lr=self.learning_rate)

    def __call__(self, params):
        """The optimizer as a ``DataParallelTrainer`` takes it: a factory of
        the ``torch.optim`` optimizer over ``params``."""
        return self.cls(params, lr=self.learning_rate)

    def update(self, grads, state, params=None):
        leaves, optimizer = state
        before = [leaf.clone() for leaf in leaves]
        for leaf, g in zip(leaves, grads):
            leaf.grad = g.detach()
        optimizer.step()
        return tuple(leaf.detach() - b for leaf, b in zip(leaves, before)), state


def adam(learning_rate):
    """``optax.adam``: ``torch.optim.Adam`` with the same learning rate (and
    the same defaults: betas (0.9, 0.999), eps 1e-8)."""
    return _TorchOptimizer(torch.optim.Adam, learning_rate)


def sgd(learning_rate):
    """``optax.sgd``: ``torch.optim.SGD`` with the same learning rate."""
    return _TorchOptimizer(torch.optim.SGD, learning_rate)


def jit(fun=None, *, on_trace=None):
    """``jax.jit``: the port's ``_compile.jit``, which runs the function's
    body once per input signature, at trace time, and replays the trace at
    every other call. Where a JAX test counts traces by a statement that
    runs at trace time, that statement is ``on_trace``, called with the
    arguments in the traced body."""
    if fun is None:
        return lambda f: jit(f, on_trace=on_trace)
    if on_trace is None:
        return _compile.jit(fun)

    def traced(*args, **kwargs):
        on_trace(*args, **kwargs)
        return fun(*args, **kwargs)

    return _compile.jit(traced)


def _leaf(value):
    return asarray(value).detach().clone().requires_grad_(True)


# --- pytrees: a Module flattened to functionalize's flat values ----------------------

# The attributes of every torch module: its registries, hooks and mode.
_TORCH_STATE = frozenset(vars(torch.nn.Module()))


def _attributes(module):
    """A module's attributes as the JAX package's pytree sees them: its
    plain attributes and its registered child modules, by name."""
    return {**{k: v for k, v in vars(module).items() if k not in _TORCH_STATE}, **module._modules}


def _describe(value):
    """The structure of ``value`` that a treedef holds: types, static
    values, containers and the Parameters' places, not their values."""
    if isinstance(value, Parameter):
        return ("parameter", type(value.transform).__name__, value.trainable, value.name, value.prior_on,
                tuple(value.unconstrained.shape), value.unconstrained.dtype)
    if isinstance(value, torch.nn.Module):
        attributes = _attributes(value)
        return (type(value), tuple((k, _describe(attributes[k])) for k in sorted(attributes)))
    if isinstance(value, (list, tuple)):
        return (type(value), tuple(_describe(v) for v in value))
    if isinstance(value, dict):
        return (type(value), getattr(value, "default_factory", None),
                tuple((k, _describe(v)) for k, v in value.items()))
    if isinstance(value, (torch.Tensor, np.ndarray)):
        return ("array", tuple(value.shape), str(value.dtype))
    return ("static", value)


class TreeDef:
    """A flattened Module's treedef: its structure (``_describe``), which
    two treedefs compare by, and a copy of the module to rebuild from."""

    def __init__(self, module):
        self.template = copy.deepcopy(module)
        self.structure = _describe(module)

    def __eq__(self, other):
        return isinstance(other, TreeDef) and self.structure == other.structure

    __hash__ = None


def tree_flatten(module):
    """``jax.tree_util.tree_flatten`` of a Module (or a Parameter): the
    leaves are ``functionalize``'s flat values, the unconstrained tensors of
    ``all_parameters``, and the treedef holds the rest."""
    return [p.unconstrained.detach() for p in module.all_parameters], TreeDef(module)


def tree_unflatten(treedef, leaves):
    """``jax.tree_util.tree_unflatten``: a module rebuilt from the treedef
    with ``leaves`` as its Parameters' unconstrained values."""
    module = copy.deepcopy(treedef.template)
    with torch.no_grad():
        for p, leaf in zip(module.all_parameters, leaves):
            p.unconstrained.copy_(leaf)
    return module


def tree_map(fun, tree, *rest):
    """``jax.tree_util.tree_map`` over Modules of one treedef."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fun(*ls) for ls in zip(leaves, *others)])


def tree_leaves(tree, is_leaf=None):
    """``jax.tree_util.tree_leaves`` of a Module: its attributes in the JAX
    package's order (sorted names; a dict's sorted keys, an OrderedDict's
    insertion order), a Parameter giving its unconstrained tensor unless
    ``is_leaf`` takes it whole, arrays and tensors as leaves, and every
    other value static."""
    out = []

    def walk(value):
        if is_leaf is not None and is_leaf(value):
            out.append(value)
        elif isinstance(value, Parameter):
            out.append(value.unconstrained.detach())
        elif isinstance(value, torch.nn.Module):
            attributes = _attributes(value)
            for k in sorted(attributes):
                walk(attributes[k])
        elif isinstance(value, (list, tuple)):
            for v in value:
                walk(v)
        elif isinstance(value, dict):
            items = value.items() if isinstance(value, collections.OrderedDict) else sorted(value.items())
            for _, v in items:
                walk(v)
        elif isinstance(value, (torch.Tensor, np.ndarray, ShardedLeaf)):
            out.append(value)

    walk(tree)
    return out


def _module_value_and_grad(fun, module, *args, **kwargs):
    """``jax.value_and_grad`` with respect to a Module: autograd through
    ``functionalize`` over its flat values; the gradient is a module of
    the same treedef."""
    leaves, treedef = tree_flatten(module)
    leaves = [_leaf(t) for t in leaves]
    value = functionalize(lambda: fun(module, *args, **kwargs), module.all_parameters)(leaves)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return value.detach(), tree_unflatten(treedef, [torch.zeros_like(t) if g is None else g
                                                    for t, g in zip(leaves, grads)])


def value_and_grad(fun, argnums=None):
    """``jax.value_and_grad`` of a function of one argument: a tensor or an
    array, a tuple or list of them, or a Module (its gradient a module of
    the same treedef); with a tuple ``argnums``, of those positional
    arguments, whose gradients come as a tuple."""
    if argnums is not None:
        def over_args(*args):
            leaves = {i: _leaf(args[i]) for i in argnums}
            value = fun(*(leaves.get(i, a) for i, a in enumerate(args)))
            grads = torch.autograd.grad(value, [leaves[i] for i in argnums], allow_unused=True)
            return value.detach(), tuple(torch.zeros_like(leaves[i]) if g is None else g
                                         for i, g in zip(argnums, grads))

        return over_args

    def wrapped(arg, *args, **kwargs):
        if isinstance(arg, Module):
            return _module_value_and_grad(fun, arg, *args, **kwargs)
        leaves = [_leaf(a) for a in arg] if isinstance(arg, (tuple, list)) else [_leaf(arg)]
        value = fun(type(arg)(leaves) if isinstance(arg, (tuple, list)) else leaves[0], *args, **kwargs)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        return value.detach(), (type(arg)(grads) if isinstance(arg, (tuple, list)) else grads[0])

    return wrapped


def vjp(fun, *primals):
    """``jax.vjp``: ``fun``'s value at ``primals`` and its pullback, which
    takes the cotangent and returns one gradient per primal."""
    leaves = [_leaf(p) for p in primals]
    out = fun(*leaves)

    def pullback(cotangent):
        grads = torch.autograd.grad(out, leaves, cotangent, retain_graph=True, allow_unused=True)
        return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads))

    return out.detach(), pullback


def grad(fun, argnums=None):
    """``jax.grad`` of a function of one argument, or of the positional
    arguments ``argnums``."""
    both = value_and_grad(fun, argnums)
    return lambda *args, **kwargs: both(*args, **kwargs)[1]


# --- the ranks of a JAX mesh: a gloo group of CPU ranks ----------------------------

#: The ranks of the group, as many as the JAX package's virtual CPU devices
#: (``tests/conftest.py``).
RANKS = 8
# Seconds for a whole file on every rank: the 8 ranks of
# test_torch_translated_parallel.py took 70 s alone and 122-155 s in the tier-1
# run, so a hang fails that file's cases in about 3x that, not the suite's run.
RANK_TIMEOUT = 420
# Seconds a collective waits: ranks out of step fail their case, not the file.
# The longest case takes 7.8 s alone on each rank.
COLLECTIVE_TIMEOUT = 60
_ON_RANKS = {}  # module name -> its cases, in definition order


def _case_keys(case):
    """The key of each parametrized instance of ``case``: its name and the
    sorted keyword arguments of the instance."""
    marks = [m for m in getattr(case, "pytestmark", []) if m.name == "parametrize"]
    grids = []
    for m in marks:
        names = [n.strip() for n in m.args[0].split(",")] if isinstance(m.args[0], str) else list(m.args[0])
        values = [v if len(names) > 1 else (v,) for v in m.args[1]]
        grids.append([dict(zip(names, v)) for v in values])
    for combo in itertools.product(*grids):
        kwargs = {k: v for d in combo for k, v in d.items()}
        yield (case.__name__, tuple(sorted(kwargs.items()))), kwargs


def on_ranks(fun):
    """A JAX test over a mesh of the package's 8 virtual devices: its body
    runs on every rank of a gloo group of ``RANKS`` CPU ranks (SPMD), once
    per parametrized instance, in the processes that the module fixture
    ``rank_outcomes`` starts; the case holds rank 0's outcome and the ranks'
    agreement. A ``tmp_path`` argument is a directory that every rank
    shares."""
    sig = inspect.signature(fun)
    params = [p for p in sig.parameters if p != "tmp_path"]

    def case(rank_outcomes, **kwargs):
        key = (fun.__name__, tuple(sorted(kwargs.items())))
        outcomes = [ranks[key] for ranks in rank_outcomes]
        failed = [o for o in outcomes if o != "passed"]
        if failed:
            raise AssertionError(f"{len(failed)} of {len(outcomes)} ranks failed; "
                                 f"rank {outcomes.index(failed[0])}:\n{failed[0]}")

    case.__name__ = case.__qualname__ = fun.__name__
    case.__module__, case.__doc__ = fun.__module__, fun.__doc__
    case.__signature__ = inspect.Signature(
        [inspect.Parameter("rank_outcomes", inspect.Parameter.POSITIONAL_OR_KEYWORD)]
        + [inspect.Parameter(p, inspect.Parameter.POSITIONAL_OR_KEYWORD) for p in params])
    case.body = fun
    _ON_RANKS.setdefault(fun.__module__, []).append(case)
    return case


def _rank_main(rank, world, module_name, store, workdir):
    """One rank: joins the group, runs every ``on_ranks`` body of the module
    on the CPU and writes each instance's outcome."""
    torch.set_num_threads(1)
    torch.Tensor.__array__ = _tensor_array  # as ``translated_test_environment``
    set_enable_check_shapes(True)
    config.set_default_device("cpu")  # the card is one device: the ranks stay on the host's CPU
    torch.distributed.init_process_group("gloo", store=torch.distributed.FileStore(store, world), rank=rank,
                                         world_size=world, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    module = importlib.import_module(module_name)
    config.set_default_device("cpu")
    outcomes, times = {}, {}
    try:
        for case in _ON_RANKS[module_name]:
            for key, kwargs in _case_keys(case):
                if "tmp_path" in inspect.signature(case.body).parameters:
                    kwargs = {**kwargs, "tmp_path": _shared_dir(workdir, key)}
                t0 = time.perf_counter()
                try:
                    case.body(**kwargs)
                    outcomes[key] = "passed"
                except BaseException as e:  # noqa: BLE001 - every outcome is the case's to judge
                    outcomes[key] = f"{type(e).__name__}: {e}\n{traceback.format_exc()[-3000:]}"
                times[key] = time.perf_counter() - t0
                torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((outcomes, times), f)


def _shared_dir(workdir, key):
    import pathlib

    path = pathlib.Path(workdir) / ("tmp_" + "_".join(str(k) for k in (key[0], *(v for _, v in key[1]))))
    path.mkdir(exist_ok=True)
    return path


@pytest.fixture(scope="module")
def rank_outcomes(request, tmp_path_factory):
    """Starts ``RANKS`` rank processes (``start_method="spawn"``, one thread
    each, a ``FileStore`` in a temporary directory) that run the module's
    ``on_ranks`` bodies; returns each rank's outcomes by case."""
    import torch.multiprocessing as mp

    workdir = str(tmp_path_factory.mktemp("ranks"))
    device = os.environ.get(DEVICE_VARIABLE)
    os.environ[DEVICE_VARIABLE] = "cpu"  # the ranks build on the host's CPU, also beside the card
    try:
        context = mp.start_processes(_rank_main, args=(RANKS, request.module.__name__, os.path.join(workdir, "store"),
                                                       workdir), nprocs=RANKS, join=False, start_method="spawn")
    finally:
        if device is None:
            del os.environ[DEVICE_VARIABLE]
        else:
            os.environ[DEVICE_VARIABLE] = device
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        while not context.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {RANKS} ranks did not finish in {RANK_TIMEOUT} s")
    finally:
        for p in context.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(RANKS):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f)[0])
    return out


# --- the JAX package's view of a sharded array ----------------------------------------


def _gather_objects(value):
    """``value`` from every rank of the default group, in rank order."""
    out = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(out, value)
    return out


def device_set(x):
    """``x.sharding.device_set``: the ranks that hold ``x`` or a block of
    it. A DTensor lives on its mesh's ranks; a tensor on every rank that
    holds one when all ranks ask (each rank holds its block, SPMD)."""
    if isinstance(x, torch.distributed.tensor.DTensor):
        return set(x.device_mesh.mesh.reshape(-1).tolist())
    held = _gather_objects(isinstance(x, torch.Tensor))
    return {rank for rank, h in enumerate(held) if h}


def addressable_shards(x):
    """``x.addressable_shards``: every rank's block of a split tensor, each
    as a shard's ``data``, in rank order."""
    return [types.SimpleNamespace(data=block) for block in _gather_objects(x.detach().cpu())]


# The collectives of ``c10d``, by the name XLA's optimized HLO gives them.
_HLO_NAMES = {"allreduce_": "all-reduce", "allgather_": "all-gather", "_allgather_base_": "all-gather",
              "allgather_into_tensor_coalesced_": "all-gather", "reduce_scatter_": "reduce-scatter",
              "_reduce_scatter_base_": "reduce-scatter", "broadcast_": "broadcast", "alltoall_": "all-to-all",
              "barrier": "barrier"}


def collective_trace(fun, *args, **kwargs):
    """``jax.jit(fun).lower(*args).compile().as_text()`` as far as a test
    reads it, the collectives: runs ``fun`` once and returns the names of
    the collectives it ran, one a line, as XLA names them (``all-reduce``,
    ``all-gather``, ...). A trainer's step is traced at its first call and
    replayed (``_compile.jit``): the names are those of the replay, whose
    collectives communicate (the trace's run on fake tensors is left out)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from gpflow_tpu_torch._compile import is_tracing

    names = []

    class _Trace(TorchDispatchMode):
        def __torch_dispatch__(self, func, types_, args_=(), kwargs_=None):
            if func.namespace == "c10d" and not is_tracing():
                op = func._schema.name.split("::")[-1]
                names.append(_HLO_NAMES.get(op, op))
            return func(*args_, **(kwargs_ or {}))

    with _Trace():
        fun(*args, **kwargs)
    return "\n".join(names)


class ShardedLeaf:
    """A leaf of the JAX trainer's state, a global array: its whole value
    (gathered where the trainer splits it over the latent axis) and its
    ``sharding``, whose ``spec`` names that axis at the split dimension and
    whose ``device_set`` is the mesh's ranks."""

    def __init__(self, whole, spec, devices):
        self.value, self.shape, self.ndim = whole, tuple(whole.shape), whole.ndim
        self.sharding = types.SimpleNamespace(spec=spec, device_set=devices)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.value.detach().cpu(), dtype=dtype)


def global_state(trainer):
    """The JAX trainer's ``params``, ``vparams`` and ``opt_state``: the
    port's trainer keeps this rank's blocks (``_state_leaves``, the
    parameters, the natural-gradient ones, then the optimizer's state), and
    each becomes a ``ShardedLeaf`` (a collective where the latent GPs are
    split)."""
    mesh = trainer.mesh
    latent = None
    if trainer._latents is not None:
        latent = next(n for n in mesh.mesh_dim_names if mesh.get_group(n) == trainer._latents.group)
    devices = set(mesh.mesh.reshape(-1).tolist()) if mesh is not None else {0}
    leaves = []
    for t, dim in trainer._state_leaves():
        whole = t if dim is None else trainer._latents.gather(t.contiguous(), dim)
        spec = tuple(latent if d == dim else None for d in range(whole.ndim))
        leaves.append(ShardedLeaf(whole.detach(), spec, devices))
    n, v = len(trainer._params), len(trainer._vparams)
    return types.SimpleNamespace(params=leaves[:n], vparams=leaves[n:n + v], opt_state=leaves[n + v:])

