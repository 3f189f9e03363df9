"""Trace once per input signature, replay the trace: the port's counterpart
of ``jax.jit`` for its functions and Modules.

``jit(fun)`` returns a callable that, at the first call with a given input
signature, runs ``fun`` once under ``make_fx`` with fake tensors (so that
the trace launches no kernel and reads no value) and keeps the resulting
``torch.fx.GraphModule``; every later call with that signature replays the
graph on the call's tensors without running ``fun``'s Python body. The
hand-written kernels K1 and K2 stand in the graph as their registered ops
(``torch.ops.gpflow_tpu_torch.stationary_k1`` and ``stationary_k2``), so a
replay launches exactly what an eager call launches.

* **Flattening.** The arguments flatten as the JAX package's pytrees do
  (``gpflow_tpu/base.py``, Module's flatten): every tensor, every numpy
  array (as a tensor, by ``base.input_to_tensor``'s rule) and, for a
  Module, every Parameter's unconstrained tensor, buffer and tensor or
  array attribute at any depth of lists, tuples and dicts, is an input of
  the trace. A bound method of a Module flattens its module as its first
  argument. Everything else is static.
* **The key.** The classes, the attribute structure and the statics (by
  value where they hash, else by identity), each input's shape, dtype,
  device, strides and ``requires_grad``, grad mode, the package's config,
  the kernel switch and the shape-check switch. A static change retraces; a
  value change (``assign``, a data tensor replaced by one of the same
  signature) replays.
* **What is constant.** A tensor that the body reads and that is not an
  input (a closure's data, a Parameter read through a closure) stands in
  the graph by reference: the replay reads its current contents, and a
  tensor put in its place afterwards is not seen, as a constant of a
  ``jax.jit`` trace is not.
* **Draws.** A draw from a ``torch.Generator`` made through ``randn`` (a
  standard normal) or ``rand`` (a uniform on [0, 1)) is an input of the
  trace: each replay draws it from the generator before it runs the
  graph, in the order of the body's draws, so that it draws afresh and
  from the state an eager call would draw from.
* **Loops and branches.** ``while_loop`` and ``cond`` run torch's
  ``while_loop`` and ``cond`` operators: eagerly a loop on the host that
  reads the predicate, in a trace one node of the graph whose bodies are
  subgraphs (``lax.while_loop`` and ``lax.cond`` in the JAX package). What
  the bodies read besides their carried values is passed to them as
  ``captured`` and becomes the operator's operands; a subgraph that holds a
  traced tensor it was not given raises ``TraceError``. The launches of the
  bodies' kernels are counted at each replay as eagerly, per iteration.
* **Readouts.** A value that a body computes for its caller to read
  afterwards, outside its result (CGLB's CG iteration count), is set by
  ``readout``: the trace returns it as an extra output and each replay sets
  the module's attribute to the replay's tensor. Such an attribute, named
  in the class's ``_readouts``, is no part of a key.
* **Gradients.** A replay runs under ``torch.no_grad``. Where grad mode is
  on, an input requires grad and the result has one scalar differentiable
  output (a loss), the trace also holds that output's gradient with
  respect to the inputs that require grad, and the replay's result carries
  it back to them through autograd, as an eager call's would. A result
  differentiable otherwise raises when autograd reaches it: take the
  gradient inside the function instead. Gradients reach the inputs only,
  never a constant; a body that reads a trainable Parameter that is not an
  input while its loss is differentiated raises at trace time, as does a
  body that calls ``backward()``.
* **Collectives.** A ``torch.distributed`` collective in a body (on a
  mesh of ``parallel/``) stands in the graph as its ``c10d`` op, which a
  replay runs, each followed by its wait (``_wait_after_collectives``). Its
  process group is held by the graph; the records that name it
  (``_sharding.Blocks``, ``ReadHook``) are statics compared by value
  (group, rank, size), so two meshes or two splits trace apart and one
  mesh replays step after step. The trace runs the collectives on fake
  tensors, which communicate nothing: each rank traces at its first call
  and then replays, in the same order of collectives as every other rank.
* **No fallback.** A body that cannot be traced (it reads a value on the
  host: ``.item()``, ``bool`` of a tensor, numpy of a tensor, a collective
  of Python objects) raises ``TraceError`` with the reason; nothing
  quietly runs eagerly.

A call made while a trace is being taken, or inside ``torch.export`` or a
``torch.func`` transform, runs ``fun`` inline, as a jitted function called
inside another ``jax.jit`` does.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import threading
import types
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["TraceError", "cond", "constants_of", "draws", "is_tracing", "jit", "lift_constants", "outside_trace",
           "over_tensors", "rand", "randn", "readout", "trace", "trace_counts", "while_loop"]

DEFAULT_CACHE_SIZE = 64

# traces taken so far, by the traced function's qualified name
trace_counts: "collections.Counter[str]" = collections.Counter()

# The attributes that ``nn.Module.__init__`` sets: its registries, hooks and mode.
_NN_STATE = frozenset(vars(nn.Module()))
_SCALARS = (type(None), bool, int, float, complex, str, bytes)

_state = threading.local()


class TraceError(RuntimeError):
    """A function that ``jit`` cannot trace, with the reason."""


def is_tracing() -> bool:
    """True while this thread takes a trace (inside the traced body)."""
    return getattr(_state, "depth", 0) > 0


@contextlib.contextmanager
def outside_trace() -> Iterator[None]:
    """Runs the block on real tensors, also while a trace is taken: for a
    cache that a body fills (``quadrature.DeviceGrid``), which must hold
    real tensors and not the trace's."""
    if not is_tracing():
        yield
        return
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

    with unset_fake_temporarily(), disable_proxy_modes_tracing():
        yield


_DRAWS = {"normal": torch.randn, "uniform": torch.rand}


def _draw(kind: str, shape: Sequence[int], generator: Optional[torch.Generator], dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    if generator is None or not is_tracing():
        return _DRAWS[kind](shape, generator=generator, dtype=dtype, device=device)
    with outside_trace():
        marker = torch.empty(tuple(shape), dtype=dtype, device=device)  # the graph's input, once lifted
    _state.draws[-1].append((marker, (generator, tuple(shape), dtype, device, kind)))
    return marker


def randn(shape: Sequence[int], *, generator: Optional[torch.Generator], dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """``torch.randn(shape, generator=generator, ...)``; inside a trace, with
    a generator, the draw becomes an input of the trace (see ``draws``)."""
    return _draw("normal", shape, generator, dtype, device)


def rand(shape: Sequence[int], *, generator: Optional[torch.Generator], dtype: torch.dtype,
         device: torch.device) -> torch.Tensor:
    """``torch.rand(shape, generator=generator, ...)``, uniform on [0, 1); inside
    a trace, with a generator, the draw becomes an input of the trace."""
    return _draw("uniform", shape, generator, dtype, device)


def draws(specs: Sequence[Tuple[Any, ...]]) -> List[torch.Tensor]:
    """The draws of a trace (its ``draw_specs``: generator, shape, dtype,
    device and kind), which it takes after its other inputs, drawn now from
    their generators in the body's order."""
    return [_DRAWS[kind](shape, generator=g, dtype=dtype, device=device) for g, shape, dtype, device, kind in specs]


def readout(module: nn.Module, name: str, value: torch.Tensor) -> None:
    """Inside a trace: ``module.<name>`` is set to ``value`` at every replay
    (``value``'s counterpart in the replay), for the caller to read after
    the call. ``name`` must be among the class's ``_readouts``, which no key
    includes. Outside ``jit`` (``trace`` alone) it is dropped."""
    if name not in getattr(type(module), "_readouts", ()):
        raise TraceError(f"jit: {type(module).__name__}.{name} is not among its class's _readouts")
    _state.readouts[-1].append((module, name, value))


# --- loops and branches -----------------------------------------------------------


_OPAQUE = (type, types.FunctionType, types.MethodType, types.ModuleType, torch.Generator, functools.partial)


def _capture_walk(v: Any, leaf: Callable[[torch.Tensor, Optional[Tuple[dict, str]]], Any],
                  undo: List[Tuple[dict, str, Any]], seen: set, slot: Optional[Tuple[dict, str]] = None) -> Any:
    """``v`` with ``leaf(t, slot)`` in each tensor's place: a Module's slots
    and a plain object's attributes are set in place (recorded in
    ``undo``), lists, tuples and dicts are rebuilt. ``slot`` is the (dict,
    key) that holds the tensor, a Module's slot or a plain object's
    attribute, or None where it lies in a list, tuple or dict, or is ``v``
    itself."""
    if isinstance(v, torch.Tensor):
        return leaf(v, slot)
    if isinstance(v, (list, tuple)):
        items = [_capture_walk(x, leaf, undo, seen) for x in v]
        return type(v)(*items) if hasattr(v, "_fields") else type(v)(items)
    if isinstance(v, dict):
        return type(v)((k, _capture_walk(x, leaf, undo, seen)) for k, x in v.items())
    if isinstance(v, nn.Module):
        slots = [(holder, k, a) for holder, k, a in _module_items(v)]
    elif hasattr(v, "__dict__") and not isinstance(v, _OPAQUE):
        slots = [(vars(v), k, a) for k, a in list(vars(v).items())]
    else:
        return v
    if id(v) in seen:
        return v
    seen.add(id(v))
    for holder, k, a in slots:
        new = _capture_walk(a, leaf, undo, seen, (holder, k))
        if new is not a:
            undo.append((holder, k, a))
            holder[k] = new
    return v


def over_tensors(fn: Callable[..., Any], n: int, captured: Tuple[Any, ...]
                 ) -> Tuple[Callable[..., Any], List[torch.Tensor]]:
    """``fn(*values, *captured)`` as a function of (its ``n`` values, the
    tensors of ``captured``), and those tensors: at each call the tensors it
    is given are put in their places in ``captured`` (a Module's slots, a
    plain object's attributes, rebuilt containers) for the call. The form
    that torch's loop and branch operators take, and that a checkpointed
    block takes, whose recomputation in the backward must read the tensors
    of its forward and not what its modules hold by then. Where every
    tensor lies in a slot or an attribute that holds the given one already
    (a block's forward), ``fn`` is called without the walk."""
    leaves: List[torch.Tensor] = []
    slots: List[Optional[Tuple[dict, str]]] = []
    _capture_walk(captured, lambda t, slot: leaves.append(t) or slots.append(slot) or t, [], set())
    in_place = all(slot is not None for slot in slots)

    def run(*args: torch.Tensor) -> Any:
        if in_place and all(holder[k] is t for (holder, k), t in zip(slots, args[n:])):
            return fn(*args[:n], *captured)
        it = iter(args[n:])
        undo: List[Tuple[dict, str, Any]] = []
        try:
            swapped = _capture_walk(captured, lambda t, slot: next(it), undo, set())
            return fn(*args[:n], *swapped)
        finally:
            _undo(undo)

    return run, leaves


@contextlib.contextmanager
def _uncached() -> Iterator[None]:
    """The trace's fake tensors without their dispatch cache: an operator's
    bodies are run again on fake tensors, and a collective's process group,
    an argument there, cannot be compared as a key of that cache."""
    from torch._guards import detect_fake_mode

    mode = detect_fake_mode()
    if mode is None or not hasattr(mode, "cache_enabled"):
        yield
        return
    enabled, mode.cache_enabled = mode.cache_enabled, False
    try:
        yield
    finally:
        mode.cache_enabled = enabled


def while_loop(cond_fn: Callable[..., torch.Tensor], body_fn: Callable[..., Tuple[torch.Tensor, ...]],
               carried: Sequence[torch.Tensor], captured: Tuple[Any, ...] = ()) -> Tuple[torch.Tensor, ...]:
    """``while cond_fn(*carried, *captured): carried = body_fn(*carried,
    *captured)`` through torch's ``while_loop`` operator, and the carried
    values at the end (``jax.lax.while_loop``). ``cond_fn`` returns a bool
    0-d tensor; ``body_fn`` returns new tensors of the carried values'
    shapes, dtypes and strides, none of them an input. ``captured`` holds
    everything else the two functions read that a trace computes: tensors,
    Modules, and lists, tuples, dicts and plain objects of them, passed to
    the functions after the carried values. Eagerly it runs as the
    operator's own eager implementation does, a loop on the host that reads
    the predicate once per iteration; in a trace the loop is one node of
    the graph, whose replay runs that eager implementation."""
    if not (is_tracing() or torch.compiler.is_compiling()):
        values = tuple(carried)  # the operator's own eager loop, without its dispatch
        while cond_fn(*values, *captured):
            values = tuple(body_fn(*values, *captured))
        return values
    from torch._higher_order_ops.while_loop import while_loop_op

    n = len(carried)
    (cond_run, leaves), (body_run, _) = over_tensors(cond_fn, n, captured), over_tensors(body_fn, n, captured)
    with _uncached():
        return tuple(while_loop_op(cond_run, body_run, tuple(carried), tuple(leaves)))


def cond(pred: torch.Tensor, true_fn: Callable[..., Any], false_fn: Callable[..., Any],
         operands: Sequence[torch.Tensor], captured: Tuple[Any, ...] = ()) -> Any:
    """``true_fn(*operands, *captured)`` where the bool 0-d ``pred`` holds,
    else ``false_fn(...)``, through torch's ``cond`` operator in a trace
    (``jax.lax.cond``; eagerly, as its eager implementation, a read of
    ``pred`` on the host): only the taken branch runs. The branches return new
    tensors of the same shapes, dtypes and strides, none of them an operand;
    ``captured`` is as for ``while_loop``."""
    if not (is_tracing() or torch.compiler.is_compiling()):
        return (true_fn if pred else false_fn)(*operands, *captured)
    from torch._higher_order_ops.cond import cond_op

    n = len(operands)
    (true_run, leaves), (false_run, _) = over_tensors(true_fn, n, captured), over_tensors(false_fn, n, captured)
    with _uncached():
        return cond_op(pred, true_run, false_run, (*operands, *leaves))


# --- flattening -------------------------------------------------------------------


def _module_items(module: nn.Module) -> Iterator[Tuple[Any, str, Any]]:
    """A module's slots in flattening order: its plain attributes, its
    parameters, its buffers and its child modules, each as (the dict that
    holds it, its name, its value)."""
    attrs = module.__dict__
    readouts = getattr(type(module), "_readouts", ())
    for k, v in list(attrs.items()):
        if k not in _NN_STATE and k not in readouts:
            yield attrs, k, v
    for registry in (module._parameters, module._buffers, module._modules):
        for k, v in list(registry.items()):
            yield registry, k, v


class _Flat:
    """The arguments of one call, flattened: the input tensors (numpy arrays
    not yet converted), the key, and the statics held by identity."""

    def __init__(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> None:
        self.leaves: List[Any] = []
        self.held: List[Any] = []  # unhashable statics, kept alive while keyed by id
        self._modules: Dict[int, int] = {}
        self.modules: List[nn.Module] = []  # in walk order
        self.structure = (self._walk(args), tuple((k, self._walk(v)) for k, v in sorted(kwargs.items())))

    def _walk(self, v: Any) -> Any:
        if isinstance(v, torch.Tensor):
            self.leaves.append(v)
            return ("T", tuple(v.shape), v.dtype, v.device, v.stride(), v.requires_grad)
        if isinstance(v, np.ndarray):
            self.leaves.append(v)
            return ("A", v.shape, v.dtype.str)
        if isinstance(v, nn.Module):
            seen = self._modules.get(id(v))
            if seen is not None:
                return ("R", seen)
            self._modules[id(v)] = len(self._modules)
            self.modules.append(v)
            return ("M", type(v), tuple((k, self._walk(a)) for _, k, a in _module_items(v)))
        if isinstance(v, (list, tuple)):
            return (type(v), tuple(self._walk(x) for x in v))
        if isinstance(v, dict):
            return (type(v), getattr(v, "default_factory", None), tuple((k, self._walk(x)) for k, x in v.items()))
        if isinstance(v, _SCALARS):
            return (type(v), v)
        try:
            hash(v)
        except TypeError:
            self.held.append(v)
            return ("I", type(v), id(v))
        return ("S", type(v), v)

    def tensors(self) -> List[torch.Tensor]:
        """The inputs as tensors: numpy arrays by ``input_to_tensor``'s rule,
        on the device of the first tensor input (else the default device)."""
        if all(isinstance(v, torch.Tensor) for v in self.leaves):
            return self.leaves
        from .base import _as_tensor
        from .config import default_device

        device = next((v.device for v in self.leaves if isinstance(v, torch.Tensor)), None) or default_device()
        return [v if isinstance(v, torch.Tensor) else _as_tensor(v, device) for v in self.leaves]


def _substitute(args: Tuple[Any, ...], kwargs: Dict[str, Any], inputs: Sequence[torch.Tensor]
                ) -> Tuple[Tuple[Any, ...], Dict[str, Any], List[Tuple[dict, str, Any]], List[nn.Module]]:
    """The arguments with ``inputs`` in their tensors' places, in
    ``_Flat``'s order: a Module's slots are set in place (undone by the
    returned list), containers are rebuilt. Also the Parameters whose
    unconstrained tensor was replaced."""
    it = iter(inputs)
    undo: List[Tuple[dict, str, Any]] = []
    swapped: List[nn.Module] = []
    seen: set = set()
    from .base import Parameter

    def walk(v: Any) -> Any:
        if isinstance(v, (torch.Tensor, np.ndarray)):
            return next(it)
        if isinstance(v, nn.Module):
            if id(v) not in seen:
                seen.add(id(v))
                for holder, k, a in _module_items(v):
                    new = walk(a)
                    if new is not a:
                        undo.append((holder, k, a))
                        holder[k] = new
                        if isinstance(v, Parameter) and k == "unconstrained":
                            swapped.append(v)
            return v
        if isinstance(v, (list, tuple)):
            items = [walk(x) for x in v]
            if all(a is b for a, b in zip(items, v)):
                return v
            if hasattr(v, "_fields"):
                return type(v)(*items)
            return type(v)(items)
        if isinstance(v, dict):
            items = [(k, walk(x)) for k, x in v.items()]
            if all(a is b for (_, a), b in zip(items, v.values())):
                return v
            factory = getattr(v, "default_factory", None)
            return type(v)(factory, items) if isinstance(v, collections.defaultdict) else type(v)(items)
        return v

    try:
        new_args = walk(args)
        new_kwargs = {k: walk(v) for k, v in sorted(kwargs.items())}
    except BaseException:
        _undo(undo)
        raise
    return new_args, new_kwargs, undo, swapped


def _undo(undo: List[Tuple[dict, str, Any]]) -> None:
    for holder, k, original in reversed(undo):
        holder[k] = original


def _environment() -> Tuple[Any, ...]:
    """What a body reads besides its arguments and that changes what it
    traces: grad mode, the config, the kernel switch, the shape checks."""
    from .config import config
    from .ops.pallas_distance import _switch
    from .utilities.shapes import get_enable_check_shapes

    return (torch.is_grad_enabled(), config(), _switch(), get_enable_check_shapes())


# --- outputs ----------------------------------------------------------------------


def _flatten_out(v: Any, tensors: List[torch.Tensor], name: str) -> Any:
    if isinstance(v, torch.Tensor):
        tensors.append(v)
        return ("T",)
    if isinstance(v, (list, tuple)):
        return (type(v), tuple(_flatten_out(x, tensors, name) for x in v))
    if isinstance(v, dict):
        return (type(v), tuple((k, _flatten_out(x, tensors, name)) for k, x in v.items()))
    if isinstance(v, _SCALARS + (torch.dtype, torch.device, torch.Size, np.ndarray, np.generic)):
        return ("S", v)
    raise TraceError(f"jit: {name} returned a {type(v).__name__}; a traced function returns tensors, "
                     "Python scalars and lists, tuples and dicts of them")


def _unflatten_out(spec: Any, it: Iterator[torch.Tensor]) -> Any:
    if spec[0] == "T":
        return next(it)
    if spec[0] == "S":
        return spec[1]
    kind, items = spec
    if issubclass(kind, dict):
        return kind((k, _unflatten_out(s, it)) for k, s in items)
    values = [_unflatten_out(s, it) for s in items]
    return kind(*values) if hasattr(kind, "_fields") else kind(values)


# --- tracing ----------------------------------------------------------------------

_HOST_READ_ERRORS: Tuple[type, ...] = ()


def _host_read_errors() -> Tuple[type, ...]:
    """The exceptions by which fake tensors refuse a value read on the host."""
    global _HOST_READ_ERRORS
    if not _HOST_READ_ERRORS:
        from torch._subclasses import fake_tensor
        from torch.fx.experimental import symbolic_shapes

        _HOST_READ_ERRORS = (
            fake_tensor.DataDependentOutputException,
            fake_tensor.DynamicOutputShapeException,
            fake_tensor.UnsupportedOperatorException,
            symbolic_shapes.GuardOnDataDependentSymNode,
        )
    return _HOST_READ_ERRORS


def _in_frame(exc: BaseException, function: str) -> bool:
    """True where ``exc`` was raised inside a call of a function so named
    (``torch.distributed``'s pickling of an object for a collective)."""
    tb = exc.__traceback__
    while tb is not None:
        if tb.tb_frame.f_code.co_name == function:
            return True
        tb = tb.tb_next
    return False


@contextlib.contextmanager
def _taking(name: str) -> Iterator[List[Tuple[torch.Tensor, Tuple[Any, ...]]]]:
    """The block runs a body on fake tensors (``is_tracing``); yields the
    list that collects its draws (``randn``). A value that the body reads on
    the host raises ``TraceError``."""
    _state.depth = getattr(_state, "depth", 0) + 1
    if not hasattr(_state, "draws"):
        _state.draws, _state.readouts = [], []
    markers: List[Tuple[torch.Tensor, Tuple[Any, ...]]] = []
    _state.draws.append(markers)
    _state.readouts.append([])
    try:
        yield markers
    except _host_read_errors() as exc:
        raise TraceError(f"jit: {name} cannot be traced: it reads a tensor's value on the host ({exc})") from exc
    except RuntimeError as exc:
        if "tensor subclasses" in str(exc) or "FakeTensor" in str(exc):
            raise TraceError(f"jit: {name} cannot be traced: it reads a tensor's value on the host "
                             f"({exc})") from exc
        raise
    except Exception as exc:
        if _in_frame(exc, "_object_to_tensor"):
            raise TraceError(f"jit: {name} cannot be traced: a collective of Python objects (all_gather_object, "
                             f"broadcast_object_list, ...) pickles a traced tensor on the host ({exc})") from exc
        raise
    finally:
        _state.depth -= 1
        _state.draws.pop()
        _state.readouts.pop()


def trace(fn: Callable[..., Any], inputs: Sequence[torch.Tensor], name: str) -> "torch.fx.GraphModule":
    """``make_fx`` of ``fn`` over ``inputs`` with fake tensors: the graph of
    what ``fn(*inputs)`` runs, taken without launching a kernel. A tensor
    that ``fn`` reads and that is not an input stays in the graph as a
    constant, by reference. A value read on the host raises ``TraceError``."""
    from torch.fx.experimental.proxy_tensor import make_fx

    with _taking(name) as markers:
        gm = make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(*inputs)
    _check_subgraphs(gm, markers, name)
    _lift_draws(gm, markers)
    _wait_after_collectives(gm)
    trace_counts[name] += 1
    return gm


def _subgraphs(gm: "torch.fx.GraphModule") -> List["torch.fx.GraphModule"]:
    """The graphs of ``gm``'s loop and branch operators, at any depth."""
    import torch.fx

    return [m for m in gm.modules() if m is not gm and isinstance(m, torch.fx.GraphModule)]


def _check_subgraphs(gm: "torch.fx.GraphModule", markers: List[Tuple[torch.Tensor, Tuple[Any, ...]]],
                     name: str) -> None:
    """A loop's or a branch's body that reads a traced tensor it was not
    given (``captured``) holds that tensor as a fake constant, and one that
    draws holds the draw's marker: neither can replay, so both raise."""
    from torch._subclasses.fake_tensor import FakeTensor

    drawn = {id(marker) for marker, _ in markers}
    for sub in _subgraphs(gm):
        for node in sub.graph.nodes:
            held = getattr(sub, node.target, None) if node.op == "get_attr" else None
            if isinstance(held, FakeTensor):
                raise TraceError(f"jit: {name} cannot be traced: the body of a loop or a branch reads a traced "
                                 "tensor that it was not given; pass it in `captured`")
            if id(held) in drawn:
                raise TraceError(f"jit: {name} cannot be traced: the body of a loop or a branch draws from a "
                                 "generator; draw before the loop")


def constants_of(fn: Callable[..., Any], inputs: Sequence[torch.Tensor], name: str
                 ) -> Tuple[List[torch.Tensor], List[Tuple[Any, ...]]]:
    """Runs ``fn(*inputs)`` on fake tensors without taking a graph, about
    three times cheaper than ``trace``: the real tensors that it reads
    besides its inputs, in the order in which it first reads them (the order
    in which a trace of it holds them as constants, ``lift_constants``), and
    the specs of its draws (``draws``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fakes = [mode.from_tensor(t) for t in inputs]
    read: Dict[int, torch.Tensor] = {}
    convert = mode.fake_tensor_converter.from_real_tensor

    def recorded(fake_mode: Any, t: torch.Tensor, *args: Any, **kwargs: Any) -> Any:
        read.setdefault(id(t), t)
        return convert(fake_mode, t, *args, **kwargs)

    mode.fake_tensor_converter.from_real_tensor = recorded
    with _taking(name) as markers, mode:
        fn(*fakes)
    drawn = {id(marker) for marker, _ in markers}
    return [t for i, t in read.items() if i not in drawn], [spec for _, spec in markers]


def _lift_draws(gm: "torch.fx.GraphModule", markers: List[Tuple[torch.Tensor, Tuple[Any, ...]]]) -> None:
    """Makes each draw of the body (``randn``) an input after the graph's
    own, in the body's order, and records how to draw it in
    ``gm.draw_specs``; a draw that nothing reads is an input too, so that
    the replay advances the generator as the body did."""
    gm.draw_specs = [spec for _, spec in markers]
    if not markers:
        return
    graph = gm.graph
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    inputs = {}
    for i, (marker, _) in enumerate(markers):
        if placeholders:
            with graph.inserting_after(placeholders[-1]):
                placeholders.append(graph.placeholder(f"draw_{i}"))
        else:
            with graph.inserting_before(next(iter(graph.nodes))):
                placeholders.append(graph.placeholder(f"draw_{i}"))
        inputs[id(marker)] = placeholders[-1]
    lifted = set()
    for node in list(graph.nodes):
        if node.op == "get_attr" and id(getattr(gm, node.target, None)) in inputs:
            node.replace_all_uses_with(inputs[id(getattr(gm, node.target))])
            graph.erase_node(node)
            lifted.add(node.target)
    for target in lifted:
        delattr(gm, target)
    gm.recompile()


def _wait_collective(result: Any) -> None:
    """Waits for a ``c10d`` collective's work, as ``torch.distributed``'s
    synchronous calls do after launching it (on a CUDA group the current
    stream waits; the host does not). The op returns the work boxed, a
    ``ScriptObject``, unboxed here to ``torch.distributed``'s ``Work``; an
    NCCL group that ran the collective on the current stream returns none
    (its boxed ``wait`` crashed the process), and there is nothing to wait
    for, as ``torch.distributed.all_reduce`` reads it."""
    from torch._C._distributed_c10d import Work

    for item in result if isinstance(result, (tuple, list)) else (result,):
        if isinstance(item, torch.ScriptObject):
            work = Work.unbox(item)
            if work is not None:
                work.wait()


def _wait_after_collectives(gm: "torch.fx.GraphModule") -> None:
    """A trace records a ``torch.distributed`` collective as its ``c10d`` op,
    which launches the collective and returns its work, but not the wait
    that the synchronous call makes: each such op is followed by one, or a
    replay would read the result before the collective wrote it."""
    for module in (gm, *_subgraphs(gm)):
        graph = module.graph
        collectives = [n for n in graph.nodes if n.op == "call_function"
                       and getattr(n.target, "namespace", None) == "c10d"]
        for node in collectives:
            with graph.inserting_after(node):
                graph.call_function(_wait_collective, (node,))
        if collectives:
            module.recompile()


def lift_constants(gm: "torch.fx.GraphModule") -> List[torch.Tensor]:
    """Turns every tensor constant of ``gm`` into an input after its own
    inputs, in the graph's order, and returns the constants: the graph then
    takes (its inputs..., the constants...). A constant that a loop's or a
    branch's body holds cannot be lifted into its operator: it raises."""
    for sub in _subgraphs(gm):
        if any(n.op == "get_attr" and isinstance(getattr(sub, n.target), torch.Tensor) for n in sub.graph.nodes):
            raise TraceError("jit: the body of a loop or a branch reads a tensor constant; pass it in `captured`")
    graph = gm.graph
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    constants: List[torch.Tensor] = []
    lifted: Dict[str, "torch.fx.Node"] = {}  # a constant's name -> its input
    anchor = placeholders[-1] if placeholders else None
    for node in list(graph.nodes):
        if node.op != "get_attr" or not isinstance(getattr(gm, node.target), torch.Tensor):
            continue
        placeholder = lifted.get(node.target)
        if placeholder is None:
            if anchor is None:
                with graph.inserting_before(next(iter(graph.nodes))):
                    placeholder = graph.placeholder(f"constant_{len(constants)}")
            else:
                with graph.inserting_after(anchor):
                    placeholder = graph.placeholder(f"constant_{len(constants)}")
            anchor = lifted[node.target] = placeholder
            constants.append(getattr(gm, node.target))
        node.replace_all_uses_with(placeholder)
        graph.erase_node(node)
    for target in lifted:
        delattr(gm, target)
    gm.recompile()
    return constants


def _grad(t: torch.Tensor) -> Optional[torch.Tensor]:
    """``t.grad``, which only a leaf can hold (a posterior's cache, an input
    computed with grad, is none; reading its ``grad`` warns)."""
    return t.grad if t.is_leaf else None


class _Entry:
    """One signature's trace: the graph, how its flat outputs rebuild the
    result, and how the gradients it holds map to the inputs."""

    __slots__ = ("gm", "spec", "n_out", "mode", "diff", "grad_of", "held", "name", "readouts")


class _FusedReplay(torch.autograd.Function):
    """The replay of a trace that holds its loss's gradient: forward runs
    the graph and keeps the gradients, backward scales them by the loss's
    cotangent."""

    @staticmethod
    def forward(ctx: Any, entry: _Entry, *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        flat = entry.gm(*inputs)
        outs = tuple(flat[:entry.n_out])
        ctx.entry = entry
        ctx.n_inputs = len(inputs)
        ctx.save_for_backward(*flat[entry.n_out:])
        ctx.mark_non_differentiable(*(o for i, o in enumerate(outs) if i != entry.diff))
        return outs

    @staticmethod
    def backward(ctx: Any, *gouts: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
        entry = ctx.entry
        g = gouts[entry.diff].reshape(())
        grads: List[Optional[torch.Tensor]] = [None] * ctx.n_inputs
        for i, saved in zip(entry.grad_of, ctx.saved_tensors):
            grads[i] = g * saved
        return (None, *grads)


class _NoVJPReplay(torch.autograd.Function):
    """The replay of a trace whose result is differentiable but not through
    one scalar output: backward raises."""

    @staticmethod
    def forward(ctx: Any, entry: _Entry, *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        ctx.name = entry.name
        return tuple(entry.gm(*inputs))

    @staticmethod
    def backward(ctx: Any, *gouts: torch.Tensor) -> Any:
        raise TraceError(
            f"jit: the result of {ctx.name} is differentiated from outside the trace, and it is not one "
            "scalar: only a traced loss carries its gradient back; take the gradient inside the function "
            "(torch.autograd.grad) instead")


def _inline(leaves: Sequence[Any]) -> bool:
    """True where a call must run its function inline: inside a trace, an
    export or a ``torch.func`` transform, or on fake tensors."""
    if is_tracing() or torch.compiler.is_compiling() or torch._C._are_functorch_transforms_active():
        return True
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(v, FakeTensor) for v in leaves)


class jit:
    """Traces ``fun`` once per input signature and replays the trace (see
    the module's docstring). ``cache_size`` bounds the traces kept (least
    recently used first out); ``trace_count`` counts the traces taken."""

    def __init__(self, fun: Callable[..., Any], *, cache_size: int = DEFAULT_CACHE_SIZE) -> None:
        functools.update_wrapper(self, fun)
        self._fun = fun
        self._bound_self: Optional[nn.Module] = None
        if inspect.ismethod(fun) and isinstance(fun.__self__, nn.Module):
            self._bound_self, self._fun = fun.__self__, fun.__func__
        self.cache_size = cache_size
        self.cache: "collections.OrderedDict[Any, _Entry]" = collections.OrderedDict()
        self.trace_count = 0
        self._name = getattr(fun, "__qualname__", None) or type(fun).__name__

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if self._bound_self is not None:
            args = (self._bound_self, *args)
        flat = _Flat(args, kwargs)
        if _inline(flat.leaves):
            return self._fun(*args, **kwargs)
        key = (flat.structure, _environment())
        entry = self.cache.get(key)
        if entry is None:
            inputs = flat.tensors()
            entry = self._trace(args, kwargs, inputs, flat)
            after = _Flat(args, kwargs)  # a body may set statics up lazily (a generator)
            self._check_after(flat, after)
            key = (after.structure, _environment())
            entry.held = (flat.held, after.held)
            self.cache[key] = entry
            while len(self.cache) > self.cache_size:
                self.cache.popitem(last=False)
        else:
            self.cache.move_to_end(key)
            inputs = flat.tensors()
        return self._replay(entry, inputs, flat)

    def _check_after(self, before: _Flat, after: _Flat) -> None:
        from torch._subclasses.fake_tensor import FakeTensor

        if any(isinstance(v, FakeTensor) for v in after.leaves):
            raise TraceError(f"jit: {self._name} stored a traced tensor in its arguments (a cache or an "
                             "attribute set in the body); a traced body must not keep tensors it computes")
        if len(before.leaves) != len(after.leaves) or any(a is not b for a, b in zip(before.leaves, after.leaves)):
            raise TraceError(f"jit: {self._name} changed the tensors its arguments hold while it was traced")

    def _trace(self, args: Tuple[Any, ...], kwargs: Dict[str, Any], inputs: Sequence[torch.Tensor],
               flat: _Flat) -> _Entry:
        from .base import capture_parameter_reads

        entry = _Entry()
        entry.name = self._name
        need_grad = torch.is_grad_enabled() and any(t.requires_grad for t in inputs)
        record: Dict[str, Any] = {}

        def body(*fakes: torch.Tensor) -> List[torch.Tensor]:
            grads_before = [_grad(f) for f in fakes]
            new_args, new_kwargs, undo, swapped = _substitute(args, kwargs, fakes)
            try:
                with capture_parameter_reads() as reads:
                    out = self._fun(*new_args, **new_kwargs)
            finally:
                _undo(undo)
            if any(_grad(f) is not g for f, g in zip(fakes, grads_before)):
                raise TraceError(f"jit: {self._name} calls backward(); a traced body takes gradients with "
                                 "torch.autograd.grad and returns them")
            tensors: List[torch.Tensor] = []
            record["spec"] = _flatten_out(out, tensors, self._name)
            n_result = len(tensors)
            # a readout's module: by its place among the arguments' modules, else by reference
            readouts = _state.readouts[-1]
            record["readouts"] = [(flat._modules.get(id(m), m), name) for m, name, _ in readouts]
            tensors += [value for _, _, value in readouts]
            diff = [i for i, t in enumerate(tensors[:n_result]) if t.requires_grad]
            record["mode"], record["diff"], record["grad_of"] = "plain", None, ()
            flat_out = [t.detach() if t.requires_grad else t for t in tensors]
            if not (need_grad and diff):
                return flat_out
            if len(diff) != 1 or tensors[diff[0]].numel() != 1:
                record["mode"] = "novjp"
                return flat_out
            lost = [p.name for p in reads.parameters if p.trainable and all(p is not s for s in swapped)]
            if lost:
                raise TraceError(
                    f"jit: {self._name} reads trainable Parameters that are not among its arguments "
                    f"({', '.join(lost)}) while its loss is differentiated: their gradients would be lost. "
                    "Pass their module as an argument, or call it under torch.no_grad()")
            wrt = [i for i, f in enumerate(fakes) if f.requires_grad]
            grads = torch.autograd.grad(tensors[diff[0]], [fakes[i] for i in wrt], allow_unused=True)
            record["mode"], record["diff"] = "fused", diff[0]
            record["grad_of"] = tuple(i for i, g in zip(wrt, grads) if g is not None)
            return flat_out + [g for g in grads if g is not None]

        entry.gm = trace(body, inputs, self._name)
        self.trace_count += 1
        entry.spec, entry.mode, entry.diff, entry.grad_of, entry.readouts = (
            record["spec"], record["mode"], record["diff"], record["grad_of"], record["readouts"])
        output = next(n for n in entry.gm.graph.nodes if n.op == "output")
        entry.n_out = len(output.args[0]) - len(entry.grad_of)
        return entry

    def _replay(self, entry: _Entry, inputs: Sequence[torch.Tensor], flat: _Flat) -> Any:
        inputs = [*inputs, *draws(entry.gm.draw_specs)]
        if entry.mode == "fused":
            outs = _FusedReplay.apply(entry, *inputs)
        elif entry.mode == "novjp":
            outs = _NoVJPReplay.apply(entry, *inputs)
        else:
            with torch.no_grad():
                outs = entry.gm(*inputs)
        it = iter(outs)
        result = _unflatten_out(entry.spec, it)
        for (where, name), value in zip(entry.readouts, it):
            setattr(flat.modules[where] if isinstance(where, int) else where, name, value)
        return result
