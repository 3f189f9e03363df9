"""Lightweight runtime shape contracts (counterpart of
``gpflow_tpu/utilities/shapes.py``, a copy of that pure-Python module with
the port's own environment switch).

Disabled by default (one flag check per decorated call); enable in tests or
debugging with ``set_enable_check_shapes(True)`` or, before the import,
``GPFLOW_TPU_TORCH_CHECK_SHAPES=1`` (where that is unset, the JAX package's
``GPFLOW_TPU_CHECK_SHAPES`` decides). A check reads ``.shape`` only, never a
value, so it never synchronises the host with a CUDA device.

Spec syntax (subset of the reference package's):

    @check_shapes(
        "X: [batch..., N, D]",
        "X2: [batch2..., N2, D]",
        "return: [batch..., N, batch2..., N2]",
    )
    def K(X, X2): ...

* uppercase/lowercase names bind dimensions consistently across arguments
* ``name...`` matches zero or more leading dims (at most one per spec)
* integer literals match exactly; ``.`` matches any single dim
* ``None``-valued arguments are skipped
* a spec may be guarded on a condition over arguments: ``"Knn: [batch..., N,
  N] if full_cov"``, ``"return: [batch..., N, N] if full_cov and (X2 is
  None)"``, ``"return: [batch..., N] if not full_cov"`` — the guard grammar
  is ``and``/``or``/``not``/parentheses over atoms ``<arg>`` (truthiness),
  ``<arg> is None`` and ``<arg> is not None``; a guard reads Python
  arguments only
* a spec may list rank alternatives separated by ``|``, as in
  ``"q_sqrt: [M, R] | [R, M, M]"``: the first alternative that matches
  commits its dimension bindings

Shapes come from ``register_get_shape`` extractors, else from ``.shape``
(``torch.Tensor``, the port's ``Parameter``, numpy arrays, inducing
variables); Python ints and floats are scalars. A symbolic size (a
``torch.SymInt`` while ``torch.export`` traces) is bound as it is.
"""
from __future__ import annotations

import functools
import inspect
import os
import re
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple, TypeVar

import torch

__all__ = [
    "ShapeError",
    "check_shape",
    "check_shapes",
    "get_enable_check_shapes",
    "inherit_check_shapes",
    "register_get_shape",
    "set_enable_check_shapes",
]

F = TypeVar("F", bound=Callable[..., Any])

def _env_enabled(value: str) -> bool:
    """Truthiness of a switch's environment value: "0", "", "false", "no"
    and "off" (any case) turn the checks off."""
    return value.lower() not in ("0", "", "false", "no", "off")


# GPFLOW_TPU_TORCH_CHECK_SHAPES, else the JAX package's GPFLOW_TPU_CHECK_SHAPES
_state = {"enabled": _env_enabled(os.environ.get(
    "GPFLOW_TPU_TORCH_CHECK_SHAPES", os.environ.get("GPFLOW_TPU_CHECK_SHAPES", "0")))}


class ShapeError(ValueError):
    pass


def set_enable_check_shapes(value: bool) -> None:
    _state["enabled"] = bool(value)


def get_enable_check_shapes() -> bool:
    return _state["enabled"]


Guard = Tuple[FrozenSet[str], Callable[[Dict[str, Any]], bool]]


def _compile_guard(guard: str) -> Guard:
    """Compiles a guard like ``full_cov and (X2 is None)`` into (referenced
    argument names, predicate over the bound-arguments dict). Tiny recursive-
    descent parser — no ``eval``, and array-valued arguments are only ever
    tested with ``is [not] None``, never for truthiness."""
    tokens = re.findall(r"\(|\)|[A-Za-z_][A-Za-z_0-9]*", guard)
    if "".join(re.findall(r"[^\s()A-Za-z_0-9]", guard)):
        raise ValueError(f"Bad characters in shape-spec guard {guard!r}")
    names: set = set()
    pos = [0]

    def peek() -> Optional[str]:
        return tokens[pos[0]] if pos[0] < len(tokens) else None

    def advance() -> str:
        if pos[0] >= len(tokens):
            raise ValueError(f"Truncated shape-spec guard {guard!r}")
        t = tokens[pos[0]]
        pos[0] += 1
        return t

    def parse_or() -> Callable[[Dict[str, Any]], bool]:
        node = parse_and()
        while peek() == "or":
            advance()
            lhs, rhs = node, parse_and()
            node = lambda a, lhs=lhs, rhs=rhs: lhs(a) or rhs(a)
        return node

    def parse_and() -> Callable[[Dict[str, Any]], bool]:
        node = parse_unary()
        while peek() == "and":
            advance()
            lhs, rhs = node, parse_unary()
            node = lambda a, lhs=lhs, rhs=rhs: lhs(a) and rhs(a)
        return node

    def parse_unary() -> Callable[[Dict[str, Any]], bool]:
        t = peek()
        if t == "not":
            advance()
            inner = parse_unary()
            return lambda a, inner=inner: not inner(a)
        if t == "(":
            advance()
            inner = parse_or()
            if peek() != ")":
                raise ValueError(f"Unbalanced parens in guard {guard!r}")
            advance()
            return inner
        return parse_atom()

    def parse_atom() -> Callable[[Dict[str, Any]], bool]:
        name = peek()
        if name is None or name in ("and", "or", "not", "is", "None", ")", "("):
            raise ValueError(f"Bad shape-spec guard {guard!r}")
        advance()
        names.add(name)
        if peek() == "is":
            advance()
            negate = False
            if peek() == "not":
                advance()
                negate = True
            if advance() != "None":
                raise ValueError(f"Only `is [not] None` comparisons allowed: {guard!r}")
            if negate:
                return lambda a, name=name: a.get(name) is not None
            return lambda a, name=name: a.get(name) is None
        # bare name: truthiness of a (boolean) flag argument
        return lambda a, name=name: bool(a.get(name))

    fn = parse_or()
    if pos[0] != len(tokens):
        raise ValueError(f"Trailing tokens in shape-spec guard {guard!r}")
    return frozenset(names), fn


def _parse_spec(spec: str) -> Tuple[str, List[List[str]], Optional[Guard]]:
    name, _, dims = spec.partition(":")
    dims = dims.strip()
    cond: Optional[Guard] = None
    if "]" in dims and not dims.endswith("]"):
        dims, _, guard = dims.rpartition("]")
        dims += "]"
        guard = guard.strip()
        if not guard.startswith("if "):
            raise ValueError(f"Bad shape-spec guard {guard!r} in {spec!r}")
        cond = _compile_guard(guard[len("if ") :])
    alternatives: List[List[str]] = []
    for alt in dims.split("|"):
        alt = alt.strip()
        if not (alt.startswith("[") and alt.endswith("]")):
            raise ValueError(f"Bad shape spec {spec!r}")
        inner = alt[1:-1].strip()
        alternatives.append([t.strip() for t in inner.split(",")] if inner else [])
    return name.strip(), alternatives, cond


def _match_alternatives(
    alternatives: Sequence[Sequence[str]],
    shape: Tuple[int, ...],
    bindings: Dict[str, Any],
    where: str,
) -> None:
    """Matches ``shape`` against one of several alternative token lists
    (spec syntax ``arg: [M, R] | [R, M, M]``, the analog of the reference
    package's compound specs like ``q_sqrt: [M_R_or_R_M_M...]``). The first
    alternative that matches commits its bindings; if none match, the first
    alternative's error is raised."""
    if len(alternatives) == 1:
        _match(alternatives[0], shape, bindings, where)
        return
    first_error: Optional[ShapeError] = None
    for tokens in alternatives:
        trial = dict(bindings)
        try:
            _match(tokens, shape, trial, where)
        except ShapeError as e:
            if first_error is None:
                first_error = e
            continue
        bindings.clear()
        bindings.update(trial)
        return
    assert first_error is not None
    raise ShapeError(
        f"{where}: shape {shape} matches none of the alternatives "
        f"{[list(a) for a in alternatives]} ({first_error})"
    )


def _match(
    tokens: Sequence[str], shape: Tuple[int, ...], bindings: Dict[str, Any], where: str
) -> None:
    ell = [i for i, t in enumerate(tokens) if t.endswith("...")]
    if len(ell) > 1:
        # multiple variadic groups are only checkable when all are already
        # bound (e.g. a return spec [batch..., N, batch2..., N2]) — expand
        # them in place and re-match
        expanded: List[str] = []
        for t in tokens:
            if t.endswith("..."):
                bound = bindings.get(t)
                if bound is None:
                    return  # unbound multi-variadic: skip (can't disambiguate)
                expanded.extend(str(d) for d in bound)
            else:
                expanded.append(t)
        _match(expanded, shape, bindings, where)
        return
    if ell:
        i = ell[0]
        head, tail = list(tokens[:i]), list(tokens[i + 1 :])
        n_var = len(shape) - len(head) - len(tail)
        # broadcast rank leniency (numpy align-right): a value may have lower
        # rank than its spec when the leftmost missing entries are
        # broadcast-marked, e.g. a scalar variance against
        # ``[broadcast batch..., broadcast N]`` (reference model_utils.py:30)
        while n_var < 0 and head and head[0].startswith("broadcast "):
            head.pop(0)
            n_var += 1
        while n_var < 0 and tail and tail[0].startswith("broadcast "):
            tail.pop(0)
            n_var += 1
        if n_var < 0:
            raise ShapeError(
                f"{where}: shape {shape} has fewer dims than spec {list(tokens)}"
            )
        var_name = tokens[i][:-3]
        # align-right leniency when the variadic group is already bound: a
        # value may omit leading broadcast-marked dims entirely, e.g. a
        # single-func _mc_quadrature result [batch..., d'] against
        # ``[broadcast n_funcs, batch..., .]`` (reference base.py:569-574)
        if var_name and not var_name.startswith("broadcast "):
            prev_var = bindings.get(var_name + "...")
            while (
                prev_var is not None
                and n_var < len(prev_var)
                and head
                and head[0].startswith("broadcast ")
            ):
                head.pop(0)
                n_var += 1
        var_dims = tuple(shape[len(head) : len(head) + n_var])
        if var_name.startswith("broadcast "):
            pass  # broadcastable variadic group: consume dims, don't pin
        elif var_name:
            prev = bindings.get(var_name + "...")
            if prev is not None and prev != var_dims:
                raise ShapeError(
                    f"{where}: variadic dims {var_name!r} = {var_dims} inconsistent "
                    f"with previous binding {prev}"
                )
            bindings[var_name + "..."] = var_dims
        fixed = list(zip(head, shape[: len(head)])) + list(zip(tail, shape[len(shape) - len(tail):]))
    else:
        tokens = list(tokens)
        while len(tokens) > len(shape) and tokens[0].startswith("broadcast "):
            tokens.pop(0)  # broadcast rank leniency (see variadic branch)
        if len(tokens) != len(shape):
            raise ShapeError(
                f"{where}: expected rank {len(tokens)} ({list(tokens)}), got shape {shape}"
            )
        fixed = list(zip(tokens, shape))

    for token, dim in fixed:
        if token in (".", "*"):
            continue
        if token.startswith("broadcast "):
            continue  # broadcastable dims are not pinned
        if token.isdigit():
            if int(token) != dim:
                raise ShapeError(f"{where}: expected dim {token}, got {dim} in shape {shape}")
            continue
        prev = bindings.get(token)
        if prev is None:
            bindings[token] = dim
        elif prev != dim:
            raise ShapeError(
                f"{where}: dim {token!r} = {dim} inconsistent with previous binding {prev} "
                f"(shape {shape})"
            )


_SELECTOR_RE = re.compile(r"^(?P<base>\w+)(?P<selectors>(\[(all|\d+)\]|\.values\(\))*)$")


def _split_multi(name: str) -> Tuple[str, Callable[[Any], Any]]:
    """Resolves the reference package's multi-value argument selectors:
    ``xs[all]`` checks every element of a sequence argument, ``Ys.values()``
    every value of a dict argument, ``data[0]`` one indexed element, and the
    selectors compose — ``var_list[all][0]`` checks element 0 of every tuple
    in a sequence (used e.g. at reference ``quadrature/gauss_hermite.py:49``,
    ``deprecated.py:132`` and ``optimizers/natgrad.py:209-212``)."""
    m = _SELECTOR_RE.match(name)
    if m is None or not m.group("selectors"):
        return name, lambda v: [v]
    selectors = re.findall(r"\[(?:all|\d+)\]|\.values\(\)", m.group("selectors"))

    def extract(v: Any) -> List[Any]:
        values = [v]
        for sel in selectors:
            try:
                if sel == "[all]":
                    # require __len__ so a one-shot iterator is never consumed
                    values = [
                        item
                        for seq in values
                        if seq is not None and hasattr(seq, "__len__")
                        for item in seq
                    ]
                elif sel == ".values()":
                    values = [item for d in values if d is not None for item in d.values()]
                else:
                    idx = int(sel[1:-1])
                    values = [seq[idx] for seq in values if seq is not None]
            except (TypeError, IndexError, KeyError, AttributeError):
                return []  # not selectable (e.g. an iterator of batches): skip
        return values

    return m.group("base"), extract


_get_shape_registry: Dict[type, Callable[[Any], Any]] = {}


def register_get_shape(tp: type) -> Callable[[Callable[[Any], Any]], Callable[[Any], Any]]:
    """Registers a custom shape extractor for instances of ``tp`` (the
    analog of the reference package's ``register_get_shape``, used e.g. at
    reference ``posteriors.py:172`` and ``probability_distributions.py:45``).
    The decorated function takes the value and returns its shape tuple
    (entries may be ``None`` for unknown dims, which skips the check)."""

    def decorator(fn: Callable[[Any], Any]) -> Callable[[Any], Any]:
        _get_shape_registry[tp] = fn
        return fn

    return decorator


def _dim(s: Any) -> Any:
    """A size as an int; a symbolic size as it is, since ``int`` would pin
    it to the traced example's value."""
    return s if isinstance(s, torch.SymInt) else int(s)


def _shape_of(value: Any) -> Optional[Tuple[int, ...]]:
    if isinstance(value, bool):
        return None  # flags are not shaped values
    if isinstance(value, (int, float)):
        return ()  # Python scalars satisfy scalar specs like "return: []"
    for tp, fn in _get_shape_registry.items():
        if isinstance(value, tp):
            shape = fn(value)
            if shape is None or any(s is None for s in shape):
                return None
            return tuple(_dim(s) for s in shape)
    shape = getattr(value, "shape", None)
    if shape is None:
        return None
    try:
        return tuple(_dim(s) for s in shape)
    except Exception:  # abstract/symbolic dims (incl. shape-polymorphic
        return None  # export dims, which raise InconclusiveDimensionOperation)


def check_shape(value: Any, spec: str, where: str = "value") -> Any:
    """Inline single-value check: ``check_shape(x, "[N, D]")``."""
    if not _state["enabled"]:
        return value
    tokens = [t.strip() for t in spec.strip()[1:-1].split(",")] if spec.strip() != "[]" else []
    shape = _shape_of(value)
    if shape is not None:
        _match(tokens, shape, {}, where)
    return value


def check_shapes(*specs: str) -> Callable[[F], F]:
    """Decorator enforcing the shape contracts in ``specs`` (see module doc)."""
    parsed = [_parse_spec(s) for s in specs]
    arg_specs = [(n, t, c) for n, t, c in parsed if not n.startswith("return")]
    ret_specs = [(n, t, c) for n, t, c in parsed if n.startswith("return")]

    def decorator(fn: F) -> F:
        sig = inspect.signature(fn)
        # a typo'd guard argument would otherwise read as always-falsy and
        # silently flip which spec applies — fail at decoration instead
        for _name, _tokens, cond in parsed:
            if cond is not None:
                unknown = cond[0] - set(sig.parameters)
                if unknown:
                    raise ValueError(
                        f"check_shapes guard references unknown argument(s) "
                        f"{sorted(unknown)} of {fn.__qualname__} "
                        f"(known: {list(sig.parameters)})"
                    )

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if not _state["enabled"]:
                return fn(*args, **kwargs)
            try:
                bound = sig.bind_partial(*args, **kwargs)
            except TypeError:
                return fn(*args, **kwargs)
            bound.apply_defaults()

            def active(cond: Optional[Guard]) -> bool:
                if cond is None:
                    return True
                return cond[1](bound.arguments)

            bindings: Dict[str, Any] = {}
            for name, tokens, cond in arg_specs:
                base, elements = _split_multi(name)
                if base not in bound.arguments or not active(cond):
                    continue
                value = bound.arguments[base]
                if value is None:
                    continue
                for i, item in enumerate(elements(value)):
                    if item is None:
                        continue
                    shape = _shape_of(item)
                    if shape is not None:
                        where = f"{fn.__qualname__} argument {name!r}"
                        if name != base:
                            where += f" element {i}"
                        _match_alternatives(tokens, shape, bindings, where)
            result = fn(*args, **kwargs)
            for name, tokens, cond in ret_specs:
                if not active(cond):
                    continue
                if name == "return[all]":
                    values = list(result)
                elif name.startswith("return["):
                    values = [result[int(name[len("return[") : -1])]]
                elif name.startswith("return."):
                    # attribute selector on a NamedTuple/dataclass return,
                    # e.g. "return.sigma_sq: [N]" (reference sgpr.py:173-179)
                    values = [getattr(result, name[len("return.") :])]
                else:
                    values = [result]
                for value in values:
                    if value is None:
                        continue
                    shape = _shape_of(value)
                    if shape is not None:
                        _match_alternatives(tokens, shape, bindings, f"{fn.__qualname__} {name}")
            return result

        wrapper.__check_shapes__ = specs  # type: ignore[attr-defined]
        return wrapper  # type: ignore[return-value]

    return decorator


def inherit_check_shapes(fn: F) -> F:
    """Marker for methods inheriting the base method's contract (resolved
    through the MRO when checking is enabled, then cached per class)."""
    cache: Dict[type, Callable[..., Any]] = {}

    @functools.wraps(fn)
    def wrapper(self: Any, *args: Any, **kwargs: Any) -> Any:
        if not _state["enabled"]:
            return fn(self, *args, **kwargs)
        cls = type(self)
        checked = cache.get(cls)
        if checked is None:
            checked = fn
            for base in cls.__mro__[1:]:
                parent = getattr(base, fn.__name__, None)
                specs = getattr(parent, "__check_shapes__", None)
                if specs is not None:
                    checked = check_shapes(*specs)(fn)
                    break
            cache[cls] = checked
        return checked(self, *args, **kwargs)

    wrapper.__inherits_check_shapes__ = True  # type: ignore[attr-defined]
    return wrapper  # type: ignore[return-value]
