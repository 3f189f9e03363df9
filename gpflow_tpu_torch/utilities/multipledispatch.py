"""Multiple dispatch on argument types, ported from
``gpflow_tpu/utilities/multipledispatch.py`` (pure Python); a call turns
numpy arguments into tensors first.

Resolution rule: among registered signatures whose types all match via
``isinstance``, pick the one with the smallest total MRO distance (most
specific). Ties broken by registration order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Type, Union

from ..base import numpy_to_tensors

__all__ = ["AnyCallable", "Dispatcher", "Types"]

# import-level parity with reference ``utilities/multipledispatch.py:24-26``
AnyCallable = Callable[..., Any]
Types = Union[Type[Any], Tuple[Type[Any], ...]]


def _mro_distance(obj_type: Type[Any], target: Type[Any]) -> Optional[int]:
    if not issubclass(obj_type, target):
        return None
    for i, base in enumerate(obj_type.__mro__):
        if base is target:
            return i
    # target reachable via issubclass but not in mro (e.g. ABC register) — coarse
    return len(obj_type.__mro__)


class Dispatcher:
    """A call takes numpy where the JAX package's takes any array: each
    numpy argument becomes a tensor before dispatch
    (``base.numpy_to_tensors``), so that no registered implementation
    converts again."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.funcs: Dict[Tuple[Type[Any], ...], Callable[..., Any]] = {}
        self._order: Dict[Tuple[Type[Any], ...], int] = {}
        self._cache: Dict[Tuple[Type[Any], ...], Callable[..., Any]] = {}

    def register(self, *types: Any) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
        def _decorator(fn: Callable[..., Any]) -> Callable[..., Any]:
            self.add(types, fn)
            return fn

        return _decorator

    def add(self, types: Tuple[Any, ...], fn: Callable[..., Any]) -> None:
        # a tuple in any position registers the cartesian product of signatures
        # (multipledispatch-package semantics, used heavily by expectations)
        import itertools

        expanded = [t if isinstance(t, tuple) else (t,) for t in types]
        for sig in itertools.product(*expanded):
            self.funcs[sig] = fn
            self._order[sig] = len(self._order)
        self._cache.clear()

    def registered_fn(self, *types: Type[Any]) -> Callable[..., Any]:
        """Returns the best implementation for the given argument *types*
        (mirrors ``Dispatcher.dispatch`` in the reference)."""
        key = tuple(types)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        best: Optional[Callable[..., Any]] = None
        best_score: Optional[Tuple[Any, ...]] = None
        for sig, fn in self.funcs.items():
            if len(sig) != len(types):
                continue
            dists = []
            ok = True
            for t, s in zip(types, sig):
                d = _mro_distance(t, s)
                if d is None:
                    ok = False
                    break
                dists.append(d)
            if not ok:
                continue
            # lexicographic left-to-right specificity (multipledispatch
            # semantics), registration order as the final tie-break
            score = (tuple(dists), self._order[sig])
            if best_score is None or score < best_score:
                best, best_score = fn, score
        if best is None:
            raise NotImplementedError(
                f"Could not find implementation of {self.name} for argument types "
                f"({', '.join(t.__name__ for t in types)}). Registered: "
                f"{[tuple(t.__name__ for t in sig) for sig in self.funcs]}"
            )
        self._cache[key] = best
        return best

    def dispatch(self, *types: Type[Any]) -> Optional[Callable[..., Any]]:
        try:
            return self.registered_fn(*types)
        except NotImplementedError:
            return None

    def dispatch_or_raise(self, *types: Type[Any]) -> Callable[..., Any]:
        return self.registered_fn(*types)

    def get_first_occurrence(self, *types: Type[Any]) -> Optional[Callable[..., Any]]:
        """First matching implementation by specificity order, or ``None``
        (reference ``multipledispatch.py:66-85``; there it walks the
        ``ordering`` list — here the same best-match lookup backs it, so
        both return the implementation ``__call__`` would pick)."""
        return self.dispatch(*types)

    @property
    def n_args(self) -> int:
        return len(next(iter(self.funcs))) if self.funcs else 0

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        # Signatures may have MIXED arities (multipledispatch-package
        # semantics): try each registered arity, longest first, so a
        # 3-type registration is reachable even when a 2-type signature
        # registered first (round-2 review: n_args came from whichever
        # signature happened to be first).
        args, kwargs = numpy_to_tensors(args, kwargs)
        arities = sorted({len(sig) for sig in self.funcs}, reverse=True)
        last_err: Optional[NotImplementedError] = None
        for n in arities:
            if n > len(args):
                continue
            types = tuple(type(a) for a in args[:n])
            try:
                fn = self.registered_fn(*types)
            except NotImplementedError as e:
                last_err = e
                continue
            return fn(*args, **kwargs)
        if last_err is not None:
            raise last_err
        raise NotImplementedError(
            f"{self.name}: no registered signature accepts {len(args)} arguments"
        )
