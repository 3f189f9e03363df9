"""Scipy optimizer wrapper (counterpart of ``gpflow_tpu/optimizers/scipy.py``).

The trainable Parameters' unconstrained values are packed into one flat
float64 vector for ``scipy.optimize.minimize`` (L-BFGS-B by default), and the
optimum is unpacked back into them. Each evaluation crosses between host and
device once each way: one upload of the flat vector, copied into every
parameter's unconstrained tensor under ``no_grad``, and one download of
``cat([loss, flat gradient])``. The gradient comes from
``torch.autograd.grad``; there is nothing to compile, so ``compile`` is
accepted for the JAX package's signature and the loss runs eagerly.

A variable that no gradient reaches (autograd returns None for it, as for a
variable read only through ``.detach()``) raises, unless
``allow_unused_variables`` is set.

``step_callback`` is called once per iteration, after the iterate has been
assigned to the variables: a ``monitor.Monitor`` with the step alone, any
other callable with the step, the variables and their unconstrained values.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.optimize
import torch

from ..base import Parameter
from ..bijectors import TriangularMask
from ..monitor.base import Monitor

__all__ = ["Scipy"]


class _ParameterCodec:
    """The flat layouts of a list of parameters' unconstrained values
    (``gpflow_tpu/optimizers/scipy.py:38-182``).

    * The PACKED layout is what scipy sees: a parameter with a TriangularMask
      transform contributes only the n(n+1)/2 lower-triangle entries of each
      matrix, so L-BFGS never carries the always-zero upper triangle.
    * The FULL layout is what the device sees: every parameter's row-major
      flattening.

    Packing and unpacking are index shuffles on the host in numpy."""

    def __init__(self, variables: Sequence[Parameter]) -> None:
        self._init_from_specs(
            [tuple(v.shape) for v in variables],
            [isinstance(v.transform, TriangularMask) for v in variables],
        )

    @classmethod
    def from_specs(cls, shapes: Sequence[Tuple[int, ...]], tril: Sequence[bool]) -> "_ParameterCodec":
        codec = cls.__new__(cls)
        codec._init_from_specs(list(shapes), list(tril))
        return codec

    def _init_from_specs(self, shapes: list, tril: list) -> None:
        self.shapes = shapes
        self.tril = tril
        self.sizes = []  # packed entry counts (scipy's layout)
        self.full_sizes = []  # row-major entry counts (the device's layout)
        self._pack_idx: dict = {}  # n -> indices of the lower triangle in a flattened [n, n]
        for shape, tri in zip(self.shapes, self.tril):
            full = int(np.prod(shape)) if shape else 1
            self.full_sizes.append(full)
            if tri:
                n = shape[-1]
                batch = int(np.prod(shape[:-2])) if shape[:-2] else 1
                self.sizes.append(batch * n * (n + 1) // 2)
                if n not in self._pack_idx:
                    rows, cols = np.tril_indices(n)
                    self._pack_idx[n] = rows * n + cols
            else:
                self.sizes.append(full)
        self.has_tril = any(self.tril)

    def unpack(self, x: np.ndarray) -> np.ndarray:
        """Packed -> full layout, zeros in the strict upper triangles."""
        if not self.has_tril:
            return x
        out = np.zeros(sum(self.full_sizes), dtype=x.dtype)
        i = j = 0
        for shape, tri, size, full_size in zip(self.shapes, self.tril, self.sizes, self.full_sizes):
            chunk = x[i:i + size]
            i += size
            if tri:
                n = shape[-1]
                dest = out[j:j + full_size].reshape(-1, n * n)
                dest[:, self._pack_idx[n]] = chunk.reshape(dest.shape[0], -1)
            else:
                out[j:j + full_size] = chunk
            j += full_size
        return out

    def pack(self, x_full: np.ndarray) -> np.ndarray:
        """Full -> packed layout, dropping the strict upper triangles."""
        if not self.has_tril:
            return x_full
        out = np.empty(sum(self.sizes), dtype=x_full.dtype)
        i = j = 0
        for shape, tri, size, full_size in zip(self.shapes, self.tril, self.sizes, self.full_sizes):
            chunk = x_full[j:j + full_size]
            j += full_size
            if tri:
                n = shape[-1]
                out[i:i + size] = chunk.reshape(-1, n * n)[:, self._pack_idx[n]].reshape(-1)
            else:
                out[i:i + size] = chunk
            i += size
        return out

    def encode(self, arrays: Sequence[np.ndarray]) -> np.ndarray:
        """Arrays shaped like the parameters -> the packed float64 vector."""
        if not arrays:
            return np.zeros((0,), dtype=np.float64)
        return self.pack(np.concatenate([np.asarray(a, dtype=np.float64).reshape(-1) for a in arrays]))

    def decode_torch(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The FULL-layout tensor -> views shaped like the parameters (the
        counterpart of the JAX package's ``decode_jax``)."""
        out, i = [], 0
        for shape, size in zip(self.shapes, self.full_sizes):
            out.append(x[i:i + size].view(shape))
            i += size
        return out

    def encode_torch(self, tensors: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
        """Tensors shaped like the parameters -> one FULL-layout tensor of
        ``dtype``, so that the gradient is one download (the counterpart of
        ``encode_jax``)."""
        if not tensors:
            return torch.zeros((0,), dtype=dtype)
        return torch.cat([t.to(dtype).reshape(-1) for t in tensors])

    def decode(self, x: np.ndarray) -> List[np.ndarray]:
        """The packed vector -> float64 arrays shaped like the parameters."""
        x_full = self.unpack(np.asarray(x, dtype=np.float64))
        out, j = [], 0
        for shape, full_size in zip(self.shapes, self.full_sizes):
            out.append(x_full[j:j + full_size].reshape(shape))
            j += full_size
        return out


LossClosure = Callable[[], torch.Tensor]
StepCallback = Union[Monitor, Callable[[int, Sequence[Parameter], Sequence[np.ndarray]], None]]


class Scipy:
    def __init__(self, compile_cache_size: int = 2) -> None:
        """:param compile_cache_size: number of loss-and-gradient functions,
        with their unused-variable analysis, kept across ``minimize`` calls
        (``gpflow_tpu/optimizers/scipy.py:224-246``). A repeat call with the
        same ``closure`` (bound methods compare equal), the same Parameter
        objects and the same ``compile`` reuses them. 0 disables caching."""
        if compile_cache_size < 0:
            raise ValueError(
                f"The 'compile_cache_size' argument must be non-negative, got {compile_cache_size}."
            )
        self.compile_cache: "OrderedDict[Tuple[Any, ...], Tuple[Callable[..., Any], List[Optional[List[int]]]]]" = (
            OrderedDict()
        )
        self.compile_cache_size = compile_cache_size

    def __getstate__(self) -> dict:
        # the cached functions hold the closures, which need not pickle
        state = self.__dict__.copy()
        state["compile_cache"] = OrderedDict()
        return state

    def minimize(
        self,
        closure: LossClosure,
        variables: Sequence[Parameter],
        method: str = "L-BFGS-B",
        step_callback: Optional[StepCallback] = None,
        compile: bool = True,
        allow_unused_variables: bool = False,
        track_loss_history: bool = False,
        nonfinite_penalty: Optional[float] = None,
        **scipy_kwargs: Any,
    ) -> "scipy.optimize.OptimizeResult":
        """Minimizes ``closure()`` with respect to ``variables``.

        :param closure: () -> scalar loss tensor that reads the current values
            of ``variables`` (e.g. ``model.training_loss``).
        :param variables: Parameters to optimize (``model.trainable_variables``).
        :param method: scipy method, default "L-BFGS-B".
        :param step_callback: called once per optimizer iteration as
            ``(step, variables, values)``, where ``values`` are the current
            unconstrained arrays, after they were assigned to ``variables``;
            a ``monitor.Monitor`` is called with the step alone.
        :param compile: accepted for the JAX package's signature; the loss
            runs eagerly either way.
        :param allow_unused_variables: warn instead of raising where no
            gradient reaches a variable.
        :param track_loss_history: record the loss at each iteration in
            ``result.loss_history`` (one more evaluation per iteration).
        :param nonfinite_penalty: if set (e.g. ``1e15``), an evaluation whose
            loss or gradient is non-finite returns this value, raised to 10x
            the largest finite |loss| seen, with a zero gradient: the line
            search rejects the trial point and backtracks, where L-BFGS-B
            would otherwise stop at the first NaN (a float32 trial step can
            round a Gram matrix indefinite). A non-finite first evaluation
            still raises FloatingPointError. The count of such evaluations is
            ``result.n_nonfinite_evals``; where scipy ends above the best
            finite point evaluated, that point, its loss and its gradient are
            restored into ``result.x``, ``result.fun`` and ``result.jac``.
        :param scipy_kwargs: passed to ``scipy.optimize.minimize`` (e.g.
            ``options={"maxiter": 1000}``).
        """
        if not callable(closure):
            raise TypeError("The 'closure' argument is expected to be a callable object.")
        variables = tuple(variables)
        if not all(isinstance(v, Parameter) for v in variables):
            raise TypeError("The 'variables' argument is expected to only contain Parameters.")

        codec = _ParameterCodec(variables)
        initial_params = self.initial_parameters(variables)
        func = self.eval_func(
            closure, variables, codec, compile=compile, allow_unused_variables=allow_unused_variables
        )

        n_nonfinite = [0]
        if nonfinite_penalty is not None:
            inner_func = func
            seen_finite = [False]
            max_abs_loss = [0.0]
            best_finite: list = [None]  # (loss, x, grad) of the best finite evaluation

            def func(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
                loss, grad = inner_func(x)
                if not (np.isfinite(loss) and np.all(np.isfinite(grad))):
                    if not seen_finite[0]:
                        # The guard is for line-search trial points: a
                        # non-finite start is a broken model, and a penalty
                        # with a zero gradient there would read as instant
                        # convergence at unusable parameters.
                        raise FloatingPointError(
                            "Loss or gradient is non-finite at the initial parameters; "
                            "nonfinite_penalty only guards line-search trial points. Fix the "
                            "model or its initialization (jitter, noise floor, dtype) instead."
                        )
                    n_nonfinite[0] += 1
                    # Above every finite loss seen, or a NaN trial could pass
                    # both Wolfe tests and be accepted as the next iterate.
                    pen = max(float(nonfinite_penalty), 10.0 * max_abs_loss[0])
                    return np.asarray(pen, dtype=np.float64), np.zeros_like(grad)
                seen_finite[0] = True
                max_abs_loss[0] = max(max_abs_loss[0], abs(float(loss)))
                if best_finite[0] is None or float(loss) < best_finite[0][0]:
                    best_finite[0] = (float(loss), np.array(x, copy=True), np.array(grad, copy=True))
                return loss, grad

        if step_callback is not None:
            if "callback" in scipy_kwargs:
                raise ValueError("Callback passed both via `step_callback` and `callback`")
            scipy_kwargs["callback"] = self.callback_func(variables, step_callback, codec)
        history: List[np.ndarray] = []
        if track_loss_history:
            scipy_kwargs["callback"] = self.loss_history_callback_func(func, history, scipy_kwargs.get("callback"))

        result = scipy.optimize.minimize(func, initial_params, jac=True, method=method, **scipy_kwargs)

        if track_loss_history:
            result["loss_history"] = history
        if nonfinite_penalty is not None:
            result["n_nonfinite_evals"] = n_nonfinite[0]
            # An abnormal line-search exit can leave scipy on a penalized
            # iterate inside the non-finite region: restore the best finite
            # point evaluated, with its own gradient.
            if best_finite[0] is not None and (not np.isfinite(result.fun) or result.fun > best_finite[0][0]):
                result["fun"], result["x"], result["jac"] = best_finite[0]
        self.assign_tensors(variables, codec.decode(np.asarray(result.x)))
        return result

    def initial_parameters(self, variables: Sequence[Parameter]) -> np.ndarray:
        """The packed float64 vector of the variables' unconstrained values."""
        return _ParameterCodec(variables).encode([_unconstrained_numpy(v) for v in variables])

    def eval_func(
        self,
        closure: LossClosure,
        variables: Sequence[Parameter],
        codec: Optional[_ParameterCodec] = None,
        compile: bool = True,
        allow_unused_variables: bool = False,
    ) -> Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]:
        """The function scipy calls: the packed float64 vector -> (loss,
        packed gradient), both float64 on the host. Its first evaluation
        checks that a gradient reaches every variable."""
        if codec is None:
            codec = _ParameterCodec(variables)
        variables = tuple(variables)

        cache_key: Optional[Tuple[Any, ...]]
        try:
            cache_key = (closure, tuple(id(v) for v in variables), compile)
            hit = self.compile_cache.get(cache_key)
        except TypeError:  # an unhashable closure is not cached
            cache_key, hit = None, None

        if hit is not None:
            self.compile_cache.move_to_end(cache_key)
            flat_value_and_grad, unused = hit
        else:
            tensors = [v.unconstrained for v in variables]
            unused = [None]  # filled by the first evaluation: indices no gradient reaches

            def flat_value_and_grad(x_full: np.ndarray) -> np.ndarray:
                """[loss, flat gradient] in the full layout, float64 on the
                host: one upload and one download."""
                x_dev = torch.from_numpy(x_full).to(tensors[0].device)
                requires = [t.requires_grad for t in tensors]
                try:
                    with torch.no_grad():
                        for t, value in zip(tensors, codec.decode_torch(x_dev)):
                            t.copy_(value)
                    for t in tensors:
                        t.requires_grad_(True)
                    loss = closure()
                    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
                finally:
                    for t, flag in zip(tensors, requires):
                        t.requires_grad_(flag)
                if unused[0] is None:
                    unused[0] = [i for i, g in enumerate(grads) if g is None]
                grads = [torch.zeros_like(t) if g is None else g for t, g in zip(tensors, grads)]
                return codec.encode_torch([loss.detach(), *grads], torch.float64).cpu().numpy()

            if cache_key is not None and self.compile_cache_size > 0:
                while len(self.compile_cache) >= self.compile_cache_size:
                    self.compile_cache.popitem(last=False)  # evict the oldest
                self.compile_cache[cache_key] = (flat_value_and_grad, unused)

        checked = [False]

        def _eval(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
            out = flat_value_and_grad(codec.unpack(np.asarray(x, dtype=np.float64)))
            if not checked[0]:
                checked[0] = True
                _check_unused(variables, unused[0], allow_unused_variables)
            return np.asarray(out[0], dtype=np.float64), codec.pack(out[1:])

        return _eval

    @staticmethod
    def callback_func(
        variables: Sequence[Parameter],
        step_callback: StepCallback,
        codec: Optional[_ParameterCodec] = None,
    ) -> Callable[..., None]:
        """Adapts ``step_callback`` to scipy's per-iteration ``callback``:
        counts iterations, assigns the current iterate to ``variables`` and
        calls a ``Monitor`` with the step alone (``gpflow_tpu/optimizers/scipy.py:483-512``)."""
        if codec is None:
            codec = _ParameterCodec(variables)
        step = [0]

        def _callback(x: Any, *_args: Any) -> None:
            decoded = codec.decode(np.asarray(getattr(x, "x", x)))  # scipy may pass an OptimizeResult
            Scipy.assign_tensors(variables, decoded)
            if isinstance(step_callback, Monitor):
                step_callback(step[0])
            else:
                step_callback(step[0], variables, decoded)
            step[0] += 1

        return _callback

    @staticmethod
    def loss_history_callback_func(
        minimize_func: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
        history: List[np.ndarray],
        callback: Optional[Callable[..., None]] = None,
    ) -> Callable[..., None]:
        """Records the loss at each iteration (one more evaluation), after an
        existing callback."""

        def _callback(x: Any, *args: Any) -> None:
            if callback is not None:
                callback(x, *args)  # some methods (trust-constr) pass (xk, state)
            history.append(minimize_func(np.asarray(getattr(x, "x", x)))[0])

        return _callback

    @staticmethod
    def pack_tensors(tensors: Sequence[Any]) -> np.ndarray:
        """Concatenation of flattened arrays in ``minimize``'s layout:
        Parameters give their unconstrained values, TriangularMask ones only
        their lower triangles, so ``unpack_tensors(variables, result.x)``
        round-trips."""
        pairs = [_unconstrained_and_tril(t) for t in tensors]
        codec = _ParameterCodec.from_specs([a.shape for a, _ in pairs], [tri for _, tri in pairs])
        return codec.encode([a for a, _ in pairs])

    @staticmethod
    def unpack_tensors(to_tensors: Sequence[Any], from_vector: Any) -> List[np.ndarray]:
        """Splits a flat vector in ``pack_tensors`` layout back into arrays
        shaped like ``to_tensors``, with zero upper triangles for the packed
        ones."""
        pairs = [_unconstrained_and_tril(t) for t in to_tensors]
        codec = _ParameterCodec.from_specs([a.shape for a, _ in pairs], [tri for _, tri in pairs])
        return [d.astype(a.dtype) for d, (a, _) in zip(codec.decode(np.asarray(from_vector)), pairs)]

    @staticmethod
    def assign_tensors(to_tensors: Sequence[Parameter], values: Sequence[Any]) -> None:
        """Assigns each value to the matching Parameter's unconstrained tensor."""
        if len(to_tensors) != len(values):
            raise ValueError("to_tensors and values should have same length")
        for target, value in zip(to_tensors, values):
            target._set_unconstrained(torch.as_tensor(np.asarray(value)))


def _unconstrained_numpy(p: Parameter) -> np.ndarray:
    return p.unconstrained.detach().cpu().numpy()


def _unconstrained_and_tril(t: Any) -> Tuple[np.ndarray, bool]:
    if isinstance(t, Parameter):
        return _unconstrained_numpy(t), isinstance(t.transform, TriangularMask)
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy(), False
    return np.asarray(t), False


def _check_unused(variables: Sequence[Parameter], unused: List[int], allow: bool) -> None:
    """Raises (or, where allowed, warns) naming the variables no gradient reaches."""
    if not unused:
        return
    names = [variables[i].name for i in unused]
    if allow:
        warnings.warn(f"Some variables do not affect the loss and will keep zero gradients: {names}")
    else:
        raise ValueError(
            f"Some variables do not affect the loss: {names}. Their gradients would silently "
            "stay zero under L-BFGS; pass allow_unused_variables=True to proceed anyway."
        )
