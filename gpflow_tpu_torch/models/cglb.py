"""CGLB: the conjugate-gradient lower bound on the GP marginal likelihood
(Artemev et al. 2021; counterpart of ``gpflow_tpu/models/cglb.py``).

The quadratic term is bounded through an auxiliary vector v [R, N] that a
preconditioned conjugate gradient (CG) moves towards (K + sigma^2 I)^-1 y.
The CG is one ``while_loop`` (``_compile.while_loop``, torch's operator, as
the JAX package's ``lax.while_loop``) whose restart is a ``cond``, so that
only the taken branch runs its K-matvec; it runs under ``torch.no_grad``
and returns a detached v, as the JAX package's loop under
``stop_gradient`` does. The same function runs eagerly and traced: eagerly
the host reads the stopping test 0.5 max(r^T Q^-1 r) once per iteration
(one synchronisation against one K-matvec of device work), and a replay of
a trace does the same inside the loop's node. The iteration counter lives
on the host (a CPU tensor), so the restart test reads nothing from the
device. ``CGLB.cg_iterations`` is the iteration count of the last CG run,
eager or replayed, a Python int read from that CPU tensor (a replay sets it
through ``_compile.readout``): reading it waits for nothing on the card.

In the matrix-free mode (``matrix_free_chunk``) no [N, N] matrix is formed:
every K-matvec builds K(X, X_chunk) one [N, chunk] block at a time (kernel
K1 on a CUDA device) and contracts it at once; under autograd each block is
checkpointed (``torch.utils.checkpoint``, as ``jax.checkpoint`` in the JAX
package), so the backward builds it again (K1 once more, and K2 for the
exponential and Matern kernels) instead of keeping it. The last chunk is
sliced short where the JAX package pads X with zero rows.

As in the JAX package, an eager evaluation of the objective with a
non-trainable v writes the CG's v back into ``aux_vec`` as the warm start of
the next one (on the device and under ``no_grad``, keeping the old v where
the new one is not finite); a traced one does not
(``gpflow_tpu/models/cglb.py:166``), so each of its replays starts the CG
from the same ``aux_vec``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from .. import _compile
from .._sharding import WHOLE, rows_of, share_blocks
from ..base import MeanAndVariance, Parameter, input_to_tensor
from ..config import default_device, default_float
from ..kernels import Kernel
from ..posteriors import sgpr_conditional
from ..utilities.model_utils import add_noise_cov, assert_params_false
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .sgpr import SGPR_deprecated as SGPR
from .training_mixins import RegressionData

__all__ = ["CGLB", "NystromPreconditioner", "cglb_conjugate_gradient"]

KOperator = Union[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]


def _block_matvec(x: torch.Tensor, xc: torch.Tensor, v: torch.Tensor, kernel: Kernel) -> torch.Tensor:
    return v @ kernel.K(x, xc)  # [R, chunk]


class _BlockMatvec:
    """v [R, n] -> v (K + sigma^2 I) over this rank's columns, K(X, x_block)
    built in blocks of ``chunk`` columns against every rank's columns of v.
    An object of its tensors and kernel, so that a CG loop can pass them to
    its body (``_compile.while_loop``'s ``captured``)."""

    def __init__(self, kernel: Kernel, x_all: torch.Tensor, x: torch.Tensor, sigma_sq: torch.Tensor, chunk: int,
                 rows: Any) -> None:
        self.kernel, self.x_all, self.x, self.sigma_sq, self.chunk, self.rows = kernel, x_all, x, sigma_sq, chunk, rows

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        v_all = self.rows.gather(v, dim=-1)
        starts = range(0, self.x.shape[0], self.chunk)
        if not torch.is_grad_enabled():
            # no backward (the CG's matvecs): each block built and used, without
            # the checkpoint's and the kernel's walk's host time at every block
            parts = [_block_matvec(self.x_all, self.x[s:s + self.chunk], v_all, self.kernel) for s in starts]
            return torch.cat(parts, dim=-1) + self.sigma_sq * v
        # the kernel's tensors are the block's inputs: its recomputation in the
        # backward reads those of the forward, also where they were put in the
        # parameters' place only for the forward (functionalize)
        block, kernel_tensors = _compile.over_tensors(_block_matvec, 3, (self.kernel,))
        parts = []
        for start in starts:
            # the backward builds the block again instead of keeping it:
            # kept, the blocks would add up to the [N, N] matrix
            parts.append(checkpoint(block, self.x_all, self.x[start:start + self.chunk], v_all, *kernel_tensors,
                                    use_reentrant=False, preserve_rng_state=False))
        return torch.cat(parts, dim=-1) + self.sigma_sq * v


class CGLB(SGPR):
    """SGPR with a tighter, Jensen-corrected log-determinant bound and a
    CG-estimated quadratic term (``gpflow_tpu/models/cglb.py:30-263``)."""

    _readouts = ("_cg_iterations",)  # set by a replay, no part of a trace's key

    @check_shapes(
        "data[0]: [N, D]",
        "data[1]: [N, P]",
    )
    def __init__(
        self,
        data: RegressionData,
        *args: Any,
        cg_tolerance: float = 1.0,
        max_cg_iters: int = 100,
        restart_cg_iters: int = 40,
        v_grad_optimization: bool = False,
        matrix_free_chunk: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        """:param matrix_free_chunk: if set, never form the [N, N] kernel
        matrix: every K-matvec is computed in [N, chunk] blocks, each built
        again in the backward, so memory is O(N * chunk).
        :param v_grad_optimization: make v a trainable parameter instead of
        the CG's output."""
        super().__init__(data, *args, **kwargs)
        self._matrix_free_chunk = matrix_free_chunk
        n, b = self.data[1].shape
        self._v = Parameter(
            torch.zeros((b, n), dtype=default_float(), device=default_device()),
            trainable=v_grad_optimization,
            name="v",
        )
        self._cg_tolerance = cg_tolerance
        self._max_cg_iters = max_cg_iters
        self._restart_cg_iters = restart_cg_iters
        self._cg_iterations: Optional[torch.Tensor] = None  # a 0-d int64 CPU tensor

    @property
    def cg_iterations(self) -> Optional[int]:
        """CG iterations of the last CG run, eager or replayed (None before the first)."""
        return None if self._cg_iterations is None else int(self._cg_iterations)

    @property
    @check_shapes(
        "return: [P, N]",
    )
    def aux_vec(self) -> Parameter:
        """The auxiliary vector v [R, N]."""
        return self._v

    def _kmat_operator(self) -> KOperator:
        """K + sigma^2 I: the dense [N, N] matrix in the default mode, a
        matvec v [R, N] -> v (K + sigma^2 I) in the matrix-free mode. Where
        the rows are split over ranks, always a matvec from this rank's
        columns of v to its columns of the product, in blocks of
        ``matrix_free_chunk`` columns (one block in the dense mode): each
        block is K(X, x_block) against every rank's columns of v."""
        x, _ = self.data
        sigma_sq = self.likelihood.variance.value
        rows = rows_of(self)
        if self._matrix_free_chunk is None and rows is WHOLE:
            return add_noise_cov(self.kernel.K(x), sigma_sq)

        return _BlockMatvec(self.kernel, rows.gather(x), x, sigma_sq, self._matrix_free_chunk or x.shape[0], rows)

    def _conjugate_gradient(self, K: KOperator, b: torch.Tensor, initial: torch.Tensor,
                            preconditioner: "NystromPreconditioner", cg_tolerance: float) -> torch.Tensor:
        """The CG's v; its iteration count into ``cg_iterations`` (through
        ``_compile.readout`` inside a trace)."""
        v, iterations = _cglb_conjugate_gradient(K, b, initial, preconditioner, cg_tolerance, self._max_cg_iters,
                                                 self._restart_cg_iters)
        if _compile.is_tracing():
            _compile.readout(self, "_cg_iterations", iterations)
        else:
            self._cg_iterations = iterations
        return v

    @check_shapes(
        "return: []",
    )
    def logdet_term(self, common: SGPR.CommonTensors) -> torch.Tensor:
        """log|K + s2 I| <= log|Q + s2 I| + N log(1 + tr(K - Q) / (s2 N))
        (``cglb.py:98-114``)."""
        LB = common.LB
        AAT = common.AAT
        x, y = self.data
        rows = rows_of(self)
        num_data, output_dim = float(y.shape[0] * rows.size), float(y.shape[1])
        sigma_sq = self.likelihood.variance.value

        kdiag = self.kernel(x, full_cov=False)
        trace = rows.sum(torch.sum(kdiag)) / sigma_sq - torch.sum(torch.diagonal(AAT))
        logdet_b = torch.sum(torch.log(torch.diagonal(LB)))
        logsigma_sq = num_data * torch.log(sigma_sq)
        logtrace = num_data * torch.log(1 + trace / num_data)
        return -output_dim * (logdet_b + 0.5 * logsigma_sq + 0.5 * logtrace)

    @check_shapes(
        "return: []",
    )
    def quad_term(self, common: SGPR.CommonTensors) -> torch.Tensor:
        """The bound -0.5 (v . (r + 0.5 K v) + 0.5 r^T Q^-1 r) on
        -0.5 y^T (K + s2 I)^-1 y through the auxiliary vector v
        (``cglb.py:116-169``)."""
        x, y = self.data
        rows = rows_of(self)
        err = y - self.mean_function(x)
        sigma_sq = self.likelihood.variance.value
        K = self._kmat_operator()

        preconditioner = NystromPreconditioner(common.A, common.LB, sigma_sq)
        share_blocks(self, preconditioner)
        err_t = err.mT

        v_init = self.aux_vec
        if not v_init.trainable:
            v = self._conjugate_gradient(K, err_t, rows.local(v_init.value, dim=-1), preconditioner,
                                         self._cg_tolerance)
        else:
            v = rows.local(v_init.value, dim=-1)

        Kv = K(v) if callable(K) else v @ K
        r = err_t - Kv
        _, error_bound_cols = preconditioner(r)  # [R]
        # The PSD quadratic forms are clamped one-sided, exactly as the JAX
        # package does (cglb.py:147-164): for a huge-norm v, float32 can round
        # the kernel part of v^T (K + s2 I) v, whose true value is >= 0, below
        # zero and inflate the "lower bound" above the evidence. Clamping it at
        # 0 and adding the exact s2 ||v||^2, and clamping r^T Q^-1 r >= 0, only
        # ever lowers the bound; in float64 both clamps change nothing.
        sq = sigma_sq.to(v.dtype)
        v_norm_sq = rows.sum(torch.sum(torch.square(v), dim=-1))  # [R]
        vKv_kernel = torch.clamp(rows.sum(torch.sum(v * Kv, dim=-1)) - sq * v_norm_sq, min=0.0)
        lb = rows.sum(torch.sum(v * err_t)) - 0.5 * torch.sum(vKv_kernel + sq * v_norm_sq)
        ub = lb + 0.5 * torch.sum(torch.clamp(error_bound_cols, min=0.0))

        if not v_init.trainable and not _compile.is_tracing():
            with torch.no_grad():
                # the warm start of the next eager CG run, as the JAX package
                # writes it only outside jit; a non-finite v (a NaN trial
                # point of L-BFGS) keeps the old one, with no host sync
                v = rows.gather(v, dim=-1)
                v_init._set_unconstrained(torch.where(torch.isfinite(v).all(), v, v_init.unconstrained))

        return -ub

    @inherit_check_shapes
    def predict_f(
        self,
        Xnew: torch.Tensor,
        full_cov: bool = False,
        full_output_cov: bool = False,
        cg_tolerance: Optional[float] = 1e-3,
    ) -> MeanAndVariance:
        """m(Xnew) = K(Xnew, X) v + Q(Xnew, X) Q^-1 r with r = y - (K + s2 I) v,
        and the SGPR variance (``cglb.py:171-232``). With ``cg_tolerance`` set,
        the CG first runs from ``aux_vec`` to that tolerance; v is not written
        back."""
        Xnew = input_to_tensor(self, Xnew)
        assert_params_false(self.predict_f, full_output_cov=full_output_cov)

        x, y = self.data
        rows = rows_of(self)
        err = y - self.mean_function(x)
        ksf = self.kernel(Xnew, x)
        sigma_sq = self.likelihood.variance.value
        sigma = torch.sqrt(sigma_sq)

        kmat = self._kmat_operator()

        common = self._common_calculation()
        A, LB, L = common.A, common.LB, common.L

        v = rows.local(self.aux_vec.value, dim=-1)
        if cg_tolerance is not None:
            preconditioner = NystromPreconditioner(A, LB, sigma_sq)
            share_blocks(self, preconditioner)
            v = self._conjugate_gradient(kmat, err.mT, v, preconditioner, cg_tolerance)

        cg_mean = rows.sum(ksf @ v.mT)
        res = err - (kmat(v).mT if callable(kmat) else kmat @ v.mT)

        c = torch.linalg.solve_triangular(LB, rows.sum(A @ res), upper=False) / sigma
        sgpr_mean, var = sgpr_conditional(self.kernel, self.inducing_variable, self.num_latent_gps, L, LB, c, Xnew,
                                          full_cov)

        mean = sgpr_mean + cg_mean + self.mean_function(Xnew)
        return mean, var

    @inherit_check_shapes
    def predict_y(
        self,
        Xnew: torch.Tensor,
        full_cov: bool = False,
        full_output_cov: bool = False,
        cg_tolerance: Optional[float] = 1e-3,
    ) -> MeanAndVariance:
        Xnew = input_to_tensor(self, Xnew)
        assert_params_false(self.predict_y, full_cov=full_cov, full_output_cov=full_output_cov)
        f_mean, f_var = self.predict_f(
            Xnew, full_cov=full_cov, full_output_cov=full_output_cov, cg_tolerance=cg_tolerance
        )
        return self.likelihood.predict_mean_and_var(Xnew, f_mean, f_var)

    @inherit_check_shapes
    def predict_log_density(
        self,
        data: RegressionData,
        full_cov: bool = False,
        full_output_cov: bool = False,
        cg_tolerance: Optional[float] = 1e-3,
    ) -> torch.Tensor:
        data = input_to_tensor(self, data)
        assert_params_false(self.predict_log_density, full_cov=full_cov, full_output_cov=full_output_cov)
        x, y = data
        f_mean, f_var = self.predict_f(
            x, full_cov=full_cov, full_output_cov=full_output_cov, cg_tolerance=cg_tolerance
        )
        return self.likelihood.predict_log_density(x, f_mean, f_var, y)


class NystromPreconditioner:
    """Q^-1 = (Q_ff + s2 I)^-1 applied through A = s^-1 L^-1 Kuf [M, N] and
    LB (``cglb.py:266-303``)."""

    @check_shapes(
        "A: [M, N]",
        "LB: [M, M]",
    )
    def __init__(self, A: torch.Tensor, LB: torch.Tensor, sigma_sq: torch.Tensor) -> None:
        self.A = A
        self.LB = LB
        self.sigma_sq = sigma_sq

    @check_shapes(
        "v: [B, N]",
        "return[0]: [B, N]",
        "return[1]: [B]",
    )
    def __call__(self, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """For v [R, N]: v^T Q^-1 as rows [R, N], and each column's quadratic
        v_r^T Q^-1 v_r [R]. Per column, as in the JAX package, so that the CG
        takes its own step size for each right-hand side."""
        sigma_sq = self.sigma_sq
        A = self.A
        LB = self.LB

        rows = rows_of(self)
        vt = v.mT
        Av = rows.sum(A @ vt)
        LBinvAv = torch.linalg.solve_triangular(LB, Av, upper=False)
        LBinvtLBinvAv = torch.linalg.solve_triangular(LB.mT, LBinvAv, upper=True)

        rv = vt - A.mT @ LBinvtLBinvAv
        vtrv = rows.sum(torch.sum(rv * vt, dim=0))  # [R]
        return rv.mT / sigma_sq, vtrv / sigma_sq


def _matvec(K: KOperator, p: torch.Tensor) -> torch.Tensor:
    return K(p) if callable(K) else p @ K


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` with row-major strides, also along a dimension of size 1: the
    loop's and the branches' values must agree in their strides."""
    return t.contiguous().view(-1).view(t.shape)


def _cglb_conjugate_gradient(
    K: KOperator,
    b: torch.Tensor,
    initial: torch.Tensor,
    preconditioner: NystromPreconditioner,
    cg_tolerance: float,
    max_steps: int,
    restart_cg_step: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cglb_conjugate_gradient`` and its iteration count, a 0-d int64 CPU
    tensor: one ``_compile.while_loop`` (``gpflow_tpu/models/cglb.py:322-370``),
    eager or traced."""
    rows = rows_of(preconditioner)  # where the rows are split, the vectors are this rank's columns

    # run until EVERY column's residual quadratic is below the tolerance; a
    # NaN compares False and stops the loop, as in the JAX package
    def keep_going(i, v, r, p, rz, K, b, pre):
        return (0.5 * torch.max(rz) > cg_tolerance) & (i < max_steps)

    def cg_step(i, v, r, p, rz, K, b, pre):
        Ap = _matvec(K, p)
        denom = rows.sum(torch.sum(p * Ap, dim=-1))  # [R]
        # per-column step size [R, 1]; a converged column (p ~ 0, denom ~ 0)
        # takes a zero step instead of 0/0
        gamma = torch.where(denom > 0, rz / denom, torch.zeros_like(denom))[..., None]
        v = v + gamma * p
        restart = i % restart_cg_step == restart_cg_step - 1  # on the host: no read of the device
        r = _compile.cond(restart, lambda v, r, gamma, Ap, K, b: b - _matvec(K, v),
                          lambda v, r, gamma, Ap, K, b: r - gamma * Ap, (v, r, gamma, Ap), (K, b))
        z, new_rz = pre(r)
        z = _dense(z)
        beta = torch.where(rz > 0, new_rz / rz, torch.zeros_like(rz))[..., None]  # [R, 1]
        p = _compile.cond(restart, lambda z, p, beta: z.clone(memory_format=torch.contiguous_format),
                          lambda z, p, beta: z + p * beta, (z, p, beta))
        return i + 1, v, r, p, new_rz

    with torch.no_grad():
        b = _dense(b)
        v = _dense(initial.detach().clone(memory_format=torch.contiguous_format))
        r = b - _matvec(K, v)
        z, rz = preconditioner(r)
        z = _dense(z)
        i = torch.zeros((), dtype=torch.int64)
        i, v, *_ = _compile.while_loop(keep_going, cg_step, (i, v, r, z, rz), (K, b, preconditioner))
    return v, i


@check_shapes(
    "b: [B, N]",
    "initial: [B, N]",
    "return: [B, N]",
)
def cglb_conjugate_gradient(
    K: KOperator,
    b: torch.Tensor,
    initial: torch.Tensor,
    preconditioner: NystromPreconditioner,
    cg_tolerance: float,
    max_steps: int,
    restart_cg_step: int,
) -> torch.Tensor:
    """Preconditioned CG with periodic restarts for (K + s2 I) v^T = b^T,
    stopping when 0.5 r^T Q^-1 r <= cg_tolerance in every column or after
    ``max_steps`` iterations (``cglb.py:306-371``). ``K`` is the dense [N, N]
    matrix or a matvec (the matrix-free mode); b and initial are [R, N].
    Runs under ``no_grad`` and returns a detached v [R, N]."""
    v, _ = _cglb_conjugate_gradient(K, b, initial, preconditioner, cg_tolerance, max_steps, restart_cg_step)
    return v
