"""Variational GP over the function values at the data (counterpart of
``gpflow_tpu/models/vgp.py``), in the JAX package's three layers:
``VGP_deprecated`` (fused prediction through ``conditionals.conditional``)
-> ``VGP_with_posterior`` (cached ``VGPPosterior``) -> ``VGP``; and
``VGPOpperArchambeau``, the same q(f) in Opper and Archambeau's (alpha,
lambda) parametrization.

VGP is whitened: f = L v with L = chol(K(X) + jitter I) and q(v) =
N(q_mu, q_sqrt q_sqrt^T), q_mu [N, L], q_sqrt [L, N, N]. On a CUDA device
K(X) and K(X, Xnew) come from kernel K1 (``ops/pallas_distance.py``) where
the kernel routes there; the Cholesky factorizations, solves and the
[N, N] products go to cuSOLVER and cuBLAS.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import posteriors
from .._sharding import kernel_rows, rows_of
from ..base import MeanAndVariance, Parameter, input_to_tensor
from ..bijectors import positive, triangular
from ..conditionals import conditional
from ..config import default_device, default_float, default_jitter
from ..functions import MeanFunction
from ..kernels import Kernel
from ..kullback_leiblers import gauss_kl
from ..likelihoods import Likelihood
from ..ops.linalg import cholesky
from ..utilities.model_utils import assert_params_false
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .model import GPModel
from .training_mixins import InternalDataTrainingLossMixin, RegressionData
from .util import data_input_to_tensor

__all__ = [
    "VGP",
    "VGPOpperArchambeau",
    "VGP_deprecated",
    "VGP_with_posterior",
    "update_vgp_data",
]


def _whole_data(model: GPModel) -> RegressionData:
    """The model's (X, Y); where its rows are split over ranks, every rank's
    rows gathered."""
    rows = rows_of(model)
    return tuple(rows.gather(a) for a in model.data)


def _eye(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.eye(n, dtype=dtype, device=device)


class VGP_deprecated(GPModel, InternalDataTrainingLossMixin):
    """Whitened full-rank Gaussian approximation over f(X)
    (``gpflow_tpu/models/vgp.py:42-111``): SVGP with Z = X, but cheaper.
    ``data`` is (X [N, D], Y [N, P]), stored as tensors of the default float
    type on ``config.default_device()``."""

    @check_shapes(
        "data[0]: [N, D]",
        "data[1]: [N, P]",
    )
    def __init__(
        self,
        data: RegressionData,
        kernel: Kernel,
        likelihood: Likelihood,
        mean_function: Optional[MeanFunction] = None,
        num_latent_gps: Optional[int] = None,
    ) -> None:
        if num_latent_gps is None:
            num_latent_gps = self.calc_num_latent_gps_from_data(data, kernel, likelihood)
        super().__init__(kernel, likelihood, mean_function, num_latent_gps)

        self.data = data_input_to_tensor(data)
        X_data, _Y_data = self.data
        self.num_data = X_data.shape[0]

        dtype, device = default_float(), default_device()
        self.q_mu = Parameter(
            torch.zeros((self.num_data, self.num_latent_gps), dtype=dtype, device=device), name="q_mu"
        )
        q_sqrt = _eye(self.num_data, dtype, device).expand(self.num_latent_gps, -1, -1)
        self.q_sqrt = Parameter(q_sqrt, transform=triangular(), name="q_sqrt")

    @check_shapes("return: []")
    def maximum_log_likelihood_objective(self) -> torch.Tensor:
        return self.elbo()

    @check_shapes("return: []")
    def elbo(self) -> torch.Tensor:
        """E_q[log p(Y | F)] - KL[q(V) || p(V)] in the whitened
        parametrization (``gpflow_tpu/models/vgp.py:76-95``)."""
        X_data, Y_data = _whole_data(self)
        KL = gauss_kl(self.q_mu.value, self.q_sqrt.value)

        K = kernel_rows(self, self.kernel, X_data)
        L = cholesky(K + default_jitter() * _eye(self.num_data, K.dtype, K.device))
        fmean = L @ self.q_mu.value + self.mean_function(X_data)  # [N, P]
        q_sqrt_dnn = torch.tril(self.q_sqrt.value)  # [P, N, N]
        LTA = torch.matmul(L[None], q_sqrt_dnn)  # [P, N, N]
        fvar = torch.sum(torch.square(LTA), dim=2).mT  # [N, P]

        var_exp = self.likelihood.variational_expectations(X_data, fmean, fvar, Y_data)
        return torch.sum(var_exp) - KL

    @inherit_check_shapes
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """The fused route through ``conditionals.conditional``: K(X), its
        Cholesky and K(X, Xnew) on every call."""
        Xnew = input_to_tensor(self, Xnew)
        assert_params_false(self.predict_f, full_output_cov=full_output_cov)
        X_data, _Y_data = _whole_data(self)
        mu, var = conditional(
            Xnew,
            X_data,
            self.kernel,
            self.q_mu.value,
            q_sqrt=self.q_sqrt.value,
            full_cov=full_cov,
            white=True,
        )
        return mu + self.mean_function(Xnew), var


class VGP_with_posterior(VGP_deprecated):
    """Adds cached-posterior prediction (``gpflow_tpu/models/vgp.py:114-137``)."""

    def posterior(
        self,
        precompute_cache: posteriors.PrecomputeCacheType = posteriors.PrecomputeCacheType.TENSOR,
    ) -> posteriors.VGPPosterior:
        """The posterior, with its (Lm,) cache computed unless NOCACHE."""
        X_data, _Y_data = _whole_data(self)
        return posteriors.VGPPosterior(
            self.kernel,
            X_data,
            self.q_mu,
            self.q_sqrt,
            mean_function=self.mean_function,
            precompute_cache=precompute_cache,
        )

    @inherit_check_shapes
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        Xnew = input_to_tensor(self, Xnew)
        return self.posterior(posteriors.PrecomputeCacheType.NOCACHE).fused_predict_f(
            Xnew, full_cov=full_cov, full_output_cov=full_output_cov
        )


class VGP(VGP_with_posterior):
    """Variational GP regression and classification over f(X)."""


@check_shapes(
    "new_data[0]: [N, D]",
    "new_data[1]: [N, P]",
)
def update_vgp_data(vgp: VGP_deprecated, new_data: RegressionData) -> None:
    """Sets new data on a VGP and refits its variational parameters so that
    q(f) at the new inputs is the current posterior there
    (``gpflow_tpu/models/vgp.py:144-172``): q_mu' = Lnn^-1 f_mu and
    q_sqrt' = chol(Lnn^-1 f_cov Lnn^-T + jitter I).

    ``q_mu`` and ``q_sqrt`` are replaced by new Parameters, of the new size,
    as the JAX package replaces them. An optimizer built on the old
    Parameters (a ``torch.optim`` optimizer, a ``NaturalGradient`` var list,
    a ``Scipy`` variable list) still holds the old tensors and is stale:
    build it again from ``vgp.trainable_variables``."""
    new_X_data, new_Y_data = data_input_to_tensor(new_data)
    new_num_data = new_X_data.shape[0]
    with torch.no_grad():
        f_mu, f_cov = vgp.predict_f(new_X_data, full_cov=True)  # [N, L], [L, N, N]
        Knn = vgp.kernel(new_X_data, full_cov=True)
        jitter_mat = default_jitter() * _eye(new_num_data, Knn.dtype, Knn.device)
        Lnn = cholesky(Knn + jitter_mat)
        new_q_mu = torch.linalg.solve_triangular(Lnn, f_mu, upper=False)
        Lnn_b = Lnn[None].expand(f_cov.shape)
        tmp = torch.linalg.solve_triangular(Lnn_b, f_cov, upper=False)  # Lnn^-1 f_cov
        S_v = torch.linalg.solve_triangular(Lnn_b, tmp.mT, upper=False)
        new_q_sqrt = cholesky(S_v + jitter_mat)

    vgp.data = (new_X_data, new_Y_data)
    vgp.num_data = new_num_data
    vgp.q_mu = Parameter(new_q_mu, name="q_mu")
    vgp.q_sqrt = Parameter(new_q_sqrt, transform=triangular(), name="q_sqrt")


class VGPOpperArchambeau(GPModel, InternalDataTrainingLossMixin):
    """Variational GP with 2N parameters per latent GP (Opper and Archambeau
    2009; ``gpflow_tpu/models/vgp.py:175-266``):
    q(f) = N(K alpha + mean, [K^-1 + diag(lambda^2)]^-1), q_alpha [N, L] and
    q_lambda [N, L] positive."""

    @check_shapes(
        "data[0]: [N, D]",
        "data[1]: [N, P]",
    )
    def __init__(
        self,
        data: RegressionData,
        kernel: Kernel,
        likelihood: Likelihood,
        mean_function: Optional[MeanFunction] = None,
        num_latent_gps: Optional[int] = None,
    ) -> None:
        if num_latent_gps is None:
            num_latent_gps = self.calc_num_latent_gps_from_data(data, kernel, likelihood)
        super().__init__(kernel, likelihood, mean_function, num_latent_gps)

        self.data = data_input_to_tensor(data)
        X_data, _Y_data = self.data
        self.num_data = X_data.shape[0]
        dtype, device = default_float(), default_device()
        shape = (self.num_data, self.num_latent_gps)
        self.q_alpha = Parameter(torch.zeros(shape, dtype=dtype, device=device), name="q_alpha")
        self.q_lambda = Parameter(
            torch.ones(shape, dtype=dtype, device=device), transform=positive(), name="q_lambda"
        )

    @check_shapes("return: []")
    def maximum_log_likelihood_objective(self) -> torch.Tensor:
        return self.elbo()

    @check_shapes("return: []")
    def elbo(self) -> torch.Tensor:
        """E_q[log p(Y | F)] - KL[q(F) || p(F)] with A = I + Lambda K Lambda
        (``gpflow_tpu/models/vgp.py:207-241``)."""
        X_data, Y_data = _whole_data(self)
        q_alpha, q_lambda = self.q_alpha.value, self.q_lambda.value

        K = kernel_rows(self, self.kernel, X_data)
        K_alpha = K @ q_alpha
        f_mean = K_alpha + self.mean_function(X_data)

        I = _eye(self.num_data, K.dtype, K.device)[None].expand(self.num_latent_gps, -1, -1)
        lam_t = q_lambda.mT  # [L, N]
        A = I + lam_t[:, None, :] * lam_t[:, :, None] * K
        L = cholesky(A)
        Li = torch.linalg.solve_triangular(L, I, upper=False)
        tmp = Li / lam_t[:, None, :]
        f_var = 1.0 / torch.square(q_lambda) - torch.sum(torch.square(tmp), dim=1).mT

        A_logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)))
        trAi = torch.sum(torch.square(Li))

        KL = 0.5 * (
            A_logdet
            + trAi
            - self.num_data * self.num_latent_gps
            + torch.sum(K_alpha * q_alpha)
        )

        v_exp = self.likelihood.variational_expectations(X_data, f_mean, f_var, Y_data)
        return torch.sum(v_exp) - KL

    @inherit_check_shapes
    def predict_f(
        self, Xnew: torch.Tensor, full_cov: bool = False, full_output_cov: bool = False
    ) -> MeanAndVariance:
        """q(F*) = N(K_{*f} alpha + mean, K_** - K_{*f} [K + diag(lambda^-2)]^-1 K_{f*})
        (``gpflow_tpu/models/vgp.py:243-266``)."""
        Xnew = input_to_tensor(self, Xnew)
        assert_params_false(self.predict_f, full_output_cov=full_output_cov)

        X_data, _ = _whole_data(self)
        Kx = self.kernel(X_data, Xnew)
        K = self.kernel(X_data)

        f_mean = Kx.mT @ self.q_alpha.value + self.mean_function(Xnew)

        inv_lam_sq = (1.0 / torch.square(self.q_lambda.value)).mT  # [L, N]
        A = K + torch.diag_embed(inv_lam_sq)
        L = cholesky(A)
        Kx_tiled = Kx[None].expand((self.num_latent_gps,) + Kx.shape)
        LiKx = torch.linalg.solve_triangular(L, Kx_tiled, upper=False)
        if full_cov:
            f_var = self.kernel(Xnew) - torch.matmul(LiKx.mT, LiKx)
        else:
            f_var = self.kernel(Xnew, full_cov=False) - torch.sum(torch.square(LiKx), dim=1)
        return f_mean, f_var if full_cov else f_var.mT
