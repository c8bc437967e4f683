"""The port's regression likelihoods (Gaussian with fixed noise, Student-t,
Laplace, Matern-3/2 noise) against the JAX package, float64: their methods,
and the stochastic-CAVI slice (SVGP, slice sampling, fixed
hyperparameters) at N=2048, D=4, M=24, B=256 through the plain
fused_cavi_stats, from identical states (``interop``) on the JAX package's
own draws.  Student-t also runs with each Matern kernel."""
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from torch_helpers import check_likelihood_methods, check_predictions_and_elbo, check_steps, slice_runs

N, D, M, B, STEPS = 2048, 4, 24, 256, 10
LIKS = ("gaussian", "studentt", "laplace", "matern32")


@pytest.mark.parametrize("lik", LIKS)
def test_likelihood_methods_match_reference(lik):
    check_likelihood_methods(lik)


@pytest.fixture(scope="module", params=LIKS)
def runs(request):
    return slice_runs(request.param, N, D, M, B, STEPS)


def test_steps_match_reference(runs):
    """10 steps: eta, mu, Sigma and the local variables after each, rtol
    1e-8; the port through its plain fused pass, the reference through its
    unfused XLA path."""
    check_steps(runs)


def test_predictions_and_elbo_match_reference(runs):
    check_predictions_and_elbo(runs, D)


@pytest.mark.parametrize("kernel", [agp.Matern12Kernel, agp.Matern32Kernel, agp.Matern52Kernel])
def test_matern_kernels_slice_matches_reference(kernel):
    """Student-t with each Matern kernel, Z on training rows as the JAX
    package's model puts it: 10 steps and the predictions at rtol 1e-8."""
    runs = slice_runs("studentt", N, D, M, B, STEPS, kernel=kernel)
    check_steps(runs)
    check_predictions_and_elbo(runs, D)


def test_create_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="opt_noise"):
        agt.GaussianLikelihood.create(0.1, opt_noise="an optax rule")
    with pytest.raises(ValueError, match="nu"):
        agt.StudentTLikelihood.create(0.5)
    Z = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="not ported"):
        agt.SVGP.create(agt.kernels.StationaryKernel(), agt.StudentTLikelihood.create(4.0), agt.AnalyticSVI(8), Z,
                        optimiser=None)


def test_parameters_live_on_the_model_device_and_dtype():
    Z = torch.zeros((4, 2), dtype=torch.float32)
    model = agt.SVGP.create(agt.Matern52Kernel(), agt.StudentTLikelihood.create(4.0, 0.5), agt.AnalyticSVI(8), Z,
                            optimiser=None)
    lik = model.likelihood
    assert lik.nu.dtype == lik.sigma.dtype == torch.float32 and lik.nu.ndim == 0
    assert float(lik.sigma) == 0.5


def test_train_through_public_api():
    """agt.train with the port's own generator and Robbins-Monro rule:
    Student-t (sigma 0.1) with the Matern-3/2 kernel on the reference's 2-D
    oracle function, N=2048, M=32, B=256, 150 steps; predict_f follows the
    noiseless latent: RMSE 0.1230 here, where the JAX package's own train
    reaches 0.1229."""
    rng = np.random.default_rng(7)
    X = rng.uniform(-2, 2, size=(N, 2))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    X, f, y = (torch.as_tensor(a) for a in (X, f, f + 0.1 * rng.standard_t(4.0, size=N)))
    model = agt.SVGP.create(agt.Matern32Kernel(), agt.StudentTLikelihood.create(4.0, 0.1),
                            agt.AnalyticSVI(B, minibatch_sampling="slice"), X[:32], optimiser=None)
    model, state = agt.train(model, X, y, iterations=150, generator=torch.Generator().manual_seed(0))
    rmse = float(torch.sqrt(torch.mean((agt.predict_f(model, state, X) - f) ** 2)))
    assert rmse < 0.15
    assert int(state.step) == 150
