"""agp_tpu_torch: the PyTorch and CUDA port of agp_tpu.

Gaussian processes with augmented likelihoods, trained by closed-form
natural-gradient CAVI.  This package mirrors ``agp_tpu``'s module paths and
public names; it runs on the CPU (plain PyTorch) and on an NVIDIA Hopper
card, where a sparse model's step statistics are hand-written CUDA kernels
(``ops/cuda_kernels.py``): one fused pass while the model's inducing set
fits a block's shared memory (M <= 128), else a split pair of kernels
around the likelihood's own E-step (M up to 2,392): the single-latent one
or the batched one.  It holds the whole public surface of ``agp_tpu``: ``SVGP`` (stochastic or
full-batch CAVI), the dense ``VGP`` (full-batch CAVI over its training
inputs) and the exact ``GP`` (Gaussian likelihood, noise learnt by
default), with the sixteen kernels of ``kernels`` (their sums, products
and the six input transforms too: a kernel outside the squared-exponential
and Matern ones forms its kappa by plain products, its statistics on the
same CUDA kernels), the four prior means and the logistic,
Gaussian (fixed or learnt noise), Student-t, Laplace, Matern-3/2 noise,
Bayesian SVM, Poisson, negative binomial, logistic-softmax (multiclass)
and heteroscedastic likelihoods, the softmax and the generic augmented
likelihoods of ``make_augmented_likelihood`` (Gibbs draws their auxiliary
from its Laplace transform), trained by closed-form CAVI or by numerical
VI (``QuadratureVI``, ``MCIntegrationVI`` and their stochastic forms:
Gauss-Hermite or Monte Carlo expectations, the statistics on the same
kernels as the split pair), with the hyperparameter step interleaved
(Adam(0.01) on the kernel and the mean by default, optionally on the
inducing points) or with fixed hyperparameters, the natural-gradient
step by Robbins-Monro or ``alrsvi``; ``predict_f`` (diagonal or
full covariance), ``predict_y``, ``proba_y`` (each optionally in chunks)
and ``sample_f``; the Monte-Carlo ``MCGP``, sampled by exact augmented
Gibbs (Polya-Gamma and GIG draws, the global resample by Cholesky or
conjugate gradients), NUTS or HMC, and the SMC and SVGD samplers
(``smc_sample``, ``svgd_sample``); the streaming ``OnlineSVGP``
(``online_train`` a batch at a time, ``online_train_stream`` over a
buffered stream, ``online_elbo``) with the inducing-point algorithms of
``inducing``.  The dense models' N x N algebra, the samplers and the
online model are plain PyTorch at full FP32 and run no kernel of the
port.  The Student-t process ``VStP`` (dense, its prior's scale updated
each step), the multi-output ``MOSVGP`` and ``MOVGP`` (``mo_train``,
``mo_elbo``, ``mo_predict_f``, ``mo_predict_y``, ``mo_proba_y``: Q shared
latents mixed into the tasks' rows, each step on the split pairs'
kernels) and the autoregressive rollouts ``predict_ar`` and ``sample_ar``
complete the model families.  ``checkpoint`` saves and loads (model,
state), the JAX package's checkpoints too; ``parallel`` trains a sparse
model data-parallel over ``torch.distributed`` (full-batch and minibatched
CAVI, one process per device); ``utils.metrics``, ``utils.plotting`` and
``utils.profiling`` evaluate, plot and trace.  Inputs without a device (numpy arrays,
lists) go to the CUDA card unless ``config.set_default_device("cpu")``
was called.
"""

from . import config, inducing, kernels
from .inference.config import (
    Analytic,
    AnalyticSVI,
    AnalyticVI,
    GibbsSampling,
    HMCSampling,
    MCIntegrationSVI,
    MCIntegrationVI,
    NumericalSVI,
    NumericalVI,
    QuadratureSVI,
    QuadratureVI,
)
from .inference.hmc import sample_hmc, sample_nuts
from .inference.smc import smc_sample
from .inference.svgd import svgd_sample
from .kernels import (
    ARDTransform,
    ChainTransform,
    ConstantKernel,
    CosineKernel,
    ExponentiatedKernel,
    FBMKernel,
    FunctionTransform,
    GaborKernel,
    LinearKernel,
    LinearTransform,
    Matern12Kernel,
    Matern32Kernel,
    Matern52Kernel,
    NeuralNetworkKernel,
    PeriodicKernel,
    PiecewisePolynomialKernel,
    PolynomialKernel,
    RationalQuadraticKernel,
    RBFKernel,
    ScaleTransform,
    SelectTransform,
    SqExponentialKernel,
    TransformedKernel,
    WhiteKernel,
    with_transform,
)
from .likelihoods.base import Likelihood
from .likelihoods.classification import BayesianSVM, LogisticLikelihood
from .likelihoods.event import NegBinomialLikelihood, PoissonLikelihood
from .likelihoods.heteroscedastic import HeteroscedasticLikelihood
from .likelihoods.generic import make_augmented_likelihood
from .likelihoods.multiclass import LogisticSoftMaxLikelihood, MultiClassLikelihood, SoftMaxLikelihood
from .likelihoods.regression import GaussianLikelihood, LaplaceLikelihood, Matern32Likelihood, StudentTLikelihood
from .means import AffineMean, ConstantMean, EmpiricalMean, ZeroMean
from .models.gp import GP
from .models.mcgp import MCGP, sample
from .models.multioutput import (
    MOSVGP,
    MOVGP,
    mo_elbo,
    mo_init_state,
    mo_predict_f,
    mo_predict_y,
    mo_proba_y,
    mo_train,
)
from .models.online_svgp import OnlineSVGP, online_elbo, online_train, online_train_stream
from .models.svgp import SVGP, VGP
from .models.vstp import VStP
from .training import checkpoint
from .training.ar_predict import predict_ar, sample_ar
from .training.predictions import predict_f, predict_y, proba_y, sample_f
from .training.autotuning import hyper_step
from .training.state import TrainState
from .training.train import elbo, init_state, train
from .utils.opt import adam, alrsvi, robbins_monro, sgd

ELBO = elbo

__all__ = [
    "SVGP",
    "VGP",
    "GP",
    "VStP",
    "MOSVGP",
    "MOVGP",
    "mo_train",
    "mo_init_state",
    "mo_elbo",
    "mo_predict_f",
    "mo_predict_y",
    "mo_proba_y",
    "predict_ar",
    "sample_ar",
    "MCGP",
    "sample",
    "OnlineSVGP",
    "online_train",
    "online_train_stream",
    "online_elbo",
    "sample_hmc",
    "sample_nuts",
    "smc_sample",
    "svgd_sample",
    "train",
    "elbo",
    "ELBO",
    "init_state",
    "predict_f",
    "predict_y",
    "proba_y",
    "sample_f",
    "TrainState",
    "Analytic",
    "AnalyticVI",
    "AnalyticSVI",
    "NumericalVI",
    "NumericalSVI",
    "QuadratureVI",
    "QuadratureSVI",
    "MCIntegrationVI",
    "MCIntegrationSVI",
    "GibbsSampling",
    "HMCSampling",
    "Likelihood",
    "LogisticLikelihood",
    "GaussianLikelihood",
    "StudentTLikelihood",
    "LaplaceLikelihood",
    "Matern32Likelihood",
    "BayesianSVM",
    "PoissonLikelihood",
    "NegBinomialLikelihood",
    "MultiClassLikelihood",
    "LogisticSoftMaxLikelihood",
    "SoftMaxLikelihood",
    "make_augmented_likelihood",
    "HeteroscedasticLikelihood",
    "config",
    "inducing",
    "kernels",
    "SqExponentialKernel",
    "RBFKernel",
    "Matern12Kernel",
    "Matern32Kernel",
    "Matern52Kernel",
    "RationalQuadraticKernel",
    "CosineKernel",
    "PeriodicKernel",
    "LinearKernel",
    "PolynomialKernel",
    "ConstantKernel",
    "WhiteKernel",
    "ExponentiatedKernel",
    "PiecewisePolynomialKernel",
    "FBMKernel",
    "GaborKernel",
    "NeuralNetworkKernel",
    "TransformedKernel",
    "with_transform",
    "ScaleTransform",
    "ARDTransform",
    "LinearTransform",
    "SelectTransform",
    "FunctionTransform",
    "ChainTransform",
    "ZeroMean",
    "ConstantMean",
    "EmpiricalMean",
    "AffineMean",
    "robbins_monro",
    "alrsvi",
    "adam",
    "sgd",
    "hyper_step",
    "checkpoint",
]
