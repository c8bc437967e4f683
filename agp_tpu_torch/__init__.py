"""agp_tpu_torch: the PyTorch and CUDA port of agp_tpu.

Sparse variational GPs with augmented likelihoods, trained by closed-form
natural-gradient CAVI.  This package mirrors ``agp_tpu``'s module paths and
public names; it runs on the CPU (plain PyTorch) and on an NVIDIA Hopper
card, where the step's statistics are hand-written CUDA kernels
(``ops/cuda_kernels.py``): one fused pass while the model's inducing set
fits a block's shared memory (M <= 128), else a split pair of kernels
around the likelihood's own E-step (M up to 2,392): the single-latent one
or the batched one.  Ported so far: ``SVGP`` with the squared-exponential
and Matern 1/2, 3/2, 5/2 kernels and the logistic, Gaussian (fixed noise),
Student-t, Laplace, Matern-3/2 noise, Bayesian SVM, Poisson, negative
binomial, logistic-softmax (multiclass) and heteroscedastic likelihoods,
trained by stochastic CAVI, with the hyperparameter step interleaved
(Adam(0.01) on the kernel and the mean by default, optionally on the
inducing points) or with fixed hyperparameters.  Inputs without a device
(numpy arrays, lists) go to the CUDA card unless
``config.set_default_device("cpu")`` was called.
"""

from . import config, kernels
from .inference.config import AnalyticSVI, AnalyticVI
from .kernels import Matern12Kernel, Matern32Kernel, Matern52Kernel, RBFKernel, SqExponentialKernel
from .likelihoods.base import Likelihood
from .likelihoods.classification import BayesianSVM, LogisticLikelihood
from .likelihoods.event import NegBinomialLikelihood, PoissonLikelihood
from .likelihoods.heteroscedastic import HeteroscedasticLikelihood
from .likelihoods.multiclass import LogisticSoftMaxLikelihood
from .likelihoods.regression import GaussianLikelihood, LaplaceLikelihood, Matern32Likelihood, StudentTLikelihood
from .means import ConstantMean, ZeroMean
from .models.svgp import SVGP
from .training.predictions import predict_f, predict_y, proba_y
from .training.autotuning import hyper_step
from .training.state import TrainState
from .training.train import elbo, init_state, train
from .utils.opt import adam, robbins_monro

ELBO = elbo

__all__ = [
    "SVGP",
    "train",
    "elbo",
    "ELBO",
    "init_state",
    "predict_f",
    "predict_y",
    "proba_y",
    "TrainState",
    "AnalyticVI",
    "AnalyticSVI",
    "Likelihood",
    "LogisticLikelihood",
    "GaussianLikelihood",
    "StudentTLikelihood",
    "LaplaceLikelihood",
    "Matern32Likelihood",
    "BayesianSVM",
    "PoissonLikelihood",
    "NegBinomialLikelihood",
    "LogisticSoftMaxLikelihood",
    "HeteroscedasticLikelihood",
    "config",
    "kernels",
    "SqExponentialKernel",
    "RBFKernel",
    "Matern12Kernel",
    "Matern32Kernel",
    "Matern52Kernel",
    "ZeroMean",
    "ConstantMean",
    "robbins_monro",
    "adam",
    "hyper_step",
]
