"""agp_tpu_torch: the PyTorch and CUDA port of agp_tpu.

Sparse variational GPs with augmented likelihoods, trained by closed-form
natural-gradient CAVI.  This package mirrors ``agp_tpu``'s module paths and
public names; it runs on the CPU (plain PyTorch) and on an NVIDIA Hopper
card, where the step's statistics pass is a hand-written CUDA kernel
(``ops/cuda_kernels.py``).  Ported so far: ``SVGP`` with the
squared-exponential kernel and the logistic, logistic-softmax (multiclass)
and heteroscedastic likelihoods, trained by stochastic CAVI with fixed
hyperparameters.
"""

from . import kernels
from .inference.config import AnalyticSVI, AnalyticVI
from .kernels import RBFKernel, SqExponentialKernel
from .likelihoods.base import Likelihood
from .likelihoods.classification import LogisticLikelihood
from .likelihoods.heteroscedastic import HeteroscedasticLikelihood
from .likelihoods.multiclass import LogisticSoftMaxLikelihood
from .means import ConstantMean, ZeroMean
from .models.svgp import SVGP
from .training.predictions import predict_f, predict_y, proba_y
from .training.state import TrainState
from .training.train import elbo, init_state, train
from .utils.opt import robbins_monro

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
    "LogisticSoftMaxLikelihood",
    "HeteroscedasticLikelihood",
    "kernels",
    "SqExponentialKernel",
    "RBFKernel",
    "ZeroMean",
    "ConstantMean",
    "robbins_monro",
]
