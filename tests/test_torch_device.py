"""Where the port's entry points put their inputs: an array without a
device (numpy, a list) goes to the package's default device, the CUDA
card unless the CPU was chosen, and raises when there is no card and no
such choice; a tensor stays where it is; train, elbo and the predictions
put arrays on the model's device, in its dtype."""
import numpy as np
import pytest
import torch

import agp_tpu_torch as agt
from agp_tpu_torch import config
from agp_tpu_torch.models.base import check_card_dtype


@pytest.fixture
def no_cuda(monkeypatch):
    """CUDA reported absent, and the default device restored afterwards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    previous = config.set_default_device("cuda")
    yield
    config.set_default_device(previous)


def data(n=512, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, d))
    return X, np.where(np.sin(2 * X[:, 0]) + 0.5 * X[:, 1] > 0, 1.0, -1.0)


def create(Z):
    return agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticSVI(64), Z,
                           optimiser=None)


def test_numpy_input_raises_without_a_card_unless_the_cpu_was_chosen(no_cuda):
    X, y = data()
    with pytest.raises(RuntimeError, match="set_default_device"):
        create(X[:32])
    with pytest.raises(RuntimeError, match="set_default_device"):
        create(X[:32].tolist())
    assert config.set_default_device("cpu") == torch.device("cuda")
    model = create(X[:32])
    assert model.Z.device.type == "cpu" and model.Z.dtype == torch.get_default_dtype()
    model, state = agt.train(model, X, y, iterations=60, generator=torch.Generator().manual_seed(0))
    assert state.mu.device.type == "cpu" and int(state.step) == 60
    acc = float(((agt.predict_y(model, state, X) > 0).numpy() == (y > 0)).mean())
    assert acc > 0.85
    mu, var = agt.predict_f(model, state, X[:5], cov=True)
    assert mu.shape == var.shape == (5,) and mu.dtype == model.Z.dtype
    assert torch.isfinite(agt.elbo(model, state, X[:64], y[:64]))


def test_tensors_stay_where_they_are(no_cuda):
    """A CPU tensor is an explicit choice: no default device is consulted,
    and arrays given with it follow the model (device and float64)."""
    X, y = data()
    model = create(torch.as_tensor(X[:32]))
    assert model.Z.device.type == "cpu" and model.Z.dtype == torch.float64
    model, state = agt.train(model, X.astype(np.float32), y, iterations=5)
    assert state.mu.dtype == torch.float64
    assert agt.predict_f(model, state, X[:3].tolist()).dtype == torch.float64
    assert agt.proba_y(model, state, X[:3]).dtype == torch.float64


def test_set_default_device_takes_cuda_or_cpu():
    with pytest.raises(ValueError, match="cuda' or 'cpu"):
        config.set_default_device("meta")
    previous = config.set_default_device("cpu")
    try:
        assert config.default_device() == torch.device("cpu")
    finally:
        config.set_default_device(previous)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_card_refuses_what_its_kernels_do_not_take(dtype):
    """The rule that SVGP.create and init_state apply, checked without a
    card: float32 and float64 on a CUDA device pass (float64 takes kernels
    4-7's float64 form, or no kernel); a model or data in float16 there
    raises TypeError, whose message names float32, float64 and
    set_default_device("cpu"); any dtype on the CPU passes."""
    if dtype == torch.float64:
        check_card_dtype(torch.device("cuda"), dtype)
        check_card_dtype("cuda:0", dtype, "data")
    else:
        with pytest.raises(TypeError, match=r'float32 or float64 on the card.*set_default_device\("cpu"\)'):
            check_card_dtype(torch.device("cuda"), dtype)
        with pytest.raises(TypeError, match="data"):
            check_card_dtype("cuda:0", dtype, "data")
    check_card_dtype(torch.device("cuda:0"), torch.float32)
    check_card_dtype(torch.device("cpu"), dtype)


def test_float64_model_on_the_cpu_is_not_refused():
    """A model cast to float64 after it was built passes init_state's
    check on the CPU and trains."""
    X, y = data()
    model = create(torch.as_tensor(X[:32], dtype=torch.float32)).to(dtype=torch.float64)
    X64 = torch.as_tensor(X)
    state = agt.init_state(model, X64, torch.as_tensor(y))
    assert state.mu.dtype == torch.float64
    model, state = agt.train(model, X64, y, iterations=5, state=state)
    assert torch.isfinite(state.mu).all()
