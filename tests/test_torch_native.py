"""PyTorch port: the native C++ dual-number library's bindings
(`hank_tpu_torch/utils/native.py`) against `torch.func.grad` and against
`hank_tpu.utils.native`, mirroring `tests/test_native.py`. The port builds
its own copy of `native/` into `hank_tpu_torch/_build/` and writes nothing
into `native/`.
"""

import math
import os
import shutil

import numpy as np
import pytest
import torch

from hank_tpu_torch.utils import native

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib():
    if shutil.which(os.environ.get("CXX") or "g++") is None:
        pytest.skip("no g++ to build the native library with")
    return native.load()


def _torch_function(which):
    if which == "rosenbrock":
        def f(v):
            return torch.sum((1 - v[:-1]) ** 2 + 100.0 * (v[1:] - v[:-1] ** 2) ** 2)
    else:
        def f(v):
            n = v.shape[0]
            return (-20.0 * torch.exp(-0.2 * torch.sqrt(torch.sum(v ** 2) / n))
                    - torch.exp(torch.sum(torch.cos(2 * math.pi * v)) / n) + 20.0 + math.e)
    return f


@pytest.mark.parametrize("which", ["ackley", "rosenbrock"])
@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_native_gradient_matches_torch_and_the_jax_package(lib, which, chunk):
    from hank_tpu.utils import native as jnative

    x = np.random.default_rng(0).uniform(-1.0, 1.0, size=37)
    f = _torch_function(which)
    xt = torch.tensor(x, dtype=torch.float64)
    assert abs(native.value(which, x) - float(f(xt))) < 1e-10
    g = native.gradient(which, x, chunk=chunk)
    assert np.max(np.abs(g - torch.func.grad(f)(xt).numpy())) <= 1e-9
    # Two builds of one source (-march=native on their own hosts): to roundoff.
    assert abs(native.value(which, x) - jnative.value(which, x)) <= 1e-12
    assert np.max(np.abs(g - jnative.gradient(which, x, chunk=chunk))) <= 1e-12


def test_native_bench_runs_and_builds_outside_native(lib):
    s = native.bench("rosenbrock", chunk=8, n=100, iters=10)
    assert 0 < s < 1.0
    path = native.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native.BUILD_DIR != native.NATIVE_DIR
    with pytest.raises(ValueError):
        native.gradient("rosenbrock", np.zeros(4), chunk=3)
