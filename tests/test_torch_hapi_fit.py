"""`Model.fit`'s per-step losses, the port's against the JAX package's, on
the CPU: tests/test_torch_hapi.py's setups (a tiny GPT and LeNet, 2
epochs each, with `prepare(jit=True)` and `jit=False` on both sides;
ResNet-18 at B=2, 64x64, 3 steps, jit) and tolerances (that file's
docstring sets them out). A file of its own so that pytest-xdist, which
runs the files with the most tests first, runs these long cases beside
the other files' last ones.
"""
import numpy as np
import pytest

from test_torch_hapi import ATOL, RESNET_TOL, RTOL, SETUPS, _fit_both
import torch_threads  # noqa: F401  (one intra-op thread a worker)


@pytest.mark.parametrize("name,jit", [("gpt", True), ("gpt", False),
                                      ("lenet", True), ("lenet", False),
                                      ("resnet18", True)])
def test_fit_losses_match_the_reference(name, jit):
    jm, tm, data, bs = SETUPS[name](jit)
    # ResNet-18: test_torch_resnet.py's three float32 steps (its batch
    # norms amplify rounding step by step)
    epochs = 1 if name == "resnet18" else 2
    want, got = _fit_both(jm, tm, data, bs, epochs=epochs)
    assert len(got) == len(want) == epochs * len(data) // bs
    assert np.isfinite(got).all()
    if name == "resnet18":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RESNET_TOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if jit:
        assert tm._train_step_fn.compiles == 1
