"""paddle.fft and paddle.signal of the port against the JAX package's, on
the CPU.

The 16 transforms at each norm on float32, float64, int64 and complex
inputs: dtypes exact (float32 -> complex64, float64 and int64 ->
complex128, as jnp.fft under x64), values within 1e-5 of the largest
|value| (1e-4 for the 2-D and n-D ones); with n / s and axes given;
fftfreq, rfftfreq and the shifts. frame / overlap_add through check_op
(values and the vjp). stft against the reference at centre padding,
reflect and constant pads, a window shorter than n_fft, normalized and
two-sided; istft against the reference and istft(stft(x)) within 1e-5 of
x; stft equal to torch.stft where both apply.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.framework.dispatch import OPS as JOPS

import paddle_tpu_torch as paddle
from paddle_tpu_torch import fft, signal
from paddle_tpu_torch.framework import place as pplace
from paddle_tpu_torch.framework.dispatch import OPS

import torch_ops_sweep as sw
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

ONE_D = ["fft", "ifft", "rfft", "irfft", "hfft", "ihfft"]
N_D = ["fft2", "ifft2", "rfft2", "irfft2", "fftn", "ifftn", "rfftn",
       "irfftn"]
REAL_IN = {"rfft", "ihfft", "rfft2", "rfftn"}


@pytest.fixture(autouse=True)
def on_cpu():
    saved = pplace._current_place
    paddle.set_device("cpu")
    yield
    pplace._current_place = saved


def _input(kind, shape=(4, 6)):
    rs = np.random.RandomState(0)
    if kind == "complex64":
        return (rs.randn(*shape) + 1j * rs.randn(*shape)).astype(
            np.complex64)
    if kind == "int64":
        return rs.randint(-5, 5, shape).astype(np.int64)
    return rs.randn(*shape).astype(kind)


def _close(got, want, tol):
    g, gn = sw._np(got)
    w, wn = sw._np(want)
    assert gn == wn, (gn, wn)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, atol=tol * max(1.0, np.abs(w).max()))


# a real-input transform takes no complex input in either package
CASES = [(op, kind) for op in ONE_D + N_D
         for kind in ("float32", "float64", "int64", "complex64")
         if not (op in REAL_IN and kind == "complex64")]


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
@pytest.mark.parametrize("op,kind", CASES)
def test_transform_dtypes_and_values(op, kind, norm):
    x = _input(kind)
    kw = {"norm": norm}
    got = OPS[op].fn(torch.from_numpy(x), **kw)
    want = JOPS[op].fn(jnp.asarray(x), **kw)
    _close(got, want, 1e-5 if op in ONE_D else 1e-4)


@pytest.mark.parametrize("op,kw", [
    ("fft", {"n": 8, "axis": 0}), ("irfft", {"n": 9}),
    ("hfft", {"n": 7, "axis": 0}), ("ifft", {"n": 4, "axis": 1}),
    ("fft2", {"s": (3, 8), "axes": (0, 1)}), ("rfftn", {"s": (5, 4)}),
    ("irfft2", {"s": (4, 10)}), ("fftn", {"axes": (1,)}),
    ("fftshift", {"axes": (1,)}), ("ifftshift", {}),
    ("fftshift", {})])
def test_transform_lengths_and_axes(op, kw):
    x = _input("float32" if op in REAL_IN else "complex64")
    got = OPS[op].fn(torch.from_numpy(x), **kw)
    want = JOPS[op].fn(jnp.asarray(x), **kw)
    _close(got, want, 1e-4)


def test_api_functions_and_frequencies():
    x = _input("float32")
    _close(fft.rfft(torch.from_numpy(x), n=10, axis=0),
           jpaddle.fft.rfft(jpaddle.to_tensor(x), n=10, axis=0).numpy(),
           1e-5)
    _close(fft.fft2(torch.from_numpy(x), axes=[0, 1]),
           jpaddle.fft.fft2(jpaddle.to_tensor(x), axes=[0, 1]).numpy(), 1e-4)
    _close(fft.fftshift(torch.from_numpy(x), axes=0),
           jpaddle.fft.fftshift(jpaddle.to_tensor(x), axes=0).numpy(), 0)
    for n, d in ((8, 1.0), (7, 0.25)):
        _close(fft.fftfreq(n, d, device="cpu"),
               jpaddle.fft.fftfreq(n, d).numpy(), 1e-7)
        _close(fft.rfftfreq(n, d, dtype="float64", device="cpu"),
               jpaddle.fft.rfftfreq(n, d, dtype="float64").numpy(), 1e-12)


@pytest.mark.parametrize("op", ["frame", "overlap_add"])
def test_frame_and_overlap_add(op):
    sw.check_op(op)
    x = np.random.RandomState(1).rand(2, 3, 20).astype(np.float32)
    got = signal.frame(torch.from_numpy(x), 6, 3)
    want = jpaddle.signal.frame(jpaddle.to_tensor(x), 6, 3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    back = signal.overlap_add(got, 3)
    jback = jpaddle.signal.overlap_add(want, 3)
    np.testing.assert_allclose(back.numpy(), jback.numpy(), rtol=1e-6)


STFT_CASES = [
    dict(n_fft=32, hop_length=8),
    dict(n_fft=32, hop_length=8, win_length=20, window="hann"),
    dict(n_fft=16, hop_length=4, center=False),
    dict(n_fft=16, hop_length=5, pad_mode="constant"),
    dict(n_fft=16, hop_length=4, normalized=True),
    dict(n_fft=16, hop_length=4, onesided=False),
]


def _window(case):
    case = dict(case)
    if case.pop("window", None) == "hann":
        w = np.hanning(case["win_length"]).astype(np.float32)
        return case, torch.from_numpy(w), jpaddle.to_tensor(w)
    return case, None, None


@pytest.mark.parametrize("case", STFT_CASES, ids=lambda c: "-".join(
    "%s%s" % kv for kv in c.items()))
def test_stft_and_istft_against_the_reference(case):
    x = np.random.RandomState(2).randn(2, 96).astype(np.float32)
    kw, w, jw = _window(case)
    got = signal.stft(torch.from_numpy(x), window=w, **kw)
    want = jpaddle.signal.stft(jpaddle.to_tensor(x), window=jw, **kw)
    _close(got, want.numpy(), 1e-5)
    ikw = {k: v for k, v in kw.items() if k != "pad_mode"}
    if kw.get("center", True):
        back = signal.istft(got, window=w, length=96, **ikw)
        jback = jpaddle.signal.istft(want, window=jw, length=96, **ikw)
        _close(back, jback.numpy(), 1e-5)
        if kw.get("onesided", True):     # the frames' span of x
            n = back.shape[-1]
            np.testing.assert_allclose(back.numpy(), x[:, :n], atol=1e-5)


def test_stft_equals_torch_stft_where_both_apply():
    x = torch.from_numpy(np.random.RandomState(3).randn(96).astype(
        np.float32))
    w = torch.hann_window(32)
    got = signal.stft(x, 32, 8, window=w)
    want = torch.stft(x, 32, 8, window=w, center=True, pad_mode="reflect",
                      return_complex=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_fft_ops_record_in_a_static_program():
    from paddle_tpu_torch import static
    x = _input("float32")
    prog = static.Program()
    paddle.enable_static()
    try:
        with static.program_guard(prog):
            xv = static.data("x", [4, 6], "float32")
            out = fft.irfft(fft.rfft(xv), n=6)
    finally:
        paddle.disable_static()
    assert [op.op_type for op in prog.ops] == ["rfft", "irfft"]
    (got,) = static.Executor("cpu").run(prog, feed={"x": x},
                                        fetch_list=[out])
    np.testing.assert_allclose(got, x, atol=1e-5)
