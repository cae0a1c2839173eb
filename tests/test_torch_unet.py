"""The improved-DDPM CIFAR-10 UNet of chip_smoke.py phase 26 against the
same architecture built on the JAX package, on the CPU.

`chip_smoke.unet_model` (the port's public API) and `_junet` below (the
reference's) build improved-diffusion's UNetModel; `models.convert`
carries the reference's weights into the port's. At the reduced depth of
phase 26 (c) (`chip_smoke.UNET_SMALL`: 64 channels, channel_mult (1, 2),
one res block, attention at 16x16 with 4 heads of 32; the zero-initialised
convolutions drawn like the others so that every parameter has a
gradient), in float32 at B=2 on 32x32 images: one forward, the L_simple
loss, step 1's gradients and the parameters after one AdamW step through
each package's make_train_step. Tolerances: the output and the loss
within 1e-4 of their largest |value| (float32 sums over up to 2304 taps
and 256 keys in another order), each parameter's gradient within 1e-3 of
its largest |value| (a GroupNorm's gradient cancels its sums, which
amplifies the rounding; the same bound phase 26 (c) puts on the card's
kernels against their plain versions, there on the norm), the parameters
after the step within 1e-4 of their largest |value|, at least 1 (a bias
that starts at 0 moves by about lr = 1e-4, Adam's normalised step: phase
26 (c)'s absolute 1e-4), and each tensor's update (after less before)
within 1e-2 of its norm (Adam's first step is about lr * sign(g), so an
update left out is off by its whole norm; rounding moves only the
elements whose gradient is near Adam's epsilon).
The full-width configuration's counts (52,542,979 parameters in 446
tensors, 8.383 GMAC an image's forward, 76 GroupNorms, 30 ResBlocks, 15
attention blocks) are held without running it.
"""
import math

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu as jp
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit.engine import make_train_step as jmake_train_step
import paddle_tpu_torch as pp
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.framework import place as pplace
from paddle_tpu_torch.jit import make_train_step
from paddle_tpu_torch.models import (export_reference_state,
                                     load_reference_state)
from paddle_tpu_torch.nn import functional as F
import torch_threads  # noqa: F401,E402  (one intra-op thread a worker)

jax.config.update("jax_platforms", "cpu")

TOL, GRAD_TOL, UPDATE_TOL = 1e-4, 1e-3, 1e-2
B = 2


@pytest.fixture(autouse=True)
def cpu_place():
    saved = pplace._current_place
    pp.set_device("cpu")
    yield
    pplace._current_place = saved


def _junet(channels, channel_mult, num_res_blocks, attention_ds, num_heads,
           dropout, zero_init, in_channels=3, out_channels=3):
    """The reference's twin of chip_smoke.unet_model."""
    zero = (jnn.ParamAttr(initializer=jnn.initializer.Constant(0.0))
            if zero_init else None)

    def conv(cin, cout, k, stride=1, last=False, dims=2):
        cls = jnn.Conv2D if dims == 2 else jnn.Conv1D
        attr = zero if last else None
        return cls(cin, cout, k, stride=stride, padding=k // 2,
                   weight_attr=attr, bias_attr=attr)

    class Norm(jnn.GroupNorm):
        def forward(self, x):
            return jp.cast(super().forward(jp.cast(x, "float32")), x.dtype)

    class ResBlock(jnn.Layer):
        def __init__(self, cin, cout, emb):
            super().__init__()
            self.in_norm = Norm(32, cin)
            self.in_conv = conv(cin, cout, 3)
            self.emb = jnn.Linear(emb, 2 * cout)
            self.out_norm = Norm(32, cout)
            self.drop = jnn.Dropout(dropout)
            self.out_conv = conv(cout, cout, 3, last=True)
            self.skip = (jnn.Identity() if cin == cout
                         else conv(cin, cout, 1))

        def forward(self, x, emb):
            h = self.in_conv(JF.silu(self.in_norm(x)))
            e = jp.cast(self.emb(JF.silu(emb)), h.dtype)
            scale, shift = jp.chunk(e[:, :, None, None], 2, axis=1)
            h = self.out_norm(h) * (1 + scale) + shift
            h = self.out_conv(self.drop(JF.silu(h)))
            return self.skip(x) + h

    class AttentionBlock(jnn.Layer):
        def __init__(self, c):
            super().__init__()
            self.norm = Norm(32, c)
            self.qkv = conv(c, 3 * c, 1, dims=1)
            self.proj = conv(c, c, 1, last=True, dims=1)

        def forward(self, x):
            Bx, C, H, W = x.shape
            T = H * W
            h = self.qkv(self.norm(jp.reshape(x, [Bx, C, T])))
            h = jp.reshape(jp.transpose(h, [0, 2, 1]),
                           [Bx, T, num_heads, 3, C // num_heads])
            q, k, v = (jp.transpose(h[:, :, :, i], [0, 2, 1, 3])
                       for i in range(3))
            a, _ = JF.scaled_dot_product_attention(q, k, v)
            a = jp.transpose(jp.reshape(jp.transpose(a, [0, 2, 1, 3]),
                                        [Bx, T, C]), [0, 2, 1])
            return x + jp.reshape(self.proj(a), [Bx, C, H, W])

    class Up(jnn.Layer):
        def __init__(self, c):
            super().__init__()
            self.up = jnn.Upsample(scale_factor=2, mode="nearest")
            self.conv = conv(c, c, 3)

        def forward(self, x):
            return self.conv(self.up(x))

    class Step(jnn.LayerList):
        def forward(self, x, emb):
            for layer in self:
                x = layer(x, emb) if isinstance(layer, ResBlock) \
                    else layer(x)
            return x

    class UNet(jnn.Layer):
        def __init__(self):
            super().__init__()
            emb = 4 * channels
            self.time_in = jnn.Linear(channels, emb)
            self.time_out = jnn.Linear(emb, emb)
            self.inputs = jnn.LayerList([Step([conv(in_channels, channels,
                                                    3)])])
            chans, ch, ds = [channels], channels, 1
            for level, mult in enumerate(channel_mult):
                for _ in range(num_res_blocks):
                    layers = [ResBlock(ch, mult * channels, emb)]
                    ch = mult * channels
                    if ds in attention_ds:
                        layers.append(AttentionBlock(ch))
                    self.inputs.append(Step(layers))
                    chans.append(ch)
                if level != len(channel_mult) - 1:
                    self.inputs.append(Step([conv(ch, ch, 3, stride=2)]))
                    chans.append(ch)
                    ds *= 2
            self.middle = Step([ResBlock(ch, ch, emb), AttentionBlock(ch),
                                ResBlock(ch, ch, emb)])
            self.outputs = jnn.LayerList()
            for level, mult in list(enumerate(channel_mult))[::-1]:
                for i in range(num_res_blocks + 1):
                    layers = [ResBlock(ch + chans.pop(), channels * mult,
                                       emb)]
                    ch = channels * mult
                    if ds in attention_ds:
                        layers.append(AttentionBlock(ch))
                    if level and i == num_res_blocks:
                        layers.append(Up(ch))
                        ds //= 2
                    self.outputs.append(Step(layers))
            self.out_norm = Norm(32, ch)
            self.out_conv = conv(channels, out_channels, 3, last=True)

        def forward(self, x, t):
            half = channels // 2
            freqs = jp.exp(jp.arange(0, half, dtype="float32")
                           * (-math.log(10000.0) / half))
            args = jp.unsqueeze(jp.cast(t, "float32"), 1) \
                * jp.unsqueeze(freqs, 0)
            emb = jp.concat([jp.cos(args), jp.sin(args)], axis=-1)
            emb = self.time_out(JF.silu(self.time_in(emb)))
            hs = []
            h = x
            for block in self.inputs:
                h = block(h, emb)
                hs.append(h)
            h = self.middle(h, emb)
            for block in self.outputs:
                h = block(jp.concat([h, hs.pop()], axis=1), emb)
            return self.out_conv(JF.silu(self.out_norm(h)))

    return UNet()


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t.numpy())


def _rel(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), np.finfo(np.float32).tiny)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * scale, (what, err, scale)


def _pair():
    jp.seed(7)
    ref = _junet(**chip_smoke.UNET_SMALL)
    port = chip_smoke.unet_model(device="cpu", **chip_smoke.UNET_SMALL)
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    load_reference_state(port, state)
    assert [n for n, _ in port.named_parameters()] == [
        n for n, _ in ref.named_parameters()]
    return ref, port


def _batch(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, 3, 32, 32).astype(np.float32)
    eps = rs.randn(B, 3, 32, 32).astype(np.float32)
    t = rs.randint(0, chip_smoke.UNET_DIFFUSION_STEPS, (B,)).astype(np.int64)
    return x, t, eps


def test_reduced_unet_forward_loss_and_gradients():
    ref, port = _pair()
    x, t, eps = _batch(0)
    jo = ref(jp.to_tensor(x), jp.to_tensor(t))
    po = port(torch.from_numpy(x), torch.from_numpy(t))
    _rel(_np(po), _np(jo), TOL, "output")
    jl = chip_smoke.unet_loss(JF, jo, jp.to_tensor(eps))
    pl = chip_smoke.unet_loss(F, po, torch.from_numpy(eps))
    _rel(_np(pl), _np(jl), TOL, "loss")
    jl.backward()
    pl.backward()
    jparams = dict(ref.named_parameters())
    for name, p in port.named_parameters():
        g = _np(jparams[name].grad)
        assert np.abs(g).max() > 0, name
        _rel(_np(p.grad), g, GRAD_TOL, name)


def test_reduced_unet_one_adamw_step_through_make_train_step():
    """One AdamW(1e-4, weight_decay 0) step through each package's
    make_train_step: the loss and every parameter after it."""
    ref, port = _pair()
    before = {k: np.array(v.numpy(), np.float64)
              for k, v in ref.state_dict().items()}
    x, t, eps = _batch(1)
    jstep = jmake_train_step(
        ref, lambda o, e: chip_smoke.unet_loss(JF, o, e),
        jopt.AdamW(learning_rate=1e-4, weight_decay=0.0,
                   parameters=ref.parameters()))
    pstep = make_train_step(
        port, lambda o, e: chip_smoke.unet_loss(F, o, e),
        optimizer.AdamW(learning_rate=1e-4, weight_decay=0.0,
                        parameters=port.parameters()), device="cpu")
    jloss, _ = jstep([jp.to_tensor(x), jp.to_tensor(t)], [jp.to_tensor(eps)])
    ploss, _ = pstep([torch.from_numpy(x), torch.from_numpy(t)],
                     [torch.from_numpy(eps)])
    _rel(_np(ploss), _np(jloss), TOL, "loss")
    want = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    got = export_reference_state(port)
    for name in want:
        err = np.abs(got[name].astype(np.float64) - want[name]).max()
        assert err <= TOL * max(1.0, np.abs(want[name]).max()), (name, err)
        # the update itself: a step left out or mis-scaled is off by the
        # whole update, while rounding moves only the few elements whose
        # gradient is near Adam's epsilon
        dwant = want[name] - before[name]
        dgot = got[name].astype(np.float64) - before[name]
        norm = np.linalg.norm(dwant)
        assert norm > 0, name
        assert np.linalg.norm(dgot - dwant) <= UPDATE_TOL * norm, (
            name, np.linalg.norm(dgot - dwant) / norm)


def test_full_width_configuration_counts():
    """The CIFAR-10 configuration's parameters, tensors and blocks, and its
    FLOPs from the shapes (chip_smoke.unet_flops), without training it."""
    model = chip_smoke.unet_model(device="cpu")
    kinds = [type(m).__name__ for m in model.modules()]
    assert sum(p.numel() for p in model.parameters()) == \
        chip_smoke.UNET_PARAMS == 52542979
    assert len(list(model.parameters())) == chip_smoke.UNET_TENSORS == 446
    assert (kinds.count("Norm"), kinds.count("ResBlock"),
            kinds.count("AttentionBlock")) == (76, 30, 15)
    flops, macs = chip_smoke.unet_flops(torch, model, chip_smoke.UNET_B)
    assert abs(macs / 1e9 - 8.383) < 1e-3
    assert abs(flops / 1e12 - 6.438) < 1e-3


def test_cosine_schedule_and_the_batches():
    """improved DDPM's cosine abar (its betas clipped at 0.999) and the
    batch maker: x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) eps, t in [0,
    4000), x0 in [-1, 1]."""
    abar = chip_smoke.cosine_alphas_cumprod()
    f = lambda t: math.cos((t / 4000 + 0.008) / 1.008 * math.pi / 2) ** 2  # noqa
    assert abar.shape == (4000,) and np.all(np.diff(abar) < 0)
    np.testing.assert_allclose(abar[:100], [f(i + 1) / f(0)
                                            for i in range(100)], rtol=1e-9)
    batch = chip_smoke.unet_batches(torch, n_pool=16, B=4, device="cpu")
    (xt, t), (eps,) = batch()
    assert xt.shape == eps.shape == (4, 3, 32, 32) and t.shape == (4,)
    assert int(t.min()) >= 0 and int(t.max()) < 4000
    a = torch.from_numpy(abar).float()[t][:, None, None, None]
    x0 = (xt - (1 - a).sqrt() * eps) / a.sqrt()
    assert float(x0.abs().max()) <= 1.0 + 1e-3
