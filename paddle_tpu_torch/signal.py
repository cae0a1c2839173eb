"""paddle.signal (counterpart of paddle_tpu/signal.py): `frame`,
`overlap_add` (registered ops) and `stft` / `istft` built from them and
`fft`, as the reference builds its own.

As in the reference, a window shorter than n_fft is centre-padded to
n_fft, `center` pads the signal by n_fft // 2 on each side (`pad_mode`,
reflect by default), and istft divides by the overlap-added squared
window (the least-squares inverse) before it trims the centre padding.
"""
from __future__ import annotations

import torch

from .framework.dispatch import primitive

__all__ = ["frame", "overlap_add", "stft", "istft"]


@primitive("frame")
def _frame(x, frame_length, hop_length, axis=-1):
    """[..., n] -> [..., frame_length, num_frames], frame i starting at i
    hop_length."""
    if axis not in (-1, x.dim() - 1):
        raise NotImplementedError("frame: axis must be the last dim")
    return x.unfold(-1, frame_length, hop_length).transpose(-1, -2)


def frame(x, frame_length, hop_length, axis=-1, name=None):
    return _frame(x, frame_length=int(frame_length),
                  hop_length=int(hop_length), axis=axis)


@primitive("overlap_add")
def _overlap_add(x, hop_length, axis=-1):
    """[..., frame_length, num_frames] -> [..., (num - 1) hop + length],
    overlapping frames summed."""
    flen, num = x.shape[-2], x.shape[-1]
    seq = (num - 1) * hop_length + flen
    idx = (torch.arange(num, device=x.device)[:, None] * hop_length
           + torch.arange(flen, device=x.device)[None, :]).reshape(-1)
    flat = x.transpose(-1, -2).reshape(x.shape[:-2] + (num * flen,))
    out = torch.zeros(x.shape[:-2] + (seq,), dtype=x.dtype, device=x.device)
    return out.index_add(-1, idx, flat)


def overlap_add(x, hop_length, axis=-1, name=None):
    if axis not in (-1,):
        raise NotImplementedError("overlap_add: axis must be -1")
    return _overlap_add(x, hop_length=int(hop_length), axis=axis)


def _window(window, win_length, n_fft, device):
    """The window (ones where None) centre-padded to n_fft."""
    w = (torch.ones(win_length, dtype=torch.float32, device=device)
         if window is None else torch.as_tensor(window).to(device))
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        w = torch.nn.functional.pad(w, (lp, n_fft - win_length - lp))
    return w


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """[..., n] -> [..., n_fft // 2 + 1 (onesided) or n_fft, frames],
    complex: the framed, windowed signal's rfft (or fft)."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    x = torch.as_tensor(x)
    w = _window(window, win_length, n_fft, x.device)
    if center:
        pad = n_fft // 2
        shape = x.shape
        x = torch.nn.functional.pad(x.reshape((-1, 1) + shape[-1:]),
                                    (pad, pad), mode=pad_mode)
        x = x.reshape(shape[:-1] + x.shape[-1:])
    spec = (frame(x, n_fft, hop_length) * w[:, None]).transpose(-1, -2)
    from . import fft as _fft
    f = _fft.rfft(spec) if onesided else _fft.fft(spec)
    if normalized:
        f = f / torch.sqrt(torch.tensor(float(n_fft), dtype=f.real.dtype,
                                        device=f.device))
    return f.transpose(-1, -2)


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """The least-squares inverse of `stft`: each frame's inverse
    transform, windowed, overlap-added and divided by the overlap-added
    squared window (at least 1e-11)."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    x = torch.as_tensor(x)
    w = _window(window, win_length, n_fft, x.device)
    spec = x.transpose(-1, -2)
    if normalized:
        spec = spec * torch.sqrt(torch.tensor(float(n_fft),
                                              device=x.device))
    from . import fft as _fft
    if onesided:
        frames = _fft.irfft(spec, n=n_fft)
    else:
        frames = _fft.ifft(spec)
        if not return_complex:
            frames = frames.real
    frames = (frames * w[None, :]).transpose(-1, -2)
    if not frames.is_complex():
        frames = frames.float()
    y = overlap_add(frames, hop_length)
    num = frames.shape[-1]
    env = overlap_add((w * w)[:, None].expand(n_fft, num).float(),
                      hop_length)
    y = y / torch.clamp_min(env, 1e-11)
    if center:
        pad = n_fft // 2
        y = y[..., pad:y.shape[-1] - pad]
    if length is not None:
        y = y[..., :length]
    return y
