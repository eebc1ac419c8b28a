"""Layers of the conv zoo, in flax's conventions, on NHWC tensors.

Counterpart of the ``flax.linen`` layers the JAX package's zoo uses
(``nn.Conv``, ``nn.Dense``, ``nn.max_pool``, ``nn.avg_pool``,
``nn.Dropout``).  Activations are NHWC tensors; permuted to NCHW they
are ``torch.channels_last`` tensors, which is what the convolutions take
and give.  Parameters are f32 masters, cast to the compute ``dtype`` in
the forward, as flax does with ``dtype=``.

Padding: flax's ``SAME`` pads a strided layer asymmetrically (a 3x3/2 at
an even size pads (0, 1)) and PyTorch's ``padding=`` is symmetric, so
such layers get an explicit ``F.pad`` first; an integer padding is
symmetric in both; ``VALID`` pads nothing.  ``max_pool`` pads with
``-inf``; ``avg_pool`` pads with zeros and divides by the whole window
(flax's ``count_include_pad=True``).
"""

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size, kernel, stride):
    """flax/XLA ``SAME`` padding ``(lo, hi)`` of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def flax_pads(padding, sizes, kernel, stride):
    """``((top, bottom), (left, right))`` of a flax ``padding`` (``'SAME'``,
    ``'VALID'`` or an int) over the spatial ``sizes``."""
    if padding == 'SAME':
        return tuple(same_pads(s, kernel, stride) for s in sizes)
    if padding == 'VALID':
        return ((0, 0), (0, 0))
    p = int(padding)
    return ((p, p), (p, p))


def out_size(size, kernel, stride, padding):
    """The spatial size after a flax conv or pool."""
    lo, hi = flax_pads(padding, (size,), kernel, stride)[0]
    return max(0, (size + lo + hi - kernel) // stride + 1)


def _lecun_normal_(w, fan_in, generator):
    """flax's default kernel init: truncated normal at +-2 std, variance
    1 / fan_in (an empty kernel stays empty)."""
    if w.numel() == 0:
        return w
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC tensors: the weight is an f32 OIHW
    channels_last master and the optional ``bias`` (zeros, flax's
    ``use_bias``) an f32 vector, both cast to ``dtype``."""

    def __init__(self, in_features, features, kernel, stride=1,
                 dtype=torch.bfloat16, generator=None, padding='SAME',
                 use_bias=False):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.dtype = dtype
        self.padding = padding
        w = torch.empty((features, in_features, kernel, kernel))
        _lecun_normal_(w, in_features * kernel * kernel, generator)
        self.weight = nn.Parameter(
            w.contiguous(memory_format=torch.channels_last))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x):
        xc = x.permute(0, 3, 1, 2).to(self.dtype)
        (ht, hb), (wl, wr) = flax_pads(self.padding, xc.shape[2:],
                                       self.kernel, self.stride)
        if ht == hb and wl == wr:
            pad = (ht, wl)
        else:
            xc = F.pad(xc, (wl, wr, ht, hb))
            pad = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(xc, self.weight.to(self.dtype), bias,
                     stride=self.stride, padding=pad)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` ``(out, in)`` (the flax kernel
    transposed) and ``bias``, f32, cast to ``dtype`` with the input."""

    def __init__(self, in_features, features, dtype=torch.bfloat16,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        w = torch.empty((features, in_features))
        self.weight = nn.Parameter(_lecun_normal_(w, in_features, generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def _pool(x, kernel, stride, padding, value, fn):
    xc = x.permute(0, 3, 1, 2)
    (ht, hb), (wl, wr) = flax_pads(padding, xc.shape[2:], kernel, stride)
    if ht or hb or wl or wr:
        xc = F.pad(xc, (wl, wr, ht, hb), value=value)
    if xc.shape[2] < kernel or xc.shape[3] < kernel:
        # the window exceeds the input: flax gives an empty map
        b, c = xc.shape[:2]
        return x.new_zeros((b, 0, 0, c))
    return fn(xc, kernel, stride).permute(0, 2, 3, 1)


def max_pool(x, kernel, stride, padding='VALID'):
    """``nn.max_pool(x, (k, k), strides=(s, s), padding=...)``."""
    return _pool(x, kernel, stride, padding, float('-inf'), F.max_pool2d)


def max_pool_same(x, kernel=3, stride=2):
    """``nn.max_pool(x, (k, k), strides=(s, s), padding='SAME')``."""
    return max_pool(x, kernel, stride, 'SAME')


def avg_pool(x, kernel, stride, padding='VALID'):
    """``nn.avg_pool(x, (k, k), strides=(s, s), padding=...)``: zero
    padding counted in the window's divisor."""
    return _pool(x, kernel, stride, padding, 0.0, F.avg_pool2d)


def global_mean(x, dtype):
    """``jnp.mean(x, axis=(1, 2))`` of an NHWC tensor: accumulated in
    f32, rounded to ``dtype``."""
    return x.float().mean((1, 2)).to(dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; in eval
    mode the identity.  The mask comes from ``torch.bernoulli`` on
    ``generator``: the one the updater owns and seeds per rank and per
    iteration (:func:`set_dropout_generator`), else one seeded 0 on the
    input's device."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        if self.generator is None or self.generator.device != x.device:
            self.generator = torch.Generator(x.device).manual_seed(0)
        mask = torch.empty(x.shape, dtype=torch.float32,
                           device=x.device).bernoulli_(
                               keep, generator=self.generator)
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def set_dropout_generator(model, generator):
    """Point every :class:`Dropout` of ``model`` at ``generator``;
    returns how many there are."""
    layers = [m for m in model.modules() if isinstance(m, Dropout)]
    for m in layers:
        m.generator = generator
    return len(layers)


@contextlib.contextmanager
def replaying(generator, state):
    """Within: ``generator`` draws from ``state`` again; after: it goes
    on from where it was.  A remat recompute replays the forward's
    dropout masks so (``torch.utils.checkpoint`` saves and restores only
    the default generators, not this one).  ``generator=None``: no-op."""
    if generator is None:
        yield
        return
    now = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(now)
