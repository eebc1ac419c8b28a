"""Shared norm + activation layer.

Counterpart of ``chainermn_tpu/models/_norm.py``.  Every BatchNorm ->
(+ residual) -> relu interlude goes through :func:`norm_act`, and ONE
switch, ``fused=``, selects between:

- ``fused=False``: the ``flax.linen.BatchNorm`` + add + relu composition
  written as plain PyTorch ops -- the numerics oracle.  (Not
  ``nn.BatchNorm2d`` / ``F.batch_norm``: their ``momentum`` weighs the
  NEW statistic and their running variance is unbiased, either of which
  breaks parity with flax.)
- ``fused=True``: :func:`chainermn_tpu_torch.ops.batch_norm_act`, which
  launches the hand-written stats and apply kernels on CUDA tensors.

Both paths use the same parameters (``scale``, ``bias``) and buffers
(``mean``, ``var``), so :class:`NormAct` is interchangeable between them.
Running averages update as ``ra = momentum * ra + (1 - momentum) *
batch`` with the BIASED fast variance, as flax does.
"""

import torch
from torch import nn

from chainermn_tpu_torch.ops.batch_norm_act import (
    batch_norm_act, batch_norm_act_inference)


def _flax_batch_norm(x, scale, bias, eps, residual, relu):
    """flax ``BatchNorm`` (train mode) + add + relu as plain PyTorch ops;
    returns ``(out, batch_mean, batch_var)``."""
    xf = x.float()
    dims = tuple(range(x.dim() - 1))
    mean = xf.mean(dims)
    var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * scale.float()) \
        + bias.float()
    y = y.to(x.dtype)
    if residual is not None:
        y = y + residual
    return (torch.relu(y) if relu else y), mean, var


def _flax_batch_norm_inference(x, scale, bias, mean, var, eps, residual,
                               relu):
    y = (x.float() - mean) * (torch.rsqrt(var + eps) * scale.float()) \
        + bias.float()
    y = y.to(x.dtype)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def norm_act(x, scale, bias, running_mean, running_var, *, train, fused,
             residual=None, relu=True, momentum=0.9, epsilon=1e-5):
    """Normalize ``x`` (``(..., C)``, C last) with batch statistics
    (``train=True``, updating ``running_mean`` / ``running_var`` in
    place) or running statistics (``train=False``), then add
    ``residual`` and apply relu."""
    if not train:
        if fused:
            return batch_norm_act_inference(
                x, scale, bias, running_mean, running_var, eps=epsilon,
                residual=residual, relu=relu)
        return _flax_batch_norm_inference(
            x, scale, bias, running_mean, running_var, epsilon, residual,
            relu)
    if fused:
        out, mean, var = batch_norm_act(x, scale, bias, eps=epsilon,
                                        residual=residual, relu=relu)
    else:
        out, mean, var = _flax_batch_norm(x, scale, bias, epsilon,
                                          residual, relu)
    with torch.no_grad():
        m = momentum
        running_mean.copy_(m * running_mean + (1.0 - m) * mean)
        running_var.copy_(m * running_var + (1.0 - m) * var)
    return out


class NormAct(nn.Module):
    """BatchNorm (+ residual add) (+ relu) over the last axis.

    The counterpart of both ``NormAct`` and the ``nn.BatchNorm`` it
    replaces in the JAX package: parameters ``scale`` / ``bias`` (f32),
    buffers ``mean`` / ``var`` (f32).  ``self.training`` selects batch
    or running statistics; ``fused`` selects the kernel path or the
    flax oracle.
    """

    def __init__(self, features, relu=True, fused=True, momentum=0.9,
                 epsilon=1e-5, scale_init=1.0):
        super().__init__()
        self.relu = relu
        self.fused = fused
        self.momentum = momentum
        self.epsilon = epsilon
        kw = dict(dtype=torch.float32)
        self.scale = nn.Parameter(torch.full((features,), float(scale_init),
                                             **kw))
        self.bias = nn.Parameter(torch.zeros((features,), **kw))
        self.register_buffer('mean', torch.zeros((features,), **kw))
        self.register_buffer('var', torch.ones((features,), **kw))

    def forward(self, x, residual=None):
        return norm_act(x, self.scale, self.bias, self.mean, self.var,
                        train=self.training, fused=self.fused,
                        residual=residual, relu=self.relu,
                        momentum=self.momentum, epsilon=self.epsilon)
