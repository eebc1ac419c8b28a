"""GoogLeNet / Inception-v1 (the reference's
``examples/imagenet/models_v2/googlenet.py``, insize 224, with its two
auxiliary heads, weighted 0.3 by ``StatefulClassifier``).

Counterpart of ``chainermn_tpu/models/googlenet.py``: convs with bias
and relu, no norm.  In train mode the model returns ``(logits, (aux1,
aux2))``, in eval mode the logits alone (the heads are skipped: flax
computes them and drops them).  An auxiliary head's 5x5/3 average pool
finds a map smaller than its window below about 96 px (the JAX script's
``--quick`` size is 64): flax then gives an empty map, ``Dense_0`` has
no input features and the head's logits are its biases; the port does
the same.
"""

import torch
from torch import nn

from chainermn_tpu_torch.models._layers import (
    Conv, Dense, Dropout, avg_pool, global_mean, max_pool_same, out_size)
from chainermn_tpu_torch.ops._common import resolve_device


class Inception(nn.Module):
    """1x1 / 3x3 / 5x5 / pool-projection branches, each conv with relu."""

    def __init__(self, in_features, n1, n3r, n3, n5r, n5, proj,
                 dtype=torch.bfloat16, generator=None):
        super().__init__()
        conv = dict(dtype=dtype, generator=generator, use_bias=True)
        self.Conv_0 = Conv(in_features, n1, 1, **conv)
        self.Conv_1 = Conv(in_features, n3r, 1, **conv)
        self.Conv_2 = Conv(n3r, n3, 3, padding=1, **conv)
        self.Conv_3 = Conv(in_features, n5r, 1, **conv)
        self.Conv_4 = Conv(n5r, n5, 5, padding=2, **conv)
        self.Conv_5 = Conv(in_features, proj, 1, **conv)
        self.out_features = n1 + n3 + n5 + proj

    def forward(self, x):
        b1 = torch.relu(self.Conv_0(x))
        b3 = torch.relu(self.Conv_2(torch.relu(self.Conv_1(x))))
        b5 = torch.relu(self.Conv_4(torch.relu(self.Conv_3(x))))
        bp = torch.relu(self.Conv_5(max_pool_same(x, 3, 1)))
        return torch.cat([b1, b3, b5, bp], dim=-1)


class _AuxHead(nn.Module):
    def __init__(self, in_features, size, num_classes, dtype=torch.bfloat16,
                 generator=None):
        super().__init__()
        self.Conv_0 = Conv(in_features, 128, 1, dtype=dtype,
                           generator=generator, use_bias=True)
        pooled = out_size(size, 5, 3, 'VALID')
        self.Dense_0 = Dense(128 * pooled * pooled, 1024, dtype=dtype,
                             generator=generator)
        self.Dense_1 = Dense(1024, num_classes, dtype=torch.float32,
                             generator=generator)
        self.dropout = Dropout(0.7)

    def forward(self, x):
        x = avg_pool(x, 5, 3)
        if x.shape[1] and x.shape[2]:
            x = torch.relu(self.Conv_0(x))
        x = x.reshape(x.shape[0], -1)
        x = self.dropout(torch.relu(self.Dense_0(x)))
        return self.Dense_1(x).float()


# (n1, n3r, n3, n5r, n5, proj) of the nine modules; a 3x3/2 max pool
# before modules 2 and 7, the auxiliary heads after modules 2 and 5
_MODULES = ((64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64),
            (192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
            (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
            (256, 160, 320, 32, 128, 128), (256, 160, 320, 32, 128, 128),
            (384, 192, 384, 48, 128, 128))
_POOL_BEFORE = (2, 7)
_AUX_AFTER = (2, 5)


class GoogLeNet(nn.Module):
    """GoogLeNet over NHWC input; parameters from ``generator``
    (default: seed 0) on ``device`` (default: the current CUDA
    device)."""

    def __init__(self, num_classes=1000, dtype=torch.bfloat16, insize=224,
                 aux_heads=True, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.insize = insize
        self.aux_heads = aux_heads
        conv = dict(dtype=dtype, generator=generator, use_bias=True)
        self.Conv_0 = Conv(3, 64, 7, 2, padding=3, **conv)
        self.Conv_1 = Conv(64, 64, 1, **conv)
        self.Conv_2 = Conv(64, 192, 3, padding=1, **conv)
        size = out_size(out_size(insize, 7, 2, 3), 3, 2, 'SAME')
        size = out_size(size, 3, 2, 'SAME')
        in_features, n_aux = 192, 0
        for j, widths in enumerate(_MODULES):
            if j in _POOL_BEFORE:
                size = out_size(size, 3, 2, 'SAME')
            m = Inception(in_features, *widths, dtype=dtype,
                          generator=generator)
            setattr(self, 'Inception_%d' % j, m)
            in_features = m.out_features
            if aux_heads and j in _AUX_AFTER:
                setattr(self, '_AuxHead_%d' % n_aux, _AuxHead(
                    in_features, size, num_classes, dtype=dtype,
                    generator=generator))
                n_aux += 1
        self.Dense_0 = Dense(in_features, num_classes, dtype=torch.float32,
                             generator=generator)
        self.dropout = Dropout(0.4)
        self.to(device)

    def forward(self, x):
        x = x.to(self.dtype)
        x = max_pool_same(torch.relu(self.Conv_0(x)))
        x = torch.relu(self.Conv_2(torch.relu(self.Conv_1(x))))
        x = max_pool_same(x)
        auxes = []
        for j in range(len(_MODULES)):
            if j in _POOL_BEFORE:
                x = max_pool_same(x)
            x = getattr(self, 'Inception_%d' % j)(x)
            if self.aux_heads and self.training and j in _AUX_AFTER:
                auxes.append(getattr(self, '_AuxHead_%d' % len(auxes))(x))
        x = self.dropout(global_mean(x, self.dtype))
        x = self.Dense_0(x).float()
        if self.aux_heads and self.training:
            return x, tuple(auxes)
        return x
