"""Carry weights between the JAX package's flax variable trees and the
port's modules.

The flax tree is ``{'params': ..., 'batch_stats': ...}`` as nested dicts
of numpy arrays.  Module names are the same on both sides, so the map is
mechanical:

- a 4-D ``kernel`` (conv, HWIO) is the module's ``weight`` (OIHW);
- a 2-D ``kernel`` (Dense, ``(in, out)``) is the ``weight`` of an
  ``nn.Linear`` (``(out, in)``);
- every other leaf (``bias``, BatchNorm ``scale`` / ``bias`` and the
  ``batch_stats`` ``mean`` / ``var``) has the same name and layout.
"""

import numpy as np
import torch


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _to_torch_layout(name, value):
    value = np.asarray(value)
    if name == 'kernel' and value.ndim == 4:
        return 'weight', value.transpose(3, 2, 0, 1)
    if name == 'kernel' and value.ndim == 2:
        return 'weight', value.T
    return name, value


@torch.no_grad()
def load_flax_variables(module, variables):
    """Copy a flax variable tree into ``module``'s parameters and
    buffers, in place (their devices, dtypes and memory formats are
    kept).  Every leaf must find its tensor, and every parameter and
    buffer of ``module`` must be covered."""
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    seen = set()
    for collection in ('params', 'batch_stats'):
        for path, value in _leaves(variables.get(collection, {})):
            name, value = _to_torch_layout(path[-1], value)
            key = '.'.join(path[:-1] + (name,))
            if key not in tensors:
                raise KeyError('flax leaf %s/%s has no counterpart %r in %s'
                               % (collection, '/'.join(path), key,
                                  type(module).__name__))
            target = tensors[key]
            if tuple(target.shape) != value.shape:
                raise ValueError('%s: shape %s, flax leaf has %s'
                                 % (key, tuple(target.shape), value.shape))
            target.copy_(torch.from_numpy(np.array(value)))
            seen.add(key)
    missing = sorted(set(tensors) - seen)
    if missing:
        raise KeyError('not in the flax tree: %s' % missing)


def to_flax_variables(module):
    """The reverse of :func:`load_flax_variables`: ``{'params': ...,
    'batch_stats': ...}`` as nested dicts of float32 numpy arrays."""
    out = {'params': {}, 'batch_stats': {}}
    named = [('params', k, v) for k, v in module.named_parameters()]
    named += [('batch_stats', k, v) for k, v in module.named_buffers()]
    for collection, key, tensor in named:
        path = key.split('.')
        value = tensor.detach().float().cpu().numpy()
        if path[-1] == 'weight':
            path[-1] = 'kernel'
            value = (value.transpose(2, 3, 1, 0) if value.ndim == 4
                     else value.T)
        node = out[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(value)
    return out
