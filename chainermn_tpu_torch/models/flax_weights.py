"""Carry weights between the JAX package's flax variable trees and the
port's modules.

The flax tree is ``{'params': ..., 'batch_stats': ...}`` as nested dicts
of numpy arrays.  Module names are the same on both sides, so the map is
mechanical:

- a ``kernel`` that the module keeps under that name (the transformer's
  ``Dense`` and ``QKV``) keeps flax's layout: ``block_i/qkv/kernel`` is
  4-D ``(d, 3, H, d_head)`` and is NOT a convolution;
- any other 4-D ``kernel`` (conv, HWIO) is the module's ``weight``
  (OIHW);
- any other 2-D ``kernel`` (Dense, ``(in, out)``) is the ``weight`` of an
  ``nn.Linear`` (``(out, in)``);
- every other leaf (``bias``, BatchNorm ``scale`` / ``bias``, LayerNorm
  ``ln*_scale``, ``embedding``, ``pos_embed`` and the ``batch_stats``
  ``mean`` / ``var``) has the same name and layout.
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
    if name == 'kernel' and value.ndim == 4:
        return 'weight', value.transpose(3, 2, 0, 1)
    if name == 'kernel' and value.ndim == 2:
        return 'weight', value.T
    return name, value


def param_tree(module):
    """The module's parameters as a nested ``dict`` keyed like the flax
    tree (the tensors themselves, not copies)."""
    out = {}
    for key, tensor in module.named_parameters():
        path = key.split('.')
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = tensor
    return out


@torch.no_grad()
def load_flax_variables(module, variables):
    """Copy a flax variable tree into ``module``'s parameters and
    buffers, in place (their devices, dtypes and memory formats are
    kept).  Every leaf must find its tensor, and every parameter and
    buffer of ``module`` must be covered."""
    shard = getattr(module, 'shard_flax_variables', None)
    if shard is not None:
        # a tensor-parallel model takes the full (oracle) tree and keeps
        # its own shard of it
        variables = shard(variables)
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    seen = set()
    for collection in ('params', 'batch_stats'):
        for path, value in _leaves(variables.get(collection, {})):
            owner, name = path[:-1], path[-1]
            value = np.asarray(value)
            if '.'.join(path) not in tensors:
                name, value = _to_torch_layout(name, value)
            key = '.'.join(owner + (name,))
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


# -- tensor-parallel layouts ----------------------------------------------
#
# A spec is a tuple with one entry per leading dim of a leaf: None
# (replicated) or the name (or tuple of names) of the mesh axes the dim
# is split over, in equal blocks in axis order (the JAX PartitionSpec).

def _spec_names(entry):
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_leaf(value, spec, mesh):
    """This process's block of one full leaf (numpy array or tensor)
    under ``spec`` on ``mesh`` (a ``parallel.ProcessMesh``)."""
    for dim, entry in enumerate(tuple(spec or ())):
        if entry is None:
            continue
        n = mesh.axis_size(entry)
        if value.shape[dim] % n:
            raise ValueError('dim %d of shape %r does not divide over axis '
                             '%r (size %d)' % (dim, tuple(value.shape),
                                               entry, n))
        k = value.shape[dim] // n
        i = mesh.axis_index(entry)
        index = [slice(None)] * value.ndim
        index[dim] = slice(i * k, (i + 1) * k)
        value = value[tuple(index)]
    return value


def gather_leaf(value, spec, mesh, device=None):
    """The full leaf from every process's block (a collective over each
    sharded dim's axes; a torch tensor or numpy array in, the same
    kind out).  ``device``: where the collective runs (a CUDA device
    under NCCL)."""
    import torch.distributed as dist
    as_numpy = isinstance(value, np.ndarray)
    t = torch.as_tensor(value)
    if device is not None:
        t = t.to(device)
    for dim, entry in enumerate(tuple(spec or ())):
        if entry is None:
            continue
        ax = mesh.axis(entry)
        if ax.size == 1:
            continue
        parts = [torch.empty_like(t) for _ in range(ax.size)]
        dist.all_gather(parts, t.contiguous(), group=ax.group)
        t = torch.cat(parts, dim=dim)
    return t.cpu().numpy() if as_numpy else t


def shard_variables(tree, specs, mesh):
    """This process's shard of a full flax tree (nested dicts) under a
    spec tree of the same structure (e.g. ``tp_param_specs``): what
    ``shard_map``'s in_specs hand one device.  Array leaves come back as
    numpy arrays; tensor leaves as views of the tensor."""
    return _map_specs(
        lambda v, sp: shard_leaf(v if torch.is_tensor(v) else np.asarray(v),
                                 sp, mesh), tree, specs)


def gather_variables(tree, specs, mesh, device=None):
    """The inverse of :func:`shard_variables`: every process's shard
    gathered back into the full tree of numpy arrays (a collective:
    call it on every process of the mesh, in the same order)."""
    return _map_specs(
        lambda v, sp: gather_leaf(np.asarray(v), sp, mesh, device),
        tree, specs)
