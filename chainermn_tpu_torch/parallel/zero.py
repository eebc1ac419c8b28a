"""ZeRO-1: optimizer state sharded over the data processes.

Counterpart of ``chainermn_tpu/parallel/zero.py``.  Each gradient is
mean-reduce-scattered over the data group into flat, zero-padded shards
(``shard_len`` elements a process), the wrapped ``torch.optim``
optimizer steps this process's shard only (so its state is 1/N of the
replicated one), and the updated shards are all-gathered back into the
parameters.  The volume moved is an allreduce's (reduce-scatter plus
all-gather IS the ring allreduce).

Used through ``StandardUpdater(zero=True)``, which hands the optimizer's
parameter groups the shards (:class:`ZeroStep`).  Only an ELEMENTWISE
optimizer keeps the replicated trajectory on flat shards;
:func:`check_elementwise` probes for it.  Global-norm clipping is
non-elementwise but mesh-aware here: :func:`clip_by_global_norm`
finishes its sum of squares over the data group inside
:func:`mesh_norm_scope`, so ``chain(clip_by_global_norm(c),
torch.optim.Adam(...))`` takes the replicated trajectory under ZeRO too.

Not ported yet (ROADMAP.md item 8): the mesh-aware trust ratio
(``scale_by_trust_ratio``, LARS, LAMB) and the elastic N -> M reshard
of a saved state (``reshard_stacked_state``).
"""

import contextlib
import copy
import inspect

import torch
import torch.distributed as dist

# the JAX package's collective names, where this torch has them
_reduce_scatter = (getattr(dist, 'reduce_scatter_single', None)
                   or dist.reduce_scatter_tensor)
_all_gather = (getattr(dist, 'all_gather_single', None)
               or dist.all_gather_into_tensor)

_NORM_CTX = {'gnorm_sq': None}


@contextlib.contextmanager
def mesh_norm_scope(gnorm_sq):
    """Give mesh-aware transforms the rule that turns a LOCAL sum of
    squares (a 0-d f32 tensor) into the GLOBAL one, for the block:
    ``StandardUpdater(zero=True)`` wraps its optimizer step in one that
    sums over the data group.  Nests and restores."""
    prev = _NORM_CTX['gnorm_sq']
    _NORM_CTX['gnorm_sq'] = gnorm_sq
    try:
        yield
    finally:
        _NORM_CTX['gnorm_sq'] = prev


def tree_sumsq(tensors):
    """Local sum of squares over every tensor (f32 accumulation)."""
    out = None
    for t in tensors:
        sq = t.to(torch.float32).square().sum()
        out = sq if out is None else out + sq
    return out if out is not None else torch.zeros(())


def group_sumsq(tensors, group=None):
    """The sum of squares of tensors whose every element lives on exactly
    one process of ``group`` (ZeRO shards; padding zeros add nothing)."""
    sq = tree_sumsq(tensors).clone()
    if dist.is_initialized():
        dist.all_reduce(sq, group=group)
    return sq


class clip_by_global_norm:
    """Global-norm clipping of the gradients of the parameters it is
    given (in place), that stays right when the optimizer runs on ZeRO
    shards: inside a :func:`mesh_norm_scope` the squared norm is
    completed with the scope's rule.  The arithmetic of
    ``optax.clip_by_global_norm``: ``g`` below the threshold, else ``g /
    norm * max_norm``.  Compose it with :func:`chain`."""

    _cmn_mesh_aware = True

    def __init__(self, max_norm):
        self.max_norm = float(max_norm)

    @torch.no_grad()
    def __call__(self, params):
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        rule = _NORM_CTX['gnorm_sq']
        sq = rule(grads) if rule is not None else tree_sumsq(grads)
        norm = torch.sqrt(sq)
        clip = norm >= self.max_norm
        for g in grads:
            scaled = (g / norm.to(g.dtype)) * self.max_norm
            g.copy_(torch.where(clip, scaled, g))


class Chain:
    """``optax.chain`` of gradient transforms and one ``torch.optim``
    optimizer (the last argument): ``step()`` runs each transform over
    the optimizer's parameters (they rewrite ``grad`` in place), then
    the optimizer's own ``step``.  Every other attribute is the
    optimizer's, so the multi-node wrapper and ``StandardUpdater(zero=
    True)`` treat it as one."""

    def __init__(self, transforms, optimizer):
        self.transforms = list(transforms)
        self.optimizer = optimizer

    def _params(self):
        return [p for g in self.optimizer.param_groups for p in g['params']]

    def step(self, closure=None):
        for t in self.transforms:
            t(self._params())
        return self.optimizer.step(closure)

    def __getattr__(self, name):
        return getattr(self.__dict__['optimizer'], name)


def chain(*parts):
    """A :class:`Chain` accepted under ``zero=True``: every transform
    must be mesh-aware (:class:`clip_by_global_norm`) or pass
    :func:`check_elementwise`, and so must the optimizer (the last
    part)."""
    *transforms, optimizer = parts
    for t in transforms:
        if not getattr(t, '_cmn_mesh_aware', False):
            check_elementwise(t)
    check_elementwise(optimizer)
    out = Chain(transforms, optimizer)
    out._cmn_zero_safe = True
    return out


def _fresh(optimizer, params):
    """A new optimizer of ``optimizer``'s kind and first group's
    settings over ``params`` (for the probes)."""
    if isinstance(optimizer, Chain):
        return Chain(optimizer.transforms,
                     _fresh(optimizer.optimizer, params))
    if not isinstance(optimizer, torch.optim.Optimizer):
        return optimizer          # a gradient transform: stateless
    group = {k: v for k, v in optimizer.param_groups[0].items()
             if k != 'params'}
    # the group carries every setting; the constructor's own keywords
    # are passed for the ones it requires
    accepted = inspect.signature(type(optimizer)).parameters
    kwargs = {k: v for k, v in copy.deepcopy(optimizer.defaults).items()
              if k in accepted}
    return type(optimizer)([dict(group, params=params)], **kwargs)


def _updates(optimizer, values, grads):
    """The change one step of a fresh copy of ``optimizer`` makes to
    parameters ``values`` given ``grads`` (lists of tensors)."""
    params = [torch.nn.Parameter(v.clone()) for v in values]
    for p, g in zip(params, grads):
        p.grad = g.clone()
    opt = _fresh(optimizer, params)
    if isinstance(opt, torch.optim.Optimizer) or isinstance(opt, Chain):
        opt.step()
    else:
        opt(params)
        with torch.no_grad():
            for p in params:
                p.sub_(p.grad)    # a transform's output is an update
    return [(p.detach() - v) for p, v in zip(params, values)]


def check_elementwise(optimizer, atol=1e-7):
    """Probe whether ``optimizer`` (a ``torch.optim`` optimizer, a
    :class:`Chain` or a gradient transform) is ELEMENTWISE; raise
    ``ValueError`` if not.

    Under ZeRO-1 every parameter becomes a flat 1-D per-process shard,
    so a transform that reads cross-element structure computes over
    shards and silently leaves the replicated trajectory.  Two probes,
    as in the JAX package: *locality* (perturbing one gradient element
    moves no other element's update) and *shape invariance* (a 2-D
    parameter and its flattened 1-D twin get the same updates).  A
    :func:`chain` or a mesh-aware transform is admitted unprobed."""
    if (getattr(optimizer, '_cmn_zero_safe', False)
            or getattr(optimizer, '_cmn_mesh_aware', False)):
        return

    def fail(reason):
        raise ValueError(
            'zero=True requires an elementwise optimizer, but this '
            'transform is not: %s.  Under ZeRO-1 every leaf becomes a '
            'flat 1-D per-device shard, so such transforms compute over '
            'shards instead of true leaves and the trajectory silently '
            'diverges from zero=False.  A mesh-aware replacement exists '
            'for global-norm clipping: zero.chain(zero.clip_by_global_'
            'norm(c), optimizer).  Otherwise use zero=False for this '
            'optimizer, or pass zero_check=False if the probe is a false '
            'positive for your transform.' % reason)

    # probe 1: locality
    a = torch.linspace(0.5, 1.0, 5)
    b = torch.linspace(-1.0, -0.5, 3)
    g1 = [torch.ones(5), torch.ones(3)]
    g2 = [g1[0].clone(), g1[1]]
    g2[0][0] = 37.0
    u1 = _updates(optimizer, [a, b], g1)
    u2 = _updates(optimizer, [a, b], g2)
    others = torch.cat([(u1[0] - u2[0]).abs()[1:], (u1[1] - u2[1]).abs()])
    if bool((others > atol).any()):
        fail('perturbing one gradient element moved updates at %d '
             'other position(s) (max %.3g)'
             % (int((others > atol).sum()), float(others.max())))
    # probe 2: shape invariance (large enough for shape-based special
    # casing, adafactor's 128, to engage)
    side = 128
    w = torch.linspace(0.1, 1.0, side * side)
    g = torch.cos(w * 3.0)
    u2d = _updates(optimizer, [w.reshape(side, side)],
                   [g.reshape(side, side)])[0]
    u1d = _updates(optimizer, [w], [g])[0]
    diff = (u2d.reshape(-1) - u1d).abs()
    if bool((diff > atol).any()):
        fail('a 2-D leaf and its flattened 1-D twin produce different '
             'updates (max diff %.3g) -- the transform reads leaf '
             'shape' % float(diff.max()))


def shard_len(size, n):
    """Per-process shard length for a flat leaf of ``size`` elements."""
    return -(-size // n)


def param_shard_leaf(p, n, rank):
    """This process's ``(k,)`` shard of a replicated parameter: its
    ``rank``-th block of the zero-padded flat tensor (no
    communication)."""
    k = shard_len(p.numel(), n)
    flat = p.detach().reshape(-1)
    pad = n * k - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat[rank * k:(rank + 1) * k]


class ZeroStep:
    """The ZeRO-1 cycle of one optimizer over ``params``, the engine of
    ``StandardUpdater(zero=True)``.

    Built once: the optimizer's parameter groups are handed flat shard
    parameters (one a parameter: this process's block of its
    zero-padded flattening), so the state the optimizer makes is
    shard-sized.  :meth:`step` then (1) mean-reduce-scatters every
    parameter's gradient over the data group, one collective per dtype
    (``reduce_dtype``: the reduction runs in that dtype, the optimizer
    sees the gradient's own), (2) refreshes the shards from the
    parameters, (3) steps the optimizer on the shards inside a
    :func:`mesh_norm_scope` over the data group, and (4) all-gathers
    the shards back into the parameters, one collective per dtype."""

    def __init__(self, optimizer, params, n, rank, group=None,
                 reduce_dtype=None):
        self.optimizer = optimizer
        self.params = list(params)
        self.n, self.rank, self.group = int(n), int(rank), group
        self.reduce_dtype = reduce_dtype
        index = {p: i for i, p in enumerate(self.params)}
        owned = [p for g in optimizer.param_groups for p in g['params']]
        if sorted(index[p] for p in owned) != list(range(len(self.params))):
            raise ValueError('zero=True needs an optimizer over exactly the '
                             "model's parameters")
        # one flat buffer a dtype: parameter i owns columns
        # [offset, offset + k) of every process's row
        self._buckets = {}
        self._where = {}
        for p in self.params:
            bucket = self._buckets.setdefault(p.dtype, [])
            k = shard_len(p.numel(), self.n)
            off = sum(shard_len(q.numel(), self.n) for q in bucket)
            bucket.append(p)
            self._where[p] = (off, k)
        self._rows = {dt: torch.zeros(sum(self._where[p][1] for p in ps),
                                      dtype=dt, device=ps[0].device)
                      for dt, ps in self._buckets.items()}
        self.shards = {}
        for p in self.params:
            off, k = self._where[p]
            self.shards[p] = torch.nn.Parameter(
                self._rows[p.dtype][off:off + k])
        for group in optimizer.param_groups:
            group['params'] = [self.shards[p] for p in group['params']]
        self.refresh()

    @torch.no_grad()
    def refresh(self):
        """Copy this process's block of every parameter into its
        shard."""
        for p in self.params:
            self.shards[p].copy_(param_shard_leaf(p, self.n, self.rank))

    def _padded(self, t, k):
        flat = t.reshape(-1)
        pad = self.n * k - flat.numel()
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat.view(self.n, k)

    @torch.no_grad()
    def reduce_scatter(self):
        """Every parameter's mean gradient shard, set as its shard's
        ``grad`` (a zero gradient where a parameter has none)."""
        for dt, ps in self._buckets.items():
            width = self._rows[dt].numel()
            wire = self.reduce_dtype or dt
            inp = torch.zeros((self.n, width), dtype=wire,
                              device=ps[0].device)
            for p in ps:
                off, k = self._where[p]
                if p.grad is not None:
                    inp[:, off:off + k] = self._padded(p.grad, k)
            out = inp.new_empty(width)
            if self.n > 1:
                _reduce_scatter(out, inp.reshape(-1), group=self.group)
                out /= self.n
            else:
                out.copy_(inp[0])
            out = out.to(dt)
            for p in ps:
                off, k = self._where[p]
                self.shards[p].grad = out[off:off + k]

    @torch.no_grad()
    def all_gather(self):
        """The updated shards gathered back into the parameters."""
        for dt, ps in self._buckets.items():
            row = self._rows[dt]
            if self.n > 1:
                full = row.new_empty(self.n * row.numel())
                _all_gather(full, row, group=self.group)
                full = full.view(self.n, row.numel())
            else:
                full = row.view(1, -1)
            for p in ps:
                off, k = self._where[p]
                p.copy_(full[:, off:off + k].reshape(-1)[:p.numel()]
                        .view(p.shape))

    def step(self):
        self.reduce_scatter()
        self.refresh()
        with mesh_norm_scope(lambda ts: group_sumsq(ts, self.group)):
            self.optimizer.step()
        self.all_gather()

    # -- snapshots ---------------------------------------------------------
    def gathered_state(self):
        """The optimizer's per-parameter state with every shard-sized
        tensor gathered into the ``(n, k)`` stack the JAX package saves
        (a collective over the data group); other entries (step
        counts) as they are.  Keyed by parameter index."""
        out = {}
        for i, p in enumerate(self.params):
            state = self.optimizer.state.get(self.shards[p], {})
            entry = {}
            for key, value in state.items():
                if torch.is_tensor(value) and value.dim() == 1 \
                        and value.numel() == self._where[p][1]:
                    parts = value.new_empty(self.n * value.numel())
                    if self.n > 1:
                        _all_gather(parts, value.contiguous(),
                                    group=self.group)
                    else:
                        parts.copy_(value)
                    value = parts.view(self.n, -1)
                entry[key] = value
            out[i] = entry
        return out

    def load_gathered_state(self, state):
        """The inverse of :meth:`gathered_state` at the same ``n``: each
        stack's row ``rank``.  ``load_state_dict`` numbers the state in
        the order of the optimizer's groups, which need not be the
        model's: each parameter index is mapped to its shard's place
        there."""
        place = {}
        for group in self.optimizer.param_groups:
            for shard in group['params']:
                place[shard] = len(place)
        by_place = {}
        for i, entry in state.items():
            p = self.params[int(i)]
            rows = {}
            for key, value in entry.items():
                value = torch.as_tensor(value)
                if value.dim() == 2:
                    if value.shape != (self.n, self._where[p][1]):
                        raise ValueError(
                            'ZeRO state of parameter %d has shape %r, this '
                            'run needs (%d, %d): the elastic N -> M reshard '
                            'is not ported yet (ROADMAP.md item 8)'
                            % (int(i), tuple(value.shape), self.n,
                               self._where[p][1]))
                    value = value[self.rank].clone()
                rows[key] = value
            by_place[place[self.shards[p]]] = rows
        groups = self.optimizer.state_dict()['param_groups']
        self.optimizer.load_state_dict({'state': by_place,
                                        'param_groups': groups})
