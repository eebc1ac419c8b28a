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
:func:`check_elementwise` probes for it.  Two kinds of non-elementwise
statistics are mesh-aware here and finish over the data group inside
:func:`mesh_norm_scope`: the global norm of :func:`clip_by_global_norm`
(``chain(clip_by_global_norm(c), torch.optim.Adam(...))``), and the
per-leaf norms of the layer-wise trust ratio (:func:`scale_by_trust_ratio`,
:func:`lars`, :func:`lamb`), completed for every leaf with ONE packed
all-reduce a step.  A state saved at N processes loads at M
(:meth:`ZeroStep.load_gathered_state`, :func:`reshard_stacked_state`):
the elastic resume.
"""

import contextlib
import copy
import inspect

import numpy as np
import torch
import torch.distributed as dist

# the JAX package's collective names, where this torch has them
_reduce_scatter = (getattr(dist, 'reduce_scatter_single', None)
                   or dist.reduce_scatter_tensor)
_all_gather = (getattr(dist, 'all_gather_single', None)
               or dist.all_gather_into_tensor)

_NORM_CTX = {'gnorm_sq': None, 'leaf_sumsq': None}


@contextlib.contextmanager
def mesh_norm_scope(gnorm_sq, leaf_sumsq=None):
    """Give mesh-aware transforms the rules that complete their norms
    over the sharding their step runs under, for the block.

    ``gnorm_sq(tensors)`` turns the tensors' LOCAL sum of squares into
    the GLOBAL one (a 0-d f32 tensor).  ``leaf_sumsq(params, tensors)``
    returns each tensor's GLOBAL sum of squares as one ``(len(tensors),)``
    f32 vector, ``tensors[i]`` shaped like parameter ``params[i]`` (the
    parameter says how that tensor is sharded): under ZeRO every leaf is
    sharded over the data group, so it is one all-reduce of the packed
    local sums.  A sharding that admits no per-leaf rule (the 1F1B
    schedule, whose same-named leaf holds a DIFFERENT layer on each
    stage) passes None, and the per-leaf transforms refuse.
    ``StandardUpdater(zero=True)`` wraps its optimizer step in both
    rules over the data group.  Nests and restores."""
    prev = dict(_NORM_CTX)
    _NORM_CTX.update(gnorm_sq=gnorm_sq, leaf_sumsq=leaf_sumsq)
    try:
        yield
    finally:
        _NORM_CTX.update(prev)


def tree_sumsq(tensors):
    """Local sum of squares over every tensor (f32 accumulation)."""
    out = None
    for t in tensors:
        sq = t.to(torch.float32).square().sum()
        out = sq if out is None else out + sq
    return out if out is not None else torch.zeros(())


def leaf_sumsqs(tensors):
    """Each tensor's local sum of squares, as one f32 vector."""
    return torch.stack([t.to(torch.float32).square().sum()
                        for t in tensors])


def leaf_norm_sq(params, tensors):
    """Each of ``tensors``' GLOBAL sum of squares under the bound
    :func:`mesh_norm_scope` (its local one outside any scope), one f32
    vector.  Inside a scope with no per-leaf rule it raises
    ``ValueError``: a per-layer ratio cannot be rebuilt there, and a
    silent fall-back to local norms would leave the trajectory."""
    rule = _NORM_CTX['leaf_sumsq']
    if rule is not None:
        return rule(params, tensors)
    if _NORM_CTX['gnorm_sq'] is not None:
        raise ValueError(
            'trust-ratio transform stepped in a sharded optimizer context '
            "without a per-leaf norm rule (the 1f1b schedule's stage "
            'sharding): per-layer ratios cannot be reconstructed there -- '
            'use the gpipe schedule, or an elementwise / global-norm-clip '
            'optimizer')
    return leaf_sumsqs(tensors)


def trust_ratios(params, updates, min_norm=0.0, trust_coefficient=1.0,
                 eps=0.0):
    """The layer-wise trust ratio of each (parameter, update) pair, as
    one f32 vector: ``optax.scale_by_trust_ratio``'s formula, ``tc *
    max(|p|, min_norm) / (max(|u|, min_norm) + eps)``, and 1 where
    either norm is 0.  The norms of every pair come from one
    :func:`leaf_norm_sq` call (one packed all-reduce under ZeRO)."""
    n = len(params)
    sq = leaf_norm_sq(list(params) * 2, list(params) + list(updates))
    norms = torch.sqrt(sq).clamp_min(min_norm)
    p_norm, u_norm = norms[:n], norms[n:]
    ratio = trust_coefficient * p_norm / (u_norm + eps)
    zero_norm = (p_norm == 0) | (u_norm == 0)
    return torch.where(zero_norm, torch.ones_like(ratio), ratio)


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


class scale_by_trust_ratio:
    """The layer-wise trust ratio of ``optax.scale_by_trust_ratio`` as a
    gradient transform (in place): each parameter's gradient times
    ``trust_coefficient * max(|p|, min_norm) / (max(|g|, min_norm) +
    eps)`` (1 where either norm is 0), with the norms completed over the
    mesh by the bound :func:`mesh_norm_scope`'s per-leaf rule, so under
    ZeRO each ratio is the whole leaf's.  In a scope with no per-leaf
    rule (1F1B) it refuses with ``ValueError``.  Compose it with
    :func:`chain`; :func:`lars` and :func:`lamb` apply it inside their
    own steps."""

    _cmn_mesh_aware = True

    def __init__(self, min_norm=0.0, trust_coefficient=1.0, eps=0.0):
        self.min_norm = float(min_norm)
        self.trust_coefficient = float(trust_coefficient)
        self.eps = float(eps)

    @torch.no_grad()
    def __call__(self, params):
        params = [p for p in params if p.grad is not None]
        if not params:
            return
        ratios = trust_ratios(params, [p.grad for p in params],
                              self.min_norm, self.trust_coefficient,
                              self.eps)
        for p, r in zip(params, ratios):
            p.grad.mul_(r.to(p.grad.dtype))


def _lr_at(lr, count):
    """A number, or a schedule ``lr(count)`` at the optimizer's step
    count (``optax.scale_by_schedule`` reads it before incrementing)."""
    return lr(count) if callable(lr) else lr


class _TrustRatioOptimizer(torch.optim.Optimizer):
    """What :class:`LARS` and :class:`LAMB` share: every parameter with a
    gradient, across the groups, gets its direction from
    :meth:`_direction`, then its trust ratio from one
    :func:`trust_ratios` call (one packed all-reduce a step under ZeRO),
    then :meth:`_apply`.  Admitted under ``zero=True`` and by the
    pipeline updaters' probe: its one non-elementwise statistic, the
    per-leaf norm, is mesh-aware."""

    _cmn_zero_safe = True

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        todo = [(group, p) for group in self.param_groups
                for p in group['params'] if p.grad is not None]
        if not todo:
            return loss
        dirs = [self._direction(group, p) for group, p in todo]
        ratios = trust_ratios(
            [p for _, p in todo], dirs, trust_coefficient=self._tc,
            eps=self._eps)
        for (group, p), u, r in zip(todo, dirs, ratios):
            self._apply(group, p, u * r.to(u.dtype))
        return loss


class LARS(_TrustRatioOptimizer):
    """LARS (You et al. 2017) in ``optax.lars``'s order, with the trust
    ratio mesh-aware: ``u = g + weight_decay * p``, ``u *= ratio``,
    ``u *= -lr``, then the momentum trace ``v = momentum * v + u`` and
    ``p += v`` (``p += u + momentum * v`` with ``nesterov``).
    ``torch.optim.SGD`` sums first and scales by lr afterwards, which
    agrees only at a constant lr, so LARS keeps optax's order.  ``lr``:
    a number or a schedule of the step count (then the state keeps a
    ``'step'``).  Build it with :func:`lars`."""

    def __init__(self, params, lr, weight_decay=0.0, trust_coefficient=0.001,
                 eps=0.0, momentum=0.9, nesterov=False):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      momentum=momentum, nesterov=nesterov))
        self._tc, self._eps = float(trust_coefficient), float(eps)

    def _direction(self, group, p):
        return p.grad + group['weight_decay'] * p

    def _apply(self, group, p, u):
        state = self.state[p]
        count = 0
        if callable(group['lr']):
            count = int(state.get('step', 0))
            state['step'] = torch.tensor(float(count + 1))
        u = u * -_lr_at(group['lr'], count)
        buf = state.get('momentum_buffer')
        buf = u if buf is None else u + group['momentum'] * buf
        state['momentum_buffer'] = buf
        p.add_(u + group['momentum'] * buf if group['nesterov'] else buf)


class LAMB(_TrustRatioOptimizer):
    """LAMB (You et al. 2020) in ``optax.lamb``'s order, with the trust
    ratio mesh-aware: Adam's direction with optax's bias correction
    (``mu / (1 - b1**t)``, ``nu / (1 - b2**t)``, ``mu_hat /
    (sqrt(nu_hat + eps_root) + eps)``), ``+ weight_decay * p``, the
    trust ratio (coefficient 1), ``* -lr``.  The moments live in this
    optimizer's state (``'exp_avg'``, ``'exp_avg_sq'``, ``'step'``), so
    ZeRO shards them and a snapshot saves them.  Build it with
    :func:`lamb`."""

    def __init__(self, params, lr, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      eps_root=eps_root,
                                      weight_decay=weight_decay))
        self._tc, self._eps = 1.0, 0.0

    def _direction(self, group, p):
        state = self.state[p]
        if not state:
            state['step'] = torch.tensor(0.0)
            state['exp_avg'] = torch.zeros_like(p)
            state['exp_avg_sq'] = torch.zeros_like(p)
        b1, b2, g = group['b1'], group['b2'], p.grad
        mu = (1 - b1) * g + b1 * state['exp_avg']
        nu = (1 - b2) * g.square() + b2 * state['exp_avg_sq']
        state['exp_avg'], state['exp_avg_sq'] = mu, nu
        t = int(state['step']) + 1
        mu_hat = mu / (1 - b1 ** t)
        nu_hat = nu / (1 - b2 ** t)
        u = mu_hat / (torch.sqrt(nu_hat + group['eps_root']) + group['eps'])
        return u + group['weight_decay'] * p

    def _apply(self, group, p, u):
        state = self.state[p]
        count = int(state['step'])
        state['step'] = torch.tensor(float(count + 1))
        p.add_(u * -_lr_at(group['lr'], count))


def lars(params, learning_rate, weight_decay=0.0, trust_coefficient=0.001,
         eps=0.0, momentum=0.9, nesterov=False):
    """Mesh-aware LARS over ``params``, usable under ``zero=True``: the
    counterpart of the JAX package's ``zero.lars`` (``optax.lars``'s
    chain with the trust ratio completed over the mesh; default masks).
    The torch optimizer needs its parameters, so they come first."""
    return LARS(params, learning_rate, weight_decay=weight_decay,
                trust_coefficient=trust_coefficient, eps=eps,
                momentum=momentum, nesterov=nesterov)


def lamb(params, learning_rate, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0,
         weight_decay=0.0):
    """Mesh-aware LAMB over ``params``, usable under ``zero=True``: the
    counterpart of the JAX package's ``zero.lamb`` (``optax.lamb``'s
    chain with the trust ratio completed over the mesh)."""
    return LAMB(params, learning_rate, b1=b1, b2=b2, eps=eps,
                eps_root=eps_root, weight_decay=weight_decay)


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
    :func:`chain`, a mesh-aware transform and :func:`lars` /
    :func:`lamb` are admitted unprobed."""
    if (getattr(optimizer, '_cmn_zero_safe', False)
            or getattr(optimizer, '_cmn_mesh_aware', False)):
        return

    def fail(reason):
        raise ValueError(
            'zero=True requires an elementwise optimizer, but this '
            'transform is not: %s.  Under ZeRO-1 every leaf becomes a '
            'flat 1-D per-device shard, so such transforms compute over '
            'shards instead of true leaves and the trajectory silently '
            'diverges from zero=False.  Mesh-aware replacements exist for '
            'the common cases: zero.chain(zero.clip_by_global_norm(c), '
            'optimizer) for global-norm clipping, zero.lars(...) / '
            'zero.lamb(...) / zero.scale_by_trust_ratio() for layer-wise '
            'trust ratios.  Otherwise use zero=False for this '
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


def regather_stacked_leaf(stacked, size):
    """The ``(n, k)`` stacked shards of one leaf -> its flat ``(size,)``
    form (numpy in, numpy out): the rows are :func:`param_shard_leaf`'s
    rank-order blocks of the zero-padded flat leaf, so the row-major
    flattening IS the regather; the trailing padding is dropped."""
    return np.asarray(stacked).reshape(-1)[:size]


def reshard_flat_leaf(flat, new_n):
    """A flat leaf -> ``(new_n, k')`` stacked shards under the
    :func:`shard_len` padding rule: the blocks :func:`param_shard_leaf`
    cuts at ``new_n`` processes (numpy in, numpy out)."""
    flat = np.asarray(flat).reshape(-1)
    k = shard_len(flat.size, new_n)
    pad = new_n * k - flat.size
    if pad:
        flat = np.concatenate([flat, np.zeros((pad,), flat.dtype)])
    return flat.reshape(new_n, k)


def _reshard(saved, shape):
    """One saved ``(n_old, k_old)`` stack (numpy array or tensor) as
    ``shape``: its row-major flattening truncated or zero-extended to the
    new padded length.  Right because shard padding is zero at the start
    and stays zero (padding gradients are zero, so an elementwise or
    mesh-aware update keeps it zero): the result is what a fresh split at
    the new size holds."""
    want = int(np.prod(shape))
    flat = saved.reshape(-1)[:want]
    pad = want - flat.shape[0]
    if pad and torch.is_tensor(flat):
        flat = torch.cat([flat, flat.new_zeros(pad)])
    elif pad:
        flat = np.concatenate([flat, np.zeros((pad,), flat.dtype)])
    return flat.reshape(shape)


def reshard_stacked_state(saved, template):
    """The elastic N -> M reshard of a SAVED stacked ZeRO-1 optimizer
    state (nested dicts) against the live run's ``template`` of the same
    structure (numpy or tensors in, the same out; a template leaf needs
    only a ``shape``).  Array leaves are ``(n_old, k_old)`` stacks and
    come back in the template's shape (see :func:`_reshard`); scalar
    leaves (step counts) pass through."""
    if isinstance(saved, dict):
        return {k: reshard_stacked_state(v, template[k])
                for k, v in saved.items()}
    tshape = tuple(np.shape(template))
    arr = saved if torch.is_tensor(saved) else np.asarray(saved)
    if len(tshape) < 1 or arr.ndim < 1:
        return saved
    if arr.shape == tshape:
        return arr
    return _reshard(arr, tshape)


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

    def rebound(self, params):
        """The same cycle over other tensors ``params`` (in this one's
        order), the optimizer's groups already holding them: what a traced
        step runs on (``StandardUpdater.traceable_step``)."""
        return ZeroStep(self.optimizer, params, self.n, self.rank,
                        self.group, self.reduce_dtype)

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

    def _group_sum(self, sq):
        """``sq`` summed over the data group (nothing to do at n = 1)."""
        if self.n > 1:
            sq = sq.clone()
            dist.all_reduce(sq, group=self.group)
        return sq

    def step(self):
        """One ZeRO-1 step (see the class docstring).  The scope's rules:
        the global sum of squares, and every leaf's, are the data group's
        sums of the shards' (one packed all-reduce for all leaves)."""
        self.reduce_scatter()
        self.refresh()
        with mesh_norm_scope(
                lambda ts: self._group_sum(tree_sumsq(ts)),
                leaf_sumsq=lambda ps, ts: self._group_sum(leaf_sumsqs(ts))):
            self.optimizer.step()
        self.all_gather()

    # -- snapshots ---------------------------------------------------------
    def local_state(self):
        """This process's optimizer state, keyed by parameter index, as
        ``{index: {key: (value, is_row)}}`` with nothing sent:
        ``is_row`` marks a shard-sized tensor, row ``rank`` of the
        ``(n, k)`` stack :meth:`gathered_state` gathers (a sharded
        checkpoint writes each row from its own process)."""
        out = {}
        for i, p in enumerate(self.params):
            state = self.optimizer.state.get(self.shards[p], {})
            out[i] = {key: (value, torch.is_tensor(value)
                            and value.dim() == 1
                            and value.numel() == self._where[p][1])
                      for key, value in state.items()}
        return out

    def gathered_state(self):
        """The optimizer's per-parameter state with every shard-sized
        tensor gathered into the ``(n, k)`` stack the JAX package saves
        (a collective over the data group); other entries (step
        counts) as they are.  Keyed by parameter index."""
        out = {}
        for i, entry in self.local_state().items():
            out[i] = {}
            for key, (value, row) in entry.items():
                if row:
                    parts = value.new_empty(self.n * value.numel())
                    if self.n > 1:
                        _all_gather(parts, value.contiguous(),
                                    group=self.group)
                    else:
                        parts.copy_(value)
                    value = parts.view(self.n, -1)
                out[i][key] = value
        return out

    def stack_shape(self, i):
        """The ``(n, k)`` shape of parameter ``i``'s saved stacks at this
        run's ``n``."""
        return (self.n, self._where[self.params[int(i)]][1])

    def stack_mismatches(self, state):
        """``[(saved shape, this run's shape), ...]`` of the stacks in
        ``state`` (:meth:`gathered_state`'s form) saved at another ``n``:
        what loading it reshards (the elastic N -> M resume)."""
        out = []
        for i, entry in state.items():
            for v in entry.values():
                shape = tuple(torch.as_tensor(v).shape)
                if len(shape) == 2 and shape != self.stack_shape(i):
                    out.append((shape, self.stack_shape(i)))
        return out

    def load_gathered_state(self, state):
        """The inverse of :meth:`gathered_state`: each stack's row
        ``rank``.  A stack saved at another process count is resharded
        to this run's ``(n, k)`` first (:func:`_reshard`, the elastic
        resume); scalar entries (step counts) pass through.
        ``load_state_dict`` numbers the state in the order of the
        optimizer's groups, which need not be the model's: each parameter
        index is mapped to its shard's place there."""
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
                    shape = self.stack_shape(i)
                    if tuple(value.shape) != shape:
                        value = _reshard(value, shape)
                    value = value[self.rank].clone()
                rows[key] = value
            by_place[place[self.shards[p]]] = rows
        groups = self.optimizer.state_dict()['param_groups']
        self.optimizer.load_state_dict({'state': by_place,
                                        'param_groups': groups})
