"""MeshPlan: named axes over the processes (data x model [x pipe]).

Counterpart of ``chainermn_tpu/parallel/meshplan.py``.  The JAX plan is
one device mesh with named roles whose collectives XLA inserts inside
``shard_map``; here each process drives one device, as in the reference
ChainerMN, so a mesh is one of PROCESSES (:class:`ProcessMesh`, laid out
row-major over its named axes) and every axis is a set of
``torch.distributed`` sub-groups, one per line of the mesh along it
(``communicators.mesh_utility.new_groups``).

An axis NAME (``'model'``, ``'sp'``, ...) resolves to this process's
group along it through the mesh that the caller binds
(``with plan.bind():`` or ``with mesh.bind():``), or that
:class:`~chainermn_tpu_torch.training.StandardUpdater` binds around the
forward and backward of a ``MeshPlanCommunicator``; there is no global
default, and an unbound name raises.  The binding is a process-wide
stack, not a thread-local one: CUDA backward passes run on autograd's
own threads, and a recompute under ``remat`` resolves names there too.

Degradation is shape-only, as in the JAX package: the requested tp
clamps to the largest divisor of the process count
(``mesh_utility.divisor_leq``), so 1 process gives ``(1, 1)``, tp >= n
gives ``(1, n)`` and tp = 1 gives ``(n, 1)``; both axis names always
exist, and a collective over an axis of size 1 is the identity (no
call is made).  ``MeshPlan.create(tp=, pp=)`` adds the ``pipe`` axis as
the minor one, ``rank = (d * tp + m) * pp + p``, and clamps tp first and
pp within what remains (``mesh_utility.divisors_leq``): one process
gives ``(1, 1, 1)``.  Its ``(data, pipe)`` plane, which the pipeline
updaters reduce the replicated ends' gradients and the metrics over,
gets a group of its own (a composite axis of a :class:`ProcessMesh`).

What has no torch meaning: the JAX plan hands out ``NamedSharding`` /
``PartitionSpec`` trees that PLACE arrays on a JAX mesh
(``batch_spec``, ``replicated``, ``sharding``, ``batch_sharding``,
``param_shardings``, ``state_specs``).  A process that drives one
device holds its own shard as an ordinary tensor, so those methods are
not here (ROADMAP.md A1); a parameter's layout over the axes is a spec
tuple (``models.tp_param_specs``) read by
``models.shard_variables`` / ``gather_variables``; a pipeline's stage
tree is placed by :meth:`MeshPlan.stage_specs`.  ``ep=`` and
``slices=`` (the expert and slice axes) are not ported yet (ROADMAP.md
item 8).
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators import memory_utility, mesh_utility
from chainermn_tpu_torch.communicators.base import (
    CommunicatorBase, join_default_group)

#: canonical plan axis names (the JAX package's)
AXIS_DATA = 'data'
AXIS_MODEL = 'model'
AXIS_PIPE = 'pipe'
AXIS_EXPERT = 'expert'
AXIS_SLICE = 'slice'
PLAN_AXES = (AXIS_DATA, AXIS_MODEL)
PLAN_AXES_3D = (AXIS_DATA, AXIS_MODEL, AXIS_PIPE)

_BOUND = []   # the binding stack: innermost last


class Axis:
    """One named axis (or a tuple of them) as this process sees it:
    ``size`` processes along it, this process at ``index``, their global
    ``ranks`` in index order, and the ``group`` to reduce over (None
    when ``size`` is 1: nothing to communicate)."""

    def __init__(self, name, size, index, ranks, group):
        self.name, self.size, self.index = name, size, index
        self.ranks, self.group = list(ranks), group

    def __repr__(self):
        return 'Axis(%r, size=%d, index=%d)' % (self.name, self.size,
                                               self.index)


def _names(axis):
    return (axis,) if isinstance(axis, str) else tuple(axis)


class ProcessMesh:
    """The processes laid out row-major over named axes: the
    counterpart of ``jax.sharding.Mesh`` for one process per device.

    ``shape`` and ``axis_names`` as in a JAX mesh; this process (global
    ``rank``, default the default group's) sits at ``coords``.  With
    ``groups=True`` (the default when a process group exists) every axis
    of size > 1 gets its sub-groups now, by every process in the same
    order: making a group is a collective over the whole world.
    ``groups=False`` builds a shape-only mesh (what
    ``MeshPlan.create(size=)`` computes with no processes); binding one
    to a collective over an axis of size > 1 raises.

    ``composites``: tuples of axis names whose planes (every line of the
    mesh along all of them at once) get groups of their own, made after
    the axes' groups, where a plane spans more than one axis of size > 1
    and less than the whole world (a single wide axis reuses its group,
    the whole world the default group)."""

    def __init__(self, shape, axis_names, rank=None, groups=None,
                 composites=()):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError('shape %r and axis names %r differ in length'
                             % (shape, axis_names))
        if len(set(axis_names)) != len(axis_names):
            raise ValueError('axis names %r repeat' % (axis_names,))
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.size = int(np.prod(shape)) if shape else 1
        live = dist.is_initialized()
        if rank is None:
            rank = dist.get_rank() if live else 0
        if not 0 <= rank < self.size:
            raise ValueError('rank %d is outside a mesh of %d processes'
                             % (rank, self.size))
        self.rank = rank
        self.coords = tuple(int(c) for c in np.unravel_index(rank, shape))
        if groups is None:
            groups = live and dist.get_world_size() > 1
        if groups and dist.get_world_size() != self.size:
            raise ValueError('a mesh of %d processes in a world of %d'
                             % (self.size, dist.get_world_size()))
        self._groups = {}
        if groups:
            for name in axis_names:
                if self.shape[name] > 1:
                    self._groups[name] = mesh_utility.new_groups(
                        self._lines((name,)), rank)
            for names in composites:
                wide = frozenset(n for n in names if self.shape[n] > 1)
                if (len(wide) > 1 and wide not in self._groups
                        and self.axis_size(names) < self.size):
                    self._groups[wide] = mesh_utility.new_groups(
                        self._lines(tuple(names)), rank)
        self._live = bool(groups)

    def _lines(self, names):
        """Every line (or plane) of the mesh along ``names``: lists of
        global ranks, major to minor in ``names``' order (the same for
        every process)."""
        idx = [self.axis_names.index(n) for n in names]
        ids = np.arange(self.size).reshape(tuple(self.shape.values()))
        moved = np.moveaxis(ids, idx, range(-len(idx), 0))
        return [[int(r) for r in row]
                for row in moved.reshape(-1, self.axis_size(names))]

    def _line(self, names):
        """The global ranks along ``names`` through this process, major
        to minor in ``names``' order (as ``lax.axis_index`` of a tuple
        counts)."""
        for n in names:
            if n not in self.shape:
                raise ValueError('mesh %r binds no axis %r'
                                 % (self.shape, n))
        ids = np.arange(self.size).reshape(tuple(self.shape.values()))
        index = tuple(slice(None) if n in names else c
                      for n, c in zip(self.axis_names, self.coords))
        sub = ids[index]
        # reorder the kept dims to the tuple's order
        kept = [n for n in self.axis_names if n in names]
        sub = np.transpose(sub, [kept.index(n) for n in names])
        return [int(r) for r in sub.reshape(-1)]

    def axis_index(self, axis):
        """This process's index along ``axis`` (a name or a tuple)."""
        return self._line(_names(axis)).index(self.rank)

    def local(self, x, spec):
        """This process's shard of the global array ``x`` under
        ``spec`` (a tuple of None / axis name / tuple of names per
        leading dim): each sharded dim cut into equal blocks, block
        ``axis_index`` kept (what ``shard_map``'s ``in_specs`` hand a
        device)."""
        for i, axes in enumerate(tuple(spec)):
            if axes is None:
                continue
            n = self.axis_size(axes)
            if x.shape[i] % n:
                raise ValueError('dim %d of shape %r does not divide over '
                                 'axis %r (size %d)'
                                 % (i, tuple(x.shape), axes, n))
            k = x.shape[i] // n
            x = x.narrow(i, self.axis_index(axes) * k, k)
        return x

    def axis(self, axis):
        """The :class:`Axis` of a name or a tuple of names."""
        names = _names(axis)
        ranks = self._line(names)
        size = len(ranks)
        pos = ranks.index(self.rank)
        wide = [n for n in names if self.shape[n] > 1]
        group = None
        if size > 1:
            if not self._live:
                raise RuntimeError(
                    'axis %r has %d processes but this mesh was built '
                    'without process groups' % (axis, size))
            if len(wide) == 1:
                group = self._groups[wide[0]]
            elif frozenset(wide) in self._groups:
                group = self._groups[frozenset(wide)]
            elif size == dist.get_world_size():
                group = dist.group.WORLD
            else:
                raise NotImplementedError(
                    'a collective over the composite axis %r (part of '
                    'the mesh) has no group: build the mesh with it in '
                    'composites=' % (axis,))
        return Axis(axis, size, pos, ranks, group)

    def axis_size(self, axis):
        return int(np.prod([self.shape[n] for n in _names(axis)]))

    @contextlib.contextmanager
    def bind(self):
        """Bind this mesh's axis names for the block (see the module
        docstring)."""
        _BOUND.append(self)
        try:
            yield self
        finally:
            _BOUND.remove(self)

    def __repr__(self):
        return 'ProcessMesh(%s)' % ', '.join(
            '%s=%d' % kv for kv in self.shape.items())


def bound_mesh(axis):
    """The innermost bound mesh that binds every name of ``axis`` (a
    name or a tuple of names); raises ``ValueError`` when none does."""
    names = _names(axis)
    for mesh in reversed(_BOUND):
        if all(n in mesh.shape for n in names):
            return mesh
    raise ValueError(
        'axis %r is bound by no mesh: call inside `with plan.bind():` (or '
        'a ProcessMesh\'s bind(), or a StandardUpdater over '
        'plan.communicator())' % (axis,))


def resolve_axis(axis):
    """The :class:`Axis` of ``axis`` in :func:`bound_mesh`."""
    return bound_mesh(axis).axis(axis)


class MeshPlan:
    """A ``(data, model)`` or ``(data, model, pipe)`` mesh of processes
    plus what training on it needs.

    Attributes (the JAX plan's): ``mesh`` (a :class:`ProcessMesh`),
    ``data_axes`` (what gradient reduction, the batch scatter and ZeRO
    span), ``model_axis`` (the tensor-parallel axis), ``pipe_axis`` (the
    pipeline-stage axis, or None on a 2-D plan), ``requested_tp`` /
    ``requested_pp``; ``expert_axis`` and ``slice_axis`` are None (not
    ported yet, ROADMAP.md item 8).  A mesh that binds the name
    ``'pipe'`` is a 3-D plan.
    """

    def __init__(self, mesh, data_axes=(AXIS_DATA,), model_axis=AXIS_MODEL,
                 requested_tp=None, device=None, pipe_axis=None,
                 requested_pp=None):
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        if model_axis is not None and model_axis not in mesh.shape:
            model_axis = None
        self.model_axis = model_axis
        for ax in (AXIS_EXPERT, AXIS_SLICE):
            if ax in mesh.shape:
                raise NotImplementedError(
                    'the %r axis is not ported yet (ROADMAP.md item 8)'
                    % ax)
        if pipe_axis is None and AXIS_PIPE in mesh.shape:
            pipe_axis = AXIS_PIPE
        self.pipe_axis = pipe_axis
        self.expert_axis = self.slice_axis = None
        self.requested_tp = requested_tp
        self.requested_pp = requested_pp
        self.device = device
        self._owns_group = False
        for ax in self.data_axes + tuple(
                a for a in (model_axis, pipe_axis) if a is not None):
            if ax not in mesh.shape:
                raise ValueError('mesh %r does not bind plan axis %r'
                                 % (mesh.shape, ax))

    @classmethod
    def create(cls, tp=1, axis_names=PLAN_AXES, pp=None, ep=None,
               slices=None, size=None, rank=None, device=None):
        """Compose a plan over the processes.

        ``tp`` is the requested model-axis width; it degrades to the
        largest divisor of the process count, never erring on a small
        world.  The model axis is the minor one: ``rank = data_index *
        tp + model_index``, so a node's neighbouring processes share a
        tensor-parallel group.

        ``pp`` (an int >= 1) adds the pipeline axis: the mesh becomes
        ``(data, model, pipe)`` with ``pipe`` the minor axis, ``rank =
        (d * tp + m) * pp + p``, so a stage's neighbours are the
        neighbouring processes.  tp clamps first, pp within what remains
        (``mesh_utility.divisors_leq``), the data axis takes the rest;
        the names never change with the shape.  ``pp=None`` keeps the
        2-D plan.  ``axis_names`` may name the three axes.

        With ``size`` (and ``rank``, default 0) the plan is shape-only
        (no process group is needed or made).  Otherwise the default
        group is joined, or made as a communicator makes it (torchrun's
        environment, else a world of one on ``device``), and the axes'
        sub-groups are made here: call it on every process in the same
        order.  A group made here is destroyed by the plan's communicator's
        ``close()``."""
        if tp < 1:
            raise ValueError('tp must be >= 1, got %d' % tp)
        if slices is not None and slices < 1:
            raise ValueError('slices must be >= 1, got %d' % slices)
        if ep is not None or slices is not None:
            raise NotImplementedError(
                'MeshPlan.create(ep=, slices=) is not ported yet '
                '(ROADMAP.md item 8)')
        if pp is not None and pp < 1:
            raise ValueError('pp must be >= 1, got %d' % pp)
        made = False
        if size is None:
            device, made = join_default_group(device)
            size, rank = dist.get_world_size(), dist.get_rank()
            groups = size > 1
        else:
            rank, groups = (0 if rank is None else rank), False
        if pp is None:
            eff = mesh_utility.divisor_leq(size, tp)
            data_name, model_name = axis_names
            plan = cls(ProcessMesh((size // eff, eff),
                                   (data_name, model_name), rank=rank,
                                   groups=groups),
                       data_axes=(data_name,), model_axis=model_name,
                       requested_tp=tp, device=device)
        else:
            if len(axis_names) == 2:
                axis_names = tuple(axis_names) + (AXIS_PIPE,)
            data_name, model_name, pipe_name = axis_names
            eff_tp, eff_pp = mesh_utility.divisors_leq(size, (tp, pp))
            plan = cls(ProcessMesh(
                (size // (eff_tp * eff_pp), eff_tp, eff_pp), axis_names,
                rank=rank, groups=groups,
                composites=((data_name, pipe_name),)),
                data_axes=(data_name,), model_axis=model_name,
                requested_tp=tp, device=device, pipe_axis=pipe_name,
                requested_pp=pp)
        plan._owns_group = made
        return plan

    # -- topology ------------------------------------------------------
    @property
    def size(self):
        return self.mesh.size

    @property
    def data_size(self):
        return self.mesh.axis_size(self.data_axes)

    @property
    def model_size(self):
        if self.model_axis is None:
            return 1
        return self.mesh.shape[self.model_axis]

    @property
    def pipe_size(self):
        """Pipeline-stage count (1 without a pipe axis: a pipeline of one
        stage is the unpipelined program)."""
        if self.pipe_axis is None:
            return 1
        return self.mesh.shape[self.pipe_axis]

    @property
    def expert_size(self):
        return 1

    @property
    def slice_size(self):
        return 1

    @property
    def axis_names(self):
        return self.mesh.axis_names

    def describe(self):
        """Provenance dict for bench rows and checkpoint manifests."""
        out = {'axes': {k: int(v) for k, v in self.mesh.shape.items()},
               'data_axes': list(self.data_axes),
               'model_axis': self.model_axis,
               'requested_tp': self.requested_tp,
               'effective_tp': int(self.model_size)}
        if self.pipe_axis is not None:
            out['pipe_axis'] = self.pipe_axis
            out['requested_pp'] = self.requested_pp
            out['effective_pp'] = int(self.pipe_size)
        return out

    def local_shape(self, shape, spec):
        """The per-process shape of a global ``shape`` under ``spec`` (a
        tuple of None / axis name / tuple of names per dim): sharded
        dims divided by their axes' sizes."""
        shape = list(shape)
        for i, axes in enumerate(tuple(spec) + (None,) * (
                len(shape) - len(tuple(spec)))):
            if axes is None:
                continue
            for ax in _names(axes):
                k = self.mesh.shape[ax]
                if shape[i] % k:
                    raise ValueError(
                        'dim %d of shape %r does not divide over axis '
                        '%r (size %d)' % (i, tuple(shape), ax, k))
                shape[i] //= k
        return tuple(shape)

    def stage_specs(self, params_stacked, body_specs=None):
        """The spec tree placing each pipeline stage's parameters on its
        ``pipe`` coordinate: every leaf of a stage-STACKED tree (leading
        dim = ``pipe_size``) gets ``(pipe_axis,)``, or, with
        ``body_specs`` (a spec tree over the unstacked leaf dims, e.g. a
        stage body's Megatron specs), ``(pipe_axis, *body_spec)``."""
        if self.pipe_axis is None:
            raise ValueError('stage_specs needs a pipeline axis: build the '
                             'plan with MeshPlan.create(pp=...)')

        def walk(tree, body):
            if isinstance(tree, dict):
                return {k: walk(v, None if body is None else body[k])
                        for k, v in tree.items()}
            return (self.pipe_axis,) + (tuple(body) if body else ())

        return walk(params_stacked, body_specs)

    def bind(self):
        """Bind the plan's axis names for the block."""
        return self.mesh.bind()

    def communicator(self, reduce_dtype=None):
        """The updater-facing communicator (gradient reduction, the
        first-call broadcast and the batch scatter over the data axes
        only)."""
        return MeshPlanCommunicator(self, reduce_dtype=reduce_dtype)

    def __repr__(self):
        return 'MeshPlan(%r)' % (self.mesh,)


class MeshPlanCommunicator(CommunicatorBase):
    """Communicator over a :class:`MeshPlan`.

    The data-parallel contract is scoped to the plan's data axes:
    :meth:`allreduce_grad` means over the data group only (a
    tensor-parallel leaf is SHARDED over ``model``; its gradients are
    exact per shard and must not be combined across that axis),
    :meth:`broadcast_data` sends data replica ``root``'s values to the
    other replicas of the same model index (model shards are left
    alone), and ``size`` / ``rank`` count DATA replicas, which is what
    ``scatter_dataset`` and the streaming loader read, so every model
    rank of a replica sees the same batch.  :meth:`allreduce` (metrics,
    statistics) still spans every process: losses after the model
    axis's reductions are replicated over it.  The object channel and
    ``barrier`` count processes (``world_rank`` / ``world_size``).

    Its process layout is the plan's: ``(inter, intra)`` = ``(data,
    model)``, and its sub-groups are the plan's own: the groups of the
    data axis and of the model axis, made once by the plan's
    :class:`ProcessMesh` (None along an axis of size 1)."""

    def __init__(self, plan, reduce_dtype=None):
        if plan.model_axis is None or len(plan.data_axes) != 1:
            raise NotImplementedError(
                'a MeshPlanCommunicator needs one data axis and a model '
                'axis')
        if plan.pipe_size > 1:
            raise NotImplementedError(
                'a plan with %d pipeline stages trains through '
                'training.MeshPipelineUpdater, which reduces over the plan '
                'itself' % plan.pipe_size)
        self.plan = plan
        super().__init__(device=plan.device, reduce_dtype=reduce_dtype,
                         mesh_shape=(plan.data_size, plan.model_size))
        if plan._owns_group:            # the communicator closes it now
            self._owns_group, plan._owns_group = True, False
        self.reduction_axes = plan.data_axes
        self.data_axes = plan.data_axes
        self._data_ranks = plan.mesh.axis(plan.data_axes).ranks

    def _make_groups(self):
        mesh = self.plan.mesh
        return (mesh.axis(self.plan.model_axis).group,
                mesh.axis(self.plan.data_axes).group)

    # -- topology ------------------------------------------------------
    @property
    def size(self):
        """Number of DATA replicas (the batch divisor and the ZeRO
        partition count), not the process count (``world_size``)."""
        return self.plan.data_size

    @property
    def rank(self):
        """This process's data-replica index."""
        return self.world_rank // self.plan.model_size

    @property
    def data_group(self):
        """The process group of this process's data axis (what ZeRO-1
        scatters and gathers over)."""
        return self._inter_group

    def axis_rank(self):
        return self.rank

    def inter_rank(self):
        return self.rank

    def model_rank(self):
        return self.world_rank % self.plan.model_size

    def intra_rank(self):
        return self.model_rank()

    # -- collectives ---------------------------------------------------
    def _allreduce_impl(self, tensors):
        group = self._inter_group

        def reduce(buf):
            if self.size > 1:
                dist.all_reduce(buf, group=group)
                buf /= self.size
            return buf
        return memory_utility.fused_reduce(tensors, reduce)

    @torch.no_grad()
    def broadcast_data(self, params, root=0):
        """Every data replica receives replica ``root``'s values of the
        same model index, IN PLACE (one broadcast per dtype)."""
        params = list(params)
        if not params or self.size == 1:
            return params
        groups = {}
        for p in params:
            groups.setdefault(p.dtype, []).append(p)
        for ps in groups.values():
            buf = torch.cat([p.detach().reshape(-1) for p in ps])
            dist.broadcast(buf, src=self._data_ranks[root],
                           group=self._inter_group)
            offset = 0
            for p in ps:
                n = p.numel()
                p.copy_(buf[offset:offset + n].view(p.shape))
                offset += n
        return params

    def __repr__(self):
        return 'MeshPlanCommunicator(%s)' % ', '.join(
            '%s=%d' % kv for kv in self.plan.mesh.shape.items())
