"""Standard updater: one data-parallel training iteration per call.

Counterpart of ``chainermn_tpu/training/updater.py``.  The JAX updater
compiles loss, gradient, reduction, optimizer step and metric averaging
into one SPMD program; here the same steps run eagerly in each process:

1. collate the next batch (cast to the policy's compute dtype on the
   host) and move it to the model's device;
2. forward and backward, once per micro-batch (a train-mode forward
   also updates the BatchNorm running statistics in the model's
   buffers); under a policy the forward sees compute-dtype copies of the
   f32 master parameters, and under ``remat`` the backward recomputes
   the forward;
3. under a loss scale: unscale the local gradients and agree across
   processes whether they are finite; a non-finite step stops here;
4. mean-sync the running statistics across processes (``model_state``):
   batch statistics stay local, so this is not ``SyncBatchNorm``;
5. the optimizer step (with a multi-node optimizer: broadcast at the
   first call, gradient mean-allreduce + step afterwards; under
   ``zero=True`` the same over flat shards: reduce-scatter, step,
   all-gather);
6. mean-average the metrics across processes (in f32).

Telemetry (:mod:`~chainermn_tpu_torch.telemetry`), with the JAX
updater's span names, each tagged ``iteration=``: ``host_batch_prep``
(collation, ``kind='host'``), ``h2d`` (the copy to the device,
``kind='h2d'``), ``jitted_step`` (steps 2-6, ``kind='compute'``) and
``metrics_sync`` (the host read of ``update(sync=True)``,
``kind='host'``).  Under ``device_prefetch`` the first two run on the
prefetch thread, for the batch it reads ahead.  A span covers the
card's work only when the session asked for fences
(``telemetry.enable(sync_fences=True)``); then ``h2d`` and
``jitted_step`` wait for the card before they close.  With telemetry
off each span is a no-op context and nothing waits.

Fault injection (:mod:`~chainermn_tpu_torch.utils.chaos`), as in the JAX
updater: ``on_step`` (``sigterm_step``, ``kill_step``, ``hang_step``,
``slice_loss``) at the top of :meth:`StandardUpdater.update_core`, and
``corrupt_batch`` (``nan_batch``) where a batch is collated.

The JAX updater's device placement (``training/placement.py``: putting
a host batch or a restored tree on a multi-host mesh with given
shardings) has no counterpart: each process here drives one device and
moves its own tensors with ``.to(device)``.
"""

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from chainermn_tpu_torch import telemetry as _telemetry
from chainermn_tpu_torch.models._layers import (
    replaying, set_dropout_generator)
from chainermn_tpu_torch.models._norm import recomputing
from chainermn_tpu_torch.models.flax_weights import (
    gather_variables, to_flax_variables)
from chainermn_tpu_torch.parallel import zero as zero_mod
from chainermn_tpu_torch.precision import all_finite
from chainermn_tpu_torch.training.convert import concat_examples
from chainermn_tpu_torch.training.iterators import DevicePrefetchIterator
from chainermn_tpu_torch.utils import chaos as _chaos


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    else:
        yield tree


class _LossCall(nn.Module):
    """Holds the model as its submodule ``model`` and calls ``loss_fn``:
    ``torch.func.functional_call`` on it swaps the model's own
    parameters for the call, which a ``loss_fn`` that closes over the
    model then sees."""

    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, *batch):
        return self.loss_fn(*batch)


class StandardUpdater:
    """Advances one iteration per :meth:`update`.

    Args:
      iterator: batch iterator (items collated by ``concat_examples``).
      optimizer: typically the result of
        :func:`chainermn_tpu_torch.create_multi_node_optimizer`.
      loss_fn: ``loss_fn(*batch) -> (loss, metrics_dict)``, e.g.
        ``StatefulClassifier(model).loss``.
      model: the ``nn.Module`` being trained; batches go to its device.
      comm: communicator for the statistics and metric averages.
      model_state: mean-sync the model's buffers (BatchNorm running
        statistics) across processes after every step.
      accum_steps: with k > 1 the per-process batch is split into k
        micro-batches, each run forward and backward in turn; the
        gradients are accumulated and scaled by 1/k before the one
        optimizer step, the metrics averaged.  The running statistics
        thread through the micro-batches and are synced once a step
        (the JAX package syncs after each: the same in exact
        arithmetic, the update being linear).  Each micro-batch draws
        its own dropout masks.  A batch that k does not divide raises
        ``ValueError``.
      policy: a :class:`~chainermn_tpu_torch.precision.Policy`.  Master
        parameters stay ``param_dtype`` (f32) in the model; the forward
        and backward see ``compute_dtype`` copies made inside the
        differentiated region (``torch.func.functional_call``), so every
        gradient comes back in the master dtype through the cast.  This
        casts every floating parameter, BatchNorm's scale and bias too,
        as the JAX updater does; the buffers (running statistics) stay
        f32.  Batches are cast to the compute dtype on the host
        (``_collate``; ``collate_pinned`` and ``device_prefetch``
        inherit it); metric averages are taken in f32; the policy's
        ``reduce_dtype`` becomes the communicator's ``reduce_dtype``
        when it has none (under ``zero=True``, the reduce-scatter's
        dtype instead).  Not ``torch.autocast``: that keeps some ops
        in f32 and so computes another function.
        A policy with a ``loss_scale`` (``Policy.f16()``) multiplies the
        differentiated loss by the scale (the reported loss is
        unscaled), unscales the local gradients before the allreduce,
        takes the finiteness verdict as ``all_finite`` min-allreduced
        across processes, and on a non-finite verdict skips the step on
        every process: the optimizer is not stepped (parameters, its
        state and a pending first broadcast stay as they were), while
        the step's BatchNorm running statistics are kept and synced, as
        the JAX updater keeps its ``new_state``, even where they are
        non-finite (a non-finite batch makes them so in both packages;
        a backward that alone overflows leaves them finite).  Then the
        scale
        adjusts; the metrics carry ``loss_scale`` (the scale this step
        used) and ``grads_finite``.  The verdict is read on the host to
        skip the step: one host-device sync a step, under a loss-scaled
        policy only.
      remat: the backward recomputes the forward (``torch.utils.
        checkpoint``, non-reentrant) instead of keeping its activations.
        The recompute neither updates the running statistics again
        (``models._norm.recomputing``) nor draws new dropout masks (the
        dropout generator is put back to its state at the forward,
        ``models._layers.replaying``).
      device_prefetch: with N >= 1, the iterator is wrapped in a
        :class:`~chainermn_tpu_torch.training.DevicePrefetchIterator` of
        depth N: the next batches are collated into pinned host memory
        and copied to the device on a side stream while the step runs.
      rng: the seed (an int, default 0) of the dropout masks.  When the
        model has :class:`~chainermn_tpu_torch.models.Dropout` layers,
        the updater owns one generator on the model's device
        (``dropout_generator``), points them at it, and reseeds it from
        (seed, iteration, rank) before every step: the counterpart of
        the JAX updater's ``fold_in(fold_in(rng, iteration), rank)``.
      zero: ZeRO-1 (:mod:`chainermn_tpu_torch.parallel.zero`): pass the
        RAW ``torch.optim`` optimizer over the model's parameters (the
        multi-node wrapper is refused: the first call's broadcast is
        built in, at iteration 0).  Its parameter groups are handed flat
        shards, so its state is 1/N over the communicator's ``size``
        data processes; each step mean-reduce-scatters the gradients,
        steps the shards and all-gathers them back.  Only elementwise
        optimizers keep the replicated trajectory, which
        ``zero.check_elementwise`` probes for unless ``zero_check=False``
        (``zero.chain(zero.clip_by_global_norm(c), opt)`` is admitted).
        ``zero.lars`` / ``zero.lamb`` (and ``zero.chain(zero.
        scale_by_trust_ratio(), ...)``) are admitted too: their per-leaf
        norms are completed over the data group, one packed all-reduce a
        step; without ZeRO the gradients are already reduced and the
        norms stay local.  Composes with ``accum_steps``, with npz
        snapshots (the state is saved gathered, ``(N, k)`` a tensor, and
        resumed at any M: ``serializers.resume_updater`` reshards it)
        and with ``policy=``: the policy's ``reduce_dtype`` drives the
        reduce-scatter (``zero_reduce_dtype`` with a policy raises
        ``ValueError``), and a non-finite loss-scaled step skips the
        update on the shards (the first call's weight sync is kept).
      zero_check: probe the optimizer for ``zero=True`` (default);
        ``False`` waves a false positive through.
      zero_reduce_dtype: under ``zero=True`` without a policy, the dtype
        the gradients are reduce-scattered in (cast back for the
        optimizer); a policy's ``reduce_dtype`` subsumes it.
      param_specs: the spec tree of the model's parameters over the
        plan's axes (default: the model's own ``param_specs``, which a
        ``tp_axis`` ``TransformerLM`` carries); with a
        ``MeshPlanCommunicator`` the updater binds the plan's mesh
        around the forward and backward, reduces gradients over the data
        axis only, and :attr:`params` gathers the shards.  ZeRO of a
        model-sharded parameter is refused, as in the JAX package; a
        leaf whose spec names only axes of one process (the plan's
        degraded (1, 1)) is whole, and ZeRO takes it.
    """

    def __init__(self, iterator, optimizer, loss_fn, model, comm,
                 model_state=True, zero=False, accum_steps=1, policy=None,
                 remat=False, device_prefetch=0, rng=None, zero_check=True,
                 zero_reduce_dtype=None, param_specs=None):
        if zero_reduce_dtype is not None and not zero:
            raise ValueError('zero_reduce_dtype requires zero=True '
                             '(use allreduce_dtype on the multi-node '
                             'optimizer for the plain path)')
        if policy is not None and zero_reduce_dtype is not None:
            raise ValueError(
                'zero_reduce_dtype is subsumed by the policy: set '
                'Policy(reduce_dtype=...) instead of passing both')
        if accum_steps < 1:
            raise ValueError('accum_steps must be >= 1')
        _telemetry.maybe_enable_from_env()
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.model = model
        self.comm = comm
        self.model_state = model_state
        self.accum_steps = int(accum_steps)
        self.policy = policy
        self.loss_scale = policy.loss_scale if policy is not None else None
        self.remat = bool(remat)
        self.device = next(model.parameters()).device
        self.iteration = 0
        self.seed = 0 if rng is None else int(rng)
        gen = torch.Generator(self.device)
        self.dropout_generator = \
            gen if set_dropout_generator(model, gen) else None
        self._loss_call = None
        if policy is not None:
            for p in model.parameters():
                if p.is_floating_point() and p.dtype != policy.param_dtype:
                    p.data = p.data.to(policy.param_dtype)  # the masters
            if any(p.is_floating_point() and p.dtype != policy.compute_dtype
                   for p in model.parameters()):
                self._loss_call = _LossCall(model, loss_fn)
            if (policy.reduce_dtype is not None and not zero
                    and getattr(comm, 'reduce_dtype', None) is None):
                # the ZeRO path narrows its own reduce-scatter instead
                comm.reduce_dtype = policy.reduce_dtype
        self.scale_state = (self.loss_scale.init(self.device)
                            if self.loss_scale is not None else None)
        plan = getattr(comm, 'plan', None)
        self._mesh = plan.mesh if plan is not None else None
        self.param_specs = (param_specs if param_specs is not None
                            else getattr(model, 'param_specs', None))
        # a leaf is model-sharded when its spec names an axis of more
        # than one process (every named axis without a plan): at a plan's
        # degraded (1, 1) a tensor-parallel model's leaves are whole
        sharded = self.param_specs is not None and any(
            e is not None and (self._mesh is None
                               or self._mesh.axis_size(e) > 1)
            for spec in _spec_leaves(self.param_specs) for e in spec)
        self._zero = None
        if zero:
            if hasattr(optimizer, 'actual_optimizer'):
                raise ValueError(
                    'zero=True needs the raw optimizer, not the multi-node '
                    'wrapper (broadcast-first is built in)')
            if sharded:
                raise NotImplementedError(
                    'zero=True with model-sharded param_specs is not '
                    'implemented: the ZeRO stacked-state layout has no '
                    'host-level representation for leaves that also vary '
                    'over the model axis.  Under a MeshPlan, ZeRO '
                    'partitions along the data axes of a REPLICATED '
                    'parameter tree only.')
            if zero_check:
                zero_mod.check_elementwise(optimizer)
            self._zero = zero_mod.ZeroStep(
                optimizer, model.parameters(), comm.size, comm.rank,
                group=getattr(comm, 'data_group', None),
                reduce_dtype=(policy.reduce_dtype if policy is not None
                              else zero_reduce_dtype))
        #: snapshots gather across processes (every process must call
        #: ``serializers.updater_state``)
        self.collective_state = (
            (self._zero is not None and comm.size > 1)
            or (sharded and plan is not None))
        self._device_prefetch = bool(device_prefetch)
        if device_prefetch:
            iterator = DevicePrefetchIterator(
                iterator, self._place, depth=device_prefetch,
                device=self.device)
        self.iterator = iterator

    def _collate(self, batch):
        arrays = concat_examples(
            batch, dtype=(self.policy.compute_dtype
                          if self.policy is not None else None))
        if isinstance(arrays, dict):
            arrays = tuple(arrays.values())
        if _chaos._active is not None:  # nan_batch fault injection
            arrays = _chaos.corrupt_batch(arrays)
        return arrays

    def _to_device(self, host, non_blocking=False):
        """The ``h2d`` span: ``host`` tensors copied to the device."""
        with _telemetry.span('h2d', kind='h2d',
                             iteration=self.iteration) as sp:
            return sp.sync(tuple(t.to(self.device,
                                      non_blocking=non_blocking)
                                 for t in host))

    def shard_batch(self, batch):
        """Collate a list of examples and move it to the device."""
        with _telemetry.span('host_batch_prep', kind='host',
                             iteration=self.iteration):
            host = tuple(torch.as_tensor(a) for a in self._collate(batch))
        return self._to_device(host)

    def collate_pinned(self, batch):
        """Collate a list of examples into host tensors, pinned when the
        model is on a CUDA device (a copy from pinned memory can run
        asynchronously)."""
        host = [torch.as_tensor(a) for a in self._collate(batch)]
        if self.device.type == 'cuda':
            host = [t.pin_memory() for t in host]
        return tuple(host)

    def _place(self, batch):
        """``device_prefetch``'s placement: pinned collation, then a
        non-blocking copy (on the prefetcher's side stream)."""
        with _telemetry.span('host_batch_prep', kind='host',
                             iteration=self.iteration):
            host = self.collate_pinned(batch)
        return self._to_device(host, non_blocking=True)

    # -- the differentiated region ----------------------------------------
    def _loss(self, *batch):
        """``loss_fn`` on compute-dtype copies of the parameters (under a
        policy), or on the parameters themselves."""
        if self._loss_call is None:
            return self.loss_fn(*batch)
        dtype = self.policy.compute_dtype
        params = {'model.' + name: (p.to(dtype) if p.is_floating_point()
                                    else p)
                  for name, p in self.model.named_parameters()}
        return torch.func.functional_call(self._loss_call, params, batch)

    def _remat_contexts(self):
        """``checkpoint``'s ``context_fn``, called as the forward starts:
        nothing around the forward; around the recompute, no running
        statistics update and the dropout generator replayed from here."""
        gen = self.dropout_generator
        state = gen.get_state() if gen is not None else None

        @contextlib.contextmanager
        def recompute():
            with recomputing(), replaying(gen, state):
                yield

        return contextlib.nullcontext(), recompute()

    def _bound(self):
        """The plan's mesh bound (a ``MeshPlanCommunicator``), else
        nothing."""
        if self._mesh is None:
            return contextlib.nullcontext()
        return self._mesh.bind()

    def _forward_backward(self, batch, scale):
        """Forward and backward of one (micro-)batch; gradients add into
        the parameters' ``grad``.  Returns the metrics and the unscaled
        loss as detached tensors, floating ones (and flags) in f32: the
        metric averages are f32 whatever the compute dtype."""
        with self._bound():
            if self.remat:
                loss, metrics = checkpoint(self._loss, *batch,
                                           use_reentrant=False,
                                           context_fn=self._remat_contexts)
            else:
                loss, metrics = self._loss(*batch)
            (loss if scale is None
             else loss * scale.to(loss.dtype)).backward()
        out = {}
        for key, v in dict(metrics, loss=loss).items():
            v = torch.as_tensor(v, device=self.device).detach()
            out[key] = (v.to(torch.float32) if v.is_floating_point()
                        or v.dtype == torch.bool else v)
        return out

    def update_core(self, arrays):
        """One iteration on device tensors; returns the averaged metrics
        as 0-d tensors (no host sync, except the loss-scale verdict and
        a fenced ``jitted_step`` span)."""
        if _chaos._active is not None:  # sigterm / kill / hang_step
            _chaos.on_step(self.iteration)
        with _telemetry.span('jitted_step', kind='compute',
                             iteration=self.iteration) as sp:
            metrics = self._step(arrays)
            sp.sync(tuple(metrics.values()))
        return metrics

    def _step(self, arrays):
        k = self.accum_steps
        if arrays[0].shape[0] % k:
            raise ValueError('batch size %d must be divisible by '
                             'accum_steps %d' % (arrays[0].shape[0], k))
        if self._zero is not None:
            self.model.zero_grad(set_to_none=True)
        else:
            self.optimizer.zero_grad(set_to_none=True)
        if self.dropout_generator is not None:
            self.dropout_generator.manual_seed(
                ((self.seed * 1000003 + self.iteration) * 65537
                 + self.comm.rank) % 2 ** 63)
        # a model without buffers (the transformer) has nothing to sync:
        # no collective is issued for it
        buffers = list(self.model.buffers()) if self.model_state else []
        scale = None
        if self.loss_scale is not None:
            scale = self.scale_state.scale
        if k == 1:
            metrics = self._forward_backward(arrays, scale)
        else:
            micro = [a.split(a.shape[0] // k) for a in arrays]
            parts = [self._forward_backward(mb, scale)
                     for mb in zip(*micro)]
            metrics = {key: torch.stack([m[key] for m in parts]).mean(0)
                       for key in parts[0]}
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            if grads:
                torch._foreach_div_(grads, float(k))
        finite = True
        if self.loss_scale is not None:
            grads = [p.grad for p in self.model.parameters()
                     if p.grad is not None]
            if grads:
                torch._foreach_mul_(grads, 1.0 / self.scale_state.scale)
            finite = self.comm.allreduce(
                all_finite(grads).to(torch.float32), 'min') > 0.5
            metrics.update(loss_scale=scale,
                           grads_finite=finite.to(torch.float32))
            self.scale_state = self.loss_scale.adjust(self.scale_state,
                                                      finite)
        if buffers:
            with torch.no_grad():
                for b, synced in zip(
                        buffers, self.comm.allreduce(buffers, 'mean')):
                    b.copy_(synced)
        if self._zero is not None:
            if self.iteration == 0:
                # the first call syncs the weights and does not step (a
                # sync, not an update: a non-finite verdict keeps it)
                self.comm.broadcast_data(list(self.model.parameters()))
            elif bool(finite):
                self._zero.step()
        elif bool(finite):
            # skipped on every process otherwise (the verdict is the
            # same on all)
            self.optimizer.step()
        self.iteration += 1
        return self.comm.allreduce(metrics, 'mean')

    def update(self, sync=True):
        """Advance one iteration.  ``sync=True`` (default) returns host
        floats, which waits for the step on the device.  ``sync=False``
        returns the 0-d device tensors, so the host can queue the next
        step while this one runs (``Trainer(async_metrics=True)``)."""
        batch = next(self.iterator)
        metrics = self.update_core(
            batch if self._device_prefetch else self.shard_batch(batch))
        if not sync:
            return metrics
        with _telemetry.span('metrics_sync', kind='host',
                             iteration=self.iteration - 1):
            return {k: float(v) for k, v in metrics.items()}

    @property
    def params(self):
        """The model's parameters as the JAX package's flax-named tree
        (numpy arrays, ``models.to_flax_variables``): what snapshots
        store and ``NanGuard`` audits.  A tensor-parallel model's shards
        are gathered into the full tree (a collective over the model
        axis: every process must read it)."""
        tree = to_flax_variables(self.model)['params']
        if self.param_specs is not None and self._mesh is not None:
            tree = gather_variables(tree, self.param_specs, self._mesh,
                                    self.device)
        return tree

    def param_spec_of(self, param):
        """The spec of one of the model's parameters (None when the
        updater has no specs)."""
        if self.param_specs is None:
            return None
        if not hasattr(self, '_spec_by_param'):
            self._spec_by_param = {}
            for key, p in self.model.named_parameters():
                node = self.param_specs
                for part in key.split('.'):
                    node = node[part]
                self._spec_by_param[p] = node
        return self._spec_by_param.get(param)

    @property
    def epoch(self):
        return getattr(self.iterator, 'epoch', 0)

    @property
    def epoch_detail(self):
        return getattr(self.iterator, 'epoch_detail', 0.0)

    @property
    def is_new_epoch(self):
        return getattr(self.iterator, 'is_new_epoch', False)
