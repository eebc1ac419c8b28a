"""Standard updater: one data-parallel training iteration per call.

Counterpart of ``chainermn_tpu/training/updater.py``.  The JAX updater
compiles loss, gradient, reduction, optimizer step and metric averaging
into one SPMD program; here the same steps run eagerly in each process:

1. collate the next batch and move it to the model's device;
2. forward and backward (a train-mode forward also updates the
   BatchNorm running statistics in the model's buffers);
3. mean-sync the running statistics across processes (``model_state``):
   batch statistics stay local, so this is not ``SyncBatchNorm``;
4. the optimizer step (with a multi-node optimizer: broadcast at the
   first call, gradient mean-allreduce + step afterwards);
5. mean-average the metrics across processes.
"""

import torch

from chainermn_tpu_torch.models._layers import set_dropout_generator
from chainermn_tpu_torch.models.flax_weights import to_flax_variables
from chainermn_tpu_torch.training.convert import concat_examples
from chainermn_tpu_torch.training.iterators import DevicePrefetchIterator


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
    """

    def __init__(self, iterator, optimizer, loss_fn, model, comm,
                 model_state=True, zero=False, accum_steps=1, policy=None,
                 remat=False, device_prefetch=0, rng=None):
        for name, value, default in (
                ('zero', zero, False), ('accum_steps', accum_steps, 1),
                ('policy', policy, None), ('remat', remat, False)):
            if value != default:
                raise NotImplementedError(
                    'StandardUpdater(%s=...) is not ported yet '
                    '(ROADMAP.md A5)' % name)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.model = model
        self.comm = comm
        self.model_state = model_state
        self.device = next(model.parameters()).device
        self.iteration = 0
        self.seed = 0 if rng is None else int(rng)
        gen = torch.Generator(self.device)
        self.dropout_generator = \
            gen if set_dropout_generator(model, gen) else None
        self._device_prefetch = bool(device_prefetch)
        if device_prefetch:
            iterator = DevicePrefetchIterator(
                iterator, self._place, depth=device_prefetch,
                device=self.device)
        self.iterator = iterator

    @staticmethod
    def _collate(batch):
        arrays = concat_examples(batch)
        if isinstance(arrays, dict):
            arrays = tuple(arrays.values())
        return arrays

    def shard_batch(self, batch):
        """Collate a list of examples and move it to the device."""
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in self._collate(batch))

    def collate_pinned(self, batch):
        """Collate a list of examples into host tensors, pinned when the
        model is on a CUDA device (a copy from pinned memory can run
        asynchronously)."""
        host = [torch.from_numpy(a) for a in self._collate(batch)]
        if self.device.type == 'cuda':
            host = [t.pin_memory() for t in host]
        return tuple(host)

    def _place(self, batch):
        """``device_prefetch``'s placement: pinned collation, then a
        non-blocking copy (on the prefetcher's side stream)."""
        return tuple(t.to(self.device, non_blocking=True)
                     for t in self.collate_pinned(batch))

    def update_core(self, arrays):
        """One iteration on device tensors; returns the averaged metrics
        as 0-d tensors."""
        self.optimizer.zero_grad(set_to_none=True)
        if self.dropout_generator is not None:
            self.dropout_generator.manual_seed(
                ((self.seed * 1000003 + self.iteration) * 65537
                 + self.comm.rank) % 2 ** 63)
        loss, metrics = self.loss_fn(*arrays)
        loss.backward()
        # a model without buffers (the transformer) has nothing to sync:
        # no collective is issued for it
        buffers = list(self.model.buffers()) if self.model_state else []
        if buffers:
            with torch.no_grad():
                for b, synced in zip(buffers,
                                     self.comm.allreduce(buffers, 'mean')):
                    b.copy_(synced)
        self.optimizer.step()
        metrics = dict(metrics, loss=loss.detach())
        self.iteration += 1
        return self.comm.allreduce(metrics, 'mean')

    def update(self):
        """Advance one iteration; returns the metrics as floats."""
        batch = next(self.iterator)
        metrics = self.update_core(
            batch if self._device_prefetch else self.shard_batch(batch))
        return {k: float(v) for k, v in metrics.items()}

    @property
    def params(self):
        """The model's parameters as the JAX package's flax-named tree
        (numpy copies, ``models.to_flax_variables``): what snapshots
        store and ``NanGuard`` audits."""
        return to_flax_variables(self.model)['params']

    @property
    def epoch(self):
        return getattr(self.iterator, 'epoch', 0)

    @property
    def epoch_detail(self):
        return getattr(self.iterator, 'epoch_detail', 0.0)

    @property
    def is_new_epoch(self):
        return getattr(self.iterator, 'is_new_epoch', False)
