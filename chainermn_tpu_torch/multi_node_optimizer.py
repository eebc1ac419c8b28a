"""Multi-node optimizer wrapper.

Counterpart of ``chainermn_tpu/multi_node_optimizer.py`` (rebuild of
``chainermn/multi_node_optimizer.py``): the first ``step()`` broadcasts
the parameters from rank 0 and does NOT step (the wrapped optimizer's
state, e.g. the velocity, stays untouched); every later ``step()``
mean-allreduces the gradients and then steps.

A parameter that got no gradient on a step (its ``grad`` is ``None``:
it was outside that step's graph) is given a zero gradient first, as
``jax.grad`` gives every leaf one: the wrapped optimizer then steps it
as the reference's optimizers do (momentum keeps moving it, Adam's
moments decay), and every rank packs the same gradients, in the same
order, into its allreduce.
"""

import torch


class _MultiNodeOptimizer:
    """Proxy of a ``torch.optim.Optimizer``; attributes other than
    ``step`` are the wrapped optimizer's.

    Under ``double_buffering`` the wrapper keeps the previous step's
    reduced gradients in ``pending`` (one tensor a parameter, ``None``
    until the first reduction): step t reduces its own gradients into
    ``pending`` and hands the inner optimizer step t-1's."""

    def __init__(self, actual_optimizer, communicator, allreduce_dtype=None,
                 broadcast_first=True, double_buffering=False):
        self.actual_optimizer = actual_optimizer
        self.communicator = communicator
        self.allreduce_dtype = allreduce_dtype
        self.needs_broadcast = bool(broadcast_first)
        self.double_buffering = bool(double_buffering)
        self.pending = None

    def _params(self):
        return [p for group in self.actual_optimizer.param_groups
                for p in group['params']]

    def _reduce(self, params):
        """Mean-allreduce every parameter's gradient in place (a zero one
        where it has none)."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)  # in p's layout
        grads = [p.grad for p in params]
        if self.allreduce_dtype is None:
            self.communicator.allreduce_grad(grads)
        else:
            narrow = [g.to(self.allreduce_dtype) for g in grads]
            self.communicator.allreduce_grad(narrow)
            for g, n in zip(grads, narrow):
                g.copy_(n)

    def step(self):
        params = self._params()
        if self.needs_broadcast:
            # initial weight sync in place of a step (reference :23-26)
            self.communicator.broadcast_data(params)
            self.needs_broadcast = False
            return None
        self._reduce(params)
        if not self.double_buffering:
            return self.actual_optimizer.step()
        # apply the PREVIOUS step's reduction; this step's goes into
        # ``pending``.  The reduction is issued synchronously: the
        # overlap it allows needs a second GPU to show (ROADMAP item 13),
        # the staleness-1 trajectory is the JAX package's exactly
        reduced = [p.grad for p in params]
        previous, self.pending = self.pending, reduced
        if previous is None:
            # the buffer-fill step: no update, the inner optimizer is
            # not stepped (its state does not change)
            return None
        for p, g in zip(params, previous):
            p.grad = g
        return self.actual_optimizer.step()

    def __getattr__(self, name):
        return getattr(self.__dict__['actual_optimizer'], name)


def create_multi_node_optimizer(actual_optimizer, communicator,
                                broadcast_first=True, allreduce_dtype=None,
                                double_buffering=False):
    """Wrap a ``torch.optim.Optimizer`` with the broadcast-first step
    and mean gradient allreduce.

    ``broadcast_first=False``: no broadcast at step 0 (the first call
    already reduces and steps).

    ``allreduce_dtype`` (e.g. ``torch.bfloat16``): cast gradients to it
    for the reduction and back afterwards.  The first-call broadcast
    stays full precision.

    ``double_buffering``: step t applies step t-1's reduced gradients
    (a staleness-1 trajectory); the first step after the broadcast
    applies no update and leaves the inner optimizer's state as it is.
    The JAX package issues the reduction so that it can overlap the
    rest of the step; here it is issued synchronously, with the same
    trajectory.
    """
    return _MultiNodeOptimizer(actual_optimizer, communicator,
                               allreduce_dtype, broadcast_first,
                               double_buffering)
