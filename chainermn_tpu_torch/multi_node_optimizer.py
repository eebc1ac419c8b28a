"""Multi-node optimizer wrapper.

Counterpart of ``chainermn_tpu/multi_node_optimizer.py`` (rebuild of
``chainermn/multi_node_optimizer.py``): the first ``step()`` broadcasts
the parameters from rank 0 and does NOT step (the wrapped optimizer's
state, e.g. the velocity, stays untouched); every later ``step()``
mean-allreduces the gradients and then steps.
"""


class _MultiNodeOptimizer:
    """Proxy of a ``torch.optim.Optimizer``; attributes other than
    ``step`` are the wrapped optimizer's."""

    def __init__(self, actual_optimizer, communicator, allreduce_dtype=None):
        self.actual_optimizer = actual_optimizer
        self.communicator = communicator
        self.allreduce_dtype = allreduce_dtype
        self.needs_broadcast = True

    def _params(self):
        return [p for group in self.actual_optimizer.param_groups
                for p in group['params']]

    def step(self):
        params = self._params()
        if self.needs_broadcast:
            # initial weight sync in place of a step (reference :23-26)
            self.communicator.broadcast_data(params)
            self.needs_broadcast = False
            return None
        grads = [p.grad for p in params if p.grad is not None]
        if self.allreduce_dtype is None:
            self.communicator.allreduce_grad(grads)
        else:
            narrow = [g.to(self.allreduce_dtype) for g in grads]
            self.communicator.allreduce_grad(narrow)
            for g, n in zip(grads, narrow):
                g.copy_(n)
        return self.actual_optimizer.step()

    def __getattr__(self, name):
        return getattr(self.__dict__['actual_optimizer'], name)


def create_multi_node_optimizer(actual_optimizer, communicator,
                                allreduce_dtype=None,
                                double_buffering=False):
    """Wrap a ``torch.optim.Optimizer`` with the broadcast-first step
    and mean gradient allreduce.

    ``allreduce_dtype`` (e.g. ``torch.bfloat16``): cast gradients to it
    for the reduction and back afterwards.  The first-call broadcast
    stays full precision.
    """
    if double_buffering:
        raise NotImplementedError(
            'double_buffering is not ported yet (ROADMAP.md A4)')
    return _MultiNodeOptimizer(actual_optimizer, communicator,
                               allreduce_dtype)
