"""Evaluation loop.

Counterpart of ``chainermn_tpu/training/evaluator.py`` (the role of
``chainer.training.extensions.Evaluator`` at ``train_mnist.py:102-104``):
iterate a validation set, sum each batch's per-example metrics, and
divide by the count of real examples, so the last partial batch counts
exactly.  Wrap it with
:func:`chainermn_tpu_torch.create_multi_node_evaluator` to average the
result across processes (``multi_node_evaluator.py:31-38``).

The JAX evaluator pads every batch to a fixed shape for its compiled
step and masks the padding; an eager step takes the partial batch as it
is, so nothing is padded here.
"""

import torch

from chainermn_tpu_torch.training.convert import concat_examples


class Evaluator:
    """Args:
      iterator: non-repeating iterator over this process's share of the
        evaluation set (it is reset before every evaluation).
      eval_fn: ``eval_fn(*batch) -> {key: metric}``, each metric a
        per-example tensor of shape ``(batch,)`` (summed here) or a 0-d
        batch mean (weighted by the batch's count), e.g.
        ``Classifier(model).eval_metrics``.
      comm: communicator; batches are collated onto ``comm.device``.
      prefix: prepended to every key of the result.

    The module carries its weights, so there is no ``params_getter``
    (the JAX evaluator takes one to read the updater's parameters).
    """

    trigger = (1, 'epoch')
    priority = 300
    name = 'validation'

    def __init__(self, iterator, eval_fn, comm, prefix='validation/main/'):
        self.iterator = iterator
        self.eval_fn = eval_fn
        self.comm = comm
        self.prefix = prefix

    @torch.no_grad()
    def evaluate(self, trainer=None):
        """``{prefix + key: float}``: each metric's mean over the
        examples this process saw ({} when it saw none)."""
        iterator = self.iterator
        if hasattr(iterator, 'reset'):
            iterator.reset()
        sums = {}
        count = 0
        for batch in iterator:
            arrays = concat_examples(batch)
            if isinstance(arrays, dict):
                arrays = tuple(arrays.values())
            metrics = self.eval_fn(*(torch.from_numpy(a).to(self.comm.device)
                                     for a in arrays))
            n = len(batch)
            for key, v in metrics.items():
                v = torch.as_tensor(v, device=self.comm.device).double()
                s = v * n if v.ndim == 0 else v.sum()
                sums[key] = s if key not in sums else sums[key] + s
            count += n
        # the sums stay on the device until here: no sync per batch
        return {self.prefix + key: float(s) / count
                for key, s in sums.items()}

    def __call__(self, trainer=None):
        return self.evaluate(trainer)
