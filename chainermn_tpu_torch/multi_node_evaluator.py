"""Multi-node evaluator wrapper.

Counterpart of ``chainermn_tpu/multi_node_evaluator.py`` (rebuild of
``chainermn/multi_node_evaluator.py``): run the wrapped evaluator on
this process's shard of the evaluation set, then average every reported
scalar across processes, key by key in sorted order, as the reference
does (``:31-38``).
"""


def create_multi_node_evaluator(actual_evaluator, communicator):
    """Parity with ``chainermn.create_multi_node_evaluator(ev, comm)``.

    ``actual_evaluator`` is an object with ``.evaluate()`` or a callable
    returning a metric dict.  The result's ``evaluate()`` / ``__call__``
    return the cross-process means (``communicator.allreduce_obj``, one
    collective per key); its other attributes (``trigger``,
    ``priority``, ``name``, ...) are the wrapped evaluator's.
    """

    class Wrapper:
        def __init__(self):
            self.actual_evaluator = actual_evaluator
            self.communicator = communicator

        def __getattr__(self, name):
            return getattr(self.actual_evaluator, name)

        def evaluate(self, *args, **kwargs):
            ev = self.actual_evaluator
            local = (ev.evaluate(*args, **kwargs)
                     if hasattr(ev, 'evaluate') else ev(*args, **kwargs))
            return {key: communicator.allreduce_obj(local[key], op='mean')
                    for key in sorted(local)}

        __call__ = evaluate

    return Wrapper()
