"""Differentiable communication functions for model parallelism.

Counterpart of ``chainermn_tpu/functions/``: :func:`send` / :func:`recv`
(one point-to-point permutation, its backward the reverse one) and
:func:`pseudo_connect` (ties a delegate into the graph with a zero
gradient).
"""

from chainermn_tpu_torch.functions import point_to_point_communication
from chainermn_tpu_torch.functions.pseudo_connect import (  # noqa: F401
    pseudo_connect)

recv = point_to_point_communication.recv
send = point_to_point_communication.send
