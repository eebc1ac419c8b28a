"""``chainermn_tpu_torch.data``: the sharded streaming input pipeline.

Counterpart of ``chainermn_tpu/data``: record shards with typed integrity
(:mod:`~chainermn_tpu_torch.data.recordio`) and a host-side streaming
loader whose global sample stream is a function of ``(seed, epoch)``
alone, with an exact elastic-resume stream cursor
(:mod:`~chainermn_tpu_torch.data.loader`).
"""

from chainermn_tpu_torch.data.recordio import (  # noqa: F401
    ShardReader, ShardSet, ShardWriter, decode_example,
    encode_example, index_path, read_index, write_examples)
from chainermn_tpu_torch.data.loader import (  # noqa: F401
    StreamingLoader, epoch_stream, stream_order)
