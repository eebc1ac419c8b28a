from chainermn_tpu_torch.training import extensions, triggers  # noqa: F401
from chainermn_tpu_torch.training.convert import concat_examples  # noqa
from chainermn_tpu_torch.training.evaluator import Evaluator  # noqa: F401
from chainermn_tpu_torch.training.iterators import SerialIterator  # noqa
from chainermn_tpu_torch.training.trainer import Trainer  # noqa: F401
from chainermn_tpu_torch.training.updater import StandardUpdater  # noqa
