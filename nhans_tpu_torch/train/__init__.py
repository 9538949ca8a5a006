"""Training: the optimizer zoo, the train step, checkpoints, metrics
and the trainer."""

from nhans_tpu_torch.train.optim import make_optimizer  # noqa: F401
from nhans_tpu_torch.train.checkpoint import Checkpointer  # noqa: F401
