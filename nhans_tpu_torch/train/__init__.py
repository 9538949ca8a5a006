"""Training: the optimizer zoo, the train step, checkpoints, metrics
and the trainer."""
