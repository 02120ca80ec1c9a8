"""Training of the port: optimizers and schedulers, the train state, the
per-mode train step, checkpoints and the trainer."""
