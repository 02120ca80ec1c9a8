"""Training of the port: optimizers and schedulers, the train state and
the per-mode train step."""
