"""Losses of the port; importing registers them in LOSSES."""

from dgvcc_tpu_torch.losses import bayesian, count  # noqa: F401
