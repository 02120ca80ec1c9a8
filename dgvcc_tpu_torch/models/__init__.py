"""Model families of the port; importing registers them in MODELS."""

from dgvcc_tpu_torch.models import baselines, dg, regressors, whitening  # noqa: F401
