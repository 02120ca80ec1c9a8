"""Data pipeline of the port: density maps (dmap_cli), datasets, loader.
Importing it registers the datasets in DATASETS."""

from dgvcc_tpu_torch.data import datasets, jhu  # noqa: F401
