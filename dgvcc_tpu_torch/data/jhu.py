"""JHU-Crowd++ domain-split datasets, counterpart of dgvcc_tpu/data/jhu.py.

The transforms of their non-domain counterparts; only the file listing
differs: images come from ``{root}/domains/{domain_label}_{train|val}.txt``
(test reuses the val list, reference jhu_domain_dataset.py:44-48).
``domain_type`` / ``domain`` are accepted for YAML compatibility and
unused (the reference's dataframe filtering is commented out; the txt
lists are authoritative).
"""

from __future__ import annotations

import os

from dgvcc_tpu_torch.core.registry import DATASETS
from dgvcc_tpu_torch.data.datasets import BayesianDataset, DenClsDataset, DensityMapDataset


class _DomainListing:
    def _list_images(self):
        phase = {"train": "train", "val": "val", "test": "val"}[self.method]
        txt = os.path.join(self.root, "domains", f"{self.domain_label}_{phase}.txt")
        with open(txt) as f:
            return [line.strip() for line in f if line.strip()]


def _make(name, base):
    @DATASETS.register(name)
    class JHUDomain(_DomainListing, base):
        def __init__(self, root, domain_label, crop_size, downsample, method,
                     domain_type=None, domain=None, **kwargs):
            self.domain_label = domain_label
            super().__init__(root, crop_size, downsample, method, **kwargs)

    JHUDomain.__name__ = f"JHU_{base.__name__}"
    return JHUDomain


JHUDomainDataset = _make("jhu_domain", DensityMapDataset)
JHUDomainClsDataset = _make("jhu_domain_cls", DenClsDataset)
JHUDomainBayesianDataset = _make("jhu_domain_bay", BayesianDataset)
