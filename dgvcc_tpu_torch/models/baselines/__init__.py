"""The classic counting baselines (NCHW), counterparts of
dgvcc_tpu/models/baselines/: csrnet, mcnn, bl, sasnet, dssinet and cctrans.
Keys follow the reference torch layouts that dgvcc_tpu/nn/torch_io.py reads
(``*_checkpoint_to_flax``), so a reference ``.pth`` strict-loads."""

from dgvcc_tpu_torch.models.baselines import (bl_vgg, cctrans, csrnet, dssinet,  # noqa: F401
                                              mcnn, sasnet)
