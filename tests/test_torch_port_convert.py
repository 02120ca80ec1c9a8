"""The port's weight bridge (dgvcc_tpu_torch.nn.convert) and key layout.

JAX variables -> ``dg_state_dict_from_flax`` -> the port's strict
``load_state_dict`` -> ``state_dict()`` as numpy -> the JAX package's own
reader of reference checkpoints (``dg_checkpoint_to_flax``) must give
back the original params and batch stats exactly. That reader hard-codes
the torchvision VGG16-BN stage splits, so these models keep the full
VGG16 trunk (with a narrow decoder and bank)."""

import numpy as np
import pytest
import torch

from dgvcc_tpu.nn.torch_io import dg_checkpoint_to_flax
from dgvcc_tpu_torch.nn.convert import load_reference_pth
from test_torch_port_helpers import dg_pair

NARROW = dict(mem_size=16, mem_dim=16, dec_widths=((32, 16), (16, 16), (16, 8)))


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("variant", ["final", "base"])
def test_bridge_roundtrip_is_exact(variant):
    _, variables, pm = dg_pair(variant, seed=11, geometry=NARROW)
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    params, stats = dg_checkpoint_to_flax(sd)
    for name, tree in (("params", params), ("batch_stats", stats)):
        want = dict(_flatten(variables[name]))
        got = dict(_flatten(tree))
        assert set(got) == set(want), name
        for path, w in want.items():
            assert got[path].shape == w.shape, path
            assert np.array_equal(got[path], w), path


def test_reference_pth_loads_strictly(tmp_path):
    _, _, pm = dg_pair("final", seed=12, geometry=NARROW)
    path = tmp_path / "ref.pth"
    torch.save(pm.state_dict(), path)
    sd = load_reference_pth(str(path))
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.registry import MODELS

    fresh = MODELS.build("final", **NARROW)
    fresh.load_state_dict(sd, strict=True)
    for k, v in pm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    sd.pop("mem")
    with pytest.raises(RuntimeError, match="mem"):
        fresh.load_state_dict(sd, strict=True)
