"""The port's DGModel eval forward (dgvcc_tpu_torch.models.dg) against
the JAX DGModel.apply, all six variants, at the tiny test geometry
(dgvcc_tpu.testing.TINY_MEM), float32 on the CPU, with identical weights
carried over by the port's own bridge. The density map and, where the
variant has one, the cls map are compared with the classifier's
prediction and with an injected ground-truth map.

Tolerance rtol 1e-4 / atol 1e-5: float32, with convolution and softmax
sums taken in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_helpers import VARIANTS, dg_pair, nchw, nhwc

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("port_fused", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_eval_forward_matches_jax(variant, port_fused):
    jm, variables, pm = dg_pair(variant, seed=VARIANTS.index(variant),
                                fused_mem=port_fused)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 64, 80, 3)).astype(np.float32)
    c_gt = (rng.uniform(size=(2, 4, 5, 1)) > 0.5).astype(np.float32)
    gts = [None, c_gt] if pm.use_cls else [None]
    for gt in gts:
        want = jm.apply(variables, jnp.asarray(x),
                        c_gt=None if gt is None else jnp.asarray(gt))
        with torch.no_grad():
            got = pm(nchw(x), c_gt=None if gt is None else nchw(gt))
        if pm.use_cls:
            (d_want, c_want), (d_got, c_got) = want, got
            np.testing.assert_allclose(nhwc(c_got), np.asarray(c_want), **TOL)
        else:
            d_want, d_got = want, got
        assert d_got.shape == (2, 1, 64, 80)
        np.testing.assert_allclose(nhwc(d_got), np.asarray(d_want), **TOL)


def test_variant_flags_and_key_layout():
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.registry import MODELS

    final = MODELS.build("final", mem_size=8, mem_dim=16,
                         dec_widths=((16, 16), (16, 16), (16, 8)))
    keys = set(final.state_dict())
    assert final.mem.shape == (1, 16, 8)
    assert {"enc1.0.weight", "enc1.1.running_var", "enc2.1.weight",
            "enc3.1.weight", "dec3.0.conv.weight", "dec1.1.bn.weight",
            "den_dec.0.conv.weight", "den_head.0.conv.weight",
            "cls_head.0.conv.weight", "cls_head.2.conv.weight", "mem"} <= keys
    assert not any(k.startswith("den_head.0.bn") for k in keys)
    base = MODELS.build("base", dec_widths=((16, 16), (16, 16), (16, 8)))
    assert "mem" not in base.state_dict() and not hasattr(base, "cls_head")
    assert len(base.den_dec) == 2 and len(MODELS.build(
        "memadd", mem_size=8, mem_dim=16,
        dec_widths=((16, 16), (16, 16), (16, 8))).den_dec) == 1
    with pytest.raises(ValueError, match="stage_splits"):
        MODELS.build("base", vgg_cfg=(8, "M"))
    # training-only YAML keys do not reach the eval model
    assert MODELS.build("base", err_thrs=0.5, remat=True, pretrained=True,
                        dec_widths=((16, 16), (16, 16), (16, 8))).use_mem is False


def test_bf16_model_keeps_bn_and_bank_in_f32():
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu.testing import TINY_MEM
    from dgvcc_tpu_torch.core.registry import MODELS

    m = MODELS.build("final", dtype=torch.bfloat16, **TINY_MEM).eval()
    assert m.enc1[0].weight.dtype == torch.bfloat16
    assert m.enc1[1].weight.dtype == torch.float32 and m.mem.dtype == torch.float32
    with torch.no_grad():
        d, c = m(torch.zeros(1, 3, 32, 48, dtype=torch.bfloat16))
    assert d.dtype == torch.bfloat16 and d.shape == (1, 1, 32, 48)
    assert c.shape == (1, 1, 2, 3)
