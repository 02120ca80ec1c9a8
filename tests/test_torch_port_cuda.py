"""The port's CUDA kernel on the card, against its plain PyTorch version.

Needs an NVIDIA Hopper GPU and nvcc; every test skips without a card.
On the card, run it without the JAX-side conftest (this file imports
torch and the port only):

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: f32 atol/rtol 1e-4 (the f32 kernel sums in another order);
bf16 output against the f32 plain version on the same inputs 2e-2 (one
bf16 rounding of the output, 2^-8 relative).
"""

import pytest
import torch

from dgvcc_tpu_torch.ops import mem_attention as ma

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run on the card with "
                    "python -m pytest --noconftest tests/test_torch_port_cuda.py")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,p,k,s", [(2, 300, 16, 16), (2, 300, 64, 128),
                                     (1, 1000, 128, 1001), (3, 6437, 256, 1024)])
def test_kernel_matches_plain(cuda, dtype, tol, b, p, k, s):
    g = torch.Generator(device=cuda).manual_seed(b * p + k + s)
    y = torch.randn(b, p, k, generator=g, device=cuda).to(dtype)
    mem = torch.randn(k, s, generator=g, device=cuda).to(dtype)
    before = ma.LAUNCHES
    out = ma.memory_attention_fused(y, mem)
    torch.cuda.synchronize()
    assert ma.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == y.shape
    ref = ma.memory_attention_reference(y.float(), mem.float())
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)


def test_kernel_rejects_what_it_cannot_take(cuda):
    y = torch.randn(1, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="K=48"):
        ma.memory_attention_fused(y, torch.randn(48, 32, device=cuda))
    with pytest.raises(TypeError):
        ma.memory_attention_fused(y[..., :32].half(),
                                  torch.randn(32, 32, device=cuda).half())
    with pytest.raises(ValueError, match="CUDA device"):
        ma.memory_attention_fused(y[..., :32], torch.randn(32, 32))


def test_dg_model_fused_matches_einsum_path(cuda):
    """Tiny DGModel final on the card: the kernel path against the einsum
    path, in f32 (TF32 off for both)."""
    import dgvcc_tpu_torch.models  # noqa: F401
    from dgvcc_tpu_torch.core.registry import MODELS

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = dict(vgg_cfg=(8, "M", 8, "M", 16, "M", 16, "M"),
                stage_splits=(0, 8, 12, 16),
                dec_widths=((16, 16), (16, 16), (16, 8)),
                mem_size=16, mem_dim=16)
    fused = MODELS.build("final", fused_mem=True, **tiny)
    fused.reset_parameters(torch.Generator().manual_seed(0))
    plain = MODELS.build("final", fused_mem=False, **tiny)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        d_f, c_f = fused.to(cuda).eval()(x.to(cuda))
        d_p, c_p = plain.to(cuda).eval()(x.to(cuda))
    torch.testing.assert_close(d_f, d_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(c_f, c_p, atol=0, rtol=0)
