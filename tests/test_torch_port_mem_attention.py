"""The port's memory attention (dgvcc_tpu_torch.ops.mem_attention) on the
CPU, against the JAX Pallas kernel run in interpret mode and against the
JAX einsum reference. P=300 is not a multiple of any tile. Tolerance
1e-5 (float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvcc_tpu.models.dg import MemoryBank as JaxMemoryBank
from dgvcc_tpu.ops.mem_attention import memory_attention_fused as jax_fused
from dgvcc_tpu.ops.mem_attention import memory_attention_reference as jax_reference
from dgvcc_tpu_torch.models.dg import MemoryBank
from dgvcc_tpu_torch.ops import mem_attention as ma


def _inputs(seed=0, b=2, p=300, k=64, s=128):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, p, k)).astype(np.float32),
            rng.normal(size=(k, s)).astype(np.float32))


@pytest.mark.parametrize("port_fn", ["reference", "fused"])
@pytest.mark.parametrize("golden", ["pallas_interpret", "jax_reference"])
def test_plain_version_matches_jax(port_fn, golden):
    y, mem = _inputs()
    if golden == "pallas_interpret":
        want = np.asarray(jax_fused(jnp.asarray(y), jnp.asarray(mem), tile=128,
                                    interpret=True))
    else:
        want = np.asarray(jax_reference(jnp.asarray(y), jnp.asarray(mem)))
    fn = (ma.memory_attention_reference if port_fn == "reference"
          else ma.memory_attention_fused)
    got = fn(torch.from_numpy(y), torch.from_numpy(mem)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    y, mem = _inputs(1, b=1, p=37, k=16, s=24)
    before = ma.LAUNCHES
    got = ma.memory_attention_fused(torch.from_numpy(y), torch.from_numpy(mem))
    assert ma.LAUNCHES == before
    want = ma.memory_attention_reference(torch.from_numpy(y), torch.from_numpy(mem))
    assert torch.equal(got, want)
    bf = ma.memory_attention_fused(torch.from_numpy(y).bfloat16(),
                                   torch.from_numpy(mem).bfloat16())
    assert bf.dtype == torch.bfloat16


def test_fused_rejects_bad_shapes():
    with pytest.raises(ValueError, match="do not form"):
        ma.memory_attention_fused(torch.zeros(2, 5, 8), torch.zeros(4, 3))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_memory_bank_einsum_path_matches_jax(dtype, tol):
    """The port's MemoryBank (NCHW, einsum path) against the JAX module
    (NHWC): f32 logits and softmax, attention cast to the compute dtype
    before the second product. bf16 tolerance: one bf16 rounding."""
    rng = np.random.default_rng(2)
    y = rng.normal(size=(2, 5, 7, 16)).astype(np.float32)
    mem = rng.normal(size=(16, 24)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = JaxMemoryBank(mem_size=24, mem_dim=16, dtype=jdt)
    want, _ = jm.apply({"params": {"mem": jnp.asarray(mem)}},
                       jnp.asarray(y).astype(jdt))
    bank = MemoryBank(16, fused=False, dtype=tdt)
    got = bank(torch.from_numpy(y.transpose(0, 3, 1, 2)).to(tdt),
               torch.from_numpy(mem))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
