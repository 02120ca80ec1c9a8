"""AOT serving artifacts (dgvcc_tpu_torch/nn/aot.py) on the CPU: the port's
AotCounter against its live VideoCounter and against the JAX package's
AotCounter (dgvcc_tpu/nn/aot.py) on the same weights, the two serving
kernels as torch.library custom ops inside the exported graphs, and the
export's refusals.

Weights come from numpy seeds: mcnn's through the JAX variables and the
port's bridge (test_torch_port_baselines._pair), `final`'s (full width, an
8 x 16 bank, as tests/test_aot.py) from the port's seed, reaching the JAX
package as the port's int8 artifact (nn/quant_io.py).

Tolerances: an artifact against the live counter it was exported from:
1e-6 relative (the same aten ops on the same weights). The port against the
JAX AotCounter, mcnn in float32: 1e-4 relative (sums in another order).
Int8 `final` against the JAX AotCounter on the same sites and scales:
INT8_COUNT (6e-2) of the map's mass, the mass floored at one count as
chip_smoke.py floors it: XLA's jit rounds the quantize and the epilogue its
own way (tests/test_torch_port_quant.py's docstring), and an untrained
`final` counts about 1e-3 a frame here, its density gated by the classifier
map in 16 x 16 blocks, so one block that lands on the other side of the gate
moves a frame's count by a tenth of itself.
"""

import io
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvcc_tpu.nn import aot as jaot
from dgvcc_tpu.nn import quant_io as jqio
from dgvcc_tpu.serve import VideoCounter as JaxCounter
from dgvcc_tpu.testing import TINY_MEM
from dgvcc_tpu_torch.nn import aot
from dgvcc_tpu_torch.nn import quant_io as pqio
from dgvcc_tpu_torch.ops import mem_attention as ma
from dgvcc_tpu_torch.ops import qconv as qc
from dgvcc_tpu_torch.serve import VideoCounter
from test_torch_port_baselines import _pair
from test_torch_port_quant import INT8_COUNT

FINAL = dict(mem_size=8, mem_dim=16)
INT8_HW = (96, 128)


def _frames(n, hw, seed):
    return np.random.default_rng(seed).integers(0, 256, (n,) + hw + (3,), dtype=np.uint8)


def _save(doc, path):
    aot.save_aot(doc, str(path))
    return str(path)


@pytest.fixture(scope="module")
def mcnn(tmp_path_factory):
    """(JAX model, variables, live port counter, the port's two-shape
    artifact's path, the one-shape artifact's path), f32."""
    jm, variables, pm = _pair("mcnn")
    counter = VideoCounter(pm, dtype=torch.float32, device="cpu")
    tmp = tmp_path_factory.mktemp("aot")
    doc = aot.export_serving(counter, [(2, 100, 140), (2, 64, 64)], platforms=["cuda", "cpu"])
    two = _save(doc, tmp / "mcnn.aot")
    one = _save(dict(doc, programs={"2x64x64": doc["programs"]["2x64x64"]}), tmp / "mcnn1.aot")
    return jm, variables, counter, two, one


@pytest.fixture(scope="module")
def final_int8(tmp_path_factory):
    """(live int8 port counter, the port's int8 artifact's path, its AOT
    document) for full-width `final`."""
    calib = _frames(2, INT8_HW, 3)
    live = VideoCounter.from_checkpoint("final", None, dtype=torch.float32, device="cpu",
                                        quantize=True, calib_frames=calib, **FINAL)
    path = str(tmp_path_factory.mktemp("int8") / "final.int8")
    pqio.save_quantized(live.quantized, path, "final", FINAL)
    return live, path, aot.export_serving(live, [(2,) + INT8_HW])


def _graph_ops(doc, key):
    ep = torch.export.load(io.BytesIO(zlib.decompress(doc["programs"][key])))
    return [n for n in ep.graph.nodes if n.op == "call_function"]


def test_round_trip_matches_the_live_counter(mcnn):
    _, _, counter, path, _ = mcnn
    a = aot.AotCounter.load(path, device="cpu")
    assert a.quantized is None and a.bucket == 64
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 100, 140, 3), dtype=np.uint8)
    live = counter.count_frames(frames)
    np.testing.assert_allclose(a.count_frames(frames), live, rtol=1e-6)
    # a smaller batch pads into the B=2 program, its padding masked out
    np.testing.assert_allclose(a.count_frames(frames[:1]), live[:1], rtol=1e-6)
    # a larger batch runs in chunks of the exported batch
    f5 = rng.integers(0, 256, (5, 64, 64, 3), dtype=np.uint8)
    np.testing.assert_allclose(a.count_frames(f5), counter.count_frames(f5), rtol=1e-6)
    assert a.dispatches == {"fp": 5, "int8": 0}
    batches = [rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8) for _ in range(3)]
    streamed = np.concatenate(list(a.stream(iter(batches), prefetch=1)))
    np.testing.assert_allclose(streamed, np.concatenate([counter.count_frames(b)
                                                         for b in batches]), rtol=1e-6)


def test_the_port_matches_the_jax_aot_counter(mcnn, tmp_path):
    jm, variables, _, path, _ = mcnn
    jc = JaxCounter(jm, variables, dtype=jnp.float32)
    jpath = str(tmp_path / "mcnn_jax.aot")
    jaot.save_aot(jaot.export_serving(jc, [(2, 100, 140)]), jpath)
    frames = _frames(2, (100, 140), 1)
    want = np.asarray(jaot.AotCounter.load(jpath).count_frames(frames))
    got = aot.AotCounter.load(path, device="cpu").count_frames(frames)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    # the JAX package's StableHLO file is refused by its format's name
    with pytest.raises(ValueError, match="dgvcc-aot-v1"):
        aot.AotCounter.load(jpath, device="cpu")


def test_int8_final_matches_live_and_the_jax_aot_counter(final_int8, tmp_path):
    live, int8_path, doc = final_int8
    a = aot.AotCounter(doc, device="cpu")
    assert a.quantized is True
    frames = _frames(2, INT8_HW, 4)
    got = a.count_frames(frames)
    np.testing.assert_allclose(got, live.count_frames(frames), rtol=1e-6)
    assert a.dispatches == {"fp": 0, "int8": 1}
    art = jqio.load_quantized(int8_path, dtype=jnp.float32, fused_mem=False)
    jc = JaxCounter(art.model, None, dtype=jnp.float32, quantized=art.quantized)
    jpath = str(tmp_path / "final_int8_jax.aot")
    # one frame: XLA's int8 convolution takes seconds a frame on this CPU
    jaot.save_aot(jaot.export_serving(jc, [(1,) + INT8_HW]), jpath)
    want = np.asarray(jaot.AotCounter.load(jpath).count_frames(frames[:1]))
    assert np.all(np.abs(got[:1] - want) <= INT8_COUNT * np.maximum(np.abs(want), 1.0)), (
        got, want)


def test_the_exported_graphs_hold_the_kernels_ops(final_int8):
    live, _, doc = final_int8
    nodes = _graph_ops(doc, "2x128x128")
    targets = [str(n.target) for n in nodes]
    assert targets.count("dgvcc_tpu_torch.qconv_int8.default") == len(live.quantized.int8_sites())
    assert len(live.quantized.int8_sites()) == 21
    assert targets.count("dgvcc_tpu_torch.memory_attention.default") == 1
    # no int8 data reaches an aten convolution, and nothing widens to float64
    convs = [n for n in nodes if "convolution" in str(n.target) or "conv2d" in str(n.target)]
    assert all(n.args[0].meta["val"].dtype != torch.int8 for n in convs)
    assert not any(getattr(n.meta.get("val"), "dtype", None) == torch.float64 for n in nodes)
    # the fp graph (the tiny geometry): #1 as its op, no softmax of the bank
    # in plain arithmetic
    fp = VideoCounter.from_checkpoint("final", None, dtype=torch.float32, device="cpu",
                                      **TINY_MEM)
    fp_nodes = [str(n.target) for n in _graph_ops(aot.export_serving(fp, [(1, 64, 64)]),
                                                    "1x64x64")]
    assert fp_nodes.count("dgvcc_tpu_torch.memory_attention.default") == 1
    assert not any("softmax" in t for t in fp_nodes)


@pytest.mark.parametrize("op,args", [
    ("memory_attention", lambda g: (torch.randn(2, 37, 16, generator=g),
                                    torch.randn(16, 8, generator=g))),
    ("memory_attention", lambda g: (torch.randn(1, 64, 32, generator=g).bfloat16(),
                                    torch.randn(32, 24, generator=g).bfloat16())),
    ("qconv_int8", lambda g: (torch.randint(-127, 128, (2, 9, 11, 16), dtype=torch.int8,
                                            generator=g),
                              torch.randint(-127, 128, (8, 3, 3, 16), dtype=torch.int8,
                                            generator=g),
                              torch.rand(8, generator=g), 0.02, torch.randn(8, generator=g),
                              True, 1, torch.bfloat16, False, 1)),
    ("qconv_int8", lambda g: (torch.randint(-127, 128, (1, 9, 7, 32), dtype=torch.int8,
                                            generator=g),
                              torch.randint(-127, 128, (5, 2, 2, 32), dtype=torch.int8,
                                            generator=g),
                              torch.rand(5, generator=g), 0.5, torch.randn(5, generator=g),
                              False, 1, torch.float32, False, 2)),
    ("qconv_int8", lambda g: (torch.randint(-127, 128, (1, 8, 8, 16), dtype=torch.int8,
                                            generator=g),
                              torch.randint(-127, 128, (4, 3, 3, 16), dtype=torch.int8,
                                            generator=g),
                              torch.rand(4, generator=g), 1.0, torch.randn(4, generator=g),
                              True, 2, torch.float32, True, 1))])
def test_opcheck_on_the_cpu(op, args):
    """Schema, fake implementation and dispatch of both ops; the eager
    wrappers give the ops' results and launch no kernel on the CPU."""
    a = args(torch.Generator().manual_seed(0))
    torch.library.opcheck(getattr(torch.ops.dgvcc_tpu_torch, op).default, a)
    before = (ma.LAUNCHES, qc.LAUNCHES)
    want = getattr(torch.ops.dgvcc_tpu_torch, op)(*a)
    got = ma.memory_attention_fused(*a) if op == "memory_attention" else qc.qconv_int8(*a)
    assert torch.equal(got, want) and (ma.LAUNCHES, qc.LAUNCHES) == before


def test_two_shapes_store_the_weights_once(mcnn):
    import os

    _, _, _, two, one = mcnn
    assert os.path.getsize(two) <= 1.1 * os.path.getsize(one)


def test_platform_and_shape_refusals(mcnn, tmp_path):
    _, _, counter, path, _ = mcnn
    cuda_only = _save(aot.export_serving(counter, [(1, 64, 64)], platforms=["cuda"]),
                      tmp_path / "cuda.aot")
    with pytest.raises(ValueError, match="lowered for"):
        aot.AotCounter.load(cuda_only, device="cpu")
    with pytest.raises(ValueError, match="platforms must name"):
        aot.export_serving(counter, [(1, 64, 64)], platforms=["tpu"])
    with pytest.raises(ValueError, match="no exported program"):
        aot.AotCounter.load(path, device="cpu").count_frames(np.zeros((1, 256, 256, 3),
                                                                      np.uint8))
    with pytest.raises(ValueError, match="not a dgvcc-torch-aot-v1"):
        aot.AotCounter.load(__file__, device="cpu")
    if not torch.cuda.is_available():  # the entry point runs on the card unless asked
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            aot.AotCounter.load(path)


def test_export_refusals(mcnn):
    _, _, counter, _, _ = mcnn
    with pytest.raises(ValueError, match="single-device"):
        aot.export_serving(types.SimpleNamespace(mesh=object()), [(1, 64, 64)])
    pending = VideoCounter(counter.model, dtype=torch.float32, device="cpu", quantize=True)
    with pytest.raises(ValueError, match="uncalibrated"):
        aot.export_serving(pending, [(1, 64, 64)])
    auto = VideoCounter(counter.model, dtype=torch.float32, device="cpu", quantize="auto")
    with pytest.raises(ValueError, match="quantize='auto'"):
        aot.export_serving(auto, [(1, 64, 64)])
    tiled = VideoCounter(counter.model, dtype=torch.float32, device="cpu", tile_size=64,
                         tile_threshold=96)
    with pytest.raises(ValueError, match="exceeds tile_threshold"):
        aot.export_serving(tiled, [(1, 100, 128)])
