"""The port's VideoCounter (dgvcc_tpu_torch.serve) against the JAX
VideoCounter with the same weights: DGModel final at the tiny geometry,
float32, on the CPU, uint8 frames of 100x130 (bucket padding to 128x192)
and a tiled case (tile_size=64, tile_threshold=96: 2x3 tiles).
Tolerance 1e-4 relative (float32 forward, sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvcc_tpu.serve import VideoCounter as JaxCounter
from dgvcc_tpu_torch.serve import VideoCounter
from test_torch_port_helpers import dg_pair

TOL = dict(rtol=1e-4, atol=1e-6)
CASES = {"padded": dict(), "tiled": dict(tile_size=64, tile_threshold=96)}


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (2, 100, 130, 3), dtype=np.uint8)
            for _ in range(3)]


@pytest.fixture(scope="module")
def pair():
    jm, variables, pm = dg_pair("final", seed=3)
    return jm, variables, pm


@pytest.mark.parametrize("case", sorted(CASES))
def test_count_frames_and_stream_match_jax(pair, frames, case):
    jm, variables, pm = pair
    jc = JaxCounter(jm, variables, dtype=jnp.float32, **CASES[case])
    pc = VideoCounter(pm, dtype=torch.float32, device="cpu", **CASES[case])
    want = [np.asarray(jc.count_frames(f)) for f in frames]
    got = [pc.count_frames(f) for f in frames]
    for g, w in zip(got, want):
        assert g.shape == (2,) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL)
    streamed = list(pc.stream(iter(frames), prefetch=2))
    assert len(streamed) == len(frames)
    for s, w in zip(streamed, want):
        np.testing.assert_allclose(s, w, **TOL)


def test_pad_and_tile_geometry():
    pc = VideoCounter(torch.nn.Identity(), dtype=torch.float32, device="cpu",
                      tile_size=64, tile_threshold=96)
    f = torch.arange(2 * 100 * 130 * 3, dtype=torch.int32).reshape(2, 100, 130, 3)
    padded = pc._pad(f)
    assert padded.shape == (2, 128, 192, 3)
    assert torch.equal(padded[:, :100, :130], f) and padded[:, 100:].eq(0).all()
    tiles, vh, vw = pc._tile(f)
    assert tiles.shape == (12, 64, 64, 3)
    assert vh.tolist() == [64, 64, 64, 36, 36, 36] * 2
    assert vw.tolist() == [64, 64, 2, 64, 64, 2] * 2
    assert torch.equal(tiles[4, :36, :64], f[0, 64:100, 64:128])


def test_unported_options_raise_with_a_pointer():
    """Spatial serving of a family other than the DG family is Queue 1 item
    1's (a mesh is ported: test_torch_port_serve_mesh.py); a mesh that is
    not a process group and an unknown shard are refused. Int8 serving is
    ported (test_torch_port_quant_io.py) and refuses a model it cannot fold,
    and an artifact that is not there."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 1"):
        VideoCounter(torch.nn.Identity(), device="cpu", mesh=object(), shard="spatial")
    with pytest.raises(TypeError, match="process group"):
        VideoCounter(torch.nn.Identity(), device="cpu", mesh=object())
    with pytest.raises(ValueError, match="'batch' or 'spatial'"):
        VideoCounter(torch.nn.Identity(), device="cpu", shard="bogus")
    for kw in (dict(quantize=True), dict(quantize="auto"), dict(quantize="int4")):
        with pytest.raises(ValueError):
            VideoCounter(torch.nn.Identity(), device="cpu", **kw)
    with pytest.raises(FileNotFoundError):
        VideoCounter.from_artifact("x.int8", device="cpu")


def test_from_checkpoint_loads_a_pth_strictly(tmp_path, pair):
    from dgvcc_tpu.testing import TINY_MEM

    _, _, pm = pair
    path = tmp_path / "final.pth"
    torch.save(pm.state_dict(), path)
    c = VideoCounter.from_checkpoint("final", str(path), dtype=torch.float32,
                                     device="cpu", **TINY_MEM)
    for k, v in pm.state_dict().items():
        assert torch.equal(c.model.state_dict()[k], v), k
    seeded = [VideoCounter.from_checkpoint("final", None, dtype=torch.float32,
                                           device="cpu", seed=7, **TINY_MEM)
              for _ in range(2)]
    assert torch.equal(seeded[0].model.mem, seeded[1].model.mem)
