"""The port's density maps (dgvcc_tpu_torch/ops/dmap.py and
data/dmap_cli.py) against the JAX package on the CPU.

Tolerances: the plain version and the CPU wrapper against
``gaussian_density_jax`` and the numpy golden rtol 1e-4 / atol 1e-5
(float32; the product sums in another order than the golden's float64
splat). The port's own copies of the numpy goldens equal the JAX
package's exactly (the same numpy code), and so do the maps its
``dmap_cli --backend numpy`` writes; ``--backend cpu`` writes the plain
version's maps, held to the JAX CLI's at the tolerance above, also at
--sigma 8 and 2 (radius 7, truncate 7 / sigma). The CPU model of the
kernel's binning (``gaussian_density_binned_reference``: tile reach,
rounds, point order) is held to ``gaussian_density_jax`` and the numpy
splat at the same tolerance.
"""

import os
from glob import glob

import numpy as np
import pytest
import torch
from PIL import Image

from dgvcc_tpu.data import dmap_cli as jax_cli
from dgvcc_tpu.ops import dmap as jdmap
from dgvcc_tpu_torch.data import dmap_cli
from dgvcc_tpu_torch.ops import dmap

TOL = dict(rtol=1e-4, atol=1e-5)


def _points(h, w, n, seed, masked=0):
    """n points over the image and a margin around it: some on every
    border, in (-1, 0) (kept on row / column 0), outside the image; the
    last ``masked`` rows are pad rows."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-8, [w + 8, h + 8], (n, 2)).astype(np.float32)
    if n >= 8:
        pts[:8] = [[0, 0], [w - 0.5, h - 0.5], [-0.4, h / 2], [w / 2, -0.7],
                   [w - 1, 3], [5, h - 1], [w + 0.5, 2], [-1.5, 4]]
    mask = np.ones(n, bool)
    if masked:
        mask[n - masked:] = False
    return pts, mask


CASES = {"border_outside_negative": (61, 83, 60, 0),
         "masked_pad_rows": (40, 52, 48, 16),
         "no_points": (17, 23, 0, 0),
         "one_row_image": (1, 30, 12, 0),
         "dense": (64, 64, 400, 100)}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_and_cpu_wrapper_match_jax(case):
    h, w, n, masked = CASES[case]
    pts, mask = _points(h, w, n, seed=n + h, masked=masked)
    want_jax = np.asarray(jdmap.gaussian_density_jax(pts, mask, h, w))
    golden = jdmap.gaussian_density_fixed_np((h, w), pts[mask])
    before = dmap.LAUNCHES
    got = dmap.gaussian_density(torch.from_numpy(pts), torch.from_numpy(mask), h, w)
    ref = dmap.gaussian_density_reference(torch.from_numpy(pts), torch.from_numpy(mask), h, w)
    assert dmap.LAUNCHES == before  # the CPU takes the plain version, no launch
    assert got.shape == (h, w) and got.dtype == torch.float32
    assert torch.equal(got, ref)
    np.testing.assert_allclose(got.numpy(), want_jax, **TOL)
    np.testing.assert_allclose(got.numpy(), golden, **TOL)


def _tile_border_points(h, w):
    """Points on the 32-pixel tile borders (either side, and just short of
    the next), a few in (-1, 0), and a few just outside the image."""
    xs = [0.0, 31.0, 31.99, 32.0, 63.5, 64.0, w - 1.0, w - 0.01]
    ys = [0.0, 31.0, 32.0, 63.99, h - 1.0]
    grid = [[x, y] for x in xs for y in ys]
    edge = [[-0.4, 31.5], [32.0, -0.7], [w + 0.2, 5.0], [5.0, float(h)], [-1.2, 3.0]]
    pts = np.array(grid + edge, np.float32)
    return pts, np.ones(len(pts), bool)


def _one_tile_points(n, seed):
    """n points whose centres all lie in the tile of columns and rows 32..63."""
    pts = 32.0 + 31.99 * np.random.default_rng(seed).random((n, 2))
    return pts.astype(np.float32), np.ones(n, bool)


# (h, w, points and mask, sigma, truncate, capacity)
BINNED_CASES = {
    "tile_borders": lambda: (70, 100, _tile_border_points(70, 100), 4.0, 7 / 4, dmap.CAPACITY),
    "border_outside_negative": lambda: (61, 83, _points(61, 83, 60, seed=1), 4.0, 7 / 4,
                                        dmap.CAPACITY),
    "masked_pad_rows": lambda: (40, 52, _points(40, 52, 48, seed=2, masked=16), 4.0, 7 / 4,
                                dmap.CAPACITY),
    "no_points": lambda: (17, 23, _points(17, 23, 0, seed=3), 4.0, 7 / 4, dmap.CAPACITY),
    "one_row_image": lambda: (1, 30, _points(1, 30, 12, seed=4), 4.0, 7 / 4, dmap.CAPACITY),
    "radius_63": lambda: (150, 170, _points(150, 170, 80, seed=5), 16.0, 3.95, dmap.CAPACITY),
    "overflow_tile": lambda: (70, 100, _one_tile_points(dmap.CAPACITY + 52, seed=6), 4.0,
                              7 / 4, dmap.CAPACITY),
    "overflow_small_buffer": lambda: (61, 83, _points(61, 83, 60, seed=7), 4.0, 7 / 4, 5),
}


@pytest.mark.parametrize("case", list(BINNED_CASES))
def test_binned_model_matches_jax_and_golden(case):
    """The CPU model of the kernel's binning (tile reach, rounds, point
    order) against gaussian_density_jax and the numpy splat, at TOL."""
    h, w, (pts, mask), sigma, truncate, capacity = BINNED_CASES[case]()
    stats = {}
    got = dmap.gaussian_density_binned_reference(
        torch.from_numpy(pts), torch.from_numpy(mask), h, w, sigma, truncate,
        capacity=capacity, stats=stats)
    want_jax = np.asarray(jdmap.gaussian_density_jax(pts, mask, h, w, sigma, truncate))
    kept = pts[mask].astype(np.int64)
    golden = jdmap._splat_np((h, w), kept, [sigma] * len(kept), [truncate] * len(kept))
    assert got.shape == (h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_jax, **TOL)
    np.testing.assert_allclose(got.numpy(), golden, **TOL)
    assert stats["kept"] <= capacity
    if case == "radius_63":
        assert dmap.scipy_radius(sigma, truncate) == dmap.MAX_RADIUS == 63
        assert stats["reach"] == 2  # a window spans two tiles on each side
    if case.startswith("overflow"):
        assert stats["rounds"] >= 2  # more candidates than the buffer: rounds
    if case == "no_points":
        assert not got.any()


def test_binned_model_sums_in_point_order_whatever_the_bin_order():
    """The scatter leaves each tile's segment in any order; sorting by point
    index makes the map the same bit for bit."""
    pts, mask = _points(64, 96, 300, seed=8, masked=20)
    maps = [dmap.gaussian_density_binned_reference(torch.from_numpy(pts),
                                                   torch.from_numpy(mask), 64, 96, seed=s)
            for s in (0, 1, 2)]
    assert torch.equal(maps[0], maps[1]) and torch.equal(maps[0], maps[2])


def test_masked_rows_and_outside_points_contribute_nothing():
    pts = np.array([[10.0, 10.0], [50.0, 50.0], [70.0, 3.0], [-1.2, 9.0]], np.float32)
    mask = np.array([True, False, True, True])
    out = dmap.gaussian_density(torch.from_numpy(pts), torch.from_numpy(mask), 64, 64)
    assert out.sum().item() == pytest.approx(1.0, rel=1e-4)  # only the first point
    assert out[50, 50] == 0.0
    # -0.4 truncates to column 0 and is kept (int(), not floor)
    edge = dmap.gaussian_density(torch.tensor([[-0.4, 20.0]]), torch.tensor([True]), 40, 40)
    assert edge[20, 0] == edge.max() and 0.5 < edge.sum().item() < 1.0


@pytest.mark.parametrize("sigma", [4.0, 2.5])
def test_numpy_goldens_are_the_jax_packages(sigma):
    h, w = 50, 70
    pts, _ = _points(h, w, 30, seed=3)
    np.testing.assert_array_equal(dmap.gaussian_density_fixed_np((h, w), pts, sigma),
                                  jdmap.gaussian_density_fixed_np((h, w), pts, sigma))
    inside = pts[(pts[:, 0] >= 0) & (pts[:, 1] >= 0)]
    np.testing.assert_array_equal(dmap.gaussian_density_adaptive_np((h, w), inside),
                                  jdmap.gaussian_density_adaptive_np((h, w), inside))
    assert dmap.scipy_radius(sigma, 7 / sigma) == jdmap.scipy_radius(sigma, 7 / sigma)


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError, match=r"\(N, 2\)"):
        dmap.gaussian_density(torch.zeros(4, 3), torch.ones(4, dtype=torch.bool), 8, 8)
    with pytest.raises(ValueError, match="mask"):
        dmap.gaussian_density(torch.zeros(4, 2), torch.ones(3, dtype=torch.bool), 8, 8)
    with pytest.raises(ValueError, match="radius"):
        dmap.gaussian_density(torch.zeros(1, 2), torch.ones(1, dtype=torch.bool), 8, 8,
                              sigma=40.0)


@pytest.fixture
def canonical_root(tmp_path):
    """train / val / test images with their points, plus an `aug` image
    the CLI must skip."""
    rng = np.random.default_rng(7)
    for split, n in (("train", 2), ("val", 1), ("test", 1)):
        (tmp_path / split).mkdir()
        for k in range(n):
            h, w = 40 + 8 * k, 56
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                tmp_path / split / f"img{k}.jpg")
            np.save(tmp_path / split / f"img{k}.npy", _points(h, w, 20, seed=k)[0])
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "train" / "img0_aug.jpg")
    return tmp_path


def _jax_cli_maps(root, sigma=4.0):
    """The JAX CLI's numpy backend (its worker function), into a dict."""
    maps = {}
    for fn in sorted(glob(os.path.join(root, "*", "*.jpg"))):
        if "aug" in os.path.basename(fn):
            continue
        jax_cli._process_numpy(fn, sigma, overwrite=True)
        maps[fn] = np.load(jax_cli._out_path(fn))
        os.remove(jax_cli._out_path(fn))
    return maps


@pytest.mark.parametrize("backend", ["cpu", "numpy"])
def test_cli_backends_write_the_jax_clis_maps(canonical_root, backend, capsys):
    want = _jax_cli_maps(str(canonical_root))
    assert len(want) == 4
    argv = ["--path", str(canonical_root), "--backend", backend]
    dmap_cli.main(argv + (["--workers", "2"] if backend == "numpy" else []))
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "4 images"
    assert out[-1].startswith("[dmap_cli] 4 of 4 images done") and "launched 0x" in out[-1]
    for fn, w in want.items():
        got = np.load(dmap_cli._out_path(fn))
        assert got.dtype == np.float32 and got.shape == w.shape
        if backend == "numpy":
            np.testing.assert_array_equal(got, w)
        else:
            np.testing.assert_allclose(got, w, **TOL)
    assert not os.path.exists(canonical_root / "train" / "img0_aug_dmap.npy")
    # existing maps are kept unless --overwrite
    dmap_cli.main(argv)
    assert "0 of 4 images done" in capsys.readouterr().out


@pytest.mark.parametrize("sigma", [8.0, 2.0])
def test_cli_cpu_backend_writes_radius_7_at_any_sigma(canonical_root, sigma, capsys):
    """The JAX CLI's numpy worker spreads each head over radius 7 whatever
    --sigma (truncate 7 / sigma, reference dmap_gen.py:79); so does every
    backend of the port's CLI."""
    want = _jax_cli_maps(str(canonical_root), sigma)
    dmap_cli.main(["--path", str(canonical_root), "--backend", "cpu", "--sigma", str(sigma)])
    assert "4 of 4 images done" in capsys.readouterr().out
    for fn, w in want.items():
        np.testing.assert_allclose(np.load(dmap_cli._out_path(fn)), w, **TOL)


def test_cli_cuda_backend_needs_the_card_and_native_is_not_ported(canonical_root):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dmap_cli.main(["--path", str(canonical_root)])  # the default backend
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dmap_cli.main(["--path", str(canonical_root), "--backend", "native"])
