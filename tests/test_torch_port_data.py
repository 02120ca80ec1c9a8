"""The port's data pipeline and tiled evaluation against the JAX package on
the CPU: datasets, transforms and loader (dgvcc_tpu_torch/data/), the
host helpers (utils/misc.py) and TiledCounter (ops/tiling.py).

The loaders must give the JAX loaders' batches bit for bit for one seed
(the same seed keys, the same draws in the same order), with thread
workers, with process workers (``worker_mode: process``) and for the
``device_aug`` path's ``RawCropDataset``. Each test that starts a process
pool runs under its own time limit (SIGALRM) and closes the pool in a
``finally``. TiledCounter's
counts and density maps are held to the JAX counter's on the same
weights (carried by ``dg_state_dict_from_flax``) at rtol 1e-4 / atol
1e-5: float32, other summation order.
"""

import io
import os
import signal
import time

import numpy as np
import pytest
import torch
from PIL import Image

import dgvcc_tpu.data  # noqa: F401  (registers the JAX datasets)
import dgvcc_tpu_torch.data  # noqa: F401  (registers the port's)
from dgvcc_tpu.core.registry import DATASETS as JAX_DATASETS
from dgvcc_tpu.data.datasets import RawCropDataset as JaxRawCropDataset
from dgvcc_tpu.data.loader import build_loader as jax_build_loader
from dgvcc_tpu.ops import tiling as jtiling
from dgvcc_tpu.utils import misc as jmisc
from dgvcc_tpu_torch.core.registry import DATASETS
from dgvcc_tpu_torch.data.datasets import RawCropDataset
from dgvcc_tpu_torch.data.loader import build_loader
from dgvcc_tpu_torch.ops import dmap, tiling
from dgvcc_tpu_torch.utils import misc
from test_torch_port_helpers import dg_pair, time_limit

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Canonical layout (image, points, _dmap) of varied sizes, one image
    smaller than the crop, plus JHU domain lists."""
    root = tmp_path_factory.mktemp("portdata")
    rng = np.random.default_rng(11)
    sizes = [(48, 64), (40, 52), (56, 44), (28, 60), (64, 64), (44, 40)]
    (root / "domains").mkdir()
    for split, n in (("train", 6), ("val", 3), ("test", 2)):
        (root / split).mkdir()
        names = []
        for k in range(n):
            h, w = sizes[k]
            fn = root / split / f"img{k:02d}.jpg"
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(fn)
            pts = rng.uniform(0, [w, h], (int(rng.integers(0, 25)), 2)).astype(np.float32)
            np.save(root / split / f"img{k:02d}.npy", pts)
            np.save(root / split / f"img{k:02d}_dmap.npy",
                    dmap.gaussian_density_fixed_np((h, w), pts))
            names.append(str(fn))
        if split != "test":
            (root / "domains" / f"snow_{split}.txt").write_text("\n".join(names) + "\n")
    return str(root)


def _params(root, name):
    p = {"root": root, "crop_size": 32, "downsample": 1, "is_grey": False,
         "unit_size": 16, "pre_resize": 1}
    if name.startswith("jhu"):
        p.update(domain_label="snow", domain_type="weather")
    return p


def _assert_same(a, b, where):
    assert a.keys() == b.keys(), where
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (where, k)
        np.testing.assert_array_equal(x, y, err_msg=f"{where} {k}")


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("name", ["den_cls", "den", "jhu_domain_cls"])
def test_loaders_yield_the_jax_batches_bit_for_bit(data_root, name, split):
    """The JAX loader runs without workers: with thread workers its den_cls
    second view can take another sample's crop (ROADMAP.md, Queue 3); the
    port's loader runs with two threads and must not."""
    spec = ({"batch_size": 2, "shuffle": True} if split == "train"
            else {"batch_size": 1, "shuffle": False})
    params = _params(data_root, name)
    jl = jax_build_loader(JAX_DATASETS.build(name, method=split, **params),
                          dict(spec, num_workers=0), seed=5)
    pl = build_loader(DATASETS.build(name, method=split, **params),
                      dict(spec, num_workers=2), seed=5)
    epochs = []
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        want, got = list(jl), list(pl)
        assert len(got) == len(want) == len(pl) > 0
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_same(a, b, f"{name} {split} epoch {epoch} batch {i}")
        epochs.append(got)
    if split == "train":  # another epoch, other crops and order
        assert not np.array_equal(epochs[0][0]["img1"], epochs[1][0]["img1"])
        assert epochs[0][0]["img1"].shape == (2, 32, 32, 3)


def test_unported_datasets_and_worker_mode_point_to_the_roadmap(data_root):
    """Every dataset of the JAX package is registered now (the Bayesian-loss
    datasets since they were ported; tests/test_torch_port_bayesian.py holds
    them); a worker_mode other than thread or process raises rather than
    falling back to threads."""
    import dgvcc_tpu.data  # noqa: F401
    from dgvcc_tpu.core.registry import DATASETS as JAX_DATASETS

    assert all(name in DATASETS for name in JAX_DATASETS._fns)
    assert len(DATASETS.build("bay", method="train", **_params(data_root, "den"))) > 0
    ds = DATASETS.build("den", method="train", **_params(data_root, "den"))
    with pytest.raises(ValueError, match="worker_mode 'processes'"):
        build_loader(ds, {"batch_size": 2, "worker_mode": "processes"})


def _epochs(loader, epochs=(0, 1)):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("name", ["den_cls", "den", "jhu_domain_cls"])
def test_process_loader_yields_the_thread_and_jax_batches(data_root, name, split):
    spec = ({"batch_size": 2, "shuffle": True} if split == "train"
            else {"batch_size": 1, "shuffle": False})
    params = _params(data_root, name)
    jl = jax_build_loader(JAX_DATASETS.build(name, method=split, **params),
                          dict(spec, num_workers=0), seed=5)
    tl = build_loader(DATASETS.build(name, method=split, **params),
                      dict(spec, num_workers=2), seed=5)
    pl = build_loader(DATASETS.build(name, method=split, **params),
                      dict(spec, num_workers=2, worker_mode="process"), seed=5)
    try:
        with time_limit():
            got = _epochs(pl)
    finally:
        pl.close()
    for epoch, (want, threads, procs) in enumerate(zip(_epochs(jl), _epochs(tl), got)):
        assert len(procs) == len(threads) == len(want) == len(pl) > 0
        for i, (a, b, c) in enumerate(zip(want, threads, procs)):
            _assert_same(a, c, f"{name} {split} epoch {epoch} batch {i} vs JAX")
            _assert_same(b, c, f"{name} {split} epoch {epoch} batch {i} vs threads")


@pytest.mark.parametrize("worker_mode", ["thread", "process"])
@pytest.mark.parametrize("pre_crop", [40, 72])
def test_raw_crop_batches_match_jax(data_root, pre_crop, worker_mode):
    """device_aug's host share: the uint8 pre-crop and its density map,
    padded where the image is smaller (72 pads every image, 40 some)."""
    params = _params(data_root, "den_cls")
    spec = {"batch_size": 3, "shuffle": True}
    jl = jax_build_loader(JaxRawCropDataset(JAX_DATASETS.build("den_cls", method="train",
                                                               **params), pre_crop),
                          dict(spec, num_workers=0), seed=8)
    pl = build_loader(RawCropDataset(DATASETS.build("den_cls", method="train", **params),
                                     pre_crop),
                      dict(spec, num_workers=2, worker_mode=worker_mode), seed=8)
    try:
        with time_limit():
            got = _epochs(pl)
    finally:
        pl.close()
    for epoch, (want, batches) in enumerate(zip(_epochs(jl), got)):
        assert len(batches) == len(want) == 2
        for i, (a, b) in enumerate(zip(want, batches)):
            _assert_same(a, b, f"raw crop {pre_crop} epoch {epoch} batch {i}")
            assert b["frames_u8"].shape == (3, pre_crop, pre_crop, 3)
            assert b["frames_u8"].dtype == np.uint8


def test_process_workers_end_with_close_and_restart(data_root):
    """close() (also run by the trainer after its runs) ends the workers;
    the next epoch starts new ones. The workers ignore SIGINT and die on
    SIGTERM whatever handler the parent has installed."""
    ds = DATASETS.build("den", method="train", **_params(data_root, "den"))
    pl = build_loader(ds, {"batch_size": 2, "shuffle": True, "num_workers": 2,
                           "worker_mode": "process"}, seed=1)
    prev = signal.signal(signal.SIGTERM, lambda *a: None)
    try:
        with time_limit():
            first = list(pl)
            workers = list(pl._pool._pool)
            assert len(workers) == 2 and all(w.is_alive() for w in workers)
            pl.close()
            for w in workers:
                w.join(timeout=30)
                assert not w.is_alive()
            assert pl._pool is None
            again = list(pl)
    finally:
        signal.signal(signal.SIGTERM, prev)
        pl.close()
    for a, b in zip(first, again):
        _assert_same(a, b, "after a restart")


class _Touching:
    """A dataset that leaves a file for each sample it makes (visible
    across the fork)."""

    def __init__(self, base, where):
        self.base, self.where = base, where

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index, rng=None):
        open(os.path.join(self.where, str(index)), "w").close()
        return self.base.__getitem__(index, rng=rng)


def test_process_loader_keeps_prefetch_batches_in_flight(data_root, tmp_path):
    """Workers make the batch being read and ``prefetch`` more, not the
    whole epoch ahead of the consumer."""
    base = DATASETS.build("den", method="train", **_params(data_root, "den"))
    pl = build_loader(_Touching(base, str(tmp_path)),
                      {"batch_size": 1, "shuffle": True, "num_workers": 2,
                       "worker_mode": "process", "prefetch": 1},
                      seed=3, collate=type(base).collate)
    try:
        with time_limit():
            it = iter(pl)
            next(it)
            time.sleep(1.0)
            made = len(os.listdir(tmp_path))
            rest = list(it)
    finally:
        pl.close()
    assert len(pl) == 6 and len(rest) == 5
    assert 1 <= made <= 2, made


def test_host_helpers_match_jax():
    for h, w, nh, nw in [(10, 20, 32, 32), (40, 20, 32, 33), (7, 7, 7, 8), (50, 60, 16, 16)]:
        assert misc.get_padding(h, w, nh, nw) == jmisc.get_padding(h, w, nh, nw)
    bbox = np.random.default_rng(0).uniform(0, 50, (20, 4))
    np.testing.assert_array_equal(misc.cal_inner_area(5, 7, 30, 40, bbox),
                                  jmisc.cal_inner_area(5, 7, 30, 40, bbox))
    img = np.random.default_rng(1).uniform(-1, 1, (4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(misc.denormalize(img), jmisc.denormalize(img))
    a, b = misc.DictAvgMeter(), jmisc.DictAvgMeter()
    for v in (1.0, 4.0, 2.5):
        a.update({"mae": v}, n=2)
        b.update({"mae": v}, n=2)
    assert a.avg == b.avg
    for mod in (misc, jmisc):  # the progress line on a stream that asks for it
        stream = io.StringIO()
        assert list(mod.progress(range(3), "Testing...", enabled=True, stream=stream)) \
            == [0, 1, 2]
        assert "Testing... 3/3 (100%)" in stream.getvalue()
        assert list(mod.progress(range(3), "x", stream=stream)) == [0, 1, 2]  # no TTY


@pytest.mark.parametrize("hw,ps", [((70, 90), 32), ((40, 200), 64), ((33, 33), 16)])
def test_tile_image_and_mask_pooling_match_jax(hw, ps):
    img = np.random.default_rng(sum(hw)).uniform(-1, 1, hw + (3,)).astype(np.float32)
    want = jtiling.tile_image(img, ps)
    got = tiling.tile_image(torch.from_numpy(img), ps)
    assert got[2:] == want[2:]
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    d_shape = (want[1].shape[0], ps // 4, ps // 4, 1)
    pooled = tiling.pool_mask_to(got[1].permute(0, 3, 1, 2), (d_shape[0], 1) + d_shape[1:3])
    np.testing.assert_allclose(pooled.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jtiling.pool_mask_to(want[1], d_shape)), **TOL)
    assert [tiling._bucket(n) for n in range(1, 80)] == [jtiling._bucket(n) for n in range(1, 80)]


@pytest.mark.parametrize("hw,ps", [((70, 90), 1440), ((70, 90), 32), ((100, 40), 64)],
                         ids=["whole_image", "tiled_bucket_padded", "tiled_tall"])
def test_tiled_counter_matches_jax(hw, ps):
    """Whole-image mode (H, W padded to 128) and tiled mode (tile count
    padded to its bucket with black tiles) on the same weights. The port's
    counter runs the bank's serving kernel flag (its plain version on the
    CPU) in eval mode and puts the training state's flags back."""
    jm, variables, pm = dg_pair("final", seed=24)
    jc = jtiling.TiledCounter(lambda v, t: jm.apply(v, t), 1000.0, ps)
    pm.memory.fused = False  # as create_train_state leaves it
    pm.train()
    seen = []
    bank_forward = pm.memory.forward
    pm.memory.forward = lambda y, mem: (seen.append(pm.memory.fused), bank_forward(y, mem))[1]
    pc = tiling.TiledCounter(pm, 1000.0, ps, device="cpu")
    img = np.random.default_rng(hw[0]).uniform(-1, 1, hw + (3,)).astype(np.float32)
    count = pc.count(img)
    np.testing.assert_allclose(count, jc.count(variables, img), **TOL)
    np.testing.assert_allclose(pc.density_map(img), jc.density_map(variables, img), **TOL)
    assert seen and all(seen)
    assert pm.memory.fused is False and pm.training
    assert abs(count) > 1e-3  # the map is not all zero
