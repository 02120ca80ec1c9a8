"""The port's batched two-view augmentation (dgvcc_tpu_torch/data/
device_pipeline.py) against the JAX package's (dgvcc_tpu/data/
device_pipeline.py) on the CPU.

Random streams cannot match across frameworks, so the draws are injected:
the port's ``apply_augmentation`` and a per-sample composition of the JAX
functions (its ``per_sample`` with the given crop, flip and gates) get the
same draws. Tolerances, float32:

  * each function alone, and img1, dmap and bmap of the whole batch:
    atol 1e-6 (1.2e-7 measured: XLA sums the grey weights as a chain of
    FMAs and reduces the contrast mean in another order, one ulp apart);
  * img2 of the whole batch, after jitter, blur and sharpness: atol 5e-6.
    Those one-ulp differences of the grey sum and the contrast mean go
    through the sharpness blend, smooth + 5 (x - smooth), which multiplies
    them by up to 11, and through the normalisation (x 2): 2 ulps x 11 x 2
    is 5.2e-6; 1.8e-6 measured.

The draws themselves are held to their laws by statistics: each gate's
share within 4 sigma of its probability over 4096 samples, the factors
and crop offsets uniform over their ranges.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgvcc_tpu.data import device_pipeline as J
from dgvcc_tpu_torch.data import device_pipeline as P

TOL = dict(rtol=0, atol=1e-6)
TOL_VIEW2 = dict(rtol=0, atol=5e-6)
N_STAT = 4096


def _images(seed, shape=(3, 24, 28, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


FUNCTIONS = {
    "rgb_to_grey3": (lambda x, f: J.rgb_to_grey3(x), lambda x, f: P.rgb_to_grey3(x)),
    "brightness": (J.adjust_brightness, P.adjust_brightness),
    "contrast": (J.adjust_contrast, P.adjust_contrast),
    "saturation": (J.adjust_saturation, P.adjust_saturation),
    "hue": (J.adjust_hue, P.adjust_hue),
    "blur": (J.gaussian_blur3, P.gaussian_blur3),
    "sharpness": (J.adjust_sharpness, P.adjust_sharpness),
}
FACTORS = {"rgb_to_grey3": (None,), "brightness": (0.5, 1.37), "contrast": (0.8, 1.2),
           "saturation": (0.83, 1.2), "hue": (-0.1, 0.047), "blur": (1.0, 0.85),
           "sharpness": (5.0, 1.7)}


@pytest.mark.parametrize("name,factor", [(n, f) for n, fs in FACTORS.items() for f in fs])
def test_each_function_matches_jax(name, factor):
    """One image at a time, as the JAX pipeline applies them (vmapped)."""
    jf, pf = FUNCTIONS[name]
    x = _images(sum(map(ord, name)))
    want = np.asarray(jax.vmap(lambda a: jf(a, factor))(jnp.asarray(x)))
    got = pf(torch.from_numpy(x), factor).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["brightness", "contrast", "saturation", "hue"])
def test_per_sample_factors_match_jax(name):
    """A (B,) factor tensor applies one factor per image of the batch."""
    jf, pf = FUNCTIONS[name]
    x = _images(7, (4, 20, 16, 3))
    f = np.array([0.9, 1.1, 0.05, -0.08] if name == "hue" else [0.8, 1.2, 0.95, 1.4],
                 np.float32)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(x), jnp.asarray(f)))
    got = pf(torch.from_numpy(x), torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _jax_batch(frames, dmaps, draws, crop, block=16):
    """The JAX package's per-sample transform (device_pipeline.py:
    augment_two_view_batch, _geometric, photometric_view) on given draws."""
    imgs = jnp.asarray(frames).astype(jnp.float32) / 255.0
    d = {k: np.asarray(v) for k, v in draws.items()}
    img1s, img2s, dms = [], [], []
    for b in range(frames.shape[0]):
        i, j = int(d["i"][b]), int(d["j"][b])
        img = jax.lax.dynamic_slice(imgs[b], (i, j, 0), (crop, crop, 3))
        dm = jax.lax.dynamic_slice(jnp.asarray(dmaps[b]), (i, j, 0), (crop, crop, 1))
        if d["flip"][b]:
            img, dm = img[:, ::-1], dm[:, ::-1]
        if d["grey"][b]:
            img = J.rgb_to_grey3(img)
        x = img
        if d["jitter"][b]:
            x = J.adjust_brightness(x, d["fb"][b])
            x = J.adjust_contrast(x, d["fc"][b])
            x = J.adjust_saturation(x, d["fs"][b])
            x = jnp.clip(J.adjust_hue(x, d["fh"][b]), 0.0, 1.0)
        if d["blur"][b]:
            x = J.gaussian_blur3(x, 1.0)
        if d["sharpen"][b]:
            x = J.adjust_sharpness(x, 5.0)
        img1s.append((img - 0.5) / 0.5)
        img2s.append((x - 0.5) / 0.5)
        dms.append(dm)
    dmap = jnp.stack(dms)
    bh = crop // block
    blocks = dmap[..., 0].reshape(-1, bh, block, bh, block).sum(axis=(2, 4))
    return {"img1": np.asarray(jnp.stack(img1s)), "img2": np.asarray(jnp.stack(img2s)),
            "dmap": np.asarray(dmap), "bmap": np.asarray((blocks > 0).astype(jnp.float32))[..., None]}


def _frames(seed, b=6, h=52, w=60):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    dmaps = (rng.uniform(0, 1, (b, h, w, 1)) * (rng.uniform(0, 1, (b, h, w, 1)) < 0.02)
             ).astype(np.float32)
    return frames, dmaps


@pytest.mark.parametrize("gates", ["drawn", "all_on", "all_off"])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_with_injected_draws_matches_jax(seed, gates):
    frames, dmaps = _frames(seed)
    crop = 32
    draws = P.draw_augmentation(frames.shape[0], 52, 60, crop,
                                torch.Generator().manual_seed(seed))
    if gates != "drawn":
        for name in P.GATES:
            draws[name] = torch.full_like(draws[name], gates == "all_on")
    got = P.apply_augmentation(torch.from_numpy(frames), torch.from_numpy(dmaps), draws, crop)
    want = _jax_batch(frames, dmaps, draws, crop)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.float32 and g.shape == (frames.shape[0],) + w.shape[3:] \
            + w.shape[1:3], k
        assert g.is_contiguous(memory_format=torch.channels_last), k
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, err_msg=k,
                                   **(TOL_VIEW2 if k == "img2" else TOL))


def test_same_generator_seed_same_batch_and_device_checks():
    frames, dmaps = (torch.from_numpy(a) for a in _frames(3))
    a, b = (P.augment_two_view_batch(frames, dmaps, torch.Generator().manual_seed(9), 32)
            for _ in range(2))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    c = P.augment_two_view_batch(frames, dmaps, torch.Generator().manual_seed(10), 32)
    assert not torch.equal(a["img2"], c["img2"])
    with pytest.raises(ValueError, match="cannot give"):
        P.augment_two_view_batch(frames, dmaps, torch.Generator(), 64)
    with pytest.raises(ValueError, match="cannot give"):
        P.augment_two_view_batch(frames, dmaps, torch.Generator(), 40)  # 40 % 16


@pytest.fixture(scope="module")
def stat_draws():
    return P.draw_augmentation(N_STAT, 384, 400, 320, torch.Generator().manual_seed(2024))


@pytest.mark.parametrize("gate", list(P.GATES))
def test_each_gate_is_drawn_with_its_probability(stat_draws, gate):
    p = P.GATES[gate]
    assert p == {"flip": 0.5, "grey": 0.12, "jitter": 0.8, "blur": 0.5, "sharpen": 0.5}[gate]
    share = stat_draws[gate].float().mean().item()
    assert abs(share - p) <= 4 * math.sqrt(p * (1 - p) / N_STAT), (gate, share)


@pytest.mark.parametrize("factor", list(P.JITTER_RANGES))
def test_each_jitter_factor_is_uniform_over_its_range(stat_draws, factor):
    """The JAX package's ranges (device_pipeline.py:78-81): a uniform law
    has mean (lo + hi) / 2 and variance (hi - lo)^2 / 12."""
    lo, hi = P.JITTER_RANGES[factor]
    assert (lo, hi) == {"fb": (0.5, 1.5), "fc": (0.8, 1.2), "fs": (0.8, 1.2),
                        "fh": (-0.1, 0.1)}[factor]
    v = stat_draws[factor].double()
    assert lo <= v.min().item() and v.max().item() <= hi
    sd = (hi - lo) / math.sqrt(12)
    assert abs(v.mean().item() - (lo + hi) / 2) <= 4 * sd / math.sqrt(N_STAT)
    assert abs(v.std().item() - sd) <= 0.05 * sd


@pytest.mark.parametrize("offset,span", [("i", 384 - 320), ("j", 400 - 320)])
def test_crop_offsets_are_uniform_over_the_positions_that_fit(stat_draws, offset, span):
    v = stat_draws[offset]
    assert v.dtype == torch.int64
    assert v.min().item() == 0 and v.max().item() == span
    counts = torch.bincount(v, minlength=span + 1).double()
    expected = N_STAT / (span + 1)
    chi2 = ((counts - expected) ** 2 / expected).sum().item()
    # chi-square with `span` degrees of freedom: mean span, sd sqrt(2 span)
    assert chi2 <= span + 4 * math.sqrt(2 * span), chi2
