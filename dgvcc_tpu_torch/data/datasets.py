"""Online datasets, counterpart of dgvcc_tpu/data/datasets.py.

Copies of the JAX package's dataset classes (reference datasets/*.py):
samples and batches are NHWC numpy dicts, ragged point lists are padded
to bucketed shapes with validity masks, and every random decision draws
from the per-sample ``random.Random`` the loader passes, in the JAX
package's order, so one seed gives the same samples bit for bit.

Registered: ``den`` (``DensityMapDataset``), ``den_cls``
(``DenClsDataset``) and ``bay`` (``BayesianDataset``, the Bayesian loss's
points and targets), plus ``jhu_domain`` / ``jhu_domain_cls`` /
``jhu_domain_bay`` in ``data/jhu.py``. ``RawCropDataset`` wraps a ``den`` /
``den_cls`` train split for the trainer's ``device_aug``.

Kept from the JAX package, on purpose: ``den`` loads ``{name}_dmap.npy``
(what ``data/dmap_cli.py`` writes) with a ``_dmap2`` fallback.

Changed, on purpose: the second view of ``den_cls`` is made from the crop
the first view's function returns. The JAX package keeps that crop on the
dataset object (``self._last_pil``) and reads it back after the call, so
with thread workers a sample can take another sample's crop as its second
view; a crop passed back cannot be taken by another thread.
"""

from __future__ import annotations

import os
import random
from glob import glob
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from dgvcc_tpu_torch.core.registry import DATASETS
from dgvcc_tpu_torch.data import transforms as T
from dgvcc_tpu_torch.utils.misc import cal_inner_area, get_padding, random_crop


def _point_bucket(n: int, step: int = 64) -> int:
    return max(step, int(np.ceil(n / step)) * step)


def pad_points(points_list: List[np.ndarray], targets_list=None) -> Dict[str, np.ndarray]:
    """Ragged point lists -> (B, Nb, 2) points, (B, Nb) mask, (B,) counts,
    and with ``targets_list`` (B, Nb) targets."""
    n_max = _point_bucket(max((len(p) for p in points_list), default=0))
    b = len(points_list)
    pts = np.zeros((b, n_max, 2), np.float32)
    msk = np.zeros((b, n_max), bool)
    tgt = np.zeros((b, n_max), np.float32) if targets_list is not None else None
    for i, p in enumerate(points_list):
        if len(p):
            pts[i, :len(p)] = p
            msk[i, :len(p)] = True
            if tgt is not None:
                tgt[i, :len(p)] = targets_list[i]
    out = {"points": pts, "pt_mask": msk,
           "gt_count": np.asarray([len(p) for p in points_list], np.float32)}
    if tgt is not None:
        out["targets"] = tgt
    return out


class CrowdDataset:
    """(image, head points): reference datasets/base_dataset.py.

    Layout: {root}/{train,val,test}/NAME.{jpg,png} + NAME.npy (points,
    (N, 2) xy), with optional ``roi_map_path`` masking. Images of the
    generation mode (``gen_root``, base_dataset.py:52-54, 89-92) and a
    separate ``gt_dir`` are not ported. Subclasses give ``_train_sample``.
    """

    name = "base"

    def __init__(self, root, crop_size, downsample, method, is_grey=False,
                 unit_size=0, pre_resize=1, roi_map_path=None):
        self.root = root
        self.crop_size = (crop_size, crop_size) if isinstance(crop_size, int) else tuple(crop_size)
        self.downsample = downsample
        self.method = method
        self.is_grey = is_grey
        self.unit_size = unit_size
        self.pre_resize = pre_resize
        self.roi_map = (
            np.load(roi_map_path, allow_pickle=True).tolist()
            if roi_map_path is not None else None
        )
        if method not in ("train", "val", "test"):
            raise ValueError("method must be train, val or test")
        self.img_fns = self._list_images()

    def _list_images(self):
        return sorted(
            glob(os.path.join(self.root, self.method, "*.jpg"))
            + glob(os.path.join(self.root, self.method, "*.png"))
        )

    def __len__(self):
        return len(self.img_fns)

    # ---- IO ---------------------------------------------------------------

    def _load_img(self, img_fn):
        img = Image.open(img_fn).convert("RGB")
        if self.roi_map is not None:
            arr = np.array(img) * np.expand_dims(self.roi_map, 2)
            img = Image.fromarray(arr.astype(np.uint8))
        return img, os.path.splitext(img_fn)[1]

    def _gt_path(self, img_fn, img_ext):
        base = os.path.basename(img_fn).rsplit(".", 1)[0]
        gt_fn = img_fn.replace(img_ext, ".npy")
        # augmented-image aliases share the source gt (den_cls_dataset.py:44-47)
        if base.endswith("_aug"):
            gt_fn = gt_fn.replace("_aug", "")
            base = base[:-4]
        elif base.endswith("_aug2"):
            gt_fn = gt_fn.replace("_aug2", "")
            base = base[:-5]
        return gt_fn, base

    def _load_gt(self, gt_fn):
        gt = np.load(gt_fn)
        if self.roi_map is not None and len(gt) > 0:
            roi = np.asarray(self.roi_map)
            keep = roi[gt[:, 1].astype(int), gt[:, 0].astype(int)].astype(bool)
            gt = gt[keep]
        return gt.astype(np.float64).reshape(-1, 2)

    def _load_dmap(self, gt_fn, base):
        for suffix in ("_dmap", "_dmap2"):
            p = gt_fn.replace(base + ".npy", base + suffix + ".npy")
            if os.path.exists(p):
                dmap = np.load(p)
                break
        else:
            raise FileNotFoundError(f"no density map for {base} next to {gt_fn}")
        if self.roi_map is not None:
            # mask density outside the ROI like the image and points
            # (den_dataset.py:27-31)
            dmap = dmap * np.asarray(self.roi_map, np.float32)
        return dmap

    # ---- sampling ---------------------------------------------------------

    def __getitem__(self, index, rng: Optional[random.Random] = None):
        rng = rng or random
        img_fn = self.img_fns[index]
        img, img_ext = self._load_img(img_fn)
        gt_fn, base = self._gt_path(img_fn, img_ext)
        gt = self._load_gt(gt_fn)
        if self.method == "train":
            return self._train_sample(img, gt, gt_fn, base, rng)
        return self._val_sample(img, gt, base, rng)

    def _train_sample(self, img, gt, gt_fn, base, rng) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _maybe_grey(self, img, rng):
        if rng.random() > 0.88:
            img = img.convert("L").convert("RGB")
        return img

    def _val_pad(self, img, gt):
        """pre_resize + pad to a unit_size multiple (base_dataset.py:157-183)."""
        if self.pre_resize != 1:
            img = img.resize((int(img.size[0] * self.pre_resize),
                              int(img.size[1] * self.pre_resize)))
        if self.unit_size and self.unit_size > 0:
            w, h = img.size
            us = self.unit_size
            new_w = w if w % us == 0 else (w // us + 1) * us
            new_h = h if h % us == 0 else (h // us + 1) * us
            padding, h, w = get_padding(h, w, new_h, new_w)
            img = T.pil_pad(img, padding)
            if len(gt) > 0:
                gt = gt + [padding[0], padding[1]]
        else:
            padding = (0, 0, 0, 0)
        return img, gt, padding

    def _val_view(self, img, gt, name):
        """(sample, the padded PIL image it was made from)."""
        img, gt, padding = self._val_pad(img, gt)
        gt = gt / self.downsample
        return {
            "img1": T.to_tensor_normalize(img),
            "gt": gt.astype(np.float32),
            "name": name,
            "padding": padding,
        }, img

    def _val_sample(self, img, gt, name, rng) -> Dict:
        return self._val_view(img, gt, name)[0]


@DATASETS.register("den")
class DensityMapDataset(CrowdDataset):
    """(image, points, density map): reference datasets/den_dataset.py.

    Train: the dmap is resized with mass renormalization, cropped, and
    sum-pool downsampled (den_dataset.py:75-111), so the count is kept.
    """

    name = "den"

    def _train_sample(self, img, gt, gt_fn, base, rng):
        dmap = self._load_dmap(gt_fn, base).astype(np.float32)
        return self._train_with_dmap(img, gt, dmap, rng)[0]

    def _train_with_dmap(self, img, gt, dmap, rng, resize_enabled=True):
        """(sample, the final PIL crop it was made from)."""
        w, h = img.size
        img = self._maybe_grey(img, rng)

        if resize_enabled:
            # den resizes unconditionally (the min-size guard is commented
            # out in den_dataset.py:70; the padding below handles images
            # that shrink under the crop size)
            factor = self.pre_resize * (rng.random() * 0.5 + 0.75)
            new_w, new_h = int(w * factor), int(h * factor)
            if factor != 1.0:
                w, h = new_w, new_h
                img = img.resize((w, h))
                mass = dmap.sum()
                dimg = Image.fromarray(dmap)
                dmap = np.asarray(dimg.resize((w, h), Image.BILINEAR), np.float32)
                if dmap.sum() > 0:
                    dmap = dmap * (mass / dmap.sum())  # mass renorm (den_dataset.py:75-78)
                gt = gt * factor

        if min(w, h) < min(self.crop_size):
            padding, h, w = get_padding(h, w, self.crop_size[0], self.crop_size[1])
            img = T.pil_pad(img, padding)
            dmap = T.np_pad_hw(dmap, padding)
            if len(gt) > 0:
                gt = gt + [padding[0], padding[1]]

        i, j = random_crop(h, w, self.crop_size[0], self.crop_size[1], rng)
        h, w = self.crop_size
        img = img.crop((j, i, j + w, i + h))
        dmap = dmap[i : i + h, j : j + w]
        if len(gt) > 0:
            gt = gt - [j, i]
            keep = (gt[:, 0] >= 0) & (gt[:, 0] <= w) & (gt[:, 1] >= 0) & (gt[:, 1] <= h)
            gt = gt[keep]
        else:
            gt = np.empty([0, 2])

        # count-preserving sum-pool downsample (den_dataset.py:109-111)
        ds = self.downsample
        if ds > 1:
            dh, dw = h // ds, w // ds
            dmap = dmap.reshape(dh, ds, dw, ds).sum(axis=(1, 3))
        if len(gt) > 0:
            gt = gt / ds

        if rng.random() > 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            dmap = dmap[:, ::-1].copy()
            if len(gt) > 0:
                gt[:, 0] = (w // ds if ds > 1 else w) - gt[:, 0]

        return {
            "img1": T.to_tensor_normalize(img),
            "gt": gt.astype(np.float32),
            "dmap": dmap[..., None].astype(np.float32),
        }, img

    @staticmethod
    def collate(samples):
        out = {
            "img1": np.stack([s["img1"] for s in samples]),
            "dmap": np.stack([s["dmap"] for s in samples]),
        }
        out.update(pad_points([s["gt"] for s in samples]))
        return out


@DATASETS.register("den_cls")
class DenClsDataset(DensityMapDataset):
    """Two views with a foreground block map: reference
    datasets/den_cls_dataset.py. img1 = the clean crop, img2 = heavy
    photometric aug of the SAME crop; bmap = (16x16 block sum of dmap) > 0
    (den_cls_dataset.py:62-64). Random resize is off
    (den_cls_dataset.py:87-101)."""

    name = "den_cls"
    BLOCK = 16

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.photo = T.TwoViewPhotometric()

    def _train_sample(self, img, gt, gt_fn, base, rng):
        dmap = self._load_dmap(gt_fn, base).astype(np.float32)
        s, crop = self._train_with_dmap(img, gt, dmap, rng, resize_enabled=False)
        s["img2"] = T.to_tensor_normalize(self.photo(crop, rng))
        d = s["dmap"][..., 0]
        bh, bw = d.shape[0] // self.BLOCK, d.shape[1] // self.BLOCK
        block = d.reshape(bh, self.BLOCK, bw, self.BLOCK).sum(axis=(1, 3))
        s["bmap"] = (block > 0).astype(np.float32)[..., None]
        return s

    def _val_sample(self, img, gt, name, rng):
        s, padded = self._val_view(img, gt, name)
        s["img2"] = T.to_tensor_normalize(self.photo(padded, rng))
        return s

    @staticmethod
    def collate(samples):
        out = {
            "img1": np.stack([s["img1"] for s in samples]),
            "img2": np.stack([s["img2"] for s in samples]),
            "dmap": np.stack([s["dmap"] for s in samples]),
            "bmap": np.stack([s["bmap"] for s in samples]),
        }
        out.update(pad_points([s["gt"] for s in samples]))
        return out


class RawCropDataset:
    """The host's share of the ``device_aug`` path: JPEG decode, the density
    map's load and one uint8 pre-crop of ``pre_crop`` (padded to it, as
    the den datasets pad, when the image is smaller), nothing else. The
    final crop, flip, greyscale, second view and foreground map run
    batched on the card (``data/device_pipeline.py``). A pre-crop larger
    than the crop leaves the card room for its own random crop.

    Samples draw from the loader's ``random.Random``, in the JAX
    ``RawCropDataset``'s order, so one seed gives its batches bit for bit.
    """

    def __init__(self, base: DensityMapDataset, pre_crop: int):
        self.base = base
        self.pre_crop = pre_crop
        self.img_fns = base.img_fns

    def __len__(self):
        return len(self.base)

    def __getitem__(self, index, rng: Optional[random.Random] = None):
        rng = rng or random
        b = self.base
        img_fn = b.img_fns[index]
        img, img_ext = b._load_img(img_fn)
        gt_fn, basename = b._gt_path(img_fn, img_ext)
        dmap = b._load_dmap(gt_fn, basename).astype(np.float32)
        w, h = img.size
        pc = self.pre_crop
        if w < pc or h < pc:
            padding, h, w = get_padding(h, w, pc, pc)
            img = T.pil_pad(img, padding)
            dmap = T.np_pad_hw(dmap, padding)
        i, j = random_crop(h, w, pc, pc, rng)
        img = img.crop((j, i, j + pc, i + pc))
        dmap = dmap[i : i + pc, j : j + pc]
        return {"frames_u8": np.asarray(img, np.uint8), "dmaps": dmap[..., None]}

    @staticmethod
    def collate(samples):
        return {"frames_u8": np.stack([s["frames_u8"] for s in samples]),
                "dmaps": np.stack([s["dmaps"] for s in samples])}


@DATASETS.register("bay")
class BayesianDataset(CrowdDataset):
    """The Bayesian loss's dataset: reference datasets/bay_dataset.py.

    A train sample is a crop, its points and each point's target: the share
    of the point's box (side: its mean 3-NN distance, computed before the
    resize and clipped to [4, 128]) inside the crop; a point survives at a
    share of 0.3 (bay_dataset.py:85-98). bay's own resize law
    (pre_resize * U * 0.8 + 0.6, only when the result still holds the crop).
    The points are mirrored only when the image is flipped, as the JAX
    package fixed the reference, which mirrors them always."""

    name = "bay"

    @staticmethod
    def _cal_dists(pts):
        """Mean 3-NN distance per point (bay_dataset.py:38-48), with the
        reference's quirks the JAX package keeps: ``np.partition`` pins only
        column 3, so a point's own 0 may count among its three, and under
        four points the mean takes every other column."""
        if len(pts) == 0:
            return np.zeros((0, 1))
        if len(pts) == 1:
            return np.array([[4.0]])
        sq = np.sum(pts * pts, axis=1)
        dists = np.sqrt(np.maximum(sq[:, None] - 2 * pts @ pts.T + sq[None, :], 0.0))
        if len(pts) < 4:
            return np.mean(dists[:, 1:], axis=1, keepdims=True)
        return np.mean(np.partition(dists, 3, axis=1)[:, 1:4], axis=1, keepdims=True)

    def _train_sample(self, img, gt, gt_fn, base, rng):
        dists = self._cal_dists(gt)
        w, h = img.size
        img = self._maybe_grey(img, rng)
        factor = self.pre_resize * rng.random() * 0.8 + 0.6
        new_w, new_h = int(w * factor), int(h * factor)
        if min(new_w, new_h) >= min(self.crop_size):
            # the distances stay as they were before the resize (the reference)
            w, h = new_w, new_h
            img = img.resize((w, h))
            gt = gt * factor

        st_size = min(w, h)
        if st_size < self.crop_size[0]:
            st_size = self.crop_size[0]
            padding, h, w = get_padding(h, w, self.crop_size[0], self.crop_size[1])
            img = T.pil_pad(img, padding)
            if len(gt) > 0:
                gt = gt + [padding[0], padding[1]]

        i, j = random_crop(h, w, self.crop_size[0], self.crop_size[1], rng)
        h, w = self.crop_size
        img = img.crop((j, i, j + w, i + h))
        targ = np.zeros(0, np.float32)
        if len(gt) > 0:
            nearest = np.clip(dists, 4.0, 128.0)
            bbox = np.concatenate((gt - nearest / 2.0, gt + nearest / 2.0), axis=1)
            inner = cal_inner_area(j, i, j + w, i + h, bbox)
            ratio = np.clip(inner / np.squeeze(nearest * nearest, axis=-1), 0.0, 1.0)
            keep = ratio >= 0.3
            targ = ratio[keep].astype(np.float32)
            gt = gt[keep] - [j, i]

        if rng.random() > 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if len(gt) > 0:
                gt[:, 0] = w - gt[:, 0]
        return {"img1": T.to_tensor_normalize(img), "gt": gt.astype(np.float32),
                "targets": targ, "st_size": np.float32(st_size)}

    @staticmethod
    def collate(samples):
        out = {"img1": np.stack([s["img1"] for s in samples])}
        out.update(pad_points([s["gt"] for s in samples], [s["targets"] for s in samples]))
        out["st_sizes"] = np.asarray([s["st_size"] for s in samples], np.float32)
        return out
