"""SYSU-MM01 cross-modal data pipeline (port of ``vqvae2_tpu/data/sysu.py``):
pure numpy and PIL, the same code, so one seed gives the JAX package's batches
bit for bit.

* :class:`SYSUData` — paired (RGB, IR) training set from the pre-resized
  ``.npy`` blobs + per-identity position pickles, with the part-label mode's
  synchronized crop/flip/erase augmentations.
* :class:`IdentitySampler` — P×K epoch sampler drawing ``batch_size``
  identities × ``num_pos`` instances per modality.
* :func:`gen_idx` — label→positions maps.
* :class:`TestData` / :func:`process_sysu` — SYSU test-protocol file lists
  (camera splits per mode, single-shot gallery sampling).

All batches leave as NHWC float32 in ImageNet-normalized space.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize(img: np.ndarray) -> np.ndarray:
    """uint8/float HWC → ImageNet-normalized float32."""
    img = np.asarray(img, np.float32)
    if img.max() > 2.0:
        img = img / 255.0
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def rgb2gray(rgb: np.ndarray) -> np.ndarray:
    """Reference ``rgb2gray`` (data_loader.py:124-126)."""
    return np.dot(rgb[..., :3], np.asarray([0.299, 0.587, 0.114],
                                           rgb.dtype if rgb.dtype.kind == "f"
                                           else np.float32)).astype(rgb.dtype)


def rgb2random_channel(rgb: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random convex channel mix (reference ``rgb2RandomChannel``,
    data_loader.py:128-132) — the 'gray' modality used in the deep trainers."""
    n = rng.random(3)
    n /= n.sum()
    return np.dot(rgb[..., :3], n).astype(rgb.dtype)


# ---------------------------------------------------------------------------
# Synchronized augmentations (part mode, data_loader.py:74-91) — numpy HWC
# ---------------------------------------------------------------------------

def synchronized_augment(img: np.ndarray, part: Optional[np.ndarray],
                         rng: np.random.Generator, crop_margin: int = 12):
    """Random crop (−12px), h/v flips, random erase — applied identically to
    the image and its part map (erase fills parts with 255 = ignore)."""
    h, w = img.shape[:2]
    ch, cw = h - crop_margin, w - crop_margin
    top = int(rng.integers(0, crop_margin + 1))
    left = int(rng.integers(0, crop_margin + 1))
    img = img[top: top + ch, left: left + cw]
    if part is not None:
        part = part[top: top + ch, left: left + cw]

    if rng.random() > 0.5:
        img = img[:, ::-1]
        part = part[:, ::-1] if part is not None else None
    if rng.random() > 0.5:
        img = img[::-1]
        part = part[::-1] if part is not None else None

    if rng.random() > 0.5:  # random erase (scale .02-.33, ratio .3-3.3)
        area = ch * cw
        for _ in range(10):
            target = rng.uniform(0.02, 0.33) * area
            ratio = np.exp(rng.uniform(np.log(0.3), np.log(3.3)))
            eh = int(round(np.sqrt(target * ratio)))
            ew = int(round(np.sqrt(target / ratio)))
            if eh < ch and ew < cw:
                et = int(rng.integers(0, ch - eh))
                el = int(rng.integers(0, cw - ew))
                v = rng.random(3) + 0.01
                v /= v.sum()
                img = img.copy()
                img[et: et + eh, el: el + ew] = (v * 255 if img.dtype.kind != "f"
                                                 else v)
                if part is not None:
                    part = part.copy()
                    part[et: et + eh, el: el + ew] = 255
                break
    return np.ascontiguousarray(img), (
        np.ascontiguousarray(part) if part is not None else None)


# ---------------------------------------------------------------------------
# Identity sampler (data_loader.py:144-178)
# ---------------------------------------------------------------------------

class IdentitySampler:
    """P×K sampler over two modalities: each epoch re-draws ``batch_size``
    identities × ``num_pos`` instances each, materializing paired color/IR
    index arrays consumed positionally."""

    def __init__(self, train_color_label, train_ir_label, color_pos,
                 thermal_pos, num_pos: int, batch_size: int,
                 rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        uni_label = np.unique(train_color_label)
        self.n_classes = len(uni_label)
        n = max(len(train_color_label), len(train_ir_label))

        idx1, idx2 = [], []
        for _ in range(n // (batch_size * num_pos) + 1):
            batch_ids = rng.choice(uni_label, batch_size, replace=False)
            for pid in batch_ids:
                idx1.append(rng.choice(color_pos[pid], num_pos))
                idx2.append(rng.choice(thermal_pos[pid], num_pos))
        self.index1 = np.concatenate(idx1)
        self.index2 = np.concatenate(idx2)
        self.N = n

    def __len__(self) -> int:
        return self.N


def gen_idx(labels: np.ndarray) -> List[np.ndarray]:
    """Label → positions list (reference ``GenIdx``, data_loader.py:181-200)."""
    return [np.nonzero(labels == u)[0] for u in np.unique(labels)]


# ---------------------------------------------------------------------------
# Training dataset (data_loader.py:19-141)
# ---------------------------------------------------------------------------

class SYSUData:
    """Paired (RGB, IR) training data from pre-resized npy blobs.

    ``__getitem__`` → non-part: (rgb, ir, label_rgb, label_ir, cam1, cam2);
    part mode additionally returns part maps and the random-channel gray view
    (reference ``data_loader.py:61-97``).
    """

    def __init__(self, data_dir: str, part: bool = False, seed: int = 0):
        self.part = part
        self.rng = np.random.default_rng(seed)
        ld = lambda name: np.load(os.path.join(data_dir, name))
        self.train_color_image = ld("train+Val_rgb_resized_img.npy")
        self.train_color_label = ld("train+Val_rgb_resized_label.npy")
        self.train_color_cam = ld("train+Val_rgb_resized_camera.npy")
        self.train_ir_image = ld("train+Val_ir_resized_img.npy")
        self.train_ir_label = ld("train+Val_ir_resized_label.npy")
        self.train_ir_cam = ld("train+Val_ir_resized_camera.npy")
        if part:
            self.train_rgb_part = ld("train+Val_rgb_resized_part.npy")
            self.train_ir_part = ld("train+Val_ir_resized_part.npy")

        def load_pos(name):
            p = os.path.join(data_dir, name)
            if os.path.exists(p):
                with open(p, "rb") as f:
                    return list(pickle.load(f).values())
            return None

        self.color_pos = load_pos("color_pos.pkl") or gen_idx(self.train_color_label)
        self.thermal_pos = load_pos("thermal_pos.pkl") or gen_idx(self.train_ir_label)

        self.c_index = np.arange(len(self.train_color_label))
        self.t_index = np.arange(len(self.train_ir_label))
        self.num_class = len(self.color_pos)

    def __len__(self) -> int:
        return len(self.c_index)

    def samplize(self, batch_size: int, num_pos: int) -> IdentitySampler:
        """Re-draw the P×K index arrays for one epoch (data_loader.py:134-141)."""
        s = IdentitySampler(self.train_color_label, self.train_ir_label,
                            self.color_pos, self.thermal_pos, num_pos,
                            batch_size, rng=self.rng)
        self.c_index, self.t_index = s.index1, s.index2
        return s

    def __getitem__(self, index: int):
        ci, ti = self.c_index[index], self.t_index[index]
        img1 = self.train_color_image[ci]
        img2 = self.train_ir_image[ti]
        t1, t2 = self.train_color_label[ci], self.train_ir_label[ti]
        cam1, cam2 = self.train_color_cam[ci], self.train_ir_cam[ti]

        if not self.part:
            return (imagenet_normalize(img1), imagenet_normalize(img2),
                    t1, t2, cam1, cam2)

        gray = np.repeat(rgb2random_channel(img1, self.rng)[..., None], 3, -1)
        p1 = self.train_rgb_part[ci]
        p2 = self.train_ir_part[ti]
        out_imgs, out_parts = [], []
        for img, prt in ((img1, p1), (img2, p2), (gray, p1)):
            a_img, a_prt = synchronized_augment(img, prt, self.rng)
            out_imgs.append(imagenet_normalize(a_img))
            out_parts.append(a_prt)
        return (out_imgs[0], out_imgs[1], t1, t2, cam1, cam2,
                out_parts[0], out_parts[1], out_imgs[2], out_parts[2])


class TestData:
    """Eval-set loader: resize to (w, h)=(144, 288), optional gray conversion
    (reference ``TestData``, data_loader.py:203-233). Cameras re-based to 0."""

    def __init__(self, img_files: Sequence[str], labels, cams,
                 img_size: Tuple[int, int] = (144, 288),
                 color_to_gray: bool = False):
        from PIL import Image

        imgs = []
        for p in img_files:
            img = Image.open(p).convert("RGB").resize(img_size)
            arr = np.asarray(img, np.uint8)
            if color_to_gray:
                arr = np.repeat(rgb2gray(arr)[..., None], 3, -1).astype(np.uint8)
            imgs.append(arr)
        self.test_image = np.stack(imgs)
        self.test_label = np.asarray(labels)
        self.test_cam = np.asarray(cams)

    def __len__(self) -> int:
        return len(self.test_image)

    def __getitem__(self, i: int):
        return (imagenet_normalize(self.test_image[i]), self.test_label[i],
                self.test_cam[i] - 1)

    def batches(self, batch_size: int = 50):
        for s in range(0, len(self), batch_size):
            sl = slice(s, s + batch_size)
            yield (imagenet_normalize(self.test_image[sl]),
                   self.test_label[sl], self.test_cam[sl] - 1)


QUERY_CAMS = {"all": ["cam3", "cam6"], "indoor": ["cam3", "cam6"],
              "Vis": ["cam1", "cam4"], "Gray": ["cam1", "cam4"], "Ir": ["cam3"]}
GALLERY_CAMS = {"all": ["cam1", "cam2", "cam4", "cam5"],
                "indoor": ["cam1", "cam2"],
                "Vis": ["cam2", "cam5"], "Gray": ["cam2", "cam5"],
                "Ir": ["cam6"]}


def process_sysu(data_path: str, data: str = "query", single_shot: bool = True,
                 mode: str = "all", file_path: str = "exp/test_id.txt",
                 rng: Optional[np.random.Generator] = None):
    """Build the SYSU test file list (reference ``process_sysu``,
    data_loader.py:236-284): ids from ``exp/test_id.txt``, camera split by
    mode, single-shot gallery draws one image per (id, cam)."""
    rng = rng or np.random.default_rng()
    cameras = (QUERY_CAMS if data == "query" else GALLERY_CAMS)[mode]

    with open(os.path.join(data_path, file_path)) as f:
        ids = ["%04d" % int(y) for y in f.read().splitlines()[0].split(",")]

    files: List[str] = []
    for pid in sorted(ids):
        for cam in cameras:
            img_dir = os.path.join(data_path, cam, pid)
            if os.path.isdir(img_dir):
                new_files = sorted(os.path.join(img_dir, i)
                                   for i in os.listdir(img_dir))
                if data == "gallery" and single_shot:
                    files.append(str(rng.choice(new_files)))
                else:
                    files.extend(new_files)

    pids = np.asarray([int(p[-13:-9]) for p in files])
    cams = np.asarray([int(p[-15]) for p in files])
    return files, pids, cams
