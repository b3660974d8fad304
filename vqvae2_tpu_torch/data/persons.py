"""Procedural cross-modal person corpus (port of
``vqvae2_tpu/data/persons.py``), numpy and PIL only: every array and blob file
is bit-equal to the JAX package's for the same seed.

Identities are persistent geometry + appearance (build, head size, leg length,
clothing colours); instances vary by pose jitter, lighting, background and
sensor noise; the IR modality keeps the identity's geometry and replaces colour
with a thermal signature (per-material emissivity x body-part temperature).
Cross-modal retrieval on it therefore needs a modality-invariant embedding.

Writes both ``SYSUData`` npy-blob layouts (``train+Val_{rgb,ir}_resized_*``,
with exact part maps) and the raw ``cam1..cam6 + exp/test_id.txt`` tree that
:func:`vqvae2_tpu_torch.eval.reid.validate` reads (RGB cameras 1/2/4/5, IR
cameras 3/6, the SYSU convention).  Each (pid, instance) renders from its own
seed.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

# part-map classes (the trainer's part head has 7 classes; 5 are used here,
# the remainder stay legitimate-but-empty like rare classes in real parsing)
BG, HEAD, TORSO, LEGS, ARMS = 0, 1, 2, 3, 4


def identity_attrs(pid: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Persistent per-identity attributes, deterministic in (seed, pid)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7919, pid]))
    return {
        # geometry (fractions of frame height/width)
        "head_r": rng.uniform(0.050, 0.085),
        "torso_w": rng.uniform(0.16, 0.26),
        "torso_h": rng.uniform(0.16, 0.24),
        "leg_len": rng.uniform(0.22, 0.34),
        "leg_gap": rng.uniform(0.02, 0.07),
        "arm_len": rng.uniform(0.12, 0.20),
        # appearance
        "skin": rng.uniform(0.45, 0.95, size=3),
        "shirt": rng.uniform(0.05, 0.95, size=3),
        "pants": rng.uniform(0.05, 0.95, size=3),
        # thermal signature: per-material emissivity scaling the body-part
        # temperature (skin hottest; clothing attenuates by material)
        "emis_shirt": rng.uniform(0.25, 0.75),
        "emis_pants": rng.uniform(0.25, 0.75),
    }


def render_person(pid: int, instance: int, hw: Tuple[int, int] = (288, 144),
                  seed: int = 0, modal: str = "rgb"):
    """Render one instance → (uint8 HWC image, uint8 HW part map).

    ``instance`` seeds the nuisance factors only (pose jitter, lighting,
    background, sensor noise); identity factors come from ``pid``.
    """
    a = identity_attrs(pid, seed)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, pid, instance, 1 if modal == "ir" else 0]))
    h, w = hw
    yy, xx = np.meshgrid(np.linspace(0.0, 1.0, h), np.linspace(0.0, 1.0, w),
                         indexing="ij")
    # frames are tall (288x144): x spans half the units of y
    ar = w / h

    dx = rng.uniform(-0.04, 0.04)
    dy = rng.uniform(-0.03, 0.03)
    s = rng.uniform(0.92, 1.08)

    cx = 0.5 + dx
    head_cy = 0.16 + dy
    head_r = a["head_r"] * s
    torso_top = head_cy + head_r * 1.15
    torso_h = a["torso_h"] * s
    torso_w = a["torso_w"] * s
    leg_top = torso_top + torso_h
    leg_len = a["leg_len"] * s
    leg_gap = a["leg_gap"]
    leg_w = (torso_w - leg_gap) / 2
    arm_len = a["arm_len"] * s
    arm_w = 0.045 * s

    # x distances in y-units so circles stay circles on the tall frame
    # (xx spans w pixels = ar*h pixels, so one xx unit = ar y-units)
    xu = (xx - cx) * ar

    head = (np.hypot(xu, yy - head_cy) < head_r)
    torso = ((np.abs(xu) < torso_w / 2)
             & (yy > torso_top) & (yy < torso_top + torso_h))
    leg_l = ((xu > -leg_gap / 2 - leg_w) & (xu < -leg_gap / 2)
             & (yy > leg_top) & (yy < leg_top + leg_len))
    leg_r = ((xu > leg_gap / 2) & (xu < leg_gap / 2 + leg_w)
             & (yy > leg_top) & (yy < leg_top + leg_len))
    arm_y = (yy > torso_top + 0.02) & (yy < torso_top + 0.02 + arm_len)
    arm_l = (np.abs(xu + torso_w / 2 + arm_w / 2) < arm_w / 2) & arm_y
    arm_r = (np.abs(xu - torso_w / 2 - arm_w / 2) < arm_w / 2) & arm_y

    part = np.zeros((h, w), np.uint8)
    part[arm_l | arm_r] = ARMS
    part[leg_l | leg_r] = LEGS
    part[torso] = TORSO
    part[head] = HEAD

    if modal == "ir":
        # thermal: background cold gradient, body parts at emissivity-scaled
        # temperatures; identity geometry + materials survive, colors do not
        bg0, bg1 = rng.uniform(0.02, 0.18, size=2)
        img1 = bg0 + (bg1 - bg0) * yy
        gain = rng.uniform(0.85, 1.15)
        img1 = np.where(head | arm_l | arm_r, 0.95 * gain, img1)
        img1 = np.where(torso, a["emis_shirt"] * gain, img1)
        img1 = np.where(leg_l | leg_r, a["emis_pants"] * gain, img1)
        img1 = img1 + rng.normal(0.0, 0.02, size=img1.shape)
        img = np.repeat(img1[..., None], 3, axis=-1)
    else:
        c0, c1 = rng.uniform(0.2, 1.0, size=(2, 3))
        ang = rng.uniform(0.0, 2 * np.pi)
        t = xx * np.cos(ang) + yy * np.sin(ang)
        t = (t - t.min()) / (t.max() - t.min() + 1e-9)
        img = c0 * (1 - t[..., None]) + c1 * t[..., None]
        light = rng.uniform(0.8, 1.2)
        for mask, color in ((head, a["skin"]), (torso, a["shirt"]),
                            (leg_l | leg_r, a["pants"]),
                            (arm_l | arm_r, a["skin"])):
            img = np.where(mask[..., None], color * light, img)
        img = img + rng.normal(0.0, 0.015, size=img.shape)

    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8), part


def save_person_sysu(root: str, n_ids: int = 16, per_id: int = 24,
                     hw: Tuple[int, int] = (288, 144), seed: int = 0) -> str:
    """Write the SYSUData training-blob layout (images, labels, cameras and
    exact part maps for both modalities)."""
    os.makedirs(root, exist_ok=True)
    h, w = hw
    labels = np.repeat(np.arange(n_ids), per_id)
    for modal, cams in (("rgb", (1, 2, 4, 5)), ("ir", (3, 6))):
        imgs = np.empty((n_ids * per_id, h, w, 3), np.uint8)
        parts = np.empty((n_ids * per_id, h, w), np.uint8)
        cam = np.empty((n_ids * per_id,), np.int64)
        i = 0
        for pid in range(n_ids):
            for k in range(per_id):
                imgs[i], parts[i] = render_person(pid, k, hw, seed, modal)
                cam[i] = cams[k % len(cams)]
                i += 1
        np.save(f"{root}/train+Val_{modal}_resized_img.npy", imgs)
        np.save(f"{root}/train+Val_{modal}_resized_label.npy", labels)
        np.save(f"{root}/train+Val_{modal}_resized_camera.npy", cam)
        np.save(f"{root}/train+Val_{modal}_resized_part.npy", parts)
    return root


def save_person_sysu_eval(root: str, n_ids: int = 16, per_id: int = 4,
                          hw: Tuple[int, int] = (288, 144),
                          seed: int = 0, instance_base: int = 100000) -> str:
    """Write the raw SYSU tree (cam1..cam6 + exp/test_id.txt) with HELD-OUT
    instances (``instance_base`` offsets the nuisance seed) of the same
    identities, for :func:`vqvae2_tpu_torch.eval.reid.validate`."""
    from PIL import Image

    os.makedirs(os.path.join(root, "exp"), exist_ok=True)
    with open(os.path.join(root, "exp", "test_id.txt"), "w") as f:
        f.write(",".join(str(pid + 1) for pid in range(n_ids)) + "\n")
    for cam_id in range(1, 7):
        modal = "ir" if cam_id in (3, 6) else "rgb"
        for pid in range(n_ids):
            d = os.path.join(root, f"cam{cam_id}", "%04d" % (pid + 1))
            os.makedirs(d, exist_ok=True)
            for k in range(per_id):
                inst = instance_base + cam_id * 1000 + k
                img, _ = render_person(pid, inst, hw, seed, modal)
                Image.fromarray(img).save(os.path.join(d, f"{k:04d}.jpg"))
    return root
