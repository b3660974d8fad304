#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vqvae2_tpu_torch``) on one NVIDIA
Hopper card: the quickest proof that the port still builds, starts and is right
on the GPU.

    python3 chip_smoke.py               # needs one card; exits non-zero without
    python3 chip_smoke.py --breakdown   # also times the stages of encode_ids, of the
                                        # top prior's forward and of one train step of
                                        # stage 1, of the top prior and of the ReID
                                        # trainer (fp32 and bf16); profiles the sampler
    python3 chip_smoke.py --repeatability   # also counts ids that flip between calls

Phases, each printing one JSON line; the first failure ends the run non-zero:

1. device   — the card, its power limit, the installation, the TF32 flags
2. build    — compiles ``ops/csrc/*.cu`` with nvcc, one compiler a source, all
              started together
3. kernels  — each kernel against its plain PyTorch version on the card, at the
              main path's shapes (on the models' own activations) and at
              awkward ones: the three nearest-code kernels (the statistics
              flavour also with every row on one code, and run twice to show
              that its sums repeat bit for bit), then the causal
              flash-attention forward and its two backward kernels (also with
              dropout on); and at shapes the JAX package
              runs that the kernels once refused (embed_dim 30, 1 and 66; head
              widths 6, 68, 72, 128 and 136 in fp32 and bf16, with and without dropout,
              at N = 1024 and 777; ABN channels 2049 and 4096), each shown by
              the launch counters to have gone through its kernel
4. main     — stage 1: ``VQVAE()`` at full width, 256 px: ``forward`` and
              ``encode_ids`` at batch 128, then ``extract_codes.main`` into a
              temporary directory, read back through the code store's native
              library and compared with a direct ``encode_ids``.  Stage 2: the two PixelSNAIL priors at full width
              from checkpoints the run writes: the top prior's forward on a
              32x32 grid at batch 32, the incremental decoder against the full
              forward for both priors, and ``train/sample.py main`` by the
              incremental sampler (256 px, batch 8) and by both samplers at a
              smaller size, whose top codes must agree.  Each path runs with
              the launch counters at zero before and read after: the kernels
              ran, the plain versions did not.  Small inputs are held against
              the CPU.  Training: ``train.vqvae.main`` at the command line's
              width and batch for a few steps and one step of two
              microbatches, ``extract_codes.main`` on what it wrote, both
              priors' ``train.pixelsnail.main`` at full width on those codes,
              and ``sample.main`` from the three checkpoints; the losses fall;
              one step of each trainer is held against the CPU
5. times    — CUDA-event times of each kernel, its plain version and the
              nearest library route; the kernels at the shapes they once
              refused, with plain and library times; ``encode_ids`` in
              img/s, the top prior's forward in ms, a train step of stage 1
              and of both priors, each in fp32 and in bf16 from the same
              weights; then (``wide_prior_step``) one fp32 step of the top
              prior at ``--channel 2048`` (D = 128) at the largest batch of
              32, 16, 8 that fits, with the device ms of K4, K5 and K6 and
              their share of it by the profiler
6. abn_kernels — the in-place ABN forward (K7) and backward (K8) against their
              plain versions at the inputs of the 13 ABNs of
              ``EmbedNet2(resnet50)`` on a train batch of 72 images at 288x144,
              and at awkward shapes (one row, three channels, bf16, eval mode,
              the elu asymptote, z and dz off a 16-byte boundary); the
              backward twice, its sums bit for bit; then K8's time over those
              13 inputs (the fp32 half of the ``k8_step`` line)
7. main_reid — the ReID path with the counters at zero before and read after:
              the eval forward at batch 50, ``train.reid.main --synthetic`` at
              its defaults for a few steps validating every epoch on a raw SYSU
              tree, the losses falling; one step held against the CPU
8. times_reid — K7/K8 times against bound, plain and library (K8 also with
              its two entries timed apart beside their byte floors); a ReID
              train step and the eval forward, in fp32 and in bf16
9. main_train_bf16 — the three pipeline trainers with ``--bf16`` (stage 1 at
              batch 128 and 256 px, both priors at batch 32), the bf16 stage-1
              model's eval forward and ``encode_ids``, with the counters at
              zero before and read after: the losses fall, the quantizer
              kernels received bf16 rows and the attention kernels fp32 (the
              JAX package's promotion); one bf16 step of stage 1 and of the
              top prior against the CPU
10. main_reid_bf16 — the ReID trainer with ``--bf16`` at 288x144, P = 6, K = 4,
              and a bf16 eval forward at batch 50: K7 and K8 received bf16 rows
11. remat   — a stage-1 step at batch 128 with and without ``remat`` from the
              same state: gradients and the state after it bit-equal; ms and
              peak memory of both
12. main_mnist — ``train/pixelsnail_mnist.py main`` on its synthetic digits at
              batch 32: the loss falls, K4-K6 ran at (256, 784, 8)
13. bf16_vs_fp32 — reported, not checked: the share of stage-1 ids that differ
              between fp32 and bf16 on the same weights and batch, ``diff`` of
              both, and the top prior's logit distance
14. times_bf16 — K1-K3 on the bf16 stage-1 model's rows and K7/K8 on the bf16
              ReID model's, each first held against its plain version at the
              standing tolerances, and K4-K6 at the MNIST prior's shape: times
              beside bound, plain and library; the ``k8_step`` line: K8 over
              the 13 ABN inputs of one ReID step in fp32 and bf16, beside the
              sums of their bounds
15. main_deep — ``train/vqvae_deep.py main`` at its defaults (resnet18, P = K =
              4) on a 288x144 synthetic SYSU tree: ``ModelAdaptive_Deep`` at its
              fixed widths, K3 eight times a step and K2 eight times a sample
              grid at D = 256 (N = 10,368 and 2,592), a validation every
              epoch; recon falls; one step (batch 2 x 2) on the card against
              the CPU: the quantizer ids, the losses, each module group's
              gradient by its norm
16. main_adaptive, main_gray2color — ``train/adaptive.py`` and
              ``train/gray2color.py main`` at their defaults on a 288x144 tree:
              the loss falls (adaptive: mse; its loss_gen is the sum of its
              terms and its KL term carries the rise), K3 ran at D = 64
              (N = 41,472 and 10,368)
17. main_deep_bi, main_deep_ir, main_stargan — the cross-modal trainers at
              their defaults (resnet18, P = K = 4) at 288x144, each with the
              counters at zero before and read after: ``train/vqvae_deep_bi.py``
              (K3 eight times a step: the four ``VQVAE_Deep`` passes of the
              cycle; the latent loss falls, the generator's loss is the sum
              of its terms), ``train/vqvae_deep_ir.py`` on a
              corpus that ``data/persons.py`` writes, three reconstruction
              steps and three full ones (K3 twice and four times a step, K2
              four times a sample grid), each with one step (batch 2 x 2) on
              the card against the CPU and a float64 backward;
              ``train/stargan_bi.py`` with the discriminator every other step
              (its parameters still over each masked step), a sample grid and
              an identity-preservation eval (no quantizer kernel runs), R1's
              gradient against a float64 backward, and one step with and
              without ``remat`` bit for bit; each phase's step time by CUDA
              events and its peak memory
18. main_ssd, main_maskrcnn — the detection trainers at their command
              lines' defaults with ``--synthetic --eval``: ``train/detection.py``
              (SSD300 at 300 px, batch 8, resnet18, 14 classes) and
              ``train/maskrcnn.py`` (256 px, batch 4, 64 proposals and 64
              ground-truth slots), each with the counters at zero before and
              read after (no kernel of the port runs on these paths, and no
              plain version): the losses finite and falling, the Mask R-CNN
              loss the sum of its five terms, the AP numbers in [0, 1]; one
              step (batch 2 and 1) on the card against the CPU and a float64
              backward; ``encode_targets`` with two ground truths on one best
              box against the CPU (classes bit for bit); ``roi_align`` on the card
              against the CPU on a step's own p2 and RoIs; whether two Mask
              R-CNN gradients from one state repeat bit for bit (reported);
              each phase's step time by CUDA events, its peak memory, the
              command line's img/s and the evaluation's host seconds
19. kernels_deep, times_deep — K2 and K3 at D = 256 on the deep step's own
              rows, with codebooks drawn among those rows (many codes in use),
              against their plain versions, then timed beside bound, plain and
              library, with the grid's blocks and the codes in use; the kernels
              timed again on the untrained codebooks (one code in use, as the
              main path's first steps run); one deep step's time, peak memory
              and split by CUDA events
20. cudnn_grads — each convolution's weight gradient of one ReID step with
              cuDNN as the port sets it and with cuDNN disabled, against a
              float64 backward on the CPU, at the toy size of the card-vs-CPU
              step and at 288x144 (resnet50; 12 images for the float64
              backward); the kernels of each layer by profiler ranges (which
              run cuDNN's FFT or Winograd algorithms); the ReID step at its
              command line's batch with cuDNN disabled for the layers found
21. probe   — what the tensor cores offer the attention kernels: mma.sync TF32
              throughput, the TF32 split's rounding by cvt against integer
              operations, and the rounding of the tensor cores' fp32 sums
22. parallel — (run after main_maskrcnn) the data-parallel layer: ``train.vqvae``,
              ``extract_codes`` and the top prior through their command lines
              under a ``torchrun`` environment of one rank (``launch`` forms an
              NCCL group of one) and without one, checkpoints and code stores
              bit for bit; then two ``gloo`` ranks spawned on the one card
              (both on cuda:0): a stage-1 step, a top-prior step at dropout 0,
              the 13 ABNs of EmbedNet2 at 288x144 forward and backward
              (``InPlaceABNSync``), and extraction with a last batch of one
              image, each against the world-1 run on the global batch; every
              rank's counters show K3, K4-K6 and K7/K8 launched and no plain
              version, every rank's state is rank 0's bit for bit; the step
              times and the all-reduce time a step in both worlds
23. parallel_trainers — (after parallel) the nine other trainers at world
              size N: each command line (``train.reid``, ``vqvae_deep``,
              ``adaptive``, ``gray2color``, ``vqvae_deep_bi``,
              ``vqvae_deep_ir``, ``stargan_bi``, ``detection``,
              ``maskrcnn``) for two steps under a ``torchrun`` environment
              of one rank (an NCCL group of one) and without one, the
              checkpoint (the detection trainers' returned losses) bit for
              bit; then two ``gloo`` ranks spawned once on the one card take
              each trainer's two steps at its command line's widths, image
              sizes and global batch, against the world-1 step rank 0 took
              first (losses, batch-norm statistics, gradient norms); each
              rank's step time, gradient all-reduce and in-step collectives
              (the synced batch norms, the gathers), host time a step, peak
              memory and K3/K7/K8 launches, no plain version, the ranks'
              parameters bit-equal after each step

The last lines are the ``{"kernels": [...]}`` record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from PIL import Image

import vqvae2_tpu_torch as port
from vqvae2_tpu_torch import parallel as par
from vqvae2_tpu_torch.data.codestore import CodeStore
from vqvae2_tpu_torch.data.datasets import SyntheticImages
from vqvae2_tpu_torch.models import build_vqvae
from vqvae2_tpu_torch.models.incremental import teacher_forced_logits
from vqvae2_tpu_torch.ops import _build
from vqvae2_tpu_torch.ops import flash_attention as fa
from vqvae2_tpu_torch.ops import inplace_abn as ia
from vqvae2_tpu_torch.ops import quantize as qz
from vqvae2_tpu_torch.train import extract_codes, sample
from vqvae2_tpu_torch.train import pixelsnail as tp
from vqvae2_tpu_torch.train import vqvae as tv
from vqvae2_tpu_torch.train.pixelsnail import build_model
from vqvae2_tpu_torch.utils import schedules
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager

SIZE = 256
BATCH = 128            # forward / encode_ids
EXTRACT_BATCH = 64     # extract_codes.main
D, K = 64, 512

# stage 2: the two priors of train/pixelsnail.py at full width
PRIOR_CONFIG = dict(n_class=512, channel=256, n_res_block=4, n_res_channel=256,
                    n_out_res_block=0, n_cond_res_block=3, dropout=0.1)
TOP_HW, BOTTOM_HW = SIZE // 8, SIZE // 4      # 32x32 and 64x64 code grids
PRIOR_BATCH = 32       # the top prior's forward (scoring a batch of code grids)
SAMPLE_BATCH = 8       # train/sample.py's default
DECODER_BATCH = 2      # incremental decoder against the full forward
# image size at which the two samplers are held against each other: the
# full-forward one takes (128/8)^2 + (128/4)^2 = 1,280 full-width forwards
COMPARE_SIZE = 128
N_HEAD, HEAD_DIM = 8, 16

# Tolerances of the attention kernel against its plain version: fp32 as the JAX
# package holds its own kernel (sums in another order, exp by the fast unit);
# bf16 outputs may round to the neighbouring bf16 value (2^-8 relative).
FA_TOL = dict(atol=2e-5, rtol=2e-5)
FA_TOL_BF16 = dict(atol=1e-2, rtol=1e-2)
# Full-width logits by two schedules, and card against CPU: what the JAX package
# holds its incremental decoder to at toy size (fp32 sums in another order).
LOGITS_TOL = dict(atol=2e-5, rtol=2e-4)

# Published peaks of one H100 SXM at its full 700 W: fp32 outside the tensor
# cores, and device memory.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# dense TF32 on the tensor cores (the yardstick of the attention kernels'
# bound_tc_ms)
PEAK_TF32_FLOPS = 494.7e12

# Kernel and plain version sum the same terms in different orders, so an id may
# differ where the best two codes of a row are equidistant to rounding: a
# mismatch is a near-tie when the plain scores of the two ids differ by at most
# this fraction of the summands' magnitude (|x|^2 + |E|^2).
TIE_RTOL = 1e-5

# training: steps of each command-line run (kept small: the run is a smoke run)
TRAIN_STEPS = {"vqvae": 12, "top": 10, "bottom": 5}
TRAIN_BATCH = {"vqvae": 128, "top": 32, "bottom": 32}    # the command lines' defaults
# The statistics kernel's sums against a float64 sum of the same rows: each
# element within this fraction of the sum of its terms' magnitudes (fp32 sums
# in another, fixed order).
ESUM_RTOL = 1e-5
# A step on the card against the same step on the CPU: the loss as LOGITS_TOL;
# each gradient tensor within this fraction of its largest element (fp32
# convolutions summed in another order, through a whole network), or of a
# thousandth of the model's largest gradient where that is larger: a gradient
# that is zero in exact arithmetic (a key's bias cannot move a softmax) is
# rounding noise on both sides.
GRAD_RTOL = 1e-3

KERNELS = {
    "nearest_code_ids": {
        "route": "cuda",
        "source": "vqvae2_tpu_torch/ops/csrc/quantize.cu",
        "replaces": "vqvae2_tpu/ops/quantize.py:155",
    },
    "nearest_code_lookup": {
        "route": "cuda",
        "source": "vqvae2_tpu_torch/ops/csrc/quantize.cu",
        "replaces": "vqvae2_tpu/ops/quantize.py:134",
    },
    "nearest_code_stats": {
        "route": "cuda",
        "source": "vqvae2_tpu_torch/ops/csrc/quantize.cu",
        "replaces": "vqvae2_tpu/ops/quantize.py:172",
    },
    "causal_flash_attention": {
        "route": "cuda",
        "source": "vqvae2_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "vqvae2_tpu/ops/flash_attention.py:81",
    },
    "causal_flash_attention_dq": {
        "route": "cuda",
        "source": "vqvae2_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "vqvae2_tpu/ops/flash_attention.py:136",
    },
    "causal_flash_attention_dkv": {
        "route": "cuda",
        "source": "vqvae2_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "vqvae2_tpu/ops/flash_attention.py:176",
    },
    "abn_forward": {
        "route": "cuda",
        "source": "vqvae2_tpu_torch/ops/csrc/inplace_abn.cu",
        "replaces": "vqvae2_tpu/ops/inplace_abn.py:80",
    },
    "abn_backward": {
        "route": "cuda",
        "source": "vqvae2_tpu_torch/ops/csrc/inplace_abn.cu",
        "replaces": "vqvae2_tpu/ops/inplace_abn.py:89",
    },
}
SOURCES = ("quantize", "flash_attention", "inplace_abn", "tc_probe")
# Kernels of which no variant may spill registers (ptxas -v): the wide forward,
# the designs of the dq kernel, the dk/dv kernel (narrow and wide), the
# nearest-code search and K8's kernels.
NO_SPILL_KERNELS = ("flash_fwd_wide_kernel",
                    "flash_bwd_dq_kernel", "flash_bwd_dq_fma_kernel", "flash_bwd_dq_wide_kernel",
                    "flash_bwd_dkv_kernel", "flash_bwd_dkv_wide_kernel", "nearest_code_kernel", "abn_sums_ring_kernel", "abn_sums_generic_kernel",
                    "abn_sums_final_kernel", "abn_dx_ring_kernel", "abn_backward_dx_kernel")
# Shapes the JAX package runs that the kernels once refused: head widths that
# are no multiple of 4 (D = 6 is --channel 96) or above 64 (68 is --channel
# 1088, the narrowest wide head; 128 one wide tile of the attention kernels,
# 136 two), embed_dim that is no multiple of 4 (and 1, and 66), and ABN
# channels above 2048.
ODD_HEAD_DIMS = (6, 68, 72, 128, 136)
ODD_SEQ_LENS = (1024, 777)
ODD_EMBED_DIMS = (30, 1, 66)
WIDE_ABN_CHANNELS = (2049, 4096)


def through_kernels(names, fn):
    """``fn()`` with the launch counters read around it: each kernel in
    ``names`` must have launched and no wrapper may have used its plain
    version.  Returns ``fn``'s result (a dict) with the launches added."""
    before = all_counts()
    out = fn()
    after = all_counts()
    launched = {k: after["launches"][k] - before["launches"][k] for k in names}
    plain = {k: v - before["plain_calls"][k] for k, v in after["plain_calls"].items()
             if v != before["plain_calls"][k]}
    check(all(launched.values()) and not plain,
          f"{out.get('case')}: kernels launched {launched}, plain versions used {plain}")
    return {**out, "kernel_launches": launched}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke failed: {message}")


def run_text(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def host_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` by the host's clock over ``reps`` calls that end in
    a synchronise, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The parts of a nearest-code call, by substrings of its kernels' names.
SEARCH_PARTS = (("codebook_prep", "prologue"), ("nearest_code_kernel", "search"),
                ("merge_kernel", "merge"), ("hist_kernel", "stats_tail"),
                ("column_scan_kernel", "stats_tail"), ("code_scan_kernel", "stats_tail"),
                ("scatter_kernel", "stats_tail"), ("piece_sum_kernel", "stats_tail"),
                ("code_sum_kernel", "stats_tail"))


def search_parts(fn, reps: int = 20) -> dict:
    """A nearest-code call ``fn`` taken apart: the device µs a call of each
    part (prologue, search, merge, the statistics tail, and PyTorch's own
    kernels such as the zero statistics of the lookup flavour as ``other``)
    by ``torch.profiler``'s kernel records, and the host µs a call takes to
    enqueue it: the median of five runs of 20 calls by the host's clock, no
    synchronise between the calls of a run."""
    runs = []
    for _ in range(5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        runs.append((time.perf_counter() - t0) / 20 * 1e6)
    host_us = float(np.median(runs))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        part = next((p for key, p in SEARCH_PARTS if key in e.name), "other")
        parts[part] = parts.get(part, 0.0) + e.device_time_total / reps
    if not parts:
        return {"host_us": host_us, "device_us": "not measured: the profiler recorded no "
                                                   "device time"}
    return {"host_us": host_us, "device_us": parts, "device_us_sum": sum(parts.values())}


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def compare_with_plain(flat: torch.Tensor, embed: torch.Tensor, label: str,
                       exact_ids: bool = False) -> dict:
    """Both kernels on ``flat``/``embed`` against the plain version.  ``q`` must
    be bit-equal to ``embed[idx]``; ids may differ only at near-ties (and not
    at all with ``exact_ids``)."""
    ids = qz.nearest_code_ids(flat, embed)
    idx, q, csum, esum = qz.nearest_code(flat, embed, with_stats=False)
    torch.cuda.synchronize()
    n, d = flat.shape
    check(ids.shape == (n,) and ids.dtype == torch.int32, f"{label}: ids shape/dtype")
    check(q.shape == (n, d) and q.dtype == flat.dtype, f"{label}: q shape/dtype")
    check(int(ids.min()) >= 0 and int(ids.max()) < embed.shape[0], f"{label}: id out of range")
    check(bool(torch.equal(ids, idx)), f"{label}: the two kernels disagree on ids")
    want_q = embed.index_select(0, idx.long()).to(flat.dtype)
    q_err = float((q.float() - want_q.float()).abs().max())
    check(bool(torch.equal(q, want_q)), f"{label}: q is not bit-equal to embed[idx] ({q_err})")
    check(float(csum.abs().sum()) == 0.0 and float(esum.abs().sum()) == 0.0,
          f"{label}: with_stats=False must return zero statistics")

    scores = qz.nearest_code_scores(flat, embed)
    ref = scores.argmax(1)
    wrong = (ids.long() != ref).nonzero().flatten()
    gap = rel_gap = 0.0
    if wrong.numel():
        rows = scores[wrong]
        s_ref = rows.gather(1, ref[wrong][:, None])[:, 0]
        s_got = rows.gather(1, ids[wrong].long()[:, None])[:, 0]
        f32 = flat[wrong].float()
        scale = (f32 * f32).sum(1) + (embed[ref[wrong]] ** 2).sum(1)
        gap = float((s_ref - s_got).abs().max())
        rel_gap = float(((s_ref - s_got).abs() / scale.clamp_min(1e-30)).max())
    check(rel_gap <= TIE_RTOL,
          f"{label}: {wrong.numel()} id mismatches, largest relative gap {rel_gap} > {TIE_RTOL}")
    if exact_ids:
        check(wrong.numel() == 0, f"{label}: ids must be equal, {wrong.numel()} differ")
    return {"case": label, "n": n, "d": d, "k": embed.shape[0], "dtype": str(flat.dtype),
            "id_mismatches": int(wrong.numel()), "largest_gap": gap,
            "largest_rel_gap": rel_gap, "q_max_abs_err": q_err}


def awkward_cases(gen: torch.Generator):
    def normal(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    yield "ragged N=37", normal(37, D), normal(K, D), False
    yield "N=1", normal(1, D), normal(K, D), False
    yield "N=7 D=8 K=16", normal(7, 8), normal(16, 8), False
    yield "deep D=256 K=512", normal(4099, 256), normal(K, 256), False
    yield "ragged K=130 D=12", normal(777, 12), normal(130, 12), False
    yield "bf16 x", normal(5000, D).to(torch.bfloat16), normal(K, D), False
    dup = normal(K, D)
    dup[K // 2:] = dup[: K // 2]       # every code twice: exact ties
    yield "duplicated codebook rows", normal(4096, D), dup, True


def compare_stats_with_plain(flat: torch.Tensor, embed: torch.Tensor, label: str) -> dict:
    """The statistics kernel on ``flat``/``embed``: ids and ``q`` bit-equal to
    the lookup kernel's (it is the same search), ids off the plain version at
    near-ties only, ``csum`` bit-equal to the plain bincount of its own ids,
    ``esum`` within ``ESUM_RTOL`` of a float64 sum of its own rows, and a
    second launch bit-equal to the first."""
    first = qz.nearest_code(flat, embed, with_stats=True)
    again = qz.nearest_code(flat, embed, with_stats=True)
    idx_l, q_l, _, _ = qz.nearest_code(flat, embed, with_stats=False)
    torch.cuda.synchronize()
    idx, q, csum, esum = first
    n, d = flat.shape
    k = embed.shape[0]
    check(csum.shape == (k,) and esum.shape == (k, d) and csum.dtype == esum.dtype == torch.float32,
          f"{label}: statistics shapes")
    check(bool(torch.equal(idx, idx_l) and torch.equal(q, q_l)),
          f"{label}: ids or q differ from the lookup kernel's")
    ids = idx.long()
    check(bool(torch.equal(csum, torch.bincount(ids, minlength=k).to(torch.float32))),
          f"{label}: csum is not the bincount of the kernel's ids")
    f64 = torch.zeros(k, d, dtype=torch.float64, device="cuda").index_add_(0, ids, flat.double())
    mag = torch.zeros(k, d, dtype=torch.float64, device="cuda").index_add_(0, ids, flat.double().abs())
    err = (esum.double() - f64).abs()
    rel = float((err / mag.clamp_min(1e-30)).max())
    check(bool((err <= ESUM_RTOL * mag + 1e-30).all()),
          f"{label}: esum off a float64 sum by {rel} of its terms' magnitude (> {ESUM_RTOL})")
    plain = torch.zeros(k, d, dtype=torch.float32, device="cuda").index_add_(0, ids, flat.float())
    repeat = bool(all(torch.equal(a, b) for a, b in zip(first, again)))
    check(repeat, f"{label}: a second launch gave other statistics")
    ties = compare_with_plain(flat, embed, f"{label} (ids)")
    return {"case": label, "n": n, "d": d, "k": k, "dtype": str(flat.dtype),
            "id_mismatches_vs_plain": ties["id_mismatches"], "largest_rel_gap": ties["largest_rel_gap"],
            "csum_bit_equal_to_bincount": True, "codes_used": int((csum > 0).sum()),
            "esum_max_abs_err_vs_float64": float(err.max()), "esum_max_rel_err_vs_float64": rel,
            "esum_max_abs_err_vs_plain_sum": float((esum - plain).abs().max()),
            "esum_bit_repeatable": repeat}


def stats_awkward_cases(gen: torch.Generator):
    def normal(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    yield "N=1", normal(1, D), normal(K, D)
    yield "N=7", normal(7, D), normal(K, D)
    yield "N=1000", normal(1000, D), normal(K, D)
    yield "K=1", normal(5000, D), normal(1, D)
    yield "deep D=256 K=512", normal(4099, 256), normal(K, 256)
    yield "bf16 x", normal(5000, D).to(torch.bfloat16), normal(K, D)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this run needs one card")
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0]
    print(smi, flush=True)
    nvcc = run_text([_build.find_nvcc(), "--version"]).splitlines()[-2:]
    emit("device", card=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=" ".join(nvcc),
         **port.set_reference_precision())
    return smi


def phase_build() -> None:
    """Every source with its own nvcc, all started together."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = list(pool.map(_build.build, SOURCES))
    qz._library()
    fa._library()
    ia._library()
    built = {}
    for name, path in zip(SOURCES, paths):
        info = _build.build_info[name]
        built[name] = {"library": os.path.relpath(path), "nvcc_seconds": info["seconds"],
                       "ptxas": ptxas_summary(info["log"])}
    emit("build", seconds=time.perf_counter() - t0, sources=built)
    spills = {k: v for src in ("flash_attention", "quantize", "inplace_abn")
              for k, v in built[src]["ptxas"].items()
              if k.startswith(NO_SPILL_KERNELS) and v.get("spill_store_bytes", 0)}
    check(not spills, f"a kernel that must not spill registers does: {spills}")


def ptxas_summary(log: str) -> dict:
    """Registers and spilled bytes of each compiled kernel variant, from
    ``-Xptxas -v``, by a short name (``flash_bwd_dkv_kernel<float,16,2,1>``)."""
    def short(mangled: str) -> str:
        m = re.search(r"\d+([A-Za-z_]*kernel)(?:I(.*?)EEv|E)", mangled)
        if not m:
            return mangled
        if m.group(2) is None:
            return m.group(1)
        args = re.findall(r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16)|(?<![A-Za-z_])f", m.group(2))
        shown = [a or b or ("bf16" if c else "float") for a, b, c in args]
        return f"{m.group(1)}<{','.join(shown)}>"

    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = short(line.split("'")[1])
        elif name and "bytes spill stores" in line:
            out.setdefault(name, {})["spill_store_bytes"] = int(
                line.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used " in line and "registers" in line:
            out.setdefault(name, {})["registers"] = int(line.split("Used ")[1].split()[0])
    return out


def capture_quantizer_inputs(model, x: torch.Tensor):
    """The rows the main path hands the two quantizers: ``(top, bottom)``."""
    seen = {}
    hooks = [
        q.register_forward_pre_hook(
            lambda mod, args, name=name: seen.__setitem__(name, args[0].detach()))
        for name, q in (("top", model.quantize_t), ("bottom", model.quantize_b))
    ]
    model.encode(x)
    for h in hooks:
        h.remove()
    return tuple(seen[name].reshape(-1, seen[name].shape[-1]).contiguous()
                 for name in ("top", "bottom"))


def seed_codebooks_from_data(model, x: torch.Tensor) -> None:
    """Random weights leave the encoder's outputs far smaller than a unit-normal
    codebook, and every row then takes the one code of least norm.  Draw each
    codebook (from a seed) among the rows its quantizer sees, top first since
    the bottom rows depend on it, so that the run spreads over the codes as a
    trained model's does."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for which, quantizer in ((0, model.quantize_t), (1, model.quantize_b)):
        rows = capture_quantizer_inputs(model, x)[which]
        pick = torch.randperm(rows.shape[0], generator=gen, device="cuda")[:quantizer.n_embed]
        quantizer.embed.copy_(rows[pick])
        quantizer.embed_avg.copy_(rows[pick])


def one_code_rows(n: int, gen: torch.Generator):
    """What an untrained encoder hands the bottom quantizer: rows far smaller
    than a unit-normal codebook, which all take the code of least norm."""
    embed = torch.randn(K, D, generator=gen, device="cuda")
    embed[K // 3] *= 0.05
    return 0.01 * torch.randn(n, D, generator=gen, device="cuda"), embed


def phase_kernels(model, x: torch.Tensor):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    flat_t, flat_b = capture_quantizer_inputs(model, x)
    check(flat_t.shape == (BATCH * 32 * 32, D) and flat_b.shape == (BATCH * 64 * 64, D),
          f"main-path shapes {tuple(flat_t.shape)} {tuple(flat_b.shape)}")
    # the stage-1 grids fill the card with row tiles: the search is not split
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stage1_ranges = {n: qz.search_split(n, K, sms) for n in (flat_t.shape[0], flat_b.shape[0])}
    check(all(r == 1 for r in stage1_ranges.values()),
          f"the stage-1 grids split the search: {stage1_ranges}")
    cases.append(compare_with_plain(flat_t, model.quantize_t.embed, "main path, top grid"))
    cases.append(compare_with_plain(flat_b, model.quantize_b.embed, "main path, bottom grid"))
    for n in (flat_t.shape[0], flat_b.shape[0]):
        cases.append(compare_with_plain(
            torch.randn(n, D, generator=gen, device="cuda"),
            torch.randn(K, D, generator=gen, device="cuda"), f"normal rows N={n}"))
    for label, flat, embed, exact in awkward_cases(gen):
        cases.append(compare_with_plain(flat, embed, label, exact_ids=exact))
    stats = [compare_stats_with_plain(flat_t, model.quantize_t.embed, "main path, top grid"),
             compare_stats_with_plain(flat_b, model.quantize_b.embed, "main path, bottom grid")]
    one = compare_stats_with_plain(*one_code_rows(flat_b.shape[0], gen),
                                   f"every row on one code N={flat_b.shape[0]}")
    check(one["codes_used"] == 1, f"the one-code case used {one['codes_used']} codes")
    stats.append(one)
    for label, flat, embed in stats_awkward_cases(gen):
        stats.append(compare_stats_with_plain(flat, embed, label))
    odd = []
    for d in ODD_EMBED_DIMS:
        flat = torch.randn(20000, d, generator=gen, device="cuda")
        embed = torch.randn(K, d, generator=gen, device="cuda")
        odd.append(through_kernels(
            ("nearest_code_ids", "nearest_code_lookup"),
            lambda: compare_with_plain(flat, embed, f"embed_dim={d}")))
        odd.append(through_kernels(
            ("nearest_code_stats",),
            lambda: compare_stats_with_plain(flat, embed, f"embed_dim={d}, statistics")))
    emit("kernels", tie_rtol=TIE_RTOL, esum_rtol=ESUM_RTOL, cases=cases, stats_cases=stats,
         odd_shape_cases=odd,
         stage1_search_ranges=stage1_ranges)
    return flat_t, flat_b, cases, stats


def small_input_against_cpu(model) -> dict:
    """Full width, small input: the card's results against the CPU's (the
    plain path).  The decoder, which has no discrete step, must agree closely;
    ids may differ at a few near-ties of the convolutions' rounding."""
    cpu = build_vqvae(device="cpu")
    cpu.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).normal(
        scale=0.5, size=(4, 128, 128, 3)).astype(np.float32))
    id_t, id_b = cpu.encode_ids(x)
    dec = cpu.decode_code(id_t, id_b)
    g_t, g_b = model.encode_ids(x.cuda())
    g_dec = model.decode_code(id_t.cuda(), id_b.cuda())
    flipped = int((g_t.cpu() != id_t).sum() + (g_b.cpu() != id_b).sum())
    total = id_t.numel() + id_b.numel()
    err = float((g_dec.cpu() - dec).abs().max())
    check(flipped <= 0.01 * total, f"card vs CPU: {flipped} of {total} ids differ (> 1%)")
    check(bool(torch.allclose(g_dec.cpu(), dec, rtol=1e-3, atol=1e-4)),
          f"card vs CPU: decode_code differs by {err}")
    return {"ids_differing": flipped, "ids": total, "decode_max_abs_err": err}


def run_extract(same_weights, tmp: str, weights_args) -> dict:
    """``extract_codes.main`` on 256 synthetic images into ``tmp``; the store
    is read back and must equal a direct ``encode_ids`` of the same images by
    ``same_weights``, and each batch must have launched each kernel once."""
    before = dict(qz.launch_counts)
    store_path = os.path.join(tmp, f"codes{len(os.listdir(tmp))}.vq2")
    t0 = time.perf_counter()
    n = extract_codes.main(["--synthetic", *weights_args, "--size", str(SIZE),
                            "--batch_size", str(EXTRACT_BATCH), "--name", store_path])
    seconds = time.perf_counter() - t0
    check(n == 4 * EXTRACT_BATCH, f"extract wrote {n} rows")
    store = CodeStore(store_path)
    backend = store.backend
    check(backend == "native", f"the code store read {store_path} by {backend}, not by its "
                               "native library")
    tops, bots, labels, names = store.gather(np.arange(n), with_names=True)
    store.close()
    batches = n // EXTRACT_BATCH
    check({k: v - before[k] for k, v in qz.launch_counts.items()}
          == {"nearest_code_ids": batches, "nearest_code_lookup": batches, "nearest_code_stats": 0},
          f"extract must launch each kernel once a batch: {before} -> {qz.launch_counts}")
    after = dict(qz.launch_counts)
    data = SyntheticImages(n=n, size=SIZE)
    for b in range(batches):
        rows = range(b * EXTRACT_BATCH, (b + 1) * EXTRACT_BATCH)
        imgs = torch.from_numpy(np.stack([data[i][0] for i in rows])).cuda()
        d_t, d_b = same_weights.encode_ids(imgs)
        check(np.array_equal(d_t.cpu().numpy(), tops[rows.start:rows.stop])
              and np.array_equal(d_b.cpu().numpy(), bots[rows.start:rows.stop]),
              f"code store differs from a direct encode_ids in batch {b}")
    check(names[0] == "synthetic/0.png" and names[-1] == f"synthetic/{n - 1}.png"
          and not labels.any(), "code store names or labels")
    qz.launch_counts.update(after)     # the comparison's launches do not count
    return {"rows": n, "seconds": seconds, "img_per_s": n / seconds, "store_backend": backend,
            "codes_used_top": int(np.unique(tops).size),
            "codes_used_bottom": int(np.unique(bots).size)}


def phase_main(model, x: torch.Tensor) -> dict:
    """The main path with the counters at zero before and read after."""
    qz.reset_counts()

    dec, diff = model(x)
    torch.cuda.synchronize()
    check(dec.shape == x.shape and bool(torch.isfinite(dec).all()), "forward: shape or non-finite")
    check(diff.ndim == 0 and bool(torch.isfinite(diff)), "forward: diff")
    check(qz.launch_counts == {"nearest_code_ids": 0, "nearest_code_lookup": 2,
                               "nearest_code_stats": 0},
          f"forward must launch the lookup kernel twice: {qz.launch_counts}")

    id_t, id_b = model.encode_ids(x)
    torch.cuda.synchronize()
    check(id_t.shape == (BATCH, SIZE // 8, SIZE // 8) and id_b.shape == (BATCH, SIZE // 4, SIZE // 4),
          f"encode_ids shapes {tuple(id_t.shape)} {tuple(id_b.shape)}")
    check(qz.launch_counts == {"nearest_code_ids": 1, "nearest_code_lookup": 3,
                               "nearest_code_stats": 0},
          f"encode_ids must launch each kernel once: {qz.launch_counts}")
    _, _, _, e_t, e_b = model.encode(x)
    check(bool(torch.equal(e_t, id_t) and torch.equal(e_b, id_b)), "encode and encode_ids disagree")
    rec_err = float((model.decode_code(id_t, id_b) - dec).abs().max())
    check(rec_err <= 1e-4 * max(1.0, float(dec.abs().max())),
          f"decode_code(ids) differs from forward's reconstruction by {rec_err}")

    fresh = build_vqvae(device="cuda", seed=0)     # what --random_init builds
    with tempfile.TemporaryDirectory() as tmp:
        CheckpointManager(os.path.join(tmp, "ckpt"), config=model.config).save_last(
            {"model": model.state_dict()})
        extract = {
            "random_init": run_extract(fresh, tmp, ["--random_init"]),
            "checkpoint": run_extract(model, tmp, ["--ckpt_dir", os.path.join(tmp, "ckpt")]),
        }
    launches = dict(qz.launch_counts)          # read just after the main path
    check(all(v == 0 for v in qz.plain_counts.values()),
          f"the plain version ran on the main path: {qz.plain_counts}")
    check(extract["checkpoint"]["codes_used_bottom"] > K // 4,
          f"the seeded codebooks should spread the codes: {extract['checkpoint']}")

    result = {"forward": {"dec": list(dec.shape), "diff": float(diff),
                          "decode_code_max_abs_err": rec_err},
              "encode_ids": {"id_t": list(id_t.shape), "id_b": list(id_b.shape),
                             "codes_used_top": int(id_t.unique().numel()),
                             "codes_used_bottom": int(id_b.unique().numel())},
              "extract": extract,
              "launches": launches, "plain_calls": dict(qz.plain_counts),
              "small_input_vs_cpu": small_input_against_cpu(model)}
    emit("main", **result)
    return launches


# ---------------------------------------------------------------------------
# stage 2: the attention kernel against its plain version
# ---------------------------------------------------------------------------

def plain_attention_in_chunks(q, k, v, chunk: int = 32, keep=None, **kw):
    """The plain version over ``chunk`` heads at a time: it materialises
    ``(heads, N, N)`` several times over, 1 GB each at 256 x 1024^2."""
    outs = [fa.causal_attention_reference_lse(
                q[i:i + chunk], k[i:i + chunk], v[i:i + chunk],
                keep=None if keep is None else keep[i:i + chunk], **kw)
            for i in range(0, q.shape[0], chunk)]
    return torch.cat([o for o, _ in outs]), torch.cat([l for _, l in outs])


def compare_attention_with_plain(q, k, v, label: str, dropout_rate: float = 0.0,
                                 seed: int = 0) -> dict:
    """The kernel's ``o`` and ``lse`` on ``(BH, N, D)`` against the plain
    version (given the kernel's own mask under dropout); row 0 must be
    bit-zero."""
    o, lse = fa.causal_flash_attention_lse(q, k, v, dropout_rate=dropout_rate, seed=seed)
    torch.cuda.synchronize()
    bh, n, d = q.shape
    check(o.shape == q.shape and o.dtype == q.dtype, f"{label}: o shape/dtype")
    check(lse.shape == (bh, n, 1) and lse.dtype == torch.float32, f"{label}: lse shape/dtype")
    check(bool((o[:, 0] == 0).all()), f"{label}: row 0 of o is not bit-zero")
    check(bool((lse[:, 0] == fa.NEG_INF).all()), f"{label}: lse of row 0 is not -1e30")
    check(bool(torch.isfinite(o.float()).all()), f"{label}: non-finite o")
    keep = fa.dropout_keep_mask(bh, n, dropout_rate, seed) if dropout_rate > 0 else None
    want_o, want_lse = plain_attention_in_chunks(q, k, v, keep=keep, dropout_rate=dropout_rate)
    tol = FA_TOL_BF16 if q.dtype == torch.bfloat16 else FA_TOL
    o_err = float((o.float() - want_o.float()).abs().max())
    lse_err = float((lse[:, 1:] - want_lse[:, 1:]).abs().max()) if n > 1 else 0.0
    check(bool(torch.allclose(o.float(), want_o.float(), **tol)),
          f"{label}: o differs from the plain version by {o_err} (tolerance {tol})")
    check(bool(torch.allclose(lse[:, 1:], want_lse[:, 1:], **FA_TOL)),
          f"{label}: lse differs from the plain version by {lse_err}")
    return {"case": label, "bh": bh, "n": n, "d": d, "dtype": str(q.dtype),
            "dropout_rate": dropout_rate, "o_max_abs_err": o_err, "lse_max_abs_err": lse_err,
            "o_abs_max": float(want_o.float().abs().max())}


def strict_causality_on_the_card(gen: torch.Generator) -> dict:
    """Overwriting k, v at positions >= i leaves rows <= i bit-equal."""
    q, k, v = (torch.randn(16, 1000, HEAD_DIM, generator=gen, device="cuda") for _ in range(3))
    o, lse = fa.causal_flash_attention_lse(q, k, v)
    i = 611
    k2, v2 = k.clone(), v.clone()
    k2[:, i:] = 999.0
    v2[:, i:] = -999.0
    o2, lse2 = fa.causal_flash_attention_lse(q, k2, v2)
    check(bool(torch.equal(o[:, :i + 1], o2[:, :i + 1]) and torch.equal(lse[:, :i + 1], lse2[:, :i + 1])),
          "strict causality: rows <= i changed with keys and values at >= i")
    check(not bool(torch.allclose(o[:, i + 1:], o2[:, i + 1:])),
          "strict causality: rows > i did not see the changed keys")
    return {"case": "strict causality", "n": 1000, "i": i, "rows_le_i_bit_equal": True}


def dropout_on_the_card(gen: torch.Generator) -> dict:
    """Dropout on: the normaliser is untouched, the exported mask is the
    kernel's own draw (and equals the same Philox draw in plain tensor
    arithmetic), and o follows the plain version given that mask."""
    rate, seed, bh, n = 0.3, 0x1234567890ABCDEF, 8, 300     # three query tiles
    q, k, v = (torch.randn(bh, n, HEAD_DIM, generator=gen, device="cuda") for _ in range(3))
    _, lse0 = fa.causal_flash_attention_lse(q, k, v)
    o, lse = fa.causal_flash_attention_lse(q, k, v, dropout_rate=rate, seed=seed)
    check(bool(torch.equal(lse, lse0)), "dropout: lse is not bit-equal to the rate-0 run")
    keep = fa.dropout_keep_mask(bh, n, rate, seed)
    check(bool(torch.equal(keep.bool(), fa.dropout_keep_reference(seed, bh, n, rate, device="cuda"))),
          "dropout: the kernel's mask is not the Philox draw of dropout_keep_reference")
    kept = float(keep.float().mean())
    check(abs(kept - (1 - rate)) < 0.005, f"dropout: keep rate {kept}, wanted {1 - rate} +- 0.005")
    want, _ = fa.causal_attention_reference_lse(q, k, v, keep=keep, dropout_rate=rate)
    err = float((o - want).abs().max())
    check(bool(torch.allclose(o, want, **FA_TOL)),
          f"dropout: o differs from the plain version with the kernel's mask by {err}")
    again, _ = fa.causal_flash_attention_lse(q, k, v, dropout_rate=rate, seed=seed)
    other, _ = fa.causal_flash_attention_lse(q, k, v, dropout_rate=rate, seed=seed + 1)
    check(bool(torch.equal(o, again)), "dropout: two launches with one seed differ")
    check(not bool(torch.equal(o, other)), "dropout: two seeds gave the same result")
    # the public wrapper draws its seed from a generator
    q4, k4, v4 = (t.reshape(1, bh, n, HEAD_DIM) for t in (q, k, v))
    a = fa.causal_flash_attention(q4, k4, v4, dropout_rate=rate,
                                  generator=torch.Generator(device="cuda").manual_seed(3))
    b = fa.causal_flash_attention(q4, k4, v4, dropout_rate=rate,
                                  generator=torch.Generator(device="cuda").manual_seed(3))
    check(bool(torch.equal(a, b)) and not bool(torch.equal(a[0], o)),
          "dropout: the wrapper's draw does not follow its generator")
    return {"case": "dropout", "rate": rate, "bh": bh, "n": n, "keep_rate": kept,
            "o_max_abs_err": err, "lse_bit_equal_to_rate_0": True,
            "mask_equals_philox_reference": True}


def plain_grads_in_chunks(q, k, v, do, keep=None, dropout_rate=0.0, chunk: int = 32):
    """Autograd of the plain version over ``chunk`` heads at a time, in fp32."""
    grads = [[], [], []]
    for i in range(0, q.shape[0], chunk):
        leaves = [t[i:i + chunk].detach().float().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            o = fa.causal_attention_reference(
                *leaves, keep=None if keep is None else keep[i:i + chunk],
                dropout_rate=dropout_rate)
            for acc, g in zip(grads, torch.autograd.grad(o, leaves, do[i:i + chunk].float())):
                acc.append(g)
    return [torch.cat(g) for g in grads]


def compare_attention_backward(q, k, v, do, label: str, dropout_rate: float = 0.0,
                               seed: int = 0, rounded_o: bool = False) -> dict:
    """The gradients through the kernels (``causal_flash_attention_lse`` with
    grad on: K4 forward, K5 and K6 backward) against autograd of the plain
    version on the same inputs; with dropout on, the plain version takes the
    kernel's own exported mask.  Row 0 of ``dq`` must be bit-zero.

    ``rounded_o``: against the backward kernels' own plain version,
    ``causal_attention_backward_reference`` in fp32, given the plain
    forward's ``o`` rounded to the inputs' dtype and its ``lse``.  For bf16
    inputs: both packages form dsum = <do, o> from the forward's bf16 ``o``
    (the JAX package's backward takes it as its forward wrote it), which
    autograd of the fp32 plain forward does not see; where a row's terms
    cancel (a row that sees few keys) that moves dq by about 1e-2 at D = 128.
    Nothing of the kernels' output enters the reference."""
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        o, lse = fa.causal_flash_attention_lse(*leaves, dropout_rate=dropout_rate, seed=seed)
        got = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    bh, n, d = q.shape
    keep = fa.dropout_keep_mask(bh, n, dropout_rate, seed) if dropout_rate > 0 else None
    if rounded_o:
        plain_o, plain_lse = plain_attention_in_chunks(q, k, v, keep=keep,
                                                       dropout_rate=dropout_rate)
        want = fa.causal_attention_backward_reference(
            *(t.float() for t in (q, k, v, plain_o)), plain_lse, do.float(), keep=keep,
            dropout_rate=dropout_rate)
    else:
        want = plain_grads_in_chunks(q, k, v, do, keep=keep, dropout_rate=dropout_rate)
    tol = FA_TOL_BF16 if q.dtype == torch.bfloat16 else FA_TOL
    out = {"case": label, "bh": bh, "n": n, "d": d, "dtype": str(q.dtype),
           "dropout_rate": dropout_rate,
           "against": "the backward's plain version given the plain forward's o in "
                      f"{str(q.dtype)[6:]} and its lse" if rounded_o
           else "autograd of the plain forward"}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.shape == q.shape and g.dtype == q.dtype and bool(torch.isfinite(g.float()).all()),
              f"{label}: {name} shape, dtype or non-finite")
        err = float((g.float() - w).abs().max())
        check(bool(torch.allclose(g.float(), w, **tol)),
              f"{label}: {name} differs from {out['against']} by {err} (tolerance {tol})")
        out[f"{name}_max_abs_err"] = err
        out[f"{name}_abs_max"] = float(w.abs().max())
    check(bool((got[0][:, 0] == 0).all()), f"{label}: row 0 of dq is not bit-zero")
    return out


def backward_causality_on_the_card(gen: torch.Generator) -> dict:
    """An upstream gradient on row i alone moves no key or value at j >= i,
    with dropout off and on."""
    bh, n, i = 8, 700, 431
    q, k, v = (torch.randn(bh, n, HEAD_DIM, generator=gen, device="cuda") for _ in range(3))
    do = torch.zeros(bh, n, HEAD_DIM, device="cuda")
    do[:, i] = torch.randn(bh, HEAD_DIM, generator=gen, device="cuda")
    for rate in (0.0, 0.2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            o, _ = fa.causal_flash_attention_lse(*leaves, dropout_rate=rate, seed=11)
            dq, dk, dv = torch.autograd.grad(o, leaves, do)
        check(bool((dk[:, i:] == 0).all() and (dv[:, i:] == 0).all()),
              f"backward causality (rate {rate}): keys at j >= i got a gradient from row i")
        check(bool((dk[:, :i] != 0).any()) and bool((dq[:, i] != 0).any())
              and bool((dq[:, :i] == 0).all() and (dq[:, i + 1:] == 0).all()),
              f"backward causality (rate {rate}): the gradient did not reach the rows < i")
    return {"case": "backward causality", "n": n, "i": i, "keys_at_or_after_i_untouched": True}


def huge_scores_backward_on_the_card(gen: torch.Generator) -> dict:
    """q and k of size 1e4, as a few train steps of the top prior bring them:
    scores of about 1e9, a one-hot softmax.  The backward kernels recompute
    p = exp(s - lse) from the forward's lse, so they must round each score as
    the forward did, or p overflows and the gradients turn to inf and NaN.
    All three gradients must be finite; dv (each key's sum of the upstream
    gradients of the queries that pick it) must agree with the plain version.
    dq and dk are rounding noise times 1e4 on both sides (dp - dsum cancels
    to zero in exact arithmetic) and are held to be finite only."""
    bh, n, d = 8, 300, HEAD_DIM
    q, k, v, do = (torch.randn(bh, n, d, generator=gen, device="cuda") for _ in range(4))
    q, k = q * 1e4, k * 1e4
    for rate in (0.0, PRIOR_CONFIG["dropout"]):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            o, _ = fa.causal_flash_attention_lse(*leaves, dropout_rate=rate, seed=13)
            dq, dk, dv = torch.autograd.grad(o, leaves, do)
        check(all(bool(torch.isfinite(g).all()) for g in (o, dq, dk, dv)),
              f"huge scores (rate {rate}): non-finite output or gradient")
        keep = fa.dropout_keep_mask(bh, n, rate, 13) if rate > 0 else None
        want = plain_grads_in_chunks(q, k, v, do, keep=keep, dropout_rate=rate)[2]
        err = float((dv - want).abs().max())
        check(bool(torch.allclose(dv, want, **FA_TOL)),
              f"huge scores (rate {rate}): dv differs from the plain version by {err}")
    return {"case": "huge scores (q, k * 1e4)", "bh": bh, "n": n, "finite": True,
            "dv_max_abs_err": err, "dv_abs_max": float(want.abs().max())}


def attention_backward_awkward_cases(gen: torch.Generator):
    def normal(bh, n, d, dtype=torch.float32):
        return [torch.randn(bh, n, d, generator=gen, device="cuda").to(dtype) for _ in range(4)]

    yield "N=1 (all zeros)", normal(8, 1, HEAD_DIM), 0.0
    yield "N=7", normal(8, 7, HEAD_DIM), 0.0
    yield "N=96", normal(8, 96, HEAD_DIM), 0.0
    yield "N=1000 (no multiple of a tile)", normal(16, 1000, HEAD_DIM), 0.0
    yield "D=24 (padded to 32 in registers)", normal(4, 130, 24), 0.0
    yield "D=32", normal(8, 300, 32), 0.0
    yield "D=64", normal(8, 200, 64), 0.0
    yield "bf16 inputs", normal(16, 1000, HEAD_DIM, torch.bfloat16), 0.0
    yield "dropout 0.3, N=300", normal(8, 300, HEAD_DIM), 0.3
    yield "dropout 0.1, D=32, N=257", normal(8, 257, 32), 0.1


def dq_tensor_core_cases():
    """Shapes on which the dq kernel takes its tensor-core design without a
    wide head (fp32 at 64 features under dropout, bf16 at 32 under dropout),
    and bf16 at 32 without dropout, where it takes its CUDA-core design."""
    gen = torch.Generator(device="cuda").manual_seed(17)

    def normal(bh, n, d, dtype=torch.float32):
        return [torch.randn(bh, n, d, generator=gen, device="cuda").to(dtype) for _ in range(4)]

    yield "dropout 0.1, D=64, N=300", normal(8, 300, 64), 0.1
    yield "bf16, D=32, N=500", normal(8, 500, 32, torch.bfloat16), 0.0
    yield "bf16, D=32, N=500, dropout 0.1", normal(8, 500, 32, torch.bfloat16), 0.1


def attention_odd_shape_cases(gen: torch.Generator) -> list:
    """The forward and both backward kernels at the head widths of
    ``ODD_HEAD_DIMS``, fp32 and bf16, without and with dropout 0.1, at N = 1024
    and a ragged N, each through its kernels (launch counters)."""
    out = []
    for d, n, dtype, rate in itertools.product(ODD_HEAD_DIMS, ODD_SEQ_LENS,
                                               (torch.float32, torch.bfloat16), (0.0, 0.1)):
        q, k, v, do = (torch.randn(4, n, d, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        label = f"odd shape D={d} N={n} {str(dtype)[6:]} dropout {rate}"
        out.append(through_kernels(
            ("causal_flash_attention",),
            lambda: compare_attention_with_plain(q, k, v, label, dropout_rate=rate, seed=21)))
        out.append(through_kernels(
            ("causal_flash_attention", "causal_flash_attention_dq", "causal_flash_attention_dkv"),
            lambda: compare_attention_backward(q, k, v, do, label + ", backward", dropout_rate=rate,
                                               seed=21,
                                               rounded_o=dtype == torch.bfloat16)))
    return out


def capture_attention_inputs(prior, codes: torch.Tensor):
    """The ``q, k, v (B*H, N, D)`` that the top prior's forward hands the
    attention kernel in each block."""
    seen = []
    hooks = [block.causal_attention.register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(
            t.reshape(-1, t.shape[2], t.shape[3]) for t in mod.qkv(*args))))
        for block in prior.blocks]
    prior(codes)
    for h in hooks:
        h.remove()
    return seen


def attention_awkward_cases(gen: torch.Generator):
    def normal(bh, n, d, dtype=torch.float32, scale=1.0):
        q, k, v = (torch.randn(bh, n, d, generator=gen, device="cuda") for _ in range(3))
        return (q * scale).to(dtype), k.to(dtype), v.to(dtype)

    yield "the full-forward sampler's shape at 128 px", normal(
        SAMPLE_BATCH * N_HEAD, (COMPARE_SIZE // 8) ** 2, HEAD_DIM)
    yield "N=1 (all zeros)", normal(8, 1, HEAD_DIM)
    yield "N=7", normal(8, 7, HEAD_DIM)
    yield "N=96", normal(8, 96, HEAD_DIM)
    yield "N=1000 (no multiple of a tile)", normal(16, 1000, HEAD_DIM)
    yield "D=32", normal(8, 300, 32)
    yield "D=64", normal(8, 200, 64)
    yield "D=24 (padded to 32 in registers)", normal(4, 130, 24)
    yield "bf16 inputs", normal(16, 1000, HEAD_DIM, dtype=torch.bfloat16)
    yield "large scores (q * 50)", normal(16, 1000, HEAD_DIM, scale=50.0)


def phase_attention_kernel(top, codes: torch.Tensor):
    gen = torch.Generator(device="cuda").manual_seed(1)
    seen = capture_attention_inputs(top, codes)
    bh, n = PRIOR_BATCH * N_HEAD, TOP_HW * TOP_HW
    check(len(seen) == len(top.blocks) and all(t.shape == (bh, n, HEAD_DIM) for t in seen[0]),
          f"main-path attention shapes {[tuple(t.shape) for t in seen[0]]}")
    cases = [compare_attention_with_plain(*qkv, f"main path, block {b}")
             for b, qkv in enumerate(seen)]
    cases.append(compare_attention_with_plain(
        *(torch.randn(bh, n, HEAD_DIM, generator=gen, device="cuda") for _ in range(3)),
        f"normal q, k, v BH={bh} N={n}"))
    for label, qkv in attention_awkward_cases(gen):
        cases.append(compare_attention_with_plain(*qkv, label))
    cases.append(strict_causality_on_the_card(gen))
    cases.append(dropout_on_the_card(gen))
    emit("attention_kernel", tolerance=FA_TOL, tolerance_bf16=FA_TOL_BF16, cases=cases)

    # the backward, on the prior's own q, k, v of the first block
    do = torch.randn(bh, n, HEAD_DIM, generator=gen, device="cuda")
    backward = [compare_attention_backward(*seen[0], do, "main path, block 0"),
                compare_attention_backward(*seen[0], do, "main path, block 0, dropout 0.1",
                                           dropout_rate=PRIOR_CONFIG["dropout"], seed=0xC0FFEE)]
    for label, (q, k, v, g), rate in attention_backward_awkward_cases(gen):
        backward.append(compare_attention_backward(q, k, v, g, label, dropout_rate=rate, seed=5))
    for label, (q, k, v, g), rate in dq_tensor_core_cases():
        backward.append(compare_attention_backward(q, k, v, g, label, dropout_rate=rate, seed=5,
                                                   rounded_o=q.dtype == torch.bfloat16))
    backward.append(backward_causality_on_the_card(gen))
    backward.append(huge_scores_backward_on_the_card(gen))
    emit("attention_backward", tolerance=FA_TOL, tolerance_bf16=FA_TOL_BF16, cases=backward)
    emit("attention_odd_shapes", tolerance=FA_TOL, tolerance_bf16=FA_TOL_BF16,
         cases=attention_odd_shape_cases(gen))
    return seen[0], cases, do, backward


# ---------------------------------------------------------------------------
# stage 2: the main path
# ---------------------------------------------------------------------------

def write_checkpoints(vqvae, tmp: str) -> dict:
    """Three checkpoint directories as ``train/sample.py`` restores them: the
    stage-1 model of this run, and the two priors at full width with seeded
    weights (biases moved off zero, so that every bias path shows)."""
    dirs = {name: os.path.join(tmp, name) for name in ("vqvae", "top", "bottom")}
    CheckpointManager(dirs["vqvae"], config=vqvae.config).save_last({"model": vqvae.state_dict()})
    args = argparse.Namespace(**PRIOR_CONFIG)
    for seed, hier in enumerate(("top", "bottom"), start=1):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            prior = build_model(hier, args, code_hw=(TOP_HW, BOTTOM_HW))
            for name, p in prior.named_parameters():
                if name.endswith(".b"):
                    torch.nn.init.normal_(p, std=0.05)
        CheckpointManager(dirs[hier], config=PRIOR_CONFIG).save_last(prior.state_dict())
    return dirs


def all_counts() -> dict:
    return {"launches": {**qz.launch_counts, **fa.launch_counts, **ia.launch_counts},
            "plain_calls": {**qz.plain_counts, **fa.plain_counts, **ia.plain_counts}}


def reset_all_counts() -> None:
    qz.reset_counts()
    fa.reset_counts()
    ia.reset_counts()


def numpy_codes(seed: int, *shape) -> torch.Tensor:
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(0, K, size=shape).astype(np.int32)).cuda()


def top_forward(top, codes: torch.Tensor) -> dict:
    """(a) the top prior's full forward on a batch of code grids, and the
    causality of the whole model."""
    before = fa.launch_counts["causal_flash_attention"]
    logits = top(codes)
    torch.cuda.synchronize()
    check(logits.shape == (PRIOR_BATCH, TOP_HW, TOP_HW, K) and bool(torch.isfinite(logits).all()),
          f"top forward: shape {tuple(logits.shape)} or non-finite logits")
    check(fa.launch_counts["causal_flash_attention"] - before == len(top.blocks) == 4,
          f"top forward must launch the attention kernel once a block: {fa.launch_counts}")
    n = TOP_HW * TOP_HW
    t = n // 2 + 5
    changed = codes.clone().view(PRIOR_BATCH, n)
    changed[:, t:] = (changed[:, t:] + 7) % K
    logits2 = top(changed.view_as(codes))
    a, b = logits.view(PRIOR_BATCH, n, K), logits2.view(PRIOR_BATCH, n, K)
    moved = float((a[:, :t + 1] - b[:, :t + 1]).abs().max())
    check(moved <= 1e-5, f"top forward: logits at positions <= t moved by {moved} with codes >= t")
    check(not bool(torch.allclose(a[:, t + 1:], b[:, t + 1:])),
          "top forward: logits after t did not see the changed codes")
    return {"logits": list(logits.shape), "logits_abs_max": float(logits.abs().max()),
            "causality_max_move_le_t": moved}


def decoder_against_forward(prior, codes, condition=None) -> dict:
    """(b) teacher-forced incremental logits against the full forward."""
    t0 = time.perf_counter()
    got = teacher_forced_logits(prior, codes, condition=condition)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = prior(codes, condition=condition)
    err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, **LOGITS_TOL)),
          f"incremental decoder differs from the full forward by {err} (tolerance {LOGITS_TOL})")
    steps = codes.shape[1] * codes.shape[2]
    return {"grid": list(codes.shape), "max_abs_err": err, "logits_abs_max": float(want.abs().max()),
            "seconds": seconds, "ms_per_step": seconds / steps * 1e3}


def run_sample(dirs: dict, tmp: str, size: int, full_forward: bool) -> dict:
    """(c) ``train/sample.py main`` through its command line; each prior's
    sampler is timed by a wrapper around the function ``main`` calls."""
    before = all_counts()
    name = "sample_prior" if full_forward else "sample_prior_incremental"
    sampler, seconds = getattr(sample, name), []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sampler(*args, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    png = os.path.join(tmp, f"sample_{size}_{name}.png")
    argv = [png, "--vqvae", dirs["vqvae"], "--top", dirs["top"], "--bottom", dirs["bottom"],
            "--batch", str(SAMPLE_BATCH), "--size", str(size), "--seed", "0"]
    setattr(sample, name, timed)
    try:
        t0 = time.perf_counter()
        top, bottom = sample.main(argv + (["--full_forward"] if full_forward else []))
        total = time.perf_counter() - t0
    finally:
        setattr(sample, name, sampler)
    th, bh = size // 8, size // 4
    check(top.shape == (SAMPLE_BATCH, th, th) and bottom.shape == (SAMPLE_BATCH, bh, bh),
          f"sample: code shapes {tuple(top.shape)} {tuple(bottom.shape)}")
    for codes in (top, bottom):
        check(int(codes.min()) >= 0 and int(codes.max()) < K, "sample: a code outside [0, 512)")
    with Image.open(png) as img:
        check(img.size == (SAMPLE_BATCH * (size + 2) + 2, size + 4) and img.mode == "RGB",
              f"sample: the PNG is {img.size} {img.mode}")
    after = all_counts()
    rose = {k: after["launches"][k] - before["launches"][k] for k in after["launches"]}
    want = dict.fromkeys(after["launches"], 0)
    want["causal_flash_attention"] = th * th * 4 if full_forward else 0
    check(rose == want, f"sample ({name}, {size} px) launched {rose}, expected {want}")
    check(after["plain_calls"] == before["plain_calls"],
          f"sample ran a plain version: {after['plain_calls']}")
    return {"size": size, "sampler": name, "batch": SAMPLE_BATCH, "seconds": total,
            "top": {"positions": th * th, "seconds": seconds[0],
                    "codes_per_s": SAMPLE_BATCH * th * th / seconds[0]},
            "bottom": {"positions": bh * bh, "seconds": seconds[1],
                       "codes_per_s": SAMPLE_BATCH * bh * bh / seconds[1]},
            "codes_used_top": int(top.unique().numel()),
            "codes_used_bottom": int(bottom.unique().numel()),
            "attention_launches": rose["causal_flash_attention"], "codes": (top, bottom)}


def samplers_agree(a: dict, b: dict) -> dict:
    """One seed, two samplers: the codes are equal unless a draw fell on a
    near-tie that the two schedules' rounding split, after which that image's
    later codes are another, equally valid sample.  At most one image of the
    batch may part that way; where it did is reported."""
    out = {}
    for which, x, y in (("top", a["codes"][0], b["codes"][0]),
                        ("bottom", a["codes"][1], b["codes"][1])):
        differ = (x != y).flatten(1)
        first = [int(row.int().argmax()) if bool(row.any()) else None for row in differ.cpu()]
        out[which] = {"images_parted": sum(f is not None for f in first), "first_position": first}
    check(out["top"]["images_parted"] <= 1,
          f"the two samplers' top codes part in more than one image: {out['top']}")
    return out


def prior_against_cpu(top) -> dict:
    """(d) full width, small grid: the card's logits against the CPU's (the
    plain attention)."""
    cpu = build_model("top", argparse.Namespace(**PRIOR_CONFIG), code_hw=(TOP_HW, BOTTOM_HW)).eval()
    cpu.load_state_dict(top.state_dict())
    codes = numpy_codes(5, 2, 8, 8)
    want = cpu(codes.cpu())
    got = top(codes).cpu()
    err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, **LOGITS_TOL)),
          f"card vs CPU: the top prior's logits differ by {err}")
    return {"grid": [2, 8, 8], "max_abs_err": err, "logits_abs_max": float(want.abs().max())}


def phase_main_stage2(dirs: dict, tmp: str, top, bottom) -> dict:
    """The stage-2 main path with the counters at zero before and read after."""
    reset_all_counts()
    torch.cuda.reset_peak_memory_stats()
    result = {"top_forward": top_forward(top, numpy_codes(2, PRIOR_BATCH, TOP_HW, TOP_HW))}
    result["decoder_vs_forward"] = {
        "top": decoder_against_forward(top, numpy_codes(3, DECODER_BATCH, TOP_HW, TOP_HW)),
        "bottom": decoder_against_forward(
            bottom, numpy_codes(4, DECODER_BATCH, BOTTOM_HW, BOTTOM_HW),
            condition=numpy_codes(3, DECODER_BATCH, TOP_HW, TOP_HW))}
    runs = {"incremental_256": run_sample(dirs, tmp, SIZE, full_forward=False),
            "incremental": run_sample(dirs, tmp, COMPARE_SIZE, full_forward=False),
            "full_forward": run_sample(dirs, tmp, COMPARE_SIZE, full_forward=True)}
    counts = all_counts()                       # read just after the main path
    check(not any(counts["plain_calls"].values()),
          f"a plain version ran on the stage-2 main path: {counts['plain_calls']}")
    check(counts["launches"]["causal_flash_attention"] > 0,
          "the stage-2 main path never launched the attention kernel")
    result["samplers_agree"] = samplers_agree(runs["incremental"], runs["full_forward"])
    result["sample"] = {k: {f: v for f, v in r.items() if f != "codes"} for k, r in runs.items()}
    result["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    result.update(counts)
    result["small_input_vs_cpu"] = prior_against_cpu(top)
    emit("main_stage2", **result)
    return counts["launches"]


# ---------------------------------------------------------------------------
# training: both trainers through their command lines
# ---------------------------------------------------------------------------

def csv_column(path: str, column: str) -> list:
    with open(path) as f:
        header, *rows = [line.strip().split(",") for line in f if line.strip()]
    at = header.index(column)
    return [float(r[at]) for r in rows]


def falling(values: list) -> bool:
    """The mean of the last third of the steps lies below that of the first."""
    w = max(1, len(values) // 3)
    return float(np.mean(values[-w:])) < float(np.mean(values[:w]))


def saved_step(ckpt_dir: str) -> int:
    return int(CheckpointManager(ckpt_dir).restore("last")["step"])


def steps_on_card_and_cpu(model_cuda, model_cpu, make_step, batch_cuda, batch_cpu) -> list:
    """One train step of the same weights on the card and on the CPU:
    ``[(metrics, gradients on the CPU)]`` of each."""
    results = []
    for model, batch in ((model_cuda, batch_cuda), (model_cpu, batch_cpu)):
        tx = schedules.adam(3e-4)
        state = tv.create_state(model, tx)
        with torch.enable_grad():
            _, metrics = make_step(model, tx)(state, batch)
        results.append(({k: float(v) for k, v in metrics.items()},
                        {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                         if p.grad is not None}))
    return results


def step_against_cpu(model_cuda, model_cpu, make_step, batch_cuda, batch_cpu) -> dict:
    """One train step of the same weights on the card and on the CPU: the
    metrics within LOGITS_TOL, each gradient tensor within GRAD_RTOL of its
    largest element.  Returns the errors."""
    (m_gpu, g_gpu), (m_cpu, g_cpu) = steps_on_card_and_cpu(
        model_cuda, model_cpu, make_step, batch_cuda, batch_cpu)
    out = {"metrics_card": m_gpu, "metrics_cpu": m_cpu}
    for k in m_cpu:
        check(bool(np.isclose(m_gpu[k], m_cpu[k], rtol=LOGITS_TOL["rtol"], atol=LOGITS_TOL["atol"])),
              f"card vs CPU step: {k} {m_gpu[k]} vs {m_cpu[k]}")
    floor = 1e-3 * max(float(g.abs().max()) for g in g_cpu.values())
    worst = 0.0
    for name, g in g_cpu.items():
        scale = max(float(g.abs().max()), floor)
        err = float((g_gpu[name] - g).abs().max())
        worst = max(worst, err / scale)
        check(err <= GRAD_RTOL * scale,
              f"card vs CPU step: the gradient of {name} differs by {err} (scale {scale})")
    out["grad_worst_rel_err"] = worst
    return out


def stage1_on_card_and_cpu(vq_dir: str, dtype: torch.dtype = torch.float32):
    """The run's own stage-1 checkpoint on the card and on the CPU with
    ``dtype`` compute, a small input, and how many of the two models' ids for
    it differ: ``(models, x, differing, total)``."""
    cfg = CheckpointManager(vq_dir).load_config()
    state = CheckpointManager(vq_dir).restore("last")["model"]
    models = []
    for device in ("cuda", "cpu"):
        m = build_vqvae(device=device, channel=cfg["channel"], n_res_block=cfg["n_res_block"],
                        n_res_channel=cfg["n_res_channel"], embed_dim=cfg["embed_dim"],
                        n_embed=cfg["n_embed"], dtype=dtype)
        m.load_state_dict(state)
        models.append(m)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        scale=0.5, size=(2, 64, 64, 3)).astype(np.float32))
    ids = [m.encode_ids(x.to(device)) for m, device in zip(models, ("cuda", "cpu"))]
    differing = int(sum((a.cpu() != b).sum() for a, b in zip(ids[0], ids[1])))
    return models, x, differing, sum(t.numel() for t in ids[1])


def stage1_step_against_cpu(vq_dir: str) -> dict:
    """Full width, small input, the run's own checkpoint: one stage-1 step on
    the card against the same on the CPU; the codebook buffers after it agree
    too where the two picked the same codes."""
    models, x, differing, total = stage1_on_card_and_cpu(vq_dir)
    check(differing <= 0.01 * total, f"card vs CPU: {differing} of {total} ids differ before the step")
    out = step_against_cpu(models[0], models[1], tv.make_train_step, x.cuda(), x)
    if differing == 0:
        for name, value in models[1].state_dict().items():
            if "quantize_" in name:
                got = models[0].state_dict()[name].cpu()
                check(bool(torch.allclose(got, value, rtol=1e-4, atol=1e-5)),
                      f"card vs CPU step: {name} differs by {float((got - value).abs().max())}")
    out.update(input=[2, 64, 64, 3], ids_differing=differing, buffers_compared=differing == 0)
    return out


def prior_step_against_cpu(top_dir: str) -> dict:
    """Full width, small grid, the run's own top prior with dropout at 0 (the
    card's and the CPU's generators draw differently): one step each."""
    models = []
    for device in ("cuda", "cpu"):
        m = sample._restore_prior(top_dir, "top", (TOP_HW, BOTTOM_HW), device)
        for mod in m.modules():
            if hasattr(mod, "dropout"):
                mod.dropout = 0.0
        models.append(m)
    codes = numpy_codes(6, 2, 8, 8)

    def make(model, tx):
        return tp.make_train_step(model, tx, conditional=False)

    out = step_against_cpu(models[0], models[1], make, {"target": codes}, {"target": codes.cpu()})
    out["grid"] = [2, 8, 8]
    return out


def phase_main_train(tmp: str) -> dict:
    """Both trainers through their command lines at the defaults' width and
    batch, with the launch counters at zero before and read after: stage 1
    for a few steps and one step of two microbatches resumed from it, code
    extraction from its checkpoint, the top and the bottom prior on those
    codes, and sampling from the three checkpoints."""
    root = os.path.join(tmp, "train")
    dirs = {name: os.path.join(root, name) for name in ("vqvae", "top", "bottom")}
    csvs = {name: os.path.join(root, f"{name}.csv") for name in dirs}
    n1, n2, n3 = TRAIN_STEPS["vqvae"], TRAIN_STEPS["top"], TRAIN_STEPS["bottom"]
    reset_all_counts()
    result = {"steps": dict(TRAIN_STEPS), "batch": dict(TRAIN_BATCH)}

    stage1 = ["--synthetic", "--size", str(SIZE), "--batch_size", str(TRAIN_BATCH["vqvae"]),
              "--log_every", "1", "--ckpt_dir", dirs["vqvae"]]
    t0 = time.perf_counter()
    tv.main(stage1 + ["--steps", str(n1), "--metrics_csv", csvs["vqvae"]])
    seconds = time.perf_counter() - t0
    losses = csv_column(csvs["vqvae"], "loss")
    check(len(losses) == n1 and all(np.isfinite(losses)), f"stage 1: losses {losses}")
    check(falling(losses), f"stage 1: the loss did not fall: {losses}")
    check(qz.launch_counts["nearest_code_stats"] == 2 * n1,
          f"stage 1: {n1} steps launched the statistics kernel "
          f"{qz.launch_counts['nearest_code_stats']} times, not {2 * n1}")
    t0 = time.perf_counter()
    tv.main(stage1 + ["--steps", "1", "--grad_accum", "2", "--resume"])
    accum_seconds = time.perf_counter() - t0
    check(saved_step(dirs["vqvae"]) == n1 + 1, "stage 1: the resumed step did not continue the count")
    check(qz.launch_counts["nearest_code_stats"] == 2 * n1 + 4,
          f"stage 1: the grad_accum=2 step launched {qz.launch_counts['nearest_code_stats'] - 2 * n1}"
          " statistics kernels, not 4")
    result["stage1"] = {"seconds": seconds, "loss": losses,
                        "recon_mse": csv_column(csvs["vqvae"], "recon_mse"),
                        "latent": csv_column(csvs["vqvae"], "latent"),
                        "img_per_s_cli": csv_column(csvs["vqvae"], "img_per_s")[-1],
                        "grad_accum_2_step_seconds": accum_seconds}

    codes = os.path.join(root, "codes.vq2")
    n = extract_codes.main(["--synthetic", "--ckpt_dir", dirs["vqvae"], "--size", str(SIZE),
                            "--name", codes])
    store = CodeStore(codes)
    tops, bots, _ = store.gather(np.arange(n))
    store.close()
    result["extract"] = {"rows": n, "codes_used_top": int(np.unique(tops).size),
                         "codes_used_bottom": int(np.unique(bots).size)}

    for hier, steps in (("top", n2), ("bottom", n3)):
        t0 = time.perf_counter()
        tp.main([codes, "--hier", hier, "--batch", str(TRAIN_BATCH[hier]), "--steps", str(steps),
                 "--log_every", "1", "--ckpt_dir", dirs[hier], "--metrics_csv", csvs[hier]])
        ce = csv_column(csvs[hier], "loss")
        check(len(ce) == steps and all(np.isfinite(ce)), f"{hier} prior: losses {ce}")
        check(abs(ce[0] - np.log(K)) < 1.0, f"{hier} prior: CE starts at {ce[0]}, not near ln {K}")
        check(falling(ce), f"{hier} prior: the cross-entropy did not fall: {ce}")
        result[hier] = {"seconds": time.perf_counter() - t0, "loss": ce,
                        "acc": csv_column(csvs[hier], "acc")}
    check(fa.launch_counts["causal_flash_attention_dq"] == 4 * n2
          and fa.launch_counts["causal_flash_attention_dkv"] == 4 * n2,
          f"{n2} top-prior steps must launch each backward kernel {4 * n2} times: {fa.launch_counts}")

    png = os.path.join(root, "sample.png")
    t0 = time.perf_counter()
    top, bottom = sample.main([png, "--vqvae", dirs["vqvae"], "--top", dirs["top"],
                               "--bottom", dirs["bottom"], "--size", str(COMPARE_SIZE),
                               "--batch", str(SAMPLE_BATCH)])
    with Image.open(png) as img:
        check(img.size == (SAMPLE_BATCH * (COMPARE_SIZE + 2) + 2, COMPARE_SIZE + 4),
              f"sample from the trained checkpoints: the PNG is {img.size}")
    result["sample"] = {"size": COMPARE_SIZE, "batch": SAMPLE_BATCH,
                        "seconds": time.perf_counter() - t0,
                        "codes_used_top": int(top.unique().numel()),
                        "codes_used_bottom": int(bottom.unique().numel())}

    counts = all_counts()                      # read just after the training path
    check(not any(counts["plain_calls"].values()),
          f"a plain version ran on the training path: {counts['plain_calls']}")
    want = {"nearest_code_stats": 2 * n1 + 4, "causal_flash_attention_dq": 4 * n2,
            "causal_flash_attention_dkv": 4 * n2}
    check(all(counts["launches"][k] == v for k, v in want.items()),
          f"training path launches {counts['launches']}, expected {want}")
    result.update(counts)
    result["stage1_step_vs_cpu"] = stage1_step_against_cpu(dirs["vqvae"])
    result["top_prior_step_vs_cpu"] = prior_step_against_cpu(dirs["top"])
    emit("main_train", **result)
    return counts["launches"], dirs


def kernel_work(name: str, n: int, d: int, k: int, itemsize: int) -> dict:
    """Least bytes and operations of one call: each input read once, each
    output written once; the product, the two norms and the two subtractions a
    score."""
    nbytes = n * d * itemsize + k * d * 4 + n * 4
    if name == "nearest_code_lookup":
        nbytes += n * d * itemsize
    flops = 2 * n * k * d + 2 * n * d + 2 * k * d + 2 * n * k
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attention_work(bh: int, n: int, d: int, itemsize: int, dropout: bool = False) -> dict:
    """Least bytes and operations of one call: q, k, v read once, o and lse
    written once; the two products over the causal half of the score matrix.
    ``bound_ms`` holds the products to the fp32 rate of the CUDA cores (the
    yardstick of the earlier rows); ``bound_tc_ms`` is the largest of the
    bytes' time, three TF32 passes of both products (3 x 2 x 2D flops a
    visible pair, N(N-1)/2 pairs a head) at the tensor cores' TF32 rate, and
    the softmax's CUDA-core work at the fp32 rate: 8 operations a visible pair
    (scale, mask, maximum, subtraction, exponential, sum, the TF32 split of
    p), and under dropout 27 more (a Philox-4x32-10 draw, 100 integer
    operations, serves 4 pairs; then the compare and the scaling).  The term
    ``scores_fma`` (2D fp32 flops a visible pair on the CUDA cores, not part
    of the bound) is what the kernel pays for keeping the scores in the plain
    version's rounding."""
    nbytes = 4 * bh * n * d * itemsize + bh * n * 4
    flops = 4 * bh * n * n * d // 2
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    pairs = bh * n * (n - 1) // 2
    t_tc = 3 * 2 * 2 * d * pairs / PEAK_TF32_FLOPS * 1e3
    t_cuda = (8 + (27 if dropout else 0)) * pairs / PEAK_FP32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "visible_pairs": pairs, "bound_tc_ms": max(t_bytes, t_tc, t_cuda),
            "bound_tc_terms_ms": {"bytes": t_bytes, "tensor_cores": t_tc, "cuda_cores": t_cuda,
                                  "scores_fma": 2 * d * pairs / PEAK_FP32_FLOPS * 1e3}}


def library_attention(q, k, v, mask):
    """One library call for the same function: ``scaled_dot_product_attention``
    with the strict mask (row 0 may see key 0, or its softmax is NaN) and row 0
    zeroed.  Timed here, used nowhere in the port."""
    o = F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=mask)[0]
    o[:, 0] = 0
    return o


def attention_record(qkv, launches: dict, cases, sampler: bool = True) -> dict:
    """Times of the attention kernel at the shape a prior's forward gives it,
    on the prior's own q, k, v, without and with the training forward's
    dropout; with ``sampler``, also its time at the shape of the full-forward
    sampler at 256 px."""
    bh, n, d = qkv[0].shape
    # rotate over copies larger together than the 50 MB L2
    copies = [qkv] + [tuple(t.clone() for t in qkv) for _ in range(2)]
    turn = itertools.count()
    rotating = lambda fn: (lambda: fn(*copies[next(turn) % len(copies)]))   # noqa: E731
    mask = torch.ones(n, n, dtype=torch.bool, device="cuda").tril(-1)
    mask[0, 0] = True
    library = lambda q, k, v: library_attention(q, k, v, mask)             # noqa: E731
    lib_err = float((library(*qkv)[:32] - fa.causal_attention_reference(
        *(t[:32] for t in qkv))).abs().max())
    ms = cuda_ms(rotating(fa.causal_flash_attention_lse), reps=20)
    rate = PRIOR_CONFIG["dropout"]
    dropout_ms = cuda_ms(rotating(lambda q, k, v: fa.causal_flash_attention_lse(
        q, k, v, dropout_rate=rate, seed=0xC0FFEE)), reps=20)
    work = attention_work(bh, n, d, qkv[0].element_size())
    work_drop = attention_work(bh, n, d, qkv[0].element_size(), dropout=True)
    case = cases[0]
    return {
        "name": "causal_flash_attention", **KERNELS["causal_flash_attention"],
        "launches": launches["causal_flash_attention"],
        "max_abs_err": max(case["o_max_abs_err"], case["lse_max_abs_err"]),
        "shape": {"bh": bh, "n": n, "d": d}, "ms": ms, "kernel_ms": ms,
        f"ms_with_dropout_{rate}": dropout_ms,
        "plain_ms": cuda_ms(rotating(plain_attention_in_chunks), reps=3, warmup=1),
        "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
        "bound_tc_ms": work["bound_tc_ms"], "bound_tc_terms_ms": work["bound_tc_terms_ms"],
        f"bound_tc_ms_with_dropout_{rate}": work_drop["bound_tc_ms"],
        "library_ms": cuda_ms(rotating(library), reps=5),
        "library": "F.scaled_dot_product_attention with the strict mask, row 0 zeroed",
        "library_max_abs_err_vs_plain": lib_err,
        "share_of_bound": work["bound_ms"] / ms, "share_of_bound_tc": work["bound_tc_ms"] / ms,
        "bytes": work["bytes"], "flops": work["flops"],
        **({"full_forward_sampler": full_forward_sampler_times()} if sampler else {}),
    }


def full_forward_sampler_times() -> dict:
    """K4 at the shape ``sample.py --full_forward`` gives it at 256 px, batch
    8: one full top-prior forward a position (``models/sampling.py``), four
    attention blocks a forward, 32 x 32 positions; per-launch time on unit
    normal q, k, v of that shape."""
    bh, n = SAMPLE_BATCH * N_HEAD, TOP_HW * TOP_HW
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v = (torch.randn(bh, n, HEAD_DIM, generator=gen, device="cuda") for _ in range(3))
    ms = cuda_ms(lambda: fa.causal_flash_attention_lse(q, k, v), reps=50)
    work = attention_work(bh, n, HEAD_DIM, 4)
    launches = 4 * n
    return {"shape": {"bh": bh, "n": n, "d": HEAD_DIM}, "ms": ms, "bound_ms": work["bound_ms"],
            "bound_tc_ms": work["bound_tc_ms"], "launches_per_top_grid": launches,
            "kernel_ms_per_top_grid": launches * ms}


def stats_work(n: int, d: int, k: int, itemsize: int) -> dict:
    """Least bytes and operations of one statistics call: the lookup's, plus
    csum and esum written once, plus the N*D additions of the sums."""
    w = kernel_work("nearest_code_lookup", n, d, k, itemsize)
    nbytes = w["bytes"] + k * 4 + k * d * 4
    flops = w["flops"] + n * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def library_stats(flat, embed):
    """One library route to the same function: ``cdist`` + ``argmin`` +
    ``bincount`` + ``index_add_`` (timed here, used nowhere in the port)."""
    idx = torch.cdist(flat, embed).argmin(1)
    k, d = embed.shape
    esum = torch.zeros(k, d, device=flat.device).index_add_(0, idx, flat)
    return idx, embed[idx], torch.bincount(idx, minlength=k).float(), esum


def stats_record(flat_t, flat_b, model, launches, stats_cases, gen) -> dict:
    """Times of the statistics kernel at the two shapes a stage-1 train step
    gives it, on the model's own rows, and with every row on one code."""
    per_shape = []
    for flat, embed in ((flat_b, model.quantize_b.embed), (flat_t, model.quantize_t.embed)):
        copies = [flat] + [flat.clone() for _ in range(max(0, 3 - flat.shape[0] // 200000))]
        turn = itertools.count()
        rotating = lambda fn: (lambda: fn(copies[next(turn) % len(copies)], embed))   # noqa: E731
        n = flat.shape[0]
        per_shape.append({
            "shape": {"n": n, "d": D, "k": K},
            "ms": cuda_ms(rotating(lambda f, e: qz.nearest_code(f, e, with_stats=True)), reps=20),
            "plain_ms": cuda_ms(rotating(qz.nearest_code_reference), reps=5),
            "library_ms": cuda_ms(rotating(library_stats), reps=5),
            **stats_work(n, D, K, flat.element_size())})
    one_flat, one_embed = one_code_rows(flat_b.shape[0], gen)
    one = {"shape": {"n": flat_b.shape[0], "d": D, "k": K, "every_row_on_one_code": True},
           "ms": cuda_ms(lambda: qz.nearest_code(one_flat, one_embed, with_stats=True), reps=20),
           "lookup_only_ms": cuda_ms(lambda: qz.nearest_code(one_flat, one_embed, with_stats=False),
                                     reps=20),
           "plain_ms": cuda_ms(lambda: qz.nearest_code_reference(one_flat, one_embed), reps=5)}
    first, case = per_shape[0], stats_cases[1]            # the bottom grid on the model's rows
    return {
        "name": "nearest_code_stats", **KERNELS["nearest_code_stats"],
        "launches": launches["nearest_code_stats"],
        # csum is exact; esum's error against the plain sums of the kernel's own ids
        "max_abs_err": case["esum_max_abs_err_vs_plain_sum"],
        "id_mismatches": case["id_mismatches_vs_plain"],
        "shape": first["shape"], "ms": first["ms"], "kernel_ms": first["ms"],
        "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"], "library_ms": first["library_ms"],
        "library": "torch.cdist + argmin + index + bincount + index_add_",
        "share_of_bound": first["bound_ms"] / first["ms"], "shapes": per_shape,
        "every_row_on_one_code": one,
    }


def backward_work(name: str, bh: int, n: int, d: int, itemsize: int,
                  dropout: bool = False) -> dict:
    """Least bytes and operations of one backward launch over the causal
    half: K5 reads q, k, v, o, do and lse and writes dq and dsum, three
    products; K6 reads q, k, v, do, lse and dsum and writes dk and dv, four.
    ``bound_ms`` at the fp32 rate of the CUDA cores, as for the forward;
    ``bound_tc_ms`` the largest of the bytes' time, three TF32 passes of the
    products (3 x 3 x 2D flops a visible pair for K5, 3 x 4 x 2D for K6) at
    the TF32 rate, and 13 CUDA-core operations a visible pair (the
    probability: scale, subtraction, exponential, mask; dp times the mask,
    minus dsum, times p, times the scale; p times the mask; the TF32 splits of
    p and ds), and under dropout 27 more, as in the forward; ``scores_fma`` as
    in the forward (both round their scores as the forward does)."""
    nbytes = 6 * bh * n * d * itemsize + 2 * bh * n * 4      # the same count for both
    products = 3 if name == "causal_flash_attention_dq" else 4
    flops = products * 2 * bh * n * n * d // 2
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    pairs = bh * n * (n - 1) // 2
    t_tc = 3 * products * 2 * d * pairs / PEAK_TF32_FLOPS * 1e3
    t_cuda = (13 + (27 if dropout else 0)) * pairs / PEAK_FP32_FLOPS * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "visible_pairs": pairs, "bound_tc_ms": max(t_bytes, t_tc, t_cuda),
            "bound_tc_terms_ms": {"bytes": t_bytes, "tensor_cores": t_tc, "cuda_cores": t_cuda,
                                  "scores_fma": 2 * d * pairs / PEAK_FP32_FLOPS * 1e3}}


def backward_launchers(q, k, v, do, dropout_rate: float = 0.0, seed: int = 0):
    """The two backward kernels launched one at a time (for timing, after the
    paths' counts were read), from the forward kernel's ``o`` and ``lse``."""
    o, lse = fa._causal_flash_attention_cuda(q, k, v, dropout_rate, seed)
    d = q.shape[-1]
    q, k, v, o, do = _build.kernel_operands(q, k, v, o, do)  # padded as the wrapper pads them
    _, dsum = fa._backward_dq_cuda(q, k, v, o, lse, do, dropout_rate, seed, d)
    return (lambda: fa._backward_dq_cuda(q, k, v, o, lse, do, dropout_rate, seed, d),
            lambda: fa._backward_dkv_cuda(q, k, v, do, lse, dsum, dropout_rate, seed, d))


def plain_backward_ms(q, k, v, do) -> float:
    """The backward's plain version (dq, dk and dv together), over 32 heads
    at a time, given the forward kernel's ``o`` and ``lse``."""
    o, lse = fa._causal_flash_attention_cuda(q, k, v, 0.0, 0)

    def plain():
        for i in range(0, q.shape[0], 32):
            fa.causal_attention_backward_reference(q[i:i + 32], k[i:i + 32], v[i:i + 32],
                                                   o[i:i + 32], lse[i:i + 32], do[i:i + 32])

    return cuda_ms(plain, reps=3, warmup=1)


def library_backward_ms(q, k, v, do) -> float:
    """The backward of ``scaled_dot_product_attention`` with the strict mask
    (dq, dk and dv together; the forward outside the timer)."""
    n = q.shape[1]
    mask = torch.ones(n, n, dtype=torch.bool, device="cuda").tril(-1)
    mask[0, 0] = True
    rows = torch.ones(n, 1, device="cuda")
    rows[0] = 0.0                          # row 0 zeroed out of place, for the backward
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        lib_o = F.scaled_dot_product_attention(*(t[None] for t in leaves), attn_mask=mask)[0] * rows
        return cuda_ms(lambda: torch.autograd.grad(lib_o, leaves, do, retain_graph=True), reps=5)


def backward_records(qkv, do, launches, backward_cases) -> list:
    """Times of the two backward kernels at the shape the top prior's train
    step gives them at batch 32, on the prior's own q, k, v (q, k, v, o and do
    together are larger than the 50 MB L2), without and with dropout."""
    q, k, v = qkv
    bh, n, d = q.shape
    run_dq, run_dkv = backward_launchers(q, k, v, do)
    ms = {"causal_flash_attention_dq": cuda_ms(run_dq, reps=20),
          "causal_flash_attention_dkv": cuda_ms(run_dkv, reps=20)}
    drop_dq, drop_dkv = backward_launchers(q, k, v, do, PRIOR_CONFIG["dropout"], 0xC0FFEE)
    dropout_ms = {"causal_flash_attention_dq": cuda_ms(drop_dq, reps=20),
                  "causal_flash_attention_dkv": cuda_ms(drop_dkv, reps=20)}
    plain_ms = plain_backward_ms(q, k, v, do)
    library_ms = library_backward_ms(q, k, v, do)
    case = backward_cases[0]
    out = []
    for name, errs in (("causal_flash_attention_dq", ("dq",)),
                       ("causal_flash_attention_dkv", ("dk", "dv"))):
        work = backward_work(name, bh, n, d, q.element_size())
        record = {
            "name": name, **KERNELS[name], "launches": launches[name],
            "max_abs_err": max(case[f"{e}_max_abs_err"] for e in errs),
            "shape": {"bh": bh, "n": n, "d": d}, "ms": ms[name], "kernel_ms": ms[name],
            "ms_with_dropout_0.1": dropout_ms[name],
            "plain_ms": plain_ms, "plain": "causal_attention_backward_reference, dq, dk and dv together",
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
            "library_ms": library_ms,
            "library": "backward of F.scaled_dot_product_attention with the strict mask "
                       "(dq, dk and dv together; forward outside the timer)",
            "share_of_bound": work["bound_ms"] / ms[name], "bytes": work["bytes"],
            "flops": work["flops"]}
        drop = backward_work(name, bh, n, d, q.element_size(), dropout=True)
        record.update({"bound_tc_ms": work["bound_tc_ms"],
                       "bound_tc_terms_ms": work["bound_tc_terms_ms"],
                       "bound_tc_ms_with_dropout_0.1": drop["bound_tc_ms"],
                       "share_of_bound_tc": work["bound_tc_ms"] / ms[name]})
        out.append(record)
    return out


def odd_shape_times() -> dict:
    """Times of the kernels at shapes they once refused, at the main path's
    sizes otherwise: attention at the top prior's B*H = 256, N = 1024 with
    D = 6 (--channel 96), D = 128 (--channel 2048, one wide tile) and D = 136
    (two 128-wide chunks and column groups); the quantizer's three
    kernels at embed_dim 30 (K1, K3 at N = 524,288; K2 at 131,072).  Each
    beside its bound, as in the kernels' records; without dropout, also the
    plain versions' and the library's times (the backward's: dq, dk and dv
    together)."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    out = {"attention": [], "quantizer": []}
    bh, n = PRIOR_BATCH * N_HEAD, TOP_HW * TOP_HW
    for d in (6, 128, 136):
        q, k, v, do = (torch.randn(bh, n, d, generator=gen, device="cuda") for _ in range(4))
        for rate in (0.0, PRIOR_CONFIG["dropout"]):
            run_dq, run_dkv = backward_launchers(q, k, v, do, rate, 0xC0FFEE)
            fwd = lambda: fa.causal_flash_attention_lse(q, k, v, dropout_rate=rate, seed=0xC0FFEE)
            record = {
                "shape": {"bh": bh, "n": n, "d": d}, "dropout_rate": rate,
                "forward_ms": cuda_ms(fwd, reps=10),
                "forward_bound_ms": attention_work(bh, n, d, 4, rate > 0)["bound_ms"],
                "dq_ms": cuda_ms(run_dq, reps=10),
                "dq_bound_ms": backward_work("causal_flash_attention_dq", bh, n, d, 4,
                                             rate > 0)["bound_ms"],
                "dkv_ms": cuda_ms(run_dkv, reps=10),
                "dkv_bound_ms": backward_work("causal_flash_attention_dkv", bh, n, d, 4,
                                              rate > 0)["bound_ms"]}
            if rate == 0.0:
                mask = torch.ones(n, n, dtype=torch.bool, device="cuda").tril(-1)
                mask[0, 0] = True
                record.update({
                    "forward_plain_ms": cuda_ms(lambda: plain_attention_in_chunks(q, k, v),
                                                reps=3, warmup=1),
                    "forward_library_ms": cuda_ms(lambda: library_attention(q, k, v, mask), reps=5),
                    "backward_plain_ms": plain_backward_ms(q, k, v, do),
                    "backward_library_ms": library_backward_ms(q, k, v, do)})
            out["attention"].append(record)
    d = 30
    flat = torch.randn(BATCH * 64 * 64, d, generator=gen, device="cuda")
    small = flat[:BATCH * 32 * 32].clone()
    embed = torch.randn(K, d, generator=gen, device="cuda")
    for name, rows, fn in (("nearest_code_ids", flat, lambda f: qz.nearest_code_ids(f, embed)),
                           ("nearest_code_lookup", small,
                            lambda f: qz.nearest_code(f, embed, with_stats=False)),
                           ("nearest_code_stats", flat,
                            lambda f: qz.nearest_code(f, embed, with_stats=True))):
        work = (stats_work(rows.shape[0], d, K, 4) if name == "nearest_code_stats"
                else kernel_work(name, rows.shape[0], d, K, 4))
        out["quantizer"].append({"name": name, "shape": {"n": rows.shape[0], "d": d, "k": K},
                                 "ms": cuda_ms(lambda: fn(rows), reps=20),
                                 "bound_ms": work["bound_ms"]})
    return out


# The top prior at --channel 2048: attention of channel 1024 in 8 heads, D =
# 128, the widest head the attention kernels take in one tile.  Batches tried
# in turn until one fits the card.  Each wrapper's device time is summed over
# the profiler's events of its wide kernel, which must have run.
WIDE_PRIOR_CHANNEL = 2048
WIDE_PRIOR_BATCHES = (32, 16, 8)
ATTENTION_KERNEL_NAMES = {"causal_flash_attention": "flash_fwd_wide_kernel",
                          "causal_flash_attention_dq": "flash_bwd_dq_wide_kernel",
                          "causal_flash_attention_dkv": "flash_bwd_dkv_wide_kernel"}


def wide_prior_step_times() -> dict:
    """One train step of the top prior at ``--channel 2048`` (D = 128, seeded
    random weights, fp32, dropout 0.1) at the first batch of
    ``WIDE_PRIOR_BATCHES`` that fits: ms a step by the host's clock (mean of
    two after a first step), peak memory, the attention kernels' launches
    in a step (counters), and from ``torch.profiler`` over one more step the
    card's busy time and the device ms of K4, K5 and K6 with their share of
    the step."""
    config = argparse.Namespace(**{**PRIOR_CONFIG, "channel": WIDE_PRIOR_CHANNEL, "bf16": False})
    for batch in WIDE_PRIOR_BATCHES:
        prior = state = step = None
        fits = False
        try:
            torch.manual_seed(0)
            with torch.device("cuda"):
                prior = build_model("top", config, code_hw=(TOP_HW, BOTTOM_HW)).cuda()
            tx = schedules.adam(3e-4)
            state = tv.create_state(prior, tx)
            step = tp.make_train_step(prior, tx, conditional=False)
            codes = {"target": numpy_codes(11, batch, TOP_HW, TOP_HW)}
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_all_counts()
            step(state, codes)
            torch.cuda.synchronize()
            launches = {k: fa.launch_counts[k] for k in ATTENTION_KERNEL_NAMES}
            check(all(launches.values()) and not any(fa.plain_counts.values()),
                  f"wide prior step: kernels launched {launches}, plain {fa.plain_counts}")
            t0 = time.perf_counter()
            for _ in range(2):
                step(state, codes)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 2 * 1e3
            peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(state, codes)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            fits = True
        except torch.cuda.OutOfMemoryError:
            pass
        if not fits:   # freed once the exception (and the frames it holds) is gone
            del prior, state, step
            gc.collect()
            torch.cuda.empty_cache()
            continue
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.device_time_total for e in events) / 1e3
        kernel_ms = {name: sum(e.device_time_total for e in events if sub in e.name) / 1e3
                     for name, sub in ATTENTION_KERNEL_NAMES.items()}
        out = {"channel": WIDE_PRIOR_CHANNEL, "head_dim": WIDE_PRIOR_CHANNEL // 2 // N_HEAD,
               "batch": batch, "grid": [TOP_HW, TOP_HW], "dtype": "float32",
               "dropout": PRIOR_CONFIG["dropout"], "ms": ms, "peak_memory_gb": peak_gb,
               "kernel_launches_per_step": launches,
               "profiled_step": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                                 "kernel_device_ms": kernel_ms}}
        if busy_ms > 0:
            check(all(kernel_ms.values()),
                  f"wide prior step: a wide attention kernel took no device time: {kernel_ms}")
            out["profiled_step"].update(
                k4_k6_share_of_busy=sum(kernel_ms.values()) / busy_ms,
                k4_k6_share_of_wall=sum(kernel_ms.values()) / wall_ms)
        else:
            out["profiled_step"]["k4_k6_share_of_busy"] = (
                "not measured: the profiler recorded no device time")
        del prior, state, step, prof, events
        gc.collect()
        torch.cuda.empty_cache()
        return out
    raise RuntimeError(f"the top prior at --channel {WIDE_PRIOR_CHANNEL} fits no batch of "
                       f"{WIDE_PRIOR_BATCHES} on this card")


def train_step_times(dirs: dict) -> dict:
    """One train step of each trainer at its command line's batch, fp32 then
    bf16 from the same fp32-run weights, by the host's clock around steps that
    end in a synchronise, on batches already on the card; peak memory of
    each."""
    out = {"stage1": {}, "top_prior": {}, "bottom_prior": {}}
    vq_state = CheckpointManager(dirs["vqvae"]).restore("last")["model"]
    x = torch.from_numpy(np.random.default_rng(8).normal(
        scale=0.5, size=(TRAIN_BATCH["vqvae"], SIZE, SIZE, 3)).astype(np.float32)).cuda()
    for dtype in (torch.float32, BF16):
        vq = build_vqvae(device="cuda", seed=0, dtype=dtype)
        vq.load_state_dict(vq_state)
        tx = schedules.adam(3e-4)
        state = tv.create_state(vq, tx)
        step = tv.make_train_step(vq, tx)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = host_ms(lambda: step(state, x), 5)
        out["stage1"][str(dtype)[6:]] = {
            "batch": TRAIN_BATCH["vqvae"], "size": SIZE, "ms": ms,
            "img_per_s": TRAIN_BATCH["vqvae"] / ms * 1e3,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        del vq, state, step
    for hier, hw in (("top", TOP_HW), ("bottom", BOTTOM_HW)):
        weights = CheckpointManager(dirs[hier]).restore("last")["model"]
        batch = {"target": numpy_codes(9, TRAIN_BATCH[hier], hw, hw)}
        if hier == "bottom":
            batch["condition"] = numpy_codes(10, TRAIN_BATCH[hier], TOP_HW, TOP_HW)
        for dtype in (torch.float32, BF16):
            prior = build_model(hier, argparse.Namespace(**{**PRIOR_CONFIG,
                                                            "bf16": dtype == BF16}),
                                code_hw=(TOP_HW, BOTTOM_HW)).cuda()
            prior.load_state_dict(weights)
            tx = schedules.adam(3e-4)
            state = tv.create_state(prior, tx)
            step = tp.make_train_step(prior, tx, conditional=hier == "bottom")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ms = host_ms(lambda: step(state, batch), 3)
            out[f"{hier}_prior"][str(dtype)[6:]] = {
                "batch": TRAIN_BATCH[hier], "grid": [hw, hw], "ms": ms,
                "grids_per_s": TRAIN_BATCH[hier] / ms * 1e3,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
            del prior, state, step
    torch.cuda.empty_cache()
    return out


def phase_times(model, x, flat_t, flat_b, launches, cases, top, attention_qkv,
                attention_cases, stats_cases, attention_do, backward_cases, dirs) -> dict:
    calls = {
        "nearest_code_ids": (lambda f, e: qz.nearest_code_ids(f, e),
                             qz.nearest_code_ids_reference,
                             lambda f, e: torch.cdist(f, e).argmin(1)),
        "nearest_code_lookup": (lambda f, e: qz.nearest_code(f, e, with_stats=False),
                                qz.nearest_code_lookup_reference,
                                lambda f, e: e[torch.cdist(f, e).argmin(1)]),
    }
    # the shape each kernel gets from encode_ids at batch 128 comes first
    shapes = {"nearest_code_ids": (flat_b, flat_t), "nearest_code_lookup": (flat_t, flat_b)}
    embeds = {flat_t.shape[0]: model.quantize_t.embed, flat_b.shape[0]: model.quantize_b.embed}
    by_n = {c["n"]: c for c in cases[:2]}
    records = []
    for name, (kernel, plain, library) in calls.items():
        per_shape = []
        for flat in shapes[name]:
            n = flat.shape[0]
            embed = embeds[n]
            # rotate over copies larger together than the 50 MB L2, as the
            # caller's rows are not all cached when the kernel starts
            copies = [flat] + [flat.clone() for _ in range(max(0, 3 - n // 200000))]
            turn = itertools.count()
            rotating = lambda fn: (lambda: fn(copies[next(turn) % len(copies)], embed))
            ms = cuda_ms(rotating(kernel), reps=20)
            per_shape.append({
                "shape": {"n": n, "d": D, "k": K}, "ms": ms,
                "plain_ms": cuda_ms(rotating(plain), reps=5),
                "library_ms": cuda_ms(rotating(library), reps=5),
                **kernel_work(name, n, D, K, flat.element_size()),
            })
        # max_abs_err, on the model's own rows at the first shape: an id has no
        # error to speak of, so it is the largest gap between the plain scores
        # of a differing pair of ids (0.0 when all ids agree), and for the
        # lookup also the largest |q - embed[idx]| (0.0: bit-equal)
        first = per_shape[0]
        case = by_n[first["shape"]["n"]]
        records.append({
            "name": name, **KERNELS[name], "launches": launches[name],
            "max_abs_err": max(case["q_max_abs_err"], case["largest_gap"])
            if name == "nearest_code_lookup" else case["largest_gap"],
            "id_mismatches": case["id_mismatches"],
            "shape": first["shape"], "ms": first["ms"], "kernel_ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"],
            "library": "torch.cdist + argmin" + (" + index" if name.endswith("lookup") else ""),
            "share_of_bound": first["bound_ms"] / first["ms"], "shapes": per_shape,
        })

    records.insert(2, stats_record(flat_t, flat_b, model, launches, stats_cases,
                                   torch.Generator(device="cuda").manual_seed(3)))
    records.append(attention_record(attention_qkv, launches, attention_cases))
    records.extend(backward_records(attention_qkv, attention_do, launches, backward_cases))

    torch.cuda.reset_peak_memory_stats()
    enc_ms = host_ms(lambda: model.encode_ids(x), 5)
    fwd_ms = host_ms(lambda: model(x), 3)
    stage1_gb = torch.cuda.max_memory_allocated() / 2 ** 30              # of these two
    torch.cuda.reset_peak_memory_stats()
    codes = numpy_codes(2, PRIOR_BATCH, TOP_HW, TOP_HW)
    top_ms = host_ms(lambda: top(codes), 3)
    top_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.enable_grad():
        train_steps = train_step_times(dirs)
    emit("times_odd_shapes", **odd_shape_times())
    with torch.enable_grad():
        emit("wide_prior_step", **wide_prior_step_times())
    emit("times", batch=BATCH, size=SIZE, encode_ids_ms=enc_ms,
         encode_ids_img_per_s=BATCH / enc_ms * 1e3, forward_ms=fwd_ms,
         forward_img_per_s=BATCH / fwd_ms * 1e3, peak_memory_gb=stage1_gb,
         top_prior_forward={"batch": PRIOR_BATCH, "grid": [TOP_HW, TOP_HW], "ms": top_ms,
                            "grids_per_s": PRIOR_BATCH / top_ms * 1e3, "peak_memory_gb": top_gb},
         train_step=train_steps,
         kernels={r["name"]: {"ms": r["ms"], "bound_ms": r["bound_ms"],
                              "plain_ms": r["plain_ms"], "library_ms": r["library_ms"]}
                  for r in records})
    return {"kernels": records}


def phase_breakdown(model, x) -> None:
    """Stage times of one ``encode_ids`` at batch 128, by CUDA events around
    each sub-module (optional; not part of the default run)."""
    marks = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    stages = [("enc_b", model.enc_b), ("enc_t", model.enc_t),
              ("quantize_conv_t", model.quantize_conv_t), ("quantize_t (K2)", model.quantize_t),
              ("dec_t", model.dec_t), ("quantize_conv_b", model.quantize_conv_b)]
    layers = [(f"enc_b.blocks.{i} {type(m).__name__}", m)
              for i, m in enumerate(model.enc_b.blocks)]
    hooks = []
    for label, mod in stages + layers:
        hooks.append(mod.register_forward_pre_hook(lambda m, a, l=label: mark(f"{l}:start")))
        hooks.append(mod.register_forward_hook(lambda m, a, o, l=label: mark(f"{l}:end")))
    model.encode_ids(x)
    torch.cuda.synchronize()
    marks.clear()
    mark("start")
    model.encode_ids(x)
    mark("end")
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    at = {label: marks[0][1].elapsed_time(ev) for label, ev in marks}
    out = {label: at[f"{label}:end"] - at[f"{label}:start"] for label, _ in stages}
    out["quantize_b.codes (K1)"] = at["end"] - at["quantize_conv_b:end"]
    out["total"] = at["end"]
    out["other (cat, permutes, gaps)"] = out["total"] - sum(
        v for k, v in out.items() if k != "total")
    inside = {label: at[f"{label}:end"] - at[f"{label}:start"] for label, _ in layers}
    emit("breakdown", batch=BATCH, unit="ms", stages=out, enc_b_layers=inside)


def phase_breakdown_stage2(top) -> None:
    """Optional: where one forward of the top prior at batch 32 spends its
    time (CUDA events around the sub-modules, summed over the four blocks),
    and how busy the card is during incremental sampling (``torch.profiler``
    over 32 steps of the top prior's decoder at batch 8)."""
    from vqvae2_tpu_torch.models import incremental as inc
    from vqvae2_tpu_torch.models.sampling import draw_codes

    marks = []
    pool = [torch.cuda.Event(enable_timing=True) for _ in range(256)]   # made ahead of the run

    def mark(label):
        ev = pool[len(marks)]
        ev.record()
        marks.append((label, ev))

    parts = [("input convolutions", [top.horizontal, top.vertical]),
             ("causal res blocks (5x5)", [r for b in top.blocks for r in b.res]),
             ("key and query res blocks (1x1)",
              [m for b in top.blocks for m in (b.key_resblock, b.query_resblock)]),
             ("attention: q, k, v layers and the kernel", [b.causal_attention for b in top.blocks]),
             ("out res blocks (1x1)", [b.out_resblock for b in top.blocks]),
             ("out convolution", [top.out_conv])]
    hooks = []
    for label, modules in parts:
        for mod in modules:
            hooks.append(mod.register_forward_pre_hook(lambda m, a, l=label: mark((l, 0))))
            hooks.append(mod.register_forward_hook(lambda m, a, o, l=label: mark((l, 1))))
    codes = numpy_codes(2, PRIOR_BATCH, TOP_HW, TOP_HW)
    top(codes)
    torch.cuda.synchronize()
    marks.clear()
    first, last = pool.pop(), pool.pop()
    first.record()
    top(codes)
    last.record()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    out = {label: 0.0 for label, _ in parts}
    out["total"] = first.elapsed_time(last)
    opened = {}
    for (label, end), ev in marks:
        if end:
            out[label] = out.get(label, 0.0) + opened.pop(label).elapsed_time(ev)
        else:
            opened[label] = ev
    out["other (one-hot, shifts, concatenations, gaps)"] = out["total"] - sum(
        v for k, v in out.items() if k != "total")

    pp = inc.resolve_params(top)
    caches = inc._make_caches(top, SAMPLE_BATCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps, width = 32, top.shape[1]

    def decode(first):
        for t in range(first, first + steps):
            i, j = divmod(t, width)
            draw = draw_codes(inc._step_logits(top, pp, caches, i, j, t, None), 1.0, gen)
            inc._write_code(top, caches, i, j, draw)

    decode(0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in device_events) / 1e3
    sampler = {"steps": steps, "batch": SAMPLE_BATCH, "wall_ms_per_step": wall_ms / steps,
               "profiler": "on (host times include its overhead)"}
    if device_events and busy_ms > 0:
        sampler.update(device_kernels_per_step=len(device_events) / steps,
                       device_busy_ms_per_step=busy_ms / steps,
                       device_idle_share=1.0 - busy_ms / wall_ms)
    else:
        sampler["device_idle_share"] = "not measured: the profiler recorded no device time"
    emit("breakdown_stage2", top_forward_ms={"batch": PRIOR_BATCH, **out},
         incremental_top_sampler=sampler)


def phase_breakdown_train(dirs: dict) -> None:
    """Optional: where one train step of stage 1 (batch 128) and of the top
    prior (batch 32) spends its time, in fp32 and in bf16 compute from the
    same weights, by CUDA events: the model's forward (with the EMA step and
    the statistics kernel inside it for stage 1, the attention forward kernel
    for the prior), the loss and backward (with the two backward kernels),
    the optimizer; and the kernels' own spans."""
    pool = [torch.cuda.Event(enable_timing=True) for _ in range(512)]
    marks = []

    def mark(label):
        ev = pool[len(marks)]
        ev.record()
        marks.append((label, ev))

    def timed(fn, label):
        def inner(*args, **kw):
            mark((label, 0))
            out = fn(*args, **kw)
            mark((label, 1))
            return out
        return inner

    from vqvae2_tpu_torch.models.vqvae import Quantize

    patches = [(qz, "_nearest_code_stats_cuda", "K3 (statistics kernel)"),
               (Quantize, "_ema_update", "EMA update of the codebooks"),
               (fa, "_causal_flash_attention_cuda", "K4 (attention forward)"),
               (fa, "_causal_flash_attention_backward_cuda", "K5 + K6 (attention backward)")]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]

    def measure(model, step, state, batch):
        hooks = [model.register_forward_pre_hook(lambda m, a: mark(("forward", 0))),
                 model.register_forward_hook(lambda m, a, o: mark(("forward", 1)))]
        opt_step = state.optimizer.step
        state.optimizer.step = timed(opt_step, "optimizer")
        step(state, batch)                          # warm-up
        torch.cuda.synchronize()
        marks.clear()
        mark(("step", 0))
        step(state, batch)
        mark(("step", 1))
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        state.optimizer.step = opt_step
        spans, opened = {}, {}
        for (label, end), ev in marks:
            if end:
                spans[label] = spans.get(label, 0.0) + opened.pop(label).elapsed_time(ev)
            else:
                opened[label] = ev
        at = {label: ev for label, ev in marks}
        spans["loss and backward"] = at[("forward", 1)].elapsed_time(at[("optimizer", 0)])
        spans["total"] = spans.pop("step")
        return spans

    out = {}
    try:
        for owner, name, label in patches:
            setattr(owner, name, timed(getattr(owner, name), label))
        with torch.enable_grad():
            for bf16 in (False, True):
                suffix = "_bf16" if bf16 else ""
                vq = build_vqvae(device="cuda", seed=0, dtype=BF16 if bf16 else torch.float32)
                vq.load_state_dict(CheckpointManager(dirs["vqvae"]).restore("last")["model"])
                tx = schedules.adam(3e-4)
                x = torch.from_numpy(np.random.default_rng(8).normal(
                    scale=0.5, size=(TRAIN_BATCH["vqvae"], SIZE, SIZE, 3)).astype(np.float32)).cuda()
                out["stage1_step" + suffix] = {"batch": TRAIN_BATCH["vqvae"], **measure(
                    vq, tv.make_train_step(vq, tx), tv.create_state(vq, tx), x)}
                del vq, x
                top = build_model("top", argparse.Namespace(**{**PRIOR_CONFIG, "bf16": bf16}),
                                  code_hw=(TOP_HW, BOTTOM_HW)).cuda()
                top.load_state_dict(CheckpointManager(dirs["top"]).restore("last")["model"])
                tx = schedules.adam(3e-4)
                batch = {"target": numpy_codes(9, TRAIN_BATCH["top"], TOP_HW, TOP_HW)}
                out["top_prior_step" + suffix] = {"batch": TRAIN_BATCH["top"], **measure(
                    top, tp.make_train_step(top, tx, conditional=False),
                    tv.create_state(top, tx), batch)}
                del top
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    emit("breakdown_train", unit="ms", **out)


def phase_repeatability(model, x, calls: int = 6) -> None:
    """Optional: how far two calls on the same batch agree, with cuDNN free to
    pick non-deterministic algorithms and with it held to deterministic ones
    (what ``set_reference_precision`` sets), and what each costs."""
    out = {}
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        base = model.encode(x)
        base_rows = capture_quantizer_inputs(model, x)[1]
        flips, moved = [], 0.0
        for _ in range(calls):
            again = model.encode(x)
            flips.append(int((again[3] != base[3]).sum() + (again[4] != base[4]).sum()))
            moved = max(moved, float(
                (capture_quantizer_inputs(model, x)[1] - base_rows).abs().max()))
        out["deterministic" if deterministic else "default"] = {
            "ids_flipped_per_call": flips, "ids": base[3].numel() + base[4].numel(),
            "bottom_rows_max_abs_diff": moved,
            "encode_ids_ms": host_ms(lambda: model.encode_ids(x), 5),
            "forward_ms": host_ms(lambda: model(x), 5)}
    check(not any(out["deterministic"]["ids_flipped_per_call"]),
          f"ids are not repeatable under deterministic cuDNN: {out['deterministic']}")
    emit("repeatability", batch=BATCH, **out)


# ---------------------------------------------------------------------------
# the ReID + part-parsing path: the ABN kernels (K7, K8), EmbedNet2 and its
# trainer
# ---------------------------------------------------------------------------

REID_ARCH = "resnet50"
REID_HW = (288, 144)            # train/reid.py's IMG_H, IMG_W
REID_P, REID_K = 6, 4           # the command line's --batch_size and --num_pos
REID_ROWS = REID_P * REID_K     # loader rows a step; three modalities of images each
REID_EVAL_BATCH = 50            # eval/reid.py's test_batch
REID_STEPS = 10
REID_IDS = 8                    # make_synthetic_sysu's identities
N_ABN = 13                      # in-place ABNs in one EmbedNet2 forward
# The ABN kernels against their plain versions: fp32 as the JAX package holds
# its own fused op (one product and one add in another order, FMA-contracted on
# the card); bf16 outputs may round to the neighbouring bf16 value (the
# attention kernels' bf16 tolerance).  The backward's sums against a float64 sum of the same
# terms: each within this fraction of the sum of its terms' magnitudes.
ABN_TOL = dict(atol=1e-5, rtol=1e-5)
ABN_TOL_BF16 = FA_TOL_BF16
ABN_SUM_RTOL = 1e-5
# The card-vs-CPU ReID step is taken at 128x64: at 96x48 the fp32 gradient of
# a few trunk tensors moves by up to 6.5e-2 of their size with the rounding
# alone (the port's own fp32 against its float64 backward on the CPU), at
# 128x64 by at most 1.5e-3 (1.8e-2 with this step's seed).  GRAD_RTOL (each
# tensor within 1e-3 of its largest element) is not met there: single
# tensors differ between card and CPU by up to 1.07e-1 of their size
# (trunk.layer4.0.conv1, which lies as far from the float64 backward), while
# each group's gradient agrees within 3.5e-3 of its norm (one NVIDIA H100
# 80GB HBM3, 700 W).
# The check holds each learning-rate group's gradient, as one vector, to
# REID_GRAD_NORM_RTOL of its norm, and reports the worst tensors beside the
# CPU's own distance from a float64 backward.
REID_GRAD_NORM_RTOL = 1e-2
REID_SMALL_HW = (128, 64)


def capture_abn_inputs(model, batch) -> list:
    """The rows each of the 13 in-place ABNs of ``model`` gets in a train-mode
    forward of ``batch``, in call order: ``(name, x (M, C))``."""
    from vqvae2_tpu_torch.models.abn import InPlaceABN

    seen, hooks = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, InPlaceABN):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, args, name=name: seen.append(
                    (name, args[0].detach().reshape(-1, args[0].shape[-1]).contiguous()))))
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        model.train()(xRGB=batch["rgb"], xIR=batch["ir"], xZ=batch["gray"], modal=0,
                      generator=gen)
    for h in hooks:
        h.remove()
    return seen


def abn_vectors(c: int, gen: torch.Generator, x: torch.Tensor, shift_offset: float = 0.0) -> dict:
    """Per-channel vectors as InPlaceABN builds them from ``x``'s moments and
    a weight of either sign."""
    w = torch.randn(c, generator=gen, device="cuda")
    b = 0.3 * torch.randn(c, generator=gen, device="cuda") + shift_offset
    mean, var = ia.batch_moments(x)
    w_t, rstd = w.abs() + 1e-5, torch.rsqrt(var + 1e-5)
    return {"mean": mean, "var": var, "w_t": w_t, "shift": b,
            "scale": (rstd * w_t).contiguous(), "mul": (w_t * rstd).contiguous()}


def float64_sums(z, dz, b, w_t, activation):
    """edz, eydz summed in float64 over the fp32 terms the kernel sums, and the
    sums of their terms' magnitudes."""
    y, dy = ia.act_invert(z.float(), dz.float(), activation, 0.01)
    dy, prod = dy.double(), ((y - b) / w_t * dy).double()
    return dy.sum(0), prod.sum(0), dy.abs().sum(0), prod.abs().sum(0)


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def compare_abn_with_plain(x, label, gen, activation=ia.ACT_LEAKY_RELU, training=True,
                           shift_offset: float = 0.0, misalign: bool = False) -> dict:
    """K7 on ``x`` and K8 on its output against their plain versions; K8
    twice, bit for bit; its sums against a float64 sum.  ``misalign``: K8
    reads z and dz from copies off a 16-byte boundary."""
    m, c = x.shape
    v = abn_vectors(c, gen, x.float(), shift_offset)
    mean, scale, shift, w_t, mul = v["mean"], v["scale"], v["shift"], v["w_t"], v["mul"]
    z = ia.abn_forward(x, mean, scale, shift, activation)
    z_plain = ia.abn_forward_reference(x, mean, scale, shift, activation)
    tol = ABN_TOL if x.dtype == torch.float32 else ABN_TOL_BF16
    z_err = float((z.float() - z_plain.float()).abs().max())
    check(bool(torch.allclose(z.float(), z_plain.float(), **tol)),
          f"{label}: K7 differs from its plain version by {z_err}")
    dz = (1e-3 * torch.randn(m, c, generator=gen, device="cuda")).to(x.dtype)
    if misalign:
        z, dz = misaligned(z), misaligned(dz)
    inv = 1.0 / m if training else 0.0
    first = ia.abn_backward(z, dz, shift, w_t, mul, inv, training, activation)
    again = ia.abn_backward(z, dz, shift, w_t, mul, inv, training, activation)
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip(first, again))
    check(repeat, f"{label}: a second K8 launch gave other results")
    dx, edz, eydz = first
    dx_plain, edz_plain, eydz_plain = ia.abn_backward_reference(z, dz, shift, w_t, mul, inv,
                                                                training, activation)
    check(bool(torch.isfinite(dx.float()).all() and torch.isfinite(edz).all()
               and torch.isfinite(eydz).all()), f"{label}: K8 gave non-finite values")
    # the scale of dx's terms: at M = 1 (or a channel that is constant) dx is
    # zero in exact arithmetic and both sides hold rounding noise
    scale_dx = max(float(dx_plain.float().abs().max()),
                   float(dz.float().abs().max() * mul.abs().max()), 1e-30)
    dx_err = float((dx.float() - dx_plain.float()).abs().max())
    check(bool(torch.allclose(dx.float(), dx_plain.float(), rtol=tol["rtol"],
                              atol=tol["atol"] * scale_dx)),
          f"{label}: K8's dx differs from its plain version by {dx_err} (scale {scale_dx})")
    sums = {}
    if training and m > 1:
        # (at M = 1 every yhat is zero in exact arithmetic: eydz's terms are the
        # inversion's rounding on either side, and dx is checked above)
        e64, y64, e_mag, y_mag = float64_sums(z, dz, shift, w_t, activation)
        for name, got, want, mag in (("edz", edz, e64, e_mag), ("eydz", eydz, y64, y_mag)):
            err = (got.double() - want).abs()
            rel = float((err / mag.clamp_min(1e-30)).max())
            check(bool((err <= ABN_SUM_RTOL * mag + 1e-30).all()),
                  f"{label}: {name} off a float64 sum by {rel} of its terms' magnitude")
            sums[f"{name}_max_rel_err_vs_float64"] = rel
    elif not training:
        check(not edz.any() and not eydz.any(), f"{label}: eval mode must give zero sums")
    return {"case": label, "m": m, "c": c, "dtype": str(x.dtype), "activation": activation,
            "training": training, "z_max_abs_err": z_err, "z_max": float(z.float().max()), "dx_max_abs_err": dx_err,
            "dx_scale": scale_dx, "sums_bit_repeatable": repeat,
            "edz_max_abs_err_vs_plain": float((edz - edz_plain).abs().max()),
            "eydz_max_abs_err_vs_plain": float((eydz - eydz_plain).abs().max()), **sums}


def abn_awkward_cases(gen: torch.Generator):
    def normal(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    for act in (ia.ACT_LEAKY_RELU, ia.ACT_ELU, ia.ACT_NONE):
        yield f"M=1 C=48 {act}", normal(1, 48), act, True, 0.0
        yield f"M=7 C=3 {act}", normal(7, 3), act, True, 0.0
        yield f"M=1031 C=48 {act}", normal(1031, 48), act, True, 0.0
        yield f"M=513 C=256 bf16 {act}", normal(513, 256).to(torch.bfloat16), act, True, 0.0
        yield f"M=5000 C=3 bf16 {act}", normal(5000, 3).to(torch.bfloat16), act, True, 0.0
        yield f"eval M=2592 C=48 {act}", normal(2592, 48), act, False, 0.0
    # a shift of -40 puts every pre-activation far below zero: elu saturates
    # onto -1 exactly, where the inversion must clamp to stay finite
    yield "elu asymptote", normal(4096, 48), ia.ACT_ELU, True, -40.0
    yield "elu asymptote bf16", normal(4096, 48).to(torch.bfloat16), ia.ACT_ELU, True, -40.0


def reid_batch(seed: int, p: int, k: int, hw, n_ids: int):
    """A collated part-mode P×K batch (``p * k`` loader rows, three images
    each) from a synthetic SYSU tree, on the card."""
    from vqvae2_tpu_torch.data.sysu import SYSUData
    from vqvae2_tpu_torch.train import reid as tr

    with tempfile.TemporaryDirectory() as d:
        tr.make_synthetic_sysu(d, n_ids=n_ids, per_id=8, h=hw[0], w=hw[1], seed=seed)
        ds = SYSUData(d, part=True, seed=seed)
        ds.samplize(p, k)
        items = [ds[i] for i in range(p * k)]
    return tr.to_device(tr.collate(items, hw), "cuda")


def phase_abn_kernels() -> list:
    """K7 and K8 against their plain versions at the inputs of the 13 ABNs of
    EmbedNet2(resnet50) on a train-mode batch of 72 images at 288x144, and at
    awkward shapes."""
    from vqvae2_tpu_torch.part.part_model import EmbedNet2

    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        model = EmbedNet2(class_num=REID_IDS, arch=REID_ARCH).cuda()
    inputs = capture_abn_inputs(model, reid_batch(4, REID_P, REID_K, REID_HW, REID_IDS))
    del model
    check(len(inputs) == N_ABN, f"EmbedNet2 ran {len(inputs)} ABNs, not {N_ABN}")
    cases = [compare_abn_with_plain(x, f"main path {name}", gen) for name, x in inputs]
    for label, x, act, training, offset in abn_awkward_cases(gen):
        cases.append(compare_abn_with_plain(x, label, gen, act, training, offset))
    for c in WIDE_ABN_CHANNELS:
        x = torch.randn(3000, c, generator=gen, device="cuda")
        cases.append(through_kernels(
            ("abn_forward", "abn_backward"),
            lambda: compare_abn_with_plain(x, f"wide M=3000 C={c}", gen)))
    # K8 on z and dz off a 16-byte boundary (the generic route), fp32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(4097, 48, generator=gen, device="cuda").to(dtype)
        cases.append(through_kernels(
            ("abn_forward", "abn_backward"),
            lambda: compare_abn_with_plain(x, f"misaligned M=4097 C=48 {dtype}", gen,
                                           misalign=True)))
    for cs in cases:
        if cs["case"].startswith("elu asymptote"):
            check(cs["z_max"] == -1.0, f"{cs['case']}: z did not saturate onto -1 ({cs['z_max']})")
    shapes = [(name, list(x.shape)) for name, x in inputs]
    emit("abn_kernels", tol=ABN_TOL, tol_bf16=ABN_TOL_BF16, sum_rtol=ABN_SUM_RTOL,
         main_path_shapes=shapes, cases=cases)
    return cases, inputs


def write_raw_sysu(root: str, n_ids: int = REID_IDS, per_cam: int = 2, hw=(64, 32),
                   seed: int = 0) -> str:
    """A raw SYSU-MM01 tree: ``cam1..cam6/<id>/<n>.jpg`` and ``exp/test_id.txt``."""
    g = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "exp"))
    with open(os.path.join(root, "exp", "test_id.txt"), "w") as f:
        f.write(",".join(str(i) for i in range(1, n_ids + 1)) + "\n")
    for cam in range(1, 7):
        for pid in range(1, n_ids + 1):
            d = os.path.join(root, f"cam{cam}", f"{pid:04d}")
            os.makedirs(d)
            for k in range(per_cam):
                Image.fromarray(g.integers(0, 255, size=(*hw, 3)).astype(np.uint8)).save(
                    os.path.join(d, f"{k:04d}.jpg"))
    return root


def count_forwards(cls):
    """A counter of ``cls`` forwards anywhere in the process: ``(counts, handle)``."""
    counts = {"forwards": 0}

    def hook(module, args, out):
        if isinstance(module, cls):
            counts["forwards"] += 1

    return counts, torch.nn.modules.module.register_module_forward_hook(hook)


def reid_step_against_cpu() -> dict:
    """One ReID train step of resnet18 at 128x64, P = K = 2, on the card and
    on the CPU from the same weights and batch (``reid_grads``): the metrics
    within LOGITS_TOL; the gradient of each learning-rate group, as one
    vector, within REID_GRAD_NORM_RTOL of its norm.  Reports the tensors that
    differ most beside the CPU's own distance from a float64 backward, which
    shows how ill-conditioned they are."""
    from vqvae2_tpu_torch.part import part_model as pm
    from vqvae2_tpu_torch.train.reid import param_group

    batch = reid_batch(5, 2, 2, REID_SMALL_HW, 3)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        cpu = pm.EmbedNet2(class_num=3, arch="resnet18")
    step = lambda dtype, device: reid_grads(cpu, batch, 2, 2, REID_SMALL_HW, dtype, device)  # noqa: E731
    (m_gpu, g_gpu), (m_cpu, g_cpu) = step(torch.float32, "cuda"), step(torch.float32, "cpu")
    _, g64 = step(torch.float64, "cpu")
    for k in m_cpu:
        check(bool(np.isclose(m_gpu[k], m_cpu[k], rtol=LOGITS_TOL["rtol"], atol=LOGITS_TOL["atol"])),
              f"ReID card vs CPU step: {k} {m_gpu[k]} vs {m_cpu[k]}")
    groups = {}
    for name in g_cpu:
        groups.setdefault(param_group(name), []).append(name)
    norm_err = {}
    for group, names in groups.items():
        err = sum(float(((g_gpu[n] - g_cpu[n]) ** 2).sum()) for n in names) ** 0.5
        norm = sum(float((g_cpu[n] ** 2).sum()) for n in names) ** 0.5
        norm_err[group] = err / norm
        check(err <= REID_GRAD_NORM_RTOL * norm,
              f"ReID card vs CPU step: the {group} gradient differs by {err / norm} of its norm")
    worst = sorted(((relative_error(g_gpu[n], g_cpu[n]), n) for n in g_cpu), reverse=True)[:5]
    return {"arch": "resnet18", "hw": list(REID_SMALL_HW), "p": 2, "k": 2,
            "metrics_card": m_gpu, "metrics_cpu": m_cpu, "grad_norm_rel_err": norm_err,
            "worst_tensors": [{"name": n, "card_vs_cpu": e,
                               "cpu_fp32_vs_float64": relative_error(g_cpu[n], g64[n]),
                               "card_vs_float64": relative_error(g_gpu[n], g64[n])}
                              for e, n in worst]}


# ---------------------------------------------------------------------------
# cuDNN's convolution algorithms and the ReID weight gradients
# ---------------------------------------------------------------------------

# The float64 backward on the CPU takes a smaller batch at the full image size
# (P = K = 2: 12 images, not the command line's 72; in float64 the full batch
# would need about twice the card's 47.6 GB fp32 peak).
REID_F64_P, REID_F64_K = 2, 2
# A convolution's weight gradient counts as one that cuDNN's route puts off
# when, against the float64 backward, it lies further than GRAD_RTOL and more
# than CUDNN_FACTOR times as far as the same step with cuDNN disabled (PyTorch's
# own im2col + cuBLAS route in true fp32) puts it.
CUDNN_FACTOR = 4.0
# kernel names of cuDNN's convolution engines (none of PyTorch's native route)
CUDNN_KERNEL = r"fft|cudnn|convolve|wgrad|dgrad|fprop|DSE::"


class _RangeEdge(torch.autograd.Function):
    """The identity, whose backward opens (``opens``) or closes a profiler
    range: one pair around a convolution spans its backward.  The autograd
    engine runs nodes by falling sequence number, so the convolution's
    backward node runs right after the opening edge, and the closing edge (on
    its weight, made just before it) right after that."""

    @staticmethod
    def forward(ctx, x, ranges: dict, name: str, opens: bool):
        ctx.ranges, ctx.name, ctx.opens = ranges, name, opens
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        stack = ctx.ranges.setdefault(ctx.name, [])
        if ctx.opens:
            rf = torch.profiler.record_function(ctx.name)
            rf.__enter__()
            stack.append(rf)
        elif stack:
            stack.pop().__exit__(None, None, None)
        return grad, None, None, None


class _ConvWithoutCudnn(torch.autograd.Function):
    """``F.conv2d`` on NCHW whose forward and backward both run with cuDNN
    disabled.  The backward picks its route when it runs, so a scope around
    the forward alone would leave the weight gradient to cuDNN."""

    @staticmethod
    def forward(ctx, x, weight, bias, conv):
        ctx.save_for_backward(x, weight)
        ctx.conv, ctx.has_bias = conv, bias is not None
        with cudnn_disabled():
            return F.conv2d(x, weight, bias, conv.stride, conv.padding, conv.dilation, conv.groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        c = ctx.conv
        with cudnn_disabled():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if ctx.has_bias else None, c.stride,
                c.padding, c.dilation, False, [0, 0], c.groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                 ctx.has_bias and ctx.needs_input_grad[2]])
        return gx, gw, gb, None


class cudnn_disabled:
    """``torch.backends.cudnn.enabled = False`` inside, restored after; the
    other cuDNN and TF32 flags are left as they are."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False

    def __exit__(self, *exc):
        torch.backends.cudnn.enabled = self.saved


def reid_convs(model) -> dict:
    from vqvae2_tpu_torch.models.resnet import Conv2d

    return {name: m for name, m in model.named_modules() if isinstance(m, Conv2d)}


def patch_convs(model, ranges=None, without_cudnn=(), shapes=None) -> None:
    """Every convolution of ``model`` labelled for the profiler (``forward
    <name>`` around its forward, ``backward <name>`` around its backward) when
    ``ranges`` is a dict, and run with cuDNN disabled when its name is in
    ``without_cudnn``; ``shapes`` collects each one's input shape."""

    def forward(conv, name, x):
        if shapes is not None:
            shapes.setdefault(name, list(x.shape))
        w = conv.weight
        if ranges is not None:
            w = _RangeEdge.apply(w, ranges, f"backward {name}", False)
        with torch.profiler.record_function(f"forward {name}"):
            xp = x.permute(0, 3, 1, 2)
            if name in without_cudnn:
                y = _ConvWithoutCudnn.apply(xp, w, conv.bias, conv)
            else:
                y = F.conv2d(xp, w, conv.bias, conv.stride, conv.padding, conv.dilation, conv.groups)
            y = y.permute(0, 2, 3, 1)
        if ranges is not None:
            y = _RangeEdge.apply(y, ranges, f"backward {name}", True)
        return y

    for name, conv in reid_convs(model).items():
        if ranges is not None or shapes is not None or name in without_cudnn:
            conv.forward = (lambda c, n: lambda x: forward(c, n, x))(conv, name)


def reid_grads(model, batch, p: int, k: int, hw, dtype, device, cudnn: bool = True,
               patch=None) -> tuple:
    """One ReID train step of a copy of ``model`` on ``batch`` (P x K rows at
    ``hw``), the parsing head's dropout replaced by the identity (the card's
    and the CPU's generators draw differently): ``(metrics, {name: gradient as
    float64 on the CPU})``.  ``cudnn=False`` disables cuDNN around the step;
    ``patch(model)`` edits the copy first."""
    from vqvae2_tpu_torch.part import part_model as pm
    from vqvae2_tpu_torch.train import reid as tr

    model = copy.deepcopy(model).to(device=device, dtype=dtype)
    if patch is not None:
        patch(model)
    b = {key: val.to(device=device, dtype=dtype if val.is_floating_point() else val.dtype)
         for key, val in batch.items()}
    sgd = tr.make_optimizer(0.1, 10)
    saved = pm.dropout
    pm.dropout = lambda x, *a, **kw: x
    try:
        with torch.enable_grad(), (contextlib.nullcontext() if cudnn else cudnn_disabled()):
            _, metrics = tr.make_train_step(model, sgd, k, p, hw)(tr.create_state(model, sgd), b)
    finally:
        pm.dropout = saved
    return ({key: float(val) for key, val in metrics.items()},
            {n: w.grad.detach().cpu().double() for n, w in model.named_parameters()})


def relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest element error over the largest element of ``want``."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def kernels_by_range(prof, prefix: str) -> dict:
    """The device kernels launched inside each profiler range whose name
    starts with ``prefix``, by the range's name."""
    out = {}

    def walk(ev, names):
        names.update(kr.name for kr in ev.kernels)
        for child in ev.cpu_children:
            walk(child, names)

    for ev in prof.events():
        if ev.name.startswith(prefix):
            walk(ev, out.setdefault(ev.name, set()))
    return {name: sorted(v) for name, v in out.items()}


def profiled_conv_kernels(model, batch, p: int, k: int, hw, without_cudnn=()) -> dict:
    """One ReID step on the card with every convolution labelled: each
    layer's forward and backward kernels, ``{layer: {"forward": [...],
    "backward": [...]}}``."""
    ranges = {}
    patch = lambda m: patch_convs(m, ranges=ranges, without_cudnn=without_cudnn)   # noqa: E731
    reid_grads(model, batch, p, k, hw, torch.float32, "cuda", patch=patch)       # warm-up
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        reid_grads(model, batch, p, k, hw, torch.float32, "cuda", patch=patch)
        torch.cuda.synchronize()
    check(not any(ranges.values()), f"profiler ranges left open: {[n for n, s in ranges.items() if s]}")
    out = {}
    for which in ("forward", "backward"):
        for name, names in kernels_by_range(prof, f"{which} ").items():
            out.setdefault(name.split(" ", 1)[1], {})[which] = names
    return out


def transform_of(kernel_names: list):
    """``"fft"`` or ``"winograd"`` when a convolution ran cuDNN's transform
    algorithms, else None."""
    low = " ".join(kernel_names).lower()
    return "fft" if "fft" in low else "winograd" if "winograd" in low else None


def conv_grad_report(model, batch, p: int, k: int, hw, label: str) -> dict:
    """Each convolution's weight gradient from one ReID step on the card, with
    cuDNN as ``set_reference_precision()`` leaves it and with cuDNN disabled,
    against the float64 backward on the CPU; the layers that cuDNN's route puts
    off, the kernels each of them runs, and the layers that run cuDNN's FFT or
    Winograd algorithms."""
    t0 = time.perf_counter()
    _, g64 = reid_grads(model, batch, p, k, hw, torch.float64, "cpu")
    cpu_seconds = time.perf_counter() - t0
    shapes = {}
    _, g_on = reid_grads(model, batch, p, k, hw, torch.float32, "cuda",
                         patch=lambda m: patch_convs(m, shapes=shapes))
    _, g_off = reid_grads(model, batch, p, k, hw, torch.float32, "cuda", cudnn=False)
    kernels = profiled_conv_kernels(model, batch, p, k, hw)
    norm = lambda g: sum(float(((g[n] - g64[n]) ** 2).sum()) for n in g64) ** 0.5 / sum(   # noqa: E731
        float((g64[n] ** 2).sum()) for n in g64) ** 0.5
    layers = []
    for name, conv in reid_convs(model).items():
        w = f"{name}.weight"
        ks = kernels.get(name, {})
        layers.append({"layer": name, "weight": list(conv.weight.shape), "input": shapes.get(name),
                       "cudnn_on": relative_error(g_on[w], g64[w]),
                       "cudnn_off": relative_error(g_off[w], g64[w]),
                       "forward_transform": transform_of(ks.get("forward", [])),
                       "backward_transform": transform_of(ks.get("backward", []))})
    offending = [r["layer"] for r in layers
                 if r["cudnn_on"] > GRAD_RTOL and r["cudnn_on"] > CUDNN_FACTOR * r["cudnn_off"]]
    transforms = {}
    for r in layers:
        for which in ("forward", "backward"):
            if r[f"{which}_transform"]:
                transforms.setdefault(f"{which} {r[f'{which}_transform']}", []).append(r["layer"])
    worst = sorted(layers, key=lambda r: r["cudnn_on"] / max(r["cudnn_off"], 1e-30), reverse=True)[:8]
    return {"case": label, "p": p, "k": k, "images": 3 * p * k, "hw": list(hw),
            "float64_cpu_seconds": cpu_seconds,
            "grad_norm_rel_err": {"cudnn_on": norm(g_on), "cudnn_off": norm(g_off)},
            "largest_on_off_ratios": worst, "offending": offending,
            "offending_backward_kernels": {n: kernels.get(n, {}).get("backward", [])
                                           for n in offending},
            "layers_by_transform": transforms, "convolutions": len(layers)}


def reid_step_without_cudnn(layer_sets: dict) -> dict:
    """The ReID train step at the command line's batch (72 images at
    288x144) as it is and with cuDNN disabled for the layers of each set
    alone, in turns (as is, without, without, as is); and a profile of each
    that shows whether those layers' backward left cuDNN."""
    from vqvae2_tpu_torch.part.part_model import EmbedNet2
    from vqvae2_tpu_torch.train import reid as tr

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(8)
        model = EmbedNet2(class_num=REID_IDS, arch=REID_ARCH).cuda()
    batch = reid_batch(8, REID_P, REID_K, REID_HW, REID_IDS)
    small = reid_batch(8, REID_F64_P, REID_F64_K, REID_HW, REID_IDS)

    def timed(without):
        m = copy.deepcopy(model)
        patch_convs(m, without_cudnn=without)
        tx = tr.make_optimizer(0.1, 10)
        state = tr.create_state(m, tx)
        step = tr.make_train_step(m, tx, REID_K, REID_P, REID_HW, seed=1)
        with torch.enable_grad():
            ms = host_ms(lambda: step(state, batch), 5)
        del m, state, step
        torch.cuda.empty_cache()
        return ms

    out = {}
    for label, layers in layer_sets.items():
        runs = [("as is", timed(())), ("without", timed(layers)), ("without", timed(layers)),
                ("as is", timed(()))]
        as_is = [ms for what, ms in runs if what == "as is"]
        without = [ms for what, ms in runs if what == "without"]
        kernels = profiled_conv_kernels(model, small, REID_F64_P, REID_F64_K, REID_HW,
                                        without_cudnn=layers)
        left = {n: [kn for kn in kernels.get(n, {}).get("backward", [])
                    if re.search(CUDNN_KERNEL, kn, re.I)] for n in layers}
        check(not any(left.values()), f"cuDNN kernels still in the backward of {left}")
        out[label] = {"layers": layers, "turns_ms": runs,
                      "cost_ms": (sum(without) - sum(as_is)) / 2,
                      "cost_share": (sum(without) - sum(as_is)) / sum(as_is),
                      "backward_left_cudnn": True}
    return out


def phase_cudnn_grads() -> dict:
    """Which convolutions of the ReID step cuDNN's algorithms put off the
    float64 backward, at the toy size of the card-vs-CPU step and at the
    image size users run, and what the step costs with cuDNN disabled for
    those layers alone."""
    from vqvae2_tpu_torch.part import part_model as pm

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        toy = pm.EmbedNet2(class_num=3, arch="resnet18")
    reports = [conv_grad_report(toy, reid_batch(5, 2, 2, REID_SMALL_HW, 3), 2, 2, REID_SMALL_HW,
                                "resnet18 at 128x64 (the card-vs-CPU step)")]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        full = pm.EmbedNet2(class_num=REID_IDS, arch=REID_ARCH)
    reports.append(conv_grad_report(
        full, reid_batch(7, REID_F64_P, REID_F64_K, REID_HW, REID_IDS), REID_F64_P, REID_F64_K,
        REID_HW, f"{REID_ARCH} at {REID_HW[0]}x{REID_HW[1]}, batch cut to "
                 f"{3 * REID_F64_P * REID_F64_K} images for the float64 backward"))
    names = set(reid_convs(full))
    transformed = sorted({n for key, layers in reports[1]["layers_by_transform"].items()
                          if key.startswith("backward") for n in layers})
    sets = {"offending at full size": reports[1]["offending"],
            "offending at the toy size, in the full model": [n for n in reports[0]["offending"]
                                                             if n in names],
            "FFT or Winograd in the backward at full size": transformed}
    result = {"grad_rtol": GRAD_RTOL, "cudnn_factor": CUDNN_FACTOR, "reports": reports,
              "step_without_cudnn": reid_step_without_cudnn({k: v for k, v in sets.items() if v})}
    emit("cudnn_grads", **result)
    return result


def phase_main_reid(tmp: str) -> dict:
    """The ReID path with the counters at zero before and read after: the eval
    forward of EmbedNet2(resnet50) at batch 50, then ``train.reid.main`` at its
    defaults on synthetic data for a few steps, validating on a raw SYSU tree
    every epoch; then one step held against the CPU."""
    from vqvae2_tpu_torch.eval.reid import validate
    from vqvae2_tpu_torch.part.part_model import EmbedNet2
    from vqvae2_tpu_torch.train import reid as tr

    root = os.path.join(tmp, "reid")
    raw = write_raw_sysu(os.path.join(root, "SYSU-MM01"), hw=(128, 64))
    ckpt, csv, map_csv = (os.path.join(root, n) for n in ("ckpt", "steps.csv", "map.csv"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(6)
        model = EmbedNet2(class_num=REID_IDS, arch=REID_ARCH).cuda().eval()
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(REID_EVAL_BATCH, *REID_HW, 3)).astype(np.float32)).cuda()

    reset_all_counts()
    with torch.no_grad():
        pooled, feats = model(xRGB=x, modal=1)
    torch.cuda.synchronize()
    check(pooled.shape == (REID_EVAL_BATCH, 2048) and feats.shape == (REID_EVAL_BATCH, 2048 + 1536)
          and bool(torch.isfinite(feats).all()), "EmbedNet2 eval forward: shape or non-finite")
    norm_err = float((torch.linalg.norm(feats, dim=1) - 1).abs().max())
    check(norm_err < 1e-4, f"EmbedNet2 eval features are not unit length ({norm_err})")
    check(ia.launch_counts == {"abn_forward": N_ABN, "abn_backward": 0},
          f"one eval forward must launch K7 {N_ABN} times: {ia.launch_counts}")

    forwards, handle = count_forwards(EmbedNet2)
    t0 = time.perf_counter()
    try:
        last = tr.main(["--synthetic", "--steps", str(REID_STEPS), "--log_every", "1",
                        "--metrics_csv", csv, "--ckpt_dir", ckpt, "--eval_every", "1",
                        "--eval_path", raw, "--map_csv", map_csv])
    finally:
        handle.remove()
    seconds = time.perf_counter() - t0
    counts = all_counts()                       # read just after the ReID path
    losses = csv_column(csv, "loss")
    check(len(losses) == REID_STEPS and all(np.isfinite(losses)), f"ReID: losses {losses}")
    check(falling(losses), f"ReID: the loss did not fall: {losses}")
    maps = csv_column(map_csv, "mAP")
    check(maps and all(0.0 <= v <= 1.0 for v in maps), f"ReID: mAP {maps}")
    check(saved_step(ckpt) == REID_STEPS, "ReID: last.pt does not hold the last step")
    check(not any(counts["plain_calls"].values()),
          f"a plain version ran on the ReID path: {counts['plain_calls']}")
    n_fwd = 1 + forwards["forwards"]
    want = {"abn_forward": N_ABN * n_fwd, "abn_backward": N_ABN * REID_STEPS}
    check(all(counts["launches"][k] == v for k, v in want.items()),
          f"ReID path launches {counts['launches']}, expected {want} "
          f"({n_fwd} forwards, {REID_STEPS} steps)")

    state = CheckpointManager(ckpt).restore("last")["model"]
    model.load_state_dict(state)
    t0 = time.perf_counter()
    mAP = validate(model, raw, img_size=(REID_HW[1], REID_HW[0]), test_batch=REID_EVAL_BATCH)
    validate_seconds = time.perf_counter() - t0
    result = {"eval_forward": {"batch": REID_EVAL_BATCH, "hw": list(REID_HW),
                               "unit_norm_max_err": norm_err},
              "train": {"steps": REID_STEPS, "p": REID_P, "k": REID_K, "hw": list(REID_HW),
                        "seconds": seconds, "loss": losses, "acc": csv_column(csv, "acc"),
                        "img_per_s_cli": csv_column(csv, "img_per_s")[-1], "mAP": maps,
                        "last_metrics": last},
              "validate": {"seconds": validate_seconds, "mAP": mAP},
              "forwards": n_fwd, **counts,
              "step_vs_cpu": reid_step_against_cpu()}
    emit("main_reid", **result)
    return counts["launches"], result


# What the card holds on chip: 50 MB of L2, 132 x 227 KB of shared memory and
# 132 x 256 KB of registers.
ON_CHIP_BYTES = 50e6 + 132 * 232448 + 132 * 262144


def abn_work(name: str, m: int, c: int, itemsize: int) -> dict:
    """Least bytes and operations of one call: K7 reads x and writes z, about
    five operations an element; K8 reads z and dz and writes dx, about fifteen
    (inversion, yhat, the two sums, dx); the channel vectors are noise.

    K8 also carries ``bound_two_pass_ms``: its per-channel sums must be
    complete before any dx, so where z and dz together exceed what the card
    holds on chip (``ON_CHIP_BYTES``, about 115 MB; 382 MB at M = 186,624,
    C = 256) every design reads them twice: five tensors' bytes, not three."""
    rows = m * c * itemsize
    nbytes = (2 if name == "abn_forward" else 3) * rows + 5 * c * 4
    flops = (5 if name == "abn_forward" else 15) * m * c
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    out = {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if name == "abn_backward":
        passes = 5 if 2 * rows > ON_CHIP_BYTES else 3
        out["bound_two_pass_ms"] = max(passes * rows / PEAK_BYTES_PER_S * 1e3, t_ops)
        # each entry alone: the sums read z and dz, the dx pass reads both and writes dx
        out["sums_bound_ms"] = 2 * rows / PEAK_BYTES_PER_S * 1e3
        out["dx_bound_ms"] = 3 * rows / PEAK_BYTES_PER_S * 1e3
    return out


def k8_entries(z, dz, v: dict, inv_count: float) -> dict:
    """K8's two entries alone and the whole backward, as callables on checked
    rows ``z``, ``dz`` (the sums' result fed to the dx pass)."""
    shift, w_t, mul = v["shift"], v["w_t"], v["mul"]
    act, slope = ia.ACT_LEAKY_RELU, 0.01
    stream = torch.cuda.current_stream().cuda_stream
    edz, eydz = ia._backward_sums_cuda(z, dz, shift, w_t, True, act, slope, stream)
    return {"sums": lambda: ia._backward_sums_cuda(z, dz, shift, w_t, True, act, slope, stream),
            "dx": lambda: ia._backward_dx_cuda(z, dz, shift, w_t, mul, edz, eydz, inv_count,
                                               act, slope, stream),
            "backward": lambda: ia.abn_backward(z, dz, shift, w_t, mul, inv_count)}


def k8_step(inputs: list, seed: int) -> dict:
    """K8's time over the ABN inputs of one ReID step (one launch each, at
    each input's shape and type), by CUDA events, beside the sums of each
    shape's ``bound_ms`` and ``bound_two_pass_ms``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shapes = []
    for name, x in inputs:
        m, c = x.shape
        v = abn_vectors(c, gen, x.float())
        z = ia.abn_forward(x, v["mean"], v["scale"], v["shift"])
        dz = (1e-3 * torch.randn(m, c, generator=gen, device="cuda")).to(x.dtype)
        work = abn_work("abn_backward", m, c, x.element_size())
        shapes.append({"name": name, "m": m, "c": c,
                       "ms": cuda_ms(lambda: ia.abn_backward(z, dz, v["shift"], v["w_t"],
                                                             v["mul"], 1.0 / m), reps=20),
                       "bound_ms": work["bound_ms"],
                       "bound_two_pass_ms": work["bound_two_pass_ms"]})
        del z, dz
    total = {k: sum(s[k] for s in shapes) for k in ("ms", "bound_ms", "bound_two_pass_ms")}
    return {"dtype": str(inputs[0][1].dtype), "launches": len(shapes), **total,
            "share_of_bound": total["bound_ms"] / total["ms"],
            "share_of_bound_two_pass": total["bound_two_pass_ms"] / total["ms"],
            "shapes": shapes}


def abn_records(x: torch.Tensor, launches: dict, cases: list) -> list:
    """Times of K7 and K8 at the largest shape the ReID train step gives them
    (M = 186,624, C = 256, in ``x``'s type; larger than the 50 MB L2), their
    plain versions and one library route each."""
    m, c = x.shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    v = abn_vectors(c, gen, x)
    mean, var, scale, shift, w_t, mul = (v[k] for k in ("mean", "var", "scale", "shift", "w_t",
                                                         "mul"))
    z = ia.abn_forward(x, mean, scale, shift)
    dz = (1e-3 * torch.randn(m, c, generator=gen, device="cuda")).to(x.dtype)
    run = {"abn_forward": (lambda: ia.abn_forward(x, mean, scale, shift),
                           lambda: ia.abn_forward_reference(x, mean, scale, shift)),
           "abn_backward": (lambda: ia.abn_backward(z, dz, shift, w_t, mul, 1.0 / m),
                            lambda: ia.abn_backward_reference(z, dz, shift, w_t, mul, 1.0 / m))}
    lib_fwd = lambda: F.leaky_relu(F.batch_norm(x, mean, var, w_t, shift, False, 0.0, 1e-5), 0.01)
    leaves = [t.detach().clone().requires_grad_() for t in (x, w_t, shift)]
    with torch.enable_grad():
        lib_out = F.leaky_relu(F.batch_norm(leaves[0], None, None, leaves[1], leaves[2], True, 0.0,
                                            1e-5), 0.01)
        lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, dz, retain_graph=True),
                             reps=10)
    library = {"abn_forward": (cuda_ms(lib_fwd, reps=20),
                               "F.batch_norm(training=False) + F.leaky_relu"),
               "abn_backward": (lib_bwd_ms, "autograd backward of F.batch_norm(training=True) + "
                                            "F.leaky_relu (dx, dw, db; forward outside the timer)")}
    main_cases = [cs for cs in cases if cs["case"].startswith("main path")]
    entries = k8_entries(z, dz, v, 1.0 / m)
    split = {f"{part}_ms": cuda_ms(entries[part], reps=20) for part in ("sums", "dx")}
    out = []
    for name, (kernel, plain) in run.items():
        work = abn_work(name, m, c, x.element_size())
        ms = cuda_ms(kernel, reps=20)
        err = max(cs["z_max_abs_err"] if name == "abn_forward" else cs["dx_max_abs_err"]
                  for cs in main_cases)
        out.append({"name": name, **KERNELS[name], "launches": launches[name],
                    "max_abs_err": err, "shape": {"m": m, "c": c, "dtype": str(x.dtype)},
                    "ms": ms, "kernel_ms": ms, "plain_ms": cuda_ms(plain, reps=5),
                    "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
                    "library_ms": library[name][0], "library": library[name][1],
                    "share_of_bound": work["bound_ms"] / ms, "bytes": work["bytes"],
                    "flops": work["flops"],
                    **({"bound_two_pass_ms": work["bound_two_pass_ms"],
                        "share_of_bound_two_pass": work["bound_two_pass_ms"] / ms,
                        **split, "sums_bound_ms": work["sums_bound_ms"],
                        "dx_bound_ms": work["dx_bound_ms"]}
                       if name == "abn_backward" else {})})
    return out


def abn_wide_times(m_rows: int) -> dict:
    """K7 and K8 at C = 4096 (K7 reads its channel vectors from global
    memory; a K8 lane takes two 16-byte vectors of each row), with as many
    elements as the main path's largest shape, beside their bounds."""
    c = 4096
    m = m_rows * 256 // c
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(m, c, generator=gen, device="cuda")
    v = abn_vectors(c, gen, x)
    z = ia.abn_forward(x, v["mean"], v["scale"], v["shift"])
    dz = 1e-3 * torch.randn(m, c, generator=gen, device="cuda")
    out = {"shape": {"m": m, "c": c, "dtype": "torch.float32"}}
    for name, fn in (("abn_forward", lambda: ia.abn_forward(x, v["mean"], v["scale"], v["shift"])),
                     ("abn_backward", lambda: ia.abn_backward(z, dz, v["shift"], v["w_t"], v["mul"],
                                                              1.0 / m))):
        work = abn_work(name, m, c, 4)
        out[name] = {"ms": cuda_ms(fn, reps=20), "bound_ms": work["bound_ms"],
                     **({"bound_two_pass_ms": work["bound_two_pass_ms"]}
                        if "bound_two_pass_ms" in work else {})}
    return out


def reid_step_times(dtype: torch.dtype = torch.float32) -> dict:
    """One ReID train step at the command line's batch (72 images at
    288x144) with ``dtype`` compute, by the host's clock around steps ending
    in a synchronise, the batch already on the card; its peak memory; the eval
    forward at batch 50."""
    from vqvae2_tpu_torch.part.part_model import EmbedNet2
    from vqvae2_tpu_torch.train import reid as tr

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(8)
        model = EmbedNet2(class_num=REID_IDS, arch=REID_ARCH, dtype=dtype).cuda()
    batch = reid_batch(8, REID_P, REID_K, REID_HW, REID_IDS)
    tx = tr.make_optimizer(0.1, 10)
    state = tr.create_state(model, tx)
    step = tr.make_train_step(model, tx, REID_K, REID_P, REID_HW, seed=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad():
        ms = host_ms(lambda: step(state, batch), 5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model.eval()
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(REID_EVAL_BATCH, *REID_HW, 3)).astype(np.float32)).cuda()
    with torch.no_grad():
        eval_ms = host_ms(lambda: model(xRGB=x, modal=1), 5)
    return {"train_step": {"rows": REID_ROWS, "images": 3 * REID_ROWS, "hw": list(REID_HW),
                           "ms": ms, "rows_per_s": REID_ROWS / ms * 1e3,
                           "img_per_s": 3 * REID_ROWS / ms * 1e3, "peak_memory_gb": peak},
            "eval_forward": {"batch": REID_EVAL_BATCH, "ms": eval_ms,
                             "img_per_s": REID_EVAL_BATCH / eval_ms * 1e3}}


def phase_breakdown_reid(dtype: torch.dtype = torch.float32) -> None:
    """Optional: where one ReID train step (72 images at 288x144) with
    ``dtype`` compute spends its time, by CUDA events: the model's forward (13 K7 launches inside it), the
    loss and backward (13 K8), the optimizer; the kernels' own spans; and the
    aten operators of a third step that take the most device time, by
    ``torch.profiler`` (which nests them: a backward operator holds its parts)."""
    from vqvae2_tpu_torch.part.part_model import EmbedNet2
    from vqvae2_tpu_torch.train import reid as tr

    pool = [torch.cuda.Event(enable_timing=True) for _ in range(256)]
    marks = []

    def mark(label):
        ev = pool[len(marks)]
        ev.record()
        marks.append((label, ev))

    def timed(fn, label):
        def inner(*args, **kw):
            mark((label, 0))
            out = fn(*args, **kw)
            mark((label, 1))
            return out
        return inner

    saved = (ia._abn_forward_cuda, ia._abn_backward_cuda)
    ia._abn_forward_cuda = timed(saved[0], "K7 (ABN forward), 13 launches")
    ia._abn_backward_cuda = timed(saved[1], "K8 (ABN backward), 13 launches")
    try:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(9)
            model = EmbedNet2(class_num=REID_IDS, arch=REID_ARCH, dtype=dtype).cuda()
        batch = reid_batch(9, REID_P, REID_K, REID_HW, REID_IDS)
        tx = tr.make_optimizer(0.1, 10)
        state = tr.create_state(model, tx)
        step = tr.make_train_step(model, tx, REID_K, REID_P, REID_HW, seed=1)
        hooks = [model.register_forward_pre_hook(lambda m, a: mark(("forward", 0))),
                 model.register_forward_hook(lambda m, a, o: mark(("forward", 1)))]
        opt_step = state.optimizer.step
        state.optimizer.step = timed(opt_step, "optimizer")
        with torch.enable_grad():
            step(state, batch)                      # warm-up
            torch.cuda.synchronize()
            marks.clear()
            mark(("step", 0))
            step(state, batch)
            mark(("step", 1))
            torch.cuda.synchronize()
            for h in hooks:
                h.remove()
            state.optimizer.step = opt_step
            timed_marks = list(marks)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                step(state, batch)
                torch.cuda.synchronize()
    finally:
        ia._abn_forward_cuda, ia._abn_backward_cuda = saved
    device_ms = lambda e: getattr(e, "device_time_total", 0.0) / 1e3
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    top_ops = [{"op": e.key, "device_ms": device_ms(e), "calls": e.count}
               for e in sorted(ops, key=device_ms, reverse=True)[:12]]
    spans, opened = {}, {}
    for (label, end), ev in timed_marks:
        if end:
            spans[label] = spans.get(label, 0.0) + opened.pop(label).elapsed_time(ev)
        else:
            opened[label] = ev
    at = {label: ev for label, ev in timed_marks}
    spans["loss and backward"] = at[("forward", 1)].elapsed_time(at[("optimizer", 0)])
    spans["total"] = spans.pop("step")
    emit("breakdown_reid", unit="ms", dtype=str(dtype), images=3 * REID_ROWS, hw=list(REID_HW),
         **spans,
         profiled_step_top_aten_ops=top_ops)


def phase_probe() -> None:
    """What the card offers the attention kernels' tensor-core products, by
    ``csrc/tc_probe.cu`` — ``mma.sync`` m16n8k8 TF32 throughput
    with 4 independent accumulators a warp at 4, 16 and 32 warps an SM; the
    TF32 split's rounding by ``cvt.rna.tf32.f32`` against an integer
    add-and-mask; and whether the tensor cores' fp32 accumulation rounds to
    nearest (1 + 9e-8 and 1 + 6e-8 round up to nearest, down toward zero)."""
    import ctypes

    lib = ctypes.CDLL(_build.build("tc_probe"))
    for fn in (lib.tcp_mma, lib.tcp_split):
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    lib.tcp_accumulate.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_float]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(sms * 32 * 256, device="cuda")
    iters = 4000

    def run(fn, *args):
        check(fn(out.data_ptr(), *args) == 0, f"probe launch failed: {fn.__name__}")

    mma = {}
    for warps in (4, 16, 32):
        blocks = sms * warps // 4
        ms = cuda_ms(lambda: run(lib.tcp_mma, blocks, 128, iters, 4), reps=5, warmup=1)
        mma[f"{warps} warps an SM"] = {"ms": ms, "tflops": blocks * 4 * iters * 4 * 2048 / ms / 1e9}
    split = {}
    for which, name in ((1, "cvt.rna.tf32.f32"), (0, "integer add and mask")):
        blocks = sms * 8
        ms = cuda_ms(lambda: run(lib.tcp_split, blocks, 256, iters, which), reps=5, warmup=1)
        split[name] = {"ms": ms, "g_values_per_s": blocks * 256 * iters * 8 / ms / 1e6}
    acc = torch.zeros(2, device="cuda")
    rounding = []
    for big, tiny in ((1.0, 9e-8), (1.0, 6e-8), (1.0, -1.7e-7), (3.0, 2.5e-7)):
        check(lib.tcp_accumulate(acc.data_ptr(), big, tiny) == 0, "probe launch failed")
        torch.cuda.synchronize()
        rounding.append({"big": big, "tiny": tiny, "tensor_cores": float(acc[0]),
                         "fp32_round_to_nearest": float(acc[1])})
    emit("probe", mma_tf32_m16n8k8=mma, tf32_split=split, accumulation=rounding,
         truncates=any(r["tensor_cores"] != r["fp32_round_to_nearest"] for r in rounding))


# ---------------------------------------------------------------------------
# bf16 compute, remat and the MNIST prior
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# bf16 training runs of each command line (a smoke run: fewer steps than fp32's)
TRAIN_STEPS_BF16 = {"vqvae": 8, "top": 6, "bottom": 4, "reid": 6}
# A bf16 step on the card against the same step on the CPU: the two sum each
# bf16 convolution in another order, so a value may round to the neighbouring
# bf16 (2^-8 relative) at every layer.  The loss within BF16_LOSS_RTOL; the
# whole model's gradient, as one vector, within BF16_GRAD_NORM_RTOL of its
# norm (about a dozen bf16 roundings); the worst tensors are reported.
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_NORM_RTOL = 5e-2
# train/pixelsnail_mnist.py: its default batch, a few steps
MNIST_BATCH, MNIST_STEPS = 32, 8
MNIST_CONFIG = dict(channel=128, dropout=0.1)
MNIST_HEAD_DIM = MNIST_CONFIG["channel"] // 2 // N_HEAD        # 8
# what each kernel's launcher is called by name, for the record of the types
# and shapes it received
LAUNCHERS = {
    "nearest_code_ids": (qz, "_nearest_code_ids_cuda"),
    "nearest_code_lookup": (qz, "_nearest_code_lookup_cuda"),
    "nearest_code_stats": (qz, "_nearest_code_stats_cuda"),
    "causal_flash_attention": (fa, "_causal_flash_attention_cuda"),
    "causal_flash_attention_dq": (fa, "_backward_dq_cuda"),
    "causal_flash_attention_dkv": (fa, "_backward_dkv_cuda"),
    "abn_forward": (ia, "_abn_forward_cuda"),
    "abn_backward": (ia, "_abn_backward_cuda"),
}


@contextlib.contextmanager
def launched_inputs():
    """While the block runs, each kernel's launcher records the type and shape
    of its first operand (the rows, or q): ``{kernel: {(dtype, shape), ...}}``.
    The launch counters are the wrappers' own and stay as they are."""
    seen = {name: set() for name in LAUNCHERS}
    saved = {}
    for name, (module, attr) in LAUNCHERS.items():
        fn = saved[name] = getattr(module, attr)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            seen[_name].add((str(args[0].dtype)[6:], tuple(args[0].shape)))
            return _fn(*args, **kwargs)

        setattr(module, attr, spy)
    try:
        yield seen
    finally:
        for name, (module, attr) in LAUNCHERS.items():
            setattr(module, attr, saved[name])


def only_dtype(seen: dict, names, dtype: str, label: str) -> dict:
    """Each kernel in ``names`` received rows of ``dtype`` alone; returns what
    each received, as lists."""
    for name in names:
        got = {dt for dt, _ in seen[name]}
        check(got == {dtype}, f"{label}: {name} received {sorted(got)}, not {dtype} alone")
    return {name: sorted([dt, list(shape)] for dt, shape in seen[name]) for name in names}


def gradient_norm_errors(g_card: dict, g_cpu: dict) -> dict:
    """The whole model's gradient error as a fraction of its norm, and the
    five tensors with the largest such fraction."""
    err = sum(float(((g_card[n].float() - g).double() ** 2).sum()) for n, g in g_cpu.items())
    norm = sum(float((g.double() ** 2).sum()) for g in g_cpu.values())
    per = sorted(((float(torch.linalg.norm((g_card[n].float() - g).double()))
                   / max(float(torch.linalg.norm(g.double())), 1e-30), n)
                  for n, g in g_cpu.items()), reverse=True)[:5]
    return {"grad_norm_rel_err": (err / max(norm, 1e-60)) ** 0.5,
            "worst_tensors": [{"name": n, "norm_rel_err": e} for e, n in per]}


def bf16_step_against_cpu(model_cuda, model_cpu, make_step, batch_cuda, batch_cpu,
                          label: str) -> dict:
    """One bf16 train step of the same weights on the card and on the CPU:
    each metric within BF16_LOSS_RTOL, the gradient within
    BF16_GRAD_NORM_RTOL of its norm."""
    (m_card, g_card), (m_cpu, g_cpu) = steps_on_card_and_cpu(
        model_cuda, model_cpu, make_step, batch_cuda, batch_cpu)
    for k in m_cpu:
        check(abs(m_card[k] - m_cpu[k]) <= BF16_LOSS_RTOL * max(abs(m_cpu[k]), 1e-6),
              f"{label}, card vs CPU: {k} {m_card[k]} vs {m_cpu[k]}")
    errs = gradient_norm_errors(g_card, g_cpu)
    check(errs["grad_norm_rel_err"] <= BF16_GRAD_NORM_RTOL,
          f"{label}, card vs CPU: the gradient differs by {errs['grad_norm_rel_err']} of its norm")
    return {"metrics_card": m_card, "metrics_cpu": m_cpu, **errs}


def stage1_bf16_step_against_cpu(vq_dir: str) -> dict:
    """Full width, small input: one bf16 stage-1 step on the card against the
    same on the CPU, from the run's own bf16 checkpoint; the ids of both
    before the step, as a share that differs."""
    models, x, differing, total = stage1_on_card_and_cpu(vq_dir, BF16)
    out = bf16_step_against_cpu(models[0], models[1], tv.make_train_step, x.cuda(), x,
                                "bf16 stage 1")
    out.update(input=[2, 64, 64, 3], ids_differing_share=differing / total)
    return out


def prior_bf16_step_against_cpu(top_dir: str) -> dict:
    """Full width, small grid, the run's own bf16 top prior with dropout at 0:
    one step on the card and on the CPU."""
    mgr = CheckpointManager(top_dir)
    check(mgr.load_config().get("bf16") is True, "the bf16 top prior's config does not say bf16")
    weights = mgr.restore("last")["model"]
    models = []
    for device in ("cuda", "cpu"):
        m = build_model("top", argparse.Namespace(**{**PRIOR_CONFIG, "bf16": True}),
                        code_hw=(TOP_HW, BOTTOM_HW))
        m.load_state_dict(weights)
        for mod in m.modules():
            if hasattr(mod, "dropout"):
                mod.dropout = 0.0
        models.append(m.to(device))
    codes = numpy_codes(6, 2, 8, 8)

    def make(model, tx):
        return tp.make_train_step(model, tx, conditional=False)

    out = bf16_step_against_cpu(models[0], models[1], make, {"target": codes},
                                {"target": codes.cpu()}, "bf16 top prior")
    out["grid"] = [2, 8, 8]
    return out


def phase_main_train_bf16(tmp: str, codes: str) -> dict:
    """The three trainers' bf16 mode through their command lines at full
    width, with the launch counters at zero before and read after: stage 1
    (``--bf16``, batch 128 at 256 px) for a few steps, the eval forward and
    ``encode_ids`` of the model it wrote, and both priors (``--bf16``, batch
    32) on the codes of the fp32 run; the losses fall.  The kernels' launchers
    show what they received: the quantizer kernels bf16 rows, the attention
    kernels fp32 q, k, v (the JAX package's promotion).  Then one bf16 step of
    stage 1 and of the top prior on the card against the CPU."""
    root = os.path.join(tmp, "train_bf16")
    dirs = {name: os.path.join(root, name) for name in ("vqvae", "top", "bottom")}
    csvs = {name: os.path.join(root, f"{name}.csv") for name in dirs}
    n1, n2, n3 = (TRAIN_STEPS_BF16[k] for k in ("vqvae", "top", "bottom"))
    result = {"steps": {k: TRAIN_STEPS_BF16[k] for k in dirs}, "batch": dict(TRAIN_BATCH)}
    reset_all_counts()
    with launched_inputs() as seen:
        t0 = time.perf_counter()
        tv.main(["--synthetic", "--bf16", "--size", str(SIZE), "--batch_size",
                 str(TRAIN_BATCH["vqvae"]), "--log_every", "1", "--ckpt_dir", dirs["vqvae"],
                 "--steps", str(n1), "--metrics_csv", csvs["vqvae"]])
        losses = csv_column(csvs["vqvae"], "loss")
        check(len(losses) == n1 and all(np.isfinite(losses)), f"bf16 stage 1: losses {losses}")
        check(falling(losses), f"bf16 stage 1: the loss did not fall: {losses}")
        result["stage1"] = {"seconds": time.perf_counter() - t0, "loss": losses,
                            "img_per_s_cli": csv_column(csvs["vqvae"], "img_per_s")[-1]}

        model = build_vqvae(device="cuda", dtype=BF16)
        model.load_state_dict(CheckpointManager(dirs["vqvae"]).restore("last")["model"])
        x = torch.from_numpy(np.random.default_rng(11).normal(
            scale=0.5, size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)).cuda()
        with torch.no_grad():
            dec, diff = model(x)
            id_t, id_b = model.encode_ids(x)
        check(dec.dtype == BF16 and dec.shape == x.shape and bool(torch.isfinite(dec.float()).all())
              and diff.dtype == torch.float32 and bool(torch.isfinite(diff)),
              f"bf16 forward: dec {dec.dtype} {tuple(dec.shape)}, diff {diff.dtype} {float(diff)}")
        check(id_t.shape == (BATCH, TOP_HW, TOP_HW) and id_b.shape == (BATCH, BOTTOM_HW, BOTTOM_HW),
              "bf16 encode_ids: id shapes")
        result["eval_forward"] = {"diff": float(diff), "codes_used_top": int(id_t.unique().numel()),
                                  "codes_used_bottom": int(id_b.unique().numel())}
        del model, dec, x

        for hier, steps in (("top", n2), ("bottom", n3)):
            t0 = time.perf_counter()
            tp.main([codes, "--hier", hier, "--bf16", "--batch", str(TRAIN_BATCH[hier]),
                     "--steps", str(steps), "--log_every", "1", "--ckpt_dir", dirs[hier],
                     "--metrics_csv", csvs[hier]])
            ce = csv_column(csvs[hier], "loss")
            check(len(ce) == steps and all(np.isfinite(ce)), f"bf16 {hier} prior: losses {ce}")
            check(abs(ce[0] - np.log(K)) < 1.0, f"bf16 {hier} prior: CE starts at {ce[0]}")
            check(falling(ce), f"bf16 {hier} prior: the cross-entropy did not fall: {ce}")
            result[hier] = {"seconds": time.perf_counter() - t0, "loss": ce,
                            "acc": csv_column(csvs[hier], "acc")}
    counts = all_counts()                      # read just after the bf16 training path
    check(not any(counts["plain_calls"].values()),
          f"a plain version ran on the bf16 training path: {counts['plain_calls']}")
    want = {"nearest_code_stats": 2 * n1, "nearest_code_lookup": 3, "nearest_code_ids": 1,
            "causal_flash_attention": 4 * n2, "causal_flash_attention_dq": 4 * n2,
            "causal_flash_attention_dkv": 4 * n2}
    check(all(counts["launches"][k] == v for k, v in want.items()),
          f"bf16 training path launches {counts['launches']}, expected {want}")
    result["received"] = {
        **only_dtype(seen, ("nearest_code_ids", "nearest_code_lookup", "nearest_code_stats"),
                     "bfloat16", "bf16 stage 1"),
        **only_dtype(seen, ("causal_flash_attention", "causal_flash_attention_dq",
                            "causal_flash_attention_dkv"), "float32", "bf16 top prior")}
    result.update(counts)
    result["stage1_step_vs_cpu"] = stage1_bf16_step_against_cpu(dirs["vqvae"])
    result["top_prior_step_vs_cpu"] = prior_bf16_step_against_cpu(dirs["top"])
    emit("main_train_bf16", bf16_loss_rtol=BF16_LOSS_RTOL,
         bf16_grad_norm_rtol=BF16_GRAD_NORM_RTOL, **result)
    return counts["launches"]


def phase_main_reid_bf16(tmp: str) -> dict:
    """The ReID trainer's bf16 mode with the counters at zero before and read
    after: the eval forward of a bf16 EmbedNet2(resnet50) at batch 50, then
    ``train.reid.main --synthetic --bf16`` at its defaults (P = 6, K = 4,
    288x144) for a few steps, the losses falling.  The ABN kernels' launchers
    show that they received bf16 rows (the output of a bf16 convolution)."""
    from vqvae2_tpu_torch.part.part_model import EmbedNet2
    from vqvae2_tpu_torch.train import reid as tr

    root = os.path.join(tmp, "reid_bf16")
    csv = os.path.join(root, "steps.csv")
    steps = TRAIN_STEPS_BF16["reid"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(6)
        model = EmbedNet2(class_num=REID_IDS, arch=REID_ARCH, dtype=BF16).cuda().eval()
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(REID_EVAL_BATCH, *REID_HW, 3)).astype(np.float32)).cuda()
    reset_all_counts()
    with launched_inputs() as seen:
        with torch.no_grad():
            pooled, feats = model(xRGB=x, modal=1)
        torch.cuda.synchronize()
        check(pooled.dtype == feats.dtype == torch.float32 and bool(torch.isfinite(feats).all()),
              f"bf16 EmbedNet2 eval forward: {pooled.dtype}, {feats.dtype} or non-finite")
        norm_err = float((torch.linalg.norm(feats, dim=1) - 1).abs().max())
        check(norm_err < 1e-4, f"bf16 EmbedNet2 eval features are not unit length ({norm_err})")
        del model
        forwards, handle = count_forwards(EmbedNet2)
        t0 = time.perf_counter()
        try:
            last = tr.main(["--synthetic", "--bf16", "--steps", str(steps), "--log_every", "1",
                            "--metrics_csv", csv])
        finally:
            handle.remove()
        seconds = time.perf_counter() - t0
    counts = all_counts()                      # read just after the bf16 ReID path
    losses = csv_column(csv, "loss")
    check(len(losses) == steps and all(np.isfinite(losses)), f"bf16 ReID: losses {losses}")
    check(falling(losses), f"bf16 ReID: the loss did not fall: {losses}")
    check(not any(counts["plain_calls"].values()),
          f"a plain version ran on the bf16 ReID path: {counts['plain_calls']}")
    want = {"abn_forward": N_ABN * (1 + forwards["forwards"]), "abn_backward": N_ABN * steps}
    check(all(counts["launches"][k] == v for k, v in want.items()),
          f"bf16 ReID path launches {counts['launches']}, expected {want}")
    received = only_dtype(seen, ("abn_forward", "abn_backward"), "bfloat16", "bf16 ReID")
    result = {"eval_forward": {"batch": REID_EVAL_BATCH, "hw": list(REID_HW),
                               "unit_norm_max_err": norm_err},
              "train": {"steps": steps, "p": REID_P, "k": REID_K, "hw": list(REID_HW),
                        "seconds": seconds, "loss": losses, "last_metrics": last},
              "received": received, **counts}
    emit("main_reid_bf16", **result)
    return counts["launches"]


def phase_bf16_vs_fp32(model, x: torch.Tensor, top) -> torch.nn.Module:
    """Reported, not checked: what bf16 compute changes, on the same seeded
    weights and batch — the share of stage-1 ids (top, bottom) that differ
    between the fp32 and the bf16 ``encode_ids``, ``diff`` of both, and the
    top prior's logits in bf16 against fp32 (largest and mean distance, and
    the share of positions whose most likely code differs).  Returns the bf16
    stage-1 model (the fp32 one's weights and codebooks)."""
    bf = build_vqvae(device="cuda", dtype=BF16)
    bf.load_state_dict(model.state_dict())
    ids32, ids16 = model.encode_ids(x), bf.encode_ids(x)
    flips = {name: float((a != b).float().mean()) for name, a, b in
             zip(("top", "bottom"), ids32, ids16)}
    diff32, diff16 = float(model(x)[1]), float(bf(x)[1])
    top16 = build_model("top", argparse.Namespace(**{**PRIOR_CONFIG, "bf16": True}),
                        code_hw=(TOP_HW, BOTTOM_HW)).cuda().eval()
    top16.load_state_dict(top.state_dict())
    codes = numpy_codes(2, PRIOR_BATCH, TOP_HW, TOP_HW)
    l32, l16 = top(codes), top16(codes)
    check(l16.dtype == BF16 and bool(torch.isfinite(l16.float()).all()),
          "bf16 top prior: logits dtype or non-finite")
    dist = (l16.float() - l32).abs()
    result = {"stage1": {"batch": BATCH, "size": SIZE, "id_flip_share": flips,
                         "diff_fp32": diff32, "diff_bf16": diff16},
              "top_prior": {"batch": PRIOR_BATCH, "logit_max_abs_diff": float(dist.max()),
                            "logit_mean_abs_diff": float(dist.mean()),
                            "logit_abs_max_fp32": float(l32.abs().max()),
                            "argmax_differs_share": float(
                                (l16.float().argmax(-1) != l32.argmax(-1)).float().mean())}}
    emit("bf16_vs_fp32", **result)
    del top16, l32, l16
    return bf


def phase_remat(dirs: dict) -> None:
    """One stage-1 train step at batch 128 with and without ``remat`` from
    the same state (the fp32 run's checkpoint): gradients, codebook buffers
    and the updated parameters bit-equal (cuDNN runs deterministic
    algorithms, so the recompute is the same program); ms and peak memory of
    each, by the host's clock over further steps."""
    weights = CheckpointManager(dirs["vqvae"]).restore("last")["model"]
    x = torch.from_numpy(np.random.default_rng(12).normal(
        scale=0.5, size=(TRAIN_BATCH["vqvae"], SIZE, SIZE, 3)).astype(np.float32)).cuda()
    after, result = {}, {}
    for remat in (False, True):
        vq = build_vqvae(device="cuda", remat=remat)
        vq.load_state_dict(weights)
        tx = schedules.adam(3e-4)
        state = tv.create_state(vq, tx)
        step = tv.make_train_step(vq, tx)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, metrics = step(state, x)
        after[remat] = ({n: p.grad.clone() for n, p in vq.named_parameters()},
                        {n: t.clone() for n, t in vq.state_dict().items()},
                        float(metrics["loss"]))
        first_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = host_ms(lambda: step(state, x), 3)
        result["remat" if remat else "plain"] = {
            "ms": ms, "img_per_s": TRAIN_BATCH["vqvae"] / ms * 1e3,
            "peak_memory_gb_first_step": first_gb,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        del vq, state, step
    (g0, s0, l0), (g1, s1, l1) = after[False], after[True]
    grads_equal = all(torch.equal(g0[n], g1[n]) for n in g0)
    state_equal = all(torch.equal(s0[n], s1[n]) for n in s0)
    worst = max(float((g0[n] - g1[n]).abs().max()) for n in g0)
    check(grads_equal and l0 == l1, f"remat: gradients or loss differ (largest |dg| {worst})")
    check(state_equal, "remat: parameters or codebook buffers after the step differ")
    torch.cuda.empty_cache()
    emit("remat", batch=TRAIN_BATCH["vqvae"], size=SIZE, loss=l0, grads_bit_equal=grads_equal,
         state_after_step_bit_equal=state_equal, **result)


def phase_main_mnist(tmp: str):
    """``train/pixelsnail_mnist.py main`` at its defaults (channel 128, batch
    32) on ``synthetic_digits`` for a few steps, with the counters at zero
    before and read after: the cross-entropy starts near ln 256 and falls, the
    attention kernels ran at (B*H, N, D) = (256, 784, 8), forward and
    backward, in fp32.  Then one step's time and peak memory.  Returns the
    launches and a prior of the same configuration."""
    from vqvae2_tpu_torch.train import pixelsnail_mnist as pmn

    csv = os.path.join(tmp, "mnist.csv")
    reset_all_counts()
    with launched_inputs() as seen:
        t0 = time.perf_counter()
        pmn.main(["--batch", str(MNIST_BATCH), "--steps", str(MNIST_STEPS), "--log_every", "1",
                  "--metrics_csv", csv])
        seconds = time.perf_counter() - t0
    counts = all_counts()                      # read just after the MNIST path
    ce = csv_column(csv, "loss")
    check(len(ce) == MNIST_STEPS and all(np.isfinite(ce)), f"MNIST prior: losses {ce}")
    check(abs(ce[0] - np.log(256)) < 1.0, f"MNIST prior: CE starts at {ce[0]}, not near ln 256")
    check(falling(ce), f"MNIST prior: the cross-entropy did not fall: {ce}")
    check(not any(counts["plain_calls"].values()),
          f"a plain version ran on the MNIST path: {counts['plain_calls']}")
    want = {k: 2 * MNIST_STEPS for k in ("causal_flash_attention", "causal_flash_attention_dq",
                                        "causal_flash_attention_dkv")}
    check(all(counts["launches"][k] == v for k, v in want.items()),
          f"MNIST path launches {counts['launches']}, expected {want}")
    shape = (MNIST_BATCH * N_HEAD, 28 * 28, MNIST_HEAD_DIM)
    received = only_dtype(seen, want, "float32", "MNIST prior")
    check(all(s == shape for name in want for _, s in seen[name]),
          f"MNIST prior: the attention kernels received {received}, not {shape}")

    args = pmn.build_argparser().parse_args(["--channel", str(MNIST_CONFIG["channel"])])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(13)
        prior = pmn.build_model(args).cuda()
    tx = schedules.adam(3e-4)
    state = tv.create_state(prior, tx)
    step = pmn.make_train_step(prior, tx, seed=1)
    codes = torch.from_numpy(pmn.synthetic_digits(MNIST_BATCH, seed=3).astype(np.int64)).cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad():
        ms = host_ms(lambda: step(state, codes), 5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    emit("main_mnist", batch=MNIST_BATCH, steps=MNIST_STEPS, seconds=seconds, loss=ce,
         acc=csv_column(csv, "acc"), received=received, **counts,
         step={"ms": ms, "img_per_s": MNIST_BATCH / ms * 1e3, "peak_memory_gb": peak})
    prior.eval()
    return counts["launches"], prior, codes


def renamed(record: dict, variant: str) -> dict:
    """A kernel record of a variant: its name carries the variant."""
    return {**record, "name": f"{record['name']} ({variant})", "variant": variant}


def quantizer_bf16_records(bf, x: torch.Tensor, launches: dict) -> list:
    """K1, K2 and K3 on the bf16 rows the bf16 stage-1 model hands its
    quantizers at batch 128 (N = 524,288 and 131,072): against their plain
    versions at TIE_RTOL and ESUM_RTOL, then timed beside the bound at 2
    bytes a row element (operations bind: unchanged), the plain version, and
    one library route (widen, then ``cdist`` + ``argmin``)."""
    flat_t, flat_b = capture_quantizer_inputs(bf, x)
    check(flat_t.dtype == flat_b.dtype == BF16 and flat_b.shape == (BATCH * 64 * 64, D),
          f"bf16 quantizer rows {flat_t.dtype} {tuple(flat_b.shape)}")
    embeds = {flat_t.shape[0]: bf.quantize_t.embed, flat_b.shape[0]: bf.quantize_b.embed}
    cases = {n: compare_with_plain(f, embeds[n], f"bf16 rows N={n}")
             for n, f in ((flat_t.shape[0], flat_t), (flat_b.shape[0], flat_b))}
    stats = {n: compare_stats_with_plain(f, embeds[n], f"bf16 rows N={n}")
             for n, f in ((flat_t.shape[0], flat_t), (flat_b.shape[0], flat_b))}
    emit("kernels_bf16", tie_rtol=TIE_RTOL, esum_rtol=ESUM_RTOL, cases=list(cases.values()),
         stats_cases=list(stats.values()))
    calls = {
        "nearest_code_ids": ((flat_b, flat_t), lambda f, e: qz.nearest_code_ids(f, e),
                             qz.nearest_code_ids_reference,
                             lambda f, e: torch.cdist(f.float(), e).argmin(1)),
        "nearest_code_lookup": ((flat_t, flat_b), lambda f, e: qz.nearest_code(f, e, False),
                                qz.nearest_code_lookup_reference,
                                lambda f, e: e[torch.cdist(f.float(), e).argmin(1)].to(f.dtype)),
        "nearest_code_stats": ((flat_b, flat_t), lambda f, e: qz.nearest_code(f, e, True),
                               qz.nearest_code_reference,
                               lambda f, e: library_stats(f.float(), e)),
    }
    records = []
    for name, (shapes, kernel, plain, library) in calls.items():
        per_shape = []
        for flat in shapes:
            n = flat.shape[0]
            embed = embeds[n]
            copies = [flat] + [flat.clone() for _ in range(max(0, 3 - n // 200000))]
            turn = itertools.count()
            rotating = lambda fn: (lambda: fn(copies[next(turn) % len(copies)], embed))  # noqa: E731
            work = (stats_work(n, D, K, 2) if name == "nearest_code_stats"
                    else kernel_work(name, n, D, K, 2))
            per_shape.append({"shape": {"n": n, "d": D, "k": K},
                              "ms": cuda_ms(rotating(kernel), reps=20),
                              "plain_ms": cuda_ms(rotating(plain), reps=5),
                              "library_ms": cuda_ms(rotating(library), reps=5), **work})
        first = per_shape[0]
        n = first["shape"]["n"]
        err = (stats[n]["esum_max_abs_err_vs_plain_sum"] if name == "nearest_code_stats"
               else max(cases[n]["largest_gap"], cases[n]["q_max_abs_err"]))
        records.append(renamed({
            "name": name, **KERNELS[name], "launches": launches[name], "max_abs_err": err,
            "id_mismatches": cases[n]["id_mismatches"],
            "shape": {**first["shape"], "dtype": "torch.bfloat16"}, "ms": first["ms"],
            "kernel_ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "library": "widen to fp32, then torch.cdist + argmin"
                       + {"nearest_code_lookup": " + index", "nearest_code_stats":
                          " + index + bincount + index_add_"}.get(name, ""),
            "share_of_bound": first["bound_ms"] / first["ms"], "shapes": per_shape}, "bf16"))
    return records


def abn_bf16_records(launches: dict) -> list:
    """K7 and K8 at the 13 ABN inputs of a bf16 EmbedNet2(resnet50) on a
    train batch of 72 images at 288x144, against their plain versions at
    ABN_TOL_BF16 (the sums at ABN_SUM_RTOL), then timed at the largest (M =
    186,624, C = 256 in bf16: byte bounds at 2 bytes an element) beside the
    plain version and ``batch_norm`` + ``leaky_relu`` on the bf16 rows."""
    from vqvae2_tpu_torch.part.part_model import EmbedNet2

    gen = torch.Generator(device="cuda").manual_seed(14)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        model = EmbedNet2(class_num=REID_IDS, arch=REID_ARCH, dtype=BF16).cuda()
    inputs = capture_abn_inputs(model, reid_batch(4, REID_P, REID_K, REID_HW, REID_IDS))
    del model
    check(len(inputs) == N_ABN and all(t.dtype == BF16 for _, t in inputs),
          f"bf16 EmbedNet2 ran {len(inputs)} ABNs on {sorted({str(t.dtype) for _, t in inputs})}")
    cases = [compare_abn_with_plain(t, f"main path {name}", gen) for name, t in inputs]
    emit("abn_kernels_bf16", tol_bf16=ABN_TOL_BF16, sum_rtol=ABN_SUM_RTOL, cases=cases)
    largest = max(inputs, key=lambda t: t[1].numel())[1]
    records = [renamed(r, "bf16") for r in abn_records(largest, launches, cases)]
    step = k8_step(inputs, seed=17)
    del inputs, largest
    torch.cuda.empty_cache()
    return records, step


def attention_mnist_records(prior, codes: torch.Tensor, launches: dict) -> list:
    """K4, K5 and K6 at the shape the MNIST prior gives them, (256, 784, 8),
    on its own q, k, v: against the plain version at FA_TOL (forward in both
    blocks, backward with dropout off and on), then timed beside their bounds,
    the plain versions and the library's attention."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    seen = capture_attention_inputs(prior, codes)
    shape = (MNIST_BATCH * N_HEAD, 28 * 28, MNIST_HEAD_DIM)
    check(len(seen) == 2 and all(t.shape == shape and t.dtype == torch.float32 for t in seen[0]),
          f"MNIST attention inputs {[tuple(t.shape) for t in seen[0]]}")
    cases = [compare_attention_with_plain(*qkv, f"MNIST prior, block {b}")
             for b, qkv in enumerate(seen)]
    do = torch.randn(*shape, generator=gen, device="cuda")
    backward = [compare_attention_backward(*seen[0], do, "MNIST prior, block 0"),
                compare_attention_backward(*seen[0], do, "MNIST prior, block 0, dropout 0.1",
                                           dropout_rate=MNIST_CONFIG["dropout"], seed=0xC0FFEE)]
    emit("attention_mnist", tolerance=FA_TOL, cases=cases, backward=backward)
    records = [attention_record(seen[0], launches, cases, sampler=False)]
    records += backward_records(seen[0], do, launches, backward)
    return [renamed(r, "MNIST") for r in records]


def phase_times_bf16(bf, x, launches_bf16, launches_reid_bf16, mnist_prior, mnist_codes,
                     launches_mnist, step_fp32: dict) -> list:
    """The kernel records of the bf16 variants and of the MNIST prior's
    attention shape; the ``k8_step`` record of both types (``step_fp32``
    from the fp32 ABN inputs)."""
    records = quantizer_bf16_records(bf, x, launches_bf16)
    abn, step_bf16 = abn_bf16_records(launches_reid_bf16)
    records += abn
    records += attention_mnist_records(mnist_prior, mnist_codes, launches_mnist)
    emit("k8_step", float32=step_fp32, bfloat16=step_bf16)
    emit("times_bf16",
         kernels={r["name"]: {k: r[k] for k in ("ms", "bound_ms", "plain_ms", "library_ms",
                                                 "launches")} for r in records})
    return records


# ---------------------------------------------------------------------------
# the adaptation path: train/vqvae_deep.py, train/adaptive.py, train/gray2color.py
# ---------------------------------------------------------------------------

DEEP_HW = REID_HW                   # SYSU at 288x144
DEEP_P, DEEP_K = 4, 4               # the three trainers' --batch_size and --num_pos
DEEP_ARCH = "resnet18"              # their --arch
DEEP_D, DEEP_CODES = 256, 512       # VQVAE_Deep's fixed embed_dim and n_embed
DEEP_STEPS = 8
ADAPTIVE_STEPS = {"adaptive": 6, "gray2color": 6}
# the deep step on the card against the CPU (batch cut to 2 x 2): the losses
# within DEEP_METRIC_RTOL; each module group's gradient no further from a
# float64 backward on the CPU than DEEP_F64_FACTOR times the CPU's own fp32
# gradient lies from it (plus a thousandth of its norm).  The fp32 gradient is
# ill-conditioned here: the fusions' batch norms normalise attention averages
# that barely vary over a sample's positions, and the AdaIN blocks' convolution
# biases have gradients that are zero in exact arithmetic (1e-17 in float64),
# so on the CPU alone the adaptor's fp32 gradient lies 5 % of its norm from the
# float64 one.
DEEP_METRIC_RTOL = 1e-3
DEEP_F64_FACTOR = 2.0


def sysu_train_batch(seed: int, p: int, k: int, hw, device="cuda"):
    """A P x K batch (``rgb``, ``ir``, ``label``) of a synthetic SYSU tree, as
    the adaptation trainers collate it."""
    from vqvae2_tpu_torch.data.sysu import SYSUData
    from vqvae2_tpu_torch.train import adaptive as tad
    from vqvae2_tpu_torch.train import reid as tr

    with tempfile.TemporaryDirectory() as d:
        tr.make_synthetic_sysu(d, n_ids=REID_IDS, per_id=8, h=hw[0], w=hw[1], seed=seed)
        ds = SYSUData(d, part=False, seed=seed)
        ds.samplize(p, k)
        rows = [ds[i] for i in range(p * k)]
    return tad.sysu_batch(rows, device)


def build_deep(seed: int, device="cuda"):
    from vqvae2_tpu_torch.models.adaptive import ModelAdaptive_Deep

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return ModelAdaptive_Deep(class_num=REID_IDS, arch=DEEP_ARCH).to(device)


@contextlib.contextmanager
def pinned_gray(seed: int):
    """The deep trainer's gray mix from numpy weights, the same on any device."""
    from vqvae2_tpu_torch.train import vqvae_deep as ttd

    saved = ttd.random_gray

    def fixed(generator, img):
        w = np.random.default_rng(seed).uniform(size=(img.shape[0], 3)).astype(np.float32) + 0.01
        w = torch.from_numpy(w / w.sum(1, keepdims=True)).to(img.device, img.dtype)
        return torch.einsum("bhwc,bc->bhw", img, w)[..., None].repeat(1, 1, 1, 3)

    ttd.random_gray = fixed
    try:
        yield
    finally:
        ttd.random_gray = saved


@contextlib.contextmanager
def quantizer_calls(model):
    """Each call of the adaptor's quantizers while the block runs, as
    ``(level, rows, codebook before the call, ids)``."""
    calls, handles = [], []
    for level in ("quantize_t", "quantize_b"):
        q = getattr(model.adaptor, level)

        def pre(mod, args, _level=level):
            calls.append([_level, args[0].detach().reshape(-1, mod.dim).clone(),
                          mod.embed.clone(), None])

        def post(mod, args, out):
            calls[-1][3] = out[2].detach().reshape(-1).clone()

        handles += [q.register_forward_pre_hook(pre), q.register_forward_hook(post)]
    try:
        yield calls
    finally:
        for h in handles:
            h.remove()


def deep_step_on(model, batch, seed: int = 0):
    """One deep train step: its metrics, the gradients it left (the ReID
    net's from its own step, the generator's from the other), and the
    quantizer calls."""
    from vqvae2_tpu_torch.train import adaptive as tad
    from vqvae2_tpu_torch.train import vqvae_deep as ttd

    tx = schedules.adam(3e-4)
    state = tad.create_state(model, tx, tx)
    with torch.enable_grad(), pinned_gray(seed), quantizer_calls(model) as calls:
        _, metrics = ttd.make_train_step(model, tx, tx, 2)(state, batch)
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}
    return {k: float(v) for k, v in metrics.items()}, grads, calls


def deep_step_against_cpu() -> dict:
    """One deep step (288x144, the batch cut to 2 x 2) on the card, on the
    CPU and on the CPU in float64, from the same weights and batch: the
    quantizer ids of each of the eight calls equal to the CPU's (or apart at
    near-ties of the CPU's own scores, within TIE_RTOL), the losses within
    DEEP_METRIC_RTOL, and each module group's gradient on the card no further
    from the float64 one than DEEP_F64_FACTOR times the CPU's fp32 gradient
    (plus 1e-3 of its norm).  Reports the card's and the CPU's distances and
    the tensors that differ most."""
    batch = sysu_train_batch(9, 2, 2, DEEP_HW, device="cpu")
    cpu = build_deep(9, "cpu")
    card = copy.deepcopy(cpu).cuda()
    c64 = copy.deepcopy(cpu).double()
    m_gpu, g_gpu, c_gpu = deep_step_on(card, {k: v.cuda() for k, v in batch.items()})
    m_cpu, g_cpu, c_cpu = deep_step_on(cpu, batch)
    _, g64, _ = deep_step_on(c64, {k: v.double() if v.is_floating_point() else v
                                   for k, v in batch.items()})
    check(len(c_gpu) == len(c_cpu) == 8, f"deep step: {len(c_gpu)} / {len(c_cpu)} quantizer calls")
    ids = []
    for (level, flat, embed, id_cpu), (_, _, _, id_gpu) in zip(c_cpu, c_gpu):
        wrong = (id_gpu.cpu() != id_cpu).nonzero().flatten()
        rel = 0.0
        if wrong.numel():
            scores = qz.nearest_code_scores(flat[wrong], embed)
            s_cpu = scores.gather(1, id_cpu[wrong].long()[:, None])[:, 0]
            s_gpu = scores.gather(1, id_gpu.cpu()[wrong].long()[:, None])[:, 0]
            scale = (flat[wrong] ** 2).sum(1) + (embed[id_cpu[wrong].long()] ** 2).sum(1)
            rel = float(((s_cpu - s_gpu).abs() / scale).max())
        check(rel <= TIE_RTOL, f"deep step: {wrong.numel()} {level} ids differ, gap {rel}")
        ids.append({"level": level, "rows": int(id_cpu.numel()), "differ": int(wrong.numel()),
                    "largest_rel_gap": rel})
    for k in m_cpu:
        check(abs(m_gpu[k] - m_cpu[k]) <= DEEP_METRIC_RTOL * abs(m_cpu[k]) + 1e-6,
              f"deep card vs CPU step: {k} {m_gpu[k]} vs {m_cpu[k]}")
    check(set(g_gpu) == set(g_cpu) == set(g64), "deep step: other parameters got gradients")
    groups = {}
    for name in g_cpu:
        top = name.split(".")[0]
        groups.setdefault("fusion" if top.startswith(("fusion", "resblocks")) else top,
                          []).append(name)

    def dist(a, b, names):
        err = sum(float(((a[n].double() - b[n].double()) ** 2).sum()) for n in names)
        return (err / sum(float((g64[n] ** 2).sum()) for n in names)) ** 0.5

    errors = {}
    for group, names in groups.items():
        card_f64, cpu_f64 = dist(g_gpu, g64, names), dist(g_cpu, g64, names)
        errors[group] = {"card_vs_float64": card_f64, "cpu_fp32_vs_float64": cpu_f64,
                         "card_vs_cpu": dist(g_gpu, g_cpu, names)}
        check(card_f64 <= DEEP_F64_FACTOR * cpu_f64 + 1e-3,
              f"deep step: the card's {group} gradient lies {card_f64} of its norm from "
              f"float64, the CPU's fp32 one {cpu_f64}")
    worst = sorted(((relative_error(g_gpu[n], g_cpu[n]), n) for n in g_cpu
                    if float(g64[n].norm()) > 1e-12), reverse=True)[:5]
    return {"hw": list(DEEP_HW), "p": 2, "k": 2, "ids": ids, "metrics_card": m_gpu,
            "metrics_cpu": m_cpu, "grad_norm_rel_err": errors,
            "worst_tensors": [{"name": n, "card_vs_cpu": e,
                               "cpu_fp32_vs_float64": relative_error(g_cpu[n], g64[n]),
                               "card_vs_float64": relative_error(g_gpu[n], g64[n])}
                              for e, n in worst]}


def phase_main_deep(tmp: str) -> dict:
    """``train.vqvae_deep.main`` at its defaults (resnet18, P = K = 4) on a
    288x144 synthetic SYSU tree for a few steps, with a sample grid at the
    last step and a validation every epoch on the raw tree of the ReID phase,
    the counters at zero before and read after: the statistics kernel ran 8
    times a step at D = 256, the lookup kernel 8 times a grid, the plain
    versions never; recon at the last step below the first; every scalar
    finite; mAP in [0, 1].  Then one step on the card against the CPU."""
    from vqvae2_tpu_torch.train import reid as tr
    from vqvae2_tpu_torch.train import vqvae_deep as ttd

    root = os.path.join(tmp, "deep")
    data = tr.make_synthetic_sysu(os.path.join(root, "blobs"), n_ids=REID_IDS, per_id=8,
                                  h=DEEP_HW[0], w=DEEP_HW[1], seed=7)
    raw = os.path.join(tmp, "reid", "SYSU-MM01")
    csv, samples, ckpt = (os.path.join(root, n) for n in ("steps.csv", "samples", "ckpt"))
    reset_all_counts()
    with launched_inputs() as seen:
        t0 = time.perf_counter()
        last = ttd.main(["--path", data, "--steps", str(DEEP_STEPS), "--log_every", "1",
                         "--metrics_csv", csv, "--sample_dir", samples, "--sample_every",
                         str(DEEP_STEPS), "--eval_every", "1", "--eval_path", raw,
                         "--ckpt_dir", ckpt])
        seconds = time.perf_counter() - t0
    counts = all_counts()                       # read just after the deep path
    recon = csv_column(csv, "recon")
    scalars = {k: csv_column(csv, k) for k in ("recon", "recon_feat", "latent", "id_ir",
                                               "feat_ir", "loss_reid", "loss_gen")}
    check(len(recon) == DEEP_STEPS and all(np.isfinite(v).all() for v in scalars.values()),
          f"deep trainer: scalars {scalars}")
    check(recon[-1] < recon[0], f"deep trainer: recon did not fall: {recon}")
    check(os.path.exists(os.path.join(samples, f"{DEEP_STEPS:05d}.png")),
          "deep trainer: no sample grid")
    check(0.0 <= last["mAP"] <= 1.0, f"deep trainer: mAP {last['mAP']}")
    check(saved_step(ckpt) == DEEP_STEPS, "deep trainer: last.pt does not hold the last step")
    check(not any(counts["plain_calls"].values()),
          f"a plain version ran on the deep path: {counts['plain_calls']}")
    want = {"nearest_code_stats": 8 * DEEP_STEPS, "nearest_code_lookup": 8,
            "nearest_code_ids": 0}
    check(all(counts["launches"][k] == v for k, v in want.items()),
          f"deep path launches {counts['launches']}, expected {want}")
    n = DEEP_P * DEEP_K
    top, bottom = n * (DEEP_HW[0] // 16) * (DEEP_HW[1] // 16), n * (DEEP_HW[0] // 8) * (
        DEEP_HW[1] // 8)
    shapes = {name: sorted(shape for _, shape in seen[name])
              for name in ("nearest_code_stats", "nearest_code_lookup")}
    check(all(v == [(top, DEEP_D), (bottom, DEEP_D)] for v in shapes.values()),
          f"deep path quantizer rows {shapes}, expected N = {top}, {bottom} at D = {DEEP_D}")
    result = {"steps": DEEP_STEPS, "p": DEEP_P, "k": DEEP_K, "hw": list(DEEP_HW),
              "seconds": seconds, **scalars, "mAP": last["mAP"], "rows": shapes, **counts,
              "step_vs_cpu": deep_step_against_cpu()}
    emit("main_deep", **result)
    return counts["launches"]


def adaptive_loss_gen_checks(scalars: dict, latent_weight: float) -> None:
    """adaptive's generator loss at every step is the sum of its logged terms
    (to the CSV's six digits), and the KL term carries at least half of its
    change over the run."""
    total = (np.asarray(scalars["mse"]) + latent_weight * np.asarray(scalars["latent"])
             + np.asarray(scalars["id_fake"]) + np.asarray(scalars["feat"])
             + np.asarray(scalars["kl_fake"]))
    check(np.allclose(total, scalars["loss_gen"], rtol=1e-4, atol=1e-5),
          f"adaptive: loss_gen {scalars['loss_gen']} is not the sum of its terms {total}")
    rise = scalars["loss_gen"][-1] - scalars["loss_gen"][0]
    kl_rise = scalars["kl_fake"][-1] - scalars["kl_fake"][0]
    check(rise <= 0 or kl_rise >= 0.5 * rise,
          f"adaptive: loss_gen rose by {rise}, its KL term by {kl_rise} only")


def phase_main_adaptive(tmp: str) -> dict:
    """``train.adaptive.main`` and ``train.gray2color.main`` at their defaults
    (resnet18, P = K = 4) on a 288x144 synthetic SYSU tree for a few steps
    each, the counters at zero before and read after each: the loss falls
    (adaptive's reconstruction: its generator loss rises at first, the sum of
    its terms, the KL term carrying the rise), every
    scalar is finite, the statistics kernel ran at D = 64 (twice a step
    and four times a step) and the plain versions never."""
    from vqvae2_tpu_torch.train import adaptive as tad
    from vqvae2_tpu_torch.train import gray2color as tg2c
    from vqvae2_tpu_torch.train import reid as tr

    data = tr.make_synthetic_sysu(os.path.join(tmp, "adaptive_blobs"), n_ids=REID_IDS,
                                  per_id=8, h=DEEP_HW[0], w=DEEP_HW[1], seed=8)
    n = DEEP_P * DEEP_K
    rows = sorted([n * (DEEP_HW[0] // 8) * (DEEP_HW[1] // 8), n * (DEEP_HW[0] // 4) * (
        DEEP_HW[1] // 4)])
    out = {}
    # adaptive's generator loss rises at first (the KL to a ReID net that
    # sharpens on the real IR view; tests/test_torch_train_adaptive.py shows
    # the JAX package's doing the same): its reconstruction is what must fall
    for name, trainer, loss, per_step in (("adaptive", tad, "mse", 2),
                                          ("gray2color", tg2c, "loss", 4)):
        steps = ADAPTIVE_STEPS[name]
        csv = os.path.join(tmp, f"{name}.csv")
        reset_all_counts()
        with launched_inputs() as seen:
            t0 = time.perf_counter()
            trainer.main(["--path", data, "--steps", str(steps), "--log_every", "1",
                          "--metrics_csv", csv])
            seconds = time.perf_counter() - t0
        counts = all_counts()                   # read just after this trainer's path
        scalars = {c: csv_column(csv, c) for c in open(csv).readline().strip().split(",")[1:]}
        check(all(np.isfinite(v).all() and len(v) == steps for v in scalars.values()),
              f"{name}: scalars {scalars}")
        check(falling(scalars[loss]), f"{name}: the loss did not fall: {scalars[loss]}")
        if name == "adaptive":
            adaptive_loss_gen_checks(scalars, tad.LATENT_LOSS_WEIGHT)
        check(not any(counts["plain_calls"].values()),
              f"a plain version ran on the {name} path: {counts['plain_calls']}")
        want = {"nearest_code_stats": per_step * steps, "nearest_code_lookup": 0,
                "nearest_code_ids": 0}
        check(all(counts["launches"][k] == v for k, v in want.items()),
              f"{name} path launches {counts['launches']}, expected {want}")
        got_rows = sorted({shape for _, shape in seen["nearest_code_stats"]})
        check(got_rows == [(r, D) for r in rows],
              f"{name}: quantizer rows {got_rows}, expected N = {rows} at D = {D}")
        out[name] = {"launches": counts["launches"]["nearest_code_stats"]}
        emit(f"main_{name}", steps=steps, p=DEEP_P, k=DEEP_K, hw=list(DEEP_HW),
             seconds=seconds, rows=got_rows, **scalars, **counts)
    return out


def deep_step_times(model, batch) -> dict:
    """One deep train step at the command line's batch (16 images at
    288x144, the batch on the card): its time by the host's clock and, by CUDA
    events around the parts of the same steps, the ReID forward + backward,
    its Adam update, the mask and gray view, the generator's forward, its
    backward (with the losses) and its Adam update; the peak memory."""
    from vqvae2_tpu_torch.train import adaptive as tad
    from vqvae2_tpu_torch.train import vqvae_deep as ttd

    tx = schedules.adam(3e-4)
    state = tad.create_state(model, tx, tx)
    step = ttd.make_train_step(model, tx, tx, DEEP_K)
    marks = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    def around(fn, before, after):
        def wrapped(*a, **kw):
            mark(before)
            out = fn(*a, **kw)
            mark(after)
            return out
        return wrapped

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.enable_grad():
        ms = host_ms(lambda: step(state, batch), 5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        saved = ttd.gen_forward
        state.opt_reid.step = around(state.opt_reid.step, "reid_adam", "reid_adam_end")
        state.opt_gen.step = around(state.opt_gen.step, "gen_adam", "gen_adam_end")
        ttd.gen_forward = around(saved, "gen_forward", "gen_forward_end")
        parts = {}
        try:
            for _ in range(5):
                marks.clear()
                mark("start")
                step(state, batch)
                torch.cuda.synchronize()
                times = [(a[0], a[1].elapsed_time(b[1])) for a, b in zip(marks, marks[1:])]
                for label, t in times:
                    parts.setdefault(label, []).append(t)
        finally:
            ttd.gen_forward = saved
            del state.opt_reid.step, state.opt_gen.step
    names = {"start": "reid_forward_backward_ms", "reid_adam": "reid_adam_ms",
             "reid_adam_end": "mask_and_gray_ms", "gen_forward": "gen_forward_ms",
             "gen_forward_end": "gen_backward_ms", "gen_adam": "gen_adam_ms"}
    split = {names[k]: float(np.mean(v)) for k, v in parts.items()}
    return {"images": DEEP_P * DEEP_K, "hw": list(DEEP_HW), "ms": ms,
            "img_per_s": DEEP_P * DEEP_K / ms * 1e3, "peak_memory_gb": peak,
            "split_ms": split, "split_sum_ms": sum(split.values())}


def deep_quantizer_rows(model, batch) -> dict:
    """``{level: (rows, codebook, ids)}`` of the deep adaptor's two quantizers
    on ``batch``'s RGB view, as a sample grid runs them."""
    with torch.no_grad(), quantizer_calls(model) as calls:
        enc_b, enc_t = model.encode_content(batch["rgb"])
        model.quantize_content(enc_b, enc_t, train=False)
    return {level: (flat, embed, ids) for level, flat, embed, ids in calls}


def seed_deep_codebooks(model, batch) -> None:
    """As ``seed_codebooks_from_data``: each of the deep adaptor's codebooks
    drawn (from a seed) among the rows its quantizer sees, top first since the
    bottom rows depend on the top codes."""
    device = model.adaptor.quantize_t.embed.device
    gen = torch.Generator(device=device).manual_seed(0)
    for level in ("quantize_t", "quantize_b"):
        flat = deep_quantizer_rows(model, batch)[level][0]
        quantizer = getattr(model.adaptor, level)
        pick = torch.randperm(flat.shape[0], generator=gen, device=device)[:quantizer.n_embed]
        quantizer.embed.copy_(flat[pick])
        quantizer.embed_avg.copy_(flat[pick])


def candidate_ranges(k: int) -> range:
    """The splits of the codebook walk over ``k`` codes that the tests here
    try: one range up to four (or as many as there are chunks)."""
    return range(1, min(4, -(-k // qz.CHUNK)) + 1)


def splits_against_whole(flat: torch.Tensor, embed: torch.Tensor, label: str) -> dict:
    """The three kernels at every split against the whole walk (one range)
    on the same rows: ids, ``q``, ``csum`` and ``esum`` bit-equal (the merge
    keeps the first maximum, and ``esum`` sums in an order fixed by the
    ids)."""
    def outputs(ranges):
        return (qz._nearest_code_ids_cuda(flat, embed, ranges),
                *qz._nearest_code_lookup_cuda(flat, embed, ranges),
                *qz._nearest_code_stats_cuda(flat, embed, ranges))

    want = outputs(1)
    differ = [r for r in candidate_ranges(embed.shape[0])
              if not all(torch.equal(a, b) for a, b in zip(outputs(r), want))]
    check(not differ, f"{label}: splits into {differ} ranges differ from the whole walk")
    return {"case": label, "ranges_bit_equal": list(candidate_ranges(embed.shape[0]))}


def cross_range_tie(gen: torch.Generator) -> dict:
    """Codes 5 and 389 of a D = 256 codebook are one row, in different ranges
    of every split of 512 codes; rows near it tie exactly across the ranges'
    boundary, and every kernel at every split must give them code 5."""
    embed = torch.randn(DEEP_CODES, DEEP_D, generator=gen, device="cuda")
    embed[389] = embed[5]
    flat = embed[5] + 0.01 * torch.randn(2592, DEEP_D, generator=gen, device="cuda")
    ids = {}
    for ranges in candidate_ranges(DEEP_CODES):
        got = (qz._nearest_code_ids_cuda(flat, embed, ranges),
               qz._nearest_code_lookup_cuda(flat, embed, ranges)[0],
               qz._nearest_code_stats_cuda(flat, embed, ranges)[0])
        ids[ranges] = sorted({int(i) for t in got for i in t.unique()})
    check(all(v == [5] for v in ids.values()), f"cross-range tie: ids by ranges {ids}")
    return {"n": flat.shape[0], "codes": [5, 389], "ids_by_ranges": ids}


def deep_records(by_path: dict) -> list:
    """K2 and K3 at D = 256 on the rows a deep train step hands its
    quantizers (N = 10,368 and 2,592 at 288x144, batch 16; K = 512).  The
    untrained adaptor puts every row on one code, so the kernels are first
    timed on its own codebooks (``one_code_ms``, the main path's first
    steps); then each codebook is drawn among its rows, the rows taken again,
    and the kernels held against their plain versions at TIE_RTOL and
    ESUM_RTOL with many codes in use, at every split against the whole
    walk bit for bit, and on an exact tie across two ranges; then timed
    beside their bounds, the plain versions and one library route each, with
    the split the wrapper launches (ranges, blocks against the card's SMs),
    each call taken apart (``search_parts``) and the ptxas lines
    of the search kernel's variants.  Also the deep step's time and split.
    ``by_path`` holds the launch counts of each path that runs these
    kernels at D = 256; a record's ``launches`` is their sum."""
    launches = {k: sum(c[k] for c in by_path.values()) for k in by_path["deep"]}
    model = build_deep(10)
    batch = sysu_train_batch(10, DEEP_P, DEEP_K, DEEP_HW)

    def by_rows(model):
        got = {flat.shape[0]: (flat, embed, int(ids.unique().numel()))
               for flat, embed, ids in deep_quantizer_rows(model, batch).values()}
        check(sorted(got) == [2592, 10368] and all(f.shape[1] == DEEP_D for f, _, _ in
                                                   got.values()),
              f"deep quantizer rows {[(n, f.shape[1]) for n, (f, _, _) in got.items()]}")
        return got

    untrained = by_rows(model)
    seed_deep_codebooks(model, batch)
    seeded = by_rows(model)
    rows = {n: (f, e) for n, (f, e, _) in seeded.items()}
    codes_used = {n: {"untrained": untrained[n][2], "drawn_from_rows": seeded[n][2]}
                  for n in rows}
    check(all(c["drawn_from_rows"] > 1 for c in codes_used.values()),
          f"deep quantizer codes in use with codebooks drawn from the rows: {codes_used}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = {n: qz.search_split(n, DEEP_CODES, sms) for n in rows}
    check(all(r > 1 for r in splits.values()), f"the deep grids do not split the search: {splits}")
    cases = {n: compare_with_plain(f, e, f"deep D=256 N={n}") for n, (f, e) in rows.items()}
    stats = {n: compare_stats_with_plain(f, e, f"deep D=256 N={n}") for n, (f, e) in rows.items()}
    every_split = [splits_against_whole(f, e, f"deep D=256 N={n}") for n, (f, e) in rows.items()]
    tie = cross_range_tie(torch.Generator(device="cuda").manual_seed(13))
    ptxas = {k: v for k, v in ptxas_summary(_build.build_info["quantize"]["log"]).items()
             if k.startswith("nearest_code_kernel")}
    emit("kernels_deep", tie_rtol=TIE_RTOL, esum_rtol=ESUM_RTOL, codes_used=codes_used,
         search_ranges=splits,
         cases=list(cases.values()), stats_cases=list(stats.values()),
         every_split=every_split, cross_range_tie=tie, ptxas=ptxas)
    calls_of = {
        "nearest_code_lookup": (lambda f, e: qz.nearest_code(f, e, False),
                                qz.nearest_code_lookup_reference,
                                lambda f, e: e[torch.cdist(f, e).argmin(1)]),
        "nearest_code_stats": (lambda f, e: qz.nearest_code(f, e, True),
                               qz.nearest_code_reference, library_stats),
    }
    records = []
    for name, (kernel, plain, library) in calls_of.items():
        per_shape = []
        for n in (10368, 2592):
            flat, embed = rows[n]
            work = (stats_work(n, DEEP_D, DEEP_CODES, 4) if name == "nearest_code_stats"
                    else kernel_work(name, n, DEEP_D, DEEP_CODES, 4))
            blocks = -(-n // qz.TILE_ROWS) * splits[n]
            one_flat, one_embed, _ = untrained[n]
            per_shape.append({"shape": {"n": n, "d": DEEP_D, "k": DEEP_CODES},
                              "codes_used": codes_used[n]["drawn_from_rows"],
                              "ms": cuda_ms(lambda: kernel(flat, embed), reps=20),
                              "one_code_ms": cuda_ms(lambda: kernel(one_flat, one_embed),
                                                     reps=20),
                              "plain_ms": cuda_ms(lambda: plain(flat, embed), reps=5),
                              "library_ms": cuda_ms(lambda: library(flat, embed), reps=5),
                              "search_ranges": splits[n], "search_blocks": blocks,
                              "sms": sms, "blocks_per_sm": blocks / sms,
                              "parts": search_parts(lambda: kernel(flat, embed)),
                              **work})
        first = per_shape[0]
        err = (stats[10368]["esum_max_abs_err_vs_plain_sum"] if name == "nearest_code_stats"
               else max(cases[10368]["largest_gap"], cases[10368]["q_max_abs_err"]))
        records.append(renamed({
            "name": name, **KERNELS[name], "launches": launches[name],
            "launches_by_path": {path: c[name] for path, c in by_path.items()},
            "max_abs_err": err,
            "id_mismatches": cases[10368]["id_mismatches"], "shape": first["shape"],
            "codes_used": first["codes_used"], "one_code_ms": first["one_code_ms"],
            "ms": first["ms"], "kernel_ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "library": "torch.cdist + argmin + index" + (" + bincount + index_add_" if
                                                         name == "nearest_code_stats" else ""),
            "share_of_bound": first["bound_ms"] / first["ms"], "shapes": per_shape,
            "ptxas": ptxas}, "deep D=256"))
    step = deep_step_times(model, batch)
    emit("times_deep", step=step,
         kernels={r["name"]: {k: r[k] for k in ("ms", "one_code_ms", "bound_ms", "plain_ms",
                                                 "library_ms", "launches", "share_of_bound")} | {
             "shapes": [{k: s[k] for k in ("shape", "codes_used", "ms", "one_code_ms",
                                           "bound_ms", "plain_ms", "library_ms", "search_ranges",
                                           "search_blocks", "blocks_per_sm", "parts")}
                        for s in r["shapes"]]} for r in records})
    del model
    torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# the cross-modal trainers: train/vqvae_deep_bi.py, train/vqvae_deep_ir.py,
# train/stargan_bi.py, and data/persons.py
# ---------------------------------------------------------------------------

CROSS_STEPS = {"deep_bi": 6, "deep_ir": 6, "stargan": 4}
CARD = "cuda"
IR_STAGE = 3                          # --stage_reconstruction of the IR phase
STARGAN_D_EVERY = 2
# the StarGAN discriminator's gradient of R1 alone on the card against a
# float64 backward on the CPU: no further from it than STARGAN_F64_FACTOR times
# the CPU's own fp32 gradient lies from it, plus R1_F64_FLOOR of its norm
STARGAN_F64_FACTOR = 2.0
R1_F64_FLOOR = 1e-3


class StepTimer:
    """CUDA events around each call of a step function built by
    ``module.<factory>`` while the block runs: ``ms`` is the mean over the
    calls after the first."""

    def __init__(self, module, factory: str):
        self.module, self.factory, self.times = module, factory, []

    def __enter__(self):
        self.saved = getattr(self.module, self.factory)

        def factory(*args, **kwargs):
            step = self.saved(*args, **kwargs)

            def timed(*a, **k):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = step(*a, **k)
                end.record()
                end.synchronize()
                self.times.append(start.elapsed_time(end))
                return out
            return timed

        setattr(self.module, self.factory, factory)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.factory, self.saved)
        self.peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    def report(self, images: int) -> dict:
        ms = float(np.mean(self.times[1:])) if len(self.times) > 1 else float("nan")
        return {"step_ms": ms, "step_ms_each": self.times, "step_img_per_s": images / ms * 1e3,
                "peak_memory_gb": self.peak_gb}


@contextlib.contextmanager
def adaptor_quantizer_calls(model, adaptors):
    """Each call of the named adaptors' quantizers while the block runs, as
    ``(level, rows, codebook before the call, ids)``."""
    calls, handles = [], []
    for name in adaptors:
        for level in ("quantize_t", "quantize_b"):
            q = getattr(getattr(model, name), level)

            def pre(mod, args, _level=f"{name}.{level}"):
                calls.append([_level, args[0].detach().reshape(-1, mod.dim).clone(),
                              mod.embed.clone(), None])

            def post(mod, args, out):
                calls[-1][3] = out[2].detach().reshape(-1).clone()

            handles += [q.register_forward_pre_hook(pre), q.register_forward_hook(post)]
    try:
        yield calls
    finally:
        for h in handles:
            h.remove()


def ids_against_cpu(c_gpu: list, c_cpu: list, label: str) -> list:
    """Each quantizer call's ids on the card equal to the CPU's, or apart at
    near-ties of the CPU's own scores (TIE_RTOL)."""
    check(len(c_gpu) == len(c_cpu), f"{label}: {len(c_gpu)} / {len(c_cpu)} quantizer calls")
    out = []
    for (level, flat, embed, id_cpu), (_, _, _, id_gpu) in zip(c_cpu, c_gpu):
        wrong = (id_gpu.cpu() != id_cpu).nonzero().flatten()
        rel = 0.0
        if wrong.numel():
            scores = qz.nearest_code_scores(flat[wrong], embed)
            s_cpu = scores.gather(1, id_cpu[wrong].long()[:, None])[:, 0]
            s_gpu = scores.gather(1, id_gpu.cpu()[wrong].long()[:, None])[:, 0]
            scale = (flat[wrong] ** 2).sum(1) + (embed[id_cpu[wrong].long()] ** 2).sum(1)
            rel = float(((s_cpu - s_gpu).abs() / scale).max())
        check(rel <= TIE_RTOL, f"{label}: {wrong.numel()} {level} ids differ, gap {rel}")
        out.append({"level": level, "rows": int(id_cpu.numel()), "differ": int(wrong.numel()),
                    "largest_rel_gap": rel})
    return out


def grads_against_float64(g_gpu: dict, g_cpu: dict, g64: dict, label: str,
                          factor: float = DEEP_F64_FACTOR, floor: float = 1e-3) -> dict:
    """Each top-level module's gradient on the card no further from the
    float64 one than ``factor`` times the CPU's fp32 gradient (plus ``floor``
    of its norm); the distances as fractions of the float64 norm."""
    check(set(g_gpu) == set(g_cpu) == set(g64), f"{label}: other parameters got gradients")
    groups = {}
    for name in g_cpu:
        groups.setdefault(name.split(".")[0], []).append(name)

    def dist(a, b, names):
        err = sum(float(((a[n].double() - b[n].double()) ** 2).sum()) for n in names)
        return (err / max(sum(float((g64[n] ** 2).sum()) for n in names), 1e-300)) ** 0.5

    errors = {}
    for group, names in groups.items():
        card, cpu = dist(g_gpu, g64, names), dist(g_cpu, g64, names)
        errors[group] = {"card_vs_float64": card, "cpu_fp32_vs_float64": cpu,
                         "card_vs_cpu": dist(g_gpu, g_cpu, names)}
        check(card <= factor * cpu + floor,
              f"{label}: the card's {group} gradient lies {card} of its norm from float64, "
              f"the CPU's fp32 one {cpu}")
    return errors


def cross_batch(seed: int, p: int, k: int, hw, device):
    """A P x K batch of a synthetic SYSU tree as the cross-modal trainers
    build it (gray mix, augmented views)."""
    from vqvae2_tpu_torch.data.sysu import SYSUData
    from vqvae2_tpu_torch.train import reid as tr
    from vqvae2_tpu_torch.train import vqvae_deep_bi as tbi

    with tempfile.TemporaryDirectory() as d:
        tr.make_synthetic_sysu(d, n_ids=REID_IDS, per_id=8, h=hw[0], w=hw[1], seed=seed)
        ds = SYSUData(d, part=False, seed=seed)
        ds.samplize(p, k)
        rows = [ds[i] for i in range(p * k)]
    return tbi.cross_modal_batch(rows, np.random.default_rng(seed), device)


def cross_step_against_cpu(label: str, build, run_step, adaptors, n_calls: int) -> dict:
    """One step (288x144, the batch cut to 2 x 2) on the card, on the CPU and
    on the CPU in float64, from the same weights and batch: the quantizer ids
    as ``deep_step_against_cpu``, the losses within DEEP_METRIC_RTOL, each
    module's gradient (what the step's last backward left) against the
    float64 one.  ``run_step(model, batch) -> metrics``."""
    t0 = time.perf_counter()
    batch = cross_batch(9, 2, 2, DEEP_HW, "cpu")
    cpu = build()
    card, c64 = copy.deepcopy(cpu).to(CARD), copy.deepcopy(cpu).double()
    results = []
    for model, b in ((card, {k: v.to(CARD) for k, v in batch.items()}), (cpu, batch),
                     (c64, {k: v.double() if v.is_floating_point() else v
                            for k, v in batch.items()})):
        with torch.enable_grad(), adaptor_quantizer_calls(model, adaptors) as calls:
            metrics = run_step(model, b)
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                 if p.grad is not None}
        results.append(({k: float(v) for k, v in metrics.items()}, grads, calls))
    (m_gpu, g_gpu, c_gpu), (m_cpu, g_cpu, c_cpu), (_, g64, _) = results
    check(len(c_cpu) == n_calls, f"{label}: {len(c_cpu)} quantizer calls, expected {n_calls}")
    ids = ids_against_cpu(c_gpu, c_cpu, label)
    for k in m_cpu:
        check(abs(m_gpu[k] - m_cpu[k]) <= DEEP_METRIC_RTOL * abs(m_cpu[k]) + 1e-6,
              f"{label}: {k} {m_gpu[k]} on the card, {m_cpu[k]} on the CPU")
    del card
    torch.cuda.empty_cache()
    return {"hw": list(DEEP_HW), "p": 2, "k": 2, "ids": ids, "metrics_card": m_gpu,
            "metrics_cpu": m_cpu,
            "grad_norm_rel_err": grads_against_float64(g_gpu, g_cpu, g64, label),
            "seconds": time.perf_counter() - t0}


def expect_launches(counts: dict, want: dict, label: str) -> None:
    check(not any(counts["plain_calls"].values()),
          f"a plain version ran on the {label} path: {counts['plain_calls']}")
    check(all(counts["launches"][k] == v for k, v in want.items()),
          f"{label} path launches {counts['launches']}, expected {want}")


def deep_rows() -> list:
    """The deep quantizers' rows at 288x144, batch P x K: ``[(N, D)]`` of the
    top and the bottom level."""
    n = DEEP_P * DEEP_K
    return [(n * (DEEP_HW[0] // 16) * (DEEP_HW[1] // 16), DEEP_D),
            (n * (DEEP_HW[0] // 8) * (DEEP_HW[1] // 8), DEEP_D)]


def phase_main_deep_bi(tmp: str) -> dict:
    """``train.vqvae_deep_bi.main`` at its defaults (resnet18, P = K = 4) on a
    288x144 synthetic SYSU tree, the counters at zero before and read after:
    the statistics kernel ran 8 times a step at D = 256 (the four
    ``VQVAE_Deep`` passes of the cycle), the other kernels and the plain
    versions never; every scalar finite; the generator's loss the sum of its
    terms and the latent loss at the last step below the first (the cycle
    loss rises at first, as in the JAX package); ``last.pt`` holds the last
    step.  Then one step on the card against the CPU (batch 2 x 2)."""
    from vqvae2_tpu_torch.models.adaptive import ModelAdaptiveBi_Deep
    from vqvae2_tpu_torch.train import reid as tr
    from vqvae2_tpu_torch.train import vqvae_deep_bi as tbi
    from vqvae2_tpu_torch.utils import schedules as sch

    steps = CROSS_STEPS["deep_bi"]
    root = os.path.join(tmp, "deep_bi")
    data = tr.make_synthetic_sysu(os.path.join(root, "blobs"), n_ids=REID_IDS, per_id=8,
                                  h=DEEP_HW[0], w=DEEP_HW[1], seed=11)
    csv, ckpt = os.path.join(root, "steps.csv"), os.path.join(root, "ckpt")
    reset_all_counts()
    with launched_inputs() as seen, StepTimer(tbi, "make_train_step") as timer:
        t0 = time.perf_counter()
        tbi.main(["--path", data, "--steps", str(steps), "--log_every", "1",
                  "--metrics_csv", csv, "--ckpt_dir", ckpt])
        seconds = time.perf_counter() - t0
    counts = all_counts()                       # read just after the bi path
    scalars = {k: csv_column(csv, k) for k in ("cycle", "latent", "id_ir", "feat_ir",
                                               "disc_fake", "loss_gen", "loss_reid",
                                               "img_per_s")}
    check(all(len(v) == steps and np.isfinite(v).all() for v in scalars.values()),
          f"deep_bi: scalars {scalars}")
    # the cycle loss rises over the first steps at the defaults, in the JAX
    # package too (tests/test_torch_train_vqvae_deep_bi.py): the ReID step
    # moves the styles; the codebooks' commitment falls
    check(scalars["latent"][-1] < scalars["latent"][0],
          f"deep_bi: the latent loss did not fall: {scalars['latent']}")
    terms = (np.asarray(scalars["cycle"]) + tbi.LATENT_LOSS_WEIGHT * np.asarray(scalars["latent"])
             + 0.5 * (np.asarray(scalars["id_ir"]) + np.asarray(scalars["feat_ir"])
                      + np.asarray(scalars["disc_fake"])))
    check(np.allclose(terms, scalars["loss_gen"], rtol=1e-4, atol=1e-5),
          f"deep_bi: loss_gen {scalars['loss_gen']} is not the sum of its terms {terms}")
    check(saved_step(ckpt) == steps, "deep_bi: last.pt does not hold the last step")
    expect_launches(counts, {"nearest_code_stats": 8 * steps, "nearest_code_lookup": 0,
                             "nearest_code_ids": 0}, "deep_bi")
    rows = sorted(shape for _, shape in seen["nearest_code_stats"])
    check(rows == deep_rows(), f"deep_bi: quantizer rows {rows}, expected {deep_rows()}")

    def build():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(9)
            return ModelAdaptiveBi_Deep(class_num=REID_IDS, arch=DEEP_ARCH)

    def run_step(model, batch):
        tx_reid = sch.SGDSchedule(tbi.reid_lr_schedule(0.1, 1), weight_decay=5e-4)
        tx_gen = sch.adam(3e-4)
        state = tbi.create_state(model, tx_reid, tx_gen)
        return tbi.make_train_step(model, tx_reid, tx_gen, 2)(state, batch)[1]

    result = {"steps": steps, "p": DEEP_P, "k": DEEP_K, "hw": list(DEEP_HW), "seconds": seconds,
              **timer.report(DEEP_P * DEEP_K), "command_line_img_per_s": scalars["img_per_s"][-1],
              **scalars, "rows": rows, **counts,
              "step_vs_cpu": cross_step_against_cpu("deep_bi step", build, run_step,
                                                    ("adaptor1", "adaptor2"), 8)}
    emit("main_deep_bi", **result)
    return counts["launches"]


def phase_main_deep_ir(tmp: str) -> dict:
    """``train.vqvae_deep_ir.main`` at its defaults with ``--stage_reconstruction
    3`` on a 288x144 persons corpus written by ``data/persons.py``, so both
    step functions run, with a sample grid at the last step, the counters at
    zero before and read after: the statistics kernel 2 times a
    reconstruction step and 4 times a full step, the lookup kernel 4 times a
    grid, the plain versions never; every scalar finite; the reconstruction
    falls over its stage; ``last.pt`` holds the last step.  Then one full
    step on the card against the CPU (batch 2 x 2; the ReID step's Adam at
    rate 0, so the generator step meets the same ReID net everywhere)."""
    from vqvae2_tpu_torch.data import persons
    from vqvae2_tpu_torch.models.adaptive import ModelAdaptive_Deep
    from vqvae2_tpu_torch.train import adaptive as tad
    from vqvae2_tpu_torch.train import vqvae_deep_ir as tir
    from vqvae2_tpu_torch.utils import schedules as sch

    steps = CROSS_STEPS["deep_ir"]
    root = os.path.join(tmp, "deep_ir")
    t0 = time.perf_counter()
    data = persons.save_person_sysu(os.path.join(root, "persons"), n_ids=REID_IDS, per_id=8,
                                    hw=DEEP_HW, seed=0)
    corpus_seconds = time.perf_counter() - t0
    csv, ckpt, samples = (os.path.join(root, n) for n in ("steps.csv", "ckpt", "samples"))
    reset_all_counts()
    with launched_inputs() as seen, StepTimer(tir, "make_full_step") as timer:
        t0 = time.perf_counter()
        tir.main(["--path", data, "--steps", str(steps), "--stage_reconstruction", str(IR_STAGE),
                  "--log_every", "1", "--metrics_csv", csv, "--ckpt_dir", ckpt,
                  "--sample_dir", samples, "--sample_every", str(steps)])
        seconds = time.perf_counter() - t0
    counts = all_counts()                       # read just after the IR path
    scalars = {k: csv_column(csv, k) for k in ("recon", "latent", "loss_gen", "loss_reid",
                                               "img_per_s")}
    check(all(len(v) == steps and np.isfinite(v).all() for v in scalars.values()),
          f"deep_ir: scalars {scalars}")
    recon = scalars["recon"]
    check(recon[IR_STAGE - 1] < recon[0] and all(r == 0.0 for r in recon[IR_STAGE:]),
          f"deep_ir: the reconstruction did not fall over its stage: {recon}")
    check(all(r == 0.0 for r in scalars["loss_reid"][:IR_STAGE])
          and all(r > 0.0 for r in scalars["loss_reid"][IR_STAGE:]),
          f"deep_ir: the ReID step ran outside the full stage: {scalars['loss_reid']}")
    check(os.path.exists(os.path.join(samples, f"{steps:05d}.png")), "deep_ir: no sample grid")
    check(saved_step(ckpt) == steps, "deep_ir: last.pt does not hold the last step")
    full = steps - IR_STAGE
    expect_launches(counts, {"nearest_code_stats": 2 * IR_STAGE + 4 * full,
                             "nearest_code_lookup": 4, "nearest_code_ids": 0}, "deep_ir")
    shapes = {name: sorted({shape for _, shape in seen[name]})
              for name in ("nearest_code_stats", "nearest_code_lookup")}
    check(all(v == deep_rows() for v in shapes.values()),
          f"deep_ir: quantizer rows {shapes}, expected {deep_rows()}")

    def build():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(9)
            return ModelAdaptive_Deep(class_num=REID_IDS, arch=DEEP_ARCH)

    def run_step(model, batch):
        # the ReID step's Adam at rate 0: the generator step that follows runs
        # through the ReID net, and Adam's first update moves each of its
        # weights by about lr * sign(g), which for the weights whose gradient
        # is rounding noise differs between the devices
        tx_reid, tx_gen = sch.adam(0.0), sch.adam(3e-4)
        state = tad.create_state(model, tx_reid, tx_gen)
        return tir.make_full_step(model, tx_reid, tx_gen, 2)(state, batch)[1]

    result = {"steps": steps, "stage_reconstruction": IR_STAGE, "p": DEEP_P, "k": DEEP_K,
              "hw": list(DEEP_HW), "corpus_seconds": corpus_seconds, "seconds": seconds,
              **{f"full_{k}": v for k, v in timer.report(DEEP_P * DEEP_K).items()},
              "command_line_img_per_s": scalars["img_per_s"][-1], **scalars, "rows": shapes,
              **counts,
              "full_step_vs_cpu": cross_step_against_cpu("deep_ir full step", build, run_step,
                                                         ("adaptor",), 4)}
    emit("main_deep_ir", **result)
    return counts["launches"]


def stargan_r1_against_float64(model) -> dict:
    """The gradient of R1 alone in the discriminator's parameters at 288x144
    (one image a domain) on the card, on the CPU and on the CPU in float64,
    from the run's own weights: the card's no further from float64 than
    STARGAN_F64_FACTOR times the CPU's fp32 one, plus R1_F64_FLOOR."""
    t0 = time.perf_counter()
    batch = cross_batch(12, 1, 1, DEEP_HW, "cpu")
    disc = copy.deepcopy(model.discriminator).cpu()
    out = []
    for dev, dt in ((CARD, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        d = copy.deepcopy(disc).to(dev, dt)
        x = torch.cat([batch["gray"][:1], batch["ir"][:1]]).mean(-1, keepdim=True).repeat(
            1, 1, 1, 3).to(dev, dt).requires_grad_(True)
        y = torch.tensor([1, 0], device=dev)
        with torch.enable_grad():
            grad_x, = torch.autograd.grad(d(x, y).sum(), x, create_graph=True)
            r1 = 0.5 * torch.mean(torch.sum(torch.square(grad_x.reshape(2, -1)), dim=1))
            r1.backward()
        # a parameter that R1 does not reach (the head's bias) has no gradient
        out.append((float(r1.detach()), {n: (torch.zeros_like(p) if p.grad is None else
                                             p.grad).detach().cpu()
                                         for n, p in d.named_parameters()}))
    (r_gpu, g_gpu), (r_cpu, g_cpu), (r64, g64) = out
    names = list(g64)

    def dist(a):
        err = sum(float(((a[n].double() - g64[n]) ** 2).sum()) for n in names)
        return (err / sum(float((g64[n] ** 2).sum()) for n in names)) ** 0.5

    card, cpu = dist(g_gpu), dist(g_cpu)
    check(r64 > 0 and card <= STARGAN_F64_FACTOR * cpu + R1_F64_FLOOR,
          f"stargan: R1's gradient on the card lies {card} of its norm from float64, "
          f"the CPU's fp32 one {cpu}")
    return {"r1_card": r_gpu, "r1_cpu": r_cpu, "r1_float64": r64, "card_vs_float64": card,
            "cpu_fp32_vs_float64": cpu, "factor": STARGAN_F64_FACTOR, "floor": R1_F64_FLOOR,
            "seconds": time.perf_counter() - t0}


def stargan_remat_bit_equal() -> dict:
    """One StarGAN step (288x144, batch 2 x 2) with ``remat`` on and off from
    the same weights and batch: every gradient the step leaves and every
    parameter after it bit-equal (deterministic cuDNN); the peak memory and
    time of each."""
    from vqvae2_tpu_torch.models.stargan import ModelStarGAN
    from vqvae2_tpu_torch.train import stargan_bi as tsb
    from vqvae2_tpu_torch.utils import schedules as sch

    batch = cross_batch(13, 2, 2, DEEP_HW, CARD)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(13)
        base = ModelStarGAN(class_num=REID_IDS, arch=DEEP_ARCH,
                            img_size=tsb._generator_img_size(*DEEP_HW))
    out, runs = {}, {}
    for remat in (True, False):
        model = copy.deepcopy(base).to(CARD)
        model.remat = remat
        tx_reid, tx_gen, tx_disc = sch.SGDSchedule(0.1), sch.adam(1e-4), sch.adam(1e-4)
        state = tsb.create_state(model, tx_reid, tx_gen, tx_disc)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.enable_grad():
            _, metrics = tsb.make_train_step(model, tx_reid, tx_gen, tx_disc, 2)(state, batch)
        torch.cuda.synchronize()
        out[f"remat_{remat}"] = {"ms": (time.perf_counter() - t0) * 1e3,
                                 "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        runs[remat] = ({n: p.grad.clone() for n, p in model.named_parameters()},
                       {k: v.clone() for k, v in model.state_dict().items()},
                       {k: float(v) for k, v in metrics.items()})
        del model, state
    differ = [n for n in runs[True][0] if not torch.equal(runs[True][0][n], runs[False][0][n])]
    differ += [k for k in runs[True][1] if not torch.equal(runs[True][1][k], runs[False][1][k])]
    check(not differ and runs[True][2] == runs[False][2],
          f"stargan: remat on and off differ at {differ[:5]} ({len(differ)} tensors)")
    torch.cuda.empty_cache()
    return {"p": 2, "k": 2, "bit_equal": True, "tensors": len(runs[True][0]), **out}


def phase_main_stargan(tmp: str) -> dict:
    """``train.stargan_bi.main`` at its defaults (resnet18, P = K = 4; the
    generators at ``img_size`` 128) on a 288x144 synthetic SYSU tree with
    ``--d_every 2``, a sample grid and an identity-preservation eval at the
    last step, the counters at zero before and read after: no quantizer
    kernel and no plain version ran; every scalar finite and R1 > 0; the
    discriminator's parameters unchanged over each masked step and changed
    over each other; the mAP in [0, 1]; ``last.pt`` holds the last step.
    Then R1's gradient against float64 and ``remat`` on and off bit for
    bit."""
    from vqvae2_tpu_torch.train import reid as tr
    from vqvae2_tpu_torch.train import stargan_bi as tsb

    steps = CROSS_STEPS["stargan"]
    root = os.path.join(tmp, "stargan")
    data = tr.make_synthetic_sysu(os.path.join(root, "blobs"), n_ids=REID_IDS, per_id=8,
                                  h=DEEP_HW[0], w=DEEP_HW[1], seed=12)
    csv, ckpt, samples = (os.path.join(root, n) for n in ("steps.csv", "ckpt", "samples"))
    moved, models = [], []
    saved_create = tsb.create_state

    def create_state(model, *a, **k):
        models.append(model)
        return saved_create(model, *a, **k)

    def d_params():
        return [p.detach().clone() for p in models[0].discriminator.parameters()]

    reset_all_counts()
    tsb.create_state = create_state
    try:
        with StepTimer(tsb, "make_train_step") as timer:
            saved_factory = tsb.make_train_step

            def watching(*a, **k):
                step = saved_factory(*a, **k)

                def watched(state, batch, knobs=None):
                    before = d_params()
                    out = step(state, batch, knobs)
                    moved.append((float(knobs["d_mask"]), any(
                        not torch.equal(x, y) for x, y in zip(before, d_params()))))
                    return out
                return watched

            tsb.make_train_step = watching
            t0 = time.perf_counter()
            last = tsb.main(["--path", data, "--steps", str(steps), "--log_every", "1",
                             "--metrics_csv", csv, "--ckpt_dir", ckpt, "--d_every",
                             str(STARGAN_D_EVERY), "--sample_dir", samples, "--sample_every",
                             str(steps), "--eval_every", str(steps), "--idpres_trials", "2"])
            seconds = time.perf_counter() - t0
    finally:
        tsb.create_state = saved_create
    counts = all_counts()                       # read just after the StarGAN path
    scalars = {k: csv_column(csv, k) for k in ("cycle", "id_ir", "feat_ir", "g_adv",
                                               "loss_reid", "loss_gen", "loss_disc", "d_real",
                                               "d_fake", "r1", "img_per_s")}
    check(all(len(v) == steps and np.isfinite(v).all() for v in scalars.values()),
          f"stargan: scalars {scalars}")
    check(all(r > 0 for r in scalars["r1"]), f"stargan: R1 {scalars['r1']}")
    want_moved = [(1.0 if i % STARGAN_D_EVERY == 0 else 0.0, i % STARGAN_D_EVERY == 0)
                  for i in range(steps)]
    check(moved == want_moved, f"stargan: (d_mask, D moved) a step {moved}, "
                               f"expected {want_moved}")
    check(0.0 <= last["idpres_map"] <= 1.0, f"stargan: mAP {last['idpres_map']}")
    check(os.path.exists(os.path.join(samples, f"{steps:05d}.png")), "stargan: no sample grid")
    check(saved_step(ckpt) == steps, "stargan: last.pt does not hold the last step")
    expect_launches(counts, {k: 0 for k in ("nearest_code_stats", "nearest_code_lookup",
                                            "nearest_code_ids")}, "stargan")
    r1 = stargan_r1_against_float64(models[0])
    del models[:]
    torch.cuda.empty_cache()
    result = {"steps": steps, "p": DEEP_P, "k": DEEP_K, "hw": list(DEEP_HW),
              "img_size": tsb._generator_img_size(*DEEP_HW), "d_every": STARGAN_D_EVERY,
              "seconds": seconds, **timer.report(DEEP_P * DEEP_K),
              "command_line_img_per_s": scalars["img_per_s"][-1], **scalars,
              "d_mask_and_moved": moved, "idpres_map": last["idpres_map"], **counts,
              "r1_vs_float64": r1, "remat": stargan_remat_bit_equal()}
    emit("main_stargan", **result)
    return counts["launches"]


# ---------------------------------------------------------------------------
# the detection trainers: train/detection.py (SSD300) and train/maskrcnn.py
# ---------------------------------------------------------------------------

DET_STEPS = {"ssd": 8, "maskrcnn": 8}
# each module group's gradient of one step on the card no further from a
# float64 backward on the CPU than DET_F64_FACTOR times the CPU's own fp32
# gradient lies from it, plus DET_F64_FLOOR of its norm; the losses within
# DET_METRIC_RTOL of the CPU's
DET_F64_FACTOR = 2.0
DET_F64_FLOOR = 1e-3
DET_METRIC_RTOL = 1e-4
ROI_ALIGN_RTOL = 1e-6
# encode_targets' offsets pass through log and divisions, whose CUDA and CPU
# versions may round apart by an ulp; its class targets must be bit-equal
LOC_TARGET_RTOL = 1e-6
DET_CLASSES = 14                      # make_synthetic_coco's 13 classes and background


class EvalTimer:
    """Host seconds of each call of ``module.<name>`` while the block runs
    (the evaluators run NMS and mask pasting on the host)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.seconds = module, name, []

    def __enter__(self):
        self.saved = getattr(self.module, self.name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = self.saved(*a, **k)
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]).splitlines()[0]


def rate_after_first(csv: str, batch: int) -> float:
    """The command line's img/s over its steps after the first, from the
    cumulative rates it logged every step (``n * batch / elapsed``)."""
    steps, rates = csv_column(csv, "step"), csv_column(csv, "img_per_s")
    elapsed = [n * batch / r for n, r in zip(steps, rates)]
    return (steps[-1] - steps[0]) * batch / (elapsed[-1] - elapsed[0])


def detection_grads(model, run_step, batch) -> tuple:
    """``run_step(model, batch)``'s metrics and the gradients it left, on
    the CPU."""
    metrics = run_step(model, batch)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None})


def detection_step_against_cpu(label: str, build, run_step, batch: dict,
                               device: str = CARD) -> dict:
    """One train step of ``build()``'s weights on the card, on the CPU and
    on the CPU in float64, on ``batch`` (numpy): the metrics within
    DET_METRIC_RTOL of the CPU's, and each module group's gradient on the
    card within DET_F64_FACTOR times the CPU's fp32 distance from float64
    (plus DET_F64_FLOOR).  Returns the distances."""
    cpu = build()
    card = copy.deepcopy(cpu).to(device)
    c64 = copy.deepcopy(cpu).double()

    def on(dev, dtype=None):
        return {k: torch.from_numpy(v).to(dev, dtype if dtype and v.dtype == np.float32
                                           else None) for k, v in batch.items()}

    with torch.enable_grad():
        m_card, g_card = detection_grads(card, run_step, on(device))
        m_cpu, g_cpu = detection_grads(cpu, run_step, on("cpu"))
        _, g64 = detection_grads(c64, run_step, on("cpu", torch.float64))
    for k in m_cpu:
        check(abs(m_card[k] - m_cpu[k]) <= DET_METRIC_RTOL * abs(m_cpu[k]) + 1e-6,
              f"{label} card vs CPU step: {k} {m_card[k]} vs {m_cpu[k]}")
    check(set(g_card) == set(g_cpu) == set(g64), f"{label}: other parameters got gradients")
    groups = {}
    for name in g_cpu:
        groups.setdefault(name.split(".")[0], []).append(name)

    def dist(a, b, names):
        err = sum(float(((a[n].double() - b[n].double()) ** 2).sum()) for n in names)
        return (err / max(sum(float((g64[n] ** 2).sum()) for n in names), 1e-300)) ** 0.5

    errors = {}
    for group, names in groups.items():
        card_f64, cpu_f64 = dist(g_card, g64, names), dist(g_cpu, g64, names)
        errors[group] = {"card_vs_float64": card_f64, "cpu_fp32_vs_float64": cpu_f64,
                         "card_vs_cpu": dist(g_card, g_cpu, names)}
        check(card_f64 <= DET_F64_FACTOR * cpu_f64 + DET_F64_FLOOR,
              f"{label}: the card's {group} gradient lies {card_f64} of its norm from "
              f"float64, the CPU's fp32 one {cpu_f64}")
    return {"metrics_card": m_card, "metrics_cpu": m_cpu, "grad_norm_rel_err": errors}


def shared_best_box_targets(device: str = CARD) -> dict:
    """``encode_targets`` on the card and on the CPU on a batch where two
    ground truths are one box (one best default box, which the later one
    must claim) and padded rows follow them: the class targets bit for bit,
    the offsets within LOC_TARGET_RTOL."""
    from vqvae2_tpu_torch.detection import boxes as dbx

    db = torch.from_numpy(dbx.default_boxes_ssd300())
    gt = torch.zeros(2, 6, 4)
    labels = torch.zeros(2, 6, dtype=torch.int32)
    gt[0, 0] = gt[0, 2] = torch.tensor([0.30, 0.30, 0.50, 0.55])
    gt[0, 1] = torch.tensor([0.05, 0.60, 0.25, 0.95])
    labels[0, :3] = torch.tensor([3, 5, 7], dtype=torch.int32)
    gt[1, 0] = torch.tensor([0.55, 0.10, 0.90, 0.40])
    gt[1, 1] = dbx.ltrb_from_cxcywh(db[0])
    labels[1, :2] = torch.tensor([2, 4], dtype=torch.int32)
    out = {}
    for dev in ("cpu", device):
        out[dev] = [t.cpu() for t in dbx.encode_targets(
            gt.to(dev), labels.to(dev), dbx.ltrb_from_cxcywh(db).to(dev), db.to(dev))]
    (loc_cpu, cls_cpu), (loc_card, cls_card) = out["cpu"], out[device]
    best = int(torch.argmax(dbx.box_iou(dbx.ltrb_from_cxcywh(db), gt[0, :1])[:, 0]))
    loc_err = relative_error(loc_card, loc_cpu)
    check(torch.equal(cls_card, cls_cpu), "ssd: encode_targets' classes on the card differ "
                                          f"from the CPU's at {int((cls_card != cls_cpu).sum())}")
    check(loc_err <= LOC_TARGET_RTOL, f"ssd: encode_targets' offsets on the card lie {loc_err} "
                                      f"of the largest from the CPU's")
    check(int(cls_card[0, best]) == 7, f"ssd: the shared best box took label "
                                       f"{int(cls_card[0, best])}, not the last claim's 7")
    return {"classes_bit_equal": True, "offsets_bit_equal": bool(torch.equal(loc_card, loc_cpu)),
            "offsets_rel_err": loc_err, "matched": int((cls_card > 0).sum()), "shared_box": best}


def phase_main_ssd(tmp: str, device: str = CARD) -> dict:
    """``train.detection.main --synthetic --eval`` at the command line's
    defaults (300 px, batch 8, resnet18, 14 classes) for DET_STEPS["ssd"]
    steps, the counters at zero before and read after: no kernel of the port
    and no plain version ran; every loss finite and the last below the
    first; mAP and AP50 in [0, 1].  Then one step at batch 2 on the card
    against the CPU and float64, and ``encode_targets`` with a shared best
    box on the card against the CPU."""
    from vqvae2_tpu_torch.detection.data import CocoDetectionDataset, make_synthetic_coco
    from vqvae2_tpu_torch.detection.ssd import SSD300
    from vqvae2_tpu_torch.train import detection as tdet

    steps = DET_STEPS["ssd"]
    csv = os.path.join(tmp, "ssd_steps.csv")
    reset_all_counts()
    with StepTimer(tdet, "make_train_step") as timer, EvalTimer(tdet, "evaluate") as ev:
        t0 = time.perf_counter()
        last = tdet.main(["--synthetic", "--steps", str(steps), "--log_every", "1",
                          "--metrics_csv", csv, "--eval", "--device", device])
        seconds = time.perf_counter() - t0
    counts = all_counts()                        # read just after the SSD path
    expect_launches(counts, {k: 0 for k in counts["launches"]}, "ssd")
    losses, rates = csv_column(csv, "loss"), csv_column(csv, "img_per_s")
    check(len(losses) == steps and np.isfinite(losses).all(), f"ssd: losses {losses}")
    check(losses[-1] < losses[0], f"ssd: the loss did not fall: {losses}")
    check(all(0.0 <= last[k] <= 1.0 for k in ("mAP", "AP50")),
          f"ssd: mAP {last['mAP']}, AP50 {last['AP50']}")

    data = os.path.join(tmp, "ssd_coco")
    img_dir, ann = make_synthetic_coco(data, size=300)
    imgs, gt_boxes, gt_labels, _ = next(CocoDetectionDataset(img_dir, ann, size=300).batches(
        2, seed=5))

    def build():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(7)
            return SSD300(num_classes=DET_CLASSES)

    def run_step(model, batch):
        tx = tdet.make_optimizer(0.002, 100)
        state = tdet.create_state(model, tx)
        _, loss = tdet.make_train_step(model, tx, tdet.B.default_boxes_ssd300())(
            state, batch["imgs"], batch["boxes"], batch["labels"])
        return {"loss": loss}

    result = {"card": card_name(), "steps": steps, "batch": 8, "size": 300, "arch": "resnet18",
              "classes": DET_CLASSES, "seconds": seconds, **timer.report(8),
              "command_line_img_per_s": rates[-1],
              "command_line_img_per_s_after_first": rate_after_first(csv, 8), "losses": losses,
              "eval_host_seconds": ev.seconds,
              **{k: last[k] for k in ("mAP", "AP50", "AP75")}, **counts,
              "step_vs_cpu": detection_step_against_cpu(
                  "ssd", build, run_step,
                  {"imgs": imgs, "boxes": gt_boxes, "labels": gt_labels}, device),
              "encode_targets": shared_best_box_targets(device)}
    emit("main_ssd", **result)
    return result


def roi_align_against_cpu(model, batch: dict, anchors: np.ndarray) -> dict:
    """``roi_align`` at 7 and 14 on the card against the CPU on one train-mode
    step's own p2 and RoIs (the top-K proposals and the ground truth),
    within ROI_ALIGN_RTOL of the largest sample."""
    from vqvae2_tpu_torch.detection import mask_rcnn as dm

    dev = next(model.parameters()).device
    anchors_t = torch.from_numpy(anchors).to(dev)
    gt = torch.from_numpy(batch["boxes"]).to(dev)
    with torch.no_grad():
        obj, reg, p2 = model.train()(torch.from_numpy(batch["imgs"]).to(dev))
        rois = torch.cat([dm.decode_proposals(anchors_t, obj, reg, model.num_proposals)[0], gt],
                         dim=1)
        out = {}
        for size in (7, 14):
            card = dm.roi_align(p2, rois, size).cpu()
            cpu = dm.roi_align(p2.cpu(), rois.cpu(), size)
            err = relative_error(card, cpu)
            check(err <= ROI_ALIGN_RTOL, f"maskrcnn: roi_align at {size} on the card lies {err} "
                                         f"of its largest sample from the CPU's")
            out[str(size)] = {"rel_err": err, "bit_equal": bool(torch.equal(card, cpu)),
                              "shape": list(card.shape)}
    return out


def phase_main_maskrcnn(tmp: str, device: str = CARD) -> dict:
    """``train.maskrcnn.main --synthetic --eval`` at the command line's
    defaults (256 px, batch 4, 64 proposals, 64 ground-truth slots, anchors
    32/64/128) for DET_STEPS["maskrcnn"] steps, the counters at zero before
    and read after: no kernel of the port and no plain version ran; each of
    the five loss terms finite, ``loss`` their sum, and the loss falls;
    mAP, mask_mAP and mask_mIoU in [0, 1].  Then one step at batch 1 on the
    card against the CPU and float64, ``roi_align`` on the card against the
    CPU on that step's p2 and RoIs, and (reported, not checked) whether two
    gradients from one state are bit-equal on the card."""
    from vqvae2_tpu_torch.detection import mask_rcnn as dm
    from vqvae2_tpu_torch.detection.data import CocoDetectionDataset, make_synthetic_coco
    from vqvae2_tpu_torch.train import maskrcnn as tmr
    from vqvae2_tpu_torch.utils import schedules as sch

    steps = DET_STEPS["maskrcnn"]
    terms = ("rpn_cls", "rpn_reg", "roi_cls", "roi_reg", "mask")
    csv = os.path.join(tmp, "maskrcnn_steps.csv")
    seen = []
    saved = tmr.make_train_step

    def watching(*a, **k):
        step = saved(*a, **k)

        def watched(*args):
            state, metrics = step(*args)
            seen.append({n: float(v) for n, v in metrics.items()})
            return state, metrics
        return watched

    reset_all_counts()
    tmr.make_train_step = watching
    try:
        with StepTimer(tmr, "make_train_step") as timer, EvalTimer(tmr, "evaluate_instances") as ev:
            t0 = time.perf_counter()
            last = tmr.main(["--synthetic", "--steps", str(steps), "--log_every", "1",
                             "--metrics_csv", csv, "--eval", "--device", device])
            seconds = time.perf_counter() - t0
    finally:
        tmr.make_train_step = saved
    counts = all_counts()                        # read just after the Mask R-CNN path
    expect_launches(counts, {k: 0 for k in counts["launches"]}, "maskrcnn")
    check(len(seen) == steps and all(np.isfinite(m[k]) for m in seen for k in terms + ("loss",)),
          f"maskrcnn: losses {seen}")
    for m in seen:
        total = sum(m[k] for k in terms)
        check(abs(m["loss"] - total) <= 1e-5 * abs(total), f"maskrcnn: loss {m['loss']} is not "
                                                           f"the sum of its terms {total}")
    losses = [m["loss"] for m in seen]
    check(falling(losses), f"maskrcnn: the loss did not fall: {losses}")
    check(all(0.0 <= last[k] <= 1.0 for k in ("mAP", "mask_mAP", "mask_mIoU")),
          f"maskrcnn: mAP {last['mAP']}, mask_mAP {last['mask_mAP']}, "
          f"mask_mIoU {last['mask_mIoU']}")

    img_dir, ann = make_synthetic_coco(os.path.join(tmp, "maskrcnn_coco"), size=256,
                                       with_masks=True)
    imgs, gt_boxes, gt_labels, _, gt_masks = next(CocoDetectionDataset(
        img_dir, ann, size=256, with_masks=True, max_boxes=64).batches(1, seed=5,
                                                                       with_masks=True))
    batch = {"imgs": imgs, "boxes": gt_boxes, "labels": gt_labels, "masks": gt_masks}
    anchors = dm.generate_anchors(256, sizes=(32, 64, 128))
    args = tmr.build_argparser().parse_args(["--seed", "7"])

    def build():
        return tmr.build_model(args, DET_CLASSES, "cpu")

    def run_step(model, batch):
        tx = sch.adam(1e-4)
        state = tmr.create_state(model, tx)
        return tmr.make_train_step(model, tx, anchors)(
            state, batch["imgs"], batch["boxes"], batch["labels"], batch["masks"])[1]

    vs_cpu = detection_step_against_cpu("maskrcnn", build, run_step, batch, device)
    grads = []
    for _ in range(2):
        card = build().to(device)
        with torch.enable_grad():
            grads.append(detection_grads(card, run_step, {
                k: torch.from_numpy(v).to(device) for k, v in batch.items()})[1])
    differ = [n for n in grads[0] if not torch.equal(grads[0][n], grads[1][n])]
    result = {"card": card_name(), "steps": steps, "batch": 4, "size": 256, "num_proposals": 64,
              "max_boxes": 64,
              "arch": "resnet18", "seconds": seconds, **timer.report(4),
              "command_line_img_per_s": csv_column(csv, "img_per_s")[-1],
              "command_line_img_per_s_after_first": rate_after_first(csv, 4),
              "losses": {k: [m[k] for m in seen] for k in terms + ("loss",)},
              "eval_host_seconds": ev.seconds,
              **{k: last[k] for k in ("mAP", "AP50", "mask_mAP", "mask_AP50", "mask_mIoU")},
              **counts, "step_vs_cpu": vs_cpu,
              "roi_align_vs_cpu": roi_align_against_cpu(build().to(device), batch, anchors),
              "repeat_bit_equal": {"equal": not differ, "tensors_differ": len(differ),
                                   "of": len(grads[0]), "first": differ[:5]}}
    emit("main_maskrcnn", **result)
    return result


# ---------------------------------------------------------------------------
# Phase parallel: the data-parallel layer (parallel/) on the card
# ---------------------------------------------------------------------------

PAR_STEPS = 3                       # each trainer's steps in the world-1 runs
PAR_EXTRACT_BATCH = 16              # extract_codes.main --synthetic: 4 batches, 64 images
GLOO_WORLD = 2                      # ranks on the one card, all on cuda:0
GLOO_DEVICE = "cuda:0"
GLOO_EXTRACT = dict(n_images=9, batch=4)   # a last batch of one image: rank 1 gets none
GLOO_TIMED_STEPS = 4                # timed steps of each trainer at world 2, after the first
GLOO_JOIN_SECONDS = 600.0
# World 2 against world 1 on the card: each gradient tensor within GRAD_RTOL
# of its largest element, as the card is held to the CPU (a floor of a
# thousandth of the whole gradient's largest, for tensors whose gradient
# vanishes analytically).  Not tighter: cuDNN takes other algorithms for half
# the batch, which round an image's activations otherwise, so a few ids flip
# at near-ties and move the stage-1 gradient by 1.9e-4 of a tensor's largest
# element (this phase on one NVIDIA H100 80GB HBM3, 700 W; the ranks' shares
# are also summed in another order).
PAR_GRAD_RTOL = GRAD_RTOL
# The same rounding moves a few of world 1's results by more than a rounding:
# an id that flips at a near-tie moves a row between two codes of the
# codebook, and, in the ABNs, a pre-activation that the moments' last bit
# moves across the leaky ReLU's kink changes its dy by 99 %.  So the codebooks
# after the step and the ABNs' z, dx, dweight, dbias and running statistics
# are held as whole tensors, each within PAR_NORM_RTOL of its norm (what the
# ReID step on the card is held to against the CPU), with the elementwise
# errors reported; ids may flip in at most PAR_FLIP_SHARE of the rows, the top
# quantizer's (whose rows come from the encoder alone) only at near-ties
# (TIE_RTOL); the bottom quantizer's rows carry the top's flips.
PAR_NORM_RTOL = REID_GRAD_NORM_RTOL
PAR_FLIP_SHARE = 1e-2


@contextlib.contextmanager
def torchrun_world_of_one():
    """The environment that ``torchrun --nproc_per_node 1`` gives its rank."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port_no = s.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port_no)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def group_seen(module, name: str, seen: list):
    """Record, at each call of ``module.<name>``, the process group it runs in."""
    saved = getattr(module, name)

    def watched(*args, **kwargs):
        seen.append({"group": par.is_initialized(), "world": par.get_world_size(),
                     "backend": dist.get_backend() if par.is_initialized() else None})
        return saved(*args, **kwargs)

    setattr(module, name, watched)
    try:
        yield seen
    finally:
        setattr(module, name, saved)


class ParallelStepTimer(StepTimer):
    """A StepTimer that also times each ``parallel.all_reduce`` made inside a
    step (the quantizers' statistics, the gradient sum) by CUDA events on the
    current stream, read after the step's own synchronise: no wait is added."""

    def __enter__(self):
        super().__enter__()
        self.in_step, self.pending, self.calls = False, [], []
        self.saved_all_reduce = par.all_reduce
        saved_factory = getattr(self.module, self.factory)

        def factory(*args, **kwargs):
            step = saved_factory(*args, **kwargs)

            def flagged(*a, **k):
                self.in_step = True
                try:
                    return step(*a, **k)
                finally:
                    self.in_step = False
                    self.calls += [(len(self.times) - 1, start.elapsed_time(end), nbytes)
                                   for start, end, nbytes in self.pending]
                    self.pending = []
            return flagged

        def timed_all_reduce(x):
            if not self.in_step:
                return self.saved_all_reduce(x)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = self.saved_all_reduce(x)
            end.record()
            self.pending.append((start, end, x.numel() * x.element_size()))
            return out

        setattr(self.module, self.factory, factory)
        par.all_reduce = timed_all_reduce
        return self

    def __exit__(self, *exc):
        par.all_reduce = self.saved_all_reduce
        super().__exit__(*exc)

    def report(self, images: int) -> dict:
        out = super().report(images)
        later = [c for c in self.calls if c[0] >= 1]          # the steps after the first
        n = max(len(self.times) - 1, 1)
        ms = sum(c[1] for c in later) / n
        out.update({"all_reduce_ms_per_step": ms, "all_reduce_calls_per_step": len(later) / n,
                    "all_reduce_mb_per_step": sum(c[2] for c in later) / n / 2 ** 20,
                    "all_reduce_share_of_step": ms / out["step_ms"] if self.times[1:] else None})
        return out


def differing(a, b, path: str = "") -> list:
    """Where two checkpoints (nested dicts and lists of tensors and numbers)
    differ, bit for bit."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path}: keys"]
        return [d for k in a for d in differing(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: length"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in differing(x, y, f"{path}/{i}")]
    if isinstance(a, torch.Tensor):
        return [] if a.shape == b.shape and torch.equal(a, b) else [path]
    return [] if a == b else [path]


def parallel_world_of_one(tmp: str) -> dict:
    """``train.vqvae``, ``extract_codes`` and the top prior through their
    command lines, each once under a ``torchrun`` environment of one rank
    (``launch`` forms an NCCL group of one) and once without: the
    checkpoints and the code stores bit for bit; the counters at zero before
    and read after the group's runs (K3, K4-K6 launched, no plain version);
    the stage-1 and top-prior step times and their all-reduce time in
    both."""
    runs = {}
    for mode in ("alone", "nccl"):
        root = os.path.join(tmp, "parallel", mode)
        dirs = {k: os.path.join(root, k) for k in ("vqvae", "top")}
        codes = os.path.join(root, "codes.vq2")
        group = torchrun_world_of_one if mode == "nccl" else contextlib.nullcontext
        seen: list = []
        reset_all_counts()
        t0 = time.perf_counter()
        with group(), group_seen(tv, "train", seen), ParallelStepTimer(tv, "make_train_step") as t1:
            tv.main(["--synthetic", "--size", str(SIZE), "--batch_size",
                     str(TRAIN_BATCH["vqvae"]), "--steps", str(PAR_STEPS), "--log_every", "1",
                     "--ckpt_dir", dirs["vqvae"]])
        with group(), group_seen(extract_codes, "_extract_main", seen):
            n = extract_codes.main(["--synthetic", "--ckpt_dir", dirs["vqvae"], "--size",
                                    str(SIZE), "--batch_size", str(PAR_EXTRACT_BATCH),
                                    "--name", codes])
        with group(), group_seen(tp, "train", seen), ParallelStepTimer(tp, "make_train_step") as t2:
            tp.main([codes, "--hier", "top", "--batch", str(TRAIN_BATCH["top"]), "--steps",
                     str(PAR_STEPS), "--log_every", "1", "--ckpt_dir", dirs["top"]])
        counts = all_counts()                    # read just after the three command lines
        check(not par.is_initialized(), f"{mode}: launch left a process group behind")
        want = {"group": mode == "nccl", "world": 1, "backend": "nccl" if mode == "nccl" else None}
        check(seen == [want] * 3, f"{mode}: the command lines ran in {seen}, not {want}")
        check(not any(counts["plain_calls"].values()),
              f"{mode}: a plain version ran: {counts['plain_calls']}")
        launched = {k: counts["launches"][k] for k in (
            "nearest_code_stats", "nearest_code_ids", "causal_flash_attention",
            "causal_flash_attention_dq", "causal_flash_attention_dkv")}
        check(all(launched.values()), f"{mode}: kernels launched {launched}")
        runs[mode] = {"seconds": time.perf_counter() - t0, "rows": n, "launches": launched,
                      "stage1_step": t1.report(TRAIN_BATCH["vqvae"]),
                      "top_prior_step": t2.report(TRAIN_BATCH["top"]), "dirs": dirs,
                      "codes": codes}
    result = {"steps": PAR_STEPS}
    for name in ("vqvae", "top"):
        a, b = (torch.load(os.path.join(runs[m]["dirs"][name], "last.pt"), map_location="cpu",
                           weights_only=True) for m in ("alone", "nccl"))
        diff = differing(a, b)
        check(not diff, f"world-1 NCCL {name}: the checkpoint differs from the run without a "
                        f"group at {diff[:5]}")
        result[f"{name}_checkpoint_bit_equal"] = True
    with open(runs["alone"]["codes"], "rb") as fa_, open(runs["nccl"]["codes"], "rb") as fb_:
        check(fa_.read() == fb_.read(), "world-1 NCCL: the code store differs from the run "
                                        "without a group")
    result["code_store_bit_equal"] = True
    for mode, run in runs.items():
        result[mode] = {k: v for k, v in run.items() if k not in ("dirs", "codes")}
    return result


def _state_digest(state: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def _grad_errors(got: dict, want: dict) -> dict:
    """Each tensor's largest difference as a fraction of its largest element,
    floored at a thousandth of the whole gradient's largest."""
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    return {k: float((got[k] - w).abs().max()) / max(float(w.abs().max()), floor, 1e-30)
            for k, w in want.items()}


def _recorded_ema(model) -> list:
    """Each quantizer's EMA step inputs, recorded as they come."""
    from vqvae2_tpu_torch.models.vqvae import Quantize

    records = []
    for q in (m for m in model.modules() if isinstance(m, Quantize)):
        def wrapped(flat, csum, esum, q=q, orig=q._ema_update):
            records.append({"rows": flat.detach().clone(), "embed": q.embed.clone(),
                            "csum": csum.clone(), "esum": esum.clone()})
            orig(flat, csum, esum)
        q._ema_update = wrapped
    return records


def score_gap(rows: torch.Tensor, embed: torch.Tensor, ids_a: torch.Tensor,
              ids_b: torch.Tensor) -> float:
    """The largest gap between the scores of codes ``ids_a`` and ``ids_b``
    under ``rows``, as a fraction of ``|x|^2 + |e|^2`` (as compare_with_plain
    measures a near-tie)."""
    scores = qz.nearest_code_scores(rows, embed)
    sa, sb = scores.gather(1, ids_a[:, None])[:, 0], scores.gather(1, ids_b[:, None])[:, 0]
    scale = (rows.float() ** 2).sum(1) + (embed[ids_a] ** 2).sum(1)
    return float(((sa - sb).abs() / scale.clamp_min(1e-30)).max())


def near_tie_flips(rows_a: torch.Tensor, rows_b: torch.Tensor, embed: torch.Tensor) -> dict:
    """The ids of two versions of the same rows (one image through batches of
    two sizes, where cuDNN may round otherwise) that differ, and the largest
    gap between the two codes' scores under ``rows_a`` (``score_gap``)."""
    ids_a = qz.nearest_code_ids(rows_a.contiguous(), embed).long()
    ids_b = qz.nearest_code_ids(rows_b.contiguous(), embed).long()
    flip = (ids_a != ids_b).nonzero().flatten()
    gap = score_gap(rows_a[flip], embed, ids_a[flip], ids_b[flip]) if flip.numel() else 0.0
    return {"rows": rows_a.shape[0], "flips": int(flip.numel()), "largest_rel_gap": gap}


def stage1_statistics_against(got: list, want: list, start: int, stop: int, images: int) -> list:
    """Each quantizer's statistics at world N against world 1: the ids that
    flip between this rank's rows and world 1's same rows, with their score
    gaps, and the counts' L1 distance (at most two a flip, summed over the
    ranks)."""
    out = []
    for g, w in zip(got, want):
        hw = w["rows"].shape[0] // images
        flips = near_tie_flips(w["rows"][start * hw:stop * hw], g["rows"], w["embed"])
        out.append({**flips, "csum_l1": float((g["csum"] - w["csum"]).abs().sum()),
                    "codes_moved": int((g["csum"] != w["csum"]).sum()),
                    "esum_norm_err": norm_err(g["esum"], w["esum"])})
    return out


def norm_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``|got - want| / |want|`` over the whole tensor."""
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-300))


def store_against_world_one(one: str, two: str, model, dataset, batch: int) -> dict:
    """The code store of world N against world 1's: bit for bit, or else the
    same rows, labels and names with ids that differ only at near-ties (the
    encoder's rows of world 1 decide)."""
    with open(one, "rb") as a, open(two, "rb") as b:
        if a.read() == b.read():
            return {"bit_equal": True, "flips": 0, "largest_rel_gap": 0.0}
    a, b = CodeStore(one), CodeStore(two)
    n = len(a)
    check(len(b) == n, f"gloo extraction: {len(b)} rows against world 1's {n}")
    ta, ba, la, na = a.gather(np.arange(n), with_names=True)
    tb, bb, lb, nb = b.gather(np.arange(n), with_names=True)
    a.close()
    b.close()
    check(np.array_equal(la, lb) and na == nb, "gloo extraction: labels or names differ")
    flips, gap = 0, 0.0
    dev = next(model.parameters()).device
    for s in range(0, n, batch):
        imgs = torch.from_numpy(np.stack([dataset[i][0] for i in range(s, min(s + batch, n))]))
        with torch.no_grad():
            rows = capture_quantizer_inputs(model.eval(), imgs.to(dev))
        for rows_q, q, ids_a, ids_b in zip(rows, (model.quantize_t, model.quantize_b),
                                           (ta[s:s + batch], ba[s:s + batch]),
                                           (tb[s:s + batch], bb[s:s + batch])):
            ia_ = torch.from_numpy(ids_a.reshape(-1).astype(np.int64)).to(dev)
            ib_ = torch.from_numpy(ids_b.reshape(-1).astype(np.int64)).to(dev)
            flip = (ia_ != ib_).nonzero().flatten()
            if flip.numel():
                gap = max(gap, score_gap(rows_q[flip], q.embed, ia_[flip], ib_[flip]))
                flips += int(flip.numel())
    return {"bit_equal": False, "flips": flips, "largest_rel_gap": gap}


def _stage1_case(dev: str):
    """``VQVAE()`` with codebooks drawn among its rows, and a global batch."""
    gen = np.random.default_rng(7)
    x = torch.from_numpy(gen.normal(scale=0.5, size=(TRAIN_BATCH["vqvae"], SIZE, SIZE, 3))
                         .astype(np.float32)).to(dev)
    model = build_vqvae(device=dev, seed=0)
    with torch.no_grad():
        seed_codebooks_from_data(model, x)
    return model, x


def _stage1_run(model, x, steps: int = 1):
    """One ``train.vqvae`` step (and ``steps - 1`` more, timed) from a copy of
    ``model``; its gradients, statistics and state after the first step."""
    m = copy.deepcopy(model).train()
    tx = schedules.adam(3e-4)
    state = tv.create_state(m, tx)
    ema = _recorded_ema(m)
    with ParallelStepTimer(tv, "make_train_step") as timer:
        step = tv.make_train_step(m, tx)
        state, _ = step(state, x)
        out = {"grads": {k: p.grad.clone() for k, p in m.named_parameters()},
               "state": {k: v.clone() for k, v in m.state_dict().items()}, "ema": ema[:]}
        for _ in range(steps - 1):
            state, _ = step(state, x)
    return out, timer.report(x.shape[0])


def _top_case(dev: str):
    args = tp.build_argparser().parse_args(["codes", "--dropout", "0"])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = build_model("top", args, code_hw=(TOP_HW, BOTTOM_HW)).to(dev)
    g = np.random.default_rng(3)
    codes = torch.from_numpy(g.integers(0, K, size=(TRAIN_BATCH["top"], TOP_HW, TOP_HW))
                             .astype(np.int64)).to(dev)
    return model, codes


def _top_run(model, codes, steps: int = 1):
    m = copy.deepcopy(model).train()
    tx = schedules.adam(3e-4)
    state = tv.create_state(m, tx)
    with ParallelStepTimer(tp, "make_train_step") as timer:
        step = tp.make_train_step(m, tx, False, seed=1)
        state, _ = step(state, {"target": codes})
        out = {"grads": {k: p.grad.clone() for k, p in m.named_parameters()},
               "state": {k: v.clone() for k, v in m.state_dict().items()}}
        for _ in range(steps - 1):
            state, _ = step(state, {"target": codes})
    return out, timer.report(codes.shape[0])


def _abn_cases(dev: str):
    """The 13 ABN inputs of ``EmbedNet2(resnet50)`` on a train batch of 72
    images at 288x144, each with a weight, a bias and an upstream gradient."""
    from vqvae2_tpu_torch.part.part_model import EmbedNet2

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        model = EmbedNet2(class_num=REID_IDS, arch=REID_ARCH).to(dev)
    inputs = capture_abn_inputs(model, reid_batch(4, REID_P, REID_K, REID_HW, REID_IDS))
    del model
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = []
    for name, x in inputs:
        m, c = x.shape
        cases.append({"name": name, "x": x,
                      "w": torch.randn(c, generator=gen, device=dev),
                      "b": 0.3 * torch.randn(c, generator=gen, device=dev),
                      "dz": torch.randn(m, c, generator=gen, device=dev) / (m * c)})
    return cases


def _abn_run(case, sync: bool):
    """``InPlaceABN`` (``InPlaceABNSync`` under a group) on this rank's rows of
    the case, backward from its rows of dz, then the gradient all-reduce."""
    from vqvae2_tpu_torch.models.abn import InPlaceABN, InPlaceABNSync

    c = case["x"].shape[1]
    abn = (InPlaceABNSync(c) if sync else InPlaceABN(c)).to(case["x"].device)
    with torch.no_grad():
        abn.weight.copy_(case["w"])
        abn.bias.copy_(case["b"])
    x = par.shard_batch(case["x"]).clone().requires_grad_(True)
    z = abn(x)
    z.backward(par.shard_batch(case["dz"]))
    par.all_reduce_grads(abn.parameters())
    return {"z": z.detach(), "dx": x.grad, "dweight": abn.weight.grad, "dbias": abn.bias.grad,
            "running_mean": abn.running_mean, "running_var": abn.running_var}


def gloo_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of the ``gloo`` world on the card: the world-1 references on
    the global batch first (no group yet), then the group, the same work on
    this rank's rows, and the comparisons; the results go to a file."""
    try:
        torch.cuda.set_device(0)
        port.set_reference_precision()
        dev = GLOO_DEVICE
        stage1_model, x = _stage1_case(dev)
        top_model, codes = _top_case(dev)
        abn_cases = _abn_cases(dev)
        ref = {"stage1": _stage1_run(stage1_model, x)[0], "top": _top_run(top_model, codes)[0],
               "abn": [_abn_run(c, sync=False) for c in abn_cases]}
        extract_dir = os.path.join(out_dir, "extract")
        dataset = SyntheticImages(n=GLOO_EXTRACT["n_images"], size=SIZE)
        if rank == 0:
            os.makedirs(extract_dir, exist_ok=True)
            extract_codes.extract(stage1_model, dataset, os.path.join(extract_dir, "one.vq2"),
                                  batch_size=GLOO_EXTRACT["batch"], size=SIZE, workers=0,
                                  device=dev)
        torch.cuda.synchronize()

        par.init_distributed(store, world, rank, device=dev, backend="gloo")
        try:
            reset_all_counts()
            s1, s1_times = _stage1_run(stage1_model, x, 1 + GLOO_TIMED_STEPS)
            top, top_times = _top_run(top_model, codes, 1 + GLOO_TIMED_STEPS)
            abn = [_abn_run(c, sync=True) for c in abn_cases]
            extract_codes.extract(stage1_model, dataset, os.path.join(extract_dir, "two.vq2"),
                                  batch_size=GLOO_EXTRACT["batch"], size=SIZE, workers=0,
                                  device=dev)
            torch.cuda.synchronize()
            counts = all_counts()
            start, stop = par.shard_rows(x.shape[0])
        finally:
            dist.destroy_process_group()

        res = {"rank": rank, "counts": counts, "rows": [start, stop],
               "stage1_step": s1_times, "top_prior_step": top_times,
               "stage1_grad_err": max(_grad_errors(s1["grads"], ref["stage1"]["grads"]).values()),
               "top_grad_err": max(_grad_errors(top["grads"], ref["top"]["grads"]).values()),
               "quantizers": stage1_statistics_against(s1["ema"], ref["stage1"]["ema"], start,
                                                       stop, x.shape[0]),
               "codebook_norm_err": {
                   k: norm_err(v, ref["stage1"]["state"][k]) for k, v in s1["state"].items()
                   if k.split(".")[-1] in ("embed", "embed_avg", "cluster_size")},
               "digests": {"stage1": _state_digest(s1["state"]), "top": _state_digest(top["state"]),
                           "abn": _state_digest({f"{i}.{k}": a[k] for i, a in enumerate(abn)
                                                 for k in ("dweight", "dbias", "running_mean",
                                                           "running_var")})},
               "abn": []}
        for case, got, want in zip(abn_cases, abn, ref["abn"]):
            lo, hi = par.shard_rows(case["x"].shape[0], par.Mesh(world, rank, torch.device(dev)))
            rows = {"z": want["z"][lo:hi], "dx": want["dx"][lo:hi]}
            res["abn"].append({
                "name": case["name"], "m": case["x"].shape[0], "c": case["x"].shape[1],
                **{f"{k}_norm_err": norm_err(got[k], rows.get(k, want[k]))
                   for k in ("z", "dx", "dweight", "dbias", "running_mean", "running_var")},
                **{f"{k}_max_abs_err": float((got[k] - rows.get(k, want[k])).abs().max())
                   for k in ("z", "dx", "dweight", "dbias")}})
        if rank == 0:
            res["store"] = store_against_world_one(
                os.path.join(extract_dir, "one.vq2"), os.path.join(extract_dir, "two.vq2"),
                stage1_model, dataset, GLOO_EXTRACT["batch"])
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        import traceback

        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def gloo_world_of_two(tmp: str) -> dict:
    """Two ``gloo`` ranks on the one card, spawned: a stage-1 step, a
    top-prior step (dropout 0), the ABNs of EmbedNet2 forward and backward,
    and extraction with a ragged last batch, each against the world-1 run on
    the global batch; every rank's counters (K3, K4-K6, K7/K8 launched, no
    plain version) and state (bit-equal to rank 0's).  What fails is listed
    under ``failures`` for the phase to report after it has printed."""
    import multiprocessing

    out_dir = tempfile.mkdtemp(dir=tmp)
    store = "file://" + os.path.join(out_dir, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=gloo_rank, args=(r, GLOO_WORLD, store, out_dir))
             for r in range(GLOO_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + GLOO_JOIN_SECONDS
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [open(os.path.join(out_dir, f"rank{r}.err")).read() for r in range(GLOO_WORLD)
              if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))]
    check(not hung and not errors and all(p.exitcode == 0 for p in procs),
          f"gloo world: ranks {hung} hung; exit codes {[p.exitcode for p in procs]}; "
          + "\n".join(errors))
    ranks_ = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
              for r in range(GLOO_WORLD)]
    seconds = time.perf_counter() - t0
    want = {"nearest_code_stats", "causal_flash_attention", "causal_flash_attention_dq",
            "causal_flash_attention_dkv", "abn_forward", "abn_backward"}
    failures = []

    def expect(cond, message: str) -> None:         # collected: the phase prints first
        if not cond:
            failures.append(message)

    for r in ranks_:
        tag = f"gloo rank {r['rank']}"
        expect(all(r["counts"]["launches"][k] for k in want) and
               not any(r["counts"]["plain_calls"].values()),
               f"{tag}: launches {r['counts']['launches']}, plain {r['counts']['plain_calls']}")
        expect(r["stage1_grad_err"] <= PAR_GRAD_RTOL,
               f"{tag}: stage-1 gradients off world 1 by {r['stage1_grad_err']} (> {PAR_GRAD_RTOL})")
        expect(r["top_grad_err"] <= PAR_GRAD_RTOL,
               f"{tag}: top-prior gradients off world 1 by {r['top_grad_err']}")
        expect(max(r["codebook_norm_err"].values()) <= PAR_NORM_RTOL,
               f"{tag}: codebooks off world 1: {r['codebook_norm_err']}")
        expect(r["quantizers"][0]["largest_rel_gap"] <= TIE_RTOL,
               f"{tag}: top ids flipped against world 1 beyond near-ties: {r['quantizers'][0]}")
        expect(all(q["flips"] <= PAR_FLIP_SHARE * q["rows"] for q in r["quantizers"]),
               f"{tag}: ids flipped against world 1 in more than {PAR_FLIP_SHARE} of the rows: "
               f"{r['quantizers']}")
        for a in r["abn"]:
            worst = max(v for k, v in a.items() if k.endswith("_norm_err"))
            expect(worst <= PAR_NORM_RTOL, f"{tag}: ABN {a['name']} off world 1: {a}")
        expect(r["digests"] == ranks_[0]["digests"], f"{tag}: state differs from rank 0's")
    for i in range(len(ranks_[0]["quantizers"])):
        flips = sum(r["quantizers"][i]["flips"] for r in ranks_)
        l1 = ranks_[0]["quantizers"][i]["csum_l1"]
        expect(l1 <= 2 * flips, f"gloo world: quantizer {i}'s counts moved by {l1} with {flips} "
                                "near-tie flips")
    store = ranks_[0]["store"]
    expect(store["largest_rel_gap"] <= TIE_RTOL,
           f"gloo world: the code store differs from world 1's beyond near-ties: {store}")
    return {"world": GLOO_WORLD, "device": GLOO_DEVICE, "seconds": seconds,
            "extract": dict(GLOO_EXTRACT), "ranks": [
                {k: v for k, v in r.items() if k not in ("digests",)} for r in ranks_],
            "states_bit_equal_across_ranks": all(r["digests"] == ranks_[0]["digests"]
                                                 for r in ranks_),
            "failures": failures}


def phase_parallel(tmp: str) -> dict:
    result = {"card": card_name(), "world_1_nccl": parallel_world_of_one(tmp),
              "world_2_gloo": gloo_world_of_two(tmp)}
    emit("parallel", **result)
    failures = result["world_2_gloo"]["failures"]
    check(not failures, "; ".join(failures))
    return result


# ---------------------------------------------------------------------------
# Phase parallel_trainers: the nine other trainers at world size N
# ---------------------------------------------------------------------------

PT_TRAINERS = ("reid", "vqvae_deep", "adaptive", "gray2color", "vqvae_deep_bi",
               "vqvae_deep_ir", "stargan_bi", "detection", "maskrcnn")
PT_STEPS = 2                         # each trainer's steps at world 2; the second is timed
PT_WORLD = 2                         # gloo ranks on the one card
PT_JOIN_SECONDS = 900.0
# each trainer at its command line's defaults: the ReID net resnet50 at
# 288x144, P = 6, K = 4; the deep family resnet18 at 288x144, P = K = 4 (the
# generators of StarGAN at img_size 128, remat on); SSD300 at batch 8; Mask
# R-CNN at 256 px, batch 4, 64 proposals, 64 ground-truth slots
PT_CONFIG = {
    "reid": dict(p=REID_P, k=REID_K, hw=REID_HW, arch=REID_ARCH),
    "deep": dict(p=DEEP_P, k=DEEP_K, hw=DEEP_HW, arch=DEEP_ARCH),
    "detection": dict(batch=8, size=300, arch="resnet18"),
    "maskrcnn": dict(batch=4, size=256, proposals=64, max_boxes=64, anchors=(32, 64, 128),
                     arch="resnet18"),
}
# world 2 against world 1 on the card, by norms (cuDNN rounds a batch of 8
# otherwise than one of 16): the losses of the first step within
# PT_LOSS_RTOL; the batch norms' running statistics within PT_STATS_RTOL of
# their largest element; each optimizer's gradient norm within
# PT_GRAD_NORM_RTOL, the ReID trainer's card-vs-CPU norm tolerance
PT_LOSS_RTOL = 1e-3
PT_STATS_RTOL = 1e-3
# What follows the ReID net's update within the same step, held to 2e-2 (as
# tests/test_torch_train_stargan_bi.py holds StarGAN's generator metrics to
# the JAX package's): StarGAN's generator metrics (after an SGD step at lr
# 0.1; its fakes renormalise in train mode), and the gray -> IR trainer's
# fusions' statistics, whose second pass fuses the features of the updated
# ReID net (Adam's first step moves a near-zero gradient element by about
# lr * sign(g)) and whose batch norm divides by a variance near its eps
PT_AFTER_UPDATE = {"stargan_bi": ("id_ir", "feat_ir", "hinge_pos", "loss_gen"),
                   "vqvae_deep_ir": ("fusion1.W_bn.", "fusion2.W_bn.")}
PT_AFTER_UPDATE_RTOL = 2e-2
PT_GRAD_NORM_RTOL = REID_GRAD_NORM_RTOL
PT_KERNELS = {"reid": ("abn_forward", "abn_backward"),
              "vqvae_deep": ("nearest_code_stats",), "vqvae_deep_bi": ("nearest_code_stats",),
              "vqvae_deep_ir": ("nearest_code_stats",), "adaptive": ("nearest_code_stats",),
              "gray2color": ("nearest_code_stats",)}


def pt_dataset(name: str, cfg: dict, root: str):
    """A trainer's synthetic data set, written once under ``root``: a SYSU
    tree (part mode for the ReID trainer) sampled P x K, or a COCO set."""
    from vqvae2_tpu_torch.data.sysu import SYSUData
    from vqvae2_tpu_torch.train import reid as tr

    d = os.path.join(root, name)
    if name in ("detection", "maskrcnn"):
        from vqvae2_tpu_torch.detection.data import CocoDetectionDataset, make_synthetic_coco

        c = cfg[name]
        masks = name == "maskrcnn"
        img_dir, ann = make_synthetic_coco(d, n=2 * c["batch"], size=c["size"], seed=40,
                                           with_masks=masks)
        return CocoDetectionDataset(img_dir, ann, size=c["size"], with_masks=masks,
                                    max_boxes=c.get("max_boxes", 64))
    c = cfg["reid" if name == "reid" else "deep"]
    tr.make_synthetic_sysu(d, n_ids=REID_IDS, per_id=8, h=c["hw"][0], w=c["hw"][1], seed=40)
    ds = SYSUData(d, part=name == "reid", seed=40)
    ds.samplize(c["p"], c["k"])
    return ds


def pt_batch(name: str, step: int, cfg: dict, ds):
    """The global batch of step ``step`` on the host, as the trainer's loop
    builds it from its data set (every rank builds the whole of it): the
    items' reads and transforms, the collation, the cross-modal trainers'
    gray mix and augmentations."""
    from vqvae2_tpu_torch.train import gray2color as tg2c
    from vqvae2_tpu_torch.train import reid as tr
    from vqvae2_tpu_torch.train import vqvae_deep_bi as tbi

    seed = 40 + step
    if name in ("detection", "maskrcnn"):
        masks = name == "maskrcnn"
        out = next(ds.batches(cfg[name]["batch"], seed=seed, with_masks=masks))
        return out[:3] if not masks else (*out[:3], out[4])
    c = cfg["reid" if name == "reid" else "deep"]
    n = c["p"] * c["k"]
    rows = [ds[i] for i in range(step * n, (step + 1) * n)]
    if name == "reid":
        return tr.collate(rows, c["hw"])
    if name in ("vqvae_deep_bi", "vqvae_deep_ir", "stargan_bi"):
        return tbi.cross_modal_batch(rows, np.random.default_rng(seed), "cpu")
    batch = {"rgb": torch.from_numpy(np.stack([r[0] for r in rows])),
             "ir": torch.from_numpy(np.stack([r[1] for r in rows])),
             "label": torch.from_numpy(np.asarray([r[2] for r in rows], np.int32))}
    if name == "gray2color":
        batch["ids"] = torch.from_numpy(tg2c.other_instance_ids(
            c["p"], c["k"], np.random.default_rng(seed)))
    return batch


def pt_build(name: str, dev: str, cfg: dict):
    """``(model, optimizers, step)``: a trainer's model with weights from a
    seed (the same on every rank), its state's optimizers, and
    ``step(batch) -> metrics`` (floats) of its ``make_train_step``."""
    from vqvae2_tpu_torch.models import adaptive as ta
    from vqvae2_tpu_torch.train import adaptive as tad
    from vqvae2_tpu_torch.train import gray2color as tg2c
    from vqvae2_tpu_torch.train import reid as tr
    from vqvae2_tpu_torch.train import stargan_bi as tsb
    from vqvae2_tpu_torch.train import vqvae_deep as ttd
    from vqvae2_tpu_torch.train import vqvae_deep_bi as tbi
    from vqvae2_tpu_torch.train import vqvae_deep_ir as tir
    from vqvae2_tpu_torch.train.vqvae import TrainState

    adam = schedules.adam(3e-4)
    c = cfg["deep"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        if name == "reid":
            r = cfg["reid"]
            model = tr.EmbedNet2(class_num=REID_IDS, arch=r["arch"]).to(dev)
            tx = tr.make_optimizer(0.1, 10)
            state = tr.create_state(model, tx)
            fn = tr.make_train_step(model, tx, r["k"], r["p"], r["hw"], seed=1)
            return model, [state.optimizer], lambda b: fn(state, b)[1]
        if name in ("vqvae_deep", "vqvae_deep_ir"):
            model = ta.ModelAdaptive_Deep(class_num=REID_IDS, arch=c["arch"]).to(dev)
            state = tad.create_state(model, adam, adam)
            fn = (ttd.make_train_step(model, adam, adam, c["k"], seed=2) if name == "vqvae_deep"
                  else tir.make_full_step(model, adam, adam, c["k"]))
            return model, [state.opt_reid, state.opt_gen], lambda b: fn(state, b)[1]
        if name == "adaptive":
            model = ta.ModelAdaptive(class_num=REID_IDS, arch=c["arch"]).to(dev)
            state = tad.create_state(model, adam, adam)
            fn = tad.make_train_step(model, adam, adam, c["k"])
            return model, [state.opt_reid, state.opt_gen], lambda b: fn(state, b)[1][0]
        if name == "gray2color":
            model = ta.ModelAdaptive(class_num=REID_IDS, arch=c["arch"], ir_head=False).to(dev)
            state = TrainState(step=0, model=model.train(),
                               optimizer=adam.build(model.parameters()))
            fn = tg2c.make_train_step(model, adam)
            return model, [state.optimizer], lambda b: fn(
                state, {"rgb": b["rgb"], "ir": b["ir"]}, b["ids"])[1][0]
        if name == "vqvae_deep_bi":
            model = ta.ModelAdaptiveBi_Deep(class_num=REID_IDS, arch=c["arch"]).to(dev)
            tx_reid = schedules.SGDSchedule(tbi.reid_lr_schedule(0.1, 10), momentum=0.9,
                                            nesterov=True, weight_decay=5e-4)
            state = tbi.create_state(model, tx_reid, adam)
            fn = tbi.make_train_step(model, tx_reid, adam, c["k"])
            return model, [state.opt_gen, state.opt_reid], lambda b: fn(state, b)[1]
        if name == "stargan_bi":
            model = tsb.build_model(argparse.Namespace(seed=11, arch=c["arch"]), REID_IDS,
                                    c["hw"], dev)
            tx_reid = schedules.SGDSchedule(0.1, momentum=0.9, nesterov=True)
            state = tsb.create_state(model, tx_reid, adam, adam)
            fn = tsb.make_train_step(model, tx_reid, adam, adam, c["k"])
            return model, [state.opt_reid, state.opt_gen, state.opt_disc], lambda b: fn(
                state, b, {"r1_weight": 1.0, "adv_weight": 0.5, "d_mask": 1.0})[1]
        if name == "detection":
            from vqvae2_tpu_torch.detection import boxes as B
            from vqvae2_tpu_torch.detection.ssd import SSD300
            from vqvae2_tpu_torch.train import detection as tdet

            model = SSD300(num_classes=DET_CLASSES, arch=cfg["detection"]["arch"]).to(dev)
            tx = tdet.make_optimizer(0.002, 40)
            state = tdet.create_state(model, tx)
            fn = tdet.make_train_step(model, tx, B.default_boxes_ssd300())
            return model, [state.optimizer], lambda b: {"loss": fn(state, *b)[1]}
        from vqvae2_tpu_torch.detection import mask_rcnn as dm
        from vqvae2_tpu_torch.train import maskrcnn as tmr

        m = cfg["maskrcnn"]
        model = dm.MaskRCNN(num_classes=DET_CLASSES, img_size=m["size"],
                            num_proposals=m["proposals"], arch=m["arch"]).to(dev)
        state = tmr.create_state(model, schedules.adam(1e-4))
        fn = tmr.make_train_step(model, schedules.adam(1e-4),
                                 dm.generate_anchors(m["size"], sizes=m["anchors"]))
        return model, [state.optimizer], lambda b: fn(state, *b)[1]


class CollectiveClock:
    """Counts and times the collectives a block makes (``parallel.all_reduce``,
    each call synchronised before and after so that it times the exchange
    alone), apart for the gradient sum (``all_reduce_grads``) and the rest of
    the step (the batch norms' and ABNs' sums, the gathers, the metrics)."""

    def __init__(self):
        self.grad = [0, 0.0, 0]            # calls, ms, bytes
        self.step = [0, 0.0, 0]
        self._in_grads = False

    def __enter__(self):
        self.saved = par.all_reduce, par.all_reduce_grads
        saved_reduce, saved_grads = self.saved

        def timed(x):
            if not par.is_initialized():
                return saved_reduce(x)
            if x.is_cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved_reduce(x)
            if out.is_cuda:
                torch.cuda.synchronize()
            acc = self.grad if self._in_grads else self.step
            acc[0] += 1
            acc[1] += (time.perf_counter() - t0) * 1e3
            acc[2] += x.numel() * x.element_size()
            return out

        def grads(parameters):
            self._in_grads = True
            try:
                return saved_grads(parameters)
            finally:
                self._in_grads = False

        par.all_reduce, par.all_reduce_grads = timed, grads
        return self

    def __exit__(self, *exc):
        par.all_reduce, par.all_reduce_grads = self.saved


def pt_grad_norms(optimizers) -> list:
    """Each optimizer's gradient norm, as its ``step`` sees it (recorded by
    wrapping ``step``; read after the step)."""
    norms = []
    for opt in optimizers:
        saved = opt.step

        def spy(*a, opt=opt, saved=saved, **kw):
            g = [p.grad.detach().double() for grp in opt.param_groups for p in grp["params"]
                 if p.grad is not None]
            norms.append(float(torch.sqrt(sum(torch.sum(t * t) for t in g))) if g else 0.0)
            return saved(*a, **kw)

        opt.step = spy
    return norms


def pt_statistics(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def pt_run(name: str, dev: str, cfg: dict, steps: int, reference: bool, root: str) -> dict:
    """A trainer's ``steps`` steps on this process's rows of each global
    batch: the first step's metrics, gradient norms and batch-norm
    statistics, the state's digest after each step, the second step's time
    by CUDA events, its collectives, the host time to build a global batch,
    the peak memory and the kernels' launches over the steps."""
    on_card = torch.device(dev).type == "cuda"
    ds = pt_dataset(name, cfg, os.path.join(root, "reference" if reference else "world"))
    model, optimizers, step = pt_build(name, dev, cfg)
    norms = pt_grad_norms(optimizers)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = {"digests": [], "host_ms": [], "step_ms": []}
    reset_all_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        batch = pt_batch(name, i, cfg, ds)
        out["host_ms"].append((time.perf_counter() - t0) * 1e3)
        with torch.enable_grad(), CollectiveClock() as clock:
            if on_card:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            metrics = step(batch)
            if on_card:
                end.record()
                end.synchronize()
                out["step_ms"].append(start.elapsed_time(end))
        if i == 0:
            out.update(metrics={k: float(v) for k, v in metrics.items()},
                       grad_norms=list(norms), statistics=pt_statistics(model))
        else:
            out.update(collectives={"grad_all_reduce": clock.grad, "in_step": clock.step})
        out["digests"].append(_state_digest(model.state_dict()))
    counts = all_counts()
    out["launches"] = {k: counts["launches"][k] for k in PT_KERNELS.get(name, ())}
    out["plain_calls"] = {k: v for k, v in counts["plain_calls"].items() if v}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    if reference:
        out.pop("digests")
    del model, optimizers, step
    if on_card:
        torch.cuda.empty_cache()
    return out


def pt_rank(rank: int, world: int, store: str, out_dir: str, dev: str, cfg: dict,
            trainers) -> None:
    """One rank of the ``gloo`` world on the card: rank 0 first takes each
    trainer's first step on the whole global batch without a group (the
    world-1 reference); then both ranks form the group and take each
    trainer's steps on their rows."""
    try:
        if torch.device(dev).type == "cuda":
            torch.cuda.set_device(torch.device(dev))
        port.set_reference_precision()
        res = {"rank": rank, "reference": {}, "world": {}}
        root = os.path.join(out_dir, f"data{rank}")
        if rank == 0:
            for name in trainers:
                res["reference"][name] = pt_run(name, dev, cfg, 1, True, root)
        par.init_distributed(store, world, rank, device=dev, backend="gloo")
        try:
            for name in trainers:
                res["world"][name] = pt_run(name, dev, cfg, PT_STEPS, False, root)
        finally:
            dist.destroy_process_group()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        import traceback

        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def pt_distances(name: str, got: dict, want: dict) -> dict:
    """A rank's world-2 step against the world-1 step: the largest relative
    error of the metrics, of the statistics (of each tensor's largest
    element; those that follow an update apart) and of the gradient norms."""
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    stats = {k: float((got["statistics"][k].cpu() - v.cpu()).abs().max())
             / max(float(v.abs().max()), 1e-6) for k, v in want["statistics"].items()}
    after = PT_AFTER_UPDATE.get(name, ())
    return {"metrics": max(rel(got["metrics"][k], v) for k, v in want["metrics"].items()),
            "statistics": max([e for k, e in stats.items()
                               if not any(k.startswith(p) for p in after)], default=0.0),
            "statistics_after_update": max([e for k, e in stats.items()
                                            if any(k.startswith(p) for p in after)],
                                           default=None),
            "grad_norms": max(rel(g, w) for g, w in zip(got["grad_norms"],
                                                        want["grad_norms"]))}


def pt_compare(name: str, got: dict, want: dict) -> list:
    """What differs between a rank's world-2 step and the world-1 step, by
    the tolerances above."""
    bad = []
    for k, v in want["metrics"].items():
        rtol = PT_AFTER_UPDATE_RTOL if k in PT_AFTER_UPDATE.get(name, ()) else PT_LOSS_RTOL
        if abs(got["metrics"][k] - v) > rtol * max(abs(v), 1e-6):
            bad.append(f"{name}: {k} {got['metrics'][k]} against {v}")
    for k, v in want["statistics"].items():
        err = float((got["statistics"][k].cpu() - v.cpu()).abs().max())
        after = any(k.startswith(p) for p in PT_AFTER_UPDATE.get(name, ()))
        if err > (PT_AFTER_UPDATE_RTOL if after else PT_STATS_RTOL) * max(float(v.abs().max()),
                                                                          1e-6):
            bad.append(f"{name}: statistics {k} off by {err}")
    for i, (g, w) in enumerate(zip(got["grad_norms"], want["grad_norms"])):
        if abs(g - w) > PT_GRAD_NORM_RTOL * max(w, 1e-30):
            bad.append(f"{name}: optimizer {i}'s gradient norm {g} against {w}")
    return bad


def pt_world_of_two(tmp: str, dev: str = GLOO_DEVICE, cfg: dict = None,
                    trainers=PT_TRAINERS) -> dict:
    """The nine trainers at world 2: two ``gloo`` ranks spawned once on the
    one card, against the world-1 step that rank 0 took first.  Failures are
    listed under ``failures``."""
    import multiprocessing

    cfg = cfg or PT_CONFIG
    out_dir = tempfile.mkdtemp(dir=tmp)
    store = "file://" + os.path.join(out_dir, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=pt_rank, args=(r, PT_WORLD, store, out_dir, dev, cfg, trainers))
             for r in range(PT_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + PT_JOIN_SECONDS
    # a rank that fails leaves the other waiting at a collective: stop then
    while time.monotonic() < deadline and any(p.is_alive() for p in procs) and not any(
            p.exitcode not in (None, 0) for p in procs):
        time.sleep(0.5)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [open(os.path.join(out_dir, f"rank{r}.err")).read() for r in range(PT_WORLD)
              if os.path.exists(os.path.join(out_dir, f"rank{r}.err"))]
    check(not hung and not errors and all(p.exitcode == 0 for p in procs),
          f"parallel_trainers: ranks {hung} hung; exit codes {[p.exitcode for p in procs]}; "
          + "\n".join(errors))
    ranks_ = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
              for r in range(PT_WORLD)]
    seconds = time.perf_counter() - t0
    failures, report = [], {}
    reference = ranks_[0]["reference"]
    for name in trainers:
        want = reference[name]
        per_rank = []
        for r in ranks_:
            got = r["world"][name]
            failures += [f"rank {r['rank']} {m}" for m in pt_compare(name, got, want)]
            if got["plain_calls"]:
                failures.append(f"rank {r['rank']} {name}: plain versions ran {got['plain_calls']}")
            if not all(got["launches"].values()):
                failures.append(f"rank {r['rank']} {name}: kernels launched {got['launches']}")
            if got["digests"] != ranks_[0]["world"][name]["digests"]:
                failures.append(f"rank {r['rank']} {name}: parameters differ from rank 0's")
            grad, in_step = got["collectives"]["grad_all_reduce"], got["collectives"]["in_step"]
            per_rank.append({
                "step_ms": got["step_ms"][-1] if got["step_ms"] else None,
                "grad_all_reduce_ms": grad[1], "grad_all_reduce_mb": grad[2] / 2 ** 20,
                "grad_all_reduce_calls": grad[0], "in_step_collectives": in_step[0],
                "in_step_collective_ms": in_step[1], "in_step_collective_mb": in_step[2] / 2 ** 20,
                "host_ms": float(np.mean(got["host_ms"])), "peak_gb": got["peak_gb"],
                "launches": got["launches"], "loss": got["metrics"].get("loss", None),
                "against_world_1": pt_distances(name, got, want)})
        report[name] = {"ranks": per_rank, "world_1": {
            "step_metrics": want["metrics"], "grad_norms": want["grad_norms"],
            "host_ms": want["host_ms"][0], "peak_gb": want["peak_gb"],
            "launches": want["launches"]},
            "states_bit_equal_across_ranks": all(
                r["world"][name]["digests"] == ranks_[0]["world"][name]["digests"]
                for r in ranks_)}
    return {"world": PT_WORLD, "device": dev, "steps": PT_STEPS, "seconds": seconds,
            "trainers": report, "failures": failures}


PT_CLI = {
    "reid": ["--synthetic", "--steps", "2"],
    "vqvae_deep": ["--synthetic", "--steps", "2"],
    "adaptive": ["--synthetic", "--steps", "2"],
    "gray2color": ["--synthetic", "--steps", "2"],
    "vqvae_deep_bi": ["--synthetic", "--steps", "2"],
    "vqvae_deep_ir": ["--synthetic", "--steps", "2", "--stage_reconstruction", "1"],
    "stargan_bi": ["--synthetic", "--steps", "2"],
    "detection": ["--synthetic", "--steps", "2"],
    "maskrcnn": ["--synthetic", "--steps", "2"],
}
PT_NO_CHECKPOINT = ("detection", "maskrcnn")      # their command lines write none
PT_REPEAT_FACTOR = 10.0


def pt_cli_run(name: str, root: str, nccl: bool) -> dict:
    """A trainer's command line for two steps, in a ``torchrun`` environment
    of one rank (an NCCL group of one) or without one: what it returns, its
    checkpoint, whether it ran in the group, and its counters."""
    import importlib

    mod = importlib.import_module(f"vqvae2_tpu_torch.train.{name}")
    argv = PT_CLI[name] + ["--log_every", "1"]
    if name not in PT_NO_CHECKPOINT:
        argv += ["--ckpt_dir", root]
    seen: list = []
    reset_all_counts()
    group = torchrun_world_of_one if nccl else contextlib.nullcontext
    t0 = time.perf_counter()
    with torch.enable_grad(), group(), group_seen(mod, "train", seen):
        metrics = mod.main(argv)
    counts = all_counts()
    out = {"metrics": {k: float(v) for k, v in dict(metrics).items()
                       if isinstance(v, (int, float))},
           "seconds": time.perf_counter() - t0, "grouped": seen[0]["group"],
           "backend": seen[0]["backend"],
           "launches": {k: counts["launches"][k] for k in PT_KERNELS.get(name, ())},
           "plain_calls": {k: v for k, v in counts["plain_calls"].items() if v}}
    if name not in PT_NO_CHECKPOINT:
        out["checkpoint"] = torch.load(os.path.join(root, "last.pt"), map_location="cpu",
                                       weights_only=True)
    check(not par.is_initialized(), f"{name}: launch left a process group behind")
    return out


def pt_distance(a: dict, b: dict) -> float:
    """The largest relative distance ``|a - b| / |b|`` over the floating
    tensors of two checkpoints' models (or over two dicts of metrics)."""
    if "model" in b:
        a, b = a["model"], b["model"]
    worst = 0.0
    for k, v in b.items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            worst = max(worst, norm_err(a[k], v))
        elif isinstance(v, float):
            worst = max(worst, abs(a[k] - v) / max(abs(v), 1e-30))
    return worst


def pt_world_of_one(tmp: str) -> dict:
    """Each of the nine command lines for two steps under a ``torchrun``
    environment of one rank (``launch`` forms an NCCL group of one) and
    without one: the checkpoint (what the detection trainers return, as they
    write none) bit for bit; the kernels launched, no plain version.  Where
    the two differ, the run without a group is repeated: a trainer whose
    backward sums with atomics on the card (the anti-aliased resizes'
    backward) does not repeat itself bit for bit, and then the group's run
    must lie within PT_REPEAT_FACTOR of the distance between the two runs
    without one."""
    result = {}
    for name in PT_TRAINERS:
        runs = {mode: pt_cli_run(name, os.path.join(tmp, "pt_cli", name, mode), mode == "nccl")
                for mode in ("alone", "nccl")}
        check(runs["nccl"]["grouped"] and runs["nccl"]["backend"] == "nccl"
              and not runs["alone"]["grouped"],
              f"{name}: the command line ran grouped {runs['nccl']['grouped']} "
              f"({runs['nccl']['backend']}) under torchrun, {runs['alone']['grouped']} alone")
        for mode, run in runs.items():
            check(not run["plain_calls"], f"{name} {mode}: plain versions ran {run['plain_calls']}")
            check(all(run["launches"].values()), f"{name} {mode}: kernels {run['launches']}")
        what = "metrics" if name in PT_NO_CHECKPOINT else "checkpoint"
        a, b = runs["alone"][what], runs["nccl"][what]
        diff = (["metrics"] if a != b else []) if what == "metrics" else differing(a, b)
        out = {"bit_equal": not diff, "compared": what,
               **{f"{mode}_seconds": run["seconds"] for mode, run in runs.items()},
               "launches": runs["nccl"]["launches"]}
        if diff:
            again = pt_cli_run(name, os.path.join(tmp, "pt_cli", name, "again"), False)[what]
            repeat, group = pt_distance(again, a), pt_distance(b, a)
            out.update(repeatable_alone=not (differing(again, a) if what == "checkpoint"
                                             else again != a),
                       distance_alone_twice=repeat, distance_group=group, differs_at=diff[:5])
            check(not out["repeatable_alone"] and group <= PT_REPEAT_FACTOR * max(repeat, 1e-7),
                  f"world-1 NCCL {name}: differs from the run without a group at {diff[:5]} "
                  f"(distance {group}; two runs without a group {repeat}, bit-equal "
                  f"{out['repeatable_alone']})")
        result[name] = out
    return result


def with_world_n_launches(kernels: list, result: dict) -> None:
    """Add to each record of K3, K7 and K8 its launches a rank in the
    world-2 steps of each trainer that runs it (phase parallel_trainers)."""
    trainers = result["world_2_gloo"]["trainers"]
    for rec in kernels:
        base = rec["name"].split(" ")[0]
        seen = {name: [r["launches"][base] for r in t["ranks"]]
                for name, t in trainers.items() if base in t["ranks"][0]["launches"]}
        if seen:
            rec["launches_world_2_a_rank"] = seen


def phase_parallel_trainers(tmp: str) -> dict:
    world_1 = pt_world_of_one(tmp)
    # the two ranks share the card with this process: hand back what its
    # allocator keeps from the nine command lines (StarGAN's alone peaks at
    # ~43 GB) before they start
    gc.collect()
    torch.cuda.empty_cache()
    result = {"card": card_name(), "world_1_nccl": world_1, "world_2_gloo": pt_world_of_two(tmp)}
    emit("parallel_trainers", **result)
    failures = result["world_2_gloo"]["failures"]
    check(not failures, "; ".join(failures))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--breakdown", action="store_true",
                    help="also time the stages of encode_ids, of the top prior's forward and "
                         "of one train step of stage 1, of the top prior and of the ReID "
                         "trainer, and profile the incremental sampler")
    ap.add_argument("--repeatability", action="store_true",
                    help="also count the ids that flip between calls, with and without "
                         "deterministic cuDNN")
    args = ap.parse_args(argv)

    smi = phase_device()
    phase_build()
    with torch.no_grad(), tempfile.TemporaryDirectory() as tmp:
        model = build_vqvae(device="cuda", seed=0)
        try:
            x = torch.from_numpy(np.random.default_rng(0).normal(
                scale=0.5, size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)).cuda()
            seed_codebooks_from_data(model, x)
            flat_t, flat_b, cases, stats_cases = phase_kernels(model, x)
            launches = phase_main(model, x)

            dirs = write_checkpoints(model, tmp)
            top = sample._restore_prior(dirs["top"], "top", (TOP_HW, BOTTOM_HW), "cuda")
            bottom = sample._restore_prior(dirs["bottom"], "bottom", (TOP_HW, BOTTOM_HW), "cuda")
            attention_qkv, attention_cases, attention_do, backward_cases = phase_attention_kernel(
                top, numpy_codes(2, PRIOR_BATCH, TOP_HW, TOP_HW))
            launches["causal_flash_attention"] = phase_main_stage2(
                dirs, tmp, top, bottom)["causal_flash_attention"]
            with torch.enable_grad():
                trained, train_dirs = phase_main_train(tmp)
            launches.update({k: trained[k] for k in (
                "nearest_code_stats", "causal_flash_attention_dq", "causal_flash_attention_dkv")})
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError(
                f"batch {BATCH} at {SIZE} px (stage 1) or batch {PRIOR_BATCH} of {TOP_HW}x{TOP_HW} "
                f"code grids (stage 2), or a trainer at its command line's batch, does not fit "
                f"this card; the run does not shrink them") from e
        record = phase_times(model, x, flat_t, flat_b, launches, cases, top, attention_qkv,
                             attention_cases, stats_cases, attention_do, backward_cases,
                             train_dirs)
        torch.cuda.empty_cache()
        abn_cases, abn_inputs = phase_abn_kernels()
        abn_rows = max(abn_inputs, key=lambda t: t[1].numel())[1]
        step_fp32 = k8_step(abn_inputs, seed=16)
        del abn_inputs
        with torch.enable_grad():
            reid_launches, _ = phase_main_reid(tmp)
        abn = abn_records(abn_rows, reid_launches, abn_cases)
        record["kernels"] += abn
        emit("times_reid", float32=reid_step_times(), bfloat16=reid_step_times(BF16),
             wide_channels=abn_wide_times(abn_rows.shape[0]),
             kernels={r["name"]: {"ms": r["ms"], "bound_ms": r["bound_ms"],
                                  "plain_ms": r["plain_ms"], "library_ms": r["library_ms"]}
                      for r in abn})
        del abn_rows
        torch.cuda.empty_cache()
        with torch.enable_grad():
            launches_bf16 = phase_main_train_bf16(tmp, os.path.join(tmp, "train", "codes.vq2"))
            launches_reid_bf16 = phase_main_reid_bf16(tmp)
            phase_remat(train_dirs)
            launches_mnist, mnist_prior, mnist_codes = phase_main_mnist(tmp)
        bf = phase_bf16_vs_fp32(model, x, top)
        record["kernels"] += phase_times_bf16(bf, x, launches_bf16, launches_reid_bf16,
                                              mnist_prior, mnist_codes, launches_mnist,
                                              step_fp32)
        del bf, mnist_prior
        torch.cuda.empty_cache()
        with torch.enable_grad():
            launches_deep = phase_main_deep(tmp)
            phase_main_adaptive(tmp)
            by_path = {"deep": launches_deep, "deep_bi": phase_main_deep_bi(tmp),
                       "deep_ir": phase_main_deep_ir(tmp)}
            phase_main_stargan(tmp)
            phase_main_ssd(tmp)
            phase_main_maskrcnn(tmp)
            phase_parallel(tmp)
            trainers_at_n = phase_parallel_trainers(tmp)
        record["kernels"] += deep_records(by_path)
        with_world_n_launches(record["kernels"], trainers_at_n)
        phase_cudnn_grads()
        phase_probe()
        if args.breakdown:
            phase_breakdown(model, x)
            phase_breakdown_stage2(top)
            phase_breakdown_train(train_dirs)
            phase_breakdown_reid()
            phase_breakdown_reid(BF16)
        if args.repeatability:
            phase_repeatability(model, x)
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
