#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vqvae2_tpu_torch``) on one NVIDIA
Hopper card: the quickest proof that the port still builds, starts and is right
on the GPU.

    python3 chip_smoke.py               # needs one card; exits non-zero without
    python3 chip_smoke.py --breakdown   # also times the stages of encode_ids
    python3 chip_smoke.py --repeatability   # also counts ids that flip between calls

Phases, each printing one JSON line; the first failure ends the run non-zero:

1. device   — the card, its power limit, the installation, the TF32 flags
2. build    — first use compiles ``ops/csrc/*.cu`` with nvcc
3. kernels  — each kernel against its plain PyTorch version on the card, at the
              main path's shapes (on the model's own activations) and at
              awkward ones
4. main     — ``VQVAE()`` at full width, 256 px: ``forward`` and ``encode_ids``
              at batch 128, then ``extract_codes.main`` into a temporary
              directory, read back and compared with a direct ``encode_ids``;
              the launch counters must show that the kernels ran and the plain
              versions did not; a small input is held against the CPU
5. times    — CUDA-event times of each kernel, its plain version and the
              nearest library route; ``encode_ids`` in img/s

The last lines are the ``{"kernels": [...]}`` record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import vqvae2_tpu_torch as port
from vqvae2_tpu_torch.data.codestore import CodeStore
from vqvae2_tpu_torch.data.datasets import SyntheticImages
from vqvae2_tpu_torch.models import build_vqvae
from vqvae2_tpu_torch.ops import _build
from vqvae2_tpu_torch.ops import quantize as qz
from vqvae2_tpu_torch.train import extract_codes
from vqvae2_tpu_torch.utils.checkpoint import CheckpointManager

SIZE = 256
BATCH = 128            # forward / encode_ids
EXTRACT_BATCH = 64     # extract_codes.main
D, K = 64, 512

# Published peaks of one H100 SXM at its full 700 W: fp32 outside the tensor
# cores, and device memory.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Kernel and plain version sum the same terms in different orders, so an id may
# differ where the best two codes of a row are equidistant to rounding: a
# mismatch is a near-tie when the plain scores of the two ids differ by at most
# this fraction of the summands' magnitude (|x|^2 + |E|^2).
TIE_RTOL = 1e-5

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
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, message: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke failed: {message}")


def run_text(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


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
    t0 = time.perf_counter()
    path = _build.build("quantize")
    qz._library()
    info = _build.build_info["quantize"]
    ptxas = [line.strip() for line in info["log"].splitlines()
             if "registers" in line or "spill" in line]
    emit("build", library=os.path.relpath(path), nvcc_seconds=info["seconds"],
         seconds=time.perf_counter() - t0, ptxas=ptxas)


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


def phase_kernels(model, x: torch.Tensor):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    flat_t, flat_b = capture_quantizer_inputs(model, x)
    check(flat_t.shape == (BATCH * 32 * 32, D) and flat_b.shape == (BATCH * 64 * 64, D),
          f"main-path shapes {tuple(flat_t.shape)} {tuple(flat_b.shape)}")
    cases.append(compare_with_plain(flat_t, model.quantize_t.embed, "main path, top grid"))
    cases.append(compare_with_plain(flat_b, model.quantize_b.embed, "main path, bottom grid"))
    for n in (flat_t.shape[0], flat_b.shape[0]):
        cases.append(compare_with_plain(
            torch.randn(n, D, generator=gen, device="cuda"),
            torch.randn(K, D, generator=gen, device="cuda"), f"normal rows N={n}"))
    for label, flat, embed, exact in awkward_cases(gen):
        cases.append(compare_with_plain(flat, embed, label, exact_ids=exact))
    emit("kernels", tie_rtol=TIE_RTOL, cases=cases)
    return flat_t, flat_b, cases


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
    tops, bots, labels, names = store.gather(np.arange(n), with_names=True)
    store.close()
    batches = n // EXTRACT_BATCH
    check({k: v - before[k] for k, v in qz.launch_counts.items()}
          == {"nearest_code_ids": batches, "nearest_code_lookup": batches},
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
    return {"rows": n, "seconds": seconds, "img_per_s": n / seconds,
            "codes_used_top": int(np.unique(tops).size),
            "codes_used_bottom": int(np.unique(bots).size)}


def phase_main(model, x: torch.Tensor) -> dict:
    """The main path with the counters at zero before and read after."""
    qz.reset_counts()

    dec, diff = model(x)
    torch.cuda.synchronize()
    check(dec.shape == x.shape and bool(torch.isfinite(dec).all()), "forward: shape or non-finite")
    check(diff.ndim == 0 and bool(torch.isfinite(diff)), "forward: diff")
    check(qz.launch_counts == {"nearest_code_ids": 0, "nearest_code_lookup": 2},
          f"forward must launch the lookup kernel twice: {qz.launch_counts}")

    id_t, id_b = model.encode_ids(x)
    torch.cuda.synchronize()
    check(id_t.shape == (BATCH, SIZE // 8, SIZE // 8) and id_b.shape == (BATCH, SIZE // 4, SIZE // 4),
          f"encode_ids shapes {tuple(id_t.shape)} {tuple(id_b.shape)}")
    check(qz.launch_counts == {"nearest_code_ids": 1, "nearest_code_lookup": 3},
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


def phase_times(model, x, flat_t, flat_b, launches, cases) -> dict:
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

    def host_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    torch.cuda.reset_peak_memory_stats()
    enc_ms = host_ms(lambda: model.encode_ids(x), 5)
    fwd_ms = host_ms(lambda: model(x), 3)
    emit("times", batch=BATCH, size=SIZE, encode_ids_ms=enc_ms,
         encode_ids_img_per_s=BATCH / enc_ms * 1e3, forward_ms=fwd_ms,
         forward_img_per_s=BATCH / fwd_ms * 1e3,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30)   # of these two
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


def phase_repeatability(model, x, calls: int = 6) -> None:
    """Optional: how far two calls on the same batch agree, with cuDNN free to
    pick non-deterministic algorithms and with it held to deterministic ones
    (what ``set_reference_precision`` sets), and what each costs."""
    def host_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

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
            "encode_ids_ms": host_ms(lambda: model.encode_ids(x)),
            "forward_ms": host_ms(lambda: model(x))}
    check(not any(out["deterministic"]["ids_flipped_per_call"]),
          f"ids are not repeatable under deterministic cuDNN: {out['deterministic']}")
    emit("repeatability", batch=BATCH, **out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--breakdown", action="store_true",
                    help="also time the stages of encode_ids")
    ap.add_argument("--repeatability", action="store_true",
                    help="also count the ids that flip between calls, with and without "
                         "deterministic cuDNN")
    args = ap.parse_args(argv)

    smi = phase_device()
    phase_build()
    with torch.no_grad():
        model = build_vqvae(device="cuda", seed=0)
        try:
            x = torch.from_numpy(np.random.default_rng(0).normal(
                scale=0.5, size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)).cuda()
            seed_codebooks_from_data(model, x)
            flat_t, flat_b, cases = phase_kernels(model, x)
            launches = phase_main(model, x)
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError(
                f"batch {BATCH} at {SIZE} px does not fit this card; the run does not "
                f"shrink the batch") from e
        record = phase_times(model, x, flat_t, flat_b, launches, cases)
        if args.breakdown:
            phase_breakdown(model, x)
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
