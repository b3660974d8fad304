#!/usr/bin/env python3
"""Times this checkout's hand-written kernels against another checkout's, in
turns on one card: the yardstick for a kernel that is redesigned or routed
anew.

    python3 compare_kernels.py --against DIR

``DIR`` holds a checkout of another commit, for example
``mkdir -p _parent/head && git archive HEAD | tar -x -C _parent/head``
(``_parent/`` is ignored by git).  Both checkouts' ``vqvae2_tpu_torch.ops`` are
loaded side by side; each builds its own libraries under its own
``ops/_built/``, every nvcc started together.  Each kernel runs on the same
inputs and is timed by CUDA events in the order other, this, this, other:

- the attention forward and the backward's dq and dk/dv kernels at the top
  prior's B*H = 256, N = 1024, for head widths 16, 32 and 64 and the wide
  heads 72 and 128 (``--channel`` 1152 and 2048), fp32 and bf16, without and
  with dropout 0.1; without dropout, also ``scaled_dot_product_attention``
  (with the strict mask, row 0 zeroed) on the same inputs, its forward and
  its backward (dq, dk and dv together);
- the three nearest-code kernels at the stage-1 train step's shapes
  (N = 524,288 and 131,072 rows, D = 64, K = 512) and at the deep adaptor's
  (N = 10,368 and 2,592 rows at 288x144, batch 16, D = 256, K = 512, the
  codebook drawn among the rows), each call also taken apart by the profiler
  (prologue, search, merge, statistics tail; device µs a call) beside the
  wrapper's host µs a call, and at D = 256 one library route each
  (``cdist`` + ``argmin``, and + ``bincount`` + ``index_add_``); with the
  ranges each checkout's wrapper splits the search into, where it splits, and
  at D = 256 this checkout's parts at each split into one to four ranges;
- the in-place ABN kernels at the inputs of the 13 ABNs of one ReID train
  step (``EmbedNet2(resnet50)``, 72 images at 288x144), in fp32 and bf16:
  K8 at each shape and its total over the 13 (``k8_step``), and at the
  largest (M = 186,624, C = 256) K8's two entries apart and K7; then K8 at
  C = 4096 (M = 11,664, fp32), where a lane of its ring takes two vectors of
  each row.

``--kernels`` picks some of ``attention``, ``search`` and ``abn`` (all three by
default) and ``prior_step``: a train step of the top prior at ``--channel
2048`` (D = 128, batch 32, fp32 at the port's reference precision) through
each checkout's trainer, in the same turns.

Prints the registers and spilled bytes of both checkouts' kernel variants,
one JSON line a shape (each kernel's two times a checkout, and the largest
difference between the two checkouts' first outputs), and the card's name and
power limit.  Needs one card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import gc
import importlib
import itertools
import json
import os
import sys
import time

import torch

from chip_smoke import (cuda_ms, library_attention, library_backward_ms, library_stats,
                        ptxas_summary, run_text, search_parts)

PACKAGE = "vqvae2_tpu_torch"
ROOT = os.path.dirname(os.path.abspath(__file__))
ATTENTION_BH, ATTENTION_N = 256, 1024
HEAD_DIMS = (16, 32, 64, 72, 128)
SEARCH_K = 512
PRIOR_STEP_BATCH = 32
# (N, D): the stage-1 train step's two grids, then the deep adaptor's two
SEARCH_SHAPES = ((524288, 64), (131072, 64), (10368, 256), (2592, 256))


# modules of each checkout besides its three kernel modules: what a train step
# of the top prior runs through
STEP_MODULES = ("train.pixelsnail", "train.vqvae", "utils.schedules")


def load_ops(root: str, extra=()) -> dict:
    """``root``'s ``flash_attention``, ``quantize`` and ``inplace_abn``
    modules, and those of ``extra`` (dotted names within the package, such as
    ``STEP_MODULES``) under their names, imported together beside whatever
    copy of the package is already loaded (which stays)."""
    def ours(name):
        return name == PACKAGE or name.startswith(PACKAGE + ".")

    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if ours(k)}
    sys.path.insert(0, root)
    try:
        mods = {name: importlib.import_module(f"{PACKAGE}.ops.{name}")
                for name in ("flash_attention", "quantize", "inplace_abn")}
        mods.update({name: importlib.import_module(f"{PACKAGE}.{name}") for name in extra})
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
    for mod in mods.values():
        if not os.path.abspath(mod.__file__).startswith(os.path.abspath(root) + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, not from {root}")
    return mods


def in_turns(other, this, reps: int) -> dict:
    """Times of two callables by CUDA events, in the order other, this, this,
    other, and the largest difference between their first outputs:
    ``{"other_ms": [..], "this_ms": [..], "max_abs_diff": x}``."""
    first = [out[0] if isinstance(out, tuple) else out for out in (other(), this())]
    diff = float((first[0].float() - first[1].float()).abs().max())
    t = [cuda_ms(other, reps), cuda_ms(this, reps), cuda_ms(this, reps), cuda_ms(other, reps)]
    return {"other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]], "max_abs_diff": diff}


def attention_launchers(fa, q, k, v, do, rate: float, seed: int = 0xC0FFEE):
    """One checkout's forward, dq and dk/dv launchers on the same inputs
    (widths that are multiples of 4, which every checkout takes as they are)."""
    o, lse = fa._causal_flash_attention_cuda(q, k, v, rate, seed)
    _, dsum = fa._backward_dq_cuda(q, k, v, o, lse, do, rate, seed)
    return {"forward": lambda: fa._causal_flash_attention_cuda(q, k, v, rate, seed),
            "dq": lambda: fa._backward_dq_cuda(q, k, v, o, lse, do, rate, seed),
            "dkv": lambda: fa._backward_dkv_cuda(q, k, v, do, lse, dsum, rate, seed)}


def compare_attention(other, this, gen: torch.Generator):
    for d, dtype, rate in itertools.product(HEAD_DIMS, (torch.float32, torch.bfloat16),
                                            (0.0, 0.1)):
        q, k, v, do = (torch.randn(ATTENTION_BH, ATTENTION_N, d, generator=gen,
                                   device="cuda").to(dtype) for _ in range(4))
        a = attention_launchers(other["flash_attention"], q, k, v, do, rate)
        b = attention_launchers(this["flash_attention"], q, k, v, do, rate)
        line = {"kernels": "attention", "bh": ATTENTION_BH, "n": ATTENTION_N, "d": d,
                "dtype": str(dtype)[6:], "dropout_rate": rate,
                **{name: in_turns(a[name], b[name], reps=10) for name in a}}
        if rate == 0.0:
            mask = torch.ones(ATTENTION_N, ATTENTION_N, dtype=torch.bool, device="cuda").tril(-1)
            mask[0, 0] = True
            line["library_forward_ms"] = cuda_ms(lambda: library_attention(q, k, v, mask), reps=10)
            line["library_backward_ms"] = library_backward_ms(q, k, v, do)
        print(json.dumps(line), flush=True)


def compare_search(other, this, gen: torch.Generator):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    embed64 = torch.randn(SEARCH_K, 64, generator=gen, device="cuda")
    for n, d in SEARCH_SHAPES:
        flat = torch.randn(n, d, generator=gen, device="cuda")
        embed = embed64 if d == 64 else flat[torch.randperm(
            n, generator=gen, device="cuda")[:SEARCH_K]].clone()
        calls = {"ids": lambda qz: qz.nearest_code_ids(flat, embed),
                 "lookup": lambda qz: qz.nearest_code(flat, embed, with_stats=False),
                 "stats": lambda qz: qz.nearest_code(flat, embed, with_stats=True)}
        line = {"kernels": "nearest_code", "n": n, "d": d, "k": SEARCH_K,
                **{name: in_turns(lambda: fn(other["quantize"]),
                                  lambda: fn(this["quantize"]), reps=20)
                   for name, fn in calls.items()}}
        line["parts"] = {who: {name: search_parts(lambda: fn(mods["quantize"]))
                               for name, fn in calls.items() if name != "ids"}
                         for who, mods in (("other", other), ("this", this))}
        for who, mods in (("other", other), ("this", this)):
            split = getattr(mods["quantize"], "search_split", None)
            if split is not None:
                line[f"{who}_search_ranges"] = split(n, SEARCH_K, sms)
        if d == 256 and hasattr(this["quantize"], "search_split"):
            qz = this["quantize"]
            line["this_by_ranges"] = {r: {
                "lookup": search_parts(lambda: qz._nearest_code_lookup_cuda(flat, embed, r)),
                "stats": search_parts(lambda: qz._nearest_code_stats_cuda(flat, embed, r))}
                for r in range(1, 5)}
        if d == 256:
            line["library_ms"] = {
                "lookup": cuda_ms(lambda: embed[torch.cdist(flat, embed).argmin(1)], reps=20),
                "stats": cuda_ms(lambda: library_stats(flat, embed), reps=20)}
        print(json.dumps(line), flush=True)


def abn_launchers(ia, x, z, dz, v: dict) -> dict:
    """One checkout's K7 and K8 launchers on the same rows: K8 whole, and its
    sums and dx entries apart.  A checkout whose wrapper has no split
    helpers is driven through its two C entries as its wrapper drives them."""
    m, c = z.shape
    inv, act, slope = 1.0 / m, ia.ACT_LEAKY_RELU, 0.01
    shift, w_t, mul = v["shift"], v["w_t"], v["mul"]
    out = {"k7": lambda: ia._abn_forward_cuda(x, v["mean"], v["scale"], shift, act, slope),
           "k8": lambda: ia._abn_backward_cuda(z, dz, shift, w_t, mul, inv, True, act, slope)}
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(ia, "_backward_sums_cuda"):
        edz, eydz = ia._backward_sums_cuda(z, dz, shift, w_t, True, act, slope, stream)
        out["k8_sums"] = lambda: ia._backward_sums_cuda(z, dz, shift, w_t, True, act, slope,
                                                        stream)
        out["k8_dx"] = lambda: ia._backward_dx_cuda(z, dz, shift, w_t, mul, edz, eydz, inv,
                                                    act, slope, stream)
        return out
    lib = ia._library()
    bf16 = int(z.dtype == torch.bfloat16)
    edz, eydz = (torch.empty(c, device="cuda") for _ in range(2))
    nbytes = lib.abn_backward_scratch_bytes(m, c)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    dx = torch.empty_like(z)

    def sums():
        assert lib.abn_backward_sums(z.data_ptr(), dz.data_ptr(), shift.data_ptr(),
                                     w_t.data_ptr(), edz.data_ptr(), eydz.data_ptr(),
                                     scratch.data_ptr(), nbytes, m, c, 0, slope, 1, bf16,
                                     stream) == 0
        return edz

    def dx_pass():
        assert lib.abn_backward_dx(z.data_ptr(), dz.data_ptr(), dx.data_ptr(), shift.data_ptr(),
                                   w_t.data_ptr(), mul.data_ptr(), edz.data_ptr(),
                                   eydz.data_ptr(), m, c, 0, slope, inv, bf16, stream) == 0
        return dx

    sums()
    return {**out, "k8_sums": sums, "k8_dx": dx_pass}


def compare_abn(other, this):
    """K7 and K8 of both checkouts at the 13 ABN inputs of one ReID train
    step, fp32 and bf16, in turns."""
    from chip_smoke import (BF16, REID_ARCH, REID_HW, REID_IDS, REID_K, REID_P, abn_vectors,
                            abn_work, capture_abn_inputs, reid_batch)
    from vqvae2_tpu_torch.part.part_model import EmbedNet2

    for dtype in (torch.float32, BF16):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(4)
            model = EmbedNet2(class_num=REID_IDS, arch=REID_ARCH, dtype=dtype).cuda()
        with torch.no_grad():
            inputs = capture_abn_inputs(model, reid_batch(4, REID_P, REID_K, REID_HW, REID_IDS))
        del model
        gen = torch.Generator(device="cuda").manual_seed(18)
        largest = max(range(len(inputs)), key=lambda i: inputs[i][1].numel())
        step = {"other_ms": [0.0, 0.0], "this_ms": [0.0, 0.0], "bound_ms": 0.0,
                "bound_two_pass_ms": 0.0}
        for i, (name, x) in enumerate(inputs):
            m, c = x.shape
            with torch.no_grad():
                v = abn_vectors(c, gen, x.float())
                z = this["inplace_abn"].abn_forward(x, v["mean"], v["scale"], v["shift"])
                dz = (1e-3 * torch.randn(m, c, generator=gen, device="cuda")).to(dtype)
                a = abn_launchers(other["inplace_abn"], x, z, dz, v)
                b = abn_launchers(this["inplace_abn"], x, z, dz, v)
                parts = ("k8", "k8_sums", "k8_dx", "k7") if i == largest else ("k8",)
                times = {p: in_turns(a[p], b[p], reps=20) for p in parts}
            work = abn_work("abn_backward", m, c, x.element_size())
            for who in ("other_ms", "this_ms"):
                step[who] = [s + t for s, t in zip(step[who], times["k8"][who])]
            step["bound_ms"] += work["bound_ms"]
            step["bound_two_pass_ms"] += work["bound_two_pass_ms"]
            print(json.dumps({"kernels": "abn", "name": name, "m": m, "c": c,
                              "dtype": str(dtype)[6:], **times,
                              **{k: work[k] for k in ("bound_ms", "bound_two_pass_ms",
                                                      "sums_bound_ms", "dx_bound_ms")}}),
                  flush=True)
            del z, dz, a, b
        print(json.dumps({"kernels": "k8_step", "dtype": str(dtype)[6:],
                          "launches": len(inputs), **step}), flush=True)
        del inputs
        torch.cuda.empty_cache()
    # K8 at C = 4096 (two vectors a lane) with as many elements as the largest input
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randn(186624 * 256 // 4096, 4096, generator=gen, device="cuda")
    with torch.no_grad():
        v = abn_vectors(x.shape[1], gen, x)
        z = this["inplace_abn"].abn_forward(x, v["mean"], v["scale"], v["shift"])
        dz = 1e-3 * torch.randn(*x.shape, generator=gen, device="cuda")
        a = abn_launchers(other["inplace_abn"], x, z, dz, v)
        b = abn_launchers(this["inplace_abn"], x, z, dz, v)
        times = {p: in_turns(a[p], b[p], reps=20) for p in ("k8", "k8_sums", "k8_dx")}
    print(json.dumps({"kernels": "abn", "name": "wide", "m": x.shape[0], "c": x.shape[1],
                      "dtype": "float32", **times}), flush=True)


def prior_step(mods: dict, steps: int = 3) -> dict:
    """One checkout's train step of the top prior at ``--channel 2048`` (D =
    128; fp32 under the port's reference precision, as the trainer runs it;
    dropout 0.1, seeded random weights) at chip_smoke's batch 32: ms a step by
    the host's clock over ``steps`` steps after a first one, and the attention
    kernels' launches in that first step."""
    from chip_smoke import PRIOR_CONFIG, TOP_HW, BOTTOM_HW, WIDE_PRIOR_CHANNEL, numpy_codes

    tp, tv, fa = mods["train.pixelsnail"], mods["train.vqvae"], mods["flash_attention"]
    config = argparse.Namespace(**{**PRIOR_CONFIG, "channel": WIDE_PRIOR_CHANNEL, "bf16": False})
    torch.manual_seed(0)
    with torch.device("cuda"):
        prior = tp.build_model("top", config, code_hw=(TOP_HW, BOTTOM_HW)).cuda()
    tx = mods["utils.schedules"].adam(3e-4)
    state = tv.create_state(prior, tx)
    step = tp.make_train_step(prior, tx, conditional=False)
    codes = {"target": numpy_codes(11, PRIOR_STEP_BATCH, TOP_HW, TOP_HW)}
    fa.reset_counts()
    step(state, codes)
    torch.cuda.synchronize()
    launches = dict(fa.launch_counts)
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, codes)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    del prior, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "launches": launches}


def compare_prior_step(other, this):
    """The top prior's train step at ``--channel 2048`` through each
    checkout's modules, in the order other, this, this, other (one model on
    the card at a time)."""
    import vqvae2_tpu_torch as port
    from chip_smoke import WIDE_PRIOR_CHANNEL

    port.set_reference_precision()   # no TF32 in cuDNN, deterministic algorithms
    runs = [prior_step(mods) for mods in (other, this, this, other)]
    print(json.dumps({"kernels": "prior_step", "channel": WIDE_PRIOR_CHANNEL,
                      "batch": PRIOR_STEP_BATCH,
                      "other_ms": [runs[0]["ms"], runs[3]["ms"]],
                      "this_ms": [runs[1]["ms"], runs[2]["ms"]],
                      "other_launches": runs[0]["launches"],
                      "this_launches": runs[1]["launches"]}), flush=True)


def build_all(checkouts: dict) -> dict:
    """Every library of both checkouts, each nvcc started together; the
    ptxas summary of each."""
    jobs = [(who, name, mod) for who, mods in checkouts.items() for name, mod in mods.items()
            if hasattr(mod, "_library")]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: job[2]._library(), jobs))
    out = {}
    for who, name, mod in jobs:
        info = mod._build.build_info[os.path.basename(mod.__file__)[:-3]]
        out.setdefault(who, {})[name] = {"nvcc_seconds": info["seconds"],
                                         "ptxas": ptxas_summary(info["log"])}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, help="a checkout of another commit")
    ap.add_argument("--kernels", nargs="+", choices=("attention", "search", "abn", "prior_step"),
                    default=("attention", "search", "abn"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    extra = STEP_MODULES if "prior_step" in args.kernels else ()
    checkouts = {"other": load_ops(os.path.abspath(args.against), extra),
                 "this": load_ops(ROOT, extra)}
    print(json.dumps({"against": args.against, "built": build_all(checkouts)}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "attention" in args.kernels:
        compare_attention(checkouts["other"], checkouts["this"], gen)
    if "search" in args.kernels:
        compare_search(checkouts["other"], checkouts["this"], gen)
    if "abn" in args.kernels:
        compare_abn(checkouts["other"], checkouts["this"])
    if "prior_step" in args.kernels:
        with torch.enable_grad():
            compare_prior_step(checkouts["other"], checkouts["this"])
    print(run_text(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
