"""The port's nearest-code search (plain PyTorch path, which is what runs on a
CPU tensor) against the JAX package's, on the same numpy inputs made from a
seed.  The JAX side runs both through ``nearest_code_reference`` and through
the Pallas kernels in interpret mode.

Tolerances: ids bit-equal; ``q`` bit-equal to ``E[idx]``; ``csum`` exact;
``esum`` rtol 1e-6 against the plain reference and 1e-5 against the Pallas
kernel, whose sums go through a three-way bf16 split (fp32 rows summed in
another order).
The CUDA kernels cannot run here: ``chip_smoke.py`` holds them against the
same plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.ops import quantize as jq
from vqvae2_tpu_torch.ops import _build
from vqvae2_tpu_torch.ops import quantize as tq

# (N, D, K): ragged N, N below one TPU sublane tile, the deep config's width,
# the main path's width
SHAPES = [(37, 64, 512), (5, 8, 16), (130, 256, 32), (257, 64, 512), (1, 16, 8)]


def _inputs(n, d, k, seed=0, duplicate=False):
    g = np.random.default_rng(seed)
    flat = g.normal(size=(n, d)).astype(np.float32)
    embed = g.normal(size=(k, d)).astype(np.float32)
    if duplicate:
        embed[k // 2:] = embed[: k - k // 2]   # every code twice: exact ties
    return flat, embed


def _jax_pallas(launcher, flat, embed):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return launcher(jnp.asarray(flat), jnp.asarray(embed), block_n=128)


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_nearest_code_matches_jax_reference(n, d, k):
    flat, embed = _inputs(n, d, k)
    ridx, rq, rcsum, resum = jq.nearest_code_reference(jnp.asarray(flat), jnp.asarray(embed))
    idx, q, csum, esum = tq.nearest_code(torch.from_numpy(flat), torch.from_numpy(embed))
    assert idx.dtype == torch.int32 and q.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(q.numpy(), embed[idx.numpy()])
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(csum.numpy(), np.asarray(rcsum))
    np.testing.assert_allclose(esum.numpy(), np.asarray(resum), rtol=1e-5, atol=1e-6)
    # the reference function and the wrapper are the same thing on the CPU
    for a, b in zip(tq.nearest_code_reference(torch.from_numpy(flat), torch.from_numpy(embed)),
                    (idx, q, csum, esum)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_nearest_code_matches_pallas_interpret(n, d, k):
    """Against the three Pallas kernels as the JAX package's own tests run them
    on the CPU."""
    flat, embed = _inputs(n, d, k, seed=1)
    tf, te = torch.from_numpy(flat), torch.from_numpy(embed)

    pidx = _jax_pallas(jq._nearest_code_pallas_ids, flat, embed)
    np.testing.assert_array_equal(tq.nearest_code_ids(tf, te).numpy(), np.asarray(pidx))

    pidx, pq = _jax_pallas(jq._nearest_code_pallas_nostats, flat, embed)
    idx, q, csum, esum = tq.nearest_code(tf, te, with_stats=False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
    np.testing.assert_array_equal(q.numpy(), np.asarray(pq))
    assert not csum.any() and not esum.any()
    assert csum.shape == (k,) and esum.shape == (k, d)

    pidx, pq, pcsum, pesum = _jax_pallas(jq._nearest_code_pallas, flat, embed)
    idx, q, csum, esum = tq.nearest_code(tf, te, with_stats=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pidx))
    np.testing.assert_array_equal(q.numpy(), np.asarray(pq))
    np.testing.assert_array_equal(csum.numpy(), np.asarray(pcsum))
    np.testing.assert_allclose(esum.numpy(), np.asarray(pesum), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,d,k", [(64, 16, 32), (37, 64, 512)])
def test_exact_ties_take_the_lowest_index(n, d, k):
    flat, embed = _inputs(n, d, k, seed=2, duplicate=True)
    ridx = np.asarray(jq.nearest_code_reference(jnp.asarray(flat), jnp.asarray(embed))[0])
    pidx = np.asarray(_jax_pallas(jq._nearest_code_pallas_ids, flat, embed))
    idx = tq.nearest_code_ids(torch.from_numpy(flat), torch.from_numpy(embed)).numpy()
    assert idx.max() < k // 2          # the duplicate in the upper half never wins
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(idx, pidx)


def test_bfloat16_rows():
    """bf16 rows are widened to fp32 for the search; ``q`` comes back in bf16."""
    flat, embed = _inputs(50, 16, 32, seed=3)
    jflat = jnp.asarray(flat).astype(jnp.bfloat16)
    tflat = torch.from_numpy(flat).to(torch.bfloat16)
    np.testing.assert_array_equal(tflat.float().numpy(), np.asarray(jflat.astype(jnp.float32)))
    ridx, rq, _, _ = jq.nearest_code_reference(jflat, jnp.asarray(embed))
    idx, q, _, _ = tq.nearest_code(tflat, torch.from_numpy(embed), with_stats=False)
    assert q.dtype == torch.bfloat16
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(q.float().numpy(), np.asarray(rq.astype(jnp.float32)))


def test_quantize_lookup_matches_jax():
    g = np.random.default_rng(4)
    embed = g.normal(size=(32, 8)).astype(np.float32)
    idx = g.integers(0, 32, size=(4, 5, 6))
    want = np.asarray(jq.quantize_lookup(jnp.asarray(idx), jnp.asarray(embed)))
    for dtype in (torch.int32, torch.int64):
        out = tq.quantize_lookup(torch.from_numpy(idx).to(dtype), torch.from_numpy(embed))
        np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("fn", [tq.nearest_code, tq.nearest_code_ids])
def test_bad_shapes_raise_like_jax(fn):
    with pytest.raises(ValueError, match="bad shapes"):
        fn(torch.zeros(4, 8), torch.zeros(16, 4))
    with pytest.raises(ValueError, match="bad shapes"):
        fn(torch.zeros(4, 8, 1), torch.zeros(16, 8))


def test_counters_count_launches_only():
    """On the CPU the plain version runs: no launch is counted, and each
    flavour counts its own plain call."""
    tq.reset_counts()
    flat, embed = (torch.from_numpy(a) for a in _inputs(9, 8, 16))
    tq.nearest_code_ids(flat, embed)
    tq.nearest_code(flat, embed, with_stats=False)
    tq.nearest_code(flat, embed, with_stats=True)
    assert tq.launch_counts == {"nearest_code_ids": 0, "nearest_code_lookup": 0,
                                "nearest_code_stats": 0}
    assert tq.plain_counts == {"nearest_code_ids": 1, "nearest_code_lookup": 1,
                               "nearest_code_stats": 1}
    tq.reset_counts()
    assert not any(tq.plain_counts.values())


# -- the statistics flavour (K3) ----------------------------------------------------

def _stats_case(name):
    """(flat, embed) of each case the statistics must get right."""
    if name == "ragged N":               # 300 rows: the Pallas launcher pads to 384
        return _inputs(300, 64, 512, seed=5)
    if name == "all rows on one code":   # an untrained encoder: tiny rows, one near code
        flat, embed = _inputs(200, 16, 32, seed=6)
        embed[3] = 0.0
        return (0.01 * flat).astype(np.float32), embed
    if name == "K=1":
        return _inputs(130, 8, 1, seed=7)
    if name == "deep D=256":
        return _inputs(257, 256, 512, seed=8)
    raise ValueError(name)


STATS_CASES = ["ragged N", "all rows on one code", "K=1", "deep D=256"]


def _check_stats(got, want, esum_rtol):
    idx, q, csum, esum = got
    ridx, rq, rcsum, resum = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(idx.numpy(), ridx)
    np.testing.assert_array_equal(q.numpy(), rq)
    np.testing.assert_array_equal(csum.numpy(), rcsum)
    np.testing.assert_allclose(esum.numpy(), resum, rtol=esum_rtol, atol=1e-6)
    assert csum.dtype == esum.dtype == torch.float32


@pytest.mark.parametrize("case", STATS_CASES)
def test_statistics_match_the_jax_reference(case):
    flat, embed = _stats_case(case)
    want = jq.nearest_code_reference(jnp.asarray(flat), jnp.asarray(embed))
    got = tq.nearest_code(torch.from_numpy(flat), torch.from_numpy(embed), with_stats=True)
    _check_stats(got, want, esum_rtol=1e-6)
    assert float(got[2].sum()) == flat.shape[0]          # every row counted once
    if case == "all rows on one code":
        assert int(got[2][3]) == flat.shape[0]


@pytest.mark.parametrize("case", STATS_CASES)
def test_statistics_match_the_interpreted_pallas_kernel(case):
    """The TPU kernel sums across a sequential grid and subtracts its pad rows'
    counts (``N`` not a multiple of the 128-row block); the port's counts and
    sums must come out the same."""
    flat, embed = _stats_case(case)
    want = _jax_pallas(jq._nearest_code_pallas, flat, embed)
    got = tq.nearest_code(torch.from_numpy(flat), torch.from_numpy(embed), with_stats=True)
    _check_stats(got, want, esum_rtol=1e-5)


def test_statistics_flavour_is_not_differentiable():
    """The zero vjp of the JAX package: the wrapper runs under no_grad."""
    flat = torch.randn(12, 8, requires_grad=True)
    embed = torch.randn(16, 8, requires_grad=True)
    out = tq.nearest_code(flat, embed, with_stats=True)
    assert not any(t.requires_grad for t in out)


@pytest.mark.parametrize("d", [30, 1, 66])
def test_widths_that_are_no_multiple_of_4_match_the_jax_reference(d):
    """``embed_dim`` 30 (and 1 and 66), which the JAX launchers take and the
    CUDA kernels take through a zero pad of the feature axis: ids bit-equal,
    q bit-equal to the reference's, the statistics as for any width."""
    flat, embed = _inputs(300, d, 64, seed=9)
    want = jq.nearest_code_reference(jnp.asarray(flat), jnp.asarray(embed))
    tf, te = torch.from_numpy(flat), torch.from_numpy(embed)
    _check_stats(tq.nearest_code(tf, te, with_stats=True), want, esum_rtol=1e-6)
    np.testing.assert_array_equal(tq.nearest_code_ids(tf, te).numpy(), np.asarray(want[0]))
    idx, q, _, _ = tq.nearest_code(tf, te, with_stats=False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(q.numpy(), np.asarray(want[1]), rtol=0, atol=0)


def _fma_chain(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise ``sum_d a[d] * b[d]`` as one fp32 FMA chain over d in order,
    the kernels' dot product: each step's exact product (fp64 holds it) added
    to the running fp32 sum and rounded once to fp32."""
    s = np.zeros(a.shape[0], dtype=np.float32)
    for c in range(a.shape[1]):
        s = (a[:, c].astype(np.float64) * b[:, c].astype(np.float64) + s).astype(np.float32)
    return s


@pytest.mark.parametrize("d", [30, 1, 66])
def test_the_kernels_zero_pad_changes_no_dot_product(d):
    """What the wrapper hands the CUDA kernels for a width that is no multiple
    of 4: both operands zero-padded to the next multiple of 4 (a copy; other
    widths pass through as they are), and an FMA chain over the padded rows
    gives the same bits as over the unpadded ones."""
    flat, embed = _inputs(50, d, 50, seed=10)
    pf, pe = _build.kernel_operands(torch.from_numpy(flat), torch.from_numpy(embed))
    assert pf.shape == (50, -(-d // 4) * 4) and pe.shape == (50, pf.shape[1])
    assert pf.is_contiguous() and bool((pf[:, d:] == 0).all()) and bool((pe[:, d:] == 0).all())
    np.testing.assert_array_equal(pf[:, :d].numpy(), flat)
    for a, b in ((flat, embed), (flat, flat), (embed, embed)):
        pa = np.pad(a, ((0, 0), (0, pf.shape[1] - d)))
        pb = np.pad(b, ((0, 0), (0, pf.shape[1] - d)))
        np.testing.assert_array_equal(_fma_chain(pa, pb).view(np.int32),
                                      _fma_chain(a, b).view(np.int32))
    aligned = torch.from_numpy(_inputs(8, 64, 4)[0])
    assert _build.kernel_operands(aligned, aligned)[0] is aligned


# -- the split of the search over the codebook (CUDA kernels' launch geometry) -----

# (N, K, SMs)
SPLIT_SHAPES = [(524288, 512, 132), (131072, 512, 132), (10368, 512, 132), (2592, 512, 132),
                (1, 512, 132), (777, 130, 132), (300, 512, 132), (128, 12288, 132),
                (2592, 512, 78)]


@pytest.mark.parametrize("n,k,sms", SPLIT_SHAPES)
def test_search_split_covers_every_code_once_in_whole_chunks(n, k, sms):
    ranges = tq.search_split(n, k, sms)
    assert 1 <= ranges <= min(-(-k // tq.CHUNK), tq.MAX_RANGES)
    codes = tq.code_ranges(k, ranges)
    assert len(codes) == ranges and codes[0][0] == 0 and codes[-1][1] == k
    for (_, b), (c, _) in zip(codes, codes[1:]):
        assert b == c and b % tq.CHUNK == 0       # contiguous, cut between chunks
    assert all(b > a for a, b in codes)           # no range is empty
    # the same arguments give the same split, whatever was asked before
    tq.search_split.cache_clear()
    assert tq.search_split(n, k, sms) == ranges


@pytest.mark.parametrize("n,want", [(524288, 1), (131072, 1), (10368, 3), (2592, 4)])
def test_search_split_at_the_main_paths_grids(n, want):
    """Stage 1's grids make thousands of row tiles, which fill the card on
    their own: one range, the search kernel as before the split.  The deep
    adaptor's grids at D = 256 make 81 and 21 tiles for 132 SMs, one block an
    SM: 21 tiles take four ranges of one chunk (84 blocks, one wave of a
    quarter of the walk); 81 take three (one, one and two chunks), which the
    scheduler packs into three chunks' time, where four ranges make 324
    blocks in three waves with three start-ups."""
    assert tq.search_split(n, 512, 132) == want


def _split_and_merge(flat: np.ndarray, embed: np.ndarray, ranges: int):
    """A plain emulation of the split search: each range's first maximum of
    the scores (every score the same bits wherever it is computed, so the
    columns of one score matrix), then the ranges merged in rising order,
    a range's best taken only where strictly larger; ``q`` gathered."""
    scores = tq.nearest_code_scores(torch.from_numpy(flat), torch.from_numpy(embed)).numpy()
    best = np.full(flat.shape[0], -np.inf, dtype=np.float32)
    idx = np.full(flat.shape[0], np.iinfo(np.int32).max, dtype=np.int64)
    for a, b in tq.code_ranges(embed.shape[0], ranges):
        local = a + np.argmax(scores[:, a:b], axis=1)       # the first maximum in the range
        s = scores[np.arange(flat.shape[0]), local]
        take = s > best
        best[take], idx[take] = s[take], local[take]
    idx = np.where(idx < embed.shape[0], idx, 0).astype(np.int32)
    return idx, embed[idx]


@pytest.mark.parametrize("ranges", [1, 2, 3, 4])
def test_split_and_merge_matches_the_jax_reference(ranges):
    flat, embed = _inputs(300, 256, 512, seed=11)
    ridx, rq, _, _ = jq.nearest_code_reference(jnp.asarray(flat), jnp.asarray(embed))
    idx, q = _split_and_merge(flat, embed, ranges)
    np.testing.assert_array_equal(idx, np.asarray(ridx))
    np.testing.assert_array_equal(q, np.asarray(rq))
    np.testing.assert_array_equal(idx, tq.nearest_code_ids(torch.from_numpy(flat),
                                                           torch.from_numpy(embed)).numpy())


@pytest.mark.parametrize("ranges", [2, 3, 4])
def test_an_exact_tie_across_ranges_takes_the_lower_index(ranges):
    """Codes 5 and 389 are the same row and lie in different ranges; rows near
    them tie exactly across the boundary and must take code 5, as argmax and
    the Pallas kernel do."""
    flat, embed = _inputs(300, 256, 512, seed=12)
    embed[389] = embed[5]
    flat = (embed[5] + 0.01 * flat).astype(np.float32)
    (a5, b5), = [r for r in tq.code_ranges(512, ranges) if r[0] <= 5 < r[1]]
    assert not a5 <= 389 < b5
    idx, q = _split_and_merge(flat, embed, ranges)
    assert (idx == 5).all()
    np.testing.assert_array_equal(q, np.broadcast_to(embed[5], q.shape))
    ridx = np.asarray(jq.nearest_code_reference(jnp.asarray(flat), jnp.asarray(embed))[0])
    pidx = np.asarray(_jax_pallas(jq._nearest_code_pallas_ids, flat, embed))
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(idx, pidx)
