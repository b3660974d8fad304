// Strictly-causal flash attention, forward and backward, written for Hopper
// (sm_90a).
//
// Replaces three TPU kernels of vqvae2_tpu/ops/flash_attention.py:
//   flash_fwd_kernel      <- _fwd_kernel   (launched by _flash_fwd; entry fa_forward)
//   flash_bwd_dq_kernel   <- _dq_kernel    (launched by _flash_bwd; entry fa_backward_dq)
//   flash_bwd_dkv_kernel  <- _dkv_kernel   (launched by _flash_bwd; entry fa_backward_dkv)
// each with a variant for heads wider than 64 features (the *_wide_kernel
// below) and K5 with a second narrow design (flash_bwd_dq_fma_kernel).
//
// What is computed, for q, k, v (BH, N, D) and each (bh, i):
//   s[j]   = <q[i], k[j]> * (1 / sqrt(D))       in true fp32, keys j < i only
//   o[i]   = sum_j softmax(s)[j] * keep[i, j] / (1 - rate) * v[j]
//   lse[i] = log sum_j exp(s[j])
// Query i sees keys j < i strictly.  Row 0 sees nothing: o[0] is exactly zero
// and lse[0] is -1e30.  The softmax normaliser is summed over the undropped
// probabilities; dropout scales only what multiplies v.  Nothing of size
// (N, N) is written anywhere.
//
// What bounds it on this card: operations.  The two products are 4*N*N*D/2
// flops a head, while q, k, v in and o, lse out are 4*N*D*4 bytes: at N = 1024,
// D = 16 the products need about six times the memory's time on the CUDA
// cores.  The priors' logits are held to 2e-5, so a product in one TF32 pass
// (about 1e-3 off) is out.
//
// All three kernels (K4, K5, K6) run their products other than the scores on
// the tensor cores by mma.sync m16n8k8 TF32 in three passes: x = hi +
// lo, both TF32, and a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with fp32
// accumulation, which keeps fp32's accuracy (tests/test_torch_flash_attention.py
// emulates it).  The split takes four integer and fp32 operations
// (cvt.rna.tf32 runs at about a quarter of the fp32 rate; chip_smoke.py's
// phase probe measures both).  The tensor cores' fp32 accumulation rounds
// toward zero: summed over a thousand keys in one accumulator, dv drifted an
// order of magnitude further from the plain version than the CUDA-core
// kernel's did.  So each (sub-)tile's products go into a fresh accumulator that
// is added to the running sum by a rounded fp32 add.  Each warp splits the
// fragments it loads from the raw staged tiles: a split pass through shared
// memory would double the fragment loads, and those loads, not the splits'
// integer operations, set the kernels' pace.  wgmma is not used: D = 16 is one
// k-step of a TF32 wgmma, and a TF32 wgmma takes both operands K-major, which V
// (and dO, Q in the backward's second products) is not.
//
// K4 up to 64 features: a block of four warps owns 64 query rows, 16 a warp
// (the M of its mma tiles), each thread two rows.  It walks tiles of 64 keys
// (32 at D = 64), staged two deep in shared memory by cp.async, up to the
// diagonal; a warp skips the key columns wholly above its rows.  The scores
// stay on the CUDA cores: s[i, j] is an fp32 FMA chain over d in order, as the
// plain version's product rounds it, in the layout of an mma accumulator.  Scores computed
// more exactly leave o further from the plain version than FA_TOL once they
// reach a few hundred (q * 50 in chip_smoke.py), because the plain version's
// own rounding of them moves o that far.  The online softmax runs on those
// fragments (row maximum and sum over the four lanes of a quad), and
// O += P.V runs on the tensor cores with P straight from the registers: the
// accumulator layout (a lane holds columns 2t, 2t + 1) is not the A operand's
// (k = t, t + 4), so the keys are reordered instead, k = t being key 2t and
// k = t + 4 key 2t + 1, and V's B fragment is read from those two rows.
//
// Any head width.  D that is not a multiple of 4 is zero-padded to one by the
// wrapper (an FMA of 0 * 0 onto a score leaves it bit for bit; the scale takes
// the head's own D).  Up to 64 features a head is one tile wide (variants of
// 16, 32 and 64 columns).  Above, all three take wide heads in kernels of
// their own (flash_fwd_wide_kernel, flash_bwd_dq_wide_kernel,
// flash_bwd_dkv_wide_kernel below): one 128-wide tile up to 128 features,
// with the block's own rows staged once in dynamic shared memory and the
// other operand streamed through a cp.async ring, so that S (and dP) are
// computed once for all the columns a block writes.  Above 128 the tile is
// cut into 128-wide chunks and a block owns one 128-wide group of its
// output's columns; the scores continue their FMA chains across the chunks
// in order, so they round as one chain over d.
//
// Dropout is a counter-based draw: Philox-4x32-10 keyed on the seed, with the
// absolute (bh, i, j / 4) as the counter and word j % 4 of the result as the
// element's bits, so the mask does not depend on any tiling and a backward
// kernel regenerates it from the same function (dropout_bits4 below).  An
// element is kept when its bits >= rate * 2^32.  Each draw is made once: in
// K4 the two lanes that hold a quad's halves each draw it for one of their two
// rows and exchange two words; in K6 each lane draws one (query, key quad) and
// the keep bits go to the lanes that hold them by shuffles.  fa_keep_mask
// writes the same draw out as a (BH, N, N) byte mask for comparisons at small
// N.
//
// Backward.  With lse from the forward and m = keep / (1 - rate) (1 without
// dropout), for every visible pair j < i:
//   p[i, j]  = exp(s[i, j] - lse[i])             recomputed, never stored
//   dp[i, j] = <do[i], v[j]> * m[i, j]
//   ds[i, j] = p * (dp - dsum[i]) * (1 / sqrt(D)),   dsum[i] = <do[i], o[i]>
//   dq[i] = sum_j ds * k[j];  dk[j] = sum_i ds * q[i];  dv[j] = sum_i p * m * do[i]
// Up to 64 features both backward kernels run on K4's design where the dq
// kernel's CUDA-core design (below) does not run: see dq_on_cuda_cores.  The
// dq kernel (K5): a block of
// four warps owns 64 query rows, 16 a warp, with dq in registers; it walks key
// tiles (64, or 32 at D = 64) up to the diagonal with k and v staged two deep
// by cp.async; the scores are fp32 FMA chains rounded as K4's, dP = dO.V^T and
// dq += dS.K are three-pass TF32 mma (dS from the registers as K4's P); it
// also computes dsum for its rows from do and o and writes it out.  The dk/dv
// kernel (K6) runs after it on the same stream and reads its dsum: a block of
// four warps owns 64 keys, 16 a warp, each thread two keys with dk and dv (and
// at D = 16 k and v) in registers; it walks query tiles (64, or 32 at D = 64) from the
// diagonal to N with q, do, lse and dsum staged two deep by cp.async.  Of its
// four products, S^T = K.Q^T stays fp32 FMA chains rounded as the forward's
// scores are (K5 rounds them so too): p = exp(s - lse) recomputed from scores
// rounded otherwise overflows once training has grown the scores to 1e10.
// dP^T = V.dO^T, dV += (P^T m).dO and dK += dS^T.Q are three-pass TF32 mma,
// the last two with the same reordering of the accumulators as K4's P.V.  The
// mask is a factor: row 0 contributes and receives exactly nothing, and no key
// j >= i is touched by row i.

#include <cmath>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FMA_THREADS = 64;   // threads of a CUDA-core K5 block
constexpr int FMA_KT = 64;        // keys in its shared tile
constexpr float NEG = -1e30f;     // the fill of masked scores; not -inf (NaN from inf - inf)
constexpr float TINY = 1e-30f;    // floor of the normaliser

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Philox-4x32 with 10 rounds (Salmon et al., "Parallel random numbers: as easy
// as 1, 2, 3").
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr unsigned int M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr unsigned int W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const unsigned int hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const unsigned int hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += W0;
    key.y += W1;
  }
  return ctr;
}

// The dropout bits of the four elements (bh, i, 4*quad .. 4*quad + 3): words
// x, y, z, w in that order.  Every kernel that drops or regenerates the mask
// calls this and nothing else.
__device__ __forceinline__ uint4 dropout_bits4(unsigned long long seed, long long bh, int i,
                                               int quad) {
  const uint4 ctr = make_uint4(static_cast<unsigned int>(quad), static_cast<unsigned int>(i),
                               static_cast<unsigned int>(bh),
                               static_cast<unsigned int>(static_cast<unsigned long long>(bh) >> 32));
  const uint2 key = make_uint2(static_cast<unsigned int>(seed),
                               static_cast<unsigned int>(seed >> 32));
  return philox4x32_10(ctr, key);
}

// ---------------------------------------------------------------------------
// Tensor-core pieces shared by K4 and K6
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_ROWS = 16 * TC_WARPS;   // query rows of a K4 block, keys of a K6 block
constexpr unsigned int FULL = 0xffffffffu;

// Rows of the other operand's tile (keys in K4, queries in K6): 64, or 32 at
// DP = 64, so that two stages of two tiles stay within 48 KB of static shared
// memory.
template <int DP>
constexpr int kTcTile = DP >= 64 ? 32 : 64;

// Row stride of a staged tile in floats: with DP + 4 the 32 lanes of every
// fragment load (rows g, columns t; or rows 2t, 2t + 1, columns g) fall on 32
// different banks, and rows stay 16-byte aligned for cp.async.
template <int DP>
constexpr int kTcLd = DP + 4;

// A bf16 value is exact in TF32: its low part is zero and the passes that
// would multiply it are skipped.
template <typename T>
struct ExactInTf32 : std::false_type {};
template <>
struct ExactInTf32<__nv_bfloat16> : std::true_type {};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x = hi + lo as TF32 operands.  hi is x rounded to TF32 (to nearest, ties
// away from zero): half a TF32 unit added to the magnitude's bits, the 13 bits
// below TF32's mantissa cleared.  lo is the remainder x - hi (exact in fp32)
// with half a unit added: the tensor cores read only an operand's top 19 bits,
// so it is rounded the same way.  Four operations, integer and fp32, at full
// rate (cvt.rna.tf32.f32 runs at about a quarter of it).
__device__ __forceinline__ void split_tf32(float x, unsigned int& hi, unsigned int& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c += a * b on one 16x8x8 tile: TF32 operands, fp32 accumulation.  Fragments
// (g = lane / 4, t = lane % 4): a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k t, column g), b1 (t + 4, g); c0 (row g, column
// 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned int (&a)[4],
                                         const unsigned int (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b to about fp32's accuracy in three TF32 passes, the small terms
// first: a_lo * b_hi + a_hi * b_lo + a_hi * b_hi (a_lo * b_lo lies below fp32's
// rounding).  An operand that is exact in TF32 has no low part: its pass is
// skipped.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const unsigned int (&ah)[4],
                                           const unsigned int (&al)[4], const unsigned int (&bh)[2],
                                           const unsigned int (&bl)[2]) {
  if (!A_EXACT) mma_tf32(c, al, bh);
  if (!B_EXACT) mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// Asynchronous copies global -> shared; a copy whose `in` is false reads
// nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most one group (the tile staged last) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Rows row0 .. row0 + ROWS - 1, columns c0 .. c0 + DP - 1 of a (n, d) matrix
// into a (ROWS, LD) fp32 tile, zero past row n and column d, by a block of
// THREADS threads.  fp32 goes by cp.async; bf16 is widened on the way (plain
// loads, stored at once).
template <typename T, int ROWS, int DP, int LD, int THREADS = TC_THREADS>
__device__ __forceinline__ void stage_rows(float (*dst)[LD], const T* __restrict__ src, int row0,
                                           int n, int d, int c0 = 0) {
  for (int f = threadIdx.x; f < ROWS * (DP / 4); f += THREADS) {
    const int r = f / (DP / 4);
    const int c = (f % (DP / 4)) * 4;
    const bool in = row0 + r < n && c0 + c < d;
    const T* p = in ? src + static_cast<long long>(row0 + r) * d + c0 + c : src;
    if constexpr (std::is_same<T, float>::value) {
      cp_async16(&dst[r][c], p, in);
    } else {
      *reinterpret_cast<float4*>(&dst[r][c]) = in ? load4(p) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The keep bits of a score fragment under K4's and K5's layout: keys
// 8j + 2t, 8j + 2t + 1 of rows ra, rb are words 2(t & 1), 2(t & 1) + 1 of
// the Philox quad key0 / 4 + t / 2 (key0 = the column tile's first key).  Of
// the two lanes that share a quad, the even one draws it for row ra and the
// odd one for row rb; each sends the other the two words it holds for the
// other's keys.  Bit c of the result: element c of the fragment is kept.
__device__ __forceinline__ unsigned int keep_bits_rows(unsigned long long seed, long long bh,
                                                       int ra, int rb, int key0, int t,
                                                       unsigned int threshold) {
  const bool odd = t & 1;
  const uint4 bits = dropout_bits4(seed, bh, odd ? rb : ra, key0 / 4 + (t >> 1));
  const unsigned int r0 = __shfl_xor_sync(FULL, odd ? bits.x : bits.z, 1);
  const unsigned int r1 = __shfl_xor_sync(FULL, odd ? bits.y : bits.w, 1);
  const unsigned int wa0 = odd ? r0 : bits.x, wa1 = odd ? r1 : bits.y;   // row ra
  const unsigned int wb0 = odd ? bits.z : r0, wb1 = odd ? bits.w : r1;   // row rb
  return static_cast<unsigned int>(wa0 >= threshold) |
         static_cast<unsigned int>(wa1 >= threshold) << 1 |
         static_cast<unsigned int>(wb0 >= threshold) << 2 |
         static_cast<unsigned int>(wb1 >= threshold) << 3;
}

// The keep bits of K6's score fragment (keys ka = key0 + g, kb = ka + 8 of
// the warp's 16; queries i0, i0 + 1): the warp's 16 keys are four Philox
// quads, and its lanes of one t hold two queries: 8 draws, one a lane.  Lane
// (g, t) draws quad key0 / 4 + g / 2 of query i0 + (g & 1) and turns it into
// four keep bits; a lane reads the bits of its two keys (word g & 3 of quads
// g / 4 and 2 + g / 4) from the four lanes that drew them.  Bit c: element c
// (key ka for c < 2 else kb, query i0 + (c & 1)) is kept.
__device__ __forceinline__ unsigned int keep_bits_keys(unsigned long long seed, long long bh,
                                                       int key0, int i0, int g, int t,
                                                       unsigned int threshold) {
  const uint4 bits = dropout_bits4(seed, bh, i0 + (g & 1), (key0 >> 2) + (g >> 1));
  const unsigned int mine = static_cast<unsigned int>(bits.x >= threshold) |
                            static_cast<unsigned int>(bits.y >= threshold) << 1 |
                            static_cast<unsigned int>(bits.z >= threshold) << 2 |
                            static_cast<unsigned int>(bits.w >= threshold) << 3;
  const int h = g >> 2;
  const unsigned int m0 = __shfl_sync(FULL, mine, (2 * h) * 4 + t);       // ka, i0
  const unsigned int m1 = __shfl_sync(FULL, mine, (2 * h + 1) * 4 + t);   // ka, i0 + 1
  const unsigned int m2 = __shfl_sync(FULL, mine, (2 * h + 4) * 4 + t);   // kb, i0
  const unsigned int m3 = __shfl_sync(FULL, mine, (2 * h + 5) * 4 + t);   // kb, i0 + 1
  const int w = g & 3;
  return ((m0 >> w) & 1u) | ((m1 >> w) & 1u) << 1 | ((m2 >> w) & 1u) << 2 |
         ((m3 >> w) & 1u) << 3;
}

// K4 up to 64 features: o and lse.  One block of four warps owns 64 query
// rows, 16 a warp (the rows of its mma tiles), each thread two rows (g and g
// + 8 of its warp's), with q in registers.  It walks KT-key tiles of K and V,
// staged two deep by cp.async, up to the diagonal.  Blocks are ordered by the
// length of their key loop, longest first, across all heads.
template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, long long bh_count, int n, int d,
                 int nq, float scale, unsigned int threshold, float inv_keep,
                 unsigned long long seed) {
  constexpr int KT = kTcTile<DP>;
  constexpr int LD = kTcLd<DP>;
  constexpr int DS = DP / 8;     // 8-wide column tiles of O
  constexpr int JT = KT / 8;     // 8-key column tiles of S; k-steps of O += P.V
  constexpr bool EXACT = ExactInTf32<T>::value;
  __shared__ __align__(16) float k_tile[2][KT][LD];
  __shared__ __align__(16) float v_tile[2][KT][LD];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long bh = blockIdx.x % bh_count;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int row0 = qt * TC_ROWS + warp * 16;   // first row of this warp
  const int ra = row0 + g;                     // this thread's two rows
  const int rb = ra + 8;
  const long long base = bh * n * d;
  const T* kb = k + base;
  const T* vb = v + base;

  float qa[DP], qb[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qa[c] = (ra < n && c < d) ? to_float(q[base + static_cast<long long>(ra) * d + c]) : 0.f;
    qb[c] = (rb < n && c < d) ? to_float(q[base + static_cast<long long>(rb) * d + c]) : 0.f;
  }
  float acc[DS][4];   // O: rows ra (0, 1) and rb (2, 3), columns 8s + 2t and 8s + 2t + 1
#pragma unroll
  for (int s = 0; s < DS; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;
  // the running maximum, and this lane's part of the normaliser (its 2 columns
  // of every 8), of rows ra and rb
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;

  // The block's rows see keys below key_end; this warp's rows see keys below
  // warp_last (0 for a warp whose rows all lie beyond N).
  const int key_end = min(n, qt * TC_ROWS + TC_ROWS) - 1;
  const int warp_last = row0 < n ? min(n, row0 + 16) - 1 : 0;
  const int tiles = (key_end + KT - 1) / KT;

  if (tiles > 0) {
    stage_rows<T, KT, DP, LD>(k_tile[0], kb, 0, n, d);
    stage_rows<T, KT, DP, LD>(v_tile[0], vb, 0, n, d);
  }
  cp_async_commit();
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * KT;
    const int st = it & 1;
    if (it + 1 < tiles) {   // the next tile loads while this one is computed
      stage_rows<T, KT, DP, LD>(k_tile[st ^ 1], kb, k0 + KT, n, d);
      stage_rows<T, KT, DP, LD>(v_tile[st ^ 1], vb, k0 + KT, n, d);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    // Column tile j (keys k0 + 8j .. + 7) is seen by this warp when 8j < kmax
    // (warp-uniform); a warp with kmax <= 0 skips the tile.
    const int kmax = warp_last - k0;
    float s[JT][4];
    if (kmax > 0) {
      // S = Q.K^T: s[j][c] is (ra, key k0 + 8j + 2t + c), s[j][2 + c] is (rb,
      // the same key), each an fp32 FMA chain over d in order, as the plain
      // version's product rounds it.  (Scores on the tensor cores, even exact
      // ones, leave o further from the plain version than FA_TOL once the
      // scores reach a few hundred: tests/test_torch_flash_attention.py.)
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        if (j * 8 >= kmax) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float* kr = &k_tile[st][j * 8 + 2 * t + c][0];
          float sa = 0.f, sb = 0.f;
#pragma unroll
          for (int dd = 0; dd < DP; dd += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(kr + dd);
            sa = fmaf(qa[dd + 0], kk.x, sa);
            sa = fmaf(qa[dd + 1], kk.y, sa);
            sa = fmaf(qa[dd + 2], kk.z, sa);
            sa = fmaf(qa[dd + 3], kk.w, sa);
            sb = fmaf(qb[dd + 0], kk.x, sb);
            sb = fmaf(qb[dd + 1], kk.y, sb);
            sb = fmaf(qb[dd + 2], kk.z, sb);
            sb = fmaf(qb[dd + 3], kk.w, sb);
          }
          s[j][c] = sa;
          s[j][2 + c] = sb;
        }
      }

      // Online softmax on the fragments; a row's maximum is reduced over the
      // four lanes of its quad.
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        if (j * 8 >= kmax) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + j * 8 + 2 * t + c;
          s[j][c] = key < ra ? s[j][c] * scale : NEG;
          s[j][2 + c] = key < rb ? s[j][2 + c] * scale : NEG;
          mx_a = fmaxf(mx_a, s[j][c]);
          mx_b = fmaxf(mx_b, s[j][2 + c]);
        }
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
      const float alpha_a = __expf(m_a - mx_a);
      const float alpha_b = __expf(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      l_a *= alpha_a;
      l_b *= alpha_b;
      // p = exp(s - m) * mask: a row that has seen nothing yet has m == NEG and
      // exp(NEG - NEG) == 1, so the mask is a factor, not only a fill
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        if (j * 8 >= kmax) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + j * 8 + 2 * t + c;
          const float pa = key < ra ? __expf(s[j][c] - mx_a) : 0.f;
          const float pb = key < rb ? __expf(s[j][2 + c] - mx_b) : 0.f;
          l_a += pa;   // the normaliser takes the undropped p
          l_b += pb;
          s[j][c] = pa;
          s[j][2 + c] = pb;
        }
      }
      if (DROP) {
        // Keys 8j + 2t, 8j + 2t + 1 are words 2(t & 1), 2(t & 1) + 1 of the
        // Philox quad k0 / 4 + 2j + t / 2.  Of the two lanes that share a quad,
        // the even one draws it for row ra and the odd one for row rb; each
        // sends the other the two words it holds for the other's keys.
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          if (j * 8 >= kmax) continue;
          const bool odd = t & 1;
          const uint4 bits = dropout_bits4(seed, bh, odd ? rb : ra, (k0 + j * 8) / 4 + (t >> 1));
          const unsigned int r0 = __shfl_xor_sync(FULL, odd ? bits.x : bits.z, 1);
          const unsigned int r1 = __shfl_xor_sync(FULL, odd ? bits.y : bits.w, 1);
          const unsigned int wa0 = odd ? r0 : bits.x, wa1 = odd ? r1 : bits.y;   // row ra
          const unsigned int wb0 = odd ? bits.z : r0, wb1 = odd ? bits.w : r1;   // row rb
          s[j][0] = wa0 >= threshold ? s[j][0] * inv_keep : 0.f;
          s[j][1] = wa1 >= threshold ? s[j][1] * inv_keep : 0.f;
          s[j][2] = wb0 >= threshold ? s[j][2] * inv_keep : 0.f;
          s[j][3] = wb1 >= threshold ? s[j][3] * inv_keep : 0.f;
        }
      }

      // O += P.V in three TF32 passes.  The score fragment of column tile j
      // is used as the A fragment of k-step j with its keys reordered: k = t is
      // key 8j + 2t, k = t + 4 is key 8j + 2t + 1, and V's B fragment is read
      // from those two rows.  The same permutation of P's columns and V's rows
      // leaves the product as it is, and P never leaves the registers.  The
      // tile's products go into a fresh accumulator, added to the running one
      // (rescaled) by a rounded fp32 FMA: the tensor cores' own fp32 sums
      // round toward zero, and over a thousand keys that drift shows.
      float part[DS][4];
#pragma unroll
      for (int ds = 0; ds < DS; ++ds) part[ds][0] = part[ds][1] = part[ds][2] = part[ds][3] = 0.f;
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        if (j * 8 >= kmax) continue;
        unsigned int ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
#pragma unroll
        for (int ds = 0; ds < DS; ++ds) {
          const int r = j * 8 + 2 * t;
          const int c = ds * 8 + g;
          unsigned int vh[2], vl[2];
          split_tf32(v_tile[st][r][c], vh[0], vl[0]);
          split_tf32(v_tile[st][r + 1][c], vh[1], vl[1]);
          mma_3xtf32<false, EXACT>(part[ds], ph, pl, vh, vl);
        }
      }
#pragma unroll
      for (int ds = 0; ds < DS; ++ds) {
        acc[ds][0] = fmaf(acc[ds][0], alpha_a, part[ds][0]);
        acc[ds][1] = fmaf(acc[ds][1], alpha_a, part[ds][1]);
        acc[ds][2] = fmaf(acc[ds][2], alpha_b, part[ds][2]);
        acc[ds][3] = fmaf(acc[ds][3], alpha_b, part[ds][3]);
      }
    }
    __syncthreads();   // this tile is consumed before the next stage overwrites it
  }

  l_a += __shfl_xor_sync(FULL, l_a, 1);
  l_a += __shfl_xor_sync(FULL, l_a, 2);
  l_b += __shfl_xor_sync(FULL, l_b, 1);
  l_b += __shfl_xor_sync(FULL, l_b, 2);
  const float den_a = fmaxf(l_a, TINY);
  const float den_b = fmaxf(l_b, TINY);
  if (ra < n) {
    if (t == 0) lse[bh * n + ra] = m_a + logf(den_a);
#pragma unroll
    for (int ds = 0; ds < DS; ++ds) {
      const int col = ds * 8 + 2 * t;
      if (col < d) {
        store2(o + base + static_cast<long long>(ra) * d + col, acc[ds][0] / den_a,
               acc[ds][1] / den_a);
      }
    }
  }
  if (rb < n) {
    if (t == 0) lse[bh * n + rb] = m_b + logf(den_b);
#pragma unroll
    for (int ds = 0; ds < DS; ++ds) {
      const int col = ds * 8 + 2 * t;
      if (col < d) {
        store2(o + base + static_cast<long long>(rb) * d + col, acc[ds][2] / den_b,
               acc[ds][3] / den_b);
      }
    }
  }
}

__global__ void keep_mask_kernel(unsigned char* __restrict__ keep, long long bh_count, int n,
                                 unsigned int threshold, unsigned long long seed) {
  const int quads = (n + 3) / 4;
  const long long total = bh_count * n * quads;
  const long long f = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (f >= total) return;
  const int quad = static_cast<int>(f % quads);
  const int i = static_cast<int>((f / quads) % n);
  const long long bh = f / quads / n;
  const uint4 bits = dropout_bits4(seed, bh, i, quad);
  const unsigned int word[4] = {bits.x, bits.y, bits.z, bits.w};
  unsigned char* row = keep + (bh * n + i) * n;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = quad * 4 + c;
    if (j < n) row[j] = word[c] >= threshold ? 1 : 0;
  }
}

// The grid of a narrow kernel: heads x row tiles of TC_ROWS, along x.
inline bool grid_of(long long bh, int n, dim3& grid) {
  const long long blocks = bh * ((n + TC_ROWS - 1) / TC_ROWS);
  if (blocks > 2147483647LL) return false;
  grid = dim3(static_cast<unsigned int>(blocks));
  return true;
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, long long bh, int n,
           int d, float scale, unsigned int threshold, float inv_keep, unsigned long long seed,
           cudaStream_t stream) {
  const int nq = (n + TC_ROWS - 1) / TC_ROWS;
  dim3 grid;
  if (!grid_of(bh, n, grid)) return static_cast<int>(cudaErrorInvalidValue);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (threshold > 0) {
    flash_fwd_kernel<T, DP, true><<<grid, TC_THREADS, 0, stream>>>(
        qp, kp, vp, op, lse, bh, n, d, nq, scale, threshold, inv_keep, seed);
  } else {
    flash_fwd_kernel<T, DP, false><<<grid, TC_THREADS, 0, stream>>>(
        qp, kp, vp, op, lse, bh, n, d, nq, scale, 0u, 1.0f, 0ull);
  }
  return static_cast<int>(cudaGetLastError());
}

// The softmax scale of a head of head_dim features; the rows themselves may be
// zero-padded to d >= head_dim (the wrapper pads D to a multiple of 4).
inline float scale_of(int head_dim) { return 1.0f / sqrtf(static_cast<float>(head_dim)); }

inline bool bad_shape(long long bh, int n, int d, int head_dim) {
  return bh < 1 || n < 1 || d < 4 || d % 4 != 0 || head_dim < 1 || head_dim > d;
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// K5 on the CUDA cores, for the shapes of dq_on_cuda_cores: dq, and dsum for
// the same rows.  One thread owns R query rows (q, do and dq in registers);
// the block walks key tiles up to the diagonal and folds KC keys a step: S and
// dP as fp32 FMA chains over d, then dq += dS.K.  Blocks are ordered by the
// length of their key loop, longest first, across all heads.
template <typename T, int DP, int R, bool DROP>
__global__ void __launch_bounds__(FMA_THREADS)
flash_bwd_dq_fma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dsum_out,
                    T* __restrict__ dq, long long bh_count, int n, int d, int nq, float scale,
                    unsigned int threshold, float inv_keep, unsigned long long seed) {
  constexpr int TQ = FMA_THREADS * R;
  // keys a step: eight at D = 16 without dropout; four under dropout (fewer
  // live scores) and at D = 32 (where bf16 spills with eight and fp32 runs as
  // fast with four)
  constexpr int KC = DROP || DP > 16 ? 4 : 8;
  __shared__ __align__(16) float ks[FMA_KT][DP];
  __shared__ __align__(16) float vs[FMA_KT][DP];

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x % bh_count;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int row0 = qt * TQ + tid * R;
  const long long base = bh * n * d;
  const T* kb = k + base;
  const T* vb = v + base;

  float qr[R][DP], dor[R][DP], acc[R][DP], lr[R], dsr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    float ds = 0.f;
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n && c < d) {
        const long long at = base + static_cast<long long>(i) * d + c;
        a = load4(q + at);
        g = load4(dout + at);
        y = load4(o + at);
      }
      qr[r][c + 0] = a.x;
      qr[r][c + 1] = a.y;
      qr[r][c + 2] = a.z;
      qr[r][c + 3] = a.w;
      dor[r][c + 0] = g.x;
      dor[r][c + 1] = g.y;
      dor[r][c + 2] = g.z;
      dor[r][c + 3] = g.w;
      ds = fmaf(g.x, y.x, ds);
      ds = fmaf(g.y, y.y, ds);
      ds = fmaf(g.z, y.z, ds);
      ds = fmaf(g.w, y.w, ds);
      acc[r][c + 0] = acc[r][c + 1] = acc[r][c + 2] = acc[r][c + 3] = 0.f;
    }
    dsr[r] = ds;
    lr[r] = 0.f;
    if (i < n) {
      lr[r] = lse[bh * n + i];
      dsum_out[bh * n + i] = ds;
    }
  }

  const int key_end = min(n, qt * TQ + TQ) - 1;
  const int warp_row0 = qt * TQ + (tid / 32) * 32 * R;
  const int warp_last = warp_row0 < n ? min(n, warp_row0 + 32 * R) - 1 : 0;

  for (int k0 = 0; k0 < key_end; k0 += FMA_KT) {
    __syncthreads();   // the previous tile has been consumed
    for (int f = tid; f < FMA_KT * (DP / 4); f += FMA_THREADS) {
      const int r = f / (DP / 4);
      const int c = (f % (DP / 4)) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < n && c < d) {
        a = load4(kb + static_cast<long long>(k0 + r) * d + c);
        b = load4(vb + static_cast<long long>(k0 + r) * d + c);
      }
      *reinterpret_cast<float4*>(&ks[r][c]) = a;
      *reinterpret_cast<float4*>(&vs[r][c]) = b;
    }
    __syncthreads();
    if (k0 >= warp_last) continue;   // wholly above this warp's rows (warp-uniform)

    const int kmax = min(FMA_KT, warp_last - k0);
    for (int c0 = 0; c0 < kmax; c0 += KC) {
      float s[R][KC], dp[R][KC];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < KC; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
#pragma unroll
        for (int dd = 0; dd < DP; dd += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[c0 + c][dd]);
          const float4 vv = *reinterpret_cast<const float4*>(&vs[c0 + c][dd]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            s[r][c] = fmaf(qr[r][dd + 0], kk.x, s[r][c]);
            s[r][c] = fmaf(qr[r][dd + 1], kk.y, s[r][c]);
            s[r][c] = fmaf(qr[r][dd + 2], kk.z, s[r][c]);
            s[r][c] = fmaf(qr[r][dd + 3], kk.w, s[r][c]);
            dp[r][c] = fmaf(dor[r][dd + 0], vv.x, dp[r][c]);
            dp[r][c] = fmaf(dor[r][dd + 1], vv.y, dp[r][c]);
            dp[r][c] = fmaf(dor[r][dd + 2], vv.z, dp[r][c]);
            dp[r][c] = fmaf(dor[r][dd + 3], vv.w, dp[r][c]);
          }
        }
      }

      const int j0 = k0 + c0;   // a multiple of KC
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = row0 + r;
        if (DROP) {
#pragma unroll
          for (int c = 0; c < KC; c += 4) {
            const uint4 bits = dropout_bits4(seed, bh, i, (j0 + c) >> 2);
            dp[r][c + 0] = (bits.x >= threshold) ? dp[r][c + 0] * inv_keep : 0.f;
            dp[r][c + 1] = (bits.y >= threshold) ? dp[r][c + 1] * inv_keep : 0.f;
            dp[r][c + 2] = (bits.z >= threshold) ? dp[r][c + 2] * inv_keep : 0.f;
            dp[r][c + 3] = (bits.w >= threshold) ? dp[r][c + 3] * inv_keep : 0.f;
          }
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const bool seen = j0 + c < i && i < n;
          const float p = seen ? __expf(s[r][c] * scale - lr[r]) : 0.f;
          s[r][c] = p * (dp[r][c] - dsr[r]) * scale;
        }
      }

#pragma unroll
      for (int c = 0; c < KC; ++c) {
#pragma unroll
        for (int dd = 0; dd < DP; dd += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[c0 + c][dd]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][dd + 0] = fmaf(s[r][c], kk.x, acc[r][dd + 0]);
            acc[r][dd + 1] = fmaf(s[r][c], kk.y, acc[r][dd + 1]);
            acc[r][dd + 2] = fmaf(s[r][c], kk.z, acc[r][dd + 2]);
            acc[r][dd + 3] = fmaf(s[r][c], kk.w, acc[r][dd + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      if (c < d) {
        store4(dq + base + static_cast<long long>(i) * d + c,
               make_float4(acc[r][c + 0], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]));
      }
    }
  }
}

// K5: dq, and dsum for the same rows, on K4's layout.  One block of four
// warps owns 64 query rows, 16 a warp (the M of its mma tiles), each thread two
// rows (ra, rb = g and g + 8 of its warp's), with dq in registers; it walks
// KT-key tiles of K and V, staged two deep by cp.async, up to the diagonal.
// Blocks are ordered by the length of their key loop, longest first, across
// all heads.  For each tile:
//   S = Q.K^T      fp32 FMA chains over d in order (K4's rounding, so that
//                  p = exp(s * scale - lse) stays at most 1 however large the
//                  scores grow), in the mma accumulator layout;
//   dP = dO.V^T    three-pass TF32 mma, dO as the A operand, V's B fragment
//                  read from rows 8j + g; the same accumulator layout as S;
//   dS = p * (dP * m - dsum) * scale       in registers (m: the dropout factor,
//                  its bits drawn once a (query, key quad) as in K4);
//   dq += dS.K     three-pass TF32 mma, dS straight from the registers as the
//                  A operand with the keys reordered as K4's P.V does (k = t is
//                  key 8j + 2t, k = t + 4 key 8j + 2t + 1; K's B fragment read
//                  from those two rows), into a fresh accumulator that is added
//                  to the running dq by a rounded fp32 add (the tensor cores'
//                  sums truncate).
// dsum = <do, o> of each row is an FMA chain over d in order (what K6 reads).
// It runs from 32 features up to 64 (dq_on_cuda_cores), where q and the split
// dO fragments would not fit in registers beside S and dP: each use reads them
// through L1 (a warp's rows of q and do are at most 8 KB).  Wider heads take
// flash_bwd_dq_wide_kernel.
template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dsum_out,
                    T* __restrict__ dq, long long bh_count, int n, int d, int nq, float scale,
                    unsigned int threshold, float inv_keep, unsigned long long seed) {
  constexpr int KT = kTcTile<DP>;
  constexpr int LD = kTcLd<DP>;
  constexpr int DS = DP / 8;     // k-steps of dP; 8-wide column tiles of dq
  constexpr int JT = KT / 8;     // 8-key column tiles of S and dP; k-steps of dq
  // ... of a sub-tile (fewer registers, and shorter chains of mma into one
  // accumulator)
  constexpr int JS = JT >= 4 ? 4 : JT;
  constexpr bool EXACT = ExactInTf32<T>::value;
  __shared__ __align__(16) float k_tile[2][KT][LD];
  __shared__ __align__(16) float v_tile[2][KT][LD];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long bh = blockIdx.x % bh_count;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int row0 = qt * TC_ROWS + warp * 16;
  const int ra = row0 + g;
  const int rb = ra + 8;
  const long long base = bh * n * d;
  const T* kb = k + base;
  const T* vb = v + base;
  const T* qbase = q + base;
  const T* gbase = dout + base;

  // dsum of rows ra and rb, each lane of the quad alike; lse of both rows
  float dsum_a = 0.f, dsum_b = 0.f, lse_a = 0.f, lse_b = 0.f;
  if (ra < n) {
    const long long at = base + static_cast<long long>(ra) * d;
    for (int c = 0; c < d; ++c) dsum_a = fmaf(to_float(dout[at + c]), to_float(o[at + c]), dsum_a);
    lse_a = lse[bh * n + ra];
  }
  if (rb < n) {
    const long long at = base + static_cast<long long>(rb) * d;
    for (int c = 0; c < d; ++c) dsum_b = fmaf(to_float(dout[at + c]), to_float(o[at + c]), dsum_b);
    lse_b = lse[bh * n + rb];
  }
  if (t == 0) {
    if (ra < n) dsum_out[bh * n + ra] = dsum_a;
    if (rb < n) dsum_out[bh * n + rb] = dsum_b;
  }

  // dO's A fragment of k-step s: (ra, 8s + t), (rb, 8s + t), (ra, 8s + t + 4),
  // (rb, 8s + t + 4)
  auto do_fragment = [&](int s, unsigned int (&h)[4], unsigned int (&l)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r & 1) ? rb : ra;
      const int col = s * 8 + t + (r >> 1) * 4;
      const float x = (row < n && col < d) ? to_float(gbase[static_cast<long long>(row) * d + col]) : 0.f;
      split_tf32(x, h[r], l[r]);
    }
  };
  float acc[DS][4];   // dq: rows ra (0, 1) and rb (2, 3), columns 8s + 2t and 8s + 2t + 1
#pragma unroll
  for (int s = 0; s < DS; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;

  const int key_end = min(n, qt * TC_ROWS + TC_ROWS) - 1;
  const int warp_last = row0 < n ? min(n, row0 + 16) - 1 : 0;
  const int tiles = (key_end + KT - 1) / KT;

  // S and dP of the JS column tiles from j0 of a staged tile of K and V; kmax
  // as in the tile loop
  auto scores_and_dp = [&](float (&s)[JS][4], float (&dp)[JS][4], const float (*kt)[LD],
                           const float (*vt)[LD], int j0, int kmax) {
    // q's rows read through L1 four features at a time (held whole they
    // would not fit beside S and dP); the same chains as score_chains
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      if ((j0 + j) * 8 >= kmax) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float* row = &kt[(j0 + j) * 8 + 2 * t + c][0];
        float sa = s[j][c], sb = s[j][2 + c];
#pragma unroll 1
        for (int dd = 0; dd < DP; dd += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(row + dd);
          const bool in = dd < d;
          const float4 xa = (ra < n && in) ? load4(qbase + static_cast<long long>(ra) * d + dd) : zero;
          const float4 xb = (rb < n && in) ? load4(qbase + static_cast<long long>(rb) * d + dd) : zero;
          sa = fmaf(xa.x, kk.x, sa);
          sa = fmaf(xa.y, kk.y, sa);
          sa = fmaf(xa.z, kk.z, sa);
          sa = fmaf(xa.w, kk.w, sa);
          sb = fmaf(xb.x, kk.x, sb);
          sb = fmaf(xb.y, kk.y, sb);
          sb = fmaf(xb.z, kk.z, sb);
          sb = fmaf(xb.w, kk.w, sb);
        }
        s[j][c] = sa;
        s[j][2 + c] = sb;
      }
    }
#pragma unroll
    for (int ds = 0; ds < DS; ++ds) {
      unsigned int ah[4], al[4];
      do_fragment(ds, ah, al);
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        if ((j0 + j) * 8 >= kmax) continue;
        unsigned int bh_[2], bl_[2];
        split_tf32(vt[(j0 + j) * 8 + g][ds * 8 + t], bh_[0], bl_[0]);
        split_tf32(vt[(j0 + j) * 8 + g][ds * 8 + t + 4], bh_[1], bl_[1]);
        mma_3xtf32<EXACT, EXACT>(dp[j], ah, al, bh_, bl_);
      }
    }
  };

  if (tiles > 0) {
    stage_rows<T, KT, DP, LD>(k_tile[0], kb, 0, n, d);
    stage_rows<T, KT, DP, LD>(v_tile[0], vb, 0, n, d);
  }
  cp_async_commit();
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * KT;
    const int st = it & 1;
    if (it + 1 < tiles) {   // the next tile loads while this one is computed
      stage_rows<T, KT, DP, LD>(k_tile[st ^ 1], kb, k0 + KT, n, d);
      stage_rows<T, KT, DP, LD>(v_tile[st ^ 1], vb, k0 + KT, n, d);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const int kmax = warp_last - k0;   // column tile j is seen when 8j < kmax (warp-uniform)
    for (int j0 = 0; j0 < JT; j0 += JS) {
      if (j0 * 8 >= kmax) break;   // no seen key from here on (warp-uniform)
      float s[JS][4], dp[JS][4];
#pragma unroll
      for (int j = 0; j < JS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
      scores_and_dp(s, dp, k_tile[st], v_tile[st], j0, kmax);

      // dS = p * (dP * m - dsum) * scale, into s; element c of column tile
      // j0 + j is (row ra for c < 2 else rb, key k0 + 8(j0 + j) + 2t + (c & 1))
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const int key0 = k0 + (j0 + j) * 8;
        if (key0 - k0 >= kmax) continue;
        unsigned int keep = 0xFu;
        if (DROP) keep = keep_bits_rows(seed, bh, ra, rb, key0, t, threshold);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = c < 2 ? ra : rb;
          const int key = key0 + 2 * t + (c & 1);
          const bool seen = key < row && row < n;
          const float p = seen ? __expf(s[j][c] * scale - (c < 2 ? lse_a : lse_b)) : 0.f;
          float m = 1.f;
          if (DROP) m = ((keep >> c) & 1u) ? inv_keep : 0.f;
          s[j][c] = p * (dp[j][c] * m - (c < 2 ? dsum_a : dsum_b)) * scale;
        }
      }
      // dq += dS.K in three TF32 passes.  The sub-tile's even and odd column
      // tiles go into two fresh accumulators (two independent chains of mma),
      // each added to the running dq by a rounded fp32 add.
      float part[2][DS][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ds = 0; ds < DS; ++ds)
          part[h][ds][0] = part[h][ds][1] = part[h][ds][2] = part[h][ds][3] = 0.f;
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        if ((j0 + j) * 8 >= kmax) continue;
        unsigned int ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
#pragma unroll
        for (int ds = 0; ds < DS; ++ds) {
          const int r = (j0 + j) * 8 + 2 * t;
          const int c = ds * 8 + g;
          unsigned int kh[2], kl[2];
          split_tf32(k_tile[st][r][c], kh[0], kl[0]);
          split_tf32(k_tile[st][r + 1][c], kh[1], kl[1]);
          mma_3xtf32<false, EXACT>(part[j & 1][ds], ph, pl, kh, kl);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ds = 0; ds < DS; ++ds)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ds][e] += part[h][ds][e];
    }
    __syncthreads();   // this tile is consumed before the next stage overwrites it
  }

#pragma unroll
  for (int ds = 0; ds < DS; ++ds) {
    const int col = ds * 8 + 2 * t;
    if (col >= d) continue;
    if (ra < n) store2(dq + base + static_cast<long long>(ra) * d + col, acc[ds][0], acc[ds][1]);
    if (rb < n) store2(dq + base + static_cast<long long>(rb) * d + col, acc[ds][2], acc[ds][3]);
  }
}

// K6: dk and dv.  One block of four warps owns 64 keys, 16 a warp (the rows
// of its mma tiles), each thread two keys, with the dk, dv accumulators (and
// at D = 16 k and v) in registers; it walks QT-query tiles from the diagonal to N
// with q, do, lse and dsum staged two deep by cp.async.  A tile is computed in
// sub-tiles of JS 8-query columns (fewer registers: at D = 64 one column).
// Blocks are ordered by the length of their query loop, longest (the first key
// tile) first, across all heads.  Wider heads take flash_bwd_dkv_wide_kernel.
template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
                     long long bh_count, int n, int d, float scale, unsigned int threshold,
                     float inv_keep, unsigned long long seed) {
  constexpr int QT = kTcTile<DP>;
  constexpr int LD = kTcLd<DP>;
  constexpr int DS = DP / 8;           // k-steps of S^T and dP^T; column tiles of dK, dV
  constexpr int JT = QT / 8;           // 8-query column tiles of a query tile
  constexpr int JS = DP >= 64 ? 1 : 4;  // ... of a sub-tile
  constexpr bool EXACT = ExactInTf32<T>::value;
  __shared__ __align__(16) float q_tile[2][QT][LD];
  __shared__ __align__(16) float g_tile[2][QT][LD];   // do
  __shared__ __align__(16) float l_tile[2][QT];
  __shared__ __align__(16) float sum_tile[2][QT];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long bh = blockIdx.x % bh_count;
  const int kt = static_cast<int>(blockIdx.x / bh_count);
  const int key0 = kt * TC_ROWS + warp * 16;   // first key of this warp, a multiple of 16
  const int ka = key0 + g;                     // this thread's two keys
  const int kb = ka + 8;
  const long long base = bh * n * d;
  const T* qb = q + base;
  const T* gb = dout + base;

  // The keys' rows, for the scores' FMA chains, and V as A fragments, kept as
  // fp32 and split at each use (element r of k-step s is key ka or kb, column
  // 8s + t or 8s + t + 4).  At D = 16 they stay in registers; at larger D they
  // would not fit beside the accumulators, and each use reads them again (from
  // L1: the warp's keys and values are at most 8 KB).
  constexpr bool KV_IN_REGS = DP <= 16;
  const T* ka_row = k + base + static_cast<long long>(ka) * d;
  const T* kb_row = k + base + static_cast<long long>(kb) * d;
  auto v_at = [&](int s, int r, long long& at) {
    const int row = (r & 1) ? kb : ka;
    const int col = s * 8 + t + (r >> 1) * 4;
    at = base + static_cast<long long>(row) * d + col;
    return row < n && col < d;
  };
  float kra[KV_IN_REGS ? DP : 1], krb[KV_IN_REGS ? DP : 1], vf[KV_IN_REGS ? DS : 1][4];
  if (KV_IN_REGS) {
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      kra[c] = (ka < n && c < d) ? to_float(ka_row[c]) : 0.f;
      krb[c] = (kb < n && c < d) ? to_float(kb_row[c]) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < DS; ++s) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        long long at;
        const bool in = v_at(s, r, at);
        vf[s][r] = in ? to_float(v[at]) : 0.f;
      }
    }
  }
  float dka[DS][4], dva[DS][4];   // rows ka (0, 1) and kb (2, 3), columns 8s + 2t, 8s + 2t + 1
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    dka[s][0] = dka[s][1] = dka[s][2] = dka[s][3] = 0.f;
    dva[s][0] = dva[s][1] = dva[s][2] = dva[s][3] = 0.f;
  }

  const int q_first = kt * TC_ROWS;   // no query before the block's first key sees it
  const int tiles = (n - q_first + QT - 1) / QT;
  auto stage = [&](int buf, int q0) {
    stage_rows<T, QT, DP, LD>(q_tile[buf], qb, q0, n, d);
    stage_rows<T, QT, DP, LD>(g_tile[buf], gb, q0, n, d);
    for (int r = threadIdx.x; r < 2 * QT; r += TC_THREADS) {
      const int i = r % QT;
      const bool in = q0 + i < n;
      const long long at = in ? bh * n + q0 + i : 0;
      if (r < QT) {
        cp_async4(&l_tile[buf][i], lse + at, in);
      } else {
        cp_async4(&sum_tile[buf][i], dsum + at, in);
      }
    }
  };

  stage(0, q_first);
  cp_async_commit();
  for (int it = 0; it < tiles; ++it) {
    const int q0 = q_first + it * QT;
    const int st = it & 1;
    if (it + 1 < tiles) stage(st ^ 1, q0 + QT);   // the next tile loads while this one is computed
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    // Column tile j (queries q0 + 8j .. + 7) holds a query that sees a key of
    // this warp when q0 + 8j + 7 > key0 (warp-uniform).
    for (int j0 = 0; j0 < JT; j0 += JS) {
      if (key0 >= n || q0 + j0 * 8 + JS * 8 - 1 <= key0) continue;
      float s[JS][4], dp[JS][4];
#pragma unroll
      for (int j = 0; j < JS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
      // S^T = K.Q^T: s[j][2h + c] is (key ka or kb for h = 0, 1, query
      // q0 + 8(j0 + j) + 2t + c), an fp32 FMA chain over d in order, so that it
      // rounds as the forward's score of the same pair does.  p = exp(s - lse)
      // then stays at most 1 whatever the scores' size: from scores rounded
      // otherwise (the tensor cores'), p overflows once the scores reach
      // 1e10, as a few steps of training bring them to.
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const int r0 = (j0 + j) * 8;
        if (q0 + r0 + 7 <= key0) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float* qr = &q_tile[st][r0 + 2 * t + c][0];
          float sa = 0.f, sb = 0.f;
          auto chain = [&](const float4& qq, const float4& xa, const float4& xb) {
            sa = fmaf(qq.x, xa.x, sa);
            sa = fmaf(qq.y, xa.y, sa);
            sa = fmaf(qq.z, xa.z, sa);
            sa = fmaf(qq.w, xa.w, sa);
            sb = fmaf(qq.x, xb.x, sb);
            sb = fmaf(qq.y, xb.y, sb);
            sb = fmaf(qq.z, xb.z, sb);
            sb = fmaf(qq.w, xb.w, sb);
          };
          if (KV_IN_REGS) {
#pragma unroll
            for (int dd = 0; dd < DP; dd += 4) {
              chain(*reinterpret_cast<const float4*>(qr + dd),
                    make_float4(kra[dd], kra[dd + 1], kra[dd + 2], kra[dd + 3]),
                    make_float4(krb[dd], krb[dd + 1], krb[dd + 2], krb[dd + 3]));
            }
          } else {
            const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
            // one step at a time: hoisted, the loads would not fit the registers
#pragma unroll 1
            for (int dd = 0; dd < DP; dd += 4) {
              chain(*reinterpret_cast<const float4*>(qr + dd),
                    (ka < n && dd < d) ? load4(ka_row + dd) : zero,
                    (kb < n && dd < d) ? load4(kb_row + dd) : zero);
            }
          }
          s[j][c] = sa;
          s[j][2 + c] = sb;
        }
      }
      // dP^T = V.dO^T in three TF32 passes
#pragma unroll
      for (int ds = 0; ds < DS; ++ds) {
        unsigned int vh[4], vl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float vx;
          if (KV_IN_REGS) {
            vx = vf[ds][r];
          } else {
            long long at;
            const bool in = v_at(ds, r, at);
            vx = in ? to_float(v[at]) : 0.f;
          }
          split_tf32(vx, vh[r], vl[r]);
        }
#pragma unroll
        for (int j = 0; j < JS; ++j) {
          const int row = (j0 + j) * 8 + g;
          if (q0 + row - g + 7 <= key0) continue;
          const int c = ds * 8 + t;
          unsigned int bh_[2], bl_[2];
          split_tf32(g_tile[st][row][c], bh_[0], bl_[0]);
          split_tf32(g_tile[st][row][c + 4], bh_[1], bl_[1]);
          mma_3xtf32<EXACT, EXACT>(dp[j], vh, vl, bh_, bl_);
        }
      }

      // Element c of column tile j is (key ka for c < 2 else kb, query
      // q0 + 8(j0 + j) + 2t + (c & 1)).
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const int col = (j0 + j) * 8 + 2 * t;   // within the tile
        if (q0 + col - 2 * t + 7 <= key0) continue;
        const int i0 = q0 + col;
        const float2 lq = *reinterpret_cast<const float2*>(&l_tile[st][col]);
        const float2 sq = *reinterpret_cast<const float2*>(&sum_tile[st][col]);
        unsigned int keep = 0xFu;   // bit c: element c is kept
        if (DROP) keep = keep_bits_keys(seed, bh, key0, i0, g, t, threshold);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = c < 2 ? ka : kb;
          const int i = i0 + (c & 1);
          const bool seen = key < i && i < n;
          const float p = seen ? __expf(s[j][c] * scale - ((c & 1) ? lq.y : lq.x)) : 0.f;
          float m = 1.f;
          if (DROP) m = ((keep >> c) & 1u) ? inv_keep : 0.f;
          s[j][c] = p * m;                                                          // into dv
          dp[j][c] = p * (dp[j][c] * m - ((c & 1) ? sq.y : sq.x)) * scale;        // into dk
        }
      }

      // dV += (P^T m).dO and dK += dS^T.Q in three TF32 passes: the score
      // fragments of column j are the A fragments of k-step j with the queries
      // reordered (k = t is query 8j + 2t, k = t + 4 is 8j + 2t + 1), and the B
      // fragments of dO and Q are read from those two rows.  The sub-tile's
      // products go into fresh accumulators, added to the running ones by
      // rounded fp32 adds (the tensor cores' fp32 sums round toward zero).
      float pv[DS][4], pk[DS][4];
#pragma unroll
      for (int ds = 0; ds < DS; ++ds) {
        pv[ds][0] = pv[ds][1] = pv[ds][2] = pv[ds][3] = 0.f;
        pk[ds][0] = pk[ds][1] = pk[ds][2] = pk[ds][3] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const int row = (j0 + j) * 8 + 2 * t;
        if (q0 + row - 2 * t + 7 <= key0) continue;
        unsigned int ph[4], pl[4], dh[4], dl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        split_tf32(dp[j][0], dh[0], dl[0]);
        split_tf32(dp[j][2], dh[1], dl[1]);
        split_tf32(dp[j][1], dh[2], dl[2]);
        split_tf32(dp[j][3], dh[3], dl[3]);
#pragma unroll
        for (int ds = 0; ds < DS; ++ds) {
          const int c = ds * 8 + g;
          unsigned int bh_[2], bl_[2];
          split_tf32(g_tile[st][row][c], bh_[0], bl_[0]);
          split_tf32(g_tile[st][row + 1][c], bh_[1], bl_[1]);
          mma_3xtf32<false, EXACT>(pv[ds], ph, pl, bh_, bl_);
          split_tf32(q_tile[st][row][c], bh_[0], bl_[0]);
          split_tf32(q_tile[st][row + 1][c], bh_[1], bl_[1]);
          mma_3xtf32<false, EXACT>(pk[ds], dh, dl, bh_, bl_);
        }
      }
#pragma unroll
      for (int ds = 0; ds < DS; ++ds) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dva[ds][e] += pv[ds][e];
          dka[ds][e] += pk[ds][e];
        }
      }
    }
    __syncthreads();   // this tile is consumed before the next stage overwrites it
  }

#pragma unroll
  for (int ds = 0; ds < DS; ++ds) {
    const int col = ds * 8 + 2 * t;
    if (col >= d) continue;
    if (ka < n) {
      const long long at = base + static_cast<long long>(ka) * d + col;
      store2(dk + at, dka[ds][0], dka[ds][1]);
      store2(dv + at, dva[ds][0], dva[ds][1]);
    }
    if (kb < n) {
      const long long at = base + static_cast<long long>(kb) * d + col;
      store2(dk + at, dka[ds][2], dka[ds][3]);
      store2(dv + at, dva[ds][2], dva[ds][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4, K5 and K6 for heads wider than 64 features
// ---------------------------------------------------------------------------
//
// The head is one tile of CW = 128 features wide up to 128 (zero-padded past
// d; whole 16-feature steps of the score chains and 8-feature k-steps of the
// products that lie past d are skipped), and above that is cut into CW-wide
// chunks: the scores continue their FMA chains over the chunks in order, dP
// takes each chunk into a fresh accumulator added by a rounded fp32 add, and
// a block owns one CW-wide group of its output's columns (blockIdx.y; one
// group up to 128 features).  Each block computes S (and dP) once for all the
// columns it writes.  The three kernels have eight warps and 1 block an SM,
// with dynamic shared memory set once a variant above the 48 KB of static
// shared memory:
//   K4 (202,752 bytes): the block's 128 query rows of q, staged once (67.6
//     KB), and a ring of two stages of 64 keys of K and V (67.6 KB a stage),
//     loaded by cp.async while the previous stage is computed.  Each warp
//     owns 16 rows as the narrow kernel does, with o (64 fp32 a thread) in
//     registers; the scores' FMA chains read q and K from shared memory, and
//     P.V takes P from the registers as the narrow kernel does.  On the card
//     64-key stages ran faster than 32 or 48 (fewer waits a key, more chains
//     in flight), and a third 32-key stage or four warps at two blocks an SM
//     did not (PERF.md).
//   K5 (203,264 bytes): the block's 128 query rows of q and do, staged once
//     (two 67.6 KB tiles), and a ring of two stages of 32 keys of K and V
//     (33.8 KB a stage).  Each warp owns 16 rows as the narrow kernel does,
//     with dq (64 fp32 a thread) in registers.
//   K6 (224,256 bytes): the block's 64 keys of k and v, staged once, a ring
//     of two stages of 64 queries of Q, dO, lse and dsum (68.1 KB a stage),
//     and a 20 KB tile through which the two warpgroups pass P^T.  Warpgroup
//     0 computes S^T (the FMA chains), P^T and the keep bits of its 64 keys
//     and accumulates dV (64 fp32 a thread); warpgroup 1 computes dP^T,
//     takes P^T and the keep bits through shared memory (a named barrier),
//     forms dS^T and accumulates dK.  So S^T and dP^T are computed once, and
//     neither warp holds more than one 64 x 128 accumulator.
// Above one chunk (D > 128) the block's own rows are staged again, one chunk
// at a time, as each ring stage of the same chunk comes (the block waits for
// them), and the chunk of the block's column group that the last products
// take is staged into their buffers (K4: into the ring stage of the last
// chunk, beside K's).

constexpr int CW = 128;                 // feature tile of a wide head, and its column groups
constexpr int CW_LD = CW + 4;           // row stride of a staged chunk in floats (kTcLd)
constexpr int WIDE_WARPS = 8;
constexpr int WIDE_THREADS = 32 * WIDE_WARPS;
constexpr int FWDW_ROWS = 16 * WIDE_WARPS;  // query rows of a K4 block
constexpr int FWDW_KT = 64;                 // keys of a stage of its ring
constexpr int DQW_ROWS = 16 * WIDE_WARPS;   // query rows of a K5 block
constexpr int DQW_KT = 32;                  // keys of a stage of its ring
constexpr int DKVW_KEYS = 64;               // keys of a K6 block, 16 a warp of each warpgroup
constexpr int DKVW_QT = 64;                 // queries of a stage of its ring
constexpr int FWDW_SMEM = (FWDW_ROWS + 2 * 2 * FWDW_KT) * CW_LD * static_cast<int>(sizeof(float));
constexpr int DQW_SMEM =
    (2 * DQW_ROWS * CW_LD + 2 * 2 * DQW_KT * CW_LD + DQW_ROWS) * static_cast<int>(sizeof(float));
constexpr int DKVW_SMEM =
    (2 * DKVW_KEYS * CW_LD + 2 * (2 * DKVW_QT * CW_LD + 2 * DKVW_QT) + 4 * (DKVW_QT / 8) * 32 * 5) *
    static_cast<int>(sizeof(float));
static_assert(FWDW_SMEM <= 232448 && DQW_SMEM <= 232448 && DKVW_SMEM <= 232448,
              "a block has at most 227 KB");

// K4 for D > 64: o of one CW-wide column group, and lse (group 0).  Each warp
// owns 16 query rows (ra, rb as in flash_fwd_kernel) and walks the ring's
// 64-key stages up to its diagonal; the block's longest key loop first,
// across all heads.  A stage: S's chains continued over its chunk of K; after
// the last chunk the steps of flash_fwd_kernel's tile loop: the online
// softmax, the dropout draw and O += P.V over the group's columns of V, the
// tile's products into a fresh accumulator added by a rounded fp32 FMA.
template <typename T, bool DROP>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, float* __restrict__ lse, long long bh_count, int n,
                      int d, int nq, float scale, unsigned int threshold, float inv_keep,
                      unsigned long long seed) {
  constexpr int ROWS = FWDW_ROWS;
  constexpr int KT = FWDW_KT;
  constexpr int LD = CW_LD;
  constexpr int JT = KT / 8;     // 8-key column tiles of S; k-steps of O += P.V
  constexpr int DS = CW / 8;     // 8-wide column tiles of O
  constexpr bool EXACT = ExactInTf32<T>::value;
  extern __shared__ __align__(16) float smem[];
  float (*q_rows)[LD] = reinterpret_cast<float (*)[LD]>(smem);
  float (*ring)[LD] = q_rows + ROWS;   // stage s: K's KT rows at ring + 2 KT s, then V's

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long bh = blockIdx.x % bh_count;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int cg = static_cast<int>(blockIdx.y);   // o's column group
  const int col0 = cg * CW;
  const int chunks = (d + CW - 1) / CW;
  const int qrow0 = qt * ROWS;
  const int wrow = warp * 16;          // the warp's first row within the block
  const int row0 = qrow0 + wrow;
  const int ra = row0 + g;
  const int rb = ra + 8;
  const long long base = bh * n * d;
  const T* qbase = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  const int key_end = min(n, qrow0 + ROWS) - 1;
  const int tiles = (key_end + KT - 1) / KT;
  const int items = tiles * chunks;   // ring stages: (key tile, chunk), the chunks innermost
  // K's chunk of the item, and with the last chunk V's columns of the block's group
  auto stage_item = [&](int u) {
    const int it = u / chunks;
    const int fc = u - it * chunks;
    float (*kt)[LD] = ring + 2 * KT * (u & 1);
    stage_rows<T, KT, CW, LD, WIDE_THREADS>(kt, kb, it * KT, n, d, fc * CW);
    if (fc == chunks - 1) stage_rows<T, KT, CW, LD, WIDE_THREADS>(kt + KT, vb, it * KT, n, d, col0);
  };

  if (items > 0) {
    stage_rows<T, ROWS, CW, LD, WIDE_THREADS>(q_rows, qbase, qrow0, n, d);
    stage_item(0);
  }
  cp_async_commit();
  const float* qa_row = &q_rows[wrow + g][0];
  const float* qb_row = &q_rows[wrow + g + 8][0];
  const int warp_last = row0 < n ? min(n, row0 + 16) - 1 : 0;

  float acc[DS][4];   // o: rows ra (0, 1) and rb (2, 3), columns col0 + 8s + 2t, + 1
#pragma unroll
  for (int s = 0; s < DS; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;
  // the running maximum, and this lane's part of the normaliser (its 2 columns
  // of every 8), of rows ra and rb
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
  float s[JT][4];   // S of the key tile: rows ra (0, 1), rb (2, 3), keys 8j + 2t, + 1

  for (int u = 0; u < items; ++u) {
    const int it = u / chunks;
    const int fc = u - it * chunks;
    const int k0 = it * KT;
    const int c0 = fc * CW;
    if (u + 1 < items) stage_item(u + 1);   // the next stage loads while this one is computed
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (chunks > 1 && u > 0) {   // this chunk of the block's rows
      stage_rows<T, ROWS, CW, LD, WIDE_THREADS>(q_rows, qbase, qrow0, n, d, c0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    const float (*kt)[LD] = ring + 2 * KT * (u & 1);
    const float (*vt)[LD] = kt + KT;
    const int kmax = warp_last - k0;   // column tile j is seen when 8j < kmax (warp-uniform)
    const int width = min(CW, d - c0);  // this chunk's features
    if (fc == 0) {
#pragma unroll
      for (int j = 0; j < JT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
    if (kmax > 0) {
      // S = Q.K^T: s[j][c] is (ra, key k0 + 8j + 2t + c), s[j][2 + c] (rb, the
      // same key), each an fp32 FMA chain over d in order, continued over
      // this chunk's features
#pragma unroll 1
      for (int db = 0; db < width; db += 16) {
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          const int dd = db + e;
          const float4 xa = *reinterpret_cast<const float4*>(qa_row + dd);
          const float4 xb = *reinterpret_cast<const float4*>(qb_row + dd);
#pragma unroll
          for (int j = 0; j < JT; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float4 kk = *reinterpret_cast<const float4*>(&kt[j * 8 + 2 * t + c][dd]);
              s[j][c] = fmaf(xa.x, kk.x, s[j][c]);
              s[j][c] = fmaf(xa.y, kk.y, s[j][c]);
              s[j][c] = fmaf(xa.z, kk.z, s[j][c]);
              s[j][c] = fmaf(xa.w, kk.w, s[j][c]);
              s[j][2 + c] = fmaf(xb.x, kk.x, s[j][2 + c]);
              s[j][2 + c] = fmaf(xb.y, kk.y, s[j][2 + c]);
              s[j][2 + c] = fmaf(xb.z, kk.z, s[j][2 + c]);
              s[j][2 + c] = fmaf(xb.w, kk.w, s[j][2 + c]);
            }
          }
        }
      }
    }
    if (fc == chunks - 1 && kmax > 0) {
      // Online softmax on the fragments; a row's maximum is reduced over the
      // four lanes of its quad.  Column tiles wholly above the warp's rows
      // (8j >= kmax) are skipped.
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        if (j * 8 >= kmax) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + j * 8 + 2 * t + c;
          s[j][c] = key < ra ? s[j][c] * scale : NEG;
          s[j][2 + c] = key < rb ? s[j][2 + c] * scale : NEG;
          mx_a = fmaxf(mx_a, s[j][c]);
          mx_b = fmaxf(mx_b, s[j][2 + c]);
        }
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
      const float alpha_a = __expf(m_a - mx_a);
      const float alpha_b = __expf(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      l_a *= alpha_a;
      l_b *= alpha_b;
      // p = exp(s - m) * mask, the mask a factor (as in flash_fwd_kernel)
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        if (j * 8 >= kmax) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = k0 + j * 8 + 2 * t + c;
          const float pa = key < ra ? __expf(s[j][c] - mx_a) : 0.f;
          const float pb = key < rb ? __expf(s[j][2 + c] - mx_b) : 0.f;
          l_a += pa;   // the normaliser takes the undropped p
          l_b += pb;
          s[j][c] = pa;
          s[j][2 + c] = pb;
        }
      }
      if (DROP) {
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          if (j * 8 >= kmax) continue;
          const unsigned int keep = keep_bits_rows(seed, bh, ra, rb, k0 + j * 8, t, threshold);
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] = ((keep >> c) & 1u) ? s[j][c] * inv_keep : 0.f;
        }
      }
      // O += P.V in three TF32 passes, P from the registers with its keys
      // reordered as in flash_fwd_kernel; the group's 8-wide column tiles
      // that lie past d are skipped
      float part[DS][4];
#pragma unroll
      for (int ds = 0; ds < DS; ++ds) part[ds][0] = part[ds][1] = part[ds][2] = part[ds][3] = 0.f;
#pragma unroll
      for (int j = 0; j < JT; ++j) {
        if (j * 8 >= kmax) continue;
        unsigned int ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const int r = j * 8 + 2 * t;
#pragma unroll
        for (int ds = 0; ds < DS; ++ds) {
          if (col0 + ds * 8 >= d) break;
          const int c = ds * 8 + g;
          unsigned int vh[2], vl[2];
          split_tf32(vt[r][c], vh[0], vl[0]);
          split_tf32(vt[r + 1][c], vh[1], vl[1]);
          mma_3xtf32<false, EXACT>(part[ds], ph, pl, vh, vl);
        }
      }
#pragma unroll
      for (int ds = 0; ds < DS; ++ds) {
        acc[ds][0] = fmaf(acc[ds][0], alpha_a, part[ds][0]);
        acc[ds][1] = fmaf(acc[ds][1], alpha_a, part[ds][1]);
        acc[ds][2] = fmaf(acc[ds][2], alpha_b, part[ds][2]);
        acc[ds][3] = fmaf(acc[ds][3], alpha_b, part[ds][3]);
      }
    }
    __syncthreads();   // this stage is consumed before the ring overwrites it
  }

  l_a += __shfl_xor_sync(FULL, l_a, 1);
  l_a += __shfl_xor_sync(FULL, l_a, 2);
  l_b += __shfl_xor_sync(FULL, l_b, 1);
  l_b += __shfl_xor_sync(FULL, l_b, 2);
  const float den_a = fmaxf(l_a, TINY);
  const float den_b = fmaxf(l_b, TINY);
  if (cg == 0 && t == 0) {
    if (ra < n) lse[bh * n + ra] = m_a + logf(den_a);
    if (rb < n) lse[bh * n + rb] = m_b + logf(den_b);
  }
#pragma unroll
  for (int ds = 0; ds < DS; ++ds) {
    const int col = col0 + ds * 8 + 2 * t;
    if (col >= d) continue;
    if (ra < n) {
      store2(o + base + static_cast<long long>(ra) * d + col, acc[ds][0] / den_a,
             acc[ds][1] / den_a);
    }
    if (rb < n) {
      store2(o + base + static_cast<long long>(rb) * d + col, acc[ds][2] / den_b,
             acc[ds][3] / den_b);
    }
  }
}

// Named barrier `id` of `threads` threads: arrive without waiting, or wait.
// Shared-memory writes made before the arrival are seen after the wait.
__device__ __forceinline__ void barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void barrier_wait(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// K5 for D > 64: dq of one CW-wide column group, and dsum.  Each warp owns 16
// query rows (ra, rb as in flash_bwd_dq_kernel) and walks the ring's 32-key
// stages up to its diagonal; the block's longest key loop first, across all
// heads.  A stage: S's chains and dP over its chunk (dP into a fresh
// accumulator), and after the last chunk dS and dq += dS.K into a fresh
// accumulator.  dsum is one FMA chain over d a row, by one thread a row, from
// the staged do.
template <typename T, bool DROP>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ dsum_out, T* __restrict__ dq, long long bh_count,
                         int n, int d, int nq, float scale, unsigned int threshold,
                         float inv_keep, unsigned long long seed) {
  constexpr int ROWS = DQW_ROWS;
  constexpr int KT = DQW_KT;
  constexpr int LD = CW_LD;
  constexpr int JT = KT / 8;     // 8-key column tiles of S and dP; k-steps of dq
  constexpr int DS = CW / 8;     // k-steps of dP; 8-wide column tiles of dq
  constexpr bool EXACT = ExactInTf32<T>::value;
  extern __shared__ __align__(16) float smem[];
  float (*q_rows)[LD] = reinterpret_cast<float (*)[LD]>(smem);   // above one chunk: then K's
  float (*do_rows)[LD] = q_rows + ROWS;
  float (*ring)[LD] = do_rows + ROWS;   // stage s: K's KT rows at ring + 2 KT s, then V's
  float* dsum_rows = smem + (2 * ROWS + 4 * KT) * LD;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long bh = blockIdx.x % bh_count;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int cg = static_cast<int>(blockIdx.y);   // dq's column group
  const int col0 = cg * CW;
  const int chunks = (d + CW - 1) / CW;
  const int qrow0 = qt * ROWS;
  const int wrow = warp * 16;          // the warp's first row within the block
  const int row0 = qrow0 + wrow;
  const int ra = row0 + g;
  const int rb = ra + 8;
  const long long base = bh * n * d;
  const T* kb = k + base;
  const T* vb = v + base;
  const T* qbase = q + base;
  const T* gbase = dout + base;

  const int key_end = min(n, qrow0 + ROWS) - 1;
  const int tiles = (key_end + KT - 1) / KT;
  const int items = tiles * chunks;   // ring stages: (key tile, chunk), the chunks innermost
  auto stage_item = [&](int u) {
    const int it = u / chunks;
    const int c0 = (u - it * chunks) * CW;
    float (*kt)[LD] = ring + 2 * KT * (u & 1);
    stage_rows<T, KT, CW, LD, WIDE_THREADS>(kt, kb, it * KT, n, d, c0);
    stage_rows<T, KT, CW, LD, WIDE_THREADS>(kt + KT, vb, it * KT, n, d, c0);
  };

  stage_rows<T, ROWS, CW, LD, WIDE_THREADS>(q_rows, qbase, qrow0, n, d);
  stage_rows<T, ROWS, CW, LD, WIDE_THREADS>(do_rows, gbase, qrow0, n, d);
  cp_async_commit();
  if (items > 0) stage_item(0);
  cp_async_commit();
  cp_async_wait_one();   // the rows have landed
  __syncthreads();

  if (threadIdx.x < ROWS) {
    const int r = threadIdx.x;
    const int i = qrow0 + r;
    float sum = 0.f;
    if (i < n) {
      const long long at = base + static_cast<long long>(i) * d;
#pragma unroll 4
      for (int c = 0; c < d; c += 4) {
        const float4 x = chunks == 1 ? *reinterpret_cast<const float4*>(&do_rows[r][c])
                                     : load4(dout + at + c);
        const float4 y = load4(o + at + c);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
        sum = fmaf(x.z, y.z, sum);
        sum = fmaf(x.w, y.w, sum);
      }
      if (cg == 0) dsum_out[bh * n + i] = sum;
    }
    dsum_rows[r] = sum;
  }
  __syncthreads();
  const float dsum_a = dsum_rows[wrow + g];
  const float dsum_b = dsum_rows[wrow + g + 8];
  const float lse_a = ra < n ? lse[bh * n + ra] : 0.f;
  const float lse_b = rb < n ? lse[bh * n + rb] : 0.f;
  const float* qa_row = &q_rows[wrow + g][0];
  const float* qb_row = &q_rows[wrow + g + 8][0];
  const int warp_last = row0 < n ? min(n, row0 + 16) - 1 : 0;

  float acc[DS][4];   // dq: rows ra (0, 1) and rb (2, 3), columns col0 + 8s + 2t, + 1
#pragma unroll
  for (int s = 0; s < DS; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;
  float s[JT][4], dp[JT][4];   // S and dP of the key tile: rows ra (0, 1), rb (2, 3), keys 8j + 2t, + 1

  for (int u = 0; u < items; ++u) {
    const int it = u / chunks;
    const int fc = u - it * chunks;
    const int k0 = it * KT;
    const int c0 = fc * CW;
    if (u + 1 < items) stage_item(u + 1);   // the next stage loads while this one is computed
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (chunks > 1 && u > 0) {   // this chunk of the block's rows
      stage_rows<T, ROWS, CW, LD, WIDE_THREADS>(q_rows, qbase, qrow0, n, d, c0);
      stage_rows<T, ROWS, CW, LD, WIDE_THREADS>(do_rows, gbase, qrow0, n, d, c0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    const float (*kt)[LD] = ring + 2 * KT * (u & 1);
    const float (*vt)[LD] = kt + KT;
    const int kmax = warp_last - k0;   // column tile j is seen when 8j < kmax (warp-uniform)
    const int width = min(CW, d - c0);  // this chunk's features
    if (fc == 0) {
#pragma unroll
      for (int j = 0; j < JT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
    }
    if (kmax > 0) {
      // S = Q.K^T: s[j][c] is (ra, key k0 + 8j + 2t + c), s[j][2 + c] (rb, the
      // same key), each chain continued over this chunk's features in order
#pragma unroll 1
      for (int db = 0; db < width; db += 16) {
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          const int dd = db + e;
          const float4 xa = *reinterpret_cast<const float4*>(qa_row + dd);
          const float4 xb = *reinterpret_cast<const float4*>(qb_row + dd);
#pragma unroll
          for (int j = 0; j < JT; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float4 kk = *reinterpret_cast<const float4*>(&kt[j * 8 + 2 * t + c][dd]);
              s[j][c] = fmaf(xa.x, kk.x, s[j][c]);
              s[j][c] = fmaf(xa.y, kk.y, s[j][c]);
              s[j][c] = fmaf(xa.z, kk.z, s[j][c]);
              s[j][c] = fmaf(xa.w, kk.w, s[j][c]);
              s[j][2 + c] = fmaf(xb.x, kk.x, s[j][2 + c]);
              s[j][2 + c] = fmaf(xb.y, kk.y, s[j][2 + c]);
              s[j][2 + c] = fmaf(xb.z, kk.z, s[j][2 + c]);
              s[j][2 + c] = fmaf(xb.w, kk.w, s[j][2 + c]);
            }
          }
        }
      }
      // dP = dO.V^T over this chunk in three TF32 passes, into a fresh
      // accumulator added to dP by a rounded fp32 add
      float dpc[JT][4];
#pragma unroll
      for (int j = 0; j < JT; ++j) dpc[j][0] = dpc[j][1] = dpc[j][2] = dpc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DS; ++ks) {
        if (ks * 8 >= width) break;
        const int c = ks * 8 + t;
        unsigned int ah[4], al[4];
        split_tf32(do_rows[wrow + g][c], ah[0], al[0]);
        split_tf32(do_rows[wrow + g + 8][c], ah[1], al[1]);
        split_tf32(do_rows[wrow + g][c + 4], ah[2], al[2]);
        split_tf32(do_rows[wrow + g + 8][c + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          unsigned int bh_[2], bl_[2];
          split_tf32(vt[j * 8 + g][c], bh_[0], bl_[0]);
          split_tf32(vt[j * 8 + g][c + 4], bh_[1], bl_[1]);
          mma_3xtf32<EXACT, EXACT>(dpc[j], ah, al, bh_, bl_);
        }
      }
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] += dpc[j][e];
    }

    if (fc == chunks - 1) {
      const float (*kd)[LD] = kt;   // K's columns of this block's group
      if (chunks > 1) {
        __syncthreads();   // every warp is done with the rows' chunk
        stage_rows<T, KT, CW, LD, WIDE_THREADS>(q_rows, kb, k0, n, d, col0);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        kd = q_rows;
      }
      if (kmax > 0) {
        // dS = p * (dP * m - dsum) * scale, into s
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          if (j * 8 >= kmax) continue;
          const int key0 = k0 + j * 8;
          unsigned int keep = 0xFu;
          if (DROP) keep = keep_bits_rows(seed, bh, ra, rb, key0, t, threshold);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = c < 2 ? ra : rb;
            const int key = key0 + 2 * t + (c & 1);
            const bool seen = key < row && row < n;
            const float p = seen ? __expf(s[j][c] * scale - (c < 2 ? lse_a : lse_b)) : 0.f;
            float m = 1.f;
            if (DROP) m = ((keep >> c) & 1u) ? inv_keep : 0.f;
            s[j][c] = p * (dp[j][c] * m - (c < 2 ? dsum_a : dsum_b)) * scale;
          }
        }
        // dq += dS.K in three TF32 passes (dS as K4's P, keys reordered), the
        // tile into a fresh accumulator added by a rounded fp32 add
        float part[DS][4];
#pragma unroll
        for (int ds = 0; ds < DS; ++ds) part[ds][0] = part[ds][1] = part[ds][2] = part[ds][3] = 0.f;
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          if (j * 8 >= kmax) continue;
          unsigned int ph[4], pl[4];
          split_tf32(s[j][0], ph[0], pl[0]);
          split_tf32(s[j][2], ph[1], pl[1]);
          split_tf32(s[j][1], ph[2], pl[2]);
          split_tf32(s[j][3], ph[3], pl[3]);
          const int r = j * 8 + 2 * t;
#pragma unroll
          for (int ds = 0; ds < DS; ++ds) {
            if (col0 + ds * 8 >= d) break;
            const int c = ds * 8 + g;
            unsigned int kh[2], kl[2];
            split_tf32(kd[r][c], kh[0], kl[0]);
            split_tf32(kd[r + 1][c], kh[1], kl[1]);
            mma_3xtf32<false, EXACT>(part[ds], ph, pl, kh, kl);
          }
        }
#pragma unroll
        for (int ds = 0; ds < DS; ++ds)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ds][e] += part[ds][e];
      }
    }
    __syncthreads();   // this stage is consumed before the ring overwrites it
  }

#pragma unroll
  for (int ds = 0; ds < DS; ++ds) {
    const int col = col0 + ds * 8 + 2 * t;
    if (col >= d) continue;
    if (ra < n) store2(dq + base + static_cast<long long>(ra) * d + col, acc[ds][0], acc[ds][1]);
    if (rb < n) store2(dq + base + static_cast<long long>(rb) * d + col, acc[ds][2], acc[ds][3]);
  }
}

// K6 for D > 64: dk and dv of one CW-wide column group.  Warp w of warpgroup
// w / 4 owns keys 16 (w % 4) .. + 15 of the block's 64 (ka, kb as in
// flash_bwd_dkv_kernel); the block walks the ring's 64-query stages from its
// first key to N, the longest loop (the first key tile) first, across all
// heads.  A stage: warpgroup 0 continues S^T's chains over its chunk,
// warpgroup 1 takes dP^T over it into a fresh accumulator; after the last
// chunk warpgroup 0 forms P^T and the keep bits, hands them over and
// accumulates dV += (P^T m).dO, and warpgroup 1 forms dS^T and accumulates
// dK += dS^T.Q, each tile into a fresh accumulator added by a rounded fp32 add.
template <typename T, bool DROP>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dsum,
                          T* __restrict__ dk, T* __restrict__ dv, long long bh_count, int n,
                          int d, float scale, unsigned int threshold, float inv_keep,
                          unsigned long long seed) {
  constexpr int KEYS = DKVW_KEYS;
  constexpr int QT = DKVW_QT;
  constexpr int LD = CW_LD;
  constexpr int JT = QT / 8;     // 8-query column tiles of a stage; k-steps of dK, dV
  constexpr int DS = CW / 8;     // k-steps of dP^T; column tiles of dK, dV
  constexpr bool EXACT = ExactInTf32<T>::value;
  extern __shared__ __align__(16) float smem[];
  float (*k_rows)[LD] = reinterpret_cast<float (*)[LD]>(smem);   // above one chunk: then Q's
  float (*v_rows)[LD] = k_rows + KEYS;                             // ... then dO's
  float (*ring)[LD] = v_rows + KEYS;   // stage s: Q's QT rows at ring + 2 QT s, then dO's
  float* lse_ring = smem + (2 * KEYS + 4 * QT) * LD;   // [2][QT]
  float* dsum_ring = lse_ring + 2 * QT;                // [2][QT]
  float4* p_tile = reinterpret_cast<float4*>(dsum_ring + 2 * QT);           // [4][JT][32]
  unsigned int* keep_tile = reinterpret_cast<unsigned int*>(p_tile + 4 * JT * 32);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int role = warp >> 2;   // 0: S^T, P^T and dV; 1: dP^T, dS^T and dK
  const int wk = warp & 3;      // the warp's 16 keys within the block
  const long long bh = blockIdx.x % bh_count;
  const int kt = static_cast<int>(blockIdx.x / bh_count);
  const int cg = static_cast<int>(blockIdx.y);   // dk's and dv's column group
  const int col0 = cg * CW;
  const int chunks = (d + CW - 1) / CW;
  const int kblock0 = kt * KEYS;
  const int key0 = kblock0 + wk * 16;   // first key of this warp, a multiple of 16
  const int ka = key0 + g;              // this thread's two keys
  const int kb = ka + 8;
  const long long base = bh * n * d;
  const T* qbase = q + base;
  const T* gbase = dout + base;
  const T* kbase = k + base;
  const T* vbase = v + base;

  const int q_first = kblock0;   // no query before the block's first key sees it
  const int tiles = (n - q_first + QT - 1) / QT;
  const int items = tiles * chunks;   // ring stages: (query tile, chunk), the chunks innermost
  auto stage_item = [&](int u) {
    const int it = u / chunks;
    const int c0 = (u - it * chunks) * CW;
    const int q0 = q_first + it * QT;
    const int st = u & 1;
    float (*qt_)[LD] = ring + 2 * QT * st;
    stage_rows<T, QT, CW, LD, WIDE_THREADS>(qt_, qbase, q0, n, d, c0);
    stage_rows<T, QT, CW, LD, WIDE_THREADS>(qt_ + QT, gbase, q0, n, d, c0);
    for (int r = threadIdx.x; r < 2 * QT; r += WIDE_THREADS) {
      const int i = r % QT;
      const bool in = q0 + i < n;
      const long long at = in ? bh * n + q0 + i : 0;
      if (r < QT) {
        cp_async4(&lse_ring[st * QT + i], lse + at, in);
      } else {
        cp_async4(&dsum_ring[st * QT + i], dsum + at, in);
      }
    }
  };

  stage_rows<T, KEYS, CW, LD, WIDE_THREADS>(k_rows, kbase, kblock0, n, d);
  stage_rows<T, KEYS, CW, LD, WIDE_THREADS>(v_rows, vbase, kblock0, n, d);
  if (items > 0) stage_item(0);
  cp_async_commit();

  const bool active = key0 < n;   // the warp has keys (warp-uniform)
  const float* ka_row = &k_rows[wk * 16 + g][0];
  const float* kb_row = &k_rows[wk * 16 + g + 8][0];
  float4* p_warp = p_tile + wk * JT * 32;
  unsigned int* keep_warp = keep_tile + wk * JT * 32;
  float acc[DS][4];   // dV (warpgroup 0) or dK (1): rows ka (0, 1), kb (2, 3), columns col0 + 8s + 2t, + 1
#pragma unroll
  for (int s = 0; s < DS; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;
  // S^T (warpgroup 0) or dP^T (1) of the query tile: x[j][2h + c] is (key ka
  // for h = 0, kb for h = 1, query q0 + 8j + 2t + c)
  float x[JT][4];

  for (int u = 0; u < items; ++u) {
    const int it = u / chunks;
    const int fc = u - it * chunks;
    const int q0 = q_first + it * QT;
    const int c0 = fc * CW;
    const int st = u & 1;
    if (u + 1 < items) stage_item(u + 1);   // the next stage loads while this one is computed
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (chunks > 1 && u > 0) {   // this chunk of the block's keys
      stage_rows<T, KEYS, CW, LD, WIDE_THREADS>(k_rows, kbase, kblock0, n, d, c0);
      stage_rows<T, KEYS, CW, LD, WIDE_THREADS>(v_rows, vbase, kblock0, n, d, c0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    const float (*qt_)[LD] = ring + 2 * QT * st;
    const float (*gt_)[LD] = qt_ + QT;
    const int width = min(CW, d - c0);   // this chunk's features
    if (fc == 0) {
#pragma unroll
      for (int j = 0; j < JT; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
    }
    if (active && role == 0) {
      // S^T = K.Q^T, each chain continued over this chunk's features in
      // order, so that it rounds as the forward's score of the same pair
#pragma unroll 1
      for (int db = 0; db < width; db += 16) {
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          const int dd = db + e;
          const float4 xa = *reinterpret_cast<const float4*>(ka_row + dd);
          const float4 xb = *reinterpret_cast<const float4*>(kb_row + dd);
#pragma unroll
          for (int j = 0; j < JT; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float4 qq = *reinterpret_cast<const float4*>(&qt_[j * 8 + 2 * t + c][dd]);
              x[j][c] = fmaf(qq.x, xa.x, x[j][c]);
              x[j][c] = fmaf(qq.y, xa.y, x[j][c]);
              x[j][c] = fmaf(qq.z, xa.z, x[j][c]);
              x[j][c] = fmaf(qq.w, xa.w, x[j][c]);
              x[j][2 + c] = fmaf(qq.x, xb.x, x[j][2 + c]);
              x[j][2 + c] = fmaf(qq.y, xb.y, x[j][2 + c]);
              x[j][2 + c] = fmaf(qq.z, xb.z, x[j][2 + c]);
              x[j][2 + c] = fmaf(qq.w, xb.w, x[j][2 + c]);
            }
          }
        }
      }
    } else if (active) {
      // dP^T = V.dO^T over this chunk in three TF32 passes, into a fresh
      // accumulator added by a rounded fp32 add
      float dpc[JT][4];
#pragma unroll
      for (int j = 0; j < JT; ++j) dpc[j][0] = dpc[j][1] = dpc[j][2] = dpc[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DS; ++ks) {
        if (ks * 8 >= width) break;
        const int c = ks * 8 + t;
        unsigned int ah[4], al[4];
        split_tf32(v_rows[wk * 16 + g][c], ah[0], al[0]);
        split_tf32(v_rows[wk * 16 + g + 8][c], ah[1], al[1]);
        split_tf32(v_rows[wk * 16 + g][c + 4], ah[2], al[2]);
        split_tf32(v_rows[wk * 16 + g + 8][c + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          unsigned int bh_[2], bl_[2];
          split_tf32(gt_[j * 8 + g][c], bh_[0], bl_[0]);
          split_tf32(gt_[j * 8 + g][c + 4], bh_[1], bl_[1]);
          mma_3xtf32<EXACT, EXACT>(dpc[j], ah, al, bh_, bl_);
        }
      }
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] += dpc[j][e];
    }

    if (fc == chunks - 1) {
      const float (*qsrc)[LD] = qt_;   // Q's and dO's columns of this block's group
      const float (*gsrc)[LD] = gt_;
      if (chunks > 1) {
        __syncthreads();   // every warp is done with the keys' chunk
        stage_rows<T, QT, CW, LD, WIDE_THREADS>(k_rows, qbase, q0, n, d, col0);
        stage_rows<T, QT, CW, LD, WIDE_THREADS>(v_rows, gbase, q0, n, d, col0);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        qsrc = k_rows;
        gsrc = v_rows;
      }
      const float* lq = lse_ring + st * QT;
      const float* sq = dsum_ring + st * QT;
      // Column tile j holds a query that sees a key of this warp when
      // q0 + 8j + 7 > key0 (warp-uniform); element c of it is (key ka for
      // c < 2 else kb, query q0 + 8j + 2t + (c & 1)).
      if (role == 0) {
        if (active) {
#pragma unroll
          for (int j = 0; j < JT; ++j) {
            if (q0 + j * 8 + 7 <= key0) continue;
            const int col = j * 8 + 2 * t;
            const int i0 = q0 + col;
            const float2 l2 = *reinterpret_cast<const float2*>(&lq[col]);
            unsigned int keep = 0xFu;
            if (DROP) keep = keep_bits_keys(seed, bh, key0, i0, g, t, threshold);
            float p[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int key = c < 2 ? ka : kb;
              const int i = i0 + (c & 1);
              const bool seen = key < i && i < n;
              p[c] = seen ? __expf(x[j][c] * scale - ((c & 1) ? l2.y : l2.x)) : 0.f;
              float m = 1.f;
              if (DROP) m = ((keep >> c) & 1u) ? inv_keep : 0.f;
              x[j][c] = p[c] * m;   // into dv
            }
            p_warp[j * 32 + lane] = make_float4(p[0], p[1], p[2], p[3]);
            if (DROP) keep_warp[j * 32 + lane] = keep;
          }
        }
        barrier_arrive(1, WIDE_THREADS);   // P^T and the keep bits are written
      } else {
        barrier_wait(1, WIDE_THREADS);
        if (active) {
#pragma unroll
          for (int j = 0; j < JT; ++j) {
            if (q0 + j * 8 + 7 <= key0) continue;
            const float2 s2 = *reinterpret_cast<const float2*>(&sq[j * 8 + 2 * t]);
            const float4 p4 = p_warp[j * 32 + lane];
            const float p[4] = {p4.x, p4.y, p4.z, p4.w};
            const unsigned int keep = DROP ? keep_warp[j * 32 + lane] : 0xFu;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              float m = 1.f;
              if (DROP) m = ((keep >> c) & 1u) ? inv_keep : 0.f;
              x[j][c] = p[c] * (x[j][c] * m - ((c & 1) ? s2.y : s2.x)) * scale;   // into dk
            }
          }
        }
      }
      if (active) {
        // dV += (P^T m).dO or dK += dS^T.Q in three TF32 passes: x's fragments
        // of column j are the A fragments of k-step j with the queries
        // reordered (k = t is query 8j + 2t, k = t + 4 is 8j + 2t + 1), and the
        // B fragments are read from those two rows of dO or Q; the tile into
        // a fresh accumulator added by a rounded fp32 add
        const float (*src)[LD] = role == 0 ? gsrc : qsrc;
        float part[DS][4];
#pragma unroll
        for (int ds = 0; ds < DS; ++ds) part[ds][0] = part[ds][1] = part[ds][2] = part[ds][3] = 0.f;
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          if (q0 + j * 8 + 7 <= key0) continue;
          unsigned int ph[4], pl[4];
          split_tf32(x[j][0], ph[0], pl[0]);
          split_tf32(x[j][2], ph[1], pl[1]);
          split_tf32(x[j][1], ph[2], pl[2]);
          split_tf32(x[j][3], ph[3], pl[3]);
          const int r = j * 8 + 2 * t;
#pragma unroll
          for (int ds = 0; ds < DS; ++ds) {
            if (col0 + ds * 8 >= d) break;
            const int c = ds * 8 + g;
            unsigned int bh_[2], bl_[2];
            split_tf32(src[r][c], bh_[0], bl_[0]);
            split_tf32(src[r + 1][c], bh_[1], bl_[1]);
            mma_3xtf32<false, EXACT>(part[ds], ph, pl, bh_, bl_);
          }
        }
#pragma unroll
        for (int ds = 0; ds < DS; ++ds)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ds][e] += part[ds][e];
      }
    }
    __syncthreads();   // this stage and the P^T tile are consumed before they are overwritten
  }

  T* out = role == 0 ? dv : dk;
#pragma unroll
  for (int ds = 0; ds < DS; ++ds) {
    const int col = col0 + ds * 8 + 2 * t;
    if (col >= d) continue;
    if (ka < n) store2(out + base + static_cast<long long>(ka) * d + col, acc[ds][0], acc[ds][1]);
    if (kb < n) store2(out + base + static_cast<long long>(kb) * d + col, acc[ds][2], acc[ds][3]);
  }
}

// The arguments of both backward kernels.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* dsum;
  void* dq;
  void* dk;
  void* dv;
  long long bh;
  int n;
  int d;
  float scale;
  unsigned int threshold;
  float inv_keep;
  unsigned long long seed;
};

template <typename T, int DP, int R, bool DROP>
int launch_dq_fma(const BwdArgs& a, cudaStream_t stream) {
  constexpr int TQ = FMA_THREADS * R;
  const int tiles = (a.n + TQ - 1) / TQ;
  const long long blocks = a.bh * tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dq_fma_kernel<T, DP, R, DROP><<<static_cast<unsigned int>(blocks), FMA_THREADS, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.dsum,
      static_cast<T*>(a.dq), a.bh, a.n, a.d, tiles, a.scale, a.threshold, a.inv_keep, a.seed);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, bool DROP>
int launch_dq(const BwdArgs& a, cudaStream_t stream) {
  const int nq = (a.n + TC_ROWS - 1) / TC_ROWS;
  dim3 grid;
  if (!grid_of(a.bh, a.n, grid)) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dq_kernel<T, DP, DROP><<<grid, TC_THREADS, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.dsum,
      static_cast<T*>(a.dq), a.bh, a.n, a.d, nq, a.scale, a.threshold, a.inv_keep, a.seed);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, bool DROP>
int launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  dim3 grid;
  if (!grid_of(a.bh, a.n, grid)) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dkv_kernel<T, DP, DROP><<<grid, TC_THREADS, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dsum, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.bh, a.n, a.d, a.scale, a.threshold, a.inv_keep, a.seed);
  return static_cast<int>(cudaGetLastError());
}

// The grid of a wide kernel: (heads x row tiles of `rows`) along x, the
// column groups along y.
inline bool wide_grid_of(long long bh, int n, int rows, int groups, dim3& grid) {
  const long long blocks = bh * ((n + rows - 1) / rows);
  if (blocks > 2147483647LL || groups > 65535) return false;
  grid = dim3(static_cast<unsigned int>(blocks), static_cast<unsigned int>(groups));
  return true;
}

template <typename T, bool DROP>
int launch_dq_wide(const BwdArgs& a, int groups, cudaStream_t stream) {
  // set once a variant: the attribute outlives the call
  static const int allowed = static_cast<int>(cudaFuncSetAttribute(
      flash_bwd_dq_wide_kernel<T, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, DQW_SMEM));
  if (allowed != 0) return allowed;
  dim3 grid;
  if (!wide_grid_of(a.bh, a.n, DQW_ROWS, groups, grid)) return static_cast<int>(cudaErrorInvalidValue);
  const int nq = (a.n + DQW_ROWS - 1) / DQW_ROWS;
  flash_bwd_dq_wide_kernel<T, DROP><<<grid, WIDE_THREADS, DQW_SMEM, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.dsum,
      static_cast<T*>(a.dq), a.bh, a.n, a.d, nq, a.scale, a.threshold, a.inv_keep, a.seed);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DROP>
int launch_dkv_wide(const BwdArgs& a, int groups, cudaStream_t stream) {
  static const int allowed = static_cast<int>(cudaFuncSetAttribute(
      flash_bwd_dkv_wide_kernel<T, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, DKVW_SMEM));
  if (allowed != 0) return allowed;
  dim3 grid;
  if (!wide_grid_of(a.bh, a.n, DKVW_KEYS, groups, grid)) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dkv_wide_kernel<T, DROP><<<grid, WIDE_THREADS, DKVW_SMEM, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.dsum, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.bh, a.n, a.d, a.scale, a.threshold, a.inv_keep, a.seed);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DROP>
int launch_fwd_wide(const void* q, const void* k, const void* v, void* o, float* lse,
                    long long bh, int n, int d, float scale, unsigned int threshold,
                    float inv_keep, unsigned long long seed, cudaStream_t stream) {
  static const int allowed = static_cast<int>(cudaFuncSetAttribute(
      flash_fwd_wide_kernel<T, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, FWDW_SMEM));
  if (allowed != 0) return allowed;
  dim3 grid;
  if (!wide_grid_of(bh, n, FWDW_ROWS, (d + CW - 1) / CW, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nq = (n + FWDW_ROWS - 1) / FWDW_ROWS;
  flash_fwd_wide_kernel<T, DROP><<<grid, WIDE_THREADS, FWDW_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, bh, n, d, nq, scale, threshold, inv_keep, seed);
  return static_cast<int>(cudaGetLastError());
}

// K4's variant for a head of d features: the narrowest of 16, 32 and 64 that
// holds it, else the wide kernel with the 128-wide column groups that cover
// d (the tiling ops/flash_attention.py's backward_tiling gives the backward).
template <typename T>
int launch_by_depth(const void* q, const void* k, const void* v, void* o, float* lse,
                     long long bh, int n, int d, float scale, unsigned int threshold,
                     float inv_keep, unsigned long long seed, cudaStream_t stream) {
  if (d <= 16) return launch<T, 16>(q, k, v, o, lse, bh, n, d, scale, threshold, inv_keep, seed, stream);
  if (d <= 32) return launch<T, 32>(q, k, v, o, lse, bh, n, d, scale, threshold, inv_keep, seed, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, o, lse, bh, n, d, scale, threshold, inv_keep, seed, stream);
  if (threshold > 0) {
    return launch_fwd_wide<T, true>(q, k, v, o, lse, bh, n, d, scale, threshold, inv_keep, seed,
                                    stream);
  }
  return launch_fwd_wide<T, false>(q, k, v, o, lse, bh, n, d, scale, 0u, 1.0f, 0ull, stream);
}

// The backward launches: dq by the design chosen for the shape, or dk/dv.
enum BwdPass { PASS_DQ = 0, PASS_DKV = 1 };

// K5's design for a narrow shape: the CUDA-core one wherever none of its
// variants spills registers (chip_smoke.py's check) -- fp32 and bf16 heads up
// to 32 features, but for bf16 at 32 under dropout -- the tensor-core one
// elsewhere.  Where both are spill-free the CUDA-core design is as fast (bf16,
// D = 16, no dropout) or 1.16-2.05 times faster; at 64 features it is faster
// too, 1.25-1.87 times, but spills 180-752 bytes in every variant, and 28 at
// bf16 D = 32 under dropout (compare_kernels.py at B*H = 256, N = 1024;
// PERF.md).
template <typename T, int DP, bool DROP>
constexpr bool dq_on_cuda_cores() {
  return DP <= 16 || (DP <= 32 && !(DROP && std::is_same<T, __nv_bfloat16>::value));
}

template <typename T, int DP>
int launch_bwd_drop(const BwdArgs& a, int pass, cudaStream_t stream) {
  const bool drop = a.threshold > 0;
  if (pass == PASS_DKV) {
    return drop ? launch_dkv<T, DP, true>(a, stream) : launch_dkv<T, DP, false>(a, stream);
  }
  // rows a thread of the CUDA-core design: two at D = 16 without dropout; one
  // under dropout and at D = 32 (two rows and eight keys a step spill under
  // dropout, and one row with four keys runs as fast)
  constexpr int R = DP <= 16 ? 2 : 1;
  if (drop) {
    if constexpr (dq_on_cuda_cores<T, DP, true>()) return launch_dq_fma<T, DP, 1, true>(a, stream);
    else return launch_dq<T, DP, true>(a, stream);
  }
  if constexpr (dq_on_cuda_cores<T, DP, false>()) return launch_dq_fma<T, DP, R, false>(a, stream);
  else return launch_dq<T, DP, false>(a, stream);
}

template <typename T>
int launch_bwd_by_tile(const BwdArgs& a, int tile, int groups, int pass, cudaStream_t stream) {
  if (tile == 16) return launch_bwd_drop<T, 16>(a, pass, stream);
  if (tile == 32) return launch_bwd_drop<T, 32>(a, pass, stream);
  if (tile == 64) return launch_bwd_drop<T, 64>(a, pass, stream);
  if (pass == PASS_DKV) {
    return a.threshold > 0 ? launch_dkv_wide<T, true>(a, groups, stream)
                           : launch_dkv_wide<T, false>(a, groups, stream);
  }
  return a.threshold > 0 ? launch_dq_wide<T, true>(a, groups, stream)
                         : launch_dq_wide<T, false>(a, groups, stream);
}

// A feature tile the backward kernels have (16, 32 or 64 with one group for a
// head up to its width; CW with the groups whose columns cover d and none
// wholly past it): what ops/flash_attention.py's backward_tiling chooses.
inline bool bad_tiling(int d, int tile, int groups) {
  if (tile == 16 || tile == 32 || tile == 64) return groups != 1 || d > tile;
  return tile != CW || groups < 1 || groups > 65535 ||
         d > static_cast<long long>(groups) * CW || d <= (groups - 1) * CW;
}

int backward(const BwdArgs& a, int head_dim, int tile, int groups, int pass, int is_bf16,
             void* stream) {
  if (bad_shape(a.bh, a.n, a.d, head_dim) || bad_tiling(a.d, tile, groups)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd_by_tile<__nv_bfloat16>(a, tile, groups, pass, s)
                 : launch_bwd_by_tile<float>(a, tile, groups, pass, s);
}

}  // namespace

// o (BH, N, D) in the inputs' type and lse (BH, N) fp32 from q, k, v
// (BH, N, D), all contiguous.  D is a multiple of 4 (the wrapper zero-pads the
// feature axis to one); head_dim <= D is the head's own width, whose
// 1 / sqrt(head_dim) scales the scores.  Up to 64 features flash_fwd_kernel
// runs at the narrowest of 16, 32 and 64 that holds D; above,
// flash_fwd_wide_kernel with the 128-wide column groups that cover D.
// threshold is rate * 2^32 (0: no dropout) and inv_keep is 1 / (1 - rate).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.  Launches on the
// given stream and does not synchronise.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, void* lse,
                          long long bh, int n, int d, int head_dim, int is_bf16,
                          unsigned int threshold, float inv_keep, unsigned long long seed,
                          void* stream) {
  if (bad_shape(bh, n, d, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const float sc = scale_of(head_dim);
  return is_bf16
             ? launch_by_depth<__nv_bfloat16>(q, k, v, o, l, bh, n, d, sc, threshold, inv_keep, seed, s)
             : launch_by_depth<float>(q, k, v, o, l, bh, n, d, sc, threshold, inv_keep, seed, s);
}

// The backward, in two launches on one stream, from q, k, v, o, do (BH, N, D)
// in one type and the forward's lse (BH, N) fp32, all contiguous; d,
// head_dim, threshold, inv_keep and seed as for fa_forward (the same values
// give the same mask).  tile and groups pick the kernels' variant:
// 16, 32 or 64 with groups = 1 for d up to the tile, or 128 with the groups of
// 128 columns that cover d (none wholly past it), as ops/flash_attention.py's
// backward_tiling gives them.  fa_backward_dq writes dq (BH, N, D) in the
// inputs' type and dsum (BH, N) fp32; fa_backward_dkv then reads that dsum
// and writes dk, dv.  Each returns cudaGetLastError() after its launch (0 on
// success), or cudaErrorInvalidValue for a shape or tiling the kernels do not
// take, and does not synchronise.
extern "C" int fa_backward_dq(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* dsum, void* dq,
                              long long bh, int n, int d, int head_dim, int is_bf16,
                              int tile, int groups, unsigned int threshold, float inv_keep,
                              unsigned long long seed, void* stream) {
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(dsum),
                  dq, nullptr, nullptr, bh, n, d, scale_of(head_dim), threshold, inv_keep, seed};
  return backward(a, head_dim, tile, groups, PASS_DQ, is_bf16, stream);
}

extern "C" int fa_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* dsum, void* dk, void* dv,
                               long long bh, int n, int d, int head_dim, int is_bf16,
                               int tile, int groups, unsigned int threshold, float inv_keep,
                               unsigned long long seed, void* stream) {
  const BwdArgs a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
                  const_cast<float*>(static_cast<const float*>(dsum)), nullptr, dk, dv, bh, n, d,
                  scale_of(head_dim), threshold, inv_keep, seed};
  return backward(a, head_dim, tile, groups, PASS_DKV, is_bf16, stream);
}

// keep (BH, N, N) bytes: 1 where the forward kernel keeps element (bh, i, j)
// under this seed and threshold, for every (i, j), seen or not.
extern "C" int fa_keep_mask(void* keep, long long bh, int n, unsigned int threshold,
                            unsigned long long seed, void* stream) {
  if (bh < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = bh * n * ((n + 3) / 4);
  const long long blocks = (total + 255) / 256;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  keep_mask_kernel<<<static_cast<unsigned int>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(keep), bh, n, threshold, seed);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
