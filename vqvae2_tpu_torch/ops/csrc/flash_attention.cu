// Strictly-causal flash attention, forward and backward, written for Hopper
// (sm_90a).
//
// Replaces three TPU kernels of vqvae2_tpu/ops/flash_attention.py:
//   flash_fwd_kernel      <- _fwd_kernel   (launched by _flash_fwd; entry fa_forward)
//   flash_bwd_dq_kernel   <- _dq_kernel    (launched by _flash_bwd; entry fa_backward_dq)
//   flash_bwd_dkv_kernel  <- _dkv_kernel   (launched by _flash_bwd; entry fa_backward_dkv)
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
// flops a head in plain fp32 (no TF32: the priors' logits are held to 2e-5),
// while q, k, v in and o, lse out are 4*N*D*4 bytes: at N = 1024, D = 16 the
// FMAs need about six times the time the memory does.
//
// What the design does about it: one thread owns R query rows outright (R = 2
// up to D = 16, else 1) with q, the running (m, l) and the D-wide accumulator
// in registers, so the online softmax needs no exchange between threads.  A
// block of 64 threads owns 64*R consecutive rows; it walks the keys in tiles
// of 64 staged in shared memory (K and V, zero-padded to the template's D, at
// most 32 KB static) and stops at the diagonal, so the work is half of N*N.
// Every thread of a warp reads the same key at the same time: the 16-byte
// shared loads are broadcasts and serve R rows each.  Keys are folded in chunks
// of 8: one maximum, one rescale of the accumulator and eight exponentials a
// chunk.  A warp skips the key tiles that lie wholly above its own rows.  N is
// a runtime value and the ragged tails are masked: rows >= N are never
// written, and keys >= N are never seen because j < i < N.  Blocks with the
// longest key loops are scheduled first.
//
// Dropout is a counter-based draw: Philox-4x32-10 keyed on the seed, with the
// absolute (bh, i, j / 4) as the counter and word j % 4 of the result as the
// element's bits, so the mask does not depend on any tiling and a backward
// kernel regenerates it from the same function (dropout_bits4 below).  An
// element is kept when its bits >= rate * 2^32.  fa_keep_mask writes the same
// draw out as a (BH, N, N) byte mask for comparisons at small N.
//
// Backward.  With lse from the forward and m = keep / (1 - rate) (1 without
// dropout), for every visible pair j < i:
//   p[i, j]  = exp(s[i, j] - lse[i])             recomputed, never stored
//   dp[i, j] = <do[i], v[j]> * m[i, j]
//   ds[i, j] = p * (dp - dsum[i]) * (1 / sqrt(D)),   dsum[i] = <do[i], o[i]>
//   dq[i] = sum_j ds * k[j];  dk[j] = sum_i ds * q[i];  dv[j] = sum_i p * m * do[i]
// The dq kernel (K5) is the forward's shape with the roles kept: one thread
// owns R query rows (q, do, dq in registers), the block walks key tiles up to
// the diagonal; it also computes dsum for its rows from do and o and writes it
// out (no separate reduction).  The dk/dv kernel (K6) swaps them: one thread
// owns R key rows (k, v, dk, dv in registers), the block walks query tiles from
// the diagonal to N with q, do, lse and dsum staged in shared memory.  It runs
// after K5 on the same stream and reads K5's dsum.  Both are bound by
// operations as the forward is: three (K5) and four (K6) products of
// N*N*D/2 FMAs a head in plain fp32, fp32 accumulators.  The mask is a factor:
// row 0 contributes and receives exactly nothing, and no key j >= i is touched
// by row i.  Dropout is regenerated by dropout_bits4 on the absolute (bh, i, j),
// so the backward's mask is the forward's bit for bit whatever the tiling, and
// nothing of size N*N is stored.

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 64;            // threads of a block
constexpr int KT = 64;            // keys in a shared tile
constexpr int KC = 8;             // keys folded per rescale
constexpr float NEG = -1e30f;     // the fill of masked scores; not -inf (NaN from inf - inf)
constexpr float TINY = 1e-30f;    // floor of the normaliser
static_assert(KT % KC == 0 && KC % 4 == 0, "a chunk is whole Philox quads");

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

template <typename T, int DP, int R, bool DROP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int n, int d, int nq, float scale,
                 unsigned int threshold, float inv_keep, unsigned long long seed) {
  constexpr int TQ = NT * R;                   // rows a block owns
  __shared__ __align__(16) float ks[KT][DP];
  __shared__ __align__(16) float vs[KT][DP];

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x / nq;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x % nq);   // longest loops first
  const int row0 = qt * TQ + tid * R;          // first of this thread's rows
  const long long base = bh * n * d;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  float qr[R][DP], acc[R][DP], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < n && c < d) x = load4(qb + static_cast<long long>(row0 + r) * d + c);
      qr[r][c + 0] = x.x;
      qr[r][c + 1] = x.y;
      qr[r][c + 2] = x.z;
      qr[r][c + 3] = x.w;
      acc[r][c + 0] = acc[r][c + 1] = acc[r][c + 2] = acc[r][c + 3] = 0.f;
    }
  }

  // The last row of the block sees keys below key_end; the last row of this
  // warp sees keys below warp_last (0 for a warp whose rows all lie beyond N).
  const int key_end = min(n, qt * TQ + TQ) - 1;
  const int warp_row0 = qt * TQ + (tid / 32) * 32 * R;
  const int warp_last = warp_row0 < n ? min(n, warp_row0 + 32 * R) - 1 : 0;

  for (int k0 = 0; k0 < key_end; k0 += KT) {
    __syncthreads();   // the previous tile has been consumed
    for (int f = tid; f < KT * (DP / 4); f += NT) {
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

    const int kmax = min(KT, warp_last - k0);
    for (int c0 = 0; c0 < kmax; c0 += KC) {
      float s[R][KC];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < KC; ++c) s[r][c] = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
#pragma unroll
        for (int dd = 0; dd < DP; dd += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&ks[c0 + c][dd]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            s[r][c] = fmaf(qr[r][dd + 0], kk.x, s[r][c]);
            s[r][c] = fmaf(qr[r][dd + 1], kk.y, s[r][c]);
            s[r][c] = fmaf(qr[r][dd + 2], kk.z, s[r][c]);
            s[r][c] = fmaf(qr[r][dd + 3], kk.w, s[r][c]);
          }
        }
      }

      const int j0 = k0 + c0;   // a multiple of KC
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = row0 + r;
        float m_new = m[r];
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          s[r][c] = (j0 + c < i) ? s[r][c] * scale : NEG;
          m_new = fmaxf(m_new, s[r][c]);
        }
        const float alpha = __expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int c = 0; c < DP; ++c) acc[r][c] *= alpha;
        // p = exp(s - m) * mask: a row that has seen nothing yet has m == NEG
        // and exp(NEG - NEG) == 1, so the mask must be a factor, not only a fill
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const float p = (j0 + c < i) ? __expf(s[r][c] - m_new) : 0.f;
          l[r] += p;   // the normaliser takes the undropped p
          s[r][c] = p;
        }
        if (DROP) {
#pragma unroll
          for (int c = 0; c < KC; c += 4) {
            const uint4 bits = dropout_bits4(seed, bh, i, (j0 + c) >> 2);
            s[r][c + 0] = (bits.x >= threshold) ? s[r][c + 0] * inv_keep : 0.f;
            s[r][c + 1] = (bits.y >= threshold) ? s[r][c + 1] * inv_keep : 0.f;
            s[r][c + 2] = (bits.z >= threshold) ? s[r][c + 2] * inv_keep : 0.f;
            s[r][c + 3] = (bits.w >= threshold) ? s[r][c + 3] * inv_keep : 0.f;
          }
        }
      }

#pragma unroll
      for (int c = 0; c < KC; ++c) {
#pragma unroll
        for (int dd = 0; dd < DP; dd += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[c0 + c][dd]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][dd + 0] = fmaf(s[r][c], vv.x, acc[r][dd + 0]);
            acc[r][dd + 1] = fmaf(s[r][c], vv.y, acc[r][dd + 1]);
            acc[r][dd + 2] = fmaf(s[r][c], vv.z, acc[r][dd + 2]);
            acc[r][dd + 3] = fmaf(s[r][c], vv.w, acc[r][dd + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    if (i >= n) continue;
    const float denom = fmaxf(l[r], TINY);
    lse[bh * n + i] = m[r] + logf(denom);
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      if (c < d) {
        store4(o + base + static_cast<long long>(i) * d + c,
               make_float4(acc[r][c + 0] / denom, acc[r][c + 1] / denom, acc[r][c + 2] / denom,
                           acc[r][c + 3] / denom));
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

template <typename T, int DP, int R>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, long long bh, int n,
           int d, unsigned int threshold, float inv_keep, unsigned long long seed,
           cudaStream_t stream) {
  constexpr int TQ = NT * R;
  const int nq = (n + TQ - 1) / TQ;
  const long long blocks = bh * nq;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  const unsigned int grid = static_cast<unsigned int>(blocks);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (threshold > 0) {
    flash_fwd_kernel<T, DP, R, true><<<grid, NT, 0, stream>>>(
        qp, kp, vp, op, lse, n, d, nq, scale, threshold, inv_keep, seed);
  } else {
    flash_fwd_kernel<T, DP, R, false><<<grid, NT, 0, stream>>>(
        qp, kp, vp, op, lse, n, d, nq, scale, 0u, 1.0f, 0ull);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_by_depth(const void* q, const void* k, const void* v, void* o, float* lse,
                    long long bh, int n, int d, unsigned int threshold, float inv_keep,
                    unsigned long long seed, cudaStream_t stream) {
  if (d <= 16) return launch<T, 16, 2>(q, k, v, o, lse, bh, n, d, threshold, inv_keep, seed, stream);
  if (d <= 32) return launch<T, 32, 1>(q, k, v, o, lse, bh, n, d, threshold, inv_keep, seed, stream);
  return launch<T, 64, 1>(q, k, v, o, lse, bh, n, d, threshold, inv_keep, seed, stream);
}


// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

constexpr int QT = 64;            // queries in a shared tile of the dk/dv kernel
constexpr int QC = 8;             // queries folded per step of the dk/dv kernel
static_assert(QT % QC == 0, "a query tile is whole steps");

__device__ __forceinline__ unsigned int word_of(uint4 bits, int w) {
  return w == 0 ? bits.x : w == 1 ? bits.y : w == 2 ? bits.z : bits.w;
}

// K5: dq, and dsum for the same rows.  Blocks are ordered by the length of
// their key loop, longest first, across all heads.
template <typename T, int DP, int R, bool DROP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dsum_out,
                    T* __restrict__ dq, long long bh_count, int n, int d, int nq, float scale,
                    unsigned int threshold, float inv_keep, unsigned long long seed) {
  constexpr int TQ = NT * R;
  __shared__ __align__(16) float ks[KT][DP];
  __shared__ __align__(16) float vs[KT][DP];

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

  for (int k0 = 0; k0 < key_end; k0 += KT) {
    __syncthreads();   // the previous tile has been consumed
    for (int f = tid; f < KT * (DP / 4); f += NT) {
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

    const int kmax = min(KT, warp_last - k0);
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

// K6: dk and dv.  One thread owns R consecutive keys, which lie in one Philox
// quad (R divides 4 and the block's first key is a multiple of 4), so one draw
// a query serves all of them.  Blocks are ordered by the length of their query
// loop, longest (the first key tile) first, across all heads.
template <typename T, int DP, int R, bool DROP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
                     long long bh_count, int n, int d, float scale, unsigned int threshold,
                     float inv_keep, unsigned long long seed) {
  constexpr int TK = NT * R;                   // keys a block owns
  static_assert(4 % R == 0, "a thread's keys lie in one Philox quad");
  __shared__ __align__(16) float qs[QT][DP];
  __shared__ __align__(16) float gs[QT][DP];   // do
  __shared__ float ls[QT];
  __shared__ float sums[QT];

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x % bh_count;
  const int kt = static_cast<int>(blockIdx.x / bh_count);
  const int key0 = kt * TK + tid * R;          // first of this thread's keys
  const long long base = bh * n * d;
  const T* qb = q + base;
  const T* gb = dout + base;

  float kr[R][DP], vr[R][DP], dkr[R][DP], dvr[R][DP];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (key0 + r < n && c < d) {
        a = load4(k + base + static_cast<long long>(key0 + r) * d + c);
        b = load4(v + base + static_cast<long long>(key0 + r) * d + c);
      }
      kr[r][c + 0] = a.x;
      kr[r][c + 1] = a.y;
      kr[r][c + 2] = a.z;
      kr[r][c + 3] = a.w;
      vr[r][c + 0] = b.x;
      vr[r][c + 1] = b.y;
      vr[r][c + 2] = b.z;
      vr[r][c + 3] = b.w;
      dkr[r][c + 0] = dkr[r][c + 1] = dkr[r][c + 2] = dkr[r][c + 3] = 0.f;
      dvr[r][c + 0] = dvr[r][c + 1] = dvr[r][c + 2] = dvr[r][c + 3] = 0.f;
    }
  }

  // The queries that see a key of this warp are those after its first key.
  const int warp_key0 = kt * TK + (tid / 32) * 32 * R;

  for (int q0 = kt * TK; q0 < n; q0 += QT) {
    __syncthreads();   // the previous tile has been consumed
    for (int f = tid; f < QT * (DP / 4); f += NT) {
      const int r = f / (DP / 4);
      const int c = (f % (DP / 4)) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < n && c < d) {
        a = load4(qb + static_cast<long long>(q0 + r) * d + c);
        b = load4(gb + static_cast<long long>(q0 + r) * d + c);
      }
      *reinterpret_cast<float4*>(&qs[r][c]) = a;
      *reinterpret_cast<float4*>(&gs[r][c]) = b;
    }
    for (int r = tid; r < QT; r += NT) {
      const bool in = q0 + r < n;
      ls[r] = in ? lse[bh * n + q0 + r] : 0.f;
      sums[r] = in ? dsum[bh * n + q0 + r] : 0.f;
    }
    __syncthreads();
    if (warp_key0 >= n) continue;   // this warp's keys all lie beyond N (warp-uniform)

    for (int c0 = 0; c0 < QT; c0 += QC) {
      if (q0 + c0 + QC - 1 <= warp_key0) continue;   // no query here sees this warp's keys
      float s[R][QC], dp[R][QC];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < QC; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll
      for (int c = 0; c < QC; ++c) {
#pragma unroll
        for (int dd = 0; dd < DP; dd += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(&qs[c0 + c][dd]);
          const float4 gg = *reinterpret_cast<const float4*>(&gs[c0 + c][dd]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            s[r][c] = fmaf(kr[r][dd + 0], qq.x, s[r][c]);
            s[r][c] = fmaf(kr[r][dd + 1], qq.y, s[r][c]);
            s[r][c] = fmaf(kr[r][dd + 2], qq.z, s[r][c]);
            s[r][c] = fmaf(kr[r][dd + 3], qq.w, s[r][c]);
            dp[r][c] = fmaf(vr[r][dd + 0], gg.x, dp[r][c]);
            dp[r][c] = fmaf(vr[r][dd + 1], gg.y, dp[r][c]);
            dp[r][c] = fmaf(vr[r][dd + 2], gg.z, dp[r][c]);
            dp[r][c] = fmaf(vr[r][dd + 3], gg.w, dp[r][c]);
          }
        }
      }

#pragma unroll
      for (int c = 0; c < QC; ++c) {
        const int i = q0 + c0 + c;
        uint4 bits = make_uint4(0u, 0u, 0u, 0u);
        if (DROP) bits = dropout_bits4(seed, bh, i, key0 >> 2);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = key0 + r;
          const bool seen = j < i && i < n;
          const float p = seen ? __expf(s[r][c] * scale - ls[c0 + c]) : 0.f;
          float m = 1.f;
          if (DROP) m = (word_of(bits, j & 3) >= threshold) ? inv_keep : 0.f;
          s[r][c] = p * m;                                      // multiplies do into dv
          dp[r][c] = p * (dp[r][c] * m - sums[c0 + c]) * scale;  // multiplies q into dk
        }
      }

#pragma unroll
      for (int c = 0; c < QC; ++c) {
#pragma unroll
        for (int dd = 0; dd < DP; dd += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(&qs[c0 + c][dd]);
          const float4 gg = *reinterpret_cast<const float4*>(&gs[c0 + c][dd]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            dvr[r][dd + 0] = fmaf(s[r][c], gg.x, dvr[r][dd + 0]);
            dvr[r][dd + 1] = fmaf(s[r][c], gg.y, dvr[r][dd + 1]);
            dvr[r][dd + 2] = fmaf(s[r][c], gg.z, dvr[r][dd + 2]);
            dvr[r][dd + 3] = fmaf(s[r][c], gg.w, dvr[r][dd + 3]);
            dkr[r][dd + 0] = fmaf(dp[r][c], qq.x, dkr[r][dd + 0]);
            dkr[r][dd + 1] = fmaf(dp[r][c], qq.y, dkr[r][dd + 1]);
            dkr[r][dd + 2] = fmaf(dp[r][c], qq.z, dkr[r][dd + 2]);
            dkr[r][dd + 3] = fmaf(dp[r][c], qq.w, dkr[r][dd + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = key0 + r;
    if (j >= n) continue;
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      if (c < d) {
        const long long at = base + static_cast<long long>(j) * d + c;
        store4(dk + at, make_float4(dkr[r][c + 0], dkr[r][c + 1], dkr[r][c + 2], dkr[r][c + 3]));
        store4(dv + at, make_float4(dvr[r][c + 0], dvr[r][c + 1], dvr[r][c + 2], dvr[r][c + 3]));
      }
    }
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
  unsigned int threshold;
  float inv_keep;
  unsigned long long seed;
};

template <typename T, int DP, int R, bool DROP>
int launch_bwd(const BwdArgs& a, bool dq_pass, cudaStream_t stream) {
  constexpr int TQ = NT * R;
  const int tiles = (a.n + TQ - 1) / TQ;   // query tiles of K5 and key tiles of K6 alike
  const long long blocks = a.bh * tiles;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(a.d));
  const unsigned int grid = static_cast<unsigned int>(blocks);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (dq_pass) {
    flash_bwd_dq_kernel<T, DP, R, DROP><<<grid, NT, 0, stream>>>(
        q, k, v, static_cast<const T*>(a.o), dout, a.lse, a.dsum, static_cast<T*>(a.dq), a.bh,
        a.n, a.d, tiles, scale, a.threshold, a.inv_keep, a.seed);
  } else {
    flash_bwd_dkv_kernel<T, DP, R, DROP><<<grid, NT, 0, stream>>>(
        q, k, v, dout, a.lse, a.dsum, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.bh, a.n,
        a.d, scale, a.threshold, a.inv_keep, a.seed);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP, int R>
int launch_bwd_drop(const BwdArgs& a, bool dq_pass, cudaStream_t stream) {
  return a.threshold > 0 ? launch_bwd<T, DP, R, true>(a, dq_pass, stream)
                         : launch_bwd<T, DP, R, false>(a, dq_pass, stream);
}

template <typename T>
int launch_bwd_by_depth(const BwdArgs& a, bool dq_pass, cudaStream_t stream) {
  if (a.d <= 16) return launch_bwd_drop<T, 16, 2>(a, dq_pass, stream);
  if (a.d <= 32) return launch_bwd_drop<T, 32, 1>(a, dq_pass, stream);
  return launch_bwd_drop<T, 64, 1>(a, dq_pass, stream);
}

int backward(const BwdArgs& a, bool dq_pass, int is_bf16, void* stream) {
  if (a.bh < 1 || a.n < 1 || a.d < 4 || a.d > 64 || a.d % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd_by_depth<__nv_bfloat16>(a, dq_pass, s)
                 : launch_bwd_by_depth<float>(a, dq_pass, s);
}

}  // namespace

// o (BH, N, D) in the inputs' type and lse (BH, N) fp32 from q, k, v
// (BH, N, D), all contiguous.  D is a multiple of 4 up to 64.  threshold is
// rate * 2^32 (0: no dropout) and inv_keep is 1 / (1 - rate).  Returns
// cudaGetLastError() after the launch (0 on success), or cudaErrorInvalidValue
// for a shape the kernel does not take.  Launches on the given stream and does
// not synchronise.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, void* lse,
                          long long bh, int n, int d, int is_bf16, unsigned int threshold,
                          float inv_keep, unsigned long long seed, void* stream) {
  if (bh < 1 || n < 1 || d < 4 || d > 64 || d % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return is_bf16
             ? launch_by_depth<__nv_bfloat16>(q, k, v, o, l, bh, n, d, threshold, inv_keep, seed, s)
             : launch_by_depth<float>(q, k, v, o, l, bh, n, d, threshold, inv_keep, seed, s);
}

// The backward, in two launches on one stream, from q, k, v, o, do (BH, N, D)
// in one type and the forward's lse (BH, N) fp32, all contiguous; threshold,
// inv_keep and seed as for fa_forward (the same values give the same mask).
// fa_backward_dq writes dq (BH, N, D) in the inputs' type and dsum (BH, N)
// fp32; fa_backward_dkv then reads that dsum and writes dk, dv.  Each returns
// cudaGetLastError() after its launch (0 on success), or cudaErrorInvalidValue
// for a shape the kernels do not take, and does not synchronise.
extern "C" int fa_backward_dq(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* dsum, void* dq,
                              long long bh, int n, int d, int is_bf16, unsigned int threshold,
                              float inv_keep, unsigned long long seed, void* stream) {
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(dsum),
                  dq, nullptr, nullptr, bh, n, d, threshold, inv_keep, seed};
  return backward(a, true, is_bf16, stream);
}

extern "C" int fa_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* dsum, void* dk, void* dv,
                               long long bh, int n, int d, int is_bf16, unsigned int threshold,
                               float inv_keep, unsigned long long seed, void* stream) {
  const BwdArgs a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
                  const_cast<float*>(static_cast<const float*>(dsum)), nullptr, dk, dv, bh, n, d,
                  threshold, inv_keep, seed};
  return backward(a, false, is_bf16, stream);
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
