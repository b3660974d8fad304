// Strictly-causal flash attention, forward, written for Hopper (sm_90a).
//
// Replaces the TPU kernel _fwd_kernel of vqvae2_tpu/ops/flash_attention.py
// (launched by _flash_fwd).
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
