// Nearest-code search for vector quantization, written for Hopper (sm_90a).
//
// Replaces two TPU kernels of vqvae2_tpu/ops/quantize.py:
//   vq_nearest_ids     <- _quantize_kernel_ids      (indices only)
//   vq_nearest_lookup  <- _quantize_kernel_nostats  (indices and q = E[idx])
//
// What is computed, for x (N, D) and a codebook E (K, D):
//   score[n, k] = (2 * <x[n], E[k]> - |x[n]|^2) - |E[k]|^2      in true fp32
//   idx[n]      = argmax_k score[n, k]      (the first maximum wins)
//   q[n, :]     = E[idx[n], :]              (lookup flavour only, in x's type)
//
// What bounds it on this card: operations.  The product is 2*N*K*D flops of
// plain fp32 (TF32 would flip near-tie ids), which the CUDA cores do at about
// 67 TFLOP/s, while x in and idx/q out are a few hundred bytes a row: the time
// the memory needs is an order of magnitude below the time the FMAs need.
//
// What the design does about it: a register-tiled fp32 product.  A block of
// 256 threads owns 128 rows.  It walks the codebook in chunks of 128 codes and
// the feature axis in pieces of 32, staging both operands transposed in shared
// memory (32 KB static, so neither the 128 KB main-path codebook nor a 512 KB
// deep one has to fit).  Each thread keeps an 8x8 tile of dot products in
// registers (64 FMAs for four 16-byte shared loads), and after each chunk
// folds its 8 scores a row into a running (best, idx).  Nothing of size (N, K)
// exists anywhere.  The 16 threads that share a row then merge their
// candidates with shuffles, comparing (score, idx) so that equal scores keep
// the lower index, as argmax does.  The lookup is an exact row gather from the
// codebook.  N, D and K are runtime values: the ragged tail of each is masked,
// no input is padded.  D must be a multiple of 4 (16-byte loads).

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TN = 128;   // rows a block owns
constexpr int KC = 128;   // codes in a chunk
constexpr int DC = 32;    // features in a piece
constexpr int NT = 256;   // threads: 16 along the rows x 16 along the codes
static_assert(TN == KC && TN * 2 == NT, "the norm pass maps one thread to one row or one code");

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

// Rows (or codes) of a thread's 8-wide strip: 4 neighbours in each half of the
// tile, so that a 16-byte shared load of neighbouring threads hits
// neighbouring banks.
__device__ __forceinline__ int strip(int t, int i) {
  return (i < 4) ? (t * 4 + i) : (TN / 2 + t * 4 + (i - 4));
}

template <typename XT, bool WITH_Q>
__global__ void __launch_bounds__(NT, 2)
nearest_code_kernel(const XT* __restrict__ x, const float* __restrict__ embed,
                    int* __restrict__ idx_out, XT* __restrict__ q_out,
                    long long n, int d, int k) {
  __shared__ __align__(16) float xs[DC][TN];   // x piece, transposed
  __shared__ __align__(16) float es[DC][KC];   // codebook piece, transposed
  __shared__ float xx_s[TN];                   // |x|^2 of each row
  __shared__ float ee_s[KC];                   // |E|^2 of each code in the chunk
  __shared__ int best_s[TN];                   // winning code of each row

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // along the codes
  const int ty = tid >> 4;   // along the rows
  const long long row0 = static_cast<long long>(blockIdx.x) * TN;

  float best[8];
  int bidx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = -INFINITY;
    bidx[i] = 0x7fffffff;
  }
  float xx_acc = 0.f;

  for (int k0 = 0; k0 < k; k0 += KC) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float ee_acc = 0.f;

    for (int d0 = 0; d0 < d; d0 += DC) {
      __syncthreads();   // the previous piece has been consumed
      for (int f = tid; f < TN * (DC / 4); f += NT) {
        const int r = f % TN;
        const int c = (f / TN) * 4;
        const long long row = row0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < n && d0 + c < d) v = load4(x + row * d + d0 + c);
        xs[c + 0][r] = v.x;
        xs[c + 1][r] = v.y;
        xs[c + 2][r] = v.z;
        xs[c + 3][r] = v.w;
      }
      for (int f = tid; f < KC * (DC / 4); f += NT) {
        const int r = f % KC;
        const int c = (f / KC) * 4;
        const int code = k0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (code < k && d0 + c < d) v = load4(embed + static_cast<long long>(code) * d + d0 + c);
        es[c + 0][r] = v.x;
        es[c + 1][r] = v.y;
        es[c + 2][r] = v.z;
        es[c + 3][r] = v.w;
      }
      __syncthreads();

      // Squared norms: the lower half of the block takes the rows (once, in
      // the first chunk), the upper half the codes of this chunk.
      if (tid < TN) {
        if (k0 == 0) {
#pragma unroll
          for (int dd = 0; dd < DC; ++dd) xx_acc = fmaf(xs[dd][tid], xs[dd][tid], xx_acc);
        }
      } else {
#pragma unroll
        for (int dd = 0; dd < DC; ++dd) ee_acc = fmaf(es[dd][tid - TN], es[dd][tid - TN], ee_acc);
      }

#pragma unroll 4
      for (int dd = 0; dd < DC; ++dd) {
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[dd][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xs[dd][TN / 2 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&es[dd][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&es[dd][KC / 2 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }

    if (tid < TN) {
      if (k0 == 0) xx_s[tid] = xx_acc;
    } else {
      ee_s[tid - TN] = ee_acc;
    }
    __syncthreads();

    // Fold this chunk into the running best.  Codes are visited in rising
    // order and only a strictly larger score replaces, so the first maximum
    // stays.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xr = xx_s[strip(ty, i)];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = strip(tx, j);
        const int code = k0 + cl;
        const float s = (2.0f * acc[i][j] - xr) - ee_s[cl];
        if (code < k && s > best[i]) {
          best[i] = s;
          bidx[i] = code;
        }
      }
    }
  }

  // The 16 threads with one ty are a half warp and hold candidates for the
  // same 8 rows: merge them, the lower index winning among equal scores.
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float os = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
      if (os > best[i] || (os == best[i] && oi < bidx[i])) {
        best[i] = os;
        bidx[i] = oi;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) best_s[strip(ty, i)] = (bidx[i] < k) ? bidx[i] : 0;
  }
  __syncthreads();

  if (tid < TN && row0 + tid < n) idx_out[row0 + tid] = best_s[tid];

  if (WITH_Q) {
    const int d4 = d / 4;
    for (int f = tid; f < TN * d4; f += NT) {
      const int r = f / d4;
      const int c = (f % d4) * 4;
      const long long row = row0 + r;
      if (row < n) {
        const float4 v = load4(embed + static_cast<long long>(best_s[r]) * d + c);
        store4(q_out + row * d + c, v);
      }
    }
  }
}

template <typename XT, bool WITH_Q>
int launch(const void* x, const void* embed, void* idx, void* q, long long n, int d, int k,
           cudaStream_t stream) {
  const long long blocks = (n + TN - 1) / TN;
  nearest_code_kernel<XT, WITH_Q><<<static_cast<unsigned int>(blocks), NT, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const float*>(embed), static_cast<int*>(idx),
      static_cast<XT*>(q), n, d, k);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(long long n, int d, int k) {
  return n < 1 || d < 4 || d % 4 != 0 || k < 1 || (n + TN - 1) / TN > 2147483647LL;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.  They launch on
// the given stream and do not synchronise.
extern "C" int vq_nearest_ids(const void* x, const void* embed, void* idx, long long n, int d,
                              int k, int x_is_bf16, void* stream) {
  if (bad_shape(n, d, k)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16, false>(x, embed, idx, nullptr, n, d, k, s)
                   : launch<float, false>(x, embed, idx, nullptr, n, d, k, s);
}

extern "C" int vq_nearest_lookup(const void* x, const void* embed, void* idx, void* q,
                                 long long n, int d, int k, int x_is_bf16, void* stream) {
  if (bad_shape(n, d, k)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16, true>(x, embed, idx, q, n, d, k, s)
                   : launch<float, true>(x, embed, idx, q, n, d, k, s);
}

extern "C" const char* vq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
