// In-place activated batch norm (ABN), forward and backward, written for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of vqvae2_tpu/ops/inplace_abn.py:
//   abn_forward_kernel         <- _fwd_kernel  (launched by _pallas_elementwise via
//                                               _abn_fwd_launch; entry abn_forward)
//   abn_backward_*_kernel      <- _bwd_kernel  (launched by _pallas_bwd via
//                                               _abn_bwd_launch; entries
//                                               abn_backward_sums, abn_backward_dx),
//                                 with the per-channel sums that the JAX package
//                                 leaves to XLA reductions (inplace_abn.py:266-276)
//
// What is computed, for rows x (M, C) and per-channel fp32 vectors:
//   forward:   z = act((x - mean) * scale + shift)          scale = rstd * (|w| + eps)
//              act in {leaky_relu(slope), elu, none}; fp32 math, z stored in x's type
//   backward:  from z and dz alone (the forward's input is not kept), per element
//              (y, dy) = act^-1(z, dz)   leaky: z < 0 -> (z / slope, dz * slope)
//                                        elu:   z < 0 -> (log1p(z'), dz * (z' + 1)),
//                                               z' = max(z, -1 + 1e-6)
//              yhat = (y - b) / w                           b = bias, w = |weight| + eps
//              edz[c] = sum_rows dy,  eydz[c] = sum_rows yhat * dy     (training only)
//              dx = (dy - edz * inv_count - yhat * eydz * inv_count) * mul,  mul = w * rstd
//   The elu clamp keeps a z rounded onto the asymptote -1 finite (log1p(-1) is
//   -inf and dz * 0 would make NaNs in the sums).  In eval mode the sums are
//   zero and inv_count is 0.
//   The sums and the dx pass are two entries, so that the synchronised ABN can
//   sum edz and eydz over the ranks between them (and pass the global
//   1 / count as inv_count).
//
// What bounds it on this card: bytes.  The forward does a handful of flops for
// 8 bytes (fp32) moved an element; the backward a few dozen for 12.  At the
// ReID main path's largest shape (M = 186,624, C = 256, fp32) the forward
// moves 382 MB and the card's 3.35 TB/s sets its floor, far above what the
// FMAs need.
//
// What the design does about it:
// * Forward and the dx pass are one elementwise pass each, a grid-stride loop
//   over 16-byte vectors of four channels (float4 for fp32, 8 bytes of bf16)
//   when C is a multiple of 4 and the rows are aligned, else one element a
//   thread.  Neighbouring threads touch neighbouring addresses; the three
//   (forward) or five (backward) channel vectors are staged in shared memory
//   once a block and read as 16-byte vectors there too.
// * The backward's sums are a reduction over rows, which the TPU's grid took
//   in order.  CUDA blocks run at once, and float atomics would sum in an order
//   that changes from run to run.  So the sums are two small kernels: one block
//   a (chunk of 512 rows, slab of 32 channels) reads z and dz once (one warp a
//   row, 128 contiguous bytes), inverts the activation and sums its rows in a
//   fixed order, writing partial sums per chunk; a second pass sums the chunks'
//   partials in a fixed order.  edz and eydz are the same bit for bit from run
//   to run.  The dx pass then reads z and dz a second time: at 190 MB each they
//   do not stay in the 50 MB L2, so the backward moves five tensors' bytes
//   where its floor counts three.
// C is any size.  Up to STAGED_MAX_C channels the vectors are staged in shared
// memory (five of them in 40 KB); above it each element reads its channel's
// values straight from global memory, where they stay in L1 and L2 (at such C
// a block's grid-stride step spans fewer channels than it has threads).  The
// arithmetic is the same on both routes.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Act { LEAKY_RELU = 0, ELU = 1, NONE = 2 };

constexpr int THREADS = 256;         // threads of an elementwise block
constexpr int MAX_BLOCKS = 132 * 16;  // grid-stride cap of an elementwise launch
constexpr int STAGED_MAX_C = 2048;
constexpr int RED_COLS = 32;         // channels of a reduction block: one warp's width
constexpr int RED_ROWS = 8;          // row lanes of a reduction block
constexpr int CHUNK_ROWS = 512;      // rows one reduction block sums

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as astype / .to() do
}

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Four channel values: a 16-byte load from the shared copy, or four loads
// through the read-only cache from global memory (no alignment assumed there).
template <bool STAGED>
__device__ __forceinline__ void load4_vec(const float* p, float (&o)[4]) {
  if constexpr (STAGED) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else {
    o[0] = __ldg(p); o[1] = __ldg(p + 1); o[2] = __ldg(p + 2); o[3] = __ldg(p + 3);
  }
}

template <bool STAGED>
__device__ __forceinline__ float load_vec(const float* p) {
  if constexpr (STAGED) return *p;
  return __ldg(p);
}

template <int ACT>
__device__ __forceinline__ float act_forward(float y, float slope) {
  if constexpr (ACT == LEAKY_RELU) return y >= 0.f ? y : slope * y;
  if constexpr (ACT == ELU) return y >= 0.f ? y : expm1f(y);
  return y;
}

template <int ACT>
__device__ __forceinline__ void act_invert(float z, float dz, float slope, float& y, float& dy) {
  if constexpr (ACT == LEAKY_RELU) {
    const bool neg = z < 0.f;
    y = neg ? z / slope : z;
    dy = neg ? dz * slope : dz;
  } else if constexpr (ACT == ELU) {
    const bool neg = z < 0.f;
    const float zs = fmaxf(z, -0.999999f);
    y = neg ? log1pf(zs) : z;
    dy = neg ? dz * (zs + 1.f) : dz;
  } else {
    y = z;
    dy = dz;
  }
}

// ---------------------------------------------------------------------------
// K7: z = act((x - mean) * scale + shift)
// ---------------------------------------------------------------------------

template <typename T, int ACT, bool VEC, bool STAGED>
__global__ void __launch_bounds__(THREADS)
abn_forward_kernel(const T* __restrict__ x, T* __restrict__ z, const float* __restrict__ mean,
                   const float* __restrict__ scale, const float* __restrict__ shift, long long m,
                   int c, float slope) {
  extern __shared__ float4 smem4[];
  const float* s_mean = mean;
  const float* s_scale = scale;
  const float* s_shift = shift;
  if constexpr (STAGED) {
    float* sm = reinterpret_cast<float*>(smem4);
    for (int i = threadIdx.x; i < c; i += blockDim.x) {
      sm[i] = mean[i];
      sm[c + i] = scale[i];
      sm[2 * c + i] = shift[i];
    }
    __syncthreads();
    s_mean = sm;
    s_scale = sm + c;
    s_shift = sm + 2 * c;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (VEC) {
    const long long nvec = m * c / 4;
    const int c4 = c / 4;
    for (long long i = first; i < nvec; i += stride) {
      const int ch = static_cast<int>(i % c4) * 4;
      float v[4], mu[4], sc[4], sh[4];
      load4(x + i * 4, v);
      load4_vec<STAGED>(s_mean + ch, mu);
      load4_vec<STAGED>(s_scale + ch, sc);
      load4_vec<STAGED>(s_shift + ch, sh);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = act_forward<ACT>((v[k] - mu[k]) * sc[k] + sh[k], slope);
      store4(z + i * 4, v);
    }
  } else {
    const long long total = m * c;
    for (long long i = first; i < total; i += stride) {
      const int ch = static_cast<int>(i % c);
      const float y = (to_f(x[i]) - load_vec<STAGED>(s_mean + ch)) * load_vec<STAGED>(s_scale + ch) +
                      load_vec<STAGED>(s_shift + ch);
      z[i] = from_f<T>(act_forward<ACT>(y, slope));
    }
  }
}

// ---------------------------------------------------------------------------
// K8 (a): per-channel sums edz, eydz in a fixed order
// ---------------------------------------------------------------------------

// One block a (chunk of CHUNK_ROWS rows, slab of RED_COLS channels): lane tx
// owns a channel, lane ty the rows ty, ty + RED_ROWS, ... of the chunk; the
// RED_ROWS partials are then added in order.  part_* are (chunks, C).
template <typename T, int ACT>
__global__ void __launch_bounds__(RED_COLS * RED_ROWS)
abn_backward_partial_kernel(const T* __restrict__ z, const T* __restrict__ dz,
                            const float* __restrict__ bias_t, const float* __restrict__ weight_t,
                            float* __restrict__ part_edz, float* __restrict__ part_eydz,
                            long long m, int c, float slope) {
  __shared__ float s_edz[RED_ROWS][RED_COLS];
  __shared__ float s_eydz[RED_ROWS][RED_COLS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.y * RED_COLS + tx;
  const long long r0 = static_cast<long long>(blockIdx.x) * CHUNK_ROWS;
  const long long r1 = (r0 + CHUNK_ROWS < m) ? r0 + CHUNK_ROWS : m;
  float se = 0.f, sy = 0.f;
  if (ch < c) {
    const float b = bias_t[ch], w = weight_t[ch];
    for (long long r = r0 + ty; r < r1; r += RED_ROWS) {
      const long long at = r * c + ch;
      float y, dy;
      act_invert<ACT>(to_f(z[at]), to_f(dz[at]), slope, y, dy);
      const float yhat = (y - b) / w;
      se += dy;
      sy += yhat * dy;
    }
  }
  s_edz[ty][tx] = se;
  s_eydz[ty][tx] = sy;
  __syncthreads();
  if (ty == 0 && ch < c) {
    float e = 0.f, y = 0.f;
#pragma unroll
    for (int k = 0; k < RED_ROWS; ++k) {
      e += s_edz[k][tx];
      y += s_eydz[k][tx];
    }
    const long long at = static_cast<long long>(blockIdx.x) * c + ch;
    part_edz[at] = e;
    part_eydz[at] = y;
  }
}

// One block a slab of RED_COLS channels: lane ty sums the chunks ty,
// ty + RED_ROWS, ... in order, then the RED_ROWS sums are added in order.
__global__ void __launch_bounds__(RED_COLS * RED_ROWS)
abn_backward_sum_kernel(const float* __restrict__ part_edz, const float* __restrict__ part_eydz,
                        float* __restrict__ edz, float* __restrict__ eydz, int chunks, int c) {
  __shared__ float s_edz[RED_ROWS][RED_COLS];
  __shared__ float s_eydz[RED_ROWS][RED_COLS];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * RED_COLS + tx;
  float se = 0.f, sy = 0.f;
  if (ch < c) {
    for (int g = ty; g < chunks; g += RED_ROWS) {
      const long long at = static_cast<long long>(g) * c + ch;
      se += part_edz[at];
      sy += part_eydz[at];
    }
  }
  s_edz[ty][tx] = se;
  s_eydz[ty][tx] = sy;
  __syncthreads();
  if (ty == 0 && ch < c) {
    float e = 0.f, y = 0.f;
#pragma unroll
    for (int k = 0; k < RED_ROWS; ++k) {
      e += s_edz[k][tx];
      y += s_eydz[k][tx];
    }
    edz[ch] = e;
    eydz[ch] = y;
  }
}

// ---------------------------------------------------------------------------
// K8 (b): dx = (dy - edz * inv_count - yhat * eydz * inv_count) * mul
// ---------------------------------------------------------------------------

// Staged, the shared copies of edz and eydz are scaled by inv_count once;
// from global memory each use scales them (the same product).
template <typename T, int ACT, bool VEC, bool STAGED>
__global__ void __launch_bounds__(THREADS)
abn_backward_dx_kernel(const T* __restrict__ z, const T* __restrict__ dz, T* __restrict__ dx,
                       const float* __restrict__ bias_t, const float* __restrict__ weight_t,
                       const float* __restrict__ mul, const float* __restrict__ edz,
                       const float* __restrict__ eydz, long long m, int c, float slope,
                       float inv_count) {
  extern __shared__ float4 smem4[];
  const float* s_b = bias_t;
  const float* s_w = weight_t;
  const float* s_mul = mul;
  const float* s_edzn = edz;
  const float* s_eydzn = eydz;
  float sums_scale = inv_count;   // applied to s_edzn, s_eydzn at each use
  if constexpr (STAGED) {
    float* sm = reinterpret_cast<float*>(smem4);
    for (int i = threadIdx.x; i < c; i += blockDim.x) {
      sm[i] = bias_t[i];
      sm[c + i] = weight_t[i];
      sm[2 * c + i] = mul[i];
      sm[3 * c + i] = edz[i] * inv_count;
      sm[4 * c + i] = eydz[i] * inv_count;
    }
    __syncthreads();
    s_b = sm;
    s_w = sm + c;
    s_mul = sm + 2 * c;
    s_edzn = sm + 3 * c;
    s_eydzn = sm + 4 * c;
    sums_scale = 1.f;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (VEC) {
    const long long nvec = m * c / 4;
    const int c4 = c / 4;
    for (long long i = first; i < nvec; i += stride) {
      const int ch = static_cast<int>(i % c4) * 4;
      float zv[4], dzv[4], b[4], w[4], mu[4], en[4], yn[4];
      load4(z + i * 4, zv);
      load4(dz + i * 4, dzv);
      load4_vec<STAGED>(s_b + ch, b);
      load4_vec<STAGED>(s_w + ch, w);
      load4_vec<STAGED>(s_mul + ch, mu);
      load4_vec<STAGED>(s_edzn + ch, en);
      load4_vec<STAGED>(s_eydzn + ch, yn);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (!STAGED) {
          en[k] *= sums_scale;
          yn[k] *= sums_scale;
        }
        float y, dy;
        act_invert<ACT>(zv[k], dzv[k], slope, y, dy);
        const float yhat = (y - b[k]) / w[k];
        zv[k] = (dy - en[k] - yhat * yn[k]) * mu[k];
      }
      store4(dx + i * 4, zv);
    }
  } else {
    const long long total = m * c;
    for (long long i = first; i < total; i += stride) {
      const int ch = static_cast<int>(i % c);
      float y, dy;
      act_invert<ACT>(to_f(z[i]), to_f(dz[i]), slope, y, dy);
      const float yhat = (y - load_vec<STAGED>(s_b + ch)) / load_vec<STAGED>(s_w + ch);
      float en = load_vec<STAGED>(s_edzn + ch), yn = load_vec<STAGED>(s_eydzn + ch);
      if constexpr (!STAGED) {
        en *= sums_scale;
        yn *= sums_scale;
      }
      dx[i] = from_f<T>((dy - en - yhat * yn) * load_vec<STAGED>(s_mul + ch));
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool bad_shape(long long m, int c, int act) {
  // (the sums' grid has a slab of RED_COLS channels along its y axis)
  return m < 1 || c < 1 || (c + RED_COLS - 1) / RED_COLS > 65535 || act < LEAKY_RELU ||
         act > NONE;
}

template <typename T>
bool vectorizable(int c, const void* a, const void* b, const void* d = nullptr) {
  const uintptr_t align = 4 * sizeof(T);
  return c % 4 == 0 && reinterpret_cast<uintptr_t>(a) % align == 0 &&
         reinterpret_cast<uintptr_t>(b) % align == 0 &&
         (d == nullptr || reinterpret_cast<uintptr_t>(d) % align == 0);
}

int elementwise_blocks(long long work) {
  const long long blocks = (work + THREADS - 1) / THREADS;
  return static_cast<int>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

long long chunks_of(long long m) { return (m + CHUNK_ROWS - 1) / CHUNK_ROWS; }

template <typename T, int ACT>
int forward_act(const void* x, void* z, const float* mean, const float* scale,
                const float* shift, long long m, int c, float slope, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* zt = static_cast<T*>(z);
  const bool vec = vectorizable<T>(c, x, z);
  const int blocks = elementwise_blocks(vec ? m * c / 4 : m * c);
  if (c <= STAGED_MAX_C) {
    const size_t smem = 3 * static_cast<size_t>(c) * sizeof(float);
    if (vec) {
      abn_forward_kernel<T, ACT, true, true><<<blocks, THREADS, smem, s>>>(xt, zt, mean, scale,
                                                                         shift, m, c, slope);
    } else {
      abn_forward_kernel<T, ACT, false, true><<<blocks, THREADS, smem, s>>>(xt, zt, mean, scale,
                                                                          shift, m, c, slope);
    }
  } else if (vec) {
    abn_forward_kernel<T, ACT, true, false><<<blocks, THREADS, 0, s>>>(xt, zt, mean, scale, shift,
                                                                     m, c, slope);
  } else {
    abn_forward_kernel<T, ACT, false, false><<<blocks, THREADS, 0, s>>>(xt, zt, mean, scale, shift,
                                                                      m, c, slope);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward(const void* x, void* z, const float* mean, const float* scale, const float* shift,
            long long m, int c, int act, float slope, cudaStream_t s) {
  switch (act) {
    case LEAKY_RELU: return forward_act<T, LEAKY_RELU>(x, z, mean, scale, shift, m, c, slope, s);
    case ELU: return forward_act<T, ELU>(x, z, mean, scale, shift, m, c, slope, s);
    default: return forward_act<T, NONE>(x, z, mean, scale, shift, m, c, slope, s);
  }
}

template <typename T, int ACT>
int sums_act(const void* z, const void* dz, const float* bias_t, const float* weight_t,
             float* edz, float* eydz, float* scratch, long long m, int c, float slope,
             bool training, cudaStream_t s) {
  int err;
  if (!training) {
    if ((err = static_cast<int>(cudaMemsetAsync(edz, 0, c * sizeof(float), s)))) return err;
    return static_cast<int>(cudaMemsetAsync(eydz, 0, c * sizeof(float), s));
  }
  const long long chunks = chunks_of(m);
  const int slabs = (c + RED_COLS - 1) / RED_COLS;
  float* part_edz = scratch;
  float* part_eydz = scratch + chunks * c;
  const dim3 block(RED_COLS, RED_ROWS);
  abn_backward_partial_kernel<T, ACT><<<dim3(static_cast<unsigned>(chunks), slabs), block, 0, s>>>(
      static_cast<const T*>(z), static_cast<const T*>(dz), bias_t, weight_t, part_edz,
      part_eydz, m, c, slope);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  abn_backward_sum_kernel<<<slabs, block, 0, s>>>(part_edz, part_eydz, edz, eydz,
                                                  static_cast<int>(chunks), c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ACT>
int dx_act(const void* z, const void* dz, void* dx, const float* bias_t, const float* weight_t,
           const float* mul, const float* edz, const float* eydz, long long m, int c,
           float slope, float inv_count, cudaStream_t s) {
  const T* zt = static_cast<const T*>(z);
  const T* dzt = static_cast<const T*>(dz);
  T* dxt = static_cast<T*>(dx);
  const bool vec = vectorizable<T>(c, z, dz, dx);
  const int blocks = elementwise_blocks(vec ? m * c / 4 : m * c);
  if (c <= STAGED_MAX_C) {
    const size_t smem = 5 * static_cast<size_t>(c) * sizeof(float);
    if (vec) {
      abn_backward_dx_kernel<T, ACT, true, true><<<blocks, THREADS, smem, s>>>(
          zt, dzt, dxt, bias_t, weight_t, mul, edz, eydz, m, c, slope, inv_count);
    } else {
      abn_backward_dx_kernel<T, ACT, false, true><<<blocks, THREADS, smem, s>>>(
          zt, dzt, dxt, bias_t, weight_t, mul, edz, eydz, m, c, slope, inv_count);
    }
  } else if (vec) {
    abn_backward_dx_kernel<T, ACT, true, false><<<blocks, THREADS, 0, s>>>(
        zt, dzt, dxt, bias_t, weight_t, mul, edz, eydz, m, c, slope, inv_count);
  } else {
    abn_backward_dx_kernel<T, ACT, false, false><<<blocks, THREADS, 0, s>>>(
        zt, dzt, dxt, bias_t, weight_t, mul, edz, eydz, m, c, slope, inv_count);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sums(const void* z, const void* dz, const float* bias_t, const float* weight_t, float* edz,
         float* eydz, float* scratch, long long m, int c, int act, float slope, bool training,
         cudaStream_t s) {
  switch (act) {
    case LEAKY_RELU:
      return sums_act<T, LEAKY_RELU>(z, dz, bias_t, weight_t, edz, eydz, scratch, m, c, slope,
                                     training, s);
    case ELU:
      return sums_act<T, ELU>(z, dz, bias_t, weight_t, edz, eydz, scratch, m, c, slope,
                              training, s);
    default:
      return sums_act<T, NONE>(z, dz, bias_t, weight_t, edz, eydz, scratch, m, c, slope,
                               training, s);
  }
}

template <typename T>
int dx_pass(const void* z, const void* dz, void* dx, const float* bias_t, const float* weight_t,
            const float* mul, const float* edz, const float* eydz, long long m, int c, int act,
            float slope, float inv_count, cudaStream_t s) {
  switch (act) {
    case LEAKY_RELU:
      return dx_act<T, LEAKY_RELU>(z, dz, dx, bias_t, weight_t, mul, edz, eydz, m, c, slope,
                                   inv_count, s);
    case ELU:
      return dx_act<T, ELU>(z, dz, dx, bias_t, weight_t, mul, edz, eydz, m, c, slope,
                            inv_count, s);
    default:
      return dx_act<T, NONE>(z, dz, dx, bias_t, weight_t, mul, edz, eydz, m, c, slope,
                             inv_count, s);
  }
}

}  // namespace

// z (M, C) = act((x - mean) * scale + shift), x and z of one type (fp32 or
// bf16), the three vectors (C,) fp32.  act: 0 leaky_relu, 1 elu, 2 none.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape it does not take.  Launches on the given
// stream and does not synchronise.
extern "C" int abn_forward(const void* x, void* z, const void* mean, const void* scale,
                           const void* shift, long long m, int c, int act, float slope,
                           int x_is_bf16, void* stream) {
  if (bad_shape(m, c, act)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mu = static_cast<const float*>(mean);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  return x_is_bf16 ? forward<__nv_bfloat16>(x, z, mu, sc, sh, m, c, act, slope, s)
                   : forward<float>(x, z, mu, sc, sh, m, c, act, slope, s);
}

// Bytes of scratch that abn_backward_sums needs for this shape in training
// mode (the caller allocates it; the kernels allocate nothing).
extern "C" long long abn_backward_scratch_bytes(long long m, int c) {
  return 2 * chunks_of(m) * c * static_cast<long long>(sizeof(float));
}

// edz, eydz (C,) fp32 from z, dz (M, C) of one type (fp32 or bf16) and bias_t,
// weight_t (C,) fp32: in training mode summed in a fixed order through
// `scratch`, in eval mode set to zero.  Returns as abn_forward; also
// cudaErrorInvalidValue for too little scratch.
extern "C" int abn_backward_sums(const void* z, const void* dz, const void* bias_t,
                                 const void* weight_t, void* edz, void* eydz, void* scratch,
                                 long long scratch_bytes, long long m, int c, int act,
                                 float slope, int training, int is_bf16, void* stream) {
  if (bad_shape(m, c, act)) return static_cast<int>(cudaErrorInvalidValue);
  if (training && scratch_bytes < abn_backward_scratch_bytes(m, c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias_t);
  const float* w = static_cast<const float*>(weight_t);
  float* e = static_cast<float*>(edz);
  float* ey = static_cast<float*>(eydz);
  float* sc = static_cast<float*>(scratch);
  return is_bf16 ? sums<__nv_bfloat16>(z, dz, b, w, e, ey, sc, m, c, act, slope, training != 0, s)
                 : sums<float>(z, dz, b, w, e, ey, sc, m, c, act, slope, training != 0, s);
}

// dx (M, C) in z's type from z, dz (M, C), bias_t, weight_t, mul (C,) fp32 and
// the sums edz, eydz (C,) fp32 (this call's, or summed over the ranks), with
// inv_count 1 / count in training mode and 0 in eval mode.  Returns as
// abn_forward.
extern "C" int abn_backward_dx(const void* z, const void* dz, void* dx, const void* bias_t,
                               const void* weight_t, const void* mul, const void* edz,
                               const void* eydz, long long m, int c, int act, float slope,
                               float inv_count, int is_bf16, void* stream) {
  if (bad_shape(m, c, act)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias_t);
  const float* w = static_cast<const float*>(weight_t);
  const float* mu = static_cast<const float*>(mul);
  const float* e = static_cast<const float*>(edz);
  const float* ey = static_cast<const float*>(eydz);
  return is_bf16 ? dx_pass<__nv_bfloat16>(z, dz, dx, b, w, mu, e, ey, m, c, act, slope,
                                          inv_count, s)
                 : dx_pass<float>(z, dz, dx, b, w, mu, e, ey, m, c, act, slope, inv_count, s);
}

extern "C" const char* abn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
