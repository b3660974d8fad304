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
// * The forward (K7) is one elementwise pass, a grid-stride loop over
//   16-byte vectors of four channels (float4 for fp32, 8 bytes of bf16) when
//   C is a multiple of 4 and the rows are aligned, else one element a thread.
//   Neighbouring threads touch neighbouring addresses; the three channel
//   vectors are staged in shared memory once a block and read as 16-byte
//   vectors there too.
// * K8 streams z and dz twice: its per-channel sums must be complete before
//   any dx, and at the ReID path's largest shape z and dz (382 MB in fp32,
//   191 MB in bf16) exceed what the card holds on chip, so the floor is five
//   tensors' bytes.  Both passes are persistent blocks, one an SM, over a
//   fixed row partition that the wrapper computes from (M, C, dtype) alone:
//   the rows are cut into whole tiles of about 16 KB, and block b of B takes
//   tiles b, b + B, b + 2B, ...  The blocks so sweep the rows together, which
//   DRAM served faster on the H100 than contiguous ranges far apart.
//   - The sums pass (`abn_sums_ring_kernel`): one producer thread streams
//     the block's z and dz tiles into a ring of RING_STAGES buffers in shared
//     memory with bulk asynchronous copies (cp.async.bulk, completion counted
//     on an mbarrier a stage; 6 x 2 x 16 KB in flight an SM).  Sixteen
//     consumer warps read 16-byte vectors from the ring (4 fp32 or 8 bf16
//     channels a lane: a lane owns fixed channels and rows lane, lane + L,
//     ... of each tile, whose rows the wrapper makes a whole number of L, so
//     that a lane takes every L-th row of its block's rows, as the generic
//     route's lanes do), invert the activation and keep fp32 sums in
//     registers, in that order.  The L lanes of a channel are then
//     added in lane order, and each block writes one partial row.  A small
//     second launch (`abn_sums_final_kernel`) adds the partials: 32 groups of
//     consecutive blocks, each summed in block order, then the groups in
//     order.  Every order is fixed, so edz and eydz repeat bit for bit from
//     launch to launch and from card to card.
//   - The dx pass (`abn_dx_ring_kernel`): the same blocks take the same
//     tiles last first, so the rows the sums pass read last, which the 50 MB
//     L2 still holds, are read first; the same ring.  Each lane writes its
//     dx vectors over the z vectors it read, and one bulk asynchronous copy
//     stores the tile from shared memory, marked evict-first, so dx does not
//     push out the z and dz lines still to come; a stage is handed back to
//     the producer once its store has read it (faster on the H100 than
//     16-byte st.global.cs from each lane, and no register spill where a
//     lane takes two vectors).
//   A lane keeps its channels' vectors (bias, 1 / weight, and for dx mul and
//   the scaled sums) in registers.  The divisions of the inversion become
//   products: yhat = (y - b) * (1 / w) and, for leaky_relu, y = z * (1 /
//   slope), each within a rounding or two of the division; at 8 bf16 values
//   a 16-byte vector the divisions' instructions held the bf16 sums back.
//   Measured and left out: L2 eviction hints on the bulk loads and
//   programmatic dependent launch of the final sum and the dx pass (each
//   made the whole backward slower on the H100).
// * Above 512 vectors a row (fp32 C from 2052 to 4096) a consumer lane takes
//   two vectors of every row.  Rows that are no multiple of 16 bytes (C not a
//   multiple of 4 in fp32, of 8 in bf16), tensors off a 16-byte boundary, and
//   C above 4096 take the generic route: the same partition and the same
//   final sum, scalar loads, a block a slab of up to 32 channels of a
//   partition block's tiles, a lane a channel and L = 256 / slab lanes over
//   the block's rows (`abn_sums_generic_kernel`); dx by the elementwise
//   grid-stride kernel (`abn_backward_dx_kernel`, 16-byte vectors of four
//   channels where the rows allow them), whose order changes no result.
// C is any size.  Up to STAGED_MAX_C channels the forward's and the generic
// dx pass's vectors are staged in shared memory (five of them in 40 KB);
// above it each element reads its channel's values straight from global
// memory, where they stay in L1 and L2.  The arithmetic is the same on every
// route.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Act { LEAKY_RELU = 0, ELU = 1, NONE = 2 };

constexpr int THREADS = 256;         // threads of an elementwise block
constexpr int MAX_BLOCKS = 132 * 16;  // grid-stride cap of an elementwise launch
constexpr int STAGED_MAX_C = 2048;
constexpr int GENERIC_SLAB = 32;     // channels of a block of K8's generic sums: a warp's width
// K8's persistent blocks, one an SM: sixteen consumer warps and one producer
// warp
constexpr int RING_CONSUMER_WARPS = 16;
constexpr int RING_CONSUMERS = 32 * RING_CONSUMER_WARPS;
constexpr int RING_THREADS = RING_CONSUMERS + 32;
constexpr int RING_STAGES = 6;                           // tiles of z and of dz in flight
constexpr int RING_BARRIER_BYTES = 2 * RING_STAGES * 8;  // full and empty mbarriers
constexpr int MAX_RING_SMEM = 232448;                    // what a block can have
constexpr int MAX_PARTITION_BLOCKS = 65535;
// the final sum over the blocks' partials: 32 channels x 32 groups of blocks
constexpr int FINAL_COLS = 32;
constexpr int FINAL_GROUPS = 32;

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

// inv_slope is 1 / slope, taken once a thread: z * inv_slope lies within a
// rounding or two of z / slope, at a fraction of a division's instructions.
template <int ACT>
__device__ __forceinline__ void act_invert(float z, float dz, float slope, float inv_slope,
                                           float& y, float& dy) {
  if constexpr (ACT == LEAKY_RELU) {
    const bool neg = z < 0.f;
    y = neg ? z * inv_slope : z;
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
// bulk asynchronous copies into a ring of shared-memory stages
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both on a
// 16-byte boundary); the copy's bytes count against the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from shared `src` to global `dst` (both on a
// 16-byte boundary) as one bulk group, under the L2 cache policy `policy`.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes,
                                           uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n"
      "cp.async.bulk.commit_group;\n"
      ::"l"(dst), "r"(src), "r"(bytes), "l"(policy)
      : "memory");
}

// Until at most the newest bulk store still reads shared memory.
__device__ __forceinline__ void bulk_wait_all_but_newest_read() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// Until every bulk store of this thread has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's writes to shared memory visible to bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// The consumer warps alone (named barrier 1; the producer warp has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(RING_CONSUMERS) : "memory");
}

// The tiles of this block, in the sums pass's order: the partition the
// wrapper computed.  Block b takes tiles b, b + blocks, b + 2 * blocks, ...,
// so the blocks sweep the rows together (neighbouring blocks read
// neighbouring tiles, which DRAM serves better than ranges far apart) and
// every block's last tiles are the rows read last.
struct BlockTiles {
  long long first, count, step;
  __device__ __forceinline__ BlockTiles(long long m, int tile_rows) {
    const long long tiles = (m + tile_rows - 1) / tile_rows;
    first = blockIdx.x;
    step = gridDim.x;
    count = (tiles - first + step - 1) / step;
  }
  __device__ __forceinline__ long long operator[](long long i) const { return first + i * step; }
};

// 16 bytes of a row: 4 fp32 or 8 bf16 values.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack16(const uint4& raw, float (&o)[4]) {
  o[0] = __uint_as_float(raw.x); o[1] = __uint_as_float(raw.y);
  o[2] = __uint_as_float(raw.z); o[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack16(const uint4& raw, float (&o)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 pack16(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
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

// The ring of a K8 block in dynamic shared memory: the mbarriers (full[s],
// then empty[s]), then RING_STAGES pairs of tile buffers (z, dz), each
// `tile_stride` bytes.  The sums pass reuses the buffers for its lanes'
// reduction once the ring has drained.
struct Ring {
  unsigned char* base;
  size_t tile_stride;
  __device__ __forceinline__ uint32_t full(int s) const { return smem_u32(base) + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return smem_u32(base) + 8 * (RING_STAGES + s);
  }
  __device__ __forceinline__ unsigned char* buf(int s, int which) const {
    return base + RING_BARRIER_BYTES + (2 * s + which) * tile_stride;
  }
};

// The producer warp's one thread: the block's tiles of z and dz into the
// ring, in the sums pass's order or (`reverse`, the dx pass) the other way
// round, each stage once its buffers are free.
template <typename T>
__device__ __forceinline__ void ring_produce(const Ring& ring, const T* z, const T* dz,
                                             long long m, int c, int tile_rows,
                                             const BlockTiles& tiles, bool reverse) {
  const size_t row_bytes = static_cast<size_t>(c) * sizeof(T);
  int stage = 0;
  uint32_t phase = 0;
  for (long long i = 0; i < tiles.count; ++i) {
    const long long row0 = tiles[reverse ? tiles.count - 1 - i : i] * tile_rows;
    const long long rows = (m - row0 < tile_rows) ? m - row0 : tile_rows;
    const uint32_t bytes = static_cast<uint32_t>(rows * row_bytes);
    mbar_wait(ring.empty(stage), phase ^ 1);   // a fresh barrier passes at once
    mbar_expect_tx(ring.full(stage), 2 * bytes);
    bulk_load(smem_u32(ring.buf(stage, 0)), z + row0 * c, bytes, ring.full(stage));
    bulk_load(smem_u32(ring.buf(stage, 1)), dz + row0 * c, bytes, ring.full(stage));
    if (++stage == RING_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// A consumer thread's place: nvec = C / V vectors a row.  Up to
// RING_CONSUMERS of them (CPT = 1): L = RING_CONSUMERS / nvec lanes, lane l
// taking rows l, l + L, ... of a tile and one vector of V channels.  Above
// (CPT = 2, fp32 up to 2 * RING_CONSUMERS vectors): one lane, every row, and
// two vectors, tid and tid + RING_CONSUMERS.
template <int CPT>
struct Lane {
  int lanes, lane, col[CPT];
  bool on[CPT];
  __device__ __forceinline__ Lane(int nvec, int tid) {
    lanes = CPT == 1 ? RING_CONSUMERS / nvec : 1;
    lane = CPT == 1 ? tid / nvec : 0;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      col[j] = CPT == 1 ? tid % nvec : tid + j * RING_CONSUMERS;
      on[j] = CPT == 1 ? lane < lanes : col[j] < nvec;
    }
  }
};

// `empty_count` arrivals free a stage: one a consumer warp, or the one
// thread that stores the stage's tile.
__device__ __forceinline__ Ring ring_setup(size_t tile_stride, int empty_count) {
  extern __shared__ __align__(128) unsigned char ring_smem[];
  Ring ring{ring_smem, tile_stride};
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING_STAGES; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), empty_count);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// One block its tiles (BlockTiles); writes its partial sums part_*[block][C].
template <typename T, int ACT, int CPT>
__global__ void __launch_bounds__(RING_THREADS, 1)
abn_sums_ring_kernel(const T* __restrict__ z, const T* __restrict__ dz,
                     const float* __restrict__ bias_t, const float* __restrict__ weight_t,
                     float* __restrict__ part_edz, float* __restrict__ part_eydz, long long m,
                     int c, int tile_rows, size_t tile_stride, float slope) {
  constexpr int V = Vec16<T>::N;
  const float inv_slope = 1.f / slope;
  const Ring ring = ring_setup(tile_stride, RING_CONSUMER_WARPS);
  const BlockTiles tiles(m, tile_rows);
  const int tid = threadIdx.x;
  if (tid >= RING_CONSUMERS) {
    if (tid == RING_CONSUMERS) ring_produce(ring, z, dz, m, c, tile_rows, tiles, false);
    return;
  }
  const Lane<CPT> at(c / V, tid);
  float b[CPT][V], iw[CPT][V], se[CPT][V], sy[CPT][V];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int ch = at.on[j] ? at.col[j] * V + k : 0;
      b[j][k] = __ldg(bias_t + ch);
      iw[j][k] = 1.f / __ldg(weight_t + ch);
      se[j][k] = 0.f;
      sy[j][k] = 0.f;
    }
  }
  const size_t row_bytes = static_cast<size_t>(c) * sizeof(T);
  int stage = 0;
  uint32_t phase = 0;
  for (long long i = 0; i < tiles.count; ++i) {
    const long long row0 = tiles[i] * tile_rows;
    const int rows = static_cast<int>((m - row0 < tile_rows) ? m - row0 : tile_rows);
    mbar_wait(ring.full(stage), phase);
    for (int r = at.lane; r < rows; r += at.lanes) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        if (!at.on[j]) continue;
        const size_t off = r * row_bytes + static_cast<size_t>(at.col[j]) * 16;
        float zv[V], dzv[V];
        unpack16(*reinterpret_cast<const uint4*>(ring.buf(stage, 0) + off), zv);
        unpack16(*reinterpret_cast<const uint4*>(ring.buf(stage, 1) + off), dzv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float y, dy;
          act_invert<ACT>(zv[k], dzv[k], slope, inv_slope, y, dy);
          const float yhat = (y - b[j][k]) * iw[j][k];
          se[j][k] += dy;
          sy[j][k] = fmaf(yhat, dy, sy[j][k]);
        }
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(ring.empty(stage));
    if (++stage == RING_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  // the L lanes of a channel, added in lane order: [2][L][C] floats over the
  // drained ring buffers
  float* red = reinterpret_cast<float*>(ring.buf(0, 0));
  const int lanes_c = at.lanes * c;
  consumers_sync();
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    if (!at.on[j]) continue;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[at.lane * c + at.col[j] * V + k] = se[j][k];
      red[lanes_c + at.lane * c + at.col[j] * V + k] = sy[j][k];
    }
  }
  consumers_sync();
  float* out_e = part_edz + static_cast<long long>(blockIdx.x) * c;
  float* out_y = part_eydz + static_cast<long long>(blockIdx.x) * c;
  for (int ch = tid; ch < c; ch += RING_CONSUMERS) {
    float e = red[ch], y = red[lanes_c + ch];
    for (int l = 1; l < at.lanes; ++l) {
      e += red[l * c + ch];
      y += red[lanes_c + l * c + ch];
    }
    out_e[ch] = e;
    out_y[ch] = y;
  }
}

// The generic route (any C, any alignment): block (b, s) of a grid of
// (blocks, slabs) takes block b's tiles for slab s of W = min(C, GENERIC_SLAB)
// channels; L = THREADS / W lanes, lane l taking positions l, l + L, ... of
// the block's rows (its tiles' rows in order, as the ring kernel's lanes do
// where a tile is a whole number of L rows); a lane's channel summed in that
// order, the L lanes added in lane order.  Writes part_*[b][C] as the ring
// kernel does.
template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
abn_sums_generic_kernel(const T* __restrict__ z, const T* __restrict__ dz,
                        const float* __restrict__ bias_t, const float* __restrict__ weight_t,
                        float* __restrict__ part_edz, float* __restrict__ part_eydz, long long m,
                        int c, int tile_rows, float slope) {
  const float inv_slope = 1.f / slope;
  __shared__ float s_e[THREADS], s_y[THREADS];
  const BlockTiles tiles(m, tile_rows);
  const int width = c < GENERIC_SLAB ? c : GENERIC_SLAB;
  const int lanes = THREADS / width;
  const int lane = threadIdx.x / width, k = threadIdx.x % width;
  const int ch = blockIdx.y * width + k;
  float se = 0.f, sy = 0.f;
  if (lane < lanes && ch < c) {
    const float b = __ldg(bias_t + ch), iw = 1.f / __ldg(weight_t + ch);
    // position p is row r of the block's tile i; a step of L positions moves
    // (di, dr) (only the last tile of all can be short)
    const long long di = lanes / tile_rows;
    const int dr = lanes % tile_rows;
    long long i = lane / tile_rows;
    int r = lane % tile_rows;
#pragma unroll 4
    for (long long p = lane; p < tiles.count * tile_rows; p += lanes) {
      const long long row = tiles[i] * tile_rows + r;
      i += di;
      r += dr;
      if (r >= tile_rows) {
        r -= tile_rows;
        ++i;
      }
      if (row >= m) continue;
      const long long idx = row * c + ch;
      float y, dy;
      act_invert<ACT>(to_f(z[idx]), to_f(dz[idx]), slope, inv_slope, y, dy);
      const float yhat = (y - b) * iw;
      se += dy;
      sy = fmaf(yhat, dy, sy);
    }
  }
  s_e[threadIdx.x] = se;
  s_y[threadIdx.x] = sy;
  __syncthreads();
  if (lane == 0 && ch < c) {
    float e = s_e[k], y = s_y[k];
    for (int l = 1; l < lanes; ++l) {
      e += s_e[l * width + k];
      y += s_y[l * width + k];
    }
    part_edz[static_cast<long long>(blockIdx.x) * c + ch] = e;
    part_eydz[static_cast<long long>(blockIdx.x) * c + ch] = y;
  }
}

// edz, eydz from the blocks' partials: a block of FINAL_COLS channels;
// group g of FINAL_GROUPS sums blocks [g * B / G, (g + 1) * B / G) in block
// order, then the groups are added in order.
__global__ void __launch_bounds__(FINAL_COLS * FINAL_GROUPS)
abn_sums_final_kernel(const float* __restrict__ part_edz, const float* __restrict__ part_eydz,
                      float* __restrict__ edz, float* __restrict__ eydz, int blocks, int c) {
  __shared__ float s_e[FINAL_GROUPS][FINAL_COLS + 1], s_y[FINAL_GROUPS][FINAL_COLS + 1];
  const int tx = threadIdx.x % FINAL_COLS, g = threadIdx.x / FINAL_COLS;
  const int ch = blockIdx.x * FINAL_COLS + tx;
  float e = 0.f, y = 0.f;
  if (ch < c) {
    const int b0 = g * blocks / FINAL_GROUPS, b1 = (g + 1) * blocks / FINAL_GROUPS;
#pragma unroll 4
    for (int b = b0; b < b1; ++b) {
      e += part_edz[static_cast<long long>(b) * c + ch];
      y += part_eydz[static_cast<long long>(b) * c + ch];
    }
  }
  s_e[g][tx] = e;
  s_y[g][tx] = y;
  __syncthreads();
  if (g == 0 && ch < c) {
    for (int i = 1; i < FINAL_GROUPS; ++i) {
      e += s_e[i][tx];
      y += s_y[i][tx];
    }
    edz[ch] = e;
    eydz[ch] = y;
  }
}

// ---------------------------------------------------------------------------
// K8 (b): dx = (dy - edz * inv_count - yhat * eydz * inv_count) * mul
// ---------------------------------------------------------------------------

// One block the tiles its sums block had, last tile first.  Consumer thread 0
// stores each tile and frees the stage of the tile before it once that
// tile's store has read its buffer.
template <typename T, int ACT, int CPT>
__global__ void __launch_bounds__(RING_THREADS, 1)
abn_dx_ring_kernel(const T* __restrict__ z, const T* __restrict__ dz, T* __restrict__ dx,
                   const float* __restrict__ bias_t, const float* __restrict__ weight_t,
                   const float* __restrict__ mul, const float* __restrict__ edz,
                   const float* __restrict__ eydz, long long m, int c, int tile_rows,
                   size_t tile_stride, float slope, float inv_count) {
  constexpr int V = Vec16<T>::N;
  const float inv_slope = 1.f / slope;
  const Ring ring = ring_setup(tile_stride, 1);
  const BlockTiles tiles(m, tile_rows);
  const int tid = threadIdx.x;
  if (tid >= RING_CONSUMERS) {
    if (tid == RING_CONSUMERS) ring_produce(ring, z, dz, m, c, tile_rows, tiles, true);
    return;
  }
  const Lane<CPT> at(c / V, tid);
  float b[CPT][V], iw[CPT][V], mu[CPT][V], en[CPT][V], yn[CPT][V];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int ch = at.on[j] ? at.col[j] * V + k : 0;
      b[j][k] = __ldg(bias_t + ch);
      iw[j][k] = 1.f / __ldg(weight_t + ch);
      mu[j][k] = __ldg(mul + ch);
      en[j][k] = __ldg(edz + ch) * inv_count;
      yn[j][k] = __ldg(eydz + ch) * inv_count;
    }
  }
  const size_t row_bytes = static_cast<size_t>(c) * sizeof(T);
  const uint64_t policy = evict_first_policy();
  int stage = 0, last_stage = 0;
  uint32_t phase = 0;
  for (long long i = tiles.count - 1; i >= 0; --i) {
    const long long row0 = tiles[i] * tile_rows;
    const int rows = static_cast<int>((m - row0 < tile_rows) ? m - row0 : tile_rows);
    mbar_wait(ring.full(stage), phase);
    for (int r = at.lane; r < rows; r += at.lanes) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        if (!at.on[j]) continue;
        const size_t off = r * row_bytes + static_cast<size_t>(at.col[j]) * 16;
        float zv[V], dzv[V];
        unpack16(*reinterpret_cast<const uint4*>(ring.buf(stage, 0) + off), zv);
        unpack16(*reinterpret_cast<const uint4*>(ring.buf(stage, 1) + off), dzv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float y, dy;
          act_invert<ACT>(zv[k], dzv[k], slope, inv_slope, y, dy);
          const float yhat = (y - b[j][k]) * iw[j][k];
          zv[k] = (dy - en[j][k] - yhat * yn[j][k]) * mu[j][k];
        }
        *reinterpret_cast<uint4*>(ring.buf(stage, 0) + off) = pack16(zv);
      }
    }
    fence_proxy_async();
    consumers_sync();
    if (tid == 0) {
      bulk_store(dx + row0 * c, smem_u32(ring.buf(stage, 0)),
                 static_cast<uint32_t>(rows * row_bytes), policy);
      if (i != tiles.count - 1) {
        bulk_wait_all_but_newest_read();
        mbar_arrive(ring.empty(last_stage));
      }
    }
    last_stage = stage;
    if (++stage == RING_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (tid == 0) bulk_wait_all();
}

// The generic route's dx: an elementwise grid-stride pass (no sum, so its
// order changes no result).
// Staged, the shared copies of edz and eydz are scaled by inv_count once;
// from global memory each use scales them (the same product).
template <typename T, int ACT, bool VEC, bool STAGED>
__global__ void __launch_bounds__(THREADS)
abn_backward_dx_kernel(const T* __restrict__ z, const T* __restrict__ dz, T* __restrict__ dx,
                       const float* __restrict__ bias_t, const float* __restrict__ weight_t,
                       const float* __restrict__ mul, const float* __restrict__ edz,
                       const float* __restrict__ eydz, long long m, int c, float slope,
                       float inv_count) {
  const float inv_slope = 1.f / slope;
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
        act_invert<ACT>(zv[k], dzv[k], slope, inv_slope, y, dy);
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
      act_invert<ACT>(to_f(z[i]), to_f(dz[i]), slope, inv_slope, y, dy);
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
  // (C up to the wrapper's MAX_C: the generic sums' grid has a slab of 32
  // channels along its y axis, at most 65,535)
  return m < 1 || c < 1 || c > GENERIC_SLAB * 65535 || act < LEAKY_RELU || act > NONE;
}

// The wrapper's partition: whole tiles of `tile_rows` rows dealt to `blocks`
// blocks, at least one tile each.
bool bad_partition(long long m, int tile_rows, int blocks) {
  return tile_rows < 1 || blocks < 1 || blocks > MAX_PARTITION_BLOCKS ||
         blocks > (m + tile_rows - 1) / tile_rows;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Vectors a consumer lane takes at most: two fp32 ones, or one bf16 one (two
// would not fit the dx kernel's registers).
template <typename T>
constexpr int max_cpt() { return sizeof(T) == 4 ? 2 : 1; }

// Bytes of dynamic shared memory of a ring block, or 0 where the ring route
// does not take the shape: rows of whole 16-byte vectors, at most max_cpt
// vectors a consumer lane (C up to 4096 in either type), tensors on a
// 16-byte boundary, and a ring that fits a block.
template <typename T>
size_t ring_smem(int c, int tile_rows, size_t& tile_stride, const void* a,
                 const void* b, const void* d = nullptr) {
  constexpr int V = Vec16<T>::N;
  const int nvec = c / V;
  if (c % V != 0 || nvec > max_cpt<T>() * RING_CONSUMERS || !aligned16(a) || !aligned16(b) ||
      (d != nullptr && !aligned16(d))) {
    return 0;
  }
  tile_stride = (static_cast<size_t>(tile_rows) * c * sizeof(T) + 127) / 128 * 128;
  const size_t buffers = 2 * static_cast<size_t>(RING_STAGES) * tile_stride;
  const int lanes = nvec <= RING_CONSUMERS ? RING_CONSUMERS / nvec : 1;
  const size_t reduction = 2 * static_cast<size_t>(lanes) * c * sizeof(float);
  const size_t smem = RING_BARRIER_BYTES + (buffers > reduction ? buffers : reduction);
  return smem <= MAX_RING_SMEM ? smem : 0;
}

// Lets `kernel` take up to MAX_RING_SMEM of dynamic shared memory: once a
// device (`allowed` is the kernel's own record of the devices done).
template <typename K>
int allow_ring_smem(K kernel, bool (&allowed)[64]) {
  int device = 0;
  if (int err = static_cast<int>(cudaGetDevice(&device))) return err;
  if (device < 64 && allowed[device]) return 0;
  const int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_RING_SMEM));
  if (!err && device < 64) allowed[device] = true;
  return err;
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

template <typename T, int ACT, int CPT>
int sums_ring(const T* z, const T* dz, const float* bias_t, const float* weight_t,
              float* part_edz, float* part_eydz, long long m, int c, int tile_rows, int blocks,
              size_t smem, size_t tile_stride, float slope, cudaStream_t s) {
  static bool allowed[64] = {};
  auto kernel = abn_sums_ring_kernel<T, ACT, CPT>;
  if (int err = allow_ring_smem(kernel, allowed)) return err;
  kernel<<<blocks, RING_THREADS, smem, s>>>(z, dz, bias_t, weight_t, part_edz, part_eydz, m, c,
                                            tile_rows, tile_stride, slope);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ACT, int CPT>
int dx_ring(const T* z, const T* dz, T* dx, const float* bias_t, const float* weight_t,
            const float* mul, const float* edz, const float* eydz, long long m, int c,
            int tile_rows, int blocks, size_t smem, size_t tile_stride, float slope,
            float inv_count, cudaStream_t s) {
  static bool allowed[64] = {};
  auto kernel = abn_dx_ring_kernel<T, ACT, CPT>;
  if (int err = allow_ring_smem(kernel, allowed)) return err;
  kernel<<<blocks, RING_THREADS, smem, s>>>(z, dz, dx, bias_t, weight_t, mul, edz, eydz, m, c,
                                            tile_rows, tile_stride, slope, inv_count);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ACT>
int sums_act(const void* z, const void* dz, const float* bias_t, const float* weight_t,
             float* edz, float* eydz, float* scratch, long long m, int c, float slope,
             bool training, int tile_rows, int blocks, cudaStream_t s) {
  int err = 0;
  if (!training) {
    if ((err = static_cast<int>(cudaMemsetAsync(edz, 0, c * sizeof(float), s)))) return err;
    return static_cast<int>(cudaMemsetAsync(eydz, 0, c * sizeof(float), s));
  }
  const T* zt = static_cast<const T*>(z);
  const T* dzt = static_cast<const T*>(dz);
  float* part_edz = scratch;
  float* part_eydz = scratch + static_cast<long long>(blocks) * c;
  size_t tile_stride = 0;
  const size_t smem = ring_smem<T>(c, tile_rows, tile_stride, z, dz);
  if (smem == 0) {
    const dim3 grid(blocks, (c + GENERIC_SLAB - 1) / GENERIC_SLAB);
    abn_sums_generic_kernel<T, ACT><<<grid, THREADS, 0, s>>>(
        zt, dzt, bias_t, weight_t, part_edz, part_eydz, m, c, tile_rows, slope);
    err = static_cast<int>(cudaGetLastError());
  } else if (c / Vec16<T>::N <= RING_CONSUMERS) {
    err = sums_ring<T, ACT, 1>(zt, dzt, bias_t, weight_t, part_edz, part_eydz, m, c,
                               tile_rows, blocks, smem, tile_stride, slope, s);
  } else if constexpr (max_cpt<T>() == 2) {
    err = sums_ring<T, ACT, 2>(zt, dzt, bias_t, weight_t, part_edz, part_eydz, m, c,
                               tile_rows, blocks, smem, tile_stride, slope, s);
  }
  if (err) return err;
  abn_sums_final_kernel<<<(c + FINAL_COLS - 1) / FINAL_COLS, FINAL_COLS * FINAL_GROUPS, 0, s>>>(
      part_edz, part_eydz, edz, eydz, blocks, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ACT>
int dx_act(const void* z, const void* dz, void* dx, const float* bias_t, const float* weight_t,
           const float* mul, const float* edz, const float* eydz, long long m, int c,
           float slope, float inv_count, int tile_rows, int blocks, cudaStream_t s) {
  const T* zt = static_cast<const T*>(z);
  const T* dzt = static_cast<const T*>(dz);
  T* dxt = static_cast<T*>(dx);
  size_t tile_stride = 0;
  const size_t ring = ring_smem<T>(c, tile_rows, tile_stride, z, dz, dx);
  if (ring != 0 && c / Vec16<T>::N <= RING_CONSUMERS) {
    return dx_ring<T, ACT, 1>(zt, dzt, dxt, bias_t, weight_t, mul, edz, eydz, m, c, tile_rows,
                              blocks, ring, tile_stride, slope, inv_count, s);
  }
  if constexpr (max_cpt<T>() == 2) {
    if (ring != 0) {
      return dx_ring<T, ACT, 2>(zt, dzt, dxt, bias_t, weight_t, mul, edz, eydz, m, c, tile_rows,
                                blocks, ring, tile_stride, slope, inv_count, s);
    }
  }
  const bool vec = vectorizable<T>(c, z, dz, dx);
  const int grid = elementwise_blocks(vec ? m * c / 4 : m * c);
  if (c <= STAGED_MAX_C) {
    const size_t smem = 5 * static_cast<size_t>(c) * sizeof(float);
    if (vec) {
      abn_backward_dx_kernel<T, ACT, true, true><<<grid, THREADS, smem, s>>>(
          zt, dzt, dxt, bias_t, weight_t, mul, edz, eydz, m, c, slope, inv_count);
    } else {
      abn_backward_dx_kernel<T, ACT, false, true><<<grid, THREADS, smem, s>>>(
          zt, dzt, dxt, bias_t, weight_t, mul, edz, eydz, m, c, slope, inv_count);
    }
  } else if (vec) {
    abn_backward_dx_kernel<T, ACT, true, false><<<grid, THREADS, 0, s>>>(
        zt, dzt, dxt, bias_t, weight_t, mul, edz, eydz, m, c, slope, inv_count);
  } else {
    abn_backward_dx_kernel<T, ACT, false, false><<<grid, THREADS, 0, s>>>(
        zt, dzt, dxt, bias_t, weight_t, mul, edz, eydz, m, c, slope, inv_count);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int sums(const void* z, const void* dz, const float* bias_t, const float* weight_t, float* edz,
         float* eydz, float* scratch, long long m, int c, int act, float slope, bool training,
         int tile_rows, int blocks, cudaStream_t s) {
  switch (act) {
    case LEAKY_RELU:
      return sums_act<T, LEAKY_RELU>(z, dz, bias_t, weight_t, edz, eydz, scratch, m, c, slope,
                                     training, tile_rows, blocks, s);
    case ELU:
      return sums_act<T, ELU>(z, dz, bias_t, weight_t, edz, eydz, scratch, m, c, slope,
                              training, tile_rows, blocks, s);
    default:
      return sums_act<T, NONE>(z, dz, bias_t, weight_t, edz, eydz, scratch, m, c, slope,
                               training, tile_rows, blocks, s);
  }
}

template <typename T>
int dx_pass(const void* z, const void* dz, void* dx, const float* bias_t, const float* weight_t,
            const float* mul, const float* edz, const float* eydz, long long m, int c, int act,
            float slope, float inv_count, int tile_rows, int blocks, cudaStream_t s) {
  switch (act) {
    case LEAKY_RELU:
      return dx_act<T, LEAKY_RELU>(z, dz, dx, bias_t, weight_t, mul, edz, eydz, m, c, slope,
                                   inv_count, tile_rows, blocks, s);
    case ELU:
      return dx_act<T, ELU>(z, dz, dx, bias_t, weight_t, mul, edz, eydz, m, c, slope,
                            inv_count, tile_rows, blocks, s);
    default:
      return dx_act<T, NONE>(z, dz, dx, bias_t, weight_t, mul, edz, eydz, m, c, slope,
                             inv_count, tile_rows, blocks, s);
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

// Bytes of scratch that abn_backward_sums needs in training mode for C
// channels over `blocks` blocks: one partial row of edz and of eydz a
// block (the caller allocates it; the kernels allocate nothing).
extern "C" long long abn_backward_scratch_bytes(int c, int blocks) {
  return 2 * static_cast<long long>(blocks) * c * static_cast<long long>(sizeof(float));
}

// edz, eydz (C,) fp32 from z, dz (M, C) of one type (fp32 or bf16) and bias_t,
// weight_t (C,) fp32: in training mode summed in a fixed order through
// `scratch`, over the wrapper's partition (`tile_rows` rows a tile, the tiles
// dealt to `blocks` blocks), in eval mode set to zero.
// Returns as abn_forward; also cudaErrorInvalidValue for a partition the
// shape cannot have or too little scratch.
extern "C" int abn_backward_sums(const void* z, const void* dz, const void* bias_t,
                                 const void* weight_t, void* edz, void* eydz, void* scratch,
                                 long long scratch_bytes, long long m, int c, int act,
                                 float slope, int training, int is_bf16, int tile_rows,
                                 int blocks, void* stream) {
  if (bad_shape(m, c, act) || bad_partition(m, tile_rows, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (training && scratch_bytes < abn_backward_scratch_bytes(c, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias_t);
  const float* w = static_cast<const float*>(weight_t);
  float* e = static_cast<float*>(edz);
  float* ey = static_cast<float*>(eydz);
  float* sc = static_cast<float*>(scratch);
  return is_bf16 ? sums<__nv_bfloat16>(z, dz, b, w, e, ey, sc, m, c, act, slope, training != 0,
                                       tile_rows, blocks, s)
                 : sums<float>(z, dz, b, w, e, ey, sc, m, c, act, slope, training != 0,
                               tile_rows, blocks, s);
}

// dx (M, C) in z's type from z, dz (M, C), bias_t, weight_t, mul (C,) fp32 and
// the sums edz, eydz (C,) fp32 (this call's, or summed over the ranks), with
// inv_count 1 / count in training mode and 0 in eval mode, over the same
// partition as abn_backward_sums.  Returns as abn_backward_sums.
extern "C" int abn_backward_dx(const void* z, const void* dz, void* dx, const void* bias_t,
                               const void* weight_t, const void* mul, const void* edz,
                               const void* eydz, long long m, int c, int act, float slope,
                               float inv_count, int is_bf16, int tile_rows, int blocks,
                               void* stream) {
  if (bad_shape(m, c, act) || bad_partition(m, tile_rows, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias_t);
  const float* w = static_cast<const float*>(weight_t);
  const float* mu = static_cast<const float*>(mul);
  const float* e = static_cast<const float*>(edz);
  const float* ey = static_cast<const float*>(eydz);
  return is_bf16 ? dx_pass<__nv_bfloat16>(z, dz, dx, b, w, mu, e, ey, m, c, act, slope,
                                          inv_count, tile_rows, blocks, s)
                 : dx_pass<float>(z, dz, dx, b, w, mu, e, ey, m, c, act, slope, inv_count,
                                  tile_rows, blocks, s);
}

extern "C" const char* abn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
