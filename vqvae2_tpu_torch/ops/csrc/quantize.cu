// Nearest-code search for vector quantization, written for Hopper (sm_90a).
//
// Replaces three TPU kernels of vqvae2_tpu/ops/quantize.py:
//   vq_nearest_ids     <- _quantize_kernel_ids      (indices only)
//   vq_nearest_lookup  <- _quantize_kernel_nostats  (indices and q = E[idx])
//   vq_nearest_stats   <- _quantize_kernel          (indices, q and the EMA statistics)
//
// What is computed, for x (N, D) and a codebook E (K, D):
//   score[n, k] = (2 * <x[n], E[k]> - |x[n]|^2) - |E[k]|^2      in true fp32
//   idx[n]      = argmax_k score[n, k]      (the first maximum wins)
//   q[n, :]     = E[idx[n], :]              (lookup and statistics flavours, in x's type)
//   csum[k]     = #{n : idx[n] == k}        (statistics flavour, fp32)
//   esum[k, :]  = sum of x[n] over idx[n] == k   (statistics flavour, fp32)
//
// What bounds it on this card: operations.  The product is 2*N*K*D flops of
// plain fp32 (TF32 would flip near-tie ids), which the CUDA cores do at about
// 67 TFLOP/s, while x in and idx/q out are a few hundred bytes a row: the time
// the memory needs is an order of magnitude below the time the FMAs need.  The
// statistics add N*D additions and one more read of x, which is memory work.
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
//
// The statistics are the search kernel (the lookup flavour, unchanged)
// followed by six small kernels of their own, not one fused kernel.  The TPU
// kernel sums them over a grid that runs in sequence; CUDA blocks run at once,
// and an atomicAdd of every row into esum[k, :] would serialise on the 64
// addresses of one code when an untrained encoder sends every row there.  So:
//   1. a histogram of the ids over chunks of 1024 rows (shared-memory integer
//      atomics: exact); the column sums over chunks are csum, exact;
//   2. prefix sums turn the histogram into each chunk's first slot in every
//      code's run of a stable counting sort, and count each code's pieces of
//      256 rows;
//   3. one warp a chunk scatters its row numbers into the sorted order, in row
//      order (__match_any_sync ranks the lanes that share a code);
//   4. one block a piece sums its 256 rows of one code in a fixed order;
//   5. one block a code sums its pieces in order.
// Every sum is taken in an order fixed by the ids alone, so esum is the same
// bit for bit from run to run, and no code gets more than one block's serial
// work per 256 of its rows.  Rows >= N are never counted (no pad rows, no
// correction).  K is at most 12288 (a histogram row of K ints in 48 KB of
// shared memory) and N below 2^31.

#include <climits>
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


// ---------------------------------------------------------------------------
// Statistics (steps 1-5 of the note at the top)
// ---------------------------------------------------------------------------

constexpr int HR = 1024;          // rows of a histogram chunk
constexpr int SP = 256;           // rows of one code summed by one block
constexpr int MAX_K_STATS = 12288;

__host__ __device__ constexpr long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Step 1: table[c][code] = rows of chunk c that took code.
__global__ void __launch_bounds__(256)
hist_kernel(const int* __restrict__ idx, int* __restrict__ table, long long n, int k) {
  extern __shared__ int h[];
  for (int c = threadIdx.x; c < k; c += blockDim.x) h[c] = 0;
  __syncthreads();
  const long long r0 = static_cast<long long>(blockIdx.x) * HR;
  for (int r = threadIdx.x; r < HR; r += blockDim.x) {
    if (r0 + r < n) atomicAdd(&h[idx[r0 + r]], 1);
  }
  __syncthreads();
  int* out = table + static_cast<long long>(blockIdx.x) * k;
  for (int c = threadIdx.x; c < k; c += blockDim.x) out[c] = h[c];
}

// Step 1 (end) and 2: per code, the table's column becomes its exclusive
// prefix over chunks; the column's total is the code's count and csum.
__global__ void __launch_bounds__(256)
column_scan_kernel(int* __restrict__ table, int* __restrict__ counts, float* __restrict__ csum,
                   int chunks, int k) {
  const int code = blockIdx.x * blockDim.x + threadIdx.x;
  if (code >= k) return;
  int run = 0;
  for (int c = 0; c < chunks; ++c) {
    int* p = table + static_cast<long long>(c) * k + code;
    const int v = *p;
    *p = run;
    run += v;
  }
  counts[code] = run;
  csum[code] = static_cast<float>(run);
}

// Step 2: exclusive prefix sums over the codes of the counts (each code's
// first slot in the sorted order) and of the pieces of SP rows (each code's
// first piece); piece_base[k] is the number of pieces.  One block.
__global__ void __launch_bounds__(1024)
code_scan_kernel(const int* __restrict__ counts, int* __restrict__ start,
                 int* __restrict__ piece_base, int k) {
  __shared__ int sa[1024], sb[1024];
  __shared__ int carry_a, carry_b;
  const int t = threadIdx.x;
  if (t == 0) carry_a = carry_b = 0;
  __syncthreads();
  for (int c0 = 0; c0 < k; c0 += 1024) {
    const int code = c0 + t;
    const int a = code < k ? counts[code] : 0;
    const int b = static_cast<int>(cdiv(a, SP));
    sa[t] = a;
    sb[t] = b;
    __syncthreads();
    for (int off = 1; off < 1024; off <<= 1) {   // inclusive scan, Hillis-Steele
      const int xa = t >= off ? sa[t - off] : 0;
      const int xb = t >= off ? sb[t - off] : 0;
      __syncthreads();
      sa[t] += xa;
      sb[t] += xb;
      __syncthreads();
    }
    if (code < k) {
      start[code] = carry_a + sa[t] - a;
      piece_base[code] = carry_b + sb[t] - b;
    }
    __syncthreads();
    if (t == 1023) {
      carry_a += sa[1023];
      carry_b += sb[1023];
    }
    __syncthreads();
  }
  if (t == 0) piece_base[k] = carry_b;
}

// Step 3: one warp a chunk writes its row numbers to their sorted slots, rows
// in order, so that the sort is stable.
__global__ void __launch_bounds__(32)
scatter_kernel(const int* __restrict__ idx, const int* __restrict__ table,
               const int* __restrict__ start, int* __restrict__ order, long long n, int k) {
  extern __shared__ int cursor[];
  const int lane = threadIdx.x;
  const int* first = table + static_cast<long long>(blockIdx.x) * k;
  for (int c = lane; c < k; c += 32) cursor[c] = start[c] + first[c];
  __syncwarp();
  const long long r0 = static_cast<long long>(blockIdx.x) * HR;
  for (int s = 0; s < HR; s += 32) {
    const long long row = r0 + s + lane;
    const bool live = row < n;
    const unsigned int active = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int code = idx[row];
      const unsigned int peers = __match_any_sync(active, code);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const int slot = cursor[code];
      __syncwarp(active);   // every peer has read the cursor before the first one moves it
      order[slot + rank] = static_cast<int>(row);
      if (rank == 0) cursor[code] = slot + __popc(peers);
    }
    __syncwarp();
  }
}

// The code whose pieces hold piece p: the last code c with piece_base[c] <= p
// (codes without rows have no pieces and are passed over).
__device__ __forceinline__ int code_of_piece(const int* piece_base, int k, int p) {
  int lo = 0, hi = k - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (piece_base[mid] <= p) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Step 4: one block a piece of SP sorted rows of one code.  Thread (lane,
// col) sums rows lane, lane + lanes, ... of the piece at columns 4*col..+3;
// then the lanes are summed in order.
template <typename XT>
__global__ void __launch_bounds__(256)
piece_sum_kernel(const XT* __restrict__ x, const int* __restrict__ order,
                 const int* __restrict__ start, const int* __restrict__ counts,
                 const int* __restrict__ piece_base, float* __restrict__ partial, int d, int k) {
  __shared__ float4 red[256];
  const int piece = blockIdx.x;
  if (piece >= piece_base[k]) return;   // the grid is an upper bound of the pieces
  const int code = code_of_piece(piece_base, k, piece);
  const int p0 = start[code] + (piece - piece_base[code]) * SP;
  const int p1 = min(start[code] + counts[code], p0 + SP);
  const int c4 = d / 4;
  for (int cb = 0; cb < c4; cb += 256) {
    const int cols = min(256, c4 - cb);
    const int lanes = 256 / cols;
    const int col = threadIdx.x % cols;
    const int lane = threadIdx.x / cols;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lane < lanes) {
      for (int p = p0 + lane; p < p1; p += lanes) {
        const float4 v = load4(x + static_cast<long long>(order[p]) * d + (cb + col) * 4);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < cols) {
      float4 s = red[threadIdx.x];
      for (int l = 1; l < lanes; ++l) {
        const float4 o = red[l * cols + threadIdx.x];
        s.x += o.x;
        s.y += o.y;
        s.z += o.z;
        s.w += o.w;
      }
      store4(partial + static_cast<long long>(piece) * d + (cb + threadIdx.x) * 4, s);
    }
    __syncthreads();
  }
}

// Step 5: one block a code sums its pieces in order (zero for a code without rows).
__global__ void code_sum_kernel(const float* __restrict__ partial, const int* __restrict__ piece_base,
                                float* __restrict__ esum, int d) {
  const int code = blockIdx.x;
  const int b0 = piece_base[code];
  const int b1 = piece_base[code + 1];
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int b = b0; b < b1; ++b) s += partial[static_cast<long long>(b) * d + c];
    esum[static_cast<long long>(code) * d + c] = s;
  }
}

// Scratch of the statistics: partial sums (floats), then the histogram table,
// counts, starts, piece bases and the sorted row order (ints).
struct StatsScratch {
  float* partial;
  int* table;
  int* counts;
  int* start;
  int* piece_base;
  int* order;
  long long bytes;
};

// With base == nullptr only .bytes is meaningful.
StatsScratch stats_scratch(void* base, long long n, int d, int k) {
  const long long pieces = cdiv(n, SP) + k;
  const long long chunks = cdiv(n, HR);
  StatsScratch s;
  char* p = static_cast<char*>(base);
  s.partial = reinterpret_cast<float*>(p);
  long long off = pieces * d * 4;
  s.table = reinterpret_cast<int*>(p + off);
  off += chunks * k * 4;
  s.counts = reinterpret_cast<int*>(p + off);
  off += static_cast<long long>(k) * 4;
  s.start = reinterpret_cast<int*>(p + off);
  off += static_cast<long long>(k) * 4;
  s.piece_base = reinterpret_cast<int*>(p + off);
  off += static_cast<long long>(k + 1) * 4;
  s.order = reinterpret_cast<int*>(p + off);
  off += n * 4;
  s.bytes = off;
  return s;
}

template <typename XT>
int launch_stats(const void* x, const void* embed, void* idx, void* q, float* csum, float* esum,
                 void* scratch, long long n, int d, int k, cudaStream_t stream) {
  int err = launch<XT, true>(x, embed, idx, q, n, d, k, stream);
  if (err) return err;
  const StatsScratch s = stats_scratch(scratch, n, d, k);
  const int* ids = static_cast<const int*>(idx);
  const unsigned int chunks = static_cast<unsigned int>(cdiv(n, HR));
  const size_t hist_bytes = static_cast<size_t>(k) * sizeof(int);
  hist_kernel<<<chunks, 256, hist_bytes, stream>>>(ids, s.table, n, k);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  column_scan_kernel<<<static_cast<unsigned int>(cdiv(k, 256)), 256, 0, stream>>>(
      s.table, s.counts, csum, static_cast<int>(chunks), k);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  code_scan_kernel<<<1, 1024, 0, stream>>>(s.counts, s.start, s.piece_base, k);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  scatter_kernel<<<chunks, 32, hist_bytes, stream>>>(ids, s.table, s.start, s.order, n, k);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  piece_sum_kernel<XT><<<static_cast<unsigned int>(cdiv(n, SP) + k), 256, 0, stream>>>(
      static_cast<const XT*>(x), s.order, s.start, s.counts, s.piece_base, s.partial, d, k);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const int threads = d >= 256 ? 256 : static_cast<int>(cdiv(d, 32) * 32);
  code_sum_kernel<<<static_cast<unsigned int>(k), threads, 0, stream>>>(
      s.partial, s.piece_base, esum, d);
  return static_cast<int>(cudaGetLastError());
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

// Bytes of scratch that vq_nearest_stats needs for this shape (the caller
// allocates it; the kernels allocate nothing).
extern "C" long long vq_stats_scratch_bytes(long long n, int d, int k) {
  return stats_scratch(nullptr, n, d, k).bytes;
}

// idx and q as vq_nearest_lookup, and csum (K,) and esum (K, D) in fp32.
// Returns cudaGetLastError() after the last launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernels do not take or too little
// scratch.  Launches on the given stream and does not synchronise.
extern "C" int vq_nearest_stats(const void* x, const void* embed, void* idx, void* q, void* csum,
                                void* esum, void* scratch, long long scratch_bytes, long long n,
                                int d, int k, int x_is_bf16, void* stream) {
  if (bad_shape(n, d, k) || k > MAX_K_STATS || n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (scratch_bytes < stats_scratch(nullptr, n, d, k).bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* cs = static_cast<float*>(csum);
  float* es = static_cast<float*>(esum);
  return x_is_bf16
             ? launch_stats<__nv_bfloat16>(x, embed, idx, q, cs, es, scratch, n, d, k, s)
             : launch_stats<float>(x, embed, idx, q, cs, es, scratch, n, d, k, s);
}

extern "C" const char* vq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
