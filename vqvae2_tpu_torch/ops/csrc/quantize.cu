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
// What the design does about it: a register-tiled fp32 product on the CUDA
// cores, fed from shared memory without a trip through registers.
// * A prologue kernel writes the codebook transposed, E^T (D, Kpad) with Kpad
//   the next multiple of 128 and zero columns past K, and |E|^2 of every code
//   (an fp32 FMA chain over d in order) into a small scratch buffer: once a
//   launch, not once a block and chunk.  A block takes 32 codes: it reads
//   their rows 16 bytes a thread, four pieces of 32 features in flight at
//   once, transposes them through shared memory and stores E^T a whole
//   32-code row segment a warp; one thread a code runs the norm's chain from
//   shared memory.
// * A block of 256 threads owns 128 rows.  Its x tile (128 rows by D,
//   transposed, widened to fp32) is staged once and stays resident in dynamic
//   shared memory for its walk over the codebook (32 KB at D = 64, 128 KB at
//   D = 256), with |x|^2 of each row (the same kind of chain).  Above
//   X_RESIDENT_MAX_D features it does not fit beside the codebook ring: the x
//   pieces then go through a ring of their own, each staged one step ahead
//   of its use.
// * The block walks the codebook in chunks of 128 codes and the feature axis
//   in pieces of 16.  Each (chunk, piece) of E^T is a contiguous 16 x 128
//   block: cp.async copies it straight into a three-deep ring in shared memory
//   in the layout the micro-tile reads, two steps ahead of its use, with one
//   barrier a piece.
// * Each thread keeps an 8x8 tile of dot products in registers (64 FMAs for
//   four 16-byte shared loads).  After each chunk it takes its best of 8 codes
//   a row, the 16 threads that share a row merge theirs with shuffles,
//   comparing (score, idx) so that equal scores keep the lower index, as
//   argmax does, and the chunk's best replaces the row's running best (in
//   shared memory) only if strictly larger.  So no per-row state stays in
//   registers across chunks (no spill at 128 registers, two blocks an SM up
//   to D = 64, one at D = 256), and nothing of size (N, K) exists anywhere.
// * The split.  A grid of one block a row tile fills the card only when the
//   rows are many: at D = 256 one 128-row block fits on an SM (152 KB of
//   shared memory), and the deep adaptor's 2,592 rows make 21 blocks for 132
//   SMs, each walking all 512 codes.  So the wrapper may also split the
//   codebook walk into S ranges of whole chunks (range r takes chunks
//   [r*C/S, (r+1)*C/S) of C): block (tile, r) walks only its range with the
//   loop above and writes each row's best (score, index) of the range to
//   scratch; a merge kernel then takes, row by row and range by range in
//   rising order, a range's best only if strictly larger.  Both the rule
//   within a block and the merge keep the first maximum, and every score is
//   the same bits wherever it is computed, so the merged ids are the unsplit
//   kernel's for every split; the merge then gathers q.  With S = 1 (the
//   stage-1 shapes: thousands of row tiles) the search kernel writes ids and
//   q itself and no merge runs, as before the split existed.
// Every code's score is the same sequence of operations wherever it lies in a
// tile or range: the dot product an FMA chain over d in order, then (2 * dot -
// |x|^2) - |E|^2; so duplicated codebook rows tie exactly and the lower index
// wins.  No TF32 and no tensor cores: their truncating fp32 sums would move
// scores by more than the near-tie tolerance.  The lookup is an exact row
// gather from the codebook.  N and K are runtime values and their ragged tails
// are masked; D is a multiple of 4 here (16-byte loads): the Python wrapper
// pads the feature axis of x and E with zeros for any other D, which leaves
// every dot product and norm bit for bit as it was (an FMA of 0 * 0 onto s
// gives s).
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
constexpr int DC = 16;    // features in a piece
constexpr int NT = 256;   // threads: 16 along the rows x 16 along the codes
constexpr int STAGES = 3; // depth of the codebook ring (and of the x ring when x is not resident)
static_assert(TN == KC && TN * 2 == NT, "the norm pass maps one thread to one row");
constexpr int CPT = DC * KC / 4 / NT;   // 16-byte copies of a thread a piece
static_assert(CPT * NT * 4 == DC * KC && KC == TN, "whole copies a thread");
// Beyond this D the resident x tile and the ring exceed the 227 KB a block may
// use (2 KB kept for the static arrays).
constexpr int X_RESIDENT_MAX_D = (232448 - 2048 - STAGES * DC * KC * 4) / (TN * 4) / DC * DC;

__host__ __device__ constexpr long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes global -> shared without a register trip; a copy whose `in` is
// false reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most one group (the one committed last) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Rows (or codes) of a thread's 8-wide strip: 4 neighbours in each half of the
// tile, so that a 16-byte shared load of neighbouring threads hits
// neighbouring banks.
__device__ __forceinline__ int strip(int t, int i) {
  return (i < 4) ? (t * 4 + i) : (TN / 2 + t * 4 + (i - 4));
}

// Codes padded to whole chunks: the row length of E^T.
__host__ __device__ inline int padded_codes(int k) { return static_cast<int>(cdiv(k, KC) * KC); }

// Scratch of the search: E^T (D, Kpad) and |E|^2 (Kpad,), floats; with a
// split (ranges > 1) also each range's best score (floats) and index (ints)
// of every row, range-major; rounded up to whole 256 bytes.
__host__ inline long long search_scratch_bytes(long long n, int d, int k, int ranges) {
  const long long bytes = (static_cast<long long>(d) + 1) * padded_codes(k) * 4 +
                          (ranges > 1 ? ranges * n * 8 : 0);
  return cdiv(bytes, 256) * 256;
}

constexpr int PC = 32;    // codes of a prologue block
constexpr int PF = 32;    // features of a prologue piece
constexpr int PU = 4;     // pieces a prologue thread has in flight

// The prologue: et[c][code] = E[code][c] and ee[code] = |E[code]|^2 (an FMA
// chain over c in order), zeros for the padding codes.  One block of 256
// threads a 32 codes: each round reads PU pieces of 32 features of their rows
// (one 16-byte load a thread a piece, all in flight together) into shared
// memory, stores them transposed (a warp a 32-code segment of an E^T row),
// and the first warp carries each code's chain on, a thread a code.
__global__ void __launch_bounds__(256)
codebook_prep_kernel(const float* __restrict__ embed, float* __restrict__ et,
                     float* __restrict__ ee, int d, int k, int kpad) {
  __shared__ float tile[PU][PC][PF + 1];
  const int t = threadIdx.x;
  const int code0 = blockIdx.x * PC;
  const int lc = t / (PF / 4);         // the code this thread loads
  const int lf = (t % (PF / 4)) * 4;   // ... at these four features of a piece
  const int wc = t % PC;               // the code this thread stores
  const bool live = code0 + lc < k;
  const float* row = embed + static_cast<long long>(code0 + lc) * d;
  float sq = 0.f;
  for (int d0 = 0; d0 < d; d0 += PU * PF) {
    float4 v[PU];
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      const int f = d0 + u * PF + lf;
      v[u] = (live && f < d) ? load4(row + f) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      tile[u][lc][lf + 0] = v[u].x;
      tile[u][lc][lf + 1] = v[u].y;
      tile[u][lc][lf + 2] = v[u].z;
      tile[u][lc][lf + 3] = v[u].w;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      for (int f = t / PC; f < PF; f += 256 / PC) {
        const int c = d0 + u * PF + f;
        if (c < d) et[static_cast<long long>(c) * kpad + code0 + wc] = tile[u][wc][f];
      }
    }
    if (t < PC) {
      for (int u = 0; u < PU; ++u) {
        for (int f = 0; f < PF && d0 + u * PF + f < d; ++f) {
          sq = fmaf(tile[u][t][f], tile[u][t][f], sq);
        }
      }
    }
    __syncthreads();
  }
  if (t < PC) ee[code0 + t] = sq;
}

// Dynamic shared memory of a search block: the x tile (resident: all of D,
// padded to whole pieces; else a ring of pieces) and the codebook ring.
__host__ inline size_t search_smem_bytes(int d, bool resident) {
  const long long x_floats = resident ? cdiv(d, DC) * DC * TN : static_cast<long long>(STAGES) * DC * TN;
  return static_cast<size_t>((x_floats + static_cast<long long>(STAGES) * DC * KC) * 4);
}

// Without SPLIT: block x owns rows [x*TN, x*TN + TN) and walks every code; it
// writes idx (and with WITH_Q, q).  With SPLIT: block (x, r) walks only the
// chunks of range r of gridDim.y and writes its rows' best score and index of
// the range to part_s / part_i [r][row].
template <typename XT, bool WITH_Q, bool SPLIT, bool RESIDENT>
__global__ void __launch_bounds__(NT, 2)
nearest_code_kernel(const XT* __restrict__ x, const float* __restrict__ embed,
                    const float* __restrict__ et, const float* __restrict__ ee,
                    int* __restrict__ idx_out, XT* __restrict__ q_out,
                    float* __restrict__ part_s, int* __restrict__ part_i, long long n, int d, int k,
                    int kpad) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float xx_s[TN];     // |x|^2 of each row
  __shared__ float run_s[TN];    // best score of each row so far
  __shared__ int run_i[TN];      // ... and its code

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // along the codes
  const int ty = tid >> 4;   // along the rows
  const long long row0 = static_cast<long long>(blockIdx.x) * TN;
  const int pieces = static_cast<int>(cdiv(d, DC));
  float* xs = smem;                                                   // [.][DC or D][TN]
  float* es = smem + (RESIDENT ? pieces * DC : STAGES * DC) * TN;     // [STAGES][DC][KC]
  // This block's codes [k_begin, k_end): whole chunks, every code without SPLIT.
  const long long chunks = kpad / KC;
  const int k_begin = SPLIT ? static_cast<int>(blockIdx.y * chunks / gridDim.y * KC) : 0;
  const int k_end = SPLIT ? static_cast<int>(min(static_cast<long long>(k),
                                                 (blockIdx.y + 1) * chunks / gridDim.y * KC))
                          : k;

  // The E^T piece (codes e_k0 .., features e_d0 ..) into ring slot e_slot;
  // then the next step's (chunk-major, pieces in order).
  int e_k0 = k_begin, e_d0 = 0, e_slot = 0;
  auto stage_e = [&]() {
    if (e_k0 < k_end) {
      float* dst = es + e_slot * DC * KC;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int f = tid + i * NT;
        const int dd = f / (KC / 4);
        const int c = (f % (KC / 4)) * 4;
        const bool in = e_d0 + dd < d;
        cp_async16(dst + dd * KC + c,
                   in ? et + static_cast<long long>(e_d0 + dd) * kpad + e_k0 + c : et, in);
      }
    }
    cp_async_commit();
    e_slot = e_slot == STAGES - 1 ? 0 : e_slot + 1;
    e_d0 += DC;
    if (e_d0 >= pieces * DC) {
      e_d0 = 0;
      e_k0 += KC;
    }
  };
  // The x piece at features d0 (rows row0 .., zero outside x) into dst,
  // transposed: neighbouring threads store neighbouring rows (no conflicts).
  auto stage_x = [&](float* dst, int d0) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int f = tid + i * NT;
      const int r = f % TN;
      const int c = (f / TN) * 4;
      const long long row = row0 + r;
      const float4 v = (row < n && d0 + c < d) ? load4(x + row * d + d0 + c)
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
      dst[(c + 0) * TN + r] = v.x;
      dst[(c + 1) * TN + r] = v.y;
      dst[(c + 2) * TN + r] = v.z;
      dst[(c + 3) * TN + r] = v.w;
    }
  };

  stage_e();
  stage_e();
  if (tid < TN) {
    run_s[tid] = -INFINITY;
    run_i[tid] = 0x7fffffff;
  }
  if (RESIDENT) {
    for (int p = 0; p < pieces; ++p) stage_x(xs + p * DC * TN, p * DC);
    __syncthreads();
    if (tid < TN) {
      float xx = 0.f;
      for (int dd = 0; dd < pieces * DC; ++dd) xx = fmaf(xs[dd * TN + tid], xs[dd * TN + tid], xx);
      xx_s[tid] = xx;
    }
  } else {
    if (tid < TN) {
      float xx = 0.f;
      const long long row = row0 + tid;
      if (row < n) {
        for (int c = 0; c < d; ++c) {
          const float v = to_float(x[row * d + c]);
          xx = fmaf(v, v, xx);
        }
      }
      xx_s[tid] = xx;
    }
    stage_x(xs, 0);
  }

  int slot = 0;   // ring slot of the current step
  for (int k0 = k_begin; k0 < k_end; k0 += KC) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int p = 0; p < pieces; ++p) {
      cp_async_wait_one();
      __syncthreads();   // this step's pieces are in; every thread is done with the last step
      stage_e();         // two steps ahead, into the slot the last step used
      const int next = slot == STAGES - 1 ? 0 : slot + 1;
      if (!RESIDENT && (p + 1 < pieces || k0 + KC < k_end)) {
        // the next step's x piece, into the slot the step before last used
        stage_x(xs + next * DC * TN, p + 1 < pieces ? (p + 1) * DC : 0);
      }
      const float* xp = xs + (RESIDENT ? p : slot) * DC * TN;
      const float* ep = es + slot * DC * KC;
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) {
        const float4 a0 = *reinterpret_cast<const float4*>(xp + dd * TN + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(xp + dd * TN + TN / 2 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(ep + dd * KC + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(ep + dd * KC + KC / 2 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      slot = next;
    }

    // Fold this chunk into each row's running best.  A thread visits its
    // codes in rising order and only a strictly larger score replaces, so it
    // keeps its first maximum; the 16 threads that share a row (a half warp)
    // merge theirs by (score, index), the lower index winning among equal
    // scores; the chunk's best replaces the running one only if strictly
    // larger, since earlier chunks hold lower indices.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xr = xx_s[strip(ty, i)];
      float best = -INFINITY;
      int bidx = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int code = k0 + strip(tx, j);
        const float sc = (2.0f * acc[i][j] - xr) - __ldg(ee + code);
        if (code < k && sc > best) {
          best = sc;
          bidx = code;
        }
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
        if (os > best || (os == best && oi < bidx)) {
          best = os;
          bidx = oi;
        }
      }
      const int row = strip(ty, i);
      if (tx == 0 && best > run_s[row]) {
        run_s[row] = best;
        run_i[row] = bidx;
      }
    }
  }
  __syncthreads();

  if (SPLIT) {
    if (tid < TN && row0 + tid < n) {
      const long long at = static_cast<long long>(blockIdx.y) * n + row0 + tid;
      part_s[at] = run_s[tid];
      part_i[at] = run_i[tid];
    }
    return;
  }

  if (tid < TN && row0 + tid < n) idx_out[row0 + tid] = run_i[tid] < k ? run_i[tid] : 0;

  if (WITH_Q) {
    const int d4 = d / 4;
    for (int f = tid; f < TN * d4; f += NT) {
      const int r = f / d4;
      const int c = (f % d4) * 4;
      const long long row = row0 + r;
      if (row < n) {
        const int code = run_i[r] < k ? run_i[r] : 0;
        const float4 v = load4(embed + static_cast<long long>(code) * d + c);
        store4(q_out + row * d + c, v);
      }
    }
  }
}

constexpr int MR = 32;   // rows of a merge block

// The merge of a split search: each row's best over the ranges, taken in
// rising order and only where strictly larger (the first maximum, as within a
// block), then (WITH_Q) q gathered from the codebook.  256 threads a MR rows.
template <typename XT, bool WITH_Q>
__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
             const float* __restrict__ embed, int* __restrict__ idx_out, XT* __restrict__ q_out,
             long long n, int d, int k, int ranges) {
  __shared__ int ids[MR];
  const long long row0 = static_cast<long long>(blockIdx.x) * MR;
  if (threadIdx.x < MR) {
    const long long row = row0 + threadIdx.x;
    int bidx = 0;
    if (row < n) {
      float best = -INFINITY;
      bidx = 0x7fffffff;
      for (int r = 0; r < ranges; ++r) {
        const float s = part_s[r * n + row];
        if (s > best) {
          best = s;
          bidx = part_i[r * n + row];
        }
      }
      bidx = bidx < k ? bidx : 0;
      idx_out[row] = bidx;
    }
    ids[threadIdx.x] = bidx;
  }
  if (WITH_Q) {
    __syncthreads();
    const int d4 = d / 4;
    for (int f = threadIdx.x; f < MR * d4; f += 256) {
      const int r = f / d4;
      const int c = (f % d4) * 4;
      const long long row = row0 + r;
      if (row < n) {
        store4(q_out + row * d + c, load4(embed + static_cast<long long>(ids[r]) * d + c));
      }
    }
  }
}

template <typename XT, bool WITH_Q, bool SPLIT, bool RESIDENT>
int launch_search(const void* x, const void* embed, const float* et, const float* ee, void* idx,
                  void* q, float* part_s, int* part_i, long long n, int d, int k, int ranges,
                  cudaStream_t stream) {
  auto kernel = nearest_code_kernel<XT, WITH_Q, SPLIT, RESIDENT>;
  const size_t smem = search_smem_bytes(d, RESIDENT);
  // set once per variant to the most any D of this variant needs
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(search_smem_bytes(RESIDENT ? X_RESIDENT_MAX_D : DC, RESIDENT)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned int>(cdiv(n, TN)), static_cast<unsigned int>(ranges));
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const float*>(embed), et, ee, static_cast<int*>(idx),
      static_cast<XT*>(q), part_s, part_i, n, d, k, padded_codes(k));
  return static_cast<int>(cudaGetLastError());
}

// The search kernel, x resident where it fits beside the ring, else in a ring of its own.
template <typename XT, bool WITH_Q, bool SPLIT>
int launch_by_width(const void* x, const void* embed, const float* et, const float* ee,
                    void* idx, void* q, float* part_s, int* part_i, long long n, int d, int k,
                    int ranges, cudaStream_t stream) {
  return d <= X_RESIDENT_MAX_D
             ? launch_search<XT, WITH_Q, SPLIT, true>(x, embed, et, ee, idx, q, part_s, part_i, n,
                                                      d, k, ranges, stream)
             : launch_search<XT, WITH_Q, SPLIT, false>(x, embed, et, ee, idx, q, part_s, part_i,
                                                       n, d, k, ranges, stream);
}

// The prologue, the search and, with a split (ranges > 1), the merge.
// `scratch` holds search_scratch_bytes(n, d, k, ranges).
template <typename XT, bool WITH_Q>
int launch(const void* x, const void* embed, void* scratch, void* idx, void* q, long long n, int d,
           int k, int ranges, cudaStream_t stream) {
  const int kpad = padded_codes(k);
  float* et = static_cast<float*>(scratch);
  float* ee = et + static_cast<long long>(d) * kpad;
  codebook_prep_kernel<<<static_cast<unsigned int>(kpad / PC), 256, 0, stream>>>(
      static_cast<const float*>(embed), et, ee, d, k, kpad);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (ranges == 1) {
    return launch_by_width<XT, WITH_Q, false>(x, embed, et, ee, idx, q, nullptr, nullptr, n, d,
                                              k, 1, stream);
  }
  float* part_s = ee + kpad;
  int* part_i = reinterpret_cast<int*>(part_s + ranges * n);
  err = launch_by_width<XT, false, true>(x, embed, et, ee, nullptr, nullptr, part_s, part_i, n,
                                         d, k, ranges, stream);
  if (err) return err;
  merge_kernel<XT, WITH_Q><<<static_cast<unsigned int>(cdiv(n, MR)), 256, 0, stream>>>(
      part_s, part_i, static_cast<const float*>(embed), static_cast<int*>(idx),
      static_cast<XT*>(q), n, d, k, ranges);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(long long n, int d, int k, int ranges) {
  return n < 1 || d < 4 || d % 4 != 0 || k < 1 || k > INT_MAX - KC || ranges < 1 ||
         ranges > cdiv(k, KC) || ranges > 65535 || cdiv(n, TN) > 2147483647LL;
}

// ---------------------------------------------------------------------------
// Statistics (steps 1-5 of the note at the top)
// ---------------------------------------------------------------------------

constexpr int HR = 1024;          // rows of a histogram chunk
constexpr int SP = 256;           // rows of one code summed by one block
constexpr int MAX_K_STATS = 12288;

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

// Scratch of the statistics: the search's (E^T and |E|^2), partial sums
// (floats), then the histogram table, counts, starts, piece bases and the
// sorted row order (ints).
struct StatsScratch {
  float* search;
  float* partial;
  int* table;
  int* counts;
  int* start;
  int* piece_base;
  int* order;
  long long bytes;
};

// With base == nullptr only .bytes is meaningful.
StatsScratch stats_scratch(void* base, long long n, int d, int k, int ranges) {
  const long long pieces = cdiv(n, SP) + k;
  const long long chunks = cdiv(n, HR);
  StatsScratch s;
  char* p = static_cast<char*>(base);
  s.search = reinterpret_cast<float*>(p);
  long long off = search_scratch_bytes(n, d, k, ranges);
  s.partial = reinterpret_cast<float*>(p + off);
  off += pieces * d * 4;
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
                 void* scratch, long long n, int d, int k, int ranges, cudaStream_t stream) {
  const StatsScratch s = stats_scratch(scratch, n, d, k, ranges);
  int err = launch<XT, true>(x, embed, s.search, idx, q, n, d, k, ranges, stream);
  if (err) return err;
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

// `ranges` (1 up to the number of 128-code chunks) is the number of ranges
// the codebook walk is split into, as vqvae2_tpu_torch/ops/quantize.py's
// search_split picks it; every value gives the same ids and q.

// Bytes of scratch that vq_nearest_ids and vq_nearest_lookup need for this
// shape and split (the codebook transposed, its norms and the ranges' bests;
// the caller allocates it).
extern "C" long long vq_search_scratch_bytes(long long n, int d, int k, int ranges) {
  return search_scratch_bytes(n, d, k, ranges);
}

// Both return cudaGetLastError() after the last launch (0 on success), or
// cudaErrorInvalidValue for a shape or split the kernels do not take or too
// little scratch.  They launch on the given stream and do not synchronise.
extern "C" int vq_nearest_ids(const void* x, const void* embed, void* idx, void* scratch,
                              long long scratch_bytes, long long n, int d, int k, int x_is_bf16,
                              int ranges, void* stream) {
  if (bad_shape(n, d, k, ranges) || scratch_bytes < search_scratch_bytes(n, d, k, ranges)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16
             ? launch<__nv_bfloat16, false>(x, embed, scratch, idx, nullptr, n, d, k, ranges, s)
             : launch<float, false>(x, embed, scratch, idx, nullptr, n, d, k, ranges, s);
}

extern "C" int vq_nearest_lookup(const void* x, const void* embed, void* idx, void* q,
                                 void* scratch, long long scratch_bytes, long long n, int d, int k,
                                 int x_is_bf16, int ranges, void* stream) {
  if (bad_shape(n, d, k, ranges) || scratch_bytes < search_scratch_bytes(n, d, k, ranges)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16, true>(x, embed, scratch, idx, q, n, d, k, ranges, s)
                   : launch<float, true>(x, embed, scratch, idx, q, n, d, k, ranges, s);
}

// Bytes of scratch that vq_nearest_stats needs for this shape and split (the
// caller allocates it; the kernels allocate nothing).
extern "C" long long vq_stats_scratch_bytes(long long n, int d, int k, int ranges) {
  return stats_scratch(nullptr, n, d, k, ranges).bytes;
}

// idx and q as vq_nearest_lookup, and csum (K,) and esum (K, D) in fp32.
// Returns cudaGetLastError() after the last launch (0 on success), or
// cudaErrorInvalidValue for a shape or split the kernels do not take or too
// little scratch.  Launches on the given stream and does not synchronise.
extern "C" int vq_nearest_stats(const void* x, const void* embed, void* idx, void* q, void* csum,
                                void* esum, void* scratch, long long scratch_bytes, long long n,
                                int d, int k, int x_is_bf16, int ranges, void* stream) {
  if (bad_shape(n, d, k, ranges) || k > MAX_K_STATS || n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (scratch_bytes < stats_scratch(nullptr, n, d, k, ranges).bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* cs = static_cast<float*>(csum);
  float* es = static_cast<float*>(esum);
  return x_is_bf16
             ? launch_stats<__nv_bfloat16>(x, embed, idx, q, cs, es, scratch, n, d, k, ranges, s)
             : launch_stats<float>(x, embed, idx, q, cs, es, scratch, n, d, k, ranges, s);
}

extern "C" const char* vq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
