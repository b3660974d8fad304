// Measurements of the card behind the design of the attention kernels' tensor-
// core products (csrc/flash_attention.cu), run by chip_smoke.py's phase
// `probe`; no kernel of the port calls anything here.
//
//   tcp_mma      mma.sync m16n8k8 TF32 throughput: `chains` independent
//                accumulators a warp, `iters` mma each
//   tcp_split    rate of the TF32 split's rounding: cvt.rna.tf32.f32 (which=1)
//                against the integer add-and-mask (which=0), 8 values a thread
//   tcp_accumulate  one mma adding tiny * 1 to an accumulator holding big:
//                out[0] is what the tensor cores return, out[1] the fp32 sum
//                rounded to nearest (they differ when the tensor cores
//                truncate)
// Each returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned int (&a)[4],
                                         const unsigned int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int CHAINS>
__global__ void mma_rate_kernel(float* out, int iters) {
  const unsigned int a[4] = {0x3f800000u, 0x3f800000u, 0x3f800000u, 0x3f800000u};
  const unsigned int b[2] = {0x3c000000u + threadIdx.x, 0x3c000000u};
  float c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) mma_tf32(c[k], a, b);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <bool CVT>
__global__ void split_rate_kernel(float* out, int iters) {
  float x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = 1.5f + threadIdx.x * 1e-3f + k;
  unsigned int acc = 0;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      unsigned int h;
      if (CVT) {
        asm volatile("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(x[k]));
      } else {
        h = (__float_as_uint(x[k]) + 0x1000u) & 0xffffe000u;
      }
      acc ^= h;
      x[k] += 1.0f;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<float>(acc);
}

__global__ void accumulate_kernel(float* out, float big, float tiny) {
  // A has ones in column k = 0 only and B = tiny in row k = 0: D = big + tiny
  const int t = threadIdx.x & 3;
  const unsigned int a[4] = {t == 0 ? 0x3f800000u : 0u, t == 0 ? 0x3f800000u : 0u, 0u, 0u};
  const unsigned int b[2] = {t == 0 ? __float_as_uint(tiny) : 0u, 0u};
  float c[4] = {big, big, big, big};
  mma_tf32(c, a, b);
  if (threadIdx.x == 0) {
    out[0] = c[0];
    out[1] = big + __uint_as_float(__float_as_uint(tiny) & 0xffffe000u);
  }
}

}  // namespace

extern "C" int tcp_mma(float* out, int blocks, int threads, int iters, int chains) {
  if (chains == 1) {
    mma_rate_kernel<1><<<blocks, threads>>>(out, iters);
  } else if (chains == 4) {
    mma_rate_kernel<4><<<blocks, threads>>>(out, iters);
  } else {
    mma_rate_kernel<8><<<blocks, threads>>>(out, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tcp_split(float* out, int blocks, int threads, int iters, int which) {
  if (which) {
    split_rate_kernel<true><<<blocks, threads>>>(out, iters);
  } else {
    split_rate_kernel<false><<<blocks, threads>>>(out, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tcp_accumulate(float* out, float big, float tiny) {
  accumulate_kernel<<<1, 32>>>(out, big, tiny);
  return static_cast<int>(cudaGetLastError());
}
