// Back-substitution sweep in two scratch layouts (probe kernel of
// picaso_tpu_torch/probes/sweep_layout_probe.py).
//
// Replaces the TPU probe kernel run / _kernel of
// scripts/sweep_layout_probe.py:31-80, which compared a [nlayer, N] row
// scratch with an (8, 128)-packed one for the sequential layer sweeps of
// the RT kernels.  The packed layout answers a Mosaic vreg question with
// no CUDA meaning; the question here is where the per-layer values of a
// column live while its thread sweeps them:
//   rows   (staged = 0): every step reads b, c, d from and writes out to
//          global memory [nlayer, ncol] -- the [slot, row, nwno] scratch
//          that K2-K6 and the SH kernels use today;
//   staged (staged = 1): a block first copies its [nlayer, tile] slices
//          of b, c, d into shared memory with coalesced loads, sweeps
//          there, and writes its out slice back once.
// One thread per column in both.  The recursion (_step_rows) runs bottom
// to top from the carry (1.0, 0.5):
//   x = 1 / (b - c * as);  as' = d * x;  ds' = (d - c * ds) * x
//   y = 1 / (b + c * as'); as = d * y;   ds = (d - b * ds') * y; out = ds
// Both layouts see the same data in the same places and do the same
// arithmetic in the same order as the twin (sweep_plain), so they are
// compared elementwise.
//
// What bounds it: bytes (3 inputs read once, 1 output written once; 2
// divides and 8 mul/add per element); the staged layout trades the
// latency hiding of many resident warps for shared memory, which caps the
// blocks per SM at 227 KB / (16 * nlayer * tile) bytes.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float step(float bb, float cc, float dd,
                                      float& as_n, float& ds_n) {
  const float x = 1.0f / (bb - cc * as_n);
  const float as_o = dd * x;
  const float ds_o = (dd - cc * ds_n) * x;
  const float y = 1.0f / (bb + cc * as_o);
  as_n = dd * y;
  ds_n = (dd - bb * ds_o) * y;
  return ds_n;
}

__global__ void sweep_rows_kernel(const float* __restrict__ b,
                                  const float* __restrict__ c,
                                  const float* __restrict__ d,
                                  float* __restrict__ out, int nlayer,
                                  int ncol) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= ncol) return;
  float as_n = 1.0f, ds_n = 0.5f;
  for (int l = nlayer - 1; l >= 0; --l) {
    const long long k = (long long)l * ncol + n;
    out[k] = step(b[k], c[k], d[k], as_n, ds_n);
  }
}

__global__ void sweep_staged_kernel(const float* __restrict__ b,
                                    const float* __restrict__ c,
                                    const float* __restrict__ d,
                                    float* __restrict__ out, int nlayer,
                                    int ncol) {
  extern __shared__ float smem[];  // 4 x [nlayer, tile]
  const int tile = blockDim.x;
  float* s_b = smem;
  float* s_c = s_b + nlayer * tile;
  float* s_d = s_c + nlayer * tile;
  float* s_o = s_d + nlayer * tile;
  const long long n = (long long)blockIdx.x * tile + threadIdx.x;
  const bool live = n < ncol;
  for (int l = 0; l < nlayer; ++l) {
    const long long k = (long long)l * ncol + n;
    const int s = l * tile + threadIdx.x;
    s_b[s] = live ? b[k] : 1.0f;
    s_c[s] = live ? c[k] : 0.0f;
    s_d[s] = live ? d[k] : 0.0f;
  }
  // each thread sweeps only its own column, so no barrier is needed
  // between its stores and loads; the copies above are still coalesced
  float as_n = 1.0f, ds_n = 0.5f;
  for (int l = nlayer - 1; l >= 0; --l) {
    const int s = l * tile + threadIdx.x;
    s_o[s] = step(s_b[s], s_c[s], s_d[s], as_n, ds_n);
  }
  if (!live) return;
  for (int l = 0; l < nlayer; ++l)
    out[(long long)l * ncol + n] = s_o[l * tile + threadIdx.x];
}

}  // namespace

extern "C" int sweep_layout_launch(const void* b, const void* c,
                                   const void* d, void* out, int nlayer,
                                   int ncol, int staged, int tile,
                                   void* stream) {
  if (!staged) {
    constexpr int kThreads = 128;
    sweep_rows_kernel<<<(ncol + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const float*)b, (const float*)c, (const float*)d, (float*)out,
        nlayer, ncol);
    return (int)cudaGetLastError();
  }
  const size_t smem = 4 * sizeof(float) * (size_t)nlayer * tile;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sweep_staged_kernel<<<(ncol + tile - 1) / tile, tile, smem,
                        (cudaStream_t)stream>>>(
      (const float*)b, (const float*)c, (const float*)d, (float*)out,
      nlayer, ncol);
  return (int)cudaGetLastError();
}
