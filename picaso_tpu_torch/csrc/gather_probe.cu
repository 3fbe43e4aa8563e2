// Layer-innermost gather: K1's function with the layer loop inside the
// thread (probe kernel of picaso_tpu_torch/probes/gather_probe.py).
//
// Replaces the TPU probe kernel interp_tau_swapped (_swapped_kernel) of
// scripts/gather_probe.py:52.  There the layer axis was the innermost
// grid axis, so Mosaic skipped the DMA of a neighbour row whose block
// index had not changed since the previous layer.  Here one thread per
// wavenumber walks all layers in order and keeps, for each of the 4
// slots, the row value of every molecule in registers; it reloads a slot
// only when the slot's row id differs from the previous layer's.  With
// slot-stabilised ids (stabilize_slots / parity_slots) every distinct row
// is read from device memory once per column: the GPU counterpart of the
// TPU's DMA elision, against K1's one block per (layer, 256 wavenumbers)
// that re-reads shared rows through L2.
//
//   taugas[l, w] = sum_m mixcol[m, l] * exp(LN10 * (sum_q w4[q, l] *
//                  log_kappa[m, idx[q, l], w] + LOG_AVO))
//
// What bounds it: bytes, the distinct rows (~234 MB at the production
// shape) and the 18 MB output; but it has only nwno threads (50 000, ~12
// warps per SM) to hide the latency of its dependent per-layer loop.
// The idx/w4/mixcol columns of all layers sit in shared memory.  The
// arithmetic order is K1's (corner products left to right in slot order,
// molecules in order), so the twin is interp_tau_w4_plain on the same
// (slot-permuted) inputs.  At most kMaxMol molecules (registers).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxMol = 16;

__global__ void __launch_bounds__(kThreads)
    layer_inner_kernel(const float* __restrict__ log_kappa,
                       const int* __restrict__ idx,
                       const float* __restrict__ w4,
                       const float* __restrict__ mixcol,
                       float* __restrict__ out, int nmol, int npt, int nwno,
                       int nlayer, float ln10, float log_avo) {
  extern __shared__ float smem[];
  int* s_idx = reinterpret_cast<int*>(smem);  // [4, nlayer]
  float* s_w = smem + 4 * nlayer;             // [4, nlayer]
  float* s_mix = s_w + 4 * nlayer;            // [nmol, nlayer]
  for (int i = threadIdx.x; i < 4 * nlayer; i += blockDim.x) {
    s_idx[i] = idx[i];
    s_w[i] = w4[i];
  }
  for (int i = threadIdx.x; i < nmol * nlayer; i += blockDim.x)
    s_mix[i] = mixcol[i];
  __syncthreads();

  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nwno) return;
  const long long plane = (long long)npt * nwno;
  float v[4][kMaxMol];
  int held[4] = {-1, -1, -1, -1};
  for (int l = 0; l < nlayer; ++l) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = s_idx[q * nlayer + l];
      if (row != held[q]) {
        held[q] = row;
        const float* src = log_kappa + (long long)row * nwno + w;
#pragma unroll
        for (int m = 0; m < kMaxMol; ++m)
          if (m < nmol) v[q][m] = src[m * plane];
      }
    }
    const float w0 = s_w[l], w1 = s_w[nlayer + l];
    const float w2 = s_w[2 * nlayer + l], w3 = s_w[3 * nlayer + l];
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < kMaxMol; ++m) {
      if (m < nmol) {
        const float logk =
            w0 * v[0][m] + w1 * v[1][m] + w2 * v[2][m] + w3 * v[3][m];
        const float kappa = expf(ln10 * (logk + log_avo));
        acc = acc + s_mix[m * nlayer + l] * kappa;
      }
    }
    out[(long long)l * nwno + w] = acc;
  }
}

}  // namespace

extern "C" int interp_tau_layer_inner_launch(
    const void* log_kappa, const void* idx, const void* w4,
    const void* mixcol, void* out, int nmol, int npt, int nwno, int nlayer,
    float ln10, float log_avo, void* stream) {
  if (nmol > kMaxMol) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(8 + nmol) * nlayer;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((nwno + kThreads - 1) / kThreads);
  layer_inner_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)log_kappa, (const int*)idx, (const float*)w4,
      (const float*)mixcol, (float*)out, nmol, npt, nwno, nlayer, ln10,
      log_avo);
  return (int)cudaGetLastError();
}
