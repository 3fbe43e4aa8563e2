// Gather-fused molecular opacity interpolation: taugas[l, w] in one pass.
//
// Two kernels from one template:
// K1 (interp_tau_launch) replaces the TPU kernels interp_tau_pallas_blocked
//    (_blocked_kernel) and interp_tau_pallas (_kernel) of
//    picaso_tpu/opacities/pallas_interp.py: a float32 log10 table;
// K8 (interp_tau_q_launch) replaces _blocked_kernel_q there
//    (pallas_interp.py:243): the same gather over the int16 fixed-point
//    table of quantize_table, dequantized once after the blend.
//
// For each (layer l, wavenumber w) it blends the 4 neighbouring (T, P)
// rows of the table in (1/T, log10 P), exponentiates with the Avogadro
// term folded into the exponent, and sums over molecules with the
// mix * colden / mmw column weights:
//
//   K1: logk = sum_q w4[q, l] * log_kappa[m, idx[q, l], w]
//   K8: logk = (sum_q w4[q, l] * float(q_table[m, idx[q, l], w]))
//              * scale + offset
//   taugas[l, w] = sum_m mixcol[m, l] * exp(LN10 * (logk + LOG_AVO))
//
// What bounds it on this card: bytes.  At the production shape (16
// molecules, 90 layers, 50k wavenumbers) the profile touches ~73 distinct
// (T, P) rows: 234 MB of float32 rows (K1) or 117 MB of int16 rows (K8),
// plus 18 MB of output, against 72M expf (~1 GFLOP), far below the
// card's compute rate.
//
// Design: one thread per wavenumber and one block row per layer, grid
// (ceil(nwno / 256), nlayer).  The table stays in the flat
// [nmol, npt, nwno] layout it is built in (no second copy): a warp's 32
// loads of one row are 128 (K1) or 64 (K8) contiguous bytes, so every
// gathered row is read coalesced.  Rows shared by neighbouring layers are
// re-read by their blocks and left to the 50 MB L2.  The block's 4 row
// ids, 4 corner weights and nmol column weights sit in shared memory.
// Arithmetic order matches the plain twins (interp_tau_plain,
// interp_tau_q_plain): the four corner products summed left to right, the
// dequantize (K8), then molecules in order; all in float32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// T = float: K1; T = short: K8 (qp = [scale, offset] on the device).
template <typename T>
__global__ void interp_tau_kernel(const T* __restrict__ table,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ w4,
                                  const float* __restrict__ mixcol,
                                  const float* __restrict__ qp,
                                  float* __restrict__ out, int nmol, int npt,
                                  int nwno, int nlayer, float ln10,
                                  float log_avo) {
  constexpr bool kQuant = sizeof(T) == 2;
  extern __shared__ float s_mix[];  // [nmol]
  __shared__ long long s_row[4];
  __shared__ float s_w[4];
  const int l = blockIdx.y;
  if (threadIdx.x < 4) {
    s_row[threadIdx.x] = idx[threadIdx.x * nlayer + l];
    s_w[threadIdx.x] = w4[threadIdx.x * nlayer + l];
  }
  for (int m = threadIdx.x; m < nmol; m += blockDim.x)
    s_mix[m] = mixcol[m * nlayer + l];
  __syncthreads();

  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nwno) return;
  const float w0 = s_w[0], w1 = s_w[1], w2 = s_w[2], w3 = s_w[3];
  float scale = 1.0f, offset = 0.0f;
  if (kQuant) {
    scale = qp[0];
    offset = qp[1];
  }
  float acc = 0.0f;
  for (int m = 0; m < nmol; ++m) {
    const T* tab = table + (long long)m * npt * nwno + w;
    const float k0 = (float)tab[s_row[0] * nwno];
    const float k1 = (float)tab[s_row[1] * nwno];
    const float k2 = (float)tab[s_row[2] * nwno];
    const float k3 = (float)tab[s_row[3] * nwno];
    float logk = w0 * k0 + w1 * k1 + w2 * k2 + w3 * k3;
    if (kQuant) logk = logk * scale + offset;
    const float kappa = expf(ln10 * (logk + log_avo));
    acc = acc + s_mix[m] * kappa;
  }
  out[(long long)l * nwno + w] = acc;
}

template <typename T>
int launch(const void* table, const void* idx, const void* w4,
           const void* mixcol, const void* qp, void* out, int nmol, int npt,
           int nwno, int nlayer, float ln10, float log_avo, void* stream) {
  const dim3 grid((nwno + kThreads - 1) / kThreads, nlayer);
  const size_t smem = sizeof(float) * (size_t)nmol;
  interp_tau_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)table, (const int*)idx, (const float*)w4,
      (const float*)mixcol, (const float*)qp, (float*)out, nmol, npt, nwno,
      nlayer, ln10, log_avo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int interp_tau_launch(const void* log_kappa, const void* idx,
                                 const void* w4, const void* mixcol,
                                 void* out, int nmol, int npt, int nwno,
                                 int nlayer, float ln10, float log_avo,
                                 void* stream) {
  return launch<float>(log_kappa, idx, w4, mixcol, nullptr, out, nmol, npt,
                       nwno, nlayer, ln10, log_avo, stream);
}

extern "C" int interp_tau_q_launch(const void* q, const void* idx,
                                   const void* w4, const void* mixcol,
                                   const void* qparams, void* out, int nmol,
                                   int npt, int nwno, int nlayer, float ln10,
                                   float log_avo, void* stream) {
  return launch<short>(q, idx, w4, mixcol, qparams, out, nmol, npt, nwno,
                       nlayer, ln10, log_avo, stream);
}
