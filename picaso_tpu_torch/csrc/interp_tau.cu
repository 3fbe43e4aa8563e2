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
// What bounds it on this card: at the production shape (16 molecules, 90
// layers, 50k wavenumbers) the profile touches 73 distinct (T, P) rows:
// 234 MB of float32 rows (K1) or 117 MB of int16 rows (K8), plus 18 MB of
// output.  A block per (layer, tile) reads its layer's 4 rows, 360 row
// reads for 90 layers: 4.9x the distinct bytes, re-read through L2, and
// from device memory once a layer's rows (12.8 MB at nwno 50 000, 51 MB at
// 200 000) outgrow L2.  Nor is the arithmetic free: 72M (layer, wavenumber,
// molecule) terms of ~30 instructions each (an accurate expf among them)
// take about as long to issue as the rows take to arrive, and K8, with
// half the bytes, is bound by that issue alone.
//
// Design: a block per (tile of kTile wavenumbers, chunk of kChunk
// consecutive layers), kPerThread neighbouring wavenumbers per thread.
// The block's prologue loads the chunk's [4, L] row ids and corner weights
// and its [nmol, L] column weights into shared memory and numbers the
// distinct rows (first come, first numbered), each corner pointing at its
// row: the CUDA counterpart of the TPU kernel's _parity_slots, whose DMA
// elision fetched each distinct row once.  At the production profile a
// chunk of 15 layers needs 91 row reads in all instead of 360 (at most 19
// rows in a chunk).  Then, for each molecule in order, the rows' tiles are
// staged in shared memory and every thread blends its wavenumbers'
// corners for each layer of the chunk, the sums staying in registers.
// Each warp stages only its own columns, with cp.async copies as wide as
// the alignment of the table and of nwno allows (16, 8 or 4 bytes; int16
// elements one by one otherwise), into a ring of two stages, so molecule
// m + 1's rows arrive while molecule m is blended and a __syncwarp, not a
// block barrier, orders the two.  A stage holds kMaxRows rows, which keeps
// five blocks on an SM; a chunk that needs more (a profile that jumps
// across the grid from layer to layer: up to 4L) runs in passes of
// kMaxRows / 4 layers, each numbering and staging its own rows.

// The table stays in the flat [nmol, npt, nwno] layout it is built in (no
// second copy).  Arithmetic order matches the plain twins (interp_tau_plain,
// interp_tau_q_plain) and the one-block-per-layer kernel before this
// design: the four corner products summed left to right, the dequantize
// (K8), then molecules in order; all in float32 (-fmad=false), so only the
// place each row value is read from changed, not a bit of the output.
//
// Without nvcc (__CUDACC__ undefined) the file compiles as host C++
// (g++ -std=c++17 -ffp-contract=off -x c++): the qualifiers are empty, the
// copies are plain copies, and interp_tau_host runs each block's phases as
// loops over its threads (tests/test_torch_interp_host.py).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <math.h>
#include <string.h>

#include <algorithm>
#include <vector>
#define __device__
#define __global__
#define __launch_bounds__(...)
using std::min;
#endif

namespace {

constexpr int kTile = 256;      // wavenumbers per block
constexpr int kPerThread = 2;   // neighbouring wavenumbers per thread
constexpr int kThreads = kTile / kPerThread;
constexpr int kWarpCols = 32 * kPerThread;  // wavenumbers per warp
constexpr int kChunk = 15;      // layers per block
constexpr int kMaxRows = 20;    // rows a stage holds
constexpr int kStages = 2;      // the staging ring

// A layer of a chunk as the blend reads it: two 16-byte shared loads.
struct alignas(16) Layer {
  int off[4];  // each corner's row in the staging stage, times kTile
  float w[4];  // corner weights
};

// What a block's prologue builds, the same for all its threads.
template <int L>
struct Chunk {
  Layer layer[L];
  int raw[4 * L];     // row id of corner q of layer j at [q * L + j]
  int first[4 * L];   // entry of that row's first occurrence in the pass
  int rows[kMaxRows]; // the pass's distinct rows, in order of occurrence
  int nrow;           // distinct rows of the pass (of the chunk at first)
  int nlayer;         // layers of this chunk (fewer than L in the last)
};

// The prologue's steps, each cooperative with a barrier after it: thread
// tid of nt takes entries tid, tid + nt, ...  (a single thread, tid 0 of
// 1, does a whole step).

// this chunk's corners, weights and column weights mix [nmol, L]
template <int L>
__device__ void load_chunk(Chunk<L>& c, float* mix, const int* idx,
                           const float* w4, const float* mixcol, int nmol,
                           int nlayer, int l0, int tid, int nt) {
  const int nl = min(L, nlayer - l0);
  if (tid == 0) c.nlayer = nl;
  for (int e = tid; e < 4 * L; e += nt) {
    const int q = e / L, j = e - q * L;
    const bool in = j < nl;
    c.raw[e] = in ? idx[q * nlayer + l0 + j] : -1;
    c.layer[j].w[q] = in ? w4[q * nlayer + l0 + j] : 0.0f;
  }
  for (int e = tid; e < nmol * L; e += nt) {
    const int m = e / L, j = e - m * L;
    mix[e] = j < nl ? mixcol[m * nlayer + l0 + j] : 0.0f;
  }
}

// each corner of layers [j0, j1) to its row's first occurrence among them
// (-1 for the other entries)
template <int L>
__device__ void find_first(Chunk<L>& c, int j0, int j1, int tid, int nt) {
  for (int e = tid; e < 4 * L; e += nt) {
    const int j = e % L;
    int f = -1;
    if (j >= j0 && j < j1) {
      f = 0;
      while (f % L < j0 || f % L >= j1 || c.raw[f] != c.raw[e]) ++f;
    }
    c.first[e] = f;
  }
}

// number the first occurrences in entry order: the rows (the first
// kMaxRows), each corner's offset and (entry 4L) their count
template <int L>
__device__ void number_rows(Chunk<L>& c, int tid, int nt) {
  for (int e = tid; e <= 4 * L; e += nt) {
    const int f = e < 4 * L ? c.first[e] : 4 * L;
    if (f < 0) continue;
    int pos = 0;
    for (int k = 0; k < f; ++k) pos += c.first[k] == k;
    if (e == 4 * L) {
      c.nrow = pos;
    } else {
      c.layer[e % L].off[e / L] = pos * kTile;
      if (f == e && pos < kMaxRows) c.rows[pos] = c.raw[e];
    }
  }
}

// a B-byte asynchronous copy from device to shared memory (B = 4, 8, 16)
template <int B>
__device__ inline void copy_async(void* dst, const void* src) {
#ifdef __CUDACC__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(B));
#else
  memcpy(dst, src, B);
#endif
}

__device__ inline void copies_commit() {
#ifdef __CUDACC__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most N committed groups of this thread's copies are still
// in flight
template <int N>
__device__ inline void copies_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

__device__ inline void warp_sync() {
#ifdef __CUDACC__
  __syncwarp();
#endif
}

// Lane `lane` of the warp whose wavenumbers start at wc0 in the tile: its
// share of molecule m's rows of the pass at those kWarpCols wavenumbers
// (those below nw), in B-byte copies, into buf [kMaxRows][kTile].  Each
// warp stages, and later reads, only its own columns, so a __syncwarp and
// no block barrier orders the two.
template <typename T, int B, int L>
__device__ void stage_cols(T* buf, const Chunk<L>& c, const T* tab, int nwno,
                           int nw, int wc0, int lane) {
  constexpr int kElems = B / (int)sizeof(T);
  constexpr int kPerRow = kWarpCols / kElems;
  const int nrow = c.nrow;
  for (int i = lane; i < nrow * kPerRow; i += 32) {
    const int r = i / kPerRow, k = wc0 + (i % kPerRow) * kElems;
    if (k >= nw) continue;
    T* dst = buf + r * kTile + k;
    const T* src = tab + (long long)c.rows[r] * nwno + k;
    if constexpr (B >= 4)
      copy_async<B>(dst, src);
    else
      *dst = *src;
  }
}

// stage_cols with the copy width picked for the launch (bytes: 16, 8, 4,
// or sizeof(T) for element loads), for molecule m of table
template <typename T, int L>
__device__ void stage_rows(T* buf, const Chunk<L>& c, const T* table, int m,
                           int npt, int nwno, long long w0, int nw,
                           int bytes, int wc0, int lane) {
  const T* tab = table + (long long)m * npt * nwno + w0;
  if (bytes == 16)
    stage_cols<T, 16>(buf, c, tab, nwno, nw, wc0, lane);
  else if (bytes == 8)
    stage_cols<T, 8>(buf, c, tab, nwno, nw, wc0, lane);
  else if (sizeof(T) == 4 || bytes == 4)
    stage_cols<T, 4>(buf, c, tab, nwno, nw, wc0, lane);
  else
    stage_cols<T, sizeof(T)>(buf, c, tab, nwno, nw, wc0, lane);
}

// kPerThread staged values from p, as float
template <typename T>
__device__ inline void load_cols(const T* p, float (&k)[kPerThread]) {
#ifdef __CUDACC__
  if constexpr (kPerThread == 2 && sizeof(T) == 4) {
    const float2 v = *(const float2*)p;
    k[0] = v.x;
    k[1] = v.y;
    return;
  } else if constexpr (kPerThread == 2) {
    const short2 v = *(const short2*)p;
    k[0] = (float)v.x;
    k[1] = (float)v.y;
    return;
  }
#endif
  for (int v = 0; v < kPerThread; ++v) k[v] = (float)p[v];
}

// Thread t's wavenumbers at molecule m: each layer j0 <= j < j1's corner
// blend from the staged rows buf [kMaxRows][kTile], exponentiated and
// weighted into acc[j].  kAll: the pass is the whole chunk of L layers
// (the common case), so no layer is tested.
template <bool kAll, typename T, int L>
__device__ void blend(float (&acc)[L][kPerThread], const T* buf,
                      const Chunk<L>& c, const float* mix, int m, int t,
                      int j0, int j1, float scale, float offset, float ln10,
                      float log_avo) {
  constexpr bool kQuant = sizeof(T) == 2;
  const T* col = buf + t * kPerThread;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (kAll || (j >= j0 && j < j1)) {
      const Layer y = c.layer[j];
      float k0[kPerThread], k1[kPerThread], k2[kPerThread], k3[kPerThread];
      load_cols(col + y.off[0], k0);
      load_cols(col + y.off[1], k1);
      load_cols(col + y.off[2], k2);
      load_cols(col + y.off[3], k3);
      const float mx = mix[m * L + j];
#pragma unroll
      for (int v = 0; v < kPerThread; ++v) {
        float logk = y.w[0] * k0[v] + y.w[1] * k1[v] + y.w[2] * k2[v] +
                     y.w[3] * k3[v];
        if (kQuant) logk = logk * scale + offset;
        const float kappa = expf(ln10 * (logk + log_avo));
        acc[j][v] = acc[j][v] + mx * kappa;
      }
    }
  }
}

struct Args {
  const void* table;
  const int* idx;
  const float* w4;
  const float* mixcol;
  const float* qp;  // [scale, offset] (K8), else null
  float* out;
  int nmol, npt, nwno, nlayer;
  float ln10, log_avo;
  int bytes;  // staging copy width: 16, 8 or 4 dividing the table's
              // address and nwno * sizeof(T), else sizeof(T)
};

template <typename T>
int copy_bytes(const void* table, int nwno) {
  for (int b = 16; b >= 4; b /= 2)
    if ((size_t)table % b == 0 && (nwno * sizeof(T)) % b == 0) return b;
  return (int)sizeof(T);
}

// dynamic shared memory: the staging ring, then mix [nmol, L]
template <typename T, int L>
size_t smem_bytes(int nmol) {
  return sizeof(T) * (size_t)kStages * kMaxRows * kTile +
         sizeof(float) * (size_t)nmol * L;
}

// layers per pass: all, or kMaxRows / 4 when the chunk's rows overflow
template <int L>
__device__ int pass_layers(const Chunk<L>& c) {
  return c.nrow <= kMaxRows ? L : kMaxRows / 4;
}

// One pass over the molecules for thread tid: the warp stages molecule
// m + kStages - 1's rows into the ring while molecule m is blended.
template <bool kAll, typename T, int L>
__device__ void molecules(float (&acc)[L][kPerThread], T* ring,
                          const Chunk<L>& c, const float* mix, const Args& a,
                          long long w0, int nw, int j0, int j1, float scale,
                          float offset, int tid) {
  const T* table = (const T*)a.table;
  const int lane = tid % 32, wc0 = (tid / 32) * kWarpCols;
  const bool busy = tid * kPerThread < nw;
  for (int m = 0; m < kStages - 1; ++m) {
    if (m < a.nmol)
      stage_rows(ring + m * kMaxRows * kTile, c, table, m, a.npt, a.nwno, w0,
                 nw, a.bytes, wc0, lane);
    copies_commit();
  }
  for (int m = 0; m < a.nmol; ++m) {
    const int ahead = m + kStages - 1;
    if (ahead < a.nmol)
      stage_rows(ring + (ahead % kStages) * kMaxRows * kTile, c, table,
                 ahead, a.npt, a.nwno, w0, nw, a.bytes, wc0, lane);
    copies_commit();
    copies_wait<kStages - 1>();  // molecule m's copies have landed
    warp_sync();
    if (busy)
      blend<kAll>(acc, ring + (m % kStages) * kMaxRows * kTile, c, mix, m,
                  tid, j0, j1, scale, offset, a.ln10, a.log_avo);
    warp_sync();  // before this stage is refilled
  }
}

template <int L>
__device__ void write_out(const Args& a, const float (&acc)[L][kPerThread],
                          int nl, int l0, long long w0, int nw, int t) {
#pragma unroll
  for (int j = 0; j < L; ++j)
#pragma unroll
    for (int v = 0; v < kPerThread; ++v)
      if (j < nl && t * kPerThread + v < nw)
        a.out[(long long)(l0 + j) * a.nwno + w0 + t * kPerThread + v] =
            acc[j][v];
}

#ifdef __CUDACC__
template <typename T, int L>
__global__ void __launch_bounds__(kThreads) interp_tau_kernel(const Args a) {
  __shared__ Chunk<L> c;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* ring = (T*)dyn;
  float* mix = (float*)(ring + kStages * kMaxRows * kTile);
  const int tid = threadIdx.x;
  const int l0 = blockIdx.y * L;
  const long long w0 = (long long)blockIdx.x * kTile;
  const int nw = (int)min((long long)kTile, a.nwno - w0);

  load_chunk(c, mix, a.idx, a.w4, a.mixcol, a.nmol, a.nlayer, l0, tid,
             kThreads);
  __syncthreads();
  const int nl = c.nlayer;
  find_first(c, 0, nl, tid, kThreads);
  __syncthreads();
  number_rows(c, tid, kThreads);
  __syncthreads();
  const int span = pass_layers(c);

  float scale = 1.0f, offset = 0.0f;
  if (sizeof(T) == 2) {
    scale = a.qp[0];
    offset = a.qp[1];
  }
  float acc[L][kPerThread];
#pragma unroll
  for (int j = 0; j < L; ++j)
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) acc[j][v] = 0.0f;
  if (span == L && nl == L) {
    molecules<true>(acc, ring, c, mix, a, w0, nw, 0, L, scale, offset, tid);
  } else {
    for (int j0 = 0; j0 < nl; j0 += span) {
      const int j1 = min(j0 + span, nl);
      if (span < L) {  // this pass's own rows
        __syncthreads();  // every warp is done with the last pass's rows
        find_first(c, j0, j1, tid, kThreads);
        __syncthreads();
        number_rows(c, tid, kThreads);
        __syncthreads();
      }
      molecules<false>(acc, ring, c, mix, a, w0, nw, j0, j1, scale, offset,
                       tid);
    }
  }
  if (tid * kPerThread < nw) write_out(a, acc, nl, l0, w0, nw, tid);
}

template <typename T>
int launch(Args a, void* stream) {
  constexpr int L = kChunk;
  a.bytes = copy_bytes<T>(a.table, a.nwno);
  const size_t smem = smem_bytes<T, L>(a.nmol);
  // the shared memory the kernel may take, raised once per device as far
  // as a launch needs (a host-side call, kept off every launch)
  constexpr int kDevices = 64;
  static size_t allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev >= kDevices || smem > allowed[dev])) {
    err = cudaFuncSetAttribute(interp_tau_kernel<T, L>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess && dev < kDevices) allowed[dev] = smem;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left behind for the next launch's check
    return (int)err;
  }
  const dim3 grid((a.nwno + kTile - 1) / kTile, (a.nlayer + L - 1) / L);
  interp_tau_kernel<T, L>
      <<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#else
// Each block's phases as loops over its threads, in the kernel's order:
// the prologue's steps, then per pass and molecule every lane's staging
// and every thread's blend, then the writes.
template <typename T>
int run_host(Args a) {
  constexpr int L = kChunk;
  a.bytes = copy_bytes<T>(a.table, a.nwno);
  std::vector<float> dyn((smem_bytes<T, L>(a.nmol) + 3) / 4);
  T* ring = (T*)dyn.data();
  float* mix = (float*)(ring + kStages * kMaxRows * kTile);
  Chunk<L> c;
  std::vector<float> acc_all((size_t)kThreads * L * kPerThread);
  auto acc = (float(*)[L][kPerThread])acc_all.data();
  const T* table = (const T*)a.table;
  const float scale = sizeof(T) == 2 ? a.qp[0] : 1.0f;
  const float offset = sizeof(T) == 2 ? a.qp[1] : 0.0f;
  for (int l0 = 0; l0 < a.nlayer; l0 += L) {
    for (long long w0 = 0; w0 < a.nwno; w0 += kTile) {
      const int nw = (int)min((long long)kTile, a.nwno - w0);
      const int busy = (nw + kPerThread - 1) / kPerThread;
      load_chunk(c, mix, a.idx, a.w4, a.mixcol, a.nmol, a.nlayer, l0, 0, 1);
      const int nl = c.nlayer;
      find_first(c, 0, nl, 0, 1);
      number_rows(c, 0, 1);
      const int span = pass_layers(c);
      const bool all = span == L && nl == L;  // the kernel's molecules<true>
      std::fill(acc_all.begin(), acc_all.end(), 0.0f);
      for (int j0 = 0; j0 < nl; j0 += span) {
        const int j1 = min(j0 + span, nl);
        if (span < L) {
          find_first(c, j0, j1, 0, 1);
          number_rows(c, 0, 1);
        }
        for (int m = 0; m < a.nmol; ++m) {
          T* buf = ring + (m % kStages) * kMaxRows * kTile;
          for (int tid = 0; tid < kThreads; ++tid)
            stage_rows(buf, c, table, m, a.npt, a.nwno, w0, nw, a.bytes,
                       (tid / 32) * kWarpCols, tid % 32);
          for (int t = 0; t < busy; ++t) {
            if (all)
              blend<true>(acc[t], buf, c, mix, m, t, j0, j1, scale, offset,
                          a.ln10, a.log_avo);
            else
              blend<false>(acc[t], buf, c, mix, m, t, j0, j1, scale, offset,
                           a.ln10, a.log_avo);
          }
        }
      }
      for (int t = 0; t < busy; ++t) write_out(a, acc[t], nl, l0, w0, nw, t);
    }
  }
  return 0;
}
#endif

Args make_args(const void* table, const void* idx, const void* w4,
               const void* mixcol, const void* qp, void* out, int nmol,
               int npt, int nwno, int nlayer, float ln10, float log_avo) {
  return Args{table,  (const int*)idx, (const float*)w4, (const float*)mixcol,
              (const float*)qp, (float*)out, nmol, npt, nwno, nlayer, ln10,
              log_avo, 0};
}

}  // namespace

#ifdef __CUDACC__
extern "C" int interp_tau_launch(const void* log_kappa, const void* idx,
                                 const void* w4, const void* mixcol,
                                 void* out, int nmol, int npt, int nwno,
                                 int nlayer, float ln10, float log_avo,
                                 void* stream) {
  return launch<float>(make_args(log_kappa, idx, w4, mixcol, nullptr, out,
                                 nmol, npt, nwno, nlayer, ln10, log_avo),
                       stream);
}

extern "C" int interp_tau_q_launch(const void* q, const void* idx,
                                   const void* w4, const void* mixcol,
                                   const void* qparams, void* out, int nmol,
                                   int npt, int nwno, int nlayer, float ln10,
                                   float log_avo, void* stream) {
  return launch<short>(make_args(q, idx, w4, mixcol, qparams, out, nmol, npt,
                                 nwno, nlayer, ln10, log_avo),
                       stream);
}
#else
// K1 (quant 0: float32 table) or K8 (quant 1: int16 table and qparams) on
// host memory, run to completion: the arguments of interp_tau_q_launch
// without the stream (qparams unread for K1).  0, or -1 for another quant.
extern "C" int interp_tau_host(int quant, const void* table, const void* idx,
                               const void* w4, const void* mixcol,
                               const void* qparams, void* out, int nmol,
                               int npt, int nwno, int nlayer, float ln10,
                               float log_avo) {
  const Args a = make_args(table, idx, w4, mixcol, qparams, out, nmol, npt,
                           nwno, nlayer, ln10, log_avo);
  if (quant == 0) return run_host<float>(a);
  if (quant == 1) return run_host<short>(a);
  return -1;
}

// layers per block and rows a stage holds, as the kernels use them
extern "C" int interp_tau_chunk() { return kChunk; }
extern "C" int interp_tau_max_rows() { return kMaxRows; }
#endif
