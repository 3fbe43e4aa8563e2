// Spherical-harmonics (SH2/SH4) reflected and thermal solves for every
// wavenumber column.
//
// Replaces four TPU kernels of picaso_tpu/rt/pallas_sh.py
// (_sh{4,2}_{reflected,thermal}_core -> _optics_block, _sh{4,2}_coeffs,
// _eta{,2}_sources, _stage_system, _solve_sh_staged, _gj_rows), each in two
// launches, stage A then stage B:
//   reflected_sh4_pallas <- sh_reflected_columns<4> + sh_reflected_angles<4>
//   reflected_sh2_pallas <- sh_reflected_columns<2> + sh_reflected_angles<2>
//   thermal_sh4_pallas   <- sh_thermal_columns<4> + sh_thermal_angles<4>
//   thermal_sh2_pallas   <- sh_thermal_columns<2> + sh_thermal_angles<2>
// Per column they build the optics from the six source strips, the SH
// coefficients of every layer, the block-tridiagonal system in the
// 'incoming' row grouping (S x S blocks, S = stream; every pivot block
// stays nonsingular in fp32), eliminate it (block Thomas, pivoted
// Gauss-Jordan on each S x 2S block row), substitute back and run the
// per-angle TOA intensity sweep.  Outputs [nang, nwno].
//
// What bounds them on this card: the chain of dependent layer steps (the
// elimination and the sweeps are sequential over the layers) and the fp32
// divisions, square roots and exponentials of the per-layer coefficients;
// only the wavenumber axis and the disk-angle axis are parallel.  The
// first design ran everything of a column in one thread and was bounded by
// three things: the angles ran one after another (about 15 chained 90-step
// sweeps per thread at 5 angles for the reflected beam, where the TPU
// kernel advances all angles' right-hand sides in one loop step, and one
// sweep per angle for the thermal pass, where the TPU kernel computes each
// angle's sources for all layers at once); 50 000 threads are about 12
// warps per SM of 64, too few to hide the latency of the sqrtf/expf/
// division chains of the coefficients, which the thermal kernel computed
// 2 + nang times per layer; and each angle re-read the column's
// angle-independent rows from a scratch 16 times the 50 MB L2, so from HBM.
//
// Design: two launches on one stream, as in toon_spectrum.cu.
//  Stage A, one thread per column.  Reflected (sh_reflected_columns): one
//  top-down loop computes each layer's optics and coefficients once, in
//  eliminate's rolling window, and writes the optics rows and every
//  per-layer value stage B reads that no angle changes (36 slots at SH4,
//  13 at SH2: the coefficients, the multi-scattering weights, the beam
//  source's factor f0pi w0 w_single, the single-scattering phase function
//  at cos_theta or its Legendre weights); then the matrix half of the
//  elimination: block row k built from the coefficients of layers k-1, k,
//  k+1, the pivoted Gauss-Jordan step on [B | C], Cp[k] and the step's
//  replay record (row swap flags packed into one slot, pivot inverses,
//  multipliers: 17 slots at SH4, 5 at SH2) to scratch; no beam source, no
//  right-hand side.  Thermal (sh_thermal_columns): one top-down loop
//  computes each layer's optics and coefficients once, in the same rolling
//  window, and writes dtau, w0 and the values the sweep needs (16 slots at
//  SH4, 7 at SH2); it builds block row k and the source rows D[k] in
//  registers from z_down/z_up of layers k-1, k and k+1, applies the Schur
//  update, factors the block row, replays the step on D[k] and writes Cp[k]
//  and Dp[k]; the back-substitution then leaves X[k] (S slots).
//  Stage B, one thread per (column, angle): a block is 32 consecutive
//  columns by up to 8 angles, one warp per angle, so every access
//  coalesces and the warps of one tile read the tile's angle-independent
//  rows at about the same time, from L1/L2 instead of from HBM once per
//  angle; more angles are cut into chunks of at most 8, the chunks of one
//  tile in neighbouring blocks.  No shared memory, no barrier.  Reflected
//  (sh_reflected_angles): top down, each thread builds its angle's D[k]
//  from the beams of layers k-1, k and k+1, applies the Schur update and
//  replays layer k's record on them; Dp[k] (S slots per angle) is its only
//  scratch.  Bottom up, one loop substitutes back (X[k] = Dp[k] - Cp[k]
//  X[k+1], in registers) and advances the TOA intensity sweep with X[k] as
//  soon as it is known.  Both loops read the layer values stage A stored
//  and compute only what the angle changes: the beam's particular
//  solution and its dither, the sources and the sweep (recomputing the
//  values in both loops of every angle instead made stage B 52 % slower
//  at SH4 and 36 angles, 33 % at SH2 and 5 angles).  Thermal
//  (sh_thermal_angles): the bottom-up sweep of its angle over X[k] and the
//  layer values stage A stored (recomputing them per angle instead made
//  stage B 55 % slower at SH4).
//
// Each value is computed by the same operations in the same order as in
// the one-thread design (the record holds the very swaps, inverses and
// multipliers; the layer values are stored as computed), so the outputs
// are bitwise those of that design.  Per-layer
// values go to global scratch [slot, row, column] (coalesced across a
// warp; rows padded to 128 bytes, scratch_row), which the wrapper
// allocates.  Expressions keep the TPU kernel's order of
// operations (integer powers as lax.integer_pow's products, the Taylor
// expm1 below |x| 0.05, the exp clip at 35, beam dither 1e-3); built with
// -fmad=false, so each operation rounds as in the eager PyTorch twin
// (rt/cuda_sh.py).
//
// Without nvcc (__CUDACC__ undefined) the file compiles as host C++
// (g++ -std=c++17 -ffp-contract=off -x c++): the qualifiers are empty, the
// thread indices are globals, and sh_reflected_host and sh_thermal_host
// run the stages' threads as loops (tests/test_torch_sh_reflected_host.py,
// tests/test_torch_sh_thermal_host.py).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <math.h>
#include <string.h>
#define __device__
#define __global__
#define __launch_bounds__(...)
namespace {
struct HostDim3 {
  unsigned x = 0, y = 0, z = 0;
};
HostDim3 blockIdx, blockDim, threadIdx;
float __int_as_float(int i) {
  float f;
  memcpy(&f, &i, sizeof f);
  return f;
}
int __float_as_int(float f) {
  int i;
  memcpy(&i, &f, sizeof i);
  return i;
}
}  // namespace
#endif

namespace {

constexpr int kThreads = 128;   // stage A: one thread per column
constexpr int kTileCols = 32;   // stage B: one warp = 32 columns, one angle
constexpr int kMaxAngles = 8;   // stage B: angles per block
constexpr float kClip = 35.0f;
constexpr float kPi = (float)3.141592653589793;
constexpr float k2Pi = (float)(2.0 * 3.141592653589793);
constexpr float k4Pi = (float)(4.0 * 3.141592653589793);
constexpr float kSixth = (float)(1.0 / 6.0);
constexpr float kDitherDelta = 1e-3f;
constexpr float kOnePlusDelta = (float)(1.0 + 1e-3);

// scratch slots, each [nlayer + 1, ld] (scratch_row: nwno rounded up to
// kRowAlign floats, so that every row starts on a 128-byte line and a
// warp's 32 columns write whole 32-byte sectors, not two partial ones
// that memory must read back and merge).  Reflected: the optics, Cp
// (S * S), the replay record (kRecSlots), the layer values of stage B
// (kReflVals to kDp), then S Dp rows per angle; thermal: dtau and w0, Cp, Dp
// (X after the back-substitution), then the layer values of the sweep
// (kThermCoefSlots: lam, ex, R/Q/Sg or q, a0, a1, wm).
enum ReflSlot { R_DTAU, R_TAU, R_W0, R_W0_OG, R_DTAU_OG, R_TAU_OG,
                kReflSlots };
enum ThermSlot { T_DTAU, T_W0, kThermSlots };
constexpr int kThermCp = kThermSlots;
template <int S> constexpr int kThermX = kThermSlots + S * S;
template <int S> constexpr int kThermCoef = kThermX<S> + S;
template <int S> constexpr int kThermCoefSlots = S == 4 ? 16 : 7;
template <int S>
constexpr int kThermScratch = kThermCoef<S> + kThermCoefSlots<S>;

// one layer's Gauss-Jordan record: the packed swap flags, S pivot
// inverses, S (S - 1) multipliers
template <int S> constexpr int kRecSlots = 1 + S + S * (S - 1);
constexpr int kCp = kReflSlots;
template <int S> constexpr int kRec = kReflSlots + S * S;
// one layer's values of stage B (refl_values' order): the coefficients
// (a, lam, ex, x, y, then beta, gama, R, Q, Sg at SH4 or q at SH2: 24 or
// 7), wm and bf (S each), then S slots of the single-scattering term
template <int S> constexpr int kReflVals = kRec<S> + kRecSlots<S>;
template <int S> constexpr int kSingle = kReflVals<S> + (S == 4 ? 24 : 7)
                                         + 2 * S;
template <int S> constexpr int kDp = kSingle<S> + S;

constexpr int kRowAlign = 32;
int scratch_row(int nwno) {
  return (nwno + kRowAlign - 1) / kRowAlign * kRowAlign;
}

struct Params {
  const float *all_b, *taugas, *tauray, *cld_opd, *cld_w0, *cld_g0, *rf;
  const float *sr, *f0pi, *u0, *u1, *cos_theta, *ptfac;
  float *out, *scr;
  int nlayer, nwno, ld, nang, dedd, hard_surface;
  int w_single_form, w_multi_form, psingle_form, w_single_rayleigh,
      w_multi_rayleigh, psingle_rayleigh, single_form;
  float frac_a, frac_b, frac_c, constant_back, constant_forward, b_top;
  float cf_pow, cb_pow;  // constant_forward**S, constant_back**S
};

// one thread's view of its column
struct Col {
  const Params& p;
  long long w;
  __device__ float& s(int slot, int row) const {
    return p.scr[((long long)slot * (p.nlayer + 1) + row) * p.ld + w];
  }
  __device__ float in(const float* a, int row) const {
    return a[(long long)row * p.nwno + w];
  }
};

// x**n with lax.integer_pow's products (binary exponentiation)
__device__ float ipow(float x, int n) {
  if (n == 0) return 1.0f;
  const bool recip = n < 0;
  if (recip) n = -n;
  float acc = 0.0f;
  bool have = false;
  while (n > 0) {
    if (n & 1) {
      acc = have ? acc * x : x;
      have = true;
    }
    n >>= 1;
    if (n > 0) x = x * x;
  }
  return recip ? 1.0f / acc : acc;
}

__device__ float cube(float x) { return x * (x * x); }

__device__ float pow_noint(float x, float fc) {
  return fc == truncf(fc) ? ipow(x, (int)fc) : expf(fc * logf(fabsf(x)));
}

__device__ float clip35(float x) { return fminf(fmaxf(x, -kClip), kClip); }

// exp(x) - 1: 4th-order Taylor below |x| < 0.05, else the difference
__device__ float expm1_(float x) {
  if (fabsf(x) < 0.05f)
    return x * (1.0f + x * (0.5f + x * (kSixth + x / 24.0f)));
  return expf(x) - 1.0f;
}

// growing-mode source integral (pallas_sh.py:_scaled_bet)
__device__ float scaled_bet(float ex, float trans, float beta, float dtau) {
  const float bd = beta * dtau;
  if (!(fabsf(bd) < 1.0f)) return (ex - trans) / (beta == 0.0f ? 1.0f : beta);
  if (fabsf(beta) < 1e-4f) return ex * (dtau * (1.0f - 0.5f * bd));
  return ex * (-expm1_(-fminf(fmaxf(bd, -1.0f), 1.0f)) / beta);
}

__device__ float dither_u0(float lam, float u0) {
  return fabsf(lam * u0 - 1.0f) < kDitherDelta
             ? 1.0f / (lam * kOnePlusDelta) : u0;
}

__device__ void legp(float mu, float P[4]) {
  P[0] = 1.0f;
  P[1] = mu;
  P[2] = (3.0f * (mu * mu) - 1.0f) / 2.0f;
  P[3] = (5.0f * cube(mu) - 3.0f * mu) / 2.0f;
}

// ---------------------------------------------------------------------
// optics (pallas_toon.py:_optics_block) of layer j
// ---------------------------------------------------------------------
struct Optics {
  float dtau, w0, w0_og, dtau_og, cosb_og, ftc, ftr;
};

__device__ Optics optics(const Col& c, int j, int S) {
  const Params& p = c.p;
  const float tg = c.in(p.taugas, j), tr = c.in(p.tauray, j);
  const float copd = c.in(p.cld_opd, j), cw0 = c.in(p.cld_w0, j);
  const float cg0 = c.in(p.cld_g0, j), rf = c.in(p.rf, j);
  Optics o;
  o.dtau_og = tg + tr + copd;
  const float cldw = cw0 * copd;
  o.ftc = cldw / (cldw + tr);
  o.ftr = tr / (tr + cldw);
  o.w0_og = (tr * rf + cldw) / o.dtau_og;
  o.cosb_og = cg0;
  o.w0 = o.w0_og;
  o.dtau = o.dtau_og;
  if (p.dedd) {
    const float f = ipow(o.cosb_og, S);
    o.w0 = o.w0_og * (1.0f - f) / (1.0f - o.w0_og * f);
    o.dtau = o.dtau_og * (1.0f - o.w0_og * f);
  }
  return o;
}

// Legendre expansion weights (pallas_sh.py:_w_expansions_blk)
template <int S>
__device__ void w_expansions(const Params& p, int form, int rayleigh,
                             float cosb_og, float ftc, float ftr, float fdm_in,
                             float w[S]) {
#pragma unroll
  for (int l = 0; l < S; ++l) w[l] = 1.0f;
  if (form == 1) {  // OTHG
#pragma unroll
    for (int l = 1; l < S; ++l) {
      const float wl = (float)(2 * l + 1) * ipow(cosb_og, l);
      w[l] = (wl - (float)(2 * l + 1) * fdm_in) / (1.0f - fdm_in);
    }
  } else if (form == 0) {  // TTHG
    const float gf = p.constant_forward * cosb_og;
    const float gb = p.constant_back * cosb_og;
    const float f = p.frac_a + p.frac_b * pow_noint(gb, p.frac_c);
    const float fdm = fdm_in * (f * p.cf_pow + (1.0f - f) * p.cb_pow);
#pragma unroll
    for (int l = 1; l < S; ++l) {
      const float wl = (float)(2 * l + 1)
                       * (f * ipow(gf, l) + (1.0f - f) * ipow(gb, l));
      w[l] = (wl - (float)(2 * l + 1) * fdm) / (1.0f - fdm);
    }
  }
  if (rayleigh == 1) {
#pragma unroll
    for (int l = 1; l < S; ++l) w[l] = w[l] * ftc;
    if (S == 4) w[2] = w[2] + 0.5f * ftr;
  }
}

// ---------------------------------------------------------------------
// SH coefficients of one layer (pallas_sh.py:_sh2_coeffs/_sh4_coeffs)
// ---------------------------------------------------------------------
// The boundary functionals at the layer top (T) and bottom (Fm): row
// r < H, mode m has the pair (x, y) with T = (x, y e_m), Fm = (x e_m, y)
// in columns (2m, 2m + 1); row r + H has the pair swapped.
template <int S>
struct Coef {
  static constexpr int H = S / 2;
  float a[S];
  float lam[H], ex[H];
  float x[H][H], y[H][H];
  float beta, gama, R[2], Q[2], Sg[2];  // SH4
  float q;                              // SH2
  __device__ float T(int i, int j) const {
    const int m = j / 2, r = i % H;
    const float xx = i < H ? x[r][m] : y[r][m];
    const float yy = i < H ? y[r][m] : x[r][m];
    return (j & 1) ? yy * ex[m] : xx;
  }
  __device__ float F(int i, int j) const {
    const int m = j / 2, r = i % H;
    const float xx = i < H ? x[r][m] : y[r][m];
    const float yy = i < H ? y[r][m] : x[r][m];
    return (j & 1) ? yy : xx * ex[m];
  }
  // eigenvector matrix A4[j][mode] of the SH4 source technique
  __device__ float A4(int j, int m) const {
    if (j == 0) return 1.0f;
    const float v = j == 1 ? R[m / 2] : j == 2 ? Q[m / 2] : Sg[m / 2];
    return (j != 2 && (m & 1)) ? -v : v;
  }
};

__device__ void coeffs(Coef<2>& c, float w0, float dtau, const float wm[2]) {
  c.a[0] = 1.0f - w0 * wm[0];
  c.a[1] = 3.0f - w0 * wm[1];
  c.lam[0] = sqrtf(c.a[0] * c.a[1]);
  c.ex[0] = expf(-fminf(fmaxf(c.lam[0] * dtau, 0.0f), kClip));
  c.q = c.lam[0] / c.a[1];
  c.x[0][0] = (0.5f + c.q) * 2.0f * kPi;  // Q1
  c.y[0][0] = (0.5f - c.q) * 2.0f * kPi;  // Q2
}

__device__ void coeffs(Coef<4>& c, float w0, float dtau, const float wm[4]) {
#pragma unroll
  for (int l = 0; l < 4; ++l) c.a[l] = (float)(2 * l + 1) - w0 * wm[l];
  const float a0 = c.a[0], a1 = c.a[1], a2 = c.a[2], a3 = c.a[3];
  c.beta = a0 * a1 + 4.0f * a0 * a3 / 9.0f + a2 * a3 / 9.0f;
  c.gama = a0 * a1 * a2 * a3 / 9.0f;
  const float root = sqrtf(c.beta * c.beta - 4.0f * c.gama);
  c.lam[0] = sqrtf((c.beta + root) / 2.0f);
  c.lam[1] = sqrtf((c.beta - root) / 2.0f);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float lam = c.lam[m];
    c.ex[m] = expf(-fminf(fmaxf(lam * dtau, 0.0f), kClip));
    const float R = -a0 / lam;
    const float Q = 0.5f * (a0 * a1 / (lam * lam) - 1.0f);
    const float Sg = -3.0f / (2.0f * a3) * (a0 * a1 / lam - lam);
    c.R[m] = R;
    c.Q[m] = Q;
    c.Sg[m] = Sg;
    c.y[0][m] = (0.5f + R + 5.0f * Q / 8.0f) * 2.0f * kPi;      // p_pl
    c.y[1][m] = (-0.125f + 5.0f * Q / 8.0f + Sg) * 2.0f * kPi;  // q_pl
    c.x[0][m] = (0.5f - R + 5.0f * Q / 8.0f) * 2.0f * kPi;      // p_mn
    c.x[1][m] = (-0.125f + 5.0f * Q / 8.0f - Sg) * 2.0f * kPi;  // q_mn
  }
}

// a layer's values that stage A stores for stage B: its coefficients, the
// multi-scattering weights wm and the beam source's angle-free factor
// bf[l] = f0pi * (w0 * w_single[l])
template <int S>
struct ReflVals : Coef<S> {
  float wm[S], bf[S];
};

// beam particular solution of one angle (pallas_sh.py:_eta2_sources and
// _eta_sources): eta, the z rows in block-row order, the dithered angle
template <int S>
struct Beam {
  float eta[S], z[S], u0b;
};

__device__ Beam<2> beam(const ReflVals<2>& c, float u0) {
  Beam<2> r;
  r.u0b = dither_u0(c.lam[0], u0);
  const float t = 1.0f / r.u0b;
  const float Del = t * t - c.a[0] * c.a[1];
  const float b0 = c.bf[0] / k4Pi;
  const float b1 = c.bf[1] * -u0 / k4Pi;
  r.eta[0] = (b1 / r.u0b - c.a[1] * b0) / Del;
  r.eta[1] = (b0 / r.u0b - c.a[0] * b1) / Del;
  r.z[0] = (0.5f * r.eta[0] - r.eta[1]) * 2.0f * kPi;
  r.z[1] = (0.5f * r.eta[0] + r.eta[1]) * 2.0f * kPi;
  return r;
}

__device__ Beam<4> beam(const ReflVals<4>& c, float u0) {
  Beam<4> r;
  r.u0b = dither_u0(c.lam[1], dither_u0(c.lam[0], u0));
  const float u0i = 1.0f / r.u0b;
  const float u0i2 = u0i * u0i;
  const float Del = 9.0f * (u0i2 * u0i2 - c.beta * u0i2 + c.gama);
  float P[4];
  legp(-u0, P);
  float b[4];
  b[0] = c.bf[0] / k4Pi;
#pragma unroll
  for (int l = 1; l < 4; ++l) b[l] = c.bf[l] * P[l] / k4Pi;
  const float a0 = c.a[0], a1 = c.a[1], a2 = c.a[2], a3 = c.a[3];
  const float d0 = (a1 * b[0] - b[1] * u0i) * (a2 * a3 - 9.0f * u0i2)
                   + 2.0f * (a3 * b[2] - 2.0f * a3 * b[0] - 3.0f * b[3] * u0i)
                         * u0i2;
  const float d1 = (a0 * b[1] - b[0] * u0i) * (a2 * a3 - 9.0f * u0i2)
                   - 2.0f * a0 * (a3 * b[2] - 3.0f * b[3] * u0i) * u0i;
  const float d2 = (a3 * b[2] - 3.0f * b[3] * u0i) * (a0 * a1 - u0i2)
                   - 2.0f * a3 * (a0 * b[1] - b[0] * u0i) * u0i;
  const float d3 = (a2 * b[3] - 3.0f * b[2] * u0i) * (a0 * a1 - u0i2)
                   + 2.0f * (3.0f * a0 * b[1] - 2.0f * a0 * b[3]
                             - 3.0f * b[0] * u0i) * u0i2;
  r.eta[0] = d0 / Del;
  r.eta[1] = d1 / Del;
  r.eta[2] = d2 / Del;
  r.eta[3] = d3 / Del;
  const float* e = r.eta;
  r.z[0] = (e[0] / 2.0f - e[1] + 5.0f * e[2] / 8.0f) * 2.0f * kPi;
  r.z[1] = (-e[0] / 8.0f + 5.0f * e[2] / 8.0f - e[3]) * 2.0f * kPi;
  r.z[2] = (e[0] / 2.0f + e[1] + 5.0f * e[2] / 8.0f) * 2.0f * kPi;
  r.z[3] = (-e[0] / 8.0f + 5.0f * e[2] / 8.0f + e[3]) * 2.0f * kPi;
  return r;
}

// the SH4 homogeneous-mode terms of the source integral
__device__ float homogeneous4(const Coef<4>& c, const float wm[4],
                              const float P1[4], const float X[4], float u1,
                              float dtau, float trans) {
  float e[4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float alpha = 1.0f / u1 + c.lam[m];
    const float beta = 1.0f / u1 - c.lam[m];
    e[2 * m] = -expm1_(-clip35(alpha * dtau)) / alpha * X[2 * m];
    e[2 * m + 1] = scaled_bet(c.ex[m], trans, beta, dtau) * X[2 * m + 1];
  }
  float ms = 0.0f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float coeff = wm[0];
#pragma unroll
    for (int j = 1; j < 4; ++j) coeff = coeff + wm[j] * P1[j] * c.A4(j, m);
    const float t = coeff * e[m];
    ms = m == 0 ? t : ms + t;
  }
  return ms;
}

// ---------------------------------------------------------------------
// block system: elimination, back-substitution
// ---------------------------------------------------------------------

// the pivoted Gauss-Jordan step of one block row: its row swaps, pivot
// inverses and multipliers, replayed on the right-hand sides
template <int S>
struct GJ {
  bool sw[S][S];
  float inv[S], fac[S][S];
};

// block row k, [B | C] with the Schur update of its top rows by
// Cp[k - 1] (cp), from the coefficients of layers k-1, k and k+1
template <int S>
__device__ void block_row(const Coef<S>& prev, const Coef<S>& cur,
                          const Coef<S>& next, const float cp[S][S], int k,
                          bool last, float sr, float M[S][2 * S]) {
  constexpr int H = S / 2;
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float acc = k == 0 ? cur.T(i, j) : -cur.T(i, j);
      if (k > 0) {
#pragma unroll
        for (int kk = 0; kk < S; ++kk) acc = acc - prev.F(i, kk) * cp[kk][j];
      }
      M[i][j] = acc;
      M[i][S + j] = 0.0f;
    }
  }
#pragma unroll
  for (int i = H; i < S; ++i) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      M[i][j] = last ? cur.F(i, j) - sr * cur.F(i - H, j) : cur.F(i, j);
      M[i][S + j] = last ? 0.0f : -next.T(i, j);
    }
  }
}

// pivoted Gauss-Jordan on [B | C] in place (M[:, S:] becomes Cp), recorded
template <int S>
__device__ void factor(float M[S][2 * S], GJ<S>& g) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int r = i + 1; r < S; ++r) {
      g.sw[i][r] = fabsf(M[r][i]) > fabsf(M[i][i]);
#pragma unroll
      for (int col = i; col < 2 * S; ++col) {
        const float top = M[i][col], bot = M[r][col];
        M[i][col] = g.sw[i][r] ? bot : top;
        M[r][col] = g.sw[i][r] ? top : bot;
      }
    }
    g.inv[i] = 1.0f / M[i][i];
#pragma unroll
    for (int col = i + 1; col < 2 * S; ++col) M[i][col] = M[i][col] * g.inv[i];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      if (r == i) continue;
      g.fac[i][r] = M[r][i];
#pragma unroll
      for (int col = i + 1; col < 2 * S; ++col)
        M[r][col] = M[r][col] - g.fac[i][r] * M[i][col];
    }
  }
}

// the recorded step on one right-hand side
template <int S>
__device__ void replay(const GJ<S>& g, float d[S]) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int r = i + 1; r < S; ++r) {
      const float top = d[i], bot = d[r];
      d[i] = g.sw[i][r] ? bot : top;
      d[r] = g.sw[i][r] ? top : bot;
    }
    d[i] = d[i] * g.inv[i];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      if (r == i) continue;
      d[r] = d[r] - g.fac[i][r] * d[i];
    }
  }
}

// Block-Thomas elimination, matrix half (pallas_sh.py:_solve_sh_staged);
// `layer(j)` gives the state of layer j, computed once: its coefficients
// (a Coef<S> or a type derived from it) and what the step needs besides.
// Writes Cp[k] to slots cp0.., then calls step(k, the states of layers
// k - 1, k and k + 1, the step of block row k).
template <int S, class Layer, class Step>
__device__ void eliminate(const Col& c, const Layer& layer, int cp0, float sr,
                          const Step& step) {
  const int L = c.p.nlayer;
  decltype(layer(0)) prev{}, cur = layer(0), next{};
  float cp[S][S];
  for (int k = 0; k < L; ++k) {
    const bool last = k == L - 1;
    if (!last) next = layer(k + 1);
    float M[S][2 * S];
    block_row<S>(prev, cur, next, cp, k, last, sr, M);
    GJ<S> g;
    factor<S>(M, g);
#pragma unroll
    for (int i = 0; i < S; ++i) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        cp[i][j] = M[i][S + j];
        c.s(cp0 + S * i + j, k) = cp[i][j];
      }
    }
    step(k, prev, cur, next, g);
    prev = cur;
    cur = next;
  }
}

// y[k] = Dp[k] - Cp[k] y[k+1], bottom up; X replaces Dp in place
template <int S>
__device__ void back_substitute(const Col& c, int cp0, int d0) {
  const int L = c.p.nlayer;
  float y[S];
#pragma unroll
  for (int i = 0; i < S; ++i) y[i] = c.s(d0 + i, L - 1);
  for (int k = L - 2; k >= 0; --k) {
    float yn[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      float acc = c.s(d0 + i, k);
#pragma unroll
      for (int j = 0; j < S; ++j) acc = acc - c.s(cp0 + S * i + j, k) * y[j];
      yn[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      y[i] = yn[i];
      c.s(d0 + i, k) = y[i];
    }
  }
}

// ---------------------------------------------------------------------
// reflected (pallas_sh.py:_sh{4,2}_reflected_core)
// ---------------------------------------------------------------------
// the single-scattering phase function at ct in the Henyey-Greenstein
// forms (single_form 0); with ct = cos_theta[0] no angle changes it
__device__ float p_single_hg(const Params& p, float cosb_og, float ftc,
                             float ftr, float ct) {
  float ps = 0.0f;
  if (p.psingle_form == 1) {  // OTHG
    ps = (1.0f - cosb_og * cosb_og)
         / cube(sqrtf(1.0f + cosb_og * cosb_og + 2.0f * cosb_og * ct));
  } else if (p.psingle_form == 0) {  // TTHG
    const float gf = p.constant_forward * cosb_og;
    const float gb = p.constant_back * cosb_og;
    const float f = p.frac_a + p.frac_b * pow_noint(gb, p.frac_c);
    ps = f * (1.0f - gf * gf) / sqrtf(cube(1.0f + gf * gf + 2.0f * gf * ct))
         + (1.0f - f) * (1.0f - gb * gb)
               / sqrtf(cube(1.0f + gb * gb + 2.0f * gb * ct));
  }
  if (p.psingle_rayleigh == 1)
    ps = ftc * ps + ftr * (0.75f * (1.0f + ct * ct));
  return ps;
}

// a layer's values of stage B in slot order from kReflVals: f(slot, value)
// for a, lam and ex, x and y, then beta, gama, R, Q, Sg (SH4) or q (SH2),
// wm, bf
template <int S, class F>
__device__ void refl_values(ReflVals<S>& v, const F& f) {
  constexpr int H = S / 2;
  int slot = kReflVals<S>;
#pragma unroll
  for (int l = 0; l < S; ++l) f(slot++, v.a[l]);
#pragma unroll
  for (int m = 0; m < H; ++m) {
    f(slot++, v.lam[m]);
    f(slot++, v.ex[m]);
  }
#pragma unroll
  for (int r = 0; r < H; ++r) {
#pragma unroll
    for (int m = 0; m < H; ++m) {
      f(slot++, v.x[r][m]);
      f(slot++, v.y[r][m]);
    }
  }
  if constexpr (S == 4) {
    f(slot++, v.beta);
    f(slot++, v.gama);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      f(slot++, v.R[m]);
      f(slot++, v.Q[m]);
      f(slot++, v.Sg[m]);
    }
  } else {
    f(slot++, v.q);
  }
#pragma unroll
  for (int l = 0; l < S; ++l) f(slot++, v.wm[l]);
#pragma unroll
  for (int l = 0; l < S; ++l) f(slot++, v.bf[l]);
}

template <int S>
__device__ ReflVals<S> load_values(const Col& c, int j) {
  ReflVals<S> v;
  refl_values<S>(v, [&](int slot, float& x) { x = c.s(slot, j); });
  return v;
}

// layer j of stage A, called for j = 0, 1, ... in turn (eliminate's
// window): writes its optics rows (tau and tau_og sum the layers above
// it), its values of stage B and its single-scattering term (single_form
// 0: p_single_hg at cos_theta; the legendre form: the weights w_single),
// and returns its coefficients
template <int S>
struct ReflLayer {
  const Col& c;
  mutable float tau = 0.0f, tau_og = 0.0f;
  __device__ Coef<S> operator()(int j) const {
    const Params& p = c.p;
    const Optics o = optics(c, j, S);
    c.s(R_DTAU, j) = o.dtau;
    c.s(R_TAU, j) = tau;
    c.s(R_W0, j) = o.w0;
    c.s(R_W0_OG, j) = o.w0_og;
    c.s(R_DTAU_OG, j) = o.dtau_og;
    c.s(R_TAU_OG, j) = tau_og;
    tau = tau + o.dtau;
    tau_og = tau_og + o.dtau_og;
    const float fdm = p.dedd ? ipow(o.cosb_og, S) : 0.0f;
    ReflVals<S> v;
    w_expansions<S>(p, p.w_multi_form, p.w_multi_rayleigh, o.cosb_og, o.ftc,
                    o.ftr, fdm, v.wm);
    coeffs(v, o.w0, o.dtau, v.wm);
    float ws[S];
    w_expansions<S>(p, p.w_single_form, p.w_single_rayleigh, o.cosb_og,
                    o.ftc, o.ftr, fdm, ws);
    const float f0pi = p.f0pi[c.w];
#pragma unroll
    for (int l = 0; l < S; ++l) v.bf[l] = f0pi * (o.w0 * ws[l]);
    refl_values<S>(v, [&](int slot, float& x) { c.s(slot, j) = x; });
    if (p.single_form == 0) {
      c.s(kSingle<S>, j) =
          p_single_hg(p, o.cosb_og, o.ftc, o.ftr, p.cos_theta[0]);
    } else {
#pragma unroll
      for (int l = 0; l < S; ++l) c.s(kSingle<S> + l, j) = ws[l];
    }
    return v;
  }
};

// the replay record of block row k: slot kRec holds the swap flags as the
// bits of an int, then the inverses, then the multipliers
template <int S>
__device__ void store_record(const Col& c, int k, const GJ<S>& g) {
  int bits = 0, bit = 0, slot = kRec<S> + 1;
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int r = i + 1; r < S; ++r) bits |= (int)g.sw[i][r] << bit++;
  }
  c.s(kRec<S>, k) = __int_as_float(bits);
#pragma unroll
  for (int i = 0; i < S; ++i) c.s(slot++, k) = g.inv[i];
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int r = 0; r < S; ++r) {
      if (r != i) c.s(slot++, k) = g.fac[i][r];
    }
  }
}

template <int S>
__device__ GJ<S> load_record(const Col& c, int k) {
  GJ<S> g;
  const int bits = __float_as_int(c.s(kRec<S>, k));
  int bit = 0, slot = kRec<S> + 1;
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int r = i + 1; r < S; ++r) g.sw[i][r] = (bits >> bit++) & 1;
  }
#pragma unroll
  for (int i = 0; i < S; ++i) g.inv[i] = c.s(slot++, k);
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int r = 0; r < S; ++r) {
      if (r != i) g.fac[i][r] = c.s(slot++, k);
    }
  }
  return g;
}

// the beam source of layer j for one angle at the layer's top (zd) and
// bottom (zu); v = the layer's stored values
template <int S>
__device__ void beam_rows(const Col& c, const ReflVals<S>& v, int j, float u0,
                          float zd[S], float zu[S]) {
  const Beam<S> bm = beam(v, u0);
  const float ex_dn = expf(-clip35(c.s(R_TAU, j) / bm.u0b));
  const float ex_up = expf(-clip35(c.s(R_TAU, j + 1) / bm.u0b));
#pragma unroll
  for (int i = 0; i < S; ++i) {
    zd[i] = bm.z[i] * ex_dn;
    zu[i] = bm.z[i] * ex_up;
  }
}

// stage A: one top-down loop over the layers (ReflLayer in eliminate's
// window), Cp[k] and the replay record of every block row
template <int S>
__global__ void __launch_bounds__(kThreads)
    sh_reflected_columns(const Params p) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.nwno) return;
  const Col c{p, w};
  const ReflLayer<S> layer{c};
  eliminate<S>(c, layer, kCp, p.sr[w],
               [&](int k, const Coef<S>&, const Coef<S>&, const Coef<S>&,
                   const GJ<S>& g) { store_record<S>(c, k, g); });
  c.s(R_TAU, p.nlayer) = layer.tau;
  c.s(R_TAU_OG, p.nlayer) = layer.tau_og;
}

// Registers of stage B: at most 65536 / (256 * min blocks) a thread (SH4
// 72, so 3 blocks of 8 warps fit an SM; (256, 4) holds it to 64 and
// spills 24 B, and carrying fewer values from layer to layer to fit 64
// without a spill made SH4 at 5 angles and SH2 slower; SH2 56, under its
// bound)
template <int S> constexpr int kAnglesMinBlocks = S == 4 ? 3 : 4;

// stage B: one thread per (column, angle).  Block b holds column tile
// b / chunks and angle chunk b % chunks: threadIdx.x is the column in the
// tile, threadIdx.y the angle in the chunk (blockDim.y angles per chunk,
// at most kMaxAngles)
template <int S>
__global__ void __launch_bounds__(kTileCols * kMaxAngles, kAnglesMinBlocks<S>)
    sh_reflected_angles(const Params p, int chunks) {
  constexpr int H = S / 2;
  const long long w =
      (long long)(blockIdx.x / chunks) * kTileCols + threadIdx.x;
  const int a = (blockIdx.x % chunks) * blockDim.y + threadIdx.y;
  if (w >= p.nwno || a >= p.nang) return;
  const Col c{p, w};
  const int L = p.nlayer;
  const int dp0 = kDp<S> + S * a;  // this angle's Dp rows
  const float sr = p.sr[w], f0pi = p.f0pi[w];
  const float u0 = p.u0[a], u1 = p.u1[a];
  const float bt = p.b_top;
  const float btv[2] = {bt, -bt / 4.0f};

  // Top down: D[k] (pallas_sh.py:_stage_system) from z_up of layer k-1,
  // z_down/z_up of layer k and z_down of layer k+1; the Schur update of
  // its top rows with F(k-1) Dp[k-1]; the replay of block row k's record.
  // Kept from step to step: z_up of layer k, the top rows of D[k], the top
  // rows of F of layer k and the Schur products F(k-1)[i][kk] Dp[k-1][kk].
  float zu[S], dtop[H], fn[H][S], schur[H][S], d[S];
  {
    const ReflVals<S> v = load_values<S>(c, 0);
    float zd[S];
    beam_rows<S>(c, v, 0, u0, zd, zu);
#pragma unroll
    for (int i = 0; i < H; ++i) {
      dtop[i] = btv[i] - zd[i];
#pragma unroll
      for (int j = 0; j < S; ++j) fn[i][j] = v.F(i, j);
    }
  }
  for (int k = 0; k < L; ++k) {
#pragma unroll
    for (int i = 0; i < H; ++i) d[i] = dtop[i];
    float f[H][S];
#pragma unroll
    for (int i = 0; i < H; ++i) {
#pragma unroll
      for (int j = 0; j < S; ++j) f[i][j] = fn[i][j];
    }
    if (k < L - 1) {
      const ReflVals<S> v = load_values<S>(c, k + 1);
      float zd[S], zu_next[S];
      beam_rows<S>(c, v, k + 1, u0, zd, zu_next);
#pragma unroll
      for (int i = 0; i < H; ++i) {
        dtop[i] = zd[i] - zu[i];
#pragma unroll
        for (int j = 0; j < S; ++j) fn[i][j] = v.F(i, j);
      }
#pragma unroll
      for (int i = H; i < S; ++i) d[i] = zd[i] - zu[i];
#pragma unroll
      for (int i = 0; i < S; ++i) zu[i] = zu_next[i];
    } else {
      const float bs = sr * u0 * f0pi * expf(-clip35(c.s(R_TAU, L) / u0));
      const float bsv[2] = {bs, -bs / 4.0f};
#pragma unroll
      for (int i = H; i < S; ++i)
        d[i] = bsv[i - H] - zu[i] + sr * zu[i - H];
    }
    if (k > 0) {
#pragma unroll
      for (int i = 0; i < H; ++i) {
#pragma unroll
        for (int kk = 0; kk < S; ++kk) d[i] = d[i] - schur[i][kk];
      }
    }
    replay<S>(load_record<S>(c, k), d);
#pragma unroll
    for (int i = 0; i < S; ++i) c.s(dp0 + i, k) = d[i];
#pragma unroll
    for (int i = 0; i < H; ++i) {
#pragma unroll
      for (int kk = 0; kk < S; ++kk) schur[i][kk] = f[i][kk] * d[kk];
    }
  }

  // Bottom up: X[k] = Dp[k] - Cp[k] X[k+1] (X[L-1] = Dp[L-1], still in d),
  // and the TOA intensity sweep with it
  float P0[4], P1[4];
  legp(-u0, P0);
  legp(u1, P1);
  float x = 0.0f;
  float (&X)[S] = d;
  for (int k = L - 1; k >= 0; --k) {
    if (k < L - 1) {
      float Xn[S];
#pragma unroll
      for (int i = 0; i < S; ++i) {
        float acc = c.s(dp0 + i, k);
#pragma unroll
        for (int j = 0; j < S; ++j)
          acc = acc - c.s(kCp + S * i + j, k) * X[j];
        Xn[i] = acc;
      }
#pragma unroll
      for (int i = 0; i < S; ++i) X[i] = Xn[i];
    }
    const float dtau = c.s(R_DTAU, k), tau_k = c.s(R_TAU, k);
    const float w0 = c.s(R_W0, k);
    const ReflVals<S> cf = load_values<S>(c, k);
    const float* wm = cf.wm;
    const Beam<S> bm = beam(cf, u0);
    if (k == L - 1) {
      float flux_bot = cf.F(H, 0) * X[0];
#pragma unroll
      for (int m = 1; m < S; ++m) flux_bot = flux_bot + cf.F(H, m) * X[m];
      flux_bot = flux_bot + bm.z[H] * expf(-clip35(c.s(R_TAU, L) / bm.u0b));
      x = flux_bot / kPi;
    }
    const float u0b = bm.u0b;
    const float mus = (u1 + u0b) / (u1 * u0b);
    const float exptrm_mus = -expm1_(-clip35(mus * dtau)) / mus;
    const float expon1 = exptrm_mus * expf(-clip35(tau_k / u0b));
    const float trans = expf(-clip35(dtau / u1));
    float ms;
    if constexpr (S == 4) {
      ms = homogeneous4(cf, wm, P1, X, u1, dtau, trans);
#pragma unroll
      for (int j = 0; j < 4; ++j) ms = ms + wm[j] * P1[j] * bm.eta[j] * expon1;
    } else {
      const float lam = cf.lam[0], q = cf.q;
      const float alpha = 1.0f / u1 + lam, beta = 1.0f / u1 - lam;
      const float alp = -expm1_(-clip35(alpha * dtau)) / alpha;
      const float bet = scaled_bet(cf.ex[0], trans, beta, dtau);
      ms = X[0] * (wm[0] - wm[1] * u1 * q) * alp
           + X[1] * (wm[0] + wm[1] * u1 * q) * bet
           + wm[0] * (bm.eta[0] * expon1) + wm[1] * u1 * (bm.eta[1] * expon1);
    }
    float ps;
    if (p.single_form != 0) {  // legendre form, from the stored weights
      ps = 0.0f;
#pragma unroll
      for (int l = 0; l < S; ++l)
        ps = ps + c.s(kSingle<S> + l, k) * P0[l] * P1[l];
    } else {
      ps = c.s(kSingle<S>, k);
    }
    const float em_mus1 = -expm1_(-clip35(mus * c.s(R_DTAU_OG, k)));
    const float intgrl =
        w0 * ms
        + c.s(R_W0_OG, k) * f0pi / k4Pi * ps * em_mus1
              * expf(-clip35(c.s(R_TAU_OG, k) / u0)) / mus;
    x = x * trans + intgrl / u1;
  }
  p.out[(long long)a * p.nwno + w] = x;
}

// ---------------------------------------------------------------------
// thermal (pallas_sh.py:_sh{4,2}_thermal_core), delta-scaled dtau/w0
// ---------------------------------------------------------------------
template <int S>
__device__ void thermal_w(const Params& p, float cosb_og, float wm[S]) {
  const float ff = p.dedd ? ipow(cosb_og, S) : 0.0f;
#pragma unroll
  for (int l = 0; l < S; ++l)
    wm[l] = (float)(2 * l + 1) * (ipow(cosb_og, l) - ff) / (1.0f - ff);
}

// the layer values of the sweep, which stage A stores for stage B, in
// slot order: f(slot, value) for lam, ex, then R, Q, Sg (SH4) or q (SH2),
// a0, a1, wm
template <int S, class F>
__device__ void sweep_values(Coef<S>& cf, float wm[S], const F& f) {
  constexpr int H = S / 2;
  int slot = kThermCoef<S>;
#pragma unroll
  for (int m = 0; m < H; ++m) f(slot++, cf.lam[m]);
#pragma unroll
  for (int m = 0; m < H; ++m) f(slot++, cf.ex[m]);
  if constexpr (S == 4) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      f(slot++, cf.R[m]);
      f(slot++, cf.Q[m]);
      f(slot++, cf.Sg[m]);
    }
  } else {
    f(slot++, cf.q);
  }
  f(slot++, cf.a[0]);
  f(slot++, cf.a[1]);
#pragma unroll
  for (int l = 0; l < S; ++l) f(slot++, wm[l]);
}

// stage A's state of layer j: its coefficients, b1 (the Planck slope over
// the layer) and the thermal source at its top (zd) and bottom (zu)
template <int S>
struct ThermState : Coef<S> {
  float zd[S], zu[S], b1;
};

// layer j of stage A: writes its dtau and w0 and the sweep's layer values,
// and returns its state
template <int S>
struct ThermLayer {
  const Col& c;
  __device__ ThermState<S> operator()(int j) const {
    const Params& p = c.p;
    const Optics o = optics(c, j, S);
    c.s(T_DTAU, j) = o.dtau;
    c.s(T_W0, j) = o.w0;
    const float dtau = o.dtau, w0 = o.w0;
    float wm[S];
    thermal_w<S>(p, o.cosb_og, wm);
    ThermState<S> t;
    coeffs(t, w0, dtau, wm);
    sweep_values<S>(t, wm, [&](int slot, float& v) { c.s(slot, j) = v; });
    const float b0 = c.in(p.all_b, j);
    const float b1 = (c.in(p.all_b, j + 1) - b0) / dtau;
    t.b1 = b1;
    const float a0 = t.a[0], a1 = t.a[1];
    const float pref = (1.0f - w0) / a0 * 2.0f * kPi;
    t.zd[0] = pref * (b0 / 2.0f - b1 / a1);
    t.zu[0] = pref * (b0 / 2.0f - b1 / a1 + b1 * dtau / 2.0f);
    t.zd[S / 2] = pref * (b0 / 2.0f + b1 / a1);
    t.zu[S / 2] = pref * (b0 / 2.0f + b1 / a1 + b1 * dtau / 2.0f);
    if constexpr (S == 4) {
      const float pref2 = -0.5f * (1.0f - w0) / (4.0f * a0) * 2.0f * kPi;
      t.zd[1] = t.zd[3] = pref2 * b0;
      t.zu[1] = t.zu[3] = pref2 * (b0 + b1 * dtau);
    }
    return t;
  }
};

// stage A: one top-down loop over the layers, each layer's coefficients
// computed once (the window of eliminate); D[k] (pallas_sh.py:
// _stage_system) is built in registers from z_up of layer k-1, z_down and
// z_up of layer k and z_down of layer k+1, updated by F(k-1) Dp[k-1] in its
// top rows, and solved by block row k's step.  Then X = the back-
// substituted Dp.
template <int S>
__global__ void __launch_bounds__(kThreads)
    sh_thermal_columns(const Params p) {
  constexpr int H = S / 2;
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.nwno) return;
  const Col c{p, w};
  const int L = p.nlayer;
  const float sr = p.sr[w];
  const float ab_last = c.in(p.all_b, L);
  float dp[S];  // Dp[k - 1]
  eliminate<S>(
      c, ThermLayer<S>{c}, kThermCp, sr,
      [&](int k, const ThermState<S>& prev, const ThermState<S>& cur,
          const ThermState<S>& next, const GJ<S>& g) {
        float d[S];
        if (k == 0) {
          const float b0 = c.in(p.all_b, 0);
          const float tau_top = c.s(T_DTAU, 0) * p.ptfac[0];
          const float bt = kPi * (1.0f - expf(-tau_top / 0.5f)) * b0;
          const float btv[2] = {bt, -bt / 4.0f};
#pragma unroll
          for (int i = 0; i < H; ++i) d[i] = btv[i] - cur.zd[i];
        } else {
#pragma unroll
          for (int i = 0; i < H; ++i) d[i] = cur.zd[i] - prev.zu[i];
        }
        if (k == L - 1) {
          const float bsv[2] = {
              p.hard_surface ? kPi * ab_last : kPi * (ab_last + cur.b1 * 0.5f),
              -kPi * ab_last / 4.0f};
#pragma unroll
          for (int i = H; i < S; ++i)
            d[i] = bsv[i - H] - cur.zu[i] + sr * cur.zu[i - H];
        } else {
#pragma unroll
          for (int i = H; i < S; ++i) d[i] = next.zd[i] - cur.zu[i];
        }
        if (k > 0) {
#pragma unroll
          for (int i = 0; i < H; ++i) {
#pragma unroll
            for (int kk = 0; kk < S; ++kk)
              d[i] = d[i] - prev.F(i, kk) * dp[kk];
          }
        }
        replay<S>(g, d);
#pragma unroll
        for (int i = 0; i < S; ++i) {
          dp[i] = d[i];
          c.s(kThermX<S> + i, k) = d[i];
        }
      });
  back_substitute<S>(c, kThermCp, kThermX<S>);
}

// stage B: one thread per (column, angle), blocks as sh_reflected_angles;
// the bottom-up TOA sweep of its angle over X[k] and the layer values
// stage A stored.  No minimum-blocks bound: it takes 48 registers at either
// stream count unbounded; (256, 6) held it to 40, spilled 28 B at SH4 and
// was 1-3 % slower.
template <int S>
__global__ void __launch_bounds__(kTileCols * kMaxAngles)
    sh_thermal_angles(const Params p, int chunks) {
  const long long w =
      (long long)(blockIdx.x / chunks) * kTileCols + threadIdx.x;
  const int a = (blockIdx.x % chunks) * blockDim.y + threadIdx.y;
  if (w >= p.nwno || a >= p.nang) return;
  const Col c{p, w};
  const int L = p.nlayer;
  const float ab_last = c.in(p.all_b, L);
  const float b1_last =
      (ab_last - c.in(p.all_b, L - 1)) / c.s(T_DTAU, L - 1);
  const float u1 = p.u1[a];
  float P1[4];
  legp(u1, P1);
  float x = p.hard_surface ? ab_last * 2.0f * kPi
                           : (ab_last + b1_last * u1) * 2.0f * kPi;
  for (int k = L - 1; k >= 0; --k) {
    const float dtau = c.s(T_DTAU, k), w0 = c.s(T_W0, k);
    float wm[S], X[S];
    Coef<S> cf;
    sweep_values<S>(cf, wm, [&](int slot, float& v) { v = c.s(slot, k); });
#pragma unroll
    for (int i = 0; i < S; ++i) X[i] = c.s(kThermX<S> + i, k);
    const float b0 = c.in(p.all_b, k);
    const float b1 = (c.in(p.all_b, k + 1) - b0) / dtau;
    const float em = -expm1_(-clip35(dtau / u1));
    const float expdtau = 1.0f - em;
    const float a0 = cf.a[0], a1 = cf.a[1];
    const float planck = b0 * em + b1 * (u1 - (dtau + u1) * expdtau);
    float ms;
    if constexpr (S == 4) {
      ms = homogeneous4(cf, wm, P1, X, u1, dtau, expdtau);
      const float nint0 = wm[0] * ((1.0f - w0) * u1 / a0 * planck);
      const float nint1 =
          wm[1] * u1 * ((1.0f - w0) * u1 / a0 * (b1 * em / a1));
      ms = ms + nint0 + nint1;
    } else {
      const float lam = cf.lam[0], q = cf.q;
      const float alpha = 1.0f / u1 + lam, beta = 1.0f / u1 - lam;
      const float alp = -expm1_(-clip35(alpha * dtau)) / alpha;
      const float bet = scaled_bet(cf.ex[0], expdtau, beta, dtau);
      ms = X[0] * (wm[0] - wm[1] * u1 * q) * alp
           + X[1] * (wm[0] + wm[1] * u1 * q) * bet
           + wm[0] * ((1.0f - w0) * u1 / a0 * planck)
           + wm[1] * u1 * ((1.0f - w0) * u1 / a0 * (b1 * em / a1));
    }
    const float intgrl =
        w0 * ms * 2.0f * kPi + k2Pi * (1.0f - w0) * u1 * planck;
    x = x * expdtau + intgrl / u1;
  }
  p.out[(long long)a * p.nwno + w] = x;
}

int blocks(int nwno) { return (nwno + kThreads - 1) / kThreads; }

// stage B's grid: tiles of kTileCols columns times chunks of at most
// kMaxAngles angles, per_chunk angles (blockDim.y) each
struct AngleGrid {
  int chunks, per_chunk, blocks;
};

AngleGrid angle_grid(const Params& p) {
  const int chunks = (p.nang + kMaxAngles - 1) / kMaxAngles;
  const int per_chunk = (p.nang + chunks - 1) / chunks;
  const int tiles = (p.nwno + kTileCols - 1) / kTileCols;
  return {chunks, per_chunk, tiles * chunks};
}

Params thermal_params(const void* all_b, const void* taugas,
                      const void* tauray, const void* cld_opd,
                      const void* cld_w0, const void* cld_g0, const void* rf,
                      const void* surf_reflect, const void* ubar1,
                      const void* ptfac, void* out, void* scratch, int nlayer,
                      int nwno, int nang, int delta_eddington,
                      int hard_surface) {
  Params p = {};
  p.all_b = (const float*)all_b;
  p.taugas = (const float*)taugas;
  p.tauray = (const float*)tauray;
  p.cld_opd = (const float*)cld_opd;
  p.cld_w0 = (const float*)cld_w0;
  p.cld_g0 = (const float*)cld_g0;
  p.rf = (const float*)rf;
  p.sr = (const float*)surf_reflect;
  p.u1 = (const float*)ubar1;
  p.ptfac = (const float*)ptfac;
  p.out = (float*)out;
  p.scr = (float*)scratch;
  p.nlayer = nlayer;
  p.nwno = nwno;
  p.ld = scratch_row(nwno);
  p.nang = nang;
  p.dedd = delta_eddington;
  p.hard_surface = hard_surface;
  return p;
}

Params reflected_params(
    const void* taugas, const void* tauray, const void* cld_opd,
    const void* cld_w0, const void* cld_g0, const void* rf,
    const void* surf_reflect, const void* F0PI, const void* ubar0,
    const void* ubar1, const void* cos_theta, void* out, void* scratch,
    int nlayer, int nwno, int nang, int delta_eddington, int w_single_form,
    int w_multi_form, int psingle_form, int w_single_rayleigh,
    int w_multi_rayleigh, int psingle_rayleigh, int single_form,
    float frac_a, float frac_b, float frac_c, float constant_back,
    float constant_forward, float b_top, float cf_pow, float cb_pow) {
  Params p = {};
  p.taugas = (const float*)taugas;
  p.tauray = (const float*)tauray;
  p.cld_opd = (const float*)cld_opd;
  p.cld_w0 = (const float*)cld_w0;
  p.cld_g0 = (const float*)cld_g0;
  p.rf = (const float*)rf;
  p.sr = (const float*)surf_reflect;
  p.f0pi = (const float*)F0PI;
  p.u0 = (const float*)ubar0;
  p.u1 = (const float*)ubar1;
  p.cos_theta = (const float*)cos_theta;
  p.out = (float*)out;
  p.scr = (float*)scratch;
  p.nlayer = nlayer;
  p.nwno = nwno;
  p.ld = scratch_row(nwno);
  p.nang = nang;
  p.dedd = delta_eddington;
  p.w_single_form = w_single_form;
  p.w_multi_form = w_multi_form;
  p.psingle_form = psingle_form;
  p.w_single_rayleigh = w_single_rayleigh;
  p.w_multi_rayleigh = w_multi_rayleigh;
  p.psingle_rayleigh = psingle_rayleigh;
  p.single_form = single_form;
  p.frac_a = frac_a;
  p.frac_b = frac_b;
  p.frac_c = frac_c;
  p.constant_back = constant_back;
  p.constant_forward = constant_forward;
  p.b_top = b_top;
  p.cf_pow = cf_pow;
  p.cb_pow = cb_pow;
  return p;
}

#ifdef __CUDACC__
// stage 0 (A: sh_*_columns, one thread per column) or stage 1 (B:
// sh_*_angles, one per column and angle) of a kernel; the cudaError_t
template <int S>
int launch_reflected(const Params& p, int stage, cudaStream_t s) {
  if (stage == 0) {
    sh_reflected_columns<S><<<blocks(p.nwno), kThreads, 0, s>>>(p);
  } else if (stage == 1) {
    if (p.nang < 1) return (int)cudaSuccess;  // no angle to solve
    const AngleGrid g = angle_grid(p);
    sh_reflected_angles<S><<<g.blocks, dim3(kTileCols, g.per_chunk), 0, s>>>(
        p, g.chunks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int S>
int launch_thermal(const Params& p, int stage, cudaStream_t s) {
  if (stage == 0) {
    sh_thermal_columns<S><<<blocks(p.nwno), kThreads, 0, s>>>(p);
  } else if (stage == 1) {
    if (p.nang < 1) return (int)cudaSuccess;  // no angle to sweep
    const AngleGrid g = angle_grid(p);
    sh_thermal_angles<S><<<g.blocks, dim3(kTileCols, g.per_chunk), 0, s>>>(
        p, g.chunks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#else
// one kernel's two stages on the host: stage A's threads (columns), then
// stage B's (angles)
template <class Columns, class Angles>
int run_host(const Params& p, Columns columns, Angles angles) {
  blockDim = {kThreads, 1, 1};
  threadIdx.y = 0;
  for (int b = 0; b < blocks(p.nwno); ++b) {
    blockIdx.x = b;
    for (int t = 0; t < kThreads; ++t) {
      threadIdx.x = t;
      columns(p);
    }
  }
  if (p.nang < 1) return 0;
  const AngleGrid g = angle_grid(p);
  blockDim = {kTileCols, (unsigned)g.per_chunk, 1};
  for (int b = 0; b < g.blocks; ++b) {
    blockIdx.x = b;
    for (int y = 0; y < g.per_chunk; ++y) {
      threadIdx.y = y;
      for (int x = 0; x < kTileCols; ++x) {
        threadIdx.x = x;
        angles(p, g.chunks);
      }
    }
  }
  return 0;
}
#endif

}  // namespace

// scratch slots ([nlayer + 1, sh_scratch_row(nwno)] each) of the SH
// kernels
extern "C" int sh_scratch_row(int nwno) { return scratch_row(nwno); }

extern "C" int sh_reflected_scratch_slots(int stream, int nang) {
  if (stream == 4) return kDp<4> + 4 * nang;
  if (stream == 2) return kDp<2> + 2 * nang;
  return -1;
}

extern "C" int sh_thermal_scratch_slots(int stream) {
  if (stream == 4) return kThermScratch<4>;
  if (stream == 2) return kThermScratch<2>;
  return -1;
}

#ifdef __CUDACC__
// Launches one stage (0: A, 1: B) of the reflected kernel and returns its
// cudaError_t; the wrapper calls it for stage 0, then stage 1, on one
// stream.
extern "C" int sh_reflected_launch(
    int stream, const void* taugas, const void* tauray, const void* cld_opd,
    const void* cld_w0, const void* cld_g0, const void* rf,
    const void* surf_reflect, const void* F0PI, const void* ubar0,
    const void* ubar1, const void* cos_theta, void* out, void* scratch,
    int nlayer, int nwno, int nang, int delta_eddington, int w_single_form,
    int w_multi_form, int psingle_form, int w_single_rayleigh,
    int w_multi_rayleigh, int psingle_rayleigh, int single_form,
    float frac_a, float frac_b, float frac_c, float constant_back,
    float constant_forward, float b_top, float cf_pow, float cb_pow,
    int stage, void* cuda_stream) {
  const Params p = reflected_params(
      taugas, tauray, cld_opd, cld_w0, cld_g0, rf, surf_reflect, F0PI, ubar0,
      ubar1, cos_theta, out, scratch, nlayer, nwno, nang, delta_eddington,
      w_single_form, w_multi_form, psingle_form, w_single_rayleigh,
      w_multi_rayleigh, psingle_rayleigh, single_form, frac_a, frac_b, frac_c,
      constant_back, constant_forward, b_top, cf_pow, cb_pow);
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  if (stream == 4) return launch_reflected<4>(p, stage, s);
  if (stream == 2) return launch_reflected<2>(p, stage, s);
  return (int)cudaErrorInvalidValue;
}

// Launches one stage (0: A, 1: B) of the thermal kernel and returns its
// cudaError_t; the wrapper calls it for stage 0, then stage 1, on one
// stream.
extern "C" int sh_thermal_launch(
    int stream, const void* all_b, const void* taugas, const void* tauray,
    const void* cld_opd, const void* cld_w0, const void* cld_g0,
    const void* rf, const void* surf_reflect, const void* ubar1,
    const void* ptfac, void* out, void* scratch, int nlayer, int nwno,
    int nang, int delta_eddington, int hard_surface, int stage,
    void* cuda_stream) {
  const Params p = thermal_params(
      all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf, surf_reflect, ubar1,
      ptfac, out, scratch, nlayer, nwno, nang, delta_eddington, hard_surface);
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  if (stream == 4) return launch_thermal<4>(p, stage, s);
  if (stream == 2) return launch_thermal<2>(p, stage, s);
  return (int)cudaErrorInvalidValue;
}
#else
// sh_reflected_launch's arguments without stage and stream, on host
// memory: both stages run to completion; 0, or -1 for another stream count
extern "C" int sh_reflected_host(
    int stream, const void* taugas, const void* tauray, const void* cld_opd,
    const void* cld_w0, const void* cld_g0, const void* rf,
    const void* surf_reflect, const void* F0PI, const void* ubar0,
    const void* ubar1, const void* cos_theta, void* out, void* scratch,
    int nlayer, int nwno, int nang, int delta_eddington, int w_single_form,
    int w_multi_form, int psingle_form, int w_single_rayleigh,
    int w_multi_rayleigh, int psingle_rayleigh, int single_form,
    float frac_a, float frac_b, float frac_c, float constant_back,
    float constant_forward, float b_top, float cf_pow, float cb_pow) {
  const Params p = reflected_params(
      taugas, tauray, cld_opd, cld_w0, cld_g0, rf, surf_reflect, F0PI, ubar0,
      ubar1, cos_theta, out, scratch, nlayer, nwno, nang, delta_eddington,
      w_single_form, w_multi_form, psingle_form, w_single_rayleigh,
      w_multi_rayleigh, psingle_rayleigh, single_form, frac_a, frac_b, frac_c,
      constant_back, constant_forward, b_top, cf_pow, cb_pow);
  if (stream == 4)
    return run_host(p, sh_reflected_columns<4>, sh_reflected_angles<4>);
  if (stream == 2)
    return run_host(p, sh_reflected_columns<2>, sh_reflected_angles<2>);
  return -1;
}

// sh_thermal_launch's arguments without stage and stream, on host memory:
// both stages run to completion; 0, or -1 for another stream count
extern "C" int sh_thermal_host(
    int stream, const void* all_b, const void* taugas, const void* tauray,
    const void* cld_opd, const void* cld_w0, const void* cld_g0,
    const void* rf, const void* surf_reflect, const void* ubar1,
    const void* ptfac, void* out, void* scratch, int nlayer, int nwno,
    int nang, int delta_eddington, int hard_surface) {
  const Params p = thermal_params(
      all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf, surf_reflect, ubar1,
      ptfac, out, scratch, nlayer, nwno, nang, delta_eddington, hard_surface);
  if (stream == 4)
    return run_host(p, sh_thermal_columns<4>, sh_thermal_angles<4>);
  if (stream == 2)
    return run_host(p, sh_thermal_columns<2>, sh_thermal_angles<2>);
  return -1;
}
#endif
