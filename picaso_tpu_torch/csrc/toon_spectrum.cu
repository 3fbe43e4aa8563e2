// Toon89 reflected and thermal spectra for every wavenumber column.
//
// Replaces five TPU kernels of picaso_tpu/rt/pallas_toon.py, all built from
// the same column routines, each in two launches (stage A, then stage B):
//   K2 spectrum_pallas_fused  <- toon_spectrum_kernel + reflected_angles_kernel
//   K3 reflected_pallas_fused <- toon_reflected_kernel<0> + reflected_angles_kernel
//   K4 thermal_pallas_fused   <- toon_thermal_columns<0> + toon_thermal_angles_kernel
//   K5 reflected_pallas       <- toon_reflected_kernel<1> + reflected_angles_kernel
//   K6 thermal_pallas         <- toon_thermal_columns<1> + toon_thermal_angles_kernel
// (_optics_block, _reflected_core, _thermal_core, _solve_two_stream_scratch).
// Per wavenumber column the reflected pass takes the delta-Eddington and OG
// optics of each layer (built from the six source strips, or read from the
// given props: one small interface, Optics), solves the Toon89 eqn-44
// tridiagonal system for the reflected beam (factorisation shared by all
// disk angles, one right-hand side per angle) and runs the TOA intensity
// recursion with the single-scattering phase function.  The thermal pass
// takes the OG optics with the no-Raman albedo (from the strips, or given),
// solves the thermal two-stream system and runs the per-angle
// source-function up-sweep.  Outputs xint and thermal, each [nang, nwno].
//
// What bounds it on this card: fp32 expf and division, and the chain of
// dependent layer steps (elimination up, substitution down, intensity sweep
// up); only the wavenumber axis and, for the reflected beam, the disk-angle
// axis are parallel.  The first design ran everything of a column in one
// thread and was bounded by three things: the angles ran one after another
// (reflected: three dependent 90-step sweeps per angle after the shared
// factorisation, 15 chained sweeps per thread at 5 angles, 108 at a phase
// curve's 36; thermal: one source-function sweep per angle after the
// column's solve, each layer step an expf and about eight divisions), where
// the TPU kernel advances all angles in one loop step on its lane axis;
// 50 000 threads are about 12 warps per SM of 64, too few to hide the
// latency of those chains; and each angle re-read the column's
// angle-independent layer state from global scratch (reflected: about 28 of
// 40 accesses per layer and angle, about 3.6 GB per launch at the
// production shape from a 437 MB scratch; thermal: 11 rows, 200 MB), which
// does not fit the 50 MB L2.
//
// Design: both passes are split in two launches on one stream.
//  Stage A, one thread per column: the reflected layer optics and the
//  angle-independent factorisation into the kReflSlots rows
//  (toon_spectrum_kernel, toon_reflected_kernel), or the thermal layer
//  values and the thermal solve, which leaves positive/negative in the
//  kThermSlots rows (toon_thermal_columns).  K2's stage A also runs the
//  whole thermal pass, solve and angles, in the same thread.
//  Stage B, one thread per (column, angle) (reflected_angles_kernel,
//  toon_thermal_angles_kernel): a block is 32 consecutive columns by up to 8
//  angles, one warp per angle, so every access still coalesces and the
//  warps of one column tile read the same angle-independent rows at about
//  the same time (from L1 or L2, not from HBM once per angle); more angles
//  are cut into chunks of at most 8, the chunks of one tile in neighbouring
//  blocks.  The angles' sweeps run in parallel on nang times as many
//  threads, and the stage has its own register budget.  Only the reflected
//  right-hand side DSE/DSO is kept per angle (kAngleSlots); the beam sources
//  c+up, c-up and e_u0dt are computed again in the ascent by the same
//  expressions, and each thermal angle sweeps the rows stage A wrote, so the
//  outputs are bitwise those of the one-thread design.
//
// Per-layer intermediates go to global scratch laid out [slot, row, nwno],
// so the 32 threads of a warp touch 128 contiguous bytes per access; the
// wrapper allocates it (the kernels allocate nothing): kReflSlots +
// kAngleSlots * nang for the reflected pass, kThermSlots for the thermal
// one.  The arithmetic follows the TPU kernel, not the JAX scan path:
// stable gama = g2/(g1+lamda), exptrm_minus = 1/exptrm_positive, the
// e_u0dt/e_u1 products in place of extra exps, product-form resonant
// limits, exp clip 10, beam dither 1e-3, resonance switch 1e-4 with the
// 1e-6 sign-preserving clamp.  Expressions keep the twin's (and the TPU
// kernel's) order of operations; built with -fmad=false, each operation
// rounds as the eager PyTorch twin's does.
//
// Without nvcc (__CUDACC__ undefined) the file compiles as host C++
// (g++ -std=c++17 -ffp-contract=off -x c++): the qualifiers are empty, the
// thread indices are globals, and toon_thermal_host runs the thermal stages'
// threads as loops (tests/test_torch_toon_thermal_host.py).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#include <math.h>
#define __device__
#define __global__
#define __launch_bounds__(...)
namespace {
struct HostDim3 {
  unsigned x = 0, y = 0, z = 0;
};
HostDim3 blockIdx, blockDim, threadIdx;
}  // namespace
#endif

namespace {

constexpr int kThreads = 128;   // stage A: one thread per column
constexpr int kTileCols = 32;   // stage B: one warp = 32 columns, one angle
constexpr int kMaxAngles = 8;   // stage B: angles per block
constexpr float kClip = 10.0f;                        // _exp_clip(f32)
constexpr float kPi = (float)3.141592653589793;
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);
constexpr float kHalfInvPi = (float)(0.5 / 3.141592653589793);
constexpr float k4Pi = (float)(4.0 * 3.141592653589793);
constexpr float kSq3 = (float)1.7320508075688772;
constexpr float kUbar2Fac = (float)(3.0 * 0.767 * 0.767);
constexpr float kDitherDelta = 1e-3f;
constexpr float kOnePlusDelta = (float)(1.0 + 1e-3);

// angle-independent reflected scratch slots (stage A), each [nlayer + 1,
// nwno]; kAngleSlots per disk angle follow them (stage B)
enum ReflSlot {
  S_DTAU, S_TAU, S_W0, S_COSB, S_FTC, S_GCOS2, S_DTAU_OG, S_TAU_OG, S_W0_OG,
  S_LAM, S_GAMA, S_EP, S_G1, S_G2, S_PSINGLE,
  S_ASE, S_ASO, S_XE, S_XO,              // reflected factorisation
  kReflSlots
};
enum AngleSlot { A_DSE, A_DSO, kAngleSlots };

// thermal scratch slots, each [nlayer + 1, nwno]
enum ThermSlot {
  T_DTAU, T_LAM, T_GAMA, T_EP, T_EPM, T_B1, T_GPG, T_ASE, T_ASO, T_DSE,
  T_DSO, kThermSlots
};

struct Params {
  // the six source strips [nlayer, nwno] and the level Planck function
  const float *all_b, *taugas, *tauray, *cld_opd, *cld_w0, *cld_g0, *rf;
  // precomputed optics: the reflected_pallas fields (tau, tau_og
  // [nlevel, nwno]), or dtau/w0/cosb/tau_top [nwno] of thermal_pallas
  const float *dtau, *tau, *w0, *cosb, *gcos2, *ftau_cld, *ftau_ray;
  const float *dtau_og, *tau_og, *w0_og, *cosb_og, *tau_top;
  const float *sr, *f0pi, *u0, *u1, *cos_theta, *ptfac;
  float *xint, *therm, *scr, *tscr;  // tscr: the thermal slots
  int nlayer, nwno, nang;
  int single_phase, multi_phase, toon_coef;
  float frac_a, frac_b, frac_c, constant_back, constant_forward, b_top;
  int stream, dedd, hard_surface;
};

// one thread's view of its column (and, in stage B, of its angle a)
struct Col {
  const Params& p;
  long long w;
  int a;
  __device__ float& s(int slot, int row) const {
    return p.scr[((long long)slot * (p.nlayer + 1) + row) * p.nwno + w];
  }
  __device__ float& d(int slot, int row) const {
    return s(kReflSlots + kAngleSlots * a + slot, row);
  }
  __device__ float& t(int slot, int row) const {
    return p.tscr[((long long)slot * (p.nlayer + 1) + row) * p.nwno + w];
  }
  __device__ float in(const float* a, int row) const {
    return a[(long long)row * p.nwno + w];
  }
};

// x**n as repeated products (the TPU kernel's integer pow)
__device__ float ipow(float x, int n) {
  const int m = n < 0 ? -n : n;
  float r = m == 0 ? 1.0f : x;
  for (int i = 1; i < m; ++i) r = r * x;
  return n < 0 ? 1.0f / r : r;
}

__device__ float cube(float x) { return x * x * x; }

__device__ float safe_den(float den) {
  return fabsf(den) < 1e-6f ? (den < 0.0f ? -1e-6f : 1e-6f) : den;
}

// num/den with the analytic limit near den = 0 (|den|-only rule)
__device__ float resonant_ratio(float num, float den, float limit) {
  return fabsf(den) < 1e-4f ? limit : num / safe_den(den);
}

__device__ float dither_u0(float lam, float u0) {
  return fabsf(lam * u0 - 1.0f) < kDitherDelta
             ? 1.0f / (lam * kOnePlusDelta) : u0;
}

// gama and the e1..e4 combinations of one layer
struct ERow {
  float g, e1, e2, e3, e4;
};

__device__ ERow erow(float gama, float ep) {
  const float em = 1.0f / ep;
  return {gama, ep + gama * em, ep - gama * em, gama * ep + em,
          gama * ep - em};
}

// the four particular-solution sources of one layer
struct CRow {
  float cpu, cmu, cpd, cmd;
};

// Toon89 eqn-44 rows of layer n (odd: ao bo co do; even: ae be ce de),
// with em1/ep1 the layers above/below; tridiag.setup_tri_diag.
struct Coef {
  float ao, bo, co, d_o, ae, be, ce, de;
};

__device__ Coef coef(int n, int L, const ERow& em1, const ERow& e,
                     const ERow& ep1, const CRow& cm1, const CRow& c,
                     const CRow& cp1, float b_top, float b_surface,
                     float sr) {
  Coef k;
  if (n == 0) {
    k.ao = 0.0f;
    k.bo = e.g + 1.0f;
    k.co = e.g - 1.0f;
    k.d_o = b_top - c.cmu;
  } else {
    k.ao = 2.0f * (1.0f - em1.g * em1.g);
    k.bo = (em1.e1 - em1.e3) * (e.g + 1.0f);
    k.co = (em1.e1 + em1.e3) * (e.g - 1.0f);
    k.d_o = em1.e3 * (c.cpu - cm1.cpd) + em1.e1 * (cm1.cmd - c.cmu);
  }
  if (n < L - 1) {
    k.ae = (e.e1 + e.e3) * (ep1.g - 1.0f);
    k.be = (e.e2 + e.e4) * (ep1.g - 1.0f);
    k.ce = 2.0f * (1.0f - ep1.g * ep1.g);
    k.de = (ep1.g - 1.0f) * (cp1.cpu - c.cpd)
           + (1.0f - ep1.g) * (c.cmd - cp1.cmu);
  } else {
    k.ae = e.e1 - sr * e.e3;
    k.be = e.e2 - sr * e.e4;
    k.ce = 0.0f;
    k.de = b_surface - c.cpd + sr * c.cmd;
  }
  return k;
}

__device__ ERow refl_e(const Col& c, int j) {
  return erow(c.s(S_GAMA, j), c.s(S_EP, j));
}

// reflected beam sources of one layer for incidence u0, and e_u0dt; the
// elimination and the intensity ascent both compute them from the same
// layer values, so they round the same in both
__device__ CRow beam(int toon_coef, float ftc, float cosb, float w0,
                     float lam, float g1, float g2, float tau, float dtau,
                     float u0, float f0pi, float& e_u0dt) {
  const float g3 = toon_coef == 1
                       ? (2.0f - 3.0f * ftc * cosb * u0) / 4.0f
                       : 0.5f * (1.0f - kSq3 * ftc * cosb * u0);
  const float g4 = 1.0f - g3;
  const float u0b = dither_u0(lam, u0);
  const float denominator = lam * lam - 1.0f / (u0b * u0b);
  const float a_minus =
      f0pi * w0 * (g4 * (g1 + 1.0f / u0b) + g2 * g3) / denominator;
  const float a_plus =
      f0pi * w0 * (g3 * (g1 - 1.0f / u0b) + g2 * g4) / denominator;
  const float x_up = expf(-tau / u0b);
  e_u0dt = expf(-dtau / u0b);
  const float x_dn = x_up * e_u0dt;
  return {a_plus * x_up, a_minus * x_up, a_plus * x_dn, a_minus * x_dn};
}

__device__ CRow refl_c(const Col& c, int j, float u0, float f0pi) {
  float e_u0dt;
  return beam(c.p.toon_coef, c.s(S_FTC, j), c.s(S_COSB, j), c.s(S_W0, j),
              c.s(S_LAM, j), c.s(S_G1, j), c.s(S_G2, j), c.s(S_TAU, j),
              c.s(S_DTAU, j), u0, f0pi, e_u0dt);
}

__device__ ERow therm_e(const Col& c, int j) {
  return erow(c.t(T_GAMA, j), c.t(T_EP, j));
}

__device__ CRow therm_c(const Col& c, int j) {
  const float twopimu = kPi;  // 2 * pi * mu1 with mu1 = 0.5
  const float b0 = c.in(c.p.all_b, j), b1 = c.t(T_B1, j);
  const float dtau = c.t(T_DTAU, j), gpg = c.t(T_GPG, j);
  return {twopimu * (b0 + b1 * gpg), twopimu * (b0 - b1 * gpg),
          twopimu * (b0 + b1 * dtau + b1 * gpg),
          twopimu * (b0 + b1 * dtau - b1 * gpg)};
}

// ---------------------------------------------------------------------
// per-layer optics of the reflected pass: built from the six strips
// (pallas_toon.py:_optics_block, combine_optics' default branch) or read
// from a precomputed RTProps (reflected_pallas; test_mode lands here)
// ---------------------------------------------------------------------
struct Optics {
  float dtau, w0, cosb, ftau_cld, ftau_ray, gcos2, dtau_og, w0_og, cosb_og;
};

__device__ Optics strip_optics(const Col& c, int j) {
  const Params& p = c.p;
  const float tg = c.in(p.taugas, j), tr = c.in(p.tauray, j);
  const float copd = c.in(p.cld_opd, j), cw0 = c.in(p.cld_w0, j);
  const float cg0 = c.in(p.cld_g0, j), rf = c.in(p.rf, j);
  Optics o;
  o.dtau_og = tg + tr + copd;
  const float cldw = cw0 * copd;
  o.ftau_cld = cldw / (cldw + tr);
  o.ftau_ray = tr / (tr + cldw);
  o.gcos2 = 0.5f * o.ftau_ray;
  o.w0_og = (tr * rf + cldw) / o.dtau_og;
  o.cosb_og = cg0;
  o.dtau = o.dtau_og;
  o.w0 = o.w0_og;
  o.cosb = o.cosb_og;
  if (p.dedd) {
    const float f = ipow(o.cosb_og, p.stream);
    o.w0 = o.w0_og * (1.0f - f) / (1.0f - o.w0_og * f);
    o.cosb = (o.cosb_og - f) / (1.0f - f);
    o.dtau = o.dtau_og * (1.0f - o.w0_og * f);
  }
  return o;
}

__device__ Optics prop_optics(const Col& c, int j) {
  const Params& p = c.p;
  return {c.in(p.dtau, j),     c.in(p.w0, j),       c.in(p.cosb, j),
          c.in(p.ftau_cld, j), c.in(p.ftau_ray, j), c.in(p.gcos2, j),
          c.in(p.dtau_og, j),  c.in(p.w0_og, j),    c.in(p.cosb_og, j)};
}

// the per-layer reflected two-stream quantities, top down; level taus
// are running sums of the built optics, or the given tau/tau_og
template <bool kProps>
__device__ void reflected_layers(const Col& c, float ct) {
  const Params& p = c.p;
  const int L = p.nlayer;
  float tau = 0.0f, tau_og = 0.0f;
  for (int j = 0; j < L; ++j) {
    Optics o;
    if constexpr (kProps) {
      o = prop_optics(c, j);
      tau = c.in(p.tau, j);
      tau_og = c.in(p.tau_og, j);
    } else {
      o = strip_optics(c, j);
    }
    c.s(S_TAU, j) = tau;
    c.s(S_TAU_OG, j) = tau_og;
    tau = tau + o.dtau;
    tau_og = tau_og + o.dtau_og;

    const float w0 = o.w0, cosb = o.cosb, ftau_cld = o.ftau_cld;
    const float cosb_og = o.cosb_og;
    float g1, g2;
    if (p.toon_coef == 1) {
      g1 = (7.0f - w0 * (4.0f + 3.0f * ftau_cld * cosb)) / 4.0f;
      g2 = -(1.0f - w0 * (4.0f - 3.0f * ftau_cld * cosb)) / 4.0f;
    } else {
      g1 = (kSq3 * 0.5f) * (2.0f - w0 * (1.0f + ftau_cld * cosb));
      g2 = (kSq3 * w0 * 0.5f) * (1.0f - ftau_cld * cosb);
    }
    const float lam = sqrtf(g1 * g1 - g2 * g2);
    const float gama = g2 / (g1 + lam);
    const float ep = expf(fminf(lam * o.dtau, kClip));

    float p_single;
    if (p.single_phase == 1) {  // OTHG
      p_single = (1.0f - cosb_og * cosb_og)
                 / sqrtf(cube(1.0f + cosb_og * cosb_og + 2.0f * cosb_og * ct));
    } else {
      const float g_fwd = p.constant_forward * cosb_og;
      const float g_back = p.constant_back * cosb_og;
      const float fc = p.frac_c;
      const float g_back_pow = fc == truncf(fc)
                                   ? ipow(g_back, (int)fc)
                                   : expf(fc * logf(fabsf(g_back)));
      const float f = p.frac_a + p.frac_b * g_back_pow;
      const float hg_fwd = (1.0f - g_fwd * g_fwd)
                           / sqrtf(cube(1.0f + g_fwd * g_fwd + 2.0f * g_fwd * ct));
      const float hg_back = (1.0f - g_back * g_back)
                            / sqrtf(cube(1.0f + g_back * g_back + 2.0f * g_back * ct));
      if (p.single_phase == 0) {         // cahoy
        p_single = f * hg_fwd + (1.0f - f) * hg_back + o.gcos2;
      } else if (p.single_phase == 2) {  // TTHG
        p_single = f * hg_fwd + (1.0f - f) * hg_back;
      } else {                           // TTHG_ray
        p_single = ftau_cld * (f * hg_fwd + (1.0f - f) * hg_back)
                   + o.ftau_ray * (0.75f * (1.0f + ct * ct));
      }
    }
    c.s(S_DTAU, j) = o.dtau;
    c.s(S_W0, j) = w0;
    c.s(S_COSB, j) = cosb;
    c.s(S_FTC, j) = ftau_cld;
    c.s(S_GCOS2, j) = o.gcos2;
    c.s(S_DTAU_OG, j) = o.dtau_og;
    c.s(S_W0_OG, j) = o.w0_og;
    c.s(S_LAM, j) = lam;
    c.s(S_GAMA, j) = gama;
    c.s(S_EP, j) = ep;
    c.s(S_G1, j) = g1;
    c.s(S_G2, j) = g2;
    c.s(S_PSINGLE, j) = p_single;
  }
  if constexpr (kProps) {
    tau = c.in(p.tau, L);
    tau_og = c.in(p.tau_og, L);
  }
  c.s(S_TAU, L) = tau;
  c.s(S_TAU_OG, L) = tau_og;
}

// angle-independent factorisation of the reflected system, bottom up
__device__ void reflected_factor(const Col& c, float sr) {
  const int L = c.p.nlayer;
  const CRow z = {0.0f, 0.0f, 0.0f, 0.0f};
  ERow ep1 = refl_e(c, L - 1), e = ep1, em1 = refl_e(c, L - 2);
  Coef k = coef(L - 1, L, em1, e, ep1, z, z, z, 0.0f, 0.0f, sr);
  const float as_last = k.ae / k.be;
  const float xo_l = 1.0f / (k.bo - k.co * as_last);
  float as_n = k.ao * xo_l;
  c.s(S_ASE, L - 1) = as_last;
  c.s(S_ASO, L - 1) = as_n;
  c.s(S_XO, L - 1) = xo_l;
  for (int n = L - 2; n >= 0; --n) {
    ep1 = e;
    e = em1;
    if (n > 0) em1 = refl_e(c, n - 1);
    k = coef(n, L, em1, e, ep1, z, z, z, 0.0f, 0.0f, sr);
    const float xe = 1.0f / (k.be - k.ce * as_n);
    const float as_e = k.ae * xe;
    const float xo = 1.0f / (k.bo - k.co * as_e);
    as_n = k.ao * xo;
    c.s(S_ASE, n) = as_e;
    c.s(S_ASO, n) = as_n;
    c.s(S_XE, n) = xe;
    c.s(S_XO, n) = xo;
  }
}

// one disk angle of the reflected solve and the TOA intensity (stage B)
__device__ float reflected_angle(const Col& c, float u0, float u1, float sr,
                                 float f0pi) {
  const Params& p = c.p;
  const int L = p.nlayer;
  // right-hand sides, reverse elimination (shared factorisation)
  ERow ep1 = refl_e(c, L - 1), e = ep1, em1 = refl_e(c, L - 2);
  CRow cp1 = refl_c(c, L - 1, u0, f0pi), cc = cp1;
  CRow cm1 = refl_c(c, L - 2, u0, f0pi);
  const float cpd_last = cc.cpd;
  const float b_surface =
      sr * u0 * f0pi * expf(-c.s(S_TAU, L) / u0);
  Coef k = coef(L - 1, L, em1, e, ep1, cm1, cc, cp1, p.b_top, b_surface, sr);
  const float ds_last = k.de / k.be;
  float ds_n = (k.d_o - k.co * ds_last) * c.s(S_XO, L - 1);
  c.d(A_DSE, L - 1) = ds_last;
  c.d(A_DSO, L - 1) = ds_n;
  for (int n = L - 2; n >= 0; --n) {
    ep1 = e;
    e = em1;
    cp1 = cc;
    cc = cm1;
    if (n > 0) {
      em1 = refl_e(c, n - 1);
      cm1 = refl_c(c, n - 1, u0, f0pi);
    }
    k = coef(n, L, em1, e, ep1, cm1, cc, cp1, p.b_top, b_surface, sr);
    const float xe = c.s(S_XE, n), xo = c.s(S_XO, n);
    const float ce_x = k.ce * xe;
    const float co_x = k.co * xo;
    const float ds_e = k.de * xe - ce_x * ds_n;
    ds_n = k.d_o * xo - co_x * ds_e;
    c.d(A_DSE, n) = ds_e;
    c.d(A_DSO, n) = ds_n;
  }
  // forward substitution; positive/negative replace ds in place
  float x_o = c.d(A_DSO, 0);
  float x_e = c.d(A_DSE, 0) - c.s(S_ASE, 0) * x_o;
  c.d(A_DSO, 0) = x_o + x_e;
  c.d(A_DSE, 0) = x_o - x_e;
  for (int n = 1; n < L; ++n) {
    x_o = c.d(A_DSO, n) - c.s(S_ASO, n) * x_e;
    x_e = c.d(A_DSE, n) - c.s(S_ASE, n) * x_o;
    c.d(A_DSO, n) = x_o + x_e;
    c.d(A_DSE, n) = x_o - x_e;
  }
  // TOA intensity: ascend from the bottom boundary
  const float ep_l = c.s(S_EP, L - 1);
  const float flux_zero = c.d(A_DSO, L - 1) * ep_l
                          + c.s(S_GAMA, L - 1) * c.d(A_DSE, L - 1)
                                * (1.0f / ep_l)
                          + cpd_last;
  float x = flux_zero / kPi;
  for (int j = L - 1; j >= 0; --j) {
    const float positive = c.d(A_DSO, j), negative = c.d(A_DSE, j);
    const float ftc = c.s(S_FTC, j), cosb = c.s(S_COSB, j);
    const float gama = c.s(S_GAMA, j), w0 = c.s(S_W0, j);
    const float lam = c.s(S_LAM, j), dtau = c.s(S_DTAU, j);
    const float ep = c.s(S_EP, j);
    const float em = 1.0f / ep;
    float e_u0dt;
    const CRow cj = beam(p.toon_coef, ftc, cosb, w0, lam, c.s(S_G1, j),
                         c.s(S_G2, j), c.s(S_TAU, j), dtau, u0, f0pi, e_u0dt);
    float multi_plus, multi_minus;
    if (p.multi_phase == 0) {
      const float gcos2 = c.s(S_GCOS2, j);
      multi_plus = 1.0f + 1.5f * ftc * cosb * u1
                   + gcos2 * (kUbar2Fac * u1 * u1 - 1.0f) / 2.0f;
      multi_minus = 1.0f - 1.5f * ftc * cosb * u1
                    + gcos2 * (kUbar2Fac * u1 * u1 - 1.0f) / 2.0f;
    } else if (p.multi_phase == 1) {
      multi_plus = 1.0f + 1.5f * ftc * cosb * u1;
      multi_minus = 1.0f - 1.5f * ftc * cosb * u1;
    } else {  // isotropic (picaso_tpu/rt/toon.py:276-282)
      multi_plus = 1.0f;
      multi_minus = 1.0f;
    }
    const float G =
        positive * (multi_plus + gama * multi_minus) * w0 * kHalfInvPi;
    const float H =
        negative * (gama * multi_plus + multi_minus) * w0 * kHalfInvPi;
    const float A = (multi_plus * cj.cpu + multi_minus * cj.cmu)
                    * w0 * kHalfInvPi;
    const float e_u1 = expf(-dtau / u1);
    const float ssterm = (c.s(S_W0_OG, j) * f0pi / k4Pi)
                         * c.s(S_PSINGLE, j)
                         * expf(-c.s(S_TAU_OG, j) / u0)
                         * (1.0f - expf(-c.s(S_DTAU_OG, j) * (u0 + u1)
                                        / (u0 * u1)))
                         * (u0 / (u0 + u1));
    const float den_u1 = lam * u1 - 1.0f;
    const float hdt1 = dtau / u1;
    const float x1 = hdt1 * den_u1;
    const float msterm =
        A * (1.0f - e_u0dt * e_u1) * (u0 / (u0 + u1))
        + G * resonant_ratio(ep * e_u1 - 1.0f, den_u1,
                             hdt1 * (1.0f + x1 * (0.5f + x1 / 6.0f)))
        + H * (1.0f - em * e_u1) / (lam * u1 + 1.0f);
    x = x * e_u1 + (ssterm + msterm);
  }
  return x;
}

// ---------------------------------------------------------------------
// thermal (pallas_toon.py:_thermal_core) on the OG optics with the no-Raman
// albedo: built from the strips (_thermal_kernel_fused) or given
// (thermal_pallas)
// ---------------------------------------------------------------------
template <bool kProps>
__device__ void thermal_layers(const Col& c) {
  const Params& p = c.p;
  for (int j = 0; j < p.nlayer; ++j) {
    float dtau, w0, cosb;
    if constexpr (kProps) {
      dtau = c.in(p.dtau, j);
      w0 = c.in(p.w0, j);
      cosb = c.in(p.cosb, j);
    } else {
      dtau = c.in(p.taugas, j) + c.in(p.tauray, j) + c.in(p.cld_opd, j);
      w0 = (c.in(p.tauray, j) * 0.99999f
            + c.in(p.cld_w0, j) * c.in(p.cld_opd, j)) / dtau;
      cosb = c.in(p.cld_g0, j);
    }
    const float b0 = c.in(p.all_b, j);
    const float b1 = (c.in(p.all_b, j + 1) - b0) / dtau;
    const float g1 = 2.0f - w0 * (1.0f + cosb);
    const float g2 = w0 * (1.0f - cosb);
    const float lam = sqrtf(g1 * g1 - g2 * g2);
    const float exptrm = fminf(lam * dtau, kClip);
    c.t(T_DTAU, j) = dtau;
    c.t(T_LAM, j) = lam;
    c.t(T_GAMA, j) = g2 / (g1 + lam);
    c.t(T_GPG, j) = 1.0f / (g1 + g2);
    c.t(T_B1, j) = b1;
    c.t(T_EP, j) = expf(exptrm);
    c.t(T_EPM, j) = expf(0.5f * exptrm);
  }
}

// thermal tridiagonal solve (_solve_two_stream_scratch); leaves
// positive/negative in T_DSO/T_DSE
__device__ void thermal_solve(const Col& c, float sr, float tau_top) {
  const Params& p = c.p;
  const int L = p.nlayer;
  const float b_top =
      (1.0f - expf(-tau_top / 0.5f)) * c.in(p.all_b, 0) * kPi;
  const float b_surface =
      p.hard_surface ? (1.0f - sr) * c.in(p.all_b, L) * kPi
                     : (c.in(p.all_b, L) + c.t(T_B1, L - 1) * 0.5f) * kPi;
  ERow ep1 = therm_e(c, L - 1), e = ep1, em1 = therm_e(c, L - 2);
  CRow cp1 = therm_c(c, L - 1), cc = cp1, cm1 = therm_c(c, L - 2);
  Coef k = coef(L - 1, L, em1, e, ep1, cm1, cc, cp1, b_top, b_surface, sr);
  const float as_last = k.ae / k.be;
  const float ds_last = k.de / k.be;
  const float xo_l = 1.0f / (k.bo - k.co * as_last);
  float as_n = k.ao * xo_l;
  float ds_n = (k.d_o - k.co * ds_last) * xo_l;
  c.t(T_ASE, L - 1) = as_last;
  c.t(T_DSE, L - 1) = ds_last;
  c.t(T_ASO, L - 1) = as_n;
  c.t(T_DSO, L - 1) = ds_n;
  for (int n = L - 2; n >= 0; --n) {
    ep1 = e;
    e = em1;
    cp1 = cc;
    cc = cm1;
    if (n > 0) {
      em1 = therm_e(c, n - 1);
      cm1 = therm_c(c, n - 1);
    }
    k = coef(n, L, em1, e, ep1, cm1, cc, cp1, b_top, b_surface, sr);
    const float xe = 1.0f / (k.be - k.ce * as_n);
    const float as_e = k.ae * xe;
    const float ds_e = (k.de - k.ce * ds_n) * xe;
    const float xo = 1.0f / (k.bo - k.co * as_e);
    as_n = k.ao * xo;
    ds_n = (k.d_o - k.co * ds_e) * xo;
    c.t(T_ASE, n) = as_e;
    c.t(T_DSE, n) = ds_e;
    c.t(T_ASO, n) = as_n;
    c.t(T_DSO, n) = ds_n;
  }
  float x_o = c.t(T_DSO, 0);
  float x_e = c.t(T_DSE, 0) - c.t(T_ASE, 0) * x_o;
  c.t(T_DSO, 0) = x_o + x_e;
  c.t(T_DSE, 0) = x_o - x_e;
  for (int n = 1; n < L; ++n) {
    x_o = c.t(T_DSO, n) - c.t(T_ASO, n) * x_e;
    x_e = c.t(T_DSE, n) - c.t(T_ASE, n) * x_o;
    c.t(T_DSO, n) = x_o + x_e;
    c.t(T_DSE, n) = x_o - x_e;
  }
}

// one disk angle of the source-function up-sweep: TOA thermal flux
__device__ float thermal_angle(const Col& c, float iubar, float sr) {
  const Params& p = c.p;
  const int L = p.nlayer;
  float fp = p.hard_surface
                 ? (1.0f - sr) * c.in(p.all_b, L) * 2.0f * kPi
                 : (c.in(p.all_b, L) + c.t(T_B1, L - 1) * iubar) * 2.0f * kPi;
  float fp_mid = fp;
  for (int j = L - 1; j >= 0; --j) {
    const float dtau = c.t(T_DTAU, j);
    const float lam = c.t(T_LAM, j), gama = c.t(T_GAMA, j);
    const float ep = c.t(T_EP, j), epm = c.t(T_EPM, j);
    const float em = 1.0f / ep, emm = 1.0f / epm;
    const float b0 = c.in(p.all_b, j), b1 = c.t(T_B1, j);
    const float G = (2.0f - lam) * c.t(T_DSO, j);
    const float H = gama * (lam + 2.0f) * c.t(T_DSE, j);
    const float alpha1 = kTwoPi * (b0 + b1 * (c.t(T_GPG, j) - 0.5f));
    const float alpha2 = kTwoPi * b1;
    const float eam = expf(-0.5f * dtau / iubar);
    const float ea = eam * eam;
    const float den = lam * iubar - 1.0f;
    const float hdt = dtau / iubar;
    const float xden = hdt * den;
    const float up_full =
        G * resonant_ratio(ep * ea - 1.0f, den,
                           hdt * (1.0f + xden * (0.5f + xden / 6.0f)))
        + H / (lam * iubar + 1.0f) * (1.0f - em * ea)
        + alpha1 * (1.0f - ea)
        + alpha2 * (iubar - (dtau + iubar) * ea);
    const float up_mid =
        G * resonant_ratio(ep * eam - epm, den,
                           epm * 0.5f * hdt
                               * (1.0f + 0.25f * xden + xden * xden / 24.0f))
        - H / (lam * iubar + 1.0f) * (em * eam - emm)
        + alpha1 * (1.0f - eam)
        + alpha2 * (iubar + 0.5f * dtau - (dtau + iubar) * eam);
    fp_mid = fp * eam + up_mid;
    fp = fp * ea + up_full;
  }
  return fp_mid;
}

// stage A of the reflected pass: the column's optics and factorisation
template <bool kProps>
__device__ void reflected_column(const Col& c) {
  reflected_layers<kProps>(c, c.p.cos_theta[0]);
  reflected_factor(c, c.p.sr[c.w]);
}

// stage A of the thermal pass: the column's layer values and its solve
template <bool kProps>
__device__ void thermal_column(const Col& c) {
  const Params& p = c.p;
  thermal_layers<kProps>(c);
  // fake isothermal layer above the model top (fluxes.py:1797-1800)
  const float tau_top =
      kProps ? p.tau_top[c.w] : c.t(T_DTAU, 0) * p.ptfac[0];
  thermal_solve(c, p.sr[c.w], tau_top);
}

// stage A of K2: reflected optics and factorisation, then the whole thermal
// pass in the same thread (the column, then each angle's sweep)
__global__ void __launch_bounds__(kThreads)
    toon_spectrum_kernel(const Params p) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.nwno) return;
  const Col c{p, w, 0};
  reflected_column<false>(c);
  thermal_column<false>(c);
  const float sr = p.sr[w];
  for (int a = 0; a < p.nang; ++a)
    p.therm[(long long)a * p.nwno + w] = thermal_angle(c, p.u1[a], sr);
}

// stage A of K3 (optics from the strips) and K5 (optics given)
template <bool kProps>
__global__ void __launch_bounds__(kThreads)
    toon_reflected_kernel(const Params p) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.nwno) return;
  reflected_column<kProps>(Col{p, w, 0});
}

// stage A of K4 (optics from the strips) and K6 (optics given)
template <bool kProps>
__global__ void __launch_bounds__(kThreads)
    toon_thermal_columns(const Params p) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= p.nwno) return;
  thermal_column<kProps>(Col{p, w, 0});
}

// stage B of K2, K3 and K5: one thread per (column, angle).  Block b holds
// column tile b / chunks and angle chunk b % chunks: threadIdx.x is the
// column in the tile, threadIdx.y the angle in the chunk (blockDim.y angles
// per chunk, at most kMaxAngles)
__global__ void __launch_bounds__(kTileCols * kMaxAngles, 4)
    reflected_angles_kernel(const Params p, int chunks) {
  const long long w =
      (long long)(blockIdx.x / chunks) * kTileCols + threadIdx.x;
  const int a = (blockIdx.x % chunks) * blockDim.y + threadIdx.y;
  if (w >= p.nwno || a >= p.nang) return;
  p.xint[(long long)a * p.nwno + w] =
      reflected_angle(Col{p, w, a}, p.u0[a], p.u1[a], p.sr[w], p.f0pi[w]);
}

// stage B of K4 and K6: one thread per (column, angle), blocks as
// reflected_angles_kernel; the source-function up-sweep of its angle over
// the rows stage A wrote.  No minimum-blocks bound: 40 registers unbounded
// and under (256, 4) alike; (256, 8) held it to 32 with a 4 B spill.
// Stage A storing G, H, alpha1 and alpha2 for it instead made K4 17 %
// slower at 5 angles (stage A +0.09 ms, stage B no faster).
__global__ void __launch_bounds__(kTileCols * kMaxAngles)
    toon_thermal_angles_kernel(const Params p, int chunks) {
  const long long w =
      (long long)(blockIdx.x / chunks) * kTileCols + threadIdx.x;
  const int a = (blockIdx.x % chunks) * blockDim.y + threadIdx.y;
  if (w >= p.nwno || a >= p.nang) return;
  p.therm[(long long)a * p.nwno + w] =
      thermal_angle(Col{p, w, a}, p.u1[a], p.sr[w]);
}

Params column_params(const void* surf_reflect, const void* ubar0,
                     const void* ubar1, void* scratch, int nlayer, int nwno,
                     int nang) {
  Params p{};
  p.sr = (const float*)surf_reflect;
  p.u0 = (const float*)ubar0;
  p.u1 = (const float*)ubar1;
  p.scr = (float*)scratch;
  p.nlayer = nlayer;
  p.nwno = nwno;
  p.nang = nang;
  return p;
}

void set_controls(Params& p, int single_phase, int multi_phase,
                  int toon_coefficients, float frac_a, float frac_b,
                  float frac_c, float constant_back, float constant_forward,
                  float b_top) {
  p.single_phase = single_phase;
  p.multi_phase = multi_phase;
  p.toon_coef = toon_coefficients;
  p.frac_a = frac_a;
  p.frac_b = frac_b;
  p.frac_c = frac_c;
  p.constant_back = constant_back;
  p.constant_forward = constant_forward;
  p.b_top = b_top;
}

void set_strips(Params& p, const void* taugas, const void* tauray,
                const void* cld_opd, const void* cld_w0, const void* cld_g0,
                const void* rf) {
  p.taugas = (const float*)taugas;
  p.tauray = (const float*)tauray;
  p.cld_opd = (const float*)cld_opd;
  p.cld_w0 = (const float*)cld_w0;
  p.cld_g0 = (const float*)cld_g0;
  p.rf = (const float*)rf;
}

// the thermal entries' common fields (K4 and K6); scratch holds the
// thermal slots
Params thermal_params(const void* all_b, const void* surf_reflect,
                      const void* ubar1, void* therm, void* scratch,
                      int nlayer, int nwno, int nang, int hard_surface) {
  Params p = column_params(surf_reflect, nullptr, ubar1, nullptr, nlayer,
                           nwno, nang);
  p.tscr = (float*)scratch;
  p.all_b = (const float*)all_b;
  p.therm = (float*)therm;
  p.hard_surface = hard_surface;
  return p;
}

void set_thermal_props(Params& p, const void* dtau, const void* w0,
                       const void* cosb, const void* tau_top) {
  p.dtau = (const float*)dtau;
  p.w0 = (const float*)w0;
  p.cosb = (const float*)cosb;
  p.tau_top = (const float*)tau_top;
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

long long refl_slots(int nang) {
  return kReflSlots + (long long)kAngleSlots * nang;
}

#ifdef __CUDACC__
// launch stage 0 (A: ``columns``, one thread per column) or stage 1 (B:
// ``angles``, one thread per column and angle) of a kernel; the cudaError_t
int launch_stage(const Params& p, int stage, void (*columns)(const Params),
                 void (*angles)(const Params, int), void* cuda_stream) {
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  if (stage == 0) {
    columns<<<blocks(p.nwno), kThreads, 0, s>>>(p);
  } else if (stage == 1) {
    if (p.nang < 1) return (int)cudaSuccess;  // no angle to solve
    const AngleGrid g = angle_grid(p);
    angles<<<g.blocks, dim3(kTileCols, g.per_chunk), 0, s>>>(p, g.chunks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
#else
// the thermal stages on the host: stage A's threads, then stage B's
template <bool kProps>
int run_thermal_host(const Params& p) {
  blockDim = {kThreads, 1, 1};
  threadIdx.y = 0;
  for (int b = 0; b < blocks(p.nwno); ++b) {
    blockIdx.x = b;
    for (int t = 0; t < kThreads; ++t) {
      threadIdx.x = t;
      toon_thermal_columns<kProps>(p);
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
        toon_thermal_angles_kernel(p, g.chunks);
      }
    }
  }
  return 0;
}
#endif

}  // namespace

// scratch slots ([nlayer + 1, nwno] each) of the Toon kernels at nang
// disk angles
extern "C" int toon_spectrum_scratch_slots(int nang) {
  return (int)refl_slots(nang) + kThermSlots;
}
extern "C" int toon_reflected_scratch_slots(int nang) {
  return (int)refl_slots(nang);
}
extern "C" int toon_thermal_scratch_slots(int) { return kThermSlots; }

#ifdef __CUDACC__
// Each entry launches one stage (0: A, 1: B) and returns its cudaError_t
// (cudaErrorInvalidValue for another stage); the wrapper calls it for
// stage 0, then stage 1, on one stream.

// spectrum_pallas_fused: scratch holds the reflected slots, then the
// thermal ones
extern "C" int toon_spectrum_launch(
    const void* all_b, const void* taugas, const void* tauray,
    const void* cld_opd, const void* cld_w0, const void* cld_g0,
    const void* rf, const void* surf_reflect, const void* F0PI,
    const void* ubar0, const void* ubar1, const void* cos_theta,
    const void* ptfac, void* xint, void* therm, void* scratch, int nlayer,
    int nwno, int nang, int single_phase, int multi_phase,
    int toon_coefficients, float frac_a, float frac_b, float frac_c,
    float constant_back, float constant_forward, float b_top, int stream,
    int delta_eddington, int hard_surface, int stage, void* cuda_stream) {
  Params p = column_params(surf_reflect, ubar0, ubar1, scratch, nlayer, nwno,
                             nang);
  p.tscr = p.scr + refl_slots(nang) * (nlayer + 1) * nwno;
  set_strips(p, taugas, tauray, cld_opd, cld_w0, cld_g0, rf);
  set_controls(p, single_phase, multi_phase, toon_coefficients, frac_a,
               frac_b, frac_c, constant_back, constant_forward, b_top);
  p.all_b = (const float*)all_b;
  p.f0pi = (const float*)F0PI;
  p.cos_theta = (const float*)cos_theta;
  p.ptfac = (const float*)ptfac;
  p.xint = (float*)xint;
  p.therm = (float*)therm;
  p.stream = stream;
  p.dedd = delta_eddington;
  p.hard_surface = hard_surface;
  return launch_stage(p, stage, toon_spectrum_kernel, reflected_angles_kernel,
                      cuda_stream);
}

// reflected_pallas_fused
extern "C" int toon_reflected_launch(
    const void* taugas, const void* tauray, const void* cld_opd,
    const void* cld_w0, const void* cld_g0, const void* rf,
    const void* surf_reflect, const void* F0PI, const void* ubar0,
    const void* ubar1, const void* cos_theta, void* xint, void* scratch,
    int nlayer, int nwno, int nang, int single_phase, int multi_phase,
    int toon_coefficients, float frac_a, float frac_b, float frac_c,
    float constant_back, float constant_forward, float b_top, int stream,
    int delta_eddington, int stage, void* cuda_stream) {
  Params p = column_params(surf_reflect, ubar0, ubar1, scratch, nlayer, nwno,
                             nang);
  set_strips(p, taugas, tauray, cld_opd, cld_w0, cld_g0, rf);
  set_controls(p, single_phase, multi_phase, toon_coefficients, frac_a,
               frac_b, frac_c, constant_back, constant_forward, b_top);
  p.f0pi = (const float*)F0PI;
  p.cos_theta = (const float*)cos_theta;
  p.xint = (float*)xint;
  p.stream = stream;
  p.dedd = delta_eddington;
  return launch_stage(p, stage, toon_reflected_kernel<false>,
                      reflected_angles_kernel, cuda_stream);
}

// thermal_pallas_fused
extern "C" int toon_thermal_launch(
    const void* all_b, const void* taugas, const void* tauray,
    const void* cld_opd, const void* cld_w0, const void* cld_g0,
    const void* ptfac, const void* surf_reflect, const void* ubar1,
    void* therm, void* scratch, int nlayer, int nwno, int nang,
    int hard_surface, int stage, void* cuda_stream) {
  Params p = thermal_params(all_b, surf_reflect, ubar1, therm, scratch,
                            nlayer, nwno, nang, hard_surface);
  set_strips(p, taugas, tauray, cld_opd, cld_w0, cld_g0, nullptr);
  p.ptfac = (const float*)ptfac;
  return launch_stage(p, stage, toon_thermal_columns<false>,
                      toon_thermal_angles_kernel, cuda_stream);
}

// reflected_pallas: the optics come as the 11 RTProps fields it reads
extern "C" int toon_reflected_props_launch(
    const void* dtau, const void* tau, const void* w0, const void* cosb,
    const void* gcos2, const void* ftau_cld, const void* ftau_ray,
    const void* dtau_og, const void* tau_og, const void* w0_og,
    const void* cosb_og, const void* surf_reflect, const void* F0PI,
    const void* ubar0, const void* ubar1, const void* cos_theta, void* xint,
    void* scratch, int nlayer, int nwno, int nang, int single_phase,
    int multi_phase, int toon_coefficients, float frac_a, float frac_b,
    float frac_c, float constant_back, float constant_forward, float b_top,
    int stage, void* cuda_stream) {
  Params p = column_params(surf_reflect, ubar0, ubar1, scratch, nlayer, nwno,
                             nang);
  p.dtau = (const float*)dtau;
  p.tau = (const float*)tau;
  p.w0 = (const float*)w0;
  p.cosb = (const float*)cosb;
  p.gcos2 = (const float*)gcos2;
  p.ftau_cld = (const float*)ftau_cld;
  p.ftau_ray = (const float*)ftau_ray;
  p.dtau_og = (const float*)dtau_og;
  p.tau_og = (const float*)tau_og;
  p.w0_og = (const float*)w0_og;
  p.cosb_og = (const float*)cosb_og;
  set_controls(p, single_phase, multi_phase, toon_coefficients, frac_a,
               frac_b, frac_c, constant_back, constant_forward, b_top);
  p.f0pi = (const float*)F0PI;
  p.cos_theta = (const float*)cos_theta;
  p.xint = (float*)xint;
  return launch_stage(p, stage, toon_reflected_kernel<true>,
                      reflected_angles_kernel, cuda_stream);
}

// thermal_pallas: dtau, w0, cosb [nlayer, nwno] and tau_top [nwno] given
extern "C" int toon_thermal_props_launch(
    const void* all_b, const void* dtau, const void* w0, const void* cosb,
    const void* tau_top, const void* surf_reflect, const void* ubar1,
    void* therm, void* scratch, int nlayer, int nwno, int nang,
    int hard_surface, int stage, void* cuda_stream) {
  Params p = thermal_params(all_b, surf_reflect, ubar1, therm, scratch,
                            nlayer, nwno, nang, hard_surface);
  set_thermal_props(p, dtau, w0, cosb, tau_top);
  return launch_stage(p, stage, toon_thermal_columns<true>,
                      toon_thermal_angles_kernel, cuda_stream);
}
#else
// K4's and K6's stages on host memory, run to completion: the arguments of
// toon_thermal_launch without stage and stream, with K6's dtau, w0, cosb
// and tau_top after ptfac; props picks what stage A reads (0: the strips
// and ptfac, as K4; 1: the given optics, as K6).  0, or -1 for another
// props.
extern "C" int toon_thermal_host(
    int props, const void* all_b, const void* taugas, const void* tauray,
    const void* cld_opd, const void* cld_w0, const void* cld_g0,
    const void* ptfac, const void* dtau, const void* w0, const void* cosb,
    const void* tau_top, const void* surf_reflect, const void* ubar1,
    void* therm, void* scratch, int nlayer, int nwno, int nang,
    int hard_surface) {
  Params p = thermal_params(all_b, surf_reflect, ubar1, therm, scratch,
                            nlayer, nwno, nang, hard_surface);
  set_strips(p, taugas, tauray, cld_opd, cld_w0, cld_g0, nullptr);
  p.ptfac = (const float*)ptfac;
  set_thermal_props(p, dtau, w0, cosb, tau_top);
  if (props == 0) return run_thermal_host<false>(p);
  if (props == 1) return run_thermal_host<true>(p);
  return -1;
}
#endif
