// Fused var-major DG volume tendencies for Hopper (sm_90a).
//
// One kernel template, two functions of the JAX package, for the
// configurations the Held-Suarez paths, the moist baroclinic wave and the
// isentropic vortex run (NV = 5 prognostic variables rho, rhou[3], rhoe,
// or NV = 6 with the advected rhoq_tot of EquilMoist; the reference
// pressure subtracted from the momentum flux or, with subtract = 0 (a
// NoReferenceState or a HydrostaticState that does not subtract), not,
// the Pallas bodies' subtract_ref branch, JAX pallas_volume.py:49 and
// :171):
//
//   * climatemachine_tpu/dg/pallas_volume.py:fused_volume_tendency_vm
//     (Pallas body _kernel_vm), the var-major RHS's: the pressure p is an
//     input; with or without the hyperdiffusive flux F2 of DryBiharmonic
//     (ngl = 4 chain variables u_h[3], h_tot) or, at NV = 6, of
//     EquilMoistBiharmonic (ngl = 5: q_tot too); with lin_dims = () or,
//     for a fused remainder, (2,), (0, 1) or (0, 1, 2) (the body's
//     lin_dims branch, :209-245).
//   * climatemachine_tpu/dg/pallas_volume.py:dry_volume_tendency (Pallas
//     body _kernel), the generic DG operator's: e_int, T and p are computed
//     from q and phi in the kernel; with lin_dims = () or, for a fused
//     remainder, (2,), (0, 1) or (0, 1, 2).  NV = 5 only.
//
// A fused remainder (the full model less a linear acoustic(-gravity)
// model, JAX spatial.py:867-883) subtracts the linear flux Flin on the
// derivative directions a in lin_dims only; with lin_gravity = False (the
// acoustic-only model) its energy coefficient is the reference enthalpy
// less phi.  The template parameter LIN holds lin_dims as a bit mask (bit
// a for direction a) and ACOUSTIC (bit 3) for lin_gravity = False: each
// branch is its own instantiation, and LIN = 0 is the code without it.
//
// Per element e, variable v and node n:
//
//   mf[v][a*Np + m] = M[m] * sum_i xi[3a+i][m] * F_i[v](m)  (+ F2, - Flin)
//   out[e][v][n]    = MI[n] * sum_k Wdiv[n][k] * mf[v][k],  k < 3*Np
//
//   F_i[rho] = rhou_i,  F_i[rhou_j] = rhou_j u_i + (p - p_ref) d_ij
//   (p d_ij with subtract = 0, when p_ref is neither staged nor read),
//   F_i[rhoe] = (rhoe + p) u_i,  F_i[rhoq_tot] = rhoq_tot u_i (NV = 6)
//   F2_i[rhou_j] = rho nu4 gl2[i][j],
//   F2_i[rhoe]   = nu4 sum_j rhou_j gl2[i][j] + rho nu4 gl2[i][3]
//   F2_i[rhoq_tot] = rho nu4q gl2[i][4]  (NV = 6)
//   (gl2[i][j] = d_i Laplacian(u_h, h_tot[, q_tot])_j, lane NG i + j of
//    [E][3 NG][Np], NG = NV - 1; nu4 lane 0, nu4q lane 1 of [E][2][Np])
//   dry thermo: e_int = (rhoe - (rhou . u) / 2) / rho - phi,
//               T = T_0 + e_int * (1/cv_d), p = rho R_d T
//   Flin_i[rho] = rhou_i, Flin_i[rhou_i] = pL, Flin_i[rhoe] = c rhou_i
//   with pL = rho R_d T_0 + (R_d/cv_d)(rhoe - rho phi),
//        c  = (rhoe_ref + p_ref) / rho_ref [- phi without gravity]
//   (ref3 = rhoe_ref, rho_ref, p_ref), subtracted from mf[v][a] for a in
//   lin_dims where the JAX kernel subtracts it: every i for rho and rhoe,
//   i = j for rhou_j, none for rhoq_tot.
//
// What bounds them: at p4 (Np = 125), E = 12288, the fluxes are ~111
// flops a node (217 with F2) and the weak divergence, sum-factorised
// along the lines of the Kronecker operator Wdiv (dg/line_ops.py), 2*5*15
// = 150 flops a node, against 23 floats read or written a node (26 with
// the remainder's ref3, 36 with F2 and nu4; one fewer without p_ref):
// bytes alone bound every branch, 0.042 ms (0.048 with ref3, 0.066 with
// F2, about 0.002 less without p_ref; the H100's 3.35 TB/s).  At NV = 6 with F2 (27 + 15 + 2 = 44 floats a node, ~250 flops)
// the bound is 0.081 ms.  Counted dense (the 3*Np terms a node of the kernel this design
// replaced), the contraction was 3750 flops a node and bound by the fp32
// pipes (0.089 ms, 0.091 with F2).
//
// Design (sum-factorised, bound by its bytes):
//   - persistent blocks of 256 threads walk tiles of TE = 4 elements (2 at
//     p5, Order<NQ>); each
//     tile's inputs (qv, p or phi, p_ref if subtract, xiv, M, MI; gl2 with F2; with
//     the remainder ref3, and phi beside p in the var-major kernel) are
//     contiguous runs, staged by TMA bulk copies
//     into one of two stages of shared memory while the block computes on
//     the other (tile_pipeline.cuh).  At NV = 5 only lane 0 (nu4) of nu
//     [E][2][Np] is read: at p4 its rows start 1000 bytes apart, 8-byte
//     aligned on odd elements, so each comes in a 512-byte copy from the
//     16-byte boundary below it, and the reader skips the shift; at NV =
//     6 both lanes are read, an element's 2 Np floats as one more run;
//   1. one thread per (element, node) builds the node's flux
//      (node_flux<KIND, NQ, NV>, the only part that differs between the
//      branches) and writes M * xi . F for NV variables x 3 directions
//      into the mf tile in shared memory ([TE][NV][3*Np]);
//   2. one thread per (element, node) contracts mf along the node's three
//      lines: for each direction the Nq weights of the node's line (the
//      line table in shared memory, the node's line start and position
//      precomputed) and Nq FMAs a variable, at node stride 1, Nq and
//      Nq^2 (a warp's reads span fewer than 32 consecutive words of a row:
//      no bank conflicts), 75 FMAs a node at p4;
//   3. scale by MI and store (one warp, 32 consecutive nodes of a row).
//   subtract is a uniform run-time flag, not a template parameter: its one
//   use is p_eff, and without it the p_ref run is not staged (a segment
//   of 0 floats issues no copy), so the branch costs no instantiations
//   (nvcc time) and no shared memory.
//   About 156 KB of shared memory a block with F2, 104 KB without at p4
//   (136 and 91 KB at p5); at NV = 6 with F2 182 KB at p4 (one block an
//   SM, as at NV = 5) and 159 KB at p5; the remainder's phi and ref3 add
//   16 KB at p4 (198 KB at NV = 6 with F2) and 14 KB at p5.  The line order NQ is a template
//   parameter, built for NQ = 2..6 (p1-p5, tile::by_order); the bench
//   shape is p4.
// Tensor cores have nothing to do here: 150 flops a node.
//
// Rounding: the flux pass rounds each product, sum and quotient as the
// plain PyTorch version does, in its order (__fmul_rn/__fadd_rn/__fsub_rn
// keep nvcc from contracting them into FMAs; 1/rho and the reference
// enthalpy are IEEE divisions; the constants are the float32 values of the
// Python scalars the plain version multiplies by), and the contraction
// accumulates k in ascending order with FMAs, as a GEMM does: direction
// a = 0's Nq entries, then a = 1's, then a = 2's, which is the float32
// number of the dense loop over all 3*Np terms (an FMA with an exact zero
// weight leaves the sum as it was).  On a near-hydrostatic state the
// divergence cancels to ~1e-5 of its terms, so a rounding difference in
// mf would show at about the 1e-5 * max|plain| the kernels are held to.

#include <cuda_runtime.h>

#include "tile_pipeline.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SMEM = 227 * 1024;  // dynamic shared memory a block

// The sizes at NQ nodes a line: NP nodes an element, mf's row of K (3
// directions), TE elements a tile (4; 2 at NQ = 6, where four would not
// fit in shared memory with F2 and every run is a multiple of 16 bytes
// an element), NU_SLOT floats a staged nu4 row (its floats + a shift of
// up to 3, rounded up to 4).
template <int NQ>
struct Order {
  static constexpr int NP = NQ * NQ * NQ;
  static constexpr int K = 3 * NP;
  static constexpr int TE = NQ < 6 ? 4 : 2;
  static constexpr int NU_SLOT = (NP + 3 + 3) / 4 * 4;
  static_assert(TE * NP % 4 == 0, "a tile's runs are 16-byte multiples");
};

// the flux branches (node_flux)
enum Kind { P_GIVEN = 0, P_GIVEN_F2 = 1, DRY = 2 };

// The remainder branch LIN: lin_dims as a bit mask (bit a: direction a)
// and ACOUSTIC for lin_gravity = False.  LIN = 0: no remainder.
constexpr int LIN_DIMS = 7, ACOUSTIC = 8;

struct Inputs {
  const float* qv;     // [E][5][Np]
  const float* p;      // [E][Np]     P_GIVEN*
  const float* phi;    // [E][Np]     DRY, or LIN
  const float* pref;   // [E][Np]
  const float* ref3;   // [E][3][Np]  LIN: rhoe_ref, rho_ref, p_ref
  const float* gl2;    // [E][3 NG][Np] P_GIVEN_F2
  const float* nu;     // [E][2][Np]  P_GIVEN_F2 (lane 0)
  const float* xiv;    // [E][9][Np]  xi_a,i at 3a+i
  const float* M;      // [E][Np]
  const float* MI;     // [E][Np]
  const float* lines;  // [3][NQ][NQ] Wdiv's line weights
  tile::Strides strides;  // node stride of each direction's lines
  float* out;          // [E][5][Np]
  float R_d, inv_cv, T_0, R_over_cv;   // DRY (inv_cv) or LIN
  int subtract;        // p_ref taken out of the momentum flux (read)
};

// Shared memory of a branch with NV variables, in 4-byte words: the two
// stage mbarriers, the line weights, each node's line (start | position <<
// 16) per direction; two stages of TE elements, each the tile's
// contiguous runs [qv | p or phi | p_ref | xiv | M | MI | gl2 (F2) | phi
// (a P_GIVEN* remainder) | ref3 (a remainder) | nu4 slots (NV = 5) or nu
// (NV = 6)]; the mf tile.  Every offset is a multiple of 4 words (16
// bytes); a run a branch does not read takes no room.
template <int KIND, int NQ, int NV, int LIN>
struct Layout {
  using O = Order<NQ>;
  static constexpr int NP = O::NP, K = O::K, TE = O::TE,
                       NU_SLOT = O::NU_SLOT;
  static constexpr bool F2 = KIND == P_GIVEN_F2;
  static constexpr bool REM = (LIN & LIN_DIMS) != 0;
  static constexpr bool DRYK = KIND == DRY;
  static constexpr bool PHI_RUN = REM && !DRYK;   // phi beside p
  static_assert(NV == 5 || (NV == 6 && !DRYK),
                "NV = 6 is a branch of fused_volume_tendency_vm only");
  static constexpr int NG = NV - 1;           // chain variables of F2
  static constexpr bool NU_ROWS = F2 && NV == 5;   // nu4 alone, by rows
  static constexpr bool NU_RUN = F2 && NV == 6;    // nu4 and nu4q, a run
  static constexpr int NSEG = 6 + (F2 ? 1 : 0) + (PHI_RUN ? 1 : 0) +
                              (REM ? 1 : 0) + (NU_RUN ? 1 : 0);
  static constexpr int LINES = 4, INFO = LINES + 3 * NQ * NQ;
  static constexpr int STAGE = (INFO + 3 * NP + 31) / 32 * 32;
  static constexpr int QV = 0, P = QV + TE * NV * NP, PREF = P + TE * NP,
                       XIV = PREF + TE * NP, M = XIV + TE * 9 * NP,
                       MI = M + TE * NP, EXTRA = MI + TE * NP;
  static constexpr int EXTRA_FLOATS = F2 ? 3 * NG * NP : 0;
  static constexpr int PHI = EXTRA + TE * EXTRA_FLOATS;
  static constexpr int PHI_FLOATS = PHI_RUN ? NP : 0;
  static constexpr int REF3 = PHI + TE * PHI_FLOATS;
  static constexpr int REF3_FLOATS = REM ? 3 * NP : 0;
  static constexpr int NU = REF3 + TE * REF3_FLOATS;
  static constexpr int NU_FLOATS = NU_ROWS ? NU_SLOT : NU_RUN ? 2 * NP : 0;
  static constexpr int STAGE_WORDS = (NU + TE * NU_FLOATS + 31) / 32 * 32;
  static constexpr int MF = STAGE + 2 * STAGE_WORDS;
  static constexpr size_t BYTES = 4 * (size_t)(MF + TE * NV * K);
  static_assert(BYTES <= MAX_SMEM, "the tile does not fit in shared memory");
};

// One element's staged inputs (pointers into a stage).
struct Elem {
  const float *qv, *p, *phi, *pref, *ref3, *gl2, *nu, *xiv, *M;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// Stage 1 for node n of a staged element: mfe[v * K + a * NP + n] for the
// NV variables and 3 directions.  s.nu is nu4's row; at NV = 6 nu4q's
// follows it, NP floats on.
template <int KIND, int NQ, int NV, int LIN>
__device__ __forceinline__ void node_flux(const Inputs& in, const Elem& s,
                                          int n, float* mfe) {
  constexpr int NP = Order<NQ>::NP, K = Order<NQ>::K, NG = NV - 1;
  constexpr bool REM = (LIN & LIN_DIMS) != 0;
  const float* q = s.qv + n;
  const float rho = q[0];
  const float ru[3] = {q[NP], q[2 * NP], q[3 * NP]};
  const float rhoe = q[4 * NP];
  const float inv_rho = 1.0f / rho;
  const float u[3] = {mul(ru[0], inv_rho), mul(ru[1], inv_rho),
                      mul(ru[2], inv_rho)};
  float pv, phi = 0.0f;
  if (KIND == DRY || REM) phi = s.phi[n];
  if (KIND == DRY) {
    const float ruu = add(add(mul(ru[0], u[0]), mul(ru[1], u[1])),
                          mul(ru[2], u[2]));
    const float e_int = sub(mul(sub(rhoe, mul(0.5f, ruu)), inv_rho), phi);
    const float T = add(in.T_0, mul(e_int, in.inv_cv));
    pv = mul(mul(rho, in.R_d), T);
  } else {
    pv = s.p[n];
  }
  const float p_eff = in.subtract ? sub(pv, s.pref[n]) : pv;
  const float h = add(rhoe, pv);
  const float m = s.M[n];
  const float* xi = s.xiv + n;
  float x[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) x[j] = xi[j * NP];
  float F[3][NV];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    F[i][0] = ru[i];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      F[i][1 + j] = (i == j) ? add(mul(ru[j], u[i]), p_eff)
                             : mul(ru[j], u[i]);
    F[i][4] = mul(h, u[i]);
    if (NV == 6) F[i][NV - 1] = mul(q[5 * NP], u[i]);  // advected rhoq_tot
  }
  float F2[3][NV];
  if (KIND == P_GIVEN_F2) {
    const float nu4 = s.nu[n];
    const float rnu = mul(rho, nu4);
    const float* g = s.gl2 + n;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float gi[NG];
#pragma unroll
      for (int j = 0; j < NG; ++j) gi[j] = g[(NG * i + j) * NP];
      F2[i][0] = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) F2[i][1 + j] = mul(rnu, gi[j]);
      const float rug = add(add(mul(ru[0], gi[0]), mul(ru[1], gi[1])),
                            mul(ru[2], gi[2]));
      F2[i][4] = add(mul(nu4, rug), mul(rnu, gi[3]));
      if (NV == 6) F2[i][NV - 1] = mul(mul(rho, s.nu[NP + n]), gi[NG - 1]);
    }
  }
  float pL = 0.0f, coeff = 0.0f;
  if (REM) {
    pL = add(mul(mul(rho, in.R_d), in.T_0),
             mul(in.R_over_cv, sub(rhoe, mul(rho, phi))));
    const float* r3 = s.ref3 + n;
    coeff = add(r3[0], r3[2 * NP]) / r3[NP];
    if (LIN & ACOUSTIC) coeff = sub(coeff, phi);   // no gravity
  }
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float acc = add(add(mul(x[3 * a], F[0][v]), mul(x[3 * a + 1], F[1][v])),
                      mul(x[3 * a + 2], F[2][v]));
      if (REM && ((LIN >> a) & 1)) {
        // a in lin_dims: the linear flux on this direction's slot
        if (v == 0 || v == 4) {
#pragma unroll
          for (int i = 0; i < 3; ++i)
            acc = sub(acc, mul(x[3 * a + i],
                               v == 0 ? ru[i] : mul(coeff, ru[i])));
        } else if (v < 4) {
          acc = sub(acc, mul(x[3 * a + v - 1], pL));
        }                                  // rhoq_tot: no linear flux
      }
      if (KIND == P_GIVEN_F2 && v > 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          acc = add(acc, mul(x[3 * a + i], F2[i][v]));
      }
      mfe[v * K + a * NP + n] = mul(m, acc);
    }
}

template <int KIND, int NQ, int NV, int LIN>
__global__ void __launch_bounds__(THREADS)
volume_kernel(const Inputs in, int E) {
  using L = Layout<KIND, NQ, NV, LIN>;
  constexpr int NP = L::NP, K = L::K, TE = L::TE;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
  float* ln = sm + L::LINES;
  int* info = reinterpret_cast<int*>(sm + L::INFO);
  float* mf = sm + L::MF;
  const int tid = threadIdx.x;
  const int tiles = (E + TE - 1) / TE;
  tile::Segment seg[L::NSEG];
  seg[0] = {in.qv, NV * NP, L::QV};
  seg[1] = {L::DRYK ? in.phi : in.p, NP, L::P};
  seg[2] = {in.pref, in.subtract ? NP : 0, L::PREF};
  seg[3] = {in.xiv, 9 * NP, L::XIV};
  seg[4] = {in.M, NP, L::M};
  seg[5] = {in.MI, NP, L::MI};
  int k = 6;
  if constexpr (L::F2) seg[k++] = {in.gl2, L::EXTRA_FLOATS, L::EXTRA};
  if constexpr (L::PHI_RUN) seg[k++] = {in.phi, NP, L::PHI};
  if constexpr (L::REM) seg[k++] = {in.ref3, L::REF3_FLOATS, L::REF3};
  if constexpr (L::NU_RUN) seg[k++] = {in.nu, 2 * NP, L::NU};
  const tile::Rows nu{in.nu, 2 * NP, NP, L::NU, L::NU_SLOT};
  const tile::Rows* rows = L::NU_ROWS ? &nu : nullptr;
  auto stage = [&](int st) { return sm + L::STAGE + st * L::STAGE_WORDS; };
  auto count = [&](int t) { return min(TE, E - t * TE); };

  if (tid == 0) {
    tile::bar_init(&bar[0]);
    tile::bar_init(&bar[1]);
    tile::bar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int st = 0; st < 2; ++st) {
      const int t = blockIdx.x + st * gridDim.x;
      if (t < tiles) tile::issue(stage(st), &bar[st], seg, rows, t * TE,
                                 count(t));
    }
  // the static tables, while the first tiles are in flight
  for (int i = tid; i < 3 * NQ * NQ; i += blockDim.x) ln[i] = in.lines[i];
  for (int i = tid; i < 3 * NP; i += blockDim.x) {
    const int a = i / NP, m = i - a * NP, sa = in.strides.at(a);
    const int q = (m / sa) % NQ;
    info[i] = (m - q * sa) | (q << 16);
  }
  __syncthreads();

  for (int it = 0, t = blockIdx.x; t < tiles; ++it, t += gridDim.x) {
    const int st = it & 1;
    float* S = stage(st);
    const int e0 = t * TE, ne = count(t);
    tile::bar_wait(&bar[st], (it >> 1) & 1);
    tile::fill_tail(S, seg, e0, ne);
    __syncthreads();

    // 1. flux times metric and mass, into the mf tile
    for (int i = tid; i < ne * NP; i += blockDim.x) {
      const int te = i / NP, n = i - te * NP;
      Elem el;
      el.qv = S + L::QV + te * NV * NP;
      el.p = S + L::P + te * NP;
      el.phi = L::DRYK ? el.p : S + L::PHI + te * NP;
      el.pref = S + L::PREF + te * NP;
      el.xiv = S + L::XIV + te * 9 * NP;
      el.M = S + L::M + te * NP;
      el.gl2 = S + L::EXTRA + te * L::EXTRA_FLOATS;
      el.ref3 = S + L::REF3 + te * L::REF3_FLOATS;
      el.nu = L::NU_ROWS ? S + L::NU + te * L::NU_SLOT
                               + tile::row_shift(nu, e0 + te)
              : L::NU_RUN ? S + L::NU + te * 2 * NP
                          : nullptr;
      node_flux<KIND, NQ, NV, LIN>(in, el, n, mf + te * NV * K);
    }
    __syncthreads();

    // 2.-3. weak divergence along the lines, scaled by MI
    for (int i = tid; i < ne * NP; i += blockDim.x) {
      const int te = i / NP, n = i - te * NP;
      const float* mfe = mf + te * NV * K;
      float acc[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v] = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int inf = info[a * NP + n], sa = in.strides.at(a);
        const float* V = ln + (a * NQ + (inf >> 16)) * NQ;
        float w[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) w[j] = V[j];
        const float* row = mfe + a * NP + (inf & 0xffff);
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int j = 0; j < NQ; ++j)
            acc[v] = fmaf(row[v * K + j * sa], w[j], acc[v]);
      }
      const float mi = S[L::MI + te * NP + n];
      float* o = in.out + (size_t)(e0 + te) * NV * NP + n;
#pragma unroll
      for (int v = 0; v < NV; ++v) o[v * NP] = mul(mi, acc[v]);
    }
    tile::fence_async_proxy();
    __syncthreads();                       // the stage and mf are free
    const int next = t + 2 * gridDim.x;
    if (tid == 0 && next < tiles)
      tile::issue(S, &bar[st], seg, rows, next * TE, count(next));
  }
}

bool aligned(const float* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int KIND, int NQ, int NV, int LIN>
int launch(const Inputs& in, int E, cudaStream_t s) {
  using L = Layout<KIND, NQ, NV, LIN>;
  constexpr int TE = L::TE;
  for (int a = 0; a < 3; ++a)
    if (in.strides.at(a) <= 0 || in.strides.at(a) > L::NP)
      return (int)cudaErrorInvalidValue;
  const float* runs[] = {in.qv, L::DRYK ? in.phi : in.p, in.pref, in.xiv,
                         in.M, in.MI, L::F2 ? in.gl2 : in.qv,
                         L::F2 ? in.nu : in.qv, L::REM ? in.phi : in.qv,
                         L::REM ? in.ref3 : in.qv};
  for (const float* ptr : runs)
    if (!aligned(ptr)) return (int)cudaErrorMisalignedAddress;
  static int2 cache[16];
  int grid = 0;
  cudaError_t err = tile::persistent_grid(volume_kernel<KIND, NQ, NV, LIN>,
                                          THREADS, L::BYTES,
                                          (E + TE - 1) / TE, cache, &grid);
  if (err != cudaSuccess) return (int)err;
  volume_kernel<KIND, NQ, NV, LIN><<<grid, THREADS, L::BYTES, s>>>(in, E);
  return (int)cudaGetLastError();
}

// The branch KIND with NV variables and remainder LIN at the order of Np
// (tile::by_order).
template <int KIND, int NV, int LIN>
int launch_order(const Inputs& in, int E, int Np, cudaStream_t s) {
  if (E <= 0) return (int)cudaErrorInvalidValue;
  return tile::by_order(Np, [&](auto nq) {
    return launch<KIND, decltype(nq)::value, NV, LIN>(in, E, s);
  });
}

// Calls f(std::integral_constant<int, LIN>) for the remainder branch of
// lin_dims mask `dims` and lin_gravity: no remainder (dims = 0), (2,)
// ("vertical"), (0, 1) ("horizontal") or (0, 1, 2) ("every"); any other
// mask, which no direction yields, gives cudaErrorInvalidValue.
template <typename F>
int by_lin(int dims, int lin_gravity, F&& f) {
  using std::integral_constant;
  const bool g = lin_gravity != 0;
  switch (dims) {
    case 0: return f(integral_constant<int, 0>());
    case 4: return g ? f(integral_constant<int, 4>())
                     : f(integral_constant<int, 4 | ACOUSTIC>());
    case 7: return g ? f(integral_constant<int, 7>())
                     : f(integral_constant<int, 7 | ACOUSTIC>());
    case 3: return g ? f(integral_constant<int, 3>())
                     : f(integral_constant<int, 3 | ACOUSTIC>());
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// fused_volume_tendency_vm on `stream` with nq = 5 or 6 variables (gl2
// then holds nq - 1 chain variables): Wdiv as its line table (lines
// [3][NQ][NQ] and the node strides s0, s1, s2 of the three directions'
// lines; dg/line_ops.py), Np = NQ^3 with NQ = 2..6 (tile::by_order),
// every input 16-byte aligned.  gl2 and nu are read only with has_f2 !=
// 0; phi and ref3 only with a remainder: lin_dims as the mask lin (bit a
// for direction a: 0, 4 for (2,), 3 for (0, 1) or 7 for (0, 1, 2)) and
// lin_gravity; pref only with subtract != 0; R_d, T_0 and R_over_cv =
// R_d/cv_d are the float32 values of the constants.  Returns the CUDA
// error code of the launch (0 on success).
int volume_vm_f32(const void* qv, const void* p, const void* phi,
                  const void* pref, const void* ref3, const void* xiv,
                  const void* M, const void* MI, const void* gl2,
                  const void* nu, const void* lines, void* out, int E,
                  int Np, int nq, int has_f2, int lin, int lin_gravity,
                  int subtract, int s0, int s1, int s2, float R_d,
                  float T_0, float R_over_cv, void* stream) {
  Inputs in{};
  in.qv = static_cast<const float*>(qv);
  in.p = static_cast<const float*>(p);
  in.phi = static_cast<const float*>(phi);
  in.pref = static_cast<const float*>(pref);
  in.ref3 = static_cast<const float*>(ref3);
  in.gl2 = static_cast<const float*>(gl2);
  in.nu = static_cast<const float*>(nu);
  in.xiv = static_cast<const float*>(xiv);
  in.M = static_cast<const float*>(M);
  in.MI = static_cast<const float*>(MI);
  in.lines = static_cast<const float*>(lines);
  in.strides = tile::Strides{{s0, s1, s2}};
  in.out = static_cast<float*>(out);
  in.R_d = R_d;
  in.T_0 = T_0;
  in.R_over_cv = R_over_cv;
  in.subtract = subtract != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq != 5 && nq != 6) return (int)cudaErrorInvalidValue;
  return by_lin(lin, lin_gravity, [&](auto lc) {
    constexpr int LIN = decltype(lc)::value;
    if (nq == 5)
      return has_f2 ? launch_order<P_GIVEN_F2, 5, LIN>(in, E, Np, s)
                    : launch_order<P_GIVEN, 5, LIN>(in, E, Np, s);
    return has_f2 ? launch_order<P_GIVEN_F2, 6, LIN>(in, E, Np, s)
                  : launch_order<P_GIVEN, 6, LIN>(in, E, Np, s);
  });
}

// dry_volume_tendency on `stream`, lines and strides as above.  ref3 is
// read only with a remainder: lin_dims as the mask lin (0, 4 for (2,), 3
// for (0, 1) or 7 for (0, 1, 2)) and lin_gravity; pref only with subtract
// != 0.  R_d, inv_cv = 1/cv_d,
// T_0 and R_over_cv = R_d/cv_d are the float32 values of the constants.
// Returns the CUDA error code of the launch (0 on success).
int dry_volume_f32(const void* qv, const void* phi, const void* pref,
                   const void* ref3, const void* xiv, const void* M,
                   const void* MI, const void* lines, void* out, int E,
                   int Np, int lin, int lin_gravity, int subtract, int s0,
                   int s1, int s2, float R_d, float inv_cv, float T_0,
                   float R_over_cv, void* stream) {
  Inputs in{};
  in.qv = static_cast<const float*>(qv);
  in.phi = static_cast<const float*>(phi);
  in.pref = static_cast<const float*>(pref);
  in.ref3 = static_cast<const float*>(ref3);
  in.xiv = static_cast<const float*>(xiv);
  in.M = static_cast<const float*>(M);
  in.MI = static_cast<const float*>(MI);
  in.lines = static_cast<const float*>(lines);
  in.strides = tile::Strides{{s0, s1, s2}};
  in.out = static_cast<float*>(out);
  in.R_d = R_d;
  in.inv_cv = inv_cv;
  in.T_0 = T_0;
  in.R_over_cv = R_over_cv;
  in.subtract = subtract != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_lin(lin, lin_gravity, [&](auto lc) {
    return launch_order<DRY, 5, decltype(lc)::value>(in, E, Np, s);
  });
}

const char* volume_vm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
