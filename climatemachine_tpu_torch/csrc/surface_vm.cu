// Var-major DG surface pass for Hopper (sm_90a): the face extraction with
// the hyperdiffusive n.F2 trace lanes, and the fused Rusanov flux + lift.
//
// Replaces climatemachine_tpu/dg/pallas_surface.py:extract_trace_vm (Pallas
// body _k_extract) and :fused_surface_lift_vm (Pallas body _kernel) for what
// the Held-Suarez step, the moist baroclinic wave, their fused remainders
// and the isentropic vortex run: float32, NQ = 5 prognostic variables
// (dry) or 6 (with the advected rhoq_tot of EquilMoist), with (NQ - 1
// chain variables u_h[3], h_tot[, q_tot]; NQ more bundle lanes) or
// without DryBiharmonic or EquilMoistBiharmonic hyperdiffusion, and NA aux
// lanes (JAX fast_rhs.py:406-423): NA = 1 (p_ref; NQ + 3 bundle lanes),
// for a fused remainder NA = 4 (p_ref, phi, the linear energy coefficient
// and the reference sound speed; NQ + 6 lanes), or NA = 0 where nothing
// reads p_ref (a reference state that does not subtract and no remainder:
// the Pallas body's na = 0 branch, :52-53; NQ + 2 lanes).  The lift takes
// the reference pressure (lane NQ + 2) out of the momentum flux where SUB
// (the Pallas body's subtract branch, :151) and leaves it in otherwise: a
// reference state that does not subtract, with (NA = 4) or without (NA =
// 0) a remainder.  Every lane offset is a constant of the template (a run-
// time flag or lane index cost the moist lift with hyperdiffusion 15 % on
// an NVIDIA H100, PERF.md).
//
// extract_trace_vm_kernel, per element e and face lane x (X = 6 Nfp):
//   B[v][x] = vol_v[node(x)]                 v = q[NQ], p, c, aux[NA]
//   G_j     = n0 g[0][j] + n1 g[1][j] + n2 g[2][j],   g = gl2 at node(x)
//   s       = (0, rho nu G_0, rho nu G_1, rho nu G_2,
//              nu (rhou . G) + rho nu G_3[, rho nu_q G_4])
//             (the NQ trace lanes; nu = nu4, nu_q = nu4q)
// surface_lift_vm_kernel, per element: for each face lane the wall ghost of
// the neighbour side, both one-sided normal fluxes, the Rusanov flux with
// the larger wavespeed, + (1 - bm) (s- - s+) / 2 with hyperdiffusion, and
// with a remainder (NA = 4) less the linear model's Rusanov flux on the
// linear faces' lanes [sl_lo, sl_hi) (JAX body :173-200)
//   FL[rho] = u.n (u.n = rhou . n), FL[rhou_j] = pL n_j, FL[rhoe] = c u.n,
//   FL[rhoq_tot] = 0, pL = rho R_d T_0 + (R_d/cv_d)(rhoe - rho phi),
//   f -= (FL- + FL+) / 2 - max(cl-, cl+) / 2 (q+ - q-)
// (phi, c and cl the lanes NQ + 3, NQ + 4, NQ + 5), times sM; then for
// each node n
//   out[v][n] = -(MI[n] * sum over the lanes x that land on n of f[v][x]).
//
// The face-extraction matrix lift [Np][X] (grid.lift) is 0/1 with one 1 per
// column; the TPU kernels multiply by it densely (2 Np flops per lane and
// row).  Here it comes as the int32 index tables of dg/ldg_tables.face_ops,
// built and checked once per matrix on the host: sel_idx [X], the node of
// each face lane, and lift_idx [Np][L], the lanes that land on each node in
// ascending order (-1 padded; L = 3 at p4, a hexahedron's corner node lies
// on 3 faces).  The extraction then is a gather and the lift an ordered sum
// from zero, which is what a GEMM gives for the same 0/1 operands.
//
// What bounds them: bytes.  At bench shapes (E = 12288, Np = 125, X = 150)
// the extraction with hyperdiffusion reads 21 volume rows (nu's second row
// is not needed) and 3 normal rows per element and writes 13 face rows,
// about 0.25 GB: 0.074 ms at 3.35 TB/s, against ~32 flops per lane.  The
// lift reads 2 x 13 bundle rows, 5 geometry rows and MI and writes 5 rows,
// about 0.26 GB: 0.079 ms, against ~130 flops per lane.  At NQ = 6 the
// extraction reads 26 volume rows (nu's both) and writes 15 face rows, the
// lift reads 2 x 15 and writes 6: about 0.29 and 0.30 GB.  A remainder's
// bundle (NA = 4) has 3 more lanes: 3 more volume rows and face rows for
// the extraction, 2 x 3 more rows read by the lift, which does ~40 flops
// more a lane on the linear faces.
//
// Design: a block of TE = 8 elements, one thread per face lane and, in the
// lift's second pass, per node (160 threads at p4).  The extraction gathers
// an element's volume rows through L1 (each 500-byte row is fetched whole)
// and reads and writes the face rows coalesced.  The lift keeps the TE
// elements' sM f* rows in shared memory between its two passes.  No
// tensor cores, no TMA: a simple kernel first.
//
// Rounding: every product and sum of the trace, ghost and flux formulas is
// rounded as the plain PyTorch version rounds it, in its order
// (__fmul_rn/__fadd_rn keep nvcc from contracting them into FMAs).

#include <cuda_runtime.h>

namespace {

constexpr int TE = 8;
constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float maximum(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// NQ variables, NA aux lanes; NGL = NQ - 1 chain variables.
template <int NQ, int NA, bool HYPER>
__global__ void __launch_bounds__(MAX_THREADS)
extract_trace_vm_kernel(const float* __restrict__ qv,    // [E][NQ][Np]
                        const float* __restrict__ p,     // [E][Np]
                        const float* __restrict__ c,     // [E][Np]
                        const float* __restrict__ aux,   // [E][NA][Np]
                        const float* __restrict__ gl2,   // [E][3 NGL][Np]
                        const float* __restrict__ nu,    // [E][2][Np]
                        const int* __restrict__ sel_idx, // [X]
                        const float* __restrict__ nrm,   // [E][3][X]
                        float* __restrict__ out,         // [E][NVB][X]
                        int E, int Np, int X) {
  constexpr int NGL = NQ - 1;
  constexpr int NVB0 = NQ + 2 + NA;     // the lanes before the trace lanes
  constexpr int NVB = HYPER ? NVB0 + NQ : NVB0;
  const int x = threadIdx.x;
  if (x >= X) return;              // no barrier in this kernel

  const int node = __ldg(sel_idx + x);

  for (int te = 0; te < TE; ++te) {
    const int e = blockIdx.x * TE + te;
    if (e >= E) return;
    const size_t en = (size_t)e * Np + node;
    float b[NVB];
    float q[NQ];
#pragma unroll
    for (int v = 0; v < NQ; ++v) {
      q[v] = __ldg(qv + ((size_t)e * NQ + v) * Np + node);
      b[v] = q[v];
    }
    b[NQ] = __ldg(p + en);
    b[NQ + 1] = __ldg(c + en);
#pragma unroll
    for (int k = 0; k < NA; ++k)
      b[NQ + 2 + k] = __ldg(aux + ((size_t)e * NA + k) * Np + node);
    if constexpr (HYPER) {
      const float* g = gl2 + (size_t)e * 3 * NGL * Np + node;
      const float* nr = nrm + (size_t)e * 3 * X + x;
      const float n0 = __ldg(nr), n1 = __ldg(nr + X), n2 = __ldg(nr + 2 * X);
      float G[NGL];
#pragma unroll
      for (int j = 0; j < NGL; ++j) {
        const float g0 = __ldg(g + j * Np);
        const float g1 = __ldg(g + (NGL + j) * Np);
        const float g2 = __ldg(g + (2 * NGL + j) * Np);
        G[j] = add(add(mul(n0, g0), mul(n1, g1)), mul(n2, g2));
      }
      const float nu4 = __ldg(nu + (size_t)e * 2 * Np + node);
      const float rnu = mul(q[0], nu4);
      b[NVB0] = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) b[NVB0 + 1 + j] = mul(rnu, G[j]);
      const float ruG =
          add(add(mul(q[1], G[0]), mul(q[2], G[1])), mul(q[3], G[2]));
      b[NVB0 + 4] = add(mul(nu4, ruG), mul(rnu, G[3]));
      if constexpr (NQ == 6) {
        const float nu4q = __ldg(nu + ((size_t)e * 2 + 1) * Np + node);
        b[NVB0 + 5] = mul(mul(q[0], nu4q), G[NGL - 1]);
      }
    }
    float* o = out + (size_t)e * NVB * X + x;
#pragma unroll
    for (int v = 0; v < NVB; ++v) o[v * X] = b[v];
  }
}

// The one-sided normal flux of the NQ variables and its wavespeed |u.n| +
// c; a variable past rhoe (rhoq_tot) is carried by u.n.
// p_ref is taken out of the momentum flux where SUB.
template <int NQ, bool SUB>
__device__ __forceinline__ float flux_n(const float S[NQ], float pv, float cs,
                                        float pref, const float n[3],
                                        float Fn[NQ]) {
  const float inv = __fdiv_rn(1.0f, S[0]);
  const float un =
      mul(add(add(mul(S[1], n[0]), mul(S[2], n[1])), mul(S[3], n[2])), inv);
  const float p_eff = SUB ? sub(pv, pref) : pv;
  Fn[0] = mul(S[0], un);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    Fn[1 + c] = add(mul(S[1 + c], un), mul(p_eff, n[c]));
  Fn[4] = mul(add(S[4], pv), un);
#pragma unroll
  for (int v = 5; v < NQ; ++v) Fn[v] = mul(S[v], un);
  return add(fabsf(un), cs);
}

// The linear acoustic(-gravity) model's normal flux of the NQ variables
// (none for rhoq_tot) and its wavespeed cl.
template <int NQ>
__device__ __forceinline__ float flux_lin(const float S[NQ], float phi,
                                          float coeff, float cl,
                                          const float n[3], float R_d_T0,
                                          float R_over_cv, float Fn[NQ]) {
  const float pL = add(mul(S[0], R_d_T0),
                       mul(R_over_cv, sub(S[4], mul(S[0], phi))));
  const float un =
      add(add(mul(S[1], n[0]), mul(S[2], n[1])), mul(S[3], n[2]));
  Fn[0] = un;
#pragma unroll
  for (int c = 0; c < 3; ++c) Fn[1 + c] = mul(pL, n[c]);
  Fn[4] = mul(coeff, un);
#pragma unroll
  for (int v = 5; v < NQ; ++v) Fn[v] = 0.0f;
  return cl;
}

// NA aux lanes in the bundle (NA = 4: a remainder's, whose linear flux
// comes off the lanes [sl_lo, sl_hi)); SUB: take p_ref out.
template <int NQ, int NA, bool HYPER, bool SUB>
__global__ void __launch_bounds__(MAX_THREADS)
surface_lift_vm_kernel(const float* __restrict__ Bf,     // [E][NVB][X]
                       const float* __restrict__ BP,     // [E][NVB][X]
                       const float* __restrict__ nrm,    // [E][3][X]
                       const float* __restrict__ sM,     // [E][1][X]
                       const float* __restrict__ bmask,  // [E][1][X]
                       const int* __restrict__ lift_idx, // [Np][L]
                       int L,
                       const float* __restrict__ MI,     // [E][Np]
                       float* __restrict__ out,          // [E][NQ][Np]
                       int E, int Np, int X, int sl_lo, int sl_hi,
                       float R_d_T0, float R_over_cv) {
  constexpr int NVB = NQ + 2 + NA + (HYPER ? NQ : 0);
  constexpr int IPREF = NQ + 2;   // the p_ref lane of the bundle (NA > 0)
  constexpr bool REM = NA == 4;   // lanes phi, coeff, cl follow p_ref
  static_assert(NA > 0 || !SUB, "p_ref is taken from the bundle");
  extern __shared__ float smf[];                 // [TE][NQ][X]
  const int t = threadIdx.x;
  const int e0 = blockIdx.x * TE;

  // 1. per face lane: sM * f*
  if (t < X) {
    for (int te = 0; te < TE; ++te) {
      const int e = e0 + te;
      if (e >= E) break;
      const float* Mr = Bf + (size_t)e * NVB * X + t;
      const float* Pr = BP + (size_t)e * NVB * X + t;
      const float* nr = nrm + (size_t)e * 3 * X + t;
      const float n[3] = {__ldg(nr), __ldg(nr + X), __ldg(nr + 2 * X)};
      const float bm = __ldg(bmask + (size_t)e * X + t);
      const float sm = __ldg(sM + (size_t)e * X + t);
      float M[NQ], P[NQ];
#pragma unroll
      for (int v = 0; v < NQ; ++v) {
        M[v] = __ldg(Mr + v * X);
        P[v] = __ldg(Pr + v * X);
      }
      // wall ghost: reflect the normal momentum, copy everything else
      const float run =
          add(add(mul(P[1], n[0]), mul(P[2], n[1])), mul(P[3], n[2]));
      const float run2 = mul(2.0f, run);
      const float keep = sub(1.0f, bm);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float ghost = sub(P[1 + c], mul(run2, n[c]));
        P[1 + c] = add(mul(bm, ghost), mul(keep, P[1 + c]));
      }
      float FM[NQ], FP[NQ];
      const float cM = flux_n<NQ, SUB>(M, __ldg(Mr + NQ * X),
                                       __ldg(Mr + (NQ + 1) * X),
                                       SUB ? __ldg(Mr + IPREF * X) : 0.0f,
                                       n, FM);
      const float cP = flux_n<NQ, SUB>(P, __ldg(Pr + NQ * X),
                                       __ldg(Pr + (NQ + 1) * X),
                                       SUB ? __ldg(Pr + IPREF * X) : 0.0f,
                                       n, FP);
      const float half_c = mul(0.5f, maximum(cM, cP));
      // the remainder's linear faces: the linear Rusanov flux
      const bool lin = REM && t >= sl_lo && t < sl_hi;
      float FLM[NQ], FLP[NQ], half_cl = 0.0f;
      if (REM && lin) {
        const float clM = flux_lin<NQ>(
            M, __ldg(Mr + (NQ + 3) * X), __ldg(Mr + (NQ + 4) * X),
            __ldg(Mr + (NQ + 5) * X), n, R_d_T0, R_over_cv, FLM);
        const float clP = flux_lin<NQ>(
            P, __ldg(Pr + (NQ + 3) * X), __ldg(Pr + (NQ + 4) * X),
            __ldg(Pr + (NQ + 5) * X), n, R_d_T0, R_over_cv, FLP);
        half_cl = mul(0.5f, maximum(clM, clP));
      }
      float* s = smf + te * NQ * X + t;
#pragma unroll
      for (int v = 0; v < NQ; ++v) {
        float f = sub(mul(0.5f, add(FM[v], FP[v])),
                      mul(half_c, sub(P[v], M[v])));
        if constexpr (HYPER) {
          // + (s- - s+) / 2 on interior faces
          const int h = (NVB - NQ + v) * X;
          const float d2 = mul(0.5f, sub(__ldg(Mr + h), __ldg(Pr + h)));
          f = add(f, mul(keep, d2));
        }
        if (REM && lin)
          f = sub(f, sub(mul(0.5f, add(FLM[v], FLP[v])),
                         mul(half_cl, sub(P[v], M[v]))));
        s[v * X] = mul(sm, f);
      }
    }
  }
  __syncthreads();
  if (t >= Np) return;             // no barrier follows

  // 2. per node: the lift, -MI
  const int* lanes = lift_idx + (size_t)t * L;
  for (int te = 0; te < TE; ++te) {
    const int e = e0 + te;
    if (e >= E) return;
    const float mi = __ldg(MI + (size_t)e * Np + t);
    const float* s = smf + te * NQ * X;
#pragma unroll
    for (int v = 0; v < NQ; ++v) {
      float acc = 0.0f;
      for (int k = 0; k < L; ++k) {
        const int x = __ldg(lanes + k);
        if (x < 0) break;
        acc = add(acc, s[v * X + x]);
      }
      out[((size_t)e * NQ + v) * Np + t] = -mul(mi, acc);
    }
  }
}

template <int NQ, int NA>
auto extract_kernel(bool hyper) {
  return hyper ? extract_trace_vm_kernel<NQ, NA, true>
               : extract_trace_vm_kernel<NQ, NA, false>;
}

template <int NQ>
auto extract_kernel(int na, bool hyper) {
  return na == 0 ? extract_kernel<NQ, 0>(hyper)
                 : na == 1 ? extract_kernel<NQ, 1>(hyper)
                           : extract_kernel<NQ, 4>(hyper);
}

template <int NQ, int NA, bool SUB>
auto lift_kernel(bool hyper) {
  return hyper ? surface_lift_vm_kernel<NQ, NA, true, SUB>
               : surface_lift_vm_kernel<NQ, NA, false, SUB>;
}

// NA = 0 has no p_ref to take out; NA = 1 carries p_ref only to take it
// out.
template <int NQ>
auto lift_kernel(int na, bool sub, bool hyper) {
  return na == 0   ? lift_kernel<NQ, 0, false>(hyper)
         : na == 1 ? lift_kernel<NQ, 1, true>(hyper)
                   : (sub ? lift_kernel<NQ, 4, true>(hyper)
                          : lift_kernel<NQ, 4, false>(hyper));
}

}  // namespace

extern "C" {

// Launches the extraction of nq = 5 or 6 variables and na = 0, 1 or 4 aux
// lanes (the bundles of fast_rhs.py) on `stream`; aux is read only with
// na > 0, gl2, nu and nrm only with has_hyper != 0.
// Returns the CUDA error code of the launch (0 on success).
int extract_trace_vm_f32(const void* qv, const void* p, const void* c,
                         const void* aux, const void* gl2, const void* nu,
                         const void* sel_idx, const void* nrm, void* out, int E,
                         int Np, int X, int nq, int na, int has_hyper,
                         void* stream) {
  const int threads = (X + 31) / 32 * 32;
  if (E <= 0 || Np <= 0 || X <= 0 || threads > MAX_THREADS ||
      (nq != 5 && nq != 6) || (na != 0 && na != 1 && na != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = nq == 5 ? extract_kernel<5>(na, has_hyper)
                        : extract_kernel<6>(na, has_hyper);
  kernel<<<(E + TE - 1) / TE, threads, 0, s>>>(
      static_cast<const float*>(qv), static_cast<const float*>(p),
      static_cast<const float*>(c), static_cast<const float*>(aux),
      static_cast<const float*>(gl2), static_cast<const float*>(nu),
      static_cast<const int*>(sel_idx), static_cast<const float*>(nrm),
      static_cast<float*>(out), E, Np, X);
  return (int)cudaGetLastError();
}

// Launches the flux + lift of nq = 5 or 6 variables on `stream`, the
// bundle with na = 0 aux lanes, na = 1 (p_ref) or, for a fused remainder,
// na = 4: then the linear Rusanov flux comes off the lanes [sl_lo,
// sl_hi), R_d_T0 = R_d T_0 and R_over_cv = R_d/cv_d (float32); p_ref
// (lane nq + 2) is taken out of the momentum flux where subtract != 0
// (na = 1 always subtracts, na = 0 never, na = 4 either way).  Returns the
// CUDA error code of the launch (0 on success).
int surface_lift_vm_f32(const void* Bf, const void* BP, const void* nrm,
                        const void* sM, const void* bmask,
                        const void* lift_idx, int L, const void* MI, void* out,
                        int E, int Np, int X, int nq, int na, int has_hyper,
                        int subtract, int sl_lo, int sl_hi, float R_d_T0,
                        float R_over_cv, void* stream) {
  const int width = X > Np ? X : Np;
  const int threads = (width + 31) / 32 * 32;
  if (E <= 0 || Np <= 0 || X <= 0 || L <= 0 || threads > MAX_THREADS ||
      (nq != 5 && nq != 6) || (na != 0 && na != 1 && na != 4) ||
      (subtract && na == 0) || (!subtract && na == 1) || sl_lo < 0 || sl_hi > X || sl_lo > sl_hi)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // at most 8 * 6 * 256 * 4 = 48 KB, the default limit
  const size_t smem = (size_t)TE * nq * X * sizeof(float);
  auto kernel = nq == 5 ? lift_kernel<5>(na, subtract != 0, has_hyper)
                        : lift_kernel<6>(na, subtract != 0, has_hyper);
  kernel<<<(E + TE - 1) / TE, threads, smem, s>>>(
      static_cast<const float*>(Bf), static_cast<const float*>(BP),
      static_cast<const float*>(nrm), static_cast<const float*>(sM),
      static_cast<const float*>(bmask), static_cast<const int*>(lift_idx), L,
      static_cast<const float*>(MI), static_cast<float*>(out), E, Np, X,
      sl_lo, sl_hi, R_d_T0, R_over_cv);
  return (int)cudaGetLastError();
}

const char* surface_vm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
