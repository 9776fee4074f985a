// Fused var-major DG volume tendencies for Hopper (sm_90a).
//
// One kernel template, two functions of the JAX package, for the
// configurations the dry Held-Suarez paths run (5 prognostic variables rho,
// rhou[3], rhoe; the reference pressure subtracted from the momentum flux):
//
//   * climatemachine_tpu/dg/pallas_volume.py:fused_volume_tendency_vm
//     (Pallas body _kernel_vm), the var-major RHS's: the pressure p is an
//     input; with or without the hyperdiffusive flux F2 of DryBiharmonic
//     (ngl = 4 chain variables u_h[3], h_tot); no linear-flux subtraction.
//   * climatemachine_tpu/dg/pallas_volume.py:dry_volume_tendency (Pallas
//     body _kernel), the generic DG operator's: e_int, T and p are computed
//     from q and phi in the kernel; with lin_dims = () or, for the fused
//     IMEX remainder, lin_dims = (2,) with lin_gravity: the linear
//     acoustic-gravity flux of the vertical direction subtracted on
//     direction slot 2.
//
// Per element e, variable v and node n:
//
//   mf[v][a*Np + m] = M[m] * sum_i xi[3a+i][m] * F_i[v](m)  (+ F2, - Flin)
//   out[e][v][n]    = MI[n] * sum_k Wdiv[n][k] * mf[v][k],  k < 3*Np
//
//   F_i[rho] = rhou_i,  F_i[rhou_j] = rhou_j u_i + (p - p_ref) d_ij,
//   F_i[rhoe] = (rhoe + p) u_i
//   F2_i[rhou_j] = rho nu4 gl2[i][j],
//   F2_i[rhoe]   = nu4 sum_j rhou_j gl2[i][j] + rho nu4 gl2[i][3]
//   (gl2[i][j] = d_i Laplacian(u_h, h_tot)_j, lane 4i+j of [E][12][Np];
//    nu4 lane 0 of [E][2][Np])
//   dry thermo: e_int = (rhoe - (rhou . u) / 2) / rho - phi,
//               T = T_0 + e_int * (1/cv_d), p = rho R_d T
//   Flin_i[rho] = rhou_i, Flin_i[rhou_i] = pL, Flin_i[rhoe] = c rhou_i
//   with pL = rho R_d T_0 + (R_d/cv_d)(rhoe - rho phi),
//        c  = (rhoe_ref + p_ref) / rho_ref  (ref3 = rhoe_ref, rho_ref,
//   p_ref), subtracted where the JAX kernel subtracts it: every i for rho
//   and rhoe, i = j for rhou_j.
//
// What bounds them: at p4 (Np = 125) the dense contraction, as this kernel
// computes it, is 2*5*375 = 3750 flops per node against 23 floats read or
// written per node (26 with the remainder's ref3, 37 with F2), ~41 flops
// per byte, above the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20),
// so the fp32 FMA pipes bound it: 0.089 ms (0.091 with F2) at E = 12288.
// Wdiv is a Kronecker operator with Nq = 5 nonzeros a row per direction, so
// sum-factorised the contraction is 2*5*15 = 150 flops per node and bytes
// alone bound it: 0.042 ms (0.048 with ref3, 0.068 with F2).
//
// Design: one block of TE elements, one thread per node (the last warp
// masked: Np = 125 is not a multiple of 32).
//   1. Each thread builds the flux of its node (node_flux<KIND>, the only
//      part that differs between the branches) and writes M * xi . F for 5
//      variables x 3 directions of TE elements into shared memory (TE * 5
//      * KP floats; rows padded to KP = 3Np rounded up to 4 with zeros so
//      they can be read as float4).
//   2. Each thread accumulates its node's 5*TE outputs in registers over
//      k: one read of Wdiv^T[k][n] (the caller's [KP][Np] copy, transposed
//      and padded once per grid so that neighbouring threads read
//      neighbouring addresses; 188 KB, served from L2/L1) feeds 5*TE FMAs,
//      and the mf values are float4 broadcast reads from shared memory.
//      TE = 8 keeps the FMA count per Wdiv load at 40, enough that the fp32
//      pipes and not the L2 reads are the limit.
//   3. Scale by MI and store.
// Tensor cores (wgmma with split TF32) are not used.
//
// Rounding: the flux pass rounds each product, sum and quotient as the
// plain PyTorch version does, in its order (__fmul_rn/__fadd_rn/__fsub_rn
// keep nvcc from contracting them into FMAs; 1/rho and the reference
// enthalpy are IEEE divisions; the constants are the float32 values of the
// Python scalars the plain version multiplies by), and the contraction
// accumulates k in ascending order with FMAs, as a GEMM does.  On a
// near-hydrostatic state the divergence cancels to ~1e-5 of its terms, so
// a rounding difference in mf would show at about the 1e-5 * max|plain|
// the kernels are held to.

#include <cuda_runtime.h>

namespace {

constexpr int NQ = 5;
constexpr int TE = 8;
constexpr int MAX_THREADS = 256;

// the flux branches (node_flux)
enum Kind { P_GIVEN = 0, P_GIVEN_F2 = 1, DRY = 2, DRY_REMAINDER = 3 };

struct Inputs {
  const float* qv;    // [E][5][Np]
  const float* p;     // [E][Np]     P_GIVEN*
  const float* phi;   // [E][Np]     DRY*
  const float* pref;  // [E][Np]
  const float* ref3;  // [E][3][Np]  DRY_REMAINDER: rhoe_ref, rho_ref, p_ref
  const float* gl2;   // [E][12][Np] P_GIVEN_F2
  const float* nu;    // [E][2][Np]  P_GIVEN_F2
  const float* xiv;   // [E][9][Np]  xi_a,i at 3a+i
  const float* M;     // [E][Np]
  const float* MI;    // [E][Np]
  const float* wt;    // [KP][Np]    Wdiv^T, rows >= 3Np zero
  float* out;         // [E][5][Np]
  float R_d, inv_cv, T_0, R_over_cv;   // DRY*
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

// Stage 1 for node n of element e: mfe[v * KP + a * Np + n] for the 5
// variables and 3 directions.
template <int KIND>
__device__ __forceinline__ void node_flux(const Inputs& in, int e, int n,
                                          int Np, int KP, float* mfe) {
  const size_t en = (size_t)e * Np + n;
  const float* q = in.qv + (size_t)e * NQ * Np + n;
  const float rho = q[0];
  const float ru[3] = {q[Np], q[2 * Np], q[3 * Np]};
  const float rhoe = q[4 * Np];
  const float inv_rho = 1.0f / rho;
  const float u[3] = {mul(ru[0], inv_rho), mul(ru[1], inv_rho),
                      mul(ru[2], inv_rho)};
  float pv, phi = 0.0f;
  if (KIND == DRY || KIND == DRY_REMAINDER) {
    phi = in.phi[en];
    const float ruu = add(add(mul(ru[0], u[0]), mul(ru[1], u[1])),
                          mul(ru[2], u[2]));
    const float e_int = sub(mul(sub(rhoe, mul(0.5f, ruu)), inv_rho), phi);
    const float T = add(in.T_0, mul(e_int, in.inv_cv));
    pv = mul(mul(rho, in.R_d), T);
  } else {
    pv = in.p[en];
  }
  const float p_eff = sub(pv, in.pref[en]);
  const float h = add(rhoe, pv);
  const float m = in.M[en];
  const float* xi = in.xiv + (size_t)e * 9 * Np + n;
  float x[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) x[j] = xi[j * Np];
  float F[3][NQ];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    F[i][0] = ru[i];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      F[i][1 + j] = (i == j) ? add(mul(ru[j], u[i]), p_eff)
                             : mul(ru[j], u[i]);
    F[i][4] = mul(h, u[i]);
  }
  float F2[3][NQ];
  if (KIND == P_GIVEN_F2) {
    const float nu4 = in.nu[(size_t)e * 2 * Np + n];
    const float rnu = mul(rho, nu4);
    const float* g = in.gl2 + (size_t)e * 12 * Np + n;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float gi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) gi[j] = g[(4 * i + j) * Np];
      F2[i][0] = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) F2[i][1 + j] = mul(rnu, gi[j]);
      const float rug = add(add(mul(ru[0], gi[0]), mul(ru[1], gi[1])),
                            mul(ru[2], gi[2]));
      F2[i][4] = add(mul(nu4, rug), mul(rnu, gi[3]));
    }
  }
  float pL = 0.0f, coeff = 0.0f;
  if (KIND == DRY_REMAINDER) {
    pL = add(mul(mul(rho, in.R_d), in.T_0),
             mul(in.R_over_cv, sub(rhoe, mul(rho, phi))));
    const float* r3 = in.ref3 + (size_t)e * 3 * Np + n;
    coeff = add(r3[0], r3[2 * Np]) / r3[Np];
  }
#pragma unroll
  for (int v = 0; v < NQ; ++v)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float acc = add(add(mul(x[3 * a], F[0][v]), mul(x[3 * a + 1], F[1][v])),
                      mul(x[3 * a + 2], F[2][v]));
      if (KIND == DRY_REMAINDER && a == 2) {
        // lin_dims = (2,): the linear flux on the vertical slot only
        if (v == 0 || v == 4) {
#pragma unroll
          for (int i = 0; i < 3; ++i)
            acc = sub(acc, mul(x[3 * a + i],
                               v == 0 ? ru[i] : mul(coeff, ru[i])));
        } else {
          acc = sub(acc, mul(x[3 * a + v - 1], pL));
        }
      }
      if (KIND == P_GIVEN_F2 && v > 0) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          acc = add(acc, mul(x[3 * a + i], F2[i][v]));
      }
      mfe[v * KP + a * Np + n] = mul(m, acc);
    }
}

template <int KIND>
__global__ void __launch_bounds__(MAX_THREADS)
volume_kernel(const Inputs in, int E, int Np, int KP) {
  extern __shared__ float4 smem4[];
  float* mf = reinterpret_cast<float*>(smem4);    // [TE][NQ][KP]
  const int n = threadIdx.x;
  const int e0 = blockIdx.x * TE;
  const int K = 3 * Np;

  // 1. flux times metric and mass, into shared memory
  for (int te = 0; te < TE; ++te) {
    const int e = e0 + te;
    float* mfe = mf + te * NQ * KP;
    if (n < Np) {
      if (e < E) {
        node_flux<KIND>(in, e, n, Np, KP, mfe);
      } else {
        for (int v = 0; v < NQ; ++v)
          for (int a = 0; a < 3; ++a) mfe[v * KP + a * Np + n] = 0.0f;
      }
    }
    if (n < KP - K)
      for (int v = 0; v < NQ; ++v) mfe[v * KP + K + n] = 0.0f;
  }
  __syncthreads();
  if (n >= Np) return;   // masked tail of the last warp; no sync follows

  // 2. weak divergence: acc[te][v] = sum_k mf[te][v][k] * wt[k][n]
  float acc[TE][NQ];
#pragma unroll
  for (int te = 0; te < TE; ++te)
#pragma unroll
    for (int v = 0; v < NQ; ++v) acc[te][v] = 0.0f;
  const float4* mf4 = reinterpret_cast<const float4*>(mf);
  const int KP4 = KP / 4;
  for (int k4 = 0; k4 < KP4; ++k4) {
    const float* w = in.wt + (size_t)(4 * k4) * Np + n;
    const float w0 = __ldg(w), w1 = __ldg(w + Np);
    const float w2 = __ldg(w + 2 * Np), w3 = __ldg(w + 3 * Np);
#pragma unroll
    for (int te = 0; te < TE; ++te)
#pragma unroll
      for (int v = 0; v < NQ; ++v) {
        const float4 a = mf4[(te * NQ + v) * KP4 + k4];
        float s = acc[te][v];
        s = fmaf(a.x, w0, s);
        s = fmaf(a.y, w1, s);
        s = fmaf(a.z, w2, s);
        s = fmaf(a.w, w3, s);
        acc[te][v] = s;
      }
  }

  // 3. scale by the inverse mass and store
#pragma unroll
  for (int te = 0; te < TE; ++te) {
    const int e = e0 + te;
    if (e < E) {
      const float mi = in.MI[(size_t)e * Np + n];
#pragma unroll
      for (int v = 0; v < NQ; ++v)
        in.out[((size_t)e * NQ + v) * Np + n] = mul(mi, acc[te][v]);
    }
  }
}

template <int KIND>
int launch(const Inputs& in, int E, int Np, cudaStream_t s) {
  const int KP = (3 * Np + 3) / 4 * 4;
  const int threads = (Np + 31) / 32 * 32;
  if (E <= 0 || Np <= 0 || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)TE * NQ * KP * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      volume_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  volume_kernel<KIND><<<(E + TE - 1) / TE, threads, smem, s>>>(in, E, Np,
                                                                 KP);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fused_volume_tendency_vm on `stream`: wt is Wdiv transposed and padded to
// [KP][Np] (KP = 3*Np rounded up to a multiple of 4, rows >= 3Np zero).  gl2
// and nu are read only with has_f2 != 0.  Returns the CUDA error code of the
// launch (0 on success).
int volume_vm_f32(const void* qv, const void* p, const void* pref,
                  const void* xiv, const void* M, const void* MI,
                  const void* gl2, const void* nu, const void* wt, void* out,
                  int E, int Np, int has_f2, void* stream) {
  Inputs in{};
  in.qv = static_cast<const float*>(qv);
  in.p = static_cast<const float*>(p);
  in.pref = static_cast<const float*>(pref);
  in.gl2 = static_cast<const float*>(gl2);
  in.nu = static_cast<const float*>(nu);
  in.xiv = static_cast<const float*>(xiv);
  in.M = static_cast<const float*>(M);
  in.MI = static_cast<const float*>(MI);
  in.wt = static_cast<const float*>(wt);
  in.out = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return has_f2 ? launch<P_GIVEN_F2>(in, E, Np, s)
                : launch<P_GIVEN>(in, E, Np, s);
}

// dry_volume_tendency on `stream`, wt as above.  ref3 is read only with
// remainder != 0 (lin_dims = (2,), lin_gravity).  R_d, inv_cv = 1/cv_d,
// T_0 and R_over_cv = R_d/cv_d are the float32 values of the constants.
// Returns the CUDA error code of the launch (0 on success).
int dry_volume_f32(const void* qv, const void* phi, const void* pref,
                   const void* ref3, const void* xiv, const void* M,
                   const void* MI, const void* wt, void* out, int E, int Np,
                   int remainder, float R_d, float inv_cv, float T_0,
                   float R_over_cv, void* stream) {
  Inputs in{};
  in.qv = static_cast<const float*>(qv);
  in.phi = static_cast<const float*>(phi);
  in.pref = static_cast<const float*>(pref);
  in.ref3 = static_cast<const float*>(ref3);
  in.xiv = static_cast<const float*>(xiv);
  in.M = static_cast<const float*>(M);
  in.MI = static_cast<const float*>(MI);
  in.wt = static_cast<const float*>(wt);
  in.out = static_cast<float*>(out);
  in.R_d = R_d;
  in.inv_cv = inv_cv;
  in.T_0 = T_0;
  in.R_over_cv = R_over_cv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return remainder ? launch<DRY_REMAINDER>(in, E, Np, s)
                   : launch<DRY>(in, E, Np, s);
}

const char* volume_vm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
