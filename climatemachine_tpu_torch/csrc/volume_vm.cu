// Fused var-major DG volume tendency for Hopper (sm_90a).
//
// Replaces climatemachine_tpu/dg/pallas_volume.py:fused_volume_tendency_vm
// (Pallas body _kernel_vm) for the configurations the dry Held-Suarez step
// runs: 5 prognostic variables (rho, rhou[3], rhoe), the reference
// pressure subtracted from the momentum flux, no linear-flux subtraction,
// with or without the hyperdiffusive flux F2 of DryBiharmonic (ngl = 4
// chain variables u_h[3], h_tot).  Per element e, variable v and node n:
//
//   mf[v][a*Np + m] = M[m] * sum_i xi[3a+i][m] * (F_i[v](m) + F2_i[v](m))
//   out[e][v][n]    = MI[n] * sum_k Wdiv[n][k] * mf[v][k],  k < 3*Np
//
//   F2_i[rhou_j] = rho nu4 gl2[i][j],
//   F2_i[rhoe]   = nu4 sum_j rhou_j gl2[i][j] + rho nu4 gl2[i][3]
//
// with gl2[i][j] = d_i Laplacian(u_h, h_tot)_j (lane 4i+j of [E][12][Np])
// and nu4 lane 0 of [E][2][Np].
//
// What bounds it: at p4 (Np = 125) the dense contraction, as this kernel
// computes it, is 2*5*375 = 3750 flops per node against 23 floats read or
// written per node (37 with F2), ~41 (~25) flops per byte, above the
// H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so the fp32 FMA
// pipes bound it: 0.089 ms (0.091 with F2) at E = 12288.  Wdiv is a
// Kronecker operator with Nq = 5 nonzeros a row per direction, so sum-
// factorised the contraction is 2*5*15 = 150 flops per node and bytes
// alone bound it: 0.042 ms (0.068 with F2).
//
// Design: one block of TE elements, one thread per node (the last warp
// masked: Np = 125 is not a multiple of 32).
//   1. Each thread builds the flux of its node from q, p and p_ref (and,
//      with F2, gl2 and nu) and writes M * xi . F for 5 variables x 3
//      directions of TE elements into shared memory (TE * 5 * KP floats;
//      rows padded to KP = 3Np rounded up to 4 with zeros so they can be
//      read as float4).  F2 is a template parameter: the flux pass is the
//      only part that differs.
//   2. Each thread accumulates its node's 5*TE outputs in registers over
//      k: one read of Wdiv^T[k][n] (pre-transposed to [KP][Np] so that
//      neighbouring threads read neighbouring addresses; 188 KB, served
//      from L2/L1) feeds 5*TE FMAs, and the mf values are float4
//      broadcast reads from shared memory.  TE = 8 keeps the FMA count per
//      Wdiv load at 40, enough that the fp32 pipes and not the L2 reads
//      are the limit.
//   3. Scale by MI and store.
// Tensor cores (wgmma with split TF32) are not used.
//
// Rounding: the flux pass rounds each product and sum as the plain
// PyTorch version does (__fmul_rn/__fadd_rn keep nvcc from contracting
// them into FMAs), and the contraction accumulates k in ascending order
// with FMAs, as a GEMM does.  On a near-hydrostatic state the divergence
// cancels to ~1e-5 of its terms, so a rounding difference in mf would
// show at about the 1e-5 * max|plain| the kernel is held to.

#include <cuda_runtime.h>

namespace {

constexpr int NQ = 5;
constexpr int TE = 8;
constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

__global__ void transpose_pad_kernel(const float* __restrict__ wdiv,
                                     float* __restrict__ wt,
                                     int Np, int K, int KP) {
  // wdiv [Np][K] -> wt [KP][Np], rows k >= K zero
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= KP * Np) return;
  const int k = idx / Np, n = idx - k * Np;
  wt[idx] = (k < K) ? wdiv[n * K + k] : 0.0f;
}

template <bool HAS_F2>
__global__ void __launch_bounds__(MAX_THREADS)
volume_vm_kernel(const float* __restrict__ qv,    // [E][5][Np]
                 const float* __restrict__ p,     // [E][Np]
                 const float* __restrict__ pref,  // [E][Np]
                 const float* __restrict__ xiv,   // [E][9][Np]
                 const float* __restrict__ M,     // [E][Np]
                 const float* __restrict__ MI,    // [E][Np]
                 const float* __restrict__ gl2,   // [E][12][Np] (F2 only)
                 const float* __restrict__ nu,    // [E][2][Np]  (F2 only)
                 const float* __restrict__ wt,    // [KP][Np]
                 float* __restrict__ out,         // [E][5][Np]
                 int E, int Np, int KP) {
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
        const size_t en = (size_t)e * Np + n;
        const float* q = qv + (size_t)e * NQ * Np + n;
        const float rho = q[0];
        const float ru[3] = {q[Np], q[2 * Np], q[3 * Np]};
        const float rhoe = q[4 * Np];
        const float pv = p[en];
        const float inv_rho = 1.0f / rho;
        const float u[3] = {mul(ru[0], inv_rho), mul(ru[1], inv_rho),
                            mul(ru[2], inv_rho)};
        const float p_eff = __fsub_rn(pv, pref[en]);
        const float h = add(rhoe, pv);
        const float m = M[en];
        const float* xi = xiv + (size_t)e * 9 * Np + n;
        float x[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) x[j] = xi[j * Np];
        float F[3][NQ];
        float F2[3][NQ];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          F[i][0] = ru[i];
#pragma unroll
          for (int j = 0; j < 3; ++j)
            F[i][1 + j] = (i == j) ? add(mul(ru[j], u[i]), p_eff)
                                   : mul(ru[j], u[i]);
          F[i][4] = mul(h, u[i]);
        }
        if (HAS_F2) {
          const float nu4 = nu[(size_t)e * 2 * Np + n];
          const float rnu = mul(rho, nu4);
          const float* g = gl2 + (size_t)e * 12 * Np + n;
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
#pragma unroll
        for (int v = 0; v < NQ; ++v)
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            float acc = add(add(mul(x[3 * a], F[0][v]),
                                mul(x[3 * a + 1], F[1][v])),
                            mul(x[3 * a + 2], F[2][v]));
            if (HAS_F2 && v > 0) {
#pragma unroll
              for (int i = 0; i < 3; ++i)
                acc = add(acc, mul(x[3 * a + i], F2[i][v]));
            }
            mfe[v * KP + a * Np + n] = mul(m, acc);
          }
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
    const float* w = wt + (size_t)(4 * k4) * Np + n;
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
      const float mi = MI[(size_t)e * Np + n];
#pragma unroll
      for (int v = 0; v < NQ; ++v)
        out[((size_t)e * NQ + v) * Np + n] = mul(mi, acc[te][v]);
    }
  }
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`; wt is caller-allocated scratch of
// KP*Np floats (KP = 3*Np rounded up to a multiple of 4).  gl2 and nu are
// read only with has_f2 != 0.  Returns the CUDA error code of the launches
// (0 on success).
int volume_vm_f32(const void* qv, const void* p, const void* pref,
                  const void* xiv, const void* M, const void* MI,
                  const void* gl2, const void* nu, const void* wdiv,
                  void* wt, void* out, int E, int Np, int has_f2,
                  void* stream) {
  const int K = 3 * Np;
  const int KP = (K + 3) / 4 * 4;
  const int threads = (Np + 31) / 32 * 32;
  if (E <= 0 || Np <= 0 || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)TE * NQ * KP * sizeof(float);
  auto kernel = has_f2 ? volume_vm_kernel<true> : volume_vm_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  transpose_pad_kernel<<<(KP * Np + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(wdiv), static_cast<float*>(wt), Np, K, KP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel<<<(E + TE - 1) / TE, threads, smem, s>>>(
      static_cast<const float*>(qv), static_cast<const float*>(p),
      static_cast<const float*>(pref), static_cast<const float*>(xiv),
      static_cast<const float*>(M), static_cast<const float*>(MI),
      static_cast<const float*>(gl2), static_cast<const float*>(nu),
      static_cast<const float*>(wt), static_cast<float*>(out), E, Np, KP);
  return (int)cudaGetLastError();
}

const char* volume_vm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
