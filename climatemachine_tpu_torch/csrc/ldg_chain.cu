// Hyperdiffusion LDG chain (grad -> div -> grad) for Hopper (sm_90a).
//
// Replaces the four Pallas kernels of
// climatemachine_tpu/dg/pallas_ldg.py:chain_vm (_k_first, _k_grad_to_div,
// _k_div_to_grad, _k_last).  Between the kernels, plain PyTorch does the
// three face-row exchanges and the jump arithmetic
// (climatemachine_tpu_torch/dg/ldg_kernel.py).  Per element, with N rows
// (the chain's variables), ND reference directions and F face nodes:
//
//   K1 ldg_first        x [N][Np] -> vol[c][v][m] = sum_a xi[3a+c][m] *
//                       sum_k x[v][k] Wd[a][k][m],  rows[v][f] = x[v][sel[f]]
//   K2 ldg_grad_to_div  grad[c][v][m] = vol1 + MI[m] * sum_{f->m} w3[c][f] *
//                       dj[v][f]; then div[v] = sum_a sum_c xi[3a+c] *
//                       (grad[c][v] Wd[a]) and s[v][f] = sum_c nrm[c][f] *
//                       grad[c][v][sel[f]]
//   K3 ldg_div_to_grad  lap[v][m] = div + MI[m] * sum_{f->m} sM[f] *
//                       dj2[v][f]; then K1 on lap
//   K4 ldg_last         out[c][v][m] = vol3 + MI[m] * sum_{f->m} w3[c][f] *
//                       dj3[v][f]
//
// Sel and LT (the 0/1 face selection and lift of the Pallas kernels) are
// applied as index gathers, the same function: sel[f] is the volume node of
// face column f, and lift[m][0..L) lists the face columns that land on node
// m (-1 padded; a node sits on at most L of the active faces), in ascending
// order, so the sums run in the order of the dense product.
//
// What bounds them (E = 12288, Np = 125, N = 4, ND = 2, F = 100, float32,
// Sel/LT counted as data movement; the H100's 67 TFLOP/s fp32 and
// 3.35 TB/s).  With the derivative products counted dense, as these
// kernels compute them: K1 3.13 GFLOP vs 155 MB, 0.047 ms on operations
// (bytes 0.046 ms); K2 9.37 GFLOP vs 210 MB, 0.140 ms on operations; K3
// 3.14 GFLOP vs 186 MB, 0.055 ms on bytes; K4 188 MB, 0.056 ms on bytes.
// Wd is a Kronecker operator with Nq = 5 nonzeros a row, so sum-factorised
// the products cost ~25x fewer flops (K2 0.52 GFLOP) and every kernel is
// bound by bytes alone: K1 0.046, K2 0.063, K3 0.055, K4 0.056 ms.  The
// dense loop over k is the headroom a sum-factorised kernel would take.
//
// Design (the volume kernel's pattern, csrc/volume_vm.cu):
//   - a block of TE elements, one thread per node (Np = 125: 128 threads,
//     the tail masked after the last barrier);
//   - K1-K3 stage the rows they differentiate (x, the gradient after the
//     pass-1 lift, the Laplacian after the pass-2 lift) in dynamic shared
//     memory, padded to KP = Np rounded up to 4 with zeros and read as
//     float4 broadcasts;
//   - each thread accumulates its node's outputs in registers over k: one
//     __ldg of Wd[a][k][m] (neighbouring threads, neighbouring addresses;
//     125 KB, served from L2/L1) feeds TE*N (K1, K3: 32) or TE*3N (K2: 48)
//     FMAs;
//   - the lift that precedes a derivative (K2, K3) finishes for every row
//     before the __syncthreads() that opens the derivative;
//   - K2 holds 3N rows per element (the gradient) and 3N*ND accumulators
//     per element, so it takes TE = 4 where K1 and K3 take TE = 8;
//   - K4 has no derivative: one thread per output value.
// Tensor cores are not used.
//
// Rounding: outside the derivative products every product and sum is
// rounded as the plain PyTorch version rounds it (__fmul_rn/__fadd_rn keep
// nvcc from contracting them into FMAs), and the products accumulate k in
// ascending order with FMAs, as a GEMM does.  The first derivative of
// h_tot (~3e5 J/kg, nearly constant along the horizontal) cancels to ~1e-5
// of its terms, so another order would show at about the 1e-5 * max|plain|
// the kernels are held to.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int TE_GRAD = 8;   // K1, K3
constexpr int TE_DIV = 4;    // K2

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// sum over the face columns f that lift onto node m of a[f] * b[f]
__device__ __forceinline__ float lift_sum(const int* __restrict__ lift,
                                          int L, int m,
                                          const float* __restrict__ a,
                                          const float* __restrict__ b) {
  float acc = 0.0f;
  for (int l = 0; l < L; ++l) {
    const int f = __ldg(lift + m * L + l);
    if (f >= 0) acc = add(acc, mul(__ldg(a + f), __ldg(b + f)));
  }
  return acc;
}

// Volume gradient and face rows of the N rows per element staged in xs
// ([TE][N][KP]); called by every thread after the barrier that completes xs.
template <int N, int ND, int TE>
__device__ __forceinline__ void grad_part(
    const float* __restrict__ xs, int KP,
    const float* __restrict__ xi,    // [E][ND*3][Np]
    const float* __restrict__ wd,    // [ND][Np][Np]
    const int* __restrict__ sel,     // [F]
    float* __restrict__ vol,         // [E][3][N][Np]
    float* __restrict__ rows,        // [E][N][F]
    int e0, int E, int Np, int F) {
  const int m = threadIdx.x;
  for (int te = 0; te < TE && e0 + te < E; ++te) {
    const int e = e0 + te;
    for (int i = m; i < N * F; i += blockDim.x) {
      const int v = i / F, f = i - v * F;
      rows[((size_t)e * N + v) * F + f] = xs[(te * N + v) * KP + sel[f]];
    }
  }
  if (m >= Np) return;

  float d[TE][N][ND];
#pragma unroll
  for (int te = 0; te < TE; ++te)
#pragma unroll
    for (int v = 0; v < N; ++v)
#pragma unroll
      for (int a = 0; a < ND; ++a) d[te][v][a] = 0.0f;
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  const int KP4 = KP / 4;
  for (int k4 = 0; k4 < KP4; ++k4) {
    float w[ND][4];
#pragma unroll
    for (int a = 0; a < ND; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * k4 + j;
        w[a][j] = k < Np ? __ldg(wd + ((size_t)a * Np + k) * Np + m) : 0.0f;
      }
#pragma unroll
    for (int te = 0; te < TE; ++te)
#pragma unroll
      for (int v = 0; v < N; ++v) {
        const float4 x = xs4[(te * N + v) * KP4 + k4];
#pragma unroll
        for (int a = 0; a < ND; ++a) {
          float s = d[te][v][a];
          s = fmaf(x.x, w[a][0], s);
          s = fmaf(x.y, w[a][1], s);
          s = fmaf(x.z, w[a][2], s);
          s = fmaf(x.w, w[a][3], s);
          d[te][v][a] = s;
        }
      }
  }

#pragma unroll
  for (int te = 0; te < TE; ++te) {
    const int e = e0 + te;
    if (e >= E) break;
    float x[ND * 3];
#pragma unroll
    for (int j = 0; j < ND * 3; ++j)
      x[j] = xi[((size_t)e * ND * 3 + j) * Np + m];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int v = 0; v < N; ++v) {
        float acc = mul(x[c], d[te][v][0]);
#pragma unroll
        for (int a = 1; a < ND; ++a)
          acc = add(acc, mul(x[a * 3 + c], d[te][v][a]));
        vol[(((size_t)e * 3 + c) * N + v) * Np + m] = acc;
      }
  }
}

template <int N, int ND, int TE>
__global__ void __launch_bounds__(MAX_THREADS)
ldg_first_kernel(const float* __restrict__ x,    // [E][N][Np]
                 const float* __restrict__ xi, const float* __restrict__ wd,
                 const int* __restrict__ sel, float* __restrict__ vol,
                 float* __restrict__ rows, int E, int Np, int KP, int F) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [TE][N][KP]
  const int e0 = blockIdx.x * TE;
  for (int i = threadIdx.x; i < TE * N * KP; i += blockDim.x) {
    const int r = i / KP, k = i - r * KP;        // r = te * N + v
    xs[i] = (e0 + r / N < E && k < Np)
                ? x[((size_t)e0 * N + r) * Np + k] : 0.0f;
  }
  __syncthreads();
  grad_part<N, ND, TE>(xs, KP, xi, wd, sel, vol, rows, e0, E, Np, F);
}

template <int N, int ND, int TE>
__global__ void __launch_bounds__(MAX_THREADS)
ldg_div_to_grad_kernel(const float* __restrict__ div,   // [E][N][Np]
                       const float* __restrict__ dj2,   // [E][N][F]
                       const float* __restrict__ sm,    // [E][F]
                       const float* __restrict__ mi,    // [E][Np]
                       const int* __restrict__ lift, int L,
                       const float* __restrict__ xi,
                       const float* __restrict__ wd,
                       const int* __restrict__ sel, float* __restrict__ vol,
                       float* __restrict__ rows, int E, int Np, int KP,
                       int F) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [TE][N][KP]: lap
  const int e0 = blockIdx.x * TE;
  // pass-2 lift: lap = div + MI * (sM . dj2) LT
  for (int i = threadIdx.x; i < TE * N * KP; i += blockDim.x) {
    const int r = i / KP, k = i - r * KP;
    const int e = e0 + r / N;
    float val = 0.0f;
    if (e < E && k < Np) {
      const size_t row = (size_t)e0 * N + r;     // = e * N + v
      val = add(div[row * Np + k],
                mul(mi[(size_t)e * Np + k],
                    lift_sum(lift, L, k, sm + (size_t)e * F, dj2 + row * F)));
    }
    xs[i] = val;
  }
  __syncthreads();
  grad_part<N, ND, TE>(xs, KP, xi, wd, sel, vol, rows, e0, E, Np, F);
}

template <int N, int ND, int TE>
__global__ void __launch_bounds__(MAX_THREADS)
ldg_grad_to_div_kernel(const float* __restrict__ vol1,  // [E][3][N][Np]
                       const float* __restrict__ dj,    // [E][N][F]
                       const float* __restrict__ w3,    // [E][3][F]
                       const float* __restrict__ nrm,   // [E][3][F]
                       const float* __restrict__ mi,    // [E][Np]
                       const int* __restrict__ lift, int L,
                       const float* __restrict__ xi,    // [E][ND*3][Np]
                       const float* __restrict__ wd,    // [ND][Np][Np]
                       const int* __restrict__ sel,     // [F]
                       float* __restrict__ div,         // [E][N][Np]
                       float* __restrict__ s,           // [E][N][F]
                       int E, int Np, int KP, int F) {
  constexpr int R = 3 * N;                       // gradient rows (c, v)
  extern __shared__ float4 smem4[];
  float* gs = reinterpret_cast<float*>(smem4);   // [TE][3][N][KP]: grad
  const int e0 = blockIdx.x * TE;
  const int m = threadIdx.x;

  // pass-1 lift: grad = vol1 + MI * (w3 (x) dj) LT
  for (int i = m; i < TE * R * KP; i += blockDim.x) {
    const int r = i / KP, k = i - r * KP;        // r = te * R + c * N + v
    const int te = r / R, cv = r - te * R;
    const int c = cv / N, v = cv - c * N;
    const int e = e0 + te;
    float val = 0.0f;
    if (e < E && k < Np)
      val = add(vol1[((size_t)e0 * R + r) * Np + k],
                mul(mi[(size_t)e * Np + k],
                    lift_sum(lift, L, k, w3 + ((size_t)e * 3 + c) * F,
                             dj + ((size_t)e * N + v) * F)));
    gs[i] = val;
  }
  __syncthreads();

  // n . grad on the face nodes
  for (int te = 0; te < TE && e0 + te < E; ++te) {
    const int e = e0 + te;
    const float* g = gs + te * R * KP;
    for (int i = m; i < N * F; i += blockDim.x) {
      const int v = i / F, f = i - v * F;
      const int node = sel[f];
      const float* nf = nrm + (size_t)e * 3 * F + f;
      s[((size_t)e * N + v) * F + f] =
          add(add(mul(nf[0], g[v * KP + node]),
                  mul(nf[F], g[(N + v) * KP + node])),
              mul(nf[2 * F], g[(2 * N + v) * KP + node]));
    }
  }
  if (m >= Np) return;

  // pass-2 volume: dv[c][v][a] = sum_k grad[c][v][k] Wd[a][k][m]
  float dv[TE][R][ND];
#pragma unroll
  for (int te = 0; te < TE; ++te)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int a = 0; a < ND; ++a) dv[te][r][a] = 0.0f;
  const float4* gs4 = reinterpret_cast<const float4*>(gs);
  const int KP4 = KP / 4;
  for (int k4 = 0; k4 < KP4; ++k4) {
    float w[ND][4];
#pragma unroll
    for (int a = 0; a < ND; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * k4 + j;
        w[a][j] = k < Np ? __ldg(wd + ((size_t)a * Np + k) * Np + m) : 0.0f;
      }
#pragma unroll
    for (int te = 0; te < TE; ++te)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 x = gs4[(te * R + r) * KP4 + k4];
#pragma unroll
        for (int a = 0; a < ND; ++a) {
          float acc = dv[te][r][a];
          acc = fmaf(x.x, w[a][0], acc);
          acc = fmaf(x.y, w[a][1], acc);
          acc = fmaf(x.z, w[a][2], acc);
          acc = fmaf(x.w, w[a][3], acc);
          dv[te][r][a] = acc;
        }
      }
  }

  // div[v] = sum_a sum_c xi[3a+c] * dv[c][v][a], in that order
#pragma unroll
  for (int te = 0; te < TE; ++te) {
    const int e = e0 + te;
    if (e >= E) break;
    float x[ND * 3];
#pragma unroll
    for (int j = 0; j < ND * 3; ++j)
      x[j] = xi[((size_t)e * ND * 3 + j) * Np + m];
#pragma unroll
    for (int v = 0; v < N; ++v) {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < ND; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc = add(acc, mul(x[a * 3 + c], dv[te][c * N + v][a]));
      div[((size_t)e * N + v) * Np + m] = acc;
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
ldg_last_kernel(const float* __restrict__ vol3,  // [E][3][N][Np]
                const float* __restrict__ dj3,   // [E][N][F]
                const float* __restrict__ w3,    // [E][3][F]
                const float* __restrict__ mi,    // [E][Np]
                const int* __restrict__ lift, int L,
                float* __restrict__ out, int E, int N, int Np, int F) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)E * 3 * N * Np) return;
  const int m = (int)(i % Np);
  const size_t r = i / Np;                       // (e * 3 + c) * N + v
  const int v = (int)(r % N);
  const size_t ec = r / N;                       // e * 3 + c
  const size_t e = ec / 3;
  out[i] = add(vol3[i], mul(mi[e * Np + m],
                           lift_sum(lift, L, m, w3 + ec * F,
                                    dj3 + (e * N + v) * F)));
}

int kp_for(int Np) { return (Np + 3) / 4 * 4; }

bool supported(int N, int ND, int Np) {
  return N == 4 && ND == 2 && Np > 0 && (Np + 31) / 32 * 32 <= MAX_THREADS;
}

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns the CUDA error of
// the launch (0 on success).  N is the number of rows (chain variables),
// ND the number of reference directions; only N = 4, ND = 2 is built.

int ldg_first_f32(const void* x, const void* xi, const void* wd,
                  const void* sel, void* vol, void* rows, int E, int N,
                  int ND, int Np, int F, void* stream) {
  if (E <= 0 || F <= 0 || !supported(N, ND, Np))
    return (int)cudaErrorInvalidValue;
  const int KP = kp_for(Np);
  const size_t smem = (size_t)TE_GRAD * N * KP * sizeof(float);
  auto kernel = ldg_first_kernel<4, 2, TE_GRAD>;
  cudaError_t err = raise_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(E + TE_GRAD - 1) / TE_GRAD, (Np + 31) / 32 * 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(xi),
      static_cast<const float*>(wd), static_cast<const int*>(sel),
      static_cast<float*>(vol), static_cast<float*>(rows), E, Np, KP, F);
  return (int)cudaGetLastError();
}

int ldg_grad_to_div_f32(const void* vol1, const void* dj, const void* w3,
                        const void* nrm, const void* mi, const void* lift,
                        int L, const void* xi, const void* wd,
                        const void* sel, void* div, void* s, int E, int N,
                        int ND, int Np, int F, void* stream) {
  if (E <= 0 || F <= 0 || L <= 0 || !supported(N, ND, Np))
    return (int)cudaErrorInvalidValue;
  const int KP = kp_for(Np);
  const size_t smem = (size_t)TE_DIV * 3 * N * KP * sizeof(float);
  auto kernel = ldg_grad_to_div_kernel<4, 2, TE_DIV>;
  cudaError_t err = raise_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(E + TE_DIV - 1) / TE_DIV, (Np + 31) / 32 * 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol1), static_cast<const float*>(dj),
      static_cast<const float*>(w3), static_cast<const float*>(nrm),
      static_cast<const float*>(mi), static_cast<const int*>(lift), L,
      static_cast<const float*>(xi), static_cast<const float*>(wd),
      static_cast<const int*>(sel), static_cast<float*>(div),
      static_cast<float*>(s), E, Np, KP, F);
  return (int)cudaGetLastError();
}

int ldg_div_to_grad_f32(const void* div, const void* dj2, const void* sm,
                        const void* mi, const void* lift, int L,
                        const void* xi, const void* wd, const void* sel,
                        void* vol, void* rows, int E, int N, int ND, int Np,
                        int F, void* stream) {
  if (E <= 0 || F <= 0 || L <= 0 || !supported(N, ND, Np))
    return (int)cudaErrorInvalidValue;
  const int KP = kp_for(Np);
  const size_t smem = (size_t)TE_GRAD * N * KP * sizeof(float);
  auto kernel = ldg_div_to_grad_kernel<4, 2, TE_GRAD>;
  cudaError_t err = raise_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(E + TE_GRAD - 1) / TE_GRAD, (Np + 31) / 32 * 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(div), static_cast<const float*>(dj2),
      static_cast<const float*>(sm), static_cast<const float*>(mi),
      static_cast<const int*>(lift), L, static_cast<const float*>(xi),
      static_cast<const float*>(wd), static_cast<const int*>(sel),
      static_cast<float*>(vol), static_cast<float*>(rows), E, Np, KP, F);
  return (int)cudaGetLastError();
}

int ldg_last_f32(const void* vol3, const void* dj3, const void* w3,
                 const void* mi, const void* lift, int L, void* out, int E,
                 int N, int Np, int F, void* stream) {
  if (E <= 0 || N <= 0 || Np <= 0 || F <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)E * 3 * N * Np;
  ldg_last_kernel<<<(unsigned)((total + MAX_THREADS - 1) / MAX_THREADS),
                    MAX_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vol3), static_cast<const float*>(dj3),
      static_cast<const float*>(w3), static_cast<const float*>(mi),
      static_cast<const int*>(lift), L, static_cast<float*>(out), E, N, Np,
      F);
  return (int)cudaGetLastError();
}

const char* ldg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
