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
// 3.35 TB/s).  With the derivative products counted dense, as K1 and K3
// compute them: K1 3.13 GFLOP vs 155 MB, 0.047 ms on operations (bytes
// 0.046 ms); K2 9.37 GFLOP vs 210 MB; K3 3.14 GFLOP vs 186 MB, 0.055 ms on
// bytes; K4 188 MB, 0.056 ms on bytes.  Wd is a Kronecker operator: a
// row's Nq = 5 nonzeros lie on one line of the Nq^3 node lattice
// (dg/line_ops.py).  Sum-factorised, K2 does 0.52 GFLOP and every kernel
// is bound by bytes alone: K1 0.046, K2 0.063, K3 0.055, K4 0.056 ms.
//
// Design of K1 and K3 (the volume kernel's first pattern): a block of TE
// elements, one thread per node (Np = 125: 128 threads, the tail masked
// after the last barrier); the rows they differentiate (x; the Laplacian
// after the pass-2 lift) staged in dynamic shared memory, padded to KP =
// Np rounded up to 4 with zeros and read as float4 broadcasts; each
// thread accumulates its node's outputs in registers over all k, one
// __ldg of Wd[a][k][m] (125 KB, from L2/L1) feeding TE*N = 32 FMAs.  K4
// has no derivative: one thread per output value.
//
// Design of K2 (sum-factorised, bound by its bytes):
//   - persistent blocks (as many as fit on the SMs: two of 512 threads)
//     walk tiles of TE = 4 elements; each tile's six inputs are contiguous
//     runs (at p4 vol1 6000 B, xi 3000, dj 1600, w3 and nrm 1200, MI 500
//     an element), staged by TMA bulk copies into one of two stages of
//     shared memory (tile_pipeline.cuh), so the next tile's bytes are in
//     flight while the current tile computes;
//   - the pass-1 lift reads dj, w3 and the lift table (transposed, [L][Np])
//     from shared memory, one thread per (element, node) for the 12
//     gradient rows, and writes the gradient over vol1 in place;
//   - n . grad reads the face nodes of the staged gradient, one thread per
//     (element, face column), into dj's dead run;
//   - the divergence, one thread per (element, node) for the N rows: for
//     each direction the Nq weights of the node's line (line table in
//     shared memory, the node's line start and position precomputed) and
//     Nq FMAs per (c, row) along the line, at node stride 1 or Nq (a warp's
//     reads span fewer than 32 consecutive words: no bank conflicts);
//   - div goes to w3 | MI | nrm's dead runs, and both outputs leave as
//     16-byte stores of the tile's contiguous runs.
//   About 110 KB of shared memory a block at p4 (two blocks a SM), 178 KB
//   at p5 (one); 25 FMAs for every node's 125 at p4 (sum-factorised: 0.52
//   GFLOP, ~0.008 ms), so tensor cores have nothing to do here.
//   The line order NQ is a template parameter, built for NQ = 2..6 (p1-p5,
//   tile::by_order); the bench shape is p4.
//
// Rounding: outside the derivative products every product and sum is
// rounded as the plain PyTorch version rounds it (__fmul_rn/__fadd_rn keep
// nvcc from contracting them into FMAs), and the products accumulate k in
// ascending order with FMAs, as a GEMM does: K1 and K3 over all k, K2 over
// the line's Nq entries in ascending k, which is the same float32 number
// (an FMA with an exact zero weight leaves the sum as it was).  The first
// derivative of h_tot (~3e5 J/kg, nearly constant along the horizontal)
// cancels to ~1e-5 of its terms, so another order would show at about the
// 1e-5 * max|plain| the kernels are held to.

#include <cuda_runtime.h>

#include "tile_pipeline.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int TE_GRAD = 8;     // K1, K3
constexpr int K2_TE = 4;       // K2: elements a tile
constexpr int K2_THREADS = 512;

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

// K2's shared memory at NQ nodes a line, in 4-byte words: the two stage
// mbarriers, the line weights [ND][NQ][NQ], each node's line (base |
// position << 16) per direction, the lift table transposed [L][NP], sel
// [F]; then two stages of TE elements, each [vol1 | dj | w3 | mi | nrm |
// xi] as the tile's contiguous runs (every offset a multiple of 4 words:
// 16-byte aligned).
template <int NQ>
struct K2Layout {
  static constexpr int NP = NQ * NQ * NQ;
  int lines, info, lift, sel, stage, stage_words;
  int vol1, dj, w3, mi, nrm, xi;
  __host__ __device__ K2Layout(int N, int ND, int F, int L) {
    lines = 4;
    info = lines + ND * NQ * NQ;
    lift = info + ND * NP;
    sel = lift + L * NP;
    stage = (sel + F + 31) / 32 * 32;
    vol1 = 0;
    dj = vol1 + K2_TE * 3 * N * NP;
    w3 = dj + K2_TE * N * F;
    mi = w3 + K2_TE * 3 * F;
    nrm = mi + K2_TE * NP;
    xi = nrm + K2_TE * 3 * F;
    stage_words = (xi + K2_TE * ND * 3 * NP + 31) / 32 * 32;
  }
  __host__ __device__ size_t bytes() const {
    return 4 * (size_t)(stage + 2 * stage_words);
  }
};

// K2's operands (NP = NQ^3 nodes an element).
struct K2Args {
  const float* vol1;   // [E][3][N][NP]
  const float* dj;     // [E][N][F]
  const float* w3;     // [E][3][F]
  const float* nrm;    // [E][3][F]
  const float* mi;     // [E][NP]
  const int* lift;     // [NP][L]
  int L;
  const float* xi;     // [E][ND*3][NP]
  const float* lines;  // [ND][NQ][NQ]
  tile::Strides strides;
  const int* sel;      // [F]
  float* div;          // [E][N][NP]
  float* s;            // [E][N][F]
  int E, F;
};

template <int N, int ND, int NQ>
__global__ void __launch_bounds__(K2_THREADS)
ldg_grad_to_div_kernel(const K2Args args) {
  static_assert(N % 4 == 0, "div and s rows go out as float4");
  constexpr int NP = NQ * NQ * NQ;
  constexpr int ITEMS = (K2_TE * NP + K2_THREADS - 1) / K2_THREADS;
  const int E = args.E, F = args.F, L = args.L;
  const tile::Strides strides = args.strides;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
  const K2Layout<NQ> lay(N, ND, F, L);
  float* ln = sm + lay.lines;
  int* info = reinterpret_cast<int*>(sm + lay.info);
  int* liftT = reinterpret_cast<int*>(sm + lay.lift);
  int* sels = reinterpret_cast<int*>(sm + lay.sel);
  const int tid = threadIdx.x;
  const int tiles = (E + K2_TE - 1) / K2_TE;
  const tile::Segment seg[6] = {
      {args.vol1, 3 * N * NP, lay.vol1}, {args.dj, N * F, lay.dj},
      {args.w3, 3 * F, lay.w3},          {args.mi, NP, lay.mi},
      {args.nrm, 3 * F, lay.nrm},        {args.xi, ND * 3 * NP, lay.xi}};
  auto stage = [&](int st) { return sm + lay.stage + st * lay.stage_words; };
  auto first = [&](int t) { return t * K2_TE; };
  auto count = [&](int t) { return min(K2_TE, E - t * K2_TE); };

  if (tid == 0) {
    tile::bar_init(&bar[0]);
    tile::bar_init(&bar[1]);
    tile::bar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int st = 0; st < 2; ++st) {
      const int t = blockIdx.x + st * gridDim.x;
      if (t < tiles)
        tile::issue(stage(st), &bar[st], seg, nullptr, first(t), count(t));
    }
  // the static tables, while the first tiles are in flight
  for (int i = tid; i < ND * NQ * NQ; i += blockDim.x) ln[i] = args.lines[i];
  for (int i = tid; i < ND * NP; i += blockDim.x) {
    const int a = i / NP, m = i - a * NP, st = strides.at(a);
    const int q = (m / st) % NQ;
    info[i] = (m - q * st) | (q << 16);
  }
  for (int i = tid; i < L * NP; i += blockDim.x) {
    const int l = i / NP, k = i - l * NP;
    liftT[i] = args.lift[k * L + l];
  }
  for (int i = tid; i < F; i += blockDim.x) sels[i] = args.sel[i];
  __syncthreads();

  for (int it = 0, t = blockIdx.x; t < tiles; ++it, t += gridDim.x) {
    const int st = it & 1;
    float* S = stage(st);
    const int e0 = first(t), ne = count(t);
    tile::bar_wait(&bar[st], (it >> 1) & 1);
    tile::fill_tail(S, seg, e0, ne);
    __syncthreads();
    float* g = S + lay.vol1;              // vol1, then the gradient
    const float* djs = S + lay.dj;
    const float* w3s = S + lay.w3;
    const float* mis = S + lay.mi;
    const float* nrms = S + lay.nrm;
    const float* xis = S + lay.xi;

    // 1. pass-1 lift, in place: grad = vol1 + MI * (w3 (x) dj) LT
    for (int i = tid; i < ne * NP; i += blockDim.x) {
      const int te = i / NP, k = i - te * NP;
      float acc[3][N];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int v = 0; v < N; ++v) acc[c][v] = 0.0f;
      for (int l = 0; l < L; ++l) {
        const int f = liftT[l * NP + k];
        if (f < 0) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float w = w3s[(te * 3 + c) * F + f];
#pragma unroll
          for (int v = 0; v < N; ++v)
            acc[c][v] = add(acc[c][v], mul(w, djs[(te * N + v) * F + f]));
        }
      }
      const float mk = mis[te * NP + k];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int v = 0; v < N; ++v) {
          float* gp = g + ((te * 3 + c) * N + v) * NP + k;
          *gp = add(*gp, mul(mk, acc[c][v]));
        }
    }
    __syncthreads();

    // 2. n . grad on the face nodes, into dj's (dead) run
    float* so = S + lay.dj;
    for (int i = tid; i < ne * F; i += blockDim.x) {
      const int te = i / F, f = i - te * F;
      const float* nf = nrms + te * 3 * F + f;
      const float n0 = nf[0], n1 = nf[F], n2 = nf[2 * F];
      const float* gt = g + te * 3 * N * NP + sels[f];
#pragma unroll
      for (int v = 0; v < N; ++v)
        so[(te * N + v) * F + f] =
            add(add(mul(n0, gt[v * NP]), mul(n1, gt[(N + v) * NP])),
                mul(n2, gt[(2 * N + v) * NP]));
    }

    // 3. pass-2 volume along the lines:
    //    div[v] = sum_a sum_c xi[3a+c] * sum_j grad[c][v][line_a(j)] V_a[j]
    float dv[ITEMS][N];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int i = tid + r * K2_THREADS;
      if (i >= ne * NP) break;
      const int te = i / NP, m = i - te * NP;
      float acc[N];
#pragma unroll
      for (int v = 0; v < N; ++v) acc[v] = 0.0f;
#pragma unroll
      for (int a = 0; a < ND; ++a) {
        const int inf = info[a * NP + m], sa = strides.at(a);
        const float* V = ln + (a * NQ + (inf >> 16)) * NQ;
        float w[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) w[j] = V[j];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float x = xis[(te * ND * 3 + 3 * a + c) * NP + m];
          const float* gl = g + (te * 3 + c) * N * NP + (inf & 0xffff);
#pragma unroll
          for (int v = 0; v < N; ++v) {
            float d = 0.0f;
#pragma unroll
            for (int j = 0; j < NQ; ++j) d = fmaf(gl[v * NP + j * sa], w[j], d);
            acc[v] = add(acc[v], mul(x, d));
          }
        }
      }
#pragma unroll
      for (int v = 0; v < N; ++v) dv[r][v] = acc[v];
    }
    __syncthreads();                       // w3, mi, nrm are dead now

    float* dvo = S + lay.w3;               // [te][N][NP] over w3 | mi | nrm
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int i = tid + r * K2_THREADS;
      if (i >= ne * NP) break;
      const int te = i / NP, m = i - te * NP;
#pragma unroll
      for (int v = 0; v < N; ++v) dvo[(te * N + v) * NP + m] = dv[r][v];
    }
    __syncthreads();

    // 4. the tile's div and s runs, 16 bytes a thread
    {
      float4* out = reinterpret_cast<float4*>(args.s + (size_t)e0 * N * F);
      const float4* in = reinterpret_cast<const float4*>(so);
      for (int i = tid; i < ne * N * F / 4; i += blockDim.x) out[i] = in[i];
      out = reinterpret_cast<float4*>(args.div + (size_t)e0 * N * NP);
      in = reinterpret_cast<const float4*>(dvo);
      for (int i = tid; i < ne * N * NP / 4; i += blockDim.x) out[i] = in[i];
    }
    tile::fence_async_proxy();
    __syncthreads();                       // the stage is free
    const int next = t + 2 * gridDim.x;
    if (tid == 0 && next < tiles)
      tile::issue(S, &bar[st], seg, nullptr, first(next), count(next));
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

// K2 at NQ nodes a line: one persistent block for each that fits on the
// SMs with its shared memory (two a SM at p4, one at p5).
template <int NQ>
int launch_grad_to_div(const K2Args& args, cudaStream_t stream) {
  const K2Layout<NQ> lay(4, 2, args.F, args.L);
  // div is staged over the dead runs w3 | mi | nrm (F = 4 NQ^2 faces
  // nodes: room up to NQ = 8)
  if (lay.xi - lay.w3 < K2_TE * 4 * K2Layout<NQ>::NP)
    return (int)cudaErrorInvalidValue;
  auto kernel = ldg_grad_to_div_kernel<4, 2, NQ>;
  static int2 cache[16];
  int grid = 0;
  cudaError_t err = tile::persistent_grid(kernel, K2_THREADS, lay.bytes(),
                                          (args.E + K2_TE - 1) / K2_TE, cache,
                                          &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, K2_THREADS, lay.bytes(), stream>>>(args);
  return (int)cudaGetLastError();
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
// K2 takes Wd as its line table (lines [ND][NQ][NQ], the node strides of
// the two directions' lines; dg/line_ops.py), Np = NQ^3 with NQ = 2..6
// (tile::by_order), and 16-byte aligned runs.

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
                        int L, const void* xi, const void* lines,
                        int stride0, int stride1, const void* sel, void* div,
                        void* s, int E, int N, int ND, int Np, int F,
                        void* stream) {
  if (E <= 0 || F <= 0 || L <= 0 || N != 4 || ND != 2 || stride0 <= 0 ||
      stride1 <= 0 || stride0 > Np || stride1 > Np)
    return (int)cudaErrorInvalidValue;
  const void* runs[] = {vol1, dj, w3, nrm, mi, xi, div, s};
  for (const void* ptr : runs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16)
      return (int)cudaErrorMisalignedAddress;
  const K2Args args{
      static_cast<const float*>(vol1), static_cast<const float*>(dj),
      static_cast<const float*>(w3), static_cast<const float*>(nrm),
      static_cast<const float*>(mi), static_cast<const int*>(lift), L,
      static_cast<const float*>(xi), static_cast<const float*>(lines),
      tile::Strides{{stride0, stride1, 0}}, static_cast<const int*>(sel),
      static_cast<float*>(div), static_cast<float*>(s), E, F};
  return tile::by_order(Np, [&](auto nq) {
    return launch_grad_to_div<decltype(nq)::value>(
        args, static_cast<cudaStream_t>(stream));
  });
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
