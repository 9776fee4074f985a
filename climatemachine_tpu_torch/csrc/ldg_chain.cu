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
// order, so the sums run in the order of the dense product.  Wd is a
// Kronecker operator: a row's Nq nonzeros lie on one line of the Nq^3 node
// lattice, and K1-K3 read it only as its line table (dg/line_ops.py): the
// Nq x Nq weights of each direction and the node stride of its lines.
//
// N is 4 rows (u_h[3], h_tot) for the dry chain, 5 with the q_tot of
// EquilMoistBiharmonic; the kernels are built for both.
//
// What bounds them (E = 12288, Np = 125, Nq = 5, N = 4, ND = 2, F = 100,
// float32, Sel/LT counted as data movement; the H100's 67 TFLOP/s fp32
// and 3.35 TB/s).  Sum-factorised, a derivative is 2 Nq flops a node, row
// and direction (K1 and K3 0.06 GFLOP, K2 0.52), so bytes alone bound
// every kernel: K1 155 MB, 0.046 ms; K2 210 MB, 0.063 ms; K3 186 MB,
// 0.055 ms; K4 188 MB, 0.056 ms (N = 5: 5/4 of each, about).  Counted
// dense (the Np terms a node that
// the TPU kernels compute), K1-K3 were bound by the fp32 pipes (3.1-9.4
// GFLOP); K4 has no derivative (0.05 GFLOP of lift either way).  Of K1's
// and K3's bytes the outputs are 60 and 50 %: vol 6000 B and rows 1600 B
// an element; of K4's 39 %, out 6000 B.
//
// Design (staged, bound by their bytes; K1 and K3 are one template,
// ldg_grad_kernel, K3 with the lift as its prologue; K1-K3 sum-factorised;
// K4, ldg_last_kernel, is K2's lift alone):
//   - persistent blocks of 512 threads (as many as fit on the SMs) walk
//     tiles of TE = 4 elements; each tile's inputs are contiguous runs, at
//     p4 an element's: K1 x 2000 B and xi 3000; K2 vol1 6000, xi 3000, dj
//     1600, w3 and nrm 1200 each, MI 500; K3 div 2000, xi 3000, dj2 1600,
//     sM 400, MI 500; K4 vol3 6000, dj3 1600, w3 1200, MI 500.  They are
//     staged by TMA bulk copies into one of two stages of shared memory
//     (tile_pipeline.cuh), so the next tile's bytes are in flight while
//     the current tile computes.  The static tables (the line weights,
//     each node's line start and position per direction, the lift table
//     transposed [L][Np], sel; K4 the lift table only) are loaded once a
//     block while the first tiles are in flight;
//   - the lift (K2's pass 1 onto vol1's 12 rows and K4's pass 3 onto
//     vol3's, one function, lift_w3; K3's pass 2 onto div's 4) reads the
//     staged face values and the lift table, one thread per (element,
//     node) with one accumulator a row, and adds onto the staged rows in
//     place; a barrier then completes the rows before any thread reads
//     along a line;
//   - face values: K2's n . grad, one thread per (element, face column),
//     into dj's dead run; K1's and K3's rows, one thread per float of the
//     tile's contiguous rows run, stored at once (a warp writes 128
//     consecutive bytes);
//   - the derivatives, one thread per (element, node): for each direction
//     the Nq weights of the node's line and Nq FMAs per row along the
//     line, at node stride 1 or Nq (a warp's reads span fewer than 32
//     consecutive words of a row: no bank conflicts); then the metric
//     terms (K1, K3: 12 vol values a node; K2: the divergence of 4);
//   - K2's div and s go to dead input runs and leave as 16-byte stores of
//     the tile's contiguous runs.  K1's and K3's vol (6000 B an element at
//     p4) goes to a vol tile in shared memory, and K4's out is its staged
//     vol3 run after the lift; either leaves as one TMA bulk copy of the
//     tile's contiguous run (cp.async.bulk, shared -> global), issued by
//     one thread after the tile's last barrier.  The store runs while the
//     block goes on; that thread waits for it to have read the shared
//     memory before it is written again: K1 and K3 before the next tile's
//     derivatives write the vol tile, K4 before the stage goes back to the
//     copy engine for the tile after next.  Stores straight from registers
//     (a warp writes 128 consecutive bytes of a (c, v) row) were measured
//     slower on an NVIDIA H100 (PERF.md).
//   Shared memory a block at p4: K1 64 KiB, K2 108, K3 85, K4 74; at p5
//   K1 111, K2 178, K3 142, K4 121; at N = 5 about 5/4 of each (K2 126
//   KiB at p4: one block an SM, where two fit at N = 4).  A run whose
//   size is no multiple of 16 bytes (at N = 5 the last, partial tile's)
//   leaves by its 16-byte floor in bulk and its <= 3 last floats by
//   threads.  ptxas gives K1 and K3 32 registers at
//   every order (K2 59 at p4), no spills.  The line order NQ is a template
//   parameter, built for NQ = 2..6 (p1-p5, tile::by_order); the bench
//   shape is p4.  Tensor cores have nothing to do here: 2 Nq flops per
//   node, row and direction.
//
// Rounding: outside the derivative products every product and sum is
// rounded as the plain PyTorch version rounds it (__fmul_rn/__fadd_rn keep
// nvcc from contracting them into FMAs), and the products accumulate the
// line's Nq entries in ascending k with FMAs: the float32 number of a
// GEMM's loop over all k in ascending order (an FMA with an exact zero
// weight leaves the sum as it was).  The first derivative of h_tot (~3e5
// J/kg, nearly constant along the horizontal) cancels to ~1e-5 of its
// terms, so another order would show at about the 1e-5 * max|plain| the
// kernels are held to.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "tile_pipeline.cuh"

namespace {

constexpr int TILE_E = 4;          // elements a tile
constexpr int TILE_THREADS = 512;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// sum_j x[j * stride] * w[j] in ascending j, with FMAs
template <int NQ>
__device__ __forceinline__ float along_line(const float* x, int stride,
                                            const float (&w)[NQ]) {
  float d = 0.0f;
#pragma unroll
  for (int j = 0; j < NQ; ++j) d = fmaf(x[j * stride], w[j], d);
  return d;
}

// K1-K3's static tables in shared memory at NQ nodes a line, in 4-byte
// words after the two stage mbarriers: the line weights [ND][NQ][NQ],
// each node's line (base | position << 16) per direction [ND][NP], the
// lift table transposed [L][NP] (L = 0 for K1), sel [F]; `end` the first
// word after them, 128-byte aligned.
template <int NQ>
struct Tables {
  static constexpr int NP = NQ * NQ * NQ;
  int lines, info, lift, sel, end;
  __host__ __device__ Tables(int ND, int F, int L) {
    lines = 4;
    info = lines + ND * NQ * NQ;
    lift = info + ND * NP;
    sel = lift + L * NP;
    end = (sel + F + 31) / 32 * 32;
  }
};

// Run by every thread of the block, once, while the first tiles are in
// flight.
template <int NQ>
__device__ __forceinline__ void load_tables(
    float* sm, const Tables<NQ>& tb, int ND, const float* __restrict__ lines,
    const tile::Strides& strides, const int* __restrict__ lift, int L,
    const int* __restrict__ sel, int F) {
  constexpr int NP = Tables<NQ>::NP;
  float* ln = sm + tb.lines;
  int* info = reinterpret_cast<int*>(sm + tb.info);
  int* liftT = reinterpret_cast<int*>(sm + tb.lift);
  int* sels = reinterpret_cast<int*>(sm + tb.sel);
  for (int i = threadIdx.x; i < ND * NQ * NQ; i += blockDim.x)
    ln[i] = lines[i];
  for (int i = threadIdx.x; i < ND * NP; i += blockDim.x) {
    const int a = i / NP, m = i - a * NP, st = strides.at(a);
    const int q = (m / st) % NQ;
    info[i] = (m - q * st) | (q << 16);
  }
  for (int i = threadIdx.x; i < L * NP; i += blockDim.x) {
    const int l = i / NP, k = i - l * NP;
    liftT[i] = lift[k * L + l];
  }
  for (int i = threadIdx.x; i < F; i += blockDim.x) sels[i] = sel[i];
}

// The lift of K2's pass 1 and K4's pass 3, in place on a staged tile of
// ne elements, one thread per (element, node) with one accumulator a row:
//   g[te][c][v][k] += MI[te][k] * sum_l w3[te][c][f] * dj[te][v][f]
// over the face columns f = liftT[l * NP + k] >= 0, in ascending slot l.
template <int N, int NP>
__device__ __forceinline__ void lift_w3(float* g, const float* djs,
                                        const float* w3s, const float* mis,
                                        const int* liftT, int L, int F,
                                        int ne) {
  for (int i = threadIdx.x; i < ne * NP; i += blockDim.x) {
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
}

// K1's and K3's shared memory at NQ nodes a line: the tables; the vol
// tile [TE][3][N][NP]; then two stages of TE elements,
// each the tile's contiguous runs [x | xi] (K1) or [div | xi | dj2 | sM |
// MI] (K3; LIFT).  Every offset is a multiple of 4 words (16 bytes).
template <int NQ, bool LIFT>
struct GradLayout : Tables<NQ> {
  static constexpr int NP = NQ * NQ * NQ;
  int vol, stage, stage_words;
  int x, xi, dj2, sm, mi;
  __host__ __device__ GradLayout(int N, int ND, int F, int L)
      : Tables<NQ>(ND, F, LIFT ? L : 0) {
    vol = this->end;
    stage = vol + TILE_E * 3 * N * NP;
    x = 0;
    xi = x + TILE_E * N * NP;
    dj2 = xi + TILE_E * ND * 3 * NP;
    sm = dj2 + (LIFT ? TILE_E * N * F : 0);
    mi = sm + (LIFT ? TILE_E * F : 0);
    stage_words = (mi + (LIFT ? TILE_E * NP : 0) + 31) / 32 * 32;
  }
  __host__ __device__ size_t bytes() const {
    return 4 * (size_t)(stage + 2 * stage_words);
  }
};

// K1's and K3's operands (NP = NQ^3 nodes an element).
struct GradArgs {
  const float* x;      // [E][N][NP]: K1's x, K3's div
  const float* dj2;    // [E][N][F]   K3
  const float* sm;     // [E][F]      K3
  const float* mi;     // [E][NP]     K3
  const int* lift;     // [NP][L]     K3
  int L;
  const float* xi;     // [E][ND*3][NP]
  const float* lines;  // [ND][NQ][NQ]
  tile::Strides strides;
  const int* sel;      // [F]
  float* vol;          // [E][3][N][NP]
  float* rows;         // [E][N][F]
  int E, F;
};

// Run by every thread after the barrier that completes `src`: the floats
// of a run of n past its 16-byte floor (none when n is a multiple of 4),
// which its bulk store leaves out.
__device__ __forceinline__ void store_tail(float* dst, const float* src,
                                          int n) {
  for (int j = (n & ~3) + threadIdx.x; j < n; j += blockDim.x)
    dst[j] = src[j];
}

// K1 (LIFT false) and K3 (LIFT true).
template <int N, int ND, int NQ, bool LIFT>
__global__ void __launch_bounds__(TILE_THREADS)
ldg_grad_kernel(const GradArgs args) {
  constexpr int NP = NQ * NQ * NQ;
  constexpr int ITEMS = (TILE_E * NP + TILE_THREADS - 1) / TILE_THREADS;
  constexpr int NSEG = LIFT ? 5 : 2;
  const int E = args.E, F = args.F, L = LIFT ? args.L : 0;
  const tile::Strides strides = args.strides;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
  const GradLayout<NQ, LIFT> lay(N, ND, F, L);
  const float* ln = sm + lay.lines;
  const int* info = reinterpret_cast<const int*>(sm + lay.info);
  const int* liftT = reinterpret_cast<const int*>(sm + lay.lift);
  const int* sels = reinterpret_cast<const int*>(sm + lay.sel);
  float* volt = sm + lay.vol;
  const int tid = threadIdx.x;
  const int tiles = (E + TILE_E - 1) / TILE_E;
  tile::Segment seg[NSEG];
  seg[0] = {args.x, N * NP, lay.x};
  seg[1] = {args.xi, ND * 3 * NP, lay.xi};
  if constexpr (LIFT) {
    seg[2] = {args.dj2, N * F, lay.dj2};
    seg[3] = {args.sm, F, lay.sm};
    seg[4] = {args.mi, NP, lay.mi};
  }
  auto stage = [&](int st) { return sm + lay.stage + st * lay.stage_words; };
  auto count = [&](int t) { return min(TILE_E, E - t * TILE_E); };

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
        tile::issue(stage(st), &bar[st], seg, nullptr, t * TILE_E, count(t));
    }
  load_tables<NQ>(sm, lay, ND, args.lines, strides, args.lift, L, args.sel,
                  F);
  __syncthreads();

  for (int it = 0, t = blockIdx.x; t < tiles; ++it, t += gridDim.x) {
    const int st = it & 1;
    float* S = stage(st);
    const int e0 = t * TILE_E, ne = count(t);
    tile::bar_wait(&bar[st], (it >> 1) & 1);
    tile::fill_tail(S, seg, e0, ne);
    // the last tile's vol store has read the vol tile
    if (tid == 0) tile::bulk_wait_read();
    __syncthreads();
    float* xs = S + lay.x;                 // x; K3: div, then lap
    const float* xis = S + lay.xi;

    // K3: pass-2 lift, in place: lap = div + MI * (sM . dj2) LT
    if constexpr (LIFT) {
      const float* djs = S + lay.dj2;
      const float* sms = S + lay.sm;
      const float* mis = S + lay.mi;
      for (int i = tid; i < ne * NP; i += blockDim.x) {
        const int te = i / NP, k = i - te * NP;
        float acc[N];
#pragma unroll
        for (int v = 0; v < N; ++v) acc[v] = 0.0f;
        for (int l = 0; l < L; ++l) {
          const int f = liftT[l * NP + k];
          if (f < 0) continue;
          const float w = sms[te * F + f];
#pragma unroll
          for (int v = 0; v < N; ++v)
            acc[v] = add(acc[v], mul(w, djs[(te * N + v) * F + f]));
        }
        const float mk = mis[te * NP + k];
#pragma unroll
        for (int v = 0; v < N; ++v) {
          float* xp = xs + (te * N + v) * NP + k;
          *xp = add(*xp, mul(mk, acc[v]));
        }
      }
      __syncthreads();
    }

    // face rows: the tile's rows run [te][v][f] = x[te][v][sel[f]]
    {
      float* out = args.rows + (size_t)e0 * N * F;
      for (int i = tid; i < ne * N * F; i += blockDim.x) {
        const int r = i / F, f = i - r * F;    // r = te * N + v
        out[i] = xs[r * NP + sels[f]];
      }
    }

    // the derivatives along the lines and the metric terms:
    //   vol[c][v][m] = sum_a xi[3a+c][m] * sum_j x[v][line_a(j)] V_a[j]
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int i = tid + r * TILE_THREADS;
      if (i >= ne * NP) break;
      const int te = i / NP, m = i - te * NP;
      float d[ND][N];
#pragma unroll
      for (int a = 0; a < ND; ++a) {
        const int inf = info[a * NP + m];
        const float* V = ln + (a * NQ + (inf >> 16)) * NQ;
        float w[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j) w[j] = V[j];
        const float* xl = xs + te * N * NP + (inf & 0xffff);
#pragma unroll
        for (int v = 0; v < N; ++v)
          d[a][v] = along_line<NQ>(xl + v * NP, strides.at(a), w);
      }
      float xv[ND * 3];
#pragma unroll
      for (int j = 0; j < ND * 3; ++j)
        xv[j] = xis[(te * ND * 3 + j) * NP + m];
      float* vo = volt + te * 3 * N * NP + m;
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int v = 0; v < N; ++v) {
          float acc = mul(xv[c], d[0][v]);
#pragma unroll
          for (int a = 1; a < ND; ++a)
            acc = add(acc, mul(xv[a * 3 + c], d[a][v]));
          vo[(c * N + v) * NP] = acc;
        }
    }
    tile::fence_async_proxy();
    __syncthreads();                       // the stage (and vol tile) done
    const int next = t + 2 * gridDim.x;
    if (tid == 0 && next < tiles)
      tile::issue(S, &bar[st], seg, nullptr, next * TILE_E, count(next));
    // the tile's vol run (3 N NP floats an element), the next tile's
    // derivatives write the vol tile after a barrier
    float* vol = args.vol + (size_t)e0 * 3 * N * NP;
    const int nvol = ne * 3 * N * NP;
    if (tid == 0 && nvol >= 4)
      tile::bulk_store(vol, volt, tile::floor16(4u * nvol));
    store_tail(vol, volt, nvol);
  }
  if (tid == 0) tile::bulk_wait();
}

// K2's shared memory at NQ nodes a line, in 4-byte words: the tables;
// then two stages of TE elements, each [vol1 | dj | w3 | mi | nrm | xi] as
// the tile's contiguous runs (every offset a multiple of 4 words: 16-byte
// aligned).
template <int NQ>
struct K2Layout : Tables<NQ> {
  static constexpr int NP = NQ * NQ * NQ;
  int stage, stage_words;
  int vol1, dj, w3, mi, nrm, xi;
  __host__ __device__ K2Layout(int N, int ND, int F, int L)
      : Tables<NQ>(ND, F, L) {
    stage = this->end;
    vol1 = 0;
    dj = vol1 + TILE_E * 3 * N * NP;
    w3 = dj + TILE_E * N * F;
    mi = w3 + TILE_E * 3 * F;
    nrm = mi + TILE_E * NP;
    xi = nrm + TILE_E * 3 * F;
    stage_words = (xi + TILE_E * ND * 3 * NP + 31) / 32 * 32;
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
__global__ void __launch_bounds__(TILE_THREADS)
ldg_grad_to_div_kernel(const K2Args args) {
  constexpr int NP = NQ * NQ * NQ;
  constexpr int ITEMS = (TILE_E * NP + TILE_THREADS - 1) / TILE_THREADS;
  const int E = args.E, F = args.F, L = args.L;
  const tile::Strides strides = args.strides;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
  const K2Layout<NQ> lay(N, ND, F, L);
  const float* ln = sm + lay.lines;
  const int* info = reinterpret_cast<const int*>(sm + lay.info);
  const int* liftT = reinterpret_cast<const int*>(sm + lay.lift);
  const int* sels = reinterpret_cast<const int*>(sm + lay.sel);
  const int tid = threadIdx.x;
  const int tiles = (E + TILE_E - 1) / TILE_E;
  const tile::Segment seg[6] = {
      {args.vol1, 3 * N * NP, lay.vol1}, {args.dj, N * F, lay.dj},
      {args.w3, 3 * F, lay.w3},          {args.mi, NP, lay.mi},
      {args.nrm, 3 * F, lay.nrm},        {args.xi, ND * 3 * NP, lay.xi}};
  auto stage = [&](int st) { return sm + lay.stage + st * lay.stage_words; };
  auto first = [&](int t) { return t * TILE_E; };
  auto count = [&](int t) { return min(TILE_E, E - t * TILE_E); };

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
  load_tables<NQ>(sm, lay, ND, args.lines, strides, args.lift, L, args.sel,
                  F);
  __syncthreads();

  for (int it = 0, t = blockIdx.x; t < tiles; ++it, t += gridDim.x) {
    const int st = it & 1;
    float* S = stage(st);
    const int e0 = first(t), ne = count(t);
    tile::bar_wait(&bar[st], (it >> 1) & 1);
    tile::fill_tail(S, seg, e0, ne);
    __syncthreads();
    float* g = S + lay.vol1;              // vol1, then the gradient
    const float* nrms = S + lay.nrm;
    const float* xis = S + lay.xi;

    // 1. pass-1 lift, in place: grad = vol1 + MI * (w3 (x) dj) LT
    lift_w3<N, NP>(g, S + lay.dj, S + lay.w3, S + lay.mi, liftT, L, F, ne);
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
      const int i = tid + r * TILE_THREADS;
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
          for (int v = 0; v < N; ++v)
            acc[v] = add(acc[v], mul(x, along_line<NQ>(gl + v * NP, sa, w)));
        }
      }
#pragma unroll
      for (int v = 0; v < N; ++v) dv[r][v] = acc[v];
    }
    __syncthreads();                       // w3, mi, nrm are dead now

    float* dvo = S + lay.w3;               // [te][N][NP] over w3 | mi | nrm
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int i = tid + r * TILE_THREADS;
      if (i >= ne * NP) break;
      const int te = i / NP, m = i - te * NP;
#pragma unroll
      for (int v = 0; v < N; ++v) dvo[(te * N + v) * NP + m] = dv[r][v];
    }
    __syncthreads();

    // 4. the tile's div and s runs, 16 bytes a thread (the last <= 3
    //    floats of a run that is no multiple of 4 one a thread)
    {
      float* s_out = args.s + (size_t)e0 * N * F;
      float* div_out = args.div + (size_t)e0 * N * NP;
      float4* out = reinterpret_cast<float4*>(s_out);
      const float4* in = reinterpret_cast<const float4*>(so);
      for (int i = tid; i < ne * N * F / 4; i += blockDim.x) out[i] = in[i];
      store_tail(s_out, so, ne * N * F);
      out = reinterpret_cast<float4*>(div_out);
      in = reinterpret_cast<const float4*>(dvo);
      for (int i = tid; i < ne * N * NP / 4; i += blockDim.x) out[i] = in[i];
      store_tail(div_out, dvo, ne * N * NP);
    }
    tile::fence_async_proxy();
    __syncthreads();                       // the stage is free
    const int next = t + 2 * gridDim.x;
    if (tid == 0 && next < tiles)
      tile::issue(S, &bar[st], seg, nullptr, first(next), count(next));
  }
}

// K4's shared memory at NQ nodes a line, in 4-byte words: the lift table
// (Tables with no line tables and no sel); then two stages of TE elements,
// each [vol3 | dj3 | w3 | mi] as the tile's contiguous runs (every offset
// a multiple of 4 words: 16-byte aligned).  vol3's run, lifted in place,
// is the tile's out run.
template <int NQ>
struct LastLayout : Tables<NQ> {
  static constexpr int NP = NQ * NQ * NQ;
  int stage, stage_words;
  int vol3, dj3, w3, mi;
  __host__ __device__ LastLayout(int N, int F, int L) : Tables<NQ>(0, 0, L) {
    stage = this->end;
    vol3 = 0;
    dj3 = vol3 + TILE_E * 3 * N * NP;
    w3 = dj3 + TILE_E * N * F;
    mi = w3 + TILE_E * 3 * F;
    stage_words = (mi + TILE_E * NP + 31) / 32 * 32;
  }
  __host__ __device__ size_t bytes() const {
    return 4 * (size_t)(stage + 2 * stage_words);
  }
};

// K4's operands (NP = NQ^3 nodes an element).
struct LastArgs {
  const float* vol3;   // [E][3][N][NP]
  const float* dj3;    // [E][N][F]
  const float* w3;     // [E][3][F]
  const float* mi;     // [E][NP]
  const int* lift;     // [NP][L]
  int L;
  float* out;          // [E][3][N][NP]
  int E, F;
};

// K4: out = vol3 + MI * (w3 (x) dj3) LT, K2's lift alone on staged tiles.
template <int N, int NQ>
__global__ void __launch_bounds__(TILE_THREADS)
ldg_last_kernel(const LastArgs args) {
  constexpr int NP = NQ * NQ * NQ;
  const int E = args.E, F = args.F, L = args.L;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
  const LastLayout<NQ> lay(N, F, L);
  const int* liftT = reinterpret_cast<const int*>(sm + lay.lift);
  const int tid = threadIdx.x;
  const int tiles = (E + TILE_E - 1) / TILE_E;
  const tile::Segment seg[4] = {
      {args.vol3, 3 * N * NP, lay.vol3}, {args.dj3, N * F, lay.dj3},
      {args.w3, 3 * F, lay.w3},          {args.mi, NP, lay.mi}};
  auto stage = [&](int st) { return sm + lay.stage + st * lay.stage_words; };
  auto count = [&](int t) { return min(TILE_E, E - t * TILE_E); };

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
        tile::issue(stage(st), &bar[st], seg, nullptr, t * TILE_E, count(t));
    }
  load_tables<NQ>(sm, lay, 0, nullptr, tile::Strides{{0, 0, 0}}, args.lift,
                  L, nullptr, 0);
  __syncthreads();

  for (int it = 0, t = blockIdx.x; t < tiles; ++it, t += gridDim.x) {
    const int st = it & 1;
    float* S = stage(st);
    const int e0 = t * TILE_E, ne = count(t);
    tile::bar_wait(&bar[st], (it >> 1) & 1);
    tile::fill_tail(S, seg, e0, ne);
    __syncthreads();
    lift_w3<N, NP>(S + lay.vol3, S + lay.dj3, S + lay.w3, S + lay.mi, liftT,
                   L, F, ne);
    tile::fence_async_proxy();
    __syncthreads();                       // the tile's out run is done
    // the out run (3 N NP floats an element); a run that is no multiple of
    // 4 floats is the last, partial tile's, whose stage is not refilled
    float* out = args.out + (size_t)e0 * 3 * N * NP;
    const int nout = ne * 3 * N * NP;
    store_tail(out, S + lay.vol3, nout);
    if (tid == 0) {
      if (nout >= 4)
        tile::bulk_store(out, S + lay.vol3, tile::floor16(4u * nout));
      const int next = t + 2 * gridDim.x;
      if (next < tiles) {
        tile::bulk_wait_read();            // the store has read the stage
        tile::issue(S, &bar[st], seg, nullptr, next * TILE_E, count(next));
      }
    }
  }
  if (tid == 0) tile::bulk_wait();
}

// One persistent block of `kernel` (TILE_THREADS threads, `smem` bytes of
// dynamic shared memory) for each that fits on the SMs, at most one a
// tile; `cache` is the kernel's own (tile::persistent_grid).
template <typename Kernel, typename Args>
int launch_tiles(Kernel kernel, size_t smem, int2* cache, const Args& args,
                 cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = tile::persistent_grid(kernel, TILE_THREADS, smem,
                                          (args.E + TILE_E - 1) / TILE_E,
                                          cache, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, TILE_THREADS, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

// K1 (LIFT false) or K3 with N rows at NQ nodes a line.
template <int N, int NQ, bool LIFT>
int launch_grad(const GradArgs& args, cudaStream_t stream) {
  static int2 cache[16];
  return launch_tiles(ldg_grad_kernel<N, 2, NQ, LIFT>,
                      GradLayout<NQ, LIFT>(N, 2, args.F, args.L).bytes(),
                      cache, args, stream);
}

// K2 with N rows at NQ nodes a line (N = 4: two blocks a SM at p4, one at
// p5; N = 5: one).
template <int N, int NQ>
int launch_grad_to_div(const K2Args& args, cudaStream_t stream) {
  const K2Layout<NQ> lay(N, 2, args.F, args.L);
  // div is staged over the dead runs w3 | mi | nrm (F = 4 NQ^2 faces
  // nodes: room up to NQ = 6 at N = 5, 8 at N = 4)
  if (lay.xi - lay.w3 < TILE_E * N * K2Layout<NQ>::NP)
    return (int)cudaErrorInvalidValue;
  static int2 cache[16];
  return launch_tiles(ldg_grad_to_div_kernel<N, 2, NQ>, lay.bytes(), cache,
                      args, stream);
}

// K4 with N rows at NQ nodes a line (N = 4: 73.75 KiB a block at p4, three
// fit in an SM's 228 KB; one at p5).
template <int N, int NQ>
int launch_last(const LastArgs& args, cudaStream_t stream) {
  static int2 cache[16];
  return launch_tiles(ldg_last_kernel<N, NQ>,
                      LastLayout<NQ>(N, args.F, args.L).bytes(), cache, args,
                      stream);
}

// The rows the kernels are built for: calls f(std::integral_constant<int,
// N>) for N = 4 or 5 and returns its result; any other N gives
// cudaErrorInvalidValue.
template <typename F>
int by_rows(int N, F&& f) {
  switch (N) {
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
  }
  return (int)cudaErrorInvalidValue;
}

// What every kernel needs: 16-byte aligned runs.
int check_runs(std::initializer_list<const void*> runs) {
  for (const void* ptr : runs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16)
      return (int)cudaErrorMisalignedAddress;
  return (int)cudaSuccess;
}

// What K1-K3 share: ND = 2 directions, line strides within an element,
// and 16-byte aligned runs (by_rows checks N).
int check_lines(int E, int ND, int Np, int F, int stride0, int stride1,
                std::initializer_list<const void*> runs) {
  if (E <= 0 || F <= 0 || ND != 2 || stride0 <= 0 ||
      stride1 <= 0 || stride0 > Np || stride1 > Np)
    return (int)cudaErrorInvalidValue;
  return check_runs(runs);
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns the CUDA error of
// the launch (0 on success).  N is the number of rows (chain variables),
// ND the number of reference directions; N = 4 or 5 and ND = 2 are
// built.
// Every kernel takes Np = NQ^3 with NQ = 2..6 (tile::by_order) and 16-byte
// aligned runs; K1-K3 take Wd as its line table (lines [ND][NQ][NQ], the
// node strides of the two directions' lines; dg/line_ops.py).

int ldg_first_f32(const void* x, const void* xi, const void* lines,
                  int stride0, int stride1, const void* sel, void* vol,
                  void* rows, int E, int N, int ND, int Np, int F,
                  void* stream) {
  int err = check_lines(E, ND, Np, F, stride0, stride1, {x, xi, vol});
  if (err) return err;
  const GradArgs args{
      static_cast<const float*>(x), nullptr, nullptr, nullptr, nullptr, 0,
      static_cast<const float*>(xi), static_cast<const float*>(lines),
      tile::Strides{{stride0, stride1, 0}}, static_cast<const int*>(sel),
      static_cast<float*>(vol), static_cast<float*>(rows), E, F};
  return by_rows(N, [&](auto n) {
    return tile::by_order(Np, [&](auto nq) {
      return launch_grad<decltype(n)::value, decltype(nq)::value, false>(
          args, static_cast<cudaStream_t>(stream));
    });
  });
}

int ldg_grad_to_div_f32(const void* vol1, const void* dj, const void* w3,
                        const void* nrm, const void* mi, const void* lift,
                        int L, const void* xi, const void* lines,
                        int stride0, int stride1, const void* sel, void* div,
                        void* s, int E, int N, int ND, int Np, int F,
                        void* stream) {
  if (L <= 0) return (int)cudaErrorInvalidValue;
  int err = check_lines(E, ND, Np, F, stride0, stride1,
                        {vol1, dj, w3, nrm, mi, xi, div, s});
  if (err) return err;
  const K2Args args{
      static_cast<const float*>(vol1), static_cast<const float*>(dj),
      static_cast<const float*>(w3), static_cast<const float*>(nrm),
      static_cast<const float*>(mi), static_cast<const int*>(lift), L,
      static_cast<const float*>(xi), static_cast<const float*>(lines),
      tile::Strides{{stride0, stride1, 0}}, static_cast<const int*>(sel),
      static_cast<float*>(div), static_cast<float*>(s), E, F};
  return by_rows(N, [&](auto n) {
    return tile::by_order(Np, [&](auto nq) {
      return launch_grad_to_div<decltype(n)::value, decltype(nq)::value>(
          args, static_cast<cudaStream_t>(stream));
    });
  });
}

int ldg_div_to_grad_f32(const void* div, const void* dj2, const void* sm,
                        const void* mi, const void* lift, int L,
                        const void* xi, const void* lines, int stride0,
                        int stride1, const void* sel, void* vol, void* rows,
                        int E, int N, int ND, int Np, int F, void* stream) {
  if (L <= 0) return (int)cudaErrorInvalidValue;
  int err = check_lines(E, ND, Np, F, stride0, stride1,
                        {div, dj2, sm, mi, xi, vol});
  if (err) return err;
  const GradArgs args{
      static_cast<const float*>(div), static_cast<const float*>(dj2),
      static_cast<const float*>(sm), static_cast<const float*>(mi),
      static_cast<const int*>(lift), L, static_cast<const float*>(xi),
      static_cast<const float*>(lines), tile::Strides{{stride0, stride1, 0}},
      static_cast<const int*>(sel), static_cast<float*>(vol),
      static_cast<float*>(rows), E, F};
  return by_rows(N, [&](auto n) {
    return tile::by_order(Np, [&](auto nq) {
      return launch_grad<decltype(n)::value, decltype(nq)::value, true>(
          args, static_cast<cudaStream_t>(stream));
    });
  });
}

int ldg_last_f32(const void* vol3, const void* dj3, const void* w3,
                 const void* mi, const void* lift, int L, void* out, int E,
                 int N, int Np, int F, void* stream) {
  if (E <= 0 || F <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const int err = check_runs({vol3, dj3, w3, mi, out});
  if (err) return err;
  const LastArgs args{
      static_cast<const float*>(vol3), static_cast<const float*>(dj3),
      static_cast<const float*>(w3), static_cast<const float*>(mi),
      static_cast<const int*>(lift), L, static_cast<float*>(out), E, F};
  return by_rows(N, [&](auto n) {
    return tile::by_order(Np, [&](auto nq) {
      return launch_last<decltype(n)::value, decltype(nq)::value>(
          args, static_cast<cudaStream_t>(stream));
    });
  });
}

const char* ldg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
