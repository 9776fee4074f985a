// Var-major grid state <-> column blocks for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of
// climatemachine_tpu/solvers/pallas_layout.py: to_blocks_vm (body
// _k_to_blocks) and from_blocks_vm (body _k_from_blocks).  With
// layout dims (Eh, NV, NVARS, NQ3, JI):
//
//   to_blocks    y[ev][k][v][eh][ji] = x[eh][ev][v][k][ji]
//   from_blocks  x[eh][ev][v][k][ji] = y[ev][k][v][eh][ji]
//
// x is the var-major state [E = Eh*NV, NVARS, Np = NQ3*JI] of a stacked
// grid, y the columnwise solver's block layout [NV, NQ3*NVARS, Eh*JI].
// climatemachine_tpu_torch/solvers/layout_kernel.py holds the wrappers
// and the plain PyTorch versions.
//
// What bounds them: a permutation does no arithmetic, so bytes alone.
// At the dry IMEX step's shapes (E = 12288, NVARS = 5, Np = 125, JI =
// 25, float32) each launch reads 30.72 MB and writes 30.72 MB: 0.0183 ms
// at the H100's 3.35 TB/s; at the moist step's (NVARS = 6) 36.86 MB each
// way, 0.0220 ms.
//
// Design: one block per (ev, tile of T consecutive eh), as the Pallas
// kernels' grid (nv, Eh / B).  The tile passes through shared memory,
// kept in y's row order: row k*NVARS + v holds the tile's T*JI floats of
// y row (ev, k, v), rows T*JI floats apart.
// - x side: the tile is T chunks of NVARS*NQ3*JI contiguous floats (2.5
//   KB at the bench shape), NV chunks apart.  Consecutive threads take
//   consecutive floats of a chunk; each thread splits its chunk offset
//   into (v, k, ji) once and walks the chunks with additions, eight
//   chunks' loads in flight before their stores.  Scalar accesses: a
//   chunk starts 4-byte aligned in general.
// - y side: NQ3*NVARS row segments of T*JI contiguous floats.  When
//   every segment starts 16-byte aligned (T*JI and Eh*JI multiples of 4,
//   y 16-byte aligned: T = 8 at JI = 25), 16-byte accesses, scalar
//   otherwise.  Rows are contiguous in shared memory, so 16-byte shared
//   accesses are free of bank conflicts.
// - to_blocks loads x through registers; from_blocks loads y global ->
//   shared with cp.async, every copy of the tile in flight at once.
//   Several blocks share an SM (20 KB of shared memory a block at the
//   bench shape), so one block's stores overlap another's loads.
// - T = 8 and 256 threads a block for to_blocks, 512 for from_blocks:
//   the fastest of the tiles 4-32 and 128-512 threads measured at the
//   bench shape (PERF.md; climatemachine_tpu_torch/bench_layout.py
//   rebuilds this source with other constants and times the variants).
//   A shape whose tile of 8 eh overflows the static 48 KB of shared
//   memory takes the largest power-of-two tile that fits; a shape whose
//   single chunk does not fit is refused.
// - The dims (NVARS, NQ3, JI) and T are template constants for the three
//   shapes the port runs on the card, (5, 5, 25) dry, (6, 5, 25) moist
//   and (9, 5, 25) moist with warm rain and two tracers, with T = 8, so
//   the splits are multiply-shift sequences; any other shape takes the
//   same kernel with runtime dims, and the *_runtime_f32 entries take it
//   at every shape (to hold both branches at one shape).  The grid
//   NV * ceil(Eh / T) is a function of the dims alone: no device query.
//   The offsets inside a tile run in 32 bits when the state has fewer
//   than 2^31 elements, in 64 otherwise; block bases in 64.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 8;
constexpr int TO_BLOCKS_THREADS = 256;
constexpr int FROM_BLOCKS_THREADS = 512;
constexpr int MAX_THREADS = 512;
constexpr size_t STATIC_SMEM = 48 * 1024;

// The layout dims inside a tile; a template value of 0 takes the runtime
// one.
template <int CV, int CK, int CJ, int CT>
struct Dims {
  int nvars_, nq3_, ji_, tile_;
  __device__ __forceinline__ int nvars() const { return CV ? CV : nvars_; }
  __device__ __forceinline__ int nq3() const { return CK ? CK : nq3_; }
  __device__ __forceinline__ int ji() const { return CJ ? CJ : ji_; }
  __device__ __forceinline__ int tile() const { return CT ? CT : tile_; }
};

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The x side of a tile: for every float of the nt <= T chunks, chunk t at
// x offset t*xstep, v = read(tile float, x offset) then write(tile float,
// x offset, v), eight chunks' reads before their writes.  Float c = (v*NQ3
// + k)*JI + ji of a chunk sits in the tile at row k*NVARS + v, column
// t*JI + ji.  The reads past the tail repeat chunk nt - 1 instead of being
// skipped: guarded, the compiler pairs each load with its store when the
// dims are runtime values, and the eight loads no longer overlap.
template <typename Index, typename D, typename Read, typename Write>
__device__ __forceinline__ void for_x(float* tile, const D& d, int nt,
                                      Index xstep, Read read, Write write) {
  constexpr int B = 8;
  const int nvars = d.nvars(), ji = d.ji(), T = d.tile();
  const int kj = d.nq3() * ji, ch = nvars * kj, rs = T * ji;
  for (int c = threadIdx.x; c < ch; c += blockDim.x) {
    const int v = c / kj, r = c - v * kj, k = r / ji, j = r - k * ji;
    float* s = tile + (k * nvars + v) * rs + j;
    for (int t0 = 0; t0 < nt; t0 += B) {
      float val[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int t = min(t0 + b, nt - 1);
        val[b] = read(s + t * ji, c + (Index)t * xstep);
      }
#pragma unroll
      for (int b = 0; b < B; ++b)
        if (t0 + b < nt)
          write(s + (t0 + b) * ji, c + (Index)(t0 + b) * xstep, val[b]);
    }
  }
}

// The y side of a tile: op(tile address, y offset) for each of the W
// floats of every row segment, row r of `seg` floats at y offset r*ystep
// and tile offset r*T*JI.  W = 4 needs seg, ystep and y 16-byte aligned.
template <int W, typename Index, typename D, typename Op>
__device__ __forceinline__ void for_y(float* tile, const D& d, int seg,
                                      Index ystep, Op op) {
  const int rs = d.tile() * d.ji(), per_row = seg / W;
  const int n = d.nq3() * d.nvars() * per_row;
  for (int f = threadIdx.x; f < n; f += blockDim.x) {
    const int r = f / per_row, q = (f - r * per_row) * W;
    op(tile + r * rs + q, (Index)r * ystep + q);
  }
}

// for_y with the segment length a compile-time constant in full tiles
template <int W, typename Index, typename D, typename Op>
__device__ __forceinline__ void for_y_tile(float* tile, const D& d, int nt,
                                           Index ystep, Op op) {
  if (nt == d.tile())
    for_y<W, Index>(tile, d, d.tile() * d.ji(), ystep, op);
  else
    for_y<W, Index>(tile, d, nt * d.ji(), ystep, op);
}

template <int CV, int CK, int CJ, int CT, bool TO_BLOCKS, bool VEC,
          typename Index>
__global__ void __launch_bounds__(MAX_THREADS)
layout_kernel(const float* __restrict__ src, float* __restrict__ dst,
              int Eh, int NV, Dims<CV, CK, CJ, CT> d) {
  extern __shared__ __align__(16) float buf[];
  const int T = d.tile(), ji = d.ji();
  const int nr = d.nq3() * d.nvars(), ch = nr * ji;
  const int ev = blockIdx.x % NV;
  const int eh0 = (blockIdx.x / NV) * T;
  const int nt = min(T, Eh - eh0);
  const int64_t xoff = ((int64_t)eh0 * NV + ev) * ch;
  const int64_t yoff = ((int64_t)ev * nr * Eh + eh0) * ji;
  const Index xstep = (Index)NV * ch, ystep = (Index)Eh * ji;
  constexpr int W = VEC ? 4 : 1;
  if constexpr (TO_BLOCKS) {
    const float* x = src + xoff;
    float* y = dst + yoff;
    for_x(buf, d, nt, xstep, [&](float*, Index g) { return __ldg(x + g); },
          [&](float* s, Index, float v) { *s = v; });
    __syncthreads();
    for_y_tile<W>(buf, d, nt, ystep, [&](float* s, Index g) {
      if constexpr (VEC)
        *reinterpret_cast<float4*>(y + g) = *reinterpret_cast<float4*>(s);
      else
        y[g] = *s;
    });
  } else {
    const float* y = src + yoff;
    float* x = dst + xoff;
    for_y_tile<W>(buf, d, nt, ystep, [&](float* s, Index g) {
      if constexpr (VEC)
        cp_async16(s, y + g);
      else
        cp_async4(s, y + g);
    });
    cp_async_wait_all();
    __syncthreads();
    for_x(buf, d, nt, xstep, [&](float* s, Index) { return *s; },
          [&](float*, Index g, float v) { x[g] = v; });
  }
}

template <int CV, int CK, int CJ, int CT, bool TO_BLOCKS, bool VEC,
          typename Index>
cudaError_t launch_one(const float* src, float* dst, int Eh, int NV,
                       Dims<CV, CK, CJ, CT> d, unsigned blocks, size_t smem,
                       cudaStream_t stream) {
  constexpr int threads = TO_BLOCKS ? TO_BLOCKS_THREADS : FROM_BLOCKS_THREADS;
  static_assert(threads % 32 == 0 && threads <= MAX_THREADS, "threads");
  layout_kernel<CV, CK, CJ, CT, TO_BLOCKS, VEC, Index>
      <<<blocks, threads, smem, stream>>>(src, dst, Eh, NV, d);
  return cudaGetLastError();
}

template <int CV, int CK, int CJ, int CT, bool TO_BLOCKS>
cudaError_t launch_dims(const float* src, float* dst, int Eh, int NV,
                        Dims<CV, CK, CJ, CT> d, unsigned blocks, size_t smem,
                        bool vec, bool wide, cudaStream_t stream) {
#define COLUMN_LAYOUT_GO(V, I)                                              \
  return launch_one<CV, CK, CJ, CT, TO_BLOCKS, V, I>(src, dst, Eh, NV, d, \
                                                     blocks, smem, stream)
  if (wide) {
    if (vec) COLUMN_LAYOUT_GO(true, int64_t);
    COLUMN_LAYOUT_GO(false, int64_t);
  }
  if (vec) COLUMN_LAYOUT_GO(true, uint32_t);
  COLUMN_LAYOUT_GO(false, uint32_t);
#undef COLUMN_LAYOUT_GO
}

// The largest power-of-two tile of at most TILE whose shared memory fits
// under the static 48 KB; 0 if a single chunk does not fit.
int tile_for(int NVARS, int NQ3, int JI) {
  const size_t chunk = (size_t)NVARS * NQ3 * JI * sizeof(float);
  for (int t = TILE; t >= 1; t /= 2)
    if (t * chunk <= STATIC_SMEM) return t;
  return 0;
}

// runtime_dims: take the runtime-dims kernel whatever the shape.
template <bool TO_BLOCKS>
int launch(const void* src, void* dst, int Eh, int NV, int NVARS, int NQ3,
           int JI, void* stream, bool runtime_dims) {
  if (Eh <= 0 || NV <= 0 || NVARS <= 0 || NQ3 <= 0 || JI <= 0 ||
      (int64_t)NVARS * NQ3 * JI > INT32_MAX / 2)
    return (int)cudaErrorInvalidValue;
  const int tile = tile_for(NVARS, NQ3, JI);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = ((int64_t)Eh + tile - 1) / tile * NV;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NVARS * NQ3 * JI * tile * sizeof(float);
  const int64_t total = (int64_t)Eh * NV * NVARS * NQ3 * JI;
  const void* y = TO_BLOCKS ? dst : src;
  const bool use_vec = (int64_t)tile * JI % 4 == 0 &&
                       (int64_t)Eh * JI % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const bool wide = total >= ((int64_t)1 << 31);
  const float* s = static_cast<const float*>(src);
  float* d = static_cast<float*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!runtime_dims) {
    if (NVARS == 5 && NQ3 == 5 && JI == 25 && tile == TILE)
      return (int)launch_dims<5, 5, 25, TILE, TO_BLOCKS>(
          s, d, Eh, NV, Dims<5, 5, 25, TILE>{5, 5, 25, TILE},
          (unsigned)blocks, smem, use_vec, wide, st);
    if (NVARS == 6 && NQ3 == 5 && JI == 25 && tile == TILE)
      return (int)launch_dims<6, 5, 25, TILE, TO_BLOCKS>(
          s, d, Eh, NV, Dims<6, 5, 25, TILE>{6, 5, 25, TILE},
          (unsigned)blocks, smem, use_vec, wide, st);
    if (NVARS == 9 && NQ3 == 5 && JI == 25 && tile == TILE)
      return (int)launch_dims<9, 5, 25, TILE, TO_BLOCKS>(
          s, d, Eh, NV, Dims<9, 5, 25, TILE>{9, 5, 25, TILE},
          (unsigned)blocks, smem, use_vec, wide, st);
  }
  return (int)launch_dims<0, 0, 0, 0, TO_BLOCKS>(
      s, d, Eh, NV, Dims<0, 0, 0, 0>{NVARS, NQ3, JI, tile}, (unsigned)blocks,
      smem, use_vec, wide, st);
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns the CUDA error of
// the launch (0 on success).  float32 only.

int to_blocks_f32(const void* x, void* y, int Eh, int NV, int NVARS, int NQ3,
                  int JI, void* stream) {
  return launch<true>(x, y, Eh, NV, NVARS, NQ3, JI, stream, false);
}

int from_blocks_f32(const void* y, void* x, int Eh, int NV, int NVARS,
                    int NQ3, int JI, void* stream) {
  return launch<false>(y, x, Eh, NV, NVARS, NQ3, JI, stream, false);
}

// The same with the runtime-dims kernel at every shape.
int to_blocks_runtime_f32(const void* x, void* y, int Eh, int NV, int NVARS,
                          int NQ3, int JI, void* stream) {
  return launch<true>(x, y, Eh, NV, NVARS, NQ3, JI, stream, true);
}

int from_blocks_runtime_f32(const void* y, void* x, int Eh, int NV,
                            int NVARS, int NQ3, int JI, void* stream) {
  return launch<false>(y, x, Eh, NV, NVARS, NQ3, JI, stream, true);
}

const char* column_layout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
