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
// At the IMEX step's shapes (E = 12288, NVARS = 5, Np = 125, JI = 25,
// float32) each launch reads 30.72 MB and writes 30.72 MB: 0.0183 ms at
// the H100's 3.35 TB/s.
//
// Design, the simple one: one thread per output element, the output index
// fastest across a warp, so every store of a warp is one coalesced run;
// the JI axis (25 floats, 100 B) is contiguous on both sides, so the loads
// of a warp come in runs of 100 B.  Grid-stride loop.  The index
// arithmetic runs in 32 bits when the state has fewer than 2^31 elements
// and in 64 bits otherwise.  No shared memory: staging an (eh, ji) tile
// through it, or wider vector loads, is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

// One output element per thread step: the output index o is split into
// its coordinates and the input index rebuilt from them.
template <typename Index, bool TO_BLOCKS>
__global__ void __launch_bounds__(THREADS)
permute_kernel(const float* __restrict__ src, float* __restrict__ dst,
               Index Eh, Index NV, Index NVARS, Index NQ3, Index JI,
               Index total) {
  const Index stride = (Index)gridDim.x * THREADS;
  for (Index o = (Index)blockIdx.x * THREADS + threadIdx.x; o < total;
       o += stride) {
    Index r = o / JI;
    const Index ji = o - r * JI;
    Index in;
    if (TO_BLOCKS) {
      // o = (((ev*NQ3 + k)*NVARS + v)*Eh + eh)*JI + ji
      const Index eh = r % Eh;
      r /= Eh;
      const Index v = r % NVARS;
      r /= NVARS;
      const Index k = r % NQ3;
      const Index ev = r / NQ3;
      in = (((eh * NV + ev) * NVARS + v) * NQ3 + k) * JI + ji;
    } else {
      // o = (((eh*NV + ev)*NVARS + v)*NQ3 + k)*JI + ji
      const Index k = r % NQ3;
      r /= NQ3;
      const Index v = r % NVARS;
      r /= NVARS;
      const Index ev = r % NV;
      const Index eh = r / NV;
      in = (((ev * NQ3 + k) * NVARS + v) * Eh + eh) * JI + ji;
    }
    dst[o] = __ldg(src + in);
  }
}

template <bool TO_BLOCKS>
int launch(const void* src, void* dst, int Eh, int NV, int NVARS, int NQ3,
           int JI, void* stream) {
  if (Eh <= 0 || NV <= 0 || NVARS <= 0 || NQ3 <= 0 || JI <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)Eh * NV * NVARS * NQ3 * JI;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  // enough blocks for every element up to 32 resident blocks per SM;
  // the grid-stride loop covers the rest
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)sms * 32;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  const float* s = static_cast<const float*>(src);
  float* d = static_cast<float*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (total < ((int64_t)1 << 31)) {
    permute_kernel<uint32_t, TO_BLOCKS><<<blocks, THREADS, 0, st>>>(
        s, d, Eh, NV, NVARS, NQ3, JI, (uint32_t)total);
  } else {
    permute_kernel<int64_t, TO_BLOCKS><<<blocks, THREADS, 0, st>>>(
        s, d, Eh, NV, NVARS, NQ3, JI, total);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns the CUDA error of
// the launch (0 on success).  float32 only.

int to_blocks_f32(const void* x, void* y, int Eh, int NV, int NVARS, int NQ3,
                  int JI, void* stream) {
  return launch<true>(x, y, Eh, NV, NVARS, NQ3, JI, stream);
}

int from_blocks_f32(const void* y, void* x, int Eh, int NV, int NVARS,
                    int NQ3, int JI, void* stream) {
  return launch<false>(y, x, Eh, NV, NVARS, NQ3, JI, stream);
}

const char* column_layout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
