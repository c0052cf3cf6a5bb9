// Hand-written Hopper SpMM: y = A @ x for a CSR sparse A and a dense f32 x.
//
// Replaces the Pallas TPU kernel foodrec_tpu/ops/spmm.py::_spmm_pallas_kernel
// (launched by _spmm_pallas_call, spmm.py:159-202). That kernel cuts the
// row-sorted edges into 512-edge blocks inside 128-row panels and adds a
// weighted one-hot [512, 128] selection matrix times the pre-gathered edge
// activations x[cols] into each panel, so the TPU's matrix unit does the
// segmented sum; XLA materialises the [nnz, d] edge buffer first. Hopper has
// no reason for that detour: this kernel reads the CSR row pointer and gathers
// x[col] rows itself, so no [nnz, d] buffer and no one-hot exist.
//
// Design: one warp per output row. The 32 lanes load 32 (col, val) pairs of
// the row at a time and broadcast them with __shfl_sync; for each pair every
// lane reads its float2 of x[col] (a coalesced 256-byte row read at d = 64)
// and accumulates in f32 registers with fmaf, in edge order. Widths other than
// 64 loop over 64-wide column tiles with a mask (d must be even). Each output
// row is written once, empty rows get zeros, and there are no atomics, so the
// result is bitwise deterministic from run to run.
//
// The same kernel is the backward, as the Pallas kernel is under the JAX
// package's custom VJP (spmm.py:255-276): d/dx (A @ x) = A^T @ g, launched on
// A^T's CSR tables by the autograd Function SpmmCSR (ops/spmm.py). Both CIKM
// graphs are symmetric, so there A^T is A and the backward reads A's tables.
//
// Bound: bytes. The compulsory traffic is nnz*8 (cols + vals) + (n+1)*4
// (row_ptr) + n*d*4 (x, read once: at Foodcom scale x is <= 9.6 MB and sits
// in the 50 MB L2) + n*d*4 (y) -- about 22.4 MB for the user-item graph
// (n 37,539, nnz 380,674) and 19.7 MB for the recipe-ingredient graph
// (n 34,906, nnz 209,036), 6.7 us and 5.9 us at 3.35 TB/s. The 2*nnz*d
// flops are a tenth of that time at the f32 rate.
//
// First thing for a later performance change: a warp per row serialises a
// hub row. The synthetic catalog's max degree is 42, but the real Foodcom and
// Allrecipes graphs are power-law, where one row can hold thousands of edges
// while its neighbours hold a handful; split long rows across warps (with a
// second reduction pass) or balance edges per warp (merge-path).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 2 * kWarp;  // columns per pass: one float2 per lane

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spmm_csr_warp_per_row(const int32_t* __restrict__ row_ptr,
                      const int32_t* __restrict__ cols,
                      const float* __restrict__ vals,
                      const float* __restrict__ x,
                      float* __restrict__ y,
                      int64_t n_rows, int64_t d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock
                      + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n_rows) return;  // the whole warp leaves together
  const int32_t start = row_ptr[row];
  const int32_t end = row_ptr[row + 1];

  for (int64_t c0 = 0; c0 < d; c0 += kTile) {
    const int64_t col = c0 + 2 * lane;
    const bool active = col < d;  // d even: col + 1 < d as well
    float2 acc = make_float2(0.f, 0.f);
    for (int32_t e0 = start; e0 < end; e0 += kWarp) {
      const int32_t e = e0 + lane;
      int32_t my_col = 0;
      float my_val = 0.f;
      if (e < end) {
        my_col = __ldg(cols + e);
        my_val = __ldg(vals + e);
      }
      const int n = min(kWarp, end - e0);  // uniform across the warp
      for (int j = 0; j < n; ++j) {
        const int32_t c = __shfl_sync(0xffffffffu, my_col, j);
        const float v = __shfl_sync(0xffffffffu, my_val, j);
        if (active) {
          const float2 xv = __ldg(reinterpret_cast<const float2*>(
              x + static_cast<int64_t>(c) * d + col));
          acc.x = fmaf(v, xv.x, acc.x);
          acc.y = fmaf(v, xv.y, acc.y);
        }
      }
    }
    if (active) {
      *reinterpret_cast<float2*>(y + row * d + col) = acc;
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller has checked shapes, dtypes, contiguity, 8-byte alignment of x and
// y, an even d, nnz < 2^31 and n_rows > 0.
extern "C" int spmm_csr_f32(const void* row_ptr, const void* cols,
                            const void* vals, const void* x, void* y,
                            long long n_rows, long long d, void* stream) {
  const long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmm_csr_warp_per_row<<<static_cast<unsigned int>(blocks),
                          kWarp * kWarpsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(cols),
      static_cast<const float*>(vals), static_cast<const float*>(x),
      static_cast<float*>(y), n_rows, d);
  return static_cast<int>(cudaGetLastError());
}
