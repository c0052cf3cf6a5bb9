// Hand-written Hopper SpMM: y = A @ x for a CSR sparse A and a dense f32 x.
//
// Replaces the Pallas TPU kernel foodrec_tpu/ops/spmm.py::_spmm_pallas_kernel
// (launched by _spmm_pallas_call, spmm.py:159-202). That kernel cuts the
// row-sorted edges into 512-edge blocks inside 128-row panels and adds a
// weighted one-hot [512, 128] selection matrix times the pre-gathered edge
// activations x[cols] into each panel, so the TPU's matrix unit does the
// segmented sum; XLA materialises the [nnz, d] edge buffer first, and
// `_panelize` (spmm.py:97-126) lays a flat grid over the occupied blocks so
// that the hub rows of power-law graphs cost no idle steps. Hopper has no
// reason for the one-hot detour: this kernel gathers x[col] rows itself, so
// no [nnz, d] buffer and no one-hot exist. What it keeps of the Pallas design
// is the flat, edge-balanced grid.
//
// The same kernel is the backward, as the Pallas kernel is under the JAX
// package's custom VJP (spmm.py:255-276): d/dx (A @ x) = A^T @ g, launched on
// A^T's CSR tables by the autograd Function SpmmCSR (ops/spmm.py). Both CIKM
// graphs are symmetric, so there A^T is A and the backward reads A's tables.
//
// Bound: bytes. The compulsory traffic is nnz*8 (cols + vals) + (n+1)*4
// (row_ptr) + n*d*4 (x, read once) + n*d*4 (y): 22.4 MB for the user-item
// graph at Foodcom scale (n 37,539, nnz 380,674) and 19.7 MB for the
// recipe-ingredient graph (n 34,906, nnz 209,036), 6.7 us and 5.9 us at
// 3.35 TB/s. The 2*nnz*d flops are a tenth of that time at the f32 rate, so
// the tensor cores (wgmma) offer nothing here. Between the SMs and the L2,
// though, every edge moves a whole row of x (256 bytes at d 64: 97 MB for
// the user-item graph, 54 MB for the recipe-ingredient one), and that, with
// the cold gathers of x from HBM in edge order, is what holds the kernel
// well above the byte bound (PERF.md: the same bytes as a plain copy, a
// warm L2, and the geometries measured).
//
// Design. The work is cut into items of about equal edge count, planned on
// the host once per matrix (ops/spmm.py:plan_csr), since the adjacency is
// static:
//   * a row with more than ITEM_EDGES edges becomes several items, each a
//     slice of its edges; a slice writes its partial sum to a row of a
//     [n_partials, d] f32 scratch;
//   * shorter rows are packed whole, in order and greedily, into items of
//     at most ITEM_EDGES edges and ITEM_ROWS rows, so the recipe-ingredient
//     graph's average degree of 6 still gives an item tens of edges;
//   * empty rows belong to the item their position falls in, and are
//     written as zeros.
// A half-warp (16 lanes) runs one item: at d 64 in f32 a row of x is 16
// lanes x 16 bytes, one float4 load a lane. It walks the item's edges as one
// flat stream, kUnroll edges at a time: it issues the kUnroll row gathers
// first (2 x kUnroll independent 256-byte gathers in flight per warp), then
// adds them in edge order, writing a row's sum when the stream crosses the
// row's end. A block of items_per_block half-warps covers one contiguous
// range of edges and rows; it stages that range's cols, vals and row_ptr in
// shared memory with cp.async before the gather loop, so the index loads are
// off the path from row_ptr to x. Widths other than 64 loop over column
// tiles of 16 lanes x V floats with a mask (V = 4 when d % 4 == 0 and x is
// 16-byte aligned, else V = 2 with d even).
//
// A second small kernel, launched only when some row was cut, adds each cut
// row's partials: a warp a row, its lower half-warp the partials at even
// positions and its upper half those at odd positions, each in item order,
// and one shuffle adds the two, the even sum first. So every row's sum is
// taken in one fixed order, with no float atomics, and the result is
// bitwise equal from run to run.
//
// bf16 mode (spmm_dtype: bfloat16): x (g in the backward) is rounded to
// bf16, to nearest even, in registers after the load; values, accumulation
// and y stay f32. That is the JAX package's pallas path exactly: x.astype
// (bf16), gather, .astype(f32), the f32 kernel (spmm.py:317-336). The loads
// stay f32, so on this card it saves no traffic, and the rounding costs a
// few microseconds.
//
// Geometry (ITEM_EDGES, ITEM_ROWS, items per block) is the host plan's
// (ops/spmm.py); kUnroll is 8. The values chosen, and the alternatives
// measured beside them (shorter and longer items, other block sizes, 4
// gathers in flight, an item per warp with the half-warps on alternate
// edges, a bulk prefetch of x into the L2), are in PERF.md.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kGroup = 16;       // lanes that share one edge: a half-warp
constexpr int kMaxThreads = 512;

__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load(const float* p, float (&v)[2]) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = t.x; v[1] = t.y;
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

__device__ __forceinline__ float to_bf16_and_back(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One item per half-warp; items_per_block = blockDim.x / kGroup. Shared
// memory: the block's cols and vals (block_edges each) and its row_ptr
// entries. The half-warp walks its item's edges as one stream, issuing the
// gathers of kUnroll edges before it adds them in order.
template <int V, int kUnroll, bool kBf16>
__global__ void __launch_bounds__(kMaxThreads)
spmm_csr_items(const int32_t* __restrict__ row_ptr,
               const int32_t* __restrict__ cols,
               const float* __restrict__ vals,
               const float* __restrict__ x,
               const int32_t* __restrict__ item_row,
               const int32_t* __restrict__ item_edge,
               const int32_t* __restrict__ item_slot,
               float* __restrict__ y,
               float* __restrict__ partials,
               int n_items, int d, int block_edges) {
  extern __shared__ int32_t smem[];
  int32_t* s_cols = smem;
  float* s_vals = reinterpret_cast<float*>(smem + block_edges);
  int32_t* s_row_ptr = smem + 2 * block_edges;

  const int items_per_block = blockDim.x / kGroup;
  const int first = blockIdx.x * items_per_block;
  const int last = min(first + items_per_block, n_items);
  const int e_base = item_edge[first];
  const int r_base = item_row[first];
  const int n_edges = item_edge[last] - e_base;
  const int n_rows = item_row[last] - r_base;
  for (int i = threadIdx.x; i < n_edges; i += blockDim.x) {
    cp_async4(s_cols + i, cols + e_base + i);
    cp_async4(s_vals + i, vals + e_base + i);
  }
  for (int i = threadIdx.x; i <= n_rows; i += blockDim.x) {
    cp_async4(s_row_ptr + i, row_ptr + r_base + i);
  }
  cp_async_wait_all();
  __syncthreads();

  const int item = first + threadIdx.x / kGroup;
  if (item >= last) return;  // no barrier follows
  const int lane = threadIdx.x % kGroup;
  const int row0 = item_row[item];
  const int slot = item_slot[item];  // >= 0: a slice of a cut row
  const int eb = item_edge[item] - e_base;
  const int ee = item_edge[item + 1] - e_base;
  const int rows_end = slot >= 0 ? row0 + 1 : item_row[item + 1];

  for (int tile = 0; tile < d; tile += kGroup * V) {
    const int col = tile + lane * V;
    const bool active = col < d;  // d % V == 0: the whole vector is in range
    float acc[V] = {};
    int row = row0;
    // the stream position (block-relative) where the current row ends
    int stop = slot >= 0 ? ee : s_row_ptr[row0 + 1 - r_base] - e_base;
    for (int e0 = eb; e0 < ee; e0 += kUnroll) {
      float w[kUnroll];
      float xv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        w[u] = 0.f;
#pragma unroll
        for (int k = 0; k < V; ++k) xv[u][k] = 0.f;
        if (e0 + u < ee) {
          w[u] = s_vals[e0 + u];
          if (active) {
            load(x + static_cast<int64_t>(s_cols[e0 + u]) * d + col, xv[u]);
          }
        }
      }
      if constexpr (kBf16) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int k = 0; k < V; ++k) xv[u][k] = to_bf16_and_back(xv[u][k]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u;
        if (e >= ee) break;
        while (e >= stop) {  // the row ends before e: write it (zeros if empty)
          if (active) store(y + static_cast<int64_t>(row) * d + col, acc);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = 0.f;
          ++row;
          stop = s_row_ptr[row + 1 - r_base] - e_base;
        }
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(w[u], xv[u][k], acc[k]);
      }
    }
    if (!active) continue;
    if (slot >= 0) {
      store(partials + static_cast<int64_t>(slot) * d + col, acc);
      continue;
    }
    store(y + static_cast<int64_t>(row) * d + col, acc);
    const float zero[V] = {};
    for (++row; row < rows_end; ++row) {  // trailing empty rows
      store(y + static_cast<int64_t>(row) * d + col, zero);
    }
  }
}

// One cut row per warp: its partials into y. The lower half-warp adds the
// partials at even positions, the upper one those at odd positions, each in
// item order; one shuffle then adds the two, the even sum first.
template <int V, int kUnroll>
__global__ void __launch_bounds__(kMaxThreads)
spmm_csr_fixup(const int32_t* __restrict__ fix_row,
               const int32_t* __restrict__ fix_ptr,
               const float* __restrict__ partials,
               float* __restrict__ y, int n_fix, int d) {
  const int i = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (i >= n_fix) return;  // the whole warp
  const int half = threadIdx.x % kWarp / kGroup;
  const int lane = threadIdx.x % kGroup;
  const int p0 = fix_ptr[i];
  const int p1 = fix_ptr[i + 1];
  const int64_t row = fix_row[i];
  for (int tile = 0; tile < d; tile += kGroup * V) {
    const int col = tile + lane * V;
    const bool active = col < d;
    float acc[V] = {};
    for (int q0 = p0 + half; q0 < p1; q0 += 2 * kUnroll) {
      float pv[kUnroll][V] = {};
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q0 + 2 * u < p1 && active) {
          load(partials + static_cast<int64_t>(q0 + 2 * u) * d + col, pv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q0 + 2 * u >= p1) break;
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] += pv[u][k];
      }
    }
    float sum[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float other = __shfl_xor_sync(0xffffffffu, acc[k], kGroup);
      sum[k] = half == 0 ? acc[k] + other : other + acc[k];
    }
    if (half == 0 && active) store(y + row * d + col, sum);
  }
}

constexpr int kFixupThreads = 128;

template <int V, int kUnroll, bool kBf16>
cudaError_t launch(const int32_t* row_ptr, const int32_t* cols,
                   const float* vals, const float* x, const int32_t* item_row,
                   const int32_t* item_edge, const int32_t* item_slot,
                   const int32_t* fix_row, const int32_t* fix_ptr, float* y,
                   float* partials, int n_items, int n_fix, int d, int threads,
                   int block_edges, int block_rows, cudaStream_t stream) {
  const auto kernel = spmm_csr_items<V, kUnroll, kBf16>;
  const int per_block = threads / kGroup;
  const size_t smem = (2 * static_cast<size_t>(block_edges) + block_rows + 1)
                      * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(n_items + per_block - 1) / per_block, threads, smem, stream>>>(
      row_ptr, cols, vals, x, item_row, item_edge, item_slot, y, partials,
      n_items, d, block_edges);
  if (n_fix > 0) {
    constexpr int kRowsPerBlock = kFixupThreads / kWarp;
    spmm_csr_fixup<V, kUnroll><<<(n_fix + kRowsPerBlock - 1) / kRowsPerBlock,
                                 kFixupThreads, 0, stream>>>(
        fix_row, fix_ptr, partials, y, n_fix, d);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success). The
// caller (ops/_kernels.py) has checked shapes, dtypes, contiguity, the plan
// against the matrix, alignment (16 bytes for vec 4, 8 for vec 2), d % vec
// == 0, nnz < 2^31, n_items > 0, and threads a multiple of 32 up to 512.
extern "C" int spmm_csr_f32(const void* row_ptr, const void* cols,
                            const void* vals, const void* x,
                            const void* item_row, const void* item_edge,
                            const void* item_slot, const void* fix_row,
                            const void* fix_ptr, void* y, void* partials,
                            long long n_items, long long n_fix, long long d,
                            long long threads, long long block_edges,
                            long long block_rows, int vec, int round_bf16,
                            void* stream) {
  const auto args = [&](auto fn) {
    return fn(static_cast<const int32_t*>(row_ptr),
              static_cast<const int32_t*>(cols),
              static_cast<const float*>(vals), static_cast<const float*>(x),
              static_cast<const int32_t*>(item_row),
              static_cast<const int32_t*>(item_edge),
              static_cast<const int32_t*>(item_slot),
              static_cast<const int32_t*>(fix_row),
              static_cast<const int32_t*>(fix_ptr), static_cast<float*>(y),
              static_cast<float*>(partials), static_cast<int>(n_items),
              static_cast<int>(n_fix), static_cast<int>(d),
              static_cast<int>(threads), static_cast<int>(block_edges),
              static_cast<int>(block_rows), static_cast<cudaStream_t>(stream));
  };
  const bool bf16 = round_bf16 != 0;
  cudaError_t err;
  if (vec == 4) {
    err = bf16 ? args(launch<4, 8, true>) : args(launch<4, 8, false>);
  } else {
    err = bf16 ? args(launch<2, 8, true>) : args(launch<2, 8, false>);
  }
  return static_cast<int>(err);
}
