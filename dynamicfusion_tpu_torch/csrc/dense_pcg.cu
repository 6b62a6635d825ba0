// Kernel P: block-Jacobi PCG over the dense damped (6N, 6N) normal
// equations (solver_linear="pcg" with the unlagged JᵀJ).
//
// Replaces dynamicfusion_tpu/solvers/warp_solver.py:860 _pcg_solve with
// :823 _pcg (a while_loop of the dense matvec a @ p, the block-Jacobi
// apply and three dot products) and :816 _block_diag_inv (whose spd6_inv
// is kernel G's entry, called by the wrapper's caller).
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W: 3.35 TB/s, 67 TFLOP/s
// float32, data-sheet peaks; measured times in PERF.md): bytes. Each
// iteration reads the whole float32 matrix, 151 MB at 1024 nodes (6N = 6
// 144), for 75 MFLOP: 0.045 ms of memory against 0.001 ms of arithmetic,
// so up to 32 iterations are ~1.4 ms of bandwidth. The vector work (a few
// 6 144-long vectors an iteration) is noise beside it.
// Design: two launches an iteration (chosen over one cooperative
// persistent launch, which would need every block resident for a grid-wide
// barrier and the cooperative-launch path): the GEMV, one warp per matrix
// row, float4 loads along the row, each lane summing its columns in column
// order and the warp in a fixed shuffle tree, so every run gives the same
// bits; then one 1024-thread block for the vector updates, the block-Jacobi
// apply (each thread owns whole nodes) and the dot products (fixed-order
// block sums). The early exit rᵀr <= rtol² bᵀb is a flag in device memory
// that the update block writes and both kernels read first: once it is
// set, the remaining launches return at once, so the host never reads a
// value and the number of launches is fixed by ``iters``. An ``active``
// flag False makes the solve return x = 0.
#include "common.cuh"
#include "reduce.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp a row
constexpr int kBlock = 1024;

using State = dfk::PcgState;

__device__ float node_dot(const float* a, const float* b, int n) {
  float s = 0.0f;
  for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
#pragma unroll
    for (int d = 0; d < 6; ++d) s += a[6 * nd + d] * b[6 * nd + d];
  }
  return s;
}

__device__ void apply_m(const float* __restrict__ minv, const float* __restrict__ r, float* __restrict__ z, int n) {
  for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
    const float* m = minv + 36 * static_cast<size_t>(nd);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float s = 0.0f;
#pragma unroll
      for (int b = 0; b < 6; ++b) s += m[6 * a + b] * r[6 * nd + b];
      z[6 * nd + a] = s;
    }
  }
}

__global__ void __launch_bounds__(kBlock)
init_kernel(const float* __restrict__ minv, const float* __restrict__ b, int n, int iters, float rtol2,
            const bool* __restrict__ active, float* __restrict__ x, float* __restrict__ r, float* __restrict__ z,
            float* __restrict__ p, State* __restrict__ st) {
  __shared__ float red[33];
  // each thread writes only the nodes it owns, as in the updates
  apply_m(minv, b, z, n);
  for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      x[6 * nd + d] = 0.0f;
      r[6 * nd + d] = b[6 * nd + d];
      p[6 * nd + d] = z[6 * nd + d];
    }
  }
  const float bb = block_sum(node_dot(b, b, n), red);
  const float rz = block_sum(node_dot(b, z, n), red);  // r = b here
  if (threadIdx.x == 0) {
    st->rz = rz;
    st->stop2 = rtol2 * bb;
    st->done = (!*active || iters <= 0 || !(bb > st->stop2)) ? 1 : 0;
  }
}

// ap = A p, one warp a row; kVec: the rows start 16-byte aligned (6N % 4 == 0)
template <bool kVec>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
gemv_kernel(const float* __restrict__ a, const float* __restrict__ p, int dof, const State* __restrict__ st,
            float* __restrict__ ap) {
  if (st->done) return;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= dof) return;
  const float* ar = a + static_cast<size_t>(row) * dof;
  float acc = 0.0f;
  if constexpr (kVec) {
    const float4* a4 = reinterpret_cast<const float4*>(ar);
    const float4* p4 = reinterpret_cast<const float4*>(p);
    for (int j = lane; j < dof / 4; j += 32) {
      const float4 av = __ldg(a4 + j);
      const float4 pv = p4[j];
      acc += av.x * pv.x;
      acc += av.y * pv.y;
      acc += av.z * pv.z;
      acc += av.w * pv.w;
    }
  } else {
    for (int j = lane; j < dof; j += 32) acc += ar[j] * p[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) ap[row] = acc;
}

__global__ void __launch_bounds__(kBlock)
update_kernel(const float* __restrict__ minv, const float* __restrict__ ap, int n, float* __restrict__ x,
              float* __restrict__ r, float* __restrict__ z, float* __restrict__ p, State* __restrict__ st) {
  __shared__ float red[33];
  if (st->done) return;
  const float rz = st->rz;
  const float alpha = rz / fmaxf(block_sum(node_dot(p, ap, n), red), 1e-30f);
  for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const int i = 6 * nd + d;
      x[i] = x[i] + alpha * p[i];
      r[i] = r[i] - alpha * ap[i];
    }
  }
  apply_m(minv, r, z, n);
  const float rz_new = block_sum(node_dot(r, z, n), red);
  const float beta = rz_new / fmaxf(rz, 1e-30f);
  for (int nd = threadIdx.x; nd < n; nd += blockDim.x) {
#pragma unroll
    for (int d = 0; d < 6; ++d) p[6 * nd + d] = z[6 * nd + d] + beta * p[6 * nd + d];
  }
  const float rr = block_sum(node_dot(r, r, n), red);
  if (threadIdx.x == 0) {
    st->rz = rz_new;
    st->done = !(rr > st->stop2) ? 1 : 0;
  }
}

}  // namespace

// work: 4 (6N) floats (r, z, p, Ap) then the 3-word loop state
extern "C" int df_dense_pcg(const void* a, const void* minv, const void* b, int n, int iters, float rtol2,
                            const void* active, void* x, void* work, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dof = 6 * n;
  const float* am = static_cast<const float*>(a);
  const float* mi = static_cast<const float*>(minv);
  float* xv = static_cast<float*>(x);
  float* r = static_cast<float*>(work);
  float* z = r + dof;
  float* p = z + dof;
  float* ap = p + dof;
  State* st = reinterpret_cast<State*>(ap + dof);
  init_kernel<<<1, kBlock, 0, s>>>(mi, static_cast<const float*>(b), n, iters, rtol2,
                                   static_cast<const bool*>(active), xv, r, z, p, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (dof + kRowsPerBlock - 1) / kRowsPerBlock;
  const bool vec = dof % 4 == 0;
  for (int it = 0; it < iters; ++it) {
    if (vec) {
      gemv_kernel<true><<<blocks, 32 * kRowsPerBlock, 0, s>>>(am, p, dof, st, ap);
    } else {
      gemv_kernel<false><<<blocks, 32 * kRowsPerBlock, 0, s>>>(am, p, dof, st, ap);
    }
    update_kernel<<<1, kBlock, 0, s>>>(mi, ap, n, xv, r, z, p, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The distributed PCG of kernel G's shard mode (csrc/pcg.cu) runs this
// kernel's init and update around its own matvec: work as df_dense_pcg's
// (r, z, p, Ap, then the 3-word loop state)
extern "C" int df_pcg_init(const void* minv, const void* b, int n, int iters, float rtol2, const void* active, void* x,
                           void* work, void* stream) {
  if (n <= 0) return 0;
  const int dof = 6 * n;
  float* r = static_cast<float*>(work);
  State* st = reinterpret_cast<State*>(r + 4 * dof);
  init_kernel<<<1, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(minv), static_cast<const float*>(b), n, iters, rtol2,
      static_cast<const bool*>(active), static_cast<float*>(x), r, r + dof, r + 2 * dof, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int df_pcg_update(const void* minv, int n, void* x, void* work, void* stream) {
  if (n <= 0) return 0;
  const int dof = 6 * n;
  float* r = static_cast<float*>(work);
  State* st = reinterpret_cast<State*>(r + 4 * dof);
  update_kernel<<<1, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(minv), r + 3 * dof, n, static_cast<float*>(x), r, r + dof, r + 2 * dof, st);
  return static_cast<int>(cudaGetLastError());
}
