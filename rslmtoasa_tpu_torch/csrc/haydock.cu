// Hand-written Hopper (sm_90a) kernels for the scalar Haydock recursion.
//
// Two kernels on the ELL/BSR layout of the JAX package, in native
// complex128 (interleaved re/im, read as double2):
//
//   haydock_spmv_dot   y = H psi and per-row-block partials of Re<psi|y>
//                      (replaces rslmtoasa_tpu/ops/pallas_conv.py
//                      _spmv_kernel / conv_spmv_df64_pallas, the fused
//                      df64 stencil SpMV + <v|psi> partials)
//   haydock_update_norm  pmn' = pmn + v - a psi and per-row-block
//                      partials of |pmn'|^2 (replaces pallas_conv.py
//                      _update_kernel / lanczos_update_pallas)
//
// Layouts (all C-contiguous):
//   hs    (ntype, nslots, 9, 9) complex128   type table
//   iz    (kk,) int32                        type per row
//   cols  (kk, nslots) int32                 neighbour rows, sentinel kk
//   psi   (kk+1, 9, C) complex128            row kk is all zero
//   y, v, pmn (kk, 9, C) complex128
//   partials (nrowblk, C) float64, nrowblk = ceil(kk / ROWS_PER_BLOCK)
//
// Mapping: blockIdx.x is one block of ROWS_PER_BLOCK rows, blockIdx.y a
// tile of up to CHAIN_TILE chains; threadIdx.x runs along the chain axis
// (consecutive threads read consecutive complex numbers of psi),
// threadIdx.y over ROW_THREADS row lanes that walk the block's rows.
// Each thread keeps its 9 complex outputs in registers.
//
// What bounds them on an H100: spmv_dot does nslots*81 complex MACs per
// (row, chain) -- 15*81*8 = 9.7 kflop at the bcc shape -- against about
// 0.3 kB of unique traffic, so at C = 144 chains it is bound by the FP64
// pipe (DMMA through mma.sync f64 is the later speed-up); at the SCF
// shape (C = 9 per spin) it is bound by latency and launch.  The type
// table sits in shared memory (19 kB per type at nslots = 15), so the
// inner loop reads only psi from global memory.  update_norm reads three
// and writes one complex array per element: it is bound by memory
// bandwidth.
//
// Reductions: each thread sums its own rows in a fixed order, then
// thread row 0 of the CTA adds the ROW_THREADS lanes in a fixed order.
// There are no atomics, so reruns are bit-identical.  The fold over row
// blocks happens in the caller.

#include <cuda_runtime.h>

namespace {

constexpr int NORB = 9;
constexpr int ROWS_PER_BLOCK = 32;  // = haydock_kernels.ROWS_PER_BLOCK
constexpr int ROW_THREADS = 8;
constexpr int CHAIN_TILE = 32;

__device__ __forceinline__ void cmac(double2& acc, const double2 h,
                                     const double2 p) {
  acc.x = fma(h.x, p.x, acc.x);
  acc.x = fma(-h.y, p.y, acc.x);
  acc.y = fma(h.x, p.y, acc.y);
  acc.y = fma(h.y, p.x, acc.y);
}

// Fixed-order sum of the ROW_THREADS lanes' partials of one chain.
// Every thread of the CTA must call it (it holds a barrier).
__device__ __forceinline__ void store_block_partial(double part,
                                                    double* red,
                                                    double* out, int blk,
                                                    int c, int C) {
  red[threadIdx.y * blockDim.x + threadIdx.x] = part;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    double s = 0.0;
    for (int r = 0; r < blockDim.y; ++r) s += red[r * blockDim.x + threadIdx.x];
    out[(size_t)blk * C + c] = s;
  }
}

__global__ void spmv_dot_kernel(const double2* __restrict__ hs,
                                const int* __restrict__ iz,
                                const int* __restrict__ cols,
                                const double2* __restrict__ psi,
                                double2* __restrict__ y,
                                double* __restrict__ apart, int ntype,
                                int nslots, int kk, int C) {
  extern __shared__ double2 smem[];
  const int ntab = ntype * nslots * NORB * NORB;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < ntab;
       i += nthreads)
    smem[i] = hs[i];
  double* red = reinterpret_cast<double*>(smem + ntab);
  __syncthreads();

  const int blk = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  double part = 0.0;
  if (c < C) {
    for (int r = threadIdx.y; r < ROWS_PER_BLOCK; r += blockDim.y) {
      const int row = blk * ROWS_PER_BLOCK + r;
      if (row >= kk) break;
      const double2* tab = smem + (size_t)iz[row] * nslots * NORB * NORB;
      double2 acc[NORB];
#pragma unroll
      for (int a = 0; a < NORB; ++a) acc[a] = make_double2(0.0, 0.0);
      for (int m = 0; m < nslots; ++m) {
        // the sentinel column kk reads psi's zero row
        const int col = cols[(size_t)row * nslots + m];
        const double2* src = psi + (size_t)col * NORB * C + c;
        const double2* h = tab + m * NORB * NORB;
#pragma unroll
        for (int b = 0; b < NORB; ++b) {
          const double2 p = src[(size_t)b * C];
#pragma unroll
          for (int a = 0; a < NORB; ++a) cmac(acc[a], h[a * NORB + b], p);
        }
      }
      const double2* self = psi + (size_t)row * NORB * C + c;
      double2* dst = y + (size_t)row * NORB * C + c;
#pragma unroll
      for (int a = 0; a < NORB; ++a) {
        dst[(size_t)a * C] = acc[a];
        const double2 p = self[(size_t)a * C];
        part = fma(p.x, acc[a].x, part);
        part = fma(p.y, acc[a].y, part);
      }
    }
  }
  store_block_partial(part, red, apart, blk, c, C);
}

// pmn and out may be the same buffer: each element is read and then
// written by the same thread.
__global__ void update_norm_kernel(const double* __restrict__ a,
                                   const double2* __restrict__ psi,
                                   const double2* __restrict__ v,
                                   const double2* pmn, double2* out,
                                   double* __restrict__ nrm, int kk,
                                   int C) {
  __shared__ double red[CHAIN_TILE * ROW_THREADS];
  const int blk = blockIdx.x;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  double part = 0.0;
  if (c < C) {
    const double ac = a[c];
    for (int r = threadIdx.y; r < ROWS_PER_BLOCK; r += blockDim.y) {
      const int row = blk * ROWS_PER_BLOCK + r;
      if (row >= kk) break;
#pragma unroll
      for (int o = 0; o < NORB; ++o) {
        const size_t i = ((size_t)row * NORB + o) * C + c;
        const double2 p = psi[i];
        const double2 w = v[i];
        const double2 q = pmn[i];
        double2 n;
        n.x = (q.x + w.x) - ac * p.x;
        n.y = (q.y + w.y) - ac * p.y;
        out[i] = n;
        part = fma(n.x, n.x, part);
        part = fma(n.y, n.y, part);
      }
    }
  }
  store_block_partial(part, red, nrm, blk, c, C);
}

dim3 grid_for(int kk, int C, int tc) {
  return dim3((kk + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, (C + tc - 1) / tc);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the attribute call or of the launch.
int haydock_spmv_dot(const void* hs, const void* iz, const void* cols,
                     const void* psi, void* y, void* apart, int ntype,
                     int nslots, int kk, int C, void* stream) {
  const int tc = C < CHAIN_TILE ? C : CHAIN_TILE;
  const dim3 block(tc, ROW_THREADS);
  const size_t smem = (size_t)ntype * nslots * NORB * NORB * sizeof(double2) +
                      (size_t)tc * ROW_THREADS * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      spmv_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  spmv_dot_kernel<<<grid_for(kk, C, tc), block, smem,
                    (cudaStream_t)stream>>>(
      (const double2*)hs, (const int*)iz, (const int*)cols,
      (const double2*)psi, (double2*)y, (double*)apart, ntype, nslots, kk,
      C);
  return (int)cudaGetLastError();
}

int haydock_update_norm(const void* a, const void* psi, const void* v,
                        const void* pmn, void* out, void* nrm, int kk, int C,
                        void* stream) {
  const int tc = C < CHAIN_TILE ? C : CHAIN_TILE;
  const dim3 block(tc, ROW_THREADS);
  update_norm_kernel<<<grid_for(kk, C, tc), block, 0,
                       (cudaStream_t)stream>>>(
      (const double*)a, (const double2*)psi, (const double2*)v,
      (const double2*)pmn, (double2*)out, (double*)nrm, kk, C);
  return (int)cudaGetLastError();
}

int haydock_rows_per_block() { return ROWS_PER_BLOCK; }

}  // extern "C"
