// Hand-written Hopper (sm_90a) kernels for the scalar Haydock recursion.
//
// Three kernels on the ELL/BSR layout of the JAX package, in native
// complex128 (interleaved re/im, read as double2):
//
//   haydock_spmv_dot   K1': y = H psi and per-row-block partials of
//                      Re<psi|y> (replaces rslmtoasa_tpu/ops/pallas_conv.py
//                      _spmv_kernel / conv_spmv_df64_pallas, the fused
//                      df64 stencil SpMV + <v|psi> partials)
//   haydock_spmv_dot_pipelined
//                      K2': the same y, with psi's gathered rows streamed
//                      through a ring of cp.async shared-memory stages, and
//                      the FINISHED per-chain a = Re<psi|y> (replaces
//                      pallas_conv.py _spmv_kernel_roll /
//                      conv_spmv_df64_pallas_roll, whose dot leaves the
//                      kernel already summed over planes)
//   haydock_update_norm  K3': pmn' = pmn + v - a psi and per-row-block
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
//   a     (C,) float64                       finished dot of K2'
//
// Mapping (all three): blockIdx.x is one block of ROWS_PER_BLOCK rows,
// blockIdx.y a tile of chains; threadIdx.x runs along the chain axis
// (consecutive threads read consecutive complex numbers of psi),
// threadIdx.y over ROW_THREADS row lanes; lane l takes the block's rows
// l, l + ROW_THREADS, ...  Each thread keeps its 9 complex outputs in
// registers.  The chain tile is CHAIN_TILE for K1' and K3' and
// PIPE_CHAIN_TILE for K2', whose ring is sized by it.
//
// The pipeline of K2': each thread walks its (row, slot) pairs, slot fastest,
// and fetches the 9 orbitals of psi[cols[row, m]] for its chain with
// 16-byte cp.async copies into its own part of a PIPE_STAGES-deep ring in
// shared memory.  While pair k is multiplied, pairs k+1 .. k+PIPE_STAGES-1
// are in flight.  A thread reads back only what it copied itself, so
// cp.async.wait_group orders the ring and no block barrier is needed in
// the loop.  The block's cols sit in shared memory beside the type table.
// The sentinel column kk reads psi's zero row like any other.  Each row
// accumulates in the order of K1' (slot outer, orbital inner, the same
// fma sequence), so the y of K2' equals that of K1' bit for bit, and so
// do its per-row-block partials.
//
// What bounds them on an H100: the SpMVs do nslots*81 complex MACs per
// (row, chain) -- 15*81*8 = 9.7 kflop at the bcc shape -- against about
// 0.3 kB of unique traffic, so at C = 144 chains they are bound by the
// FP64 pipe (DMMA through mma.sync f64 is the later speed-up); at the SCF
// shape (C = 9 per spin) by latency and launch, which the ring of K2'
// attacks by keeping 2 slots of gathers in flight per thread without
// holding them in registers.  The type table sits in shared memory (19 kB per
// type at nslots = 15), so the inner loop reads only psi from global
// memory.  update_norm reads three and writes one complex array per
// element: it is bound by memory bandwidth.
//
// Reductions: each thread sums its own rows in a fixed order, then
// thread row 0 of the CTA adds the ROW_THREADS lanes in a fixed order.
// K1' and K3' stop there and the caller folds the row blocks.  K2' then
// finishes the sum over row blocks itself: each block stores its partial,
// fences, and takes a ticket from an int counter of its chain tile; the
// block that takes the last ticket adds the partials in index order
// (ROW_THREADS contiguous runs, then the runs in order) and writes a.
// There are no floating-point atomics, so reruns are bit-identical.

#include <cuda_runtime.h>

namespace {

constexpr int NORB = 9;
constexpr int ROWS_PER_BLOCK = 32;  // = haydock_kernels.ROWS_PER_BLOCK
constexpr int ROW_THREADS = 8;
constexpr int CHAIN_TILE = 32;
constexpr int PIPE_CHAIN_TILE = 16;
constexpr int PIPE_STAGES = 3;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Dynamic shared memory of K2' for a chain tile of tc: type table, ring,
// lane partials, the block's cols, the last-block flag.
size_t pipelined_smem(int ntype, int nslots, int tc) {
  return (size_t)ntype * nslots * NORB * NORB * sizeof(double2) +
         (size_t)PIPE_STAGES * ROW_THREADS * NORB * tc * sizeof(double2) +
         (size_t)ROW_THREADS * tc * sizeof(double) +
         (size_t)ROWS_PER_BLOCK * nslots * sizeof(int) + sizeof(int);
}

__global__ void spmv_dot_pipelined_kernel(
    const double2* __restrict__ hs, const int* __restrict__ iz,
    const int* __restrict__ cols, const double2* __restrict__ psi,
    double2* __restrict__ y, double* __restrict__ bpart,
    int* __restrict__ counter, double* __restrict__ a, int ntype,
    int nslots, int kk, int C) {
  extern __shared__ double2 smem[];
  const int tc = blockDim.x;
  const int ntab = ntype * nslots * NORB * NORB;
  const size_t stage = (size_t)ROW_THREADS * NORB * tc;
  double2* ring = smem + ntab;  // [stage][lane][orbital][chain]
  double* red = reinterpret_cast<double*>(ring + PIPE_STAGES * stage);
  int* colsh = reinterpret_cast<int*>(red + ROW_THREADS * tc);
  int* last = colsh + ROWS_PER_BLOCK * nslots;

  const int blk = blockIdx.x;
  const int row0 = blk * ROWS_PER_BLOCK;
  const int nrow = min(ROWS_PER_BLOCK, kk - row0);
  const int tid = threadIdx.y * tc + threadIdx.x;
  const int nthreads = tc * blockDim.y;
  for (int i = tid; i < ntab; i += nthreads) smem[i] = hs[i];
  for (int i = tid; i < nrow * nslots; i += nthreads)
    colsh[i] = cols[(size_t)row0 * nslots + i];
  __syncthreads();

  const int c = blockIdx.y * tc + threadIdx.x;
  const int lane = threadIdx.y;
  const int nmine = (c < C && lane < nrow)
                        ? (nrow - lane + ROW_THREADS - 1) / ROW_THREADS
                        : 0;
  const int nsteps = nmine * nslots;  // (row, slot) pairs, slot fastest
  double2* mine = ring + (size_t)lane * NORB * tc + threadIdx.x;

  // fetch pair qk into stage qk % PIPE_STAGES; one commit group per pair
  // (empty past the end, so wait_group's count stays exact)
  int qk = 0, qr = 0, qm = 0;
  auto fetch = [&]() {
    if (qk < nsteps) {
      const int col = colsh[(lane + qr * ROW_THREADS) * nslots + qm];
      const double2* src = psi + (size_t)col * NORB * C + c;
      double2* dst = mine + (size_t)(qk % PIPE_STAGES) * stage;
#pragma unroll
      for (int b = 0; b < NORB; ++b)
        cp_async16(dst + (size_t)b * tc, src + (size_t)b * C);
      if (++qm == nslots) {
        qm = 0;
        ++qr;
      }
    }
    ++qk;
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < PIPE_STAGES - 1; ++s) fetch();

  double part = 0.0;
  double2 acc[NORB];
  const double2* tab = smem;
  int r = 0, m = 0;
  for (int k = 0; k < nsteps; ++k) {
    fetch();
    cp_async_wait<PIPE_STAGES - 1>();  // pair k has landed
    const int row = row0 + lane + r * ROW_THREADS;
    if (m == 0) {
      tab = smem + (size_t)iz[row] * nslots * NORB * NORB;
#pragma unroll
      for (int o = 0; o < NORB; ++o) acc[o] = make_double2(0.0, 0.0);
    }
    const double2* h = tab + m * NORB * NORB;
    const double2* src = mine + (size_t)(k % PIPE_STAGES) * stage;
#pragma unroll
    for (int b = 0; b < NORB; ++b) {
      const double2 p = src[(size_t)b * tc];
#pragma unroll
      for (int o = 0; o < NORB; ++o) cmac(acc[o], h[o * NORB + b], p);
    }
    if (++m == nslots) {
      const double2* self = psi + (size_t)row * NORB * C + c;
      double2* dst = y + (size_t)row * NORB * C + c;
#pragma unroll
      for (int o = 0; o < NORB; ++o) {
        dst[(size_t)o * C] = acc[o];
        const double2 p = self[(size_t)o * C];
        part = fma(p.x, acc[o].x, part);
        part = fma(p.y, acc[o].y, part);
      }
      m = 0;
      ++r;
    }
  }
  cp_async_wait<0>();
  store_block_partial(part, red, bpart, blk, c, C);

  // the last block of this chain tile to finish adds the partials
  __threadfence();
  __syncthreads();
  if (tid == 0)
    *last = atomicAdd(counter + blockIdx.y, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!*last) return;
  const int nblk = gridDim.x;
  const int run = (nblk + ROW_THREADS - 1) / ROW_THREADS;
  double s = 0.0;
  if (c < C) {
    const int j1 = min(nblk, (lane + 1) * run);
    for (int j = lane * run; j < j1; ++j)
      s += __ldcg(bpart + (size_t)j * C + c);
  }
  red[lane * tc + threadIdx.x] = s;
  __syncthreads();
  if (lane == 0 && c < C) {
    double t = 0.0;
    for (int l = 0; l < ROW_THREADS; ++l) t += red[l * tc + threadIdx.x];
    a[c] = t;
  }
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

// K2'.  bpart (nrowblk, C) float64 is scratch; counter holds at least
// ceil(C / PIPE_CHAIN_TILE) ints that must be ZERO at launch.
int haydock_spmv_dot_pipelined(const void* hs, const void* iz,
                               const void* cols, const void* psi, void* y,
                               void* a, void* bpart, void* counter,
                               int ntype, int nslots, int kk, int C,
                               void* stream) {
  const int tc = C < PIPE_CHAIN_TILE ? C : PIPE_CHAIN_TILE;
  const dim3 block(tc, ROW_THREADS);
  const size_t smem = pipelined_smem(ntype, nslots, tc);
  cudaError_t err = cudaFuncSetAttribute(
      spmv_dot_pipelined_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  spmv_dot_pipelined_kernel<<<grid_for(kk, C, tc), block, smem,
                              (cudaStream_t)stream>>>(
      (const double2*)hs, (const int*)iz, (const int*)cols,
      (const double2*)psi, (double2*)y, (double*)bpart, (int*)counter,
      (double*)a, ntype, nslots, kk, C);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory K2' asks for at this shape.
long long haydock_spmv_dot_pipelined_smem(int ntype, int nslots, int C) {
  return (long long)pipelined_smem(ntype, nslots,
                                   C < PIPE_CHAIN_TILE ? C : PIPE_CHAIN_TILE);
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
