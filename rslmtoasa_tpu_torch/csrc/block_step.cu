// Hand-written Hopper (sm_90a) kernel for the step of the block recursion.
//
//   block_step   K4: y = add + H x + O p, and per-row-tile partials of the
//                Gram blocks p^H y.  Replaces the XLA ops of
//                rslmtoasa_tpu/ops/block_lanczos.py that apply_h composes
//                at :147-159: _spmv18 (:27), _onsite18 (:66) and gram_sum
//                (:73).  The TPU had no Pallas kernel for this step.
//
// Layouts (all C-contiguous, complex128 read as double2; D = 9 or 18 is the
// block width, C = R D the columns of R start blocks side by side):
//   tab    (ntype, nslots, D, D)   ELL type table T[t, m, a, b]
//   iz     (kk,) int32             type of each row
//   cols   (kk, nslots) int32      neighbour rows, sentinel kk
//   x      (kk+1, D, C)            row kk is zero
//   onsite (nto, D, D)             onsite table O, or null
//   izo    (kk,) int32             onsite type of each row (with onsite)
//   p      (kk+1, D, C)            onsite operand and Gram bra (with onsite
//                                  or gram)
//   add    (kk, D, C)              added to y, or null
//   y      (kk + pad, D, C)        out; with pad = 1, row kk is written zero
//   gram   (nrowblk, R, D, D)      out, or null
//
//   y[i, a, c] = add[i, a, c]
//                + sum_m sum_b T[iz[i], m, a, b] x[cols[i, m], b, c]
//                + sum_b O[izo[i], a, b] p[i, b, c]
//   gram[t, r, a, c] = sum over the rows i of tile t and over b of
//                      conj(p[i, b, rD + a]) y[i, b, rD + c]
//
// Mapping.  A block of THREADS = 288 threads takes a tile of RT = 288 / D
// rows (16 at D = 18, 32 at D = 9) and one start block r (blockIdx.y).
// Thread (row, col) owns column rD + col of its row and keeps all D outputs
// y[i, :, rD + col] in registers.  Per slot and input orbital b it loads one
// gathered x[j, b, rD + col] (the D threads of a row read D neighbouring
// double2) and the D entries T[t, m, :, b] of its type's block, which are
// the same addresses for every thread whose row has that type, read through
// L1.  (A type's table is 15 * 18 * 18 * 16 B = 78 KB at D = 18, so two
// types would not fit in shared memory beside anything else.)  So one
// gathered value feeds D complex MACs, and the table loads are broadcasts.
// The onsite term is one more block of the same loop, with x = p and j = i.
// Sentinel slots are skipped.
//
// Gram epilogue: each thread forms sum_b conj(p[i, b, rD + a]) y[i, b, c]
// from its registers for GRAM_CHUNK values of a at a time and writes them
// to shared memory; after a barrier the block adds the tile's rows in row
// order for each (a, c).  No floating-point atomics, so reruns are
// bit-identical; the caller folds the tiles with .sum(0).
//
// What bounds it: at the box-30 bcc shape (kk = 27000, 15 slots, 383758
// occupied (row, slot) blocks, D = 18, R = 1) one launch does 17.9 GFLOP of
// SpMV and 1.26 GFLOP each of onsite and Gram work, against about 290 MB of
// tables, x, y and partials.  Operations bound it: 0.30 ms at the 67
// TFLOP/s FP64 tensor-core peak, and 0.60 ms at the 34 TFLOP/s FP64 vector
// peak, the best this SIMT kernel can reach.  Its inner loop issues one L1
// load (a broadcast) per four DFMA.  On an H100 80GB HBM3 (700 W;
// chip_smoke.py phase 6) it takes about 1.77 ms at D = 18 and 0.26 ms at
// D = 9, 17 % and 14 % of the bound, built for one block per SM (168
// registers); built for two (96 registers and spills) it took 2.69 ms.  With 9 warps per SM the broadcasts' latency shows; DMMA
// (the table realified into B fragments, as K1' does) is the next design.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 288;   // = block_kernels.THREADS
constexpr int GRAM_CHUNK = 9;  // Gram rows a per shared-memory round
// blocks per SM the register budget is cut for: one leaves 168 registers
// a thread; two (96, with spills) ran 1.5 times slower at D = 18
constexpr int MIN_BLOCKS = 1;

__device__ __forceinline__ void cmac(double2& acc, double2 h, double2 v) {
  acc.x = fma(h.x, v.x, acc.x);
  acc.x = fma(-h.y, v.y, acc.x);
  acc.y = fma(h.x, v.y, acc.y);
  acc.y = fma(h.y, v.x, acc.y);
}

// acc[a] += sum_b blk[a, b] v[b C]
template <int D>
__device__ __forceinline__ void block_mac(double2 (&acc)[D],
                                          const double2* __restrict__ blk,
                                          const double2* __restrict__ v,
                                          int C) {
#pragma unroll 3
  for (int b = 0; b < D; ++b) {
    const double2 xv = __ldg(v + (size_t)b * C);
#pragma unroll
    for (int a = 0; a < D; ++a) cmac(acc[a], __ldg(blk + a * D + b), xv);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    block_step_kernel(const double2* __restrict__ tab,
                      const int* __restrict__ iz,
                      const int* __restrict__ cols,
                      const double2* __restrict__ x,
                      const double2* __restrict__ onsite,
                      const int* __restrict__ izo,
                      const double2* __restrict__ p,
                      const double2* __restrict__ add,
                      double2* __restrict__ y, double2* __restrict__ gram,
                      int nslots, int kk, int nout, int C) {
  constexpr int RT = THREADS / D;
  __shared__ double2 sg[RT * GRAM_CHUNK * D];
  const int row = threadIdx.x / D;
  const int col = threadIdx.x % D;
  const int r = blockIdx.y;
  const int i = blockIdx.x * RT + row;
  const int cc = r * D + col;
  const bool live = i < kk;
  const size_t own = (size_t)i * D * C + cc;  // y[i, 0, cc]

  double2 acc[D];
#pragma unroll
  for (int a = 0; a < D; ++a) acc[a] = make_double2(0.0, 0.0);
  if (live) {
    if (add != nullptr) {
#pragma unroll
      for (int a = 0; a < D; ++a) acc[a] = add[own + (size_t)a * C];
    }
    const double2* tt = tab + (size_t)iz[i] * nslots * D * D;
    for (int m = 0; m < nslots; ++m) {
      const int j = cols[(size_t)i * nslots + m];
      if (j >= kk) continue;
      block_mac<D>(acc, tt + m * D * D, x + (size_t)j * D * C + cc, C);
    }
    if (onsite != nullptr)
      block_mac<D>(acc, onsite + (size_t)izo[i] * D * D, p + own, C);
  }
  if (i < nout) {
#pragma unroll
    for (int a = 0; a < D; ++a) y[own + (size_t)a * C] = acc[a];
  }
  if (gram == nullptr || blockIdx.x * RT >= kk) return;  // block-uniform

  for (int a0 = 0; a0 < D; a0 += GRAM_CHUNK) {
    for (int k = 0; k < GRAM_CHUNK; ++k) {
      double2 g = make_double2(0.0, 0.0);
      if (live) {
        const double2* pa = p + (size_t)i * D * C + r * D + a0 + k;
#pragma unroll
        for (int b = 0; b < D; ++b) {  // conj(p[i, b, rD + a]) y[i, b, cc]
          const double2 pv = __ldg(pa + (size_t)b * C);
          g.x = fma(pv.x, acc[b].x, g.x);
          g.x = fma(pv.y, acc[b].y, g.x);
          g.y = fma(pv.x, acc[b].y, g.y);
          g.y = fma(-pv.y, acc[b].x, g.y);
        }
      }
      sg[(row * GRAM_CHUNK + k) * D + col] = g;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < GRAM_CHUNK * D; o += THREADS) {
      double2 s = make_double2(0.0, 0.0);
      for (int q = 0; q < RT; ++q) {  // the tile's rows in order
        const double2 v = sg[q * GRAM_CHUNK * D + o];
        s.x += v.x;
        s.y += v.y;
      }
      const int k = o / D;
      const int c = o % D;
      gram[(((size_t)blockIdx.x * gridDim.y + r) * D + a0 + k) * D + c] = s;
    }
    __syncthreads();
  }
}

template <int D>
int launch(const void* tab, const void* iz, const void* cols, const void* x,
           const void* onsite, const void* izo, const void* p,
           const void* add, void* y, void* gram, int nslots, int kk, int pad,
           int C, void* stream) {
  constexpr int RT = THREADS / D;
  const int nout = kk + pad;
  const dim3 grid((nout + RT - 1) / RT, C / D);
  block_step_kernel<D><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const double2*)tab, (const int*)iz, (const int*)cols,
      (const double2*)x, (const double2*)onsite, (const int*)izo,
      (const double2*)p, (const double2*)add, (double2*)y, (double2*)gram,
      nslots, kk, nout, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4.  onsite/izo, p, add and gram may be null as the layout notes say;
// C must be a multiple of d.  Returns the cudaError_t of the launch.
int block_step(int d, const void* tab, const void* iz, const void* cols,
               const void* x, const void* onsite, const void* izo,
               const void* p, const void* add, void* y, void* gram,
               int nslots, int kk, int pad, int C, void* stream) {
  if (d == 9)
    return launch<9>(tab, iz, cols, x, onsite, izo, p, add, y, gram, nslots,
                     kk, pad, C, stream);
  if (d == 18)
    return launch<18>(tab, iz, cols, x, onsite, izo, p, add, y, gram, nslots,
                      kk, pad, C, stream);
  return (int)cudaErrorInvalidValue;
}

int block_step_threads() { return THREADS; }

}  // extern "C"
