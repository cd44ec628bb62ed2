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
//   tab    (ntype, nqs, NT, 32) double2  type table T[t, m, a, b], realified
//                                        and cut into B fragments by
//                                        block_kernels.pack_table
//   iz     (kk,) int32                   type of each row
//   cols   (kk, nslots) int32            neighbour rows, sentinel kk
//   x      (kk+1, D, C)                  row kk is zero
//   onsite (nto, nqo, NT, 32) double2    onsite table O, packed the same
//                                        way as one slot, or null
//   izo    (kk,) int32                   onsite type of each row
//   p      (kk+1, D, C)                  onsite operand and Gram bra
//   add    (kk, D, C)                    added to y, or null
//   y      (kk + pad, D, C)              out; with pad = 1, row kk is zero
//   gram   (nrowblk, R, D, D)            out, or null
//   tabl, izl, onl, izol                 the local zone's tables and
//                                        indices, or null (see below)
//
//   y[i, a, c] = add[i, a, c]
//                + sum_m sum_b T[iz[i], m, a, b] x[cols[i, m], b, c]
//                + sum_b O[izo[i], a, b] p[i, b, c]
//   gram[t, r, a, c] = sum over the rows i of tile t and over b of
//                      conj(p[i, b, rD + a]) y[i, b, rD + c]
//
// The step as a GEMM on the FP64 tensor cores, as K1' in haydock.cu does
// it.  Each (row i, column c) pair is one GEMM row.  Its K axis is every
// complex input it sums: the D orbitals of each of the nslots neighbour
// rows in slot order (270 at D = 18, nslots = 15), grouped in quads of 4
// (nqs = 68 quads, the last one padded with zeros), then the onsite block
// as one more slot with x = p and j = i (nqo = 5 quads at D = 18, 3 at
// D = 9).  One quad is one mma.sync.m16n8k8.f64: k = 0..3 take the real
// parts of its 4 inputs, k = 4..7 their imaginary parts.  The N axis is
// the 2D real outputs, in NT = 5 n8 tiles at D = 18 (90 % useful) and 3 at
// D = 9 (75 %).  m8n8k4 would run at half rate on this card.
//
// Mapping: a tile is RT = 288 / D rows (16 at D = 18, 32 at D = 9) times
// the D columns of one start block: 288 pairs, pair p = row * D + column,
// so the 8 pairs of an m16 half-tile are neighbouring columns of one or two
// rows and their gathers share 128-byte lines.  Eighteen warps of one m16
// tile each take the 288 pairs: with two m16 tiles per warp (nine warps,
// each B fragment read from shared memory feeding two MMAs) the kernel
// ran 1.7 times slower at D = 18, as too few warps were left to hide the
// gathers' latency (PERF.md section 6).  The grid is persistent: each
// block copies the tables into shared memory once, takes tile blockIdx.x
// and then the next free tile of an int counter that all blocks draw from
// (the last block out sets it back to 0), so that a block held up by a
// slow tile takes fewer of the rest; which block runs a tile changes no
// bit of it.  Tile t is row tile t % nrt of start block t / nrt.  The next tile's cols and types land by cp.async
// while the current one is multiplied.  Each lane loads its gathered
// double2 of the next quad into registers while the tensor cores multiply
// the current one.
// A row tile whose rows mix types runs once per type present, with the
// other types' inputs zero (exact zeros, so the bits do not depend on the
// pass order); the onsite term likewise per onsite type present.
//
// An impurity's local zone.  Its recursion runs on the combined row
// table [hall; ee]: one row type per atom of the local zone (the first
// nmax rows), then one per species, 64 types for three impurities at
// nmax = 60, which no chunking fits beside the fixed buffers.  The caller
// splits the rows at nl = ceil(nmax / RT) RT, so that no tile holds rows
// of both parts.  The nlt = nl / RT local row tiles read the combined
// tables from global memory (tabl, onl, indexed by izl and izol: ntypel
// and ntol types), one pass per type present as above, so each of their
// per-atom rows is a pass of the one or two warps that hold it.  Every
// other tile runs the shared-memory route on tables compacted to the
// types present beyond nl (tab, onsite, indexed by iz and izo: at the bcc
// impurity one type and one onsite type, so one chunk, as bulk bcc).  The
// branch is per tile and so block-uniform, and each branch has its own
// call of run_quads, so that the shared-memory loads stay LDS.  A local
// tile takes several times as long as a bulk one (its fragments come from
// L2 a quad at a time); as the blocks draw their tiles from the counter,
// the rest of the grid absorbs it: at the three-impurity shape the zone
// costs under 1 % of the launch, against 14 % when each block walked a
// fixed list of tiles (PERF.md section 6).
//
// Tables larger than shared memory.  One type's table takes 174 KB at
// D = 18 (52 KB at D = 9); with the onsite table, the Gram staging and the
// cols it fits the 227 KB a block may use, two types at D = 18 do not.
// The launcher then cuts the slot quads into equal chunks that fit for
// every type at once, and each tile walks the chunks, reloading the
// chunk's fragments of every type between two block barriers while its
// accumulators stay in registers.  So there is one route for every shape:
// one chunk (the table loaded once per block) whenever it fits, which
// covers every bcc shape and D = 9, and several on the B2 preset at
// D = 18, where a tile then reloads the table at a few per cent of its
// MMA time.
//
// Gram epilogue, on the vector pipe.  A lane holds y[i, b, c] for its
// pairs and b = 4 nt + t; for GC rows a at a time it forms
// sum_b conj(p[i, b, rD + a]) y[i, b, c] over its b, adds the four lanes
// of a pair with two xor shuffles and writes the result to shared memory;
// after a barrier the block adds the tile's rows in row order for each
// (a, c).  No floating-point atomics, so reruns are bit-identical; the
// caller folds the tiles with .sum(0).
//
// What bounds it: at the box-30 bcc shape (kk = 27000, 15 slots, 383758
// occupied (row, slot) blocks, D = 18, R = 1) one launch does 17.9 GFLOP
// of SpMV and 1.26 GFLOP each of onsite and Gram work, against about
// 290 MB of tables, x, y and partials.  Operations bound it: 0.30 ms at
// the 67 TFLOP/s FP64 tensor-core peak.  The padded DMMA work is 22.7
// GFLOP (0.34 ms).  Each quad of a warp reads 512 B of gathered inputs
// through L1 and 2.5 KB of B fragments from shared memory for five MMAs,
// so at the tensor peak the L1/shared-memory pipe would be about as busy
// as the tensor cores.  On an H100 80GB HBM3 (700 W; chip_smoke.py phase
// 6) it takes about 0.88 ms at D = 18, 35 % of the bound; without the
// Gram 0.65 ms, and the SpMV alone 0.59 ms, so the Gram epilogue's loads
// of p (four 128-byte lines per warp load, one per b) cost a quarter.
// PERF.md section 6 has the times.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_PAIRS = 288;  // = block_kernels.TILE_PAIRS
constexpr int NX = 2;            // pairs (gathered inputs) per lane
constexpr int THREADS = 32 * TILE_PAIRS / 16;  // 18 warps of one m16 tile
constexpr int QUAD = 4;          // complex inputs per k8 step
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Width {
  static constexpr int RT = TILE_PAIRS / D;   // rows per tile
  static constexpr int NT = (2 * D + 7) / 8;  // n8 tiles over 2D outputs
  static constexpr int GC = D == 18 ? 6 : 9;  // Gram rows a per round
};

__host__ __device__ constexpr int nquads(int n) {
  return (n + QUAD - 1) / QUAD;
}

__device__ __forceinline__ void dmma_m16n8k8(double (&d)[4], double a0,
                                             double a1, double a2, double a3,
                                             double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One quad of the warp's m16 tile.  x[h] is the lane's gathered input of
// pair 8 h + (lane >> 2); bq the quad's table fragments.
template <int NT>
__device__ __forceinline__ void quad_mma(double (&acc)[NT][4],
                                         const double2 (&x)[NX],
                                         const double2* bq, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const double2 b = bq[nt * 32 + lane];
    dmma_m16n8k8(acc[nt], x[0].x, x[1].x, x[0].y, x[1].y, b.x, b.y);
  }
}

// Quads j0 <= j < j1 into acc.  src(j, k) is the address of the lane's
// input k of quad j, or nullptr where it is zero; tq holds the fragments
// of quad j0 onwards.  The next quad's inputs load while this one is
// multiplied.
template <int NT, typename Src>
__device__ __forceinline__ void run_quads(double (&acc)[NT][4], int j0,
                                          int j1, Src src,
                                          const double2* tq, int lane) {
  auto load = [&](int j, double2 (&xv)[NX]) {
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const double2* s = src(j, k);
      xv[k] = s ? __ldg(s) : make_double2(0.0, 0.0);
    }
  };
  double2 xa[NX], xb[NX];
  load(j0, xa);
  for (int j = j0; j < j1; j += 2) {
    if (j + 1 < j1) load(j + 1, xb);
    quad_mma<NT>(acc, xa, tq + (size_t)(j - j0) * NT * 32, lane);
    if (j + 1 < j1) {
      if (j + 2 < j1) load(j + 2, xa);
      quad_mma<NT>(acc, xb, tq + (size_t)(j + 1 - j0) * NT * 32, lane);
    }
  }
}

// Dynamic shared memory: the table chunk of every type, the onsite table,
// the Gram staging, two of each (this tile's and the next one's) cols,
// types and onsite types, and the next tile's index.
template <int D>
size_t smem_fixed(int nto, int nslots, bool onsite, bool gram) {
  using W = Width<D>;
  const size_t quad = (size_t)W::NT * 32 * sizeof(double2);
  return (onsite ? (size_t)nto * nquads(D) * quad : 0) +
         (gram ? (size_t)W::RT * W::GC * D * sizeof(double2) : 0) +
         2 * (size_t)W::RT * (nslots + 2) * sizeof(int) + sizeof(int);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    block_step_kernel(const double2* __restrict__ tab,
                      const int* __restrict__ iz,
                      const int* __restrict__ cols,
                      const double2* __restrict__ x,
                      const double2* __restrict__ onsite,
                      const int* __restrict__ izo,
                      const double2* __restrict__ p,
                      const double2* __restrict__ add,
                      double2* __restrict__ y, double2* __restrict__ gram,
                      const double2* __restrict__ tabl,
                      const int* __restrict__ izl,
                      const double2* __restrict__ onl,
                      const int* __restrict__ izol,
                      int* __restrict__ counter, int ntype, int nto,
                      int ntypel, int ntol, int nlt, int nslots, int kk,
                      int nout, int C, int cq) {
  constexpr int RT = Width<D>::RT, NT = Width<D>::NT, GC = Width<D>::GC;
  constexpr int FRAG = NT * 32;  // double2 of one quad's fragments
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nqs = nquads(D * nslots), nqo = nquads(D);
  const int nchunk = (nqs + cq - 1) / cq;
  double2* tabsh = reinterpret_cast<double2*>(smem_raw);
  double2* onsh = tabsh + (size_t)ntype * cq * FRAG;
  double2* sg = onsh + (onsite ? (size_t)nto * nqo * FRAG : 0);
  int* cols2 = reinterpret_cast<int*>(sg + (gram ? RT * GC * D : 0));
  int* ty2 = cols2 + 2 * RT * nslots;  // [2][RT]
  int* tyo2 = ty2 + 2 * RT;            // [2][RT]
  int& next_tile = tyo2[2 * RT];       // the tile after this one

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int R = C / D;
  const int nrt = (nout + RT - 1) / RT;
  const int ntiles = nrt * R;

  // quads [j0, j0 + cq) of every type's table into shared memory
  auto load_chunk = [&](int j0) {
    const int n = min(cq, nqs - j0) * FRAG;
    for (int ty = 0; ty < ntype; ++ty) {
      const double2* src = tab + ((size_t)ty * nqs + j0) * FRAG;
      double2* dst = tabsh + (size_t)ty * cq * FRAG;
      for (int i = tid; i < n; i += blockDim.x) dst[i] = src[i];
    }
  };
  if (onsite != nullptr)
    for (int i = tid; i < nto * nqo * FRAG; i += blockDim.x)
      onsh[i] = onsite[i];
  if (nchunk == 1) load_chunk(0);

  // copy tile tl's cols and types into buffer buf; rows past kk are
  // zero-filled and never read
  auto stage = [&](int tl, int buf) {
    const int r0 = (tl % nrt) * RT;
    const bool lc = tl % nrt < nlt;
    const int* tys = lc ? izl : iz;
    const int* tyos = lc ? izol : izo;
    const int nr = max(0, min(RT, kk - r0)), n = nr * nslots;
    int* cb = cols2 + buf * RT * nslots;
    for (int i = tid; i < RT * nslots; i += blockDim.x)
      cp_async4(cb + i, i < n ? cols + (size_t)r0 * nslots + i : cols,
                i < n ? 4 : 0);
    for (int i = tid; i < RT; i += blockDim.x) {
      cp_async4(ty2 + buf * RT + i, i < nr ? tys + r0 + i : tys,
                i < nr ? 4 : 0);
      if (onsite != nullptr)
        cp_async4(tyo2 + buf * RT + i, i < nr ? tyos + r0 + i : tyos,
                  i < nr ? 4 : 0);
    }
  };
  stage(blockIdx.x, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  int cur = 0;
  for (int tile = blockIdx.x, next; tile < ntiles; tile = next, cur ^= 1) {
    if (tid == 0) next_tile = gridDim.x + atomicAdd(counter, 1);
    __syncthreads();
    next = next_tile;
    // the next tile's cols land while this one is multiplied
    if (next < ntiles) stage(next, cur ^ 1);
    cp_async_commit();
    const int* colsh = cols2 + cur * RT * nslots;
    const int* tysh = ty2 + cur * RT;
    const int* tyosh = tyo2 + cur * RT;
    const int rt = tile % nrt, r = tile / nrt;
    const int row0 = rt * RT, c0 = r * D;
    const bool local = rt < nlt;  // block-uniform

    // the lane's pairs: pair 16 warp + 8 k + g
    int pr[NX], pc[NX];
    bool live[NX];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const int pair = 16 * warp + 8 * k + g;
      pr[k] = pair / D;
      pc[k] = pair - pr[k] * D;
      live[k] = row0 + pr[k] < kk;
    }
    // acc[nt][2k], [2k + 1]: y[row, a = 4 nt + t, c] of pair k
    double acc[NT][4];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const size_t base = (size_t)(row0 + pr[k]) * D * C + c0 + pc[k];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int a = 4 * nt + t;
        double2 v = make_double2(0.0, 0.0);
        if (add != nullptr && live[k] && a < D) v = add[base + (size_t)a * C];
        acc[nt][2 * k] = v.x;
        acc[nt][2 * k + 1] = v.y;
      }
    }

    bool mine[NX];
    // which pairs of the lane take type ty of types[]; false if no lane
    // of the warp does
    auto select = [&](const int* types, int ty) {
      bool any = false;
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        mine[k] = live[k] && types[pr[k]] == ty;
        any |= mine[k];
      }
      return __any_sync(FULL, any);
    };
    // the lane's input k of slot quad j, or nullptr where it is zero
    auto slot_src = [&](int j, int k) -> const double2* {
      const int q = QUAD * j + t;
      if (!mine[k] || q >= D * nslots) return nullptr;
      const int m = q / D, b = q - D * m;
      const int col = colsh[pr[k] * nslots + m];
      if (col >= kk) return nullptr;
      return x + ((size_t)col * D + b) * C + c0 + pc[k];
    };
    auto onsite_src = [&](int j, int k) -> const double2* {
      const int q = QUAD * j + t;
      if (!mine[k] || q >= D) return nullptr;
      return p + ((size_t)(row0 + pr[k]) * D + q) * C + c0 + pc[k];
    };
    if (local) {
      for (int ty = 0; ty < ntypel; ++ty)
        if (select(tysh, ty))
          run_quads<NT>(acc, 0, nqs, slot_src, tabl + (size_t)ty * nqs * FRAG,
                        lane);
      if (onsite != nullptr)
        for (int to = 0; to < ntol; ++to)
          if (select(tyosh, to))
            run_quads<NT>(acc, 0, nqo, onsite_src,
                          onl + (size_t)to * nqo * FRAG, lane);
    } else {
      for (int j0 = 0; j0 < nqs; j0 += cq) {
        if (nchunk > 1) {  // block-uniform
          __syncthreads();
          load_chunk(j0);
          __syncthreads();
        }
        const int j1 = min(nqs, j0 + cq);
        for (int ty = 0; ty < ntype; ++ty)
          if (select(tysh, ty))
            run_quads<NT>(acc, j0, j1, slot_src,
                          tabsh + (size_t)ty * cq * FRAG, lane);
      }
      if (onsite != nullptr)
        for (int to = 0; to < nto; ++to)
          if (select(tyosh, to))
            run_quads<NT>(acc, 0, nqo, onsite_src,
                          onsh + (size_t)to * nqo * FRAG, lane);
    }

#pragma unroll
    for (int k = 0; k < NX; ++k) {
      if (row0 + pr[k] >= nout) continue;
      const size_t base = (size_t)(row0 + pr[k]) * D * C + c0 + pc[k];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int a = 4 * nt + t;
        if (a < D)
          y[base + (size_t)a * C] =
              make_double2(acc[nt][2 * k], acc[nt][2 * k + 1]);
      }
    }

    if (gram != nullptr) {  // block-uniform
      for (int a0 = 0; a0 < D; a0 += GC) {
        for (int kq = 0; kq < GC; ++kq) {
#pragma unroll
          for (int k = 0; k < NX; ++k) {
            // conj(p[i, b, rD + a]) y[i, b, c] over the lane's b
            double2 s = make_double2(0.0, 0.0);
            if (live[k]) {
              const double2* pa =
                  p + (size_t)(row0 + pr[k]) * D * C + c0 + a0 + kq;
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                const int b = 4 * nt + t;
                if (b < D) {
                  const double2 pv = __ldg(pa + (size_t)b * C);
                  const double yr = acc[nt][2 * k];
                  const double yi = acc[nt][2 * k + 1];
                  s.x = fma(pv.x, yr, s.x);
                  s.x = fma(pv.y, yi, s.x);
                  s.y = fma(pv.x, yi, s.y);
                  s.y = fma(-pv.y, yr, s.y);
                }
              }
            }
            s.x += __shfl_xor_sync(FULL, s.x, 1);
            s.y += __shfl_xor_sync(FULL, s.y, 1);
            s.x += __shfl_xor_sync(FULL, s.x, 2);
            s.y += __shfl_xor_sync(FULL, s.y, 2);
            if (t == 0) sg[(pr[k] * GC + kq) * D + pc[k]] = s;
          }
        }
        __syncthreads();
        for (int o = tid; o < GC * D; o += blockDim.x) {
          double2 s = make_double2(0.0, 0.0);
          for (int q = 0; q < RT; ++q) {  // the tile's rows in order
            const double2 v = sg[q * GC * D + o];
            s.x += v.x;
            s.y += v.y;
          }
          const int kq = o / D, c = o - kq * D;
          gram[(((size_t)rt * R + r) * D + a0 + kq) * D + c] = s;
        }
        __syncthreads();
      }
    }
    cp_async_wait_all();  // the next tile's cols
    __syncthreads();
  }
  // the last block out sets the counters back to 0 for the next launch
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(counter + 1, 1) == (int)gridDim.x - 1) {
      counter[0] = 0;
      counter[1] = 0;
      __threadfence();
    }
  }
}

// Slot quads per chunk: all of them if every type's table fits beside the
// fixed buffers, else equal chunks that do.  0 if one quad does not fit.
template <int D>
int chunk_quads(int ntype, int nto, int nslots, bool onsite, bool gram,
                int optin) {
  const size_t quad = (size_t)Width<D>::NT * 32 * sizeof(double2);
  const size_t fixed = smem_fixed<D>(nto, nslots, onsite, gram);
  const int nqs = nquads(D * nslots);
  if (fixed + ntype * quad > (size_t)optin) return 0;
  if (ntype == 0) return nqs;  // every row in the local zone
  int cq = (int)((optin - fixed) / (ntype * quad));
  if (cq >= nqs) return nqs;
  const int nchunk = (nqs + cq - 1) / cq;
  return (nqs + nchunk - 1) / nchunk;
}

int smem_optin(cudaError_t& err) {
  int dev = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? optin : 0;
}

template <int D>
int launch(const void* tab, const void* iz, const void* cols, const void* x,
           const void* onsite, const void* izo, const void* p,
           const void* add, void* y, void* gram, const void* tabl,
           const void* izl, const void* onl, const void* izol, void* counter,
           int ntype, int nto, int ntypel, int ntol, int nl, int nslots,
           int kk, int pad, int C, void* stream) {
  constexpr int RT = Width<D>::RT;
  cudaError_t err;
  const int optin = smem_optin(err);
  if (optin == 0) return (int)err;
  const bool on = onsite != nullptr, gr = gram != nullptr;
  const int cq = chunk_quads<D>(ntype, nto, nslots, on, gr, optin);
  if (cq == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_fixed<D>(nto, nslots, on, gr) +
                      (size_t)ntype * cq * Width<D>::NT * 32 * sizeof(double2);
  if (nl % RT) return (int)cudaErrorInvalidValue;
  const int nout = kk + pad;
  const int ntiles = ((nout + RT - 1) / RT) * (C / D);
  auto kernel = block_step_kernel<D>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  const int grid = nsm * per_sm < ntiles ? nsm * per_sm : ntiles;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const double2*)tab, (const int*)iz, (const int*)cols,
      (const double2*)x, (const double2*)onsite, (const int*)izo,
      (const double2*)p, (const double2*)add, (double2*)y, (double2*)gram,
      (const double2*)tabl, (const int*)izl, (const double2*)onl,
      (const int*)izol, (int*)counter, ntype, nto, ntypel, ntol, nl / RT,
      nslots, kk, nout, C, cq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4.  tab and onsite are packed tables; onsite/izo, p, add and gram may
// be null as the layout notes say; C must be a multiple of d.  The first
// nl rows (a multiple of the tile's rows, 0 without a local zone) take
// the packed tables tabl and onl with the indices izl and izol.  counter
// is two ints, 0 before the launch and left 0 by it.  Returns the
// cudaError_t of the set-up calls or of the launch.
int block_step(int d, const void* tab, const void* iz, const void* cols,
               const void* x, const void* onsite, const void* izo,
               const void* p, const void* add, void* y, void* gram,
               const void* tabl, const void* izl, const void* onl,
               const void* izol, void* counter, int ntype, int nto,
               int ntypel, int ntol, int nl, int nslots, int kk, int pad,
               int C, void* stream) {
  if (d == 9)
    return launch<9>(tab, iz, cols, x, onsite, izo, p, add, y, gram, tabl,
                     izl, onl, izol, counter, ntype, nto, ntypel, ntol, nl,
                     nslots, kk, pad, C, stream);
  if (d == 18)
    return launch<18>(tab, iz, cols, x, onsite, izo, p, add, y, gram, tabl,
                      izl, onl, izol, counter, ntype, nto, ntypel, ntol, nl,
                      nslots, kk, pad, C, stream);
  return (int)cudaErrorInvalidValue;
}

// Chunks of slot quads a launch of this shape walks (1: the whole table
// stays in shared memory), or -1 if one quad of every type does not fit.
int block_step_chunks(int d, int ntype, int nto, int nslots, int onsite,
                      int gram) {
  cudaError_t err;
  const int optin = smem_optin(err);
  if (optin == 0) return -1;
  int cq = 0, nqs = nquads(d * nslots);
  if (d == 9)
    cq = chunk_quads<9>(ntype, nto, nslots, onsite, gram, optin);
  else if (d == 18)
    cq = chunk_quads<18>(ntype, nto, nslots, onsite, gram, optin);
  return cq == 0 ? -1 : (nqs + cq - 1) / cq;
}

int block_step_tile_pairs() { return TILE_PAIRS; }

}  // extern "C"
