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
//   haydock_update_norm  K3': one step of the recursion with its
//                      normalisation deferred, u' = v / b - (a / b) u -
//                      (b / b_prev) w written over w, the step's a, and
//                      |u'|^2 finished in the launch, with its row-block
//                      partials; or the generalised update alpha v +
//                      beta u + gamma w (replaces pallas_conv.py
//                      _update_kernel / lanczos_update_pallas, which is
//                      (1, -a, 1) of it, and the normalisation the JAX
//                      loop runs after it)
//
// Layouts (all C-contiguous):
//   tab   (ntype, nquad, 3, 32) double2      realified type table, packed
//                                            by haydock_kernels.pack_table
//   iz    (kk,) int32                        type per row
//   cols  (kk, nslots) int32                 neighbour rows, sentinel nx
//   psi   (nx+1, 9, C) complex128            row nx is all zero; nx >= kk
//                                            (a row slab: kk own rows,
//                                            then its halo rows)
//   y, v  (kk, 9, C) complex128
//   u, w  (>= kk rows, 9, C) complex128       K3' reads the first kk rows
//   partials (nrowblk, C) float64, nrowblk = ceil(kk / ROWS_PER_BLOCK)
//   a     (C,) float64                       finished dot of K2'
//
// The SpMVs as a GEMM on the FP64 tensor cores.  Each (row, chain) pair is
// one GEMM row.  Its K axis is every complex input it sums: the 9 orbitals
// of each of the nslots neighbour rows, 135 at nslots = 15, in slot
// order, grouped in quads of 4 (34 quads, the last one padded with a
// zero).  One quad is one mma.sync.m16n8k8.f64: k = 0..3 take the real
// parts of the quad's 4 inputs, k = 4..7 their imaginary parts, so a lane
// that holds one gathered double2 feeds both halves.  The N axis is the 18
// real outputs (9 orbitals x re/im), padded to three n8 tiles.  The table
// holds the realified 9x9 blocks [[Hr, -Hi], [Hi, Hr]] already cut into
// B fragments, so the inner loop reads one 16-byte word of shared memory
// per n-tile and quad.  Useful work is 135*18 / (136*24) = 74 % of the
// tensor-core work.  (On an H100 m8n8k4.f64 runs at half the f64 tensor
// rate, 33 TFLOP/s; m16n8k4, k8 and k16 at 65-67.)
//
// Mapping: a tile is ROWS_PER_BLOCK rows x ct chains (ct <= 16, the chains
// split into equal tiles); its 32 ct pairs, pair p = row * ct + chain, go
// to warps of 16 MT pairs, MT m16 tiles each: K1' MT = 1 (1024 threads a
// block at ct = 16), K2' MT = 2 (512).  A pair's outputs depend only on
// its own row of the MMA, so both give the same bits.  The grid is
// persistent: each block copies the table into shared memory once and
// walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...; tile t is row
// block t % nrt of chain tile t / nrt, so the blocks in flight cover
// neighbouring rows and share their neighbours in L2.  The next tile's
// cols land by cp.async while the current one is multiplied, so a tile
// costs one block barrier.  A row tile whose rows mix types is run once
// per type present, with the other types' inputs zeroed: ntype passes on
// such tiles, one pass on single-type tiles (every tile of the bcc bench
// shape).  The sentinel column kk is read as zero without a load.
//
// K1' loads each lane's gathered double2 of the next quad into registers
// while the tensor cores multiply the current one.  K2' instead keeps
// PIPE_STAGES quads in flight per warp through 16-byte cp.async copies
// (zero-filled where masked) into its own ring in shared memory; a lane
// reads back only what it copied, so cp.async.wait_group orders the ring
// with no block barrier.  Both multiply through one device function,
// quad_mma, in the same order, so K2's y equals K1's bit for bit.
//
// What bounds them on an H100 80GB HBM3 (700 W; chip_smoke.py phase 2 at
// the bcc bench shape, kk = 27000, 15 slots): at C = 144 K1' takes about
// 2.0 ms.  Its gathers alone (the same kernel with the MMAs left out)
// take 1.3 ms, its MMAs alone 1.2 ms, against 0.76 ms of padded DMMA work
// at the 67 TFLOP/s peak.  With every column the row itself (every gather
// an L1 hit) it takes no less, so the L2 traffic of the gathers (7.96 GB
// at C = 144 against 1.12 GB of unique traffic) is not what holds it: the
// load and multiply halves overlap little, and each runs about 1.6 times
// its floor.  At C = 9 (0.16 ms) a block holds 18 warps and the 844 tiles
// come to 6.4 per SM, so latency and the last round's tail weigh most.
// K3' reads three and writes one complex array per element: it is bound
// by memory bandwidth.  It keeps the chain unnormalised, u_n = b_n psi_n,
// so the step needs no pass after it: the recursion
//   u_{n+1} = y_n / b_n - (a_n / b_n) u_n - (b_n / b_{n-1}) u_{n-1},
//   y_n = H u_n,  a_n = Re<u_n|y_n> / b_n^2,  b_{n+1}^2 = |u_{n+1}|^2
// reads y_n, u_n and u_{n-1}, writes u_{n+1} over u_{n-1}, and takes the
// chain's scalars from device memory (the SpMVs are linear, so their dot
// on u_n is the raw Re<u_n|y_n>).  Its grid is sized from the element
// count and the SM count (ops/haydock_kernels.py update_plan), so that a
// 512-row prefix fills the card as a 27 000-row cluster does.
//
// Reductions: the four lanes that hold one pair's outputs add their parts
// of Re<psi|y> with two xor shuffles; the block adds each chain's 32 rows
// in row order.  K1' stops there and the caller folds the row blocks.
// K2' and K3' finish the sum over row blocks themselves: each block
// fences and takes a ticket from an int counter; the block that takes the
// last ticket adds the partials in index order (K2': equal contiguous
// runs, then the runs in order; K3': runs of ceil(sqrt(nrowblk)) row
// blocks, then the runs in order, which haydock_kernels.fold_norm
// repeats), writes the sum, and sets the counter back to 0 for the next
// launch.  There are no floating-point atomics, so reruns are
// bit-identical.

#include <cuda_runtime.h>

namespace {

constexpr int NORB = 9;
constexpr int ROWS_PER_BLOCK = 32;  // = haydock_kernels.ROWS_PER_BLOCK
constexpr int QUAD = 4;             // complex inputs per k8 step
constexpr int NTILE = 3;            // n8 tiles over the 18 real outputs
constexpr int SPMV_CHAIN_TILE = 16;  // chains per tile at most
constexpr int K1_MT = 1;  // m16 tiles per warp of K1' (1024 threads a block)
constexpr int K2_MT = 2;  // m16 tiles per warp of K2' (512 threads a block)
constexpr int PIPE_STAGES = 3;
constexpr int UPD_PIECE = 2;    // update_norm: rows a piece
constexpr int UPD_PIECE_ELEMS = NORB * UPD_PIECE;   // (row, orbital) pairs
constexpr int UPD_PIECES = ROWS_PER_BLOCK / UPD_PIECE;  // pieces a row block
constexpr int UPD_THREADS = 288;  // update_norm: threads a block at most
constexpr int UPD_BATCH = 2;      // update_norm: elements loaded at once

__device__ __forceinline__ void dmma_m16n8k8(double (&d)[4], double a0,
                                             double a1, double a2, double a3,
                                             double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// One quad of the warp's MT m16 tiles.  x[2i + h] is the lane's gathered
// input of pair 16 i + 8 h + (lane >> 2); bq the quad's table fragments.
// Each pair's outputs depend only on its own inputs, so a pair gets the
// same bits whatever MT its kernel runs with.
template <int MT>
__device__ __forceinline__ void quad_mma(double (&acc)[MT][NTILE][4],
                                         const double2 (&x)[2 * MT],
                                         const double2* bq, int lane) {
#pragma unroll
  for (int nt = 0; nt < NTILE; ++nt) {
    const double2 b = bq[nt * 32 + lane];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      dmma_m16n8k8(acc[i][nt], x[2 * i].x, x[2 * i + 1].x, x[2 * i].y,
                   x[2 * i + 1].y, b.x, b.y);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ int nquads(int nslots) {
  return (NORB * nslots + QUAD - 1) / QUAD;
}

// Warps of a block: the tile's 32 ct pairs, 16 MT to a warp (whole warps
// for any ct, since MT is 1 or 2).
constexpr __host__ __device__ int spmv_warps(int mt, int ct) {
  return 2 * ct / mt;
}

// Chains per tile: the chains split into equal tiles of at most
// SPMV_CHAIN_TILE.
int chain_tile(int C) {
  const int nct = (C + SPMV_CHAIN_TILE - 1) / SPMV_CHAIN_TILE;
  return (C + nct - 1) / nct;
}

// Dynamic shared memory of an SpMV: the table; K2's rings; two of each
// (this tile's and the next one's) chain partials, cols and types.
size_t spmv_smem(bool pipelined, int ntype, int nslots, int C) {
  const int ct = chain_tile(C);
  return (size_t)ntype * nquads(nslots) * NTILE * 32 * sizeof(double2) +
         (pipelined ? (size_t)spmv_warps(K2_MT, ct) * PIPE_STAGES * 2 *
                          K2_MT * 32 * sizeof(double2)
                    : 0) +
         2 * (size_t)ROWS_PER_BLOCK * ct * sizeof(double) +
         2 * (size_t)ROWS_PER_BLOCK * (nslots + 1) * sizeof(int);
}

// What spmv_tiles runs: the two SpMVs, and two measurement passes of K1'
// that leave out one half of its work (chip_smoke.py times them).
enum Mode { K1 = 0, K2 = 1, GATHER_ONLY = 2, MMA_ONLY = 3 };

// Both SpMVs.  Writes y and the row-block partials of Re<psi|y>.
template <int MODE, int MT>
__device__ __forceinline__ void spmv_tiles(
    const double2* __restrict__ tab, const int* __restrict__ iz,
    const int* __restrict__ cols, const double2* __restrict__ psi,
    double2* __restrict__ y, double* __restrict__ part, int ntype,
    int nslots, int kk, int nx, int C, int ct, double*& scratch) {
  constexpr bool PIPE = MODE == K2;
  constexpr int NX = 2 * MT;  // pairs (gathered inputs) per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nquad = nquads(nslots);
  const int tabn = ntype * nquad * NTILE * 32;
  double2* tabsh = reinterpret_cast<double2*>(smem_raw);
  double2* ring = tabsh + tabn;  // K2': [warp][stage][NX][32]
  double* contrib2 = reinterpret_cast<double*>(
      ring + (PIPE ? spmv_warps(MT, ct) * PIPE_STAGES * NX * 32 : 0));
  int* cols2 = reinterpret_cast<int*>(contrib2 + 2 * ROWS_PER_BLOCK * ct);
  int* ty2 = cols2 + 2 * ROWS_PER_BLOCK * nslots;  // [2][32]
  scratch = contrib2;  // [2][32][ct]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < tabn; i += blockDim.x) tabsh[i] = tab[i];

  const int nq9 = NORB * nslots;
  const int nrt = (kk + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const int ntiles = nrt * ((C + ct - 1) / ct);
  // copy tile tl's cols and types into buffer buf; rows past kk are
  // zero-filled and never read
  auto stage = [&](int tl, int buf) {
    const int r0 = (tl % nrt) * ROWS_PER_BLOCK;
    const int nr = min(ROWS_PER_BLOCK, kk - r0), n = nr * nslots;
    int* cb = cols2 + buf * ROWS_PER_BLOCK * nslots;
    for (int i = tid; i < ROWS_PER_BLOCK * nslots; i += blockDim.x)
      cp_async4(cb + i, i < n ? cols + (size_t)r0 * nslots + i : cols,
                i < n ? 4 : 0);
    for (int i = tid; i < ROWS_PER_BLOCK; i += blockDim.x)
      cp_async4(ty2 + buf * ROWS_PER_BLOCK + i, i < nr ? iz + r0 + i : iz,
                i < nr ? 4 : 0);
  };
  stage(blockIdx.x, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  int cur = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, cur ^= 1) {
    // the next tile's cols land while this one is multiplied
    if (tile + (int)gridDim.x < ntiles) stage(tile + gridDim.x, cur ^ 1);
    cp_async_commit();
    const int* colsh = cols2 + cur * ROWS_PER_BLOCK * nslots;
    const int* tysh = ty2 + cur * ROWS_PER_BLOCK;
    double* contrib = contrib2 + cur * ROWS_PER_BLOCK * ct;
    const int rt = tile % nrt;
    const int row0 = rt * ROWS_PER_BLOCK, c0 = (tile / nrt) * ct;
    const int nrow = min(ROWS_PER_BLOCK, kk - row0);

    // the lane's pairs: pair 16 MT warp + 16 (k >> 1) + 8 (k & 1) + g
    int pr[NX], pc[NX];
    bool pok[NX];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const int p = 16 * MT * warp + 16 * (k >> 1) + 8 * (k & 1) + g;
      pr[k] = p / ct;
      pc[k] = p - pr[k] * ct;
      pok[k] = pr[k] < nrow && c0 + pc[k] < C;
    }
    double acc[MT][NTILE][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int nt = 0; nt < NTILE; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.0;

    for (int ty = 0; ty < ntype; ++ty) {
      bool mine[NX], any = false;
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        mine[k] = pok[k] && tysh[pr[k]] == ty;
        any |= mine[k];
      }
      if (!__any_sync(0xffffffffu, any)) continue;
      const double2* tq = tabsh + (size_t)ty * nquad * NTILE * 32;
      // source of the lane's input k of quad j; nullptr where it is zero
      // (masked, padding, or the sentinel row nx)
      auto src = [&](int j, int k) -> const double2* {
        const int q = QUAD * j + t;
        if (!mine[k] || q >= nq9) return nullptr;
        const int m = q / NORB, b = q - NORB * m;
        const int col = colsh[pr[k] * nslots + m];
        if (col == nx) return nullptr;
        return psi + ((size_t)col * NORB + b) * C + c0 + pc[k];
      };
      if constexpr (PIPE) {
        double2* myring = ring + (size_t)warp * PIPE_STAGES * NX * 32 + lane;
        // fetch quad j into stage j % PIPE_STAGES; one commit group per
        // quad (empty past the end, so wait_group's count stays exact)
        auto fetch = [&](int j) {
          if (j < nquad) {
            double2* dst = myring + (j % PIPE_STAGES) * NX * 32;
#pragma unroll
            for (int k = 0; k < NX; ++k) {
              const double2* s = src(j, k);
              cp_async16(dst + k * 32, s ? s : psi, s ? 16 : 0);
            }
          }
          cp_async_commit();
        };
#pragma unroll
        for (int s = 0; s < PIPE_STAGES - 1; ++s) fetch(s);
        for (int j = 0; j < nquad; ++j) {
          fetch(j + PIPE_STAGES - 1);
          cp_async_wait<PIPE_STAGES - 1>();  // quad j has landed
          const double2* st = myring + (j % PIPE_STAGES) * NX * 32;
          double2 x[NX];
#pragma unroll
          for (int k = 0; k < NX; ++k) x[k] = st[k * 32];
          quad_mma<MT>(acc, x, tq + (size_t)j * NTILE * 32, lane);
        }
        cp_async_wait<0>();
      } else {
        auto load = [&](int j, double2 (&x)[NX]) {
#pragma unroll
          for (int k = 0; k < NX; ++k) {
            if constexpr (MODE == MMA_ONLY) {
              x[k] = make_double2(mine[k] ? 1.0 : 0.0, 0.5);
            } else {
              const double2* s = src(j, k);
              x[k] = s ? __ldg(s) : make_double2(0.0, 0.0);
            }
          }
        };
        auto step = [&](int j, const double2 (&x)[NX]) {
          if constexpr (MODE == GATHER_ONLY) {
#pragma unroll
            for (int k = 0; k < NX; ++k) {
              acc[k >> 1][0][2 * (k & 1)] += x[k].x;
              acc[k >> 1][0][2 * (k & 1) + 1] += x[k].y;
            }
          } else {
            quad_mma<MT>(acc, x, tq + (size_t)j * NTILE * 32, lane);
          }
        };
        // the next quad's inputs load while this one is multiplied
        double2 xa[NX], xb[NX];
        load(0, xa);
        for (int j = 0; j < nquad; j += 2) {
          if (j + 1 < nquad) load(j + 1, xb);
          step(j, xa);
          if (j + 1 < nquad) {
            if (j + 2 < nquad) load(j + 2, xa);
            step(j + 1, xb);
          }
        }
      }
    }

    // y, and each pair's Re<psi|y>: lane t holds orbitals t, 4 + t, 8 + t
    double s[NX];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const int i = k >> 1, h = k & 1;
      s[k] = 0.0;
      if (pok[k]) {
        const size_t base =
            (size_t)(row0 + pr[k]) * NORB * C + c0 + pc[k];
#pragma unroll
        for (int nt = 0; nt < NTILE; ++nt) {
          const int a = 4 * nt + t;
          if (a < NORB) {
            const double2 v =
                make_double2(acc[i][nt][2 * h], acc[i][nt][2 * h + 1]);
            y[base + (size_t)a * C] = v;
            const double2 p = psi[base + (size_t)a * C];
            s[k] = fma(p.x, v.x, s[k]);
            s[k] = fma(p.y, v.y, s[k]);
          }
        }
      }
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], 1);
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], 2);
    }
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < NX; ++k) contrib[pr[k] * ct + pc[k]] = s[k];
    }
    cp_async_wait<0>();  // the next tile's cols
    __syncthreads();
    if (tid < ct && c0 + tid < C) {
      double sum = 0.0;
      for (int r = 0; r < ROWS_PER_BLOCK; ++r) sum += contrib[r * ct + tid];
      part[(size_t)rt * C + c0 + tid] = sum;
    }
  }
}

constexpr int K1_THREADS = 32 * spmv_warps(K1_MT, SPMV_CHAIN_TILE);
constexpr int K2_THREADS = 32 * spmv_warps(K2_MT, SPMV_CHAIN_TILE);

__global__ void __launch_bounds__(K1_THREADS, 1)
    spmv_dot_kernel(const double2* __restrict__ tab, const int* __restrict__ iz,
                    const int* __restrict__ cols,
                    const double2* __restrict__ psi, double2* __restrict__ y,
                    double* __restrict__ apart, int ntype, int nslots,
                    int kk, int nx, int C, int ct) {
  double* scratch;
  spmv_tiles<K1, K1_MT>(tab, iz, cols, psi, y, apart, ntype, nslots,
                        kk, nx, C, ct, scratch);
}

// K1' with one half of its work left out (MODE GATHER_ONLY or MMA_ONLY),
// for measurement only.
template <int MODE>
__global__ void __launch_bounds__(K1_THREADS, 1)
    spmv_half_kernel(const double2* __restrict__ tab,
                     const int* __restrict__ iz,
                     const int* __restrict__ cols,
                     const double2* __restrict__ psi, double2* __restrict__ y,
                     double* __restrict__ apart, int ntype, int nslots,
                     int kk, int nx, int C, int ct) {
  double* scratch;
  spmv_tiles<MODE, K1_MT>(tab, iz, cols, psi, y, apart, ntype, nslots,
                          kk, nx, C, ct, scratch);
}

__global__ void __launch_bounds__(K2_THREADS, 1)
    spmv_dot_pipelined_kernel(
        const double2* __restrict__ tab, const int* __restrict__ iz,
        const int* __restrict__ cols,
        const double2* __restrict__ psi, double2* __restrict__ y,
        double* __restrict__ bpart, int* __restrict__ counter,
        double* __restrict__ a, int ntype, int nslots, int kk, int nx,
        int C, int ct) {
  __shared__ int last;
  double* red;
  spmv_tiles<K2, K2_MT>(tab, iz, cols, psi, y, bpart, ntype, nslots,
                        kk, nx, C, ct, red);

  // the last block to finish adds the row-block partials
  __threadfence();
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid == 0) last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  const int nblk = (kk + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const int nred = 2 * ROWS_PER_BLOCK * ct;  // the size of red
  const int nrun = C >= nred ? 1 : nred / C;
  const int len = (nblk + nrun - 1) / nrun;
  for (int i = tid; i < nrun * C; i += blockDim.x) {
    const int run = i / C, c = i - run * C;
    const int j1 = min(nblk, (run + 1) * len);
    double s = 0.0;
    for (int j = run * len; j < j1; ++j) s += __ldcg(bpart + (size_t)j * C + c);
    if (nrun == 1)
      a[c] = s;
    else
      red[i] = s;
  }
  if (nrun > 1) {
    __syncthreads();
    for (int c = tid; c < C; c += blockDim.x) {
      double s = 0.0;
      for (int run = 0; run < nrun; ++run) s += red[run * C + c];
      a[c] = s;
    }
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

// K3': one step of the recursion with its normalisation deferred, or the
// generalised update, in one launch:
//
//   out = alpha v + beta u + gamma w   per chain, written over w
//
// with (alpha, beta, gamma) given (deferred = 0), or (deferred = 1) made
// from the chain's raw dot r = Re<u|v>, b2 = |u|^2 and b2p, the norm
// before it:  a = r / b2,  alpha = 1 / sqrt(b2),  beta = -a / sqrt(b2),
// gamma = -sqrt(b2) / sqrt(b2p), and a written to a_out.  Then |out|^2:
// per-piece partials, per-row-block partials (part) and, from the block
// that takes the last ticket, their fixed-order sum (b2_out).
//
// Mapping: the (row, orbital, chain) elements are contiguous with the
// chain fastest.  A block takes `rows` rows (a whole number of pieces of
// UPD_PIECE rows, at most one row block) of one chain tile of ct chains
// with KR threads per chain, thread t = k ct + q on chain c0 + q: so
// consecutive lanes read consecutive 16-byte words, and a thread's
// elements, (row, orbital) pairs k, k + KR, ... of each piece, share its
// chain.  A thread's sum over a piece's elements in order, then the KR
// threads' sums in k order, give the piece partial; the 16 pieces in
// order give the row-block partial.  That order does not depend on
// `rows`, so a row block gives the same bits whatever the grid (a row
// slab's partials are the single rank's).  A block of fewer rows than a
// row block stores its piece partials; the last of its row block's
// blocks (a ticket per row block) adds the 16 in order.  The sum over
// row blocks is ticketed the same way, a level at a time: the last row
// block of each run of runlen adds the run, the last run adds the runs,
// so the launch's tail is one run's and one chain's loads.
template <int KR>
__global__ void __launch_bounds__(UPD_THREADS) update_norm_kernel(
    int deferred, const double* __restrict__ s0,
    const double* __restrict__ s1, const double* __restrict__ s2,
    const double2* __restrict__ v, const double2* __restrict__ u,
    double2* __restrict__ w, double* __restrict__ part,
    double* __restrict__ pieces, double* __restrict__ runs,
    double* __restrict__ a_out, double* __restrict__ b2_out,
    int* __restrict__ counter, int kk, int C, int ct, int npc,
    int runlen) {
  constexpr int EPP = UPD_PIECE_ELEMS / KR;  // a thread's elements a piece
  extern __shared__ double red[];            // [npc][KR ct]
  __shared__ int last;
  const int tid = threadIdx.x, nthr = KR * ct;
  const int nct = (C + ct - 1) / ct, bpr = UPD_PIECES / npc;
  const int ctile = blockIdx.x % nct, rest = blockIdx.x / nct;
  const int sub = rest % bpr, rb = rest / bpr;
  const int q = tid % ct, k = tid / ct;
  const int c0 = ctile * ct, c = c0 + q;
  const bool live = c < C;
  const int piece0 = rb * UPD_PIECES + sub * npc;
  const size_t ro_end = (size_t)kk * NORB;

  double al = 0.0, be = 0.0, ga = 0.0;
  if (live) {
    if (deferred) {
      const double b2 = s1[c], an = s0[c] / b2, sb = sqrt(b2);
      al = 1.0 / sb;
      be = -(an / sb);
      ga = -(sb / sqrt(s2[c]));
      if (blockIdx.x < nct && k == 0) a_out[c] = an;
    } else {
      al = s0[c];
      be = s1[c];
      ga = s2[c];
    }
  }

  // UPD_BATCH elements' loads in flight, then their updates
  const int nel = npc * EPP;
  double acc = 0.0;
  for (int e0 = 0; e0 < nel; e0 += UPD_BATCH) {
    double2 xv[UPD_BATCH], xu[UPD_BATCH], xw[UPD_BATCH];
    size_t idx[UPD_BATCH];
    bool ok[UPD_BATCH];
#pragma unroll
    for (int b = 0; b < UPD_BATCH; ++b) {
      const int e = e0 + b, j = e / EPP, m = e - j * EPP;
      const size_t ro =
          (size_t)(piece0 + j) * UPD_PIECE_ELEMS + k + (size_t)m * KR;
      ok[b] = live && e < nel && ro < ro_end;
      idx[b] = ro * C + c;
      if (ok[b]) {
        xv[b] = v[idx[b]];
        xu[b] = u[idx[b]];
        xw[b] = w[idx[b]];
      }
    }
#pragma unroll
    for (int b = 0; b < UPD_BATCH; ++b) {
      const int e = e0 + b;
      if (e >= nel) break;
      if (ok[b]) {  // fma written out: the same bits from any build
        double2 o;
        o.x = fma(ga, xw[b].x, fma(be, xu[b].x, al * xv[b].x));
        o.y = fma(ga, xw[b].y, fma(be, xu[b].y, al * xv[b].y));
        w[idx[b]] = o;
        acc = fma(o.x, o.x, acc);
        acc = fma(o.y, o.y, acc);
      }
      if (e % EPP == EPP - 1) {  // the piece's last element
        red[(e / EPP) * nthr + tid] = acc;
        acc = 0.0;
      }
    }
  }
  __syncthreads();
  // piece partials: each chain's KR thread sums in k order, into slot k = 0
  for (int it = tid; it < npc * ct; it += nthr) {
    const int j = it / ct, qq = it - j * ct;
    double s = 0.0;
    for (int p = 0; p < KR; ++p) s += red[j * nthr + p * ct + qq];
    red[j * nthr + qq] = s;
  }
  __syncthreads();
  if (npc == UPD_PIECES) {  // the whole row block
    if (k == 0 && live) {
      double s = 0.0;
      for (int j = 0; j < UPD_PIECES; ++j) s += red[j * nthr + q];
      part[(size_t)rb * C + c] = s;
    }
  } else {
    for (int it = tid; it < npc * ct; it += nthr) {
      const int j = it / ct, qq = it - j * ct;
      if (c0 + qq < C)
        pieces[(size_t)(piece0 + j) * C + c0 + qq] = red[j * nthr + qq];
    }
    __threadfence();
    __syncthreads();
    int* rbc = counter + 1 + (size_t)rb * nct + ctile;
    if (tid == 0) last = atomicAdd(rbc, 1) == bpr - 1;
    __syncthreads();
    if (!last) return;
    if (k == 0 && live) {
      double s = 0.0;
      for (int j = 0; j < UPD_PIECES; ++j)
        s += __ldcg(pieces + (size_t)(rb * UPD_PIECES + j) * C + c);
      part[(size_t)rb * C + c] = s;
    }
    if (tid == 0) *rbc = 0;  // ready for the next launch
  }

  // the last row block of a run adds the run's row blocks in order; the
  // last run adds the runs in order (haydock_kernels.fold_norm)
  const int nrb = (kk + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const int nrun = (nrb + runlen - 1) / runlen, run = rb / runlen;
  const int j0 = run * runlen, j1 = min(nrb, j0 + runlen);
  int* rnc = counter + 1 + (size_t)(nrb + run) * nct + ctile;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(rnc, 1) == j1 - j0 - 1;
  __syncthreads();
  if (!last) return;
  if (k == 0 && live) {
    double s = 0.0;
#pragma unroll 8
    for (int j = j0; j < j1; ++j) s += __ldcg(part + (size_t)j * C + c);
    runs[(size_t)run * C + c] = s;
  }
  if (tid == 0) *rnc = 0;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1) == nrun * nct - 1;
  __syncthreads();
  if (!last) return;
  for (int cc = tid; cc < C; cc += nthr) {
    double s = 0.0;
#pragma unroll 8
    for (int r = 0; r < nrun; ++r) s += __ldcg(runs + (size_t)r * C + cc);
    b2_out[cc] = s;
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

// Persistent grid of an SpMV: as many blocks as fit on the card at once,
// at most one per tile.  Returns 0 with err set if none fits.
template <typename K>
int spmv_grid(K kernel, int threads, size_t smem, int ntiles,
              cudaError_t& err) {
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return 0;
  int dev = 0, nsm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return 0;
  if (per_sm == 0) {
    err = cudaErrorInvalidConfiguration;
    return 0;
  }
  return nsm * per_sm < ntiles ? nsm * per_sm : ntiles;
}

// K1' or one of its measurement halves.
int launch_k1(int mode, const void* tab, const void* iz,
              const void* cols, const void* psi, void* y, void* apart,
              int ntype, int nslots, int kk, int nx, int C,
              void* stream) {
  const int ct = chain_tile(C);
  const size_t smem = spmv_smem(false, ntype, nslots, C);
  auto kernel = mode == K1            ? spmv_dot_kernel
                : mode == GATHER_ONLY ? spmv_half_kernel<GATHER_ONLY>
                                      : spmv_half_kernel<MMA_ONLY>;
  const int threads = 32 * spmv_warps(K1_MT, ct);
  const int ntiles = ((kk + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK) *
                     ((C + ct - 1) / ct);
  cudaError_t err;
  const int grid = spmv_grid(kernel, threads, smem, ntiles, err);
  if (grid == 0) return (int)err;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const double2*)tab, (const int*)iz, (const int*)cols,
      (const double2*)psi, (double2*)y, (double*)apart, ntype, nslots, kk,
      nx, C, ct);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the set-up calls or of the launch.
int haydock_spmv_dot(const void* tab, const void* iz, const void* cols,
                     const void* psi, void* y, void* apart, int ntype,
                     int nslots, int kk, int nx, int C, void* stream) {
  return launch_k1(K1, tab, iz, cols, psi, y, apart, ntype, nslots, kk, nx,
                   C, stream);
}

// K1' with its gathers (mode 2) or its MMAs (mode 3) only: the same
// grid, tiles, table copy and epilogue, for measurement.  y and apart
// are written but mean nothing.
int haydock_spmv_part(int mode, const void* tab, const void* iz,
                      const void* cols, const void* psi, void* y,
                      void* apart, int ntype, int nslots, int kk, int nx,
                      int C, void* stream) {
  if (mode != GATHER_ONLY && mode != MMA_ONLY)
    return (int)cudaErrorInvalidValue;
  return launch_k1(mode, tab, iz, cols, psi, y, apart, ntype, nslots, kk, nx,
                   C, stream);
}

// K2'.  bpart (nrowblk, C) float64 is scratch; counter is one int that is
// ZERO at launch, and the kernel leaves it zero.
int haydock_spmv_dot_pipelined(const void* tab, const void* iz,
                               const void* cols, const void* psi, void* y,
                               void* a, void* bpart, void* counter, int ntype,
                               int nslots, int kk, int nx, int C,
                               void* stream) {
  const int ct = chain_tile(C);
  const size_t smem = spmv_smem(true, ntype, nslots, C);
  const int threads = 32 * spmv_warps(K2_MT, ct);
  const int ntiles = ((kk + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK) *
                     ((C + ct - 1) / ct);
  cudaError_t err;
  const int grid =
      spmv_grid(spmv_dot_pipelined_kernel, threads, smem, ntiles, err);
  if (grid == 0) return (int)err;
  spmv_dot_pipelined_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const double2*)tab, (const int*)iz, (const int*)cols,
      (const double2*)psi, (double2*)y, (double*)bpart, (int*)counter,
      (double*)a, ntype, nslots, kk, nx, C, ct);
  return (int)cudaGetLastError();
}

// Bytes of dynamic shared memory an SpMV asks for at this shape.
long long haydock_spmv_smem(int pipelined, int ntype, int nslots, int C) {
  return (long long)spmv_smem(pipelined != 0, ntype, nslots, C);
}

// K3' (see update_norm_kernel).  s0, s1, s2 (C,) float64: (alpha, beta,
// gamma), or with deferred (r, b2, b2p) and a_out (C,) written.  v (kk,
// 9, C), u and w (at least kk rows) complex128; w is overwritten.  part
// (nrowblk, C), pieces (nrowblk * 16, C) where rows < ROWS_PER_BLOCK,
// runs (ceil(nrowblk / runlen), C) float64 and b2_out (C,).  counter:
// 1 + (nrowblk + nrun) * ceil(C / ct) ints, nrun = ceil(nrowblk /
// runlen), ZERO at launch, left zero.  A block
// takes `rows` rows (2, 4, 8, 16 or 32) of ct chains with kr threads
// per chain (kr 1, 2 or 3, kr ct <= UPD_THREADS).
int haydock_update_norm(int deferred, const void* s0, const void* s1,
                        const void* s2, const void* v, const void* u,
                        void* w, void* part, void* pieces, void* runs,
                        void* a_out, void* b2_out, void* counter, int kk,
                        int C, int ct, int kr, int rows, int runlen,
                        void* stream) {
  if (kk <= 0 || C <= 0 || ct <= 0 || ct > C || runlen <= 0 ||
      rows < UPD_PIECE || rows > ROWS_PER_BLOCK ||
      ROWS_PER_BLOCK % rows != 0 || kr * ct > UPD_THREADS ||
      (deferred && a_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const int npc = rows / UPD_PIECE;
  const int nrb = (kk + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const int nct = (C + ct - 1) / ct;
  const dim3 grid((unsigned)nrb * (UPD_PIECES / npc) * nct);
  const int threads = kr * ct;
  const size_t smem = (size_t)npc * threads * sizeof(double);
  cudaStream_t st = (cudaStream_t)stream;
#define UPD_ARGS                                                           \
  deferred, (const double*)s0, (const double*)s1, (const double*)s2,      \
      (const double2*)v, (const double2*)u, (double2*)w, (double*)part,   \
      (double*)pieces, (double*)runs, (double*)a_out, (double*)b2_out,    \
      (int*)counter, kk, C, ct, npc, runlen
  switch (kr) {
    case 1:
      update_norm_kernel<1><<<grid, threads, smem, st>>>(UPD_ARGS);
      break;
    case 2:
      update_norm_kernel<2><<<grid, threads, smem, st>>>(UPD_ARGS);
      break;
    case 3:
      update_norm_kernel<3><<<grid, threads, smem, st>>>(UPD_ARGS);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef UPD_ARGS
  return (int)cudaGetLastError();
}

int haydock_rows_per_block() { return ROWS_PER_BLOCK; }

}  // extern "C"
