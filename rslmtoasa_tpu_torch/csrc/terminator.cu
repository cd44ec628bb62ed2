// Hand-written Hopper (sm_90a) kernel for the Beer-Pettifor terminator fits
// of the block recursion's chains.
//
//   bpopt_fit   The Pettifor fit (a_inf, b_inf) of C scalar chains, one
//               thread a chain, and the guards get_terminf applies to the
//               fits of 18 x 18 blocks.  It replaces no Pallas kernel: the
//               JAX package runs these fits in NumPy on the host
//               (rslmtoasa_tpu/ops/terminator.py bpopt / emami), and so
//               did the port (ops/terminator.py bpopt_batch, all chains in
//               lockstep), which stays the plain version.
//
// Layouts (C-contiguous float64):
//   a, rb   (C, lld)   the real parts of a chain's diagonal and off-diagonal
//                      coefficients (rb = sqrt(b^2)); the fit reads the
//                      first n = lld - 1 of each
//   fit     (2, C)     out: a_inf, then b_inf
//   ifail   (C,)       out: 1 where the centring loop ran out of steps
//   sturms  (C,)       out, optional (null in the fits the program runs):
//                      the Sturm counts each chain's fit ran, for measuring
//
// What it computes, step for step as ops/terminator.py bpopt_batch does
// for each lane (bpopt, recursion.f90 :3540-3588): up to 301 centring
// steps, each centring the chain on the current a_inf (0.5 (a_i - a_inf)
// and 0.5 rb_i, the last level a_{n-1} - a_inf and rb_{n-1} / sqrt(2)),
// and each calling emami (:3589-3713), which bisects for the largest and
// then the smallest eigenvalue of the centred tridiagonal matrix with
// Sturm counts, 50 steps at most a phase, from the Gershgorin bounds,
// stopping where |(emax - emin) / mid| <= 1e-6 (mid != 0); a phase that
// runs out of steps returns its current (emax, emin).  a_inf moves by
// emax + emin until |emax + emin| <= 1e-5; b_inf = (emax - emin) / 2.
// With ldim > 0 (C = R ldim^2 chains of R blocks), get_terminf's guards
// follow in the same launch: NaN -> 0, a zero diagonal entry -> 0.5, and
// b_inf of orbitals 0 and 9 times 1.01.
//
// Bit for bit.  The callers' comparisons hold the fits at 1e-9, and one
// Sturm count that flips moves a bisection endpoint by ~1e-6 of the band
// width, so the kernel repeats the NumPy arithmetic operation by
// operation: every operation is a round-to-nearest intrinsic (__dadd_rn,
// __dsub_rn, __dmul_rn, __ddiv_rn), which nvcc never contracts into an
// FMA; it divides where NumPy divides (rb / sqrt(2), |b| / 2^-39, never a
// multiply by a reciprocal), squares as b * b (NumPy's ** 2 on arrays),
// and takes the Gershgorin max / min with NaN propagating, as np.max /
// np.min do (fmax / fmin would drop it).
//
// What bounds it: neither bytes (2 lld doubles a chain) nor flops, but the
// latency of the slowest chain's serial recurrence, a division at each of
// the n - 1 levels of every Sturm count, up to 100 counts a centring step.
// sturm_steps measures that latency apart: one thread's chain of dependent
// levels on finite operands, with no fit around it.
// The design spreads the chains over the threads and leaves each chain's
// recurrence as it is, in order: a different bisection order would give
// different bits.  A block's threads load their chains coalesced into
// shared memory, [level][thread], where the Sturm loop reads them
// conflict-free; the centred diagonal is written there at each centring
// step.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;  // chains a block

__device__ __forceinline__ double add(double x, double y) {
  return __dadd_rn(x, y);
}
__device__ __forceinline__ double sub(double x, double y) {
  return __dsub_rn(x, y);
}
__device__ __forceinline__ double mul(double x, double y) {
  return __dmul_rn(x, y);
}
__device__ __forceinline__ double dvd(double x, double y) {
  return __ddiv_rn(x, y);
}

// np.max / np.min of a row: NaN wins
__device__ __forceinline__ double nanmax(double m, double x) {
  return (x > m || x != x) && m == m ? x : m;
}
__device__ __forceinline__ double nanmin(double m, double x) {
  return (x < m || x != x) && m == m ? x : m;
}

// A chain's levels in shared memory, level i of this thread at [i * T].
struct Levels {
  const double* az;  // centred diagonal
  const double* bb;  // centred off-diagonal, bb[0] = 0
  int n;
  __device__ double z(int i) const { return az[i * THREADS]; }
  __device__ double b(int i) const { return bb[i * THREADS]; }
};

// One level of the Sturm recurrence: p_i from p_{i-1}, ae = a_i - e and
// b_i.  Only the division and the subtraction wait for p.
__device__ __forceinline__ double level(double p, double ae, double bi) {
  const double relfeh = 0x1p-39;
  return p == 0.0 ? sub(ae, dvd(fabs(bi), relfeh))
                  : sub(ae, dvd(mul(bi, bi), p));
}

// Eigenvalues below e of the tridiagonal (az, bb): emami's sturm.
__device__ int sturm(const Levels& c, double e) {
  int num = 0;
  double p = sub(c.z(0), e);
  num += p < 0.0;
  for (int i = 1; i < c.n; ++i) {
    p = level(p, sub(c.z(i), e), c.b(i));
    num += p < 0.0;
  }
  return num;
}

// One bisection phase of emami from (emax, emin): the largest eigenvalue
// (hi) or the smallest, adding its Sturm counts to nst.  Returns false
// where it ran out of steps.
__device__ bool bisect(const Levels& c, bool hi, double& emax, double& emin,
                       double& e, int& nst) {
  const double eps = 1.0e-6;
  for (int it = 0; it < 50; ++it) {
    e = mul(0.5, add(emax, emin));
    const int num = sturm(c, e);
    ++nst;
    if (hi) {
      if (num == c.n) emax = e;
      if (num < c.n) emin = e;
    } else {
      if (num == 0) emin = e;
      if (num > 0) emax = e;
    }
    const double mid = mul(0.5, add(emax, emin));
    if (mid != 0.0 && fabs(dvd(sub(emax, emin), mid)) <= eps) return true;
  }
  return false;
}

// emami: the extremal eigenvalues (emax, emin) of the centred chain.
__device__ void emami(const Levels& c, double& emax, double& emin,
                      int& nst) {
  double hi = 0.0, lo = 0.0;
  for (int i = 0; i < c.n; ++i) {
    const double bl = fabs(c.b(i));
    const double br = i + 1 < c.n ? fabs(c.b(i + 1)) : 0.0;
    const double x1 = add(add(c.z(i), bl), br);
    const double x2 = sub(sub(c.z(i), bl), br);
    hi = i == 0 ? x1 : nanmax(hi, x1);
    lo = i == 0 ? x2 : nanmin(lo, x2);
  }
  double e1, e2;
  emax = hi;
  emin = lo;
  if (!bisect(c, true, emax, emin, e1, nst)) return;
  emax = e1;
  emin = lo;
  if (!bisect(c, false, emax, emin, e2, nst)) return;
  emax = e1;
  emin = e2;
}

__global__ void __launch_bounds__(THREADS)
bpopt_fit_kernel(const double* __restrict__ a, const double* __restrict__ rb,
                 double* __restrict__ fit, int* __restrict__ ifail,
                 int* __restrict__ sturms, int C, int lld, int n, int ldim) {
  extern __shared__ double smem[];
  double* sa = smem;                  // a, (n, T)
  double* sz = sa + n * THREADS;      // the centred a
  double* sb = sz + n * THREADS;      // the centred rb
  const int t = threadIdx.x;
  const int c0 = blockIdx.x * THREADS;
  const int nc = min(THREADS, C - c0);
  // the block's chains are nc rows of lld: read them coalesced
  for (int k = t; k < nc * lld; k += THREADS) {
    const int ch = k / lld, l = k - ch * lld;
    if (l < n) {
      sa[l * THREADS + ch] = a[(size_t)c0 * lld + k];
      sb[l * THREADS + ch] = rb[(size_t)c0 * lld + k];
    }
  }
  __syncthreads();
  if (t >= nc) return;
  const int c = c0 + t;
  double* az = sz + t;
  double* bb = sb + t;
  // the centred off-diagonal (bpopt's rbz, emami's bb): fixed for the fit
  for (int i = 1; i < n - 1; ++i) bb[i * THREADS] = mul(0.5, bb[i * THREADS]);
  bb[(n - 1) * THREADS] = dvd(bb[(n - 1) * THREADS], 1.4142135623730951);
  bb[0] = 0.0;
  const Levels lv{az, bb, n};
  const double eps = 1.0e-5;
  const double* ar = sa + t;
  double ainf = ar[(n - 1) * THREADS], bmax = 0.0, bmin = 0.0;
  int fail = 0, nst = 0;
  for (int jiter = 1;; ++jiter) {
    az[0] = mul(0.5, sub(ar[0], ainf));
    for (int i = 1; i < n - 1; ++i)
      az[i * THREADS] = mul(0.5, sub(ar[i * THREADS], ainf));
    az[(n - 1) * THREADS] = sub(ar[(n - 1) * THREADS], ainf);
    emami(lv, bmax, bmin, nst);
    const double bm = fabs(add(bmax, bmin));
    ainf = add(ainf, add(bmax, bmin));
    if (bm <= eps) break;
    if (jiter > 300) {
      fail = 1;
      break;
    }
  }
  double binf = dvd(sub(bmax, bmin), 2.0);
  if (ldim > 0) {  // get_terminf's guards
    const int j = c % ldim, i = (c / ldim) % ldim;
    if (ainf != ainf) ainf = 0.0;
    if (binf != binf) binf = 0.0;
    if (i == j) {
      if (ainf == 0.0) ainf = 0.5;
      if (binf == 0.0) binf = 0.5;
      if (i == 0 || i == 9) binf = mul(binf, 1.01);
    }
  }
  fit[c] = ainf;
  fit[C + c] = binf;
  ifail[c] = fail;
  if (sturms) sturms[c] = nst;
}

// Measurement only: reps passes over the levels 1 .. n-1 of one chain (z,
// b) at e on one thread, each level's p the last one's, carried from pass
// to pass, so that every division waits for the one before; out[0] is the
// last p, out[1] the levels with p < 0 (the count the fit would take).
__global__ void sturm_steps_kernel(const double* __restrict__ z,
                                   const double* __restrict__ b, double e,
                                   int n, int reps, double* __restrict__ out) {
  double p = sub(z[0], e);
  int num = 0;
  for (int r = 0; r < reps; ++r) {
    for (int i = 1; i < n; ++i) {
      p = level(p, sub(z[i], e), b[i]);
      num += p < 0.0;
    }
  }
  out[0] = p;
  out[1] = num;
}

}  // namespace

extern "C" {

// Shared memory a block of the fit takes at n levels.
int bpopt_fit_smem(int n) { return 3 * n * THREADS * (int)sizeof(double); }

// The fits of C chains of lld levels at n = lld - 1; ldim > 0 applies
// get_terminf's guards to chains laid out (R, ldim, ldim); sturms may be
// null.  Returns the cudaError_t of the set-up call or of the launch.
int bpopt_fit(const void* a, const void* rb, void* fit, void* ifail,
              void* sturms, int C, int lld, int n, int ldim, void* stream) {
  if (C <= 0 || n < 1 || n > lld) return (int)cudaErrorInvalidValue;
  const int smem = bpopt_fit_smem(n);
  cudaError_t err = cudaFuncSetAttribute(
      bpopt_fit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (C + THREADS - 1) / THREADS;
  bpopt_fit_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const double*)a, (const double*)rb, (double*)fit, (int*)ifail,
      (int*)sturms, C, lld, n, ldim);
  return (int)cudaGetLastError();
}

// Measurement only: sturm_steps_kernel on one thread.
int sturm_steps(const void* z, const void* b, double e, int n, int reps,
                void* out, void* stream) {
  if (n < 2 || reps < 1) return (int)cudaErrorInvalidValue;
  sturm_steps_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const double*)z, (const double*)b, e, n, reps, (double*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
