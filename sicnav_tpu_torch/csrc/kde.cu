// Pairwise whitened-distance KDE log-likelihood, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kde_kernel` in
// sicnav_tpu/ops/kde_pallas.py (launched by `_kde_loglik_pallas_impl`,
// dispatched from `kde_loglik_fused`). For every group g of S whitened
// samples y (S x D) with log-normalizer log_Z[g]:
//
//   out[g, i] = logsumexp_j( -0.5 * max(d2_ij, 0) - log_Z[g] ),
//   d2_ij     = sum_d (y_i[d] - y_j[d])^2
//
// What bounds it on this card: the launch. At the main path's joint-ranking
// shape (G=8, S=48, D=16) the function moves 26 KB and needs about 0.37
// MFLOP, which an H100 covers in about 8 ns; a launch costs microseconds.
// The design therefore spreads the little work there is over enough warps
// that nothing after the launch waits long:
//
// - a warp per row: the grid is (G, ceil(S / 8)) blocks of 8 warps, warp w
//   of block (g, t) takes row i = 8t + w of group g (48 blocks at the main
//   shape, 384 at the iMID shape (64, 48, 2));
// - each block stages its group's S*D floats in shared memory once, read
//   coalesced and stored transposed, [D][S|1], so that lane j's read of
//   y_j[d] is one word in its own bank;
// - y_i sits in registers (the D loop is unrolled: one instantiation per D
//   the main path and its tests use, 2, 12, 16 and 24, and a masked one for
//   any other D <= 64; the wrapper raises above 64), and lane l takes
//   j = l, l+32, ..., so S > 32 takes more passes and any S works;
// - d2 in difference form: the self term is exactly 0 and d2 never rounds
//   below 0. The Gram form |y_i|^2 + |y_j|^2 - 2 y_i.y_j that the TPU kernel
//   uses loses hundreds in d2 where |y|^2 is near 1e9, as on the main path's
//   uncentred whitened samples; the difference form stays near float64;
// - no running max: the self term, exp(0) = 1, is each row's largest, so
//   each lane sums exp(-0.5 d2) directly, a __shfl_xor_sync tree adds the
//   lanes, and lane 0 writes log(sum) - log_Z[g]. The sum is at least 1,
//   so nothing underflows to log(0).
//
// Not used, and why: the tensor cores (wgmma/mma) take float32 as TF32,
// whose 10-bit mantissa would put errors of order 1e6 into d2 at |y|^2 near
// 1e9, and a group's Gram is only 48 x 48 x 16; TMA would copy a 3 KB tile
// that one coalesced pass of 256 threads loads as fast.
//
// No PyTorch header is included: the file builds with plain nvcc in seconds
// and is bound from Python with ctypes (sicnav_tpu_torch/ops/kde_cuda.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;                  // rows (one warp each) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 64;                  // widest instantiation
constexpr size_t kDefaultSmem = 48 * 1024;  // above it, opt in per kernel

// DMAX is the compile-time length of y_i's registers. EXACT: D == DMAX;
// otherwise D <= DMAX and coordinates d >= D are skipped.
template <int DMAX, bool EXACT>
__global__ void __launch_bounds__(kThreads)
kde_loglik_kernel(const float* __restrict__ y, const float* __restrict__ log_z,
                  float* __restrict__ out, int S, int D) {
  extern __shared__ float ys[];  // ys[d * ld + j] = y[g, j, d]
  const int Dk = EXACT ? DMAX : D;
  const int ld = S | 1;
  const int g = blockIdx.x;
  const float* yg = y + static_cast<size_t>(g) * S * Dk;
  for (int k = threadIdx.x; k < S * Dk; k += kThreads) {
    const int j = k / Dk;
    ys[(k - j * Dk) * ld + j] = yg[k];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int i = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (i >= S) return;  // a whole warp leaves: the shuffles below stay full

  // the masked loops leave at d == D: predicating all DMAX steps instead
  // made D = 3 at S = 100 take 10.6 us on an H100, against 6.1 us for a
  // D <= 8 kernel
  float yi[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    if (!EXACT && d >= Dk) break;
    yi[d] = ys[d * ld + i];
  }

  float sum = 0.f;
  for (int j = lane; j < S; j += 32) {
    float d2 = 0.f;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      if (!EXACT && d >= Dk) break;
      const float t = yi[d] - ys[d * ld + j];
      d2 = fmaf(t, t, d2);
    }
    sum += expf(-0.5f * fmaxf(d2, 0.f));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) out[static_cast<size_t>(g) * S + i] = logf(sum) - log_z[g];
}

template <int DMAX, bool EXACT>
int launch(const float* y, const float* log_z, float* out, int G, int S,
           int D, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(D) * (S | 1);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kde_loglik_kernel<DMAX, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(G, (S + kWarps - 1) / kWarps);
  kde_loglik_kernel<DMAX, EXACT><<<grid, kThreads, smem, stream>>>(
      y, log_z, out, S, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: (G, S, D) float32, contiguous; log_z: (G,); out: (G, S). Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched), or
// cudaErrorInvalidValue for D > 64. The block needs D * (S | 1) * 4 bytes of
// shared memory; the caller checks that they fit the 227 KB a block can have.
extern "C" int sicnav_kde_loglik(const float* y, const float* log_z,
                                 float* out, int G, int S, int D,
                                 void* stream) {
  if (G <= 0 || S <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 2: return launch<2, true>(y, log_z, out, G, S, D, s);
    case 12: return launch<12, true>(y, log_z, out, G, S, D, s);
    case 16: return launch<16, true>(y, log_z, out, G, S, D, s);
    case 24: return launch<24, true>(y, log_z, out, G, S, D, s);
    default: break;
  }
  if (D < 0 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kMaxD, false>(y, log_z, out, G, S, D, s);
}
