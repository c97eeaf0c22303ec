// Pairwise whitened-distance KDE log-likelihood, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_kde_kernel` in
// sicnav_tpu/ops/kde_pallas.py (launched by `_kde_loglik_pallas_impl`,
// dispatched from `kde_loglik_fused`). For every group g of S whitened
// samples y (S x D) with log-normalizer log_Z[g]:
//
//   out[g, i] = logsumexp_j( -0.5 * max(|y_i|^2 + |y_j|^2 - 2 y_i.y_j, 0)
//                            - log_Z[g] )
//
// What bounds it on this card: latency, not bytes or operations. At the
// main path's joint-ranking shape (G=8, S=48, D=16) it moves 26 KB and the
// function needs about 0.37 MFLOP (the Gram is symmetric), which an H100
// covers in about 8 ns at its HBM rate; the launch costs microseconds, and
// in this design each thread's chain of dependent shared-memory loads (1.5
// warps per SM) costs tens more. It does each pair twice, once per row, and
// keeps an online max as logsumexp does; the bound counts neither. It runs
// once per control step, so the design is the simplest one that is right; a
// warp per row with y_i in registers is the next step when its time matters:
//
// - one block per group; the group's Y (S*D*4 bytes, 3 KB at the main-path
//   shape) and its squared row norms are staged in shared memory once;
// - one thread per row i runs an online max / sum-exp over j < S, so the
//   S x S Gram is never stored;
// - the ragged edge is masked by index (loops stop at S and D): no -1e30
//   padding and no padding of D to 128 as the TPU's (8, 128) tiling needed;
// - the distance uses the same Gram form as the TPU kernel, so rounding
//   follows the reference.
//
// No PyTorch header is included: the file builds with plain nvcc in seconds
// and is bound from Python with ctypes (sicnav_tpu_torch/ops/kde_cuda.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void kde_loglik_kernel(const float* __restrict__ y,
                                  const float* __restrict__ log_z,
                                  float* __restrict__ out, int S, int D) {
  extern __shared__ float smem[];
  float* ys = smem;           // S * D whitened samples of this group
  float* sq = smem + S * D;   // S squared row norms

  const int g = blockIdx.x;
  const float* yg = y + static_cast<size_t>(g) * S * D;
  for (int k = threadIdx.x; k < S * D; k += blockDim.x) ys[k] = yg[k];
  __syncthreads();

  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(ys[i * D + d], ys[i * D + d], acc);
    sq[i] = acc;
  }
  __syncthreads();

  const float z = log_z[g];
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const float* yi = ys + i * D;
    const float sqi = sq[i];
    float m = -INFINITY;
    float s = 0.f;
    for (int j = 0; j < S; ++j) {
      const float* yj = ys + j * D;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(yi[d], yj[d], dot);
      const float d2 = sqi + sq[j] - 2.f * dot;
      const float x = -0.5f * fmaxf(d2, 0.f) - z;
      if (x > m) {
        s = s * expf(m - x) + 1.f;
        m = x;
      } else {
        s += expf(x - m);
      }
    }
    out[static_cast<size_t>(g) * S + i] = m + logf(s);
  }
}

}  // namespace

// y: (G, S, D) float32, contiguous; log_z: (G,); out: (G, S). Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched). The
// caller checks shapes and that (S*D + S)*4 bytes fit the default 48 KB of
// shared memory.
extern "C" int sicnav_kde_loglik(const float* y, const float* log_z,
                                 float* out, int G, int S, int D,
                                 void* stream) {
  if (G <= 0 || S <= 0) return 0;
  int threads = ((S + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = static_cast<size_t>(S) * (D + 1) * sizeof(float);
  kde_loglik_kernel<<<G, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, log_z, out, S, D);
  return static_cast<int>(cudaGetLastError());
}
