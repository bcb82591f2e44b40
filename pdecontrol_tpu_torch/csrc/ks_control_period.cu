// K1: one Kuramoto-Sivashinsky control period, fp32, for NVIDIA Hopper.
//
// Replaces pdecontrol_tpu/ops/pallas_ks.py::_kernel (launched by _call,
// public entry ks_control_period_pallas).  It computes what that kernel
// computes: cfg_steps classic RK4 sub-steps of
//     u_t = -u_xxxx - u_xx - 0.5 * upwind((u^2)_x) + phi
// on a periodic grid of n points with phi fixed over the period, and the
// per-sub-step reward on the pre-step state, averaged over the period
// (l2control: -mean u^2; dissipation: -(mean u_xx^2 + mean u_x^2 + mean u*phi)).
//
// What bounds it on this card: latency.  One launch runs 250 sub-steps x 4
// dependent RHS evaluations; each needs the neighbours' values of the
// previous stage, so the 1,000 evaluations form one chain of block-level
// barriers.  A row is 64 floats in and 64 + 1 out per period, and an RHS is
// ~60 FLOPs per point, so neither bytes nor FLOPs come near the card's
// limits.  The design therefore keeps everything on chip and pays the chain
// once per period:
//   * one launch per control period; each block owns a few rows, one thread
//     per grid point, and the state lives in a register (plus a shared-memory
//     copy of the current stage for the neighbours) for all sub-steps;
//   * direct periodic stencils (u_xx 7 taps, u_xxxx 9 taps, the one-sided
//     upwinds 5 taps each) instead of the TPU kernel's dense [2N, 4N] matrix,
//     which would take 128 KB of shared memory and mostly multiply by zero.
//     The taps are the float32 entries of the port's KSOperators matrices, so
//     the kernel and the plain path use the same float32 coefficients;
//   * the reward is a per-row warp-shuffle reduction, accumulated in a
//     register;
//   * all arithmetic is fp32 (no TF32, no bf16).
//
// Plain C interface (built with nvcc into a shared library, called through
// ctypes); the function returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreadsPerBlock = 256;

struct Taps {
  float c2[7];  // u_xx,    offsets -3..3
  float c4[9];  // u_xxxx,  offsets -4..4
  float fw[5];  // forward upwind of u^2, offsets 0..4
  float bw[5];  // backward upwind of u^2, offsets -4..0
};

__device__ __forceinline__ int wrap(int j, int n) {
  j += (j < 0) ? n : 0;
  j -= (j >= n) ? n : 0;
  return j;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One RHS evaluation at stage value v of grid point i.  The caller's stage
// value and its square are published to shared memory, read back by the
// neighbours, and the trailing barrier protects them until every thread of
// the block has read them.
__device__ __forceinline__ float rhs(float v, float phi, float* v_row, float* sq_row, int i,
                                     int n, const Taps& t, float* u_x, float* u_xx) {
  v_row[i] = v;
  sq_row[i] = v * v;
  __syncthreads();
  float d2 = 0.f, d4 = 0.f, fwd = 0.f, bwd = 0.f;
#pragma unroll
  for (int d = -3; d <= 3; ++d) d2 += t.c2[d + 3] * v_row[wrap(i + d, n)];
#pragma unroll
  for (int d = -4; d <= 4; ++d) d4 += t.c4[d + 4] * v_row[wrap(i + d, n)];
#pragma unroll
  for (int d = 0; d <= 4; ++d) fwd += t.fw[d] * sq_row[wrap(i + d, n)];
#pragma unroll
  for (int d = -4; d <= 0; ++d) bwd += t.bw[d + 4] * sq_row[wrap(i + d, n)];
  __syncthreads();
  const float ux = (v < 0.f) ? fwd : bwd;
  *u_x = ux;
  *u_xx = d2;
  return -d4 - d2 - 0.5f * ux + phi;
}

template <bool kDissipation>
__global__ void __launch_bounds__(kThreadsPerBlock)
ks_control_period_kernel(const float* __restrict__ u_in, const float* __restrict__ phi_in,
                         float* __restrict__ u_out, float* __restrict__ rew_out, int batch,
                         int n, int rows_per_block, float dt, int cfg_steps, Taps taps) {
  extern __shared__ float smem[];
  const int local_row = threadIdx.x / n;
  const int i = threadIdx.x - local_row * n;
  const int row = blockIdx.x * rows_per_block + local_row;
  const bool active = row < batch;
  const int warps_per_row = n / 32;
  const int warp_in_row = i / 32;
  const int lane = threadIdx.x & 31;

  float* v_row = smem + local_row * n;
  float* sq_row = smem + rows_per_block * n + local_row * n;
  // Per-warp partial sums of the reward terms: [rows][warps_per_row][3].
  float* red = smem + 2 * rows_per_block * n + local_row * warps_per_row * 3;

  // Rows past the batch (the last block's tail) compute on zeros and write
  // nothing; they still take part in every barrier.
  float u = active ? u_in[row * n + i] : 0.f;
  const float phi = active ? phi_in[row * n + i] : 0.f;
  const float inv_n = 1.0f / static_cast<float>(n);
  float acc = 0.f;

  for (int s = 0; s < cfg_steps; ++s) {
    float ux, uxx, ux_, uxx_;
    const float k1 = rhs(u, phi, v_row, sq_row, i, n, taps, &ux, &uxx);

    // Reward on the pre-step state, reduced over the row.
    float a, b = 0.f, c = 0.f;
    if (kDissipation) {
      a = warp_sum(uxx * uxx);
      b = warp_sum(ux * ux);
      c = warp_sum(u * phi);
    } else {
      a = warp_sum(u * u);
    }
    if (lane == 0) {
      red[warp_in_row * 3 + 0] = a;
      red[warp_in_row * 3 + 1] = b;
      red[warp_in_row * 3 + 2] = c;
    }
    __syncthreads();
    if (i == 0) {
      float sa = 0.f, sb = 0.f, sc = 0.f;
      for (int w = 0; w < warps_per_row; ++w) {
        sa += red[w * 3 + 0];
        sb += red[w * 3 + 1];
        sc += red[w * 3 + 2];
      }
      acc += kDissipation ? -(sa * inv_n + sb * inv_n + sc * inv_n) : -(sa * inv_n);
    }
    // ``red`` is rewritten only after the next sub-step's first RHS, whose
    // two barriers follow this read.

    const float k2 = rhs(u + dt * k1 / 2.0f, phi, v_row, sq_row, i, n, taps, &ux_, &uxx_);
    const float k3 = rhs(u + dt * k2 / 2.0f, phi, v_row, sq_row, i, n, taps, &ux_, &uxx_);
    const float k4 = rhs(u + dt * k3, phi, v_row, sq_row, i, n, taps, &ux_, &uxx_);
    u = u + dt * (k1 + 2.0f * k2 + 2.0f * k3 + k4) / 6.0f;
  }

  if (active) {
    u_out[row * n + i] = u;
    if (i == 0) rew_out[row] = acc / static_cast<float>(cfg_steps);
  }
}

}  // namespace

extern "C" int ks_control_period_f32(const void* u, const void* phi, void* u_out, void* rew_out,
                                     int batch, int n, float dt, int cfg_steps, int dissipation,
                                     const void* taps26, void* stream) {
  if (n < 9 || n % 32 != 0 || n > kThreadsPerBlock || cfg_steps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0) return 0;
  Taps taps;
  static_assert(sizeof(Taps) == 26 * sizeof(float), "Taps must hold 26 packed floats");
  std::memcpy(&taps, taps26, sizeof(Taps));

  const int rows_per_block = kThreadsPerBlock / n;
  const int blocks = (batch + rows_per_block - 1) / rows_per_block;
  const int threads = rows_per_block * n;
  const size_t smem = sizeof(float) * (2 * rows_per_block * n + rows_per_block * (n / 32) * 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uu = static_cast<const float*>(u);
  const float* pp = static_cast<const float*>(phi);
  float* uo = static_cast<float*>(u_out);
  float* ro = static_cast<float*>(rew_out);
  if (dissipation) {
    ks_control_period_kernel<true><<<blocks, threads, smem, s>>>(
        uu, pp, uo, ro, batch, n, rows_per_block, dt, cfg_steps, taps);
  } else {
    ks_control_period_kernel<false><<<blocks, threads, smem, s>>>(
        uu, pp, uo, ro, batch, n, rows_per_block, dt, cfg_steps, taps);
  }
  return static_cast<int>(cudaGetLastError());
}
