// K2: one Kuramoto-Sivashinsky control period in bf16-limb precision, for
// NVIDIA Hopper.
//
// Replaces pdecontrol_tpu/ops/pallas_ks_packed.py::_kernel (launched by
// _call, public entry ks_control_period_packed) in its limb modes.  It
// computes what that kernel computes: cfg_steps classic RK4 sub-steps of
//     u_t = lin - 0.5 * upwind((u^2)_x) + phi,   lin = (-c_xx u) + (-c_xxxx u)
// on a periodic grid of n points, phi fixed over the period, and the
// per-sub-step reward on the pre-step state averaged over the period, where
// every derivative is a product at the TPU's limb precision:
//   bf16     (1 pass):  x_hi*W_hi
//   bf16_3x  (3 passes): x_hi*W_hi + x_hi*W_lo + x_lo*W_hi
//   bf16_4x  (4 passes): ... + x_lo*W_lo
// with x_hi = bf16(x), x_lo = bf16(x - x_hi), W_hi = bf16(W),
// W_lo = bf16(W - W_hi), all rounded to nearest even, and float32
// accumulation.  The two linear blocks are summed after the products, in
// float32 (the separate-block operator of the limb modes).  The
// dissipation reward's u_xx is the negated -c_xx product: bf16 rounding is
// symmetric in sign and the sum runs in the same order, so that is exactly
// the product with +c_xx.
//
// A product of two bf16 values is exact in float32, so a float32 FMA chain
// over these terms computes the TPU kernel's matrix product up to the
// order of summation.
//
// What bounds it on this card: latency, as for K1 (ks_control_period.cu).
// A period is 250 sub-steps x 4 dependent RHS evaluations, each of which
// needs the neighbours' previous stage; a row is 64 floats in and 65 out.
// The design is K1's: one launch per period, one thread per grid point, the
// state in a register, the current stage in shared memory, a warp-shuffle
// reward.  Each stage publishes its value's and its square's bf16 limbs,
// computed once per point, and every tap reads them back.  The stencils are
// direct (-c_xx 7 taps, -c_xxxx 9, the one-sided upwinds 5 each) with the
// bf16 limbs of the float32 entries of the port's operator matrices, passed
// in by the host.  The tensor cores (mma.sync / wgmma on bf16 tiles) are
// not used: that redesign is later work.
//
// Plain C interface (built with nvcc into a shared library, called through
// ctypes); the function returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreadsPerBlock = 256;

// hi and lo bf16 limbs (stored as float) of the operators' nonzero entries.
struct LimbTaps {
  float c2h[7], c2l[7];  // -c_xx,   offsets -3..3
  float c4h[9], c4l[9];  // -c_xxxx, offsets -4..4
  float fwh[5], fwl[5];  // forward upwind of u^2, offsets 0..4
  float bwh[5], bwl[5];  // backward upwind of u^2, offsets -4..0
};

__device__ __forceinline__ int wrap(int j, int n) {
  j += (j < 0) ? n : 0;
  j -= (j >= n) ? n : 0;
  return j;
}

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One limb product term of tap weight (wh, wl) with the value limbs at
// index j, added to acc.
template <int kPasses>
__device__ __forceinline__ float limb_fma(float acc, float wh, float wl, const float* hi,
                                          const float* lo, int j) {
  const float xh = hi[j];
  acc = fmaf(wh, xh, acc);
  if (kPasses >= 3) {
    const float xl = lo[j];
    acc = fmaf(wl, xh, acc);
    acc = fmaf(wh, xl, acc);
    if (kPasses == 4) acc = fmaf(wl, xl, acc);
  }
  return acc;
}

// Shared-memory rows of one block row: the limbs of the stage value and of
// its square.  The lo arrays are unused (and not allocated) at one pass.
struct StageRows {
  float* vh;
  float* vl;
  float* sh;
  float* sl;
};

// One RHS evaluation at stage value v of grid point i.  Returns the RHS and
// writes the upwind u_x and the -c_xx product (for the reward).  The
// trailing barrier protects the shared rows until every thread has read
// them.
template <int kPasses>
__device__ __forceinline__ float rhs(float v, float phi, const StageRows& r, int i, int n,
                                     const LimbTaps& t, float* u_x, float* neg_uxx) {
  const float vh = bf16_rn(v);
  // Rounded square (no FMA contraction into s - sh): the lo limb is taken
  // of the float32 square, as the TPU kernel takes it.
  const float s = __fmul_rn(v, v);
  const float sh = bf16_rn(s);
  r.vh[i] = vh;
  r.sh[i] = sh;
  if (kPasses >= 3) {
    r.vl[i] = bf16_rn(v - vh);
    r.sl[i] = bf16_rn(s - sh);
  }
  __syncthreads();
  float d2 = 0.f, d4 = 0.f, fwd = 0.f, bwd = 0.f;
#pragma unroll
  for (int d = -3; d <= 3; ++d)
    d2 = limb_fma<kPasses>(d2, t.c2h[d + 3], t.c2l[d + 3], r.vh, r.vl, wrap(i + d, n));
#pragma unroll
  for (int d = -4; d <= 4; ++d)
    d4 = limb_fma<kPasses>(d4, t.c4h[d + 4], t.c4l[d + 4], r.vh, r.vl, wrap(i + d, n));
#pragma unroll
  for (int d = 0; d <= 4; ++d)
    fwd = limb_fma<kPasses>(fwd, t.fwh[d], t.fwl[d], r.sh, r.sl, wrap(i + d, n));
#pragma unroll
  for (int d = -4; d <= 0; ++d)
    bwd = limb_fma<kPasses>(bwd, t.bwh[d + 4], t.bwl[d + 4], r.sh, r.sl, wrap(i + d, n));
  __syncthreads();
  const float ux = (v < 0.f) ? fwd : bwd;
  *u_x = ux;
  *neg_uxx = d2;
  return (d2 + d4) - 0.5f * ux + phi;
}

template <int kPasses, bool kDissipation>
__global__ void __launch_bounds__(kThreadsPerBlock)
ks_control_period_limb_kernel(const float* __restrict__ u_in, const float* __restrict__ phi_in,
                              float* __restrict__ u_out, float* __restrict__ rew_out,
                              int batch, int n, int rows_per_block, float dt, int cfg_steps,
                              LimbTaps taps) {
  extern __shared__ float smem[];
  const int local_row = threadIdx.x / n;
  const int i = threadIdx.x - local_row * n;
  const int row = blockIdx.x * rows_per_block + local_row;
  const bool active = row < batch;
  const int warps_per_row = n / 32;
  const int warp_in_row = i / 32;
  const int lane = threadIdx.x & 31;

  // [vh | sh | vl | sl] planes of rows_per_block * n floats, then the
  // per-warp reward partials [rows][warps_per_row][3].
  const int plane = rows_per_block * n;
  const int planes = (kPasses >= 3) ? 4 : 2;
  StageRows r;
  r.vh = smem + 0 * plane + local_row * n;
  r.sh = smem + 1 * plane + local_row * n;
  r.vl = (kPasses >= 3) ? smem + 2 * plane + local_row * n : nullptr;
  r.sl = (kPasses >= 3) ? smem + 3 * plane + local_row * n : nullptr;
  float* red = smem + planes * plane + local_row * warps_per_row * 3;

  // Rows past the batch (the last block's tail) compute on zeros and write
  // nothing; they still take part in every barrier.
  float u = active ? u_in[row * n + i] : 0.f;
  const float phi = active ? phi_in[row * n + i] : 0.f;
  const float inv_n = 1.0f / static_cast<float>(n);
  float acc = 0.f;

  for (int s = 0; s < cfg_steps; ++s) {
    float ux, neg_uxx, ux_, nxx_;
    const float k1 = rhs<kPasses>(u, phi, r, i, n, taps, &ux, &neg_uxx);

    // Reward on the pre-step state, reduced over the row.
    float a, b = 0.f, c = 0.f;
    if (kDissipation) {
      const float uxx = -neg_uxx;
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

    const float k2 = rhs<kPasses>(u + dt * k1 / 2.0f, phi, r, i, n, taps, &ux_, &nxx_);
    const float k3 = rhs<kPasses>(u + dt * k2 / 2.0f, phi, r, i, n, taps, &ux_, &nxx_);
    const float k4 = rhs<kPasses>(u + dt * k3, phi, r, i, n, taps, &ux_, &nxx_);
    u = u + dt * (k1 + 2.0f * k2 + 2.0f * k3 + k4) / 6.0f;
  }

  if (active) {
    u_out[row * n + i] = u;
    if (i == 0) rew_out[row] = acc / static_cast<float>(cfg_steps);
  }
}

template <int kPasses>
void launch(const float* u, const float* phi, float* u_out, float* rew_out, int batch, int n,
            float dt, int cfg_steps, bool dissipation, const LimbTaps& taps,
            cudaStream_t stream) {
  const int rows_per_block = kThreadsPerBlock / n;
  const int blocks = (batch + rows_per_block - 1) / rows_per_block;
  const int threads = rows_per_block * n;
  const int planes = (kPasses >= 3) ? 4 : 2;
  const size_t smem =
      sizeof(float) * (planes * rows_per_block * n + rows_per_block * (n / 32) * 3);
  if (dissipation) {
    ks_control_period_limb_kernel<kPasses, true><<<blocks, threads, smem, stream>>>(
        u, phi, u_out, rew_out, batch, n, rows_per_block, dt, cfg_steps, taps);
  } else {
    ks_control_period_limb_kernel<kPasses, false><<<blocks, threads, smem, stream>>>(
        u, phi, u_out, rew_out, batch, n, rows_per_block, dt, cfg_steps, taps);
  }
}

}  // namespace

extern "C" int ks_control_period_limb(const void* u, const void* phi, void* u_out,
                                      void* rew_out, int batch, int n, float dt, int cfg_steps,
                                      int dissipation, int passes, const void* taps52,
                                      void* stream) {
  if (n < 9 || n % 32 != 0 || n > kThreadsPerBlock || cfg_steps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (passes != 1 && passes != 3 && passes != 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0) return 0;
  LimbTaps taps;
  static_assert(sizeof(LimbTaps) == 52 * sizeof(float), "LimbTaps must hold 52 packed floats");
  std::memcpy(&taps, taps52, sizeof(LimbTaps));

  const float* uu = static_cast<const float*>(u);
  const float* pp = static_cast<const float*>(phi);
  float* uo = static_cast<float*>(u_out);
  float* ro = static_cast<float*>(rew_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dis = dissipation != 0;
  if (passes == 1) {
    launch<1>(uu, pp, uo, ro, batch, n, dt, cfg_steps, dis, taps, s);
  } else if (passes == 3) {
    launch<3>(uu, pp, uo, ro, batch, n, dt, cfg_steps, dis, taps, s);
  } else {
    launch<4>(uu, pp, uo, ro, batch, n, dt, cfg_steps, dis, taps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
