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
// The bound.  Per grid point and RHS evaluation the function needs 21
// stencil taps as FMAs (u_xx 7, u_xxxx 9, and one of the two 5-tap upwind
// sums, picked by the sign of the stage value; the kernel evaluates both and
// selects, 5 FMAs more) plus the square, the combine and the stage input,
// ~50 FLOPs; with the RK4 combine and the reward ~210
// FLOPs per point and sub-step, so ~3.4 MFLOP per row of 64 points and 250
// sub-steps, against 772 bytes in and out.  By the roofline the kernel is
// compute-bound (~51 us at B=1024 on the H100's 67 TFLOP/s of non-tensor
// fp32).  In practice, at the batches the main path runs (B <= 64 rows), it
// is latency-bound: a period is one chain of 1,000 dependent RHS
// evaluations, each of which needs the neighbours' values of the previous
// stage.
//
// The design shortens that chain:
//   * one launch per control period, one warp per row; lane l holds the
//     P = n/32 consecutive points [l*P, l*P + P) in registers for all
//     sub-steps;
//   * the stencils reach 4 points, so an RHS takes its 8 halo values from
//     the neighbouring lanes by __shfl_sync (8 shuffles at every P), and
//     (l + k) & 31 wraps the periodic grid because 32 * P = n.  The halo's
//     squares are recomputed from the shuffled values, which gives the
//     owner's bits.  No shared memory, no block barrier: the chain per RHS
//     is the shuffles plus the longest tap sum (9 FMAs);
//   * the four tap sums (u_xx 7 taps, u_xxxx 9, the one-sided upwinds of
//     u^2 5 each) are independent accumulators of each point, for
//     instruction-level parallelism.  The taps are the float32 entries of
//     the port's KSOperators matrices, so the kernel and the plain path use
//     the same float32 coefficients (direct stencils instead of the TPU
//     kernel's dense [2N, 4N] matrix, which mostly multiplies by zero);
//   * each lane sums its points' reward terms over all sub-steps in
//     registers, and one warp reduction per term ends the period (this
//     reorders the float32 sum of the per-sub-step version);
//   * a block is one warp, so a launch has one block per row and no block
//     is partly filled (1, 2 and 4 rows per block ran equally fast);
//   * all arithmetic is fp32 (no TF32, no bf16).
//
// That register path takes n = 32, 64, ..., 256.  Every other grid of 9 to
// 1,024 points (the JAX kernel takes any N; below 9 the 9-point stencil
// wraps onto itself) runs the general path further down: one warp per row,
// the stage values in a shared-memory window with a copied periodic halo.
//
// Plain C interface (built with nvcc into a shared library, called through
// ctypes); it returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kReach = 4;  // the widest stencil, u_xxxx, spans -4..4

struct Taps {
  float c2[7];  // u_xx,    offsets -3..3
  float c4[9];  // u_xxxx,  offsets -4..4
  float fw[5];  // forward upwind of u^2, offsets 0..4
  float bw[5];  // backward upwind of u^2, offsets -4..0
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// One RHS evaluation at the stage values v[P] of this lane's points.  w is
// the window [4 halo | P own | 4 halo] of stage values, sq their squares.
// Writes the RHS of each point to k, and its upwind u_x and u_xx to ux,
// uxx (read only for the reward of the first stage).
template <int P>
__device__ __forceinline__ void rhs(const float (&v)[P], const float (&phi)[P], int lane,
                                    const Taps& t, float (&k)[P], float (&ux)[P],
                                    float (&uxx)[P]) {
  float w[P + 2 * kReach];
  float sq[P + 2 * kReach];
#pragma unroll
  for (int p = 0; p < P; ++p) w[kReach + p] = v[p];
  // Halo point h (1..4) to the left is point lP - h, held by lane l - q at
  // index qP - h, where q = ceil(h / P); to the right, point lP + P - 1 + h
  // is held by lane l + q at index h - 1 - (q - 1)P.  They are fetched in
  // the order the tap sums consume them, leftmost first.
#pragma unroll
  for (int h = kReach; h >= 1; --h) {
    const int q = (h + P - 1) / P;
    w[kReach - h] = __shfl_sync(kFullMask, v[q * P - h], (lane - q) & 31);
  }
#pragma unroll
  for (int h = 1; h <= kReach; ++h) {
    const int q = (h + P - 1) / P;
    w[kReach + P - 1 + h] = __shfl_sync(kFullMask, v[h - 1 - (q - 1) * P], (lane + q) & 31);
  }
#pragma unroll
  for (int j = 0; j < P + 2 * kReach; ++j) sq[j] = __fmul_rn(w[j], w[j]);

#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = kReach + p;
    float d2 = 0.f, d4 = 0.f, fwd = 0.f, bwd = 0.f;
#pragma unroll
    for (int d = -3; d <= 3; ++d) d2 += t.c2[d + 3] * w[c + d];
#pragma unroll
    for (int d = -4; d <= 4; ++d) d4 += t.c4[d + 4] * w[c + d];
#pragma unroll
    for (int d = 0; d <= 4; ++d) fwd += t.fw[d] * sq[c + d];
#pragma unroll
    for (int d = -4; d <= 0; ++d) bwd += t.bw[d + 4] * sq[c + d];
    const float u_x = (v[p] < 0.f) ? fwd : bwd;
    ux[p] = u_x;
    uxx[p] = d2;
    k[p] = -d4 - d2 - 0.5f * u_x + phi[p];
  }
}

template <int P, bool kDissipation>
__global__ void __launch_bounds__(32)
ks_control_period_kernel(const float* __restrict__ u_in, const float* __restrict__ phi_in,
                         float* __restrict__ u_out, float* __restrict__ rew_out, float dt,
                         int cfg_steps, Taps taps) {
  constexpr int n = 32 * P;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;

  const float* u_row = u_in + static_cast<size_t>(row) * n + lane * P;
  const float* phi_row = phi_in + static_cast<size_t>(row) * n + lane * P;
  float u[P], phi[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    u[p] = u_row[p];
    phi[p] = phi_row[p];
  }

  // This lane's reward terms, summed over its points and all sub-steps:
  // l2control a = u^2; dissipation a = u_xx^2, b = u_x^2, c = u*phi.
  float a = 0.f, b = 0.f, c = 0.f;
  float k1[P], k2[P], k3[P], k4[P], ux[P], uxx[P], stage[P];

  for (int s = 0; s < cfg_steps; ++s) {
    rhs<P>(u, phi, lane, taps, k1, ux, uxx);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (kDissipation) {
        a += uxx[p] * uxx[p];
        b += ux[p] * ux[p];
        c += u[p] * phi[p];
      } else {
        a += u[p] * u[p];
      }
      stage[p] = u[p] + dt * k1[p] / 2.0f;
    }
    rhs<P>(stage, phi, lane, taps, k2, ux, uxx);
#pragma unroll
    for (int p = 0; p < P; ++p) stage[p] = u[p] + dt * k2[p] / 2.0f;
    rhs<P>(stage, phi, lane, taps, k3, ux, uxx);
#pragma unroll
    for (int p = 0; p < P; ++p) stage[p] = u[p] + dt * k3[p];
    rhs<P>(stage, phi, lane, taps, k4, ux, uxx);
#pragma unroll
    for (int p = 0; p < P; ++p)
      u[p] = u[p] + dt * (k1[p] + 2.0f * k2[p] + 2.0f * k3[p] + k4[p]) / 6.0f;
  }

  float* u_dst = u_out + static_cast<size_t>(row) * n + lane * P;
#pragma unroll
  for (int p = 0; p < P; ++p) u_dst[p] = u[p];

  const float inv_n = 1.0f / static_cast<float>(n);
  float total;
  if (kDissipation) {
    const float sa = warp_sum(a), sb = warp_sum(b), sc = warp_sum(c);
    total = -(sa * inv_n + sb * inv_n + sc * inv_n);
  } else {
    total = -(warp_sum(a) * inv_n);
  }
  if (lane == 0) rew_out[row] = total / static_cast<float>(cfg_steps);
}

// ---------------------------------------------------------------------------
// The general grid: every n in [kMinN, kMaxN] that the register path does not
// take (not a multiple of 32, or above 256).
//
//   * one warp per row and one warp per block, as above; lane l owns the
//     points l, l + 32, l + 64, ... < n, so neighbouring lanes touch
//     neighbouring addresses, and at n < 32 lanes n..31 own none;
//   * a point's state u, forcing phi and running RK4 sum k1 + 2 k2 + 2 k3
//     (+ k4) sit in dynamic shared memory, touched only by the point's owner;
//   * each RHS reads the stage values and their squares (one float2 a
//     point) from a shared window [4 halo | n points | 4 halo] and writes
//     the next stage's into the other of two windows.  The owners of the
//     first and last 4 points also write the periodic halo's copies.  One
//     __syncwarp() per RHS separates a window's writes from its reads: a
//     window is written again only two RHS evaluations after it was read,
//     and every lane has passed the barrier in between;
//   * the tap sums are the register path's, the same taps in the same
//     order, from a 9-point window read out of shared memory; the squares
//     are the owner's __fmul_rn, as the register path recomputes them;
//   * the reward is summed per lane over its points and all sub-steps, and
//     one warp reduction on the full mask ends the period (lanes that own
//     no point add zero).
// Shared memory: 2 (n + 8) float2 + 3n float, 28.8 KB at n = 1,024, under
// the 48 KB a block has without an opt-in.
constexpr int kMinN = 9;
constexpr int kMaxN = 1024;

// Stage value v of point i, with its square, into window w (and into the
// periodic halo where point i lies within 4 of either end).
__device__ __forceinline__ void put(float2* w, int i, int n, float v) {
  const float2 x = make_float2(v, __fmul_rn(v, v));
  w[kReach + i] = x;
  if (i < kReach) w[kReach + n + i] = x;
  if (i >= n - kReach) w[i - (n - kReach)] = x;
}

template <bool kDissipation>
__global__ void __launch_bounds__(32)
ks_control_period_general_kernel(const float* __restrict__ u_in,
                                 const float* __restrict__ phi_in, float* __restrict__ u_out,
                                 float* __restrict__ rew_out, int n, float dt, int cfg_steps,
                                 Taps t) {
  extern __shared__ float2 smem[];
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const int wn = n + 2 * kReach;
  float2* cur = smem;
  float2* nxt = smem + wn;
  float* su = reinterpret_cast<float*>(smem + 2 * wn);
  float* sphi = su + n;
  float* sks = sphi + n;

  const float* u_row = u_in + static_cast<size_t>(row) * n;
  const float* phi_row = phi_in + static_cast<size_t>(row) * n;
  for (int i = lane; i < n; i += 32) {
    const float v = u_row[i];
    su[i] = v;
    sphi[i] = phi_row[i];
    put(cur, i, n, v);
  }
  __syncwarp();

  // This lane's reward terms, as in the register path.
  float a = 0.f, b = 0.f, c = 0.f;
  for (int s = 0; s < cfg_steps; ++s) {
#pragma unroll
    for (int stage = 0; stage < 4; ++stage) {
      for (int i = lane; i < n; i += 32) {
        float w[2 * kReach + 1], sq[2 * kReach + 1];
#pragma unroll
        for (int j = 0; j <= 2 * kReach; ++j) {
          const float2 x = cur[i + j];
          w[j] = x.x;
          sq[j] = x.y;
        }
        float d2 = 0.f, d4 = 0.f, fwd = 0.f, bwd = 0.f;
#pragma unroll
        for (int d = -3; d <= 3; ++d) d2 += t.c2[d + 3] * w[kReach + d];
#pragma unroll
        for (int d = -4; d <= 4; ++d) d4 += t.c4[d + 4] * w[kReach + d];
#pragma unroll
        for (int d = 0; d <= 4; ++d) fwd += t.fw[d] * sq[kReach + d];
#pragma unroll
        for (int d = -4; d <= 0; ++d) bwd += t.bw[d + 4] * sq[kReach + d];
        const float v = w[kReach];
        const float u_x = (v < 0.f) ? fwd : bwd;
        const float ph = sphi[i];
        const float k = -d4 - d2 - 0.5f * u_x + ph;
        const float u = su[i];
        float next;
        if (stage == 0) {
          if (kDissipation) {
            a += d2 * d2;
            b += u_x * u_x;
            c += u * ph;
          } else {
            a += u * u;
          }
          sks[i] = k;
          next = u + dt * k / 2.0f;
        } else if (stage == 1) {
          sks[i] += 2.0f * k;
          next = u + dt * k / 2.0f;
        } else if (stage == 2) {
          sks[i] += 2.0f * k;
          next = u + dt * k;
        } else {
          next = u + dt * (sks[i] + k) / 6.0f;
          su[i] = next;
        }
        put(nxt, i, n, next);
      }
      __syncwarp();
      float2* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }

  float* u_dst = u_out + static_cast<size_t>(row) * n;
  for (int i = lane; i < n; i += 32) u_dst[i] = su[i];

  const float inv_n = 1.0f / static_cast<float>(n);
  float total;
  if (kDissipation) {
    const float sa = warp_sum(a), sb = warp_sum(b), sc = warp_sum(c);
    total = -(sa * inv_n + sb * inv_n + sc * inv_n);
  } else {
    total = -(warp_sum(a) * inv_n);
  }
  if (lane == 0) rew_out[row] = total / static_cast<float>(cfg_steps);
}

template <int P>
void launch(const float* u, const float* phi, float* u_out, float* rew_out, int batch, float dt,
            int cfg_steps, bool dissipation, const Taps& taps, cudaStream_t stream) {
  if (dissipation) {
    ks_control_period_kernel<P, true><<<batch, 32, 0, stream>>>(u, phi, u_out, rew_out, dt,
                                                                 cfg_steps, taps);
  } else {
    ks_control_period_kernel<P, false><<<batch, 32, 0, stream>>>(u, phi, u_out, rew_out, dt,
                                                                  cfg_steps, taps);
  }
}

void launch_general(const float* u, const float* phi, float* u_out, float* rew_out, int batch,
                    int n, float dt, int cfg_steps, bool dissipation, const Taps& taps,
                    cudaStream_t stream) {
  const size_t smem = 2 * (n + 2 * kReach) * sizeof(float2) + 3 * n * sizeof(float);
  if (dissipation) {
    ks_control_period_general_kernel<true><<<batch, 32, smem, stream>>>(
        u, phi, u_out, rew_out, n, dt, cfg_steps, taps);
  } else {
    ks_control_period_general_kernel<false><<<batch, 32, smem, stream>>>(
        u, phi, u_out, rew_out, n, dt, cfg_steps, taps);
  }
}

}  // namespace

// One control period of a [batch, n] float32 batch, 9 <= n <= 1024: the
// register path for n = 32, 64, ..., 256, the general path for the others.
extern "C" int ks_control_period_f32(const void* u, const void* phi, void* u_out, void* rew_out,
                                     int batch, int n, float dt, int cfg_steps, int dissipation,
                                     const void* taps26, void* stream) {
  if (n < kMinN || n > kMaxN || cfg_steps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0) return 0;
  Taps taps;
  static_assert(sizeof(Taps) == 26 * sizeof(float), "Taps must hold 26 packed floats");
  std::memcpy(&taps, taps26, sizeof(Taps));

  const float* uu = static_cast<const float*>(u);
  const float* pp = static_cast<const float*>(phi);
  float* uo = static_cast<float*>(u_out);
  float* ro = static_cast<float*>(rew_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dis = dissipation != 0;
  if (n % 32 != 0 || n > 256) {
    launch_general(uu, pp, uo, ro, batch, n, dt, cfg_steps, dis, taps, s);
    return static_cast<int>(cudaGetLastError());
  }
  switch (n / 32) {
    case 1: launch<1>(uu, pp, uo, ro, batch, dt, cfg_steps, dis, taps, s); break;
    case 2: launch<2>(uu, pp, uo, ro, batch, dt, cfg_steps, dis, taps, s); break;
    case 3: launch<3>(uu, pp, uo, ro, batch, dt, cfg_steps, dis, taps, s); break;
    case 4: launch<4>(uu, pp, uo, ro, batch, dt, cfg_steps, dis, taps, s); break;
    case 5: launch<5>(uu, pp, uo, ro, batch, dt, cfg_steps, dis, taps, s); break;
    case 6: launch<6>(uu, pp, uo, ro, batch, dt, cfg_steps, dis, taps, s); break;
    case 7: launch<7>(uu, pp, uo, ro, batch, dt, cfg_steps, dis, taps, s); break;
    default: launch<8>(uu, pp, uo, ro, batch, dt, cfg_steps, dis, taps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
