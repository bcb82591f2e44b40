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
// The bound.  Per grid point and RHS evaluation the function needs 21 taps
// (u_xx 7, u_xxxx 9, and the one 5-tap upwind sum that the sign of the
// stage value picks) as FMAs in each limb pass, 8 FLOPs for the square, the
// combine and the stage input, and 7 for the limbs; with the RK4 combine
// and the reward that is 574 FLOPs per point and sub-step at bf16_3x (742
// at bf16_4x, 238 at bf16), 9.2 MFLOP per row of 64 points and 250
// sub-steps against 772 bytes in and out.  Of the 574, 504 are bf16 x bf16
// products accumulated in float32 (168 per pass), an operation the H100's
// tensor cores run at 989 TFLOP/s; the other 70 are float32 at 67 TFLOP/s.
// Each over its own peak, the kernel is operations-bound by the roofline:
// 0.025 ms per period at B=1024.  At B <= 64 it is latency-bound: a period
// is one chain of 1,000 dependent RHS evaluations, each of which needs the
// neighbours' limbs of the previous stage.
//
// The design is K1's (ks_control_period.cu), with the limbs:
//   * one launch per control period, one warp per row and one warp per
//     block (blocks = B); lane l holds the P = n/32 consecutive points
//     [l*P, l*P + P) in registers for all sub-steps (templated on P = 1..8,
//     on the limb passes and on the objective);
//   * each lane splits its own points once per RHS: the square
//     s = __fmul_rn(v, v) (rounded, so no FMA contraction reaches the lo
//     limb), one packed conversion for the word (bf16(v), bf16(s)) and one
//     for (bf16(v - v_hi), bf16(s - s_hi)); both differences are exact, so
//     the limbs carry the bits of the plain version's rounding;
//   * the stencils reach 4 points, so each RHS takes the 8 halo points'
//     limb words from the neighbouring lanes by __shfl_sync (16 shuffles at
//     3 and 4 passes, 8 at one), and (l + k) & 31 wraps the periodic grid
//     because 32 * P = n.  A halo limb is its owner's word: no limb is
//     computed twice.  No shared memory, no block barrier;
//   * every operator and every limb pass has its own accumulator: at
//     bf16_3x the -c_xxxx sum is three independent 9-FMA chains hh, hl and
//     lh (x_hi*W_hi, x_hi*W_lo, x_lo*W_hi), summed in limb_dot's pass order
//     (hh + hl) + lh (+ ll), not one chain of 27;
//   * each lane sums its points' reward terms over all sub-steps in
//     registers, and one warp reduction per term ends the period (this
//     reorders the float32 sum of the per-sub-step version).
//
// Instructions per RHS and lane at P = 2 and bf16_3x: 156 FMAs (both upwind
// sums are evaluated and one is selected: 2 points x 26 taps x 3 passes),
// 16 adds of the pass sums, 4 packed conversions (2 per own point), 16
// shuffles, 40 unpacks of a bf16 half to float (4 per point of the
// window), 2 squares, 4 limb differences and ~14 for the combine, the
// select and the stage input: ~250.  At one pass: 52 FMAs, 2 conversions,
// 8 shuffles, 20 unpacks.  Shuffling the 8 halo values instead and
// recomputing their limbs costs 8 shuffles fewer but 8 squares, 16
// conversions and 16 differences more, on a longer dependent chain; it
// measured 5-10% slower on an H100.
//
// No tensor cores.  Every limb product is bf16 x bf16 -> f32, which is what
// mma.sync computes, but its smallest tile (m16n8k16) takes 16 rows: at the
// flagship batch of 10 one warp would carry every row, and the circulant
// stencils cut into the 16 x 8 tiles they touch cost 8 column tiles x 2
// k-tiles x 4 operator blocks x 3 passes = 192 MMAs per warp and RHS, over
// a thousand cycles, against the ~250 instructions per RHS and lane above.
// Spreading the tiles over a warpgroup brings back a shared-memory exchange
// and a barrier per RHS.  They could pay only at large batches, where these
// FMAs leave most of the tensor-core bound above unused.
//
// That register path takes n = 32, 64, ..., 256.  Every other grid of 9 to
// 1,024 points runs the general path further down, K1's general path with
// the limbs: each point's limb words are split once per RHS by its owner
// and read by its neighbours from a shared-memory window, not shuffled.
//
// Plain C interface (built with nvcc into a shared library, called through
// ctypes); it returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kReach = 4;  // the widest stencil, -c_xxxx, spans -4..4

// hi and lo bf16 limbs (stored as float) of the operators' nonzero entries.
struct LimbTaps {
  float c2h[7], c2l[7];  // -c_xx,   offsets -3..3
  float c4h[9], c4l[9];  // -c_xxxx, offsets -4..4
  float fwh[5], fwl[5];  // forward upwind of u^2, offsets 0..4
  float bwh[5], bwl[5];  // backward upwind of u^2, offsets -4..0
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// The limb words of stage value v: hi = (bf16(v), bf16(s)) and
// lo = (bf16(v - v_hi), bf16(s - s_hi)), s the float32 square.  lo is not
// written at one pass.
template <int kPasses>
__device__ __forceinline__ void split(float v, __nv_bfloat162& hi, __nv_bfloat162& lo) {
  const float s = __fmul_rn(v, v);
  hi = __floats2bfloat162_rn(v, s);
  if (kPasses >= 3) lo = __floats2bfloat162_rn(v - __low2float(hi), s - __high2float(hi));
}

// One stencil's limb product: taps (wh, wl) against the limbs (xh, xl) of
// window points j0, j0 + 1, ...  Each pass has its own accumulator, and the
// passes are summed in limb_dot's order.
template <int kPasses, int kTaps, int W>
__device__ __forceinline__ float limb_sum(const float (&wh)[kTaps], const float (&wl)[kTaps],
                                          const float (&xh)[W], const float (&xl)[W], int j0) {
  float hh = 0.f, hl = 0.f, lh = 0.f, ll = 0.f;
#pragma unroll
  for (int d = 0; d < kTaps; ++d) {
    hh = fmaf(wh[d], xh[j0 + d], hh);
    if (kPasses >= 3) {
      hl = fmaf(wl[d], xh[j0 + d], hl);
      lh = fmaf(wh[d], xl[j0 + d], lh);
      if (kPasses == 4) ll = fmaf(wl[d], xl[j0 + d], ll);
    }
  }
  if (kPasses == 1) return hh;
  const float y = (hh + hl) + lh;
  return (kPasses == 4) ? y + ll : y;
}

// One RHS evaluation at the stage values v[P] of this lane's points.  Writes
// the RHS of each point to k, and its upwind u_x and -c_xx product to ux,
// neg_uxx (read only for the reward of the first stage).
template <int P, int kPasses>
__device__ __forceinline__ void rhs(const float (&v)[P], const float (&phi)[P], int lane,
                                    const LimbTaps& t, float (&k)[P], float (&ux)[P],
                                    float (&neg_uxx)[P]) {
  // The window [4 halo | P own | 4 halo] of limb words.
  constexpr int W = P + 2 * kReach;
  __nv_bfloat162 hi[W], lo[W];
#pragma unroll
  for (int p = 0; p < P; ++p) split<kPasses>(v[p], hi[kReach + p], lo[kReach + p]);
  // Halo point h (1..4) to the left is point lP - h, held by lane l - q at
  // index qP - h, where q = ceil(h / P); to the right, point lP + P - 1 + h
  // is held by lane l + q at index h - 1 - (q - 1)P.  They are fetched in
  // the order the tap sums consume them, leftmost first.
#pragma unroll
  for (int h = kReach; h >= 1; --h) {
    const int q = (h + P - 1) / P;
    const int src = (lane - q) & 31, j = kReach + q * P - h;
    hi[kReach - h] = __shfl_sync(kFullMask, hi[j], src);
    if (kPasses >= 3) lo[kReach - h] = __shfl_sync(kFullMask, lo[j], src);
  }
#pragma unroll
  for (int h = 1; h <= kReach; ++h) {
    const int q = (h + P - 1) / P;
    const int src = (lane + q) & 31, j = kReach + h - 1 - (q - 1) * P;
    hi[kReach + P - 1 + h] = __shfl_sync(kFullMask, hi[j], src);
    if (kPasses >= 3) lo[kReach + P - 1 + h] = __shfl_sync(kFullMask, lo[j], src);
  }

  // The limbs as float: value hi and lo, square hi and lo.
  float vh[W], vl[W], sh[W], sl[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    vh[j] = __low2float(hi[j]);
    sh[j] = __high2float(hi[j]);
    if (kPasses >= 3) {
      vl[j] = __low2float(lo[j]);
      sl[j] = __high2float(lo[j]);
    }
  }

#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = kReach + p;
    const float d2 = limb_sum<kPasses>(t.c2h, t.c2l, vh, vl, c - 3);
    const float d4 = limb_sum<kPasses>(t.c4h, t.c4l, vh, vl, c - 4);
    const float fwd = limb_sum<kPasses>(t.fwh, t.fwl, sh, sl, c);
    const float bwd = limb_sum<kPasses>(t.bwh, t.bwl, sh, sl, c - 4);
    const float u_x = (v[p] < 0.f) ? fwd : bwd;
    ux[p] = u_x;
    neg_uxx[p] = d2;
    k[p] = (d2 + d4) - 0.5f * u_x + phi[p];
  }
}

template <int P, int kPasses, bool kDissipation>
__global__ void __launch_bounds__(32)
ks_control_period_limb_kernel(const float* __restrict__ u_in, const float* __restrict__ phi_in,
                              float* __restrict__ u_out, float* __restrict__ rew_out, float dt,
                              int cfg_steps, LimbTaps taps) {
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
  // l2control a = u^2; dissipation a = u_xx^2 (the square of the -c_xx
  // product), b = u_x^2, c = u*phi.
  float a = 0.f, b = 0.f, c = 0.f;
  float k1[P], k2[P], k3[P], k4[P], ux[P], nxx[P], stage[P];

  for (int s = 0; s < cfg_steps; ++s) {
    rhs<P, kPasses>(u, phi, lane, taps, k1, ux, nxx);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (kDissipation) {
        a += nxx[p] * nxx[p];
        b += ux[p] * ux[p];
        c += u[p] * phi[p];
      } else {
        a += u[p] * u[p];
      }
      stage[p] = u[p] + dt * k1[p] / 2.0f;
    }
    rhs<P, kPasses>(stage, phi, lane, taps, k2, ux, nxx);
#pragma unroll
    for (int p = 0; p < P; ++p) stage[p] = u[p] + dt * k2[p] / 2.0f;
    rhs<P, kPasses>(stage, phi, lane, taps, k3, ux, nxx);
#pragma unroll
    for (int p = 0; p < P; ++p) stage[p] = u[p] + dt * k3[p];
    rhs<P, kPasses>(stage, phi, lane, taps, k4, ux, nxx);
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
// take (not a multiple of 32, or above 256).  K1's general path
// (ks_control_period.cu) with the limbs:
//
//   * one warp per row and per block; lane l owns the points l, l + 32, ...
//     < n; a point's u, phi, running RK4 sum and current stage value sit in
//     dynamic shared memory, touched only by its owner;
//   * each RHS the owner splits its point's stage value once (split<>, as
//     above) and writes the two limb words (hi, lo) into a shared window
//     [4 halo | n points | 4 halo], the periodic halo as second copies; the
//     neighbours read the words from there, so no limb is computed twice.
//     Two windows alternate, with one __syncwarp() per RHS (see K1);
//   * the tap sums are limb_sum<> over a 9-point window of unpacked limbs:
//     the same taps, one accumulator per limb pass, limb_dot's pass order;
//   * the reward is summed per lane and reduced once per period on the
//     full mask (lanes that own no point add zero).
// Shared memory: 2 (n + 8) x 8 bytes of limb words + 4n floats, 32.9 KB at
// n = 1,024, under the 48 KB a block has without an opt-in.
constexpr int kMinN = 9;
constexpr int kMaxN = 1024;

__device__ __forceinline__ unsigned bits(__nv_bfloat162 h) {
  unsigned w;
  std::memcpy(&w, &h, sizeof w);
  return w;
}

// The limb words of stage value v of point i into window w (and into the
// periodic halo where point i lies within 4 of either end): x = the hi word
// (bf16(v) in the low half, bf16(s) in the high half), y = the lo word (0
// at one pass).
template <int kPasses>
__device__ __forceinline__ void put_limbs(uint2* w, int i, int n, float v) {
  __nv_bfloat162 hi, lo;
  split<kPasses>(v, hi, lo);
  const uint2 x = make_uint2(bits(hi), kPasses >= 3 ? bits(lo) : 0u);
  w[kReach + i] = x;
  if (i < kReach) w[kReach + n + i] = x;
  if (i >= n - kReach) w[i - (n - kReach)] = x;
}

template <int kPasses, bool kDissipation>
__global__ void __launch_bounds__(32)
ks_control_period_limb_general_kernel(const float* __restrict__ u_in,
                                      const float* __restrict__ phi_in,
                                      float* __restrict__ u_out, float* __restrict__ rew_out,
                                      int n, float dt, int cfg_steps, LimbTaps t) {
  extern __shared__ uint2 smem_words[];
  constexpr int kW = 2 * kReach + 1;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const int wn = n + 2 * kReach;
  uint2* cur = smem_words;
  uint2* nxt = smem_words + wn;
  float* su = reinterpret_cast<float*>(smem_words + 2 * wn);
  float* sphi = su + n;
  float* sks = sphi + n;
  float* sv = sks + n;  // the point's current stage value

  const float* u_row = u_in + static_cast<size_t>(row) * n;
  const float* phi_row = phi_in + static_cast<size_t>(row) * n;
  for (int i = lane; i < n; i += 32) {
    const float v = u_row[i];
    su[i] = v;
    sv[i] = v;
    sphi[i] = phi_row[i];
    put_limbs<kPasses>(cur, i, n, v);
  }
  __syncwarp();

  // This lane's reward terms, as in the register path.
  float a = 0.f, b = 0.f, c = 0.f;
  for (int s = 0; s < cfg_steps; ++s) {
#pragma unroll
    for (int stage = 0; stage < 4; ++stage) {
      for (int i = lane; i < n; i += 32) {
        // The window's limbs as float: value hi and lo, square hi and lo.
        float vh[kW], vl[kW], sh[kW], sl[kW];
#pragma unroll
        for (int j = 0; j < kW; ++j) {
          const uint2 x = cur[i + j];
          vh[j] = __uint_as_float(x.x << 16);
          sh[j] = __uint_as_float(x.x & 0xffff0000u);
          if (kPasses >= 3) {
            vl[j] = __uint_as_float(x.y << 16);
            sl[j] = __uint_as_float(x.y & 0xffff0000u);
          }
        }
        const float d2 = limb_sum<kPasses>(t.c2h, t.c2l, vh, vl, kReach - 3);
        const float d4 = limb_sum<kPasses>(t.c4h, t.c4l, vh, vl, 0);
        const float fwd = limb_sum<kPasses>(t.fwh, t.fwl, sh, sl, kReach);
        const float bwd = limb_sum<kPasses>(t.bwh, t.bwl, sh, sl, 0);
        const float v = sv[i];
        const float u_x = (v < 0.f) ? fwd : bwd;
        const float ph = sphi[i];
        const float k = (d2 + d4) - 0.5f * u_x + ph;
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
        sv[i] = next;
        put_limbs<kPasses>(nxt, i, n, next);
      }
      __syncwarp();
      uint2* tmp = cur;
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

template <int kPasses>
void launch_general(const float* u, const float* phi, float* u_out, float* rew_out, int batch,
                    int n, float dt, int cfg_steps, bool dissipation, const LimbTaps& taps,
                    cudaStream_t stream) {
  const size_t smem = 2 * (n + 2 * kReach) * sizeof(uint2) + 4 * n * sizeof(float);
  if (dissipation) {
    ks_control_period_limb_general_kernel<kPasses, true><<<batch, 32, smem, stream>>>(
        u, phi, u_out, rew_out, n, dt, cfg_steps, taps);
  } else {
    ks_control_period_limb_general_kernel<kPasses, false><<<batch, 32, smem, stream>>>(
        u, phi, u_out, rew_out, n, dt, cfg_steps, taps);
  }
}

template <int P, int kPasses>
void launch(const float* u, const float* phi, float* u_out, float* rew_out, int batch, float dt,
            int cfg_steps, bool dissipation, const LimbTaps& taps, cudaStream_t stream) {
  if (dissipation) {
    ks_control_period_limb_kernel<P, kPasses, true><<<batch, 32, 0, stream>>>(
        u, phi, u_out, rew_out, dt, cfg_steps, taps);
  } else {
    ks_control_period_limb_kernel<P, kPasses, false><<<batch, 32, 0, stream>>>(
        u, phi, u_out, rew_out, dt, cfg_steps, taps);
  }
}

template <int kPasses>
void launch_passes(const float* u, const float* phi, float* u_out, float* rew_out, int batch,
                   int n, float dt, int cfg_steps, bool dis, const LimbTaps& taps,
                   cudaStream_t s) {
  if (n % 32 != 0 || n > 256) {
    launch_general<kPasses>(u, phi, u_out, rew_out, batch, n, dt, cfg_steps, dis, taps, s);
    return;
  }
  switch (n / 32) {
    case 1: launch<1, kPasses>(u, phi, u_out, rew_out, batch, dt, cfg_steps, dis, taps, s); break;
    case 2: launch<2, kPasses>(u, phi, u_out, rew_out, batch, dt, cfg_steps, dis, taps, s); break;
    case 3: launch<3, kPasses>(u, phi, u_out, rew_out, batch, dt, cfg_steps, dis, taps, s); break;
    case 4: launch<4, kPasses>(u, phi, u_out, rew_out, batch, dt, cfg_steps, dis, taps, s); break;
    case 5: launch<5, kPasses>(u, phi, u_out, rew_out, batch, dt, cfg_steps, dis, taps, s); break;
    case 6: launch<6, kPasses>(u, phi, u_out, rew_out, batch, dt, cfg_steps, dis, taps, s); break;
    case 7: launch<7, kPasses>(u, phi, u_out, rew_out, batch, dt, cfg_steps, dis, taps, s); break;
    default: launch<8, kPasses>(u, phi, u_out, rew_out, batch, dt, cfg_steps, dis, taps, s);
  }
}

}  // namespace

// One control period of a [batch, n] float32 batch at 1, 3 or 4 limb
// passes, 9 <= n <= 1024: the register path for n = 32, 64, ..., 256, the
// general path for the others.
extern "C" int ks_control_period_limb(const void* u, const void* phi, void* u_out,
                                      void* rew_out, int batch, int n, float dt, int cfg_steps,
                                      int dissipation, int passes, const void* taps52,
                                      void* stream) {
  if (n < kMinN || n > kMaxN || cfg_steps < 1) {
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
    launch_passes<1>(uu, pp, uo, ro, batch, n, dt, cfg_steps, dis, taps, s);
  } else if (passes == 3) {
    launch_passes<3>(uu, pp, uo, ro, batch, n, dt, cfg_steps, dis, taps, s);
  } else {
    launch_passes<4>(uu, pp, uo, ro, batch, n, dt, cfg_steps, dis, taps, s);
  }
  return static_cast<int>(cudaGetLastError());
}
