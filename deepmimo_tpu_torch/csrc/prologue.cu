// Prologue of the fused render and beam-gain kernels: a call's per-path
// fields in, the seven per-path inputs of csrc/render_fwd.cu and
// csrc/beamgain.cu out, in one pass over memory.
//
// Replaces no TPU kernel. The JAX package leaves this arithmetic (the
// fused renderers' prologue in deepmimo_tpu/ops/channel.py) to XLA, which
// fuses it; as PyTorch ops it took ~100 launches a call. ops/channel.py
// (_fused_inputs, _polar_fused_inputs) keeps those ops for the calls this
// kernel does not take. For user u, path p and polarization slot n of N
// (N = 1 for a single-polarized call):
//
//   (y', z')  the arrival direction in the UE panel's rotated frame
//             (z-axis first, then y, then x), the departure direction in
//             the BS panel's
//   gry, grz  = valid ? 2 pi spacing_ue (y', z') : 0, likewise gty, gtz
//   delay_n   = delay * bandwidth,   omega0 = (2 pi / n_fft) delay_n
//   omega     = omega0 * stride
//   amp[n]    = valid && delay_n < n_fft
//               ? sqrt((valid ? 10^(power[n] / 10) : 0) / n_fft) : 0
//   psi[n]    = deg2rad(phase[n]) - omega0 * k0, the phase taken as 0 on
//               invalid paths where the stacks are NaN-padded (mask_phase)
//
// amp and psi lie pol-major on the kernels' slot axis, [U, N*P] with
// slot n at columns n*P .. n*P + P - 1. This is the PyTorch prologue's
// arithmetic op for op in float32: every op rounded once (__fmul_rn and
// its kin, so that nvcc contracts nothing into an FMA), a division by a
// scalar as PyTorch's CUDA ops take it (a product with the float
// reciprocal), precise sincosf, powf and sqrtf (no fast-math intrinsics).
//
// What bounds it on an H100: HBM bytes. At the headline (131,072 users x
// 25 paths, one slot) it reads 7 float32 fields and the bool mask and
// writes 7 float32 arrays, 57 bytes a path, 187 MB: 0.056 ms at 3.35 TB/s.
// With four slots it reads 13 floats and the mask and writes 13 floats a
// path, 344 MB: 0.103 ms. Its ~8 sincosf, a powf a slot and a sqrtf a slot
// per path come to ~1 GFLOP, far under the FP32 rate.
//
// Design: one thread per (user, path), 256 a block. Neighbouring threads
// take neighbouring paths of a user, so each warp's reads and writes are
// coalesced; the fields are read at their row stride, so a view of the
// paths trimmed to fewer slots needs no copy. The panels' rotations ([3]
// or [U, 3]) and spacings are read on the device: the host copies nothing
// and waits for nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// float(pi / 180) and float(2 pi): the float32 scalars of torch.deg2rad
// and of kd = 2 pi spacing.
constexpr float kDegToRad = 0.017453292519943295f;
constexpr float kTwoPi = 6.283185307179586f;

struct Args {
  const float* delay;
  const unsigned char* valid;
  const float* aoa_el;
  const float* aoa_az;
  const float* aod_el;
  const float* aod_az;
  const float* power;
  const float* phase;
  const float* rot_ue;
  const float* rot_bs;
  const float* spacing_ue;
  const float* spacing_bs;
  float* gry;
  float* grz;
  float* gty;
  float* gtz;
  float* amp;
  float* psi;
  float* omega;
  int n_users, n_paths, ld, n_pol, pol_stride, pol_ld, rot_ue_ld, rot_bs_ld;
  int mask_phase;
  float n_fft, inv_n_fft, omega_scale, k0, stride, bandwidth;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// kd (y', z'): the unit vector of (el, az) (degrees) in the frame of the
// Euler rotation rot (degrees), as ops/geometry.py
// _rotated_unit_components computes it, scaled by kd.
__device__ __forceinline__ void rotated_steps(const float* rot, float kd,
                                              float el, float az, float& gy,
                                              float& gz) {
  const float rot_x = mul(rot[0], kDegToRad);
  const float rot_y = mul(rot[1], kDegToRad);
  const float rot_z = mul(rot[2], kDegToRad);
  float sin_az, cos_az, sin_y, cos_y, sin_x, cos_x, sin_t, cos_t;
  sincosf(sub(mul(az, kDegToRad), rot_z), &sin_az, &cos_az);
  sincosf(rot_y, &sin_y, &cos_y);
  sincosf(rot_x, &sin_x, &cos_x);
  sincosf(mul(el, kDegToRad), &sin_t, &cos_t);
  const float z = add(mul(mul(cos_y, cos_x), cos_t),
                      mul(sin_t, sub(mul(mul(sin_y, cos_x), cos_az),
                                     mul(sin_x, sin_az))));
  const float y = add(mul(mul(cos_y, sin_x), cos_t),
                      mul(sin_t, add(mul(mul(sin_y, sin_x), cos_az),
                                     mul(cos_x, sin_az))));
  gy = mul(kd, y);
  gz = mul(kd, z);
}

__global__ void __launch_bounds__(kThreads) prologue_kernel(const Args a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(a.n_users) * a.n_paths) return;
  const int u = static_cast<int>(i / a.n_paths);
  const int p = static_cast<int>(i - static_cast<long long>(u) * a.n_paths);
  const long long in = static_cast<long long>(u) * a.ld + p;
  const bool valid = a.valid[in] != 0;

  float gy, gz;
  rotated_steps(a.rot_ue + static_cast<long long>(u) * a.rot_ue_ld,
                mul(kTwoPi, *a.spacing_ue), a.aoa_el[in], a.aoa_az[in], gy,
                gz);
  a.gry[i] = valid ? gy : 0.0f;
  a.grz[i] = valid ? gz : 0.0f;
  rotated_steps(a.rot_bs + static_cast<long long>(u) * a.rot_bs_ld,
                mul(kTwoPi, *a.spacing_bs), a.aod_el[in], a.aod_az[in], gy,
                gz);
  a.gty[i] = valid ? gy : 0.0f;
  a.gtz[i] = valid ? gz : 0.0f;

  const float delay_n = mul(a.delay[in], a.bandwidth);
  const bool pvalid = valid && delay_n < a.n_fft;
  const float omega0 = mul(a.omega_scale, delay_n);
  a.omega[i] = mul(omega0, a.stride);
  const float shift = mul(omega0, a.k0);
  const bool phase_zero = a.mask_phase && !valid;
  const long long out =
      static_cast<long long>(u) * a.n_pol * a.n_paths + p;
  for (int n = 0; n < a.n_pol; ++n) {
    const long long src = static_cast<long long>(n) * a.pol_stride +
                          static_cast<long long>(u) * a.pol_ld + p;
    const float p_lin = valid ? powf(10.0f, mul(a.power[src], 0.1f)) : 0.0f;
    const float phase = phase_zero ? 0.0f : a.phase[src];
    const long long o = out + static_cast<long long>(n) * a.n_paths;
    a.amp[o] = pvalid ? sqrtf(mul(p_lin, a.inv_n_fft)) : 0.0f;
    a.psi[o] = sub(mul(phase, kDegToRad), shift);
  }
}

}  // namespace

// Launches the prologue on `stream`. Pointers are device pointers: the
// path fields delay, aoa_el, aoa_az, aod_el, aod_az (float32) and valid
// (bool) [U, P] at row stride `ld`; power and phase (float32) [N, U, P] at
// slot stride `pol_stride` and row stride `pol_ld`; the rotations
// (degrees) [3] (`rot_*_ld` 0) or [U, 3] (`rot_*_ld` 3); the spacings one
// float each; the outputs contiguous: gry..gtz and omega [U, P], amp and
// psi [U, N*P]. Returns the cudaError_t of the launch (0 on success); the
// kernel is not waited for.
extern "C" int prologue_launch(
    const float* delay, const unsigned char* valid, const float* aoa_el,
    const float* aoa_az, const float* aod_el, const float* aod_az,
    const float* power, const float* phase, const float* rot_ue,
    const float* rot_bs, const float* spacing_ue, const float* spacing_bs,
    float* gry, float* grz, float* gty, float* gtz, float* amp, float* psi,
    float* omega, int n_users, int n_paths, int ld, int n_pol,
    int pol_stride, int pol_ld, int rot_ue_ld, int rot_bs_ld, int n_fft,
    int k0, int stride, int mask_phase, float bandwidth, void* stream) {
  const long long n = static_cast<long long>(n_users) * n_paths;
  if (n == 0) return cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff || n_pol < 1 || n_fft < 1) {
    return cudaErrorInvalidValue;
  }
  const Args a{delay, valid, aoa_el, aoa_az, aod_el, aod_az, power, phase,
               rot_ue, rot_bs, spacing_ue, spacing_bs, gry, grz, gty, gtz,
               amp, psi, omega, n_users, n_paths, ld, n_pol, pol_stride,
               pol_ld, rot_ue_ld, rot_bs_ld, mask_phase,
               static_cast<float>(n_fft),
               1.0f / static_cast<float>(n_fft),
               static_cast<float>(2.0 * 3.141592653589793 / n_fft),
               static_cast<float>(k0), static_cast<float>(stride),
               bandwidth};
  prologue_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
