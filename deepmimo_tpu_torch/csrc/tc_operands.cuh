// Operands of the tensor-core designs (beamgain.cu, render_fwd.cu) that
// their producer warps build alike: the path sum's B operand G = [gr | gi]
// of one slot, 32 paths and 64 subcarriers, split into tf32 hi and lo
// planes in wgmma.cuh's K-major layout, from separable OFDM tables.
//
// Lane layout of build_g: producer warp w (of 4), lane e + 4 t +
// 16 jh takes paths 8 w + 4 h2 + e of the chunk (h2 < 2).

#pragma once

#include <cuda_runtime.h>

#include "render_tables.cuh"
#include "wgmma.cuh"

namespace tcop {

using render::Split;

constexpr int kPc = 32;              // paths per chunk: the path sum's depth
constexpr int kKt = 64;              // subcarriers per column tile
constexpr int kNG = 2 * kKt;         // path-sum columns: (re, im) of kKt
constexpr int kGPlane = kPc * kNG;   // floats of one g plane

// The bank-conflict-free stores of build_x and build_g: a quarter warp's
// lanes jh = 0 and 1 write the two columns of a pair in turn, lanes jh = 1
// the second first. So that no value is selected per lane, lanes jh = 1
// build swap(z) = (Im z, Re z) = j conj(z) for each entry z, and every
// lane writes its value's x first, at `first`, and y at `second`.
__device__ __forceinline__ void store_split(float* h, float* l, int first,
                                            int second, float2 v) {
  const Split x = render::split(v.x), y = render::split(v.y);
  h[first] = __uint_as_float(x.hi);
  h[second] = __uint_as_float(y.hi);
  l[first] = __uint_as_float(x.lo);
  l[second] = __uint_as_float(y.lo);
}

// Producers: g of the step's slot and columns k0 .. k0 + kKt - 1 as the
// path sum's B operand [kPc x kNG] in hi and lo planes: depth p is path p
// of the chunk (the order in which the fold's accumulators lie as A
// fragments), column 8 j + 2 t + c the real (c = 0) or imaginary (c = 1)
// part of g at subcarrier 16 (j / 4) + 4 t + j % 4 of the tile, so that a
// consumer lane's sums hold four adjacent subcarriers. Separable:
// subcarrier k0 + 8 a + b has g = coarse[a] fine[b], fine[b] =
// exp(-j omega b) and coarse[a] = ca exp(j (psi - omega (k0 + 8 a))),
// ca = amp a_rx[r], a, b < 8. Warp w, lane e + 4 t + 16 jh (paths
// 8 w + 4 h2 + e, h2 < 2) computes fine and coarse of entry r = t + 4 jh;
// its value i, column block j = 2 i + jh, takes b = 4 (t % 2) + 2 (i % 2)
// + jh and a = 2 (i / 2) + t / 2 from the lanes of its path that hold
// them (lanes jh = 1: swap(coarse) conj(fine)). Columns past K hold values
// that are never stored.
__device__ __forceinline__ void build_g(const float (&om)[2],
                                        const float (&ps)[2],
                                        const float2 (&ca)[2], int k0, int w,
                                        int e, int t, int jh, float* gh) {
  const int r = t + 4 * jh;
  float ph[4];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    ph[2 * h2] = -__fmul_rn(om[h2], static_cast<float>(r));
    ph[2 * h2 + 1] = __fsub_rn(ps[h2], __fmul_rn(
                                           om[h2],
                                           static_cast<float>(k0 + 8 * r)));
  }
  float2 fc[4];
  render::phasors(ph, fc);
  const float sf = jh ? -1.f : 1.f;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const float2 cr = render::cmul(ca[h2], fc[2 * h2 + 1]);
    float2 fine[2], coarse[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = 4 * (t & 1) + 2 * i + jh;
      const int src = e + 4 * (b & 3) + 16 * (b >> 2);
      fine[i] = make_float2(__shfl_sync(~0u, fc[2 * h2].x, src),
                            sf * __shfl_sync(~0u, fc[2 * h2].y, src));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int aa = 2 * i + (t >> 1);
      const int src = e + 4 * (aa & 3) + 16 * (aa >> 2);
      const float2 c = make_float2(__shfl_sync(~0u, cr.x, src),
                                   __shfl_sync(~0u, cr.y, src));
      coarse[i] = jh ? make_float2(c.y, c.x) : c;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = wg::offset(8 * (2 * i + jh) + 2 * t,
                               8 * w + 4 * h2 + e, kNG);
      store_split(gh, gh + kGPlane, jh ? o + 4 : o, jh ? o : o + 4,
                 render::cmul(coarse[i >> 1], fine[i & 1]));
    }
  }
}

}  // namespace tcop
