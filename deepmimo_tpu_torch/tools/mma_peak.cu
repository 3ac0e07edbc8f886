// Rate of mma.sync m16n8k8 TF32 products on the card: each warp issues
// 8 independent products per step (render_tables.cuh's mma_tf32), at 4
// blocks per SM of 4 to 32 warps. Built and run by tools/ablate.py.
#include <cuda_runtime.h>
#include <cstdio>
#include "render_tables.cuh"
using namespace render;
__global__ void k(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a = threadIdx.x, b = blockIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(acc[j], a, a + j, a ^ j, a, b, b + j);
  }
  float s = 0;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 1.2345f) out[0] = s;
}
int main() {
  float* out; cudaMalloc(&out, 4);
  int n_sm; cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, 0);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  for (int warps : {4, 8, 16, 32}) {
    int iters = 20000;
    k<<<n_sm * 4, warps * 8>>>(out, 10);
    cudaEventRecord(e0);
    k<<<n_sm * 4, warps * 8>>>(out, iters);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    double mmas = double(n_sm) * 4 * warps * 8 / 32 * iters * 8;
    printf("mma.sync tf32 m16n8k8: %d warps/SM: %.3f ms, %.3e mma/s, %.2f TFLOP/s\n",
           warps, ms, mmas / ms * 1e3, mmas * 2048 / ms / 1e9);
  }
  return 0;
}
