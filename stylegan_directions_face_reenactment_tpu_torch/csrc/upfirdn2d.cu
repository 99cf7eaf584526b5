// upfirdn2d for (up, down) in {(1, 1), (2, 1), (1, 2)} on NCHW planes, f32
// and bf16.
//
// Replaces the Pallas TPU kernel
// stylegan_directions_face_reenactment_tpu/ops/pallas_upfirdn.py::_forward
// (up in {1, 2}, down 1) and the XLA upfirdn2d of that file's `_backward`,
// the gradient of the forward: the cotangent through the flipped taps with up
// and down swapped, so the backward of the 2x upsample is a down = 2 call and
// the backward of the blur an up = down = 1 call.
//
// What it computes, per spatial axis: zero-stuff the input by `up`, pad by
// (p0, p1), convolve with the FIR taps (a true convolution, so the taps are
// flipped), keep every `down`-th sample. Written polyphase: output `o` takes
// the flipped taps `j` with (o * down - p0 + j) = 0 (mod up) from input
// (o * down - p0 + j) / up, so nothing is zero-stuffed or computed and then
// dropped in memory.
//
// What bounds it on an H100: bytes. Each output reads at most 16 inputs
// (4 with up = 2) and does as many FMAs, far below the 295 FLOP/byte where the
// card's arithmetic would matter. The least time is one read of the input and
// one write of the output at the card's memory rate.
//
// What the design does about that: one thread per output element, with
// neighbouring threads on neighbouring output columns, so the reads of a warp
// fall on one or two cache lines of an input row (two to four with down = 2,
// whose outputs step two inputs apart) and the 4x4 neighbourhood is served
// from L1 after the first touch; every input byte comes from device memory
// about once. The taps ride in the kernel's parameter space (constant
// bank), so no device buffer is allocated. The block shape is cut to the
// plane for the small planes (4x4 .. 32x32) so few threads idle. The TPU
// kernel's width padding, row-band DMA double-buffering and phase interleave
// were artifacts of VMEM tiling and are not carried over.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 4;

struct Taps {
  float v[kMaxTaps * kMaxTaps];  // flipped taps, row-major, stride kMaxTaps
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int UP, int DOWN>
__global__ void upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y,
                                 int planes, int in_h, int in_w, int out_h,
                                 int out_w, int pad_x0, int pad_y0, int kh,
                                 int kw, Taps taps) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= out_w || oy >= out_h) return;
  for (int64_t plane = blockIdx.z; plane < planes; plane += gridDim.z) {
    const T* xp = x + plane * in_h * in_w;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxTaps; ++j) {
      if (j >= kh) break;
      const int ty = oy * DOWN + j - pad_y0;  // row in the zero-stuffed input
      if (ty < 0 || ty % UP != 0) continue;
      const int iy = ty / UP;
      if (iy >= in_h) continue;
#pragma unroll
      for (int i = 0; i < kMaxTaps; ++i) {
        if (i >= kw) break;
        const int tx = ox * DOWN + i - pad_x0;
        if (tx < 0 || tx % UP != 0) continue;
        const int ix = tx / UP;
        if (ix >= in_w) continue;
        acc += taps.v[j * kMaxTaps + i] * to_f32(xp[(int64_t)iy * in_w + ix]);
      }
    }
    y[plane * out_h * out_w + (int64_t)oy * out_w + ox] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* x, void* y, int planes, int in_h, int in_w, int out_h,
           int out_w, int up, int down, int pad_x0, int pad_y0, int kh, int kw,
           const float* taps, void* stream) {
  const bool supported = (up == 1 && down == 1) || (up == 2 && down == 1) ||
                         (up == 1 && down == 2);
  if (!supported || kh < 1 || kw < 1 || kh > kMaxTaps || kw > kMaxTaps ||
      planes < 1 || out_h < 1 || out_w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Taps t;
  for (int i = 0; i < kMaxTaps * kMaxTaps; ++i) t.v[i] = taps[i];
  int bx = 32;
  while (bx > 1 && bx / 2 >= out_w) bx /= 2;
  int by = 256 / bx;
  while (by > 1 && by / 2 >= out_h) by /= 2;
  const dim3 block(bx, by);
  const dim3 grid((out_w + bx - 1) / bx, (out_h + by - 1) / by,
                  planes < 65535 ? planes : 65535);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (up == 2) {
    upfirdn2d_kernel<T, 2, 1><<<grid, block, 0, s>>>(xt, yt, planes, in_h, in_w, out_h,
                                                     out_w, pad_x0, pad_y0, kh, kw, t);
  } else if (down == 2) {
    upfirdn2d_kernel<T, 1, 2><<<grid, block, 0, s>>>(xt, yt, planes, in_h, in_w, out_h,
                                                     out_w, pad_x0, pad_y0, kh, kw, t);
  } else {
    upfirdn2d_kernel<T, 1, 1><<<grid, block, 0, s>>>(xt, yt, planes, in_h, in_w, out_h,
                                                     out_w, pad_x0, pad_y0, kh, kw, t);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int upfirdn2d_f32(const void* x, void* y, int planes, int in_h, int in_w,
                             int out_h, int out_w, int up, int down, int pad_x0,
                             int pad_y0, int kh, int kw, const float* taps,
                             void* stream) {
  return launch<float>(x, y, planes, in_h, in_w, out_h, out_w, up, down, pad_x0,
                       pad_y0, kh, kw, taps, stream);
}

extern "C" int upfirdn2d_bf16(const void* x, void* y, int planes, int in_h, int in_w,
                              int out_h, int out_w, int up, int down, int pad_x0,
                              int pad_y0, int kh, int kw, const float* taps,
                              void* stream) {
  return launch<__nv_bfloat16>(x, y, planes, in_h, in_w, out_h, out_w, up, down,
                               pad_x0, pad_y0, kh, kw, taps, stream);
}
