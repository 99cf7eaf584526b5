// Fused bias + LeakyReLU + gain, forward: y = leaky_relu(x + b[c], slope) * scale.
//
// Replaces the Pallas TPU kernel
// stylegan_directions_face_reenactment_tpu/ops/fused_act.py::_pallas_fwd_call
// (body `_fwd_kernel`).
//
// Layout: the bias lies on dim 1 of a contiguous tensor, so element i has
// channel (i / inner) % C, with inner = H*W for NCHW and 1 for (B, C).
//
// What bounds it on an H100: bytes. Two flops an element against 4 (bf16) or
// 8 (f32) bytes moved; the least time is one read of x and one write of y at
// the card's memory rate (the bias is C values and stays in cache).
//
// What the design does about that: one pass, so the add, the activation and
// the gain cost one read and one write instead of the three passes eager
// PyTorch would make. Where H*W is a multiple of 4 and the pointers allow it,
// each thread moves 4 elements of one channel with one 16-byte (f32) or
// 8-byte (bf16) access; otherwise one element a thread. A grid-stride loop
// keeps the grid at a few waves of the 132 SMs. Arithmetic is in f32 and is
// rounded once on the store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float act(float v, float slope, float scale) {
  v = v >= 0.f ? v : v * slope;
  return v * scale;
}

template <typename T>
__global__ void bias_act_kernel(const T* __restrict__ x, const T* __restrict__ b,
                                T* __restrict__ y, int64_t n, int channels,
                                int64_t inner, float slope, float scale) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float v = to_f32(x[i]);
    if (b != nullptr) v += to_f32(b[(i / inner) % channels]);
    y[i] = from_f32<T>(act(v, slope, scale));
  }
}

struct alignas(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

// Four consecutive elements of one channel a thread (inner % 4 == 0).
template <typename T>
__global__ void bias_act_vec4_kernel(const T* __restrict__ x, const T* __restrict__ b,
                                     T* __restrict__ y, int64_t n4, int channels,
                                     int64_t inner4, float slope, float scale) {
  using V = typename std::conditional<std::is_same<T, float>::value, float4, Bf16x4>::type;
  const V* xv = reinterpret_cast<const V*>(x);
  V* yv = reinterpret_cast<V*>(y);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const float bias = b != nullptr ? to_f32(b[(i / inner4) % channels]) : 0.f;
    const V v = xv[i];
    V o;
    if constexpr (std::is_same<T, float>::value) {
      o.x = act(v.x + bias, slope, scale);
      o.y = act(v.y + bias, slope, scale);
      o.z = act(v.z + bias, slope, scale);
      o.w = act(v.w + bias, slope, scale);
    } else {
      const float2 lo = __bfloat1622float2(v.lo);
      const float2 hi = __bfloat1622float2(v.hi);
      o.lo = __floats2bfloat162_rn(act(lo.x + bias, slope, scale),
                                   act(lo.y + bias, slope, scale));
      o.hi = __floats2bfloat162_rn(act(hi.x + bias, slope, scale),
                                   act(hi.y + bias, slope, scale));
    }
    yv[i] = o;
  }
}

int grid_for(int64_t work, int threads) {
  const int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = 132 * 32;  // a few waves of the SMs; the loop strides the rest
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <typename T>
int launch(const void* x, const void* bias, void* y, int64_t n, int channels,
           int64_t inner, float slope, float scale, void* stream) {
  if (n < 1 || channels < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  T* yt = static_cast<T*>(y);
  constexpr int threads = 256;
  constexpr uintptr_t align = 4 * sizeof(T);
  const bool vec = inner % 4 == 0 && reinterpret_cast<uintptr_t>(x) % align == 0 &&
                   reinterpret_cast<uintptr_t>(y) % align == 0;
  if (vec) {
    const int64_t n4 = n / 4;
    bias_act_vec4_kernel<T><<<grid_for(n4, threads), threads, 0, s>>>(
        xt, bt, yt, n4, channels, inner / 4, slope, scale);
  } else {
    bias_act_kernel<T><<<grid_for(n, threads), threads, 0, s>>>(
        xt, bt, yt, n, channels, inner, slope, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_bias_act_f32(const void* x, const void* bias, void* y, int64_t n,
                                  int channels, int64_t inner, float slope,
                                  float scale, void* stream) {
  return launch<float>(x, bias, y, n, channels, inner, slope, scale, stream);
}

extern "C" int fused_bias_act_bf16(const void* x, const void* bias, void* y, int64_t n,
                                   int channels, int64_t inner, float slope,
                                   float scale, void* stream) {
  return launch<__nv_bfloat16>(x, bias, y, n, channels, inner, slope, scale, stream);
}
