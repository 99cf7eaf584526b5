// Fused bias + LeakyReLU + gain, forward: y = leaky_relu(x + b[c], slope) * scale,
// and its backward: dx = g * scale where y >= 0, g * scale * slope elsewhere.
//
// Replaces the Pallas TPU kernels
// stylegan_directions_face_reenactment_tpu/ops/fused_act.py::_pallas_fwd_call
// (body `_fwd_kernel`) and `_pallas_bwd_call` (body `_bwd_kernel`). As there,
// the backward takes its mask from the sign of the saved output (scale > 0,
// so y >= 0 iff x + b >= 0): only y is kept for the backward, never x. The
// bias gradient, a sum of dx over every dim but the channel's, is left to a
// PyTorch reduction, as the JAX package leaves it to XLA outside its kernel.
//
// Layout: the bias lies on dim 1 of a contiguous tensor, so element i has
// channel (i / inner) % C, with inner = H*W for NCHW and 1 for (B, C).
//
// What bounds it on an H100: bytes. Two flops an element against 4 (bf16) or
// 8 (f32) bytes moved; the least time is one read of x and one write of y at
// the card's memory rate (the bias is C values and stays in cache). The
// backward, one compare and one multiply an element, reads g and y and
// writes dx: 6 (bf16) or 12 (f32) bytes an element.
//
// What the design does about that: one pass, so the add, the activation and
// the gain cost one read and one write instead of the three passes eager
// PyTorch would make. Where H*W is a multiple of 4 and the pointers allow it,
// each thread moves 4 elements of one channel with one 16-byte (f32) or
// 8-byte (bf16) access; otherwise one element a thread. A grid-stride loop
// keeps the grid at a few waves of the 132 SMs. Arithmetic is in f32 and is
// rounded once on the store. The backward has the same shape: one pass, 4
// elements a thread with 16- or 8-byte accesses where n is a multiple of 4
// and the pointers allow it; its two gains (scale, scale * slope) come in
// as f32 values computed once on the host, so the plain version's products
// are the same to the last bit.
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

__device__ __forceinline__ float act_grad(float g, float y, float gain_pos,
                                          float gain_neg) {
  return g * (y >= 0.f ? gain_pos : gain_neg);
}

template <typename T>
__global__ void bias_act_bwd_kernel(const T* __restrict__ g, const T* __restrict__ y,
                                    T* __restrict__ dx, int64_t n, float gain_pos,
                                    float gain_neg) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    dx[i] = from_f32<T>(act_grad(to_f32(g[i]), to_f32(y[i]), gain_pos, gain_neg));
  }
}

// Four consecutive elements a thread (n % 4 == 0).
template <typename T>
__global__ void bias_act_bwd_vec4_kernel(const T* __restrict__ g, const T* __restrict__ y,
                                         T* __restrict__ dx, int64_t n4, float gain_pos,
                                         float gain_neg) {
  using V = typename std::conditional<std::is_same<T, float>::value, float4, Bf16x4>::type;
  const V* gv = reinterpret_cast<const V*>(g);
  const V* yv = reinterpret_cast<const V*>(y);
  V* dv = reinterpret_cast<V*>(dx);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const V a = gv[i];
    const V b = yv[i];
    V o;
    if constexpr (std::is_same<T, float>::value) {
      o.x = act_grad(a.x, b.x, gain_pos, gain_neg);
      o.y = act_grad(a.y, b.y, gain_pos, gain_neg);
      o.z = act_grad(a.z, b.z, gain_pos, gain_neg);
      o.w = act_grad(a.w, b.w, gain_pos, gain_neg);
    } else {
      const float2 glo = __bfloat1622float2(a.lo), ghi = __bfloat1622float2(a.hi);
      const float2 ylo = __bfloat1622float2(b.lo), yhi = __bfloat1622float2(b.hi);
      o.lo = __floats2bfloat162_rn(act_grad(glo.x, ylo.x, gain_pos, gain_neg),
                                   act_grad(glo.y, ylo.y, gain_pos, gain_neg));
      o.hi = __floats2bfloat162_rn(act_grad(ghi.x, yhi.x, gain_pos, gain_neg),
                                   act_grad(ghi.y, yhi.y, gain_pos, gain_neg));
    }
    dv[i] = o;
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

template <typename T>
int launch_bwd(const void* g, const void* y, void* dx, int64_t n, float gain_pos,
               float gain_neg, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* gt = static_cast<const T*>(g);
  const T* yt = static_cast<const T*>(y);
  T* dt = static_cast<T*>(dx);
  constexpr int threads = 256;
  constexpr uintptr_t align = 4 * sizeof(T);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(g) % align == 0 &&
                   reinterpret_cast<uintptr_t>(y) % align == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % align == 0;
  if (vec) {
    bias_act_bwd_vec4_kernel<T><<<grid_for(n / 4, threads), threads, 0, s>>>(
        gt, yt, dt, n / 4, gain_pos, gain_neg);
  } else {
    bias_act_bwd_kernel<T><<<grid_for(n, threads), threads, 0, s>>>(
        gt, yt, dt, n, gain_pos, gain_neg);
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

extern "C" int fused_bias_act_bwd_f32(const void* g, const void* y, void* dx, int64_t n,
                                      float gain_pos, float gain_neg, void* stream) {
  return launch_bwd<float>(g, y, dx, n, gain_pos, gain_neg, stream);
}

extern "C" int fused_bias_act_bwd_bf16(const void* g, const void* y, void* dx, int64_t n,
                                       float gain_pos, float gain_neg, void* stream) {
  return launch_bwd<__nv_bfloat16>(g, y, dx, n, gain_pos, gain_neg, stream);
}
