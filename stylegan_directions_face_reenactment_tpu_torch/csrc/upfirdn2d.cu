// upfirdn2d for (up, down) in {(1, 1), (2, 1), (1, 2)} and taps of at most
// 4x4 on NCHW planes, f32 and bf16.
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
// What the design does about that:
// * Every call's arguments are made once per shape, in a launch plan on the
//   host (ops/upfirdn2d_kernel.py): one struct, passed by pointer, holds the
//   flipped taps (zero-padded to 4x4), the sizes, the pads and the launch
//   shape, so a call is one C call with four arguments.
// * (UP, DOWN) are template parameters and the taps are 4x4, so the tap loops
//   unroll fully. With UP = 2 the taps an output meets depend on its parity:
//   a thread's outputs start on a multiple of 4, so each column's parity, and
//   with it its taps and input offsets, is a compile-time constant; the row
//   parity picks one of two instantiations once a thread.
// * A block stages its input band with the halo in shared memory (zeros
//   outside the plane, so no tap tests a bound) with coalesced loads, and
//   each thread makes 4 adjacent outputs of a row from registers loaded from
//   that band (float4 reads for UP = 1), storing them with one vector store
//   where the output rows are 4-aligned.
// * The plan sizes the block (threads along x, rows, planes) to the plane
//   and shrinks it down to 32 threads until the grid has a block for each SM
//   where the work allows: the small 3-plane skip gradients of a PTI step at
//   batch 1 and the 8x8 blurs of 512 channels alike.
// Each output sums its taps row by row, each row left to right, and a tap
// over the zero halo adds an exact zero: at every shape of the main paths
// the results equal the plain version's bit for bit (chip_smoke.py checks).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

constexpr int kTaps = 4;

// The launch plan's arguments (outside the unnamed namespace: the C entry
// point takes it); ops/upfirdn2d_kernel.py::_K1Params mirrors it.
struct K1Params {
  int dtype;           // 0 float32, 1 bf16
  int up, down;
  int planes, in_h, in_w, out_h, out_w;
  int pad_x0, pad_y0;
  int bx, by, bz;      // block: threads along x (4 outputs each), rows, planes
  int gx, gy, gz;      // grid
  int rows_in, cols_in;  // the shared input band of one plane
  int smem_bytes;
  float taps[kTaps * kTaps];  // flipped, row-major
};

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ int floor_half(int v) { return v >> 1; }  // floor(v / 2)

template <typename T>
__device__ __forceinline__ void store4(T* y, const float (&acc)[4], int n, bool vec);
template <>
__device__ __forceinline__ void store4<float>(float* y, const float (&acc)[4], int n, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(y) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < n) y[k] = acc[k];
  }
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* y, const float (&acc)[4],
                                                      int n, bool vec) {
  if (vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0], acc[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2], acc[3]);
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo);
    v.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(y) = v;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < n) y[k] = __float2bfloat16(acc[k]);
  }
}

// UP = 1: output (oy, ox) sums taps (j, i) over band (ty*DOWN + j, (4tx + k)*DOWN + i).
template <int DOWN>
__device__ __forceinline__ void fir_down(const float* sp, int cols, int tx, int ty,
                                         const float* taps, float (&acc)[4]) {
  constexpr int kWin = DOWN == 1 ? 8 : 12;   // 3 * DOWN + 4 band columns, in float4s
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    const float4* row =
        reinterpret_cast<const float4*>(sp + (ty * DOWN + j) * cols + 4 * tx * DOWN);
    float win[kWin];
#pragma unroll
    for (int v = 0; v < kWin / 4; ++v) {
      const float4 q = row[v];
      win[4 * v] = q.x;
      win[4 * v + 1] = q.y;
      win[4 * v + 2] = q.z;
      win[4 * v + 3] = q.w;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < kTaps; ++i) acc[k] += taps[j * kTaps + i] * win[k * DOWN + i];
  }
}

// UP = 2: row parity RP of the output, column parity P of the band origin.
// Tap row j meets the output when RP + j is even, from band row
// a + (RP + j) / 2; tap column i meets output k when P + k + i is even, from
// band column 2 tx + (P + k + i) / 2.
template <int RP, int P>
__device__ __forceinline__ void fir_up2(const float* sp, int cols, int a, int tx,
                                        const float* taps, float (&acc)[4]) {
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    if ((RP + j) & 1) continue;
    const float* row = sp + (a + ((RP + j) >> 1)) * cols + 2 * tx;
    float win[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) win[v] = row[v];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < kTaps; ++i) {
        if ((P + k + i) & 1) continue;
        acc[k] += taps[j * kTaps + i] * win[(P + k + i) >> 1];
      }
  }
}

template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(256) upfirdn2d_kernel(const T* __restrict__ x,
                                                        T* __restrict__ y, const K1Params p) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;
  const int tid = tx + p.bx * (ty + p.by * tz), nt = p.bx * p.by * p.bz;
  const int ox_b = blockIdx.x * p.bx * 4, oy_b = blockIdx.y * p.by, pl_b = blockIdx.z * p.bz;
  const int base_y = UP == 1 ? oy_b * DOWN - p.pad_y0 : floor_half(oy_b - p.pad_y0);
  const int base_x = UP == 1 ? ox_b * DOWN - p.pad_x0 : floor_half(ox_b - p.pad_x0);
  const int band = p.rows_in * p.cols_in;
  for (int i = tid; i < p.bz * band; i += nt) {
    const int z = i / band, rc = i - z * band;
    const int r = rc / p.cols_in, c = rc - r * p.cols_in;
    const int pl = pl_b + z, iy = base_y + r, ix = base_x + c;
    float v = 0.f;
    if (pl < p.planes && iy >= 0 && iy < p.in_h && ix >= 0 && ix < p.in_w)
      v = to_f32(x[((int64_t)pl * p.in_h + iy) * p.in_w + ix]);
    s[i] = v;
  }
  __syncthreads();
  const int plane = pl_b + tz, oy = oy_b + ty, ox0 = ox_b + 4 * tx;
  if (plane >= p.planes || oy >= p.out_h || ox0 >= p.out_w) return;
  const float* sp = s + tz * band;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (UP == 1) {
    fir_down<DOWN>(sp, p.cols_in, tx, ty, p.taps, acc);
  } else {
    const int rel = oy - p.pad_y0 - 2 * base_y;   // >= 0
    const int a = rel >> 1;
    const bool odd_row = rel & 1, odd_col = p.pad_x0 & 1;
    if (odd_row) {
      if (odd_col) fir_up2<1, 1>(sp, p.cols_in, a, tx, p.taps, acc);
      else fir_up2<1, 0>(sp, p.cols_in, a, tx, p.taps, acc);
    } else {
      if (odd_col) fir_up2<0, 1>(sp, p.cols_in, a, tx, p.taps, acc);
      else fir_up2<0, 0>(sp, p.cols_in, a, tx, p.taps, acc);
    }
  }
  store4<T>(y + ((int64_t)plane * p.out_h + oy) * p.out_w + ox0, acc, p.out_w - ox0,
            (p.out_w & 3) == 0);
}

template <typename T>
int launch(const K1Params& p, const void* x, void* y, cudaStream_t s) {
  const dim3 grid(p.gx, p.gy, p.gz), block(p.bx, p.by, p.bz);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (p.up == 2 && p.down == 1)
    upfirdn2d_kernel<T, 2, 1><<<grid, block, p.smem_bytes, s>>>(xt, yt, p);
  else if (p.up == 1 && p.down == 2)
    upfirdn2d_kernel<T, 1, 2><<<grid, block, p.smem_bytes, s>>>(xt, yt, p);
  else if (p.up == 1 && p.down == 1)
    upfirdn2d_kernel<T, 1, 1><<<grid, block, p.smem_bytes, s>>>(xt, yt, p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int upfirdn2d_run(const K1Params* p, const void* x, void* y, void* stream) {
  if (p->smem_bytes > 48 * 1024 || p->bx * p->by * p->bz > 256 || p->planes < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p->dtype == 1 ? launch<__nv_bfloat16>(*p, x, y, s) : launch<float>(*p, x, y, s);
}
