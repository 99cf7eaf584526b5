// K4: the filtered leaky ReLU of StyleGAN3's synthesis layers on NCHW planes,
// f32 and bf16, sums in f32.
//
// Replaces no TPU kernel: the JAX package has no StyleGAN3. It was added with
// the port's StyleGAN3-T generator (models/stylegan3.py), whose every layer
// runs modulated conv -> this. What it computes per plane (NVlabs'
// `_filtered_lrelu_ref`): add the bias; upsample by UP through the separable
// FIR fu (zero-stuff, pad, convolve along x then y with fu * UP); leaky ReLU
// (slope), times gain, clamp; downsample by DOWN through the separable FIR fd
// (convolve along x then y, keep every DOWN-th sample). Optionally each plane
// is scaled on the way in (the modulated conv's demodulation) and on the way
// out (the next layer's styles), so that neither is a pass of its own over
// device memory. ops/filtered_lrelu.py holds the plain version and the plan.
//
// What bounds it on an H100: at the published 1024^2 layers the FIR FMAs on
// the CUDA cores (about 72 an output, polyphase) and the bytes (one read of
// the input, one write of the output) about equally. Composed in device
// memory, the upsampled plane (four times the output) would be written and
// read several times over: ten times the bytes.
//
// What the design does about that:
// * One block makes one output tile (16 to 40 a side, chosen by the plan to
//   waste least at the plane's size) of one plane in one pass through
//   shared memory: the input tile with its halo (bias added, zeros outside
//   the plane), then the x-upsampled tile, the upsampled tile with the
//   activation applied, the x-downsampled tile, and the output. Nothing but
//   the input and the output touches device memory.
// * Polyphase: an upsampled sample takes only the taps of its phase, so no
//   zero-stuffed sample is stored or multiplied. The tile starts on phase 0
//   (the plan shifts it by (dy, dx)), so every phase, tap and window offset is
//   a compile-time constant. The input tile is loaded a warp a row, eight
//   loads in flight a thread; a pass steps through its items without an
//   integer division per item.
// * Each thread makes a run of 8 upsampled (4 downsampled) samples along the
//   filter's axis from a window held in registers: 48 FMAs for 10 shared
//   loads in an upsampling pass, 48 for 18 in a downsampling pass. The taps
//   sit in the launch's parameter space at constant offsets, so an FMA reads
//   its tap as an operand.
// * Lanes of a warp walk neighbouring rows (x passes) or columns (y passes);
//   row pitches are odd, so their shared-memory reads fall in distinct banks.
// * Tap counts are template parameters: the published layers (up 2 or 4 with
//   6 taps a phase, down 2 with 12 taps; the 1-tap ToRGB) have their own
//   instantiations; any other count up to 24 runs zero-padded to 24.
// * Every call's arguments are made once per shape on the host (a plan: one
//   struct passed by pointer), so a call is one C call with five arguments.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

constexpr int kMaxTaps = 24;
constexpr int kRun = 8;       // upsampled samples a thread makes in a pass
constexpr int kDownRun = 4;   // downsampled samples a thread makes in a pass
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 8;     // loads of the input tile in flight a thread

// The launch plan's arguments; ops/filtered_lrelu.py::_K4Params mirrors it.
struct K4Params {
  int dtype;                 // 0 float32, 1 bf16
  int up, down;
  int planes, channels;
  int in_h, in_w, out_h, out_w;
  int py0, px0;              // the upsampling's leading pads
  int nq, kd;                // taps a phase of fu, taps of fd (as instantiated)
  int th, tw;                // the output tile
  int dy, dx;                // the upsampled tile's offset onto phase 0
  int mh, mw, mh_used;       // the upsampled tile (whole runs); rows read downstream
  int ih, iw;                // the input tile
  int p_in, p_hu, p_mid, p_hd;  // row pitches (floats)
  int off_hu, off_mid;       // float offsets of regions B and C
  int gx, gy;                // grid: tiles along x, along y (planes on z)
  int smem_bytes;
  float gain, slope, clamp;  // clamp < 0: none
  float fu[kMaxTaps];        // flipped, times up, phase-major: fu[ph * (24 / up) + q]
  float fd[kMaxTaps];        // flipped
};

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The items of a pass, w = tid, tid + kThreads, ..., as (fast, slow) =
// (w % n, w / n), stepped without a division per item.
struct Walk {
  int fast, slow, step_fast, step_slow, n;
  __device__ __forceinline__ Walk(int tid, int n_)
      : fast(tid % n_), slow(tid / n_), step_fast(kThreads % n_), step_slow(kThreads / n_),
        n(n_) {}
  __device__ __forceinline__ void next() {
    fast += step_fast;
    slow += step_slow;
    if (fast >= n) {
      fast -= n;
      ++slow;
    }
  }
};

__device__ __forceinline__ float activate(float v, const K4Params& p) {
  v = v < 0.f ? v * p.slope : v;
  v *= p.gain;
  if (p.clamp >= 0.f) v = fminf(fmaxf(v, -p.clamp), p.clamp);
  return v;
}

// One run of kRun upsampled samples from a window of inputs; sample u has
// phase (-u) mod UP and starts at window entry ceil(u / UP).
template <int UP, int NQ>
__device__ __forceinline__ void up_run(const float (&win)[(kRun - 1 + UP - 1) / UP + NQ],
                                       const K4Params& p, float (&acc)[kRun]) {
  constexpr int kStride = kMaxTaps / UP;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    const int ph = (UP - u % UP) % UP;
    const int st = (u + UP - 1) / UP;
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) a += p.fu[ph * kStride + q] * win[st + q];
    acc[u] = a;
  }
}

// One run of kDownRun downsampled samples: sample u reads window entries
// u * DOWN + k.
template <int DOWN, int KD>
__device__ __forceinline__ void down_run(const float (&win)[(kDownRun - 1) * DOWN + KD],
                                         const K4Params& p, float (&acc)[kDownRun]) {
#pragma unroll
  for (int u = 0; u < kDownRun; ++u) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < KD; ++k) a += p.fd[k] * win[u * DOWN + k];
    acc[u] = a;
  }
}

template <typename T, int UP, int DOWN, int NQ, int KD>
__global__ void __launch_bounds__(kThreads) filtered_lrelu_kernel(
    const T* __restrict__ x, const float* __restrict__ bias,
    const float* __restrict__ in_scale, const float* __restrict__ out_scale, T* __restrict__ y,
    const K4Params p, const int plane0) {
  constexpr int kWinU = (kRun - 1 + UP - 1) / UP + NQ;
  constexpr int kWinD = (kDownRun - 1) * DOWN + KD;
  extern __shared__ float smem[];
  float* s_in = smem;              // region A: the input tile
  float* s_hd = smem;              // region A, later: the x-downsampled tile
  float* s_hu = smem + p.off_hu;   // region B: the x-upsampled tile
  float* s_mid = smem + p.off_mid; // region C: the upsampled, activated tile
  const int tid = threadIdx.x;
  const int plane = plane0 + blockIdx.z;
  const int oy0 = blockIdx.y * p.th, ox0 = blockIdx.x * p.tw;
  // the upsampled tile starts on phase 0, so (m0 - pad0) is a multiple of UP
  const int iy0 = (oy0 * DOWN - p.dy - p.py0) / UP;
  const int ix0 = (ox0 * DOWN - p.dx - p.px0) / UP;

  // 1. the input tile, scaled and its bias added, zeros outside the plane: a
  //    warp a row, its lanes along the row, kLoads loads in flight a thread
  {
    const float b = bias[plane % p.channels];
    const float a = in_scale != nullptr ? in_scale[plane] : 1.f;
    const T* xp = x + (int64_t)plane * p.in_h * p.in_w;
    const int lane = tid & 31, warp = tid >> 5;
    const int cols = (p.iw + 31) >> 5;            // 32-column strips of a row
    const int items = p.ih * cols;                // (row, strip) pairs
    for (int base = warp; base < items; base += kWarps * kLoads) {
      float v[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int it = base + j * kWarps;
        const int r = it / cols, c = (it - r * cols) * 32 + lane;
        const int iy = iy0 + r, ix = ix0 + c;
        v[j] = (it < items && iy >= 0 && iy < p.in_h && ix >= 0 && ix < p.in_w)
                   ? to_f32(xp[(int64_t)iy * p.in_w + ix]) * a + b : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int it = base + j * kWarps;
        const int r = it / cols, c = (it - r * cols) * 32 + lane;
        if (it < items && c < p.iw) s_in[r * p.p_in + c] = v[j];
      }
    }
  }
  __syncthreads();

  // 2. upsample along x: ih rows, mw columns in runs of kRun
  {
    const int runs = p.mw / kRun;
    for (Walk it(tid, p.ih); it.slow < runs; it.next()) {
      const int r = it.fast, c0 = it.slow * kRun;
      const float* src = s_in + r * p.p_in + c0 / UP;
      float win[kWinU];
#pragma unroll
      for (int i = 0; i < kWinU; ++i) win[i] = src[i];
      float acc[kRun];
      up_run<UP, NQ>(win, p, acc);
      float* dst = s_hu + r * p.p_hu + c0;
#pragma unroll
      for (int u = 0; u < kRun; ++u) dst[u] = acc[u];
    }
  }
  __syncthreads();

  // 3. upsample along y, then bias-free leaky ReLU, gain and clamp: mh rows
  {
    const int runs = p.mh / kRun;
    for (Walk it(tid, p.mw); it.slow < runs; it.next()) {
      const int c = it.fast, r0 = it.slow * kRun;
      const float* src = s_hu + (r0 / UP) * p.p_hu + c;
      float win[kWinU];
#pragma unroll
      for (int i = 0; i < kWinU; ++i) win[i] = src[i * p.p_hu];
      float acc[kRun];
      up_run<UP, NQ>(win, p, acc);
      float* dst = s_mid + r0 * p.p_mid + c;
#pragma unroll
      for (int u = 0; u < kRun; ++u) dst[u * p.p_mid] = activate(acc[u], p);
    }
  }
  __syncthreads();

  // 4. downsample along x: the mh_used rows the y pass reads, tw columns
  {
    const int runs = p.tw / kDownRun;
    for (Walk it(tid, p.mh_used); it.slow < runs; it.next()) {
      const int r = it.fast, t0 = it.slow * kDownRun;
      const float* src = s_mid + r * p.p_mid + p.dx + t0 * DOWN;
      float win[kWinD];
#pragma unroll
      for (int i = 0; i < kWinD; ++i) win[i] = src[i];
      float acc[kDownRun];
      down_run<DOWN, KD>(win, p, acc);
      float* dst = s_hd + r * p.p_hd + t0;
#pragma unroll
      for (int u = 0; u < kDownRun; ++u) dst[u] = acc[u];
    }
  }
  __syncthreads();

  // 5. downsample along y and store: tw columns, th rows in runs
  {
    T* yp = y + (int64_t)plane * p.out_h * p.out_w;
    const float a = out_scale != nullptr ? out_scale[plane] : 1.f;
    const int runs = p.th / kDownRun;
    for (Walk it(tid, p.tw); it.slow < runs; it.next()) {
      const int t = it.fast, t0 = it.slow * kDownRun;
      const int ox = ox0 + t;
      if (ox >= p.out_w || oy0 + t0 >= p.out_h) continue;
      const float* src = s_hd + (p.dy + t0 * DOWN) * p.p_hd + t;
      float win[kWinD];
#pragma unroll
      for (int i = 0; i < kWinD; ++i) win[i] = src[i * p.p_hd];
      float acc[kDownRun];
      down_run<DOWN, KD>(win, p, acc);
#pragma unroll
      for (int u = 0; u < kDownRun; ++u) {
        const int oy = oy0 + t0 + u;
        if (oy < p.out_h) yp[(int64_t)oy * p.out_w + ox] = from_f32<T>(acc[u] * a);
      }
    }
  }
}

template <typename T, int UP, int DOWN, int NQ, int KD>
int launch(const K4Params& p, const void* x, const void* b, const float* in_scale,
           const float* out_scale, void* y, cudaStream_t s) {
  auto kernel = filtered_lrelu_kernel<T, UP, DOWN, NQ, KD>;
  static int smem_set = 0;   // the largest dynamic shared memory allowed so far
  if (p.smem_bytes > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = p.smem_bytes;
  }
  for (int plane0 = 0; plane0 < p.planes; plane0 += 65535) {
    const int n = p.planes - plane0 < 65535 ? p.planes - plane0 : 65535;
    kernel<<<dim3(p.gx, p.gy, n), kThreads, p.smem_bytes, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(b), in_scale, out_scale,
        static_cast<T*>(y), p, plane0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T>
int dispatch(const K4Params& p, const void* x, const void* b, const float* si, const float* so,
             void* y, cudaStream_t s) {
  const int u = p.up, d = p.down, q = p.nq, k = p.kd;
  // the published layers
  if (u == 2 && d == 2 && q == 6 && k == 12)
    return launch<T, 2, 2, 6, 12>(p, x, b, si, so, y, s);
  if (u == 4 && d == 2 && q == 6 && k == 12)
    return launch<T, 4, 2, 6, 12>(p, x, b, si, so, y, s);
  if (u == 1 && d == 1 && q == 1 && k == 1)
    return launch<T, 1, 1, 1, 1>(p, x, b, si, so, y, s);
  // any other count, zero-padded to 24 taps
  if (k != kMaxTaps || q != kMaxTaps / u) return (int)cudaErrorInvalidValue;
  if (u == 1 && d == 1) return launch<T, 1, 1, 24, 24>(p, x, b, si, so, y, s);
  if (u == 1 && d == 2) return launch<T, 1, 2, 24, 24>(p, x, b, si, so, y, s);
  if (u == 2 && d == 1) return launch<T, 2, 1, 12, 24>(p, x, b, si, so, y, s);
  if (u == 2 && d == 2) return launch<T, 2, 2, 12, 24>(p, x, b, si, so, y, s);
  if (u == 4 && d == 1) return launch<T, 4, 1, 6, 24>(p, x, b, si, so, y, s);
  if (u == 4 && d == 2) return launch<T, 4, 2, 6, 24>(p, x, b, si, so, y, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// in_scale / out_scale: one float a plane (N x C), or null for 1
extern "C" int filtered_lrelu_run(const K4Params* p, const void* x, const void* b,
                                  const void* in_scale, const void* out_scale, void* y,
                                  void* stream) {
  if (p->planes < 1 || p->th % kDownRun || p->tw % kDownRun || p->mh % kRun ||
      p->mw % kRun || p->smem_bytes > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* si = static_cast<const float*>(in_scale);
  const float* so = static_cast<const float*>(out_scale);
  return p->dtype == 1 ? dispatch<__nv_bfloat16>(*p, x, b, si, so, y, s)
                       : dispatch<float>(*p, x, b, si, so, y, s);
}
