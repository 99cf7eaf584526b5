// The FAN dense-residual ConvBlock, channels-equal with 256 channels (K3):
//
//   o1  = conv3x3(relu(x  * i1 + f1))    256 -> 128
//   o2  = conv3x3(relu(o1 * i2 + f2))    128 -> 64
//   o3  = conv3x3(relu(o2 * i3 + f3))     64 -> 64
//   out = concat(o1, o2, o3) + x
//
// on NCHW tensors, f32 and bf16, with zero padding of the activation (the
// conv pads after the ReLU). Each stage sums in f32 and rounds its output
// to the activation type; the folds i*, f* arrive already rounded to it, and
// in bf16 the activation rounds after the multiply and after the add, as
// the plain PyTorch composition does.
//
// Replaces the Pallas TPU kernel
// stylegan_directions_face_reenactment_tpu/ops/fused_conv_block.py::_forward
// (body `_kernel`), which held one whole image per grid step in VMEM.
//
// What bounds it on an H100: operations. A block-pixel costs
// 2*9*(256*128 + 128*64 + 64*64) = 811,008 FLOP against 2*256 activations
// read and written (2 KB in f32), about 400 FLOP a byte.
//
// What the design does about that (a simple first design; no TF32):
// * three launches, one a stage, each a direct 3x3 convolution over tiles of
//   8x16 output pixels of one image with a 1-pixel halo, staged in shared
//   memory chunk by chunk of input channels with the fold and ReLU applied
//   as they load, beside the chunk's weights.
// * float32 (CUDA-core FMAs, so that it holds to f32 tolerance): a block
//   owns 32 output channels and walks chunks of 8 input channels; each of
//   its 128 threads keeps 4 rows x 8 channels of f32 sums in registers and
//   per input channel reads a 6-row x 3-column window of the tile once for
//   the 9 taps (18 shared loads and 18 broadcast float4 weight loads for
//   288 FMAs).
// * bf16 (tensor cores, `mma.sync` m16n8k16 with f32 sums): an implicit
//   GEMM of 128 pixels x 64 output channels x (9 taps x 16-channel chunks);
//   each warp owns two tile rows and all 64 channels. The activations sit
//   channel-innermost in shared memory and the weights arrive packed as
//   (cin / 16, 9, cout, 16), so fragments are 32-bit loads on distinct banks
//   and the weight tile is 16-byte copies.
// * stage k writes straight into its channel slice of `out`, so the concat
//   costs nothing. The residual must not land in a slice that a later stage
//   still reads through its halo: o2 goes to a scratch buffer, and stage 3's
//   epilogue writes o3 + x, o2 + x and adds x into the o1 slice, once stage 2
//   (the only reader of o1) has finished.
// The TPU kernel's VMEM budget and its 8x8 floor were limits of that chip and
// are not carried over: the tile covers any H, W from 4x4 up.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kC = 256;                 // block channels (in = out)
constexpr int kTH = 8, kTW = 16;        // output pixels of a tile
constexpr int kCoT = 32;                // output channels of a tile
constexpr int kCiT = 8;                 // input channels of a chunk
constexpr int kRows = kTH + 2, kCols = kTW + 2;
constexpr int kSW = 20;                 // shared row stride: the two row groups of a warp
                                        // land 80 floats apart, on disjoint banks
constexpr int kThreads = 128;           // 4 warps x 8 output channels

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and back
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// relu(v * inv + off) with T's roundings (no fused multiply-add)
template <typename T>
__device__ __forceinline__ float activate(float v, float inv, float off) {
  float t = round_to<T>(__fmul_rn(v, inv));
  t = round_to<T>(__fadd_rn(t, off));
  return t > 0.f ? t : 0.f;
}

template <typename T>
struct Stage {
  const T* in;      // (B, in_ctot, H, W); channels [0, cin) are read
  int in_ctot, cin;
  const T* inv;     // (cin,)
  const T* off;     // (cin,)
  const T* wt;      // f32: (cin, 3, 3, cout); bf16: (cin / 16, 9, cout, 16)
  int cout;
  T* out;           // (B, out_ctot, H, W); channels [out_c0, out_c0 + cout) are written
  int out_ctot, out_c0;
  const T* res;     // stage 3: x (B, 256, H, W); null otherwise
  const T* o2;      // stage 3: the o2 scratch (B, 64, H, W)
  int batch, h, w;
};

// One output element: the f32 sum rounded to T; in stage 3 plus x, rounded again.
template <typename T>
__device__ __forceinline__ void store_out(const Stage<T>& s, int b, int co, int gy, int gx,
                                          float acc) {
  if (gy >= s.h || gx >= s.w) return;
  const size_t plane = (size_t)s.h * s.w, pix = (size_t)gy * s.w + gx;
  const int ch = s.out_c0 + co;
  float v = round_to<T>(acc);
  if (s.res != nullptr) v += to_f32(s.res[((size_t)b * kC + ch) * plane + pix]);
  s.out[((size_t)b * s.out_ctot + ch) * plane + pix] = from_f32<T>(v);
}

// Stage 3's epilogue for the o1 and o2 slices of this pixel tile (o1 + x in
// place, o2 + x from the scratch), split between the tile's blocks.
template <typename T>
__device__ void residual_rest(const Stage<T>& s, int b, int y0, int x0) {
  const size_t plane = (size_t)s.h * s.w;
  const int n_extra = s.out_c0;   // 192 = 128 (o1) + 64 (o2)
  const int o2_c0 = n_extra - 64;
  const int per = (n_extra + (int)gridDim.y - 1) / (int)gridDim.y;
  const int c_begin = (int)blockIdx.y * per;
  const int c_end = min(n_extra, c_begin + per);
  for (int i = threadIdx.x; i < (c_end - c_begin) * kTH * kTW; i += blockDim.x) {
    const int ch = c_begin + i / (kTH * kTW);
    const int p = i % (kTH * kTW);
    const int gy = y0 + p / kTW, gx = x0 + p % kTW;
    if (gy >= s.h || gx >= s.w) continue;
    const size_t pix = (size_t)gy * s.w + gx;
    const size_t o = ((size_t)b * s.out_ctot + ch) * plane + pix;
    const float base = ch < o2_c0 ? to_f32(s.out[o])
                                  : to_f32(s.o2[((size_t)b * 64 + ch - o2_c0) * plane + pix]);
    s.out[o] = from_f32<T>(base + to_f32(s.res[((size_t)b * kC + ch) * plane + pix]));
  }
}

// float32 stage on the CUDA cores (see the header).
__global__ void __launch_bounds__(kThreads) conv3x3_stage(Stage<float> s) {
  __shared__ float s_in[kCiT][kRows][kSW];
  __shared__ __align__(16) float s_w[kCiT][9][kCoT];

  const int tiles_x = (s.w + kTW - 1) / kTW;
  const int tiles_y = (s.h + kTH - 1) / kTH;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int t = blockIdx.x % (tiles_x * tiles_y);
  const int y0 = (t / tiles_x) * kTH, x0 = (t % tiles_x) * kTW;
  const int co0 = blockIdx.y * kCoT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int px = lane & 15, rg = lane >> 4;   // column; rows rg*4 .. rg*4+3
  const size_t plane = (size_t)s.h * s.w;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < s.cin; ci0 += kCiT) {
    for (int i = threadIdx.x; i < kCiT * kRows * kCols; i += kThreads) {
      const int c = i / (kRows * kCols);
      const int r = (i / kCols) % kRows;
      const int cc = i % kCols;
      const int gy = y0 - 1 + r, gx = x0 - 1 + cc;
      float v = 0.f;
      if (gy >= 0 && gy < s.h && gx >= 0 && gx < s.w) {
        const int ci = ci0 + c;
        v = activate<float>(s.in[((size_t)b * s.in_ctot + ci) * plane + (size_t)gy * s.w + gx],
                            s.inv[ci], s.off[ci]);
      }
      s_in[c][r][cc] = v;
    }
    for (int i = threadIdx.x; i < kCiT * 9 * kCoT; i += kThreads) {
      const int co = i % kCoT;
      const int ct = i / kCoT;          // c * 9 + tap
      s_w[ct / 9][ct % 9][co] = s.wt[((size_t)ci0 * 9 + ct) * s.cout + co0 + co];
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kCiT; ++c) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float col[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) col[r] = s_in[c][rg * 4 + r][px + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float4 wa = *reinterpret_cast<const float4*>(&s_w[c][ky * 3 + kx][warp * 8]);
          const float4 wb = *reinterpret_cast<const float4*>(&s_w[c][ky * 3 + kx][warp * 8 + 4]);
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(col[i + ky], wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  const int gx = x0 + px;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gy = y0 + rg * 4 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) store_out(s, b, co0 + warp * 8 + j, gy, gx, acc[i][j]);
  }
  if (s.res != nullptr) residual_rest(s, b, y0, x0);
}

// bf16 stage on the tensor cores: mma.sync m16n8k16 (bf16 in, f32 sums), an
// implicit GEMM of M = 128 pixels (8 rows x 16 columns) x N = 64 output
// channels x K = 9 taps x 16-channel chunks. Each warp owns two tile rows
// (two m16 tiles) and all 64 channels (eight n8 tiles). The chunk's
// activations sit in shared memory channel-innermost, [10][18][24], and its
// weights [9][64][24] (24 of 16 slots used: rows of 12 words put the eight
// rows of a fragment on distinct banks).
constexpr int kMmaCo = 64, kMmaCi = 16, kPad = 24;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads) conv3x3_stage_mma(Stage<__nv_bfloat16> s) {
  __shared__ __align__(16) __nv_bfloat16 s_in[kRows][kCols][kPad];
  __shared__ __align__(16) __nv_bfloat16 s_w[9][kMmaCo][kPad];

  const int tiles_x = (s.w + kTW - 1) / kTW;
  const int tiles_y = (s.h + kTH - 1) / kTH;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int t = blockIdx.x % (tiles_x * tiles_y);
  const int y0 = (t / tiles_x) * kTH, x0 = (t % tiles_x) * kTW;
  const int co0 = blockIdx.y * kMmaCo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;   // fragment row group, column pair
  const size_t plane = (size_t)s.h * s.w;

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;

  for (int ci0 = 0; ci0 < s.cin; ci0 += kMmaCi) {
    // activations: a channel pair of one pixel a thread, fold + ReLU on load
    for (int i = threadIdx.x; i < (kMmaCi / 2) * kRows * kCols; i += kThreads) {
      const int cp = i / (kRows * kCols);
      const int r = (i / kCols) % kRows;
      const int cc = i % kCols;
      const int gy = y0 - 1 + r, gx = x0 - 1 + cc;
      float v0 = 0.f, v1 = 0.f;
      if (gy >= 0 && gy < s.h && gx >= 0 && gx < s.w) {
        const int ci = ci0 + 2 * cp;
        const size_t at = ((size_t)b * s.in_ctot + ci) * plane + (size_t)gy * s.w + gx;
        v0 = activate<__nv_bfloat16>(to_f32(s.in[at]), to_f32(s.inv[ci]), to_f32(s.off[ci]));
        v1 = activate<__nv_bfloat16>(to_f32(s.in[at + plane]), to_f32(s.inv[ci + 1]),
                                     to_f32(s.off[ci + 1]));
      }
      *reinterpret_cast<__nv_bfloat162*>(&s_in[r][cc][2 * cp]) = __floats2bfloat162_rn(v0, v1);
    }
    // weights, packed (cin / 16, 9, cout, 16): 16-byte copies of the tile's rows
    const __nv_bfloat16* wsrc = s.wt + ((size_t)(ci0 / kMmaCi) * 9 * s.cout + co0) * kMmaCi;
    for (int i = threadIdx.x; i < 9 * kMmaCo * 2; i += kThreads) {
      const int half = i & 1, row = (i >> 1) % kMmaCo, tap = (i >> 1) / kMmaCo;
      *reinterpret_cast<uint4*>(&s_w[tap][row][half * 8]) = *reinterpret_cast<const uint4*>(
          wsrc + ((size_t)tap * s.cout + row) * kMmaCi + half * 8);
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = warp * 2 + m + ky;
        a[m][0] = ld32(&s_in[r][g + kx][2 * q]);
        a[m][1] = ld32(&s_in[r][g + 8 + kx][2 * q]);
        a[m][2] = ld32(&s_in[r][g + kx][2 * q + 8]);
        a[m][3] = ld32(&s_in[r][g + 8 + kx][2 * q + 8]);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t b0 = ld32(&s_w[tap][n * 8 + g][2 * q]);
        const uint32_t b1 = ld32(&s_w[tap][n * 8 + g][2 * q + 8]);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(acc[m][n][0]), "+f"(acc[m][n][1]), "+f"(acc[m][n][2]), "+f"(acc[m][n][3])
              : "r"(a[m][0]), "r"(a[m][1]), "r"(a[m][2]), "r"(a[m][3]), "r"(b0), "r"(b1));
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int gy = y0 + warp * 2 + m;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int co = co0 + n * 8 + 2 * q;
      store_out(s, b, co, gy, x0 + g, acc[m][n][0]);
      store_out(s, b, co + 1, gy, x0 + g, acc[m][n][1]);
      store_out(s, b, co, gy, x0 + g + 8, acc[m][n][2]);
      store_out(s, b, co + 1, gy, x0 + g + 8, acc[m][n][3]);
    }
  }
  if (s.res != nullptr) residual_rest(s, b, y0, x0);
}

int tiles_of(int h, int w) { return ((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW); }

int launch_stage(const Stage<float>& s, cudaStream_t stream) {
  const dim3 grid((unsigned)(s.batch * tiles_of(s.h, s.w)), (unsigned)(s.cout / kCoT));
  conv3x3_stage<<<grid, kThreads, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

int launch_stage(const Stage<__nv_bfloat16>& s, cudaStream_t stream) {
  const dim3 grid((unsigned)(s.batch * tiles_of(s.h, s.w)), (unsigned)(s.cout / kMmaCo));
  conv3x3_stage_mma<<<grid, kThreads, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* i1, const void* f1, const void* w1,
           const void* i2, const void* f2, const void* w2,
           const void* i3, const void* f3, const void* w3,
           void* out, void* scratch, int batch, int h, int w, void* stream) {
  if (batch < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  T* o2 = static_cast<T*>(scratch);
  auto P = [](const void* p) { return static_cast<const T*>(p); };
  // stage 1: x -> o1 into out[:, 0:128]
  Stage<T> s1{xt, kC, kC, P(i1), P(f1), P(w1), 128, ot, kC, 0, nullptr, nullptr,
              batch, h, w};
  int err = launch_stage(s1, st);
  if (err) return err;
  // stage 2: out[:, 0:128] -> o2 into the scratch
  Stage<T> s2{ot, kC, 128, P(i2), P(f2), P(w2), 64, o2, 64, 0, nullptr, nullptr,
              batch, h, w};
  err = launch_stage(s2, st);
  if (err) return err;
  // stage 3: o2 -> o3 + x into out[:, 192:256]; o2 + x and o1 + x into out[:, 0:192]
  Stage<T> s3{o2, 64, 64, P(i3), P(f3), P(w3), 64, ot, kC, 192, xt, o2,
              batch, h, w};
  return launch_stage(s3, st);
}

}  // namespace

extern "C" int fused_conv_block_f32(const void* x, const void* i1, const void* f1,
                                    const void* w1, const void* i2, const void* f2,
                                    const void* w2, const void* i3, const void* f3,
                                    const void* w3, void* out, void* scratch, int batch,
                                    int h, int w, void* stream) {
  return launch<float>(x, i1, f1, w1, i2, f2, w2, i3, f3, w3, out, scratch, batch, h, w,
                       stream);
}

extern "C" int fused_conv_block_bf16(const void* x, const void* i1, const void* f1,
                                     const void* w1, const void* i2, const void* f2,
                                     const void* w2, const void* i3, const void* f3,
                                     const void* w3, void* out, void* scratch, int batch,
                                     int h, int w, void* stream) {
  return launch<__nv_bfloat16>(x, i1, f1, w1, i2, f2, w2, i3, f3, w3, out, scratch, batch,
                               h, w, stream);
}
