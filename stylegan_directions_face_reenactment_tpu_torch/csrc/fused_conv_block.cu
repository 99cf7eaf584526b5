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
// read and written (2 KB in f32), about 400 FLOP a byte. In float32 the
// stage runs three TF32 products a product (below), so its floor is
// 3 x 811,008 FLOP a block-pixel at the TF32 dense rate, 495 TFLOP/s.
//
// What the design does about that: each stage is an implicit GEMM with
// M = the pixels of all images (B*H*W), N = the stage's output channels and
// K = 9 taps x its input channels, on tiles of 128 pixels x N channels.
// * The fold and ReLU are out of the main loop. A prologue pass writes
//   A1 = relu(x*i1 + f1) channels-innermost (NHWC); each stage's epilogue
//   writes the next stage's activation A(k+1) = relu(o_k*i + f) in NHWC
//   beside o_k + x in its NCHW slice of `out`. So a K step's operands are
//   plain copies: one (tap, channel chunk) of 128 shifted pixel rows, whose
//   out-of-image halo is a zero fill (the conv pads after the ReLU), and the
//   weight slab of that (tap, chunk). No stage reads `out`, so each writes
//   its residual sum straight away and nothing needs an o2 scratch.
// * Loads run ahead of the math: a ring of shared-memory stages filled by
//   cp.async (16 bytes a copy, zero-fill for the halo and the ragged last
//   tile), so the copies of the next steps are in flight while a step's
//   products run.
// * Both dtypes on the tensor cores, with wgmma from 128-byte-swizzled
//   shared memory, two warpgroups of 64 pixels each, N = 128 channels for
//   the first stage (half the pixel rows copied per product of the 64-wide
//   tile) and 64 for the others, K steps of (tap, one 128-byte row of
//   channels) for a pixel and for a weight row. Weights are packed one
//   contiguous K-major slab a K step.
// * bf16: wgmma m64nNk16 (bf16 in, f32 sums), K steps of 64 channels,
//   weights packed (9, cin / 64, cout, 64), copies two (N = 128) or three
//   steps ahead in a ring of 3 or 4 slots.
// * float32: three TF32 products, so that it holds to f32 tolerance. Every
//   operand v is split into hi = tf32(v) and lo = tf32(v - hi), and each
//   product summed as a_hi b_hi + a_hi b_lo + a_lo b_hi (a_lo b_lo, about
//   2^-22 relative, is dropped). The splits are made where the operands are
//   written, so the main loop only copies and multiplies: the prologue and
//   the epilogues write each activation as two NHWC planes, hi and then lo
//   (M * C floats apart), and the weights are split once, at pack time,
//   into (9, cin / 32, 2, cout, 32): a K step's slab is the N hi rows, then
//   the N lo rows. K steps of 32 channels, channel chunk by chunk and the 9
//   taps within a chunk (the 9 shifted reads of a chunk's rows follow each
//   other, so they stay in L2); per 8 channels a warpgroup issues
//   m64n(2N)k8 on A_hi and [B_hi | B_lo], whose two halves sum the big and
//   the small products apart, and m64nNk8 on A_lo and B_hi into the small
//   half. The tensor cores' own sums are less exact than float32's, so
//   every kSumSteps steps the two halves are added into float32 sums on
//   the CUDA cores, rounded.
//   The planes double the bytes a K step copies (about 200 FLOP a byte of
//   activation). Neither the copies nor the products bound the stage alone:
//   at 64x64 a call read 836 us, 658 us with its copies taken out and 579 us
//   with its products taken out; the two meet at a barrier every K step. A ring of
//   3 slots for N = 128 or 4 for N = 64 (one block an SM), copies two or
//   three steps ahead, issued after the step's products.
// * Small maps (B*H*W of a few thousand pixels or fewer) put too few tiles on
//   132 SMs: the K loop is split across blocks (blockIdx.z), each writing an
//   f32 partial tile, and a second short pass, one thread an element, sums
//   the partials in split order and runs the epilogue. No atomics, so two
//   runs are bit-equal. The split per stage comes from a
//   table of shapes in ops/fused_conv_block.py.
// * The epilogue stages the f32 tile in shared memory, so the NHWC writes
//   run along channels and the NCHW writes along pixels, each thread moving
//   8 values with 16-byte accesses (a simple per-element epilogue took half
//   of the bf16 stage's time at 64x64).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kC = 256;              // block channels (in = out)
constexpr int kBM = 128, kBN = 64;   // pixels x output channels of a tile (N = 64, reduce)
constexpr int kLdc = kBN + 1;        // row stride of the f32 epilogue tile
constexpr int kRM = 4;               // pixels of a split-K reduce tile (x 64 = 256 threads)

// bf16 (wgmma) stage, tiles of 128 pixels x BN channels (BN = 128 for the
// first stage, 64 for the others)
constexpr int kBK = 64;              // channels of a K step: 128 bytes
constexpr int kWgThreads = 256;      // two warpgroups
constexpr int kATile = kBM * 128;
template <int BN> struct WgTile {
  static constexpr int kStages = BN == 128 ? 3 : 4;   // two blocks an SM either way
  static constexpr int kAhead = kStages - 1;          // steps of copies in flight
  static constexpr int kStageBytes = kATile + BN * 128;
  static constexpr int kSmem = kStages * kStageBytes + 1024;   // + alignment to 1024
  static_assert((kBM * (BN + 1) + kBM) * 4 <= kStages * kStageBytes,
                "epilogue tile fits the ring");
};

// float32 (three TF32 products) stage, tiles of 128 pixels x BN channels
constexpr int kTK = 32;              // channels of a K step: 128 bytes
constexpr int kAPlane = kBM * 128;   // one plane (hi or lo) of a step's A
constexpr int kSumSteps = 2;         // K steps a tensor-core sum runs before it is rounded
                                     // into the float32 sums
template <int BN> struct TfTile {
  static constexpr int kStages = BN == 128 ? 3 : 4;   // one block an SM either way
  static constexpr int kAhead = kStages - 1;          // steps of copies in flight
  static constexpr int kStageBytes = 2 * kAPlane + 2 * BN * 128;
  static constexpr int kSmem = kStages * kStageBytes + 1024;   // + alignment to 1024
  static_assert(kSmem <= 232448, "the ring fits a block's shared memory");
  static_assert((kBM * (BN + 1) + kBM) * 4 <= kStages * kStageBytes,
                "epilogue tile fits the ring");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
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

// What a stage's epilogue writes for pixel m (image b, pixel p) and output
// channel n: out[b, c0 + n, p] = o + x[b, c0 + n, p], and, unless this is the
// last stage, act[m, n] = relu(o * inv[n] + off[n]), o the sum rounded to T.
template <typename T>
struct Epi {
  T* out;
  const T* x;
  int c0;
  T* act;            // (M, cout) NHWC (f32: the hi plane, then the lo plane), or null
  const T* inv;
  const T* off;
  int m, hw, cout;
};

template <typename T>
struct Gemm {
  const T* a;        // (M, cin) NHWC activation (f32: hi plane, then lo plane)
  const T* w;        // f32: (9, cin / 32, 2, cout, 32); bf16: (9, cin / 64, cout, 64)
  int cin, h, w_;
  int ksteps, kchunk;
  float* ws;         // (splits, M, cout) partial sums, or null: no split
  Epi<T> epi;
};

// 8 consecutive values of T to and from f32: one 16-byte access in bf16,
// two in f32 (the address is 8-element aligned)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// v rounded to TF32 (10 mantissa bits, the low 13 bits zero), ties away
// from zero
__device__ __forceinline__ float tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// An activation as the next stage reads it: bf16 as it is; f32 as the two
// TF32 operands of the three-product sums, hi = tf32(v) at act[i] and lo =
// tf32(v - hi) (v - hi is exact) at act[plane + i].
__device__ __forceinline__ void put_act(bf16* act, size_t, size_t i, float v) {
  act[i] = __float2bfloat16(v);
}
__device__ __forceinline__ void put_act(float* act, size_t plane, size_t i, float v) {
  const float hi = tf32(v);
  act[i] = hi;
  act[plane + i] = tf32(v - hi);
}
__device__ __forceinline__ void put_act8(bf16* act, size_t, size_t i, const float (&v)[8]) {
  store8(act + i, v);
}
__device__ __forceinline__ void put_act8(float* act, size_t plane, size_t i,
                                         const float (&v)[8]) {
  float hi[8], lo[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    hi[j] = tf32(v[j]);
    lo[j] = tf32(v[j] - hi[j]);
  }
  store8(act + i, hi);
  store8(act + plane + i, lo);
}

// The epilogue of a ROWS x BN tile of f32 sums c (row stride BN + 1) whose
// first pixel is m0 and first channel n0. off_px (ROWS ints of shared
// memory) takes each row's offset in the NCHW tensors, so the per-element
// work has no division. A thread writes 8 channels of a pixel of the NHWC
// activation at once (its folds loaded once) and, where H*W is a multiple
// of 8, 8 pixels of a channel of `out` (8 rows of a group lie in one
// image), so every access is 16 or 32 bytes.
template <typename T, int BN, int ROWS>
__device__ void epilogue_tile(const float* c, int* off_px, int m0, int n0, const Epi<T>& e,
                              int tid, int nt) {
  constexpr int ldc = BN + 1, G = BN / 8;
  for (int r = tid; r < ROWS; r += nt) {
    const int m = m0 + r, b = m / e.hw;
    off_px[r] = m < e.m ? b * kC * e.hw + (m - b * e.hw) : -1;
  }
  __syncthreads();
  if (e.act != nullptr) {
    const int g = tid % G;
    float iv[8], of[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      iv[j] = to_f32(e.inv[n0 + 8 * g + j]);
      of[j] = to_f32(e.off[n0 + 8 * g + j]);
    }
    for (int r = tid / G; r < ROWS; r += nt / G) {
      if (off_px[r] < 0) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = activate<T>(round_to<T>(c[r * ldc + 8 * g + j]), iv[j], of[j]);
      put_act8(e.act, (size_t)e.m * e.cout, (size_t)(m0 + r) * e.cout + n0 + 8 * g, v);
    }
  }
  if (ROWS % 8 == 0 && e.hw % 8 == 0) {
    constexpr int RG = ROWS / 8;
    for (int i = tid; i < RG * BN; i += nt) {
      const int n = i / RG, r = (i % RG) * 8;
      if (off_px[r] < 0) continue;
      const size_t o = (size_t)off_px[r] + (size_t)(e.c0 + n0 + n) * e.hw;
      float v[8];
      load8(&e.x[o], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = round_to<T>(c[(r + j) * ldc + n]) + v[j];
      store8(&e.out[o], v);
    }
    return;
  }
  for (int i = tid; i < ROWS * BN; i += nt) {
    const int n = i / ROWS, r = i % ROWS;
    if (off_px[r] < 0) continue;
    const size_t o = (size_t)off_px[r] + (size_t)(e.c0 + n0 + n) * e.hw;
    e.out[o] = from_f32<T>(round_to<T>(c[r * ldc + n]) + to_f32(e.x[o]));
  }
}

// A1 = relu(x * i1 + f1), NCHW -> NHWC through a 32 x 32 shared tile.
template <typename T>
__global__ void __launch_bounds__(256) fcb_prologue(const T* __restrict__ x,
                                                    const T* __restrict__ inv,
                                                    const T* __restrict__ off,
                                                    T* __restrict__ act, int m_total, int hw) {
  __shared__ float tile[32][33];
  const int m0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int m = m0 + tx;
  if (m < m_total) {
    const int b = m / hw, p = m - b * hw;
    for (int r = ty; r < 32; r += 8) {
      const int c = c0 + r;
      tile[r][tx] = activate<T>(to_f32(x[((size_t)b * kC + c) * hw + p]), to_f32(inv[c]),
                                to_f32(off[c]));
    }
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    if (m0 + r < m_total)
      put_act(act, (size_t)m_total * kC, (size_t)(m0 + r) * kC + c0 + tx, tile[tx][r]);
  }
}

template <typename T> struct Pair;
template <> struct Pair<float> {
  typedef float2 V;
  static __device__ __forceinline__ float2 unpack(V v) { return v; }
  // act[i], act[i + 1] = a, b as put_act writes them (both planes)
  static __device__ __forceinline__ void put(float* act, size_t plane, size_t i, float a,
                                             float b) {
    const float ha = tf32(a), hb = tf32(b);
    *reinterpret_cast<float2*>(act + i) = make_float2(ha, hb);
    *reinterpret_cast<float2*>(act + plane + i) = make_float2(tf32(a - ha), tf32(b - hb));
  }
};
template <> struct Pair<bf16> {
  typedef __nv_bfloat162 V;
  static __device__ __forceinline__ float2 unpack(V v) { return __bfloat1622float2(v); }
  static __device__ __forceinline__ void put(bf16* act, size_t, size_t i, float a, float b) {
    *reinterpret_cast<V*>(act + i) = __floats2bfloat162_rn(a, b);
  }
};

// The prologue when H*W is even, so a pair of pixels never spans two
// images: 64 pixels x 64 channels a block, each thread loading and storing
// two adjacent values at once (8- or 4-byte accesses).
template <typename T>
__global__ void __launch_bounds__(256) fcb_prologue_pairs(const T* __restrict__ x,
                                                          const T* __restrict__ inv,
                                                          const T* __restrict__ off,
                                                          T* __restrict__ act, int m_total,
                                                          int hw) {
  typedef typename Pair<T>::V V;
  __shared__ float tile[64][65];   // [channel][pixel]
  const int m0 = blockIdx.x * 64, c0 = blockIdx.y * 64;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int m = m0 + 2 * tx;
  if (m < m_total) {
    const int b = m / hw, p = m - b * hw;
    for (int r = ty; r < 64; r += 8) {
      const int c = c0 + r;
      const float2 v =
          Pair<T>::unpack(*reinterpret_cast<const V*>(&x[((size_t)b * kC + c) * hw + p]));
      const float iv = to_f32(inv[c]), of = to_f32(off[c]);
      tile[r][2 * tx] = activate<T>(v.x, iv, of);
      tile[r][2 * tx + 1] = activate<T>(v.y, iv, of);
    }
  }
  __syncthreads();
  for (int r = ty; r < 64; r += 8) {
    if (m0 + r < m_total)
      Pair<T>::put(act, (size_t)m_total * kC, (size_t)(m0 + r) * kC + c0 + 2 * tx,
                   tile[2 * tx][r], tile[2 * tx + 1][r]);
  }
}

// ---- copies ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false the 16 bytes are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The pixel coordinates of the tile rows one thread copies: rows
// first + step * j, j < N.
template <int N>
struct RowCoords {
  int y[N], x[N];
  bool in[N];
  __device__ void init(int m0, int first, int step, int m_total, int hw, int w) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int m = m0 + first + step * j;
      in[j] = m < m_total;
      const int p = m % hw;
      y[j] = p / w;
      x[j] = p - y[j] * w;
    }
  }
  // whether row j's pixel shifted by (dy, dx) lies in the image
  __device__ bool ok(int j, int dy, int dx, int h, int w) const {
    const int yy = y[j] + dy, xx = x[j] + dx;
    return in[j] && yy >= 0 && yy < h && xx >= 0 && xx < w;
  }
};

// ---- bf16: wgmma -----------------------------------------------------------

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d(64x64, f32) += A(64x16) B(16x64), both from shared memory, K-major
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d(64x128, f32) += A(64x16) B(16x128), both from shared memory, K-major
__device__ __forceinline__ void wgmma_64x128x16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN> struct Wgmma;
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da, uint64_t db) {
    wgmma_64x64x16(d, da, db);
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db) {
    wgmma_64x128x16(d, da, db);
  }
};

// The end both stage kernels share. `acc` is a thread's part of the tile's
// f32 sums in the wgmma accumulator layout: thread (warp w of warpgroup g,
// lane l) holds pixel rows 64 g + 16 w + l / 4 (+ 8) and channels
// 8 j + 2 (l % 4) (+ 1), at acc[4 j + 2 hh] (+ 1) for the row + 8 hh. A
// split (g.ws) writes its f32 partial; an unsplit tile is staged in shared
// memory for epilogue_tile. A tile spans the stage's output channels (BN is
// cout), so its first channel n0 is 0.
template <typename T, int BN>
__device__ __forceinline__ void stage_tail(const float (&acc)[BN / 2], const Gemm<T>& g,
                                           uint8_t* smem, int m0, int n0, int split, int tid) {
  const int lane = tid & 31, wq = (tid & 127) >> 5;
  const int row = (tid >> 7) * 64 + wq * 16 + (lane >> 2), cq = (lane & 3) * 2;
  if (g.ws != nullptr) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + row + 8 * hh, i = 4 * j + 2 * hh;
        if (m < g.epi.m)
          *reinterpret_cast<float2*>(
              &g.ws[((size_t)split * g.epi.m + m) * g.epi.cout + n0 + j * 8 + cq]) =
              make_float2(acc[i], acc[i + 1]);
      }
    return;
  }
  float* c = reinterpret_cast<float*>(smem);
  int* off_px = reinterpret_cast<int*>(c + kBM * (BN + 1));
  constexpr int ldc = BN + 1;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = 4 * j + 2 * hh;
      c[(row + 8 * hh) * ldc + j * 8 + cq] = acc[i];
      c[(row + 8 * hh) * ldc + j * 8 + cq + 1] = acc[i + 1];
    }
  __syncthreads();
  epilogue_tile<T, BN, kBM>(c, off_px, m0, n0, g.epi, tid, kWgThreads);
}

// One bf16 stage tile (or, with g.ws, one split's partial of it): pixels
// [m0, m0 + 128) x channels [n0, n0 + BN) over K steps [k0, k1). Warpgroup
// g owns pixels m0 + 64 g .. + 63. Every thread copies 4 A rows and BN / 32
// B rows (16 bytes of each) a step: rows tid / 8 + 32 j, column tid % 8,
// stored at column (tid % 8) ^ (row % 8) of the row: the 128-byte swizzle.
// n0 is 0 (grid.y is 1) but is read from blockIdx.y: with a constant 0,
// ptxas gives the BN = 128 stage 122 registers for 120, and the bf16 stages
// read 0.5-1.9 % slower on an H100.
template <int BN>
__global__ void __launch_bounds__(kWgThreads) fcb_stage_wgmma(const Gemm<bf16> g) {
  using Tile = WgTile<BN>;
  constexpr int kStages = Tile::kStages, kStageBytes = Tile::kStageBytes;
  constexpr int kAhead = Tile::kAhead;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int k0 = split * g.kchunk, k1 = min(g.ksteps, k0 + g.kchunk);
  const int m_total = g.epi.m, h = g.h, w = g.w_;
  const int nchunk = g.cin / kBK;
  const int col = tid & 7, row0 = tid >> 3;
  RowCoords<4> rc;
  rc.init(m0, row0, 32, m_total, g.epi.hw, w);

  auto load = [&](int step, int slot) {
    const int tap = step / nchunk, cc = step - tap * nchunk;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    uint8_t* sa = smem + slot * kStageBytes;
    uint8_t* sb = sa + kATile;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + 32 * j;
      const bool ok = rc.ok(j, dy, dx, h, w);
      const bf16* src = ok ? g.a + (size_t)(m0 + r + dy * w + dx) * g.cin + cc * kBK + col * 8
                           : g.a;
      cp_async16(sa + r * 128 + ((col ^ (r & 7)) << 4), src, ok);
    }
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int r = row0 + 32 * j;
      const bf16* src = g.w + ((size_t)step * g.epi.cout + n0 + r) * kBK + col * 8;
      cp_async16(sb + r * 128 + ((col ^ (r & 7)) << 4), src, true);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int wg = tid >> 7;

  // Copies run kAhead = kStages - 1 steps ahead; the slot refilled at step s
  // is step s - 1's, whose products every warpgroup waited for before the
  // barrier of step s.
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (k0 + s < k1) load(k0 + s, s);
    cp_async_commit();
  }
  for (int step = k0; step < k1; ++step) {
    const int slot = (step - k0) % kStages;
    cp_async_wait<kAhead - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int nxt = step + kAhead;
    if (nxt < k1) load(nxt, (nxt - k0) % kStages);
    cp_async_commit();
    const uint32_t a_addr = smem_u32(smem + slot * kStageBytes + wg * 64 * 128);
    const uint32_t b_addr = smem_u32(smem + slot * kStageBytes + kATile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Wgmma<BN>::run(acc, smem_desc(a_addr + kk * 32), smem_desc(b_addr + kk * 32));
    wgmma_commit();
    wgmma_wait0();
  }
  wgmma_wait0();
  cp_async_wait<0>();
  __syncthreads();
  stage_tail<bf16, BN>(acc, g, smem, m0, n0, split, tid);
}

// ---- float32: three TF32 products on wgmma ---------------------------------

// d(64xN, f32) = A(64x8) B(8xN) + (scale_d ? d : 0), TF32 from shared
// memory, both K-major
__device__ __forceinline__ void wgmma_tf32_64x64x8(float (&d)[32], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_64x128x8(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_64x256x8(float (&d)[128], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127}, "
      "%128, %129, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N> struct WgmmaTf32;
template <> struct WgmmaTf32<64> {
  static __device__ __forceinline__ void run(float* d, uint64_t da, uint64_t db, int scale_d) {
    wgmma_tf32_64x64x8(*reinterpret_cast<float(*)[32]>(d), da, db, scale_d);
  }
};
template <> struct WgmmaTf32<128> {
  static __device__ __forceinline__ void run(float* d, uint64_t da, uint64_t db, int scale_d) {
    wgmma_tf32_64x128x8(*reinterpret_cast<float(*)[64]>(d), da, db, scale_d);
  }
};
template <> struct WgmmaTf32<256> {
  static __device__ __forceinline__ void run(float* d, uint64_t da, uint64_t db, int scale_d) {
    wgmma_tf32_64x256x8(*reinterpret_cast<float(*)[128]>(d), da, db, scale_d);
  }
};

// One float32 stage tile (or, with g.ws, one split's partial of it): as the
// bf16 one, with K steps of (32-channel chunk, tap). A slot holds the step's A
// hi plane (128 rows of 128 bytes), its lo plane, and its weight slab: BN hi
// rows, then BN lo rows. Every thread copies 4 A rows of each plane and
// BN / 16 B rows (16 bytes of each) a step: rows tid / 8 + 32 j, column
// tid % 8, stored at column (tid % 8) ^ (row % 8): the 128-byte swizzle.
// Warpgroup g owns pixels m0 + 64 g .. + 63. The products of kSumSteps K
// steps go to BN tensor-core sums a thread, the big products' half
// acc[0, BN / 2) and the small products' acc[BN / 2, BN), started afresh;
// then both halves are added into sum[BN / 2] on the CUDA cores. The tensor
// cores' own sums are less exact than float32's rounded adds: carried
// through a whole K loop of up to 72 steps, they read 6.7x the worst error
// of the float32 composition (cuDNN) against float64 at 64x64 on an H100;
// rounded into float32 every 2 steps, 0.47x.
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1) fcb_stage_tf32(const Gemm<float> g) {
  using Tile = TfTile<BN>;
  constexpr int kStages = Tile::kStages, kStageBytes = Tile::kStageBytes;
  constexpr int kAhead = Tile::kAhead;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, split = blockIdx.z;   // BN = cout: one tile spans N
  const int k0 = split * g.kchunk, k1 = min(g.ksteps, k0 + g.kchunk);
  const int m_total = g.epi.m, h = g.h, w = g.w_;
  const int nchunk = g.cin / kTK;
  const size_t a_plane = (size_t)m_total * g.cin;
  const int col = tid & 7, row0 = tid >> 3;
  RowCoords<4> rc;
  rc.init(m0, row0, 32, m_total, g.epi.hw, w);

  auto load = [&](int step, int slot) {
    const int cc = step / 9, tap = step - cc * 9;
    const int slab = tap * nchunk + cc;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    uint8_t* sa = smem + slot * kStageBytes;
    uint8_t* sb = sa + 2 * kAPlane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + 32 * j;
      const bool ok = rc.ok(j, dy, dx, h, w);
      const float* src =
          g.a + (ok ? (size_t)(m0 + r + dy * w + dx) * g.cin + cc * kTK + col * 4 : 0);
      const int o = r * 128 + ((col ^ (r & 7)) << 4);
      cp_async16(sa + o, src, ok);
      cp_async16(sa + kAPlane + o, ok ? src + a_plane : g.a, ok);
    }
#pragma unroll
    for (int j = 0; j < 2 * BN / 32; ++j) {
      const int r = row0 + 32 * j;
      const float* src = g.w + ((size_t)slab * 2 * BN + r) * kTK + col * 4;
      cp_async16(sb + r * 128 + ((col ^ (r & 7)) << 4), src, true);
    }
  };

  float acc[BN], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sum[i] = 0.f;
  const int wg = tid >> 7;

  // Copies run kAhead = kStages - 1 steps ahead. The copies of step s +
  // kAhead go into step s - 1's slot, issued after step s's products:
  // every warpgroup waited for step s - 1's products before the barrier of
  // step s. (Keeping one step's products in flight instead, with a step
  // less of copies ahead, read 2 % slower.)
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (k0 + s < k1) load(k0 + s, s);
    cp_async_commit();
  }
  for (int step = k0; step < k1; ++step) {
    const int slot = (step - k0) % kStages;
    cp_async_wait<kAhead - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t a_hi = smem_u32(smem + slot * kStageBytes + wg * 64 * 128);
    const uint32_t a_lo = a_hi + kAPlane;
    const uint32_t b = smem_u32(smem + slot * kStageBytes + 2 * kAPlane);
    const bool fresh = (step - k0) % kSumSteps == 0;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTK / 8; ++kk) {
      // [a_hi b_hi | a_hi b_lo] (afresh at a sum's first), then a_lo b_hi
      // into the small half
      WgmmaTf32<2 * BN>::run(acc, smem_desc(a_hi + kk * 32), smem_desc(b + kk * 32),
                             kk > 0 || !fresh);
      WgmmaTf32<BN>::run(acc + BN / 2, smem_desc(a_lo + kk * 32), smem_desc(b + kk * 32), 1);
    }
    wgmma_commit();
    const int nxt = step + kAhead;
    if (nxt < k1) load(nxt, (nxt - k0) % kStages);
    cp_async_commit();
    wgmma_wait0();
    if ((step - k0) % kSumSteps == kSumSteps - 1 || step == k1 - 1) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i] + acc[BN / 2 + i];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  stage_tail<float, BN>(sum, g, smem, m0, 0, split, tid);
}

// The split-K pass over a 4-pixel x 64-channel tile, one element a thread
// (so a small map's pass still spreads over the card): each thread sums its
// element's partials in split order, 8 loads in flight, then the epilogue.
// The order is fixed, so two runs are bit-equal.
template <typename T>
__global__ void __launch_bounds__(256) fcb_splitk_reduce(const float* __restrict__ ws,
                                                         int splits, const Epi<T> e) {
  __shared__ float c[kRM * kLdc];
  __shared__ int off_px[kRM];
  const int m0 = blockIdx.x * kRM, n0 = blockIdx.y * kBN;
  const int r = threadIdx.x / kBN, n = threadIdx.x % kBN, m = m0 + r;
  float s = 0.f;
  if (m < e.m) {
    const size_t stride = (size_t)e.m * e.cout;
    const float* p = ws + (size_t)m * e.cout + n0 + n;
    int k = 0;
    for (; k + 8 <= splits; k += 8) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = p[(k + j) * stride];
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[j];
    }
    for (; k < splits; ++k) s += p[k * stride];
  }
  c[r * kLdc + n] = s;
  __syncthreads();
  epilogue_tile<T, kBN, kRM>(c, off_px, m0, n0, e, threadIdx.x, 256);
}

// ---- launch ------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Let `kernel` take `bytes` of dynamic shared memory. The attribute belongs
// to each device's context: set it once a card (`done`, one flag a card for
// each kernel).
int allow_smem(const void* kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    done[dev] = true;
  }
  return 0;
}

template <int BN>
int launch_tf32(const Gemm<float>& g, dim3 grid, cudaStream_t st) {
  static bool done[kMaxDevices] = {};
  const int e = allow_smem((const void*)fcb_stage_tf32<BN>, TfTile<BN>::kSmem, done);
  if (e) return e;
  fcb_stage_tf32<BN><<<grid, kWgThreads, TfTile<BN>::kSmem, st>>>(g);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_wgmma(const Gemm<bf16>& g, dim3 grid, cudaStream_t st) {
  static bool done[kMaxDevices] = {};
  const int e = allow_smem((const void*)fcb_stage_wgmma<BN>, WgTile<BN>::kSmem, done);
  if (e) return e;
  fcb_stage_wgmma<BN><<<grid, kWgThreads, WgTile<BN>::kSmem, st>>>(g);
  return (int)cudaGetLastError();
}

int launch_gemm(const Gemm<float>& g, dim3 grid, cudaStream_t st) {
  return g.epi.cout == 128 ? launch_tf32<128>(g, grid, st) : launch_tf32<64>(g, grid, st);
}

int launch_gemm(const Gemm<bf16>& g, dim3 grid, cudaStream_t st) {
  return g.epi.cout == 128 ? launch_wgmma<128>(g, grid, st) : launch_wgmma<64>(g, grid, st);
}

template <typename T> constexpr int k_step_channels();
template <> constexpr int k_step_channels<float>() { return kTK; }
template <> constexpr int k_step_channels<bf16>() { return kBK; }

// One stage: the GEMM (split over kchunk K steps a block), then, if split,
// the reduce pass.
template <typename T>
int run_stage(const T* a, int cin, const T* wt, int kchunk, float* ws, const Epi<T>& epi,
              int h, int w, cudaStream_t st) {
  Gemm<T> g;
  g.a = a;
  g.w = wt;
  g.cin = cin;
  g.h = h;
  g.w_ = w;
  g.ksteps = 9 * cin / k_step_channels<T>();
  g.kchunk = kchunk < 1 ? g.ksteps : min(kchunk, g.ksteps);
  const int splits = (g.ksteps + g.kchunk - 1) / g.kchunk;
  g.ws = splits > 1 ? ws : nullptr;
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  g.epi = epi;
  // a tile spans the stage's output channels (BN = cout, 128 or 64)
  const dim3 grid((unsigned)((epi.m + kBM - 1) / kBM), 1, (unsigned)splits);
  int err = launch_gemm(g, grid, st);
  if (err || splits == 1) return err;
  fcb_splitk_reduce<T><<<dim3((unsigned)((epi.m + kRM - 1) / kRM), (unsigned)(epi.cout / kBN)),
                         256, 0, st>>>(ws, splits, epi);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* i1, const void* f1, const void* w1,
           const void* i2, const void* f2, const void* w2,
           const void* i3, const void* f3, const void* w3,
           void* out, void* act_a, void* act_b, void* ws, int batch, int h, int w,
           int kchunk1, int kchunk2, int kchunk3, void* stream) {
  if (batch < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto P = [](const void* p) { return static_cast<const T*>(p); };
  const T* xt = P(x);
  T* ot = static_cast<T*>(out);
  T* aa = static_cast<T*>(act_a);   // A1 (M, 256), then A3 (M, 64); f32: two planes each
  T* ab = static_cast<T*>(act_b);   // A2 (M, 128)
  float* wsf = static_cast<float*>(ws);
  const int hw = h * w, m = batch * hw;
  if (hw % 2 == 0)
    fcb_prologue_pairs<T><<<dim3((unsigned)((m + 63) / 64), kC / 64), 256, 0, st>>>(
        xt, P(i1), P(f1), aa, m, hw);
  else
    fcb_prologue<T><<<dim3((unsigned)((m + 31) / 32), kC / 32), 256, 0, st>>>(xt, P(i1), P(f1),
                                                                              aa, m, hw);
  int err = (int)cudaGetLastError();
  if (err) return err;
  // stage 1: A1 -> o1; out[:, 0:128] = o1 + x, A2 = relu(o1 * i2 + f2)
  err = run_stage<T>(aa, 256, P(w1), kchunk1, wsf,
                     Epi<T>{ot, xt, 0, ab, P(i2), P(f2), m, hw, 128}, h, w, st);
  if (err) return err;
  // stage 2: A2 -> o2; out[:, 128:192] = o2 + x, A3 = relu(o2 * i3 + f3) over A1
  err = run_stage<T>(ab, 128, P(w2), kchunk2, wsf,
                     Epi<T>{ot, xt, 128, aa, P(i3), P(f3), m, hw, 64}, h, w, st);
  if (err) return err;
  // stage 3: A3 -> o3; out[:, 192:256] = o3 + x
  return run_stage<T>(aa, 64, P(w3), kchunk3, wsf,
                      Epi<T>{ot, xt, 192, nullptr, nullptr, nullptr, m, hw, 64}, h, w, st);
}

}  // namespace

extern "C" int fused_conv_block_f32(const void* x, const void* i1, const void* f1,
                                    const void* w1, const void* i2, const void* f2,
                                    const void* w2, const void* i3, const void* f3,
                                    const void* w3, void* out, void* act_a, void* act_b,
                                    void* ws, int batch, int h, int w, int kchunk1,
                                    int kchunk2, int kchunk3, void* stream) {
  return launch<float>(x, i1, f1, w1, i2, f2, w2, i3, f3, w3, out, act_a, act_b, ws, batch,
                       h, w, kchunk1, kchunk2, kchunk3, stream);
}

extern "C" int fused_conv_block_bf16(const void* x, const void* i1, const void* f1,
                                     const void* w1, const void* i2, const void* f2,
                                     const void* w2, const void* i3, const void* f3,
                                     const void* w3, void* out, void* act_a, void* act_b,
                                     void* ws, int batch, int h, int w, int kchunk1,
                                     int kchunk2, int kchunk3, void* stream) {
  return launch<bf16>(x, i1, f1, w1, i2, f2, w2, i3, f3, w3, out, act_a, act_b, ws, batch, h,
                      w, kchunk1, kchunk2, kchunk3, stream);
}
