// K4: the filtered leaky ReLU of StyleGAN3's synthesis layers on the planes
// of an NCHW or an NHWC (channels-last) batch, f32 and bf16, sums in f32.
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
// What bounds it on an H100: by its bytes (one read of the input, one write
// of the output) and its FIR FMAs on the CUDA cores (about 72 an output,
// polyphase) it could run in 11.3 ms a StyleGAN3-T chunk; composed in
// device memory, the upsampled plane (four times the output) would be
// written and read several times over, ten times the bytes. What holds it
// back now is not the latency of its loads (hidden below) but the passes'
// own issue slots and shared-memory traffic: an output of an up-2 layer
// takes about 29 32-bit shared accesses for its 72 FMAs, and about as many
// other instructions again (the activation, addresses, the walk), where an
// SM serves 32 shared floats a clock and 128 FMAs. Taking one pass out of a
// build saves about its share of those (PERF.md, section 6). On an NHWC
// batch its shared memory also bounds it: a group's input tiles and output
// tiles stay in shared memory together, so a block is larger and fewer fit
// an SM.
//
// What the design does about that:
// * A block owns one output tile (16 to 40 a side, chosen by the plan) and
//   walks a run of planes of it (the plan's pz, from the shape: as many as
//   keep enough waves of blocks on the card); its geometry, window offsets
//   and edge masks are worked out once. Each plane goes through shared
//   memory in one pass: the input tile with its halo, the x-upsampled tile,
//   the upsampled tile with the activation applied, the x-downsampled tile,
//   and the output. Nothing but the input and the output touches device
//   memory.
// * The layout is read from the input's strides (ops/filtered_lrelu.py): the
//   filter core (passes 2 to 5 below) is the same for both; only the copy of
//   the input tile and the store of the output differ.
// * NCHW: the input tile has two slots. While plane k is filtered, plane
//   k + 1's input is on its way into the other slot by cp.async (4 bytes a
//   copy, zero-filled outside the plane), with its bias and scales in
//   registers; it is waited for only when plane k + 1 starts. The threads
//   walk the tile's words without a division or a 64-bit product a word, so
//   that issuing the copies costs few slots. The raw input lands as it is
//   (f32 or bf16); the x-up pass scales it, adds the bias and, on a tile
//   that crosses the plane's edge, zeroes what lies outside.
// * NHWC: a plane's pixels lie C elements apart, so a copy or store of one
//   plane alone would touch a 32-byte sector for every 4 bytes. The walk of
//   a block stays in one sample and goes in groups of cg channels (the
//   plan's; a power of two, the last group of a walk may be short): a
//   group's tiles are copied together, the lanes of a warp along the
//   channels of a pixel and then along the row, each element into its
//   plane's slot (a word an element, slots apart by a word count that puts
//   the lanes' channels on distinct banks), and are in flight together.
//   Each plane's output goes to a staging tile in shared memory; when the
//   group is done the block writes the group's outputs a pixel at a time,
//   cg channels side by side. So loads and stores are runs of cg channels
//   (8 float32 channels: one 32-byte sector of device memory, which a group
//   of 4 would write in halves, at several times the cost), as the NCHW rows
//   are runs of columns. Where a plane's output tile fits its input slot
//   (up 1 or 2) it is staged there, once the slot's plane has been
//   upsampled along x, and the next group's inputs go in flight after the
//   store; else (up 4, whose input tile is the smaller) the staging tiles
//   have a region of their own and the next group's inputs go in flight as
//   soon as the last plane of this one has been upsampled along x. Eight
//   slots and the staging take more shared memory than the NCHW walk, so
//   the plan allows a block up to half an SM's.
// * The x-downsampled tile reuses the x-upsampled tile's region, which no
//   input slot overlaps.
// * Not TMA: a tensor map needs a row pitch that is a multiple of 16
//   bytes, and no NCHW input width of the published layers but ToRGB's (38
//   ... 1046 columns) is one, in f32 (8 mod 16 bytes) or in bf16; on an NHWC
//   batch its box would land a group interleaved, a pixel's channels side by
//   side, which a pass over one plane reads with 8-way bank conflicts.
// * Polyphase: an upsampled sample takes only the taps of its phase, so no
//   zero-stuffed sample is stored or multiplied. The tile starts on phase 0
//   (the plan shifts it by (dy, dx)), so every phase, tap and window offset is
//   a compile-time constant; a pass steps through its items without an
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
// * Every call's arguments are made once per shape and layout on the host (a
//   plan: one struct passed by pointer), so a call is one C call with five
//   arguments.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

constexpr int kMaxTaps = 24;
constexpr int kRun = 8;       // upsampled samples a thread makes in a pass
constexpr int kDownRun = 4;   // downsampled samples a thread makes in a pass
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The launch plan's arguments; ops/filtered_lrelu.py::_K4Params mirrors it.
struct K4Params {
  int dtype;                 // 0 float32, 1 bf16
  int nhwc;                  // 0 NCHW planes, 1 an NHWC (channels-last) batch
  int up, down;
  int planes, channels;
  int in_h, in_w, out_h, out_w;
  int py0, px0;              // the upsampling's leading pads
  int nq, kd;                // taps a phase of fu, taps of fd (as instantiated)
  int th, tw;                // the output tile
  int dy, dx;                // the upsampled tile's offset onto phase 0
  int mh, mw, mh_used;       // the upsampled tile (whole runs); rows read downstream
  int ih, iw;                // the input tile
  int p_in, p_hu, p_mid, p_hd;  // row pitches (4-byte words; p_in of a slot)
  int slot;                  // words of an input slot (slot g starts at g * slot)
  int off_hu, off_mid;       // word offsets of regions B and C
  int off_out, s_out;        // NHWC: plane g's output staging at off_out + g * s_out (0: in
                             // the input slots, once the slot's plane is upsampled along x)
  int cg, lg;                // NHWC: channels a group, 1 << lg
  int gx, gy, gz;            // grid: tiles along x, along y, runs of planes
  int pz;                    // planes a block walks (its last block: the rest)
  int runs;                  // NHWC: runs of a sample's channels (blockIdx.z = n * runs + run)
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
// (w % n, w / n), stepped without a division per item. A block makes each
// pass's walk once and starts every plane's pass from a copy of it.
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

// 4 bytes from global to shared memory, in flight until cp_async_wait();
// zeros where !fetch (nothing is read then).
__device__ __forceinline__ void cp_async4(float* dst, const uint32_t* src, bool fetch) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(fetch ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A tile's input rows in device memory as cp.async copies them: 4-byte
// words. Element e of the input (counted from a 4-byte boundary, so a bf16
// tensor may start at e = 1) lies in word e / kPer at place e % kPer; each
// row of the tile starts at its own place, which a bf16 plane of odd width
// changes from row to row.
template <typename T>
struct TileRows {
  static constexpr int kPer = 4 / sizeof(T);   // elements a word
  const uint32_t* w0;  // the word that holds the tile's (row 0, column 0) in this plane
  int s0;              // that element's place in it
  // e0: the element index of the tile's (row 0, column 0) in this plane
  __device__ __forceinline__ TileRows(const uint32_t* words, int64_t e0)
      : w0(words + (e0 - (e0 & (kPer - 1))) / kPer), s0((int)(e0 & (kPer - 1))) {}
  // row r's first word and the place of its first element (column 0) in it
  __device__ __forceinline__ const uint32_t* row(int r, int in_w) const {
    return w0 + (s0 + r * in_w) / kPer;
  }
  __device__ __forceinline__ int shift(int r, int in_w) const {
    return (s0 + r * in_w) & (kPer - 1);
  }
};

// Where an NHWC plane's element lies in its slot: a word an element; a bf16
// element in the half of its word that its index in device memory gives,
// (e00 + r * in_w * C + c * C) mod 2 for tile row r, column c.
struct NhwcPlace {
  int e00;    // the index's parity at (row 0, column 0) of this plane
  int wc;     // in_w * C mod 2
  int c;      // C mod 2
  __device__ __forceinline__ int half(int r, int col) const {
    return e00 ^ (r & wc) ^ (col & c);
  }
};

// Put one plane's input tile in flight into a slot (NCHW): the threads walk
// its words row by row, a warp's lanes along a row. On a tile that crosses
// the plane's edge (EDGE) a word is read only if it holds an element of the
// plane (tile columns [lo, hi) of rows inside it), and zero-filled else.
template <typename T, bool EDGE>
__device__ __forceinline__ void issue_tile(const TileRows<T>& t, float* slot, const K4Params& p,
                                           int iy0, int lo, int hi, const Walk& words) {
  constexpr int kPer = TileRows<T>::kPer;
  for (Walk it = words; it.slow < p.ih; it.next()) {
    const int r = it.slow, j = it.fast;
    const int c = j * kPer - t.shift(r, p.in_w);          // tile column of its first element
    const bool fetch =
        !EDGE || ((unsigned)(iy0 + r) < (unsigned)p.in_h && c < hi && c + kPer > lo);
    cp_async4(slot + r * p.p_in + j, t.row(r, p.in_w) + j, fetch);
  }
  cp_async_commit();
}

// Put a group's gr input tiles in flight into slots 0 .. gr - 1 (NHWC). A
// row's items are (column, channel), the channel fastest, so that a warp's
// lanes copy the channels of a few neighbouring pixels; a thread takes the
// same items of every row (kThreads is a multiple of cg, so its channel is
// tid mod cg), stepping its offsets by a row's. e_grp: the element index
// (from the 4-byte boundary below the tensor) of the group's first channel
// at the tile's input row 0, column 0; a sample's offsets fit 32 bits (the
// plan checks). On a tile that crosses the plane's edge (EDGE) only the
// pixels inside are read, the rest zero-filled.
template <typename T, bool EDGE>
__device__ __forceinline__ void issue_group(const uint32_t* words, int64_t e_grp, float* slots,
                                            const K4Params& p, int iy0, int lo, int hi, int gr) {
  constexpr int kShift = sizeof(T) == 2 ? 1 : 0;
  const uint32_t* w0 = words + (e_grp >> kShift);
  const int s0 = (int)(e_grp & kShift), row = p.in_w * p.channels;
  for (int j = threadIdx.x; j < p.iw * p.cg; j += kThreads) {
    const int g = j & (p.cg - 1), col = j >> p.lg;
    const bool live = g < gr && (!EDGE || (col >= lo && col < hi));
    int src = s0 + col * p.channels + g;
    float* dst = slots + g * p.slot + col;
    for (int r = 0; r < p.ih; ++r, src += row, dst += p.p_in) {
      const bool fetch = live && (!EDGE || (unsigned)(iy0 + r) < (unsigned)p.in_h);
      cp_async4(dst, w0 + (src >> kShift), fetch);
    }
  }
  cp_async_commit();
}

// 2. upsample along x: ih rows, mw columns in runs of kRun, from the landed
//    raw tile, scaled and its bias added; on a tile that crosses the plane's
//    edge (EDGE) what lies outside it is zero
template <typename T, int UP, int NQ, bool EDGE, bool NHWC>
__device__ __forceinline__ void x_up_pass(const TileRows<T>& t, const NhwcPlace& at,
                                          const float* slot, float* s_hu, const K4Params& p,
                                          int iy0, int ix0, float a, float b, const Walk& rows) {
  constexpr int kWinU = (kRun - 1 + UP - 1) / UP + NQ;
  const int runs = p.mw / kRun;
  for (Walk it = rows; it.slow < runs; it.next()) {
    const int r = it.fast, c0 = it.slow * kRun;
    const bool row_in = !EDGE || (unsigned)(iy0 + r) < (unsigned)p.in_h;
    float win[kWinU];
    if constexpr (!NHWC) {
      const T* src =
          reinterpret_cast<const T*>(slot + r * p.p_in) + t.shift(r, p.in_w) + c0 / UP;
#pragma unroll
      for (int i = 0; i < kWinU; ++i) {
        const float v = to_f32(src[i]) * a + b;
        win[i] = !EDGE || (row_in && (unsigned)(ix0 + c0 / UP + i) < (unsigned)p.in_w) ? v : 0.f;
      }
    } else {
      // a word an element; a bf16 element in the half its index gives
      const float* src = slot + r * p.p_in + c0 / UP;
      const int h0 = at.half(r, c0 / UP);
#pragma unroll
      for (int i = 0; i < kWinU; ++i) {
        const float raw =
            sizeof(T) == 4 ? src[i]
                           : to_f32(reinterpret_cast<const T*>(src)[2 * i + (h0 ^ (i & at.c))]);
        const float v = raw * a + b;
        win[i] = !EDGE || (row_in && (unsigned)(ix0 + c0 / UP + i) < (unsigned)p.in_w) ? v : 0.f;
      }
    }
    float acc[kRun];
    up_run<UP, NQ>(win, p, acc);
    float* dst = s_hu + r * p.p_hu + c0;
#pragma unroll
    for (int u = 0; u < kRun; ++u) dst[u] = acc[u];
  }
}

// 3. upsample along y, then bias-free leaky ReLU, gain and clamp: mh rows
template <int UP, int NQ>
__device__ __forceinline__ void y_up_pass(const float* s_hu, float* s_mid, const K4Params& p,
                                          const Walk& cols) {
  constexpr int kWinU = (kRun - 1 + UP - 1) / UP + NQ;
  const int runs = p.mh / kRun;
  for (Walk it = cols; it.slow < runs; it.next()) {
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

// 4. downsample along x: the mh_used rows the y pass reads, tw columns
template <int DOWN, int KD>
__device__ __forceinline__ void x_down_pass(const float* s_mid, float* s_hd, const K4Params& p,
                                            const Walk& rows) {
  constexpr int kWinD = (kDownRun - 1) * DOWN + KD;
  const int runs = p.tw / kDownRun;
  for (Walk it = rows; it.slow < runs; it.next()) {
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

// 5. (NHWC) downsample along y and scale by o into the plane's staging tile
//    (pitch tw): tw columns, th rows in runs, the outputs inside the plane
template <int DOWN, int KD>
__device__ __forceinline__ void y_down_pass(const float* s_hd, float* stage, const K4Params& p,
                                            int oy0, int ox0, float o, const Walk& cols) {
  constexpr int kWinD = (kDownRun - 1) * DOWN + KD;
  const int runs = p.th / kDownRun;
  for (Walk it = cols; it.slow < runs; it.next()) {
    const int c = it.fast, t0 = it.slow * kDownRun;
    if (ox0 + c >= p.out_w || oy0 + t0 >= p.out_h) continue;
    const float* src = s_hd + (p.dy + t0 * DOWN) * p.p_hd + c;
    float win[kWinD];
#pragma unroll
    for (int i = 0; i < kWinD; ++i) win[i] = src[i * p.p_hd];
    float acc[kDownRun];
    down_run<DOWN, KD>(win, p, acc);
#pragma unroll
    for (int u = 0; u < kDownRun; ++u) {
      if (oy0 + t0 + u < p.out_h) stage[(t0 + u) * p.tw + c] = acc[u] * o;
    }
  }
}

// The store of a group's gr staged output tiles (NHWC), its items as the
// copy's: (column, channel) of a row, the channel fastest, so that a warp
// writes the channels of a few neighbouring pixels side by side; a thread
// takes the same items of every row. y_tile: the group's first channel at
// the tile's output row 0, column 0.
template <typename T>
__device__ __forceinline__ void store_group(const float* stage, T* y_tile, const K4Params& p,
                                            int oy0, int ox0, int gr) {
  const int row = p.out_w * p.channels, rows = min(p.th, p.out_h - oy0);
  for (int j = threadIdx.x; j < p.tw * p.cg; j += kThreads) {
    const int g = j & (p.cg - 1), col = j >> p.lg;
    if (g >= gr || ox0 + col >= p.out_w) continue;
    int dst = col * p.channels + g;
    const float* src = stage + g * p.s_out + col;
    for (int r = 0; r < rows; ++r, dst += row, src += p.tw)
      y_tile[dst] = from_f32<T>(*src);
  }
}

template <typename T, int UP, int DOWN, int NQ, int KD, bool NHWC>
__global__ void __launch_bounds__(kThreads) filtered_lrelu_kernel(
    const T* __restrict__ x, const float* __restrict__ bias,
    const float* __restrict__ in_scale, const float* __restrict__ out_scale, T* __restrict__ y,
    const K4Params p) {
  extern __shared__ float smem[];
  float* s_hu = smem + p.off_hu;   // region B: the x-upsampled tile
  float* s_hd = smem + p.off_hu;   // region B, later: the x-downsampled tile
  float* s_mid = smem + p.off_mid; // region C: the upsampled, activated tile
  const int tid = threadIdx.x;
  // the planes this block walks: NCHW any run of planes, NHWC a run of one
  // sample's channels
  int plane0, n, ns = 0, c0 = 0;
  if constexpr (NHWC) {
    ns = blockIdx.z / p.runs;
    c0 = (blockIdx.z - ns * p.runs) * p.pz;
    plane0 = ns * p.channels + c0;
    n = min(p.pz, p.channels - c0);
  } else {
    plane0 = blockIdx.z * p.pz;
    n = min(p.pz, p.planes - plane0);
  }
  // the tile, the same in every plane: the upsampled tile starts on phase 0,
  // so (m0 - pad0) is a multiple of UP
  const int oy0 = blockIdx.y * p.th, ox0 = blockIdx.x * p.tw;
  const int iy0 = (oy0 * DOWN - p.dy - p.py0) / UP;
  const int ix0 = (ox0 * DOWN - p.dx - p.px0) / UP;
  const int lo = max(0, -ix0), hi = min(p.iw, p.in_w - ix0);   // tile columns inside
  const bool edge = iy0 < 0 || iy0 + p.ih > p.in_h || ix0 < 0 || ix0 + p.iw > p.in_w;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(xa & ~(uintptr_t)3);
  // the passes' walks: each pass's items
  const Walk w_xu(tid, p.ih), w_yu(tid, p.mw), w_xd(tid, p.mh_used), w_yd(tid, p.tw);
  float b_next = bias[plane0 % p.channels];
  float a_next = in_scale != nullptr ? in_scale[plane0] : 1.f;
  float o_next = out_scale != nullptr ? out_scale[plane0] : 1.f;

  if constexpr (!NHWC) {
    const int64_t plane_elems = (int64_t)p.in_h * p.in_w;
    // element index of the tile's (row 0, column 0) in the next plane to issue
    int64_t e0 = (int64_t)((xa & 3) / sizeof(T)) + plane0 * plane_elems +
                 (int64_t)iy0 * p.in_w + ix0;
    TileRows<T> t(words, e0);
    // the input tile's words: as many a row as its elements take from any
    // place in a word
    constexpr int kPer = TileRows<T>::kPer;
    const Walk w_in(tid, (p.iw + kPer - 1) / kPer + kPer - 1);
    if (edge)
      issue_tile<T, true>(t, smem, p, iy0, lo, hi, w_in);
    else
      issue_tile<T, false>(t, smem, p, iy0, lo, hi, w_in);

    for (int k = 0; k < n; ++k) {
      const int plane = plane0 + k;
      const float b = b_next, a = a_next, o = o_next;
      const TileRows<T> cur = t;
      const float* slot = smem + (k & 1) * p.slot;
      // 1. this plane's input has landed (the barrier also ends the last
      //    plane's reads of region B and of the other slot); the next
      //    plane's goes in flight
      cp_async_wait();
      __syncthreads();
      if (k + 1 < n) {
        e0 += plane_elems;
        t = TileRows<T>(words, e0);
        float* next = smem + ((k + 1) & 1) * p.slot;
        if (edge)
          issue_tile<T, true>(t, next, p, iy0, lo, hi, w_in);
        else
          issue_tile<T, false>(t, next, p, iy0, lo, hi, w_in);
        b_next = bias[(plane + 1) % p.channels];
        if (in_scale != nullptr) a_next = in_scale[plane + 1];
        if (out_scale != nullptr) o_next = out_scale[plane + 1];
      }
      // 2. upsample along x
      const NhwcPlace none{0, 0, 0};
      if (edge)
        x_up_pass<T, UP, NQ, true, false>(cur, none, slot, s_hu, p, iy0, ix0, a, b, w_xu);
      else
        x_up_pass<T, UP, NQ, false, false>(cur, none, slot, s_hu, p, iy0, ix0, a, b, w_xu);
      __syncthreads();
      // 3. upsample along y, the activation
      y_up_pass<UP, NQ>(s_hu, s_mid, p, w_yu);
      __syncthreads();
      // 4. downsample along x
      x_down_pass<DOWN, KD>(s_mid, s_hd, p, w_xd);
      __syncthreads();
      // 5. downsample along y and store: tw columns, th rows in runs
      {
        constexpr int kWinD = (kDownRun - 1) * DOWN + KD;
        T* yp = y + (int64_t)plane * p.out_h * p.out_w;
        const int runs = p.th / kDownRun;
        for (Walk it = w_yd; it.slow < runs; it.next()) {
          const int c = it.fast, t0 = it.slow * kDownRun;
          const int ox = ox0 + c;
          if (ox >= p.out_w || oy0 + t0 >= p.out_h) continue;
          const float* src = s_hd + (p.dy + t0 * DOWN) * p.p_hd + c;
          float win[kWinD];
#pragma unroll
          for (int i = 0; i < kWinD; ++i) win[i] = src[i * p.p_hd];
          float acc[kDownRun];
          down_run<DOWN, KD>(win, p, acc);
#pragma unroll
          for (int u = 0; u < kDownRun; ++u) {
            const int oy = oy0 + t0 + u;
            if (oy < p.out_h) yp[(int64_t)oy * p.out_w + ox] = from_f32<T>(acc[u] * o);
          }
        }
      }
    }
  } else {
    float* stage = smem + p.off_out;   // the group's output tiles
    const TileRows<T> rows_unused(words, 0);   // NCHW's; an NHWC slot is a word an element
    // the walk's first channel at the tile's input row 0, column 0 (an
    // element index from the 4-byte boundary below x) and output row 0,
    // column 0
    const int64_t e_tile = (int64_t)((xa & 3) / sizeof(T)) +
                           (int64_t)ns * p.in_h * p.in_w * p.channels + c0 +
                           ((int64_t)iy0 * p.in_w + ix0) * p.channels;
    T* y_tile = y + (int64_t)ns * p.out_h * p.out_w * p.channels + c0 +
                ((int64_t)oy0 * p.out_w + ox0) * p.channels;
    int gr = min(p.cg, n);   // planes of the current group
    if (edge)
      issue_group<T, true>(words, e_tile, smem, p, iy0, lo, hi, gr);
    else
      issue_group<T, false>(words, e_tile, smem, p, iy0, lo, hi, gr);
    int gr_next = 0;

    for (int k = 0; k < n; ++k) {
      const int plane = plane0 + k, gi = k & (p.cg - 1);
      const float b = b_next, a = a_next, o = o_next;
      // 1. at a group's first plane its inputs have landed; the barrier also
      //    ends the last plane's reads of region B and the last group's
      //    reads of the staging tiles
      if (gi == 0) cp_async_wait();
      __syncthreads();
      if (k + 1 < n) {
        b_next = bias[c0 + k + 1];
        if (in_scale != nullptr) a_next = in_scale[plane + 1];
        if (out_scale != nullptr) o_next = out_scale[plane + 1];
      }
      // 2. upsample along x from this plane's slot
      const NhwcPlace at{(int)((e_tile + k) & 1), (p.in_w * p.channels) & 1, p.channels & 1};
      const float* slot = smem + gi * p.slot;
      if (edge)
        x_up_pass<T, UP, NQ, true, true>(rows_unused, at, slot, s_hu, p, iy0, ix0, a, b, w_xu);
      else
        x_up_pass<T, UP, NQ, false, true>(rows_unused, at, slot, s_hu, p, iy0, ix0, a, b, w_xu);
      __syncthreads();
      // the group's inputs are read: with staging tiles of their own, the
      // next group's go in flight
      if (gi == gr - 1 && k + 1 < n && p.off_out) {
        gr_next = min(p.cg, n - k - 1);
        if (edge)
          issue_group<T, true>(words, e_tile + k + 1, smem, p, iy0, lo, hi, gr_next);
        else
          issue_group<T, false>(words, e_tile + k + 1, smem, p, iy0, lo, hi, gr_next);
      }
      // 3. upsample along y, the activation
      y_up_pass<UP, NQ>(s_hu, s_mid, p, w_yu);
      __syncthreads();
      // 4. downsample along x
      x_down_pass<DOWN, KD>(s_mid, s_hd, p, w_xd);
      __syncthreads();
      // 5. downsample along y into the plane's staging tile
      y_down_pass<DOWN, KD>(s_hd, stage + gi * p.s_out, p, oy0, ox0, o, w_yd);
      // the group is done: its outputs go out a pixel at a time; with the
      // staging tiles in the input slots, the next group's inputs go in
      // flight after that
      if (gi == gr - 1) {
        __syncthreads();
        store_group<T>(stage, y_tile + (k - gi), p, oy0, ox0, gr);
        if (k + 1 < n && !p.off_out) {
          gr_next = min(p.cg, n - k - 1);
          __syncthreads();
          if (edge)
            issue_group<T, true>(words, e_tile + k + 1, smem, p, iy0, lo, hi, gr_next);
          else
            issue_group<T, false>(words, e_tile + k + 1, smem, p, iy0, lo, hi, gr_next);
        }
        gr = gr_next;
      }
    }
  }
}

template <typename T, int UP, int DOWN, int NQ, int KD, bool NHWC>
int launch(const K4Params& p, const void* x, const void* b, const float* in_scale,
           const float* out_scale, void* y, cudaStream_t s) {
  auto kernel = filtered_lrelu_kernel<T, UP, DOWN, NQ, KD, NHWC>;
  static int smem_set = 0;   // the largest dynamic shared memory allowed so far
  if (p.smem_bytes > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = p.smem_bytes;
  }
  kernel<<<dim3(p.gx, p.gy, p.gz), kThreads, p.smem_bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(b), in_scale, out_scale,
      static_cast<T*>(y), p);
  return (int)cudaGetLastError();
}

template <typename T, int UP, int DOWN, int NQ, int KD>
int launch_layout(const K4Params& p, const void* x, const void* b, const float* si,
                  const float* so, void* y, cudaStream_t s) {
  return p.nhwc ? launch<T, UP, DOWN, NQ, KD, true>(p, x, b, si, so, y, s)
                : launch<T, UP, DOWN, NQ, KD, false>(p, x, b, si, so, y, s);
}

template <typename T>
int dispatch(const K4Params& p, const void* x, const void* b, const float* si, const float* so,
             void* y, cudaStream_t s) {
  const int u = p.up, d = p.down, q = p.nq, k = p.kd;
  // the published layers
  if (u == 2 && d == 2 && q == 6 && k == 12)
    return launch_layout<T, 2, 2, 6, 12>(p, x, b, si, so, y, s);
  if (u == 4 && d == 2 && q == 6 && k == 12)
    return launch_layout<T, 4, 2, 6, 12>(p, x, b, si, so, y, s);
  if (u == 1 && d == 1 && q == 1 && k == 1)
    return launch_layout<T, 1, 1, 1, 1>(p, x, b, si, so, y, s);
  // any other count, zero-padded to 24 taps
  if (k != kMaxTaps || q != kMaxTaps / u) return (int)cudaErrorInvalidValue;
  if (u == 1 && d == 1) return launch_layout<T, 1, 1, 24, 24>(p, x, b, si, so, y, s);
  if (u == 1 && d == 2) return launch_layout<T, 1, 2, 24, 24>(p, x, b, si, so, y, s);
  if (u == 2 && d == 1) return launch_layout<T, 2, 1, 12, 24>(p, x, b, si, so, y, s);
  if (u == 2 && d == 2) return launch_layout<T, 2, 2, 12, 24>(p, x, b, si, so, y, s);
  if (u == 4 && d == 1) return launch_layout<T, 4, 1, 6, 24>(p, x, b, si, so, y, s);
  if (u == 4 && d == 2) return launch_layout<T, 4, 2, 6, 24>(p, x, b, si, so, y, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// in_scale / out_scale: one float a plane (N x C), or null for 1
extern "C" int filtered_lrelu_run(const K4Params* p, const void* x, const void* b,
                                  const void* in_scale, const void* out_scale, void* y,
                                  void* stream) {
  if (p->planes < 1 || p->th % kDownRun || p->tw % kDownRun || p->mh % kRun ||
      p->mw % kRun || p->smem_bytes > 227 * 1024 || p->pz < 1 || p->gz > 65535)
    return (int)cudaErrorInvalidValue;
  if (p->nhwc) {   // runs of pz channels cover each sample's channels
    if (p->cg < 1 || p->cg > 32 || p->cg != (1 << p->lg) || p->runs < 1 ||
        (int64_t)p->pz * p->runs < p->channels ||
        (int64_t)p->pz * (p->runs - 1) >= p->channels ||
        p->planes % p->channels || (int64_t)(p->planes / p->channels) * p->runs != p->gz)
      return (int)cudaErrorInvalidValue;
  } else if ((int64_t)p->pz * p->gz < p->planes || (int64_t)p->pz * (p->gz - 1) >= p->planes) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* si = static_cast<const float*>(in_scale);
  const float* so = static_cast<const float*>(out_scale);
  return p->dtype == 1 ? dispatch<__nv_bfloat16>(*p, x, b, si, so, y, s)
                       : dispatch<float>(*p, x, b, si, so, y, s);
}
