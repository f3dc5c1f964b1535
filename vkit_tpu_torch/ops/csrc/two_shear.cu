// The two-shear affine warp's work around its row shifts
// (vkit_tpu_torch/ops/warp_mxu.py, apply_affine_warp and
// apply_affine_warp_quad), as two kernels:
//   vk_quadrant_slab  each sample turned by its rot90 quadrant, cast to
//                     float32 and laid out as pass V's slab (N, W, C, H)
//   vk_line_blend     each line's 3-tap hat blend of its shifted window
//                     (K1's or K2's output), stored in the layout the next
//                     step reads
// They replace no TPU kernel: vkit_tpu/ops/warp_mxu.py leaves this work to
// XLA (jnp.rot90 / jnp.where, the one-hot einsum and weighted sum of
// apply_line_resample, the transposes between the passes), which fuses it
// into its programs.  Run eagerly as plain PyTorch it took a dozen kernels
// a pass, each moving a whole stack: a transpose copy, three gathers over
// an int64 index, five elementwise ops, the rot90's clone, index, flip and
// index_put.
//
// What bounds both on the H100: bytes moved.  Each output is a copy or
// five multiplies and adds of three taps, so the ceiling is device memory
// bandwidth (3.35 TB/s on an H100 SXM).  At the rotate cell's shape
// (32 x 640 x 640 x 5 float32, cardbench's distort-640.rotate) the slab
// reads and writes 262 MB each; a blend reads the window lanes its taps
// touch and writes its output once.
//
// Design, for Hopper: both are tiled transposes through shared memory.
//   - a block owns a 32 x 32 tile of one sample (lines x outputs, or
//     slab columns x rows) and up to 8 channels of it; 256 threads, a warp
//     per tile row, lanes along the tile's other axis;
//   - loads run along the axis that is contiguous in memory: the blend's
//     lanes take consecutive outputs, whose taps i0 + {0, 1, 2} are
//     consecutive window lanes; the slab's lanes take consecutive pixels of
//     a source row, whichever of the slab's axes that row runs along for
//     the sample's quadrant (columns for 0 and 2, rows for 1 and 3).  A
//     pixel's channels are interleaved, so a warp's loads of one channel
//     touch the same sectors as the next channel's, which L1 serves;
//   - stores run along the output's contiguous axis: 32 consecutive floats
//     (128 bytes) a warp for the slab and for the blend's (N, L, C, J) and
//     (N, J, C, L) layouts, a line's tile of outputs x channels as one run
//     for (N, L, J, C).  The tile's row pitch is 33 floats and its channel
//     planes are 8 banks apart, so neither phase conflicts on a bank but
//     for the (N, L, J, C) store's at most 2-way;
//   - memory-level parallelism: a thread issues every load of a tile line
//     (the blend: each channel's three taps) or of its share of the tile
//     (the slab: four rows of every channel) before it uses the first, the
//     channel loop unrolled to 8 and predicated;
//   - no staging by TMA: a tile is 4-5 KB a channel and each byte is read
//     once, so the loads are plain __ldg.
// Arithmetic, in the order of the plain PyTorch versions (ops/kernels.py),
// one IEEE rounding an operation and none contracted (__fmul_rn,
// __fadd_rn, __fsub_rn), so both kernels equal them bit for bit:
//   u = frac_j + phi; w0 = max(1 - u, 0); w2 = max(u - 1, 0);
//   w1 = (1 - w0) - w2; out = (a0 * w0 + a1 * w1) + a2 * w2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr int kRows = kThreads / kTile;         // tile rows a pass
constexpr int kChunk = 8;                       // channels a block
constexpr int kPitch = kTile + 1;               // floats a tile row
constexpr int kPlane = kTile * kPitch + 8;      // floats a channel plane

// The blend's output layouts (ops/kernels.py LINE_BLEND_LAYOUTS).
enum Layout { kNLCJ = 0, kNJCL = 1, kNLJC = 2 };

struct Blend {
  const float* win;
  const int32_t* i0;
  const float* frac;
  const float* phi;
  float* out;
  int lines, channels, width, outs;   // L, C, M, J
  int chunk, chunks, ltiles, jtiles;
};

__device__ __forceinline__ float clamp_min0(float v) {
  return v < 0.f ? 0.f : v;
}

// Blocks an SM: the (N, L, J, C) store takes 62 registers and spills
// under a cap of 48; the other layouts fit 48 and gain from a fifth
// block (timed on an H100, PERF.md section 6).
template <int kLayout>
__global__ void __launch_bounds__(kThreads, kLayout == kNLJC ? 1 : 5)
line_blend_kernel(Blend p) {
  __shared__ float tile[kChunk * kPlane];   // [c][j][l]
  __shared__ int s_i0[kTile];
  __shared__ float s_frac[kTile];
  __shared__ float s_phi[kTile];
  // Block -> (sample, channel chunk, line tile, output tile).
  int b = blockIdx.x;
  const int jt = b % p.jtiles;
  b /= p.jtiles;
  const int lt = b % p.ltiles;
  b /= p.ltiles;
  const int ch = b % p.chunks;
  const int n = b / p.chunks;
  const int j0 = jt * kTile, l0 = lt * kTile, c0 = ch * p.chunk;
  const int tj = min(kTile, p.outs - j0), tl = min(kTile, p.lines - l0);
  const int cn = min(p.chunk, p.channels - c0);
  const int tid = threadIdx.x, lane = tid % kTile, row = tid / kTile;

  if (tid < tj) {
    const int64_t k = (int64_t)n * p.outs + j0 + tid;
    // The taps stay inside the window whatever i0 holds (the plain
    // version raises on an i0 outside [0, M - 3]).
    s_i0[tid] = min(max(__ldg(p.i0 + k), 0), p.width - 3);
    s_frac[tid] = __ldg(p.frac + k);
  } else if (tid >= kTile && tid < kTile + tl) {
    s_phi[tid - kTile] = __ldg(p.phi + (int64_t)n * p.lines + l0 + tid - kTile);
  }
  __syncthreads();

  if (lane < tj) {
    const int i = s_i0[lane];
    const float frac = s_frac[lane];
    for (int l = row; l < tl; l += kRows) {
      const float u = __fadd_rn(frac, s_phi[l]);
      const float w0 = clamp_min0(__fsub_rn(1.f, u));
      const float w2 = clamp_min0(__fsub_rn(u, 1.f));
      const float w1 = __fsub_rn(__fsub_rn(1.f, w0), w2);
      const float* w =
          p.win + (((int64_t)n * p.lines + l0 + l) * p.channels + c0) *
                      p.width + i;
      // Every channel's taps in flight before the first is blended.
      float a[kChunk][3];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (c < cn) {
          const float* t = w + (int64_t)c * p.width;
          a[c][0] = __ldg(t);
          a[c][1] = __ldg(t + 1);
          a[c][2] = __ldg(t + 2);
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (c < cn)
          tile[c * kPlane + lane * kPitch + l] = __fadd_rn(
              __fadd_rn(__fmul_rn(a[c][0], w0), __fmul_rn(a[c][1], w1)),
              __fmul_rn(a[c][2], w2));
      }
    }
  }
  __syncthreads();

  if (kLayout == kNLCJ) {
    for (int r = row; r < tl * cn; r += kRows) {
      const int l = r / cn, c = r - l * cn;
      if (lane < tj)
        p.out[(((int64_t)n * p.lines + l0 + l) * p.channels + c0 + c) *
                  p.outs + j0 + lane] = tile[c * kPlane + lane * kPitch + l];
    }
  } else if (kLayout == kNJCL) {
    for (int r = row; r < tj * cn; r += kRows) {
      const int j = r / cn, c = r - j * cn;
      if (lane < tl)
        p.out[(((int64_t)n * p.outs + j0 + j) * p.channels + c0 + c) *
                  p.lines + l0 + lane] = tile[c * kPlane + j * kPitch + lane];
    }
  } else {
    // A line's tj outputs x cn channels: one run when the chunk is all C.
    const int run = tj * cn;
    for (int l = row; l < tl; l += kRows) {
      float* o = p.out + (((int64_t)n * p.lines + l0 + l) * p.outs + j0) *
                             p.channels + c0;
      for (int e = lane; e < run; e += kTile) {
        const int j = e / cn, c = e - j * cn;
        o[(int64_t)j * p.channels + c] = tile[c * kPlane + j * kPitch + l];
      }
    }
  }
}

struct QuadSlab {
  const void* x;
  const int32_t* quads;   // null: every sample in quadrant 0
  float* out;
  int height, width, channels;
  int chunk, chunks, utiles, ytiles;
};

// out[n, u, c, y] = rot90(x[n], k)[y, u, c] as float32, k = quads[n].
template <typename T>
__global__ void __launch_bounds__(kThreads) quadrant_slab_kernel(QuadSlab p) {
  __shared__ float tile[kChunk * kPlane];   // [c][u][y]
  int b = blockIdx.x;
  const int yt = b % p.ytiles;
  b /= p.ytiles;
  const int ut = b % p.utiles;
  b /= p.utiles;
  const int ch = b % p.chunks;
  const int n = b / p.chunks;
  const int y0 = yt * kTile, u0 = ut * kTile, c0 = ch * p.chunk;
  const int ty = min(kTile, p.height - y0), tu = min(kTile, p.width - u0);
  const int cn = min(p.chunk, p.channels - c0);
  const int lane = threadIdx.x % kTile, row = threadIdx.x / kTile;
  const int k = p.quads == nullptr ? 0 : (__ldg(p.quads + n) & 3);

  // Element offset of the turned image's pixel (y, u) in x[n]:
  // base + y * sy + u * su (np.rot90 on axes (1, 2); 1 and 3 square).
  const int64_t C = p.channels, W = p.width, H = p.height;
  int64_t base, sy, su;
  switch (k) {
    case 0: base = 0; sy = W * C; su = C; break;
    case 1: base = (W - 1) * C; sy = -C; su = W * C; break;
    case 2: base = ((H - 1) * W + W - 1) * C; sy = -W * C; su = -C; break;
    default: base = (H - 1) * W * C; sy = C; su = -W * C; break;
  }
  const T* src = static_cast<const T*>(p.x) + (int64_t)n * H * W * C + base +
                 c0 + (int64_t)y0 * sy + (int64_t)u0 * su;
  // Lanes along the axis that walks a source row.
  const bool lanes_on_u = (k & 1) == 0;
  // Every load of the thread in flight before the first is stored.
  T v[kTile / kRows][kChunk];
#pragma unroll
  for (int i = 0; i < kTile / kRows; ++i) {
    const int r = row + i * kRows;
    const int u = lanes_on_u ? lane : r, y = lanes_on_u ? r : lane;
    if (u < tu && y < ty) {
      const T* px = src + y * sy + u * su;
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (c < cn) v[i][c] = __ldg(px + c);
    }
  }
#pragma unroll
  for (int i = 0; i < kTile / kRows; ++i) {
    const int r = row + i * kRows;
    const int u = lanes_on_u ? lane : r, y = lanes_on_u ? r : lane;
    if (u < tu && y < ty) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (c < cn)
          tile[c * kPlane + u * kPitch + y] = static_cast<float>(v[i][c]);
    }
  }
  __syncthreads();

  for (int r = row; r < tu * cn; r += kRows) {
    const int u = r / cn, c = r - u * cn;
    if (lane < ty)
      p.out[(((int64_t)n * W + u0 + u) * C + c0 + c) * H + y0 + lane] =
          tile[c * kPlane + u * kPitch + lane];
  }
}

// Blocks of (n, chunk, tile, tile), or 0 when they pass the grid's int32.
int64_t blocks_of(int64_t n, int channels, int64_t a, int64_t b, int* chunk,
                  int* chunks, int* atiles, int* btiles) {
  *chunk = channels < kChunk ? channels : kChunk;
  *chunks = (channels + *chunk - 1) / *chunk;
  *atiles = (int)((a + kTile - 1) / kTile);
  *btiles = (int)((b + kTile - 1) / kTile);
  const int64_t blocks = n * *chunks * *atiles * *btiles;
  return blocks > 0x7fffffff ? 0 : blocks;
}

}  // namespace

extern "C" int vk_line_blend(const float* win, const int32_t* i0,
                             const float* frac, const float* phi, float* out,
                             int64_t n, int lines, int channels, int width,
                             int outs, int layout, void* stream) {
  if (n < 1 || lines < 1 || channels < 1 || width < 3 || outs < 1)
    return (int)cudaErrorInvalidValue;
  Blend p;
  p.win = win;
  p.i0 = i0;
  p.frac = frac;
  p.phi = phi;
  p.out = out;
  p.lines = lines;
  p.channels = channels;
  p.width = width;
  p.outs = outs;
  const int64_t blocks = blocks_of(n, channels, lines, outs, &p.chunk,
                                   &p.chunks, &p.ltiles, &p.jtiles);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int grid = (unsigned int)blocks;
  switch (layout) {
    case kNLCJ: line_blend_kernel<kNLCJ><<<grid, kThreads, 0, s>>>(p); break;
    case kNJCL: line_blend_kernel<kNJCL><<<grid, kThreads, 0, s>>>(p); break;
    case kNLJC: line_blend_kernel<kNLJC><<<grid, kThreads, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int vk_quadrant_slab(const void* x, int is_uint8,
                                const int32_t* quads, float* out, int64_t n,
                                int height, int width, int channels,
                                void* stream) {
  if (n < 1 || height < 1 || width < 1 || channels < 1)
    return (int)cudaErrorInvalidValue;
  QuadSlab p;
  p.x = x;
  p.quads = quads;
  p.out = out;
  p.height = height;
  p.width = width;
  p.channels = channels;
  const int64_t blocks = blocks_of(n, channels, width, height, &p.chunk,
                                   &p.chunks, &p.utiles, &p.ytiles);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned int grid = (unsigned int)blocks;
  if (is_uint8)
    quadrant_slab_kernel<uint8_t><<<grid, kThreads, 0, s>>>(p);
  else
    quadrant_slab_kernel<float><<<grid, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
