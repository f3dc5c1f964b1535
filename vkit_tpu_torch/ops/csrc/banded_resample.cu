// Banded line resample: the 1-D linear resampler behind both passes of the
// banded two-pass warp (vkit_tpu_torch/ops/warp_banded.py), i.e. every
// camera, MLS and perspective-skew sample of the geometric stage.
//
// Replaces vkit_tpu/ops/pallas_kernels.py _banded_resample_kernel /
// banded_line_resample (K3).  The TPU kernel computes, per line l and
// output position j (p = j mod 128, b = base[n, l / 8, j / 128]):
//   out[n, l, c, j] = sum_{t < taps} max(0, 1 - |u - t|) * src(b + p + t),
//   u = pos[n, l, j] - (float(b) + float(p)),
// where src(k) reads a 2048-lane window that holds the row at lane 512
// and the border value elsewhere, with the lane index taken mod 2048.
// Only the taps floor(u) and floor(u) + 1 can carry weight; the others add
// exact zeros, so two taps, each masked to [0, taps), give the same sum.
//
// What bounds it on the H100: bytes moved.  Per (n, l, j) one pos float
// and per channel one output float, and the row's source floats once: a
// few bytes per output and ~15 flops, far below the card's compute roof.
// At its first launch in a synth-640 batch (chip_smoke.py phase 3),
// x (8, 640, 7, 640) -> 640, taps 64: 196.6 MB, a bound of 0.0587 ms at
// 3.35 TB/s; at the grid warps' (32, 768, 5, 640) -> 768 (phase 9) 767.6
// / 736.8 MB, 0.2291 / 0.2199 ms.
//
// Design, for Hopper:
//   - work item = (n, G consecutive lines of one 8-line base group, a
//     chunk of channels): G in 1, 2, 4, 8 and the chunk (all C unless one
//     line outgrows a stage) come from ops/kernels.py banded_launch, which
//     sizes a stage to ~36 KB.  Thread 0 decomposes an item once (32-bit
//     divisions, once per item; kernels.banded_item is its twin) and
//     leaves it in shared memory for the block;
//   - staging: the item's G * chunk * W source floats are contiguous in x,
//     so its 16-byte-aligned middle goes to shared memory in one TMA 1-D
//     bulk copy (cp.async.bulk, completion on an mbarrier); the ragged
//     head and tail (at most 3 floats each, when C * W % 4 != 0 or x is
//     off 16 bytes) are read by thread 0 and stored beside it.  A stage
//     mirrors global memory's 16-byte phase, so the copy's destination
//     stays aligned.  With the row in shared memory the window rule is an
//     index test against [0, W) and the border value in a register, for
//     any taps and base;
//   - overlap: blocks are persistent (at most 4 per SM, as shared memory
//     allows, over every SM) and walk the items with two stages: item
//     i + 1's copy is in flight while item i is computed and stored;
//   - compute: a warp takes one (line, 128-lane block) at a time, so the
//     block's base is one broadcast load, and a thread its lanes lane +
//     32 e, e < 4: consecutive threads read neighbouring shared-memory
//     words (no bank conflicts) and store 128 bytes a warp and channel.
//     Each thread loads pos once per output position, computes the two
//     taps' weights and window indices once, then loops over the channels
//     (unrolled for the channel counts the paths launch, a runtime loop
//     for the rest) reading both taps from shared memory.
// Tried on the card (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phases 3
// and 9, PERF.md): at the page-warp call this kernel reads 0.0766-0.0786
// ms in chip_smoke's turns (0.0735-0.0763 ms back to back) where the
// kernel before it -- a thread per output, a 64-bit division per output,
// channels in a runtime loop behind a branch on each weight, scalar gathers
// through L1 -- read 0.0929 ms in the same call, and F.grid_sample
// 0.0934-0.0959; at the grid warps 0.278 ms against 0.362-0.368 before.
// ptxas: 64 registers (the cap of __launch_bounds__(256, 4)), no spills.
// Stages of 18 and 36 KB tie; 72 KB (one block an SM at C = 7) is ~6%
// slower at the page warp and ~1% faster at the grid warps.  A second
// thread mapping, 4 consecutive lanes a thread with float4 pos loads and
// stores (~4-way bank conflicts on the tap reads), tied with this one
// within 0.3% at all three shapes and was dropped: it needs pos and out
// 16-byte aligned, this one nothing.
// Lane indices are taken in 32-bit unsigned arithmetic, (b + p + t0 + 512)
// & 2047, which is the two's complement mod 2048 of the plain version's
// 64-bit sum, so a tap far outside the band wraps back into the row as
// there.  The blend uses __fmul_rn / __fadd_rn so nvcc cannot contract it
// into an FMA, and reads both taps whatever their weight: the result
// rounds, and propagates a non-finite source, like the plain PyTorch
// version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kWindow = 2048;
constexpr int kRowOffset = 512;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;       // blocks per SM (<= 64 registers)
constexpr int kHeaderBytes = 128;   // two mbarriers, two items

struct Banded {
  const float* x;
  const int32_t* base;
  const float* pos;
  float* out;
  int lines, channels, width, jp, groups, taps;
  int lines_per_item, chunk, chunks, items_per_sample, items;
  int stage_floats;   // one stage's floats, a multiple of 4
  float border;
};

// One stage's work item.
struct Item {
  int row0;    // n * lines + its first line
  int lines;   // lines in the item (fewer at the end of a sample)
  int c0, cn;  // its channels
  int group;   // n * groups + first line / 8: the row of base
  int phase;   // float phase (mod 4) of its first source float
};

__device__ __forceinline__ Item decompose(const Banded& s, int item) {
  const int n = item / s.items_per_sample;
  const int rest = item - n * s.items_per_sample;
  const int lg = rest / s.chunks;
  const int ch = rest - lg * s.chunks;
  const int l0 = lg * s.lines_per_item;
  Item it;
  it.row0 = n * s.lines + l0;
  it.lines = min(s.lines_per_item, s.lines - l0);
  it.c0 = ch * s.chunk;
  it.cn = min(s.chunk, s.channels - it.c0);
  it.group = n * s.groups + (l0 >> 3);
  it.phase = 0;
  return it;
}

// Thread 0: decompose `item` and start its copy into `stage`.  Stage
// float phase + i holds the item's source float i.
__device__ void start_copy(const Banded& s, int item, int stage, float* bufs,
                           uint64_t* bars, Item* items) {
  Item it = decompose(s, item);
  const float* src =
      s.x + ((int64_t)it.row0 * s.channels + it.c0) * s.width;
  const int count = it.lines * it.cn * s.width;
  it.phase = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3u);
  items[stage] = it;
  float* buf = bufs + (size_t)stage * s.stage_floats + it.phase;
  int m0 = (4 - it.phase) & 3;
  int m1 = count - ((it.phase + count) & 3);
  if (m1 <= m0) m0 = m1 = count;   // no aligned middle: all read below
  // Shared memory read by the generic proxy in the previous use of this
  // stage is written by the async proxy next.
  tma::fence_proxy_async();
  tma::mbar_arrive_expect_tx(&bars[stage], (uint32_t)(m1 - m0) * 4u);
  if (m1 > m0)
    tma::bulk_copy_g2s(buf + m0, src + m0, (uint32_t)(m1 - m0) * 4u,
                       &bars[stage]);
  for (int i = 0; i < m0; ++i) buf[i] = __ldg(src + i);
  for (int i = m1; i < count; ++i) buf[i] = __ldg(src + i);
}

// One channel of a warp's 128 outputs: both taps from the staged row `sc`
// (or the border), blended as the plain version rounds, stored to `o`.
__device__ __forceinline__ void blend_channel(
    const float* sc, float* o, const float (&w0)[4], const float (&w1)[4],
    const int (&i0)[4], const int (&i1)[4], float border, int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v0 = i0[e] >= 0 ? sc[i0[e]] : border;
    const float v1 = i1[e] >= 0 ? sc[i1[e]] : border;
    o[lane + 32 * e] = __fadd_rn(__fmul_rn(w0[e], v0), __fmul_rn(w1[e], v1));
  }
}

// One warp: line `line` of the item, lanes [128 q, 128 q + 128), every
// channel.  `src` is the item's first staged float.
template <int kC>
__device__ __forceinline__ void resample_block(const Banded& s,
                                               const Item& it,
                                               const float* src,
                                               const int32_t* base_row,
                                               int line, int q, int lane) {
  const int b = __ldg(base_row + q);
  const int64_t row = (int64_t)it.row0 + line;
  const float* prow = s.pos + row * s.jp + (q << 7);
  float* orow = s.out + (row * s.channels + it.c0) * s.jp + (q << 7);
  const int cn = kC > 0 ? kC : it.cn;
  const float* sline = src + line * cn * s.width;

  float w0[4], w1[4];
  int i0[4], i1[4];   // staged column of each tap, -1 for the border
  const float fb = (float)b;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int p = lane + 32 * e;
    const float u = __ldg(prow + p) - (fb + (float)p);
    const float t0f = floorf(u);
    const int t0 = (int)t0f;
    const float a0 = fmaxf(1.0f - fabsf(u - t0f), 0.0f);
    const float a1 = fmaxf(1.0f - fabsf(u - (t0f + 1.0f)), 0.0f);
    w0[e] = (t0 >= 0 && t0 < s.taps) ? a0 : 0.0f;
    w1[e] = (t0 >= -1 && t0 < s.taps - 1) ? a1 : 0.0f;
    const uint32_t k0 = ((uint32_t)b + (uint32_t)p + (uint32_t)t0 +
                         (uint32_t)kRowOffset) & (kWindow - 1);
    const int col0 = (int)k0 - kRowOffset;
    const int col1 = (int)((k0 + 1u) & (kWindow - 1)) - kRowOffset;
    i0[e] = (col0 >= 0 && col0 < s.width) ? col0 : -1;
    i1[e] = (col1 >= 0 && col1 < s.width) ? col1 : -1;
  }

  if constexpr (kC > 0) {
#pragma unroll
    for (int cc = 0; cc < kC; ++cc)
      blend_channel(sline + cc * s.width, orow + (int64_t)cc * s.jp, w0, w1,
                    i0, i1, s.border, lane);
  } else {
    for (int cc = 0; cc < cn; ++cc)
      blend_channel(sline + cc * s.width, orow + (int64_t)cc * s.jp, w0, w1,
                    i0, i1, s.border, lane);
  }
}

template <int kC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
banded_resample_kernel(Banded s) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  Item* items = reinterpret_cast<Item*>(smem + 16);
  float* bufs = reinterpret_cast<float*>(smem + kHeaderBytes);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int blocks = s.jp >> 7;   // 128-lane blocks of a line

  if (tid == 0) {
    tma::mbar_init(&bars[0]);
    tma::mbar_init(&bars[1]);
    tma::mbar_init_fence();
    if ((int)blockIdx.x < s.items)
      start_copy(s, blockIdx.x, 0, bufs, bars, items);
  }
  __syncthreads();

  int item = blockIdx.x;
  for (int it = 0; item < s.items; ++it, item += gridDim.x) {
    const int stage = it & 1;
    const int next = item + gridDim.x;
    // The other stage was drained at the end of the previous iteration.
    if (tid == 0 && next < s.items)
      start_copy(s, next, stage ^ 1, bufs, bars, items);
    tma::mbar_wait(&bars[stage], (uint32_t)(it >> 1) & 1u);

    const Item cur = items[stage];
    const float* src = bufs + (size_t)stage * s.stage_floats + cur.phase;
    const int32_t* base_row = s.base + (int64_t)cur.group * blocks;
    const int units = cur.lines * blocks;
    int line = 0, q = warp;
    while (q >= blocks) { q -= blocks; ++line; }
    for (int u = warp; u < units; u += kWarps) {
      resample_block<kC>(s, cur, src, base_row, line, q, lane);
      q += kWarps;
      while (q >= blocks) { q -= blocks; ++line; }
    }
    // Every thread is done with this stage (and its item) before it is
    // refilled.
    __syncthreads();
  }
}

template <int kC>
int launch(const Banded& s, int grid, int smem, cudaStream_t stream) {
  auto kernel = banded_resample_kernel<kC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace

// ops/kernels.py banded_launch sizes lines_per_item, chunk, stage_floats,
// smem_bytes and grid; they are checked here against the shapes.
extern "C" int vk_banded_line_resample(
    const float* x, const int32_t* base, const float* pos, float* out,
    int n, int lines, int channels, int width, int jp, int groups, int taps,
    float border, int lines_per_item, int chunk, int stage_floats,
    int smem_bytes, int grid, void* stream) {
  const int g = lines_per_item;
  if (n < 1 || lines < 1 || channels < 1 || width < 1 || jp < 128 ||
      jp % 128 != 0 || (g != 1 && g != 2 && g != 4 && g != 8) ||
      chunk < 1 || chunk > channels || (g > 1 && chunk != channels) ||
      stage_floats % 4 != 0 ||
      (int64_t)stage_floats < (int64_t)g * chunk * width + 3 ||
      (int64_t)smem_bytes < kHeaderBytes + 8 * (int64_t)stage_floats ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  Banded s;
  s.x = x;
  s.base = base;
  s.pos = pos;
  s.out = out;
  s.lines = lines;
  s.channels = channels;
  s.width = width;
  s.jp = jp;
  s.groups = groups;
  s.taps = taps;
  s.lines_per_item = g;
  s.chunk = chunk;
  s.chunks = (channels + chunk - 1) / chunk;
  const int64_t per_sample = (int64_t)((lines + g - 1) / g) * s.chunks;
  const int64_t items = per_sample * n;
  if (items + grid > 0x7fffffff || (int64_t)n * lines > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  s.items_per_sample = (int)per_sample;
  s.items = (int)items;
  s.stage_floats = stage_floats;
  s.border = border;
  cudaStream_t st = (cudaStream_t)stream;
  // The channel counts the paths launch (5: the grid warps and
  // RandomDistortion; 7: the page warp; chip_smoke.py's phase-9 shape
  // line) get an unrolled loop; the rest, and split lines, the runtime one.
  switch (s.chunks == 1 ? channels : 0) {
    case 5: return launch<5>(s, grid, smem_bytes, st);
    case 7: return launch<7>(s, grid, smem_bytes, st);
    default: return launch<0>(s, grid, smem_bytes, st);
  }
}
