// Per-row integer shifts: the data-movement half of the two-shear affine
// warp (vkit_tpu_torch/ops/warp_mxu.py apply_line_resample).
//
// Replaces three TPU kernels of vkit_tpu/ops/pallas_kernels.py:
//   vk_row_shift_window_slab  <- _row_shift_window_slab_kernel /
//                                row_shift_window_slab (K1)
//   vk_row_shift              <- _row_shift_kernel / row_shift (K2)
//   vk_row_shift_window       <- _row_shift_window_kernel /
//                                row_shift_window (K4: K1 with one channel)
//
// What bounds it on the H100: bytes moved.  Each output element is one
// copy (or the border value) with no arithmetic, so the ceiling is device
// memory bandwidth (3.35 TB/s on an H100 SXM).
//
// K1 / K4.  out[r, c, j] = win_r[c][(starts[r] + j) mod 2048], where win_r
// holds x[r, c, :] at [0, W) and the border value elsewhere (the TPU
// kernel rolls a 2048-lane VMEM window; W + out_w <= 2048).  Row r's window
// overlaps the source in ONE interval [lo, hi) of lanes, so a row needs
// C * (hi - lo) source floats and writes C * out_w.  At its first launch
// in a synth-640 batch (chip_smoke.py phase 3), x (8, 640, 7, 640) ->
// out_w 1024 with every window over its whole row: 91.8 MB read + 146.8
// MB written, a bound of 0.071 ms at 3.35 TB/s.
//
// Design, for Hopper:
//   - one block owns a work item: a row r and a chunk of its channels (all
//     C = 7 at the main path).  One thread reads starts[r] once per item
//     and computes the row's interval; threads take channel c and output
//     chunk q from loop indices, with no 64-bit division;
//   - staging: for each channel, the 16-byte-aligned middle of
//     x[r, c, lo:hi] goes to shared memory in one TMA 1-D bulk copy
//     (cp.async.bulk, completion on an mbarrier); the ragged head and tail
//     (at most 3 floats each) are read straight from global memory;
//   - overlap: blocks are persistent (a few per SM, as the occupancy
//     calculator allows, over all 132 SMs) and walk the items with two
//     stages: item i+1's copies are in flight while item i is stored;
//   - stores: 16-byte float4 stores when out_w % 4 == 0 (scalar
//     otherwise); border lanes are made in registers, with no read.
// Lane indices are taken in 32-bit unsigned arithmetic, (start + j) & 2047,
// which is the two's complement mod 2048 for every int32 start, so the
// result equals the plain PyTorch version bit for bit, wrapping starts
// included.
//
// K2.  out[r, j] = x[r, clamp(starts[r] + j, 0, m_padded - 1)]: the caller
// pads the rows (the TPU kernel rolls a 1024-lane window of the padded row;
// its contract is 0 <= starts and starts + 1024 <= m_padded), so a row is
// one contiguous span of out_w floats in and one out, each at any float
// phase.  Bytes bound it: at the spread-split call (chip_smoke.py phase
// 3), x (8, 4480, 1792) -> out_w 702, 35,840 rows: 100.6 MB read + 100.6
// MB written, a bound of 0.060 ms at 3.35 TB/s.
//
// Design, for Hopper:
//   - one warp owns a row; row and lane come from the block and thread
//     index (no division), and starts[r] is one broadcast load per row;
//   - 16-byte traffic on both sides.  The output row splits into a head
//     (0-3 floats up to the first 16-byte boundary), full aligned quads
//     and a tail (0-3 floats).  Output quad t needs the source floats
//     [4t + d, 4t + d + 4) of the 16-byte-aligned source span, d in 0..3
//     the phase between the two sides.  Every lane loads whole aligned
//     source quads (ld.global.nc.v4, all of a row's loads issued before
//     the first store: up to 8 per lane, 2.8 KB in flight per warp at
//     out_w 702), takes the d floats it lacks from the next lane's quad
//     with warp shuffles (lane 31 from lane 0's next quad), and writes
//     one float4.  Each source byte is requested once; nothing goes
//     through shared memory;
//   - no staging or TMA: a row is 2.8 KB, so a bulk copy per row would pay
//     an mbarrier round trip for every 2.8 KB, and the realign would then
//     read shared memory at a 4-float lane stride (a 4-way bank conflict,
//     which K1's scalar reads have); registers and shuffles need neither.
//     Tried on the card: the same kernel with each lane loading both
//     quads itself instead of shuffling read 0.0798 ms where this one read
//     0.0757 and 0.0761 ms in the same call, and the kernel before it (a
//     thread per output float, scalar accesses, a 64-bit division each)
//     0.1365 ms (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 3,
//     PERF.md);
//   - blocks are 4 warps = 4 rows and not persistent: 8,960 short blocks at
//     the spread-split call, scheduled as SMs free up, so the ragged last
//     wave is one 4-row block long at most;
//   - a start outside the contract (negative, or the row would end past
//     m_padded) takes a scalar path that clamps each index in 64 bits, as
//     the plain version does; quads that would reach outside the tensor
//     (its first and last 12 bytes when it is not 16-byte aligned) are
//     read float by float.
// Copies only, so the result equals the plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kWindow = 2048;
constexpr int kShiftWarps = 4;      // K2: rows (warps) per block
constexpr int kSlabThreads = 128;   // K1 / K4
// Shared memory of one stage; two stages and the header stay under the
// 48 KB a block gets without opting in.
constexpr int kStageBytes = 23 * 1024;
constexpr int kHeaderBytes = 128;   // two mbarriers, two starts

// The lanes [lo, hi) of the 2048-lane window, starting at lane a, that hold
// the row (W + out_w <= 2048, so the overlap is one interval).
__device__ __forceinline__ void window_span(uint32_t a, int width,
                                            int out_width, int* lo, int* hi) {
  int s = (int)a;
  if (s < width) {
    *lo = s;
    *hi = min(s + out_width, width);
  } else if (s + out_width > kWindow) {
    *lo = 0;
    *hi = min(s + out_width - kWindow, width);
  } else {
    *lo = 0;
    *hi = 0;
  }
}

// The 16-byte-aligned middle [mid0, mid1) of [lo, hi) for a row whose lane
// 0 sits at float phase p (mod 4) in memory; empty as [lo, lo).
__device__ __forceinline__ void aligned_middle(int lo, int hi, uint32_t p,
                                               int* mid0, int* mid1) {
  int m0 = lo + (int)((4u - (((uint32_t)lo + p) & 3u)) & 3u);
  int m1 = hi - (int)(((uint32_t)hi + p) & 3u);
  if (m1 <= m0) m0 = m1 = lo;
  *mid0 = m0;
  *mid1 = m1;
}

struct Slab {
  const float* x;
  const int32_t* starts;
  float* out;
  int rows, channels, chunk, groups, width, out_width, region;
  float border;
};

// Float phase (mod 4) of x[r, c, 0] in memory.
__device__ __forceinline__ uint32_t row_phase(const Slab& s, int r, int c) {
  uint32_t base = (uint32_t)(((uintptr_t)s.x) >> 2);
  uint32_t rc = (uint32_t)r * (uint32_t)s.channels + (uint32_t)c;
  return (base + rc * (uint32_t)s.width) & 3u;
}

// Thread 0: start the copies of item `item` into `stage`.
__device__ void start_copies(const Slab& s, int item, int stage,
                             float* bufs, uint64_t* bars, int* s_start) {
  int r = item / s.groups;
  int c0 = (item - r * s.groups) * s.chunk;
  int cn = min(s.chunk, s.channels - c0);
  int start = __ldg(s.starts + r);
  s_start[stage] = start;
  int lo, hi;
  window_span((uint32_t)start & (kWindow - 1), s.width, s.out_width, &lo,
              &hi);
  // Shared memory read by the generic proxy in the previous use of this
  // stage is written by the async proxy next.
  tma::fence_proxy_async();
  uint32_t total = 0;
  for (int cc = 0; cc < cn; ++cc) {
    int m0, m1;
    aligned_middle(lo, hi, row_phase(s, r, c0 + cc), &m0, &m1);
    total += (uint32_t)(m1 - m0) * 4u;
  }
  tma::mbar_arrive_expect_tx(&bars[stage], total);
  for (int cc = 0; cc < cn; ++cc) {
    int m0, m1;
    aligned_middle(lo, hi, row_phase(s, r, c0 + cc), &m0, &m1);
    if (m1 > m0) {
      const float* src =
          s.x + ((int64_t)r * s.channels + c0 + cc) * s.width + m0;
      float* dst = bufs + ((size_t)stage * s.chunk + cc) * s.region;
      tma::bulk_copy_g2s(dst, src, (uint32_t)(m1 - m0) * 4u, &bars[stage]);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kSlabThreads)
row_shift_window_slab_kernel(Slab s) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* s_start = reinterpret_cast<int*>(smem + 16);
  float* bufs = reinterpret_cast<float*>(smem + kHeaderBytes);
  const int items = s.rows * s.groups;
  const int tid = threadIdx.x;

  if (tid == 0) {
    tma::mbar_init(&bars[0]);
    tma::mbar_init(&bars[1]);
    tma::mbar_init_fence();
  }
  __syncthreads();
  int item = blockIdx.x;
  if (tid == 0 && item < items) start_copies(s, item, 0, bufs, bars, s_start);

  for (int it = 0; item < items; ++it, item += gridDim.x) {
    const int stage = it & 1;
    const int next = item + gridDim.x;
    // The other stage was drained at the end of the previous iteration.
    if (tid == 0 && next < items)
      start_copies(s, next, stage ^ 1, bufs, bars, s_start);
    tma::mbar_wait(&bars[stage], (uint32_t)(it >> 1) & 1u);

    const int r = item / s.groups;
    const int c0 = (item - r * s.groups) * s.chunk;
    const int cn = min(s.chunk, s.channels - c0);
    const uint32_t a = (uint32_t)s_start[stage];
    int lo, hi;
    window_span(a & (kWindow - 1), s.width, s.out_width, &lo, &hi);
    for (int cc = 0; cc < cn; ++cc) {
      const int c = c0 + cc;
      int m0, m1;
      aligned_middle(lo, hi, row_phase(s, r, c), &m0, &m1);
      const int64_t rc = (int64_t)r * s.channels + c;
      const float* xrow = s.x + rc * s.width;
      const float* buf = bufs + ((size_t)stage * s.chunk + cc) * s.region;
      float* orow = s.out + rc * s.out_width;
      auto value = [&](int j) -> float {
        const int k = (int)((a + (uint32_t)j) & (kWindow - 1));
        if (k >= s.width) return s.border;
        if (k >= m0 && k < m1) return buf[k - m0];
        return __ldg(xrow + k);   // ragged head or tail
      };
      if (kVec) {
        const int nq = s.out_width >> 2;
        for (int q = tid; q < nq; q += kSlabThreads) {
          const int j = q << 2;
          reinterpret_cast<float4*>(orow)[q] =
              make_float4(value(j), value(j + 1), value(j + 2), value(j + 3));
        }
      } else {
        for (int j = tid; j < s.out_width; j += kSlabThreads) {
          orow[j] = value(j);
        }
      }
    }
    // Every thread is done with this stage before it is refilled.
    __syncthreads();
  }
}

// K2.  An aligned source quad; floats outside the tensor [lo, hi) read 0
// (they are never selected).
__device__ __forceinline__ float4 load_quad(const float* p, const float* lo,
                                            const float* hi) {
  if (p >= lo && p + 4 <= hi) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p >= lo && p < hi) v.x = __ldg(p);
  if (p + 1 >= lo && p + 1 < hi) v.y = __ldg(p + 1);
  if (p + 2 >= lo && p + 2 < hi) v.z = __ldg(p + 2);
  if (p + 3 >= lo && p + 3 < hi) v.w = __ldg(p + 3);
  return v;
}

// The value the next quad of the row holds: the next lane's `cur`, or for
// lane 31 lane 0's `next` (the warp's following group of 32 quads).
__device__ __forceinline__ float from_next_quad(float cur, float next,
                                                int lane) {
  const float down = __shfl_down_sync(0xffffffffu, cur, 1);
  const float wrap = __shfl_sync(0xffffffffu, next, 0);
  return lane == 31 ? wrap : down;
}

// out[r, j] = x[r, clamp(starts[r] + j, 0, m_padded - 1)], one warp per
// row; kGroups * 32 aligned quads cover a row's source span.
template <int kGroups>
__global__ void __launch_bounds__(kShiftWarps * 32)
row_shift_kernel(const float* __restrict__ x,
                 const int32_t* __restrict__ starts, float* __restrict__ out,
                 int rows, int m_padded, int out_width) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kShiftWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int start = __ldg(starts + row);
  const float* xrow = x + (int64_t)row * m_padded;
  float* orow = out + (int64_t)row * out_width;

  if (start < 0 || start > m_padded - out_width) {
    // Outside the caller's contract: clamp every index into the row.
    for (int j = lane; j < out_width; j += 32) {
      int64_t k = (int64_t)start + j;
      k = k < 0 ? 0 : (k >= m_padded ? m_padded - 1 : k);
      orow[j] = __ldg(xrow + k);
    }
    return;
  }

  const float* src = xrow + start;
  const int dst_phase = (int)(((uintptr_t)orow >> 2) & 3u);
  const int head = min((4 - dst_phase) & 3, out_width);
  const int quads = (out_width - head) >> 2;
  const int tail = out_width - head - (quads << 2);
  // Phase of the source float that lands in the first aligned output slot.
  const int d = (int)(((uintptr_t)(src + head) >> 2) & 3u);
  const float* span = src + head - d;         // 16-byte aligned
  const int last = quads - 1 + (d > 0 ? 1 : 0);
  const float* lo = x;
  const float* hi = x + (int64_t)rows * m_padded;

  float4 a[kGroups + 1];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int t = g * 32 + lane;
    a[g] = t <= last ? load_quad(span + 4 * t, lo, hi)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  a[kGroups] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (lane < head) orow[lane] = __ldg(src + lane);
  if (lane < tail) {
    const int j = head + (quads << 2) + lane;
    orow[j] = __ldg(src + j);
  }

  float4* oq = reinterpret_cast<float4*>(orow + head);
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int t = g * 32 + lane;
    const float4 c = a[g];
    const float4 n = a[g + 1];
    float4 v = c;
    // d is the same for the whole warp, so every lane takes one branch.
    if (d == 1) {
      v = make_float4(c.y, c.z, c.w, from_next_quad(c.x, n.x, lane));
    } else if (d == 2) {
      v = make_float4(c.z, c.w, from_next_quad(c.x, n.x, lane),
                      from_next_quad(c.y, n.y, lane));
    } else if (d == 3) {
      v = make_float4(c.w, from_next_quad(c.x, n.x, lane),
                      from_next_quad(c.y, n.y, lane),
                      from_next_quad(c.z, n.z, lane));
    }
    if (t < quads) oq[t] = v;
  }
}

template <int kGroups>
int launch_shift(const float* x, const int32_t* starts, float* out, int rows,
                 int m_padded, int out_width, cudaStream_t stream) {
  const unsigned int blocks =
      (unsigned int)((rows + kShiftWarps - 1) / kShiftWarps);
  row_shift_kernel<kGroups><<<blocks, kShiftWarps * 32, 0, stream>>>(
      x, starts, out, rows, m_padded, out_width);
  return (int)cudaGetLastError();
}

template <bool kVec>
int launch_slab(const Slab& s, size_t smem, int items, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, row_shift_window_slab_kernel<kVec>, kSlabThreads, smem);
  if (err != cudaSuccess) return (int)err;
  int grid = per_sm * sms;
  if (grid < 1) grid = 1;
  if (grid > items) grid = items;
  row_shift_window_slab_kernel<kVec><<<grid, kSlabThreads, smem, stream>>>(s);
  return (int)cudaGetLastError();
}

int launch_window(const float* x, const int32_t* starts, float* out,
                  int64_t rows, int channels, int width, int out_width,
                  float border, void* stream) {
  Slab s;
  s.x = x;
  s.starts = starts;
  s.out = out;
  s.channels = channels;
  s.width = width;
  s.out_width = out_width;
  s.border = border;
  s.region = (width + 3) & ~3;  // floats per staged channel, 16-byte rows
  s.chunk = kStageBytes / (s.region * 4);
  if (s.chunk > channels) s.chunk = channels;
  s.groups = (channels + s.chunk - 1) / s.chunk;
  if (rows * s.groups > 0x7fffffff) return (int)cudaErrorInvalidValue;
  s.rows = (int)rows;
  size_t smem = kHeaderBytes + 2 * (size_t)s.chunk * s.region * 4;
  int items = s.rows * s.groups;
  bool vec = out_width % 4 == 0 && ((uintptr_t)out & 15) == 0;
  return vec ? launch_slab<true>(s, smem, items, (cudaStream_t)stream)
             : launch_slab<false>(s, smem, items, (cudaStream_t)stream);
}

}  // namespace

extern "C" int vk_row_shift_window_slab(
    const float* x, const int32_t* starts, float* out, int64_t rows,
    int channels, int width, int out_width, float border, void* stream) {
  return launch_window(x, starts, out, rows, channels, width, out_width,
                       border, stream);
}

// K4 is K1 with one channel: the same device code, its own entry point.
extern "C" int vk_row_shift_window(
    const float* x, const int32_t* starts, float* out, int64_t rows,
    int width, int out_width, float border, void* stream) {
  return launch_window(x, starts, out, rows, 1, width, out_width, border,
                       stream);
}

extern "C" int vk_row_shift(
    const float* x, const int32_t* starts, float* out, int64_t rows,
    int m_padded, int out_width, void* stream) {
  if (rows > 0x7fffffff || out_width < 1 || out_width > m_padded)
    return (int)cudaErrorInvalidValue;
  const int r = (int)rows;
  cudaStream_t s = (cudaStream_t)stream;
  // Source quads of a row: out_width / 4 and one more for the phase.
  switch ((out_width / 4 + 1 + 31) / 32) {
    case 1: return launch_shift<1>(x, starts, out, r, m_padded, out_width, s);
    case 2: return launch_shift<2>(x, starts, out, r, m_padded, out_width, s);
    case 3: return launch_shift<3>(x, starts, out, r, m_padded, out_width, s);
    case 4: return launch_shift<4>(x, starts, out, r, m_padded, out_width, s);
    case 5: return launch_shift<5>(x, starts, out, r, m_padded, out_width, s);
    case 6: return launch_shift<6>(x, starts, out, r, m_padded, out_width, s);
    case 7: return launch_shift<7>(x, starts, out, r, m_padded, out_width, s);
    case 8: return launch_shift<8>(x, starts, out, r, m_padded, out_width, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
