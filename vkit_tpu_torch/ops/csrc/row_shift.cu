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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 2048;
constexpr int kThreads = 256;       // K2
constexpr int kSlabThreads = 128;   // K1 / K4
// Shared memory of one stage; two stages and the header stay under the
// 48 KB a block gets without opting in.
constexpr int kStageBytes = 23 * 1024;
constexpr int kHeaderBytes = 128;   // two mbarriers, two starts

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(float* dst, const float* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

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
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  uint32_t total = 0;
  for (int cc = 0; cc < cn; ++cc) {
    int m0, m1;
    aligned_middle(lo, hi, row_phase(s, r, c0 + cc), &m0, &m1);
    total += (uint32_t)(m1 - m0) * 4u;
  }
  mbar_arrive_expect_tx(&bars[stage], total);
  for (int cc = 0; cc < cn; ++cc) {
    int m0, m1;
    aligned_middle(lo, hi, row_phase(s, r, c0 + cc), &m0, &m1);
    if (m1 > m0) {
      const float* src =
          s.x + ((int64_t)r * s.channels + c0 + cc) * s.width + m0;
      float* dst = bufs + ((size_t)stage * s.chunk + cc) * s.region;
      bulk_copy_g2s(dst, src, (uint32_t)(m1 - m0) * 4u, &bars[stage]);
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
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
    mbar_wait(&bars[stage], (uint32_t)(it >> 1) & 1u);

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

// out[r, j] = x[r, clamp(starts[r] + j, 0, m_padded - 1)].  The caller
// pads the rows (the TPU kernel's contract: 0 <= starts and
// starts + 1024 <= m_padded); the clamp only keeps a start outside that
// contract from reading another row.
__global__ void row_shift_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ starts,
    float* __restrict__ out, int64_t total, int m_padded, int out_width) {
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= total) return;
  int j = (int)(i % out_width);
  int64_t row = i / out_width;
  int k = starts[row] + j;
  k = k < 0 ? 0 : (k >= m_padded ? m_padded - 1 : k);
  out[i] = x[row * (int64_t)m_padded + k];
}

unsigned int blocks_for(int64_t total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
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
  int64_t total = rows * (int64_t)out_width;
  row_shift_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      x, starts, out, total, m_padded, out_width);
  return (int)cudaGetLastError();
}
