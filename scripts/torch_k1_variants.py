"""Write the variant trees of K1's A/B (``scripts/torch_k1_ab.py``).

Each variant is a copy of a tree's ``tpusparse_torch`` package (this
tree's, or the one under ``--base``) with
``csrc/dia_masked.cu`` (and, where the geometry or the launch changes,
``kernels/dia_stream.py`` and ``kernels/_build.py``) changed in one
respect, so that a design step is timed against the kernel without it,
or a variant against the design:

  rows1    one row a thread (step 1's rows a thread undone: scalar mask
           loads, x loads and y stores);
  gridy    the lanes spread over grid.y, a CTA one lane (step 1's lane
           walk undone: the mask is read again for each lane;
           rows1+gridy undoes step 1 whole);
  rows4    16 bytes of rows a thread (4 in float32, 2 in float64);
  rows16   64 bytes of rows a thread (16 in float32, 8 in float64);
  scalar   one guarded element load a value of x instead of 16-byte
           loads and a shift (step 2 undone);
  win      x through shared memory: the plan groups the offsets on the
           host into runs whose spread fits a window of the row block
           (``offset_groups``, in every ``DiaStreamDevice``), and per lane
           the CTA copies each group's window with ``cp.async`` into one of
           two stages (zero-filled where it crosses 0 or n; a group the
           32 KB stage cannot hold is read directly), the next lane's
           windows in flight while a lane computes; a thread reads its
           values from the window with 16-byte loads and a shift;
  win+single  win with one stage (each lane's copies waited for before
           it computes);
  win+bulk win with each interior window one 1-D bulk copy
           (``cp.async.bulk``) completing on an mbarrier per stage;
  a+b      variant a, then variant b.

Those variants edit ``dia_masked.cu`` as it was before its runs of
planes (``git archive a8eda11``), ``rows4`` and ``rows16`` any version.
On the design that reads each run of consecutive offsets as one window
of x in registers (``plane_runs``):

  copy     a run's window loaded as the vectors of an aligned window
           and shifted into place by copies (the first form of the
           design: one instance per run length, not per shift);
  cap3     runs cut at three planes instead of four;
  occ      ``__launch_bounds__`` asks for five CTAs an SM (at most 51
           registers a thread);
  lb<D>_<F> ``__launch_bounds__`` asks for D CTAs an SM in float64 (K1d)
           and F in float32 (K1): at most 65536 / (256 D) registers a
           thread in float64 (``lb6_4``: 42, 64 in float32); ``lb<D>d``
           is ``lb<D>_1``, which let K1 take 76;
  shfl     (on ``copy``) a thread loads only its own R values of a run's
           window, from the rounded-down address; the values past them
           are the next lane's first R, taken with ``__shfl_down_sync``,
           and the warp's last lane loads its own (threads past n stay to
           take part in the shuffles and store nothing).

    python3 scripts/torch_k1_variants.py build/ab rows1+gridy scalar win
    python3 scripts/torch_k1_variants.py build/ab copy cap3 copy+shfl
    python3 scripts/torch_k1_variants.py --base build/ab/old \
        --prefix old+ build/ab rows16

Every variant computes the same products and sums in the same order, so
its Y equals the design's bit for bit.
"""

import argparse
import re

import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ROWS = "  return kRowBytes / static_cast<int>(sizeof(T));"
PY_ROWS = "    return (K1_THREADS, K1_ROW_BYTES // itemsize,"

LANE_LOOP = "  for (int l = 0; l < L; ++l) {\n    const T* xl"
LANE_LOOP_Y = ("  for (int l = blockIdx.y; l < L; l += gridDim.y) {\n"
               "    const T* xl")
LAUNCH = "dia_masked_kernel<T><<<grid, kThreads, 0,"
LAUNCH_Y = ("dia_masked_kernel<T><<<dim3(grid, L < 65535 ? L : 65535), "
            "kThreads, 0,")

VECTOR_READS = "  if constexpr (R % V == 0) {\n    const int s = misalign(xl, c);"
SCALAR_READS = "  if constexpr (false) {\n    const int s = misalign(xl, c);"

# The shared-memory window design (kernel, host grouping and launch).
WIN_CU = r'''// K1 — masked constant-coefficient DIA SpMV / SpMM for Hopper (sm_90a),
// and K1d, its float64 twin.
//
// K1 replaces the Pallas TPU kernel tpusparse/kernels/dia_stream.py::
// _spmm_dia_stream_edge_mask (body _dia_stream_kernel_edge_mask). K1d
// replaces _spmm_dia_stream_df_edge_mask (body
// _dia_stream_kernel_df_edge_mask), which computes the same y in
// double-float (two-f32) arithmetic because Mosaic has no 64-bit types;
// on Hopper float64 is native, so K1d is the same template at IEEE fp64:
// no hi/lo split of x, y or the coefficients.
//
// Computes, for each RHS lane l and row i of a square n x n operator,
//   y[l, i] = sum_k coef_k(i) * x[l, i + off_k],  k in offset order,
//   coef_k(i) = bit k of mask[i] ? vals[k] : 0.
// The mask word is uint32: bit 31 is legal (up to 32 planes); the JAX
// package views the same words as int32.
//
// Bound: bytes. At L = 1 a row moves 12 B in float32 (mask word 4, x 4,
// y 4) and 20 B in float64 (4 + 8 + 8); each further lane adds the x and
// y bytes only, since the mask is read once for all lanes. 2K flops a
// row and lane is far below the card's flop-per-byte balance in either
// type. The design:
//
//  1. A CTA owns a block of kThreads * R consecutive rows, a thread R of
//     them (R = kRowBytes / sizeof(T): 8 in float32, 4 in float64), and
//     the CTA walks all L lanes itself. The thread's R mask words stay in
//     registers for every lane, and each lane's R outputs leave in one
//     16-byte store.
//  2. x goes through shared memory by offset group. The plan groups the
//     offsets on the host (kernels/dia_stream.py::offset_groups) into
//     runs of consecutive planes whose spread fits a window of the row
//     block: lap3d-160's {-25600}, {-160, -1, 0, 1, 160}, {25600}. Per
//     lane the CTA copies each group's window of x with 16-byte copies
//     from an address rounded down to 16 B; each output then reads its K
//     values from shared memory, R at a time with 16-byte loads and a
//     shift. Only a window that crosses 0 or n takes the element-wise
//     copy that zero-fills; interior windows take no guards. A group the
//     plan gave no window (the stage was full) is read by direct guarded
//     loads, in the same offset order, in this kernel.
//  3. The copies are cp.async into two stages: lane l + 1's windows are
//     in flight while lane l computes.
//
// Semantics kept from the TPU kernel: x[i + off] outside [0, n) reads 0
// (the TPU kernel's zero halo); in-range values are multiplied even when
// the coefficient is 0, as the TPU kernel's 0 * w is; products and sums
// round separately (no FMA contraction, rn_arith.cuh), in offset order,
// as the TPU kernel's select-multiply-add does. K1 and K1d therefore
// equal their plain versions bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

#include "rn_arith.cuh"

namespace {

constexpr int kMaxPlanes = 32;
constexpr int kThreads = 256;
// bytes of a copy into a window, and of a thread's run of rows
constexpr int kChunkBytes = 16;
constexpr int kRowBytes = 32;
// shared memory of one stage (the windows of one lane)
constexpr int kStageBytes = 32768;
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T>
__host__ __device__ constexpr int rows_per_thread() {
  return kRowBytes / static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ constexpr int chunk_elems() {
  return kChunkBytes / static_cast<int>(sizeof(T));
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

__device__ __forceinline__ void unpack(float4 v, float* b) {
  b[0] = v.x;
  b[1] = v.y;
  b[2] = v.z;
  b[3] = v.w;
}
__device__ __forceinline__ void unpack(double2 v, double* b) {
  b[0] = v.x;
  b[1] = v.y;
}
__device__ __forceinline__ float4 pack(const float* b) {
  return make_float4(b[0], b[1], b[2], b[3]);
}
__device__ __forceinline__ double2 pack(const double* b) {
  return make_double2(b[0], b[1]);
}

template <typename T>
struct K1Params {
  T vals[kMaxPlanes];
  int offsets[kMaxPlanes];
  int K;
  int num_groups;
  int k_end[kMaxPlanes];   // group g holds planes [k_end[g - 1], k_end[g])
  int lo[kMaxPlanes];      // its least offset
  int chunks[kMaxPlanes];  // kChunkBytes copies of its window; 0: direct
  int smem[kMaxPlanes];    // its window's first element in a stage
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// One element, or zeros where !in (the source is then not read).
template <int BYTES>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(BYTES), "r"(in ? BYTES : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements by which xl + i lies past a kChunkBytes boundary (i may be
// negative: the address arithmetic wraps, the remainder does not).
template <typename T>
__device__ __forceinline__ int misalign(const T* xl, long long i) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(xl) +
                      static_cast<uintptr_t>(i) * sizeof(T);
  return static_cast<int>((a & (kChunkBytes - 1)) / sizeof(T));
}

// Issue the copies of every window of lane xl into stage: the window of
// group g starts at row r0 + lo[g] rounded down to kChunkBytes.
template <typename T>
__device__ __forceinline__ void stage_lane(const K1Params<T>& p,
                                           const T* __restrict__ xl,
                                           long long n, long long r0,
                                           T* stage) {
  constexpr int V = chunk_elems<T>();
  for (int g = 0; g < p.num_groups; ++g) {
    const int nc = p.chunks[g];
    if (nc == 0) continue;
    const long long lo = r0 + p.lo[g];
    const long long start = lo - misalign(xl, lo);
    T* dst = stage + p.smem[g];
    if (start >= 0 && start + static_cast<long long>(nc) * V <= n) {
      for (int c = threadIdx.x; c < nc; c += kThreads) {
        cp_async16(dst + c * V, xl + start + c * V);
      }
    } else {
      for (int e = threadIdx.x; e < nc * V; e += kThreads) {
        const long long j = start + e;
        const bool in = j >= 0 && j < n;
        cp_async_elem<sizeof(T)>(dst + e, in ? xl + j : xl, in);
      }
    }
  }
}

// x of this thread's R rows at window element base + tid * R + j.
template <typename T, int R>
__device__ __forceinline__ void window_values(const T* win, int base,
                                              int tid, T (&x)[R]) {
  constexpr int V = chunk_elems<T>();
  if constexpr (R % V != 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = win[base + tid * R + j];
  } else {
    using VT = typename Vec<T>::type;
    constexpr int C = R / V;
    const VT* wv = reinterpret_cast<const VT*>(win) + base / V + tid * C;
    T buf[(C + 1) * V];
#pragma unroll
    for (int c = 0; c < C; ++c) unpack(wv[c], buf + c * V);
    const int s = base % V;
    if (s == 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) x[j] = buf[j];
      return;
    }
    unpack(wv[C], buf + C * V);
#pragma unroll
    for (int t = 1; t < V; ++t) {
      if (s == t) {
#pragma unroll
        for (int j = 0; j < R; ++j) x[j] = buf[j + t];
      }
    }
  }
}

// x of this thread's R rows read directly: xl[c + j], 0 outside [0, n).
template <typename T, int R>
__device__ __forceinline__ void direct_values(const T* __restrict__ xl,
                                              long long n, long long c,
                                              T (&x)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    x[j] = (c + j >= 0 && c + j < n) ? __ldg(xl + c + j) : T(0);
  }
}

template <typename T, int R>
__device__ __forceinline__ void accumulate(T (&acc)[R], const uint32_t (&w)[R],
                                           int k, T v, const T (&x)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const T c = ((w[j] >> k) & 1u) ? v : T(0);
    acc[j] = tps_rn::add(acc[j], tps_rn::mul(c, x[j]));
  }
}

template <int R>
__device__ __forceinline__ void load_mask(const uint32_t* __restrict__ mask,
                                          long long n, long long i0,
                                          uint32_t (&w)[R]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(mask + i0);
  if constexpr (R % 4 == 0) {
    if (i0 + R <= n && a % 16 == 0) {
#pragma unroll
      for (int c = 0; c < R / 4; ++c) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(mask + i0) + c);
        w[4 * c] = v.x;
        w[4 * c + 1] = v.y;
        w[4 * c + 2] = v.z;
        w[4 * c + 3] = v.w;
      }
      return;
    }
  } else if constexpr (R == 2) {
    if (i0 + 2 <= n && a % 8 == 0) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(mask + i0));
      w[0] = v.x;
      w[1] = v.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) w[j] = i0 + j < n ? __ldg(mask + i0 + j) : 0u;
}

// This thread's R outputs of lane yl: one 16-byte store per V rows where
// they lie in [0, n) on a 16-byte boundary, else element by element.
template <typename T, int R>
__device__ __forceinline__ void store_rows(T* __restrict__ yl, long long n,
                                           long long i0, const T (&acc)[R]) {
  constexpr int V = chunk_elems<T>();
  if constexpr (R % V == 0) {
    if (i0 + R <= n && reinterpret_cast<uintptr_t>(yl + i0) % 16 == 0) {
      using VT = typename Vec<T>::type;
#pragma unroll
      for (int c = 0; c < R / V; ++c) {
        reinterpret_cast<VT*>(yl + i0)[c] = pack(acc + c * V);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (i0 + j < n) yl[i0 + j] = acc[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_masked_kernel(const uint32_t* __restrict__ mask,
                  const T* __restrict__ xt, T* __restrict__ yt, long long n,
                  int L, int stage_elems,
                  const __grid_constant__ K1Params<T> p) {
  constexpr int R = rows_per_thread<T>();
  constexpr long long B = static_cast<long long>(kThreads) * R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* stages = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * B;
  const long long i0 = r0 + static_cast<long long>(tid) * R;

  uint32_t w[R];
  load_mask<R>(mask, n, i0, w);

  stage_lane(p, xt, n, r0, stages);
  cp_async_commit();
  for (int l = 0; l < L; ++l) {
    const T* xl = xt + static_cast<long long>(l) * n;
    if (l + 1 < L) {
      stage_lane(p, xl + n, n, r0, stages + ((l + 1) & 1) * stage_elems);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cur = stages + (l & 1) * stage_elems;
    T acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = T(0);
    int k = 0;
    for (int g = 0; g < p.num_groups; ++g) {
      const int ke = p.k_end[g];
      if (p.chunks[g] != 0) {
        const int lo = p.lo[g];
        const int m = misalign(xl, r0 + lo);
        const T* win = cur + p.smem[g];
        for (; k < ke; ++k) {
          T x[R];
          window_values<T, R>(win, p.offsets[k] - lo + m, tid, x);
          accumulate<T, R>(acc, w, k, p.vals[k], x);
        }
      } else {
        for (; k < ke; ++k) {
          T x[R];
          direct_values<T, R>(xl, n, i0 + p.offsets[k], x);
          accumulate<T, R>(acc, w, k, p.vals[k], x);
        }
      }
    }
    store_rows<T, R>(yt + static_cast<long long>(l) * n, n, i0, acc);
    __syncthreads();
  }
}

// groups: num_groups rows of (k_end, lo, chunks, smem). Refuses a table
// whose windows do not cover their planes' reads for this geometry.
template <typename T>
int launch(const void* mask, const void* xt, void* yt, long long n, int L,
           int K, const int* offsets, const T* vals, int num_groups,
           const int* groups, void* stream) {
  constexpr int R = rows_per_thread<T>();
  constexpr int V = chunk_elems<T>();
  constexpr long long B = static_cast<long long>(kThreads) * R;
  const cudaError_t bad = cudaErrorInvalidValue;
  if (K < 0 || K > kMaxPlanes || n < 0 || L < 0 || num_groups < 0 ||
      num_groups > K || (K > 0 && num_groups == 0)) {
    return static_cast<int>(bad);
  }
  K1Params<T> p{};
  p.K = K;
  p.num_groups = num_groups;
  for (int k = 0; k < K; ++k) {
    p.offsets[k] = offsets[k];
    p.vals[k] = vals[k];
  }
  int stage_elems = 0;
  int k = 0;
  for (int g = 0; g < num_groups; ++g) {
    const int* row = groups + 4 * g;
    p.k_end[g] = row[0];
    p.lo[g] = row[1];
    p.chunks[g] = row[2];
    p.smem[g] = row[3];
    if (row[0] <= k || row[0] > K || row[2] < 0 || row[3] < 0 ||
        row[3] % V != 0) {
      return static_cast<int>(bad);
    }
    for (; k < row[0]; ++k) {
      const long long spread = static_cast<long long>(offsets[k]) - row[1];
      if (row[2] != 0 && (spread < 0 || spread + B + V - 1 >
                                            static_cast<long long>(row[2]) *
                                                V)) {
        return static_cast<int>(bad);
      }
    }
    if (row[2] != 0) {
      const long long end = static_cast<long long>(row[3]) +
                            static_cast<long long>(row[2]) * V;
      if (end > kStageBytes / static_cast<long long>(sizeof(T))) {
        return static_cast<int>(bad);
      }
      if (end > stage_elems) stage_elems = static_cast<int>(end);
    }
  }
  if (k != K) return static_cast<int>(bad);
  if (n == 0 || L == 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(stage_elems) * sizeof(T);
  auto* kernel = dia_masked_kernel<T>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned grid = static_cast<unsigned>((n + B - 1) / B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mask), static_cast<const T*>(xt),
      static_cast<T*>(yt), n, L, stage_elems, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// yt (L, n) = A @ xt (L, n) for the masked operand (mask (n,), K planes),
// float32 (K1). offsets and vals are host arrays of K entries, groups a
// host array of num_groups (k_end, lo, chunks, smem) rows from the plan.
// Returns the cudaGetLastError() code after the launch.
extern "C" int tps_dia_masked(const void* mask, const void* xt, void* yt,
                              long long n, int L, int K, const int* offsets,
                              const float* vals, int num_groups,
                              const int* groups, void* stream) {
  return launch<float>(mask, xt, yt, n, L, K, offsets, vals, num_groups,
                       groups, stream);
}

// The same in float64 (K1d): xt, yt and vals are double.
extern "C" int tps_dia_masked_f64(const void* mask, const void* xt, void* yt,
                                  long long n, int L, int K,
                                  const int* offsets, const double* vals,
                                  int num_groups, const int* groups,
                                  void* stream) {
  return launch<double>(mask, xt, yt, n, L, K, offsets, vals, num_groups,
                        groups, stream);
}

// K1's geometry for values of value_bytes (4 or 8) into out[4]: threads a
// CTA, rows a thread, elements a copy, elements of a stage. Returns 0, or
// 1 for another value size.
extern "C" int tps_dia_masked_geometry(int value_bytes, int* out) {
  if (value_bytes != 4 && value_bytes != 8) return 1;
  const bool f64 = value_bytes == 8;
  out[0] = kThreads;
  out[1] = f64 ? rows_per_thread<double>() : rows_per_thread<float>();
  out[2] = f64 ? chunk_elems<double>() : chunk_elems<float>();
  out[3] = kStageBytes / value_bytes;
  return 0;
}
'''

WIN_PY_GEOMETRY = r'''# K1's geometry, mirrored from csrc/dia_masked.cu (kThreads, kChunkBytes,
# kRowBytes, kStageBytes) and checked against the library at every launch:
# threads a CTA, bytes of a copy into a shared-memory window, bytes of a
# thread's run of rows, bytes of the windows of one lane (one stage).
K1_THREADS = 256
K1_CHUNK_BYTES = 16
K1_ROW_BYTES = 32
K1_STAGE_BYTES = 32768

# the library's geometry by value size, read once
_lib_geometry: dict = {}


def k1_geometry(itemsize: int) -> tuple:
    """(threads a CTA, rows a thread, elements a copy, elements a stage)
    of K1 (itemsize 4) or K1d (itemsize 8)."""
    return (K1_THREADS, K1_ROW_BYTES // itemsize,
            K1_CHUNK_BYTES // itemsize, K1_STAGE_BYTES // itemsize)


def k1_block_rows(itemsize: int) -> int:
    """Rows of a K1 (K1d) CTA."""
    threads, rows, _, _ = k1_geometry(itemsize)
    return threads * rows


@dataclasses.dataclass(frozen=True)
class OffsetGroups:
    """K1's offset groups for values of ``value_bytes``: ``table`` holds
    one (k_end, lo, chunks, smem) row per group, in plane order. Group g
    holds planes [k_end of g - 1, k_end), lo is their least offset, and
    its window of x in shared memory is ``chunks`` copies of
    ``K1_CHUNK_BYTES`` from element ``smem`` of a stage; chunks = 0 means
    the group has no window and is read by direct loads."""

    value_bytes: int
    table: tuple


def offset_groups(offsets, itemsize: int) -> OffsetGroups:
    """Group K1's planes for a shared-memory window each.

    Consecutive planes (in offset order, which fixes the order of the
    sums) share a group while the group's spread (largest less least
    offset) is at most a CTA's row block: a window then holds the row
    block plus the spread, rounded out to whole copies, and is never
    larger than the two windows it replaces. Windows are laid out in
    plane order while a stage has room; a group past that gets none."""
    offsets = [int(o) for o in offsets]
    _, _, V, stage = k1_geometry(itemsize)
    B = k1_block_rows(itemsize)
    table, used, k0 = [], 0, 0
    for k in range(1, len(offsets) + 1):
        if k < len(offsets):
            run = offsets[k0:k + 1]
            if max(run) - min(run) <= B:
                continue
        run = offsets[k0:k]
        lo, spread = min(run), max(run) - min(run)
        chunks = -(-(spread + B + V - 1) // V)
        if used + chunks * V <= stage:
            table.append((k, lo, chunks, used))
            used += chunks * V
        else:
            table.append((k, lo, 0, 0))
        k0 = k
    return OffsetGroups(itemsize, tuple(table))


'''

WIN_PY_LAUNCH = r'''def _check_geometry(lib, itemsize: int) -> None:
    """Raise unless the library's K1 geometry for ``itemsize`` is the
    mirror's (``k1_geometry``), which the plan's offset groups assume."""
    if itemsize not in _lib_geometry:
        out = (ctypes.c_int * 4)()
        if lib.tps_dia_masked_geometry(itemsize, ctypes.addressof(out)):
            raise RuntimeError(f"K1 has no geometry for {itemsize}-byte "
                               "values")
        _lib_geometry[itemsize] = tuple(out)
    if _lib_geometry[itemsize] != k1_geometry(itemsize):
        raise RuntimeError(
            f"K1's geometry for {itemsize}-byte values is "
            f"{_lib_geometry[itemsize]} in the library, "
            f"{k1_geometry(itemsize)} in dia_stream.py")


def _launch(D: DiaStreamDevice, XT: torch.Tensor) -> torch.Tensor:
    global LAUNCHES, LAUNCHES_F64
    L, n = XT.shape
    K = len(D.offsets)
    itemsize = XT.element_size()
    G = D.groups
    if G is None or G.value_bytes != itemsize:
        raise ValueError(
            f"K1 needs the operand's offset groups for {XT.dtype} "
            "(from_mask_words builds them)")
    lib = _build.library()
    _check_geometry(lib, itemsize)
    f64 = XT.dtype == torch.float64
    Y = torch.empty((L, n), dtype=XT.dtype, device=XT.device)
    offs = (ctypes.c_int * max(K, 1))(*D.offsets)
    vals = (_C_VALS[XT.dtype] * max(K, 1))(*D.vals_host)
    groups = (ctypes.c_int * max(4 * len(G.table), 1))(
        *(v for row in G.table for v in row))
    name = "tps_dia_masked_f64" if f64 else "tps_dia_masked"
    with torch.cuda.device(XT.device):
        stream = torch.cuda.current_stream(XT.device).cuda_stream
        rc = getattr(lib, name)(D.mask.data_ptr(), XT.data_ptr(),
                                Y.data_ptr(), n, L, K,
                                ctypes.addressof(offs),
                                ctypes.addressof(vals), len(G.table),
                                ctypes.addressof(groups), stream)
    _build.check(rc, name)
    if f64:
        LAUNCHES_F64 += 1
    else:
        LAUNCHES += 1
    return Y


'''

WIN_SIGNATURES = (
    '''    # mask, xt, yt, n, L, K, offsets (host int*), vals (host float* or
    # double*), stream
    "tps_dia_masked": (_P, _P, _P, _I64, _I32, _I32, _P, _P, _P),
    "tps_dia_masked_f64": (_P, _P, _P, _I64, _I32, _I32, _P, _P, _P),
''',
    '''    "tps_dia_masked": (_P, _P, _P, _I64, _I32, _I32, _P, _P, _I32, _P, _P),
    "tps_dia_masked_f64": (_P, _P, _P, _I64, _I32, _I32, _P, _P, _I32, _P,
                           _P),
''')

DOUBLE_BUFFER = '''  stage_lane(p, xt, n, r0, stages);
  cp_async_commit();
  for (int l = 0; l < L; ++l) {
    const T* xl = xt + static_cast<long long>(l) * n;
    if (l + 1 < L) {
      stage_lane(p, xl + n, n, r0, stages + ((l + 1) & 1) * stage_elems);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cur = stages + (l & 1) * stage_elems;
'''

SINGLE_STAGE = '''  for (int l = 0; l < L; ++l) {
    const T* xl = xt + static_cast<long long>(l) * n;
    stage_lane(p, xl, n, r0, stages);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const T* cur = stages;
'''

TWO_STAGES = "2 * static_cast<size_t>(stage_elems) * sizeof(T)"
ONE_STAGE = "static_cast<size_t>(stage_elems) * sizeof(T)"

BULK_HELPERS = '''__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" ::"r"(
      smem_addr(bar)));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\\n"
      ".reg .pred P1;\\n"
      "WAIT:\\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\\n"
      "@P1 bra.uni DONE;\\n"
      "bra.uni WAIT;\\n"
      "DONE:\\n"
      "}\\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Issue the copies of every window of lane xl into stage: thread 0 copies
// each interior window in one bulk copy on bar, the CTA's threads the
// windows that cross 0 or n element by element.
template <typename T>
__device__ __forceinline__ void stage_lane(const K1Params<T>& p,
                                           const T* __restrict__ xl,
                                           long long n, long long r0,
                                           T* stage, uint64_t* bar) {
  constexpr int V = chunk_elems<T>();
  if (threadIdx.x == 0) {
    unsigned bytes = 0;
    for (int g = 0; g < p.num_groups; ++g) {
      const int nc = p.chunks[g];
      const long long lo = r0 + p.lo[g];
      const long long start = lo - misalign(xl, lo);
      if (nc != 0 && start >= 0 &&
          start + static_cast<long long>(nc) * V <= n) {
        bytes += nc * kChunkBytes;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    mbar_expect(bar, bytes);
    for (int g = 0; g < p.num_groups; ++g) {
      const int nc = p.chunks[g];
      const long long lo = r0 + p.lo[g];
      const long long start = lo - misalign(xl, lo);
      if (nc != 0 && start >= 0 &&
          start + static_cast<long long>(nc) * V <= n) {
        bulk_copy(stage + p.smem[g], xl + start, nc * kChunkBytes, bar);
      }
    }
  }
  for (int g = 0; g < p.num_groups; ++g) {
    const int nc = p.chunks[g];
    if (nc == 0) continue;
    const long long lo = r0 + p.lo[g];
    const long long start = lo - misalign(xl, lo);
    if (start >= 0 && start + static_cast<long long>(nc) * V <= n) continue;
    T* dst = stage + p.smem[g];
    for (int e = threadIdx.x; e < nc * V; e += kThreads) {
      const long long j = start + e;
      const bool in = j >= 0 && j < n;
      cp_async_elem<sizeof(T)>(dst + e, in ? xl + j : xl, in);
    }
  }
}

'''

BULK_LOOP = '''  __shared__ uint64_t bars[2];
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
  stage_lane(p, xt, n, r0, stages, &bars[0]);
  cp_async_commit();
  for (int l = 0; l < L; ++l) {
    const T* xl = xt + static_cast<long long>(l) * n;
    if (l + 1 < L) {
      stage_lane(p, xl + n, n, r0, stages + ((l + 1) & 1) * stage_elems,
                 &bars[(l + 1) & 1]);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    mbar_wait(&bars[l & 1], (l >> 1) & 1);
    __syncthreads();
    const T* cur = stages + (l & 1) * stage_elems;
'''

SHFL_WINDOW = r'''// The window by shuffles: a thread loads its own R values from the
// rounded-down address a = c - s (whole vectors where they lie inside
// [0, n), else guarded element loads); the s + W - R values past them are
// the next lane's first ones (__shfl_down_sync), which the warp's last
// lane loads itself.
template <typename E, int R, int W>
__device__ __forceinline__ void window_shfl(const E* __restrict__ p,
                                            long long n, long long c,
                                            E (&v)[W]) {
  constexpr int V = vector_elems<E>();
  constexpr int X = W - R + V - 1;
  static_assert(R % V == 0 && X <= R, "window past the next lane's values");
  const int s = misalign(p, c);
  const long long a = c - s;
  E own[R];
  if (a >= 0 && a + R <= n) {
    using VT = typename Vec<E>::type;
    const VT* pv = reinterpret_cast<const VT*>(p + a);
#pragma unroll
    for (int q = 0; q < R / V; ++q) unpack(__ldg(pv + q), own + q * V);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      own[j] = (a + j >= 0 && a + j < n) ? __ldg(p + a + j) : E{};
    }
  }
  E ext[X];
  const int need = s + W - R;
  const bool last = (threadIdx.x & 31) == 31;
#pragma unroll
  for (int q = 0; q < X; ++q) {
    if (q < need) {
      ext[q] = __shfl_down_sync(0xffffffffu, own[q], 1);
      const long long j = a + R + q;
      if (last) ext[q] = (j >= 0 && j < n) ? __ldg(p + j) : E{};
    }
  }
#pragma unroll
  for (int t = 0; t < V; ++t) {
    if (s == t) {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        v[e] = e + t < R ? own[e + t] : ext[e + t - R];
      }
    }
  }
}

'''
RUN_START = "// Planes k .. k + M - 1, one run"
KERNEL_START = "template <typename T>\n__global__ void __launch_bounds__(kThreads)"
RUN_LOOP = """      const long long c = i0 + p.offsets[k];
      add_run<T, R, kMaxRun>(misalign(xl, c), p.runs[r], xl, n, c, p, k, w,
                             acc);
"""
COPY_RUN_LOOP = """      add_run_of<T, R, kMaxRun>(p.runs[r], xl, n, i0, p, k, w, acc);
"""
COPY_RUNS = r'''// v[e] = p[c + e] for e < W, 0 outside [0, n). From p + c - s (s = c's
// misalignment): C = ceil(W / V) vectors, and one more where s + W passes
// them, where C + 1 vectors from there lie inside [0, n); else guarded
// element loads.
template <typename E, int W>
__device__ __forceinline__ void window_copy(const E* __restrict__ p,
                                            long long n, long long c,
                                            E (&v)[W]) {
  constexpr int V = vector_elems<E>();
  constexpr int C = (W + V - 1) / V;
  const int s = misalign(p, c);
  if (c - s >= 0 && c - s + (C + 1) * V <= n) {
    using VT = typename Vec<E>::type;
    const VT* pv = reinterpret_cast<const VT*>(p + (c - s));
    E buf[(C + 1) * V];
#pragma unroll
    for (int q = 0; q < C; ++q) unpack(__ldg(pv + q), buf + q * V);
    if (s + W > C * V) unpack(__ldg(pv + C), buf + C * V);
#pragma unroll
    for (int t = 0; t < V; ++t) {
      if (s == t) {
#pragma unroll
        for (int e = 0; e < W; ++e) v[e] = buf[e + t];
      }
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < W; ++e) {
    v[e] = (c + e >= 0 && c + e < n) ? __ldg(p + c + e) : E{};
  }
}

// Planes k .. k + M - 1, one run, from one window of R + M - 1 values.
template <typename T, int R, int M>
__device__ __forceinline__ void add_run(const T* __restrict__ xl,
                                        long long n, long long i0,
                                        const DiaParams<T>& p, int k,
                                        const uint32_t (&w)[R],
                                        T (&acc)[R]) {
  T x[R + M - 1];
  window_values<T, R + M - 1>(xl, n, i0 + p.offsets[k], x);
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const T v = p.vals[k + q];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const T c = ((w[j] >> (k + q)) & 1u) ? v : T(0);
      acc[j] = tps_rn::add(acc[j], tps_rn::mul(c, x[j + q]));
    }
  }
}

// add_run for a run of m planes, 1 <= m <= M.
template <typename T, int R, int M>
__device__ __forceinline__ void add_run_of(int m, const T* __restrict__ xl,
                                           long long n, long long i0,
                                           const DiaParams<T>& p, int k,
                                           const uint32_t (&w)[R],
                                           T (&acc)[R]) {
  if constexpr (M > 1) {
    if (m < M) {
      add_run_of<T, R, M - 1>(m, xl, n, i0, p, k, w, acc);
      return;
    }
  }
  add_run<T, R, M>(xl, n, i0, p, k, w, acc);
}

'''.replace("  window_values<T, R + M - 1>(", "  window_copy<T, R + M - 1>(")
WINDOW_LOADS = "  window_copy<T, R + M - 1>(xl, n, i0 + p.offsets[k], x);"
WINDOW_SHFL = "  window_shfl<T, R, R + M - 1>(xl, n, i0 + p.offsets[k], x);"
PAST_N = "  if (i0 >= n) return;\n"

STAGE_LANE_START = "// Issue the copies of every window of lane xl into stage"
STAGE_LANE_END = "// x of this thread's R rows at window element"


def _once(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"variant patch does not apply: {old[:60]!r}")
    return text.replace(old, new)


def _between(text: str, start: str, end: str, new: str) -> str:
    i = text.index(start)
    j = text.index(end, i)
    return text[:i] + new + text[j:]


def variant(cu: str, py: str, build: str, name: str) -> tuple:
    if "+" in name:
        for part in name.split("+"):
            cu, py, build = variant(cu, py, build, part)
        return cu, py, build
    if name == "rows1":
        cu = _once(cu, ROWS, "  return 1;")
        py = _once(py, PY_ROWS, "    return (K1_THREADS, 1,")
    elif name in ("rows4", "rows16"):
        nbytes = 16 if name == "rows4" else 64
        cu = _once(cu, "constexpr int kRowBytes = 32;",
                   f"constexpr int kRowBytes = {nbytes};")
        py = _once(py, "K1_ROW_BYTES = 32", f"K1_ROW_BYTES = {nbytes}")
    elif name == "gridy":
        cu = _once(cu, LANE_LOOP, LANE_LOOP_Y)
        cu = _once(cu, LAUNCH, LAUNCH_Y)
    elif name == "scalar":
        cu = _once(cu, VECTOR_READS, SCALAR_READS)
    elif name == "win":
        cu = WIN_CU
        py = _between(py, "# K1's geometry, mirrored", "def mask_words(",
                      WIN_PY_GEOMETRY)
        py = _once(py, "    vals_host: tuple\n",
                   "    vals_host: tuple\n    groups: OffsetGroups | None = "
                   "None\n")
        py = _once(py, "        tuple(float(v) for v in vals),\n    )",
                   "        tuple(float(v) for v in vals),\n"
                   "        offset_groups(offsets, vals.itemsize),\n    )")
        py = _between(py, "def _check_geometry(", "def spmm_dia_stream_t(",
                      WIN_PY_LAUNCH)
        build = _once(build, *WIN_SIGNATURES)
    elif name == "single":
        cu = _once(cu, DOUBLE_BUFFER, SINGLE_STAGE)
        cu = _once(cu, TWO_STAGES, ONE_STAGE)
    elif name == "bulk":
        cu = _between(cu, STAGE_LANE_START, STAGE_LANE_END, BULK_HELPERS)
        cu = _once(cu, DOUBLE_BUFFER, BULK_LOOP)
    elif name == "copy":
        cu = _between(cu, RUN_START, KERNEL_START, COPY_RUNS)
        cu = _once(cu, RUN_LOOP, COPY_RUN_LOOP)
    elif name == "cap3":
        cu = _once(cu, "constexpr int kMaxRun = 4;", "constexpr int kMaxRun = 3;")
        py = _once(py, "K1_MAX_RUN = 4", "K1_MAX_RUN = 3")
    elif name == "occ":
        cu = _once(cu, KERNEL_START, KERNEL_START[:-1] + ", 5)")
    elif re.fullmatch(r"lb\d+(d|_\d+)", name):
        f64, f32 = (name[2:-1], "1") if name.endswith("d") else \
            name[2:].split("_")
        cu = _once(cu, KERNEL_START, KERNEL_START[:-1] +
                   f", sizeof(T) == 8 ? {f64} : {f32})")
    elif name == "shfl":
        cu = _once(cu, RUN_START, SHFL_WINDOW + RUN_START)
        cu = _once(cu, WINDOW_LOADS, WINDOW_SHFL)
        cu = _once(cu, PAST_N, "")
    else:
        raise SystemExit(f"unknown variant {name}")
    return cu, py, build


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", type=Path)
    ap.add_argument("names", nargs="+")
    ap.add_argument("--base", type=Path, default=ROOT,
                    help="the tree whose tpusparse_torch the variants edit")
    ap.add_argument("--prefix", default="",
                    help="put before each variant's directory name")
    args = ap.parse_args()
    for name in args.names:
        tree = args.out / f"{args.prefix}{name}"
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(args.base / "tpusparse_torch",
                        tree / "tpusparse_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        kernels = tree / "tpusparse_torch" / "kernels"
        paths = (tree / "tpusparse_torch" / "csrc" / "dia_masked.cu",
                 kernels / "dia_stream.py", kernels / "_build.py")
        texts = variant(*(p.read_text() for p in paths), name)
        for p, text in zip(paths, texts):
            p.write_text(text)
        print(f"{tree}: {name}")


if __name__ == "__main__":
    main()
