// K8 — BCSR panel SpMM for Hopper (sm_90a), and K8d, its float64 twin.
//
// K8 replaces the Pallas TPU kernel tpusparse/kernels/bsr.py::
// _bsr_spmm_panels_static (body _bsr_kernel). The TPU kernel walks the
// blocks in order on one core, each grid step one (br, bc) x (bc, L)
// matmul on the MXU at Precision.HIGHEST, accumulated into the revisited
// (br, L) output panel of its block row (a first-of-row flag zeroes it).
// K8d is the port of the JAX package's float64 BSR product, XLA's einsum
// and segment sum (tpusparse/kernels/bsr.py::bsr_spmm), which has no
// Pallas kernel; it is the same template at IEEE float64.
//
// Computes Y (num_rows, L) = A X for X (num_cols, L), both row-major, A
// in BCSR: block b of block row R holds rows [R br, R br + br) and
// columns [bci[b] bc, bci[b] bc + bc). Rows of X past num_cols read 0 and
// rows of Y past num_rows are not written (the implicit zero padding of
// the edges); a block row with no blocks gives 0.
//
// Arithmetic: IEEE fused multiply-adds in the operand's type (float32 for
// K8): HIGHEST precision, no TF32, no tensor cores. Each output's dot
// product over its block row is split over a group of G lanes of one warp
// (column c to lane c mod G), each lane an FMA chain in block order, then
// a fixed butterfly of shuffles sums the G partial sums: the order is
// fixed, so two runs give bitwise equal Y.
//
// Bound: bytes. Every stored block entry is read once and used L times
// (2 L flops per 4 B in float32: below the card's flop-per-byte balance
// up to L of about 40). Design, simple first: one CTA per block row, so
// no output is shared between CTAs and nothing needs atomics; the CTA's
// 256 threads cover the br x L outputs of the panel, G = 256 / (br L)
// lanes each (a power of two up to 32: a warp per row at L = 1 with the
// (8, 128) blocks), in rounds when br L exceeds 256. For each block the
// CTA first copies the block and its X panel (contiguous runs for whole
// rows) into shared memory, every thread's loads in flight at once, and
// then multiplies from there, so the FMA chains wait on one copy a block
// and not on a global load each (PERF.md). Double-buffered copies and
// tensor-core blocks (split-TF32 held to the float32 bound, or wgmma)
// are later work.

#include <cstdint>

#include <cuda_runtime.h>

#include "rn_arith.cuh"

namespace {

constexpr int kThreads = 256;
// Shared memory for one chunk of a block and its X rows (at most).
constexpr int kSmemBytes = 24 * 1024;

// One CTA per block row. A round covers rw block rows x lw columns of Y
// (the whole (br, L) panel whenever br L G <= 256); for each block of the
// row it stages chunks of ct block columns in shared memory, the block's
// entries as (rw, ct) and the chunk's X rows as (ct, lw), with every
// thread's loads in flight together, then each lane of a G-group runs its
// FMA chain over the chunk's columns c = sub mod G. ct is a multiple of G,
// so a lane's columns stay in ascending order across chunks and the sums
// do not depend on ct.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_kernel(const int* __restrict__ bro, const int* __restrict__ bci,
           const T* __restrict__ blocks, const T* __restrict__ x,
           T* __restrict__ y, long long num_rows, long long num_cols,
           int br, int bc, int L, int group, int rw, int lw, int ct) {
  extern __shared__ unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // (ct, lw)
  T* as = xs + ct * lw;                     // (rw, ct)
  const long long brow = blockIdx.x;
  const int b0 = __ldg(bro + brow);
  const int b1 = __ldg(bro + brow + 1);
  const int sub = threadIdx.x & (group - 1);
  const int slot = threadIdx.x / group;
  const int rr = slot / lw;
  const int j = slot - rr * lw;
  // every thread runs the same rounds and chunks, so the barriers and the
  // shuffles see every thread
  for (int r0 = 0; r0 < br; r0 += rw) {
    const int rn = min(rw, br - r0);
    for (int l0 = 0; l0 < L; l0 += lw) {
      const int ln = min(lw, L - l0);
      const bool active = rr < rn && j < ln;
      T acc = T(0);
      for (int b = b0; b < b1; ++b) {
        const long long col0 = static_cast<long long>(__ldg(bci + b)) * bc;
        const T* blk = blocks + (static_cast<long long>(b) * br + r0) * bc;
        for (int c0 = 0; c0 < bc; c0 += ct) {
          const int cn = min(ct, bc - c0);
          __syncthreads();  // the previous chunk has been used
          if (ln == L) {  // whole X rows: one contiguous run
            const long long g0 = (col0 + c0) * L;
            const long long gend = num_cols * L;
#pragma unroll 4
            for (int i = threadIdx.x; i < cn * L; i += kThreads) {
              xs[i] = g0 + i < gend ? __ldg(x + g0 + i) : T(0);
            }
          } else {
            for (int i = threadIdx.x; i < cn * ln; i += kThreads) {
              const int c = i / ln;
              const int jj = i - c * ln;
              const long long col = col0 + c0 + c;
              xs[c * lw + jj] =
                  col < num_cols ? __ldg(x + col * L + l0 + jj) : T(0);
            }
          }
          if (cn == bc) {  // whole block rows: one contiguous run
#pragma unroll 4
            for (int i = threadIdx.x; i < rn * bc; i += kThreads) {
              as[i] = __ldg(blk + i);
            }
          } else {
            for (int i = threadIdx.x; i < rn * cn; i += kThreads) {
              const int r = i / cn;
              const int c = i - r * cn;
              as[r * ct + c] = __ldg(blk + static_cast<long long>(r) * bc +
                                     c0 + c);
            }
          }
          __syncthreads();
          if (active) {
            for (int c = sub; c < cn; c += group) {
              acc = tps_rn::fma(as[rr * ct + c], xs[c * lw + j], acc);
            }
          }
        }
      }
      for (int off = group / 2; off > 0; off /= 2) {
        acc = tps_rn::add(acc, __shfl_xor_sync(0xffffffffu, acc, off));
      }
      const long long row = brow * br + r0 + rr;
      if (active && sub == 0 && row < num_rows) {
        y[row * L + l0 + j] = acc;
      }
    }
  }
}

template <typename T>
int launch(const void* bro, const void* bci, const void* blocks,
           const void* x, void* y, long long num_rows, long long num_cols,
           long long num_block_rows, int br, int bc, int L, void* stream) {
  if (num_rows < 0 || num_cols < 0 || num_block_rows < 0 || br < 1 ||
      bc < 1 || L < 0 || num_block_rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_block_rows == 0 || L == 0) return 0;
  int group = 32;
  while (group > 1 && static_cast<long long>(br) * L * group > kThreads) {
    group /= 2;
  }
  const int slots = kThreads / group;
  const int lw = L < slots ? L : slots;
  const int rw = br < slots / lw ? br : slots / lw;
  // the widest chunk that fits, a multiple of G (rw + lw <= slots + 1, so
  // G columns always fit), or the whole block
  int ct = kSmemBytes / ((rw + lw) * static_cast<int>(sizeof(T)));
  ct -= ct % group;
  if (ct >= bc) ct = bc;
  if (ct < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(rw + lw) * ct * sizeof(T);
  bsr_kernel<T><<<static_cast<unsigned>(num_block_rows), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bro), static_cast<const int*>(bci),
      static_cast<const T*>(blocks), static_cast<const T*>(x),
      static_cast<T*>(y), num_rows, num_cols, br, bc, L, group, rw, lw, ct);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Y (num_rows, L) = A @ X (num_cols, L) for A in BCSR with (br, bc)
// blocks, float32 (K8): bro (num_block_rows + 1,) and bci (num_blocks,)
// int32, blocks (num_blocks, br, bc). Returns the cudaGetLastError() code
// after the launch.
extern "C" int tps_bsr(const void* bro, const void* bci, const void* blocks,
                       const void* x, void* y, long long num_rows,
                       long long num_cols, long long num_block_rows, int br,
                       int bc, int L, void* stream) {
  return launch<float>(bro, bci, blocks, x, y, num_rows, num_cols,
                       num_block_rows, br, bc, L, stream);
}

// The same in float64 (K8d): blocks, X and Y are double.
extern "C" int tps_bsr_f64(const void* bro, const void* bci,
                           const void* blocks, const void* x, void* y,
                           long long num_rows, long long num_cols,
                           long long num_block_rows, int br, int bc, int L,
                           void* stream) {
  return launch<double>(bro, bci, blocks, x, y, num_rows, num_cols,
                        num_block_rows, br, bc, L, stream);
}
