// K6 — exact row permutation y[i, :] = x[perm[i], :] for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpusparse/kernels/permute.py::
// _permute_call (body _permute_kernel). The TPU has no fast element
// gather, so that kernel rebuilt y = x[perm] from (8, 128) register
// tiles: a host plan splits each output tile's source blocks into
// subtiles of at most SPAN blocks, and a select loop lane-gathers and
// accumulates them. A GPU thread loads from any address, so none of that
// plan survives: this kernel reads perm itself.
//
// x and y are (n, L) row-major, L >= 1, of any 4- or 8-byte element type
// (float32, int32, float64). The kernel moves bits and does no
// arithmetic, so it is exact whatever the type. The wrapper views each
// row of L * itemsize bytes as `words` machine words of 4, 8 or 16 bytes
// (the widest that divides the row and the pointers' alignment), and one
// thread moves one word: the `words` threads of a row are neighbours, so
// a row of X is read as one contiguous run (at L = 16 in float32, four
// 16-byte loads), and y is written fully coalesced.
//
// Bound: bytes. perm (4 B a row) and y are streamed once; x is gathered
// once per row, a whole row at a time. A scattered perm at L = 1 makes
// each 4- or 8-byte load its own 32-byte sector, so the gather then costs
// up to 8 (or 4) times its byte count; an RCM or banded perm keeps
// neighbouring rows near each other and the sectors are shared.
//
// The A/B on the card (scripts/torch_k7_ab.py, PERF.md §6) kept this
// design against two others: a thread moving 2, 4 or 8 rows (16-byte
// loads of perm, the gathers issued together, 16-byte stores of y) was 1-6
// % slower, and a scatter y[perm^-1[j]] = x[j] (x read in order, the
// scattered traffic sent to the stores) 13-80 % slower. At L = 1 the
// gathers of the RCM order of a scrambled lap3d-160 are one random 32-byte
// L2 sector each, and the kernel runs at the rate L2 serves them: more
// gathers in flight a thread change nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

template <typename Word>
__global__ void __launch_bounds__(kBlock)
permute_rows_kernel(const int* __restrict__ perm, const Word* __restrict__ x,
                    Word* __restrict__ y, int64_t n, int words) {
  const int64_t total = n * words;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (e >= total) return;
  const int64_t i = words == 1 ? e : e / words;
  const int64_t w = e - i * words;
  const int64_t src = static_cast<int64_t>(__ldg(perm + i));
  y[e] = __ldg(x + src * words + w);
}

template <typename Word>
int run(const void* perm, const void* x, void* y, int64_t n, int words,
        cudaStream_t s) {
  const int64_t total = n * words;
  const int64_t blocks = (total + kBlock - 1) / kBlock;
  permute_rows_kernel<Word><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
      static_cast<const int*>(perm), static_cast<const Word*>(x),
      static_cast<Word*>(y), n, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = x[perm] for x and y of n rows of `words` words of `word_bytes`
// (4, 8 or 16) bytes each; perm (n,) int32 with entries in [0, n) (the
// wrapper's plan checks the range). n > 0. Returns the cudaGetLastError()
// code after the launch, cudaErrorInvalidValue for a word size other
// than 4, 8 or 16 or a grid past 2^31 - 1 blocks.
extern "C" int tps_permute(const void* perm, const void* x, void* y,
                           int64_t n, int words, int word_bytes,
                           void* stream) {
  if (n <= 0 || words <= 0 ||
      (n * words + kBlock - 1) / kBlock > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (word_bytes) {
    case 4:
      return run<uint32_t>(perm, x, y, n, words, s);
    case 8:
      return run<uint2>(perm, x, y, n, words, s);
    case 16:
      return run<uint4>(perm, x, y, n, words, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
