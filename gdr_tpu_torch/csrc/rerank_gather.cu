// Gather re-rank scorer (sm_90a) over the plain store:
//   sim[r, c] = tanh(q[r] · store[docs[r, c]]),  -1e9 where mask[r, c] is false.
//
// Replaces gdr_tpu/ops/pallas/rerank_kernel.py::rerank_scores_pallas, which
// streams each candidate row HBM -> VMEM with double-buffered row DMAs so
// the gathered [R, cap, d] candidates never exist in HBM.  On the H100 it
// is purely memory-bound: at 3,200 beams over clusters of at most 30
// documents (cap 64) it reads about 148 MB of bf16 rows for 0.15 GFLOP.
// One block per beam row, one warp per candidate: the block stages the f32
// query row in shared memory once; each lane reads 16-byte chunks of the
// candidate's store row (8 bf16 or 4 f32 values), the warp reduces with
// shuffles and lane 0 writes tanh.  A masked candidate writes -1e9 without
// reading its row: its output does not depend on the row, so the card reads
// only the real documents (the TPU kernel also DMAs the pad slots' doc 0).
// An unmasked doc id outside [0, N) writes NaN instead of reading out of
// bounds.  The TPU kernel's chunk and 8-row padding has no counterpart.
// The wrapper guarantees d is a whole number of chunks, 16-byte aligned
// store and query, int32 docs and a bool mask read as bytes.

#include "common.cuh"

namespace gdr {

constexpr int kGatherThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
rerank_scores_kernel(const T* __restrict__ store, const int* __restrict__ docs,
                     const unsigned char* __restrict__ mask,
                     const float* __restrict__ q, float* __restrict__ out, int N,
                     int D, int cap) {
  extern __shared__ float4 qs[];   // the query row, D floats
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  stage_query<T>(q + (size_t)r * D, qs, D);
  __syncthreads();
  const float* qf = reinterpret_cast<const float*>(qs);
  const int chunks = D / Chunk<T>::n;
  for (int c = warp; c < cap; c += nw) {
    const size_t o = (size_t)r * cap + c;
    if (!mask[o]) {
      if (lane == 0) out[o] = kNegInf;
      continue;
    }
    const int doc = docs[o];
    if (doc < 0 || doc >= N) {
      if (lane == 0) out[o] = __int_as_float(0x7fc00000);   // quiet NaN
      continue;
    }
    const uint4* row = reinterpret_cast<const uint4*>(store + (size_t)doc * D);
    const float s = row_dot<T>(row, qf, chunks, lane);
    if (lane == 0) out[o] = tanhf(s);
  }
}

template <typename T>
static cudaError_t launch_gather(const void* store, const void* docs, const void* mask,
                                 const void* q, void* out, int N, int R, int D, int cap,
                                 cudaStream_t s) {
  const size_t smem = (size_t)D * sizeof(float);
  if (D % Chunk<T>::n != 0 || smem > 48 * 1024) return cudaErrorInvalidValue;
  rerank_scores_kernel<T><<<R, kGatherThreads, smem, s>>>(
      static_cast<const T*>(store), static_cast<const int*>(docs),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(q),
      static_cast<float*>(out), N, D, cap);
  return cudaGetLastError();
}

}  // namespace gdr

extern "C" int gdr_rerank_scores(int dtype, const void* store, const void* docs,
                                 const void* mask, const void* q, void* out, int n,
                                 int beams, int d, int cap, void* stream) {
  if (n <= 0 || beams <= 0 || d <= 0 || cap <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gdr::kF32:
      return gdr::launch_gather<float>(store, docs, mask, q, out, n, beams, d, cap, s);
    case gdr::kBF16:
      return gdr::launch_gather<__nv_bfloat16>(store, docs, mask, q, out, n, beams, d,
                                               cap, s);
    default:
      return cudaErrorInvalidValue;
  }
}
