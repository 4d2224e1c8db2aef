// Packed re-rank scorers (sm_90a) over the cluster-packed store:
//   f32 / bf16 rows: sim[r, c] = tanh(q[r] · rows[starts[r] + c])
//   int8 rows:       raw[r, c] = q[r] · values[starts[r] + c]   (no scale, no tanh)
//
// Replace gdr_tpu/ops/pallas/rerank_kernel.py::packed_scores_pallas and
// ::packed_scores_pallas_int8, which DMA one contiguous [cap, d] block of
// the cluster-packed store per beam.  Both are purely memory-bound on the
// H100: 3,200 beams x 32 rows x 768 is 157 MB of bf16 rows (79 MB of int8)
// for 0.16 GFLOP.  One block per beam, one warp per candidate row: the
// block stages the query row in shared memory once (f32, as the TPU kernels
// cast it); each lane reads 16-byte chunks of the candidate row (8 bf16,
// 4 f32 or 16 int8 values, widened to f32), strided by the warp; the warp
// reduces with shuffles and lane 0 writes tanh, or for int8 the raw dot
// (the caller applies the per-row scale and the tanh, as the reference
// does).  The query is f32, so the int8 dot has no tensor-core path that
// keeps the result; at about 1.8 FLOP per byte it does not need one.  The
// wrapper guarantees d is a whole number of chunks and 16-byte aligned
// tensors.  The packed layout's cap-row tail margin keeps starts[r] + cap
// inside the store, so real beams need no bounds masking; pad rows are zero
// and the caller masks them.  A beam whose block would leave the store
// gets NaN scores instead of an out-of-bounds read.

#include "common.cuh"

namespace gdr {

constexpr int kThreads = 256;

// Rows a warp reads at once.  An int8 row of 768 values is only 48 chunks,
// 1.5 per lane, so a warp reads two rows with 16 lanes each and keeps
// twice the bytes in flight.
template <typename T> constexpr int kRowsPerWarp = Chunk<T>::n == 16 ? 2 : 1;

template <typename T, bool kRaw>
__global__ void __launch_bounds__(kThreads)
packed_scores_kernel(const T* __restrict__ rows, const int* __restrict__ starts,
                     const float* __restrict__ q, float* __restrict__ out, int M,
                     int D, int cap) {
  extern __shared__ float4 qs[];   // the query row, D floats in q_index<T> order
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const long long start = starts[r];
  if (start < 0 || start + cap > M) {
    for (int c = threadIdx.x; c < cap; c += blockDim.x)
      out[(size_t)r * cap + c] = __int_as_float(0x7fc00000);   // quiet NaN
    return;
  }
  stage_query<T>(q + (size_t)r * D, qs, D);
  __syncthreads();
  const float* qf = reinterpret_cast<const float*>(qs);
  const int chunks = D / Chunk<T>::n;
  constexpr int G = kRowsPerWarp<T>, LANES = 32 / G;
  const int sub = lane / LANES, gl = lane % LANES;
  for (int c0 = warp * G; c0 < cap; c0 += nw * G) {
    // a group past the last row re-reads row c0 and writes nothing, so
    // every lane reaches the shuffles
    const int c = c0 + sub < cap ? c0 + sub : c0;
    const uint4* row = reinterpret_cast<const uint4*>(rows + (size_t)(start + c) * D);
    const float s = row_dot<T, LANES>(row, qf, chunks, gl);
    if (gl == 0 && c0 + sub < cap) out[(size_t)r * cap + c] = kRaw ? s : tanhf(s);
  }
}

template <typename T, bool kRaw>
static cudaError_t launch(const void* rows, const void* starts, const void* q, void* out,
                          int M, int R, int D, int cap, cudaStream_t s) {
  const size_t smem = (size_t)D * sizeof(float);
  if (D % Chunk<T>::n != 0 || smem > 48 * 1024) return cudaErrorInvalidValue;
  packed_scores_kernel<T, kRaw><<<R, kThreads, smem, s>>>(
      static_cast<const T*>(rows), static_cast<const int*>(starts),
      static_cast<const float*>(q), static_cast<float*>(out), M, D, cap);
  return cudaGetLastError();
}

}  // namespace gdr

// dtype kF32 / kBF16: tanh of the dot; kI8: the raw dot
extern "C" int gdr_packed_scores(int dtype, const void* rows, const void* starts,
                                 const void* q, void* out, int m, int beams, int d,
                                 int cap, void* stream) {
  if (m <= 0 || beams <= 0 || d <= 0 || cap <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gdr::kF32:
      return gdr::launch<float, false>(rows, starts, q, out, m, beams, d, cap, s);
    case gdr::kBF16:
      return gdr::launch<__nv_bfloat16, false>(rows, starts, q, out, m, beams, d, cap, s);
    case gdr::kI8:
      return gdr::launch<int8_t, true>(rows, starts, q, out, m, beams, d, cap, s);
    default:
      return cudaErrorInvalidValue;
  }
}
