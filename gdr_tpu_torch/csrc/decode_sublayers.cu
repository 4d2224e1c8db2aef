// Decoder-sublayer kernels for the beam-decode loop (sm_90a).
//
// Replaces gdr_tpu/ops/pallas/decode_kernel.py: self_attn_sublayer (core
// _cached_self_attention), cross_attn_sublayer and ffn_sublayer.  The Python
// wrappers (gdr_tpu_torch/kernels/decode.py) compose each sublayer from the
// launches below:
//
//   FFN:        gemm(norm, relu)  -> h;        gemm(h, residual)    -> x'
//   self-attn:  gemm(norm, round) -> qkv;      self_attn_core       -> attn
//               (writes the new K/V row into the caches in place);
//               gemm(attn, residual) -> x'
//   cross-attn: gemm(norm, round) -> q;        cross_attn_core      -> o;
//               gemm(o, residual) -> x'
//
// Every intermediate is stored once in the model dtype, exactly where the
// TPU kernel rounds it: RMSNorm output, q/k/v, probabilities, attention
// output, ReLU'd FFN hidden, projection output before the residual add.
// Products accumulate in f32; scores and softmax are f32.
//
// Bounds on the H100 at R = 3,200 rows of t5-base: the GEMMs (QKV, Wo, wi,
// wo) are above the bf16 ridge and bound by tensor-core operations; at
// R = 32 they are bound by the weight bytes.  The attention cores are bound
// by bytes (the K/V caches, the per-query encoder K/V, q and the outputs).
//
// bf16 GEMM (gemm_wgmma): C = epi(A · Wᵀ) with A [M, K] and W [N, K] both
// K-major, the layout wgmma takes without a transpose.  The launch is
// persistent: at most one block per SM, each walking the work units
// blockIdx.x, blockIdx.x + gridDim.x, ... in a static order.  A work unit
// is an output tile (64 or 128 rows × 8 to 192 columns) and one of its
// `splits` ranges of k-tiles.  One producer warp keeps a ring of 3 to 8
// tiles in flight by TMA (128-byte swizzle, BK = 64 = one swizzle row) on
// full/empty mbarriers whose phases follow the block's running k-tile
// count, so it loads the next unit's tiles while the consumers finish the
// last one; one or two consumer warpgroups of 64 rows each issue wgmma
// m64nBNk16 with f32 accumulators in registers and release a stage, warp by
// warp, once its MMAs retire.  Ragged M, N and K edges arrive as TMA zeros.
// Split-K: each split writes its f32 partial to a workspace and arrives on
// the tile's counter (an atomic after a __threadfence); the last to arrive
// sums the partials in split order (so the result is the same on every
// call), resets the counter for the next launch and runs the epilogue.
// ReLU and rounding act only on the full sum.  The epilogue (round / ReLU /
// residual) stages the tile in shared memory of its own, apart from the
// ring the producer is refilling, so that global memory sees 16-byte row
// chunks, and masks the ragged edge.  The plan (tile, splits, blocks) is
// chosen per shape by a cost model (choose_plan, fitted to
// tools/gemm_plan_sweep.py): at R = 32 the K = 3,072 product splits its 48
// k-tiles 4 ways over 96 blocks that each read a slice of W once; at
// R = 992 and 3,200 the tile is sized so that the units fill >= 90% of the
// SMs in one wave (128×160: 125 tiles of N = 768 at 3,200 rows) or walk
// several waves.  Splits pay for their f32 partials, so only small row
// counts take them.  The mainloop is bound by the operand bytes the SMs
// pull from L2 (~8-9 TB/s at 3,200 rows) or, for narrow tiles, by the
// ring's depth against the load latency.
// The RMSNorm: the TPU kernel rounds norm(x) to the model dtype before the
// product, so a row kernel (rms_norm<T>) writes norm(x) once, [R, d] in the
// model dtype, and both GEMMs read it as a plain A operand.  In bf16 that
// costs one launch and ~10 MB at R = 3,200 (a few µs), gives the GEMM
// exactly the TPU kernel's rounded input, and keeps the mainloop pure TMA →
// wgmma (normalising A in registers would need the register-A form of wgmma
// and a second pass over every A tile).
//
// f32 GEMM: the same C = epi(A · Wᵀ) with exact f32 products summed in f32
// on the FMA units (no TF32: 67 TFLOP/s, so every main-path shape above ~40
// rows is bound by operations), in one of two kernels by the row count.
// Above 128 rows gemm_f32_ring_ws, warp-specialised and persistent (a TMA
// producer warpgroup on full / empty mbarriers, consumer warps of 8 x 12
// outputs a lane with the registers setmaxnreg gives them, every block an
// even share of the launch's k-tiles, so a tile's k-range may be cut across
// blocks and summed in k order by its last arrival).  Up to 128 rows
// gemm_f32_ring_rows (below it): all M rows in one tile padded to 8 or 16,
// W streamed once by TMA in strips split over the blocks of a cluster,
// split-K summed in shared and distributed shared memory.  Each has a cost
// model of its own that picks its plan (choose_plan_f32).

// Weights are in nn.Linear layout W[N, K].  The wrapper guarantees K and N
// are multiples of 8 and 16-byte aligned tensors (TMA's requirements).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <vector>

#include "common.cuh"
#include "hopper.cuh"

namespace gdr {

namespace cg = cooperative_groups;

enum Epi { kRound = 0, kRelu = 1, kResidual = 2 };

// the output before its final rounding to T: ReLU'd, or the residual plus
// the product rounded to T (the TPU kernel's x + y.astype(dtype))
template <int EPI, typename T>
__device__ __forceinline__ float epilogue(float acc, float resid) {
  if (EPI == kRelu) return fmaxf(acc, 0.f);
  if (EPI == kResidual) return resid + round_to<T>(acc);
  return acc;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ uint4 ld16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}
template <typename T>
__device__ __forceinline__ void st16(T* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// ------------------------------------------------------------- RMSNorm

// y = round(x · rsqrt(mean(x²) + eps) · scale), one warp a row of K (a
// multiple of 8) in 16-byte chunks; f32 mean of squares as _rms.  Both GEMMs
// read its output, [M, K] in the model dtype, as their plain A operand.
template <typename T>
__global__ void __launch_bounds__(256)
rms_norm(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ y, int M,
         int K, float eps) {
  constexpr int CH = Chunk<T>::n;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;                            // whole warps leave
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * K);
  const int chunks = K / CH;
  float ss = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    float f[CH];
    Chunk<T>::unpack(xr[c], f);
#pragma unroll
    for (int t = 0; t < CH; ++t) ss += f[t] * f[t];
  }
  const float ir = rsqrtf(warp_sum(ss) / (float)K + eps);
  for (int c = lane; c < chunks; c += 32) {
    float f[CH], s[CH];
    Chunk<T>::unpack(xr[c], f);
    Chunk<T>::unpack(sr[c], s);
#pragma unroll
    for (int t = 0; t < CH; ++t) f[t] = (f[t] * ir) * s[t];
    yr[c] = Chunk<T>::pack(f);
  }
}

// ------------------------------------------------------------- bf16 GEMM

constexpr int BK = 64;        // one 128-byte swizzle row of bf16
constexpr int kMaxSplits = 32;

template <int WG, int BN, int ST>
struct GemmShape {
  static constexpr int BM = 64 * WG;
  static constexpr int kConsumers = WG * 128;
  static constexpr int kThreads = kConsumers + 32;         // + the producer warp
  static constexpr int kABytes = BM * BK * 2, kBBytes = BN * BK * 2;
  static constexpr int kStage = kABytes + kBBytes;         // a multiple of 1,024
  static constexpr int kCLd = BN + 8;                      // staged C row, bf16
  static constexpr int kCBytes = BM * kCLd * 2;            // a multiple of 16
  static constexpr int kPart = BM * BN / 4;                // a split's partial, float4s
  // the ring, the staged C tile, the barriers and the last-split flag, and
  // slack to align the ring to 1,024 bytes
  static constexpr int kSmem = ST * kStage + kCBytes + 2 * ST * 8 + 16 + 1024;
  static_assert(kSmem <= 232448, "a Hopper block opts into at most 227 KB");
};

// work unit u of a launch: output tile u / splits (row-major over tiles_n
// column tiles) and its k-tiles [kb, ke), split u % splits of ktiles in
// near-equal ranges (splits <= ktiles, so none is empty)
struct Unit {
  int tile, split, m0, n0, kb, ke;
};

template <int BM, int BN>
__device__ __forceinline__ Unit unit_at(int u, int splits, int tiles_n, int ktiles) {
  Unit w;
  w.tile = u / splits;
  w.split = u - w.tile * splits;
  const int tm = w.tile / tiles_n;
  w.m0 = tm * BM;
  w.n0 = (w.tile - tm * tiles_n) * BN;
  w.kb = w.split * ktiles / splits;
  w.ke = (w.split + 1) * ktiles / splits;
  return w;
}

// ws: splits x [BM x BN] f32 partials per tile (null when splits == 1);
// counters: one int per tile, zero between launches
template <int WG, int BN, int ST, int EPI>
__global__ void __launch_bounds__(GemmShape<WG, BN, ST>::kThreads)
gemm_wgmma(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
           const __nv_bfloat16* __restrict__ resid, __nv_bfloat16* __restrict__ C,
           float4* __restrict__ ws, int* __restrict__ counters, int M, int N, int K,
           int splits) {
  using S = GemmShape<WG, BN, ST>;
  constexpr int BM = S::BM, NT = S::kConsumers;
  extern __shared__ __align__(16) uint8_t gemm_smem[];
  uint8_t* smem = gemm_smem + ((1024 - (smem_u32(gemm_smem) & 1023)) & 1023);
  __nv_bfloat16* cstage = reinterpret_cast<__nv_bfloat16*>(smem + ST * S::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * S::kStage + S::kCBytes);
  uint64_t* empty = full + ST;
  volatile int* last_split = reinterpret_cast<volatile int*>(empty + ST);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid & 31;
  const int tiles_n = (N + BN - 1) / BN;
  const int units = (M + BM - 1) / BM * tiles_n * splits;
  const int ktiles = (K + BK - 1) / BK;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG * 4);                // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // ring slot s of round r: full[s] completes its phase r once the tiles
  // land, empty[s] once every consumer warp is done with them; ph = r & 1
  if (wg == WG) {                                  // the producer warp
    if (tid == NT) {
      int s = 0, ph = 0, it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_at<BM, BN>(u, splits, tiles_n, ktiles);
        for (int kt = w.kb; kt < w.ke; ++kt, ++it) {
          if (it >= ST) mbar_wait(&empty[s], ph ^ 1);
          uint8_t* a = smem + s * S::kStage;
          mbar_expect_tx(&full[s], S::kStage);    // zero-filled bytes count too
          tma_load_2d(a, &ta, &full[s], kt * BK, w.m0);
          tma_load_2d(a + S::kABytes, &tw, &full[s], kt * BK, w.n0);
          if (++s == ST) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  const int warp = tid >> 5;                       // rows 16·warp .. of the tile
  int s = 0, ph = 0, prev = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_at<BM, BN>(u, splits, tiles_n, ktiles);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = w.kb; kt < w.ke; ++kt) {
      mbar_wait(&full[s], ph);
      const uint8_t* a = smem + s * S::kStage;
      const uint64_t da = sw128_desc(a + wg * 64 * BK * 2), db = sw128_desc(a + S::kABytes);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        Wgmma<BN>::mma(acc, da + 2 * ks, db + 2 * ks, 1);
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();                             // this warp's previous tile is done
      if (kt > w.kb) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == ST) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);      // the unit's last tile

    if (splits > 1) {
      // this split's partial in fragment order (thread t writes float4 j at
      // j·NT + t: each warp instruction stores 512 contiguous bytes); warps
      // whose 16 rows all lie past M neither write nor read theirs
      const bool live = w.m0 + warp * 16 < M;
      float4* part = ws + (size_t)w.tile * splits * S::kPart + tid;
      if (live) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          __stcg(part + (size_t)w.split * S::kPart + j * NT,
                 make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]));
      }
      __threadfence();
      named_sync(1, NT);
      if (tid == 0) {
        const int last = atomicAdd(&counters[w.tile], 1) == splits - 1;
        if (last) atomicExch(&counters[w.tile], 0);   // zero again for the next launch
        __threadfence();
        *last_split = last;
      }
      named_sync(1, NT);
      if (!*last_split) continue;
      __threadfence();
      if (live) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        for (int p = 0; p < splits; ++p) {         // in split order: deterministic
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float4 v = __ldcg(part + (size_t)p * S::kPart + j * NT);
            acc[4 * j] += v.x;
            acc[4 * j + 1] += v.y;
            acc[4 * j + 2] += v.z;
            acc[4 * j + 3] += v.w;
          }
        }
      }
    }

    // epilogue, staged in shared memory so that global memory sees 16-byte
    // row chunks: lane l of warp w holds rows 16w + l/4 (+8), column pairs
    // 8j + 2(l%4) of its warpgroup's 64 x BN tile
    named_sync(2 + wg, 128);                       // the last unit's reads are done
    __nv_bfloat16* cs = cstage + wg * 64 * S::kCLd;
    const int wq = warp & 3;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wq * 16 + (lane >> 2) + 8 * h, c = 8 * j + 2 * (lane & 3);
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        // the residual adds the rounded product below; the others finish here
        *reinterpret_cast<uint32_t*>(cs + r * S::kCLd + c) =
            EPI == kResidual ? pack2(v0, v1)
                             : pack2(epilogue<EPI, __nv_bfloat16>(v0, 0.f),
                                     epilogue<EPI, __nv_bfloat16>(v1, 0.f));
      }
    }
    named_sync(2 + wg, 128);
    for (int i = tid & 127; i < 64 * (BN / 8); i += 128) {
      const int r = i / (BN / 8), c = (i - r * (BN / 8)) * 8;
      const int row = w.m0 + wg * 64 + r, col = w.n0 + c;
      if (row >= M || col >= N) continue;          // N is a multiple of 8
      uint4 v = ld16(cs + r * S::kCLd + c);
      const size_t idx = (size_t)row * N + col;
      if (EPI == kResidual) {
        float p[8], x[8];
        unpack8(v, p);
        unpack8(ld16(resid + idx), x);
#pragma unroll
        for (int e = 0; e < 8; ++e) p[e] += x[e];
        v = pack8(p);
      }
      st16(C + idx, v);
    }
  }
}

// ------------------------------------------------------------- f32 GEMM, warp-specialised

// k-tiles of 32 floats, one 128-byte swizzle row; rings of at most 8 stages
constexpr int kWsBK = 32, kWsMaxStages = 8;
// registers a consumer thread holds once the roles split (setmaxnreg)
constexpr int kWsConsumerRegs = 232;

// The ring's block: one consumer warpgroup of WM x WN warps, each a 32 x
// 8·TN warp tile of 8 x TN outputs a lane, then a producer warpgroup
// (setmaxnreg acts on whole warpgroups; one of its threads issues the
// loads); two blocks an SM.
template <int WM, int WN, int TN>
struct WsRing {
  static constexpr int TM = 8;
  static constexpr int BM = 32 * WM, BN = 8 * TN * WN;
  static constexpr int kWarps = WM * WN;                   // consumer warps
  static constexpr int kConsumers = 32 * kWarps;
  static constexpr int kThreads = kConsumers + 128;
  // registers a thread starts with (__maxnreg__): half an SM's 65,536, in
  // the allocation's steps of 8; the producer warpgroup keeps what the
  // consumers' kWsConsumerRegs leave of the block's pool
  static constexpr int kEntryRegs = 65536 / (kThreads * 2) / 8 * 8;
  static constexpr int kProducerRegs =
      (kThreads * kEntryRegs - kConsumers * kWsConsumerRegs) / 128 / 8 * 8;
  static constexpr int kStage = (BM + BN) * kWsBK * 4;    // bytes, a multiple of 1,024
  static constexpr int kGroups = TM * TN / 4;              // a lane's float4s of outputs
  static_assert(kWarps == 4, "one consumer warpgroup");
  static_assert(BM <= 256 && BN <= 256, "a TMA box holds at most 256 rows");
  static_assert(kGroups % 8 == 0, "partials are summed 8 float4s at a time");
  static_assert(kProducerRegs >= 24 && kEntryRegs <= kWsConsumerRegs,
                "setmaxnreg's counts: 24 to 256, the producer's down, the consumers' up");
};

// A launch's schedule.  Tiles of BM x BN, row-major over tiles_n column
// tiles; tile t's kt k-tiles cut into s units (unit i: k-tiles [i·kt/s,
// (i+1)·kt/s)), its units t·s .. t·s + s - 1; the u = tiles·s units dealt to
// g <= u blocks in contiguous ranges [b·u/g, (b+1)·u/g), so that every block
// works an even share, within one unit, of the launch's k-tiles.  The cuts
// depend on the shape and the plan alone.
struct Sched {
  int tiles_n, kt, s, g, u;
  __host__ __device__ int start(int b) const { return (int)((long long)b * u / g); }
  // the block whose range holds unit v
  __host__ __device__ int block_of(int v) const { return (int)((((long long)v + 1) * g - 1) / u); }
};

// a block's run of units [u, ue) inside one tile: the tile, its corner and
// its k-tiles [kb, ke)
struct Seg {
  int tile, m0, n0, kb, ke;
  int tu, ue;                // the tile's first unit; the end of the run
};

template <int BM, int BN>
__host__ __device__ __forceinline__ Seg seg_at(const Sched& sc, int u, int u1) {
  Seg g;
  g.tile = u / sc.s;
  g.tu = g.tile * sc.s;
  g.ue = u1 < g.tu + sc.s ? u1 : g.tu + sc.s;
  g.kb = (u - g.tu) * sc.kt / sc.s;
  g.ke = (g.ue - g.tu) * sc.kt / sc.s;
  const int tm = g.tile / sc.tiles_n;
  g.m0 = tm * BM;
  g.n0 = (g.tile - tm * sc.tiles_n) * BN;
  return g;
}

// bar.red.or over a named barrier: synchronises `threads` threads and
// returns whether any of them passed true
__device__ __forceinline__ bool named_sync_or(int id, int threads, bool pred) {
  unsigned r;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, %3, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"((unsigned)pred), "r"(id), "r"(threads)
      : "memory");
  return r != 0;
}

__device__ __forceinline__ float4 f4add(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// A's fragments of chunk c (4 k-values) of a k-tile: rows r0 + 4i of the
// stage, chunk c of row r at 16-byte slot c ^ (r % 8) (r0 % 8 = ly, and
// r % 8 = ly ^ 4 for odd i)
template <int TM>
__device__ __forceinline__ void ws_a(float4 (&a)[TM], const float* sa, int c, int ly) {
  const int oa = (c ^ ly) << 2;
#pragma unroll
  for (int i = 0; i < TM; ++i)
    a[i] = *reinterpret_cast<const float4*>(sa + i * 4 * kWsBK + (i & 1 ? oa ^ 16 : oa));
}

// chunk c's FMAs: W rows lx + 8j (r % 8 = lx), each read once beside A's TM
// fragments, k in order within every output
template <int TM, int TN>
__device__ __forceinline__ void ws_fma(float (&acc)[TM][TN], const float4 (&a)[TM],
                                       const float* sw, int c, int lx) {
  const int ow = (c ^ lx) << 2;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const float4 b = *reinterpret_cast<const float4*>(sw + j * 8 * kWsBK + ow);
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
  }
}

// float4 group q of a lane's outputs: row i = q / (TN / 4), columns
// 4·(q % (TN / 4)) .. + 3 of its TN
template <int TM, int TN>
__device__ __forceinline__ float4 acc_group(const float (&acc)[TM][TN], int q) {
  const int i = q / (TN / 4), j = 4 * (q % (TN / 4));
  return make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
}
template <int TM, int TN>
__device__ __forceinline__ void set_group(float (&acc)[TM][TN], int q, const float4& v) {
  const int i = q / (TN / 4), j = 4 * (q % (TN / 4));
  acc[i][j] = v.x;
  acc[i][j + 1] = v.y;
  acc[i][j + 2] = v.z;
  acc[i][j + 3] = v.w;
}

// gemm_f32_ring_ws: the f32 GEMM C = epi(A · Wᵀ) above 128 rows (the
// decoder at batch > 1: 992 and 3,200 rows at 32 queries of 100 beams; 320
// rows in query generation).  It replaces no TPU kernel (the TPU's f32
// product is XLA's).  Bound: at these rows every product does >= 20 FMAs a
// byte it must move, so the 67 TFLOP/s of the FMA units bound it; f32 has
// no tensor-core path that keeps every product exact.  On the H100 it
// reaches 61-64% of that at 3,200 rows and 52% on 768 x 768 (its mainloop
// issues 93% FFMAs; the rest are stalls, kernels/f32_bench.py sweep).
// ptxas -v (sm_90a): 128 registers at entry (__maxnreg__), 0 bytes of
// spill, for both tiles.  Design:
// - Warp-specialised ring: one thread of a producer warpgroup keeps TMA
//   loads of A's and W's 32-float k-tiles (128-byte swizzle, rows past M or
//   N and k past K as zeros) in flight through a ring of `stages` slots on
//   full / empty mbarriers; consumer warps wait only on a slot's full
//   barrier and release it, warp by warp, on its empty barrier.  They issue
//   no copies, and the mainloop has no block barrier.  setmaxnreg moves the
//   producer warpgroup's registers to the consumers (it acts on whole
//   warpgroups: a lone producer warp that lowered its count hung the block).
// - A larger register tile: a lane holds 8 x TN outputs (TN = 12), rows
//   ly + 4i and columns lx + 8j of its warp's 32 x 8·TN (lane 8·ly + lx), so
//   a quarter warp reads one A address (a broadcast) and 8 W rows that the
//   swizzle puts on distinct banks: 8 + TN LDS.128 for 32·TN FMAs, A's
//   fragments of the next chunk loaded while this chunk's FMAs run.
// - Persistent, an even share of k-work on every block (Sched): a tile's
//   k-range may be cut across blocks.  A cut tile's partials are summed in k
//   order (block order) by its last arrival on the tile's counter, which
//   zeroes the counter again; a block that finds every other part already
//   in skips writing its own.  No block waits on another, and every call of
//   a plan gives the same bits, eager or replayed.  While the consumers
//   store one tile (round, ReLU or residual, on the full sum), the producer
//   already loads the next one's first k-tiles.
// ws: 2 f32 partials of BM x BN a block (its first run, its last), each in
// lane order (float4 q of consumer thread c at q·NC + c); counters: one int
// a tile, zero between launches.
template <int WM, int WN, int TN>
__global__ void __maxnreg__((WsRing<WM, WN, TN>::kEntryRegs))
gemm_f32_ring_ws(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                 const float* __restrict__ resid, float* __restrict__ C, float4* __restrict__ ws,
                 int* __restrict__ counters, int M, int N, int K, int splits, int stages,
                 int epi) {
  using R = WsRing<WM, WN, TN>;
  constexpr int TM = R::TM, NC = R::kConsumers, G4 = R::kGroups, BM = R::BM, BN = R::BN;
  extern __shared__ __align__(16) uint8_t ws_smem_raw[];
  uint8_t* smem = ws_smem_raw + ((1024 - (smem_u32(ws_smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * R::kStage);
  uint64_t* empty = full + kWsMaxStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_n = (N + BN - 1) / BN;
  const Sched sc{tiles_n, (K + kWsBK - 1) / kWsBK, splits, (int)gridDim.x,
                 (M + BM - 1) / BM * tiles_n * splits};
  const int u0 = sc.start(blockIdx.x), u1 = sc.start(blockIdx.x + 1);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], R::kWarps);             // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // ring slot s of round r: full[s] completes its phase r once both boxes
  // land (zero-filled bytes count too), empty[s] once every consumer warp
  // is done with them; ph = r & 1
  if (warp >= R::kWarps) {                         // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R::kProducerRegs));
    if (tid == NC) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&ta)) : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&tw)) : "memory");
      int s = 0, it = 0;
      unsigned ph = 0;
      for (int u = u0; u < u1;) {
        const Seg g = seg_at<BM, BN>(sc, u, u1);
        for (int kt = g.kb; kt < g.ke; ++kt, ++it) {
          if (it >= stages) mbar_wait(&empty[s], ph ^ 1);
          uint8_t* st = smem + s * R::kStage;
          mbar_expect_tx(&full[s], R::kStage);
          tma_load_2d(st, &ta, &full[s], kt * kWsBK, g.m0);
          tma_load_2d(st + BM * kWsBK * 4, &tw, &full[s], kt * kWsBK, g.n0);
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
        u = g.ue;
      }
    }
  } else {                                         // the consumer warps
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kWsConsumerRegs));
    const int wm = warp % WM, wn = warp / WM, ly = lane >> 3, lx = lane & 7;
    const int a_off = (wm * 32 + ly) * kWsBK, w_off = (BM + wn * 8 * TN + lx) * kWsBK;
    int s = 0;
    unsigned ph = 0;
    for (int u = u0; u < u1;) {
      const Seg g = seg_at<BM, BN>(sc, u, u1);
      const bool first_run = u == u0;
      u = g.ue;
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      for (int kt = g.kb; kt < g.ke; ++kt) {
        mbar_wait(&full[s], ph);
        const float* sa = reinterpret_cast<const float*>(smem + s * R::kStage) + a_off;
        const float* sw = reinterpret_cast<const float*>(smem + s * R::kStage) + w_off;
        float4 a0[TM], a1[TM];
        ws_a(a0, sa, 0, ly);
#pragma unroll 1
        for (int c = 0; c < 6; c += 2) {
          ws_a(a1, sa, c + 1, ly);
          ws_fma(acc, a0, sw, c, lx);
          ws_a(a0, sa, c + 2, ly);
          ws_fma(acc, a1, sw, c + 1, lx);
        }
        ws_a(a1, sa, 7, ly);
        ws_fma(acc, a0, sw, 6, lx);
        ws_fma(acc, a1, sw, 7, lx);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);     // this warp is done with the slot
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }

      if (g.kb != 0 || g.ke != sc.kt) {
        // a cut tile: blocks first .. last hold its runs in k order; block
        // b's run is its first (slot 0) unless b started before the tile
        const int first = sc.block_of(g.tu), last = sc.block_of(g.tu + sc.s - 1);
        const int me = blockIdx.x;
        auto part = [&](int b) {
          const int slot = b == first && sc.start(b) < g.tu ? 1 : 0;
          return ws + ((size_t)b * 2 + slot) * (NC * G4) + tid;
        };
        int* cnt = counters + g.tile;
        bool done = false;                         // every other run has arrived
        if (tid == 0) {
          int seen;
          asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(seen) : "l"(cnt) : "memory");
          done = seen == last - first;
        }
        bool is_last = named_sync_or(1, NC, done);
        if (!is_last) {
          float4* p = ws + ((size_t)me * 2 + (first_run ? 0 : 1)) * (NC * G4) + tid;
#pragma unroll
          for (int q = 0; q < G4; ++q) __stcg(p + q * NC, acc_group(acc, q));
          __threadfence();
          bool arrived_last = false;
          named_sync(1, NC);
          if (tid == 0) {
            arrived_last = atomicAdd(cnt, 1) == last - first;
            __threadfence();
          }
          is_last = named_sync_or(1, NC, arrived_last);
          if (!is_last) continue;
        }
        if (tid == 0) atomicExch(cnt, 0);          // zero again for the next launch
        __threadfence();
        // the sum in block order: the earlier runs' ordered sum (4 float4s of
        // a lane at a time, two runs' loads in flight) added to this run's,
        // then each later run's partial, half a lane's float4s at a time
        if (me > first) {
#pragma unroll
          for (int h = 0; h < G4 / 4; ++h) {
            float4 pre[4];
            for (int b = first; b < me; b += 2) {
              const float4* p = part(b) + h * 4 * NC;
              const float4* p2 = b + 1 < me ? part(b + 1) + h * 4 * NC : p;
              float4 v[4], v2[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                v[q] = __ldcg(p + q * NC);
                v2[q] = __ldcg(p2 + q * NC);
              }
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                pre[q] = b == first ? v[q] : f4add(pre[q], v[q]);
                if (b + 1 < me) pre[q] = f4add(pre[q], v2[q]);
              }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
              set_group(acc, h * 4 + q, f4add(acc_group(acc, h * 4 + q), pre[q]));
          }
        }
        for (int b = me + 1; b <= last; ++b) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4* p = part(b) + h * (G4 / 2) * NC;
            float4 v[G4 / 2];
#pragma unroll
            for (int q = 0; q < G4 / 2; ++q) v[q] = __ldcg(p + q * NC);
#pragma unroll
            for (int q = 0; q < G4 / 2; ++q)
              set_group(acc, h * (G4 / 2) + q, f4add(acc_group(acc, h * (G4 / 2) + q), v[q]));
          }
        }
      }

      // the epilogue on the full sum: a quarter warp stores 8 consecutive
      // columns of one row, a warp 4 rows, per instruction (staging the tile
      // in shared memory for float4 stores was slower at every shape)
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = g.m0 + wm * 32 + ly + 4 * i;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = g.n0 + wn * 8 * TN + lx + 8 * j;
          if (col < N) {
            const size_t idx = (size_t)row * N + col;
            float v = acc[i][j];
            if (epi == kRelu) v = fmaxf(v, 0.f);
            else if (epi == kResidual) v = resid[idx] + v;
            C[idx] = v;
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------- f32 GEMM, few rows

// k-tiles of 32 floats, one 128-byte swizzle row; 8 warps a block; clusters
// of at most 8 blocks (the portable size)
constexpr int kRowsBK = 32, kRowsThreads = 256, kRowsMaxM = 128, kRowsMaxCluster = 8,
              kRowsMaxStages = 8;

// M rows padded to the row extent mt of the tile: to 8 up to 64 rows, to 16
// above; the warps that stack the rows, WR = mt / 32 rounded up to 1, 2 or
// 4, each 4·TM of them (TM = mt / (4·WR) is 2, 4, 5, 6, 7 or 8)
__host__ __device__ __forceinline__ int rows_pad(int m) {
  return m <= 64 ? (m + 7) / 8 * 8 : (m + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int rows_wr(int mt) { return mt <= 32 ? 1 : (mt <= 64 ? 2 : 4); }

// shared memory of a block: the ring, or the warps' partials after it (the
// larger of the two); the slices the cluster's blocks send it; the ring's
// barriers; slack to align to 1,024
__host__ __device__ __forceinline__ int rows_smem(int mt, int bn, int stages) {
  const int ring = stages * (mt + bn) * kRowsBK * 4;
  const int part = 8 / rows_wr(mt) * mt * (bn + 8) * 4;
  return (ring > part ? ring : part) + (mt * bn + 4 * kRowsMaxCluster) * 4 + stages * 8 + 1024;
}

// gemm_f32_ring_rows: the f32 GEMM C = epi(A · Wᵀ) for M <= 128 rows (the
// decoder at one query a retrieve, 1 / 31 / 100 rows, and step 0 of a batch
// of 32).  It replaces no TPU kernel: at these rows the earlier tile ring's
// 32-row tiles and 16-32 splits spent 18-35 us on products bound at 0.7-7
// us, in launch and first loads, a last split that re-reads every partial
// alone, and FMAs on zero rows.  Below ~40 rows an f32 product is bound by W's bytes (67
// TFLOP/s over 3.35 TB/s: 20 FLOP a byte, 40 rows of f32 W), at 100 rows by
// the FMAs.  Design:
// - W streamed once: block b of a launch owns the strip of BN = 8·TN columns
//   b / nc (W's rows) and range b % nc of its k-tiles, and streams them by
//   TMA (128-byte swizzle) through a ring of `stages` slots on mbarriers,
//   every slot loaded ahead; A's tile of the same k-range rides along, all
//   mt rows in one box (rows past M arrive as zeros).  The nc blocks of a
//   strip form one thread-block cluster.  Strips of 48 or 64 columns let the
//   plan fill the SMs with one even wave.
// - A from L2, kept below W: a strip's nc blocks split K, so each reads
//   only its share of A; A's bytes over W's are then mt / BN.
// - Micro-tiles fitted to M: the 8 warps split a k-tile's 8 chunks of 4
//   k-values WK = 8 / WR ways and stack the rows WR ways; lane 8·ly + lx owns
//   rows ly + 4i (i < TM) and columns lx + 8j (j < TN) of its warp's 4·TM
//   rows, so a quarter warp reads one A address (a broadcast) and 8 W rows
//   that the swizzle puts on distinct banks: TM + TN LDS.128 for 4·TM·TN
//   FMAs, W's chunk read column by column beside the TM of A.
// - Split-K summed on chip in a fixed order: the warps' partials go to shared
//   memory; each block sums its WK of them in order and sends slice r of the
//   sum to block r of its cluster (distributed shared memory: its stores wait
//   on a cluster barrier that every block arrives at once it runs, before its
//   mainloop); after a second cluster barrier block r sums the slices it
//   holds rank by rank and applies the epilogue.  No workspace, no counters: every call of a plan
//   gives the same bits, eager or replayed.
// - Exact f32 FMAs, the sum in another order than the ring's.
template <int TM, int TN>
__global__ void __launch_bounds__(kRowsThreads, 2)
gemm_f32_ring_rows(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                   const float* __restrict__ resid, float* __restrict__ C, int M, int N, int K,
                   int mt, int stages, int epi) {
  // a partial's rows hold BN + 8 floats (8 or 24 banks past the row above):
  // a warp's stores of one (t, j), 4 rows x 8 columns, meet no bank twice
  constexpr int BN = 8 * TN, LDP = BN + 8, G4 = BN / 4;
  extern __shared__ __align__(16) uint8_t rows_smem_raw[];
  float* smem =
      reinterpret_cast<float*>(rows_smem_raw + ((1024 - (smem_u32(rows_smem_raw) & 1023)) & 1023));
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.x / nc * BN;
  const int WR = rows_wr(mt), WK = 8 / WR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, ly = lane >> 3, lx = lane & 7;
  const int wr = warp % WR, wk = warp / WR;
  const int kt_all = (K + kRowsBK - 1) / kRowsBK;
  const int kb = rank * kt_all / nc, nk = (rank + 1) * kt_all / nc - kb;
  const int slot_f = (mt + BN) * kRowsBK;          // floats of a ring slot: A's tile, W's
  const int ring_f = stages * slot_f, part_f = WK * mt * LDP;
  float4* recv = reinterpret_cast<float4*>(smem + (ring_f > part_f ? ring_f : part_f));
  uint64_t* full = reinterpret_cast<uint64_t*>(recv + mt * G4 + kRowsMaxCluster);

  // k-tile kt into slot s; full[s] completes its phase once both boxes land
  // (zero-filled bytes count too)
  const CUtensorMap *map_a = &ta, *map_w = &tw;
  auto issue = [=](int s, int kt) {
    float* a = smem + s * slot_f;
    mbar_expect_tx(&full[s], slot_f * 4);
    tma_load_2d(a, map_a, &full[s], kt * kRowsBK, 0);
    tma_load_2d(a + mt * kRowsBK, map_w, &full[s], kt * kRowsBK, n0);
  };
  if (tid == 0) {                                  // the ring's barriers, then its first loads
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map_a)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map_w)) : "memory");
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < stages && s < nk; ++s) issue(s, kb + s);
  }
  __syncthreads();
  // this block is running: the first half of the cluster barrier that each
  // block waits on before its first store into a peer's shared memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int r0 = wr * 4 * TM + ly;                 // the lane's first row
  const int cpw = 8 / WK, c0 = wk * cpw;           // the warp's chunks of a k-tile
  for (int i = 0; i < nk; ++i) {
    const int s = i % stages;
    if (i > 0) {
      __syncthreads();                             // every warp is done with k-tile i - 1
      if (tid == 0 && i - 1 + stages < nk) issue((i - 1) % stages, kb + i - 1 + stages);
    }
    mbar_wait(&full[s], (i / stages) & 1);
    const float* sa = smem + s * slot_f + r0 * kRowsBK;
    const float* sw = smem + s * slot_f + (mt + lx) * kRowsBK;
    // chunk c of row r sits at 16-byte slot c ^ (r % 8) of its 128-byte row;
    // the lane's rows r0 + 4t have r % 8 = r0 % 8 for even t, r0 % 8 ^ 4 for
    // odd t, and its W rows lx + 8j have lx
    for (int c = c0; c < c0 + cpw; ++c) {
      const int oa = (c ^ (r0 & 7)) << 2, ow = (c ^ lx) << 2;
      float4 a[TM];
#pragma unroll
      for (int t = 0; t < TM; ++t)
        a[t] = *reinterpret_cast<const float4*>(sa + 4 * t * kRowsBK + (t & 1 ? oa ^ 16 : oa));
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(sw + 8 * j * kRowsBK + ow);
#pragma unroll
        for (int t = 0; t < TM; ++t) acc[t][j] = fmaf(a[t].x, b.x, acc[t][j]);
#pragma unroll
        for (int t = 0; t < TM; ++t) acc[t][j] = fmaf(a[t].y, b.y, acc[t][j]);
#pragma unroll
        for (int t = 0; t < TM; ++t) acc[t][j] = fmaf(a[t].z, b.z, acc[t][j]);
#pragma unroll
        for (int t = 0; t < TM; ++t) acc[t][j] = fmaf(a[t].w, b.w, acc[t][j]);
      }
    }
  }

  // the warps' partials, [WK][mt][LDP] over the drained ring
  __syncthreads();
  float* part = smem;
  {
    float* p = part + (wk * mt + r0) * LDP + lx;
#pragma unroll
    for (int t = 0; t < TM; ++t)
#pragma unroll
      for (int j = 0; j < TN; ++j) p[4 * t * LDP + 8 * j] = acc[t][j];
  }
  __syncthreads();
  // every block of the cluster has started (their arrivals above), so their
  // shared memory may take stores
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  // this block's partial of the rows below M, the WK warps' sums in order,
  // float4 g of it to block g / per of the cluster, at recv[rank·per + g % per]
  const int groups = M * G4, per = (groups + nc - 1) / nc;
  for (int g = tid; g < groups; g += kRowsThreads) {
    const float* p = part + g / G4 * LDP + g % G4 * 4;
    float4 v = *reinterpret_cast<const float4*>(p);
    for (int q = 1; q < WK; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(p + q * mt * LDP);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int owner = g / per;
    *(cluster.map_shared_rank(recv, owner) + rank * per + (g - owner * per)) = v;
  }
  cluster.sync();                                  // every slice has arrived; no more remote stores
  // slice `rank`: the cluster's partials summed rank by rank, then the
  // epilogue (ReLU and the residual on the full sum)
  const int end = (rank + 1) * per < groups ? (rank + 1) * per : groups;
  for (int g = rank * per + tid; g < end; g += kRowsThreads) {
    const int j = g - rank * per;
    float4 v = recv[j];
    for (int q = 1; q < nc; ++q) {
      const float4 u = recv[q * per + j];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int row = g / G4, col = n0 + g % G4 * 4;
    if (col < N) {
      const size_t idx = (size_t)row * N + col;
      if (epi == kRelu) {
        v.x = fmaxf(v.x, 0.f);
        v.y = fmaxf(v.y, 0.f);
        v.z = fmaxf(v.z, 0.f);
        v.w = fmaxf(v.w, 0.f);
      } else if (epi == kResidual) {
        const float4 r = *reinterpret_cast<const float4*>(resid + idx);
        v.x += r.x;
        v.y += r.y;
        v.z += r.z;
        v.w += r.w;
      }
      *reinterpret_cast<float4*>(C + idx) = v;
    }
  }
}

// ------------------------------------------------------------- self-attention core

// One group of G = d_kv / Chunk<T>::n lanes per (row r, head h), one 16-byte
// chunk of the head a lane (G a power of two <= 32, so groups never straddle
// a warp); consecutive groups are consecutive heads of a row, so a warp
// reads contiguous cache bytes.  qkv: [R, 3·inner] (q | k | v, rounded);
// ck/cv: [L, R, inner], time-major; bias: [L, H] f32; attn: [R, inner].
// Each lane issues its loads of q, the fresh k/v and every cache row at
// positions < pos (LB >= L, unrolled) before any reduction; a score is a
// chunk dot reduced in log2(G) shuffles.  The fresh K/V row enters the
// scores from qkv, never from the stale cache row, and is written into
// ck/cv at pos in place.  In-place is safe: the caches are the tensors the
// beam reorder produced for this step, and each group reads and writes only
// its own (row, head) slice.
template <typename T, int LB>
__global__ void __launch_bounds__(128)
self_attn_core(const T* __restrict__ qkv, T* __restrict__ ck, T* __restrict__ cv,
               const float* __restrict__ bias, T* __restrict__ attn, int R, int H, int G,
               int pos) {
  constexpr int CH = Chunk<T>::n;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int gi = t / G, sub = t & (G - 1);
  if (gi >= R * H) return;                         // whole groups leave
  const unsigned lane = threadIdx.x & 31;
  const unsigned mask = (G == 32) ? 0xffffffffu : ((1u << G) - 1) << (lane & ~(G - 1));
  const int r = gi / H, h = gi - r * H;
  const int dkv = G * CH, inner = H * dkv;
  const T* qp = qkv + (size_t)r * 3 * inner + h * dkv + sub * CH;
  const size_t slice = (size_t)r * inner + h * dkv + sub * CH;   // within one position
  const size_t step = (size_t)R * inner;                         // one position

  const uint4 qc = ld16(qp), kc = ld16(qp + inner), vc = ld16(qp + 2 * inner);
  uint4 kr[LB], vr[LB];
#pragma unroll
  for (int l = 0; l < LB; ++l) {
    if (l < pos) {
      kr[l] = ld16(ck + l * step + slice);
      vr[l] = ld16(cv + l * step + slice);
    }
  }
  st16(ck + pos * step + slice, kc);
  st16(cv + pos * step + slice, vc);

  float q[CH];
  Chunk<T>::unpack(qc, q);
  float s[LB];
  float m = -INFINITY;
#pragma unroll
  for (int l = 0; l < LB; ++l) {
    if (l <= pos) {                                // causal: positions > pos get p = 0
      float k[CH];
      Chunk<T>::unpack(l == pos ? kc : kr[l], k);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < CH; ++e) part += q[e] * k[e];
      for (int o = G >> 1; o > 0; o >>= 1) part += __shfl_xor_sync(mask, part, o);
      s[l] = part + bias[l * H + h];               // T5: no 1/sqrt(d_kv)
      m = fmaxf(m, s[l]);
    }
  }
  float denom = 0.f;
#pragma unroll
  for (int l = 0; l < LB; ++l) {
    if (l <= pos) {
      s[l] = expf(s[l] - m);
      denom += s[l];
    }
  }
  float acc[CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) acc[e] = 0.f;
#pragma unroll
  for (int l = 0; l < LB; ++l) {
    if (l <= pos) {
      const float p = round_to<T>(s[l] / denom);   // probabilities in the model dtype
      float v[CH];
      Chunk<T>::unpack(l == pos ? vc : vr[l], v);
#pragma unroll
      for (int e = 0; e < CH; ++e) acc[e] += p * v[e];
    }
  }
  st16(attn + slice, Chunk<T>::pack(acc));         // rounds to T
}

// The same core for caches longer than the register path holds (L > 16):
// the same lane groups stream the cache in chunks of kSelfChunk positions
// (a chunk's loads all in flight before its reductions) and keep the
// group's f32 scores in shared memory, one per position <= pos (smem
// [128 / G groups][pos + 1]).  So the softmax is the plain version's, with
// no online rescaling: the max over all scores, Σ exp(s − max) (each lane
// a strided share, then log2(G) shuffles), then p = round_T(exp(s − max) /
// Σ) against the V rows, streamed the same way.  K and V are each read
// once; shared memory alone bounds L (kernels/decode.py::self_attn_max_len).
constexpr int kSelfChunk = 16;

template <typename T>
__global__ void __launch_bounds__(128)
self_attn_core_long(const T* __restrict__ qkv, T* __restrict__ ck, T* __restrict__ cv,
                    const float* __restrict__ bias, T* __restrict__ attn, int R, int H, int G,
                    int pos) {
  extern __shared__ float self_scores[];
  constexpr int CH = Chunk<T>::n, LB = kSelfChunk;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int gi = t / G, sub = t & (G - 1);
  if (gi >= R * H) return;                         // whole groups leave
  const unsigned lane = threadIdx.x & 31;
  const unsigned mask = (G == 32) ? 0xffffffffu : ((1u << G) - 1) << (lane & ~(G - 1));
  const int r = gi / H, h = gi - r * H;
  const int dkv = G * CH, inner = H * dkv;
  const T* qp = qkv + (size_t)r * 3 * inner + h * dkv + sub * CH;
  const size_t slice = (size_t)r * inner + h * dkv + sub * CH;
  const size_t step = (size_t)R * inner;
  float* s = self_scores + (threadIdx.x / G) * (pos + 1);

  const uint4 qc = ld16(qp), kc = ld16(qp + inner), vc = ld16(qp + 2 * inner);
  st16(ck + pos * step + slice, kc);               // only positions < pos are read
  st16(cv + pos * step + slice, vc);
  float q[CH];
  Chunk<T>::unpack(qc, q);

  float m = -INFINITY;
  for (int l0 = 0; l0 <= pos; l0 += LB) {
    uint4 kr[LB];
#pragma unroll
    for (int j = 0; j < LB; ++j)
      if (l0 + j < pos) kr[j] = ld16(ck + (l0 + j) * step + slice);
#pragma unroll
    for (int j = 0; j < LB; ++j) {
      const int l = l0 + j;
      if (l <= pos) {                              // the same l in every lane of the warp
        float k[CH];
        Chunk<T>::unpack(l == pos ? kc : kr[j], k);
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < CH; ++e) part += q[e] * k[e];
        for (int o = G >> 1; o > 0; o >>= 1) part += __shfl_xor_sync(mask, part, o);
        const float sl = part + bias[l * H + h];  // T5: no 1/sqrt(d_kv)
        if (sub == 0) s[l] = sl;
        m = fmaxf(m, sl);
      }
    }
  }
  __syncwarp(mask);                                // the group's scores are in smem

  float denom = 0.f;
  for (int l = sub; l <= pos; l += G) denom += expf(s[l] - m);
  for (int o = G >> 1; o > 0; o >>= 1) denom += __shfl_xor_sync(mask, denom, o);

  float acc[CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) acc[e] = 0.f;
  for (int l0 = 0; l0 <= pos; l0 += LB) {
    uint4 vr[LB];
#pragma unroll
    for (int j = 0; j < LB; ++j)
      if (l0 + j < pos) vr[j] = ld16(cv + (l0 + j) * step + slice);
#pragma unroll
    for (int j = 0; j < LB; ++j) {
      const int l = l0 + j;
      if (l <= pos) {
        const float p = round_to<T>(expf(s[l] - m) / denom);
        float v[CH];
        Chunk<T>::unpack(l == pos ? vc : vr[j], v);
#pragma unroll
        for (int e = 0; e < CH; ++e) acc[e] += p * v[e];
      }
    }
  }
  st16(attn + slice, Chunk<T>::pack(acc));
}

// ------------------------------------------------------------- cross-attention core

// bf16, on the tensor cores.  One block per (query b, head h): the query's
// encoder K and V [S, DKV] are copied once into shared memory in bf16
// (16-byte cp.async, all in flight at once; rows padded to 16 keys with
// zeros, row stride DKV + 8 so fragment reads meet no bank twice) with the
// bias row (−inf past S).  Warp w takes the 16-row tiles w, w + nw, ... of
// the query's K beam rows; q enters mma.sync fragments straight from
// global memory, the first tile's while the K/V copies are in flight.  Per
// tile, S = Q·Kᵀ + bias runs on mma.sync m16n8k16 over 48-key chunks, and
// three passes take the row max, then Σ exp(s − max), then
// P = round_bf16(exp(s − max) / Σ), fed from the score registers as the A
// operand of P·V (V fragments by ldmatrix.trans).  With one chunk (S <= 48,
// the main path's 40) the scores stay in registers across the passes;
// longer S recomputes them a chunk at a time (2·16·48·DKV flops, cheap), so
// the softmax is exactly the plain version's for any S that fits shared
// memory.  The core is latency-bound (a K/V copy, then dependent MMA and
// shuffle chains): at most 4 warps a block and <= 128 registers a thread
// keep 4 blocks, and so every (query, head) block of the main path, on the
// card at once.
// Key columns past S carry −inf and get probability exactly 0.
// q/out: [B·K, inner] (rows b·K … b·K+K-1 belong to query b);
// ck/cv: [B, H, S, DKV]; bias: [B, H, S] f32 (rel-bias row + −1e9 at pads).
constexpr int kKeyChunk = 48;   // 6 n-tiles of scores, 3 P·V k-steps

template <int DKV>
__global__ void __launch_bounds__(128, 4)
cross_attn_core_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ ck,
                     const __nv_bfloat16* __restrict__ cv, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int K, int H, int S) {
  constexpr int LD = DKV + 8, NKS = DKV / 16, NOT = DKV / 8, NT = kKeyChunk / 8;
  extern __shared__ __align__(16) uint8_t cross_smem[];
  const int sp = (S + 15) & ~15;                   // keys padded to the P·V k-step
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(cross_smem);
  __nv_bfloat16* vs = ks + sp * LD;
  float* bs = reinterpret_cast<float*>(vs + sp * LD);
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const size_t kv = ((size_t)b * H + h) * S * DKV;
  for (int i = threadIdx.x; i < sp * (DKV / 8); i += blockDim.x) {   // all in flight
    const int j = i / (DKV / 8), c = (i - j * (DKV / 8)) * 8;
    const size_t src = j < S ? kv + (size_t)j * DKV + c : kv;
    const int bytes = j < S ? 16 : 0;              // pad rows: zeros
    cp_async16(ks + j * LD + c, ck + src, bytes);
    cp_async16(vs + j * LD + c, cv + src, bytes);
  }
  const float* brow = bias + ((size_t)b * H + h) * S;
  for (int j = threadIdx.x; j < sp; j += blockDim.x) bs[j] = j < S ? brow[j] : -INFINITY;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int inner = H * DKV;
  // q of rows r, r+8 as A fragments of the k-steps, straight from global
  uint32_t qa[NKS][4];
  auto load_q = [&](int rt) {
    const int r0 = rt * 16 + g, r1 = r0 + 8;
    const __nv_bfloat16* q0 = q + ((size_t)b * K + r0) * inner + h * DKV + c2;
    const __nv_bfloat16* q1 = q0 + 8 * (size_t)inner;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
      qa[kk][0] = r0 < K ? *reinterpret_cast<const uint32_t*>(q0 + 16 * kk) : 0u;
      qa[kk][1] = r1 < K ? *reinterpret_cast<const uint32_t*>(q1 + 16 * kk) : 0u;
      qa[kk][2] = r0 < K ? *reinterpret_cast<const uint32_t*>(q0 + 16 * kk + 8) : 0u;
      qa[kk][3] = r1 < K ? *reinterpret_cast<const uint32_t*>(q1 + 16 * kk + 8) : 0u;
    }
  };
  load_q(warp);                                    // in flight with the K/V copies
  cp_async_wait_all();
  __syncthreads();

  for (int rt = warp; rt * 16 < K; rt += nw) {     // warp-uniform
    if (rt != warp) load_q(rt);
    const int r0 = rt * 16 + g, r1 = r0 + 8;
    // sc[nt]: rows g, g+8 × keys c0 + 8nt + c2, +1 of this chunk
    float sc[NT][4];
    auto scores = [&](int c0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j0 = c0 + 8 * nt;
        if (j0 < sp) {
          sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
          const __nv_bfloat16* kr = ks + (j0 + g) * LD + c2;
#pragma unroll
          for (int kk = 0; kk < NKS; ++kk)
            mma_16816(sc[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr + 16 * kk),
                      *reinterpret_cast<const uint32_t*>(kr + 16 * kk + 8));
          const float2 bb = *reinterpret_cast<const float2*>(bs + j0 + c2);
          sc[nt][0] += bb.x;
          sc[nt][1] += bb.y;
          sc[nt][2] += bb.x;
          sc[nt][3] += bb.y;
        } else {
          sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = -INFINITY;
        }
      }
    };
    float m0 = -INFINITY, m1 = -INFINITY;          // rows g and g+8
    for (int c0 = 0; c0 < sp; c0 += kKeyChunk) {
      scores(c0);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        m0 = fmaxf(m0, fmaxf(sc[nt][0], sc[nt][1]));
        m1 = fmaxf(m1, fmaxf(sc[nt][2], sc[nt][3]));
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {              // the 4 lanes of a row
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float d0 = 0.f, d1 = 0.f;
    for (int c0 = 0; c0 < sp; c0 += kKeyChunk) {
      if (sp > kKeyChunk) scores(c0);              // one chunk: still in sc
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        d0 += expf(sc[nt][0] - m0) + expf(sc[nt][1] - m0);
        d1 += expf(sc[nt][2] - m1) + expf(sc[nt][3] - m1);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      d0 += __shfl_xor_sync(0xffffffffu, d0, o);
      d1 += __shfl_xor_sync(0xffffffffu, d1, o);
    }
    float acc[NOT][4];
#pragma unroll
    for (int nt = 0; nt < NOT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    for (int c0 = 0; c0 < sp; c0 += kKeyChunk) {
      if (sp > kKeyChunk) scores(c0);
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {        // 16 keys a k-step
        if (c0 + 16 * kk >= sp) break;
        const int lo = 2 * kk, hi = 2 * kk + 1;
        const uint32_t pa[4] = {                   // probabilities rounded to bf16
            pack2(expf(sc[lo][0] - m0) / d0, expf(sc[lo][1] - m0) / d0),
            pack2(expf(sc[lo][2] - m1) / d1, expf(sc[lo][3] - m1) / d1),
            pack2(expf(sc[hi][0] - m0) / d0, expf(sc[hi][1] - m0) / d0),
            pack2(expf(sc[hi][2] - m1) / d1, expf(sc[hi][3] - m1) / d1)};
        const __nv_bfloat16* vrow = vs + (c0 + 16 * kk + (lane & 15)) * LD;
#pragma unroll
        for (int nt = 0; nt < NOT; ++nt) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, vrow + 8 * nt);
          mma_16816(acc[nt], pa, b0, b1);
        }
      }
    }
    __nv_bfloat16* o0 = out + ((size_t)b * K + r0) * inner + h * DKV + c2;
    __nv_bfloat16* o1 = o0 + 8 * (size_t)inner;
#pragma unroll
    for (int nt = 0; nt < NOT; ++nt) {             // the attention output, rounded
      if (r0 < K) *reinterpret_cast<uint32_t*>(o0 + 8 * nt) = pack2(acc[nt][0], acc[nt][1]);
      if (r1 < K) *reinterpret_cast<uint32_t*>(o1 + 8 * nt) = pack2(acc[nt][2], acc[nt][3]);
    }
  }
}

// f32, on the FMA units, with the plain version's math and order: s = q·k +
// bias (the bias added after the dot), the f32 max over all S keys, e =
// exp(s − max), p = e / Σe, o = Σ p·v.  The scores of all S keys sit in
// shared memory, so the softmax needs no online rescaling.  Two kernels, by
// the number of beams a query has.
//
// Few beams (query generation: each row its own query): a row's K and V are
// read once, so they are streamed, not staged.  One 128-thread block per
// (row, head); a group of G = DKV / 4 lanes reads a key's row in 16-byte
// chunks (one a lane) and reduces the dot in log2(G) shuffles.  The block's
// 128 / G groups split the keys, kStreamKeys a group in flight with their
// bias (K and V rows both, when S fits one pass; keys past S read as zeros,
// so the shuffle chains need no branch), write the scores to shared memory,
// and every warp takes the max and Σ over all of them; each group then sums
// p·v over its keys and the groups' partial rows are summed in group order.
constexpr int kStreamKeys = 4;
constexpr int kStreamBeams = 4;                    // fewer beams a query: streamed

template <int DKV>
__global__ void __launch_bounds__(128)
cross_attn_stream_f32(const float* __restrict__ q, const float* __restrict__ ck,
                      const float* __restrict__ cv, const float* __restrict__ bias,
                      float* __restrict__ out, int K, int H, int S) {
  constexpr int G = DKV / 4, NG = 128 / G, KS = kStreamKeys, PASS = NG * KS;
  extern __shared__ __align__(16) float stream_smem[];
  float4* red = reinterpret_cast<float4*>(stream_smem);     // [NG][G] partial rows
  float* sc = stream_smem + 4 * 128;                         // [S] scores
  const int row = blockIdx.x / H, h = blockIdx.x - row * H, b = row / K;
  const int tid = threadIdx.x, grp = tid / G, sub = tid & (G - 1), lane = tid & 31;
  const size_t head = (size_t)row * H * DKV + h * DKV;
  const size_t kv = ((size_t)b * H + h) * S;                 // the query's key rows
  const float4 qv = reinterpret_cast<const float4*>(q + head)[sub];
  const float4* kp = reinterpret_cast<const float4*>(ck + kv * DKV) + sub;
  const float4* vp = reinterpret_cast<const float4*>(cv + kv * DKV) + sub;
  const float* bb = bias + kv;
  const bool one_pass = S <= PASS;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 vr[KS];
  for (int p0 = 0; p0 < S; p0 += PASS) {
    float4 kr[KS];
    float bv[KS];
#pragma unroll
    for (int i = 0; i < KS; ++i) {                 // every load in flight first
      const int j = p0 + grp + NG * i;
      const bool in = j < S;                       // keys past S: zeros, never stored
      kr[i] = in ? kp[(size_t)j * G] : zero;
      bv[i] = in ? bb[j] : 0.f;
      if (one_pass) vr[i] = in ? vp[(size_t)j * G] : zero;
    }
#pragma unroll
    for (int i = 0; i < KS; ++i) {                 // KS independent shuffle chains
      float d = qv.x * kr[i].x;
      d = fmaf(qv.y, kr[i].y, d);
      d = fmaf(qv.z, kr[i].z, d);
      d = fmaf(qv.w, kr[i].w, d);
#pragma unroll
      for (int o = G >> 1; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      const int j = p0 + grp + NG * i;
      if (sub == 0 && j < S) sc[j] = d + bv[i];    // T5: no 1/sqrt(d_kv)
    }
  }
  __syncthreads();
  float m = -INFINITY;
  for (int j = lane; j < S; j += 32) m = fmaxf(m, sc[j]);
  m = warp_max(m);
  float den = 0.f;
  for (int j = lane; j < S; j += 32) den += expf(sc[j] - m);
  den = warp_sum(den);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p0 = 0; p0 < S; p0 += PASS) {
    if (!one_pass) {
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        const int j = p0 + grp + NG * i;
        vr[i] = j < S ? vp[(size_t)j * G] : zero;
      }
    }
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int j = p0 + grp + NG * i;
      if (j < S) {
        const float p = expf(sc[j] - m) / den;
        acc.x = fmaf(p, vr[i].x, acc.x);
        acc.y = fmaf(p, vr[i].y, acc.y);
        acc.z = fmaf(p, vr[i].z, acc.z);
        acc.w = fmaf(p, vr[i].w, acc.w);
      }
    }
  }
  red[grp * G + sub] = acc;
  __syncthreads();
  if (tid < G) {
    float4 o = red[tid];
    for (int g = 1; g < NG; ++g) {
      const float4 v = red[g * G + tid];
      o.x += v.x;
      o.y += v.y;
      o.z += v.z;
      o.w += v.w;
    }
    reinterpret_cast<float4*>(out + head)[tid] = o;
  }
}

// Many beams (the main path: 100 a query): one 128-thread block per (query,
// head, tile of up to kBeamTile beams).  It stages the tile's q rows and
// its query's K and V, kKeyTile keys at a time, in shared memory with
// 16-byte cp.async copies (rows padded to DKV + 4 floats, an odd number of
// 16-byte slots; the first K and V tiles in flight together; past
// kKeyTile keys, K and then V are streamed through their buffers).  Q·Kᵀ is
// register-tiled: thread (kx, by) = (tid % 16, tid / 16) takes beams by + 8r
// and keys kx + 16i (r, i < 4), 16 FMAs per pair of float4 reads (a quarter
// warp's q reads are one broadcast address, its K reads 8 consecutive
// rows).  The scores of all keys go to shared memory [kBeamTile][sp + 4]
// (sp: S padded to kKeyTile); 4 lanes a beam row take its softmax and write
// p back.  P·V:
// thread (dx, bz) = (tid % (DKV / 4), tid / (DKV / 4)) takes a float4 of d
// and every (128 / (DKV / 4))-th beam, reading 4 p and 4 V rows a step.
constexpr int kBeamTile = 32, kKeyTile = 64;

template <int DKV>
__global__ void __launch_bounds__(128)
cross_attn_tiled_f32(const float* __restrict__ q, const float* __restrict__ ck,
                     const float* __restrict__ cv, const float* __restrict__ bias,
                     float* __restrict__ out, int K, int H, int S) {
  constexpr int BT = kBeamTile, KT = kKeyTile, LD = DKV + 4, C4 = DKV / 4;
  constexpr int BZ = 128 / C4, TB = BT / BZ;       // P·V: beam groups, beams a thread
  static_assert(BT * 4 == 128, "the softmax takes 4 lanes a beam row");
  extern __shared__ __align__(16) float tiled_smem[];
  const int sp = (S + KT - 1) / KT * KT, lp = sp + 4;
  float* qs = tiled_smem;                          // [BT][LD]
  float* ks = qs + BT * LD;                        // [KT][LD]
  float* vs = ks + KT * LD;                        // [KT][LD]
  float* ps = vs + KT * LD;                        // [BT][lp] scores, then p
  const int tiles = (K + BT - 1) / BT;
  const int bh = blockIdx.x / tiles, t = blockIdx.x - bh * tiles;
  const int b = bh / H, h = bh - b * H;
  const int k0 = t * BT, nb = min(BT, K - k0);
  const int inner = H * DKV, tid = threadIdx.x;
  const size_t kv = (size_t)bh * S;                // the query's key rows
  const float* bb = bias + kv;

  for (int c = tid; c < BT * C4; c += 128) {      // the tile's q rows, zeros past nb
    const int r = c / C4, e = (c - r * C4) * 4;
    const bool ok = r < nb;
    cp_async16(qs + r * LD + e, ok ? q + (size_t)(b * K + k0 + r) * inner + h * DKV + e : q,
               ok ? 16 : 0);
  }
  // keys j0 .. j0 + KT - 1 of K or V into buf, zeros past S
  auto stage = [&](float* buf, const float* src, int j0) {
    for (int c = tid; c < KT * C4; c += 128) {
      const int j = c / C4, e = (c - j * C4) * 4;
      const bool ok = j0 + j < S;
      cp_async16(buf + j * LD + e, ok ? src + (kv + j0 + j) * DKV + e : src, ok ? 16 : 0);
    }
  };
  stage(ks, ck, 0);
  cp_async_commit();                               // q and the first K tile
  stage(vs, cv, 0);
  cp_async_commit();                               // the first V tile

  const int kx = tid & 15, by = tid >> 4;
  for (int j0 = 0; j0 < S; j0 += KT) {
    if (j0 == 0) {
      cp_async_wait<1>();
    } else {
      __syncthreads();                             // done with the last K tile
      stage(ks, ck, j0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[r][i] = 0.f;
#pragma unroll 4
    for (int e = 0; e < DKV; e += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = *reinterpret_cast<const float4*>(qs + (by + 8 * r) * LD + e);
#pragma unroll
      for (int i = 0; i < 4; ++i) kb[i] = *reinterpret_cast<const float4*>(ks + (kx + 16 * i) * LD + e);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[r][i] = fmaf(qa[r].x, kb[i].x, sc[r][i]);
          sc[r][i] = fmaf(qa[r].y, kb[i].y, sc[r][i]);
          sc[r][i] = fmaf(qa[r].z, kb[i].z, sc[r][i]);
          sc[r][i] = fmaf(qa[r].w, kb[i].w, sc[r][i]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + kx + 16 * i;
      const float bj = j < S ? bb[j] : 0.f;       // keys past S are never read
#pragma unroll
      for (int r = 0; r < 4; ++r) ps[(by + 8 * r) * lp + j] = sc[r][i] + bj;
    }
  }
  __syncthreads();
  {                                                // softmax: 4 lanes a beam row
    const int q4 = tid & 3;
    float* pr = ps + (tid >> 2) * lp;              // rows past nb hold finite scores too
    float m = -INFINITY;
    for (int j = q4; j < S; j += 4) m = fmaxf(m, pr[j]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float den = 0.f;
    for (int j = q4; j < S; j += 4) den += expf(pr[j] - m);
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    for (int j = q4; j < sp; j += 4) pr[j] = j < S ? expf(pr[j] - m) / den : 0.f;
  }

  const int dx = tid % C4, bz = tid / C4;
  float4 o[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) o[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < S; j0 += KT) {
    if (j0 > 0) {
      __syncthreads();                             // done with the last V tile
      stage(vs, cv, j0);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();                               // the V tile and every p are in
    const int n = min(KT, S - j0);
    for (int j = 0; j < n; j += 4) {               // past S: p = 0 and V rows of zeros
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = *reinterpret_cast<const float4*>(vs + (j + u) * LD + 4 * dx);
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(ps + (bz + BZ * r) * lp + j0 + j);
        const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          o[r].x = fmaf(pj[u], v[u].x, o[r].x);
          o[r].y = fmaf(pj[u], v[u].y, o[r].y);
          o[r].z = fmaf(pj[u], v[u].z, o[r].z);
          o[r].w = fmaf(pj[u], v[u].w, o[r].w);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    const int beam = bz + BZ * r;
    if (beam < nb)
      *reinterpret_cast<float4*>(out + (size_t)(b * K + k0 + beam) * inner + h * DKV + 4 * dx) =
          o[r];
  }
}

// ------------------------------------------------------------- launchers

// cuTensorMapEncodeTiled from the driver, fetched once through the runtime
// (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the [rows, cols] bf16 (or f32) row-major matrix at ptr, read in boxes of
// box_rows x 64 bf16 (32 f32), one 128-byte row each, with the 128-byte
// swizzle
static bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                       bool f32 = false) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)(f32 ? kRowsBK : BK), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Tile {
  int wg, bn, stages;   // 64·wg rows x bn columns, a ring of `stages` tiles
};

// every instantiated tile, largest first.  128×160 makes 125 tiles of
// N = 768 at 3,200 rows (one wave), 64×96 128 of them at 992; the narrow
// tiles of small row counts keep rings of 6-8 to hide the load latency.
// (128×256 fits only 3 stages beside its staged C tile and spilled at the
// 168 registers a thread of two consumer warpgroups gets; 128×160 was as
// fast on every main-path shape.)
#define GDR_GEMM_TILES(X)                                                                \
  X(2, 192, 4) X(2, 160, 4) X(2, 128, 4) X(2, 64, 4) X(1, 128, 4) X(1, 96, 6) X(1, 64, 6) \
  X(1, 32, 8) X(1, 16, 8) X(1, 8, 8)

#define GDR_TILE_ENTRY(wg, bn, st) {wg, bn, st},
static const Tile kTiles[] = {GDR_GEMM_TILES(GDR_TILE_ENTRY)};
#undef GDR_TILE_ENTRY

// The GEMM's kernels: the bf16 tile kernel (gemm_wgmma), the f32 small-row
// kernel (gemm_f32_ring_rows) and the f32 warp-specialised ring
// (gemm_f32_ring_ws).
enum Kernel { kWgmma = 0, kF32Rows = 1, kF32Ws = 2 };

// a launch: the kernel, its tile, the tile's k-tiles split `splits` ways,
// units = tiles · splits work units walked by `blocks` persistent blocks.
// kF32Rows: tile.wg = its row extent / 8, tile.bn its strip, a ring of
// tile.stages, `splits` blocks a cluster, one block a unit; kF32Ws: tiles of
// 32·wg rows whose 32-float k-tiles are cut into `splits` units, dealt to
// `blocks` blocks.
struct Plan {
  Tile tile;
  int splits, units, blocks;
  int kernel = kWgmma;
};

constexpr int kSplitTiles = 1024;   // output tiles a split launch may count on
constexpr int kSplitRounds = 4;     // splits only while units <= 4 · SMs

// The cost model's constants, fitted to tools/gemm_plan_sweep.py on the
// H100: the tensor-core FLOP/s one SM sustains in this mainloop (70% of
// its share of 989 TFLOP/s), the operand bytes/s one SM pulls from L2, a
// TMA load's round trip, the rate at which a block writes and reads split
// partials, and a split's fence and arrival.
constexpr double kOpsPerSm = 0.7 * 989e12 / 132, kL2PerSm = 120e9, kLatency = 1.0e-6,
                 kPartPerSm = 10e9, kSplitSync = 0.5e-6;

// Modelled time of a plan: the slowest block's units.  A k-tile costs the
// largest of its tensor-core work, its operand bytes (rows past M arrive as
// TMA zeros and cost none) and the ring's latency share; a unit adds its
// epilogue's bytes or, when split, its partial's write and the arrival, and
// the tile's last split reads every partial.
static double plan_time(const Tile& t, int splits, int m, int n, int k, int sms) {
  const int bm = 64 * t.wg, rows = m < bm ? m : bm;
  const int parted = (rows + 15) / 16 * 16;        // rows of the live warps
  const int tiles = (m + bm - 1) / bm * ((n + t.bn - 1) / t.bn), kt = (k + BK - 1) / BK;
  const int units = tiles * splits, blocks = units < sms ? units : sms;
  const double ops = 2.0 * bm * t.bn * BK / kOpsPerSm;
  const double bytes = 2.0 * (rows + t.bn) * BK / kL2PerSm;
  double t_kt = ops > bytes ? ops : bytes;
  if (kLatency / t.stages > t_kt) t_kt = kLatency / t.stages;
  const double out = 4.0 * rows * t.bn / kL2PerSm;     // bf16 written, residual read
  if (splits == 1) return kLatency + (units + blocks - 1) / blocks * (kt * t_kt + out);
  const double part = 4.0 * parted * t.bn / kPartPerSm;
  double worst = 0;
  for (int b = 0; b < blocks; ++b) {
    double time = kLatency;
    for (int u = b; u < units; u += blocks) {
      const int s = u % splits;
      time += ((s + 1) * kt / splits - s * kt / splits) * t_kt + part + kSplitSync;
      if (s == splits - 1) time += splits * part + out;
    }
    if (time > worst) worst = time;
  }
  return worst;
}

// the plan with the least modelled time; ties go to the larger tile and
// then to fewer splits
static Plan choose_plan(int m, int n, int k, int sms) {
  const int kt = (k + BK - 1) / BK;
  Plan best{kTiles[0], 1, 0, 0};
  double best_t = 1e30;
  for (const Tile& t : kTiles) {
    const int bm = 64 * t.wg;
    const int tiles = (m + bm - 1) / bm * ((n + t.bn - 1) / t.bn);
    for (int splits = 1; splits <= kt && splits <= kMaxSplits; ++splits) {
      if (splits > 1 && (tiles > kSplitTiles || tiles * splits > kSplitRounds * sms)) break;
      const double time = plan_time(t, splits, m, n, k, sms);
      if (time < best_t * (1 - 1e-9)) {
        best_t = time;
        best = {t, splits, tiles * splits, tiles * splits < sms ? tiles * splits : sms};
      }
    }
  }
  return best;
}

// The small-row kernel's strips and clusters a plan may take (its row extent
// follows M: rows_pad), and its ring: the model sees no depth, and 4 stages
// were as fast as 2 or 8 at every shape of the sweep (kernels/f32_bench.py
// sweep still runs 2 and 8 as forced plans).
static const int kRowsBn[] = {48, 64};
static const int kRowsClusters[] = {1, 2, 3, 4, 6, 8};
constexpr int kRowsStages = 4;
constexpr int kSmemOptin = 232448;      // shared memory a Hopper block may opt into

// The small-row kernel's cost model, fitted by kernels/f32_bench.py sweep on
// the H100 to every plan of M 1-128 x the four (N, K) of a t5-base decoder
// layer within 1.5x of its shape's best: the FMAs/s one SM sustains in this
// mainloop (47% of its share of 67 TFLOP/s), the launch with its first loads
// and the cluster's syncs, the bytes/s one block pulls of W and of A through
// its ring, and the rate at which a block writes, sums and sends its
// partials.  The sweep fits these five through gdr_gemm_rows_time.
struct RowsModel {
  double fma_per_sm, latency, w_per_block, a_per_block, part_per_sm;
};
constexpr RowsModel kRowsModel = {0.473 * 67e12 / 2 / 132, 3.72e-6, 15.6e9, 16.8e9, 140e9};

// registers a thread holds (ptxas, the H100 build: 72-96 up to TM 4, 96-128
// above)
static int rows_regs(int tm) { return tm >= 5 ? 128 : 80; }

// blocks of a plan an SM holds at once: registers, shared memory, threads
static int rows_resident(int mt, int bn, int stages) {
  int b = 65536 / (kRowsThreads * rows_regs(mt / (4 * rows_wr(mt))));
  const int smem = rows_smem(mt, bn, stages) + 1024;   // + the block's reserved 1 KB
  if (233472 / smem < b) b = 233472 / smem;
  if (2048 / kRowsThreads < b) b = 2048 / kRowsThreads;
  return b < 1 ? 1 : b;
}

// The blocks of clusters of cl that one wave places one an SM.  A cluster
// runs inside one GPC.  The SMs of the H100 of the sweep sit in GPCs of 18,
// 18, 18, 18, 16, 16, 14 and 14, inferred from the sweep (its clusters of 4
// and 8 blocks ran a second round past 120 and 112 blocks): the plans are
// tuned to that die.  A 132-SM card floor-swept to another layout runs the
// same plans, at another speed, with the same results.
static const int kGpcSms[] = {18, 18, 18, 18, 16, 16, 14, 14};
static int rows_cluster_cap(int cl, int sms) {
  if (sms != 132) return sms / cl * cl;
  int cap = 0;
  for (const int g : kGpcSms) cap += g / cl * cl;
  return cap;
}

// Modelled time of a small-row plan at M rows: strips of bn columns, each
// split over a cluster of cl blocks, a ring of st slots.  The busiest SM
// holds `stack` blocks at once (more where the clusters outnumber its share
// of a wave), in `rounds` where they outnumber its residency; its blocks
// cost the larger of their FMAs, their k-tiles' pulls of W and A, and the
// card's stream of W at 3.35 TB/s, plus their partials.
static double plan_time_rows(const RowsModel& c, int mt, int bn, int cl, int st, int m, int n,
                             int k, int sms) {
  const int blocks = (n + bn - 1) / bn * cl;
  const int kt = (k + kRowsBK - 1) / kRowsBK, kb = (kt + cl - 1) / cl;
  const int res = rows_resident(mt, bn, st), cap = rows_cluster_cap(cl, sms);
  int stack = (blocks + cap - 1) / cap;
  const int rounds = (stack + res - 1) / res;
  if (stack > res) stack = res;
  const double per = (double)rounds * stack * kb;        // k-tiles the busiest SM works
  double t = per * mt * bn * kRowsBK / c.fma_per_sm;
  const double pulls = per * kRowsBK * 4 * (bn / c.w_per_block + mt / c.a_per_block);
  const double card = 4.0 * n * k / 3.35e12;
  if (pulls > t) t = pulls;
  if (card > t) t = card;
  const double part = (double)rounds * stack * m * bn * 4 * (2.0 * 8 / rows_wr(mt) + 2) /
                      c.part_per_sm;
  return c.latency + t + part;
}

// whether the small-row kernel runs a plan of a bn strip, cl blocks a
// cluster and st stages at M rows and K
static bool rows_plan_ok(int m, int k, int bn, int cl, int st) {
  return m >= 1 && m <= kRowsMaxM && (bn == 48 || bn == 64) && cl >= 1 &&
         cl <= kRowsMaxCluster && cl <= (k + kRowsBK - 1) / kRowsBK && st >= 1 &&
         st <= kRowsMaxStages && rows_smem(rows_pad(m), bn, st) <= kSmemOptin;
}

// the small-row plan with the least modelled time at M <= 128 rows; ties go
// to the first strip and cluster in the lists above
static Plan choose_plan_rows(int m, int n, int k, int sms) {
  const int mt = rows_pad(m);
  Plan best{{0, 0, 0}, 1, 0, 0, kF32Rows};
  double best_t = 1e30;
  for (const int bn : kRowsBn)
    for (const int cl : kRowsClusters) {
      if (!rows_plan_ok(m, k, bn, cl, kRowsStages)) continue;
      const double time = plan_time_rows(kRowsModel, mt, bn, cl, kRowsStages, m, n, k, sms);
      if (time < best_t * (1 - 1e-9)) {
        best_t = time;
        const int units = (n + bn - 1) / bn * cl;
        best = {{mt / 8, bn, kRowsStages}, cl, units, units, kF32Rows};
      }
    }
  return best;
}

// The ring's instantiations (WM, WN, TN): tiles of 128 x 96 and 64 x 192, 4
// consumer warps of 8 x 12 outputs a lane.  (8 x 16 a lane, in tiles of 128
// x 128, 64 x 256, and 256 x 128 or 128 x 256 of 8 consumer warps at one
// block an SM, spilled and was slower at every shape of the sweep,
// kernels/f32_bench.py sweep.)
#define GDR_WS_TILES(X) X(4, 1, 12) X(2, 2, 12)

struct WsShape {
  int bm, bn;
};
#define GDR_WS_ENTRY(wm, wn, tn) {WsRing<wm, wn, tn>::BM, WsRing<wm, wn, tn>::BN},
static const WsShape kWsTiles[] = {GDR_WS_TILES(GDR_WS_ENTRY)};
#undef GDR_WS_ENTRY

// shared memory of a ring block: the stages, the barriers, slack to align
// to 1,024
static int ws_smem(int bm, int bn, int stages) {
  return stages * (bm + bn) * kWsBK * 4 + 2 * kWsMaxStages * 8 + 1024;
}

// the deepest ring (at most 4 stages) that lets two blocks share an SM
static int ws_stages(const WsShape& t) {
  int st = 4;
  while (st > 1 && 2 * (ws_smem(t.bm, t.bn, st) + 1024) > 233472) --st;
  return st;
}

// The ring's cost model, fitted by kernels/f32_bench.py sweep on the H100
// to every plan of M 129 / 320 / 992 / 997 / 3,200 x the four (N, K) of a
// t5-base decoder layer within 1.5x of its shape's best: the FMAs/s one SM
// sustains with two blocks (67% of its share of 67 TFLOP/s), the share of
// that one block reaches alone, the bytes/s at which an SM writes or reads a
// partial, and the launch with its first loads and the last tile's fix-up.
// (A tile's store fitted to no cost: the SM's other block hides it.)  The
// sweep fits these four through gdr_gemm_ws_time.
struct WsModel {
  double fma_per_sm, lone, part_per_sm, latency;
};
constexpr WsModel kWsModel = {0.673 * 67e12 / 2 / 132, 0.892, 61.8e9, 12.4e-6};

// Modelled time of a ring plan: the busiest SM's blocks (block b on SM
// b % sms; the two blocks an SM holds share its FMA rate).  A block's
// runs cost their k-tiles; a cut tile's runs each write a partial, except
// the tile's first block, which arrives last (its run there is its last)
// and reads the others'.
static double plan_time_ws(const WsModel& c, const WsShape& t, int s, int g, int m, int n,
                           int k, int sms) {
  const int tiles_n = (n + t.bn - 1) / t.bn;
  Sched sc{tiles_n, (k + kWsBK - 1) / kWsBK, s, g, (m + t.bm - 1) / t.bm * tiles_n * s};
  if (sc.g > sc.u) sc.g = sc.u;
  const double rate = c.fma_per_sm * (sc.g > sms ? 1.0 : c.lone);
  const double t_kt = (double)t.bm * t.bn * kWsBK / rate;
  const double part = 4.0 * t.bm * t.bn / c.part_per_sm;
  std::vector<double> sm(sms, 0.0);
  for (int b = 0; b < sc.g; ++b) {
    const int u1 = sc.start(b + 1);
    double time = 0;
    for (int u = sc.start(b); u < u1;) {
      const Seg r = seg_at<1, 1>(sc, u, u1);
      time += (r.ke - r.kb) * t_kt;
      if (r.kb != 0 || r.ke != sc.kt)
        time += (sc.block_of(r.tu) == b ? sc.block_of(r.tu + s - 1) - b : 1) * part;
      u = r.ue;
    }
    sm[b % sms] += time;
  }
  double worst = 0;
  for (const double x : sm) worst = x > worst ? x : worst;
  return c.latency + worst;
}

// the ring plans the chooser weighs at M, N, K: both tiles, each tile's
// k-tiles cut into s units (s = 1, a few, or one a k-tile; s > 1 only while
// the tiles fit the arrival counters), dealt to one or two blocks an SM
template <typename F>
static void ws_plans(int m, int n, int k, int sms, F&& visit) {
  const int kt = (k + kWsBK - 1) / kWsBK;
  static const int kCuts[] = {1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96};
  int cuts[16], nc = 0;
  for (const int s : kCuts)
    if (s < kt) cuts[nc++] = s;
  cuts[nc++] = kt;
  for (const WsShape& t : kWsTiles) {
    const long long tiles = (long long)((m + t.bm - 1) / t.bm) * ((n + t.bn - 1) / t.bn);
    for (int i = 0; i < nc; ++i) {
      const int s = cuts[i];
      if (s > 1 && tiles > kSplitTiles) continue;
      for (int per = 1; per <= 2; ++per) {
        const long long units = tiles * s;
        const int g = units < (long long)sms * per ? (int)units : sms * per;
        if (per > 1 && g <= sms * (per - 1)) continue;   // as few blocks as the last
        visit(t, s, g);
      }
    }
  }
}

// the plan with the least modelled time: the small-row kernel's up to 128
// rows, the warp-specialised ring's above, each by its own model; ties go to
// the first tile, cut and block count
static Plan choose_plan_f32(int m, int n, int k, int sms) {
  if (m <= kRowsMaxM) return choose_plan_rows(m, n, k, sms);
  Plan best{{0, 0, 0}, 1, 0, 0, kF32Ws};
  double best_t = 1e30;
  ws_plans(m, n, k, sms, [&](const WsShape& t, int s, int g) {
    const double time = plan_time_ws(kWsModel, t, s, g, m, n, k, sms);
    if (time < best_t * (1 - 1e-9)) {
      best_t = time;
      const int units = (m + t.bm - 1) / t.bm * ((n + t.bn - 1) / t.bn) * s;
      best = {{t.bm / 32, t.bn, ws_stages(t)}, s, units, g, kF32Ws};
    }
  });
  return best;
}

template <int WG, int BN, int ST, int EPI>
static cudaError_t launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tw,
                                const void* resid, void* c, void* ws, int* counters, int m,
                                int n, int k, int splits, int blocks, cudaStream_t s) {
  using S = GemmShape<WG, BN, ST>;
  auto kernel = gemm_wgmma<WG, BN, ST, EPI>;
  // the opt-in to more than 48 KB of shared memory, once per device
  static unsigned opted = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(opted & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return e;
    opted |= bit;
  }
  kernel<<<blocks, S::kThreads, S::kSmem, s>>>(
      ta, tw, static_cast<const __nv_bfloat16*>(resid), static_cast<__nv_bfloat16*>(c),
      static_cast<float4*>(ws), counters, m, n, k, splits);
  return cudaGetLastError();
}

template <int WG, int BN, int ST>
static cudaError_t launch_epi(int epi, const CUtensorMap& ta, const CUtensorMap& tw,
                              const void* resid, void* c, void* ws, int* counters, int m,
                              int n, int k, int splits, int blocks, cudaStream_t s) {
  if (epi == kRound)
    return launch_wgmma<WG, BN, ST, kRound>(ta, tw, resid, c, ws, counters, m, n, k, splits,
                                            blocks, s);
  if (epi == kRelu)
    return launch_wgmma<WG, BN, ST, kRelu>(ta, tw, resid, c, ws, counters, m, n, k, splits,
                                           blocks, s);
  return launch_wgmma<WG, BN, ST, kResidual>(ta, tw, resid, c, ws, counters, m, n, k, splits,
                                             blocks, s);
}

static cudaError_t gemm_bf16(const void* a, const void* w, const void* resid, void* c, int m,
                             int n, int k, int epi, const Plan& p, void* ws, int* counters,
                             cudaStream_t s) {
  CUtensorMap ta, tw;
  if (!tensor_map(&ta, a, m, k, 64 * p.tile.wg) || !tensor_map(&tw, w, n, k, p.tile.bn))
    return cudaErrorInvalidValue;
#define GDR_TILE_LAUNCH(wg_, bn_, st_)                                                  \
  if (p.tile.wg == wg_ && p.tile.bn == bn_)                                             \
    return launch_epi<wg_, bn_, st_>(epi, ta, tw, resid, c, ws, counters, m, n, k, p.splits, \
                                     p.blocks, s);
  GDR_GEMM_TILES(GDR_TILE_LAUNCH)
#undef GDR_TILE_LAUNCH
  return cudaErrorInvalidValue;
}

template <int WM, int WN, int TN>
static cudaError_t launch_f32_ws(const CUtensorMap& ta, const CUtensorMap& tw, const void* resid,
                                 void* c, void* ws, int* counters, int m, int n, int k,
                                 int splits, int blocks, int stages, int epi, cudaStream_t s) {
  using R = WsRing<WM, WN, TN>;
  auto kernel = gemm_f32_ring_ws<WM, WN, TN>;
  static unsigned ready = 0;                       // checked and opted in, once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(ready & bit)) {
    // the consumers' setmaxnreg.inc waits for registers that the block's
    // pool, its threads x the kernel's count, must hold
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    if (fa.numRegs * R::kThreads < R::kConsumers * kWsConsumerRegs + 128 * R::kProducerRegs)
      return cudaErrorInvalidConfiguration;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptin);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    ready |= bit;
  }
  const long long units =
      (long long)((m + R::BM - 1) / R::BM) * ((n + R::BN - 1) / R::BN) * splits;
  const int grid = blocks < units ? blocks : (int)units;
  kernel<<<grid, R::kThreads, ws_smem(R::BM, R::BN, stages), s>>>(
      ta, tw, static_cast<const float*>(resid), static_cast<float*>(c), static_cast<float4*>(ws),
      counters, m, n, k, splits, stages, epi);
  return cudaGetLastError();
}

static cudaError_t gemm_f32_ws(const void* a, const void* w, const void* resid, void* c, int m,
                               int n, int k, int epi, const Plan& p, void* ws, int* counters,
                               cudaStream_t s) {
  CUtensorMap ta, tw;
  if (!tensor_map(&ta, a, m, k, 32 * p.tile.wg, true) ||
      !tensor_map(&tw, w, n, k, p.tile.bn, true))
    return cudaErrorInvalidValue;
#define GDR_WS_LAUNCH(wm_, wn_, tn_)                                                        \
  if (32 * p.tile.wg == WsRing<wm_, wn_, tn_>::BM && p.tile.bn == WsRing<wm_, wn_, tn_>::BN) \
    return launch_f32_ws<wm_, wn_, tn_>(ta, tw, resid, c, ws, counters, m, n, k, p.splits,  \
                                        p.blocks, p.tile.stages, epi, s);
  GDR_WS_TILES(GDR_WS_LAUNCH)
#undef GDR_WS_LAUNCH
  return cudaErrorInvalidValue;
}

// the small-row kernel's instantiations: (TM rows, TN columns) a lane
#define GDR_ROWS_TILES(X) \
  X(2, 6) X(4, 6) X(5, 6) X(6, 6) X(7, 6) X(8, 6) X(2, 8) X(4, 8) X(5, 8) X(6, 8) X(7, 8) X(8, 8)

template <int TM, int TN>
static cudaError_t launch_f32_rows(const CUtensorMap& ta, const CUtensorMap& tw,
                                   const void* resid, void* c, int m, int n, int k, int mt,
                                   int cl, int stages, int epi, cudaStream_t s) {
  auto kernel = gemm_f32_ring_rows<TM, TN>;
  static unsigned opted = 0;                       // the shared-memory opt-in, once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(opted & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptin);
    if (e != cudaSuccess) return e;
    opted |= bit;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + 8 * TN - 1) / (8 * TN) * cl);
  cfg.blockDim = dim3(kRowsThreads);
  cfg.dynamicSmemBytes = rows_smem(mt, 8 * TN, stages);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;                   // a strip's blocks, consecutive in x
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, ta, tw, static_cast<const float*>(resid),
                            static_cast<float*>(c), m, n, k, mt, stages, epi);
}

static cudaError_t gemm_f32_rows(const void* a, const void* w, const void* resid, void* c, int m,
                                 int n, int k, int epi, const Plan& p, cudaStream_t s) {
  const int mt = 8 * p.tile.wg, tm = mt / (4 * rows_wr(mt)), tn = p.tile.bn / 8;
  CUtensorMap ta, tw;
  if (!tensor_map(&ta, a, m, k, mt, true) || !tensor_map(&tw, w, n, k, p.tile.bn, true))
    return cudaErrorInvalidValue;
#define GDR_ROWS_LAUNCH(tm_, tn_)                                                          \
  if (tm == tm_ && tn == tn_)                                                              \
    return launch_f32_rows<tm_, tn_>(ta, tw, resid, c, m, n, k, mt, p.splits, p.tile.stages, \
                                     epi, s);
  GDR_ROWS_TILES(GDR_ROWS_LAUNCH)
#undef GDR_ROWS_LAUNCH
  return cudaErrorInvalidValue;
}

static cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// K/V in shared memory bound S (kernels/decode.py::cross_attn_max_len
// mirrors both formulas, and the wrapper refuses more than they fit)
template <int DKV>
static cudaError_t launch_cross_bf16(const void* q, const void* ck, const void* cv,
                                     const void* bias, void* out, int B, int K, int H, int S,
                                     cudaStream_t s) {
  const int sp = (S + 15) & ~15;
  const size_t smem = (size_t)2 * sp * (DKV + 8) * 2 + (size_t)sp * 4;
  const cudaError_t e = set_smem((const void*)cross_attn_core_bf16<DKV>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (K + 15) / 16, warps = tiles < 4 ? tiles : 4;
  cross_attn_core_bf16<DKV><<<B * H, 32 * warps, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(ck),
      static_cast<const __nv_bfloat16*>(cv), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), K, H, S);
  return cudaGetLastError();
}

// the tiled f32 core's shared memory: q rows, a K and a V tile, and the
// tile's scores of all keys (kernels/decode.py::cross_attn_max_len mirrors it)
static size_t cross_tiled_smem(int dkv, int S) {
  const int sp = (S + kKeyTile - 1) / kKeyTile * kKeyTile;
  return (size_t)(kBeamTile * (dkv + 4) + 2 * kKeyTile * (dkv + 4) + kBeamTile * (sp + 4)) * 4;
}

template <int DKV>
static cudaError_t launch_cross_f32(const void* q, const void* ck, const void* cv,
                                    const void* bias, void* out, int B, int K, int H, int S,
                                    cudaStream_t s) {
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(ck),
              *vf = static_cast<const float*>(cv), *bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  if (K < kStreamBeams) {
    const size_t smem = (size_t)(4 * 128 + S) * 4;  // partial rows, then the scores
    const cudaError_t e = set_smem((const void*)cross_attn_stream_f32<DKV>, smem);
    if (e != cudaSuccess) return e;
    cross_attn_stream_f32<DKV><<<B * K * H, 128, smem, s>>>(qf, kf, vf, bf, of, K, H, S);
    return cudaGetLastError();
  }
  const size_t smem = cross_tiled_smem(DKV, S);
  if (smem > 232448) return cudaErrorInvalidValue;
  const cudaError_t e = set_smem((const void*)cross_attn_tiled_f32<DKV>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (K + kBeamTile - 1) / kBeamTile;
  cross_attn_tiled_f32<DKV><<<B * H * tiles, 128, smem, s>>>(qf, kf, vf, bf, of, K, H, S);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_self(const void* qkv, void* ck, void* cv, const void* bias,
                               void* attn, int R, int L, int H, int dkv, int pos,
                               cudaStream_t s) {
  const int G = dkv / Chunk<T>::n;
  if (pos < 0 || pos >= L || dkv % Chunk<T>::n || G > 32 || (G & (G - 1)))
    return cudaErrorInvalidValue;
  const int threads = 128;
  const long groups = (long)R * H;
  const int blocks = (int)((groups * G + threads - 1) / threads);
  const T* q = static_cast<const T*>(qkv);
  T *k = static_cast<T*>(ck), *v = static_cast<T*>(cv), *o = static_cast<T*>(attn);
  const float* b = static_cast<const float*>(bias);
  if (L > 16) {
    // one f32 score per position <= pos for each of the block's groups
    const size_t smem = (size_t)(threads / G) * L * sizeof(float);
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    const cudaError_t e = set_smem((const void*)self_attn_core_long<T>, smem);
    if (e != cudaSuccess) return e;
    const size_t used = (size_t)(threads / G) * (pos + 1) * sizeof(float);
    self_attn_core_long<T><<<blocks, threads, used, s>>>(q, k, v, b, o, R, H, G, pos);
    return cudaGetLastError();
  }
  if (L <= 4)
    self_attn_core<T, 4><<<blocks, threads, 0, s>>>(q, k, v, b, o, R, H, G, pos);
  else if (L <= 8)
    self_attn_core<T, 8><<<blocks, threads, 0, s>>>(q, k, v, b, o, R, H, G, pos);
  else
    self_attn_core<T, 16><<<blocks, threads, 0, s>>>(q, k, v, b, o, R, H, G, pos);
  return cudaGetLastError();
}

}  // namespace gdr

using gdr::kBF16;
using gdr::kF32;

// The GEMM's plan for C[m, n] = A[m, k] · W[n, k]ᵀ in `dtype` on a card of
// `sms` SMs: plan[0..6] = tile rows / 64 (bf16), / 32 (the f32 ring) or / 8
// (the small-row kernel), tile columns, ring stages, splits, work units,
// blocks, and the kernel (Kernel: 0 the bf16 tile kernel, 1 the small-row
// kernel, 2 the warp-specialised f32 ring).  A split plan of the bf16 tile
// kernel needs splits x [tile rows x tile columns] f32 of workspace per
// output tile, one of the warp-specialised ring (its tiles' k-tiles cut into
// `splits` units) 2 x [tile rows x tile columns] per block; both one counter
// per output tile.  The small-row kernel splits over the blocks of a cluster
// and needs neither.
extern "C" int gdr_gemm_plan(int dtype, int m, int n, int k, int sms, int* plan) {
  if (m <= 0 || n <= 0 || k <= 0 || sms <= 0 || plan == nullptr ||
      (dtype != kBF16 && dtype != kF32))
    return cudaErrorInvalidValue;
  const gdr::Plan p =
      dtype == kBF16 ? gdr::choose_plan(m, n, k, sms) : gdr::choose_plan_f32(m, n, k, sms);
  const int out[7] = {p.tile.wg, p.tile.bn, p.tile.stages, p.splits, p.units, p.blocks, p.kernel};
  for (int i = 0; i < 7; ++i) plan[i] = out[i];
  return cudaSuccess;
}

// The warp-specialised ring's plans that choose_plan_f32 weighs at C[m, n],
// K = k, on a card of `sms` SMs, in its order: five ints each (tile rows,
// tile columns, ring stages, splits, blocks), at most `cap` of them into
// `plans`; *count = how many there are (so that kernels/f32_bench.py sweep
// times, and the tests check, the chooser's own list).
extern "C" int gdr_gemm_ws_plans(int m, int n, int k, int sms, int* plans, int cap, int* count) {
  if (m <= 0 || n <= 0 || k <= 0 || sms <= 0 || cap < 0 || count == nullptr ||
      (cap > 0 && plans == nullptr))
    return cudaErrorInvalidValue;
  int c = 0;
  gdr::ws_plans(m, n, k, sms, [&](const gdr::WsShape& t, int s, int g) {
    if (c < cap) {
      const int row[5] = {t.bm, t.bn, gdr::ws_stages(t), s, g};
      for (int i = 0; i < 5; ++i) plans[5 * c + i] = row[i];
    }
    ++c;
  });
  *count = c;
  return cudaSuccess;
}

// The small-row kernel's modelled time, in seconds, of a plan of a `bn`
// strip, `cl` blocks a cluster and `stages` at C[m, n], K = k, on a card of
// `sms` SMs: plan_time_rows with `model` = its five constants in RowsModel's
// order (null: the fitted ones), so that kernels/f32_bench.py sweep fits the
// model the chooser runs.  Refuses a plan the kernel does not run.
extern "C" int gdr_gemm_rows_time(int m, int n, int k, int bn, int cl, int stages, int sms,
                                  const double* model, double* seconds) {
  if (n <= 0 || k <= 0 || sms <= 0 || seconds == nullptr ||
      !gdr::rows_plan_ok(m, k, bn, cl, stages))
    return cudaErrorInvalidValue;
  const gdr::RowsModel c =
      model ? gdr::RowsModel{model[0], model[1], model[2], model[3], model[4]} : gdr::kRowsModel;
  *seconds = gdr::plan_time_rows(c, gdr::rows_pad(m), bn, cl, stages, m, n, k, sms);
  return cudaSuccess;
}

// The ring's modelled time, in seconds, of a plan of a `bm` x `bn` tile
// whose k-tiles are cut into `splits` units, dealt to `blocks` blocks, at
// C[m, n], K = k, on a card of `sms` SMs: plan_time_ws with `model` = its
// four constants in WsModel's order (null: the fitted ones), so that
// kernels/f32_bench.py sweep fits the model the chooser runs.  Refuses a
// tile the kernel does not have.
extern "C" int gdr_gemm_ws_time(int m, int n, int k, int bm, int bn, int splits, int blocks,
                                  int sms, const double* model, double* seconds) {
  if (m <= 0 || n <= 0 || k <= 0 || sms <= 0 || blocks < 1 || splits < 1 ||
      splits > (k + gdr::kWsBK - 1) / gdr::kWsBK || seconds == nullptr)
    return cudaErrorInvalidValue;
  for (const gdr::WsShape& t : gdr::kWsTiles)
    if (t.bm == bm && t.bn == bn) {
      const gdr::WsModel c =
          model ? gdr::WsModel{model[0], model[1], model[2], model[3]} : gdr::kWsModel;
      *seconds = gdr::plan_time_ws(c, t, splits, blocks, m, n, k, sms);
      return cudaSuccess;
    }
  return cudaErrorInvalidValue;
}

// C[M, N] = epi(norm?(A) · Wᵀ).  normed: [M, K] scratch in the model dtype
// that the row kernel writes norm(A) to (null without norm).  Runs the plan
// (wg, bn, stages, splits, blocks, kernel) of gdr_gemm_plan, or any other of
// an instantiated tile.  `kernel` 0 (bf16 only): the tile kernel, 1 <=
// splits <= min(k-tiles, 32), any number of blocks.  1 (f32 only): the
// small-row kernel (wg = its row extent / 8, at least M and rows_pad of
// itself; bn 48 or 64; `splits` = 1 to 8 blocks a cluster, at most the
// 32-float k-tiles; 1 to 8 stages in 227 KB), M <= 128; no workspace, no
// counters.  2 (f32 only): the warp-specialised ring, 1 <= splits <= its
// 32-float k-tiles, 1 to 8 stages in 227 KB, on min(blocks, tiles x splits)
// blocks.  A split plan of kernel 0 or 2 takes its f32 workspace and
// n_counters >= output tiles zeroed counters, which it leaves zeroed.
extern "C" int gdr_gemm(int dtype, const void* a, const void* scale, void* normed,
                        const void* w, const void* resid, void* c, int m, int n, int k,
                        int norm, int epi, float eps, int wg, int bn, int splits, int blocks,
                        int stages, int kernel, void* workspace, void* counters, int n_counters,
                        void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || n % 8 != 0 || k % 8 != 0) return cudaErrorInvalidValue;
  const bool ok = (norm && (epi == gdr::kRound || epi == gdr::kRelu)) ||
                  (!norm && epi == gdr::kResidual);
  const bool bf16 = dtype == kBF16;
  if (!ok || (norm && normed == nullptr) || (!bf16 && dtype != kF32) ||
      (bf16 ? kernel != gdr::kWgmma : kernel != gdr::kF32Rows && kernel != gdr::kF32Ws))
    return cudaErrorInvalidValue;
  gdr::Plan p{{0, 0, 0}, splits, 0, blocks, kernel};
  int kt = 0, bm = 0;
  if (kernel == gdr::kF32Rows) {
    const int mt = 8 * wg;
    if (m > gdr::kRowsMaxM || mt < m || mt > gdr::kRowsMaxM || gdr::rows_pad(mt) != mt ||
        (bn != 48 && bn != 64) || splits < 1 || splits > gdr::kRowsMaxCluster ||
        splits > (k + gdr::kRowsBK - 1) / gdr::kRowsBK || stages < 1 ||
        stages > gdr::kRowsMaxStages || gdr::rows_smem(mt, bn, stages) > gdr::kSmemOptin)
      return cudaErrorInvalidValue;
    p.tile = {wg, bn, stages};
  } else {
    if (bf16) {
      for (const gdr::Tile& t : gdr::kTiles)
        if (t.wg == wg && t.bn == bn) p.tile = t;
      kt = (k + gdr::BK - 1) / gdr::BK;
      bm = 64 * wg;
    } else {
      for (const gdr::WsShape& t : gdr::kWsTiles)
        if (t.bm == 32 * wg && t.bn == bn) p.tile = {wg, bn, stages};
      kt = (k + gdr::kWsBK - 1) / gdr::kWsBK;
      bm = 32 * wg;
      if (stages < 1 || stages > gdr::kWsMaxStages ||
          gdr::ws_smem(bm, bn, stages) > gdr::kSmemOptin)
        return cudaErrorInvalidValue;
    }
    if (p.tile.wg == 0 || splits < 1 || splits > kt || (bf16 && splits > gdr::kMaxSplits) ||
        blocks < 1)
      return cudaErrorInvalidValue;
    const long tiles = (long)((m + bm - 1) / bm) * ((n + bn - 1) / bn);
    if ((splits > 1 && (workspace == nullptr || counters == nullptr || tiles > n_counters)) ||
        tiles * splits > 0x7fffffff)
      return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (norm) {
    if (bf16)
      gdr::rms_norm<__nv_bfloat16><<<(m + 7) / 8, 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(scale),
          static_cast<__nv_bfloat16*>(normed), m, k, eps);
    else
      gdr::rms_norm<float><<<(m + 7) / 8, 256, 0, s>>>(static_cast<const float*>(a),
                                                       static_cast<const float*>(scale),
                                                       static_cast<float*>(normed), m, k, eps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    a = normed;
  }
  int* cnt = static_cast<int*>(counters);
  if (kernel == gdr::kF32Rows) return gdr::gemm_f32_rows(a, w, resid, c, m, n, k, epi, p, s);
  if (kernel == gdr::kF32Ws)
    return gdr::gemm_f32_ws(a, w, resid, c, m, n, k, epi, p, workspace, cnt, s);
  return gdr::gemm_bf16(a, w, resid, c, m, n, k, epi, p, workspace, cnt, s);
}

extern "C" int gdr_self_attn_core(int dtype, const void* qkv, void* ck, void* cv,
                                  const void* bias, void* attn, int rows, int L, int heads,
                                  int dkv, int pos, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == kBF16
             ? gdr::launch_self<__nv_bfloat16>(qkv, ck, cv, bias, attn, rows, L, heads, dkv,
                                               pos, s)
             : gdr::launch_self<float>(qkv, ck, cv, bias, attn, rows, L, heads, dkv, pos, s);
}

extern "C" int gdr_cross_attn_core(int dtype, const void* q, const void* ck, const void* cv,
                                   const void* bias, void* out, int batch, int beams,
                                   int heads, int S, int dkv, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GDR_CROSS(d)                                                                     \
  case d:                                                                                \
    return dtype == kBF16                                                                \
               ? gdr::launch_cross_bf16<d>(q, ck, cv, bias, out, batch, beams, heads, S, s) \
               : gdr::launch_cross_f32<d>(q, ck, cv, bias, out, batch, beams, heads, S, s);
  switch (dkv) {
    GDR_CROSS(16)
    GDR_CROSS(32)
    GDR_CROSS(64)
    GDR_CROSS(128)
    default: return cudaErrorInvalidValue;
  }
#undef GDR_CROSS
}
