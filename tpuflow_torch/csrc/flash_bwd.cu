// Flash-attention backward for Hopper (sm_90a): the fused and the split
// dq and dk/dv pairs.
//
// Replaces, in tpuflow/ops/flash_attention.py:
// - _flash_bwd_fused: the Pallas kernels _bwd_dq_fused_kernel (dq plus the
//   row delta) and _bwd_dkv_fused_kernel (dk and dv from the residuals,
//   never reading O);
// - _flash_bwd_split: _bwd_dq_kernel and _bwd_dkv_kernel, which recompute
//   the row delta from O and dO on every block visit, and whose dk/dv
//   kernel reads O instead of a delta array.
// The FlashAttention-2 recompute: with the forward's row logsumexp,
//   P  = exp(S - lse),  S = (Q K^T) * 1/sqrt(D), causal mask value -1e30,
//   dP = dO V^T,  D = rowsum(dO o O),  dS = P o (dP - D) * 1/sqrt(D),
//   dQ = dS K,  dK = dS^T Q,  dV = P^T dO.
// S and dP are input-dtype products summed in f32. For bf16 inputs P is
// rounded to dO's dtype before P^T dO and dS to the input dtype before
// dS K and dS^T Q, as the TPU kernels cast them; the gradients are written
// in the input dtype.
//
// What bounds it on the H100: at the training shape (B*H = 96, T = 1024,
// D = 64) each pair does five causal T x T x D products (S and dP in both
// kernels, then dQ, dK, dV) against ~10 (B*H, T, D) arrays of traffic: it
// is bound by operations, on the tensor cores for bf16 and on the f32 CUDA
// cores for f32 (no TF32: the f32 contract is IEEE products).
//
// Grid. The TPU walks a sequential grid axis and carries dq (or dk, dv) in
// scratch across it; here each block owns one output tile and loops:
// - dq: a block per (batch*head, q tile of `rows` rows), the q tiles in
//   reverse under the causal mask (the longest run first). It streams the
//   64-key tiles (32 for bf16 at D = 128) up to the causal bound.
// - dk/dv: a block per (batch*head, key tile of `rows` rows), the key tiles
//   ascending (key tile 0 sees every q row: the longest first). It streams
//   the 64-row q tiles (32 for bf16 at D = 128) from the causal start, with
//   their lse and D rows (fused) or their O tile (split).
// `rows` is the launch plan's (ops/flash_attention.py::_flash_bwd_plan):
// 32 or 64 (bf16: 16 a warp), or 128 (f32 at D <= 64: 8 a lane pair, 8
// warps); the C entries derive grid and shared memory from it and refuse
// other values.
// The streamed tiles come by 16-byte cp.async (4-byte for the lse and D
// rows) into a two-stage ring: the next tile loads while this one
// computes, one barrier per tile (split dk/dv adds one after it computes
// the tile's D). Ragged Tq, Tk and Tq != Tk are masked in the kernels;
// rows or strides that are not 16-byte aligned are staged by plain loads.
//
// bf16 (bwd_dq_mma, bwd_dkv_mma): FlashAttention-2 on mma.sync m16n8k16
// bf16 -> f32, each warp owning 16 rows of the block's tile.
// - dq: Q and dO are A fragments in registers for the whole key loop;
//   S = Q K^T and dP = dO V^T take K and V by ldmatrix.x4; P and dS are
//   computed on the accumulator fragments, and dS, rounded to bf16 in
//   registers, is the A operand of dQ += dS K with K by ldmatrix.x4.trans.
// - dk/dv: K and V are A fragments; S^T = K Q^T and dP^T = V dO^T take Q
//   and dO by ldmatrix.x4; P^T and dS^T, rounded to bf16 in registers, are
//   the A operands of dV += P^T dO and dK += dS^T Q, dO and Q by .trans. A
//   lane's lse and D columns come from the stage's rows in shared memory.
// No S, P or dS tile goes through shared memory. At D = 128 the A
// fragments are read from shared memory per use instead of held, and the
// streamed tiles are 32 rows, to stay within 255 registers.
//
// f32 (bwd_dq_fma, bwd_dkv_fma): IEEE f32 FMAs on the CUDA cores, the
// forward's tiling: a pair of lanes per 8 rows x 8 columns of S and dP,
// each lane over one half of d (halves added by a shuffle), rows
// interleaved and columns strided by 8 so that float4 reads hit distinct
// banks. Every word a product loop loads from shared memory feeds 8 FMAs.
// P and dS go through a warp-private buffer (a __syncwarp, no block
// barrier; dk/dv writes dS^T over P^T once dV has taken it) to the
// products that take them, where each lane of a pair takes one half of the
// reduction for 8 rows x D/8 columns and the halves are added at the end.
// The f32 blocks are shared-memory bound to one an SM (~177 KB at 128
// rows), so the plan gives them 8 warps where the grid allows; a lane sits
// at ~254 registers.
//
// Head dims. D = 32, 64 and 128 are instantiated as they are; the wrapper
// zero-pads any other D % 8 == 0 up to the next of 32, 64, 128, 256 (q, k,
// v, O and dO) and passes the true scale 1/sqrt(D): zero columns add exact
// zeros to every S, dP, D and gradient column. D = 256 keeps the D = 128
// register layout by splitting the output columns: a block owns 128 of
// them (grid.z = 2), computes S, dP and D over the full 256 and
// accumulates dQ (or dK and dV) for its own columns only; the fused dq
// kernel's delta row is written by column block 0 alone. The S and dP
// work is done once a column block; nothing else changes. The streamed
// tiles are 32 rows (bf16 as at D = 128; f32 too, whose 64-row ring would
// not fit), and an f32 block owns 32 rows. Above 256 the wide-head kernels
// take over (see "wide heads" below): a block keeps its own rows at 512
// columns and computes S and dP once a tile.
//
// Bits. Split = fused: the split kernels are the fused kernels' code with
// the SPLIT flag set; D comes from one helper (pair_delta, a fixed order)
// at all three sites, P and dS from two others (prob, dscore) of _rn
// intrinsics never contracted into FMAs, so both pairs give the same bits.
// A dq block visits its q tile once, so split dq computes D once as fused
// dq does, without writing it; split dk/dv recomputes it for every q tile
// from the O tile it streams. Each output tile has one owner and no
// atomics are used: two runs give the same bits. The bits do not depend on
// the plan: the streamed tiles are anchored at row 0 and their height is
// fixed by dtype and D, every output element sums its products in the
// same order whatever `rows` is, and tiles that are wholly masked (skipped
// per block or per warp) add exact zeros.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int STAGES = 2;  // ring depth of the streamed tiles
constexpr float NEG_INF = -1e30f;

// f32: keys (dq) or q rows (dk/dv) a streamed tile; its P / dS buffer row
// stride (+8: banks).
__host__ __device__ constexpr int fma_tile(int D) { return D <= 128 ? 64 : 32; }
__host__ __device__ constexpr int fma_ps(int D) { return fma_tile(D) + 8; }
// The output columns a block owns (grid.z = D / out_cols(D)).
__host__ __device__ constexpr int out_cols(int D) { return D <= 128 ? D : 128; }

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows x D elements of (seq-strided) global memory, rows t0.., into shared
// memory with row stride RS elements; rows >= T_len are zero.
template <typename T, int D, int RS>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long st, int t0, int T_len,
                                          int rows, bool aligned) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / E;
  for (int i = threadIdx.x; i < rows * CPR; i += blockDim.x) {
    const int r = i / CPR, ch = i % CPR, t = t0 + r;
    T* d = dst + r * RS + ch * E;
    const bool ok = t < T_len;
    if (aligned) {
      cp_async16(d, ok ? src + t * st + ch * E : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        d[e] = ok ? src[t * st + ch * E + e] : T(0.f);
    }
  }
}

// n f32 entries of a (B*H, Tq) row array from row t0 on (0 past Tq).
__device__ __forceinline__ void load_row_vals(float* dst, const float* src,
                                              int t0, int T_len, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool ok = t0 + i < T_len;
    cp_async4(dst + i, ok ? src + t0 + i : src, ok ? 4 : 0);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D = rowsum(dO o O) of one row in f32 by a pair of adjacent lanes (lane
// bit 0 = `half`): each sums its half of d in ascending order, one FMA per
// element, and both return lower + upper (a + b == b + a). Every kernel
// that computes D calls this, so the fused value (computed once, stored in
// f32) and the split value (recomputed per visit) are the same bits. All
// 32 lanes of the warp must call it. VEC: both rows are 16-byte aligned
// (shared-memory tiles) and are read 16 bytes at a time; the FMAs are the
// same.
template <int D, bool VEC = true, typename T>
__device__ __forceinline__ float pair_delta(const T* g, const T* o,
                                            int half) {
  constexpr int E = VEC ? 16 / sizeof(T) : 1;  // elements a load
  float s = 0.f;
  const int d0 = half * (D / 2);
#pragma unroll
  for (int d = d0; d < d0 + D / 2; d += E) {
    alignas(16) T gv[E];
    alignas(16) T ov[E];
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(g + d);
      *reinterpret_cast<uint4*>(ov) = *reinterpret_cast<const uint4*>(o + d);
    } else {
      gv[0] = g[d];
      ov[0] = o[d];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) s = fmaf(to_f32(gv[e]), to_f32(ov[e]), s);
  }
  const float other = __shfl_xor_sync(0xffffffffu, s, 1);
  return half == 0 ? s + other : other + s;
}

// P = exp(S * scale - lse), 0 where out of range; S masked to -1e30.
// dS = P (dP - D) scale. Each operation rounded on its own (the _rn
// intrinsics are never contracted into an FMA), so every kernel gets the
// same bits from the same inputs.
__device__ __forceinline__ float prob(float s, float lse, float scale,
                                      bool masked, bool in_range) {
  const float x = masked ? NEG_INF : __fmul_rn(s, scale);
  return in_range ? expf(__fsub_rn(x, lse)) : 0.f;
}
__device__ __forceinline__ float dscore(float p, float dp, float delta,
                                        float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

// Element strides over (batch, seq, head) of one (B, T, H, D) tensor with
// unit stride over D.
struct Strides {
  long long b, t, h;
};

struct Args {
  const void *q, *k, *v, *o, *g;  // o: dq kernels and split dk/dv only
  const float* lse;               // (B*H, Tq)
  const float* delta_in;          // fused dk/dv: (B*H, Tq)
  float* delta_out;               // fused dq: (B*H, Tq)
  void *dq, *dk, *dv;             // contiguous (B, T, H, D)
  int H, Tq, Tk, causal, aligned;
  float scale;  // 1/sqrt(D) of the caller's D, before any padding
  Strides sq, sk, sv, so, sg;
};

template <typename T>
__device__ __forceinline__ const T* head(const void* p, const Strides& s,
                                         int b, int h) {
  return (const T*)p + b * s.b + h * s.h;
}

// bf16 tile heights: keys a dq tile, q rows a dk/dv tile.
__host__ __device__ constexpr int mma_tile(int D) { return D >= 128 ? 32 : 64; }

// Whether the split dk/dv ring stages O: all but f32 at D = 128, whose
// stage would not fit the block's shared memory twice; that kernel reads
// O's rows from global memory when it computes D.
template <typename T, int D, bool SPLIT>
__host__ __device__ constexpr bool o_staged() {
  return SPLIT && (sizeof(T) == 2 || D < 128);
}

// One streamed q tile of the dk/dv kernels: Q, dO, O (if staged), lse, D.
template <typename T>
struct QStage {
  T *q, *g, *o;
  float *lse, *dl;
};
template <typename T>
__host__ __device__ constexpr int qstage_bytes(int BQ, int RS, bool ost) {
  return (int)sizeof(T) * (ost ? 3 : 2) * BQ * RS + 8 * BQ;
}
template <typename T, bool OST>
__device__ __forceinline__ QStage<T> qstage(uint8_t* base, int BQ, int RS) {
  QStage<T> s;
  s.q = reinterpret_cast<T*>(base);
  s.g = s.q + BQ * RS;
  s.o = s.g + BQ * RS;
  s.lse = reinterpret_cast<float*>(s.g + (OST ? 2 : 1) * BQ * RS);
  s.dl = s.lse + BQ;
  return s;
}
template <typename T, int D, int RS, bool SPLIT, bool OST>
__device__ __forceinline__ void load_qstage(const QStage<T>& s, const Args& a,
                                            const T* qb, const T* gb,
                                            const T* ob, int bh, int q0,
                                            int BQ) {
  load_rows<T, D, RS>(s.q, qb, a.sq.t, q0, a.Tq, BQ, a.aligned);
  load_rows<T, D, RS>(s.g, gb, a.sg.t, q0, a.Tq, BQ, a.aligned);
  if (OST) load_rows<T, D, RS>(s.o, ob, a.so.t, q0, a.Tq, BQ, a.aligned);
  const long long r0 = (long long)bh * a.Tq;
  load_row_vals(s.lse, a.lse + r0, q0, a.Tq, BQ);
  if (!SPLIT) load_row_vals(s.dl, a.delta_in + r0, q0, a.Tq, BQ);
}

// Split dk/dv: the stage's D rows from its dO tile and O (the staged tile,
// or else O's rows in global memory; a row past Tq takes its zero dO row
// in O's place), two lanes a row; a warp takes whole rows or none.
template <int D, bool OST, typename T>
__device__ __forceinline__ void stage_delta(const QStage<T>& s, int BQ,
                                            int RS, const T* ob,
                                            long long ost, int q0, int Tq) {
  for (int r = threadIdx.x >> 1; r < BQ; r += blockDim.x >> 1) {
    const T* g = s.g + r * RS;
    const T* o = OST ? s.o + r * RS : q0 + r < Tq ? ob + (q0 + r) * ost : g;
    const float d = pair_delta<D, OST>(g, o, threadIdx.x & 1);
    if ((threadIdx.x & 1) == 0) s.dl[r] = d;
  }
}

// ----------------------------------------------------------- bf16, dq
template <int D, bool SPLIT>
__global__ void __launch_bounds__(128)
bwd_dq_mma(const Args a) {
  constexpr int RS = D + 8;  // +16 bytes a row: ldmatrix rows hit all banks
  constexpr int BK = mma_tile(D);
  constexpr int DV = out_cols(D);  // dq columns from col0 on
  constexpr bool AREG = D <= 64;  // Q, dO fragments held in registers
  extern __shared__ __align__(16) uint8_t smem[];
  const int BQ = blockDim.x / 2;  // 16 rows a warp
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + BQ * RS;
  bf16* ring = Gs + BQ * RS;  // [STAGES][K, V][BK][RS]
  bf16* Os = ring + 2 * BK * RS;  // slot 1, free until tile 1 is loaded
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ, w0 = warp * 16, col0 = blockIdx.z * DV;
  const bf16* kb = head<bf16>(a.k, a.sk, b, h);
  const bf16* vb = head<bf16>(a.v, a.sv, b, h);
  const bool al = a.aligned;

  const int k_end = a.causal ? min(a.Tk, q0 + BQ) : a.Tk;
  const int n_kt = (k_end + BK - 1) / BK;
  load_rows<bf16, D, RS>(Qs, head<bf16>(a.q, a.sq, b, h), a.sq.t, q0, a.Tq,
                         BQ, al);
  load_rows<bf16, D, RS>(Gs, head<bf16>(a.g, a.sg, b, h), a.sg.t, q0, a.Tq,
                         BQ, al);
  load_rows<bf16, D, RS>(Os, head<bf16>(a.o, a.so, b, h), a.so.t, q0, a.Tq,
                         BQ, al);
  if (n_kt > 0) {
    load_rows<bf16, D, RS>(ring, kb, a.sk.t, 0, a.Tk, BK, al);
    load_rows<bf16, D, RS>(ring + BK * RS, vb, a.sv.t, 0, a.Tk, BK, al);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // D of the warp's rows (two lanes a row), and of the lane's rows g, g+8.
  const int drow = q0 + w0 + (lane >> 1);
  const float dl = pair_delta<D>(Gs + (w0 + (lane >> 1)) * RS,
                                 Os + (w0 + (lane >> 1)) * RS, lane & 1);
  if (!SPLIT && blockIdx.z == 0 && (lane & 1) == 0 && drow < a.Tq)
    a.delta_out[(long long)bh * a.Tq + drow] = dl;
  float dr[2], lr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dr[r] = __shfl_sync(0xffffffffu, dl, 2 * (g + 8 * r));
    const int row = q0 + w0 + g + 8 * r;
    lr[r] = row < a.Tq ? a.lse[(long long)bh * a.Tq + row] : 0.f;
  }
  uint32_t qf[AREG ? D / 16 : 1][4], gf[AREG ? D / 16 : 1][4];
  if constexpr (AREG) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (w0 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(qf[kk], Qs + off);
      ldsm_x4(gf[kk], Gs + off);
    }
  }
  float acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int row_last = q0 + w0 + 15;

  for (int j = 0; j < n_kt; ++j) {
    cp_async_wait_all();  // tile j has landed
    __syncthreads();      // ... for every thread; slot (j+1)%2 is free
    if (j + 1 < n_kt) {
      bf16* nx = ring + ((j + 1) % STAGES) * 2 * BK * RS;
      load_rows<bf16, D, RS>(nx, kb, a.sk.t, (j + 1) * BK, a.Tk, BK, al);
      load_rows<bf16, D, RS>(nx + BK * RS, vb, a.sv.t, (j + 1) * BK, a.Tk,
                             BK, al);
    }
    cp_async_commit();
    const int k0 = j * BK;
    if (a.causal && k0 > row_last) continue;  // adds exact zeros: skipped
    const bf16* Kt = ring + (j % STAGES) * 2 * BK * RS;
    const bf16* Vt = Kt + BK * RS;

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ag[4];
      if constexpr (AREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          aq[e] = qf[kk][e];
          ag[e] = gf[kk][e];
        }
      } else {
        const int off = (w0 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8;
        ldsm_x4(aq, Qs + off);
        ldsm_x4(ag, Gs + off);
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        const int off = (16 * np + (lane & 7) + ((lane >> 4) << 3)) * RS +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        ldsm_x4(r, Kt + off);
        mma_bf16(s[2 * np], aq, r[0], r[1]);
        mma_bf16(s[2 * np + 1], aq, r[2], r[3]);
        ldsm_x4(r, Vt + off);
        mma_bf16(dp[2 * np], ag, r[0], r[1]);
        mma_bf16(dp[2 * np + 1], ag, r[2], r[3]);
      }
    }
    // Tiles wholly below the warp's diagonal and inside Tk need no mask.
    const bool mask = (a.causal && k0 + BK - 1 > q0 + w0) || k0 + BK > a.Tk;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = q0 + w0 + g + 8 * (c >> 1);
        const int key = k0 + 8 * n + 2 * t + (c & 1);
        const float p = prob(s[n][c], lr[c >> 1], a.scale,
                             mask && a.causal && row < key,
                             !mask || key < a.Tk);
        s[n][c] = dscore(p, dp[n][c], dr[c >> 1], a.scale);
      }
    // dQ += dS K: dS (bf16) as the A operand, K by ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < DV / 16; ++dd) {
        uint32_t r[4];
        ldsm_x4_t(r, Kt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                         col0 + dd * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dd], pa, r[0], r[1]);
        mma_bf16(acc[2 * dd + 1], pa, r[2], r[3]);
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + w0 + g + 8 * r;
    if (row >= a.Tq) continue;
    bf16* out =
        (bf16*)a.dq + (((long long)b * a.Tq + row) * a.H + h) * D + col0;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      *reinterpret_cast<uint32_t*>(out + 8 * i + 2 * t) =
          pack_bf16(acc[i][2 * r], acc[i][2 * r + 1]);
  }
}

// -------------------------------------------------------- bf16, dk/dv
template <int D, bool SPLIT>
__global__ void __launch_bounds__(128)
bwd_dkv_mma(const Args a) {
  constexpr int RS = D + 8;
  constexpr int BQ = mma_tile(D);
  constexpr int DV = out_cols(D);  // dk, dv columns from col0 on
  constexpr bool AREG = D <= 64;  // K, V fragments held in registers
  constexpr bool OST = o_staged<bf16, D, SPLIT>();
  constexpr int SB = qstage_bytes<bf16>(BQ, RS, OST);
  extern __shared__ __align__(16) uint8_t smem[];
  const int BKV = blockDim.x / 2;  // 16 key rows a warp
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKV * RS;
  uint8_t* ring = reinterpret_cast<uint8_t*>(Vs + BKV * RS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * BKV, kw0 = k0 + warp * 16;
  const int col0 = blockIdx.z * DV;
  const bf16* qb = head<bf16>(a.q, a.sq, b, h);
  const bf16* gb = head<bf16>(a.g, a.sg, b, h);
  const bf16* ob = SPLIT ? head<bf16>(a.o, a.so, b, h) : nullptr;

  // Causal: a q tile whose last row precedes this key tile sees none of it.
  const int q_begin = a.causal ? (k0 / BQ) * BQ : 0;
  const int n_qt = a.Tq > q_begin ? (a.Tq - q_begin + BQ - 1) / BQ : 0;
  load_rows<bf16, D, RS>(Ks, head<bf16>(a.k, a.sk, b, h), a.sk.t, k0, a.Tk,
                         BKV, a.aligned);
  load_rows<bf16, D, RS>(Vs, head<bf16>(a.v, a.sv, b, h), a.sv.t, k0, a.Tk,
                         BKV, a.aligned);
  if (n_qt > 0)
    load_qstage<bf16, D, RS, SPLIT, OST>(qstage<bf16, OST>(ring, BQ, RS), a,
                                         qb, gb, ob, bh, q_begin, BQ);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t kf[AREG ? D / 16 : 1][4], vf[AREG ? D / 16 : 1][4];
  if constexpr (AREG) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8;
      ldsm_x4(kf[kk], Ks + off);
      ldsm_x4(vf[kk], Vs + off);
    }
  }
  float ak[DV / 8][4], av[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) ak[i][c] = av[i][c] = 0.f;

  for (int j = 0; j < n_qt; ++j) {
    cp_async_wait_all();  // tile j has landed
    __syncthreads();      // ... for every thread; slot (j+1)%2 is free
    if (j + 1 < n_qt)
      load_qstage<bf16, D, RS, SPLIT, OST>(
          qstage<bf16, OST>(ring + ((j + 1) % STAGES) * SB, BQ, RS), a, qb,
          gb, ob, bh, q_begin + (j + 1) * BQ, BQ);
    cp_async_commit();
    const int q0 = q_begin + j * BQ;
    const QStage<bf16> st = qstage<bf16, OST>(ring + (j % STAGES) * SB, BQ, RS);
    if (SPLIT) {
      stage_delta<D, OST>(st, BQ, RS, ob, a.so.t, q0, a.Tq);
      __syncthreads();  // the tile's D rows are written
    }
    // All of the tile's rows before the warp's first key, or no key of the
    // warp inside Tk: exact zeros, skipped.
    if ((a.causal && q0 + BQ - 1 < kw0) || kw0 >= a.Tk) continue;

    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak_[4], av_[4];
      if constexpr (AREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ak_[e] = kf[kk][e];
          av_[e] = vf[kk][e];
        }
      } else {
        const int off = (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8;
        ldsm_x4(ak_, Ks + off);
        ldsm_x4(av_, Vs + off);
      }
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        const int off = (16 * np + (lane & 7) + ((lane >> 4) << 3)) * RS +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        ldsm_x4(r, st.q + off);
        mma_bf16(s[2 * np], ak_, r[0], r[1]);
        mma_bf16(s[2 * np + 1], ak_, r[2], r[3]);
        ldsm_x4(r, st.g + off);
        mma_bf16(dp[2 * np], av_, r[0], r[1]);
        mma_bf16(dp[2 * np + 1], av_, r[2], r[3]);
      }
    }
    // P^T into s, dS^T into dp. Tiles wholly at or below the diagonal for
    // every key of the warp and inside Tq and Tk need no mask.
    const bool mask = (a.causal && q0 < kw0 + 15) || q0 + BQ > a.Tq ||
                      kw0 + 16 > a.Tk;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kw0 + g + 8 * (c >> 1);
        const int col = 8 * n + 2 * t + (c & 1), row = q0 + col;
        const float p = prob(s[n][c], st.lse[col], a.scale,
                             mask && a.causal && row < key,
                             !mask || (row < a.Tq && key < a.Tk));
        s[n][c] = p;
        dp[n][c] = dscore(p, dp[n][c], st.dl[col], a.scale);
      }
    // dV += P^T dO and dK += dS^T Q: P^T, dS^T (bf16) as the A operands,
    // dO and Q by ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      sa[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      sa[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      sa[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      sa[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < DV / 16; ++dd) {
        const int off = (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                        col0 + dd * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        ldsm_x4_t(r, st.g + off);
        mma_bf16(av[2 * dd], pa, r[0], r[1]);
        mma_bf16(av[2 * dd + 1], pa, r[2], r[3]);
        ldsm_x4_t(r, st.q + off);
        mma_bf16(ak[2 * dd], sa, r[0], r[1]);
        mma_bf16(ak[2 * dd + 1], sa, r[2], r[3]);
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + g + 8 * r;
    if (key >= a.Tk) continue;
    const long long off = (((long long)b * a.Tk + key) * a.H + h) * D + col0;
    bf16* ok = (bf16*)a.dk + off;
    bf16* ov = (bf16*)a.dv + off;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      *reinterpret_cast<uint32_t*>(ok + 8 * i + 2 * t) =
          pack_bf16(ak[i][2 * r], ak[i][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(ov + 8 * i + 2 * t) =
          pack_bf16(av[i][2 * r], av[i][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- f32
// s[i][c] = A[ty + R*i] . B[tx + 8c] over d (c < NS: a tile of 8 NS
// columns): each lane of a pair sums its half of d in ascending order (four
// FMAs a float4), then the halves are added, lower + upper (both lanes get
// the same bits). Each float4 loaded feeds 8 x 4 FMAs. Every lane of the
// warp must call it.
template <int D, int RS, int NS>
__device__ __forceinline__ void pair_dots(float (&s)[8][NS], const float* A,
                                          const float* B, int ty, int R,
                                          int tx, int hf) {
  constexpr int DH = D / 2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NS; ++c) s[i][c] = 0.f;
#pragma unroll 2
  for (int d = hf * DH; d < hf * DH + DH; d += 4) {
    float4 av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (ty + R * i) * RS + d);
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const float4 bv =
          *reinterpret_cast<const float4*>(B + (tx + 8 * c) * RS + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float x = fmaf(av[i].x, bv.x, s[i][c]);
        x = fmaf(av[i].y, bv.y, x);
        x = fmaf(av[i].z, bv.z, x);
        s[i][c] = fmaf(av[i].w, bv.w, x);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NS; ++c)
      s[i][c] += __shfl_xor_sync(0xffffffffu, s[i][c], 8);
}

// acc[i][.] += sum over the KT/2 rows u of this lane's half of a KT-wide
// tile, in order, of W[ty + R*i][u] X[u][4tx + 32qc .. +3] (DV columns of
// X): W a warp-private P / dS buffer, X a tile in shared memory. Each word
// loaded feeds 8 FMAs.
template <int DV, int RS, int KT>
__device__ __forceinline__ void half_products(float (&acc)[8][DV / 8],
                                              const float* W, const float* X,
                                              int ty, int R, int tx, int hf) {
  constexpr int NC = DV / 32, KH = KT / 2, PS = KT + 8;
#pragma unroll 2
  for (int u0 = KH * hf; u0 < KH * hf + KH; u0 += 4) {
    float4 wv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      wv[i] = *reinterpret_cast<const float4*>(W + (ty + R * i) * PS + u0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int qc = 0; qc < NC; ++qc) {
        const float4 xv = *reinterpret_cast<const float4*>(
            X + (u0 + u) * RS + 4 * tx + 32 * qc);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float w = u == 0 ? wv[i].x
                        : u == 1 ? wv[i].y
                        : u == 2 ? wv[i].z : wv[i].w;
          acc[i][4 * qc] = fmaf(w, xv.x, acc[i][4 * qc]);
          acc[i][4 * qc + 1] = fmaf(w, xv.y, acc[i][4 * qc + 1]);
          acc[i][4 * qc + 2] = fmaf(w, xv.z, acc[i][4 * qc + 2]);
          acc[i][4 * qc + 3] = fmaf(w, xv.w, acc[i][4 * qc + 3]);
        }
      }
    }
  }
}

// The halves of acc added (lower + upper) and the lane's own rows
// (i / 4 == hf) of 8 rows x DV/8 columns written to columns col0.. of a
// contiguous (B, T, H, D) f32 gradient.
template <int D, int DV>
__device__ __forceinline__ void store_rows(float (&acc)[8][DV / 8],
                                           float* out, int b, int h, int H,
                                           int T, int r0, int R, int ty,
                                           int tx, int hf, int col0) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < DV / 8; ++c)
      acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], 8);
    const int row = r0 + ty + R * i;
    if (row >= T || (i >> 2) != hf) continue;
    float* o = out + (((long long)b * T + row) * H + h) * D + col0;
#pragma unroll
    for (int qc = 0; qc < DV / 32; ++qc)
      *reinterpret_cast<float4*>(o + 4 * tx + 32 * qc) =
          make_float4(acc[i][4 * qc], acc[i][4 * qc + 1], acc[i][4 * qc + 2],
                      acc[i][4 * qc + 3]);
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[8][D / 8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
}

// Lane bits of the f32 kernels: tx (0-2) picks the columns tx + 8c of S or
// S^T, hf (3) the half of d in S and dP and of the reduction in the
// products that take P and dS, ty (4 and up) the rows ty + R*i. The warp
// holds rows ty = 2w, 2w+1 (16 rows): its P and dS buffer rows are its own.

// ------------------------------------------------------------ f32, dq
template <int D, bool SPLIT>
__global__ void __launch_bounds__(256)
bwd_dq_fma(const Args a) {
  constexpr int RS = D + 4;  // float4 rows land on distinct banks
  constexpr int KT = fma_tile(D), PS = fma_ps(D), NS = KT / 8;
  constexpr int DV = out_cols(D);  // dq columns from col0 on
  extern __shared__ __align__(16) uint8_t smem[];
  const int BQ = blockDim.x / 2, R = BQ / 8;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + BQ * RS;
  float* ring = Gs + BQ * RS;                // [STAGES][K, V][KT][RS]
  float* Os = ring + 2 * KT * RS;            // slot 1, free until tile 1
  float* dSb = ring + STAGES * 2 * KT * RS;  // [BQ][PS]: P, then dS
  float* lse_s = dSb + BQ * PS;              // [BQ]
  float* dl_s = lse_s + BQ;                   // [BQ] row delta D
  const int tid = threadIdx.x, tx = tid & 7, hf = (tid >> 3) & 1;
  const int ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ, col0 = blockIdx.z * DV;
  const float* kb = head<float>(a.k, a.sk, b, h);
  const float* vb = head<float>(a.v, a.sv, b, h);
  const bool al = a.aligned;

  const int k_end = a.causal ? min(a.Tk, q0 + BQ) : a.Tk;
  const int n_kt = (k_end + KT - 1) / KT;
  load_rows<float, D, RS>(Qs, head<float>(a.q, a.sq, b, h), a.sq.t, q0,
                          a.Tq, BQ, al);
  load_rows<float, D, RS>(Gs, head<float>(a.g, a.sg, b, h), a.sg.t, q0,
                          a.Tq, BQ, al);
  load_rows<float, D, RS>(Os, head<float>(a.o, a.so, b, h), a.so.t, q0,
                          a.Tq, BQ, al);
  if (n_kt > 0) {
    load_rows<float, D, RS>(ring, kb, a.sk.t, 0, a.Tk, KT, al);
    load_rows<float, D, RS>(ring + KT * RS, vb, a.sv.t, 0, a.Tk, KT, al);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  {
    // D and lse of the block's rows, two lanes a row (read after the first
    // tile's barrier).
    const int r = tid >> 1, row = q0 + r;
    const float d = pair_delta<D>(Gs + r * RS, Os + r * RS, tid & 1);
    if ((tid & 1) == 0) {
      dl_s[r] = d;
      lse_s[r] = row < a.Tq ? a.lse[(long long)bh * a.Tq + row] : 0.f;
      if (!SPLIT && blockIdx.z == 0 && row < a.Tq)
        a.delta_out[(long long)bh * a.Tq + row] = d;
    }
  }
  float acc[8][DV / 8];  // dS K over this lane's half of every key tile
  zero_acc<DV>(acc);

  for (int j = 0; j < n_kt; ++j) {
    cp_async_wait_all();  // tile j has landed
    __syncthreads();      // ... for every thread; slot (j+1)%2, dSb free
    if (j + 1 < n_kt) {
      float* nx = ring + ((j + 1) % STAGES) * 2 * KT * RS;
      load_rows<float, D, RS>(nx, kb, a.sk.t, (j + 1) * KT, a.Tk, KT, al);
      load_rows<float, D, RS>(nx + KT * RS, vb, a.sv.t, (j + 1) * KT, a.Tk,
                              KT, al);
    }
    cp_async_commit();
    const int k0 = j * KT;
    const float* Kt = ring + (j % STAGES) * 2 * KT * RS;
    const float* Vt = Kt + KT * RS;
    // Tiles wholly below the block's diagonal and inside Tk need no mask.
    const bool mask = (a.causal && k0 + KT - 1 > q0) || k0 + KT > a.Tk;
    float s[8][NS];
    pair_dots<D, RS, NS>(s, Qs, Kt, ty, R, tx, hf);  // S = Q K^T
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + R * i, row = q0 + r;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        const int key = k0 + tx + 8 * c;
        if ((i >> 2) == hf)
          dSb[r * PS + tx + 8 * c] =
              prob(s[i][c], lse_s[r], a.scale, mask && a.causal && row < key,
                   !mask || key < a.Tk);
      }
    }
    pair_dots<D, RS, NS>(s, Gs, Vt, ty, R, tx, hf);  // dP = dO V^T
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + R * i;
#pragma unroll
      for (int c = 0; c < NS; ++c)
        if ((i >> 2) == hf) {
          float* e = dSb + r * PS + tx + 8 * c;
          *e = dscore(*e, s[i][c], dl_s[r], a.scale);
        }
    }
    __syncwarp();  // the warp's dS rows are written
    // dQ += dS K over the block's columns of K.
    half_products<DV, RS, KT>(acc, dSb, Kt + col0, ty, R, tx, hf);
  }
  cp_async_wait_all();  // no copy outlives the block
  store_rows<D, DV>(acc, (float*)a.dq, b, h, a.H, a.Tq, q0, R, ty, tx, hf,
                    col0);
}

// --------------------------------------------------------- f32, dk/dv
template <int D, bool SPLIT>
__global__ void __launch_bounds__(256)
bwd_dkv_fma(const Args a) {
  constexpr int RS = D + 4;
  constexpr int BQ = fma_tile(D), PS = fma_ps(D), NS = BQ / 8;
  constexpr int DV = out_cols(D);  // dk, dv columns from col0 on
  constexpr bool OST = o_staged<float, D, SPLIT>();
  constexpr int SB = qstage_bytes<float>(BQ, RS, OST);
  extern __shared__ __align__(16) uint8_t smem[];
  const int BKV = blockDim.x / 2, R = BKV / 8;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BKV * RS;
  uint8_t* ring = reinterpret_cast<uint8_t*>(Vs + BKV * RS);
  // [BKV][PS]: P^T for dV, then dS^T in its place for dK.
  float* Pt = reinterpret_cast<float*>(ring + STAGES * SB);
  const int tid = threadIdx.x, tx = tid & 7, hf = (tid >> 3) & 1;
  const int ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * BKV, col0 = blockIdx.z * DV;
  const float* qb = head<float>(a.q, a.sq, b, h);
  const float* gb = head<float>(a.g, a.sg, b, h);
  const float* ob = SPLIT ? head<float>(a.o, a.so, b, h) : nullptr;

  // Causal: a q tile whose last row precedes this key tile sees none of it.
  const int q_begin = a.causal ? (k0 / BQ) * BQ : 0;
  const int n_qt = a.Tq > q_begin ? (a.Tq - q_begin + BQ - 1) / BQ : 0;
  load_rows<float, D, RS>(Ks, head<float>(a.k, a.sk, b, h), a.sk.t, k0,
                          a.Tk, BKV, a.aligned);
  load_rows<float, D, RS>(Vs, head<float>(a.v, a.sv, b, h), a.sv.t, k0,
                          a.Tk, BKV, a.aligned);
  if (n_qt > 0)
    load_qstage<float, D, RS, SPLIT, OST>(qstage<float, OST>(ring, BQ, RS),
                                          a, qb, gb, ob, bh, q_begin, BQ);
  cp_async_commit();
  // P^T dO and dS^T Q over this lane's half of every q tile.
  float av[8][DV / 8], ak[8][DV / 8];
  zero_acc<DV>(av);
  zero_acc<DV>(ak);

  for (int j = 0; j < n_qt; ++j) {
    cp_async_wait_all();  // tile j (and K, V) has landed
    __syncthreads();      // ... for every thread; slot (j+1)%2, Pt free
    if (j + 1 < n_qt)
      load_qstage<float, D, RS, SPLIT, OST>(
          qstage<float, OST>(ring + ((j + 1) % STAGES) * SB, BQ, RS), a, qb,
          gb, ob, bh, q_begin + (j + 1) * BQ, BQ);
    cp_async_commit();
    const int q0 = q_begin + j * BQ;
    const QStage<float> st =
        qstage<float, OST>(ring + (j % STAGES) * SB, BQ, RS);
    if (SPLIT) {
      stage_delta<D, OST>(st, BQ, RS, ob, a.so.t, q0, a.Tq);
      __syncthreads();  // the tile's D rows are written
    }
    const bool mask = (a.causal && q0 < k0 + BKV - 1) || q0 + BQ > a.Tq ||
                      k0 + BKV > a.Tk;
    float s[8][NS];
    pair_dots<D, RS, NS>(s, Ks, st.q, ty, R, tx, hf);  // S^T = K Q^T
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + R * i, key = k0 + r;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        const int col = tx + 8 * c, row = q0 + col;
        if ((i >> 2) == hf)
          Pt[r * PS + col] =
              prob(s[i][c], st.lse[col], a.scale,
                   mask && a.causal && row < key,
                   !mask || (row < a.Tq && key < a.Tk));
      }
    }
    __syncwarp();  // the warp's P^T rows are written
    // dV += P^T dO over the block's columns of dO.
    half_products<DV, RS, BQ>(av, Pt, st.g + col0, ty, R, tx, hf);
    pair_dots<D, RS, NS>(s, Vs, st.g, ty, R, tx, hf);  // dP^T = V dO^T
    __syncwarp();  // the warp's P^T rows are read by dV's products
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + R * i;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        const int col = tx + 8 * c;
        if ((i >> 2) == hf) {
          float* e = Pt + r * PS + col;
          *e = dscore(*e, s[i][c], st.dl[col], a.scale);
        }
      }
    }
    __syncwarp();  // the warp's dS^T rows are written
    // dK += dS^T Q over the block's columns of Q.
    half_products<DV, RS, BQ>(ak, Pt, st.q + col0, ty, R, tx, hf);
  }
  cp_async_wait_all();  // no copy outlives the block
  store_rows<D, DV>(ak, (float*)a.dk, b, h, a.H, a.Tk, k0, R, ty, tx, hf,
                    col0);
  store_rows<D, DV>(av, (float*)a.dv, b, h, a.H, a.Tk, k0, R, ty, tx, hf,
                    col0);
}

// ------------------------------------------------------------ wide heads
// D > 256, a multiple of 128 (the wrapper pads other head dims up):
// bwd_dq_wide and bwd_dkv_wide, fused and split (the SPLIT flag, as for
// the narrow kernels), both dtypes. They replace the same TPU kernels as
// the narrow ones (_bwd_dq_fused_kernel, _bwd_dkv_fused_kernel,
// _bwd_dq_kernel, _bwd_dkv_kernel).
//
// What bounds them on the H100 at (1, 1024, 12, 512) causal: the products
// (dq: S, dP, dQ; dk/dv: S, dP, dV, dK) against ~6 (B, T, H, D) arrays of
// traffic: operations in f32 (dq 0.289 ms, dk/dv 0.385 ms at 67
// TFLOP/s); bytes in bf16 for dq (0.0226 ms), operations for dk/dv (0.0261
// ms at 989 TFLOP/s).
//
// Design. A block owns a panel of WP = 512 gradient columns (grid.z =
// ceil(D / WP)); at D <= WP that is every column, so S and dP are computed
// once per (q tile, key tile). The block's own rows stay in shared memory
// at full width for the whole loop (dq: Q and dO; dk/dv: K and V); the
// other side streams in tiles of full width by 16-byte cp.async into a
// two-stage ring (dq: K and V tiles of BK keys; dk/dv: Q and dO tiles of
// BQS rows with their lse and D rows), the next tile loading while this
// one computes (dynamic shared memory, 208-224 KB). Per tile: S and dP
// (for dk/dv S^T and dP^T) into f32 tiles in shared memory; P and dS
// elementwise (prob, dscore: the narrow kernels' helpers), rounded to the
// input dtype and stored for the products that take them; then the
// gradient products in registers.
// bf16: every product on mma.sync m16n8k16 bf16 -> f32 with ldmatrix
// fragments, laid out for shared-memory traffic: half the warps compute S
// (S^T), half dP (dP^T), each over half of D (the halves added in a fixed
// order); a gradient warp owns 32 rows x 128 columns (128 f32 registers a
// lane), each B fragment feeding both 16-row halves. dq: 4 BQ threads, BQ
// = 32 or 64, BK = 16, a score warp 32 rows x 16 keys. dk/dv: 256
// threads, 32 keys, BQS = 32, a score warp 16 keys x 32 q rows; warps 0-3
// own dV and warps 4-7 dK and run at once, so one block holds both for all
// 512 columns (two accumulators of 32 x 512 need 128 registers a lane
// over 256 threads; 64 keys would need 256). f32: IEEE FMAs on the CUDA
// cores, 256 threads, 32 own rows (dq BK = 8, dk/dv BQS = 8): each warp
// sums S or dP over a quarter of D (a lane 4 x 2 entries), the four
// partial tiles added in a fixed order; a thread owns 8 rows x 8 columns
// of each gradient, each float4 of the streamed tile feeding 32 FMAs; the
// dk/dv kernels sit at 255 registers without spilling.
// Above WP columns a block contracts S and dP over the 512-wide panels in
// order (both sides staged one panel at a time, without the ring), then
// stages the streamed tile at its own panel for the gradient products.
// D = rowsum(dO o O) comes from one helper (wide_deltas) in all three
// kernels that need it: split = fused bit for bit. The bits do not depend
// on the plan: streamed tiles are anchored at key 0 (dq) or at the
// 32-row boundary below the block's first key (dk/dv), every element sums
// its products in 16-wide (bf16) or single (f32) steps in order, and
// wholly masked entries add exact zeros.
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W), device ms at
// (1, 1024, 12, 512) causal, f32 / bf16: dq 0.943-0.950 / 0.214-0.216,
// dk/dv 1.099-1.107 / 0.223-0.226 (plain versions 1.42 and 1.67 / 1.57
// and 1.87; SDPA's backward of all three 1.65 / 3.04); split dq as fused,
// split dk/dv 1.256-1.266 / 0.318-0.325, the cost of reading O's rows for
// D on every q tile. The kernels they replaced took 11.2-14.7 / 9.4-12.8
// in the same call.
constexpr int WP = 512;  // gradient columns a block owns; a score panel
constexpr int WIDE_MAX_D = 65535 * 128;  // the wrappers' MAX_HEAD_DIM

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows x WP elements into shared memory (row stride RS): rows t0.. and
// columns c0 .. c0 + width - 1 of a seq-strided tensor; rows >= T_len and
// columns >= width are zero.
template <typename T>
__device__ __forceinline__ void load_panel(T* dst, int RS, const T* src,
                                           long long st, int t0, int T_len,
                                           int rows, int c0, int width,
                                           bool aligned) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CPR = WP / E;
  for (int i = threadIdx.x; i < rows * CPR; i += blockDim.x) {
    const int r = i / CPR, c = (i % CPR) * E, t = t0 + r;
    T* d = dst + r * RS + c;
    const bool ok = t < T_len && c < width;
    if (aligned) {
      cp_async16(d, ok ? src + t * st + c0 + c : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        d[e] = ok ? src[t * st + c0 + c + e] : T(0.f);
    }
  }
}

// A warp's 16 x 8NT tile of A B^T over `width` (a multiple of 16): A's 16
// rows and B's 8NT rows in shared memory (bf16, row stride RS), summed on
// mma.sync in 16-wide steps of d in order.
template <int NT>
__device__ __forceinline__ void mma_scores(float (&c)[NT][4], const bf16* A,
                                           const bf16* B, int RS, int width,
                                           int lane) {
#pragma unroll 2
  for (int kk = 0; kk < width; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, A + (lane & 15) * RS + kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      ldsm_x4(r, B + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * RS + kk +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * np], a, r[0], r[1]);
      mma_bf16(c[2 * np + 1], a, r[2], r[3]);
    }
  }
}

// acc[i][c] += A[RSTEP i] . B[CSTEP c] over d in [d0, d1) (f32, row
// stride RS; A and B point at the lane's first rows), four FMAs a float4
// in d order.
template <int NR, int NC, int RSTEP, int CSTEP>
__device__ __forceinline__ void fma_dots(float (&acc)[NR][NC], const float* A,
                                         const float* B, int RS, int d0,
                                         int d1) {
#pragma unroll 2
  for (int d = d0; d < d1; d += 4) {
    float4 av[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + RSTEP * i * RS + d);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float4 bv =
          *reinterpret_cast<const float4*>(B + CSTEP * c * RS + d);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        float x = fmaf(av[i].x, bv.x, acc[i][c]);
        x = fmaf(av[i].y, bv.y, x);
        x = fmaf(av[i].z, bv.z, x);
        acc[i][c] = fmaf(av[i].w, bv.w, x);
      }
    }
  }
}

// acc[i][4j + e] += sum over u < NK, in order, of W[4i][u] X[u][256j + e]
// (f32; W points at the lane's first row, row stride WS; X at its first
// column, row stride RS): 8 rows 4 apart x columns 4cx .. +3 and 256 +
// 4cx .. +3. Each float4 of X feeds 32 FMAs.
template <int NK>
__device__ __forceinline__ void fma_out(float (&acc)[8][8], const float* W,
                                        int WS, const float* X, int RS) {
#pragma unroll
  for (int u0 = 0; u0 < NK; u0 += 4) {
    float4 wv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      wv[i] = *reinterpret_cast<const float4*>(W + 4 * i * WS + u0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 x0 = *reinterpret_cast<const float4*>(X + (u0 + u) * RS);
      const float4 x1 =
          *reinterpret_cast<const float4*>(X + (u0 + u) * RS + 256);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float w = u == 0 ? wv[i].x
                      : u == 1 ? wv[i].y
                      : u == 2 ? wv[i].z : wv[i].w;
        acc[i][0] = fmaf(w, x0.x, acc[i][0]);
        acc[i][1] = fmaf(w, x0.y, acc[i][1]);
        acc[i][2] = fmaf(w, x0.z, acc[i][2]);
        acc[i][3] = fmaf(w, x0.w, acc[i][3]);
        acc[i][4] = fmaf(w, x1.x, acc[i][4]);
        acc[i][5] = fmaf(w, x1.y, acc[i][5]);
        acc[i][6] = fmaf(w, x1.z, acc[i][6]);
        acc[i][7] = fmaf(w, x1.w, acc[i][7]);
      }
    }
  }
}

// D = rowsum(dO o O) in f32 of `rows` rows from row t0 on, into dl[] (0
// past Tq); row r of dO at gs + r * gst, of O at os + r * ost. A warp takes R rows at a time, a row all 32 lanes: lane l sums
// the 16-byte chunks l, l + 32, ... of the row in order, one FMA an
// element in element order, then five xor shuffles (a + b == b + a: every
// lane gets the same bits). The R rows' loads of O (a 512-wide panel) are
// issued together, dO's where they are consumed; each from a staged tile
// where the kernel has one, else from global memory (the same values).
// 16-byte loads when aligned, else element by element: the same FMAs. Every wide kernel that computes D calls it: split = fused bit for
// bit, whatever R.
template <int R, typename T>
__device__ __forceinline__ void wide_deltas(float* dl, const Args& a,
                                            const T* gs, long long gst,
                                            const T* os, long long ost,
                                            int t0, int rows, int D) {
  constexpr int E = 16 / sizeof(T), NCH = WP / (32 * E);
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r0 = (threadIdx.x >> 5) * R; r0 < rows; r0 += nw * R) {
    float s[R];
    bool valid[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      s[u] = 0.f;
      valid[u] = r0 + u < rows && t0 + r0 + u < a.Tq;
    }
    for (int p0 = 0; p0 < D; p0 += WP) {
      alignas(16) T ov[R][NCH][E];
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int c = p0 + (lane + 32 * i) * E;
          if (!valid[u] || c >= D) continue;
          const T* o = os + (r0 + u) * ost + c;
          if (a.aligned) {
            *reinterpret_cast<uint4*>(ov[u][i]) =
                *reinterpret_cast<const uint4*>(o);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) ov[u][i][e] = o[e];
          }
        }
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int c = p0 + (lane + 32 * i) * E;
          if (!valid[u] || c >= D) continue;
          const T* g = gs + (r0 + u) * gst + c;
          alignas(16) T gv[E];
          if (a.aligned) {
            *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(g);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) gv[e] = g[e];
          }
#pragma unroll
          for (int e = 0; e < E; ++e)
            s[u] = fmaf(to_f32(gv[e]), to_f32(ov[u][i][e]), s[u]);
        }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
#pragma unroll
      for (int m = 1; m < 32; m <<= 1)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], m);
      if (lane == 0 && r0 + u < rows) dl[r0 + u] = s[u];
    }
  }
}

// A warp's 32 x 8NT tile of A B^T over `width` (a multiple of 16): A's 32
// rows (two halves of 16) and B's 8NT rows in shared memory (bf16, row
// stride RS), each B fragment feeding both halves; 16-wide steps of d in
// order.
template <int NT>
__device__ __forceinline__ void mma_scores2(float (&c)[2][NT][4],
                                            const bf16* A, const bf16* B,
                                            int RS, int width, int lane) {
#pragma unroll 2
  for (int kk = 0; kk < width; kk += 16) {
    uint32_t a0[4], a1[4];
    const bf16* Ak = A + (lane & 15) * RS + kk + (lane >> 4) * 8;
    ldsm_x4(a0, Ak);
    ldsm_x4(a1, Ak + 16 * RS);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t r[4];
      ldsm_x4(r, B + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * RS + kk +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(c[0][2 * np], a0, r[0], r[1]);
      mma_bf16(c[0][2 * np + 1], a0, r[2], r[3]);
      mma_bf16(c[1][2 * np], a1, r[0], r[1]);
      mma_bf16(c[1][2 * np + 1], a1, r[2], r[3]);
    }
  }
}

// c[hf] += W[16 hf ..] X for a warp's 32 rows x 8NT columns: W (32 x NK,
// bf16, row stride WS) as A fragments, X (NK x columns, row stride RS) by
// ldmatrix.trans, each B fragment feeding both 16-row halves; column pairs
// of 16 at or past `valid` are skipped.
template <int NT, int NK>
__device__ __forceinline__ void mma_out2(float (&c)[2][NT][4], const bf16* W,
                                         int WS, const bf16* X, int RS,
                                         int valid, int lane) {
#pragma unroll
  for (int kk = 0; kk < NK; kk += 16) {
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, W + (lane & 15) * WS + kk + (lane >> 4) * 8);
    ldsm_x4(a1, W + (16 + (lane & 15)) * WS + kk + (lane >> 4) * 8);
#pragma unroll
    for (int dp = 0; dp < NT / 2; ++dp) {
      if (16 * dp < valid) {  // warp-uniform
        uint32_t r[4];
        ldsm_x4_t(r, X + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                         dp * 16 + (lane >> 4) * 8);
        mma_bf16(c[0][2 * dp], a0, r[0], r[1]);
        mma_bf16(c[0][2 * dp + 1], a0, r[2], r[3]);
        mma_bf16(c[1][2 * dp], a1, r[0], r[1]);
        mma_bf16(c[1][2 * dp + 1], a1, r[2], r[3]);
      }
    }
  }
}

// bf16: a gradient warp owns 32 rows x 128 columns (the block's rows in
// pairs of 16-row halves, columns in quarters of the 512-wide panel).
__device__ __forceinline__ void zero_acc2(float (&c)[2][16][4]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 16; ++n) c[hf][n][0] = c[hf][n][1] = c[hf][n][2] =
        c[hf][n][3] = 0.f;
}
// Rows r0 + 16 hf + g (+8) and columns 128 cq + 8n + 2t of c into a
// contiguous (B, T, H, D) bf16 gradient from column col0 on.
__device__ __forceinline__ void store_acc2(const float (&c)[2][16][4],
                                           bf16* out, int b, int h, int H,
                                           int T, int D, int r0, int col0,
                                           int own, int cq, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 4; ++hr) {
    const int hf = hr >> 1, r = hr & 1, row = r0 + 16 * hf + g + 8 * r;
    if (row >= T) continue;
    bf16* orow = out + (((long long)b * T + row) * H + h) * D + col0;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = 128 * cq + 8 * n + 2 * t;
      if (col < own)
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(c[hf][n][2 * r], c[hf][n][2 * r + 1]);
    }
  }
}
// f32: a thread owns 8 rows (r0 + oy + 4i) x 8 columns (4 ox + 256 j + e).
__device__ __forceinline__ void store_acc8(const float (&c)[8][8], float* out,
                                           int b, int h, int H, int T, int D,
                                           int r0, int col0, int own, int oy,
                                           int ox) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + oy + 4 * i;
    if (row >= T) continue;
    float* orow = out + (((long long)b * T + row) * H + h) * D + col0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 4 * ox + 256 * j;
      if (col < own)
        *reinterpret_cast<float4*>(orow + col) = make_float4(
            c[i][4 * j], c[i][4 * j + 1], c[i][4 * j + 2], c[i][4 * j + 3]);
    }
  }
}

// Tile sizes by dtype (256 threads, 32 own rows; bf16 dq 32 or 64, 4 a
// row). dq: BK keys a streamed tile; dk/dv: BQS q rows a streamed tile.
// RS: the row stride (elements) of the staged tiles; SSQ, SS: of the f32
// S and dP tiles of dq and of dk/dv (bf16, two d halves each); PSQ, PS: of
// the dS (dq) and P^T, dS^T (dk/dv) tiles.
template <typename T>
struct WideBwd {
  static constexpr int BK = 8, BQS = 8, RS = WP + 4;
  static constexpr int SSQ = 0, SS = 0, PSQ = 12, PS = 12;
};
template <>
struct WideBwd<bf16> {
  static constexpr int BK = 16, BQS = 32, RS = WP + 8;
  static constexpr int SSQ = 20, SS = 36, PSQ = 24, PS = 40;
};

// Shared memory: Q and dO; the K/V ring; S and dP over two d halves
// (bf16) or their eight partial tiles (f32); dS; the rows' lse and D.
template <typename T>
__host__ __device__ constexpr int wide_dq_smem(int rows) {
  using C = WideBwd<T>;
  return (int)sizeof(T) * (2 * rows + 4 * C::BK) * C::RS +
         4 * (sizeof(T) == 2 ? 4 * rows * C::SSQ : 8 * rows * C::BK) +
         (int)sizeof(T) * rows * C::PSQ + 8 * rows;
}
// One streamed stage of dk/dv: Q, dO, lse and D rows.
template <typename T>
__host__ __device__ constexpr int wide_dkv_stage() {
  using C = WideBwd<T>;
  return (int)sizeof(T) * 2 * C::BQS * C::RS + 8 * C::BQS;
}
// K and V; two stages; S^T and dP^T over two d halves (bf16) or their
// partials (f32); P^T and dS^T.
template <typename T>
__host__ __device__ constexpr int wide_dkv_smem(int rows) {
  using C = WideBwd<T>;
  return (int)sizeof(T) * 2 * rows * C::RS + 2 * wide_dkv_stage<T>() +
         4 * (sizeof(T) == 2 ? 4 * rows * C::SS : 8 * rows * C::BQS) +
         (int)sizeof(T) * 2 * rows * C::PS;
}

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(256, 1)
bwd_dq_wide(const Args a, int D) {
  using C = WideBwd<T>;
  constexpr bool BF = sizeof(T) == 2;
  constexpr int BK = C::BK, RS = C::RS, PS = C::PSQ, SS = C::SSQ;
  extern __shared__ __align__(16) uint8_t smem[];
  const int BQ = BF ? blockDim.x / 4 : 32;
  T* Qs = reinterpret_cast<T*>(smem);
  T* Gs = Qs + BQ * RS;
  T* ring = Gs + BQ * RS;  // [2][K, V][BK][RS]
  float* Sb = reinterpret_cast<float*>(ring + 4 * BK * RS);
  T* dSs = reinterpret_cast<T*>(Sb + (BF ? 4 * BQ * SS : 8 * BQ * BK));
  float* lse_s = reinterpret_cast<float*>(dSs + BQ * PS);
  float* dl_s = lse_s + BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ, col0 = blockIdx.z * WP;
  const int n_pan = (D + WP - 1) / WP, own = min(WP, D - col0);
  const T* qb = head<T>(a.q, a.sq, b, h);
  const T* kb = head<T>(a.k, a.sk, b, h);
  const T* vb = head<T>(a.v, a.sv, b, h);
  const T* gb = head<T>(a.g, a.sg, b, h);
  const T* ob = head<T>(a.o, a.so, b, h);
  const bool al = a.aligned;
  const int k_end = a.causal ? min(a.Tk, q0 + BQ) : a.Tk;
  const int n_kt = (k_end + BK - 1) / BK;
  auto kslot = [&](int s) { return ring + 2 * s * BK * RS; };
  auto vslot = [&](int s) { return ring + (2 * s + 1) * BK * RS; };

  // Half the warps compute S, half dP. bf16: a warp 32 rows (pair rp) x
  // the BK keys over d half dh; dQ rows 32 rq, columns 128 cq. f32: d
  // quarter warp & 3, a lane rows ry + 8i of keys kx + 4c; dQ rows oy +
  // 4i, columns 4 ox (+256).
  const int WPP = BF ? BQ / 16 : 4;  // warps a product
  const bool is_dp = warp >= WPP;
  const int wp = warp % WPP, dh = wp & 1, rp = wp >> 1;
  const int rq = warp >> 2, cq = warp & 3;
  const int kx = lane & 3, ry = lane >> 2, oy = tid >> 6, ox = tid & 63;
  float sc[BF ? 1 : 4][2];                                // f32
  float sb[BF ? 2 : 1][2][4];                             // bf16
  float acc[BF ? 1 : 8][BF ? 1 : 8];                      // f32 dQ
  float acc2[BF ? 2 : 1][BF ? 16 : 1][4];                 // bf16 dQ
  if constexpr (BF) {
    zero_acc2(acc2);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
  // S or dP over one panel: the A side (Q or dO) and the B side (K or V).
  auto scores_acc = [&](const T* Q, const T* G, const T* K, const T* V,
                        int width) {
    const T* A = is_dp ? G : Q;
    const T* B_ = is_dp ? V : K;
    if constexpr (BF) {
      const int hw = width / 2;
      mma_scores2<2>(sb, A + 32 * rp * RS + dh * hw, B_ + dh * hw, RS, hw,
                     lane);
    } else {
      const int w4 = width / 4, d0 = (warp & 3) * w4;
      fma_dots<4, 2, 8, 4>(sc, A + ry * RS, B_ + kx * RS, RS, d0, d0 + w4);
    }
  };
  auto entry = [&](int which, int r, int k) {  // 0: S, 1: dP
    if constexpr (BF) {
      return Sb[(2 * which * BQ + r) * SS + k] +
             Sb[((2 * which + 1) * BQ + r) * SS + k];
    } else {
      const float* p = Sb + 4 * which * BQ * BK + r * BK + k;
      return ((p[0] + p[BQ * BK]) + p[2 * BQ * BK]) + p[3 * BQ * BK];
    }
  };

  if (n_pan == 1) {
    load_panel<T>(Qs, RS, qb, a.sq.t, q0, a.Tq, BQ, 0, D, al);
    load_panel<T>(Gs, RS, gb, a.sg.t, q0, a.Tq, BQ, 0, D, al);
    if (n_kt > 0) {
      load_panel<T>(kslot(0), RS, kb, a.sk.t, 0, a.Tk, BK, 0, D, al);
      load_panel<T>(vslot(0), RS, vb, a.sv.t, 0, a.Tk, BK, 0, D, al);
    }
    cp_async_commit();
  }
  // D and lse of the block's rows; dO from its staged rows when the block
  // holds them whole.
  if (n_pan == 1) {
    cp_async_wait_all();
    __syncthreads();
    wide_deltas<BF ? 4 : 2, T>(dl_s, a, Gs, RS, ob + q0 * a.so.t, a.so.t,
                               q0, BQ, D);
  } else {
    wide_deltas<BF ? 4 : 2, T>(dl_s, a, gb + q0 * a.sg.t, a.sg.t,
                               ob + q0 * a.so.t, a.so.t, q0, BQ, D);
  }
  __syncthreads();
  const long long r0 = (long long)bh * a.Tq;
  for (int r = tid; r < BQ; r += blockDim.x) {
    const int row = q0 + r;
    lse_s[r] = row < a.Tq ? a.lse[r0 + row] : 0.f;
    if (!SPLIT && blockIdx.z == 0 && row < a.Tq)
      a.delta_out[r0 + row] = dl_s[r];
  }

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * BK;
    if constexpr (BF) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) sb[hf][n][c] = 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
    }
    const int slot = n_pan == 1 ? j & 1 : 0;
    if (n_pan == 1) {
      cp_async_wait_all();  // tile j has landed
      __syncthreads();      // ... for every thread; the other slot is free
      if (j + 1 < n_kt) {
        load_panel<T>(kslot(slot ^ 1), RS, kb, a.sk.t, k0 + BK, a.Tk, BK, 0,
                      D, al);
        load_panel<T>(vslot(slot ^ 1), RS, vb, a.sv.t, k0 + BK, a.Tk, BK, 0,
                      D, al);
      }
      cp_async_commit();
      scores_acc(Qs, Gs, kslot(slot), vslot(slot), D);
    } else {
      for (int p = 0; p < n_pan; ++p) {
        const int w = min(WP, D - p * WP);
        __syncthreads();  // the previous panel or tile has been read
        load_panel<T>(Qs, RS, qb + p * WP, a.sq.t, q0, a.Tq, BQ, 0, w, al);
        load_panel<T>(Gs, RS, gb + p * WP, a.sg.t, q0, a.Tq, BQ, 0, w, al);
        load_panel<T>(kslot(0), RS, kb + p * WP, a.sk.t, k0, a.Tk, BK, 0, w,
                      al);
        load_panel<T>(vslot(0), RS, vb + p * WP, a.sv.t, k0, a.Tk, BK, 0, w,
                      al);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        scores_acc(Qs, Gs, kslot(0), vslot(0), w);
      }
    }
    if constexpr (BF) {
      float* dst = Sb + ((is_dp ? 2 : 0) + dh) * BQ * SS;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dst[(32 * rp + 16 * hf + g + 8 * (c >> 1)) * SS + 8 * n + 2 * t +
                (c & 1)] = sb[hf][n][c];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          Sb[(warp * BQ + ry + 8 * i) * BK + kx + 4 * c] = sc[i][c];
    }
    __syncthreads();  // S and dP are stored; the panel tiles are read
    if (n_pan > 1) {  // K at the block's own panel, for dQ
      load_panel<T>(kslot(0), RS, kb + col0, a.sk.t, k0, a.Tk, BK, 0, own,
                    al);
      cp_async_commit();
      cp_async_wait_all();
    }
    for (int e = tid; e < BQ * BK; e += blockDim.x) {
      const int r = e / BK, k = e % BK, row = q0 + r, key = k0 + k;
      const float p = prob(entry(0, r, k), lse_s[r], a.scale,
                           a.causal && row < key, key < a.Tk);
      dSs[r * PS + k] = from_f32<T>(dscore(p, entry(1, r, k), dl_s[r],
                                           a.scale));
    }
    __syncthreads();  // dS is written
    // dQ += dS K over the block's columns.
    const T* Kt = kslot(slot);
    if constexpr (BF)
      mma_out2<16, BK>(acc2, dSs + 32 * rq * PS, PS, Kt + 128 * cq, RS,
                       own - 128 * cq, lane);
    else
      fma_out<BK>(acc, dSs + oy * PS, PS, Kt + 4 * ox, RS);
  }
  cp_async_wait_all();  // no copy outlives the block

  if constexpr (BF)
    store_acc2(acc2, (bf16*)a.dq, b, h, a.H, a.Tq, D, q0 + 32 * rq, col0,
               own, cq, lane);
  else
    store_acc8(acc, (float*)a.dq, b, h, a.H, a.Tq, D, q0, col0, own, oy, ox);
}

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(256, 1)
bwd_dkv_wide(const Args a, int D) {
  using C = WideBwd<T>;
  constexpr bool BF = sizeof(T) == 2;
  constexpr int BQS = C::BQS, RS = C::RS, PS = C::PS, SS = C::SS;
  constexpr int SB = wide_dkv_stage<T>();
  constexpr int BKV = 32;
  extern __shared__ __align__(16) uint8_t smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BKV * RS;
  uint8_t* ring = reinterpret_cast<uint8_t*>(Vs + BKV * RS);
  float* Sb = reinterpret_cast<float*>(ring + 2 * SB);
  T* Pt = reinterpret_cast<T*>(Sb + (BF ? 4 * BKV * SS : 8 * BKV * BQS));
  T* dSt = Pt + BKV * PS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * BKV, col0 = blockIdx.z * WP;
  const int n_pan = (D + WP - 1) / WP, own = min(WP, D - col0);
  const T* qb = head<T>(a.q, a.sq, b, h);
  const T* kb = head<T>(a.k, a.sk, b, h);
  const T* vb = head<T>(a.v, a.sv, b, h);
  const T* gb = head<T>(a.g, a.sg, b, h);
  const T* ob = SPLIT ? head<T>(a.o, a.so, b, h) : nullptr;
  const bool al = a.aligned;
  const long long r0 = (long long)bh * a.Tq;
  // A stage: Q, dO [BQS][RS], then its lse and D rows.
  auto sq = [&](int s) { return reinterpret_cast<T*>(ring + s * SB); };
  auto sg = [&](int s) { return sq(s) + BQS * RS; };
  auto slse = [&](int s) {
    return reinterpret_cast<float*>(ring + s * SB + 2 * sizeof(T) * BQS * RS);
  };
  auto sdl = [&](int s) { return slse(s) + BQS; };
  // Causal: q tiles are anchored at the BQS-row boundary at or below k0;
  // one whose last row precedes this block's keys sees none of them.
  const int q_begin = a.causal ? (k0 / BQS) * BQS : 0;
  const int n_qt = a.Tq > q_begin ? (a.Tq - q_begin + BQS - 1) / BQS : 0;
  // The stage's lse (and fused D) rows by cp.async.
  auto load_rows_of = [&](int s, int q0) {
    load_row_vals(slse(s), a.lse + r0, q0, a.Tq, BQS);
    if (!SPLIT) load_row_vals(sdl(s), a.delta_in + r0, q0, a.Tq, BQS);
  };

  // Warps 0-3 compute S^T and then own dV, warps 4-7 dP^T and dK. bf16:
  // S^T or dP^T keys 16 kg x the BQS q rows over d half dh; dV or dK all
  // 32 keys x columns 128 cq. f32: d quarter warp & 3, a lane keys ry + 8i
  // of q rows kx + 4c; dV and dK keys oy + 4i, columns 4 ox (+256).
  const bool second = warp >= 4;  // dP^T; dK
  const int kg = (warp & 3) >> 1, dh = warp & 1, cq = warp & 3;
  const int kx = lane & 3, ry = lane >> 2, oy = tid >> 6, ox = tid & 63;
  float sc[BF ? 1 : 4][2];                          // f32
  float sk[BF ? 4 : 1][4];                          // bf16
  float acc[BF ? 1 : 8][BF ? 1 : 8];                // f32 dV
  float acc2[BF ? 1 : 8][BF ? 1 : 8];               // f32 dK
  float accb[BF ? 2 : 1][BF ? 16 : 1][4];           // bf16 dV or dK
  if constexpr (BF) {
    zero_acc2(accb);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = acc2[i][c] = 0.f;
  }
  auto scores_acc = [&](const T* Q, const T* G, int width) {
    const T* A = second ? Vs : Ks;
    const T* B_ = second ? G : Q;
    if constexpr (BF) {
      const int hw = width / 2;
      mma_scores<4>(sk, A + 16 * kg * RS + dh * hw, B_ + dh * hw, RS, hw,
                    lane);
    } else {
      const int w4 = width / 4, d0 = (warp & 3) * w4;
      fma_dots<4, 2, 8, 4>(sc, A + ry * RS, B_ + kx * RS, RS, d0, d0 + w4);
    }
  };
  auto entry = [&](int which, int kr, int qc) {  // 0: S^T, 1: dP^T
    if constexpr (BF) {
      return Sb[(2 * which * BKV + kr) * SS + qc] +
             Sb[((2 * which + 1) * BKV + kr) * SS + qc];
    } else {
      const float* p = Sb + 4 * which * BKV * BQS + kr * BQS + qc;
      return ((p[0] + p[BKV * BQS]) + p[2 * BKV * BQS]) + p[3 * BKV * BQS];
    }
  };

  if (n_pan == 1) {
    load_panel<T>(Ks, RS, kb, a.sk.t, k0, a.Tk, BKV, 0, D, al);
    load_panel<T>(Vs, RS, vb, a.sv.t, k0, a.Tk, BKV, 0, D, al);
    if (n_qt > 0) {
      load_panel<T>(sq(0), RS, qb, a.sq.t, q_begin, a.Tq, BQS, 0, D, al);
      load_panel<T>(sg(0), RS, gb, a.sg.t, q_begin, a.Tq, BQS, 0, D, al);
      load_rows_of(0, q_begin);
    }
    cp_async_commit();
  }

  for (int j = 0; j < n_qt; ++j) {
    const int q0 = q_begin + j * BQS;
    if constexpr (BF) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) sk[n][c] = 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
    }
    const int slot = n_pan == 1 ? j & 1 : 0;
    if (n_pan == 1) {
      cp_async_wait_all();  // tile j has landed
      __syncthreads();      // ... for every thread; the other stage is free
      if (j + 1 < n_qt) {
        load_panel<T>(sq(slot ^ 1), RS, qb, a.sq.t, q0 + BQS, a.Tq, BQS, 0, D,
                      al);
        load_panel<T>(sg(slot ^ 1), RS, gb, a.sg.t, q0 + BQS, a.Tq, BQS, 0, D,
                      al);
        load_rows_of(slot ^ 1, q0 + BQS);
      }
      cp_async_commit();
      // Split: this tile's D from its staged dO and O's rows, read after
      // the next barrier.
      if (SPLIT)
        wide_deltas<BF ? 4 : 1, T>(sdl(slot), a, sg(slot), RS,
                                   ob + q0 * a.so.t, a.so.t, q0, BQS, D);
      scores_acc(sq(slot), sg(slot), D);
    } else {
      __syncthreads();  // the previous tile has been read
      load_rows_of(0, q0);
      if (SPLIT)
        wide_deltas<BF ? 4 : 1, T>(sdl(0), a, gb + q0 * a.sg.t, a.sg.t,
                                   ob + q0 * a.so.t, a.so.t, q0, BQS, D);
      for (int p = 0; p < n_pan; ++p) {
        const int w = min(WP, D - p * WP);
        if (p) __syncthreads();  // panel p-1 has been read
        load_panel<T>(Ks, RS, kb + p * WP, a.sk.t, k0, a.Tk, BKV, 0, w, al);
        load_panel<T>(Vs, RS, vb + p * WP, a.sv.t, k0, a.Tk, BKV, 0, w, al);
        load_panel<T>(sq(0), RS, qb + p * WP, a.sq.t, q0, a.Tq, BQS, 0, w, al);
        load_panel<T>(sg(0), RS, gb + p * WP, a.sg.t, q0, a.Tq, BQS, 0, w, al);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        scores_acc(sq(0), sg(0), w);
      }
    }
    if constexpr (BF) {
      float* dst = Sb + ((second ? 2 : 0) + dh) * BKV * SS;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dst[(16 * kg + g + 8 * (c >> 1)) * SS + 8 * n + 2 * t + (c & 1)] =
              sk[n][c];
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          Sb[(warp * BKV + ry + 8 * i) * BQS + kx + 4 * c] = sc[i][c];
    }
    __syncthreads();  // S^T and dP^T are stored; the panel tiles are read
    if (n_pan > 1) {  // Q and dO at the block's own panel, for dK and dV
      load_panel<T>(sq(0), RS, qb + col0, a.sq.t, q0, a.Tq, BQS, 0, own, al);
      load_panel<T>(sg(0), RS, gb + col0, a.sg.t, q0, a.Tq, BQS, 0, own, al);
      cp_async_commit();
      cp_async_wait_all();
    }
    const float* lse = slse(slot);
    const float* dl = sdl(slot);
    for (int e = tid; e < BKV * BQS; e += blockDim.x) {
      const int kr = e / BQS, qc = e % BQS, key = k0 + kr, row = q0 + qc;
      const float p = prob(entry(0, kr, qc), lse[qc], a.scale,
                           a.causal && row < key, row < a.Tq && key < a.Tk);
      Pt[kr * PS + qc] = from_f32<T>(p);
      dSt[kr * PS + qc] =
          from_f32<T>(dscore(p, entry(1, kr, qc), dl[qc], a.scale));
    }
    __syncthreads();  // P^T and dS^T are written
    // dV += P^T dO and dK += dS^T Q over the block's columns.
    const T* Qt = sq(slot);
    const T* Gt = sg(slot);
    if constexpr (BF) {
      mma_out2<16, BQS>(accb, second ? dSt : Pt, PS,
                        (second ? Qt : Gt) + 128 * cq, RS, own - 128 * cq,
                        lane);
    } else {
      fma_out<BQS>(acc, Pt + oy * PS, PS, Gt + 4 * ox, RS);
      fma_out<BQS>(acc2, dSt + oy * PS, PS, Qt + 4 * ox, RS);
    }
  }
  cp_async_wait_all();  // no copy outlives the block

  if constexpr (BF) {
    store_acc2(accb, (bf16*)(second ? a.dk : a.dv), b, h, a.H, a.Tk, D, k0,
               col0, own, cq, lane);
  } else {
    store_acc8(acc, (float*)a.dv, b, h, a.H, a.Tk, D, k0, col0, own, oy, ox);
    store_acc8(acc2, (float*)a.dk, b, h, a.H, a.Tk, D, k0, col0, own, oy,
               ox);
  }
}

// The plans' row heights: dq bf16 32 or 64, f32 32; dk/dv 32.
bool wide_rows_ok(bool dq, int dtype, int rows) {
  return dq && dtype == 1 ? rows == 32 || rows == 64 : rows == 32;
}

int wide_smem(bool dq, int dtype, int rows) {
  if (dq) return dtype == 1 ? wide_dq_smem<bf16>(rows)
                            : wide_dq_smem<float>(rows);
  return dtype == 1 ? wide_dkv_smem<bf16>(rows) : wide_dkv_smem<float>(rows);
}

// ------------------------------------------------------------- launch
// Dynamic shared memory of one block, from the plan's `rows` (q rows of a
// dq block, key rows of a dk/dv block) at the kernels' padded strides. A
// size above the card's per-block limit fails the launch
// (cudaFuncSetAttribute), so no plan can overrun it.
int dq_smem(int dtype, int D, int rows) {
  if (dtype == 1)  // Q, dO; the K/V ring (O in slot 1)
    return 2 * (D + 8) * (2 * rows + 2 * STAGES * mma_tile(D));
  // Q, dO; the K/V ring (O in slot 1); P / dS rows; lse and D rows
  return 4 * ((D + 4) * (2 * rows + 2 * STAGES * fma_tile(D)) +
              rows * fma_ps(D) + 2 * rows);
}
int dkv_smem(int dtype, int D, int rows, int split) {
  if (dtype == 1) {  // K, V; the q-tile ring
    const int RS = D + 8, BQ = mma_tile(D);
    return 2 * 2 * rows * RS + STAGES * qstage_bytes<bf16>(BQ, RS, split);
  }
  const int RS = D + 4;  // K, V; the q-tile ring; P^T / dS^T rows
  return 4 * 2 * rows * RS +
         STAGES * qstage_bytes<float>(fma_tile(D), RS, split && D < 128) +
         4 * rows * fma_ps(D);
}

using Kernel = void (*)(const Args);

template <int D, bool SPLIT>
Kernel pick(bool dq, int dtype) {
  if (dq) return dtype == 1 ? bwd_dq_mma<D, SPLIT> : bwd_dq_fma<D, SPLIT>;
  return dtype == 1 ? bwd_dkv_mma<D, SPLIT> : bwd_dkv_fma<D, SPLIT>;
}

template <bool SPLIT>
Kernel pick_d(bool dq, int dtype, int D) {
  switch (D) {
    case 32: return pick<32, SPLIT>(dq, dtype);
    case 64: return pick<64, SPLIT>(dq, dtype);
    case 128: return pick<128, SPLIT>(dq, dtype);
    case 256: return pick<256, SPLIT>(dq, dtype);
    default: return nullptr;
  }
}

using WideKernel = void (*)(const Args, int);

template <typename T>
WideKernel pick_wide_t(bool dq, bool split) {
  if (dq) return split ? bwd_dq_wide<T, true> : bwd_dq_wide<T, false>;
  return split ? bwd_dkv_wide<T, true> : bwd_dkv_wide<T, false>;
}
WideKernel pick_wide(bool dq, bool split, int dtype) {
  return dtype == 1 ? pick_wide_t<bf16>(dq, split)
                    : pick_wide_t<float>(dq, split);
}

// tensors: q, k, v, o, g (nullptr where the kernel takes none); `strides`
// holds (batch, seq, head) of each non-null tensor in that order.
int launch(bool dq, bool split, const void* const* tensors,
           const long long* strides, const void* lse, const void* delta,
           void* out0, void* out1, int B, int H, int Tq, int Tk, int D,
           int dtype, int causal, int rows, float scale, void* stream) {
  // Narrow: 16 rows a warp in bf16 (at most 4 warps), 8 a lane pair in
  // f32 (at most 8 warps). Wide (D > 256): the plans' heights.
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool wide = D > 256;
  const Kernel kern = split ? pick_d<true>(dq, dtype, D)
                            : pick_d<false>(dq, dtype, D);
  if (wide ? !wide_rows_ok(dq, dtype, rows) || D % 128 || D > WIDE_MAX_D
           : kern == nullptr ||
                 (rows != 32 && rows != 64 && !(dtype == 0 && rows == 128)))
    return (int)cudaErrorInvalidValue;
  const int esz = dtype == 1 ? 2 : 4;
  Args a{};
  Strides* st[5] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sg};
  bool aligned = true;
  for (int i = 0, n = 0; i < 5; ++i) {
    if (tensors[i] == nullptr) continue;
    const long long* s = strides + 3 * n++;
    *st[i] = Strides{s[0], s[1], s[2]};
    aligned = aligned && (uintptr_t)tensors[i] % 16 == 0 &&
              (s[0] * esz) % 16 == 0 && (s[1] * esz) % 16 == 0 &&
              (s[2] * esz) % 16 == 0;
  }
  a.q = tensors[0];
  a.k = tensors[1];
  a.v = tensors[2];
  a.o = tensors[3];
  a.g = tensors[4];
  a.lse = (const float*)lse;
  if (dq) {
    a.dq = out0;
    a.delta_out = (float*)delta;
  } else {
    a.dk = out0;
    a.dv = out1;
    a.delta_in = (const float*)delta;
  }
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.causal = causal;
  a.aligned = aligned;
  a.scale = scale;
  if (wide) {
    const WideKernel wk = pick_wide(dq, split, dtype);
    const int smem = wide_smem(dq, dtype, rows);
    const cudaError_t err = cudaFuncSetAttribute(
        wk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    // bf16: a dq warp per 16 q rows of S and of dP, a dk/dv warp per 16
    // keys of S^T, dP^T, dV and dK; f32: 8 warps.
    const int threads = dtype == 0 ? 256 : (dq ? 4 : 8) * rows;
    const dim3 grid(B * H, ((dq ? Tq : Tk) + rows - 1) / rows,
                    (D + WP - 1) / WP);
    wk<<<grid, threads, smem, (cudaStream_t)stream>>>(a, D);
    return (int)cudaGetLastError();
  }
  const int smem = dq ? dq_smem(dtype, D, rows)
                      : dkv_smem(dtype, D, rows, split);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, ((dq ? Tq : Tk) + rows - 1) / rows, D / out_cols(D));
  kern<<<grid, 2 * rows, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry: tensors (B, T, H, D) with unit stride over D; `strides`
// points to int64 element strides, (batch, seq, head) of each input
// tensor in the order named; lse (and delta) contiguous (B*H, Tq) f32;
// gradients written contiguous (B, T, H, D) in the input dtype. D: 32, 64,
// 128, 256 or a multiple of 128 above 256 (the wide-head kernels; the
// wrapper pads other head dims). dtype: 0 = float32, 1 = bfloat16. rows
// (32, 64, or 128 in f32 at D <= 64; above 256: 32, or 64 for bf16 dq):
// the launch plan's
// q rows a dq block or key rows a dk/dv block owns
// (ops/flash_attention.py::_flash_bwd_plan). scale: 1/sqrt of the head dim
// before padding. Returns cudaGetLastError() after the launch (0 on
// success).

// Fused dq: strides of q, k, v, o, g (= dO). Writes dq and
// delta = rowsum(dO o O).
int tpuflow_flash_bwd_dq(const void* q, const void* k, const void* v,
                         const void* o, const void* g, const void* lse,
                         void* dq, void* delta, int B, int H, int Tq, int Tk,
                         int D, int dtype, int causal, int rows,
                         float scale, const void* strides, void* stream) {
  const void* t[5] = {q, k, v, o, g};
  return launch(true, false, t, (const long long*)strides, lse, delta, dq,
                nullptr, B, H, Tq, Tk, D, dtype, causal, rows, scale, stream);
}

// Fused dk/dv: strides of q, k, v, g (= dO); reads lse and delta, never O.
int tpuflow_flash_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dk, void* dv, int B, int H, int Tq, int Tk,
                          int D, int dtype, int causal, int rows,
                          float scale, const void* strides, void* stream) {
  const void* t[5] = {q, k, v, nullptr, g};
  return launch(false, false, t, (const long long*)strides, lse, delta, dk,
                dv, B, H, Tq, Tk, D, dtype, causal, rows, scale, stream);
}

// Split dq: as tpuflow_flash_bwd_dq, no delta written.
int tpuflow_flash_bwd_dq_split(const void* q, const void* k, const void* v,
                               const void* o, const void* g, const void* lse,
                               void* dq, int B, int H, int Tq, int Tk, int D,
                               int dtype, int causal, int rows,
                               float scale, const void* strides,
                               void* stream) {
  const void* t[5] = {q, k, v, o, g};
  return launch(true, true, t, (const long long*)strides, lse, nullptr, dq,
                nullptr, B, H, Tq, Tk, D, dtype, causal, rows, scale, stream);
}

// Split dk/dv: strides of q, k, v, o, g (= dO); D recomputed from O and dO
// on every q tile.
int tpuflow_flash_bwd_dkv_split(const void* q, const void* k, const void* v,
                                const void* o, const void* g, const void* lse,
                                void* dk, void* dv, int B, int H, int Tq,
                                int Tk, int D, int dtype, int causal,
                                int rows, float scale, const void* strides,
                                void* stream) {
  const void* t[5] = {q, k, v, o, g};
  return launch(false, true, t, (const long long*)strides, lse, nullptr, dk,
                dv, B, H, Tq, Tk, D, dtype, causal, rows, scale, stream);
}

// The dynamic shared memory bytes a launch takes: kernel 0 = dq, 1 = dk/dv
// (the card tests hold it to the per-block limit).
int tpuflow_flash_bwd_smem(int kernel, int split, int dtype, int D,
                           int rows) {
  if (D > 256) return wide_smem(kernel == 0, dtype, rows);
  return kernel == 0 ? dq_smem(dtype, D, rows)
                     : dkv_smem(dtype, D, rows, split);
}

const char* tpuflow_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
