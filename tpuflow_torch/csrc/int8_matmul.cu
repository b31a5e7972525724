// Fused W8A8 int8 matmul for Hopper (sm_90a) on the int8 tensor cores:
// quantize x per row, int8 x int8 -> int32 over K, dequant epilogue.
//
// Replaces: tpuflow/ops/int8_matmul.py::_pallas_int8_matmul, the Pallas
// kernel _int8_matmul_kernel. Same contract, bit for bit against the plain
// version (_plain_int8_matmul in ops/int8_matmul.py):
//   s   = __fdiv_rn(amax_k |x[m, k]|, 127)  (1/127 for a row of zeros)
//   xq  = clip(rintf(__fdiv_rn(x, s[m])), -127, 127)     (IEEE division,
//         round half to even: no fast math anywhere in this file)
//   acc = sum_k xq[m, k] * wq[k, n]                         (exact int32)
//   out = __fmul_rn(__fmul_rn((float)acc, s[m]), ws[n])    (that order, no
//         fused multiply-add)
// A decode call (M <= 16) launches one kernel, which computes its rows'
// scales itself; a prefill call two: the row scale pass (row_scale_kernel)
// and the product. The integer sum is exact in any order, so the split of
// K across blocks, the atomics that combine it and the order of k inside a
// tensor-core step change no output bit.
//
// What bounds it on the H100: the serving path calls it at M = 8 (decode)
// and M = a prefill bucket width (16..1023), with K, N = 768..3072 and the
// 50257-row LM head. At M = 8 every weight byte is used for 16 int ops, far
// below the ~590 ops/byte the int8 tensor cores need: it is bound by the
// bytes of the int8 weight stream, and at these sizes (0.6-2.4 MB a Dense
// layer) by the latency of getting them all in flight. At M = 512 it is
// bound by operations.
//
// Design. Both tiles swap the operands of mma.sync m16n8k32 s8.s8.s32: the
// weights are the A operand (16 output channels per m16 tile, 8 such tiles
// = 128 channels per block), the quantized activations the B operand (8
// rows per n8 tile). Weights are staged by 16-byte cp.async "pieces", each
// lane's own: in the (N, K) layout of the LM head a piece is 16 k of one
// channel; in the (K, N) layout of the Dense kernels (N contiguous, while
// int8 mma takes only row.col, K contiguous in both operands) a piece is 16
// channels of one k, and the lane turns 4x4 byte blocks around in
// registers (__byte_perm) before they enter the tensor core. The leaves stay
// in the JAX layout; no transposed copy is stored. Which k feeds which
// fragment slot is permuted so that every lane's pieces are contiguous; the
// activations are staged in the same permutation.
// - Decode tile (M <= 16): one block per 128 channels and piece of K; its 4
//   warps take the piece's 64-wide k chunks in turn, each through a private
//   cp.async ring of up to 4 stages (no barrier in the k loop), and add
//   their sums in shared memory. Where the 128-channel tiles leave the 132
//   SMs short of about two blocks each, K is split across blocks: the
//   int32 partials go to a scratch by atomicAdd and the last block of a
//   tile (a counter per tile) runs the epilogue and zeroes scratch and
//   counter for the next call.
// - Prefill tile (M > 16): one block per 64 rows x 128 channels (2 x 2
//   warps of 32 x 64), a two-stage cp.async ring for the weight tile, the x
//   tile prefetched into registers and quantized into shared memory at each
//   k step (the int8 activations never reach device memory). The block's
//   sums pass through shared memory so that the output is written row by
//   row (fragment order scattered the stores over 32-byte sectors). It
//   walks all of K: a split of K ran slower here on the H100.
// Ragged M, K and N are zero-filled: a zero adds nothing to the integer
// sum. Rows whose length is not a multiple of 16 bytes, or a base pointer
// that is not 16-byte aligned, take a masked byte-wise staging path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK_K = 64;   // k per stage: two m16n8k32 steps
constexpr int TILE_N = 128;   // output channels per block: 8 m16 tiles
constexpr int THREADS = 128;  // 4 warps
constexpr int PIECES = 16;    // 16-byte pieces per lane per stage
constexpr int STAGE_BYTES = PIECES * 32 * 16;
constexpr int PREFILL_BM = 64;                 // x rows per prefill block
constexpr int PREFILL_MT = PREFILL_BM / 8;     // n8 tiles of x rows
constexpr int X_STAGE_WORDS = 2 * PREFILL_MT * 32 * 2;
constexpr int CS = TILE_N + 1;  // row stride of an int32 output tile in smem

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most stages-1 groups are in flight (one group per stage).
__device__ __forceinline__ void cp_async_wait_stages(int stages) {
  switch (stages) {
    case 1: cp_async_wait<0>(); break;
    case 2: cp_async_wait<1>(); break;
    case 3: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows r0..r3 hold 4 bytes (4 channels) of k+0..k+3; o0..o3 hold the 4 k
// of channel 0..3, byte i = k+i.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1,
                                           uint32_t r2, uint32_t r3,
                                           uint32_t& o0, uint32_t& o1,
                                           uint32_t& o2, uint32_t& o3) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  o0 = __byte_perm(t0, t2, 0x5410);
  o1 = __byte_perm(t0, t2, 0x7632);
  o2 = __byte_perm(t1, t3, 0x5410);
  o3 = __byte_perm(t1, t3, 0x7632);
}

// Output channel (within the block's 128) of row-half r (0: fragment row g,
// 1: row g + 8) of m16 tile j, for the lane of group g.
template <bool CL>
__device__ __forceinline__ int n_local(int j, int r, int g) {
  return CL ? 16 * j + g + 8 * r : 16 * g + 2 * j + r;
}

// Stage one 16-byte weight piece of lane `lane` for the chunk at k = kb of
// the channel tile at n = nb. (N, K) layout: piece 2j + r is channel
// n_local(j, r, g), k = kb + 16t .. +15. (K, N) layout: piece p is
// k = kb + 16t + p, channels 16g .. 16g + 15. Out of range bytes are 0.
template <bool CL>
__device__ __forceinline__ void load_piece(uint8_t* stage, int piece,
                                           int lane, const int8_t* w, int K,
                                           int N, int nb, int kb,
                                           bool aligned) {
  const int g = lane >> 2, t = lane & 3;
  long long off;
  int valid;
  if (CL) {
    const int n = nb + n_local<true>(piece >> 1, piece & 1, g);
    const int k = kb + 16 * t;
    valid = n < N ? K - k : 0;
    off = (long long)n * K + k;
  } else {
    const int k = kb + 16 * t + piece;
    const int n = nb + 16 * g;
    valid = k < K ? N - n : 0;
    off = (long long)k * N + n;
  }
  valid = max(0, min(valid, 16));
  uint8_t* dst = stage + (piece * 32 + lane) * 16;
  if (aligned) {
    cp_async16(dst, valid > 0 ? w + off : w, valid);
  } else {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      dst[b] = b < valid ? (uint8_t)w[off + b] : (uint8_t)0;
  }
}

// A fragments of m16 tiles [2 jp0, 2 jp0 + 2 NJP) for k step s, (K, N)
// layout: the lane's pieces 8s .. 8s+7 (k rows), words jp0 .. jp0+NJP-1
// (4 channels each), turned around 4x4 bytes at a time.
template <int NJP>
__device__ __forceinline__ void a_frags_kn(const uint8_t* stage, int lane,
                                           int s, int jp0,
                                           uint32_t (&a)[2 * NJP][4]) {
  uint32_t wd[8][NJP];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const uint8_t* p = stage + ((8 * s + r) * 32 + lane) * 16 + 4 * jp0;
    if constexpr (NJP == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      wd[r][0] = v.x; wd[r][1] = v.y; wd[r][2] = v.z; wd[r][3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      wd[r][0] = v.x; wd[r][1] = v.y;
    }
  }
#pragma unroll
  for (int q = 0; q < NJP; ++q) {
    uint32_t lo[4], hi[4];
    transpose4(wd[0][q], wd[1][q], wd[2][q], wd[3][q], lo[0], lo[1], lo[2],
               lo[3]);
    transpose4(wd[4][q], wd[5][q], wd[6][q], wd[7][q], hi[0], hi[1], hi[2],
               hi[3]);
    a[2 * q][0] = lo[0]; a[2 * q][1] = lo[1];
    a[2 * q][2] = hi[0]; a[2 * q][3] = hi[1];
    a[2 * q + 1][0] = lo[2]; a[2 * q + 1][1] = lo[3];
    a[2 * q + 1][2] = hi[2]; a[2 * q + 1][3] = hi[3];
  }
}

// A fragments of m16 tiles [j0, j0 + NJ) for k step s, (N, K) layout:
// pieces 2j (row g) and 2j + 1 (row g + 8), words 2s and 2s + 1.
template <int NJ>
__device__ __forceinline__ void a_frags_nk(const uint8_t* stage, int lane,
                                           int s, int j0,
                                           uint32_t (&a)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int p = 2 * (j0 + j);
    const uint2 v0 = *reinterpret_cast<const uint2*>(
        stage + (p * 32 + lane) * 16 + 8 * s);
    const uint2 v1 = *reinterpret_cast<const uint2*>(
        stage + ((p + 1) * 32 + lane) * 16 + 8 * s);
    a[j][0] = v0.x; a[j][1] = v1.x; a[j][2] = v0.y; a[j][3] = v1.y;
  }
}

__device__ __forceinline__ uint32_t quant4(float4 v, float s) {
  auto q = [s](float x) {
    const float r = rintf(__fdiv_rn(x, s));
    return (uint32_t)((int)fminf(fmaxf(r, -127.f), 127.f) & 0xff);
  };
  return q(v.x) | (q(v.y) << 8) | (q(v.z) << 16) | (q(v.w) << 24);
}

__device__ __forceinline__ float4 load_x4(const float* x, int m, int k,
                                          int M, int K, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (m >= M || k >= K) return v;
  const float* p = x + (long long)m * K + k;
  if (vec) return *reinterpret_cast<const float4*>(p);  // K % 4 == 0
  v.x = p[0];
  if (k + 1 < K) v.y = p[1];
  if (k + 2 < K) v.z = p[2];
  if (k + 3 < K) v.w = p[3];
  return v;
}

// Word index in the staged activations of the 4 quantized k at k-in-chunk
// kk (a multiple of 4) of local row m, in B-fragment order: [chunk][step]
// [n8 tile][lane][reg], reg 0 = k + 0..3, reg 1 = k + 4..7 of the lane's
// 8 k (kb + 16t + 8s .. +7), the same permutation as the weight pieces.
__device__ __forceinline__ int x_word(int c, int mt_count, int m, int kk) {
  const int s = (kk >> 3) & 1, t = kk >> 4, half = (kk >> 2) & 1;
  return ((((c * 2 + s) * mt_count + (m >> 3)) * 32 + (m & 7) * 4 + t) * 2) +
         half;
}

__device__ __forceinline__ float epilogue(int acc, float s, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s), ws);
}

// After every block of a tile added its partial sums to scratch: the last
// one to arrive writes the tile's outputs and leaves scratch and counter
// at zero for the next call.
__device__ void finish_split_tile(int* scratch, int* counters, int tile,
                                  int splits, float* out, const float* s_s,
                                  const float* ws, int ws_stride, int rows,
                                  int nb, int M, int N) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[tile], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < rows * TILE_N; i += blockDim.x) {
    const int m = i / TILE_N, n = nb + i % TILE_N;
    if (m >= M || n >= N) continue;
    int* p = scratch + (long long)m * N + n;
    out[(long long)m * N + n] =
        epilogue(__ldcg(p), s_s[m], ws[(long long)n * ws_stride]);
    __stcg(p, 0);
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

// The row scale amax / 127 (1/127 for a row of zeros) of one row of K
// floats, by one warp: 8 float4 loads a lane in flight at a time. Every
// lane returns it.
__device__ __forceinline__ float warp_row_scale(const float* r, int K,
                                                bool vec) {
  const int lane = threadIdx.x & 31;
  float a = 0.f;
  const int n4 = vec ? K / 4 : 0;
  for (int base = 0; base < n4; base += 32 * 8) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + 32 * u + lane;
      v[u] = i < n4 ? reinterpret_cast<const float4*>(r)[i]
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      a = fmaxf(a, fmaxf(fmaxf(fabsf(v[u].x), fabsf(v[u].y)),
                         fmaxf(fabsf(v[u].z), fabsf(v[u].w))));
  }
  for (int k = 4 * n4 + lane; k < K; k += 32) a = fmaxf(a, fabsf(r[k]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  return __fdiv_rn(a > 0.f ? a : 1.f, 127.f);
}

// The prefill tile's scale pass: s[m] for every row, one warp a row.
__global__ void row_scale_kernel(const float* __restrict__ x,
                                 float* __restrict__ s, int M, int K,
                                 int x_vec) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= M) return;
  const float sc = warp_row_scale(x + (long long)row * K, K, x_vec);
  if ((threadIdx.x & 31) == 0) s[row] = sc;
}

template <bool CL, int MT>
__global__ void __launch_bounds__(THREADS)
int8_decode_kernel(const float* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ ws, int ws_stride,
                   float* __restrict__ out, int* scratch, int* counters,
                   int M, int K, int N, int cps, int stages, int aligned,
                   int x_vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = blockIdx.x * TILE_N;
  const int splits = gridDim.y;
  const int n_chunks = (K + CHUNK_K - 1) / CHUNK_K;
  const int c_lo = blockIdx.y * cps;
  const int nc = min(c_lo + cps, n_chunks) - c_lo;
  // [rings, then the 4 warps' sums] [x staged] [row scales]
  uint8_t* ring = smem + warp * stages * STAGE_BYTES;
  uint32_t* Xs = reinterpret_cast<uint32_t*>(smem + 4 * stages * STAGE_BYTES);
  float* s_s = reinterpret_cast<float*>(Xs + cps * 2 * MT * 32 * 2);

  // This warp's chunks: warp, warp + 4, ... of the block's piece of K.
  const int nw = warp < nc ? (nc - warp + 3) / 4 : 0;
  for (int i = 0; i < stages; ++i) {
    if (i < nw) {
      const int kb = (c_lo + warp + 4 * i) * CHUNK_K;
#pragma unroll
      for (int p = 0; p < PIECES; ++p)
        load_piece<CL>(ring + i * STAGE_BYTES, p, lane, w, K, N, nb, kb,
                       aligned);
    }
    cp_async_commit();
  }
  // The row scales, while the weights are in flight: each block reads its
  // (at most 16) rows whole, one warp a row.
  for (int m = warp; m < 8 * MT; m += 4) {
    const float sc = m < M ? warp_row_scale(x + (long long)m * K, K, x_vec)
                           : 1.f;
    if (lane == 0) s_s[m] = sc;
  }
  __syncthreads();
  // Quantize the block's rows over its piece of K into shared memory.
  for (int i = tid; i < 8 * MT * nc * 16; i += THREADS) {
    const int m = i / (nc * 16), c = (i / 16) % nc, kk = 4 * (i % 16);
    const float4 v = load_x4(x, m, (c_lo + c) * CHUNK_K + kk, M, K, x_vec);
    Xs[x_word(c, MT, m, kk)] = quant4(v, s_s[m]);
  }
  __syncthreads();

  int acc[8][MT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][mi][c] = 0;

  for (int i = 0; i < nw; ++i) {
    cp_async_wait_stages(stages);  // chunk i has landed (this lane's pieces)
    const uint8_t* st = ring + (i % stages) * STAGE_BYTES;
    const int c = warp + 4 * i;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t b[MT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const uint2 v = reinterpret_cast<const uint2*>(
            Xs)[((c * 2 + s) * MT + mi) * 32 + lane];
        b[mi][0] = v.x;
        b[mi][1] = v.y;
      }
      uint32_t a[8][4];
      if constexpr (CL)
        a_frags_nk<8>(st, lane, s, 0, a);
      else
        a_frags_kn<4>(st, lane, s, 0, a);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          mma_s8(acc[j][mi], a[j], b[mi][0], b[mi][1]);
    }
    if (i + stages < nw) {  // refill the slot just read
      const int kb = (c_lo + warp + 4 * (i + stages)) * CHUNK_K;
#pragma unroll
      for (int p = 0; p < PIECES; ++p)
        load_piece<CL>(ring + (i % stages) * STAGE_BYTES, p, lane, w, K, N,
                       nb, kb, aligned);
    }
    cp_async_commit();
  }

  // Add the 4 warps' sums (the rings' space is free now), in fragment
  // order: a thread's 16-byte stores and loads, no bank conflicts.
  constexpr int E = 8 * MT * 128;
  __syncthreads();
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      *reinterpret_cast<int4*>(&red[warp * E + (j * MT + mi) * 128 +
                                    lane * 4]) =
          make_int4(acc[j][mi][0], acc[j][mi][1], acc[j][mi][2],
                    acc[j][mi][3]);
  __syncthreads();
  for (int e = tid; e < E; e += THREADS) {
    const int v = red[e] + red[E + e] + red[2 * E + e] + red[3 * E + e];
    const int c = e & 3, ln = (e >> 2) & 31, jm = e >> 7;
    const int m = (jm % MT) * 8 + 2 * (ln & 3) + (c & 1);
    const int n = nb + n_local<CL>(jm / MT, c >> 1, ln >> 2);
    if (m >= M || n >= N) continue;
    if (splits == 1)
      out[(long long)m * N + n] =
          epilogue(v, s_s[m], ws[(long long)n * ws_stride]);
    else
      atomicAdd(&scratch[(long long)m * N + n], v);
  }
  if (splits > 1)
    finish_split_tile(scratch, counters, blockIdx.x, splits, out, s_s, ws,
                      ws_stride, 8 * MT, nb, M, N);
}

template <bool CL>
__global__ void __launch_bounds__(THREADS)
int8_prefill_kernel(const float* __restrict__ x, const float* __restrict__ s,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ ws, int ws_stride,
                    float* __restrict__ out, int M, int K, int N, int aligned,
                    int x_vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  // [weight ring (2 stages), x tiles (2) | the output tile] [row scales]
  constexpr int REGION = 2 * STAGE_BYTES + 2 * X_STAGE_WORDS * 4 >
                                 PREFILL_BM * CS * 4
                             ? 2 * STAGE_BYTES + 2 * X_STAGE_WORDS * 4
                             : PREFILL_BM * CS * 4;
  uint8_t* Ws = smem;
  uint32_t* Xs = reinterpret_cast<uint32_t*>(smem + 2 * STAGE_BYTES);
  float* s_s = reinterpret_cast<float*>(smem + REGION);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wn = warp & 1, wm = warp >> 1;  // 64 channels x 32 rows each
  const int nb = blockIdx.x * TILE_N, m0 = blockIdx.y * PREFILL_BM;
  const int nc = (K + CHUNK_K - 1) / CHUNK_K;

  auto load_w = [&](int c, int slot) {
    const int kb = c * CHUNK_K;
#pragma unroll
    for (int i = 0; i < PIECES / 4; ++i)
      load_piece<CL>(Ws + slot * STAGE_BYTES, warp + 4 * i, lane, w, K, N,
                     nb, kb, aligned);
  };
  // Each thread holds 8 groups of 4 consecutive k of the next x tile.
  float4 xr[8];
  auto fetch_x = [&](int c) {
    const int kb = c * CHUNK_K;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = tid + THREADS * i;
      xr[i] = load_x4(x, m0 + (q >> 4), kb + 4 * (q & 15), M, K, x_vec);
    }
  };
  auto store_x = [&](int slot) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = tid + THREADS * i, m = q >> 4, kk = 4 * (q & 15);
      Xs[x_word(slot, PREFILL_MT, m, kk)] = quant4(xr[i], s_s[m]);
    }
  };

  if (tid < PREFILL_BM) s_s[tid] = m0 + tid < M ? s[m0 + tid] : 1.f;
  load_w(0, 0);
  cp_async_commit();
  fetch_x(0);
  __syncthreads();
  store_x(0);

  int acc[4][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][mi][c] = 0;

  for (int c = 0; c < nc; ++c) {
    const int slot = c & 1;
    if (c + 1 < nc) {
      load_w(c + 1, slot ^ 1);
      fetch_x(c + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk c's weights and x tile are in shared memory
    const uint8_t* st = Ws + slot * STAGE_BYTES;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint2 v = reinterpret_cast<const uint2*>(
            Xs)[((slot * 2 + s) * PREFILL_MT + 4 * wm + mi) * 32 + lane];
        b[mi][0] = v.x;
        b[mi][1] = v.y;
      }
      uint32_t a[4][4];
      if constexpr (CL)
        a_frags_nk<4>(st, lane, s, 4 * wn, a);
      else
        a_frags_kn<2>(st, lane, s, 2 * wn, a);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          mma_s8(acc[j][mi], a[j], b[mi][0], b[mi][1]);
    }
    if (c + 1 < nc) store_x(slot ^ 1);
    __syncthreads();  // the slots of chunk c are free again
  }

  // The block's sums into a [row][channel] tile (the ring's space is free
  // after the loop's last barrier), then written row by row.
  int* Cs = reinterpret_cast<int*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Cs[((4 * wm + mi) * 8 + 2 * t + (c & 1)) * CS +
           n_local<CL>(4 * wn + j, c >> 1, g)] = acc[j][mi][c];
  __syncthreads();
  // Row by row: a warp's stores cover consecutive channels of one row.
  for (int i = tid; i < PREFILL_BM * TILE_N; i += THREADS) {
    const int ml = i / TILE_N, nl = i % TILE_N, m = m0 + ml, n = nb + nl;
    if (m < M && n < N)
      out[(long long)m * N + n] =
          epilogue(Cs[ml * CS + nl], s_s[ml], ws[(long long)n * ws_stride]);
  }
}

// Dynamic shared memory of one block: the layouts the kernels above carve
// out of it. The launch refuses a size above the card's per-block limit
// (cudaFuncSetAttribute fails), so no plan can overrun it.
int decode_smem(int mt, int cps, int stages) {
  // [K rings, then the 4 warps' sums] [x staged] [row scales]
  return 4 * stages * STAGE_BYTES + cps * 2 * mt * 32 * 8 + 16 * 4;
}
int prefill_smem() {
  // [weight ring, x tiles | the output tile] [row scales]
  return max(2 * STAGE_BYTES + 2 * X_STAGE_WORDS * 4, PREFILL_BM * CS * 4) +
         PREFILL_BM * 4;
}
int smem_bytes(int tile, int M, int cps, int stages) {
  return tile == 0 ? decode_smem(M <= 8 ? 1 : 2, cps, stages)
                   : prefill_smem();
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// x: (M, K) float32 contiguous; w: int8, (K, N) or (N, K) when
// w_contract_last, contiguous; ws: float32, element n at n * ws_stride;
// s: (M,) float32 written with the row scales (prefill tile; unused by
// the decode tile, which keeps them in shared memory); out: (M, N) float32;
// scratch: (M, N) int32 and counters: one int32 per 128-channel tile, both
// zero (used when splits > 1, left zero). The plan's decisions come from
// ops/int8_matmul.py::_int8_plan: tile (0 = decode, M <= 16; 1 = prefill),
// splits of K and cps (64-wide k chunks per split), stages (the decode
// ring's depth); the prefill tile takes splits = 1 and walks all of K
// through a two-stage ring, ignoring cps and stages. A plan that does not
// cover K with non-empty splits returns cudaErrorInvalidValue. One launch
// (decode) or two (prefill); returns cudaGetLastError() after them (0 on
// success).
int tpuflow_int8_matmul(const void* x, const void* w, const void* ws,
                        void* s, void* out, void* scratch, void* counters,
                        int M, int K, int N, int w_contract_last,
                        int ws_stride, int tile, int splits, int cps,
                        int stages, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (N + TILE_N - 1) / TILE_N;
  const int n_chunks = (K + CHUNK_K - 1) / CHUNK_K;
  const int aligned =
      ((uintptr_t)w % 16 == 0) && ((w_contract_last ? K : N) % 16 == 0);
  const int x_vec = ((uintptr_t)x % 16 == 0) && (K % 4 == 0);
  const float* xf = (const float*)x;
  const int8_t* w8 = (const int8_t*)w;
  const float* wsf = (const float*)ws;
  float* sf = (float*)s;
  float* of = (float*)out;
  int* sc = (int*)scratch;
  int* cn = (int*)counters;
  const int smem = smem_bytes(tile, M, cps, stages);

  cudaError_t err;
  if (tile == 0) {
    if (M > 16 || splits < 1 || cps < 1 || stages < 1 || stages > 4 ||
        (long long)splits * cps < n_chunks || (splits - 1) * cps >= n_chunks)
      return (int)cudaErrorInvalidValue;
    dim3 grid(n_tiles, splits);
#define TPUFLOW_DECODE(CLV, MTV)                                            \
  do {                                                                      \
    auto kern = int8_decode_kernel<CLV, MTV>;                               \
    err = allow_smem(kern, smem);                                           \
    if (err != cudaSuccess) return (int)err;                                \
    kern<<<grid, THREADS, smem, st>>>(xf, w8, wsf, ws_stride, of, sc, cn,   \
                                      M, K, N, cps, stages, aligned, x_vec);\
  } while (0)
    if (w_contract_last) {
      if (M <= 8) TPUFLOW_DECODE(true, 1); else TPUFLOW_DECODE(true, 2);
    } else {
      if (M <= 8) TPUFLOW_DECODE(false, 1); else TPUFLOW_DECODE(false, 2);
    }
#undef TPUFLOW_DECODE
  } else {
    if (tile != 1 || splits != 1) return (int)cudaErrorInvalidValue;
    row_scale_kernel<<<(M + 7) / 8, 256, 0, st>>>(xf, sf, M, K, x_vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dim3 grid(n_tiles, (M + PREFILL_BM - 1) / PREFILL_BM);
    if (w_contract_last)
      int8_prefill_kernel<true><<<grid, THREADS, smem, st>>>(
          xf, sf, w8, wsf, ws_stride, of, M, K, N, aligned, x_vec);
    else
      int8_prefill_kernel<false><<<grid, THREADS, smem, st>>>(
          xf, sf, w8, wsf, ws_stride, of, M, K, N, aligned, x_vec);
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory bytes tpuflow_int8_matmul launches a block of
// the given plan with (the card tests hold it to the per-block limit).
int tpuflow_int8_smem(int tile, int M, int cps, int stages) {
  return smem_bytes(tile, M, cps, stages);
}

const char* tpuflow_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
