// Device pieces shared by the two matrix inverse links, lkj_inv.cu (#6) and
// pd_inverse.cu (#10): each maps a packed y to an upper factor U and writes
// X = U'U with U (or its transpose) beside it.
//
// A group of G lanes owns one batch element (a half-warp at K <= 16, else a
// warp) and a block works on tiles of E elements. A block stays on the card
// and walks its tiles (`for_each_tile`): while it works on one tile, the
// next tile's y is on its way into shared memory (cp.async, coalesced along
// whichever stride is 1) and the last tile's outputs are on their way out.
// For each element it builds U in a K x K tile (row stride Kp, zeros below
// the diagonal), forms X into a second tile, and writes each K x K output
// tile whole (`store_tile`: one TMA bulk store, or 16-byte stores).
//
// Layout of a block's shared memory, in floats: `tiles` K x K tiles for each
// of the E elements (tile t of element e at (t E + e) Fs), then two y
// buffers (element e at tiles E Fs + e Pp, and E Pp further). Kp is K
// rounded up to 4, so a row of U is 16-byte aligned and four of its entries
// come in one load; Fs is K Kp rounded up to 16 modulo 32, so the two
// elements of a warp (G = 16) read their tiles on disjoint banks; Pp is P
// rounded up to odd, so the lanes loading the swapped layout write on
// distinct banks.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tbt {
namespace link {

constexpr int kMaxThreads = 256;

__host__ __device__ constexpr int tri(int r) { return r * (r + 1) / 2; }

// lanes owning one element
__host__ __device__ constexpr int group_lanes(int K) { return K <= 16 ? 16 : 32; }

struct Shape {
  int K, P;   // matrix size, packed slots of y
  int Kp;     // a tile's row stride
  int Fs;     // a tile's element stride
  int Pp;     // the y tile's element stride
  int tiles;  // K x K tiles an element
  int E;      // elements a block
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (size_t)E * ((size_t)tiles * Fs + 2 * Pp);
  }
};

// The block shape for K, P slots and `tiles` tiles at batch B: blocks of at
// most 256 threads within the device's shared memory, halved while the grid
// has fewer blocks than the card has SMs (so that a sampler's 64 chains
// spread over 32 SMs), down to one warp. E = 0 when one element's tiles do
// not fit in a block.
inline Shape shape(int K, int P, int tiles, long long B) {
  Shape s;
  s.K = K;
  s.P = P;
  s.Kp = (K + 3) & ~3;
  s.Fs = K * s.Kp + ((16 - K * s.Kp % 32) + 32) % 32;
  s.Pp = P | 1;
  s.tiles = tiles;
  int dev = 0, optin = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int G = group_lanes(K);
  s.E = kMaxThreads / G;
  while (s.E > 0 && s.bytes() > (size_t)optin) s.E /= 2;
  while (s.E > 32 / G && (B + s.E - 1) / s.E < sms) s.E /= 2;
  return s;
}

// sum over the G lanes of a group (the xor partners stay within it)
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(d), "l"(src) : "memory");
}

// ys[e Pp + q] = y[(b0 + e) sb + q sp] for the n elements from b0 on, by
// cp.async, coalesced along whichever stride is 1: along the batch for the
// swapped view of a transposed state (sb = 1), along the slots otherwise.
__device__ __forceinline__ void prefetch_y(const float* __restrict__ y, long long sb,
                                           long long sp, long long b0, int n, const Shape& s,
                                           float* ys) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (sb == 1 && sp != 1) {
    const int e = tid % s.E;
    if (e >= n) return;
    const float* ye = y + b0 + e;
    for (int q = tid / s.E; q < s.P; q += nt / s.E) cp_async4(ys + e * s.Pp + q, ye + q * sp);
    return;
  }
  const int lane = tid % 32, nw = nt / 32;
  for (int e = tid / 32; e < n; e += nw) {
    const float* ye = y + (b0 + e) * sb;
    for (int q = lane; q < s.P; q += 32) cp_async4(ys + e * s.Pp + q, ye + q * sp);
  }
}

// prefetch_y for a y whose slots are contiguous (sp = 1), along the
// flattened (element, slot) index: every lane loads, whatever P, and each
// warp's loads are neighbouring addresses within and across elements (a
// warp an element leaves lanes idle where P is not a multiple of 32: 17
// of 32 at P = 15). Two divisions a thread; then (e, q) steps by nt.
__device__ __forceinline__ void prefetch_rows(const float* __restrict__ y, long long sb,
                                              long long b0, int n, const Shape& s, float* ys) {
  const int tid = threadIdx.x, nt = blockDim.x, P = s.P, total = n * P;
  if (tid >= total) return;
  int e = tid / P, q = tid - e * P;
  const int de = nt / P, dq = nt - de * P;
  const float* base = y + b0 * sb;
  for (int i = tid; i < total; i += nt) {
    cp_async4(ys + e * s.Pp + q, base + e * sb + q);
    e += de;
    q += dq;
    if (q >= P) {
      q -= P;
      ++e;
    }
  }
}

// wait until this thread's bulk stores have read their shared memory
template <bool BULK>
__device__ __forceinline__ void bulk_wait_read() {
  if (BULK) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// The block's share of the batch: tile t holds the n = min(E, B - t E)
// elements from t E on, and the block walks t = blockIdx.x, + gridDim.x, ...
// calling body(ys, t E, n) with the tile's y staged at ys (element e at
// e Pp). The next tile's y is loaded into the other buffer while body runs,
// and before body writes the K x K tiles again the last tile's bulk stores
// have read them (BULK: the tiles leave by bulk stores). FLAT: a y whose
// slots are contiguous (sp = 1, sb != 1) is loaded by prefetch_rows.
template <bool BULK, bool FLAT = false, class Body>
__device__ __forceinline__ void for_each_tile(const float* __restrict__ y, long long sb,
                                              long long sp, long long B, const Shape& s,
                                              float* ybuf, Body body) {
  const long long ntiles = (B + s.E - 1) / s.E;
  const int half = s.E * s.Pp;
  auto count = [&](long long t) { return (int)min((long long)s.E, B - t * s.E); };
  auto prefetch = [&](long long b0, int n, float* ys) {
    if (FLAT && sp == 1 && sb != 1)
      prefetch_rows(y, sb, b0, n, s, ys);
    else
      prefetch_y(y, sb, sp, b0, n, s, ys);
  };
  long long t = blockIdx.x;
  if (t < ntiles) prefetch(t * s.E, count(t), ybuf);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int it = 0; t < ntiles; t += gridDim.x, ++it) {
    const long long next = t + gridDim.x;
    if (next < ntiles) prefetch(next * s.E, count(next), ybuf + ((it + 1) & 1) * half);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    bulk_wait_read<BULK>();
    __syncthreads();
    body(ybuf + (it & 1) * half, t * s.E, count(t));
  }
  bulk_wait_read<BULK>();
}

// U in a tile (zeros below the diagonal): row k at U + k Kp, four entries
// of a row in one load
struct TileU {
  const float* u;
  int Kp;
  __device__ __forceinline__ float4 row4(int k, int a0) const {
    return *reinterpret_cast<const float4*>(u + k * Kp + a0);
  }
  __device__ __forceinline__ float at(int k, int c) const { return u[k * Kp + c]; }
};

// U packed by columns (column j at tri(j), its rows 0..j), for a K whose
// tiles do not fit; 0 below the diagonal
struct PackedU {
  const float* u;
  int K;
  __device__ __forceinline__ float at(int k, int c) const {
    return k <= c ? u[tri(c) + k] : 0.0f;
  }
  __device__ __forceinline__ float4 row4(int k, int a0) const {
    auto get = [&](int a) { return a < K ? at(k, a) : 0.0f; };
    return make_float4(get(a0), get(a0 + 1), get(a0 + 2), get(a0 + 3));
  }
};

// X = U'U for one element: out(a, c, X[a][c]), X[a][c] the sum over k of
// U[k][a] U[k][c], k ascending. Rows are formed four at a time (the four
// U[k][a] one 16-byte broadcast load), k up to the group's last row: the
// terms past min(a, c) are products with U's zeros below the diagonal, so
// for a finite U the (a, c) and (c, a) entries are the same products in the
// same order plus exact zeros, and X is exactly symmetric; an infinite
// diagonal entry meets zeros as in the plain version's U'U. Lane l of the
// group's G lanes forms the columns c = l, l + G, ...; with K = KS known
// (KS = G = 16) its column of U lives in registers and the loops unroll.
template <int KS, class Fac, class Out>
__device__ __forceinline__ void gram(const Fac& u, int K, int l, int G, Out out) {
  if constexpr (KS > 0) {
    float uc[KS];
#pragma unroll
    for (int k = 0; k < KS; ++k) uc[k] = u.at(k, l);
#pragma unroll
    for (int a0 = 0; a0 < KS; a0 += 4) {
      float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f, x3 = 0.0f;
#pragma unroll
      for (int k = 0; k < a0 + 4; ++k) {
        const float4 r = u.row4(k, a0);
        x0 = fmaf(r.x, uc[k], x0);
        x1 = fmaf(r.y, uc[k], x1);
        x2 = fmaf(r.z, uc[k], x2);
        x3 = fmaf(r.w, uc[k], x3);
      }
      out(a0, l, x0);
      out(a0 + 1, l, x1);
      out(a0 + 2, l, x2);
      out(a0 + 3, l, x3);
    }
    return;
  }
  for (int c = l; c < K; c += G) {
    for (int a0 = 0; a0 < K; a0 += 4) {
      float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f, x3 = 0.0f;
      const int kend = min(a0 + 3, K - 1);
      for (int k = 0; k <= kend; ++k) {
        const float4 r = u.row4(k, a0);
        const float v = u.at(k, c);
        x0 = fmaf(r.x, v, x0);
        x1 = fmaf(r.y, v, x1);
        x2 = fmaf(r.z, v, x2);
        x3 = fmaf(r.w, v, x3);
      }
      out(a0, c, x0);
      if (a0 + 1 < K) out(a0 + 1, c, x1);
      if (a0 + 2 < K) out(a0 + 2, c, x2);
      if (a0 + 3 < K) out(a0 + 3, c, x3);
    }
  }
}

// Before a tile written by the threads is read by a bulk store: every
// thread orders its shared-memory writes before the async proxy's reads,
// then the block meets.
template <bool BULK>
__device__ __forceinline__ void tiles_written() {
  if (BULK) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
}

// Write tile t of the block's n elements to out (B, K, K) from element b0
// on. With Kp = K each element's tile is one contiguous, 16-byte aligned run
// of K K floats (out comes from torch.empty): with BULK one TMA bulk store
// each, which the issuing thread waits for (bulk_wait_read) only before the
// tile is written again, else 16-byte stores. Otherwise rows are copied
// float by float.
template <bool BULK>
__device__ __forceinline__ void store_tile(float* __restrict__ out, const float* smem,
                                           int t, long long b0, int n, const Shape& s) {
  const int K = s.K, KK = K * K, tid = threadIdx.x;
  const float* tile = smem + (size_t)t * s.E * s.Fs;
  if (s.Kp == K && BULK) {
    if (tid < n) {
      const uint32_t src = static_cast<uint32_t>(__cvta_generic_to_shared(tile + tid * s.Fs));
      float* dst = out + (b0 + tid) * KK;
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   :: "l"(dst), "r"(src), "r"(KK * 4) : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    return;
  }
  const int lane = tid % 32, nw = blockDim.x / 32;
  for (int e = tid / 32; e < n; e += nw) {
    float* dst = out + (b0 + e) * KK;
    const float* src = tile + e * s.Fs;
    if (s.Kp == K) {
      for (int q = lane; q < KK / 4; q += 32)
        reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(src)[q];
    } else {
      for (int q = lane; q < KK; q += 32) dst[q] = src[(q / K) * s.Kp + q % K];
    }
  }
}

// Write n rows of w floats, row e of the shared tile at tile + e ld, to the
// elements b0 .. b0 + n - 1 of out, whose element e, slot q is at
// out[(b0 + e) ob + q oq], with the block's threads in the order that
// keeps each warp's stores on neighbouring addresses: along the slots when
// the n rows are one contiguous run (ob = w, oq = 1; 16-byte stores where
// the run is 16-byte aligned), else along the batch, which needs ob = 1
// (the swapped view of a (w, B) tensor).
__device__ __forceinline__ void store_rows(float* __restrict__ out, long long ob, long long oq,
                                           const float* tile, int ld, long long b0, int n,
                                           int w) {
  const int tid = threadIdx.x, nt = blockDim.x, total = n * w;
  if (oq == 1 && ob == w) {
    float* dst = out + b0 * w;
    int q0 = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      q0 = total & ~3;
      for (int q = 4 * tid; q < q0; q += 4 * nt) {
        int e = q / w, c = q - e * w;  // one division for the four floats
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = tile[e * ld + c];
          if (++c == w) {
            c = 0;
            ++e;
          }
        }
        *reinterpret_cast<float4*>(dst + q) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    for (int q = q0 + tid; q < total; q += nt) dst[q] = tile[(q / w) * ld + q % w];
    return;
  }
  for (int i = tid; i < total; i += nt) {
    const int q = i / n, e = i % n;
    out[q * oq + b0 + e] = tile[e * ld + q];
  }
}

// Launch kern(args...) with `threads` threads and `bytes` of dynamic shared
// memory a block for `tiles` tiles: as many blocks as stay on the card at
// once (at most one a tile), each walking its tiles.
template <class... P, class... A>
cudaError_t launch_blocks(void (*kern)(P...), int threads, size_t bytes, long long tiles,
                          cudaStream_t stream, A... args) {
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, bytes);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  kern<<<(unsigned)(tiles < resident ? tiles : resident), threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// launch_blocks for the tiles of B elements of shape s, G lanes an element
template <class... P, class... A>
cudaError_t launch_tiles(void (*kern)(P...), const Shape& s, long long B, cudaStream_t stream,
                         A... args) {
  return launch_blocks(kern, s.E * group_lanes(s.K), s.bytes(), (B + s.E - 1) / s.E, stream,
                       args...);
}

}  // namespace link
}  // namespace tbt
