// Reflexive-transitive closure of boolean adjacency matrices on Hopper.
//
// Replaces the TPU kernel nemo_tpu/ops/pallas_kernels.py:closure_pallas
// (body _closure_kernel): (A|I) squared exactly n_steps times, thresholded
// after every squaring, for a [B,V,V] batch of 0/1 matrices.
//
// What bounds it on an H100: at the analysis path's shapes (B ~ 2048,
// V = 64, 5 squarings) the work is a few thousand 64-bit ORs per graph, so
// the floor is the bytes it must move: one read of the [B,V,V] bool input
// and one write of the output (14 MB at (1700, 64): 4.2 us at 3.35 TB/s).
// The TPU kernel packed graphs block-diagonally into 128-wide MXU tiles;
// here a graph is held as bit rows, and one squaring is
//   out[i] = OR over k in row i of R[k]
// on whole words.  Each squaring reads one copy of the rows and writes the
// other (out of place), so the result is bit-identical to the squaring chain
// even where n_steps is below what the graph needs (cyclic inputs, a
// max_len under the true depth).
//
// What held the first design (one CTA of 128 threads per 64-node graph) at
// ~10x that floor: per-graph occupancy, and byte-wise packing (each thread
// read 32 consecutive bytes, so neighbouring lanes sat 32 bytes apart) and
// unpacking.  And the analyses' graphs are sparse (chains of a few dozen
// nodes, and padding graphs with no edge at all), so their closures settle
// within fewer squarings than n_steps and a row has few set bits: the warp
// and block variants stop where a squaring changes nothing (R*R = R, so
// every later squaring is the identity: bit-identical to the full chain)
// and visit only set bits.  The variants (kernels/closure.py:closure_plan
// picks one from the shapes and passes the launch plan in):
//
//  * warp (V <= 64; the plan gives it single graphs, the [V,V] diff
//    closures): one warp per graph, several graphs per block.  The
//    graph's V*V bytes are read with coalesced 16-byte loads, all of a
//    lane's in flight at once (where V % 16 == 0; a warp ballot per 32
//    bytes otherwise), and turned into bits by a multiply; a lane holds
//    rows `lane` and `lane + 32` as uint64 in registers, ORs the diagonal
//    in, and per squaring publishes them to the graph's 512 bytes of shared
//    memory and ORs in, as broadcasts, the rows of its own rows' set bits
//    (found four at a time, their loads in flight together), or, once the
//    rows are dense, every row under a mask.  The result leaves with
//    16-byte stores.
//  * block (batches, and single graphs of 64 < V <= 960): one CTA per
//    graph, both bit buffers in shared memory, packed and unpacked with the
//    same coalesced vector loads and stores (where V % 32 == 0; warp
//    ballots and byte stores otherwise).  On the analyses' batched buckets
//    at V = 64 its four warps per graph beat the warp variant's one: the
//    graphs are sparse and settle in a few squarings, so what counts is
//    the loads in flight per graph while the graph is read.
//  * global (V above ~960, where two bit buffers exceed a block's 227 KB):
//    the bit rows live in device memory supplied by the caller, and each
//    squaring is one launch over all row words of the batch.
//
// C interface (loaded with ctypes): pointers and the stream are passed as
// void*, every function returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGlobalThreads = 256;
// 16-byte loads per lane of the warp variant: a 64-node graph is 4,096
// bytes, 256 loads, 8 per lane.
constexpr int kWarpLoads = 8;
// Dynamic shared memory a block may opt into on sm_90: 227 KB (232,448 B),
// less the room kernels/closure.py keeps for static shared variables.
constexpr size_t kMaxSmemBytes = 232448 - 1024;

enum Variant { kWarp = 0, kBlock = 1, kGlobal = 2 };

__host__ __device__ inline int words_per_row(int v) { return (v + 31) / 32; }

__device__ inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// 16 bool bytes (0 or 1) -> 16 bits, byte j to bit j.
__device__ inline uint32_t pack16(uint4 x) {
  const uint64_t ones = 0x0101010101010101ull, gather = 0x0102040810204080ull;
  const uint64_t lo = ((uint64_t)x.y << 32 | x.x) & ones;
  const uint64_t hi = ((uint64_t)x.w << 32 | x.z) & ones;
  return (uint32_t)((lo * gather) >> 56) | (uint32_t)((hi * gather) >> 56) << 8;
}

// 4 bits -> 4 bytes of 0 or 1 (bit j to byte j).
__device__ inline uint32_t spread4(uint32_t nibble) { return (nibble * 0x00204081u) & 0x01010101u; }

// 16 bits -> 16 bytes of 0 or 1.
__device__ inline uint4 spread16(uint32_t bits) {
  return make_uint4(spread4(bits & 15u), spread4(bits >> 4 & 15u), spread4(bits >> 8 & 15u),
                    spread4(bits >> 12 & 15u));
}

// ------------------------------------------------------------------- warp

// Set bits of a row whose rows or_rows loads at once.
constexpr int kRowLoads = 4;
// Set bits in a lane's two rows above which the warp squares by ORing every
// row under a mask instead: 64 loads, no search for bits.
constexpr int kDenseBits = 32;

// The OR of the rows R[k] over the set bits k of `row`: one squared row.
// Only set bits cost a load (the analyses' graphs are sparse); the next
// kRowLoads set bits are found first and their loads issued together.
__device__ inline uint64_t or_rows(const uint64_t* R, uint64_t row) {
  uint64_t acc = 0;
  while (row) {
    int k[kRowLoads];
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j) {
      k[j] = __ffsll((long long)row) - 1;  // -1 once the row is used up
      row &= row - 1;
    }
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j)
      if (k[j] >= 0) acc |= R[k[j]];
  }
  return acc;
}

// One warp per graph (V <= 64); graphs_per_block = blockDim.x / 32, each
// with 64 uint64 rows of shared memory.
__global__ void closure_warp_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int b, int v,
                                    int n_steps) {
  extern __shared__ __align__(16) uint64_t rows_all[];
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * (blockDim.x >> 5) + wi;
  if (g >= b) return;
  uint64_t* R = rows_all + wi * 64;
  const uint8_t* src = in + g * v * v;
  uint8_t* dst = out + g * v * v;
  const bool vec = (v & 15) == 0 && aligned16(src) && aligned16(dst);
  const int per_row = v >> 4;  // 16-byte pieces per row (vec)
  uint16_t* P = reinterpret_cast<uint16_t*>(R);  // piece q of row i is P[4 i + q]

  R[lane] = 0;
  R[lane + 32] = 0;
  __syncwarp();
  if (vec) {
    // All of a lane's (at most 8) loads are issued before any is used, so
    // the graph arrives in about one device-memory latency.
    const int n = v * per_row;
    uint4 x[kWarpLoads];
#pragma unroll
    for (int j = 0; j < kWarpLoads; ++j)
      if (lane + 32 * j < n) x[j] = __ldg(reinterpret_cast<const uint4*>(src) + lane + 32 * j);
#pragma unroll
    for (int j = 0; j < kWarpLoads; ++j) {
      const int u = lane + 32 * j;
      if (u < n) {
        const int i = u / per_row;
        P[4 * i + (u - i * per_row)] = (uint16_t)pack16(x[j]);
      }
    }
  } else {
    uint32_t* H = reinterpret_cast<uint32_t*>(R);
    for (int i = 0; i < v; ++i)
      for (int c = 0; c < v; c += 32) {
        const uint32_t word = __ballot_sync(kFull, c + lane < v && src[i * v + c + lane] != 0);
        if (lane == 0) H[2 * i + (c >> 5)] = word;
      }
  }
  __syncwarp();
  uint64_t r0 = R[lane], r1 = R[lane + 32];
  if (lane < v) r0 |= 1ull << lane;
  if (lane + 32 < v) r1 |= 1ull << (lane + 32);

  // A squaring that changes no row has reached R*R = R, and every squaring
  // after it would change nothing: the warp stops there, bit-identical to
  // the full chain.
  for (int s = 0; s < n_steps; ++s) {
    __syncwarp();
    R[lane] = r0;
    R[lane + 32] = r1;
    __syncwarp();
    uint64_t a0 = 0, a1 = 0;
    if (__any_sync(kFull, __popcll(r0) + __popcll(r1) > kDenseBits)) {
#pragma unroll 16
      for (int k = 0; k < 64; ++k) {  // rows at or above v are zero
        const uint64_t rk = R[k];
        if (r0 >> k & 1u) a0 |= rk;
        if (r1 >> k & 1u) a1 |= rk;
      }
    } else {
      a0 = or_rows(R, r0);
      a1 = or_rows(R, r1);
    }
    if (!__any_sync(kFull, a0 != r0 || a1 != r1)) break;
    r0 = a0;
    r1 = a1;
  }

  __syncwarp();
  R[lane] = r0;
  R[lane + 32] = r1;
  __syncwarp();
  if (vec) {
    for (int u = lane; u < v * per_row; u += 32) {
      const int i = u / per_row;
      reinterpret_cast<uint4*>(dst)[u] = spread16(P[4 * i + (u - i * per_row)]);
    }
  } else {
    for (int idx = lane; idx < v * v; idx += 32) {
      const int i = idx / v;
      dst[idx] = (uint8_t)(R[i] >> (idx - i * v) & 1u);
    }
  }
}

// ------------------------------------------------------------------ block

// Row word (i, k) of R*R: the OR of row words (k', k) over the set bits k'
// of row i.  Bits at or above V are never set, so every k' is a real row.
__device__ inline uint32_t square_word(const uint32_t* src, int w, int i, int k) {
  const uint32_t* row = src + (size_t)i * w;
  uint32_t acc = 0;
  for (int kw = 0; kw < w; ++kw) {
    uint32_t bits = row[kw];
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      acc |= src[(size_t)(kw * 32 + b) * w + k];
    }
  }
  return acc;
}

// One CTA per graph, the whole squaring chain in shared memory.
__global__ void closure_block_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int v,
                                     int n_steps) {
  extern __shared__ uint32_t smem[];
  const int w = words_per_row(v);
  const int words = v * w;
  const int wi = threadIdx.x >> 5, nw = blockDim.x >> 5, lane = threadIdx.x & 31;
  uint32_t* a = smem;
  uint32_t* b = smem + words;
  const uint8_t* src = in + (size_t)blockIdx.x * v * v;
  uint8_t* dst = out + (size_t)blockIdx.x * v * v;
  // With V % 32 == 0 the graph's bytes are its row words in order: word j
  // is bytes [32 j, 32 j + 32).
  const bool vec_in = (v & 31) == 0 && aligned16(src);
  const bool vec_out = (v & 31) == 0 && aligned16(dst);

  if (vec_in) {
    const int n16 = 2 * words;
    for (int u0 = wi * 32; u0 < n16; u0 += nw * 32) {
      const int u = u0 + lane;
      const uint32_t half = u < n16 ? pack16(reinterpret_cast<const uint4*>(src)[u]) : 0u;
      const uint32_t upper = __shfl_down_sync(kFull, half, 1);
      if (u < n16 && !(lane & 1)) a[u >> 1] = half | upper << 16;
    }
  } else {
    for (int j = wi; j < words; j += nw) {
      const int i = j / w, c = (j - i * w) * 32 + lane;
      const uint32_t word = __ballot_sync(kFull, c < v && src[(size_t)i * v + c] != 0);
      if (lane == 0) a[j] = word;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < v; i += blockDim.x) a[i * w + (i >> 5)] |= 1u << (i & 31);
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {  // stops where a squaring changes nothing, as the warp variant
    int changed = 0;
    for (int idx = threadIdx.x; idx < words; idx += blockDim.x) {
      const uint32_t x = square_word(a, w, idx / w, idx % w);
      b[idx] = x;
      changed |= x != a[idx];
    }
    if (!__syncthreads_or(changed)) break;
    uint32_t* t = a;
    a = b;
    b = t;
  }
  if (vec_out) {
    for (int u = threadIdx.x; u < 2 * words; u += blockDim.x)
      reinterpret_cast<uint4*>(dst)[u] = spread16(a[u >> 1] >> ((u & 1) * 16) & 0xffffu);
  } else {
    for (int idx = threadIdx.x; idx < v * v; idx += blockDim.x) {
      const int i = idx / v, j = idx - i * v;
      dst[idx] = (uint8_t)((a[i * w + (j >> 5)] >> (j & 31)) & 1u);
    }
  }
}

// ----------------------------------------------------------------- global

// Row word (i, k) of (A|I) from the [V,V] byte matrix `in`.
__device__ inline uint32_t pack_word(const uint8_t* __restrict__ in, int v, int i, int k) {
  const uint8_t* src = in + (size_t)i * v + (size_t)k * 32;
  const int n = min(32, v - k * 32);
  uint32_t word = 0;
  for (int b = 0; b < n; ++b) word |= (uint32_t)(src[b] != 0) << b;
  if (i / 32 == k) word |= 1u << (i % 32);
  return word;
}

__device__ inline uint8_t unpack_byte(const uint32_t* rows, int w, int i, int j) {
  return (uint8_t)((rows[(size_t)i * w + j / 32] >> (j % 32)) & 1u);
}

// Device-memory variant for large V: one thread per row word of the batch.
__global__ void pack_kernel(const uint8_t* __restrict__ in, uint32_t* __restrict__ rows, int v,
                            long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int w = words_per_row(v);
  const long long per_graph = (long long)v * w;
  const long long g = idx / per_graph;
  const int r = (int)(idx % per_graph);
  rows[idx] = pack_word(in + g * v * v, v, r / w, r % w);
}

__global__ void square_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst, int v,
                              long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int w = words_per_row(v);
  const long long per_graph = (long long)v * w;
  const long long g = idx / per_graph;
  const int r = (int)(idx % per_graph);
  dst[idx] = square_word(src + g * per_graph, w, r / w, r % w);
}

__global__ void unpack_kernel(const uint32_t* __restrict__ rows, uint8_t* __restrict__ out, int v,
                              long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int w = words_per_row(v);
  const long long per_graph = (long long)v * v;
  const long long g = idx / per_graph;
  const int r = (int)(idx % per_graph);
  out[idx] = unpack_byte(rows + g * v * w, w, r / v, r % v);
}

inline unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kGlobalThreads - 1) / kGlobalThreads);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// out = closure of adj ([b,v,v] bool bytes, both contiguous on the device),
// exactly n_steps squarings of (adj|I), by the launch plan (variant,
// graphs_per_block, threads, smem bytes) that kernels/closure.py:closure_plan
// chose.  scratch: 2 * b * v * ceil(v/32) uint32 words for the global
// variant, else null.
int nemo_closure(const void* adj, void* out, void* scratch, int b, int v, int n_steps, int variant,
                 int graphs_per_block, int threads, long long smem, void* stream) {
  if (b <= 0 || v <= 0) return (int)cudaSuccess;
  if (smem < 0 || (size_t)smem > kMaxSmemBytes || threads <= 0 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* in = (const uint8_t*)adj;
  uint8_t* dst = (uint8_t*)out;
  const long long words = (long long)v * words_per_row(v);
  cudaError_t err;
  switch (variant) {
    case kWarp: {
      if (v > 64 || graphs_per_block <= 0 || threads != 32 * graphs_per_block ||
          (size_t)smem < (size_t)graphs_per_block * 64 * sizeof(uint64_t))
        return (int)cudaErrorInvalidValue;
      if ((err = allow_smem(closure_warp_kernel, (size_t)smem)) != cudaSuccess) return (int)err;
      const unsigned blocks = (unsigned)((b + graphs_per_block - 1) / graphs_per_block);
      closure_warp_kernel<<<blocks, threads, smem, st>>>(in, dst, b, v, n_steps);
      return (int)cudaGetLastError();
    }
    case kBlock: {
      if ((size_t)smem < (size_t)(2 * words) * sizeof(uint32_t)) return (int)cudaErrorInvalidValue;
      if ((err = allow_smem(closure_block_kernel, (size_t)smem)) != cudaSuccess) return (int)err;
      closure_block_kernel<<<b, threads, smem, st>>>(in, dst, v, n_steps);
      return (int)cudaGetLastError();
    }
    case kGlobal: {
      if (scratch == nullptr) return (int)cudaErrorInvalidValue;
      uint32_t* r0 = (uint32_t*)scratch;
      uint32_t* r1 = r0 + (long long)b * words;
      const long long total_words = (long long)b * words;
      pack_kernel<<<blocks_for(total_words), kGlobalThreads, 0, st>>>(in, r0, v, total_words);
      for (int s = 0; s < n_steps; ++s) {
        square_kernel<<<blocks_for(total_words), kGlobalThreads, 0, st>>>(r0, r1, v, total_words);
        uint32_t* t = r0;
        r0 = r1;
        r1 = t;
      }
      const long long total_bytes = (long long)b * v * v;
      unpack_kernel<<<blocks_for(total_bytes), kGlobalThreads, 0, st>>>(r0, dst, v, total_bytes);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* nemo_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
