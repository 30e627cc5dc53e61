// Frontier waves over per-run edge lists on Hopper.
//
// Replaces the TPU kernel nemo_tpu/ops/pallas_kernels.py:edge_wave_pallas
// (body _edge_wave_kernel): for every run b of a [B,V] bool state,
//   state |= push(state)        (push: nodes with an in-edge from state)
// exactly n_steps times, or to the fix point when n_steps < 0.  The TPU
// kernel expressed the push as [E,V] one-hot compares in VMEM, because
// Mosaic has no scatter; here a scatter is one atomicOr on a bit.
//
// Design: one CTA per run.  The node state is a bitset in shared memory
// (ceil(V/32) words: 2 KB at V = 16384).  The run's masked edges are staged
// once into shared memory as (src, dst) int32 pairs where they fit (E =
// 16384 edges take 128 KB), so a wave reads no device memory at all; where
// they do not fit, every wave streams the edge planes from device memory
// (served from L2 after the first wave).  Each thread walks a stride of the
// edges; an edge whose source bit is set ORs its destination bit into the
// next buffer with atomicOr, and a __syncthreads_or vote on "some bit was
// newly set" ends the loop early: a wave that changes nothing changes
// nothing after it, so the early exit is exact for any n_steps.
//
// Semantics.  With a finite n_steps each wave reads one buffer and writes
// the other (Jacobi), so a wave reaches exactly one hop further, as the
// reference's synchronous pushes do; reading bits set in the same wave would
// reach further per step and differ from the reference at finite n_steps.
// With n_steps < 0 only the fix point is asked for: the least set that
// contains the state and is closed under push is unique, so the kernel
// updates one buffer in place (Gauss-Seidel), which reaches that same set in
// at most as many waves, usually far fewer on long chains.
//
// Edge lists: src/dst/mask are [B,E] (edge_stride = E) or one [E] list
// shared by every run (edge_stride = 0: the diff broadcasts the good run's
// edges over all failed runs).  Edges whose endpoints fall outside [0, V)
// are ignored (memory safety; callers' edge lists are in range).
//
// What bounds it on an H100: the bytes of one read of the state and edge
// planes ([B,V] + 9 B x B x E) and one write of the [B,V] output; the waves
// themselves run out of shared memory.  The deep case is one CTA walking a
// long chain: sparse_diff on a giant good run has B = 8 (padded) CTAs and
// needs up to ~V waves in the Jacobi form; that case is latency-bound on one
// SM per run.  Multi-CTA or cluster designs are later work.
//
// C interface (loaded with ctypes): pointers and the stream are passed as
// void*, the launch returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMinThreads = 64;
// Dynamic shared memory a block may opt into on sm_90: 227 KB (232,448 B)
// in all, less room for the kernel's static counter.
constexpr size_t kMaxSmemBytes = 232448 - 1024;

__host__ __device__ inline int words_for(int v) { return (v + 31) / 32; }

__host__ inline size_t bitset_bytes(int v) { return (size_t)2 * words_for(v) * sizeof(uint32_t); }

// One edge (s, d) of a wave: reads `cur`, ORs into `nxt`.  Returns 1 iff it
// newly set d's bit.
__device__ inline int relax(const volatile uint32_t* cur, uint32_t* nxt, int s, int d) {
  if (!((cur[s >> 5] >> (s & 31)) & 1u)) return 0;
  const uint32_t bit = 1u << (d & 31);
  if (((const volatile uint32_t*)nxt)[d >> 5] & bit) return 0;
  return (atomicOr(&nxt[d >> 5], bit) & bit) ? 0 : 1;
}

template <bool kStaged>
__global__ void edge_wave_kernel(const uint8_t* __restrict__ state, const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ dst, const uint8_t* __restrict__ mask,
                                 uint8_t* __restrict__ out, int v, int e, long long edge_stride,
                                 int n_steps) {
  extern __shared__ uint32_t smem[];
  __shared__ int n_staged;
  const int w = words_for(v);
  uint32_t* buf0 = smem;
  uint32_t* buf1 = smem + w;
  int2* staged = reinterpret_cast<int2*>(smem + 2 * w);  // 2w words: 8-byte aligned
  const long long row = blockIdx.x;
  const uint8_t* st = state + row * v;
  const int32_t* es = src + row * edge_stride;
  const int32_t* ed = dst + row * edge_stride;
  const uint8_t* em = mask + row * edge_stride;

  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    const int base = i * 32;
    const int n = min(32, v - base);
    uint32_t word = 0;
    for (int k = 0; k < n; ++k) word |= (uint32_t)(st[base + k] != 0) << k;
    buf0[i] = word;
  }
  if (kStaged) {
    if (threadIdx.x == 0) n_staged = 0;
    __syncthreads();
    // Compacted in any order: OR is order-free.
    for (int k = threadIdx.x; k < e; k += blockDim.x) {
      const int s = es[k];
      const int d = ed[k];
      if (em[k] && s >= 0 && s < v && d >= 0 && d < v) staged[atomicAdd(&n_staged, 1)] = make_int2(s, d);
    }
  }
  __syncthreads();

  const bool fix_point = n_steps < 0;
  uint32_t* cur = buf0;
  uint32_t* nxt = fix_point ? buf0 : buf1;
  const int n_edges = kStaged ? n_staged : e;
  for (int step = 0; fix_point || step < n_steps; ++step) {
    if (!fix_point) {
      for (int i = threadIdx.x; i < w; i += blockDim.x) nxt[i] = cur[i];
      __syncthreads();
    }
    int changed = 0;
    for (int k = threadIdx.x; k < n_edges; k += blockDim.x) {
      if (kStaged) {
        const int2 sd = staged[k];
        changed |= relax(cur, nxt, sd.x, sd.y);
      } else if (em[k]) {
        const int s = es[k];
        const int d = ed[k];
        if (s >= 0 && s < v && d >= 0 && d < v) changed |= relax(cur, nxt, s, d);
      }
    }
    const int any = __syncthreads_or(changed);
    if (!fix_point) {
      uint32_t* t = cur;
      cur = nxt;
      nxt = t;
    }
    if (!any) break;
  }

  uint8_t* o = out + row * v;
  for (int i = threadIdx.x; i < v; i += blockDim.x) o[i] = (uint8_t)((cur[i >> 5] >> (i & 31)) & 1u);
}

template <bool kStaged>
cudaError_t launch(const void* state, const void* src, const void* dst, const void* mask, void* out,
                   int b, int v, int e, long long edge_stride, int n_steps, size_t smem, int threads,
                   cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_wave_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  edge_wave_kernel<kStaged><<<b, threads, smem, st>>>(
      (const uint8_t*)state, (const int32_t*)src, (const int32_t*)dst, (const uint8_t*)mask,
      (uint8_t*)out, v, e, edge_stride, n_steps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest V whose two bitsets fit a block's shared memory.
int nemo_edge_wave_max_v() { return (int)(kMaxSmemBytes / (2 * sizeof(uint32_t))) * 32; }

// out[b] = state[b] after n_steps waves (n_steps < 0: to the fix point).
// state/out: [b,v] bool bytes; src/dst: int32, mask: bool bytes, each
// [b,e] (shared_edges = 0) or [e] (shared_edges = 1); all contiguous on the
// device.
int nemo_edge_wave(const void* state, const void* src, const void* dst, const void* mask, void* out,
                   int b, int v, int e, int shared_edges, int n_steps, void* stream) {
  if (b <= 0 || v <= 0) return (int)cudaSuccess;
  if (v > nemo_edge_wave_max_v() || e < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long edge_stride = shared_edges ? 0 : (long long)e;
  int threads = (e + 31) / 32 * 32;
  if (threads < kMinThreads) threads = kMinThreads;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t staged_smem = bitset_bytes(v) + (size_t)e * sizeof(int2);
  if (staged_smem <= kMaxSmemBytes)
    return (int)launch<true>(state, src, dst, mask, out, b, v, e, edge_stride, n_steps, staged_smem,
                             threads, st);
  return (int)launch<false>(state, src, dst, mask, out, b, v, e, edge_stride, n_steps,
                            bitset_bytes(v), threads, st);
}

const char* nemo_edge_wave_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
