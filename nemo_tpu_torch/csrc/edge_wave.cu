// Reach over per-run edge lists on Hopper: a work-efficient fix point, and
// synchronous frontier waves.
//
// Replaces the TPU kernel nemo_tpu/ops/pallas_kernels.py:edge_wave_pallas
// (body _edge_wave_kernel): for every run b of a [B,V] bool state,
//   state |= push(state)        (push: nodes with an in-edge from state)
// exactly n_steps times, or to the fix point when n_steps < 0.  The TPU
// kernel expressed the push as [E,V] one-hot compares in VMEM, because
// Mosaic has no scatter; here a scatter is one atomicOr on a bit.
//
// What bounds it on an H100.  Bytes: one read of the state and the edge
// planes ([B,V] + 9 B x B x E, or 9 B x E for one shared list) and one write
// of the [B,V] output.  Latency: the fix point cannot be reached faster than
// the longest chain of dependent hops it has to follow (a 10,000-node chain
// is 10,000 hops), and a hop is a few dependent shared-memory operations:
// measured on the card, 0.14 us a hop for the traversal below against
// 0.86 us a wave for the synchronous waves, which pay a block barrier and a
// sweep of all E edges per wave.  And every launch costs about 2 us on the
// card before it does anything, which sets the floor at the analyses'
// small shapes.
//
// Variants (the wrapper, kernels/edge_wave.py:edge_wave_plan, picks one
// from the shapes and passes the launch plan in):
//
//  * worklist_warp (n_steps < 0; V <= 1024 and E <= 4096): one warp per run,
//    several runs per block.  worklist_block (n_steps < 0, larger runs whose
//    edges and CSR fit 227 KB of shared memory, V <= ~19,000 at E = V): one
//    block per run.  Both compute the least set that contains the state and
//    is closed under push.  That set is unique, so any order of work gives
//    it bit for bit.  (fix_point:) One coalesced pass (16-byte loads where
//    aligned, several in flight per lane) stages the run's masked, in-range
//    edges in shared memory as packed (src, dst) pairs.  In-place sweeps of
//    the staged pairs (a warp vote or __syncthreads_or ends each) finish the
//    runs that are shallow or have few edges, within a budget of pair visits
//    per thread.  What the budget leaves (deep chains over many edges) gets
//    a CSR sorted by source (an out-degree count, an exclusive scan and a
//    scatter of the pairs, 16-bit nodes) and a traversal: the set nodes
//    seed a queue; a node is queued only when its bit is newly set, so the
//    queue never holds more than V entries and needs no wraparound.  A warp
//    takes up to 32 nodes at a time, one per lane, and walks their
//    out-edges lane-parallel (all 32 lanes over one node's edges for large
//    out-degrees); the nodes it newly sets become its next batch, the
//    overflow goes to the shared queue, and a batch of one node is followed
//    as a chain by lane 0 alone, with no warp collective per hop.  The end
//    is found with a count of warps holding nodes, not a barrier per hop.
//  * waves_staged / waves_streamed (finite n_steps; the fix point of small
//    runs whose CTAs all fit on the card at once, where it measured faster;
//    and any shape whose CSR does not fit, up to ~925,000 nodes): one CTA per
//    run; the node state as bitsets in shared memory; the masked edges
//    staged there as (src, dst) pairs where they fit, else streamed from
//    device memory each wave; every wave sweeps all edges and ends in a
//    __syncthreads_or vote.  With a finite n_steps each wave reads one
//    bitset and writes the other (Jacobi), so a wave reaches exactly one hop
//    further, as the reference's synchronous pushes do; with n_steps < 0 it
//    updates one bitset in place (Gauss-Seidel).
//
// Edge lists: src/dst/mask are [B,E] (edge_stride = E) or one [E] list
// shared by every run (edge_stride = 0: the diff broadcasts the good run's
// edges over all failed runs).  With a shared list every block builds the
// CSR of the one list itself, reading it from L2: that costs no extra
// launch and no device scratch, and a list of E edges is 9E bytes, small
// next to the runs' state.  Edges whose endpoints fall outside [0, V) are
// ignored (memory safety; callers' edge lists are in range).
//
// C interface (loaded with ctypes): pointers and the stream are passed as
// void*, the launch returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Dynamic shared memory a block may opt into on sm_90: 227 KB (232,448 B)
// in all, less room for the kernels' static shared variables.
constexpr size_t kMaxSmemBytes = 232448 - 1024;
// Out-degree above which all 32 lanes of a warp walk one node's edges.
constexpr int kHeavyDegree = 8;

enum Variant { kWavesStaged = 0, kWavesStreamed = 1, kWorklistBlock = 2, kWorklistWarp = 3 };

__host__ __device__ inline int words_for(int v) { return (v + 31) / 32; }

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ inline size_t bitset_bytes(int v) { return (size_t)2 * words_for(v) * sizeof(uint32_t); }

__device__ inline bool aligned(const void* p, uintptr_t n) { return ((uintptr_t)p & (n - 1)) == 0; }

// ------------------------------------------------------------------ waves

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

// ------------------------------------------------------ bit packing helpers

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

// The v bool bytes at `st` -> bit words[0, ceil(v/32)), by whole warps (warp
// wi of nw): 16-byte loads where v % 16 == 0 and `st` is 16-byte aligned,
// else one byte per lane and a warp ballot; both coalesced.
__device__ void pack_row(const uint8_t* st, int v, uint32_t* words, int wi, int nw, int lane) {
  if ((v & 15) == 0 && aligned(st, 16)) {
    const int n16 = v >> 4;
    for (int u0 = wi * 32; u0 < n16; u0 += nw * 32) {
      const int u = u0 + lane;
      const uint32_t half = u < n16 ? pack16(reinterpret_cast<const uint4*>(st)[u]) : 0u;
      const uint32_t upper = __shfl_down_sync(kFull, half, 1);
      if (u < n16 && !(lane & 1)) words[u >> 1] = half | upper << 16;
    }
  } else {
    for (int i = wi; i < words_for(v); i += nw) {
      const int k = i * 32 + lane;
      const uint32_t word = __ballot_sync(kFull, k < v && st[k] != 0);
      if (lane == 0) words[i] = word;
    }
  }
}

// Bit words -> v bool bytes at `o`, thread t of nt: 16-byte stores where
// v % 16 == 0 and `o` is 16-byte aligned, else one byte per thread.
__device__ void unpack_row(const uint32_t* words, int v, uint8_t* o, int t, int nt) {
  if ((v & 15) == 0 && aligned(o, 16)) {
    for (int u = t; u < (v >> 4); u += nt)
      reinterpret_cast<uint4*>(o)[u] = spread16(words[u >> 1] >> ((u & 1) * 16) & 0xffffu);
  } else {
    for (int i = t; i < v; i += nt) o[i] = (uint8_t)((words[i >> 5] >> (i & 31)) & 1u);
  }
}

// ---------------------------------------------------------------- worklist

// A node index in shared memory.  16 bits hold every node of a worklist
// run: at 6 bytes a node and 6 an edge at the least, a run fits a block's
// 227 KB only while V stays far below 65,535, the largest index ~0 leaves
// free.
using Node = uint16_t;

// One run's shared-memory state.  Layout, in this order, each part 16-byte
// aligned (kernels/edge_wave.py:worklist_run_bytes computes the same):
// ctl (64 B), stage (32 entries per warp), bits, off, adj, queue, pairs.
struct Run {
  int* ctl;        // [0] queue head, [1] queue tail, [2] warps holding nodes, [3] edges staged
  Node* stage;     // each warp's next batch, 32 entries per warp
  uint32_t* bits;  // ceil(v/32) words: the set so far
  uint32_t* off;   // v entries; after the build, s's out-edges are adj[s ? off[s-1] : 0, off[s])
  Node* adj;       // e entries: destinations grouped by source
  Node* q;         // v entries; a block run's unwritten slots hold the sentinel ~0
  uint32_t* pairs; // e entries: the staged edges, src | dst << 16, in any order
};

__host__ __device__ inline size_t run_bytes(int v, int e, int stage_warps) {
  return 64 + align16((size_t)stage_warps * 32 * sizeof(Node)) + align16((size_t)words_for(v) * 4) +
         align16((size_t)v * 4) + align16((size_t)e * sizeof(Node)) + align16((size_t)v * sizeof(Node)) +
         align16((size_t)e * 4);
}

__device__ inline Run carve(char* p, int v, int e, int stage_warps) {
  Run r;
  r.ctl = reinterpret_cast<int*>(p);
  p += 64;
  r.stage = reinterpret_cast<Node*>(p);
  p += align16((size_t)stage_warps * 32 * sizeof(Node));
  r.bits = reinterpret_cast<uint32_t*>(p);
  p += align16((size_t)words_for(v) * 4);
  r.off = reinterpret_cast<uint32_t*>(p);
  p += align16((size_t)v * 4);
  r.adj = reinterpret_cast<Node*>(p);
  p += align16((size_t)e * sizeof(Node));
  r.q = reinterpret_cast<Node*>(p);
  p += align16((size_t)v * sizeof(Node));
  r.pairs = reinterpret_cast<uint32_t*>(p);
  return r;
}

template <typename T>
__device__ inline T ld_volatile(const T* p) { return *reinterpret_cast<const volatile T*>(p); }

// A group is a whole block (kBlock) or one warp.
template <bool kBlock>
__device__ inline void group_sync() {
  if (kBlock) __syncthreads(); else __syncwarp();
}

// Edge slots a lane loads before it visits any: their loads are in flight
// together, so a pass over a run's edges waits about one device-memory
// latency per kLoads slots instead of one per slot.
constexpr int kLoads = 4;

// f(s, d, ok) for every edge slot, called by all 32 lanes of a warp together
// (warp wi of the group's nw); ok is true for a masked edge with both ends
// in [0, v).  16-byte loads where e % 4 == 0 and the planes are aligned,
// else one element per lane; both coalesced.
template <typename F>
__device__ inline void for_each_edge(const int32_t* es, const int32_t* ed, const uint8_t* em, int v, int e,
                                     int wi, int nw, int lane, F f) {
  auto visit = [&](int s, int d, uint8_t m) {
    f(s, d, m && (unsigned)s < (unsigned)v && (unsigned)d < (unsigned)v);
  };
  const int stride = 32 * nw;
  if ((e & 3) == 0 && aligned(es, 16) && aligned(ed, 16) && aligned(em, 4)) {
    const int n4 = e >> 2;
    for (int g0 = wi * 32; g0 < n4; g0 += kLoads * stride) {  // warp-uniform trip count
      int4 s[kLoads], d[kLoads];
      uchar4 m[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int g = g0 + j * stride + lane;
        s[j] = d[j] = make_int4(0, 0, 0, 0);
        m[j] = make_uchar4(0, 0, 0, 0);
        if (g < n4) {
          s[j] = reinterpret_cast<const int4*>(es)[g];
          d[j] = reinterpret_cast<const int4*>(ed)[g];
          m[j] = reinterpret_cast<const uchar4*>(em)[g];
        }
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        visit(s[j].x, d[j].x, m[j].x);
        visit(s[j].y, d[j].y, m[j].y);
        visit(s[j].z, d[j].z, m[j].z);
        visit(s[j].w, d[j].w, m[j].w);
      }
    }
  } else {
    for (int k0 = wi * 32; k0 < e; k0 += kLoads * stride) {
      int s[kLoads], d[kLoads];
      uint8_t m[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int k = k0 + j * stride + lane;
        s[j] = d[j] = 0;
        m[j] = 0;
        if (k < e) {
          s[j] = es[k];
          d[j] = ed[k];
          m[j] = em[k];
        }
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) visit(s[j], d[j], m[j]);
    }
  }
}

// The 16-byte-aligned region [p, p + bytes) (bytes a multiple of 16) filled
// with copies of `word`, by thread t of nt with 16-byte stores.
__device__ inline void fill16(void* p, size_t bytes, uint32_t word, int t, int nt) {
  const uint4 x = make_uint4(word, word, word, word);
  for (size_t u = t; u < bytes / 16; u += nt) reinterpret_cast<uint4*>(p)[u] = x;
}

// a[0, v) <- its exclusive prefix sums, by the group (thread t of nt; a
// block's scan uses warp_sums[32]).
template <bool kBlock>
__device__ void exclusive_scan(uint32_t* a, int v, int t, int nt, uint32_t* warp_sums) {
  const int chunk = (v + nt - 1) / nt;
  const int lo = min(v, t * chunk), hi = min(v, lo + chunk);
  uint32_t sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  const int lane = threadIdx.x & 31;
  uint32_t x = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (kBlock) {
    const int wi = threadIdx.x >> 5, nw = blockDim.x >> 5;
    if (lane == 31) warp_sums[wi] = x;
    __syncthreads();
    if (wi == 0) {
      uint32_t s = lane < nw ? warp_sums[lane] : 0u;
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += y;
      }
      if (lane < nw) warp_sums[lane] = s;
    }
    __syncthreads();
    if (wi > 0) x += warp_sums[wi - 1];
  }
  uint32_t run = x - sum;
  for (int i = lo; i < hi; ++i) {
    const uint32_t c = a[i];
    a[i] = run;
    run += c;
  }
}

// The masked, in-range edges of the run staged as (src, dst) pairs in
// r.pairs, their count in r.ctl[3], by one coalesced pass over device
// memory (each warp reserves its slots with one atomic); by the group (warp
// wi of nw), ending with a group sync.
template <bool kBlock>
__device__ void stage_edges(const Run& r, const int32_t* es, const int32_t* ed, const uint8_t* em, int v,
                            int e, int wi, int nw, int lane) {
  group_sync<kBlock>();  // r.ctl is zero
  for_each_edge(es, ed, em, v, e, wi, nw, lane, [&](int s, int d, bool ok) {
    const unsigned m = __ballot_sync(kFull, ok);
    if (!m) return;
    int base = 0;
    if (lane == 0) base = atomicAdd(&r.ctl[3], __popc(m));
    base = __shfl_sync(kFull, base, 0);
    if (ok) r.pairs[base + __popc(m & ((1u << lane) - 1u))] = (uint32_t)s | (uint32_t)d << 16;
  });
  group_sync<kBlock>();
}

// Counting sort of the n staged pairs by source into r.off / r.adj, then
// every node of the set so far queued; by the group (thread t of nt).
// r.ctl[0..2] must be zero; ends with a group sync.
template <bool kBlock>
__device__ void build_csr(const Run& r, int v, int n, int t, int nt, uint32_t* warp_sums) {
  fill16(r.off, align16((size_t)v * 4), 0u, t, nt);
  if (kBlock) fill16(r.q, align16((size_t)v * sizeof(Node)), ~0u, t, nt);
  group_sync<kBlock>();
  for (int k = t; k < n; k += nt) atomicAdd(&r.off[r.pairs[k] & 0xffffu], 1u);
  group_sync<kBlock>();
  exclusive_scan<kBlock>(r.off, v, t, nt, warp_sums);
  group_sync<kBlock>();
  // Each source's cursor runs from its start to its end, which is the next
  // source's start: afterwards off[s] is s's end.
  for (int k = t; k < n; k += nt) r.adj[atomicAdd(&r.off[r.pairs[k] & 0xffffu], 1u)] = (Node)(r.pairs[k] >> 16);
  for (int i = t; i < words_for(v); i += nt) {
    uint32_t word = r.bits[i];
    while (word) {
      const int b = __ffs(word) - 1;
      word &= word - 1;
      r.q[atomicAdd(&r.ctl[1], 1)] = (Node)(i * 32 + b);
    }
  }
  group_sync<kBlock>();
}

// Sets d's bit; true iff it was not set before.  (No plain read first: on
// a chain every hop sets a new bit, and the read would add its latency.)
__device__ inline bool set_bit(uint32_t* bits, int d) {
  const uint32_t bit = 1u << (d & 31);
  return !(atomicOr(&bits[d >> 5], bit) & bit);
}

// A chain from node n (newly set, and the whole of a warp's batch): while
// the node has exactly one out-edge and its destination is new, step to the
// destination.  Lane 0 walks it alone, with no warp
// collective per hop: two loads of the offsets, one of the destination and
// an atomicOr.  Returns (to every lane) the node that needs the general
// expansion (out-degree 0 or above 1), or -1 where the chain ran into a node
// already set.
__device__ inline int follow_chain(const Run& r, int n, int lane) {
  if (lane == 0) {
    for (;;) {
      const int beg = n ? (int)r.off[n - 1] : 0;
      if ((int)r.off[n] - beg != 1) break;
      const int d = r.adj[beg];
      if (!set_bit(r.bits, d)) {
        n = -1;
        break;
      }
      n = d;
    }
  }
  return __shfl_sync(kFull, n, 0);
}

// Warp-collective: the lanes whose `fresh` is true newly set node d.  They
// go to this warp's next batch while it has room, the rest to the shared
// queue.  The next batch is `nb` nodes (warp-uniform): while it is a single
// node found alone (the chain case) it stays in a register, `single`, and
// never touches shared memory; otherwise it is stage[0, nb).
__device__ inline void emit(bool fresh, int d, int lane, const Run& r, Node* stage, int& nb,
                            int& single) {
  const unsigned m = __ballot_sync(kFull, fresh);
  if (!m) return;
  const int c = __popc(m);
  if (nb == 0 && c == 1) {
    single = __shfl_sync(kFull, d, __ffs(m) - 1);
    nb = 1;
    return;
  }
  if (single >= 0) {  // the batch outgrows the register
    if (lane == 0) stage[0] = (Node)single;
    single = -1;
  }
  const int rank = __popc(m & ((1u << lane) - 1u));
  const int room = 32 - nb;
  if (fresh && rank < room) stage[nb + rank] = (Node)d;
  if (c > room) {
    int base = 0;
    if (lane == 0) base = atomicAdd(&r.ctl[1], c - room);
    base = __shfl_sync(kFull, base, 0);
    if (fresh && rank >= room) *reinterpret_cast<volatile Node*>(&r.q[base + rank - room]) = (Node)d;
    nb = 32;
  } else {
    nb += c;
  }
}

// A run's traversal, warp wi's part (a warp run has one warp, a block run
// all the block's).  The warps share the queue.  A
// warp takes up to 32 nodes at a time, one per lane, and walks their
// out-edges (lane-parallel for small out-degrees, all 32 lanes over one
// node's edges for large ones), setting destination bits with atomicOr.
// The nodes it newly sets become its own next batch, and only the overflow
// beyond 32 goes to the queue; a batch of one node is followed as a chain
// by lane 0 (follow_chain).  A warp ends when the queue is empty and no warp
// holds a node: r.ctl[2] counts the warps that hold nodes; a warp counts
// itself before it takes from the queue and uncounts itself only after
// finding the queue empty, so no node is ever held by an uncounted warp.
__device__ void traverse(const Run& r, int wi, int lane) {
  constexpr Node kSentinel = (Node)~(Node)0;
  Node* stage = r.stage + wi * 32;
  int nb = 0;            // nodes in the next batch (warp-uniform)
  int single = -1;       // the next batch's one node, while it has one (warp-uniform)
  bool holding = false;  // this warp is counted in r.ctl[2] (warp-uniform)
  for (;;) {
    int node = -1;
    if (single >= 0) {
      const int n = follow_chain(r, single, lane);
      single = -1;
      nb = 0;
      if (n < 0) continue;
      if (lane == 0) node = n;
    } else if (nb > 0) {
      __syncwarp();
      if (lane < nb) node = stage[lane];
      nb = 0;
      __syncwarp();
    } else {
      int h = 0, n = 0;  // n: nodes taken; 0: the queue looked empty; -1: lost a race
      if (lane == 0) {
        h = ld_volatile(&r.ctl[0]);
        const int tail = ld_volatile(&r.ctl[1]);
        if (h < tail) {
          if (!holding) atomicAdd(&r.ctl[2], 1);
          n = min(32, tail - h);
          if (atomicCAS(&r.ctl[0], h, h + n) != h) n = -1;
        }
      }
      n = __shfl_sync(kFull, n, 0);
      h = __shfl_sync(kFull, h, 0);
      if (n != 0) holding = true;
      if (n < 0) continue;
      if (n == 0) {
        int done = 0;
        if (lane == 0) {
          if (holding) atomicSub(&r.ctl[2], 1);
          done = ld_volatile(&r.ctl[2]) == 0 && ld_volatile(&r.ctl[0]) == ld_volatile(&r.ctl[1]);
        }
        holding = false;
        if (__shfl_sync(kFull, done, 0)) break;
        __nanosleep(128);
        continue;
      }
      // A warp run's queue slots were written by this warp's lanes (emit):
      // the warp barrier orders those stores before these loads.  A block
      // run's may be written by another warp still: its slots start as the
      // sentinel, and a lane spins until its slot is written.
      __syncwarp();
      if (lane < n) {
        Node x;
        do x = ld_volatile(&r.q[h + lane]); while (x == kSentinel);
        node = x;
      }
    }
    int beg = 0, deg = 0;
    if (node >= 0) {
      beg = node ? (int)r.off[node - 1] : 0;
      deg = (int)r.off[node] - beg;
    }
    const bool heavy = deg > kHeavyDegree;
    const int ldeg = heavy ? 0 : deg;
    const int max_deg = (int)__reduce_max_sync(kFull, (unsigned)ldeg);
    for (int k = 0; k < max_deg; ++k) {
      int d = 0;
      bool fresh = false;
      if (k < ldeg) {
        d = r.adj[beg + k];
        fresh = set_bit(r.bits, d);
      }
      emit(fresh, d, lane, r, stage, nb, single);
    }
    for (unsigned hm = __ballot_sync(kFull, heavy); hm; hm &= hm - 1) {
      const int j = __ffs(hm) - 1;
      const int hb = __shfl_sync(kFull, beg, j), hd = __shfl_sync(kFull, deg, j);
      for (int k0 = 0; k0 < hd; k0 += 32) {
        const int k = k0 + lane;
        int d = 0;
        bool fresh = false;
        if (k < hd) {
          d = r.adj[hb + k];
          fresh = set_bit(r.bits, d);
        }
        emit(fresh, d, lane, r, stage, nb, single);
      }
    }
  }
}

// Visits of staged pairs a thread may spend sweeping before its run is
// finished by traversal instead.
constexpr int kSweepBudget = 64;

// In-place sweeps of the n staged pairs by the group (thread t of nt): every
// edge whose source is set sets its destination.  A sweep that sets nothing
// leaves the run at its fix point: returns true.  Returns false once a
// thread has visited kSweepBudget pairs; the set so far then lies between
// the state and its fix point, and has the same fix point.
template <bool kBlock>
__device__ bool sweep(const Run& r, int n, int t, int nt) {
  const int per_thread = max(1, (n + nt - 1) / nt);
  for (int visits = 0; visits < kSweepBudget; visits += per_thread) {
    int changed = 0;
    for (int k0 = t; k0 < n; k0 += kLoads * nt) {
      // kLoads pairs at a time, each step's loads issued together: the
      // pairs, their sources' words, their destinations' words, then an
      // atomicOr for each destination that is newly reached.
      uint32_t p[kLoads], src_word[kLoads], dst_word[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) p[j] = k0 + j * nt < n ? r.pairs[k0 + j * nt] : 0u;
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        src_word[j] = k0 + j * nt < n ? ld_volatile(&r.bits[(p[j] & 0xffffu) >> 5]) : 0u;
        dst_word[j] = ld_volatile(&r.bits[p[j] >> 21]);
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const uint32_t bit = 1u << (p[j] >> 16 & 31);
        if ((src_word[j] >> (p[j] & 31) & 1u) && !(dst_word[j] & bit))
          changed |= !(atomicOr(&r.bits[p[j] >> 21], bit) & bit);
      }
    }
    if (!(kBlock ? __syncthreads_or(changed) : __any_sync(kFull, changed))) return true;
  }
  return false;
}

// The run's fix point in r.bits, from its start state `st` (v bool bytes),
// by the group (warp wi of nw); r.ctl must be zero.  The state's bytes are
// prefetched and its edges staged in shared memory, so both trips to
// device memory overlap; then the state is packed.  Sweeps finish the runs
// that are shallow or have few edges, where a sweep of the staged pairs
// costs less than the CSR's O(V) set-up and its hops of dependent loads;
// what the budget leaves unfinished (deep chains over many edges) is
// finished by the traversal of a CSR built from the same pairs.
template <bool kBlock>
__device__ void fix_point(const Run& r, const uint8_t* st, const int32_t* es, const int32_t* ed,
                          const uint8_t* em, int v, int e, int wi, int nw, int lane, uint32_t* warp_sums) {
  const int t = wi * 32 + lane, nt = nw * 32;
  for (int i = t * 128; i < v; i += nt * 128) asm volatile("prefetch.global.L1 [%0];" ::"l"(st + i));
  stage_edges<kBlock>(r, es, ed, em, v, e, wi, nw, lane);
  pack_row(st, v, r.bits, wi, nw, lane);
  group_sync<kBlock>();
  const int n = r.ctl[3];
  if (sweep<kBlock>(r, n, t, nt)) return;
  build_csr<kBlock>(r, v, n, t, nt, warp_sums);
  traverse(r, wi, lane);
}

// One block per run.
__global__ void __launch_bounds__(1024) edge_wave_worklist_block(
    const uint8_t* __restrict__ state, const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const uint8_t* __restrict__ mask, uint8_t* __restrict__ out, int v, int e, long long edge_stride) {
  extern __shared__ __align__(16) char smem_raw[];
  __shared__ uint32_t warp_sums[32];
  const int nw = blockDim.x >> 5, wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Run r = carve(smem_raw, v, e, nw);
  const long long row = blockIdx.x;
  if (threadIdx.x < 16) r.ctl[threadIdx.x] = 0;
  fix_point<true>(r, state + row * v, src + row * edge_stride, dst + row * edge_stride,
                  mask + row * edge_stride, v, e, wi, nw, lane, warp_sums);
  __syncthreads();
  unpack_row(r.bits, v, out + row * v, threadIdx.x, blockDim.x);
}

// One warp per run, blockDim.x / 32 runs per block, run_stride bytes of
// shared memory each.
__global__ void edge_wave_worklist_warp(const uint8_t* __restrict__ state, const int32_t* __restrict__ src,
                                        const int32_t* __restrict__ dst, const uint8_t* __restrict__ mask,
                                        uint8_t* __restrict__ out, int b, int v, int e,
                                        long long edge_stride, int run_stride) {
  extern __shared__ __align__(16) char smem_raw[];
  const int wi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + wi;
  if (row >= b) return;
  const Run r = carve(smem_raw + (size_t)wi * run_stride, v, e, 1);
  if (lane < 16) r.ctl[lane] = 0;
  fix_point<false>(r, state + row * v, src + row * edge_stride, dst + row * edge_stride,
                   mask + row * edge_stride, v, e, 0, 1, lane, nullptr);
  __syncwarp();
  unpack_row(r.bits, v, out + row * v, lane, 32);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

cudaError_t launch_worklist(int variant, const void* state, const void* src, const void* dst,
                            const void* mask, void* out, int b, int v, int e, long long edge_stride,
                            int runs_per_block, int threads, size_t smem, cudaStream_t st) {
  const auto* s8 = (const uint8_t*)state;
  const auto* es = (const int32_t*)src;
  const auto* ed = (const int32_t*)dst;
  const auto* em = (const uint8_t*)mask;
  auto* o8 = (uint8_t*)out;
  if (variant == kWorklistBlock) {
    if (threads % 32 || threads > 1024 || run_bytes(v, e, threads / 32) > smem)
      return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(edge_wave_worklist_block, smem);
    if (err != cudaSuccess) return err;
    edge_wave_worklist_block<<<b, threads, smem, st>>>(s8, es, ed, em, o8, v, e, edge_stride);
  } else {
    const size_t per_run = run_bytes(v, e, 1);
    if (threads != 32 * runs_per_block || per_run * runs_per_block > smem) return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(edge_wave_worklist_warp, smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks = (unsigned)((b + runs_per_block - 1) / runs_per_block);
    edge_wave_worklist_warp<<<blocks, threads, smem, st>>>(s8, es, ed, em, o8, b, v, e, edge_stride,
                                                           (int)per_run);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[b] = state[b] after n_steps waves (n_steps < 0: the fix point), by
// the launch plan (variant, runs_per_block, threads, smem bytes) that
// kernels/edge_wave.py:edge_wave_plan chose.  state/out: [b,v]
// bool bytes; src/dst: int32, mask: bool bytes, each [b,e] (shared_edges =
// 0) or [e] (shared_edges = 1); all contiguous on the device.
int nemo_edge_wave(const void* state, const void* src, const void* dst, const void* mask, void* out,
                   int b, int v, int e, int shared_edges, int n_steps, int variant, int runs_per_block,
                   int threads, long long smem, void* stream) {
  if (b <= 0 || v <= 0) return (int)cudaSuccess;
  if (e < 0 || smem < 0 || (size_t)smem > kMaxSmemBytes || threads <= 0 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long edge_stride = shared_edges ? 0 : (long long)e;
  switch (variant) {
    case kWavesStaged:
    case kWavesStreamed: {
      const bool staged = variant == kWavesStaged;
      if ((size_t)smem < bitset_bytes(v) + (staged ? (size_t)e * sizeof(int2) : 0))
        return (int)cudaErrorInvalidValue;
      cudaError_t err;
      if (staged) {
        err = allow_smem(edge_wave_kernel<true>, (size_t)smem);
        if (err != cudaSuccess) return (int)err;
        edge_wave_kernel<true><<<b, threads, smem, st>>>((const uint8_t*)state, (const int32_t*)src,
                                                         (const int32_t*)dst, (const uint8_t*)mask,
                                                         (uint8_t*)out, v, e, edge_stride, n_steps);
      } else {
        err = allow_smem(edge_wave_kernel<false>, (size_t)smem);
        if (err != cudaSuccess) return (int)err;
        edge_wave_kernel<false><<<b, threads, smem, st>>>((const uint8_t*)state, (const int32_t*)src,
                                                          (const int32_t*)dst, (const uint8_t*)mask,
                                                          (uint8_t*)out, v, e, edge_stride, n_steps);
      }
      return (int)cudaGetLastError();
    }
    case kWorklistBlock:
    case kWorklistWarp:
      // A Node is 16 bits, and ~0 is the queue's sentinel.
      if (n_steps >= 0 || runs_per_block <= 0 || v >= 65535) return (int)cudaErrorInvalidValue;
      return (int)launch_worklist(variant, state, src, dst, mask, out, b, v, e, edge_stride, runs_per_block,
                                  threads, (size_t)smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Shared-memory bytes of one worklist run (kernels/edge_wave.py computes the
// same; chip_smoke.py holds the two against each other).
long long nemo_edge_wave_run_bytes(int v, int e, int stage_warps) { return (long long)run_bytes(v, e, stage_warps); }

const char* nemo_edge_wave_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
