// Breadth-first distance fields of navigation meshes for NVIDIA Hopper
// (sm_90a): G meshes in one launch, one thread block a mesh.
//
// Not a TPU kernel.  It replaces the lax.while_loop of
// mass_tpu/nav/grid.py (distance_field_from_seeds), which XLA runs inside
// one jitted program, and its port's plain relaxation
// (nav/grid.distance_field_reference), which relaxes 8 hops of 17 small
// launches each between host convergence checks.  The field is the
// fixpoint of
//
//   d = where(alive, min(d, min over intact neighbours (d_nbr + 1)), INF)
//
// from d = 0 at alive seeds and INF = 1 << 28 elsewhere, where the edge
// (i, j)-(i, j+1) is intact when edge_right[i, j] and both nodes are alive
// (edge_down likewise, downwards), and an edge leaving the mesh joins
// nothing.  The kernel gives exactly that field: the hop count over alive
// nodes and intact edges, 0 at alive seeds, and exactly INF at dead nodes
// and at alive nodes no seed reaches.
//
// Bound.  A field is 4 bytes a node (77 x 77 nodes at the agent's full
// width: 23.7 KB a mesh), so bytes and operations are both well under a
// microsecond.  What cannot be made parallel is the hop chain: a node's
// distance waits on its neighbour's along the shortest path, one
// dependent integer step (an add and a min) a hop, for as many hops as
// the longest shortest path.
//
// Design.  Each block writes its mesh into the output as one 32-bit word
// a node: the distance in bits 0-28, the right and down edges that stay
// inside the mesh in bits 29 and 30 and the node's own alive bit in bit
// 31, read from the four boolean masks kInit nodes a thread at a time so
// that their loads are in flight together.  The words stay in device
// memory, which the L1 and L2 caches hold (a full-width mesh is 23.7 KB),
// whatever the mesh's size.  A round relaxes every row,
// then every column, in place: one thread a line runs a min-plus scan
// forwards and one backwards,
//
//   best_k = min(d_k, best_{k-1} + 1)   where node k-1 joins node k
//                                       and node k is alive,
//
// with the line's words loaded kChunk at a time so that the loads of a
// chunk do not wait on each other, and the scan itself a register chain of
// one add and one min a node.  A dead node keeps INF and so passes INF
// on, which is what masking its edges would do: an edge counts only
// between two alive nodes.  Such a round carries a distance down a
// whole straight run of a path, so a field takes as many rounds as its
// shortest paths have turns, not hops.  Relaxing in place (Gauss-Seidel)
// is sound: every value is always the length of some real path and only
// decreases, so the fixpoint is the BFS field whatever the order.  The
// block decides convergence with __syncthreads_or over "this thread
// lowered a distance"; a round that lowers nothing leaves every row and
// every column relaxed, which is the fixpoint.  Nothing reaches the host
// until the field is done.  The last pass clears the flag bits.
//
// The launch goes on the caller's stream, allocates nothing and does not
// synchronise; the entry returns the error of the launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;                    // words a scan loads at once
constexpr int kInit = 8;                     // nodes a thread stages at once
constexpr uint32_t kInf = 1u << 28;          // nav/grid.INF
constexpr uint32_t kDistance = (1u << 29) - 1;
constexpr uint32_t kRight = 1u << 29;        // edge to (i, j + 1)
constexpr uint32_t kDown = 1u << 30;         // edge to (i + 1, j)
constexpr uint32_t kAlive = 1u << 31;

// One relaxation of a line of `count` words at p[0], p[stride], ...,
// forwards or backwards; `link` is the edge bit that joins a word's node
// to the next node of the line.  Returns whether a distance went down.
template <bool kForward>
__device__ __forceinline__ bool relax_line(uint32_t* p, int count,
                                           int stride, uint32_t link) {
  bool lowered = false;
  uint32_t carry = kInf;    // the previous node's distance, scan order
  bool joined = false;      // forwards: the previous node links to this
  for (int first = 0; first < count; first += kChunk) {
    uint32_t w[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int at = kForward ? first + k : count - 1 - first - k;
      if (first + k < count) w[k] = p[static_cast<ptrdiff_t>(at) * stride];
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (first + k >= count) break;
      const int at = kForward ? first + k : count - 1 - first - k;
      const uint32_t d = w[k] & kDistance;
      // backwards, a node's own link joins it to the node scanned before
      const bool from = (kForward ? joined : (w[k] & link) != 0) &&
                        (w[k] & kAlive) != 0;
      const uint32_t best = from ? min(d, carry + 1) : d;
      if (best < d) {
        p[static_cast<ptrdiff_t>(at) * stride] = best | (w[k] & ~kDistance);
        lowered = true;
      }
      carry = best;
      joined = (w[k] & link) != 0;
    }
  }
  return lowered;
}

// masks [meshes, ny, nx] as bytes (0 false); out [meshes, ny, nx] int32,
// which holds the block's words until the last pass.
__global__ void __launch_bounds__(kThreads)
    bfs_field_kernel(const uint8_t* __restrict__ alive,
                     const uint8_t* __restrict__ edge_right,
                     const uint8_t* __restrict__ edge_down,
                     const uint8_t* __restrict__ seeds, int ny, int nx,
                     uint32_t* out) {
  const int n = ny * nx;
  const ptrdiff_t base = static_cast<ptrdiff_t>(blockIdx.x) * n;
  uint32_t* field = out + base;
  for (int first = threadIdx.x; first < n; first += kThreads * kInit) {
    uint8_t live[kInit], seed[kInit], right[kInit], down[kInit];
#pragma unroll
    for (int u = 0; u < kInit; ++u) {
      const int k = first + u * kThreads;
      if (k < n) {
        live[u] = alive[base + k];
        seed[u] = seeds[base + k];
        right[u] = edge_right[base + k];
        down[u] = edge_down[base + k];
      }
    }
#pragma unroll
    for (int u = 0; u < kInit; ++u) {
      const int k = first + u * kThreads;
      if (k >= n) break;
      const int i = k / nx;
      const int j = k - i * nx;
      uint32_t w = live[u] ? kAlive : 0u;
      if (!(live[u] && seed[u])) w |= kInf;
      if (right[u] && j + 1 < nx) w |= kRight;
      if (down[u] && i + 1 < ny) w |= kDown;
      field[k] = w;
    }
  }
  __syncthreads();
  bool lowered;
  do {
    bool mine = false;
    for (int r = threadIdx.x; r < ny; r += kThreads) {
      uint32_t* row = field + static_cast<ptrdiff_t>(r) * nx;
      mine |= relax_line<true>(row, nx, 1, kRight);
      mine |= relax_line<false>(row, nx, 1, kRight);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < nx; c += kThreads) {
      mine |= relax_line<true>(field + c, ny, nx, kDown);
      mine |= relax_line<false>(field + c, ny, nx, kDown);
    }
    lowered = __syncthreads_or(mine) != 0;
  } while (lowered);
  for (int k = threadIdx.x; k < n; k += kThreads)
    field[k] &= kDistance;
}

}  // namespace

// alive, edge_right, edge_down and seeds [meshes, ny, nx] bool (one byte
// each), contiguous; out [meshes, ny, nx] int32.  The caller keeps
// ny * nx below INF so that no distance reaches it.
extern "C" int bfs_launch(const uint8_t* alive, const uint8_t* edge_right,
                          const uint8_t* edge_down, const uint8_t* seeds,
                          int meshes, int ny, int nx, int32_t* out,
                          cudaStream_t stream) {
  if (meshes == 0 || ny == 0 || nx == 0) return static_cast<int>(cudaSuccess);
  bfs_field_kernel<<<meshes, kThreads, 0, stream>>>(
      alive, edge_right, edge_down, seeds, ny, nx,
      reinterpret_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
