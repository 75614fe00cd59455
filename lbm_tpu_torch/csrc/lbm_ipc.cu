// The halo exchange's kernels on Hopper (sm_90a), hand-written CUDA C++:
// the device transport between processes on one host (CUDA IPC memory and
// events, and the two kernels that move an exchange's pieces through a
// mailbox), and the copy of every piece of one phase between the shards of
// one process on one card in one launch.
//
// Replaces: no Pallas kernel.  lbm_tpu moves every halo piece device to
// device with `lax.ppermute` inside its one SPMD program
// (lbm_tpu/parallel/sharded.py:85-96, 156-163, 310-320, 626-627,
// 1118-1123); pack and unpack stand in for ppermute's transfer between
// processes that share a host (parallel/ipc.py), `lbm_exchange_copy` for
// its transfer between the shards of one process (parallel/halo.py), one
// launch a phase in place of one `Tensor.copy_` a piece.
//
// The mailbox.  Each process cudaMallocs one block for every message it
// receives (per sending peer, phase and parity) and hands its IPC handle to
// the peers, which map it once.  A sender packs one phase's pieces for one
// peer straight into that peer's mailbox (one launch, not one copy a
// piece); the receiver unpacks its mailbox into the destination views on
// its own stream.  Inter-process events order the two: the sender records
// one after its pack, the receiver's stream waits on it before the unpack
// and records its own after, which the sender's stream waits on before it
// reuses that parity.  The host only passes sequence numbers (parallel/ipc.py);
// nothing here polls on the device, since two processes without MPS
// time-slice the card and a spinning kernel would hold it for a slice.
//
// A piece is a strided 3-D view [planes][rows][cols] of a shard buffer:
// a y-phase piece is h owned rows of the owned columns (runs of a row's
// width), an x-phase piece h columns over every padded row (runs of h).
// The device table gives each piece as 8 int64 words (PieceRow).  A
// piece's element e (planes, rows, cols, row-major) sits at mailbox
// offset + e, so the mailbox holds each piece as `view.contiguous()` would.
//
// The copy within one process: its device table gives each piece of a
// phase as a source view and a destination view of the same shape
// (CopyRow), and the launch copies them all at once, so no piece's
// destination may overlap another piece's source or destination
// (parallel/halo.py checks this when it builds the table).  The y phase's
// launch precedes the x phase's on one stream, since the x phase's columns
// carry the rows the y phase brought.
//
// Bound: device-memory bytes, each element read once and written once (8 B
// an element); the pieces are small (18-1200 KB a message or phase on the
// main path), so a launch is mostly its fixed cost.  One thread an
// element, a grid-stride loop over a piece in blockIdx.x, one piece a
// blockIdx.y.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;
// The handles' size, CUDA_IPC_HANDLE_SIZE, as parallel/ipc.py copies them.
static_assert(sizeof(cudaIpcMemHandle_t) == 64 && sizeof(cudaIpcEventHandle_t) == 64,
              "64-byte IPC handles");

struct PieceRow {
  long long ptr;  // the view's first element (float*)
  long long plane_stride, row_stride, col_stride;  // in floats
  long long planes, rows, cols;
  long long offset;  // in floats, into the mailbox
};
static_assert(sizeof(PieceRow) == 8 * sizeof(long long), "8 int64 words a piece");

template <bool kPack>
__global__ void __launch_bounds__(kThreads)
exchange_kernel(const PieceRow* __restrict__ table, float* __restrict__ mailbox) {
  const PieceRow p = table[blockIdx.y];
  const int cols = static_cast<int>(p.cols);
  const int per_plane = static_cast<int>(p.rows) * cols;
  const int n = static_cast<int>(p.planes) * per_plane;
  float* view = reinterpret_cast<float*>(p.ptr);
  float* box = mailbox + p.offset;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < n; e += gridDim.x * kThreads) {
    const int k = e / per_plane;
    const int rem = e - k * per_plane;
    const int r = rem / cols;
    const int c = rem - r * cols;
    const long long at = k * p.plane_stride + r * p.row_stride + c * p.col_stride;
    if (kPack) {
      box[e] = view[at];
    } else {
      view[at] = box[e];
    }
  }
}

struct CopyRow {
  long long src;  // the source view's first element (const float*)
  long long src_plane, src_row, src_col;  // in floats
  long long dst;  // the destination view's first element (float*)
  long long dst_plane, dst_row, dst_col;
  long long planes, rows, cols;
  long long pad;
};
static_assert(sizeof(CopyRow) == 12 * sizeof(long long), "12 int64 words a piece");

__global__ void __launch_bounds__(kThreads) copy_kernel(const CopyRow* __restrict__ table) {
  const CopyRow p = table[blockIdx.y];
  const int cols = static_cast<int>(p.cols);
  const int per_plane = static_cast<int>(p.rows) * cols;
  const int n = static_cast<int>(p.planes) * per_plane;
  const float* src = reinterpret_cast<const float*>(p.src);
  float* dst = reinterpret_cast<float*>(p.dst);
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < n; e += gridDim.x * kThreads) {
    const int k = e / per_plane;
    const int rem = e - k * per_plane;
    const int r = rem / cols;
    const int c = rem - r * cols;
    dst[k * p.dst_plane + r * p.dst_row + c * p.dst_col] =
        src[k * p.src_plane + r * p.src_row + c * p.src_col];
  }
}

int grid_x(int max_numel) {
  const int blocks = (max_numel + kThreads - 1) / kThreads;
  return blocks > kMaxBlocksX ? kMaxBlocksX : blocks;
}

template <bool kPack>
int launch_exchange(const void* table, int pieces, int max_numel, float* mailbox,
                    void* stream) {
  if (pieces < 1 || pieces > 65535 || max_numel < 1) return cudaErrorInvalidValue;
  exchange_kernel<kPack><<<dim3(grid_x(max_numel), pieces), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const PieceRow*>(table), mailbox);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A block of `floats` floats of device memory of its own (not a caching
// allocator's segment, whose IPC handle would name the whole segment), on
// the current device.
int lbm_ipc_malloc(int floats, void** out) {
  if (floats < 1) return cudaErrorInvalidValue;
  return cudaMalloc(out, static_cast<size_t>(floats) * sizeof(float));
}

int lbm_ipc_free(void* ptr) { return cudaFree(ptr); }

int lbm_ipc_mem_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) std::memcpy(handle, &h, sizeof h);
  return err;
}

// Maps a peer process's block (its own handle cannot be opened: the
// runtime refuses it); a peer card's memory through P2P.
int lbm_ipc_open_mem(const void* handle, void** out) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof h);
  return cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

int lbm_ipc_close_mem(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

int lbm_ipc_event_create(void** out) {
  cudaEvent_t ev;
  const cudaError_t err =
      cudaEventCreateWithFlags(&ev, cudaEventInterprocess | cudaEventDisableTiming);
  if (err == cudaSuccess) *out = ev;
  return err;
}

int lbm_ipc_event_handle(void* event, void* handle) {
  cudaIpcEventHandle_t h;
  const cudaError_t err = cudaIpcGetEventHandle(&h, static_cast<cudaEvent_t>(event));
  if (err == cudaSuccess) std::memcpy(handle, &h, sizeof h);
  return err;
}

int lbm_ipc_event_open(const void* handle, void** out) {
  cudaIpcEventHandle_t h;
  std::memcpy(&h, handle, sizeof h);
  cudaEvent_t ev;
  const cudaError_t err = cudaIpcOpenEventHandle(&ev, h);
  if (err == cudaSuccess) *out = ev;
  return err;
}

int lbm_ipc_event_destroy(void* event) {
  return cudaEventDestroy(static_cast<cudaEvent_t>(event));
}

int lbm_ipc_event_record(void* event, void* stream) {
  return cudaEventRecord(static_cast<cudaEvent_t>(event), static_cast<cudaStream_t>(stream));
}

// The stream waits for the event's latest record at the time of this call.
int lbm_ipc_stream_wait(void* stream, void* event) {
  return cudaStreamWaitEvent(static_cast<cudaStream_t>(stream),
                             static_cast<cudaEvent_t>(event), 0);
}

// Gathers `pieces` pieces (the device table) into the mailbox: piece i's
// element e to mailbox[offset_i + e].  max_numel: the largest piece's
// elements (sizes the grid).
int lbm_exchange_pack(const void* table, int pieces, int max_numel, void* mailbox,
                      void* stream) {
  return launch_exchange<true>(table, pieces, max_numel, static_cast<float*>(mailbox),
                               stream);
}

// Scatters the mailbox into the pieces' views: the inverse of the pack.
int lbm_exchange_unpack(const void* table, int pieces, int max_numel, void* mailbox,
                        void* stream) {
  return launch_exchange<false>(table, pieces, max_numel, static_cast<float*>(mailbox),
                                stream);
}

// Copies `pieces` pieces (the device table of CopyRow) of one phase, each
// source view into its destination view; max_numel: the largest piece's
// elements (sizes the grid).
int lbm_exchange_copy(const void* table, int pieces, int max_numel, void* stream) {
  if (pieces < 1 || pieces > 65535 || max_numel < 1) return cudaErrorInvalidValue;
  copy_kernel<<<dim3(grid_x(max_numel), pieces), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(static_cast<const CopyRow*>(table));
  return cudaGetLastError();
}

}  // extern "C"
