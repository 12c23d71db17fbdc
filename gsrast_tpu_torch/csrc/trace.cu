// Device marks of the program's spans (`utils/profiling.py`), for Hopper (sm_90a), bound
// to Python through ctypes.
//
// A CUDA graph's replay reaches the profiler as kernels and nothing else: no host range
// of the Python that captured it runs again. So, where tracing is on, each span also
// launches one of these kernels on the current stream at its start and at its end, and
// the work captured between two marks carries its span into every replay. A mark's span
// and edge are its template arguments, so the device trace alone names them:
// `gsrast_span_mark<id, edge>`, id the span's index in `profiling.SPANS`, edge 0 at the
// start and 1 at the end. A mark does no work.

#include <cuda_runtime.h>

#include <array>
#include <utility>

constexpr int kSpans = 32;  // profiling.SPANS may hold at most this many names

template <int Span, int Edge>
__global__ void gsrast_span_mark() {}

using MarkFn = void (*)();

namespace {

template <std::size_t... S>
std::array<std::array<MarkFn, 2>, sizeof...(S)> mark_table(
    std::index_sequence<S...>) {
  return {{{{gsrast_span_mark<S, 0>, gsrast_span_mark<S, 1>}}...}};
}

const std::array<std::array<MarkFn, 2>, kSpans> kMarks =
    mark_table(std::make_index_sequence<kSpans>{});

}  // namespace

// One mark of span `span` (0 <= span < kSpans), edge 0 (start) or 1 (end), on `stream`.
// Does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int gsrast_trace_mark(int span, int edge, void* stream) {
  if (span < 0 || span >= kSpans || edge < 0 || edge > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const MarkFn mark = kMarks[span][edge];
  mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
