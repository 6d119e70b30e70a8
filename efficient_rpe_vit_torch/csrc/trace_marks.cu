// Marker kernels of the device spans (utils/tracing.py): one empty kernel
// per span edge, named after it (rpe_mark_begin_<span>, rpe_mark_end_<span>)
// and launched <<<1, 1>>> on the caller's stream. They do no work: in a
// profiler's device trace they show where each span of a train step begins
// and ends, also in a step replayed from a CUDA graph, which holds them as
// nodes. The names are C names, so the trace shows them as they are here.

#include <cuda_runtime.h>

// the spans, in the order of tracing.DEVICE_SPANS
#define RPE_SPANS(X) X(gather) X(forward) X(backward) X(optimizer) X(phi) X(phi_bwd) X(window) X(window_bwd) X(relpos) X(relpos_bwd) X(attn_window) X(attn_window_bwd) X(attn_global) X(attn_global_bwd)

#define RPE_DEFINE(span)                                    \
  extern "C" __global__ void rpe_mark_begin_##span() {}     \
  extern "C" __global__ void rpe_mark_end_##span() {}
RPE_SPANS(RPE_DEFINE)

#define RPE_ENTRY(span)                                                              \
  {"rpe_mark_begin_" #span, reinterpret_cast<const void*>(rpe_mark_begin_##span)},   \
  {"rpe_mark_end_" #span, reinterpret_cast<const void*>(rpe_mark_end_##span)},

namespace {

struct Mark {
  const char* name;
  const void* kernel;
};

const Mark MARKS[] = {RPE_SPANS(RPE_ENTRY)};
constexpr int COUNT = static_cast<int>(sizeof(MARKS) / sizeof(MARKS[0]));

}  // namespace

extern "C" {

int rpe_mark_count() { return COUNT; }

// The name of marker i (0 <= i < rpe_mark_count()), else null.
const char* rpe_mark_name(int i) { return i >= 0 && i < COUNT ? MARKS[i].name : nullptr; }

// Launches marker i on `stream`; returns the CUDA error code.
int rpe_mark_launch(int i, void* stream) {
  if (i < 0 || i >= COUNT) return cudaErrorInvalidValue;
  return cudaLaunchKernel(MARKS[i].kernel, dim3(1), dim3(1), nullptr, 0,
                          static_cast<cudaStream_t>(stream));
}

const char* rpe_mark_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
