// The tracer's span marker (mpmcxx_tpu_torch/tracing.py): one thread that
// does nothing, enqueued on the program's stream at every span boundary
// while device marking is on.  In a device trace its launches split the
// stream's operations by the program span that launched them, in stream
// order, and each one's device start pairs with the host ns the tracer
// kept for that boundary.  The argument is the boundary's index, so a
// trace names which boundary each marker is.  Its name is its own: it
// matches neither the benchmark's marker (torch.cuda._sleep's
// spin_kernel) nor any kernel of the library.

#include <cuda_runtime.h>

__global__ void mpmcxx_span_mark_kernel(int) {}

extern "C" int mpmcxx_span_mark(void* stream, int index) {
  mpmcxx_span_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      index);
  return static_cast<int>(cudaGetLastError());
}
