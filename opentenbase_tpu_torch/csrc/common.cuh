// Shared helpers of the port's hand-written kernels (built for sm_90a).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace otbt {

constexpr int kThreads = 256;
// Grid-stride launches: enough blocks to fill the 132 SMs of an H100
// several times over, never more blocks than there is work.
inline int grid_for(long long n, int per_thread = 1) {
  long long want = (n + (long long)kThreads * per_thread - 1) /
                   ((long long)kThreads * per_thread);
  const long long cap = 132LL * 16;
  if (want < 1) want = 1;
  return (int)(want < cap ? want : cap);
}

}  // namespace otbt
