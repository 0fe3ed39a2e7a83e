// Phase stamps for orcvio_tpu_torch/scripts/kernel_phases.py.
//
// Built with -DKPHASES, PHASE(t) records clock64() into a local t, a
// kernel writes the differences of its stamps into a row of g_phase, and
// phases_read() copies g_phase to the host. Built without it, as
// ops/_build.py builds every kernel, PHASE is empty and no stamp exists.
#pragma once

#ifdef KPHASES
#include <cuda_runtime.h>

__device__ long long g_phase[4096][8];

extern "C" int phases_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}

#define PHASE(t) const long long t = clock64()
#else
#define PHASE(t)
#endif
