// An empty kernel, one thread: what a launch costs on the device when the
// kernel does nothing. The kernels whose shapes are a few hundred kilobytes
// (LayerNorm at the UNet's 8x8 maps, batch norm statistics of a [16, 128]
// map) are held against this time beside their byte bound. It replaces no
// TPU kernel and is on no path.
//
// Entry point: launch_floor(), a plain C function that launches on the
// given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int launch_floor(void* stream) {
  launch_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
