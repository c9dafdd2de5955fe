// In-graph host calls (paper §3.5) for the port's CUDA programs: the
// counterpart of the reference's io_callback / pure_callback
// (repro/core/hostcall.py: HostCallTable.hostcall, hostcall_value).
//
// No kernel: a call is three stream operations, enqueued in order on the
// caller's stream by repro_hostcall: a copy of each device argument into
// pinned host staging, a host function (cudaLaunchHostFunc) that runs the
// Python dispatch through a ctypes callback, and, for a call that returns
// a value, a copy of the pinned result back to the device, where later
// kernels of the same stream read it.  Stream capture records them as two
// memcpy nodes around a host node, so a captured program runs the call
// once per replay, in program order.  The host function must not call the
// CUDA API (the runtime forbids it); it reads and writes the pinned
// staging only.
//
// repro_host_alloc swaps the thread's capture mode to relaxed around
// cudaHostAlloc, so a call made while a graph is captured (global mode)
// can still allocate its staging.

#include <cuda_runtime.h>

extern "C" {

typedef void (*repro_host_fn)(void*);

int repro_hostcall(void* stream, repro_host_fn fn, void* user, int n_args,
                   const void* const* dev_args, void* const* host_args,
                   const long long* arg_bytes, const void* host_out,
                   void* dev_out, long long out_bytes) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n_args; ++i) {
    if (arg_bytes[i] <= 0) continue;
    cudaError_t err = cudaMemcpyAsync(host_args[i], dev_args[i],
                                      static_cast<size_t>(arg_bytes[i]),
                                      cudaMemcpyDeviceToHost, s);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaLaunchHostFunc(s, fn, user);
  if (err != cudaSuccess) return err;
  if (out_bytes > 0) {
    err = cudaMemcpyAsync(dev_out, host_out, static_cast<size_t>(out_bytes),
                          cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

void* repro_host_alloc(long long bytes) {
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  cudaThreadExchangeStreamCaptureMode(&mode);
  void* p = nullptr;
  cudaError_t err = cudaHostAlloc(&p, static_cast<size_t>(bytes),
                                  cudaHostAllocDefault);
  cudaThreadExchangeStreamCaptureMode(&mode);
  return err == cudaSuccess ? p : nullptr;
}

int repro_host_free(void* p) { return cudaFreeHost(p); }

}  // extern "C"
