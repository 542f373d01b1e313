// Host-side helpers of every library's C entry points: the calling thread's
// device and context, a launch that returns its own error, and the text of
// an error that a cudaError_t alone does not say.
//
// Each library is one translation unit, so `cflearn_error_text` below is
// defined once in each.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include <atomic>
#include <cstdio>
#include <utility>

namespace cflearn {

// The calling thread's text of its last driver failure (a CUresult), read
// through `cflearn_error_text`.
inline char* driver_error_text() {
  static thread_local char text[256] = {};
  return text;
}

// cudaError_t code returned for a driver call that failed; its CUresult is in `driver_error_text()`.
constexpr int kDriverError = cudaErrorUnknown;

// A driver entry point, looked up through the runtime once (thread-safe), so that no library links libcuda.
template <typename Fn>
Fn driver_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<Fn>(fn);
}

// Records `res`, the result of driver call `what`, as this thread's driver error text and returns
// kDriverError; CUDA_SUCCESS returns cudaSuccess.
inline cudaError_t driver_result(CUresult res, const char* what) {
  if (res == CUDA_SUCCESS) return cudaSuccess;
  static const PFN_cuGetErrorName_v6000 name_of = driver_entry<PFN_cuGetErrorName_v6000>("cuGetErrorName");
  static const PFN_cuGetErrorString_v6000 string_of = driver_entry<PFN_cuGetErrorString_v6000>("cuGetErrorString");
  const char* name = nullptr;
  const char* text = nullptr;
  if (name_of == nullptr || name_of(res, &name) != CUDA_SUCCESS) name = "unknown CUresult";
  if (string_of == nullptr || string_of(res, &text) != CUDA_SUCCESS) text = "";
  std::snprintf(driver_error_text(), 256, "%s: %s %d (%s)", what, name, int(res), text);
  return static_cast<cudaError_t>(kDriverError);
}

// For one entry-point call: makes the device that holds `p` current in the calling thread, with its primary
// context bound, and puts the previous device back afterwards. A host thread that has made no CUDA call that
// needs a context has none bound (a new Python thread whose tensors come from the caching allocator makes
// none), and the driver's tensor-map encoder, called before a launch, then fails with
// CUDA_ERROR_INVALID_CONTEXT. cudaSetDevice binds the device's primary context (CUDA 12). The device is the
// pointer's, not the thread's current one: a new thread's current device is 0 whatever the caller's was.
class DeviceOf {
 public:
  explicit DeviceOf(const void* p) {
    driver_error_text()[0] = '\0';
    cudaPointerAttributes attr;
    err_ = cudaPointerGetAttributes(&attr, p);
    if (err_ != cudaSuccess) return;
    if (attr.type != cudaMemoryTypeDevice && attr.type != cudaMemoryTypeManaged) {
      err_ = cudaErrorInvalidDevicePointer;
      return;
    }
    int current = 0;
    err_ = cudaGetDevice(&current);
    if (err_ != cudaSuccess) return;
    err_ = cudaSetDevice(attr.device);
    if (err_ == cudaSuccess && current != attr.device) previous_ = current;
  }
  ~DeviceOf() {
    if (previous_ >= 0) cudaSetDevice(previous_);
  }
  DeviceOf(const DeviceOf&) = delete;
  DeviceOf& operator=(const DeviceOf&) = delete;
  cudaError_t error() const { return err_; }

 private:
  cudaError_t err_ = cudaSuccess;
  int previous_ = -1;
};

// Launches `kernel` and returns this launch's error (a `<<<>>>` launch followed by cudaGetLastError would
// return the thread's last error, which may be older than the launch).
template <typename... Params, typename... Args>
cudaError_t launch_kernel(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                   Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// Raises kernel `Kernel`'s dynamic shared memory limit once per device, not on every launch. The attribute is
// set before the device's flag, so a thread that sees the flag may launch.
template <auto Kernel>
cudaError_t set_smem(int bytes) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<bool> done[MAX_DEVICES];  // zero-initialised: static storage
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace cflearn

// The text of error `err` returned by an entry point of this library on the calling thread: the driver's
// CUresult for a failed driver call, else the runtime's name and description.
extern "C" const char* cflearn_error_text(int err) {
  if (err == cflearn::kDriverError && cflearn::driver_error_text()[0] != '\0') return cflearn::driver_error_text();
  static thread_local char text[256];
  std::snprintf(text, sizeof(text), "%s (%s)", cudaGetErrorName(static_cast<cudaError_t>(err)),
                cudaGetErrorString(static_cast<cudaError_t>(err)));
  return text;
}
