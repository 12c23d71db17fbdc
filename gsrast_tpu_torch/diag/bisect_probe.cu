// Probes of the card's memory path for bisection kernel B (sm_90a), built and run by
// `python -m gsrast_tpu_torch.diag.bisect_timing --probe` and by chip_smoke.py's
// phase 11; not part of the kernel library.
//
// B reads 8 floats of each 512-byte row, 64 bytes apart, and writes whole rows. How
// many bytes those reads cost depends on what the L2 fetches from HBM on a miss: a
// 32-byte sector (then B moves 1.5 times its output) or a 64-byte granule (then every
// byte of the input, as A moves). The probes:
// - gsrast_probe_fetch_granularity: cudaDeviceGetLimit(cudaLimitMaxL2FetchGranularity),
//   a hint to the L2 (only read, never set: it is device-wide state);
// - gsrast_probe_read: a streaming read of one float every `stride` floats of n
//   (stride 1 reads every float, as float4), summed so that no load is dropped;
// - gsrast_probe_write: a streaming write of n floats, as float4.

#include <cuda_runtime.h>

namespace {

constexpr int kProbeThreads = 256;

__global__ void __launch_bounds__(kProbeThreads)
read_kernel(const float* __restrict__ in, long long n, int stride,
            float* __restrict__ sink) {
  float acc = 0.0f;
  const long long step = static_cast<long long>(gridDim.x) * kProbeThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kProbeThreads +
                          threadIdx.x;
  if (stride == 1) {
    const float4* in4 = reinterpret_cast<const float4*>(in);
    for (long long i = first; i < n / 4; i += step) {
      const float4 v = in4[i];
      acc += v.x + v.y + v.z + v.w;
    }
  } else {
    for (long long i = first; i < n / stride; i += step) acc += in[i * stride];
  }
  if (acc == -1.0f) sink[0] = acc;  // the inputs are >= 0: never taken
}

__global__ void __launch_bounds__(kProbeThreads)
write_kernel(float4* __restrict__ out, long long n4) {
  const long long step = static_cast<long long>(gridDim.x) * kProbeThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kProbeThreads +
                     threadIdx.x;
       i < n4; i += step) {
    out[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

int grid_of() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return 8 * sms;  // 8 blocks of 256 threads an SM: every SM full
}

}  // namespace

extern "C" int gsrast_probe_fetch_granularity(unsigned long long* bytes) {
  size_t value = 0;
  const cudaError_t err = cudaDeviceGetLimit(&value, cudaLimitMaxL2FetchGranularity);
  *bytes = value;
  return static_cast<int>(err);
}

// in: n floats, 16-byte aligned, n a multiple of 4 and of stride; sink: one float.
extern "C" int gsrast_probe_read(const float* in, long long n, int stride, float* sink,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  read_kernel<<<grid_of(), kProbeThreads, 0, s>>>(in, n, stride, sink);
  return static_cast<int>(cudaGetLastError());
}

// out: n floats, 16-byte aligned, n a multiple of 4.
extern "C" int gsrast_probe_write(float* out, long long n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  write_kernel<<<grid_of(), kProbeThreads, 0, s>>>(reinterpret_cast<float4*>(out),
                                                   n / 4);
  return static_cast<int>(cudaGetLastError());
}
