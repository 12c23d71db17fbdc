// cp.async on the host (tests only, with cuda_runtime.h here): a plain copy
// of size - zfill bytes and zeros for the rest; commit and wait do nothing.
#pragma once
#include <cstddef>
#include <cstring>

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size, size_t zfill = 0) {
  std::memcpy(dst, src, size - zfill);
  std::memset(static_cast<char*>(dst) + size - zfill, 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
