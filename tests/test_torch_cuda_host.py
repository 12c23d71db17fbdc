"""The host stand-in of the CUDA runtime (`tests/cuda_host/`) that the
kernel sources' CPU tests build against: its warp intrinsics
(`__match_any_sync`, `__ballot_sync`, `__shfl_up_sync`, `__popc`, `__ffs`),
`__threadfence`, `atomicInc` and `__ldcg`, each checked by a small kernel
of its own run through the stand-in's `launch` against what the card
does."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = r"""
#include <cuda_runtime.h>

__global__ void match_kernel(const int* values, unsigned* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = __match_any_sync(0xffffffffu, values[i]);
}

__global__ void ballot_kernel(const int* values, unsigned* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = __ballot_sync(0xffffffffu, values[i] > 0);
}

__global__ void shfl_up_kernel(const int* values, int* out, unsigned delta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = __shfl_up_sync(0xffffffffu, values[i], delta);
}

__global__ void popc_kernel(const unsigned* values, int* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[2 * i] = __popc(values[i]);
  out[2 * i + 1] = __ffs(static_cast<int>(values[i]));
}

// The last block to take the ticket sums every block's value.
__global__ void last_block_kernel(int* values, unsigned* ticket, int* sum, int* last) {
  __shared__ bool is_last;
  if (threadIdx.x == 0) values[blockIdx.x] = static_cast<int>(blockIdx.x) + 1;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (is_last && threadIdx.x == 0) {
    __threadfence();
    int s = 0;
    for (unsigned b = 0; b < gridDim.x; ++b) s += __ldcg(values + b);
    *sum = s;
    *last = static_cast<int>(blockIdx.x);
  }
}

extern "C" void run_match(const int* values, unsigned* out, int blocks, int threads) {
  launch(blocks, threads, match_kernel, values, out);
}
extern "C" void run_ballot(const int* values, unsigned* out, int blocks, int threads) {
  launch(blocks, threads, ballot_kernel, values, out);
}
extern "C" void run_shfl_up(const int* values, int* out, int threads, unsigned delta) {
  launch(1, threads, shfl_up_kernel, values, out, delta);
}
extern "C" void run_popc(const unsigned* values, int* out, int n) {
  launch(1, n, popc_kernel, values, out);
}
extern "C" void run_last_block(int* values, unsigned* ticket, int* sum, int* last, int blocks) {
  launch(blocks, 64, last_block_kernel, values, ticket, sum, last);
}
extern "C" unsigned run_atomic_inc(unsigned* address, unsigned limit) {
  return atomicInc(address, limit);
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("cuda_host")
    cpp, so = out / "intrinsics.cpp", out / "libintrinsics.so"
    cpp.write_text(SOURCE)
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                    "-I", os.path.join(HERE, "cuda_host"), "-o", str(so),
                    str(cpp)], check=True)
    return ctypes.CDLL(str(so))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _lanes(threads: int) -> list:
    """Each thread's (first lane of its warp, lanes in its warp)."""
    return [(t - t % 32, min(32, threads - (t - t % 32)))
            for t in range(threads)]


@pytest.mark.parametrize("threads", [64, 48])
def test_match_any_sync(host, threads):
    """Each lane gets the mask of the lanes of its warp that hold its
    value; a partial last warp (48 threads) only sees its own lanes."""
    rng = np.random.default_rng(0)
    blocks = 2
    values = rng.integers(-2, 3, blocks * threads).astype(np.int32)
    out = np.zeros(blocks * threads, np.uint32)
    host.run_match(_ptr(values), _ptr(out), blocks, threads)
    for b in range(blocks):
        for t, (w0, width) in enumerate(_lanes(threads)):
            lanes = values[b * threads + w0:b * threads + w0 + width]
            want = sum(1 << lane for lane in range(width)
                       if lanes[lane] == values[b * threads + t])
            assert out[b * threads + t] == want


def test_ballot_sync(host):
    """Each lane gets the mask of its warp's lanes whose predicate holds."""
    values = np.random.default_rng(1).integers(-1, 2, 96).astype(np.int32)
    out = np.zeros(96, np.uint32)
    host.run_ballot(_ptr(values), _ptr(out), 1, 96)
    for t, (w0, width) in enumerate(_lanes(96)):
        want = sum(1 << lane for lane in range(width)
                   if values[w0 + lane] > 0)
        assert out[t] == want


@pytest.mark.parametrize("delta", [1, 4, 16])
def test_shfl_up_sync(host, delta):
    """Lane l gets lane l - delta's value of its own warp, and keeps its
    own where l < delta."""
    values = np.random.default_rng(2).integers(-99, 99, 64).astype(np.int32)
    out = np.zeros(64, np.int32)
    host.run_shfl_up(_ptr(values), _ptr(out), 64, delta)
    for t in range(64):
        assert out[t] == values[t - delta if t % 32 >= delta else t]


def test_popc_and_ffs(host):
    """__popc counts the set bits; __ffs gives the lowest one's position
    from 1, 0 for none."""
    values = np.array([0, 1, 0xFFFFFFFF, 0x80000001, 0x0F0F0F00],
                      np.uint32)
    out = np.zeros(10, np.int32)
    host.run_popc(_ptr(values), _ptr(out), 5)
    assert out[0::2].tolist() == [0, 1, 32, 2, 12]
    assert out[1::2].tolist() == [0, 1, 1, 1, 9]


def test_atomic_inc(host):
    """atomicInc returns the old value and stores 0 where it was at or
    above the limit, else old + 1."""
    host.run_atomic_inc.restype = ctypes.c_uint
    cell = np.array([0], np.uint32)
    seen = [host.run_atomic_inc(_ptr(cell), 2) for _ in range(5)]
    assert seen == [0, 1, 2, 0, 1] and cell[0] == 2
    cell[0] = 7
    assert host.run_atomic_inc(_ptr(cell), 3) == 7 and cell[0] == 0


@pytest.mark.parametrize("blocks", [1, 5])
def test_threadfence_last_block(host, blocks):
    """The last-block-done pattern (`__threadfence`, a ticket taken with
    `atomicInc`, `__ldcg` reads): the last block sees every block's value,
    and the ticket is back to 0 for the next launch."""
    values = np.zeros(blocks, np.int32)
    ticket = np.zeros(1, np.uint32)
    total, last = np.zeros(1, np.int32), np.full(1, -1, np.int32)
    for _ in range(2):
        host.run_last_block(_ptr(values), _ptr(ticket), _ptr(total),
                            _ptr(last), blocks)
        assert total[0] == blocks * (blocks + 1) // 2
        assert last[0] == blocks - 1 and ticket[0] == 0
