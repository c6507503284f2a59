"""Host allocator tuning for the packing hot path.

Measured on a 1-core VM host: first-touch page faults on fresh
mmap-backed numpy allocations run at ~25-200 MB/s, so the T-sized
`(T, ph, bw)` scatter-map buffers `pack_tiles` builds at low delta make
packing allocation-bound — a 2.2M-nnz replica packed in 22 s, of which
>half was `np.full` page-faulting. Raising glibc's M_MMAP_THRESHOLD /
M_TRIM_THRESHOLD keeps those buffers in the (already-faulted) heap so
repeated packs reuse warm pages: the same pack drops to 4-7 s.

Harness entry points (bench.py, chip_smoke.py, the suite runner) call
:func:`tune_malloc` explicitly; the library never mutates the global
allocator on import.
"""
import ctypes

M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3


def tune_malloc(threshold_bytes: int = 1 << 30) -> bool:
    """Serve allocations below ``threshold_bytes`` from the glibc heap
    (warm pages) instead of fresh mmaps. Returns True if applied;
    no-op (False) on non-glibc platforms."""
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = libc.mallopt(M_MMAP_THRESHOLD, threshold_bytes)
        ok = libc.mallopt(M_TRIM_THRESHOLD, threshold_bytes) and ok
        return bool(ok)
    except OSError:
        return False

