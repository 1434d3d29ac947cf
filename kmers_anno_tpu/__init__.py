"""kmers_anno_tpu — a JAX k-mer genome annotation engine for GPUs.

A from-scratch JAX/XLA re-implementation of the capabilities of SEEDtk
``kmers.anno`` (a single-threaded Java tool).  The compute path encodes
sequences as packed integer tensors, runs k-mer extraction / hashing / table
probing / vote reduction as batched device kernels, and scales over a
``jax.sharding.Mesh`` with XLA collectives.  The host layer provides the GTO
genome model, coordinate math, role/function maps, file I/O and the CLI
surface of the reference tool.

Three annotation engines (mirroring SURVEY.md §1):

1. ORF-projection engine  (``kmers`` / ``batch`` commands)  — engine.projection
2. Discriminating-kmer engine (``build`` / ``apply``)        — engine.signature, engine.apply
3. Kmer-hash similarity engine (``hashAnno`` / ``applyAnno``)— engine.hashanno
"""

__version__ = "0.1.0"


def _tune_malloc() -> None:
    """Keep large allocations on the heap instead of per-call mmap/munmap.

    The pipelines cycle many multi-MB NumPy buffers (probe tables, flat
    token streams).  glibc serves those via mmap and unmaps them on free,
    so every cycle refaults every page — measured at seconds per 50 MB
    under THP defrag.  Raising M_MMAP_THRESHOLD/M_TRIM_THRESHOLD makes the
    heap retain the pages (one-time cost), a ~100x win on the host path.
    """
    import ctypes
    import sys
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
    except (OSError, AttributeError):
        pass


_tune_malloc()
