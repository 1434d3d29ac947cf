"""32-bit hash mixing of the two kmer key words (device + host-identical).

The table hash is a murmur3-style finalizer over the (lo, hi) uint32 pair,
kept in 32-bit arithmetic (JAX's default integer width).  The same arithmetic runs under NumPy (host) and
jax.numpy (device) so slot assignments agree everywhere — required for the
sharded-table ``hash % num_shards`` routing (SURVEY.md §2d, §5.8).
"""

from __future__ import annotations

GOLDEN = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def fmix32(x, xp):
    """Murmur3 finalizer; ``xp`` is the array namespace (numpy or
    jax.numpy).  Operates on uint32 with wrap-around arithmetic."""
    u32 = xp.uint32
    x = x ^ (x >> u32(16))
    x = x * u32(_M1)
    x = x ^ (x >> u32(13))
    x = x * u32(_M2)
    x = x ^ (x >> u32(16))
    return x


def mix_kmer(lo, hi, xp):
    """Hash of a packed kmer key pair → uint32."""
    u32 = xp.uint32
    return fmix32(lo ^ fmix32(hi ^ u32(GOLDEN), xp), xp)


def mix_kmer_salted(lo, hi, salt, xp):
    """Salted kmer hash → uint32.  ``salt`` is a uint32 scalar (host int or
    traced device scalar); salt == GOLDEN reproduces ``mix_kmer`` exactly.

    The salt exists for the wide-bucket table (ops.widetable): the build
    retries salts until no bucket overflows its slots, which is what makes
    the single-gather probe possible."""
    u32 = xp.uint32
    return fmix32(lo ^ fmix32(hi ^ u32(salt), xp), xp)


def salt_sequence(n: int) -> list[int]:
    """Deterministic salt candidates for the overflow-free table build;
    the first is GOLDEN so unsalted and salted hashes usually agree.
    Pure-Python wrap-around arithmetic (numpy uint32 scalars warn)."""
    out = [GOLDEN]
    x = GOLDEN
    for _ in range(n - 1):
        x = (x + 0x6A09E667) & 0xFFFFFFFF
        x ^= x >> 16
        x = (x * _M1) & 0xFFFFFFFF
        x ^= x >> 13
        x = (x * _M2) & 0xFFFFFFFF
        x ^= x >> 16
        out.append(x)
    return out
