"""Bit-twiddling utilities shared by the dictionary matcher and decoder.

Parity notes: `hamming_distance` mirrors the reference crate's XOR+popcount
helper (reference src/lib.rs:11-21).  On device we never touch 64-bit
integers: code words are carried either as (…, 2) uint32 (lo, hi) pairs or as
±1 bit-plane vectors so the Hamming search is one matmul.
Bit index convention everywhere: bit 0 = least-significant bit of the u64.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def hamming_distance(a: int, b: int) -> int:
    """Hamming distance between two u64 code words (host-side scalar)."""
    return int(bin((int(a) ^ int(b)) & 0xFFFFFFFFFFFFFFFF).count("1"))


def pack_u64_to_u32(codes: np.ndarray) -> np.ndarray:
    """(N,) uint64 -> (N, 2) uint32 with column 0 = low word, 1 = high word."""
    codes = np.asarray(codes, dtype=np.uint64)
    out = np.empty(codes.shape + (2,), dtype=np.uint32)
    out[..., 0] = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[..., 1] = (codes >> np.uint64(32)).astype(np.uint32)
    return out


def unpack_u32_to_u64(pairs: np.ndarray) -> np.ndarray:
    """(N, 2) uint32 (lo, hi) -> (N,) uint64."""
    pairs = np.asarray(pairs, dtype=np.uint32)
    return pairs[..., 0].astype(np.uint64) | (
        pairs[..., 1].astype(np.uint64) << np.uint64(32)
    )


def codes_to_bitplanes(codes: np.ndarray, num_bits: int) -> np.ndarray:
    """(N,) uint64 -> (N, num_bits) float32 in {-1, +1}; bit 0 first.

    +1 means the bit is set.  With this encoding the dot product of two
    bit-plane vectors x, y over `num_bits` lanes satisfies
        dist(x, y) = (num_bits - x . y) / 2,
    turning the whole-dictionary Hamming scan (reference
    src/dictionaries.rs:160-196) into one dense matmul.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    shifts = np.arange(num_bits, dtype=np.uint64)
    bits = (codes[..., None] >> shifts) & np.uint64(1)
    return (bits.astype(np.float32) * 2.0) - 1.0


def bits_to_bitplane_jnp(bits: jnp.ndarray) -> jnp.ndarray:
    """(…, num_bits) {0,1} -> (…, num_bits) float32 {-1,+1} (device-side)."""
    return bits.astype(jnp.float32) * 2.0 - 1.0


def bitplane_hamming(
    query: jnp.ndarray, codebook_t: jnp.ndarray, num_bits: int
) -> jnp.ndarray:
    """Batched Hamming distances via a single matmul.

    query:       (M, num_bits) float32 in {-1, +1}
    codebook_t:  (num_bits, N) float32 in {-1, +1}
    returns:     (M, N) int32 Hamming distances (exact)
    """
    dots = jnp.dot(query, codebook_t, preferred_element_type=jnp.float32)
    return ((num_bits - dots) * 0.5).astype(jnp.int32)


def u32pair_hamming(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Popcount Hamming distance on (…, 2) uint32 pairs."""
    import jax

    x = jnp.bitwise_xor(a, b)
    return jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)
