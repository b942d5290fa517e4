"""Fiducial marker dictionaries and the batched Hamming-distance matcher.

Parity surface (vs reference src/dictionaries.rs):
  * 15 named dictionaries incl. the ARUCO_DEFAULT alias (dictionaries.rs:5-19,
    30-113) with the same code words, num_bits and tau values.
  * ``ARDictionary.new_from_named_dict`` / ``find_nearest`` /
    ``try_find_nearest`` / ``get_mark_size`` / ``make_binary_image`` /
    ``get_dictionary_names`` (dictionaries.rs:115-233).
  * tau==0 dictionaries (ARTAG, ARTOOLKITPLUS, ARTOOLKITPLUSBCH) compute tau
    as the minimum pairwise Hamming distance (dictionaries.rs:124,129-138).

Design: the codebook is materialised once as a ±1 bit-plane matrix padded to
a multiple of 128 columns; the whole-dictionary nearest-code search is one
dense (M, bits) x (bits, N) matmul followed by an argmin —
no per-code scalar loop anywhere on the hot path.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .utils.bits import (
    codes_to_bitplanes,
    hamming_distance,
    pack_u64_to_u32,
    unpack_u32_to_u64,
)

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data", "codebooks.npz")

# Bit-plane matrices are padded to a multiple of 128 columns.
_LANE = 128


@functools.lru_cache(maxsize=1)
def _load_raw():
    with np.load(_DATA_PATH, allow_pickle=False) as z:
        names = [str(n) for n in z["names"]]
        num_bits = {n: int(b) for n, b in zip(names, z["num_bits"])}
        tau = {n: int(t) for n, t in zip(names, z["tau"])}
        codes = {n: unpack_u32_to_u64(z[f"codes_{n}"]) for n in names}
    # Alias (reference dictionaries.rs:6, 40-44).
    codes["ARUCO_DEFAULT"] = codes["ARUCO"]
    num_bits["ARUCO_DEFAULT"] = num_bits["ARUCO"]
    tau["ARUCO_DEFAULT"] = tau["ARUCO"]
    return codes, num_bits, tau


def calculate_tau(code_list: np.ndarray) -> int:
    """Minimum pairwise Hamming distance over a codebook.

    Semantics of reference dictionaries.rs:129-138, but vectorised: popcount
    of the full XOR outer product instead of an O(n^2) scalar loop.
    """
    codes = np.asarray(code_list, dtype=np.uint64)
    n = len(codes)
    if n < 2:
        return 255
    # Chunk rows to bound memory for the 4096-code BCH table.
    best = 255
    chunk = 512
    for i in range(0, n, chunk):
        x = codes[i : i + chunk, None] ^ codes[None, :]
        d = np.zeros(x.shape, dtype=np.uint8)
        v = x.copy()
        while v.any():
            d += (v & np.uint64(1)).astype(np.uint8)
            v >>= np.uint64(1)
        # Mask the diagonal (distance to self is 0).
        rows = np.arange(i, min(i + chunk, n)) - i
        cols = np.arange(i, min(i + chunk, n))
        d[rows, cols] = 255
        best = min(best, int(d.min()))
    return best


def get_dictionary_names() -> list[str]:
    """All registered dictionary names (reference dictionaries.rs:147-149)."""
    codes, _, _ = _load_raw()
    return sorted(codes.keys())


@dataclass(frozen=True)
class ARDictionary:
    """A named marker dictionary plus its device-side matcher tables.

    Mirrors reference dictionaries.rs:22-28 (num_bits, tau, code_list) and
    adds the device representations used by the jitted detector.
    """

    name: str
    num_bits: int
    tau: int
    code_list: np.ndarray  # (N,) uint64, host-side
    # Device-side tables (materialised lazily, cached on the instance):
    _device: dict = field(default_factory=dict, repr=False, compare=False)

    # ---------------------------------------------------------------- init
    @staticmethod
    def new_from_named_dict(name: str) -> "ARDictionary":
        """Look up a dictionary by (case-insensitive) name.

        Raises KeyError on unknown names (the reference panics,
        dictionaries.rs:140-145).
        """
        codes, num_bits, tau = _load_raw()
        key = name.upper()
        if key not in codes:
            raise KeyError(
                f"unknown dictionary {name!r}; known: {sorted(codes)}"
            )
        t = tau[key]
        if t == 0:
            t = _cached_tau(key)
        return ARDictionary(
            name=key,
            num_bits=num_bits[key],
            tau=t,
            code_list=codes[key],
        )

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self.code_list)

    def get_mark_size(self) -> int:
        """Marker side length in cells including the black border ring
        (reference dictionaries.rs:151-156)."""
        return int(np.ceil(np.sqrt(self.num_bits))) + 2

    @property
    def inner_size(self) -> int:
        return self.get_mark_size() - 2

    # Device tables -------------------------------------------------------
    @property
    def padded_bits(self) -> int:
        return ((self.num_bits + _LANE - 1) // _LANE) * _LANE

    def codebook_bitplanes_t(self) -> jnp.ndarray:
        """(padded_bits, N) float32 in {-1,+1}, zero-padded lanes.

        Zero padding is distance-neutral when the query is also zero-padded.
        The cache holds host numpy (never device tracers — caching a jnp
        array created under an active jit/vmap trace leaks the tracer);
        jnp.asarray inside a trace is a free constant.
        """
        if "bp_t" not in self._device:
            bp = codes_to_bitplanes(self.code_list, self.num_bits)
            pad = self.padded_bits - self.num_bits
            if pad:
                bp = np.pad(bp, ((0, 0), (0, pad)))
            self._device["bp_t"] = np.ascontiguousarray(bp.T)
        return jnp.asarray(self._device["bp_t"])

    def codebook_u32(self) -> jnp.ndarray:
        """(N, 2) uint32 (lo, hi) code words."""
        if "u32" not in self._device:
            self._device["u32"] = pack_u64_to_u32(self.code_list)
        return jnp.asarray(self._device["u32"])

    # ------------------------------------------------------------ matching
    def find_nearest_bits(self, query_bits: jnp.ndarray):
        """Batched nearest-code search from raw bit vectors.

        query_bits: (..., num_bits) in {0,1} (bit 0 = LSB of the code word).
        Returns (ids, dists): (...,) int32 each.  One matmul + argmin (the
        ±1 products and their sums are small integers, exact in TF32 and
        bf16 as well as f32);
        ties resolve to the lowest index, matching the strict `<` update in
        the reference scan (dictionaries.rs:178-187).
        """
        q = query_bits.astype(jnp.float32) * 2.0 - 1.0
        lead = q.shape[:-1]
        q = q.reshape((-1, self.num_bits))
        pad = self.padded_bits - self.num_bits
        if pad:
            q = jnp.pad(q, ((0, 0), (0, pad)))
        dots = jnp.dot(
            q, self.codebook_bitplanes_t(), preferred_element_type=jnp.float32
        )
        dists = ((self.num_bits - dots) * 0.5).astype(jnp.int32)
        ids = jnp.argmin(dists, axis=-1).astype(jnp.int32)
        best = jnp.take_along_axis(dists, ids[:, None], axis=-1)[:, 0]
        return ids.reshape(lead), best.reshape(lead)

    def find_nearest(self, bits: int) -> tuple[int, int]:
        """Scalar convenience wrapper (reference dictionaries.rs:160-196)."""
        vec = (int(bits) >> np.arange(self.num_bits, dtype=np.uint64)) & 1
        ids, dists = self.find_nearest_bits(jnp.asarray(vec[None, :]))
        return int(ids[0]), int(dists[0])

    def try_find_nearest(self, bits: int):
        """Some((id, dist)) iff dist < tau (reference dictionaries.rs:198-207)."""
        idx, dist = self.find_nearest(bits)
        if dist < self.tau:
            return idx, dist
        return None

    # ----------------------------------------------------------- rendering
    def make_binary_image(self, marker_id: int) -> tuple[int, np.ndarray]:
        """(width, bits) boolean row-major marker image with black border.

        Bit packing is LSB-first, matching reference dictionaries.rs:212-232
        (including its quirky interleaved border emission).
        """
        code = int(self.code_list[marker_id])
        width = self.get_mark_size()
        bits: list[bool] = [False] * width
        for i in range(self.num_bits):
            if len(bits) % width == 0:
                bits.append(False)
            bits.append(bool(code & (1 << i)))
            if len(bits) % width == width - 1:
                bits.append(False)
        bits.extend([False] * width)
        return width, np.array(bits, dtype=bool)

    def marker_bit_matrix(self, marker_id: int) -> np.ndarray:
        """(mark_size, mark_size) bool marker incl. border, row-major."""
        width, bits = self.make_binary_image(marker_id)
        return bits.reshape(width, width)


@functools.lru_cache(maxsize=None)
def _cached_tau(name: str) -> int:
    codes, _, _ = _load_raw()
    return calculate_tau(codes[name])
