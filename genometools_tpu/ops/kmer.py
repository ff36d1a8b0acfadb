"""k-mer code extraction — the shared scan kernel.

Capability equivalent of the reference GtKmercodeiterator /
getencseqkmers_twobitencoding (ref: src/match/sfx-mappedstr.c:427-483),
redesigned as a vectorized window scan: instead of a sliding-window
iterator with incremental code updates, every window code is computed
data-parallel with k shifted gathers (elementwise, no sequential
dependency). Windows containing special characters are masked invalid.

Codes wider than 30 bits are returned as multiple int32 words
(most-significant word first) so downstream sorts use multi-key
`lax.sort` and jax_enable_x64 can stay off (a design chosen for the
machine the package first ran on; not yet measured on a GPU).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.chardef import SPECIAL_MIN

# max symbols packed in one int32 word for a 4-letter alphabet (2 bits each,
# keep below 2^30 so int32 sorts stay positive)
_SYMS_PER_WORD_DNA = 15


def words_for_k(k: int, num_chars: int = 4) -> int:
    import math
    bits = math.ceil(math.log2(num_chars))
    per = 30 // bits
    return (k + per - 1) // per


@partial(jax.jit, static_argnames=("k", "num_chars"))
def kmer_codes(codes: jnp.ndarray, k: int, num_chars: int = 4):
    """All k-mer codes of a uint8 code array.

    Returns (words, valid):
      words: int32[nwords, npos] — multi-word big-endian codes, npos = n-k+1
      valid: bool[npos] — True iff window has no special character
    """
    import math
    bits = math.ceil(math.log2(num_chars))
    per = 30 // bits
    n = codes.shape[0]
    npos = n - k + 1
    assert npos >= 1, "sequence shorter than k"
    sym = jnp.where(codes >= SPECIAL_MIN, 0, codes).astype(jnp.int32)
    special = (codes >= SPECIAL_MIN)

    # split k symbols into words of <= per symbols each (last word fullest
    # alignment: first word may be short so low word is densely packed)
    nwords = (k + per - 1) // per
    sizes = []
    rem = k
    for w in range(nwords):
        take = rem - per * (nwords - 1 - w)
        take = max(1, min(per, take))
        sizes.append(take)
        rem -= take
    # adjust: distribute exactly k
    assert sum(sizes) == k

    words = []
    off = 0
    bad = jnp.zeros(npos, jnp.bool_)
    for size in sizes:
        acc = jnp.zeros(npos, jnp.int32)
        for j in range(size):
            acc = acc * num_chars + jax.lax.dynamic_slice(sym, (off + j,), (npos,))
            bad = bad | jax.lax.dynamic_slice(special, (off + j,), (npos,))
        words.append(acc)
        off += size
    return jnp.stack(words), jnp.logical_not(bad)


def kmer_codes_np(codes: np.ndarray, k: int, num_chars: int = 4):
    """Host reference implementation (numpy) for cross-checks."""
    n = codes.size
    npos = n - k + 1
    sym = np.where(codes >= SPECIAL_MIN, 0, codes).astype(np.int64)
    special = codes >= SPECIAL_MIN
    code = np.zeros(npos, np.int64)
    bad = np.zeros(npos, bool)
    for j in range(k):
        code = code * num_chars + sym[j:j + npos]
        bad |= special[j:j + npos]
    return code, ~bad


def words_to_int(words: np.ndarray, k: int, num_chars: int = 4) -> np.ndarray:
    """Combine multi-word codes into python-int/np.int64 scalars (host)."""
    import math
    bits = math.ceil(math.log2(num_chars))
    per = 30 // bits
    nwords = words.shape[0]
    sizes = []
    rem = k
    for w in range(nwords):
        take = rem - per * (nwords - 1 - w)
        take = max(1, min(per, take))
        sizes.append(take)
        rem -= take
    out = np.zeros(words.shape[1], np.int64)
    for w, size in enumerate(sizes):
        out = out * (num_chars ** size) + words[w].astype(np.int64)
    return out


def pack_mers_2bit(mer_codes: np.ndarray, k: int) -> np.ndarray:
    """Pack k-mer integer codes into ceil(k/4)-byte big-endian 2-bit strings
    (the reference Tallymer .mer layout, ref: src/match/tyr-basic.h:24-28:
    MERBYTES(k) = (k + 3) / 4, symbols packed MSB-first per byte)."""
    merbytes = (k + 3) // 4
    npos = mer_codes.size
    out = np.zeros((npos, merbytes), np.uint8)
    # pad to multiple of 4 symbols on the right (low bits of last byte zero)
    shift_total = (merbytes * 4 - k) * 2
    vals = mer_codes.astype(object) if k > 31 else mer_codes.astype(np.int64)
    vals = vals << shift_total
    for b in range(merbytes - 1, -1, -1):
        out[:, b] = np.asarray(vals & 0xFF, np.uint8)
        vals = vals >> 8
    return out


def spaced_kmer_codes_np(codes: np.ndarray, mask: int, num_chars: int = 4):
    """Spaced-seed codes: `mask` is a bitmask over the seed span
    (MSB = first window position); only 1-bit positions contribute to the
    code (ref: src/match/dbs_spaced_seeds.c, diagbandseed spaced-seed
    extraction). Returns (codes int64[npos], valid bool[npos]) where
    validity requires the FULL span free of specials (like the
    reference's window scan)."""
    span = mask.bit_length()
    weight_positions = [span - 1 - b for b in range(span - 1, -1, -1)
                        if (mask >> b) & 1]
    n = codes.size
    npos = n - span + 1
    if npos <= 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    sym = np.where(codes >= SPECIAL_MIN, 0, codes).astype(np.int64)
    special = codes >= SPECIAL_MIN
    out = np.zeros(npos, np.int64)
    bad = np.zeros(npos, bool)
    for j in range(span):
        bad |= special[j:j + npos]
    for j in weight_positions:
        out = out * num_chars + sym[j:j + npos]
    return out, ~bad
