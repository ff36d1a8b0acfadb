"""`congruence spacedseed` — match the fixed spaced seed against an index.

Capability equivalent of the reference gt congruence toolbox (ref:
src/tools/gt_congruence.c, engine src/match/cgr_spacedseed.c): every
special-free query window of seed span is matched against the indexed
subject on the seed's care positions (seed "11011011000011011",
ref: cgr_spacedseed.c:198); each hit prints ``dblen<TAB>dbstartpos``
(ref: cgr_showmatch cgr_spacedseed.c:135-140).

Accelerator-first shape: instead of the reference's limdfs wildcard walk over
the packed index (idx-limdfs.c), the subject's masked window codes are
packed once into a sorted table (2 bits per care position) and every
query window becomes one binary search — the same batched
sorted-array-join used across the seed machinery. Emission order
reproduces the index walk: hits sorted by subject suffix rank.
"""

from __future__ import annotations

import numpy as np

from ..core.chardef import is_special
from ..core.encseq import Encseq

SEED = "11011011000011011"            # ref: cgr_spacedseed.c:198


def seed_mask(seed: str = SEED) -> np.ndarray:
    return np.flatnonzero(np.frombuffer(seed.encode(), np.uint8)
                          == ord("1"))


def _masked_codes(codes: np.ndarray, mask: np.ndarray, span: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(packed care-position code, window-valid) for every start; a
    window is valid when the FULL span is special-free (the reference
    skips windows containing specials, cgr_spacedseed.c:118)."""
    n = codes.size
    starts = n - span + 1
    if starts <= 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    valid = np.ones(starts, bool)
    for j in range(span):
        valid &= ~is_special(codes[j:j + starts])
    code = np.zeros(starts, np.int64)
    for j in mask:
        c = np.where(is_special(codes[j:j + starts]), 0,
                     codes[j:j + starts])
        code = (code << 2) | c
    return code, valid


def match_spacedseed(subject: Encseq, queries: Encseq,
                     rank: np.ndarray | None = None,
                     seed: str = SEED) -> list[tuple[int, int]]:
    """All (dblen, dbstartpos) hits in reference emission order: query
    windows left to right, hits per window by subject suffix rank (the
    limdfs index-walk order). rank = suffix rank per subject position
    (inverse suftab); positional order when absent."""
    mask = seed_mask(seed)
    span = len(seed)
    scode, svalid = _masked_codes(subject.codes, mask, span)
    spos = np.flatnonzero(svalid)
    sc = scode[spos]
    if rank is not None:
        order = np.lexsort((rank[spos], sc))
    else:
        order = np.lexsort((spos, sc))
    sc_sorted = sc[order]
    spos_sorted = spos[order]
    qcode, qvalid = _masked_codes(queries.codes, mask, span)
    out: list[tuple[int, int]] = []
    for w in np.flatnonzero(qvalid):
        lo = np.searchsorted(sc_sorted, qcode[w], side="left")
        hi = np.searchsorted(sc_sorted, qcode[w], side="right")
        for p in spos_sorted[lo:hi]:
            out.append((span, int(p)))
    return out
