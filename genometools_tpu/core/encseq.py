"""Encseq: the encoded-sequence container — foundation of every engine.

Capability equivalent of the reference GtEncseq (ref: src/core/encseq.c,
struct at src/core/encseq_rep.h:112-227), redesigned for accelerators:

* The sequence set is one concatenated uint8 code array with SEPARATOR (255)
  between sequences and WILDCARD (254) for ambiguity codes — exactly the
  reference's logical model (ref: src/core/chardef.h).
* Device representation is a dense jnp.uint8 array (one gather = random
  access in any readmode — no branching on access types) plus a 2-bit
  packed uint32 array (16 symbols/word) feeding the k-mer/compare kernels
  (ref 2-bit path: src/core/encseq.c:5963-6160).
* Special ranges are sorted (start, length) arrays == the reference's
  SWtable (ref: src/core/encseq_rep.h:42-80), but kept as plain device
  arrays searched with searchsorted instead of paged binary search.
* Readmodes FWD/REV/CPL/RCL (ref: src/core/readmode_api.h:22-33) are index
  arithmetic + complement LUT, never materialized copies.
* Mirroring (virtual reverse-complement concatenation,
  ref: encseq_rep.h:222 `hasmirror`) doubles the logical length:
  codes + SEPARATOR + revcompl(codes).

Suffix-ordering contract: `suffix_keys()` maps each position to an int32
key — regular symbols keep their code; the special at position p maps to
``num_chars + p`` (unique, ascending by position) and the empty suffix at
totallength is the largest key. Plain lexicographic order of these keys
reproduces the reference comparator exactly (specials > regulars; specials
ordered among themselves by position; ref:
src/core/encseq.c:7371-7462 gt_encseq_check_comparetwosuffixes).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .alphabet import Alphabet, dna_alphabet, protein_alphabet
from .chardef import SEPARATOR, WILDCARD, is_special
from .seqio import SeqSet, read_seqfile, read_seqfiles


@dataclass
class EncseqOrigin:
    """Input-provenance metadata needed for the reference's on-disk
    formats (.esq header fields, .md5, filelengthtab — see core/esq.py;
    ref: gt_inputfiles2sequencekeyvalues, src/core/encseq.c:5470)."""

    filenames: list[str]            # as given on the command line
    filelengths: list[tuple[int, int]]  # (raw bytes, effective length)
    md5s: list[str]                 # md5 hex of UPPERCASED original seq
    numofallchars: int              # distinct original input characters
    maxsubalphasize: int            # max distinct chars in one char class

    @classmethod
    def from_seqset(cls, seqset: SeqSet, alphabet: Alphabet,
                    filenames: list[str] | None,
                    filelengths: list[tuple[int, int]] | None
                    ) -> "EncseqOrigin":
        import hashlib
        # the reference hashes toupper(gt_alphabet_decode(code)) per
        # symbol (ref: encseq_charproc.gen:35) — so every wildcard
        # contributes the uppercased wildcardshow char ('N' for DNA),
        # not its original IUPAC letter
        codes = alphabet.encode(np.arange(256, dtype=np.uint8))
        lut = np.zeros(256, np.uint8)
        reg = codes < len(alphabet.characters)
        lut[reg] = np.frombuffer(
            alphabet.characters.upper().encode("latin-1"),
            np.uint8)[codes[reg]]
        lut[~reg] = ord(alphabet.wildcard_show.upper())
        md5s = [hashlib.md5(lut[np.asarray(s, np.uint8)].tobytes())
                .hexdigest() for s in seqset.seqs]
        # distinct original chars, grouped by encoded class
        seen = np.zeros(256, bool)
        for s in seqset.seqs:
            seen[np.asarray(s, np.uint8)] = True
        chars = np.flatnonzero(seen)
        classes: dict[int, int] = {}
        enc = alphabet.encode(chars.astype(np.uint8))
        for c in enc:
            classes[int(c)] = classes.get(int(c), 0) + 1
        return cls(filenames=filenames or [],
                   filelengths=filelengths or [],
                   md5s=md5s,
                   numofallchars=int(chars.size),
                   maxsubalphasize=max(classes.values()) if classes else 0)

FWD, REV, CPL, RCL = 0, 1, 2, 3
READMODES = {"fwd": FWD, "rev": REV, "cpl": CPL, "rcl": RCL}


def readmode_invert(rm: int) -> int:
    # ref: src/core/readmode.c gt_readmode_invert
    return {FWD: RCL, RCL: FWD, REV: CPL, CPL: REV}[rm]


@dataclass
class SpecialRanges:
    """Sorted, disjoint (start, length) runs of special characters."""

    starts: np.ndarray  # int64[k]
    lengths: np.ndarray  # int64[k]

    @property
    def count(self) -> int:
        return int(self.starts.size)

    @property
    def total(self) -> int:
        return int(self.lengths.sum()) if self.lengths.size else 0


def _runs(mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Run-length starts/lengths of True runs in a boolean mask."""
    pos = np.flatnonzero(mask)
    if pos.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # True positions are sparse in practice: derive runs from gaps in the
    # position list instead of diffing the whole mask
    brk = np.flatnonzero(pos[1:] != pos[:-1] + 1)
    starts = pos[np.concatenate([[0], brk + 1])].astype(np.int64)
    ends = pos[np.concatenate([brk, [pos.size - 1]])].astype(np.int64) + 1
    return starts, ends - starts


class Encseq:
    """Encoded multi-sequence container (host numpy + lazy device arrays)."""

    def __init__(self, codes: np.ndarray, ssp: np.ndarray, descs: list[str],
                 alphabet: Alphabet, mirrored: bool = False):
        assert codes.dtype == np.uint8
        self.codes = codes                      # uint8[totallength]
        self.ssp = np.asarray(ssp, np.int64)    # separator positions
        self.descs = descs
        self.alphabet = alphabet
        self.mirrored = mirrored
        self.origin: EncseqOrigin | None = None
        s, l = _runs(is_special(codes))
        self.special_ranges = SpecialRanges(s, l)
        w, wl = _runs(codes == WILDCARD)
        self.wildcard_ranges = SpecialRanges(w, wl)
        self._device = {}

    # -- construction ------------------------------------------------------
    @classmethod
    def from_seqset(cls, seqset: SeqSet, alphabet: Alphabet | None = None,
                    filenames: list[str] | None = None,
                    filelengths: list[tuple[int, int]] | None = None,
                    ) -> "Encseq":
        if alphabet is None:
            sample = b"".join(s[:2048].tobytes() for s in seqset.seqs[:16])
            from .alphabet import guess_alphabet
            alphabet = guess_alphabet(sample)
        nseq = len(seqset.seqs)
        if nseq == 0:
            codes = np.zeros(0, np.uint8)
            ssp = []
        else:
            lens = np.fromiter((len(s) for s in seqset.seqs), np.int64,
                               count=nseq)
            starts = np.cumsum(lens + 1) - (lens + 1)  # incl. separators
            ssp = (starts[1:] - 1).tolist()
            off = int(lens.sum()) + nseq - 1
            codes = np.empty(off, np.uint8)
            raw = seqset.seqs[0] if nseq == 1 else np.concatenate(
                [np.asarray(s, np.uint8) for s in seqset.seqs])
            enc_all = alphabet.encode(raw)
            # per-sequence block copies beat a whole-array boolean
            # scatter (few sequences, tens of MB each)
            cum = np.cumsum(lens) - lens
            for i in range(nseq):
                codes[starts[i]:starts[i] + lens[i]] = \
                    enc_all[cum[i]:cum[i] + lens[i]]
            codes[np.asarray(ssp, np.int64)] = SEPARATOR
        enc = cls(codes, np.asarray(ssp, np.int64), list(seqset.descs),
                  alphabet)
        enc.origin = EncseqOrigin.from_seqset(seqset, alphabet, filenames,
                                              filelengths)
        return enc

    @classmethod
    def from_files(cls, paths: list[str], alphabet: Alphabet | None = None) -> "Encseq":
        """ref: gt_encseq_new_from_files (src/core/encseq.c:7503)."""
        import os
        fast = cls._from_files_native(paths, alphabet)
        if fast is not None:
            return fast
        seqsets = [read_seqfile(p) for p in paths]
        merged = SeqSet()
        filelengths = []
        for p, s in zip(paths, seqsets):
            nsep = len(s.seqs) - 1 + (1 if merged.seqs else 0)
            filelengths.append((os.path.getsize(p),
                                s.total_length + nsep))
            merged.seqs.extend(s.seqs)
            merged.descs.extend(s.descs)
        return cls.from_seqset(merged, alphabet, filenames=list(paths),
                               filelengths=filelengths)

    @classmethod
    def _from_files_native(cls, paths: list[str],
                           alphabet: Alphabet | None):
        """One-pass native FASTA intake: codes + separators + header
        spans + seen-char stats straight off the file bytes, with
        encoding through the alphabet's own LUT — byte-identical
        Encseq (codes, descs, origin incl. md5s/char stats) to the
        seqset path, one file read instead of four array passes."""
        import hashlib
        import os

        from .native import fasta_encseq_native
        datas = []
        for p in paths:
            try:
                d = open(p, "rb").read()
            except OSError:
                return None
            if not d[:1] == b">":
                return None             # other formats: general reader
            datas.append(d)
        if not datas:
            return None
        if alphabet is None:
            from .seqio import parse_fasta_bytes
            prefix = datas[0][:1 << 16]
            cut = prefix.rfind(b"\n")
            if 0 < cut < len(datas[0]) - 1:
                prefix = prefix[:cut]
            try:
                head = parse_fasta_bytes(prefix)
            except (ValueError, IndexError):
                return None
            if not head.seqs:
                return None
            sample = b"".join(s[:2048].tobytes()
                              for s in head.seqs[:16])
            from .alphabet import guess_alphabet
            alphabet = guess_alphabet(sample)
        pieces = []
        descs: list[str] = []
        lens_all = []
        filelengths = []
        seen = np.zeros(256, bool)
        for p, d in zip(paths, datas):
            res = fasta_encseq_native(d, alphabet._encode_lut)
            if res is None:
                return None
            codes_f, lens_f, hs, he, seen_f = res
            pieces.append(codes_f)
            seen |= seen_f.astype(bool)
            for a, b in zip(hs.tolist(), he.tolist()):
                descs.append(d[a:b].decode("latin-1").rstrip("\r"))
            nsep = lens_f.size - 1 + (1 if lens_all else 0)
            filelengths.append((os.path.getsize(p),
                                int(lens_f.sum()) + nsep))
            lens_all.append(lens_f)
        lens = np.concatenate(lens_all) if lens_all else \
            np.zeros(0, np.int64)
        if lens.size == 0:
            return None
        sep = np.array([SEPARATOR], np.uint8)
        joined = []
        for t, c in enumerate(pieces):
            if t:
                joined.append(sep)
            joined.append(c)
        codes = np.concatenate(joined) if len(joined) > 1 else pieces[0]
        ssp = (np.cumsum(lens + 1) - 1)[:-1]
        enc = cls(codes, ssp.astype(np.int64), descs, alphabet)
        # origin stats: md5 maps each code to the uppercased class
        # char ('N' for every non-regular), identical to hashing the
        # mapped original bytes (the map factors through the code)
        nreg = len(alphabet.characters)
        md5lut = np.full(256, ord(alphabet.wildcard_show.upper()),
                         np.uint8)
        md5lut[:nreg] = np.frombuffer(
            alphabet.characters.upper().encode("latin-1"), np.uint8)
        starts = np.cumsum(lens + 1) - (lens + 1)
        md5s = []
        for s0, ln in zip(starts.tolist(), lens.tolist()):
            md5s.append(hashlib.md5(
                md5lut[codes[s0:s0 + ln]].tobytes()).hexdigest())
        chars = np.flatnonzero(seen)
        classes: dict[int, int] = {}
        for c in alphabet.encode(chars.astype(np.uint8)):
            classes[int(c)] = classes.get(int(c), 0) + 1
        enc.origin = EncseqOrigin(
            filenames=list(paths), filelengths=filelengths, md5s=md5s,
            numofallchars=int(chars.size),
            maxsubalphasize=max(classes.values()) if classes else 0)
        return enc

    @classmethod
    def from_string(cls, s: str, alphabet: Alphabet | None = None) -> "Encseq":
        seqs = [np.frombuffer(x.encode(), np.uint8) for x in s.split("|")]
        return cls.from_seqset(SeqSet(seqs=seqs, descs=[""] * len(seqs)),
                               alphabet or dna_alphabet())

    def mirror(self) -> "Encseq":
        """Virtually append the reverse complement
        (ref: gt_encseq_mirror, encseq_rep.h:222). Materialized here: the
        doubled array is what the device wants anyway."""
        if self.mirrored:
            return self
        comp = self.alphabet.complement_table()
        rc = comp[self.codes[::-1]]
        codes = np.concatenate([self.codes, [SEPARATOR], rc]).astype(np.uint8)
        n = self.codes.size
        extra_ssp = [n] + [2 * n - p for p in self.ssp[::-1]]
        ssp = np.concatenate([self.ssp, extra_ssp]).astype(np.int64)
        descs = self.descs + [d + " (rc)" for d in self.descs[::-1]]
        e = Encseq(codes, ssp, descs, self.alphabet, mirrored=True)
        return e

    # -- basic geometry ----------------------------------------------------
    @property
    def total_length(self) -> int:
        return int(self.codes.size)

    @property
    def num_sequences(self) -> int:
        return int(self.ssp.size) + 1 if self.total_length else 0

    def seq_startpos(self, seqnum) -> np.ndarray:
        starts = np.concatenate([[0], self.ssp + 1])
        return starts[seqnum]

    def seq_endpos(self, seqnum) -> np.ndarray:
        """Inclusive end position."""
        ends = np.concatenate([self.ssp - 1, [self.total_length - 1]])
        return ends[seqnum]

    def seq_length(self, seqnum) -> np.ndarray:
        return self.seq_endpos(seqnum) - self.seq_startpos(seqnum) + 1

    def seqnum_of_pos(self, pos) -> np.ndarray:
        """Vectorized position -> sequence number (ref: gt_encseq_seqnum)."""
        return np.searchsorted(self.ssp, np.asarray(pos), side="right")

    def max_seq_length(self) -> int:
        if self.num_sequences == 0:
            return 0
        return int(self.seq_length(np.arange(self.num_sequences)).max())

    # -- access ------------------------------------------------------------
    def get_encoded_char(self, pos, readmode: int = FWD) -> np.ndarray:
        """Random access in any readmode (ref: gt_encseq_get_encoded_char)."""
        pos = np.asarray(pos)
        n = self.total_length
        if readmode in (REV, RCL):
            pos = n - 1 - pos
        c = self.codes[pos]
        if readmode in (CPL, RCL):
            c = np.where(is_special(c), c, self.alphabet.complement_table()[c])
        return c

    def codes_view(self, readmode: int = FWD) -> np.ndarray:
        """Whole code array transformed by readmode (copy for non-FWD)."""
        c = self.codes
        if readmode in (REV, RCL):
            c = c[::-1]
        if readmode in (CPL, RCL):
            comp = self.alphabet.complement_table()
            c = np.where(is_special(c), c, comp[c])
        return np.ascontiguousarray(c)

    def extract_decoded(self, frompos: int, topos: int) -> str:
        """Decode [frompos, topos] inclusive (ref: gt_encseq_extract_decoded)."""
        return self.alphabet.decode(self.codes[frompos:topos + 1])

    # -- suffix sort keys --------------------------------------------------
    def suffix_keys(self, readmode: int = FWD) -> np.ndarray:
        """int32 keys reproducing reference suffix comparison semantics.

        Regular symbol -> its code; special at position p -> num_chars + p;
        sentinel (empty suffix) at totallength -> num_chars + totallength.
        """
        c = self.codes_view(readmode)
        n = c.size
        if n + self.alphabet.num_chars >= 2 ** 31:
            # wide inputs: int64 keys; the sharded engine carries them
            # as base-C int32 pairs (parallel/dist_doubling_sharded
            # pair lanes), the host parts engine natively
            keys = np.empty(n + 1, np.int64)
            keys[:n] = c
            sp = np.flatnonzero(is_special(c))
            keys[sp] = self.alphabet.num_chars + sp
            keys[n] = self.alphabet.num_chars + n
            return keys
        keys = np.empty(n + 1, np.int32)
        keys[:n] = c                       # uint8 -> int32, one pass
        sp = np.flatnonzero(is_special(c)).astype(np.int32)
        keys[sp] = self.alphabet.num_chars + sp
        keys[n] = self.alphabet.num_chars + n
        return keys

    # -- 2-bit packed device form -----------------------------------------
    def twobit_packed(self) -> np.ndarray:
        """uint32[ceil(n/16)] with symbol i in bits 2*(15-(i%16)) of word i//16
        (big-endian within word so that whole-word integer compare == lexicographic
        compare of 16 symbols, the property the reference exploits in
        gt_encseq_compare_pairof_twobitencodings, ref: encseq.c:6449).
        Specials are packed as 0; callers mask them via special ranges."""
        n = self.total_length
        nw = (n + 15) // 16
        sym = np.where(is_special(self.codes), 0, self.codes).astype(np.uint64)
        padded = np.zeros(nw * 16, np.uint64)
        padded[:n] = sym
        padded = padded.reshape(nw, 16)
        shifts = np.arange(15, -1, -1, dtype=np.uint64) * 2
        words = (padded << shifts).sum(axis=1, dtype=np.uint64)
        return words.astype(np.uint32)

    # -- persistence -------------------------------------------------------
    def save(self, indexname: str) -> None:
        """Persist the encoded sequence. DNA sequence sets are written in
        the reference gt binary's own format (.esq/.ssp/.des/.sds/.md5,
        byte-identical — see core/esq.py); non-DNA alphabets and mirrored
        views fall back to the internal .gte container."""
        if self.alphabet.num_chars == 4 and not self.mirrored:
            from . import esq
            esq.write_all(self, indexname)
            return
        self._save_gte(indexname)

    def _save_gte(self, indexname: str) -> None:
        """Write <indexname>.gte (npz) + <indexname>.gte.json metadata."""
        np.savez_compressed(
            indexname + ".gte",
            codes=self.codes, ssp=self.ssp,
        )
        meta = {
            "version": 1,
            "alphabet": "dna" if self.alphabet.is_dna() else
                        ("protein" if self.alphabet.is_protein() else "custom"),
            "groups": self.alphabet.groups,
            "wildcards": self.alphabet.wildcards,
            "mirrored": self.mirrored,
            "descs": self.descs,
            "totallength": self.total_length,
            "numofsequences": self.num_sequences,
            "specialcharacters": self.special_ranges.total,
            "specialranges": self.special_ranges.count,
        }
        Path(indexname + ".gte.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, indexname: str) -> "Encseq":
        """Load a persisted encoded sequence — either the reference .esq
        format (ours or one written by the real gt binary) or the
        internal .gte container."""
        if Path(indexname + ".esq").exists():
            from . import esq
            enc, _ = esq.read_esq(indexname)
            return enc
        data = np.load(indexname + ".gte.npz")
        meta = json.loads(Path(indexname + ".gte.json").read_text())
        if meta["alphabet"] == "dna":
            alpha = dna_alphabet()
        elif meta["alphabet"] == "protein":
            alpha = protein_alphabet()
        else:
            alpha = Alphabet(meta["groups"], meta["wildcards"], "?")
        return cls(data["codes"], data["ssp"], list(meta["descs"]), alpha,
                   mirrored=meta["mirrored"])

    # -- device ------------------------------------------------------------
    def device_codes(self, readmode: int = FWD):
        """jnp.uint8 codes on the default device (cached)."""
        key = ("codes", readmode)
        if key not in self._device:
            import jax.numpy as jnp
            self._device[key] = jnp.asarray(self.codes_view(readmode))
        return self._device[key]

    def device_suffix_keys(self, readmode: int = FWD):
        key = ("keys", readmode)
        if key not in self._device:
            import jax.numpy as jnp
            self._device[key] = jnp.asarray(self.suffix_keys(readmode))
        return self._device[key]
