"""gt-style command line driver.

Capability equivalent of the reference toolbox dispatch
(ref: src/gt.c:21, src/gtr.c:428, tool registry src/gtt.c:186-265).
Tools are argparse subcommands; each maps to an engine module. Invoke as
`python -m genometools_tpu <tool> ...`.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _force_platform(args):
    """Select device platform before first JAX touch, and enable the
    persistent compile cache so every CLI process reuses the programs
    earlier ones compiled (see utils.compile_cache for its placement)."""
    import jax

    from .utils.compile_cache import enable_compile_cache
    if getattr(args, "cpu", False):
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()


# ---------------------------------------------------------------------------
# suffixerator
# ---------------------------------------------------------------------------

def cmd_suffixerator(args):
    _force_platform(args)
    from .core.encseq import READMODES, Encseq
    from .index.esa import build_esa, write_esa
    from .utils.options import Logger, Showtime

    st = Showtime(args.showtime)
    log = Logger(getattr(args, "v", False))
    enc = Encseq.from_files(args.db)
    log.log(f"indexname=\"{args.indexname or args.db[0]}\"")
    log.log(f"prefixlength={args.pl if args.pl else 'automatic'}")
    for i, f in enumerate(args.db):
        log.log(f"inputfile[{i}]={f}")
    st.phase("reading the input sequences")
    if args.mirrored:
        enc = enc.mirror()
    rm = READMODES[args.dir]
    indexname = args.indexname or args.db[0]
    if args.parts > 1 or args.memlimit:
        # memory-bounded code-range parts (int64 path; ref: -parts /
        # -memlimit, src/match/sfx-partssuf.c:172); streams
        # .suf/.lcp/.llv/.bwt one part at a time for every readmode
        from .index.parts import stream_esa_parts
        n1 = enc.total_length + 1
        if args.memlimit:
            budget = max(1, _parse_memlimit(args.memlimit) // 16)
        else:
            budget = -(-n1 // args.parts)
        if args.tis:
            enc.save(indexname)
        nparts = stream_esa_parts(
            enc, rm, indexname, budget, suf=args.suf, lcp=args.lcp,
            bwt=args.bwt, bck=args.bck, prefixlength=args.pl or None)
        if args.showtime:
            print(f"# parts={nparts} budget={budget}", file=sys.stderr)
        return 0
    if args.dist is not None:
        os.environ["GT_TPU_DIST"] = str(args.dist)
    esa = build_esa(enc, rm, with_lcp=args.lcp,
                    prefixlength=args.pl or None, with_bck=args.bck)
    st.phase("sorting the suffixes")
    if args.tis:
        enc.save(indexname)
    write_esa(esa, indexname, suf=args.suf, lcp=args.lcp, bwt=args.bwt,
              bck=args.bck)
    st.phase("writing the output tables")
    if args.showtime:
        print(f"# indexed {enc.total_length} symbols, "
              f"{enc.num_sequences} sequences", file=sys.stderr)
        st.overall()
    return 0


def _add_suffixerator(sub):
    p = sub.add_parser("suffixerator", help="compute enhanced suffix array")
    p.add_argument("-db", nargs="+", required=True, help="input sequence files")
    p.add_argument("-indexname", default=None)
    p.add_argument("-suf", action="store_true", help="output suffix table")
    p.add_argument("-lcp", action="store_true", help="output lcp table")
    p.add_argument("-tis", action="store_true", help="output encoded sequence")
    p.add_argument("-bwt", action="store_true", help="output BWT table")
    p.add_argument("-bck", action="store_true", help="output bucket table")
    p.add_argument("-pl", type=int, nargs="?", const=0, default=0,
                   help="prefix length (0 = auto)")
    p.add_argument("-dna", action="store_true")
    p.add_argument("-protein", action="store_true")
    p.add_argument("-mirrored", action="store_true")
    p.add_argument("-ssp", action="store_true")
    p.add_argument("-des", action="store_true")
    p.add_argument("-sds", action="store_true",
                   help="output sequence description separator table")
    p.add_argument("-md5", action="store_true")
    p.add_argument("-dir", default="fwd", choices=["fwd", "rev", "cpl", "rcl"])
    p.add_argument("-parts", type=int, default=1,
                   help="build the suffix table in N memory-bounded parts")
    p.add_argument("-memlimit", default=None,
                   help="memory budget for part planning, e.g. 512MB")
    p.add_argument("-dist", type=int, default=None, metavar="N",
                   help="route the suffix sort over an N-device mesh "
                        "(0 = off; default: all attached devices)")
    p.add_argument("-showtime", action="store_true")
    p.add_argument("-v", action="store_true", help="verbose logger")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_suffixerator)


def _parse_memlimit(s: str) -> int:
    s = s.strip().upper()
    for suf, mult in (("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10)):
        if s.endswith(suf):
            return int(float(s[:-2]) * mult)
    return int(s)


# ---------------------------------------------------------------------------
# encseq
# ---------------------------------------------------------------------------

def cmd_encseq(args):
    from .core.encseq import Encseq
    if args.sub == "encode":
        enc = Encseq.from_files(args.files)
        enc.save(args.indexname or args.files[0])
    elif args.sub == "decode":
        enc = Encseq.load(args.indexname)
        from .core.seqio import write_fasta
        seqs = [enc.alphabet.decode(
            enc.codes[enc.seq_startpos(i):enc.seq_endpos(i) + 1]).upper()
            for i in range(enc.num_sequences)]
        write_fasta(sys.stdout, seqs, enc.descs)
    elif args.sub == "info":
        enc = Encseq.load(args.indexname)
        print(f"total length: {enc.total_length}")
        print(f"number of sequences: {enc.num_sequences}")
        print(f"special characters: {enc.special_ranges.total}")
        print(f"special ranges: {enc.special_ranges.count}")
        print(f"alphabet: {'dna' if enc.alphabet.is_dna() else 'protein'}")
    return 0


def _add_encseq(sub):
    p = sub.add_parser("encseq", help="encode/decode/inspect sequence sets")
    sp = p.add_subparsers(dest="sub", required=True)
    pe = sp.add_parser("encode")
    pe.add_argument("files", nargs="+")
    pe.add_argument("-indexname", default=None)
    pd = sp.add_parser("decode")
    pd.add_argument("indexname")
    pi = sp.add_parser("info")
    pi.add_argument("indexname")
    p.set_defaults(func=cmd_encseq)


# ---------------------------------------------------------------------------
# tallymer
# ---------------------------------------------------------------------------

def cmd_tallymer(args):
    _force_platform(args)
    from .core.encseq import Encseq
    from .index.esa import load_esa
    from .match import tallymer

    if args.sub == "mkindex":
        from .index.esa import read_prj
        mi = None
        try:
            rm = int(read_prj(args.esa).get("readmode", 0))
        except OSError:
            rm = None
        if rm == 0:
            # forward readmode, DNA codes: ESA-free native counting
            # (identical bytes, no .suf/.lcp load)
            enc_t = Encseq.load(args.esa)
            if enc_t.alphabet.num_chars == 4:
                mi = tallymer.mkindex_direct(enc_t, args.mersize,
                                             minocc=args.minocc,
                                             maxocc=args.maxocc)
        if mi is None:
            esa = load_esa(args.esa, need_lcp="small", signed_suftab=False)
            mi = tallymer.mkindex(esa, args.mersize, minocc=args.minocc,
                                  maxocc=args.maxocc)
        if args.indexname:
            mi.save(args.indexname)
        else:
            dist = tallymer.occurrence_distribution(mi)
            for count in sorted(dist):
                print(f"{count} {dist[count]}")
    elif args.sub == "search":
        mi = tallymer.MerIndex.load(args.tyr)
        q = Encseq.from_files(args.q)
        fwd, rev = _parse_strand(args.strand)
        res = tallymer.search(mi, q, forward=fwd, reverse=rev)
        out_toks = args.output if isinstance(args.output, list) \
            else [args.output]
        show = [f for tok in out_toks for f in tok.split(",")]
        if show in (["qseqnum", "qpos", "counts"], ["qpos", "counts"]) \
                and res.counts.size > (1 << 14):
            try:
                fd = sys.stdout.fileno()
            except Exception:
                fd = None
            if fd is not None:
                from .core.native import tyr_write_lines_native
                sys.stdout.flush()
                if tyr_write_lines_native(res.qseqnum, res.qpos,
                                          res.counts, res.strand,
                                          f"/dev/fd/{fd}",
                                          show[0] == "qseqnum", True):
                    return 0
        qs = res.qseqnum.tolist()
        qp = res.qpos.tolist()
        ct = res.counts.tolist()
        st = res.strand.tolist()
        lines = []
        for i in range(len(ct)):
            fields = []
            for f in show:
                if f == "qseqnum":
                    fields.append(str(qs[i]))
                elif f == "qpos":
                    fields.append(chr(st[i]) + str(qp[i]))
                elif f == "counts":
                    fields.append(str(ct[i]))
                elif f == "sequence":
                    fields.append(_code_to_seq(int(res.codes[i]),
                                               mi.mersize))
            lines.append("\t".join(fields))     # gt's field separator
        sys.stdout.write("\n".join(lines) + ("\n" if lines else ""))
    return 0


def _code_to_seq(code: int, k: int) -> str:
    chars = "acgt"
    return "".join(chars[(code >> (2 * (k - 1 - i))) & 3] for i in range(k))


def _add_tallymer(sub):
    p = sub.add_parser("tallymer", help="k-mer counting and search")
    sp = p.add_subparsers(dest="sub", required=True)
    pm = sp.add_parser("mkindex")
    pm.add_argument("-esa", required=True, help="enhanced suffix array index")
    pm.add_argument("-mersize", type=int, default=20)
    pm.add_argument("-minocc", type=int, default=1)
    pm.add_argument("-maxocc", type=int, default=None)
    pm.add_argument("-indexname", default=None)
    pm.add_argument("--cpu", action="store_true")
    ps = sp.add_parser("search")
    ps.add_argument("-tyr", required=True, help="tallymer index")
    ps.add_argument("-q", nargs="+", required=True, help="query files")
    ps.add_argument("-strand", default="f",
                    help="f=forward p=reverse ('fp' both); gt default f")
    ps.add_argument("-output", nargs="+", default=["qseqnum", "qpos",
                                                   "counts"])
    ps.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_tallymer)


def _parse_strand(s: str):
    return ("f" in s, "p" in s)


# ---------------------------------------------------------------------------
# repfind
# ---------------------------------------------------------------------------

def cmd_repfind(args):
    _force_platform(args)
    from .core.encseq import Encseq
    from .index.esa import load_esa
    from .match.repfind import (repfind_palindromic, repfind_reverse,
                                repfind_self, write_match_lines)

    enc = Encseq.load(args.ii)
    if args.q:
        # query matching (ref: gt_repfind.c:620 over
        # gt_querysubstringmatchiterator, esa-mmsearch.c): one exact
        # match record per db occurrence of each query position's
        # longest db-matching prefix >= -l
        from .match.querysearch import query_substring_matches
        esa = load_esa(args.ii, encseq=enc)
        q = Encseq.from_files(args.q)
        for dbpos, qpos, length in query_substring_matches(esa, q,
                                                           args.l):
            dbseq = int(enc.seqnum_of_pos(dbpos))
            dbrel = dbpos - int(enc.seq_startpos(dbseq))
            qseq = int(q.seqnum_of_pos(qpos))
            qrel = qpos - int(q.seq_startpos(qseq))
            print(f"{length} {dbseq} {dbrel} F {length} {qseq} {qrel}")
        return 0
    if args.extendgreedy is not False or args.extendxdrop is not False:
        from .match.repfind import repfind_extend
        esa = load_esa(args.ii, encseq=enc)
        kind = "greedy" if args.extendgreedy is not False else "xdrop"
        for m in repfind_extend(enc, args.l, kind,
                                minidentity=args.minidentity,
                                maxalignedlendifference=args.maxalilendiff,
                                perc_mat_history=args.percmathistory,
                                esa=esa):
            print(m.line())
        return 0
    if args.f or not (args.r or args.p):
        # memmap-fed native walk: no table loads or conversions at all
        from .match.maxpairs import enumerate_maxpairs_files
        from .match.repfind import _format_rows
        mp = enumerate_maxpairs_files(args.ii, enc, args.l)
        if mp is not None:
            write_match_lines(
                sys.stdout,
                _format_rows(enc, mp.pos1, mp.pos2, mp.length, "F"), "F")
        else:
            esa = load_esa(args.ii, encseq=enc, signed_suftab="i32")
            write_match_lines(sys.stdout,
                              repfind_self(enc, args.l, esa=esa), "F")
    if args.r:
        esa_r = load_esa(args.ii, encseq=enc)
        write_match_lines(sys.stdout,
                          repfind_reverse(enc, args.l, esa=esa_r), "R")
    if args.p:
        esa_p = load_esa(args.ii, encseq=enc)
        write_match_lines(sys.stdout,
                          repfind_palindromic(enc, args.l, esa=esa_p),
                          "P")
    return 0


def _add_repfind(sub):
    p = sub.add_parser("repfind", help="maximal exact repeats")
    p.add_argument("-l", type=int, required=True, help="minimum length")
    p.add_argument("-ii", required=True, help="input index")
    p.add_argument("-f", action="store_true", help="forward matches (default)")
    p.add_argument("-r", action="store_true", help="reverse matches")
    p.add_argument("-p", action="store_true", help="reverse-strand matches")
    p.add_argument("-extendgreedy", nargs="?", const=100, default=False,
                   type=int, help="greedy-extend maximal pairs")
    p.add_argument("-extendxdrop", nargs="?", const=97, default=False,
                   type=int, help="xdrop-extend maximal pairs")
    p.add_argument("-minidentity", type=int, default=80)
    p.add_argument("-maxalilendiff", type=int, default=30)
    p.add_argument("-percmathistory", type=int, default=55)
    p.add_argument("-q", nargs="+", default=None,
                   help="query files: report maximal db matches of "
                        "query substrings")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_repfind)


# ---------------------------------------------------------------------------
# gff3 and annotation tools
# ---------------------------------------------------------------------------

def cmd_gff3(args):
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.node_stream import add_introns_stream, sort_stream
    import itertools
    nodes = []
    for p in args.files or ["-"]:
        text = sys.stdin.read() if p == "-" else open(p).read()
        nodes.extend(parse_gff3(text, strict=not args.tidy))
    if args.xrfcheck is not None:
        from .anno.xrf import XRFChecker, XRFError, resolve_xrf_path
        try:
            checker = XRFChecker.from_file(
                resolve_xrf_path(args.xrfcheck or None))
            checker.check_nodes(nodes)
        except XRFError as e:
            print(f"gt gff3: error: {e}", file=sys.stderr)
            return 1
    stream = iter(nodes)
    if args.addintrons:
        stream = add_introns_stream(stream)
    if args.sort:
        stream = sort_stream(stream)
    out = GFF3Writer(retainids=args.retainids).render(list(stream))
    sys.stdout.write(out)
    return 0


def _add_gff3(sub):
    p = sub.add_parser("gff3", help="parse, validate and output GFF3")
    p.add_argument("files", nargs="*")
    p.add_argument("-sort", action="store_true")
    p.add_argument("-retainids", action="store_true")
    p.add_argument("-addintrons", action="store_true")
    p.add_argument("-tidy", action="store_true")
    p.add_argument("-xrfcheck", nargs="?", const="", default=None,
                   help="check Dbxref/Ontology_term attributes against "
                        "an XRF abbreviation definition file")
    p.set_defaults(func=cmd_gff3)


def cmd_stat(args):
    from .anno.gff3 import parse_gff3
    from .anno.node_stream import FeatureStats, stat_stream
    from .anno.genome_node import FeatureNode, RegionNode
    stats = FeatureStats()
    n_regions = 0
    for p in args.files:
        nodes = parse_gff3(open(p).read())
        n_regions += sum(isinstance(n, RegionNode) for n in nodes)
        list(stat_stream(nodes, stats))
    print(f"parsed genome node DAGs: "
          f"{stats.counts.get('gene', 0)}")
    print(f"sequence regions: {n_regions}")
    for t in sorted(stats.counts):
        print(f"{t}s: {stats.counts[t]}")
    return 0


def _add_stat(sub):
    p = sub.add_parser("stat", help="show statistics about GFF3 features")
    p.add_argument("files", nargs="+")
    p.set_defaults(func=cmd_stat)


# ---------------------------------------------------------------------------
# seqstat
# ---------------------------------------------------------------------------

def cmd_seqstat(args):
    from .core.seqio import read_seqfiles
    s = read_seqfiles(args.files)
    lens = np.array([len(x) for x in s.seqs], np.int64)
    total = int(lens.sum())
    print(f"# number of contigs:     {len(lens)}")
    print(f"# total contigs length:  {total}")
    print(f"# mean contig size:      {lens.mean():.2f}")
    print(f"# contig size first quartile: {int(np.percentile(lens, 25))}")
    print(f"# median contig size:         {int(np.median(lens))}")
    print(f"# contig size third quartile: {int(np.percentile(lens, 75))}")
    print(f"# longest contig:             {int(lens.max())}")
    print(f"# shortest contig:            {int(lens.min())}")
    # N50: largest L s.t. contigs >= L cover half the total
    sorted_lens = np.sort(lens)[::-1]
    csum = np.cumsum(sorted_lens)
    n50 = int(sorted_lens[np.searchsorted(csum, total / 2)])
    print(f"# contigs > 500 nt:           {(lens > 500).sum()} "
          f"({100.0 * (lens > 500).sum() / len(lens):.2f} %)")
    print(f"# N50:                {n50}")
    l50 = int(np.searchsorted(csum, total / 2)) + 1
    print(f"# L50:                {l50}")
    return 0


def _add_seqstat(sub):
    p = sub.add_parser("seqstat", help="sequence set statistics")
    p.add_argument("files", nargs="+")
    p.set_defaults(func=cmd_seqstat)


# ---------------------------------------------------------------------------
# seed_extend
# ---------------------------------------------------------------------------

def cmd_seed_extend(args):
    _force_platform(args)
    from .core.encseq import Encseq
    from .match.seed_extend import SeedExtendParams, seed_extend
    aenc = Encseq.load(args.ii)
    benc = Encseq.load(args.qii) if args.qii else None
    p = SeedExtendParams(
        seedlength=args.seedlength or None,
        minidentity=args.minidentity,
        sensitivity=args.extendxdrop or args.extendgreedy or 97,
        userdefinedleastlength=args.l or 0,
        # greedy is the default extension mode
        # (ref: gt_seed_extend.c:833 extendgreedy = true)
        extension="xdrop" if args.extendxdrop else "greedy",
        maxfreq=args.maxfreq,
        reverse=not args.no_reverse,
        history=args.history,
        logdiagbandwidth=args.diagbandwidth,
        perc_mat_history=args.percmathistory,
        maxalignedlendifference=args.maxalilendiff,
        spacedseedweight=args.spacedseed,
        parts=args.parts,
        pick=tuple(int(x) for x in args.pick.split(","))
        if args.pick else None)
    if args.pick and args.parts <= 1:
        raise SystemExit('option "-pick" requires option "-parts"')
    if args.estim:
        from .match.estim import seed_extend_estim
        sys.stdout.write(seed_extend_estim(
            aenc, benc, p, mode=args.estim,
            delta_filter=args.delta_filter,
            bias_parameters=args.bias_parameters,
            aname=args.ii, bname=args.qii or args.ii))
        return 0
    outfmt = args.outfmt or []
    width = 60
    seed_in_algn = "seed_in_algn" in outfmt
    show_alignment = any(o == "alignment" or o.startswith("alignment=")
                         for o in outfmt)
    for o in outfmt:
        if o.startswith("alignment="):
            width = int(o.split("=")[1])
    if show_alignment:
        from .match.seed_extend import _seq_codes
        from .match.seedext_display import (format_alignment,
                                            seeded_alignment)
        from .ops.greedy import PolishingInfo
        pol = PolishingInfo.new(float(p.errorpercentage), p.history)
        pmh, mad = p.greedy_params()
    col_fmts = []
    for o in outfmt:
        if o == "seed":
            col_fmts += ["seed.len", "seed.s", "seed.q"]
        elif o in ("cigar", "cigarX", "evalue", "bitscore", "s.seqlen",
                   "q.seqlen", "subjectid", "queryid", "seed.len",
                   "seed.s", "seed.q"):
            col_fmts.append(o)
    show_failed = "failed_seed" in outfmt
    ka = None
    if "evalue" in col_fmts or "bitscore" in col_fmts:
        from .match.karlin_altschul import KarlinAltschulStat
        ka = KarlinAltschulStat.new_gapped(aenc.total_length,
                                           aenc.num_sequences)
    if col_fmts:
        from .match.seedext_display import match_extra_columns
    if args.maxmat:
        from .match.seed_extend import maximal_exact_matches
        k = args.seedlength or min(32, args.l or 20)
        for m in maximal_exact_matches(aenc, benc if args.qii else None,
                                       k, args.l):
            print(f"{m.dblen:8d}{m.dbseqnum:10d}{m.dbstart + 1:10d}  "
                  f"{m.direction}{m.queryseqnum:10d}"
                  f"{m.querystart + 1:10d}")
        return 0
    events = [] if show_failed else None
    if args.dist is not None and args.parts > 1:
        # mesh-dispatched grid: cells fan out over devices, output
        # stays in grid-cell order (parallel/dist_seed_grid)
        import jax
        from .parallel.dist_seed_grid import distributed_seed_extend
        ndev = args.dist or len(jax.devices())
        result = distributed_seed_extend(
            aenc, benc, p, events=events,
            devices=jax.devices()[:ndev] if ndev else None)
    else:
        plain = not (show_failed or col_fmts or show_alignment)
        raw = [] if plain else None
        result = seed_extend(aenc, benc, p, events=events, raw_sink=raw)
        if raw:
            # bulk emission: fused-engine record blocks go through the
            # native line formatter straight to the output fd; object
            # blocks (non-fused strands) print normally — emission
            # order is the generation order either way
            from .core.native import seedext_write_lines_native
            for block in raw:
                if block[0] == "recs":
                    _, d, _k, recs = block
                    done = False
                    if recs.shape[0]:
                        try:
                            fd = sys.stdout.fileno()
                        except Exception:
                            fd = None
                        if fd is not None:
                            sys.stdout.flush()
                            done = seedext_write_lines_native(
                                recs, d, f"/dev/fd/{fd}", True)
                    if not done:
                        from .match.seed_extend import _recs_to_matches
                        for m in _recs_to_matches(recs, d, _k):
                            print(m.line())
                else:
                    for m in block[1]:
                        print(m.line())
            return 0
    if show_failed:
        stream = events
    else:
        stream = [("match", m) for m in result]
    for ev in stream:
        if ev[0] == "failed":
            _, k, aseq, apos, d, bseq, bpos = ev
            print(f"# failed_seed: {k} {aseq} {apos} {d} {bseq} {bpos}")
            continue
        m = ev[1]
        if col_fmts:
            extra = match_extra_columns(m, aenc, benc or aenc, p,
                                        col_fmts, ka)
            parts = m.line().split()
            if "subjectid" in col_fmts:
                parts[1] = extra[col_fmts.index("subjectid")]
            if "queryid" in col_fmts:
                parts[5] = extra[col_fmts.index("queryid")]
            rest = [x for o, x in zip(col_fmts, extra)
                    if o not in ("subjectid", "queryid")]
            print(" ".join(parts + rest))
        else:
            print(m.line())
        if show_alignment and m.direction == "F":
            useq = _seq_codes(aenc, m.dbseqnum, False)
            vseq = _seq_codes(benc or aenc, m.queryseqnum, False)
            ops, uo, ul, vo, vl, useedoff = seeded_alignment(
                useq, vseq, m.dbstart, m.dblen, m.querystart,
                m.querylen, m.db_seedpos, m.query_seedpos, m.seedlen,
                pol, pmh, mad)
            sys.stdout.write(format_alignment(
                ops, useq[uo:uo + ul], vseq[vo:vo + vl], uo, vo,
                width=width, useedoffset=useedoff, seedlen=m.seedlen,
                seed_in_algn=seed_in_algn))
    return 0


def _add_seed_extend(sub):
    p = sub.add_parser("seed_extend", help="seed and extend matching")
    p.add_argument("-ii", required=True)
    p.add_argument("-qii", default=None, help="query index (default: self)")
    p.add_argument("-l", type=int, default=None,
                   help="minimum alignment len (default: mincoverage)")
    p.add_argument("-estim", choices=["ANI", "JKD"], default=None)
    p.add_argument("-snd_pass", action="store_true")  # implied by -estim
    p.add_argument("-bias-parameters", dest="bias_parameters",
                   action="store_true")
    p.add_argument("-delta-filter", dest="delta_filter",
                   action="store_true")
    p.add_argument("-noinseqseeds", action="store_true")  # implied
    p.add_argument("-histogram", default=None)            # accepted, no-op
    p.add_argument("-cam", default=None)                  # accepted, no-op
    p.add_argument("-parts", type=int, default=1)
    p.add_argument("-pick", default=None, help="run one grid cell: a,b")
    p.add_argument("-diagbandwidth", type=int, default=6)
    p.add_argument("-seedlength", type=int, default=0)
    p.add_argument("-spacedseed", type=int, nargs="?", const=0,
                   default=None,
                   help="use tuned spaced seeds (optional weight; span "
                        "= seedlength)")
    p.add_argument("-minidentity", type=int, default=80)
    p.add_argument("-extendxdrop", type=int, nargs="?", const=97, default=0)
    p.add_argument("-extendgreedy", type=int, nargs="?", const=97, default=0)
    p.add_argument("-maxfreq", type=int, default=None)
    p.add_argument("-no-reverse", dest="no_reverse", action="store_true")
    p.add_argument("-history", type=int, default=64)
    p.add_argument("-percmathistory", type=int, default=None)
    p.add_argument("-maxalilendiff", type=int, default=None)
    p.add_argument("-outfmt", nargs="+", default=None)
    p.add_argument("-maxmat", action="store_true")
    p.add_argument("-dist", type=int, nargs="?", const=0, default=None,
                   metavar="N",
                   help="fan the -parts grid cells out over N mesh "
                        "devices (0 = all attached devices)")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_seed_extend)


# ---------------------------------------------------------------------------
# readjoiner
# ---------------------------------------------------------------------------

def cmd_readjoiner(args):
    from .assembly import readjoiner as rj
    from .core.seqio import write_fasta
    if args.sub == "prefilter":
        rs = rj.ReadSet.from_files(
            args.db, maxlow=args.maxlow, lowqual=args.lowqual,
            phredbase=64 if args.phred64 else 33)
        contained = rj.find_contained(rs)
        import numpy as _np
        keepmask = ~contained
        posmask = _np.repeat(keepmask, rs.lens)
        # one blob + offsets (a 100k-key compressed zip took ~25s)
        _np.savez(args.readset + ".reads", blob=rs.blob[posmask],
                  lens=rs.lens[keepmask])
        print(f"# {rs.num_reads} reads, {int(contained.sum())} contained, "
              f"{int(keepmask.sum())} kept", file=sys.stderr)
    elif args.sub == "overlap":
        rs = _load_readset(args.readset)
        spms = rj.find_spms(rs, args.l, singlestrand=args.singlestrand)
        if args.spmformat in ("bin32", "bin64"):
            spms.write_bin(args.readset + ".spm",
                           bits=32 if args.spmformat == "bin32" else 64)
        else:
            with open(args.readset + ".spm", "w") as f:
                for line in spms.lines():
                    f.write(line + "\n")
        print(f"# {spms.length.size} SPMs", file=sys.stderr)
    elif args.sub == "cgraph":
        import os
        rs = _load_readset(args.readset)
        if os.path.exists(args.readset + ".spm"):
            spms = rj.SpmList.read(args.readset + ".spm")
        else:
            spms = rj.find_spms(rs, args.l)
        cg = rj.ContigsGraph.from_assembly(rs, spms,
                                           min_depth=args.depthcutoff)
        merges = cg.simplify()
        with open(args.readset + ".cgraph.dot", "w") as f:
            f.write(cg.show_dot())
        with open(args.readset + ".paths", "w") as f:
            for line in cg.output_paths():
                f.write(line + "\n")
        print(f"# cgraph: {len(cg.seqs) - len(cg.deleted)} contigs after "
              f"{merges} junction merges", file=sys.stderr)
    elif args.sub == "assembly":
        import os
        rs = _load_readset(args.readset)
        if os.path.exists(args.readset + ".spm"):
            spms = rj.SpmList.read(args.readset + ".spm", args.l)
        else:
            spms = rj.find_spms(rs, args.l)
        g = rj.StringGraph.from_spms(rs, spms)
        g.reduce_self()
        g.reduce_transitive()
        contigs = g.spell_contigs(min_depth=args.depthcutoff,
                                  min_length=args.lengthcutoff)
        with open(args.readset + ".contigs.fas", "w") as f:
            for i, (seq, depth, desc) in enumerate(contigs):
                f.write(f">contig_{i} length={len(seq)} depth={depth} "
                        f"{desc}\n{seq}\n")
        print(f"# {len(contigs)} contigs", file=sys.stderr)
    elif args.sub == "spmtest":
        rs = rj.ReadSet.from_files(args.db)
        spms = rj.find_spms(rs, args.l, singlestrand=args.singlestrand)
        for line in spms.lines():
            print(line)
    return 0


def _load_readset(name):
    import numpy as _np
    from .assembly.readjoiner import ReadSet
    d = _np.load(name + ".reads.npz")
    if "blob" in d.files:
        return ReadSet(blob=d["blob"], lens=d["lens"])
    return ReadSet([d[k] for k in sorted(d.files,
                                         key=lambda s: int(s[1:]))])


def _add_readjoiner(sub):
    p = sub.add_parser("readjoiner", help="string graph assembler")
    sp = p.add_subparsers(dest="sub", required=True)
    pp_ = sp.add_parser("prefilter")
    pp_.add_argument("-db", nargs="+", required=True)
    pp_.add_argument("-readset", default="reads")
    pp_.add_argument("-maxlow", type=int, default=None,
                     help="max low-quality positions per FASTQ read")
    pp_.add_argument("-lowqual", type=int, default=0,
                     help="phred value considered low")
    pp_.add_argument("-phred64", action="store_true")
    po = sp.add_parser("overlap")
    po.add_argument("-readset", default="reads")
    po.add_argument("-l", type=int, default=45)
    po.add_argument("-singlestrand", action="store_true")
    po.add_argument("-spmformat", default="bin32",
                    choices=["text", "bin32", "bin64"])
    pc = sp.add_parser("cgraph")
    pc.add_argument("-readset", default="reads")
    pc.add_argument("-l", type=int, default=45)
    pc.add_argument("-depthcutoff", type=int, default=1)
    pa = sp.add_parser("assembly")
    pa.add_argument("-readset", default="reads")
    pa.add_argument("-l", type=int, default=45)
    pa.add_argument("-depthcutoff", type=int, default=3)
    pa.add_argument("-lengthcutoff", type=int, default=100)
    ps = sp.add_parser("spmtest")
    ps.add_argument("-db", nargs="+", required=True)
    ps.add_argument("-l", type=int, default=3)
    ps.add_argument("-singlestrand", action="store_true")
    p.set_defaults(func=cmd_readjoiner)


# ---------------------------------------------------------------------------
# ltrharvest / packedindex / genomediff / uniquesub / matstat
# ---------------------------------------------------------------------------

def cmd_ltrharvest(args):
    _force_platform(args)
    from .core.encseq import Encseq
    from .ltr.ltrharvest import LTRHarvestParams, gff3_nodes, ltrharvest
    enc = Encseq.load(args.index)
    params = LTRHarvestParams(
        seedlength=args.seed, minlenltr=args.minlenltr,
        maxlenltr=args.maxlenltr, mindistltr=args.mindistltr,
        maxdistltr=args.maxdistltr, similar=args.similar,
        mintsd=args.mintsd, with_tsd=args.mintsd > 0)
    preds = ltrharvest(enc, params)
    if args.gff3:
        from .anno.gff3 import gff3_to_string
        text = gff3_to_string(gff3_nodes(preds, enc, seqids=args.seqids))
        if isinstance(args.gff3, str):
            with open(args.gff3, "w") as f:
                f.write(text)
        else:
            sys.stdout.write(text)
    if args.tabout != "no" and not args.gff3:
        from .ltr.ltrharvest import tabout_lines
        print("# s(ret) e(ret) l(ret) s(lLTR) e(lLTR) l(lLTR) "
              "s(rLTR) e(rLTR) l(rLTR) sim(LTRs) seq-nr")
        for line in tabout_lines(preds, enc,
                                 longoutput=args.longoutput):
            print(line)
    from .ltr.ltrharvest import fasta_out_entries
    if args.out:
        with open(args.out, "w") as f:
            for line in fasta_out_entries(preds, enc, inner=False):
                f.write(line + "\n")
    if args.outinner:
        with open(args.outinner, "w") as f:
            for line in fasta_out_entries(preds, enc, inner=True):
                f.write(line + "\n")
    return 0


def _add_ltrharvest(sub):
    p = sub.add_parser("ltrharvest", help="LTR retrotransposon prediction")
    p.add_argument("-index", required=True)
    p.add_argument("-seed", type=int, default=30)
    p.add_argument("-minlenltr", type=int, default=100)
    p.add_argument("-maxlenltr", type=int, default=1000)
    p.add_argument("-mindistltr", type=int, default=1000)
    p.add_argument("-maxdistltr", type=int, default=15000)
    p.add_argument("-similar", type=float, default=85.0)
    p.add_argument("-mintsd", type=int, default=4)
    p.add_argument("-gff3", nargs="?", const=True, default=False,
                   help="GFF3 output (optionally to a file)")
    p.add_argument("-out", default=None,
                   help="FASTA of predicted elements")
    p.add_argument("-outinner", default=None,
                   help="FASTA of inner regions between the LTRs")
    p.add_argument("-tabout", default="yes", choices=["yes", "no"])
    p.add_argument("-longoutput", action="store_true")
    p.add_argument("-seqids", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_ltrharvest)


def cmd_ltrdigest(args):
    """gt ltrdigest: PPT/PBS annotation of LTR retrotransposons
    (ref: src/tools/gt_ltrdigest.c)."""
    from .anno.gff3 import gff3_to_string, parse_gff3
    from .ltr.ltrdigest import LTRdigestParams, ltrdigest
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    try:
        nodes = parse_gff3(text)
        mapping = _region_mapping(args)
        trna_lib = None
        if args.trnas:
            from .core.seqio import read_seqfile
            ss = read_seqfile(args.trnas)
            trna_lib = [(d.split()[0], s.tobytes().decode())
                        for d, s in zip(ss.descs, ss.seqs)]
        params = LTRdigestParams(
            ppt_len=(args.pptlen[0], args.pptlen[1]),
            ubox_len=(args.uboxlen[0], args.uboxlen[1]),
            ppt_radius=args.pptradius,
            max_ubox_dist=args.maxgaplen,
            pbs_alilen=(args.pbsalilen[0], args.pbsalilen[1]),
            pbs_offsetlen=(args.pbsoffset[0], args.pbsoffset[1]),
            pbs_trnaoffsetlen=(args.pbstrnaoffset[0],
                               args.pbstrnaoffset[1]),
            pbs_max_edist=args.pbsmaxedist, pbs_radius=args.pbsradius)
        ltrdigest(nodes, mapping, trna_lib, params)
        if args.outfileprefix:
            from .ltr.ltrdigest import ltrdigest_file_out
            ltrdigest_file_out(nodes, mapping, args.outfileprefix,
                               seqnamelen=args.seqnamelen)
    except ValueError as e:
        print(f"gt ltrdigest: error: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(gff3_to_string(nodes, retainids=True))
    return 0


def _add_ltrdigest(sub):
    p = sub.add_parser("ltrdigest",
                       help="annotate PPT/PBS in LTR retrotransposons")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-seqfile")
    p.add_argument("-encseq")
    p.add_argument("-matchdesc", action="store_true")
    p.add_argument("-usedesc", action="store_true")
    p.add_argument("-trnas")
    p.add_argument("-pptlen", type=int, nargs=2, default=[8, 30])
    p.add_argument("-uboxlen", type=int, nargs=2, default=[3, 30])
    p.add_argument("-pptradius", type=int, default=30)
    p.add_argument("-maxgaplen", type=int, default=0)
    p.add_argument("-pbsalilen", type=int, nargs=2, default=[11, 30])
    p.add_argument("-pbsoffset", type=int, nargs=2, default=[0, 5])
    p.add_argument("-pbstrnaoffset", type=int, nargs=2, default=[0, 5])
    p.add_argument("-pbsmaxedist", type=int, default=1)
    p.add_argument("-pbsradius", type=int, default=30)
    p.add_argument("-outfileprefix", default=None,
                   help="prefix for tabular + FASTA output files")
    p.add_argument("-seqnamelen", type=int, default=20)
    p.set_defaults(func=cmd_ltrdigest)


def cmd_packedindex(args):
    _force_platform(args)
    from .core.encseq import Encseq
    from .index.fmindex import build_fmindex
    if args.sub == "mkindex":
        enc = Encseq.from_files(args.db) if args.db else Encseq.load(args.ii)
        fm = build_fmindex(enc)
        fm.save(args.indexname)
        enc.save(args.indexname)
        if args.bdx:
            # also emit the reference's .bdx block-composition format
            # (gt packedindex chkintegrity-verified; index/bdx.py)
            import numpy as np
            from .index.bdx import write_bdx
            from .index.esa import build_esa
            esa = build_esa(enc, with_lcp=False)
            counts = [int((enc.codes == c).sum())
                      for c in range(enc.alphabet.num_chars)]
            write_bdx(args.indexname + ".bdx",
                      esa.bwt().astype(np.int16), counts)
    elif args.sub == "chkintegrity":
        # decode a reference-format .bdx (ref: gt packedindex
        # chkintegrity, src/tools/gt_packedindex_chk_integrity.c) and
        # verify the recovered BWT against the BWT our ESA engine
        # computes from the index's own encseq files
        from .index.bdx import decode_bwt, read_header
        from .index.esa import build_esa
        import numpy as np
        enc = Encseq.load(args.ii)
        got = decode_bwt(args.ii + ".bdx")
        esa = build_esa(enc, readmode=args.dir, with_lcp=False)
        ours = esa.bwt().astype(np.int16)
        if got.size != ours.size or not (got == ours).all():
            bad = int(np.flatnonzero(got[:ours.size] != ours)[0]) \
                if got.size == ours.size else -1
            print(f"chkintegrity: MISMATCH (first at {bad})",
                  file=sys.stderr)
            return 1
        print(f"# {got.size} symbols verified OK", file=sys.stderr)
    return 0


def _add_packedindex(sub):
    p = sub.add_parser("packedindex", help="BWT-based compressed index")
    sp = p.add_subparsers(dest="sub", required=True)
    pm = sp.add_parser("mkindex")
    pm.add_argument("-db", nargs="*", default=None)
    pm.add_argument("-ii", default=None)
    pm.add_argument("-indexname", required=True)
    pm.add_argument("-bdx", action="store_true",
                    help="also write the reference .bdx format")
    pm.add_argument("--cpu", action="store_true")
    pc = sp.add_parser("chkintegrity",
                       help="verify a reference-format .bdx index")
    pc.add_argument("-ii", required=True)
    pc.add_argument("-dir", type=int, default=0,
                    help="readmode the index was built with (0=fwd)")
    pc.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_packedindex)


def cmd_condenseq(args):
    """ref: src/tools/gt_condenseq*.c — compress / extract / info /
    search over redundancy-compressed sequence sets."""
    from .core.alphabet import dna_alphabet
    from .core.seqio import read_seqfiles
    from .utils import condenseq as cq
    if args.sub == "compress":
        ss = read_seqfiles(args.files)
        store = cq.compress(ss, kmersize=args.kmersize)
        cq.save(store, args.indexname)
        st = cq.info(store)
        print(f"# compressed {st['number of sequences']} sequences, "
              f"ratio {st['compression ratio']}", file=sys.stderr)
        return 0
    store = cq.load(args.archive)
    alpha = dna_alphabet()
    if args.sub == "extract":
        idxs = ([int(x) for x in args.sequences] if args.sequences
                else range(store.num_sequences))
        for i in idxs:
            print(f">{store.descs[i]}")
            s = alpha.decode(store.extract(i))
            for j in range(0, len(s), 60):
                print(s[j:j + 60])
    elif args.sub == "info":
        for k, v in cq.info(store).items():
            print(f"{k}: {v}")
    elif args.sub == "search":
        qs = read_seqfiles([args.query])
        for qi, q in enumerate(qs.seqs):
            enc = alpha.encode(q)
            for seqnum, pos in cq.search(store, enc):
                print(f"{qi}\t{seqnum}\t{pos}\t{enc.size}")
    return 0


def _add_condenseq(sub):
    p = sub.add_parser("condenseq",
                       help="redundancy-compressed sequence sets")
    sp = p.add_subparsers(dest="sub", required=True)
    pc = sp.add_parser("compress")
    pc.add_argument("-indexname", required=True)
    pc.add_argument("-kmersize", type=int, default=16)
    pc.add_argument("files", nargs="+")
    pe = sp.add_parser("extract")
    pe.add_argument("-sequences", nargs="+", default=None)
    pe.add_argument("archive")
    pi = sp.add_parser("info")
    pi.add_argument("archive")
    ps = sp.add_parser("search")
    ps.add_argument("-query", required=True)
    ps.add_argument("archive")
    p.set_defaults(func=cmd_condenseq)


def cmd_tagerator(args):
    """Approximate tag mapping (ref: src/tools/gt_tagerator.c +
    src/match/tagerator.c); output columns and headers match the
    reference; see match/querysearch.tagerator_search for semantics."""
    _force_platform(args)
    from .core.chardef import is_special
    from .core.encseq import Encseq
    from .core.seqio import read_seqfile
    if args.esa is None and args.pck is None:
        raise SystemExit("one of -esa or -pck is required")
    e = args.e if args.e is not None and args.e >= 0 else 0
    outkeys = args.output or ["tagnum", "tagseq", "dblength",
                              "dbstartpos", "strand"]
    if e == 0:
        print("# computing complete matches without differences "
              "(exact matches)")
    else:
        print(f"# computing complete matches with up to {e} differences")
    if args.esa:
        print(f"# indexname(esa)={args.esa}")
        enc = Encseq.load(args.esa)
        from .index.esa import load_esa
        from .match.querysearch import tagerator_search
        esa = load_esa(args.esa, encseq=enc)
        search = lambda tagc, dist: tagerator_search(esa, tagc, dist)
    else:
        print(f"# indexname(pck)={args.pck}")
        from .index.fmindex import fmindex_from_codes, pck_tagerator_search
        enc = Encseq.load(args.pck)
        # forward-trie DFS over the packed index = FM over the REVERSED
        # codes (like the reference's `packedindex mkindex -dir rev`)
        fm = fmindex_from_codes(enc.codes[::-1].copy())
        n = enc.total_length
        search = lambda tagc, dist: pck_tagerator_search(fm, tagc, dist, n)
    print(f"# queryfile={args.q}")
    print("# for each match show: " + " ".join(outkeys) + " ")
    tags = read_seqfile(args.q)
    comp = enc.alphabet.complement_table()
    for tagnum, raw in enumerate(tags.seqs):
        codes = enc.alphabet.encode(raw)
        if is_special(codes).any():
            raise SystemExit(f"gt-tpu tagerator: error: wildcard in tag "
                             f"number {tagnum}")
        tagseq = enc.alphabet.decode(codes).lower()
        if "tagnum" in outkeys or "tagseq" in outkeys:
            print(f"#\t{tagnum}\t{tagseq}")
        dirs = []
        if not args.nod:
            dirs.append(("+", codes))
        if not args.nop:
            dirs.append(("-", np.where(is_special(codes[::-1]),
                                       codes[::-1], comp[codes[::-1]])))
        mind = 0 if args.best else e
        for dist in range(mind, e + 1):
            found = False
            for strand, tagc in dirs:
                rows = search(tagc, dist)
                if args.maxocc:
                    rows = rows[:args.maxocc]
                for pos, dblen, edist in rows:
                    found = True
                    s = int(enc.seqnum_of_pos(pos))
                    rel = pos - int(enc.seq_startpos(s))
                    cols = []
                    if "dblength" in outkeys:
                        cols.append(str(dblen))
                    if "dbstartpos" in outkeys:
                        if "abspos" in outkeys:
                            cols.append(str(pos))
                        else:
                            cols += [str(s), str(rel)]
                    if "dbsequence" in outkeys:
                        cols.append(enc.alphabet.decode(
                            enc.codes[pos:pos + dblen]).lower())
                    if "strand" in outkeys:
                        cols.append(strand)
                    if "edist" in outkeys:
                        cols.append(str(edist))
                    print("\t".join(cols))
            if args.best and found:
                break
    return 0


def _add_tagerator(sub):
    p = sub.add_parser("tagerator", help="map short tags approximately")
    p.add_argument("-q", required=True, help="tag file (FASTA)")
    p.add_argument("-e", type=int, default=None, help="max differences")
    p.add_argument("-esa", default=None, help="enhanced suffix array index")
    p.add_argument("-pck", default=None, help="packed index")
    p.add_argument("-nod", action="store_true", help="no direct matches")
    p.add_argument("-nop", action="store_true", help="no palindromic")
    p.add_argument("-best", action="store_true")
    p.add_argument("-maxocc", type=int, default=0)
    p.add_argument("-output", nargs="+", default=None)
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_tagerator)


def cmd_genomediff(args):
    _force_platform(args)
    from .core.encseq import Encseq
    from .match.genomediff import genomediff
    import os
    genomes = [Encseq.from_files([f]) for f in args.files]
    sums, kr = genomediff(genomes)
    names = [os.path.basename(f).split(".")[0] for f in args.files]
    width = max(len(n) for n in names) + 1
    # shulen-sum matrix then Kr matrix (ref: genomediff output,
    # testdata/genomediff/*-kr.out)
    print(len(genomes))
    for i, name in enumerate(names):
        print(f"{name:<{width}}" + " ".join(
            str(int(sums[i, j])) for j in range(len(genomes))) + " ")
    print(len(genomes))
    for i, name in enumerate(names):
        print(f"{name:<{width}}" + " ".join(
            f"{kr[i, j]:.6f}" for j in range(len(genomes))) + " ")
    return 0


def _add_genomediff(sub):
    p = sub.add_parser("genomediff", help="pairwise Kr divergence")
    p.add_argument("files", nargs="+")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_genomediff)


def cmd_uniquesub(args):
    _force_platform(args)
    from .core.encseq import Encseq
    from .index.esa import load_esa
    from .match.querysearch import minimum_unique_substrings
    esa = load_esa(args.esa)
    q = Encseq.from_files(args.query)
    for qpos, length in minimum_unique_substrings(
            esa, q, args.min, args.max):
        line = f"{qpos} {length}"
        if args.output_sequence:
            line += " " + q.alphabet.decode(q.codes[qpos:qpos + length])
        print(line)
    return 0


def _add_uniquesub(sub):
    p = sub.add_parser("uniquesub", help="minimum unique substrings")
    p.add_argument("-esa", required=True)
    p.add_argument("-query", nargs="+", required=True)
    p.add_argument("-min", type=int, default=1)
    p.add_argument("-max", type=int, default=None)
    p.add_argument("-output-sequence", dest="output_sequence",
                   action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_uniquesub)


def cmd_matstat(args):
    _force_platform(args)
    from .core.encseq import Encseq
    from .index.esa import load_esa
    from .match.querysearch import matching_statistics
    esa = load_esa(args.esa)
    q = Encseq.from_files(args.query)
    ms = matching_statistics(esa, q)
    for qpos in range(ms.size):
        print(f"{qpos} {int(ms[qpos])}")
    return 0


def _add_matstat(sub):
    p = sub.add_parser("matstat", help="matching statistics")
    p.add_argument("-esa", required=True)
    p.add_argument("-query", nargs="+", required=True)
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_matstat)


# ---------------------------------------------------------------------------
# sequence utility tools
# ---------------------------------------------------------------------------

def _show_fasta(out, width: int, file=None):
    """gt_fasta_show_entry semantics: width 0 means one line."""
    file = file or sys.stdout
    for desc, seq in zip(out.descs, out.seqs):
        s = seq.tobytes().decode("latin-1") if hasattr(seq, "tobytes") \
            else seq
        file.write(">" + desc + "\n")
        if width:
            for i in range(0, len(s), width):
                file.write(s[i:i + width] + "\n")
            if not s:
                file.write("\n")
        else:
            file.write(s + "\n")


def cmd_seqtool(args):
    from .core.seqio import read_seqfiles
    from .utils import seqtools
    files = args.files or ["-"]
    if "-" in files:
        import tempfile
        data = sys.stdin.buffer.read()
        tf = tempfile.NamedTemporaryFile(suffix=".fas", delete=False)
        tf.write(data)
        tf.close()
        files = [tf.name if f == "-" else f for f in files]
    try:
        s = read_seqfiles(files)
    except (ValueError, OSError) as exc:
        print(f"gt {args.tool}: error: {exc}", file=sys.stderr)
        return 1
    width = getattr(args, "width", 0)
    if args.tool == "extractseq":
        if args.keys:
            keys_text = sys.stdin.read() if args.keys == "-" \
                else open(args.keys).read()
            try:
                for header, seq in seqtools.extractseq_keys(s, keys_text):
                    from .core.seqio import SeqSet
                    import numpy as _np
                    one = SeqSet(
                        seqs=[_np.frombuffer(seq.encode("latin-1"),
                                             _np.uint8)],
                        descs=[header])
                    _show_fasta(one, width)
            except ValueError as exc:
                print(f"gt extractseq: error: {exc}", file=sys.stderr)
                return 1
            return 0
        if (args.frompos is None) != (args.topos is None):
            print("gt extractseq: error: option \"-frompos\" requires "
                  "option \"-topos\"", file=sys.stderr)
            return 1
        if args.frompos is not None and args.frompos > args.topos:
            print("gt extractseq: error: argument to option '-frompos' "
                  "must be <= argument to option '-topos'", file=sys.stderr)
            return 1
        try:
            out = seqtools.extractseq(s, args.frompos, args.topos,
                                      args.match)
        except ValueError as exc:
            print(f"gt extractseq: error: {exc}", file=sys.stderr)
            return 1
        except re.error as exc:
            print(f"gt extractseq: error: invalid pattern: {exc}",
                  file=sys.stderr)
            return 1
    elif args.tool == "shredder":
        if args.minlength > args.maxlength:
            print("gt shredder: error: -minlength must be <= than "
                  "-maxlength", file=sys.stderr)
            return 1
        out = seqtools.shredder(s, args.minlength, args.maxlength,
                                args.overlap, args.coverage,
                                sample_probability=args.sample,
                                clip_desc=args.clipdesc)
    elif args.tool == "sequniq":
        out, dups = seqtools.sequniq(s, rev=args.rev)
        n = len(s.seqs)
        print(f"# {dups} out of {n} sequences have been removed "
              f"({dups / n * 100.0:.3f}%)", file=sys.stderr)
    elif args.tool == "seqfilter":
        out, filtered, total = seqtools.seqfilter(
            s, args.minlength, args.maxlength, args.maxseqnum,
            step=args.step, sample_prob=args.sample,
            nowildcards=args.nowildcards)
        print(f"# {filtered} out of {total} sequences have been removed "
              f"({filtered / total * 100.0:.3f}%)", file=sys.stderr)
    elif args.tool == "simreads":
        out = seqtools.simreads(s, num=args.num, length=args.length,
                                coverage=args.coverage)
    elif args.tool == "mutate":
        out = seqtools.mutate(s, args.rate)
        out.descs = [d + f" [mutated with rate {int(args.rate)}]"
                     for d in out.descs]
    elif args.tool == "seqtranslate":
        from .core.seqio import SeqSet
        for desc, seq in zip(s.descs, s.seqs):
            text = seq.tobytes().decode("latin-1")
            if len(text) < 3:
                print(f"warning: sequence '{desc}' is shorter than codon "
                      f"length of 3, skipping", file=sys.stderr)
                continue
            frames = seqtools.translate_all_frames(text)
            for f, t in enumerate(frames):
                if not t:
                    continue
                strand = "+" if f < 3 else "-"
                one = SeqSet(seqs=[t], descs=[
                    f"{desc} ({f % 3 + 1}{strand})"])
                _show_fasta(one, args.fastawidth)
        return 0
    elif args.tool == "fingerprint":
        fps = seqtools.fingerprints(s)
        if args.check:
            from collections import Counter
            have = Counter(fps)
            text = sys.stdin.read() if args.check == "-" \
                else open(args.check).read()
            failed = False
            for line in text.splitlines():
                line = line.strip()
                if not line:
                    continue
                if have.get(line, 0) > 0:
                    have[line] -= 1
                else:
                    print(f"{line} only in checklist")
                    failed = True
            for fp, cnt in sorted(have.items()):
                for _ in range(cnt):
                    print(f"{fp} only in sequence_file(s)")
                    failed = True
            if failed:
                print("gt fingerprint: error: fingerprint comparison "
                      "failed", file=sys.stderr)
                return 1
            return 0
        if args.duplicates:
            from collections import Counter
            cnt = Counter(fps)
            dups = 0
            for fp, c in sorted(cnt.items()):
                if c > 1:
                    print(f"{fp}\t{c}")
                    dups += c - 1
            if dups:
                n = len(fps)
                print(f"gt fingerprint: error: duplicates found: {dups} "
                      f"out of {n} ({dups / n * 100.0:.3f}%)",
                      file=sys.stderr)
                return 1
            return 0
        if args.extract:
            from .core.seqio import SeqSet
            hit = SeqSet()
            for fp, seq, desc in zip(fps, s.seqs, s.descs):
                if fp == args.extract:
                    hit.seqs.append(seq)
                    hit.descs.append(desc)
            _show_fasta(hit, width)
            return 0
        for fp in fps:
            print(fp)
        return 0
    else:
        raise SystemExit(f"unknown tool {args.tool}")
    _show_fasta(out, width)
    return 0


def _add_seqtools(sub):
    common = {
        "extractseq": "extract sequences from sequence file(s)",
        "shredder": "shred sequences into consecutive pieces",
        "sequniq": "filter out repeated sequences",
        "seqfilter": "filter sequence files",
        "simreads": "simulate sequencing reads",
        "mutate": "mutate the given sequences",
        "seqmutate": "mutate the given sequences",
        "seqtranslate": "translate a nucleotide sequence",
        "fingerprint": "compute MD5 fingerprints per sequence",
    }
    for name, helptext in common.items():
        p = sub.add_parser(name, help=helptext)
        p.add_argument("files", nargs="*")
        if name == "extractseq":
            p.add_argument("-frompos", type=int, default=None)
            p.add_argument("-topos", type=int, default=None)
            p.add_argument("-match", default=None)
            p.add_argument("-keys", default=None)
            p.add_argument("-width", type=int, default=0)
        elif name == "shredder":
            p.add_argument("-coverage", type=int, default=1)
            p.add_argument("-minlength", type=int, default=300)
            p.add_argument("-maxlength", type=int, default=700)
            p.add_argument("-overlap", type=int, default=0)
            p.add_argument("-sample", type=float, default=1.0)
            p.add_argument("-clipdesc", action="store_true")
            p.add_argument("-width", type=int, default=0)
        elif name == "sequniq":
            p.add_argument("-rev", action="store_true")
            p.add_argument("-seqit", action="store_true")
            p.add_argument("-v", action="store_true")
            p.add_argument("-width", type=int, default=0)
        elif name == "seqfilter":
            p.add_argument("-minlength", type=int, default=None)
            p.add_argument("-maxlength", type=int, default=None)
            p.add_argument("-maxseqnum", type=int, default=None)
            p.add_argument("-sample", type=float, default=1.0)
            p.add_argument("-step", type=int, default=1)
            p.add_argument("-nowildcards", action="store_true")
            p.add_argument("-width", type=int, default=0)
        elif name == "simreads":
            p.add_argument("-num", type=int, default=100)
            p.add_argument("-length", type=int, default=100)
            p.add_argument("-coverage", type=float, default=None)
            p.add_argument("-width", type=int, default=0)
        elif name in ("mutate", "seqmutate"):
            p.add_argument("-rate", type=float, default=1.0)
            p.add_argument("-width", type=int, default=0)
        elif name == "seqtranslate":
            p.add_argument("-reverse", default="yes")
            p.add_argument("-fastawidth", type=int, default=60)
        elif name == "fingerprint":
            p.add_argument("-check", default=None)
            p.add_argument("-duplicates", action="store_true")
            p.add_argument("-extract", default=None)
            p.add_argument("-width", type=int, default=0)
        p.set_defaults(func=cmd_seqtool,
                       tool="mutate" if name == "seqmutate" else name)


# ---------------------------------------------------------------------------
# annotation conversion + filtering tools
# ---------------------------------------------------------------------------

def cmd_convert_anno(args):
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.parsers import gff3_to_gtf, parse_bed, parse_gtf
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    if args.tool == "gtf_to_gff3":
        nodes = parse_gtf(text)
        sys.stdout.write(GFF3Writer(retainids=True).render(nodes))
    elif args.tool == "bed_to_gff3":
        nodes = parse_bed(text)
        sys.stdout.write(GFF3Writer(retainids=True).render(nodes))
    elif args.tool == "gff3_to_gtf":
        nodes = parse_gff3(text)
        sys.stdout.write(gff3_to_gtf(nodes))
    return 0


def _add_convert_anno(sub):
    for name in ("gtf_to_gff3", "bed_to_gff3", "gff3_to_gtf"):
        p = sub.add_parser(name, help=f"{name.replace('_', ' ')}")
        p.add_argument("file", nargs="?", default="-")
        p.set_defaults(func=cmd_convert_anno, tool=name)


def cmd_select(args):
    from .anno.genome_node import Range
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.node_stream import select_stream
    nodes = []
    for pth in args.files:
        nodes.extend(parse_gff3(open(pth).read()))
    contain = Range(args.contain[0], args.contain[1]) if args.contain         else None
    out = list(select_stream(
        nodes, seqid=args.seqid, typefilter=args.hastype,
        max_gene_length=args.maxgenelength, contain=contain))
    if args.rule_files:
        from .anno.script_filter import load_filter
        preds = [load_filter(p)[1] for p in args.rule_files]

        def drop(n):
            # only feature nodes are filtered (ref: script_filter.c
            # visits feature nodes; regions/comments pass through)
            if not hasattr(n, "type"):
                return False
            return (any if args.rule_logic == "OR" else all)(
                p(n) for p in preds)

        out = [n for n in out if not drop(n)]
    sys.stdout.write(GFF3Writer().render(out))
    return 0


def _add_select(sub):
    p = sub.add_parser("select", help="filter GFF3 features")
    p.add_argument("files", nargs="+")
    p.add_argument("-seqid", default=None)
    p.add_argument("-hastype", default=None)
    p.add_argument("-maxgenelength", type=int, default=None)
    p.add_argument("-contain", nargs=2, type=int, default=None)
    p.add_argument("-rule_files", nargs="+", default=None,
                   help="Python filter scripts (filter(gn) -> drop)")
    p.add_argument("-rule_logic", default="AND", choices=["AND", "OR"])
    p.set_defaults(func=cmd_select)


# ---------------------------------------------------------------------------
# seqid / feature manipulation streams
# (ref: gt_chseqids.c, gt_dupfeat.c, gt_mergefeat.c, gt_id_to_md5.c,
#  gt_md5_to_id.c)
# ---------------------------------------------------------------------------

def _read_gff3_files(files):
    from .anno.gff3 import parse_gff3
    nodes = []
    for pth in files:
        text = sys.stdin.read() if pth == "-" else open(pth).read()
        if not text.strip():
            raise SystemExit(f"gt chseqids: error: GFF3 file \"{pth}\" "
                             f"is empty")
        nodes.extend(parse_gff3(text))
    return nodes


def cmd_chseqids(args):
    from .anno.gff3 import GFF3Writer
    from .anno.md5translate import parse_lua_mapping
    from .anno.node_stream import chseqids_stream, sort_stream
    try:
        mapping = parse_lua_mapping(args.mapping_file, "chseqids")
    except ValueError as exc:
        print(f"gt chseqids: error: {exc}", file=sys.stderr)
        return 1
    nodes = _read_gff3_files(args.files or ["-"])
    missing = [n.seqid for n in nodes
               if getattr(n, "seqid", None) and n.seqid not in mapping]
    if missing:
        print(f"gt chseqids: error: chseqids[{missing[0]}] is nil "
              f"(defined in \"{args.mapping_file}\")", file=sys.stderr)
        return 1
    out = chseqids_stream(iter(nodes), mapping)
    if args.sort:
        out = sort_stream(out)
    text = GFF3Writer(retainids=True).render(list(out))
    if args.o:
        open(args.o, "w").write(text)
    else:
        sys.stdout.write(text)
    return 0


def cmd_dupfeat(args):
    from .anno.gff3 import GFF3Writer
    from .anno.node_stream import dupfeat_stream
    nodes = _read_gff3_files(args.files or ["-"])
    out = list(dupfeat_stream(iter(nodes), args.dest, args.source))
    sys.stdout.write(GFF3Writer().render(out))
    return 0


def cmd_mergefeat(args):
    from .anno.gff3 import GFF3Writer
    from .anno.node_stream import mergefeat_stream
    nodes = _read_gff3_files(args.files or ["-"])
    out = list(mergefeat_stream(iter(nodes)))
    sys.stdout.write(GFF3Writer().render(out))
    return 0


def cmd_id_to_md5(args):
    from .anno.gff3 import GFF3Writer
    from .anno.md5translate import SeqCollection, id_to_md5_nodes
    seqfiles = (args.seqfiles or []) + ([args.seqfile] if args.seqfile
                                        else [])
    if not seqfiles:
        print("gt id_to_md5: error: option \"-seqfile\" or \"-seqfiles\" "
              "is mandatory", file=sys.stderr)
        return 1
    seqcol = SeqCollection(seqfiles, matchdesc=args.matchdesc)
    nodes = _read_gff3_files(args.files or ["-"])
    try:
        out = list(id_to_md5_nodes(iter(nodes), seqcol,
                                   subtargetids=not args.no_subtargetids))
    except ValueError as exc:
        print(f"gt id_to_md5: error: {exc}", file=sys.stderr)
        return 1
    sys.stdout.write(GFF3Writer(retainids=True).render(out))
    return 0


def cmd_md5_to_id(args):
    from .anno.gff3 import GFF3Writer
    from .anno.md5translate import SeqCollection, md5_to_id_nodes
    seqfiles = (args.seqfiles or []) + ([args.seqfile] if args.seqfile
                                        else [])
    seqcol = SeqCollection(seqfiles, matchdesc=args.matchdesc) \
        if seqfiles else None
    nodes = _read_gff3_files(args.files or ["-"])
    try:
        out = list(md5_to_id_nodes(iter(nodes), seqcol))
    except ValueError as exc:
        print(f"gt md5_to_id: error: {exc}", file=sys.stderr)
        return 1
    sys.stdout.write(GFF3Writer(retainids=True).render(out))
    return 0


def _add_feat_streams(sub):
    p = sub.add_parser("chseqids",
                       help="change sequence ids by a mapping file")
    p.add_argument("mapping_file")
    p.add_argument("files", nargs="*")
    p.add_argument("-sort", action="store_true")
    p.add_argument("-v", action="store_true")
    p.add_argument("-o", default=None)
    p.set_defaults(func=cmd_chseqids)

    p = sub.add_parser("dupfeat",
                       help="duplicate internal feature nodes")
    p.add_argument("files", nargs="*")
    p.add_argument("-dest", required=True)
    p.add_argument("-source", required=True)
    p.set_defaults(func=cmd_dupfeat)

    p = sub.add_parser("mergefeat",
                       help="merge adjacent features of the same type")
    p.add_argument("files", nargs="*")
    p.set_defaults(func=cmd_mergefeat)

    for name, fn in (("id_to_md5", cmd_id_to_md5),
                     ("md5_to_id", cmd_md5_to_id)):
        p = sub.add_parser(
            name, help=f"{name.replace('_', ' ')} seqid translation")
        p.add_argument("files", nargs="*")
        p.add_argument("-seqfile", default=None)
        p.add_argument("-seqfiles", nargs="+", default=None)
        p.add_argument("-matchdesc", action="store_true")
        p.add_argument("-no_subtargetids", action="store_true")
        p.set_defaults(func=fn)


def cmd_scriptfilter(args):
    """ref: src/tools/gt_scriptfilter.c — validate filter scripts and
    show their metadata (output format of
    testdata/script_filter_output.txt)."""
    from .anno.script_filter import load_filter, show_metadata
    for pth in args.files:
        meta, _ = load_filter(pth)
        print(show_metadata(
            meta, scriptname=pth if args.scriptname != "false" else None,
            oneline=args.oneline))
    return 0


def _add_scriptfilter(sub):
    p = sub.add_parser("scriptfilter",
                       help="show metadata of select filter scripts")
    p.add_argument("files", nargs="+")
    p.add_argument("-scriptname", default="true")
    p.add_argument("-oneline", action="store_true")
    p.set_defaults(func=cmd_scriptfilter)


def cmd_speck(args):
    """ref: src/tools/gt_speck.c — check annotations against a spec
    (Python describe/it rules; see anno/speck.py)."""
    from .anno.gff3 import parse_gff3
    from .anno.speck import run_speck
    nodes = []
    for pth in args.files:
        nodes.extend(parse_gff3(open(pth).read()))
    res = run_speck(args.specfile, nodes)
    print(res.report())
    if res.failures and args.failhard:
        raise SystemExit(1)
    return 0


def _add_speck(sub):
    p = sub.add_parser("speck", help="check annotations against a spec")
    p.add_argument("-specfile", required=True)
    p.add_argument("-failhard", action="store_true")
    p.add_argument("files", nargs="+")
    p.set_defaults(func=cmd_speck)


def cmd_csa(args):
    from .anno.csa import csa
    from .anno.gff3 import GFF3Writer, parse_gff3
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    nodes = csa(parse_gff3(text), join_length=args.join_length)
    sys.stdout.write(GFF3Writer().render(nodes))
    return 0


def _add_csa(sub):
    p = sub.add_parser("csa", help="consensus spliced alignments")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-join-length", dest="join_length", type=int, default=300)
    p.set_defaults(func=cmd_csa)


def cmd_eval(args):
    """gt eval (ref: src/tools/gt_eval.c)."""
    from .anno.eval import evaluate
    from .anno.gff3 import parse_gff3
    reality = parse_gff3(open(args.reality).read()
                         if args.reality != "-" else sys.stdin.read())
    prediction = parse_gff3(open(args.prediction).read()
                            if args.prediction != "-" else sys.stdin.read())
    try:
        sys.stdout.write(evaluate(
            reality, prediction, nuceval=args.nuc == "yes",
            evalLTR=args.ltr, LTRdelta=args.ltrdelta,
            reality_name=args.reality, prediction_name=args.prediction))
    except ValueError as e:
        print(f"gt eval: error: {e}", file=sys.stderr)
        return 1
    return 0


def _add_eval(sub):
    p = sub.add_parser("eval", help="evaluate gene predictions against "
                       "reference annotation")
    p.add_argument("reality")
    p.add_argument("prediction")
    p.add_argument("-nuc", choices=["yes", "no"], default="yes")
    p.add_argument("-ltr", action="store_true")
    p.add_argument("-ltrdelta", type=int, default=20)
    p.set_defaults(func=cmd_eval)


def cmd_cds(args):
    """gt cds (ref: src/tools/gt_cds.c)."""
    from .anno.cds import RegionMapping, add_cds
    from .anno.gff3 import GFF3Writer, parse_gff3
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    try:
        mapping = RegionMapping.from_file(args.seqfile,
                                          matchdesc=args.matchdesc,
                                          usedesc=args.usedesc)
        nodes = add_cds(parse_gff3(text), mapping,
                        minorflen=args.minorflen,
                        start_codon=args.startcodon == "yes",
                        final_stop_codon=args.finalstopcodon == "yes",
                        filename=args.file)
    except ValueError as e:
        print(f"gt cds: error: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(GFF3Writer().render(nodes))
    return 0


def _add_cds(sub):
    p = sub.add_parser("cds", help="add CDS features to exon features")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-seqfile", required=True)
    p.add_argument("-matchdesc", action="store_true")
    p.add_argument("-usedesc", action="store_true")
    p.add_argument("-minorflen", type=int, default=64)
    p.add_argument("-startcodon", nargs="?", const="yes",
                   choices=["yes", "no"], default="no")
    p.add_argument("-finalstopcodon", nargs="?", const="yes",
                   choices=["yes", "no"], default="no")
    p.set_defaults(func=cmd_cds)


def _region_mapping(args):
    from .anno.cds import RegionMapping
    if getattr(args, "encseq", None):
        return RegionMapping.from_encseq(args.encseq,
                                         matchdesc=args.matchdesc,
                                         usedesc=args.usedesc)
    return RegionMapping.from_file(args.seqfile, matchdesc=args.matchdesc,
                                   usedesc=args.usedesc)


def cmd_splicesiteinfo(args):
    """gt splicesiteinfo (ref: src/tools/gt_splicesiteinfo.c)."""
    from .anno.gff3 import parse_gff3
    from .anno.splicesite import splice_site_info
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    try:
        report = splice_site_info(parse_gff3(text), _region_mapping(args),
                                  addintrons=args.addintrons)
    except ValueError as e:
        print(f"gt splicesiteinfo: error: {e}", file=sys.stderr)
        return 1
    if report is None:
        print("warning: input file(s) contained no intron, use option "
              "-addintrons to add introns automatically", file=sys.stderr)
    else:
        sys.stdout.write(report)
    return 0


def _add_splicesiteinfo(sub):
    p = sub.add_parser("splicesiteinfo",
                       help="show splice site info for introns")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-seqfile")
    p.add_argument("-encseq")
    p.add_argument("-matchdesc", action="store_true")
    p.add_argument("-usedesc", action="store_true")
    p.add_argument("-addintrons", action="store_true")
    p.set_defaults(func=cmd_splicesiteinfo)


def cmd_orffinder(args):
    """gt orffinder (ref: src/tools/gt_orffinder.c)."""
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.orffinder import find_orfs
    if args.min < 30:
        print("gt orffinder: error: argument to option \"-min\" must be "
              "an integer >= 30", file=sys.stderr)
        return 1
    if args.min > args.max:
        print("gt orffinder: error: Value for -min must be larger than "
              "-max", file=sys.stderr)
        return 1
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    try:
        nodes = find_orfs(parse_gff3(text), _region_mapping(args),
                          types=set(args.types) if args.types else None,
                          min_len=args.min, max_len=args.max,
                          all_orfs=args.allorfs)
    except ValueError as e:
        print(f"gt orffinder: error: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(GFF3Writer().render(nodes))
    return 0


def _add_orffinder(sub):
    p = sub.add_parser("orffinder", help="find ORFs in annotated features")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-types", nargs="+", default=None)
    p.add_argument("-allorfs", action="store_true")
    p.add_argument("-min", type=int, default=30)
    p.add_argument("-max", type=int, default=10000)
    p.add_argument("-seqfile")
    p.add_argument("-encseq")
    p.add_argument("-matchdesc", action="store_true")
    p.add_argument("-usedesc", action="store_true")
    p.set_defaults(func=cmd_orffinder)


def cmd_seqorder(args):
    """gt seqorder (ref: src/tools/gt_seqorder.c)."""
    from .core.encseq import Encseq
    from .utils.seqorder import render_fasta, seqorder_permutation
    modes = [m for m in ("sort", "revsort", "sorthdr", "sorthdrnum",
                         "sortlength", "invert", "shuffle")
             if getattr(args, m)]
    if len(modes) != 1:
        print("gt seqorder: error: exactly one of -invert|-sort|-revsort|"
              "-shuffle|-sorthdr|-sorthdrnum|-sortlength is mandatory",
              file=sys.stderr)
        return 1
    try:
        encseq = Encseq.load(args.index)
    except (FileNotFoundError, OSError):
        from .core.seqio import read_seqfile
        encseq = Encseq.from_seqset(read_seqfile(args.index))
    sys.stdout.write(render_fasta(encseq,
                                  seqorder_permutation(encseq, modes[0])))
    return 0


def _add_seqorder(sub):
    p = sub.add_parser("seqorder", help="output sequences of an encseq "
                       "in a given order")
    p.add_argument("index")
    for m in ("sort", "revsort", "sorthdr", "sorthdrnum", "sortlength",
              "invert", "shuffle"):
        p.add_argument(f"-{m}", action="store_true")
    p.set_defaults(func=cmd_seqorder)


def cmd_regioncov(args):
    """gt dev regioncov (ref: src/tools/gt_regioncov.c)."""
    from .anno.gff3 import parse_gff3
    from .anno.regioncov import region_coverage
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    sys.stdout.write(region_coverage(parse_gff3(text),
                                     args.maxfeaturedist))
    return 0


def _add_regioncov(sub):
    p = sub.add_parser("regioncov", help="show region parts covered by "
                       "features")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-maxfeaturedist", type=int, default=0)
    p.set_defaults(func=cmd_regioncov)


def cmd_magicmatch(args):
    """gt dev magicmatch (ref: src/tools/gt_magicmatch.c): md5
    fingerprint + description per sequence."""
    from .core.seqio import read_seqfiles
    from .utils import seqtools
    ss = read_seqfiles(args.f)
    for fp, desc in zip(seqtools.fingerprints(ss), ss.descs):
        print(f"{fp}\t{desc}")
    return 0


def _add_magicmatch(sub):
    p = sub.add_parser("magicmatch", help="match sequences by md5 "
                       "fingerprint")
    p.add_argument("-t", action="store_true")
    p.add_argument("-f", nargs="+", required=True)
    p.set_defaults(func=cmd_magicmatch)


def cmd_seqtransform(args):
    """gt seqtransform (ref: src/tools/gt_seqtransform.c)."""
    from .core.seqio import read_seqfiles
    ss = read_seqfiles(args.files)
    protein_chars = set(b"EFILPQZefilpqz*")
    for desc, seq in zip(ss.descs, ss.seqs):
        s = seq.tobytes().decode("latin-1")
        if args.addstopaminos and s and not s.endswith("*") and \
                (set(seq.tobytes()) & protein_chars):
            s += "*"
        print(">" + desc)
        if args.width:
            for i in range(0, len(s), args.width):
                print(s[i:i + args.width])
        else:
            print(s)
    return 0


def _add_seqtransform(sub):
    p = sub.add_parser("seqtransform", help="transform sequence files")
    p.add_argument("files", nargs="+")
    p.add_argument("-addstopaminos", action="store_true")
    p.add_argument("-width", type=int, default=0)
    p.set_defaults(func=cmd_seqtransform)


def cmd_fastq_sample(args):
    """gt fastq_sample (ref: src/tools/gt_fastq_sample.c): randomly
    sample fastq entries until the requested total length is reached."""
    import random
    from .core.seqio import read_seqfile
    if args.length <= 0:
        print("gt fastq_sample: error: length must be a positive integer",
              file=sys.stderr)
        return 1
    seqs, descs, quals = [], [], []
    for path in args.files:
        ss = read_seqfile(path)
        seqs += [s.tobytes().decode("latin-1") for s in ss.seqs]
        descs += ss.descs
        quals += ([q.tobytes().decode("latin-1") for q in ss.quals]
                  if ss.quals is not None else [""] * len(ss.seqs))
    if not seqs:
        print("gt fastq_sample: error: file does not contain any "
              "sequence data", file=sys.stderr)
        return 1
    total = sum(len(s) for s in seqs)
    if total < args.length:
        print(f"gt fastq_sample: error: requested length {args.length} "
              f"exceeds length of sequences ({total})", file=sys.stderr)
        return 1
    rng = random.Random()
    n = len(seqs)
    chosen = set()
    len_count = 0
    pos = rng.randrange(n) if n > 1 else 0
    while len_count < args.length:
        if rng.randrange(total) < args.length and pos not in chosen:
            chosen.add(pos)
            len_count += len(seqs[pos])
        pos = (pos + 1) % n
    print(f"total length {len_count} from {len(chosen)} entries")
    for i in sorted(chosen):
        print(f"@{descs[i]}")
        print(seqs[i])
        print("+")
        print(quals[i])
    return 0


def _add_fastq_sample(sub):
    p = sub.add_parser("fastq_sample", help="randomly sample fastq "
                       "entries up to a total length")
    p.add_argument("-length", type=int, required=True)
    p.add_argument("files", nargs="+")
    p.set_defaults(func=cmd_fastq_sample)


def cmd_seqids(args):
    """gt seqids (ref: src/tools/gt_seqids.c): sorted unique seqids."""
    from .anno.genome_node import FeatureNode, RegionNode
    from .anno.gff3 import parse_gff3
    try:
        text = open(args.file).read() if args.file != "-" \
            else sys.stdin.read()
    except FileNotFoundError as e:
        print(f"gt seqids: error: {e.strerror}: {args.file}",
              file=sys.stderr)
        return 1
    ids = set()
    for n in parse_gff3(text):
        if isinstance(n, (RegionNode, FeatureNode)):
            ids.add(n.seqid)
    for s in sorted(ids):
        print(s)
    return 0


def _add_seqids(sub):
    p = sub.add_parser("seqids", help="print sorted unique seqids of a "
                       "GFF3 file")
    p.add_argument("file", nargs="?", default="-")
    p.set_defaults(func=cmd_seqids)


def cmd_loccheck(args):
    """gt loccheck (ref: src/tools/gt_loccheck.c,
    extended/check_boundaries_visitor.c): warn about child ranges not
    contained in their parents."""
    from .anno.genome_node import FeatureNode
    from .anno.gff3 import parse_gff3
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    for top in parse_gff3(text):
        if not isinstance(top, FeatureNode):
            continue
        for parent in top.traverse():
            for child in parent.children:
                if child.range.start < parent.range.start or \
                        child.range.end > parent.range.end:
                    print(f"warning: {child.type} child range "
                          f"{child.range.start}-{child.range.end} "
                          f"(line {getattr(child, 'line_number', 0)}) not "
                          f"contained in {parent.type} parent range "
                          f"{parent.range.start}-{parent.range.end} "
                          f"(line {getattr(parent, 'line_number', 0)})",
                          file=sys.stderr)
    return 0


def _add_loccheck(sub):
    p = sub.add_parser("loccheck", help="check parent-child range "
                       "containment")
    p.add_argument("file", nargs="?", default="-")
    p.set_defaults(func=cmd_loccheck)


def cmd_gff3validator(args):
    """gt gff3validator (ref: src/tools/gt_gff3validator.c)."""
    from .anno.anno_db import TypeChecker
    from .anno.gff3 import GFF3Error, parse_gff3
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    try:
        nodes = parse_gff3(text)
    except GFF3Error as e:
        print(f"gt gff3validator: error: {e}", file=sys.stderr)
        return 1
    if args.typecheck:
        import os
        path = args.typecheck
        if not os.path.exists(path):
            for d in os.environ.get("GT_DATA_PATH", "").split(":"):
                cand = os.path.join(d, "obo_files", path + ".obo")
                if d and os.path.exists(cand):
                    path = cand
                    break
        try:
            checker = TypeChecker.from_obo(open(path).read())
        except OSError as e:
            print(f"gt gff3validator: error: cannot open {path}: {e}",
                  file=sys.stderr)
            return 1
        bad = checker.check_nodes(nodes)
        if bad:
            print(f"gt gff3validator: error: type \"{bad[0]}\" is not a "
                  f"valid feature type", file=sys.stderr)
            return 1
    print("input is valid GFF3")
    return 0


def _add_gff3validator(sub):
    p = sub.add_parser("gff3validator", help="validate GFF3 files")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-typecheck", default=None)
    p.set_defaults(func=cmd_gff3validator)


def cmd_inlineseq_split(args):
    """gt inlineseq_split (ref: src/tools/gt_inlineseq_split.c): write
    the annotation and the embedded FASTA to separate files."""
    from .anno.genome_node import SequenceNode
    from .anno.gff3 import GFF3Writer, parse_gff3
    try:
        text = open(args.file).read() if args.file != "-" \
            else sys.stdin.read()
    except FileNotFoundError as e:
        print(f"gt inlineseq_split: error: {e}", file=sys.stderr)
        return 1
    nodes = parse_gff3(text)
    seqs = [n for n in nodes if isinstance(n, SequenceNode)]
    rest = [n for n in nodes if not isinstance(n, SequenceNode)]
    try:
        if args.seqfile:
            with open(args.seqfile, "w") as f:
                for s in seqs:
                    f.write(">" + s.description + "\n")
                    for i in range(0, len(s.sequence), 80):
                        f.write(s.sequence[i:i + 80] + "\n")
        out = GFF3Writer().render(rest)
        if args.gff3file:
            with open(args.gff3file, "w") as f:
                f.write(out)
        else:
            sys.stdout.write(out)
    except OSError as e:
        print(f"gt inlineseq_split: error: {e}", file=sys.stderr)
        return 1
    return 0


def _add_inlineseq_split(sub):
    p = sub.add_parser("inlineseq_split", help="split GFF3 with inline "
                       "sequence into annotation + FASTA")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-seqfile", default=None)
    p.add_argument("-gff3file", default=None)
    p.set_defaults(func=cmd_inlineseq_split)


def cmd_inlineseq_add(args):
    """gt inlineseq_add (ref: src/tools/gt_inlineseq_add.c): append the
    seqids' sequences as an inline ##FASTA section."""
    from .anno.genome_node import FeatureNode, RegionNode, SequenceNode
    from .anno.gff3 import GFF3Writer, parse_gff3
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    nodes = parse_gff3(text)
    mapping = _region_mapping(args)
    seqids = []
    for n in nodes:
        if isinstance(n, (RegionNode, FeatureNode)) and \
                n.seqid not in seqids:
            seqids.append(n.seqid)
    try:
        for sid in seqids:
            idx = mapping._grep_desc(sid)
            nodes.append(SequenceNode(sid, mapping.seqs[idx]))
    except ValueError as e:
        print(f"gt inlineseq_add: error: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(GFF3Writer(fasta_width=10 ** 9).render(nodes))
    return 0


def _add_inlineseq_add(sub):
    p = sub.add_parser("inlineseq_add", help="add inline sequence to "
                       "GFF3 from a sequence file")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-seqfile", required=True)
    p.add_argument("-matchdesc", action="store_true")
    p.add_argument("-usedesc", action="store_true")
    p.set_defaults(func=cmd_inlineseq_add)


def cmd_hop(args):
    """gt hop (ref: src/tools/gt_hop.c)."""
    import os
    from .assembly.hop import (HopParams, alignments_from_bam,
                               alignments_from_sam, hop_correct,
                               hop_output)
    from .core.seqio import read_seqfile
    if args.aggressive:
        params = HopParams.aggressive()
    elif args.moderate:
        params = HopParams.moderate()
    elif args.conservative:
        params = HopParams.conservative()
    elif args.expert:
        params = HopParams(hmin=args.hmin, read_hmin=args.read_hmin,
                           qmax=args.qmax, altmax=args.altmax,
                           refmin=args.cogmin, mapqmin=args.mapqmin,
                           covmin=args.covmin, clenmax=args.clenmax,
                           allow_partial=args.allow_partial,
                           allow_multiple=args.allow_multiple)
    else:
        print("gt hop: error: Select correction mode: -aggressive, "
              "-moderate, -conservative or -expert", file=sys.stderr)
        return 1
    try:
        from .core.encseq import Encseq
        enc = Encseq.load(args.c)
        refs = []
        for i in range(enc.num_sequences):
            start = int(enc.seq_startpos(i))
            refs.append((enc.descs[i], enc.extract_decoded(
                start, start + int(enc.seq_length(i)) - 1).lower()))
    except (FileNotFoundError, OSError):
        ss = read_seqfile(args.c)
        refs = [(d, s.tobytes().decode("latin-1").lower())
                for d, s in zip(ss.descs, ss.seqs)]
    if args.sam or args.map.endswith(".sam"):
        alns = alignments_from_sam(open(args.map).read())
    else:
        alns = alignments_from_bam(args.map)
    result = hop_correct(refs, alns, params)
    for path in args.reads:
        ss = read_seqfile(path)
        out = hop_output(result, ss.descs, None)
        with open("hop_" + os.path.basename(path), "w") as f:
            f.write(out)
    return 0


def _add_hop(sub):
    p = sub.add_parser("hop", help="homopolymer error correction")
    p.add_argument("-c", required=True, help="cognate sequence "
                   "(encseq index or fasta)")
    p.add_argument("-map", required=True, help="SAM/BAM mapping")
    p.add_argument("-sam", action="store_true")
    p.add_argument("-reads", nargs="+", required=True)
    p.add_argument("-aggressive", action="store_true")
    p.add_argument("-moderate", action="store_true")
    p.add_argument("-conservative", action="store_true")
    p.add_argument("-expert", action="store_true")
    p.add_argument("-hmin", type=int, default=3)
    p.add_argument("-read-hmin", dest="read_hmin", type=int, default=2)
    p.add_argument("-qmax", type=int, default=120)
    p.add_argument("-altmax", type=float, default=0.8)
    p.add_argument("-cogmin", type=float, default=0.1)
    p.add_argument("-mapqmin", type=int, default=21)
    p.add_argument("-covmin", type=int, default=1)
    p.add_argument("-clenmax", type=int, default=None)
    p.add_argument("-allow-partial", dest="allow_partial",
                   action="store_true")
    p.add_argument("-allow-multiple", dest="allow_multiple",
                   action="store_true")
    p.set_defaults(func=cmd_hop)


def cmd_matchtool(args):
    """gt matchtool (ref: src/tools/gt_matchtool.c)."""
    from .core.seqio import _read_bytes
    from .match.matchtool import parse_blast_matches, parse_open_matches
    text = _read_bytes(args.matchfile).decode("latin-1")
    try:
        if args.type == "OPENMATCH":
            sys.stdout.write(parse_open_matches(text))
        elif args.type == "BLASTOUT":
            sys.stdout.write(parse_blast_matches(text))
        else:
            print(f"gt matchtool: error: type {args.type} requires an "
                  f"external matcher (not supported)", file=sys.stderr)
            return 1
    except ValueError as e:
        print(f"gt matchtool: error: {e}", file=sys.stderr)
        return 1
    return 0


def _add_matchtool(sub):
    p = sub.add_parser("matchtool", help="parse match files "
                       "(OPENMATCH/BLASTOUT)")
    p.add_argument("-matchfile", required=True)
    p.add_argument("-type", default="OPENMATCH",
                   choices=["OPENMATCH", "BLASTOUT", "BLASTALLP",
                            "BLASTALLN", "BLASTP", "BLASTN", "SW"])
    p.set_defaults(func=cmd_matchtool)


def cmd_mergeesa(args):
    """gt dev mergeesa (ref: src/tools/gt_mergeesa.c): merge several
    enhanced suffix arrays into one."""
    _force_platform(args)
    from .core.encseq import Encseq
    from .index.esa import merge_esas, write_esa
    encseqs = [Encseq.load(ii) for ii in args.ii]
    esa = merge_esas(encseqs, with_lcp=True)
    esa.encseq.save(args.indexname)
    write_esa(esa, args.indexname, suf=True, lcp=True)
    return 0


def _add_mergeesa(sub):
    p = sub.add_parser("mergeesa", help="merge enhanced suffix arrays")
    p.add_argument("-indexname", required=True)
    p.add_argument("-ii", nargs="+", required=True)
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_mergeesa)


def cmd_sain(args):
    """gt dev sain (ref: src/tools/gt_sain.c, src/match/sfx-sain.c:1577):
    SA-IS linear-time induced-sorting construction — the independent
    second ESA path; cross-checks the doubling engine when both run."""
    _force_platform(args)
    from .core.encseq import Encseq
    from .core.native import sais_native
    from .index.esa import build_esa, write_esa

    enc = Encseq.from_files(args.db) if args.db else Encseq.load(args.esa)
    keys = enc.suffix_keys()
    sa = sais_native(keys)
    if sa is None:
        print("sain: native library unavailable", file=sys.stderr)
        return 1
    if args.check:
        esa = build_esa(enc, with_lcp=False)
        if not (sa.astype(np.int64) == esa.suftab.astype(np.int64)).all():
            print("sain: MISMATCH vs doubling engine", file=sys.stderr)
            return 1
        print(f"# sain == doubling engine on {sa.size} suffixes",
              file=sys.stderr)
    if args.suf:
        indexname = args.indexname or (args.db[0] if args.db else args.esa)
        sa.astype(np.uint64).tofile(indexname + ".suf")
    return 0


def _add_sain(sub):
    p = sub.add_parser("sain", help="SA-IS induced-sorting suffix array")
    p.add_argument("-db", nargs="+", default=None)
    p.add_argument("-esa", default=None, help="existing encseq index")
    p.add_argument("-indexname", default=None)
    p.add_argument("-suf", action="store_true", help="write .suf")
    p.add_argument("-check", action="store_true",
                   help="cross-check against the doubling engine")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_sain)


def cmd_compreads(args):
    """gt compreads (ref: src/tools/gt_compreads.c + hcr.c): lossless
    FASTQ read compression.  The container is an own compact format
    (zlib-compressed records) rather than the reference's HCR
    bit-packing; round trips are exact."""
    import zlib
    from .core.seqio import read_seqfile
    if args.sub == "compress":
        blobs = []
        for path in args.files:
            ss = read_seqfile(path)
            for i, (d, s) in enumerate(zip(ss.descs, ss.seqs)):
                q = (ss.quals[i].tobytes().decode("latin-1")
                     if ss.quals is not None else "")
                blobs.append("\x00".join(
                    [d, s.tobytes().decode("latin-1"), q]))
        payload = zlib.compress("\x01".join(blobs).encode("latin-1"), 9)
        with open(args.name + ".hcr", "wb") as f:
            f.write(b"GTHCR1\n" + payload)
    elif args.sub == "decompress":
        data = open(args.file + ".hcr", "rb").read()
        assert data[:7] == b"GTHCR1\n", "not a compreads archive"
        text = zlib.decompress(data[7:]).decode("latin-1")
        name = args.name or args.file
        with open(name + ".fastq", "w") as f:
            for blob in text.split("\x01"):
                d, s, q = blob.split("\x00")
                f.write(f"@{d}\n{s}\n+\n{q}\n")
    return 0


def _add_compreads(sub):
    p = sub.add_parser("compreads", help="compress/decompress short "
                       "reads")
    sp = p.add_subparsers(dest="sub", required=True)
    pc = sp.add_parser("compress")
    pc.add_argument("-files", nargs="+", required=True)
    pc.add_argument("-name", required=True)
    pd = sp.add_parser("decompress")
    pd.add_argument("-file", required=True)
    pd.add_argument("-name", default=None)
    p.set_defaults(func=cmd_compreads)


def cmd_sambam(args):
    """gt dev sambam (ref: src/tools/gt_sambam.c): extract alignment
    fields from SAM/BAM."""
    from .assembly.hop import alignments_from_bam, alignments_from_sam
    from .core.seqio import _read_bytes
    if args.sam:
        text = _read_bytes(args.file).decode("latin-1")
        if args.idxfile is None and not text.startswith("@"):
            print("gt sambam: error: SAM file has no header and no "
                  "-idxfile given", file=sys.stderr)
            return 1
        alns = alignments_from_sam(text)
    else:
        alns = alignments_from_bam(args.file)
    for qname, flag, _rname, _pos, _mapq, cigar, seq, qual in alns:
        rname = _rname
        print(f"{qname}\t{flag}\t{rname}\t{cigar}\t{seq.lower()}\t{qual}")
    return 0


def _add_sambam(sub):
    p = sub.add_parser("sambam", help="extract alignments from SAM/BAM")
    p.add_argument("file")
    p.add_argument("-sam", action="store_true")
    p.add_argument("-idxfile", default=None)
    p.set_defaults(func=cmd_sambam)


def cmd_merge(args):
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.node_stream import merge_stream
    streams = [parse_gff3(open(pth).read()) for pth in args.files]
    sys.stdout.write(GFF3Writer().render(list(merge_stream(streams))))
    return 0


def _add_merge(sub):
    p = sub.add_parser("merge", help="merge sorted GFF3 files")
    p.add_argument("files", nargs="+")
    p.set_defaults(func=cmd_merge)


def cmd_uniq(args):
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.node_stream import sort_stream, uniq_stream
    nodes = []
    for pth in args.files:
        nodes.extend(parse_gff3(open(pth).read()))
    out = list(uniq_stream(sort_stream(nodes)))
    sys.stdout.write(GFF3Writer().render(out))
    return 0


def _add_uniq(sub):
    p = sub.add_parser("uniq", help="remove repeated feature trees")
    p.add_argument("files", nargs="+")
    p.set_defaults(func=cmd_uniq)


def cmd_interfeat(args):
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.node_stream import inter_feature_stream
    nodes = []
    for pth in args.files:
        nodes.extend(parse_gff3(open(pth).read()))
    out = list(inter_feature_stream(nodes, args.outside, args.inter))
    sys.stdout.write(GFF3Writer().render(out))
    return 0


def _add_interfeat(sub):
    p = sub.add_parser("interfeat", help="add inter features")
    p.add_argument("files", nargs="+")
    p.add_argument("-outside", default="exon")
    p.add_argument("-inter", default="intron")
    p.set_defaults(func=cmd_interfeat)


def cmd_extractfeat(args):
    from .anno.feature_index import extract_features
    from .anno.gff3 import parse_gff3
    from .core.seqio import read_seqfiles, write_fasta
    nodes = parse_gff3(open(args.gff3).read())
    ss = read_seqfiles(args.seqfile)
    seqs = {d.split()[0]: s.tobytes().decode("latin-1")
            for d, s in zip(ss.descs, ss.seqs)}
    out = extract_features(nodes, seqs, args.type, join=args.join,
                           translate=args.translate)
    write_fasta(sys.stdout, [x.tobytes().decode("latin-1")
                             for x in out.seqs], out.descs)
    return 0


def _add_extractfeat(sub):
    p = sub.add_parser("extractfeat", help="extract feature sequences")
    p.add_argument("gff3")
    p.add_argument("-seqfile", nargs="+", required=True)
    p.add_argument("-type", default="exon")
    p.add_argument("-join", action="store_true")
    p.add_argument("-translate", action="store_true")
    p.set_defaults(func=cmd_extractfeat)


# ---------------------------------------------------------------------------
# sketch / chain2dim / linspace_align / wtree
# ---------------------------------------------------------------------------

def cmd_sketch(args):
    from .anno.gff3 import parse_gff3
    from .anno.sketch import sketch
    nodes = []
    for pth in args.files:
        nodes.extend(parse_gff3(open(pth).read()))
    style = None
    if args.style:
        from .anno.style import load_style
        style = load_style(args.style)
    fmt = args.format
    if fmt == "auto":
        ext = args.out.rsplit(".", 1)[-1].lower()
        fmt = ext if ext in ("svg", "png", "pdf") else "svg"
    ii = None
    if args.showrecmaps:
        from .anno.sketch import ImageInfo
        ii = ImageInfo()
    out = sketch(nodes, seqid=args.seqid, width=args.width, fmt=fmt,
                 style=style, image_info=ii)
    mode = "w" if isinstance(out, str) else "wb"
    with open(args.out, mode) as f:
        f.write(out)
    if ii is not None:
        # ref: gt_sketch.c:449-458 — "<coords>, <type>" per rec map
        for rm in ii.rec_maps:
            print(f"{rm.html_imagemap_coords()}, {rm.node.type}")
    return 0


def _add_sketch(sub):
    p = sub.add_parser("sketch",
                       help="draw annotation diagrams (SVG/PNG/PDF)")
    p.add_argument("out")
    p.add_argument("files", nargs="+")
    p.add_argument("-seqid", default=None)
    p.add_argument("-width", type=int, default=800)
    p.add_argument("-format", default="auto",
                   choices=["auto", "svg", "png", "pdf"])
    p.add_argument("-style", default=None,
                   help="annotation style file (reference .style "
                        "table format)")
    p.add_argument("-showrecmaps", action="store_true",
                   help="show recmaps after image creation")
    p.set_defaults(func=cmd_sketch)


def cmd_sketch_page(args):
    """gt sketch_page (ref: src/tools/gt_sketch_page.c): multi-page
    PDF over the whole annotated range."""
    from .anno.gff3 import parse_gff3
    from .anno.sketch import sketch_pages
    nodes = []
    for pth in args.files:
        nodes.extend(parse_gff3(open(pth).read()))
    style = None
    if args.style:
        from .anno.style import load_style
        style = load_style(args.style)
    pdf = sketch_pages(nodes, seqid=args.seqid, width=args.width,
                       page_span=args.linewidth, style=style)
    with open(args.out, "wb") as f:
        f.write(pdf)
    return 0


def _add_sketch_page(sub):
    p = sub.add_parser("sketch_page",
                       help="draw a multi-page PDF of annotations")
    p.add_argument("out")
    p.add_argument("files", nargs="+")
    p.add_argument("-seqid", default=None)
    p.add_argument("-width", type=int, default=800)
    p.add_argument("-linewidth", type=int, default=50000,
                   help="base pairs per page")
    p.add_argument("-style", default=None)
    p.set_defaults(func=cmd_sketch_page)


def cmd_chain2dim(args):
    from .match.chain2dim import Fragment, chain_fragments
    frags = []
    for line in open(args.m):
        parts = line.split()
        if len(parts) >= 4 and not line.startswith("#"):
            s1, e1, s2, e2 = (int(x) for x in parts[:4])
            w = int(parts[4]) if len(parts) > 4 else (e1 - s1 + 1)
            frags.append(Fragment(s1, e1, s2, e2, w))
    score, chain = chain_fragments(frags, local=args.local,
                                   gapcost_factor=args.wf)
    print(f"# chain score {score}")
    for i in chain:
        f = frags[i]
        print(f"{f.start1} {f.end1} {f.start2} {f.end2}")
    return 0


def _add_chain2dim(sub):
    p = sub.add_parser("chain2dim", help="chain colinear match fragments")
    p.add_argument("-m", required=True, help="match file")
    p.add_argument("-local", action="store_true")
    p.add_argument("-wf", type=float, default=0.0, help="gap cost factor")
    p.set_defaults(func=cmd_chain2dim)


def cmd_linspace_align(args):
    from .core.alphabet import dna_alphabet
    from .match.alignment import (global_alignment,
                                  global_alignment_affine,
                                  global_alignment_linear_space,
                                  local_alignment)
    a = dna_alphabet()
    u = a.encode(args.ss[0].encode())
    v = a.encode(args.ss[1].encode())
    if args.local:
        r = local_alignment(u, v)
    elif args.affine:
        r = global_alignment_affine(u, v)
    else:
        r = global_alignment_linear_space(u, v)
    print(f"# score {r.score}")
    print(r.cigar(distinguish=True, u=u, v=v))
    return 0


def _add_linspace_align(sub):
    p = sub.add_parser("linspace_align", help="pairwise alignment")
    p.add_argument("-ss", nargs=2, required=True, metavar=("SEQ1", "SEQ2"))
    p.add_argument("-local", action="store_true")
    p.add_argument("-affine", action="store_true")
    p.set_defaults(func=cmd_linspace_align)


def cmd_wtree(args):
    from .core.encseq import Encseq
    from .utils.structures import WaveletTree
    enc = Encseq.load(args.indexname)
    wt = WaveletTree(enc.codes.astype(np.int64), 256)
    if args.rank is not None:
        sym, pos = args.rank
        print(wt.rank(int(sym), int(pos)))
    elif args.select is not None:
        sym, k = args.select
        print(wt.select(int(sym), int(k)))
    else:
        print(f"sequence length: {enc.total_length}")
    return 0


def _add_wtree(sub):
    p = sub.add_parser("wtree", help="wavelet-tree rank/select over encseq")
    p.add_argument("indexname")
    p.add_argument("-rank", nargs=2, default=None, metavar=("SYM", "POS"))
    p.add_argument("-select", nargs=2, default=None, metavar=("SYM", "K"))
    p.set_defaults(func=cmd_wtree)


# ---------------------------------------------------------------------------
# main dispatch
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# long-tail utility tools (ref registry: src/gtt.c:186-265)
# ---------------------------------------------------------------------------

def cmd_splitfasta(args):
    """ref: src/tools/gt_splitfasta.c — split a FASTA file at sequence
    boundaries into <file>.<N> pieces of ~targetsize, or one file per
    description with -splitdesc."""
    import gzip
    import os
    fn = args.file
    gz = fn.endswith(".gz")
    op = (lambda p, m: gzip.open(p, m)) if gz else open
    raw = op(fn, "rb").read()
    if not raw:
        raise SystemExit(f'gt-tpu splitfasta: error: file "{fn}" is empty')
    if not raw.startswith(b">"):
        raise SystemExit("gt-tpu splitfasta: error: file is not in "
                         "FASTA format")
    recs = []
    start = 0
    for i in range(1, len(raw)):
        if raw[i:i + 1] == b">" and raw[i - 1:i] == b"\n":
            recs.append(raw[start:i])
            start = i
    recs.append(raw[start:])

    def xopen(path):
        if os.path.exists(path) and not args.force:
            raise SystemExit(f'gt-tpu splitfasta: error: file "{path}" '
                             f'exists already')
        return op(path, "wb")

    if args.splitdesc:
        suffix = os.path.splitext(fn[:-3] if gz else fn)[1]
        for rec in recs:
            desc = rec.split(b"\n", 1)[0][1:].split()[0].decode()
            out = xopen(os.path.join(args.splitdesc, desc + suffix))
            out.write(rec)
            out.close()
        return 0
    if args.numfiles:
        maxsize = max(1, len(raw) // args.numfiles)
    else:
        maxsize = args.targetsize << 20
    base = fn[:-3] if gz else fn
    ext = ".gz" if gz else ""
    filenum, count = 0, 0
    cur = None
    for rec in recs:
        if cur is None or (count + len(rec) > maxsize and count > 0
                           and filenum < (args.numfiles or 1 << 30)):
            if cur:
                cur.close()
            filenum += 1
            cur = xopen(f"{base}.{filenum}{ext}")
            count = 0
        cur.write(rec)
        count += len(rec)
    if cur:
        cur.close()
    return 0


def _add_splitfasta(sub):
    p = sub.add_parser("splitfasta", help="split FASTA file")
    p.add_argument("file")
    p.add_argument("-numfiles", type=int, default=0)
    p.add_argument("-targetsize", type=int, default=50, help="in MB")
    p.add_argument("-splitdesc", default=None,
                   help="directory for per-description files")
    p.add_argument("-width", type=int, default=0)
    p.add_argument("-force", action="store_true")
    p.set_defaults(func=cmd_splitfasta)


def cmd_clean(args):
    """ref: src/tools/gt_clean.c — remove gt-generated index files in
    the current directory."""
    import glob
    import os
    for suf in (".esq", ".ssp", ".des", ".sds", ".ois", ".md5"):
        for f in glob.glob("*" + suf):
            os.remove(f)
    return 0


def _add_clean(sub):
    p = sub.add_parser("clean", help="remove gt-created files in cwd")
    p.set_defaults(func=cmd_clean)


def cmd_mmapandread(args):
    """ref: src/tools/gt_mmapandread.c."""
    import mmap
    import os
    for fn in args.files:
        size = os.path.getsize(fn)
        if size == 0:
            print(f'file "{fn}" is empty')
            continue
        with open(fn, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
            byte = 0
            for off in range(0, size, 1 << 20):
                byte ^= mm[off]
            mm.close()
    return 0


def _add_mmapandread(sub):
    p = sub.add_parser("mmapandread",
                       help="map files into memory and read them")
    p.add_argument("files", nargs="+")
    p.set_defaults(func=cmd_mmapandread)


def cmd_template(args):
    """ref: src/tools/gt_template.c (the developer demo tool)."""
    if args.bool:
        print("argc=?, parsed_args=?")
    print(f"argv[0]={args.file or 'template'}")
    return 0


def _add_template(sub):
    p = sub.add_parser("template", help="development template tool")
    p.add_argument("file", nargs="?", default=None)
    p.add_argument("-bool", action="store_true")
    p.set_defaults(func=cmd_template)


def cmd_dot(args):
    """ref: src/tools/gt_dot.c — print feature graphs in dot format."""
    from .anno.gff3 import parse_gff3
    print("digraph {")
    print("  ratio=compress;")
    print("  node [shape=box];")
    n = 0
    for pth in args.files:
        for node in parse_gff3(open(pth).read()):
            if not hasattr(node, "children"):
                continue
            stack = [(node, None)]
            while stack:
                cur, parent = stack.pop()
                nid = f"n{n}"
                n += 1
                label = f"{cur.type} {cur.range.start}-{cur.range.end}" \
                    if hasattr(cur, "type") else str(cur)
                print(f'  {nid} [label="{label}"];')
                if parent is not None:
                    print(f"  {parent} -> {nid};")
                for ch in getattr(cur, "children", []) or []:
                    stack.append((ch, nid))
    print("}")
    return 0


def _add_dot(sub):
    p = sub.add_parser("dot", help="print feature graphs in dot format")
    p.add_argument("files", nargs="+")
    p.set_defaults(func=cmd_dot)


def cmd_convertseq(args):
    """ref: src/tools/gt_convertseq.c — read sequence files, write
    FASTA (optionally reverse-complemented)."""
    from .core.seqio import read_seqfile
    import numpy as np
    comp = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
    for fn in args.files:
        ss = read_seqfile(fn)
        if args.showfilelengthvalues:
            import os
            print(f"# file \"{fn}\" {os.path.getsize(fn)} bytes")
        for desc, seq in zip(ss.descs, ss.seqs):
            if args.noseq:
                continue
            s = bytes(seq)
            if args.r:
                s = s[::-1].translate(comp)
            print(f">{desc}")
            w = args.fastawidth or 60
            for i in range(0, len(s), w):
                print(s[i:i + w].decode("latin-1"))
    return 0


def _add_convertseq(sub):
    p = sub.add_parser("convertseq", help="parse and convert sequences")
    p.add_argument("files", nargs="+")
    p.add_argument("-r", action="store_true", help="reverse complement")
    p.add_argument("-noseq", action="store_true")
    p.add_argument("-showfilelengthvalues", action="store_true")
    p.add_argument("-fastawidth", type=int, default=0)
    p.add_argument("-v", action="store_true")
    p.set_defaults(func=cmd_convertseq)


def cmd_seq(args):
    """ref: src/tools/gt_seq.c — bioseq access tool."""
    from .core.seqio import read_seqfile
    for fn in args.files:
        ss = read_seqfile(fn)
        if args.stat:
            total = sum(len(s) for s in ss.seqs)
            print(f"# number of sequences: {len(ss.seqs)}")
            print(f"# total length: {total}")
            if ss.seqs:
                print(f"# mean size: {total / len(ss.seqs):.2f}")
        elif args.showseqnum is not None:
            i = args.showseqnum - 1
            if not 0 <= i < len(ss.seqs):
                raise SystemExit(
                    f"gt-tpu seq: error: sequence number {args.showseqnum} "
                    f"out of range")
            print(f">{ss.descs[i]}")
            s = bytes(ss.seqs[i]).decode("latin-1")
            for j in range(0, len(s), args.width or 60):
                print(s[j:j + (args.width or 60)])
        else:
            for desc, seq in zip(ss.descs, ss.seqs):
                if args.showfasta:
                    print(f">{desc}")
                    s = bytes(seq).decode("latin-1")
                    for j in range(0, len(s), args.width or 60):
                        print(s[j:j + (args.width or 60)])
                else:
                    print(f"{desc}: {len(seq)}")
    return 0


def _add_seq(sub):
    p = sub.add_parser("seq", help="bioseq access tool")
    p.add_argument("files", nargs="+")
    p.add_argument("-showfasta", action="store_true")
    p.add_argument("-showseqnum", type=int, default=None)
    p.add_argument("-stat", action="store_true")
    p.add_argument("-width", type=int, default=0)
    p.set_defaults(func=cmd_seq)


def cmd_shulengthdist(args):
    """ref: src/tools/gt_shulen.c — without -q: the pairwise
    sum-of-shulen matrix over the index's units (print format of
    esa-shulen.c:341 shulengthdist_print); with -q: one total of the
    query files against the index (gt_esa2shulengthqueryfiles)."""
    _force_platform(args)
    from .core.encseq import Encseq
    from .index.esa import build_esa
    from .match.querysearch import SuffixArraySearcher
    enc = Encseq.load(args.ii)
    if args.q:
        from .core.seqio import read_seqfiles
        searcher = SuffixArraySearcher(build_esa(enc, with_lcp=False))
        total = 0
        qs = read_seqfiles(args.q)
        for seq in qs.seqs:
            qc = enc.alphabet.encode(seq)
            for qpos in range(qc.size):
                if qc[qpos] >= 4:
                    continue
                total += searcher.longest_prefix_match(qc[qpos:]) + 1
        print(total)
        return 0
    # units: one per sequence (the multi-file index maps each input to
    # one unit; our encseq keeps per-sequence units)
    units = [enc.codes[int(enc.seq_startpos(i)):
                       int(enc.seq_endpos(i)) + 1]
             for i in range(enc.num_sequences)]
    n = len(units)
    searchers = []
    for u in units:
        e = Encseq(u.copy(), np.zeros(0, np.int64), [""], enc.alphabet)
        searchers.append(SuffixArraySearcher(build_esa(e, with_lcp=False)))
    dist = np.zeros((n, n), np.int64)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            total = 0
            u = units[i]
            for qpos in range(u.size):
                if u[qpos] >= 4:
                    continue
                total += searchers[j].longest_prefix_match(u[qpos:]) + 1
            dist[i, j] = total
    print("# sum of shulen")
    print(n)
    for idx2 in range(n):
        row = "".join(
            (f"{dist[idx1, idx2]}\t" if idx1 != idx2 else "0.000000\t")
            for idx1 in range(n))
        print(f"{idx2}\t{row}")
    return 0


def _add_shulengthdist(sub):
    p = sub.add_parser("shulengthdist",
                       help="pairwise sum of shortest unique substrings")
    p.add_argument("-ii", required=True)
    p.add_argument("-q", nargs="+", default=None)
    p.add_argument("-scan", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_shulengthdist)


def cmd_encseq2spm(args):
    """ref: src/tools/gt_encseq2spm.c — suffix-prefix matches of an
    encoded read set (the firstcodes engine as a standalone tool)."""
    _force_platform(args)
    from .assembly.readjoiner import ReadSet, find_spms
    from .core.encseq import Encseq
    enc = Encseq.load(args.ii)
    reads = [enc.codes[int(enc.seq_startpos(i)):int(enc.seq_endpos(i)) + 1]
             for i in range(enc.num_sequences)]
    spm = find_spms(ReadSet(reads), args.l, singlestrand=args.singlestrand)
    if args.spm == "show":
        for line in spm.lines():
            print(line)
    else:
        print(f"number of suffix-prefix matches: {spm.length.size}")
    return 0


def _add_encseq2spm(sub):
    p = sub.add_parser("encseq2spm", help="compute suffix-prefix matches")
    p.add_argument("-ii", required=True)
    p.add_argument("-l", type=int, required=True, help="minimum SPM length")
    p.add_argument("-spm", default="count", choices=["count", "show"])
    p.add_argument("-singlestrand", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_encseq2spm)


def cmd_prebwt(args):
    """ref: src/tools/gt_prebwt.c — precompute BWT prefix-code bucket
    boundaries of a packed index (.pbt)."""
    _force_platform(args)
    import itertools
    import json as _json
    from .core.encseq import Encseq
    from .index.fmindex import fmindex_from_codes
    enc = Encseq.load(args.pck)
    fm = fmindex_from_codes(enc.codes[::-1].copy())
    bounds = {}
    for depth in range(1, args.maxdepth + 1):
        for code in itertools.product(range(4), repeat=depth):
            import numpy as np
            lo, hi = fm.backward_search(np.asarray(code, np.uint8))
            if hi > lo:
                bounds["".join(map(str, code))] = [int(lo), int(hi)]
    with open(args.pck + ".pbt", "w") as f:
        _json.dump({"maxdepth": args.maxdepth, "bounds": bounds}, f)
    return 0


def _add_prebwt(sub):
    p = sub.add_parser("prebwt", help="precompute BWT bucket boundaries")
    p.add_argument("-pck", required=True)
    p.add_argument("-maxdepth", type=int, default=4)
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_prebwt)


def cmd_mkfmindex(args):
    """ref: src/tools/gt_mkfmindex.c (legacy fmindex builder) — by
    design one FM implementation backs both mkfmindex and packedindex."""
    _force_platform(args)
    from .core.encseq import Encseq
    from .index.fmindex import build_fmindex
    enc = Encseq.load(args.ii[0])
    fm = build_fmindex(enc)
    fm.save(args.fmout)
    enc.save(args.fmout)
    return 0


def _add_mkfmindex(sub):
    p = sub.add_parser("mkfmindex", help="construct an FM index")
    p.add_argument("-ii", nargs="+", required=True)
    p.add_argument("-fmout", required=True)
    p.add_argument("-noindexpos", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_mkfmindex)


def cmd_mkfeatureindex(args):
    """ref: src/tools/gt_mkfeatureindex.c — persist GFF3 features into
    an SQLite-backed feature index."""
    from .anno.anno_db import AnnoDB
    from .anno.gff3 import parse_gff3
    db = AnnoDB(args.filename)
    for pth in args.input:
        db.add_gff3(parse_gff3(open(pth).read()))
    db.conn.commit()
    return 0


def _add_mkfeatureindex(sub):
    p = sub.add_parser("mkfeatureindex",
                       help="create persistent feature index")
    p.add_argument("-filename", required=True)
    p.add_argument("input", nargs="+")
    p.set_defaults(func=cmd_mkfeatureindex)


def cmd_featureindex(args):
    """ref: src/tools/gt_featureindex.c — query a persistent feature
    index, GFF3 output."""
    from .anno.anno_db import AnnoDB
    from .anno.gff3 import GFF3Writer
    db = AnnoDB(args.filename)
    seqid = args.seqid or (db.seqids()[0] if db.seqids() else None)
    if seqid is None:
        return 0
    if args.range:
        lo, hi = (int(x) for x in args.range)
    else:
        lo, hi = 0, 1 << 60
    feats = db.features_for_range(seqid, lo, hi)
    sys.stdout.write(GFF3Writer(retainids=True).render(list(feats)))
    return 0


def _add_featureindex(sub):
    p = sub.add_parser("featureindex",
                       help="retrieve features from a feature index")
    p.add_argument("-filename", required=True)
    p.add_argument("-seqid", default=None)
    p.add_argument("-range", nargs=2, default=None)
    p.set_defaults(func=cmd_featureindex)


def cmd_snpper(args):
    """gt snpper (ref: src/tools/gt_snpper.c)."""
    from .anno.cds import RegionMapping
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.node_stream import sort_stream
    from .anno.snpper import snp_annotator_stream
    from .core.trans_table import TransTable

    try:
        tt = TransTable(args.trans_table)
    except ValueError as e:
        print(f"gt snpper: error: {e}", file=sys.stderr)
        return 1
    gff_nodes = list(sort_stream(parse_gff3(open(args.gff3_file).read())))
    gvf_text = open(args.gvf_file).read() if args.gvf_file != "-" \
        else sys.stdin.read()
    gvf_nodes = list(sort_stream(parse_gff3(gvf_text)))
    try:
        if args.encseq:
            rmap = RegionMapping.from_encseq(args.encseq,
                                             matchdesc=args.matchdesc,
                                             usedesc=args.usedesc)
        elif args.seqfile:
            rmap = RegionMapping.from_file(args.seqfile,
                                           matchdesc=args.matchdesc,
                                           usedesc=args.usedesc)
        else:
            print("gt snpper: error: option \"-seqfile\" or \"-encseq\" "
                  "is mandatory", file=sys.stderr)
            return 1
        out = list(snp_annotator_stream(gvf_nodes, gff_nodes, rmap, tt))
    except ValueError as e:
        print(f"gt snpper: error: {e}", file=sys.stderr)
        return 1
    text = GFF3Writer().render(out)
    if args.o:
        with open(args.o, "w") as fp:
            fp.write(text)
    else:
        sys.stdout.write(text)
    return 0


def _add_snpper(sub):
    p = sub.add_parser(
        "snpper", help="annotate SNPs according to their effect on the "
        "genome as given by a genomic annotation")
    p.add_argument("gff3_file")
    p.add_argument("gvf_file", nargs="?", default="-")
    p.add_argument("-trans_table", type=int, default=1,
                   help="NCBI translation table number")
    p.add_argument("-seqfile", default=None)
    p.add_argument("-encseq", default=None)
    p.add_argument("-matchdesc", action="store_true")
    p.add_argument("-usedesc", action="store_true")
    p.add_argument("-o", default=None)
    p.set_defaults(func=cmd_snpper)


def cmd_ltrclustering(args):
    """gt ltrclustering (ref: src/ltr/gt_ltrclustering.c)."""
    _force_platform(args)
    from .anno.gff3 import gff3_to_string, parse_gff3
    from .core.encseq import Encseq
    from .ltr.ltrclustering import ltrclustering
    enc = Encseq.load(args.indexname)
    nodes = []
    for p in args.files:
        nodes.extend(parse_gff3(open(p).read()))
    ltrclustering(enc, nodes, args.psmall, args.plarge)
    out = gff3_to_string(nodes)
    if args.o:
        open(args.o, "w").write(out)
    else:
        sys.stdout.write(out)
    return 0


def _add_ltrclustering(sub):
    p = sub.add_parser("ltrclustering",
                       help="cluster features of LTRs")
    p.add_argument("-psmall", type=int, required=True,
                   help="match must cover this percent of the smaller "
                        "sequence")
    p.add_argument("-plarge", type=int, required=True,
                   help="match must cover this percent of the larger "
                        "sequence")
    p.add_argument("-o", default=None)
    p.add_argument("indexname")
    p.add_argument("files", nargs="+")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_ltrclustering)


def cmd_tirvish(args):
    """gt tirvish (ref: src/tools/gt_tir.c over
    src/extended/tir_stream.c)."""
    _force_platform(args)
    from .core.encseq import Encseq
    from .ltr.tirvish import TIRvishParams, gff3_nodes, tirvish
    enc = Encseq.load(args.index)
    p = TIRvishParams(
        min_seed_length=args.seed, min_tir_length=args.mintirlen,
        max_tir_length=args.maxtirlen, min_tir_distance=args.mintirdist,
        max_tir_distance=args.maxtirdist, mat=args.mat, mis=args.mis,
        ins=args.ins, dele=getattr(args, "del"),
        xdrop_belowscore=args.xdrop,
        similarity_threshold=args.similar,
        min_tsd_length=args.mintsd, max_tsd_length=args.maxtsd,
        vicinity=args.vic, overlaps=args.overlaps)
    pairs = tirvish(enc, p)
    from .anno.gff3 import gff3_to_string
    nodes = gff3_nodes(pairs, enc)
    if args.refseqs:
        from .ltr.tirvish import refseq_match_annotate
        refseq_match_annotate(nodes, enc, [args.refseqs],
                              min_ali_len_perc=args.min_ali_len_perc,
                              flcands=args.flcands, source="TIRvish")
    sys.stdout.write(gff3_to_string(nodes))
    return 0


def _add_tirvish(sub):
    p = sub.add_parser("tirvish",
                       help="identify Terminal Inverted Repeat (TIR) "
                            "elements")
    p.add_argument("-index", required=True)
    p.add_argument("-seed", type=int, default=20)
    p.add_argument("-mintirlen", type=int, default=100)
    p.add_argument("-maxtirlen", type=int, default=1000)
    p.add_argument("-mintirdist", type=int, default=500)
    p.add_argument("-maxtirdist", type=int, default=10000)
    p.add_argument("-mat", type=int, default=2)
    p.add_argument("-mis", type=int, default=-2)
    p.add_argument("-ins", type=int, default=-3)
    p.add_argument("-del", type=int, default=-3)
    p.add_argument("-xdrop", type=int, default=5)
    p.add_argument("-similar", type=float, default=85.0)
    p.add_argument("-mintsd", type=int, default=2)
    p.add_argument("-maxtsd", type=int, default=11)
    p.add_argument("-vic", type=int, default=60)
    p.add_argument("-overlaps", default="best",
                   choices=["best", "longest", "no", "all"])
    p.add_argument("-refseqs", default=None,
                   help="annotate best reference-sequence matches")
    p.add_argument("-min_ali_len_perc", type=float, default=10.0)
    p.add_argument("-flcands", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_tirvish)


def cmd_congruence(args):
    """gt congruence spacedseed (ref: src/tools/gt_congruence.c over
    src/match/cgr_spacedseed.c): match the fixed spaced seed."""
    _force_platform(args)
    from .core.encseq import Encseq
    from .index.esa import load_esa
    from .match.congruence import match_spacedseed
    if args.subtool != "spacedseed":
        print(f"gt congruence: unknown subtool {args.subtool}",
              file=sys.stderr)
        return 1
    idx = args.esa or args.pck
    enc = Encseq.load(idx)
    rank = None
    try:
        esa = load_esa(idx, encseq=enc, need_lcp=False)
        rank = np.zeros(esa.suftab.size, np.int64)
        rank[esa.suftab.astype(np.int64)] = np.arange(esa.suftab.size)
    except FileNotFoundError:
        pass
    q = Encseq.from_files(args.q)
    for dblen, dbstart in match_spacedseed(enc, q, rank=rank):
        print(f"{dblen}\t{dbstart}")
    return 0


def _add_congruence(sub):
    p = sub.add_parser("congruence", help="match spaced seeds")
    p.add_argument("subtool", choices=["spacedseed"])
    p.add_argument("-esa", default=None, help="enhanced suffix array")
    p.add_argument("-pck", default=None, help="packed index")
    p.add_argument("-q", nargs="+", required=True, help="query files")
    p.add_argument("-cmp", action="store_true")   # accepted, no-op
    p.add_argument("-v", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.set_defaults(func=cmd_congruence)


# ---------------------------------------------------------------------------
# dev toolbox (ref: src/tools/gt_dev.c:60-91)
# ---------------------------------------------------------------------------

def cmd_dev_sfxmap(args):
    """gt dev sfxmap (ref: src/tools/gt_sfxmap.c): verify an on-disk
    index — suftab order, lcp recompute, bcktab consistency, encseq
    readback; the reference's own cross-checker (checksfx in
    testsuite/gt_suffixerator_include.rb:17 runs it on every index)."""
    _force_platform(args)
    from .core.encseq import Encseq
    from .index.esa import load_esa
    from .index.suffix import check_suftab_order, kasai_lcp
    if args.esa and not args.indexname:
        args.indexname = args.esa          # gt-compatible -esa alias
    enc = Encseq.load(args.indexname)
    need_itv = args.enumlcpitvs or args.enumlcpitvtree or \
        args.enumlcpitvtreeBU or args.spmitv
    esa = load_esa(args.indexname, encseq=enc,
                   need_lcp=args.lcp or need_itv)
    if need_itv:
        from .match.esa_bottomup import (LcpIntervalPrinter,
                                         LcpTreePrinter, SpmitvsVisitor,
                                         esa_bottomup)
        sa = esa.suftab.astype(np.int64)
        lcp = np.asarray(esa.lcptab, np.int64)
        nonspecials = enc.total_length - enc.special_ranges.total
        if args.enumlcpitvs:
            esa_bottomup(sa, lcp, nonspecials,
                         LcpIntervalPrinter(sys.stdout))
            # the reference's interval enumerator closes with the root
            # interval over the whole table (esa-lcpintervals.c)
            print(f"N 0 0 {enc.total_length}")
        if args.enumlcpitvtree or args.enumlcpitvtreeBU:
            esa_bottomup(sa, lcp, nonspecials,
                         LcpTreePrinter(sys.stdout))
        if args.spmitv:
            v = SpmitvsVisitor(enc)
            esa_bottomup(sa, lcp, nonspecials, v)
            v.print_results(nonspecials, sys.stdout)
        return 0
    keys = enc.suffix_keys()
    bad = 0
    if args.suf:
        sa = esa.suftab.astype(np.int64)
        if sorted(sa.tolist()) != list(range(keys.size)):
            print("sfxmap: suftab is not a permutation",
                  file=sys.stderr)
            bad = 1
        elif not check_suftab_order(keys, sa):
            print("sfxmap: suftab order violated", file=sys.stderr)
            bad = 1
        else:
            print(f"# suftab order verified ({sa.size} suffixes)",
                  file=sys.stderr)
    if args.lcp and esa.lcptab is not None and not bad:
        from .core.native import kasai_lcp_native
        ref = kasai_lcp_native(keys, esa.suftab)
        if ref is None:
            ref = kasai_lcp(keys, esa.suftab.astype(np.int64))
        if not np.array_equal(np.asarray(ref, np.int64),
                              np.asarray(esa.lcptab, np.int64)):
            print("sfxmap: lcp table mismatch vs Kasai recompute",
                  file=sys.stderr)
            bad = 1
        else:
            print("# lcp table verified (Kasai recompute)",
                  file=sys.stderr)
    if args.tis:
        rt = Encseq.load(args.indexname)
        if not np.array_equal(rt.codes, enc.codes):
            print("sfxmap: encseq readback mismatch", file=sys.stderr)
            bad = 1
        else:
            print("# encseq readback verified", file=sys.stderr)
    return bad


def cmd_dev_show_seedext(args):
    _force_platform(args)
    from .match.show_seedext import show_seedext
    return show_seedext(args.f, args.outfmt or [],
                        sortmatches=args.sortmatches)


def cmd_dev_sortbench(args):
    """gt dev sortbench (ref: src/tools/gt_sortbench.c): time sort
    implementations on random data; ours benches the device lax.sort
    lane against numpy (the reference benches its qsort variants)."""
    _force_platform(args)
    import time as _time
    rng = np.random.default_rng(42)
    vals = rng.integers(0, args.maxvalue, args.n, dtype=np.int64)
    out = vals
    for _ in range(args.runs):
        t0 = _time.perf_counter()
        if args.impl == "numpy":
            out = np.sort(vals)
        else:
            import jax
            import jax.numpy as jnp
            out = np.asarray(jax.jit(jnp.sort)(jnp.asarray(vals)))
        el = _time.perf_counter() - t0
        print(f"# TIME {args.impl} sort of {args.n} values "
              f"{int(el)}.{int(el * 100) % 100:02d}")
    if args.verify:
        assert (np.diff(out) >= 0).all(), "output not sorted"
        print("# verified")
    return 0


def cmd_dev_paircmp(args):
    """gt dev paircmp (ref: src/tools/gt_paircmp.c): apply the unit
    edit-distance checkfunction to string pairs — all pairs over a
    character list up to a length (-a), or two given strings (-ss);
    verifies the production aligner against the O(n*m) DP oracle."""
    _force_platform(args)
    from itertools import product

    from .match.alignment import edit_distance

    def dp_edist(u, v):
        prev = list(range(len(v) + 1))
        for i in range(1, len(u) + 1):
            cur = [i] + [0] * len(v)
            for j in range(1, len(v) + 1):
                cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                             prev[j - 1] + (u[i - 1] != v[j - 1]))
            prev = cur
        return prev[len(v)]

    charset = sorted(set("".join(args.ss) if args.ss else args.a[0]))
    if len(charset) > 4:
        raise SystemExit("paircmp: at most 4 distinct characters "
                         "(the production aligner's code domain)")
    cmap = {c: i for i, c in enumerate(charset)}

    def enc(w):
        return np.asarray([cmap[c] for c in w], np.uint8)

    pairs = 0
    if args.ss:
        u, v = args.ss
        d = edit_distance(enc(u), enc(v))
        if args.e:
            print(f"edist({u},{v})={d}")
        assert d == dp_edist(u, v)
        pairs = 1
    else:
        chars, maxlen = args.a[0], int(args.a[1])
        words = [""]
        all_words = [""]
        for _ in range(maxlen):
            words = [w + c for w in words for c in chars]
            all_words += words
        for u, v in product(all_words, repeat=2):
            d = edit_distance(enc(u), enc(v))
            assert d == dp_edist(u, v), f"mismatch at ({u}, {v})"
            pairs += 1
    print(f"# number of compared pairs: {pairs}")
    return 0


def cmd_dev_patternmatch(args):
    """gt dev patternmatch (ref: src/tools/gt_patternmatch.c): sample
    random substrings of an indexed sequence set and check that the
    index search finds each at its sampled position."""
    _force_platform(args)
    from .core.encseq import Encseq
    from .index.esa import load_esa
    from .match.querysearch import query_substring_matches

    enc = Encseq.load(args.ii)
    esa = load_esa(args.ii, encseq=enc)
    rng = np.random.default_rng(7)
    n = enc.total_length
    found = 0
    for _ in range(args.samples):
        pl = int(rng.integers(args.minpl, args.maxpl + 1))
        p0 = int(rng.integers(0, max(n - pl, 1)))
        pat = enc.codes[p0:p0 + pl]
        if (pat >= 4).any():
            continue
        q = Encseq.from_string(enc.alphabet.decode(pat))
        hits = [dbpos for dbpos, _, length in
                query_substring_matches(esa, q, pl) if length >= pl]
        assert p0 in hits, f"pattern at {p0} (len {pl}) not found"
        found += 1
    print(f"# {found} patterns checked")
    return 0


def cmd_dev_trieins(args):
    """gt dev trieins (ref: src/tools/gt_trieins.c over
    src/match/trieins.c): insert every suffix of an index into the
    trie order and verify it equals the suffix array (the reference's
    checktrie traversal)."""
    _force_platform(args)
    from .core.encseq import Encseq
    from .index.esa import load_esa
    from .index.suffix import check_suftab_order

    enc = Encseq.load(args.indexname)
    esa = load_esa(args.indexname, encseq=enc, need_lcp=False)
    keys = enc.suffix_keys()
    n1 = keys.size
    sa = esa.suftab.astype(np.int64)
    assert sorted(sa.tolist()) == list(range(n1))
    assert check_suftab_order(keys, sa), "trie order violated"
    print(f"# {n1} suffixes inserted and verified")
    return 0


def cmd_dev_kmer_database(args):
    """gt dev kmer_database (ref: src/tools/gt_kmer_database.c over
    src/extended/kmer_database.c): build the merged k-mer database of
    a sequence file, optionally verify against brute-force counts."""
    _force_platform(args)
    from .core.encseq import Encseq
    from .match.kmer_database import KmerDatabase

    enc = Encseq.from_files(args.db)
    db = KmerDatabase.from_encseq(enc, args.kmersize,
                                  cutoff=args.cutoff)
    assert db.check_consistency()
    if args.verify:
        from .match.tallymer import mkindex_bruteforce
        ref = mkindex_bruteforce(enc, args.kmersize)
        counts = np.diff(db.offsets)
        assert db.num_keys == ref.num_mers
        assert (db.codes == ref.mer_codes).all()
        if args.cutoff is None:
            assert (counts == ref.counts).all()
        print("# verified against brute-force recount")
    print(f"# {db.num_keys} distinct {args.kmersize}-mers, "
          f"{db.num_occurrences} occurrences")
    return 0


def cmd_dev_skproto(args):
    """gt dev skproto (ref: src/tools/gt_skproto.c): print a new-tool
    skeleton (a Python subcommand module here, matching this CLI's
    conventions instead of the reference's C boilerplate)."""
    name = args.name or "newtool"
    q3 = '"""'
    lines = [
        f"def cmd_{name}(args):",
        f"    {q3}gt {name} (ref: src/tools/gt_{name}.c).{q3}",
        "    _force_platform(args)",
        "    return 0",
        "",
        "",
        f"def _add_{name}(sub):",
        f'    p = sub.add_parser("{name}", help="FIXME")',
        '    p.add_argument("--cpu", action="store_true")',
        f"    p.set_defaults(func=cmd_{name})",
    ]
    print("\n".join(lines))
    return 0


def cmd_dev(args):
    return args.devfunc(args)


def _add_dev(sub):
    p = sub.add_parser("dev", help="development tools")
    dsub = p.add_subparsers(dest="devtool", required=True)

    s = dsub.add_parser("sfxmap", help="verify an on-disk ESA index")
    s.add_argument("indexname", nargs="?", default=None)
    s.add_argument("-suf", action="store_true")
    s.add_argument("-lcp", action="store_true")
    s.add_argument("-tis", action="store_true")
    s.add_argument("-esa", default=None)       # accepted alias
    s.add_argument("-enumlcpitvs", action="store_true",
                   help="enumerate the lcp-intervals")
    s.add_argument("-enumlcpitvtree", action="store_true",
                   help="enumerate the lcp-interval tree")
    s.add_argument("-enumlcpitvtreeBU", action="store_true",
                   help="enumerate the lcp-interval tree (bottom-up)")
    s.add_argument("-spmitv", action="store_true",
                   help="distribution of intervals with whole leaves")
    s.add_argument("--cpu", action="store_true")
    s.set_defaults(func=cmd_dev_sfxmap)

    s = dsub.add_parser("show_seedext",
                        help="re-display seed_extend match files")
    s.add_argument("-f", required=True, help="match file")
    s.add_argument("-outfmt", nargs="+", default=None)
    s.add_argument("-sortmatches", action="store_true")
    s.add_argument("-relax_polish", action="store_true")  # accepted
    s.add_argument("--cpu", action="store_true")
    s.set_defaults(func=cmd_dev_show_seedext)

    s = dsub.add_parser("sortbench", help="benchmark sorting")
    s.add_argument("-impl", default="device",
                   choices=["device", "numpy"])
    s.add_argument("-size", dest="n", type=int, default=1 << 20)
    s.add_argument("-maxvalue", type=int, default=1 << 30)
    s.add_argument("-runs", type=int, default=1)
    s.add_argument("-verify", action="store_true")
    s.add_argument("--cpu", action="store_true")
    s.set_defaults(func=cmd_dev_sortbench)

    s = dsub.add_parser("paircmp", help="check pairwise aligners")
    s.add_argument("-ss", nargs=2, default=None,
                   help="use two strings")
    s.add_argument("-a", nargs=2, default=None,
                   help="use character list and length")
    s.add_argument("-e", action="store_true",
                   help="output unit edit distance")
    s.add_argument("--cpu", action="store_true")
    s.set_defaults(func=cmd_dev_paircmp)

    s = dsub.add_parser("patternmatch",
                        help="check index pattern search")
    s.add_argument("-ii", required=True)
    s.add_argument("-minpl", type=int, default=10)
    s.add_argument("-maxpl", type=int, default=30)
    s.add_argument("-samples", type=int, default=100)
    s.add_argument("--cpu", action="store_true")
    s.set_defaults(func=cmd_dev_patternmatch)

    s = dsub.add_parser("trieins", help="suffix trie insertion check")
    s.add_argument("indexname")
    s.add_argument("--cpu", action="store_true")
    s.set_defaults(func=cmd_dev_trieins)

    s = dsub.add_parser("kmer_database", help="merged k-mer database")
    s.add_argument("-db", nargs="+", required=True)
    s.add_argument("-kmersize", type=int, default=8)
    s.add_argument("-cutoff", type=int, default=None)
    s.add_argument("-verify", action="store_true")
    s.add_argument("--cpu", action="store_true")
    s.set_defaults(func=cmd_dev_kmer_database)

    s = dsub.add_parser("skproto", help="print a tool skeleton")
    s.add_argument("name", nargs="?", default=None)
    s.add_argument("--cpu", action="store_true")
    s.set_defaults(func=cmd_dev_skproto)


_REGISTER = [_add_suffixerator, _add_encseq, _add_tallymer, _add_repfind,
             _add_seqstat, _add_gff3, _add_stat, _add_seed_extend,
             _add_readjoiner, _add_ltrharvest, _add_ltrdigest,
             _add_packedindex, _add_tagerator,
             _add_genomediff, _add_uniquesub, _add_matstat, _add_seqtools,
             _add_sketch, _add_chain2dim, _add_linspace_align, _add_wtree,
             _add_convert_anno, _add_select, _add_merge, _add_uniq,
             _add_interfeat, _add_extractfeat, _add_csa, _add_eval,
             _add_cds, _add_splicesiteinfo, _add_orffinder,
             _add_seqorder, _add_regioncov, _add_magicmatch,
             _add_seqtransform, _add_fastq_sample, _add_seqids,
             _add_loccheck, _add_gff3validator, _add_inlineseq_split,
             _add_inlineseq_add, _add_hop, _add_matchtool,
             _add_mergeesa, _add_compreads, _add_sambam, _add_sain,
             _add_splitfasta, _add_clean, _add_mmapandread, _add_template,
             _add_dot, _add_convertseq, _add_seq, _add_shulengthdist,
             _add_encseq2spm, _add_prebwt, _add_mkfmindex,
             _add_mkfeatureindex, _add_featureindex, _add_condenseq,
             _add_scriptfilter, _add_speck, _add_feat_streams,
             _add_snpper, _add_congruence, _add_dev, _add_tirvish,
             _add_ltrclustering, _add_sketch_page]


def _tool_constraints():
    """Declarative option implications/exclusions per tool, mirroring
    the reference's gt_option_imply/_exclude declarations (ref:
    src/tools/gt_repfind.c:458-477, gt_seed_extend.c:272-380,
    src/match/sfx-run.c; error texts byte-matched to core/option.c)."""
    from .utils.options import Constraints
    return {
        "suffixerator": Constraints()
            .exclude("parts", "memlimit"),
        "repfind": Constraints()
            .exclude("extendgreedy", "extendxdrop")
            .imply_either("minidentity", "extendxdrop", "extendgreedy")
            .imply("maxalilendiff", "extendgreedy")
            .imply("percmathistory", "extendgreedy"),
        "seed_extend": Constraints()
            .exclude("extendgreedy", "extendxdrop")
            .exclude("percmathistory", "extendxdrop")
            .exclude("maxalilendiff", "extendxdrop")
            .exclude("history", "extendxdrop")
            .imply("pick", "parts"),
    }


def _proc_env_options():
    """Parse $GT_ENV_OPTIONS (ref: src/core/init.c:52-95
    proc_env_options): `-spacepeak` turns on the space-peak ledger
    printed at exit, `-showtime` enables run-time statistics globally.
    Bad options report on stderr without aborting the tool, exactly
    like the reference."""
    env = os.environ.get("GT_ENV_OPTIONS")
    if not env:
        return
    for tok in env.split():
        if tok == "-spacepeak":
            bookkeeping = os.environ.get("GT_MEM_BOOKKEEPING")
            if bookkeeping != "on":
                print("warning: GT_ENV_OPTIONS=-spacepeak used without "
                      "GT_MEM_BOOKKEEPING=on", file=sys.stderr)
            from .utils import spacepeak
            spacepeak.show_at_exit()
        elif tok == "-showtime":
            os.environ["GT_SHOWTIME"] = "1"
        elif tok:
            print(f'error parsing $GT_ENV_OPTIONS: unknown option: '
                  f'"{tok}"', file=sys.stderr)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="gt-tpu",
        description="JAX sequence indexing and matching toolkit")
    sub = parser.add_subparsers(dest="tool", required=True)
    for add in _REGISTER:
        add(sub)
    _proc_env_options()
    raw0 = (argv if argv is not None else sys.argv[1:])
    # man page sources for every tool (ref: src/gtr.c:227 -createman,
    # gtr.c:325 create_manpages)
    if len(raw0) >= 2 and raw0[0] == "-createman":
        from .utils.manpage import create_manpages
        n = create_manpages(parser, raw0[1])
        print(f"# wrote {n} man page sources to {raw0[1]}",
              file=sys.stderr)
        return 0
    # driver script fallback (ref: src/gtr.c:462-507): first argument
    # is not a tool -> run it as a script with the `gt` namespace;
    # `-i` opens the interactive shell
    if raw0 and raw0[0] == "-i":
        from .gtscript import interactive
        return interactive()
    if raw0 and raw0[0] not in sub.choices \
            and not raw0[0].startswith("-"):
        if os.path.isfile(raw0[0]):
            from .gtscript import run_script
            return run_script(raw0[0], list(raw0[1:]))
        print(f"gt-tpu: error: neither tool nor script '{raw0[0]}' "
              f"found; option -help lists possible tools",
              file=sys.stderr)
        return 1
    args = parser.parse_args(argv)
    cons = _tool_constraints().get(getattr(args, "tool", None))
    if cons is not None:
        raw = argv if argv is not None else sys.argv[1:]
        cons.check(list(raw), lambda msg: parser.error(msg))
    try:
        return args.func(args)
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(main())
