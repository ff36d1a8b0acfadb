"""LTR feature clustering (`gt ltrclustering`).

Capability equivalent of the reference cluster stream (ref:
src/ltr/ltr_cluster_stream.c over src/ltr/gt_ltrclustering.c): the
sequences of each LTR feature group — left/right long terminal repeats
and protein_match features grouped by their `name` attribute — are
matched all-vs-all, and two features land in one cluster when a match
covers >= psmall percent of the smaller AND >= plarge percent of the
larger sequence (ref: ltr_cluster_stream.c:216-219); the union-find
closure's cluster index is written to every member as the `clid`
attribute (ref: cluster_annotate_nodes, ltr_cluster_stream.c:296).
Elements are then assigned a family id (`ltrfam`) from their lLTR
cluster (the classify stream's grouping key, ref:
src/ltr/ltr_classify_stream.c).

Accelerator-first matcher: instead of the reference's external LAST pipeline,
group members are concatenated into one Encseq and matched with the
batched seed_extend engine (the same device seeding + extension stack
as `gt seed_extend`).
"""

from __future__ import annotations

import numpy as np

from ..core.encseq import Encseq
from ..anno.genome_node import FeatureNode


class _UnionFind:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, x):
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[max(ra, rb)] = min(ra, rb)


def _collect_groups(nodes, encseq: Encseq):
    """feature-group name -> list of (node, codes). Groups: lLTR, rLTR
    (the two long_terminal_repeat children per element, ≥10bp) and each
    protein_match `name` (ref: ltr_cluster_prepare_seq_visitor.c)."""
    seq_of = {}
    for i in range(encseq.num_sequences):
        seq_of[f"seq{i}"] = i
        if i < len(encseq.descs) and encseq.descs[i]:
            seq_of[encseq.descs[i].split()[0]] = i
    groups: dict[str, list] = {}

    def seq_slice(node):
        sn = seq_of.get(node.seqid)
        if sn is None:
            return None
        lo = int(encseq.seq_startpos(sn))
        return encseq.codes[lo + node.start - 1:lo + node.end]

    for top in nodes:
        if not isinstance(top, FeatureNode):
            continue
        ltr_index = 0
        for node in top.traverse():
            if node.type == "long_terminal_repeat":
                key = "lLTR" if ltr_index == 0 else "rLTR"
                ltr_index += 1
            elif node.type == "protein_match":
                key = node.attributes.get("name")
                if not key:
                    continue
            else:
                continue
            if node.end - node.start + 1 < 10:
                continue
            codes = seq_slice(node)
            if codes is None or codes.size < 10:
                continue
            groups.setdefault(key, []).append((node, codes))
    return groups


def _cluster_group(members, psmall: int, plarge: int) -> None:
    """All-vs-all match the group's sequences; union on the coverage
    rule; write clid attributes (cluster numbering in union-find root
    order, matching the reference's clustered-set enumeration)."""
    from ..match.seed_extend import SeedExtendParams, seed_extend
    n = len(members)
    if n == 0:
        return
    uf = _UnionFind(n)
    if n > 1:
        lens = [c.size for _, c in members]
        e = Encseq.from_string("|".join(
            "".join("acgt"[x] if x < 4 else "n" for x in c)
            for _, c in members))
        p = SeedExtendParams(
            seedlength=min(14, max(8, min(lens) // 4)),
            userdefinedleastlength=10, minidentity=80,
            extension="greedy")
        try:
            matches = seed_extend(e, None, p)
        except Exception:
            matches = []
        for m in matches:
            i, j = int(m.dbseqnum), int(m.queryseqnum)
            if i == j:
                continue
            l1, l2 = int(m.dblen), int(m.querylen)
            lsmall, llarge = min(lens[i], lens[j]), max(lens[i], lens[j])
            # ref: ltr_cluster_stream.c:216-219 — both match lengths
            # must cover psmall% of the smaller AND plarge% of the
            # larger sequence
            if (llarge * plarge) // 100 <= l1 \
                    and (lsmall * psmall) // 100 <= l1 \
                    and (llarge * plarge) // 100 <= l2 \
                    and (lsmall * psmall) // 100 <= l2:
                uf.union(i, j)
    roots = []
    for i in range(n):
        r = uf.find(i)
        if r not in roots:
            roots.append(r)
    for i, (node, _) in enumerate(members):
        node.attributes["clid"] = str(roots.index(uf.find(i)))


def ltrclustering(encseq: Encseq, nodes, psmall: int, plarge: int):
    """Annotate clid per feature group + ltrfam per element; returns
    the (mutated) node list."""
    groups = _collect_groups(nodes, encseq)
    for key in groups:
        _cluster_group(groups[key], psmall, plarge)
    # family assignment from the lLTR clusters (classify stream key)
    fam_of_clid: dict[str, int] = {}
    for top in nodes:
        if not isinstance(top, FeatureNode):
            continue
        for node in top.traverse():
            if node.type != "LTR_retrotransposon":
                continue
            ltrs = [c for c in node.traverse()
                    if c.type == "long_terminal_repeat"]
            if not ltrs or "clid" not in ltrs[0].attributes:
                continue
            clid = ltrs[0].attributes["clid"]
            fam = fam_of_clid.setdefault(clid, len(fam_of_clid))
            node.attributes["ltrfam"] = f"ltrfam_{fam}"
    return nodes
