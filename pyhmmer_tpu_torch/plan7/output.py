"""Tabular output formats: ``--tblout``, ``--domtblout``, Pfam.

Byte-layout follows ``p7_tophits_TabularTargets`` / ``TabularDomains``
(reference contract in SURVEY.md §2.2, golden files in
``tests/data/tables``): dynamic name-column widths, ``%9.2g`` E-values,
``%6.1f`` scores.

The port's copy of ``pyhmmer_tpu/plan7/output.py``, line for line but
the imports; ``TopHits.write`` calls it.
"""

from __future__ import annotations

import math


def _w(items, header):
    return max([len(header)] + [len(x or b"-") for x in items])


def write_targets(th, fh, header: bool = True) -> None:
    if getattr(th, "long_targets", False):
        return _write_targets_long(th, fh, header)
    hits = [h for h in th.hits if h.reported]
    qname = th.query_name or b"-"
    qacc = th.query_accession or b"-"
    tnw = _w([h.name for h in hits], "target name")
    taw = _w([h.accession for h in hits], "accession")
    qnw = max(len("query name"), len(qname))
    qaw = max(len("accession"), len(qacc))
    if header:
        fh.write("#%*s %22s %22s %33s\n" % (
            tnw + qnw + taw + qaw + 2, "",
            "--- full sequence ----", "--- best 1 domain ----",
            "--- domain number estimation ----"))
        fh.write("#%-*s %-*s %-*s %-*s %9s %6s %5s %9s %6s %5s %5s %3s "
                 "%3s %3s %3s %3s %3s %3s %s\n" % (
                     tnw - 1, " target name", taw, "accession",
                     qnw, "query name", qaw, "accession",
                     "E-value", "score", "bias", "E-value", "score", "bias",
                     "exp", "reg", "clu", "ov", "env", "dom", "rep", "inc",
                     "description of target"))
        fh.write("#%*s %*s %*s %*s %9s %6s %5s %9s %6s %5s %5s %3s %3s "
                 "%3s %3s %3s %3s %3s %s\n" % (
                     tnw - 1, "-" * (tnw - 1), taw, "-" * taw,
                     qnw, "-" * qnw, qaw, "-" * qaw,
                     "-" * 9, "-" * 6, "-" * 5, "-" * 9, "-" * 6, "-" * 5,
                     "-" * 5, "-" * 3, "-" * 3, "-" * 3, "-" * 3, "-" * 3,
                     "-" * 3, "-" * 3, "-" * 21))
    for h in hits:
        bd = h.best_domain
        fh.write("%-*s %-*s %-*s %-*s %9.2g %6.1f %5.1f %9.2g %6.1f %5.1f "
                 "%5.1f %3d %3d %3d %3d %3d %3d %3d %s\n" % (
                     tnw, (h.name or b"-").decode(),
                     taw, (h.accession or b"-").decode(),
                     qnw, qname.decode(), qaw, qacc.decode(),
                     h.evalue, h.score, h.bias,
                     bd.i_evalue, bd.score, bd.bias,
                     h.nexpected, h.nregions, h.nclustered, h.noverlaps,
                     h.nenvelopes, h.ndom, h.nreported, h.nincluded,
                     (h.description or b"-").decode()))


def _write_targets_long(th, fh, header: bool = True) -> None:
    """nhmmer ``--tblout`` layout (``p7_tophits_TabularTargets`` with
    ``pli->long_targets``): per-hit hmm/ali/env coordinates, sequence
    length and strand instead of the domain-number columns."""
    hits = [h for h in th.hits if h.reported]
    qname = th.query_name or b"-"
    qacc = th.query_accession or b"-"
    tnw = _w([h.name for h in hits], "target name")
    taw = _w([h.accession for h in hits], "accession")
    qnw = max(len("query name"), len(qname))
    qaw = max(len("accession"), len(qacc))
    if header:
        fh.write("#%-*s %-*s %-*s %-*s %7s %7s %7s %7s %7s %7s %7s %6s "
                 "%9s %6s %5s %s\n" % (
                     tnw - 1, " target name", taw, "accession",
                     qnw, "query name", qaw, "accession",
                     "hmmfrom", "hmm to", "alifrom", "ali to",
                     "envfrom", "env to", "sq len", "strand",
                     "E-value", "score", "bias",
                     "description of target"))
        fh.write("#%*s %*s %*s %*s %7s %7s %7s %7s %7s %7s %7s %6s %9s "
                 "%6s %5s %s\n" % (
                     tnw - 1, "-" * (tnw - 1), taw, "-" * taw,
                     qnw, "-" * qnw, qaw, "-" * qaw,
                     "-" * 7, "-" * 7, "-" * 7, "-" * 7, "-" * 7, "-" * 7,
                     "-" * 7, "-" * 6, "-" * 9, "-" * 6, "-" * 5, "-" * 21))
    for h in hits:
        d = h.best_domain
        a = d.alignment
        strand = "+" if d.ali_from <= d.ali_to else "-"
        fh.write("%-*s %-*s %-*s %-*s %7d %7d %7d %7d %7d %7d %7d %6s "
                 "%9.2g %6.1f %5.1f %s\n" % (
                     tnw, (h.name or b"-").decode(),
                     taw, (h.accession or b"-").decode(),
                     qnw, qname.decode(), qaw, qacc.decode(),
                     a.hmm_from, a.hmm_to, d.ali_from, d.ali_to,
                     d.env_from, d.env_to, h.length, strand,
                     h.evalue, h.score, h.bias,
                     (h.description or b"-").decode()))


def write_domains(th, fh, header: bool = True) -> None:
    hits = [h for h in th.hits if h.reported]
    qname = th.query_name or b"-"
    qacc = th.query_accession or b"-"
    tnw = _w([h.name for h in hits], "target name")
    taw = _w([h.accession for h in hits], "accession")
    qnw = max(len("query name"), len(qname))
    qaw = max(len("accession"), len(qacc))
    if header:
        fh.write("#%*s %22s %40s %11s %11s %11s\n" % (
            tnw + qnw - 1 + taw + qaw + 12, "",
            "--- full sequence ---", "-------------- this domain "
            "-------------", "hmm coord", "ali coord", "env coord"))
        fh.write("#%-*s %-*s %5s %-*s %-*s %5s %9s %6s %5s %3s %3s %9s "
                 "%9s %6s %5s %5s %5s %5s %5s %5s %5s %4s %s\n" % (
                     tnw - 1, " target name", taw, "accession", "tlen",
                     qnw, "query name", qaw, "accession", "qlen",
                     "E-value", "score", "bias", "#", "of", "c-Evalue",
                     "i-Evalue", "score", "bias", "from", "to", "from",
                     "to", "from", "to", "acc", "description of target"))
        fh.write("#%*s %*s %5s %*s %*s %5s %9s %6s %5s %3s %3s %9s %9s "
                 "%6s %5s %5s %5s %5s %5s %5s %5s %4s %s\n" % (
                     tnw - 1, "-" * (tnw - 1), taw, "-" * taw, "-" * 5,
                     qnw, "-" * qnw, qaw, "-" * qaw, "-" * 5, "-" * 9,
                     "-" * 6, "-" * 5, "-" * 3, "-" * 3, "-" * 9, "-" * 9,
                     "-" * 6, "-" * 5, "-" * 5, "-" * 5, "-" * 5, "-" * 5,
                     "-" * 5, "-" * 5, "-" * 4, "-" * 21))
    for h in hits:
        nd = len(h.domains)
        for di, d in enumerate(h.domains):
            if not d.reported:
                continue
            a = d.alignment
            acc = d.oasc / (1.0 + abs(d.env_to - d.env_from))
            fh.write("%-*s %-*s %5d %-*s %-*s %5d %9.2g %6.1f %5.1f %3d "
                     "%3d %9.2g %9.2g %6.1f %5.1f %5d %5d %5d %5d %5d %5d "
                     "%4.2f %s\n" % (
                         tnw, (h.name or b"-").decode(),
                         taw, (h.accession or b"-").decode(), h.length,
                         qnw, qname.decode(), qaw, qacc.decode(),
                         th.query_length,
                         h.evalue, h.score, h.bias,
                         di + 1, nd, d.c_evalue, d.i_evalue, d.score,
                         d.bias,
                         a.hmm_from, a.hmm_to, d.ali_from, d.ali_to,
                         d.env_from, d.env_to, min(acc, 1.0),
                         (h.description or b"-").decode()))


def write_pfam(th, fh, header: bool = True) -> None:
    """3-line-per-hit Pfam format (``p7_tophits_TabularXfam`` subset)."""
    hits = [h for h in th.hits if h.reported]
    qname = (th.query_name or b"-").decode()
    tnw = _w([h.name for h in hits], "target name")
    if header:
        fh.write("# Sequence scores\n")
    for h in hits:
        fh.write("%-*s %9.2g %6.1f %5.1f %s\n" % (
            tnw, (h.name or b"-").decode(), h.evalue, h.score, h.bias,
            qname))
