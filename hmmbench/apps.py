"""The program's applications as the benchmark drives them.

An application holds a cell's inputs (made by :mod:`hmmbench.data` from
the seed), hands them to ``pyhmmer_tpu_torch`` as its ``HMM`` and
``DigitalSequenceBlock`` objects, makes one timed call at a time, and
keeps of each call a record (its work and the engine's stage marks) and
the summary of its answers that the check reads.  Which application a
configuration runs is its ``app``; how many models or sequences make a
call is the traffic's ``per_call``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from . import check, data, roofline
from .reference import search as ref_search


def _port():
    """The program's modules (imported when a run starts, never when
    this module is imported)."""
    from pyhmmer_tpu_torch import hmmer
    from pyhmmer_tpu_torch.easel.alphabet import Alphabet
    from pyhmmer_tpu_torch.easel.sequence import (DigitalSequence,
                                                  DigitalSequenceBlock)
    from pyhmmer_tpu_torch.engine import SearchEngine
    from pyhmmer_tpu_torch.plan7.hmm import HMM, HMMFlags
    return dict(hmmer=hmmer, Alphabet=Alphabet, HMM=HMM, HMMFlags=HMMFlags,
                DigitalSequence=DigitalSequence,
                DigitalSequenceBlock=DigitalSequenceBlock,
                SearchEngine=SearchEngine)


class App:
    """What every application shares: the port, the device, the
    database, the records and the answers."""

    unit = ""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        if traffic["unit"] != self.unit:
            raise ValueError(f"traffic of {traffic['unit']!r} for an "
                             f"application that slices {self.unit!r}")
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = device
        self.port = _port()
        self.alphabet = self.port["Alphabet"].amino()
        self.db = data.Database(cfg)
        self.per_call = int(traffic["per_call"])
        self.records: List[dict] = []
        self.answers: Dict = {}
        self.missing = 0                # queries a call did not answer
        self.planted: set = set()       # keys holding a planted domain
        self.key_size: Dict = {}        # key -> model length or residues

    def hmm(self, m: dict):
        P = self.port
        h = P["HMM"](self.alphabet, m["M"], name=m["name"])
        h.t[...] = m["t"]
        h.mat[...] = m["mat"]
        h.ins[...] = m["ins"]
        h.evparam[:] = m["evparam"]
        h.flags |= P["HMMFlags"].STATS
        return h

    def sequences(self, names, seqs):
        P = self.port
        return [P["DigitalSequence"](self.alphabet, name=n, sequence=s)
                for n, s in zip(names, seqs)]

    def free(self) -> None:
        """Drop the program's objects (before the reference runs)."""

    def sample(self, k: int) -> Tuple[List, int]:
        """The answered keys in the order the check takes them, drawn
        from the seed, and how many of them it takes first: ``k`` keys,
        half among those holding a planted domain and the rest among
        all, and the largest; then the other keys holding a planted
        domain, then the rest."""
        rng = data.stream(self.seed, 3, 3)
        keys = sorted(self.answers)
        planted = [x for x in keys if x in self.planted]
        chosen = data.pick(rng, planted, k // 2)
        rest = [x for x in keys if x not in set(chosen)]
        chosen += data.pick(rng, rest, k - len(chosen))
        largest = max(keys, key=lambda x: (self.key_size[x], x))
        if largest not in chosen:
            chosen.append(largest)
        first = sorted(chosen)
        taken = set(first)
        later = [planted[int(i)] for i in rng.permutation(len(planted))
                 if planted[int(i)] not in taken]
        taken |= set(later)
        others = [x for x in keys if x not in taken]
        later += [others[int(i)] for i in rng.permutation(len(others))]
        return first + later, len(first)


class SearchApp(App):
    """hmmsearch of successive slices of the database against one
    proteome, each call a fresh ``SearchEngine`` and one ``search`` (what
    ``hmmer.hmmsearch(slice, block)`` runs), so every slice pays profile
    configuration, packing and upload.  The slices are dealt by model
    length (:func:`hmmbench.data.dealt_slices`), so each carries the
    database's mix of lengths and a window's rate does not hang on how
    many of them it reaches.  The last slice warms up; the window takes
    the others in order, at most one pass."""

    unit = "models"

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        self.proteome = data.Proteome(cfg, self.db, seed, 0,
                                      range(self.db.n))
        P = self.port
        self.block = P["DigitalSequenceBlock"](self.alphabet, self.sequences(
            self.proteome.names, self.proteome.sequences))
        self.lengths = [len(s) for s in self.proteome.sequences]
        self.planted = set(self.proteome.planted)
        self.slices = data.dealt_slices(
            [self.db.length(i) for i in range(self.db.n)], self.per_call)
        self.warm_slice = self.slices.pop()

    def inputs(self, c: int) -> Optional[Tuple]:
        if c == "warm":
            idxs = self.warm_slice
        elif c < len(self.slices):
            idxs = self.slices[c]
        else:
            return None
        models = [self.db.model(i) for i in idxs]
        return models, [self.hmm(m) for m in models]

    def call(self, inp):
        eng = self.port["SearchEngine"](self.alphabet, device=self.device)
        return eng.search(inp[1], self.block), eng

    def free(self) -> None:
        self.block = None

    def keys(self, inp) -> List[Tuple]:
        """(key, model length) of each query of a call."""
        return [(m["index"], m["M"]) for m in inp[0]]

    def keep(self, inp, out) -> dict:
        results, eng = out
        models = inp[0]
        self.missing += max(0, len(models) - len(results))
        for (key, size), th in zip(self.keys(inp), results):
            self.answers[key] = check.tophits_summary(th)
            self.key_size[key] = size
        Ms = [m["M"] for m in models]
        return {"work": len(models) * len(self.lengths),
                "timing": dict(eng.last_timing),
                "msv_bound_s": roofline.msv_bound_s(Ms, self.lengths)}

    def reference(self, keys, device) -> Dict:
        models = [self.db.model(i) for i in keys]
        out = ref_search.search(models, self.proteome.sequences,
                                self.proteome.names, device)
        return dict(zip(keys, out))


class ScanApp(App):
    """hmmscan of batches of proteins against a resident database: one
    ``SearchEngine`` keeps the configured models on the device, and each
    call is ``hmmer.hmmscan(batch, models, engine=engine)``.  Batches
    are drawn in order from a stream of seeded proteomes, no sequence
    twice; a batch of proteome 0, which the window does not draw from,
    warms up (and configures the models)."""

    unit = "sequences"

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        self.models = [self.db.model(i) for i in range(self.db.n)]
        self.hmms = [self.hmm(m) for m in self.models]
        self.Ms = [m["M"] for m in self.models]
        self.engine = self.port["SearchEngine"](self.alphabet,
                                                device=self.device)
        self.proteomes: Dict[int, data.Proteome] = {}
        self.n_prot = int(cfg["proteins"])

    def proteome(self, p: int) -> data.Proteome:
        if p not in self.proteomes:
            pr = data.Proteome(self.cfg, self.db, self.seed, p,
                               range(self.db.n))
            self.proteomes[p] = pr
            for idxs in pr.planted.values():
                self.planted |= {(p, i) for i in idxs}
        return self.proteomes[p]

    def inputs(self, c) -> Optional[Tuple]:
        k = self.per_call
        if c == "warm":
            p, b = 0, 0
        else:
            p, b = divmod(c, self.n_prot // k)
            p += 1
        pr = self.proteome(p)
        keys = [(p, i) for i in range(b * k, (b + 1) * k)]
        seqs = self.sequences([pr.names[i] for _, i in keys],
                              [pr.sequences[i] for _, i in keys])
        return keys, seqs

    def call(self, inp):
        return list(self.port["hmmer"].hmmscan(inp[1], self.hmms,
                                               engine=self.engine)), None

    def keys(self, inp) -> List[Tuple]:
        """(key, residues) of each sequence of a call."""
        return [(k, len(s.sequence)) for k, s in zip(*inp)]

    def keep(self, inp, out) -> dict:
        seqs = inp[1]
        self.missing += max(0, len(seqs) - len(out[0]))
        for (key, size), th in zip(self.keys(inp), out[0]):
            self.answers[key] = check.tophits_summary(th)
            self.key_size[key] = size
        Ls = [len(s.sequence) for s in seqs]
        return {"work": len(seqs),
                "timing": dict(self.engine.last_timing),
                "msv_bound_s": roofline.msv_bound_s(self.Ms, Ls)}

    def reference(self, keys, device) -> Dict:
        seqs = [self.proteomes[p].sequences[i] for p, i in keys]
        out = ref_search.scan(self.models, seqs, device)
        return dict(zip(keys, out))

    def free(self) -> None:
        self.engine = None
        self.hmms = None


APPS = {"hmmsearch": SearchApp, "hmmscan": ScanApp}
