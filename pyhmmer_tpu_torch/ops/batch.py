"""Profile and sequence packing for the PyTorch filter cascade.

``ProfileBatch`` keeps the same per-profile fields as the JAX package's
``pyhmmer_tpu.ops.batch.ProfileBatch`` (same names, shapes and padding)
as host numpy arrays, and, as ``nn.Module`` buffers that ``.to(device)``
moves, the tables the three stage kernels read.  The tables are padded
from ``Mp`` to the kernel width ``Mk = 32 * S`` (``S`` model slots per
warp lane, see ``stripe_width``) and stored striped, ``[..., S, 32]``
with element ``(j, l)`` holding slot ``l * S + j`` (:func:`striped`), so
warp lane ``l`` reads its ``S`` slots with coalesced loads:

* ``msv_w16`` [P, Kp, S, 32] int16, the quantized costs pre-biased,
  ``bias - cost`` (cost 255 in padding), ``msv_scal`` [P, 4] (bias, tec,
  tbm, 0), ``msv_odds`` [P, Kp] bias-filter odds with 0 at the
  nonresidue code;
* ``vit_emis`` [P, Kp, S, 32, 2] and ``vit_trans`` [P, S, 2, 32, 4]:
  the Viterbi kernel's log scores, packed so that a lane reads one
  slot's (M, I) emission scores of a residue in one 8-byte load and its
  eight transition scores in two 16-byte loads, each contiguous over
  the warp.  Transition ``t`` of slot ``s`` (state ``k = s + 1``) is: 0
  M->M, 1 I->M, 2 D->M into the slot from slot ``s - 1``; 3 B->M; 4
  M->I, 5 I->I within the slot; 6 M->D, 7 D->D out of the slot into
  slot ``s + 1``; ``NEGMASS`` marks an absent transition.  From ``S =
  VIT_WIDE_S`` on, where the kernel reads one value a load, ``vit_emis``
  is [P, Kp, 2, S, 32] (the M then the I scores of a residue) and
  ``vit_trans`` [P, 8, S, 32], striped (:func:`unpacked` undoes either
  layout);
* ``fwd_emis`` and ``fwd_trans``: the same tables in odds space
  (``exp``, 0 where absent) in the packed layouts of ``vit_emis`` and
  ``vit_trans``, wide from ``S = FWD_WIDE_S`` on, read by the Forward
  filter kernel and (in the narrow layout: S <= 24) by the survivor-rows
  kernels.

Models wider than ``32 * STRIPES[-1]`` (4,096) slots take the wide
route (:func:`stripe_width` is 0 there): one CTA a (profile, target)
pair, ``Mk`` padded to a multiple of ``CTA_THREADS``
(:func:`kernel_width`).  The MSV kernel runs ``NT = MSV_CTA_THREADS``
threads (:func:`msv_cta_shape`), thread ``t`` owning the run of ``SPT =
Mk / NT`` slots from ``t * SPT`` as ``R = SPT / 2`` words of two 16-bit
cells, word ``r`` holding slots ``r`` and ``r + R`` of the run:
``msv_w16`` is [P, Kp, R, W, 32, 2] there (:func:`msv_thread_major`;
``W = NT / 32`` warps, element ``(r, w, l, h)`` holds slot ``(32 w + l)
* SPT + r + h * R``), so the CTA's read of one word ``r`` is one
contiguous run of 4 bytes a thread; its row lives in registers for the
word counts :data:`MSV_CTA_REGS`, else in shared memory.  The Forward
and Viterbi kernels run ``NT`` threads (:func:`cta_shape`), thread ``t``
owning the contiguous run of ``SPT = Mk / NT`` slots ``t * SPT .. t *
SPT + SPT - 1``, and read thread-major tables (:func:`thread_major`):
``vit_emis`` and ``fwd_emis`` [P, Kp, SPT, W, 32, 2], ``vit_trans`` and
``fwd_trans`` [P, SPT, 2, W, 32, 4] (element ``(j, w, l)`` holds slot
``(32 w + l) * SPT + j``, packed as the narrow layout packs a slot), so
the CTA's read of one position ``j`` is one contiguous run of 8 or 16
bytes a thread.  Six dimensions mark the wide layouts: no narrow one has
more than five.  The Forward and Viterbi row lives in registers for the
compiled shapes :data:`CTA_REGS`, else in shared memory up to
:data:`CTA_SMEM_SLOTS` slots, else in a global scratch row (``NT =
CTA_THREADS`` for both).

``SeqDevice`` holds one length bucket of target sequences on an explicit
device.  The JAX package imports JAX at load, so the packing is
re-implemented here from its numpy parts, field for field.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..easel.alphabet import Alphabet
from ..easel.sequence import DigitalSequence, DigitalSequenceBlock
from ..plan7.background import Background
from ..plan7.hmm import HMM
from .quantize import quantize_msv, tjb_units

NEGMASS = -1e30

#: lane stripe widths the kernels are compiled for (model slots per lane)
STRIPES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)

#: threads a pair on the wide route (``csrc/common.cuh:CTA_THREADS``);
#: its model width is padded to a multiple of this
CTA_THREADS = 512

#: the wide-route Forward and Viterbi kernels compiled with the row in
#: registers, as (threads a CTA, slots a thread)
#: (``csrc/common.cuh:PYHMMER_CTA_REGS``: the entries ptxas compiles
#: without a spill): models of 4,097 to 5,632 slots; every multiple of
#: ``CTA_THREADS`` up to there has one, so the ladder adds no padding
CTA_REGS = ((256, 18), (256, 20), (256, 22))

#: threads a pair of the wide-route MSV kernel
#: (``csrc/msv.cu:MSV_CTA_THREADS``; ``tests/test_torch_wide.py`` holds
#: this and the other constants mirrored here against the sources):
#: every wide ``Mk``, a multiple of ``CTA_THREADS``, gives each thread an
#: even run of slots
MSV_CTA_THREADS = 256

#: the words a thread (two slots each) for which the wide-route MSV
#: kernel is compiled with its row in registers
#: (``csrc/msv.cu:PYHMMER_MSV_CTA_REGS``): every model width from 4,608
#: to 12,288 slots; wider ones keep the row in shared memory
MSV_CTA_REGS = tuple(range(9, 25))

#: the widest model whose row (three floats a slot) the wide-route
#: Forward and Viterbi kernels keep in shared memory
#: (``csrc/common.cuh:CTA_SMEM_SLOTS``: 227,328 of a block's 232,448
#: bytes); wider ones keep it in a global scratch row
CTA_SMEM_SLOTS = 37 * CTA_THREADS

#: stripe widths from which the Forward and the Viterbi kernel take the
#: wide table layout (``csrc/fwd.cu:FWD_WIDE_S``, ``csrc/vit.cu:VIT_WIDE_S``)
FWD_WIDE_S = 32
VIT_WIDE_S = 16

#: padded model width granularity when no ``Mp`` is given
PAD = 64

#: the per-profile fields shared with the JAX ``ProfileBatch``
FIELDS = ("msc", "isc", "tMM", "tIM", "tDM", "tMD", "tDD", "tBM", "tMI",
          "tII", "kmask", "xE", "msv_cost", "msv_bias", "msv_tec",
          "msv_tbm", "filter_odds")


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def stripe_width(Mp: int) -> int:
    """Smallest compiled stripe ``S`` with ``32 * S >= Mp``, or 0 past
    the widest, where the kernels take the wide route."""
    for s in STRIPES:
        if 32 * s >= Mp:
            return s
    return 0


def kernel_width(Mp: int) -> int:
    """The kernels' model width ``Mk`` for a padded width ``Mp``: ``32 *
    stripe_width(Mp)``, or on the wide route ``Mp`` rounded up to a
    multiple of :data:`CTA_THREADS`."""
    S = stripe_width(Mp)
    return 32 * S if S else round_up(Mp, CTA_THREADS)


def pack_profiles(profiles: Sequence, Mp: Optional[int] = None) -> dict:
    """The JAX ``ProfileBatch`` packing (``pyhmmer_tpu/ops/batch.py``) as
    a dict of numpy arrays, plus ``Mp``, ``Kp`` and ``scale_b``."""
    profiles = list(profiles)
    P = len(profiles)
    alph = profiles[0].alphabet
    Kp = alph.Kp
    Mp = Mp or round_up(max(p.M for p in profiles), PAD)
    out = {"Mp": Mp, "Kp": Kp}

    def padded(field, width, fill):
        a = np.full((P, width), fill, dtype=np.float32)
        for i, p in enumerate(profiles):
            v = np.maximum(getattr(p, field), NEGMASS)
            a[i, : len(v)] = v
        return a

    for name in ("tMM", "tIM", "tDM", "tMD"):
        out[name] = padded(name, Mp, NEGMASS)
    out["tDD"] = padded("tDD", Mp, 0.0)
    for i, p in enumerate(profiles):
        out["tDD"][i, p.M:] = 0.0
    out["tBM"] = padded("tBM", Mp, NEGMASS)
    out["tMI"] = padded("tMI", Mp + 1, NEGMASS)
    out["tII"] = padded("tII", Mp + 1, NEGMASS)
    out["kmask"] = np.zeros((P, Mp), dtype=bool)
    out["msc"] = np.full((P, Kp, Mp), NEGMASS, dtype=np.float32)
    out["isc"] = np.full((P, Kp, Mp), NEGMASS, dtype=np.float32)
    for i, p in enumerate(profiles):
        out["kmask"][i, : p.M] = True
        out["msc"][i, :, : p.M] = np.maximum(p.msc[:, 1:], NEGMASS)
        out["isc"][i, :, : p.M] = np.maximum(p.isc[:, 1:], NEGMASS)
    out["xE"] = np.stack([np.maximum(p.xE, NEGMASS)
                          for p in profiles]).astype(np.float32)

    quants = [quantize_msv(p) for p in profiles]
    out["msv_cost"] = np.full((P, Kp, Mp), 255.0, dtype=np.float32)
    for i, q in enumerate(quants):
        out["msv_cost"][i, :, : q.M] = q.cost
    out["msv_bias"] = np.array([q.bias_b for q in quants], dtype=np.float32)
    out["msv_tec"] = np.array([q.tec_b for q in quants], dtype=np.float32)
    out["msv_tbm"] = np.array([q.tbm_b for q in quants], dtype=np.float32)
    out["scale_b"] = quants[0].scale_b

    odds = np.ones((P, Kp), dtype=np.float32)
    for i, p in enumerate(profiles):
        if p.compo is None:
            continue
        f = Background(alph).residue_frequencies
        K = alph.K
        o = (0.5 * np.asarray(p.compo)[:K] + 0.5 * f) / f
        odds[i, :K] = o
        for code in range(K + 1, Kp - 2):
            mem = alph.degen[code]
            w = f[mem]
            odds[i, code] = (o[mem] * w).sum() / w.sum()
    out["filter_odds"] = odds
    return out


def _xexp(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float64)
    return np.where(a > -600.0, np.exp(np.minimum(a, 600.0)),
                    0.0).astype(np.float32)


def cta_shape(Mk: int):
    """(threads a CTA, tier) of the wide-route Forward and Viterbi
    kernels for a model ``Mk`` slots wide: the tier says where the row
    lives, ``"registers"``, ``"shared"`` or ``"global"`` (module
    docstring)."""
    for nt, spt in CTA_REGS:
        if nt * spt == Mk:
            return nt, "registers"
    return CTA_THREADS, "shared" if Mk <= CTA_SMEM_SLOTS else "global"


def msv_cta_shape(Mk: int):
    """(threads a CTA, tier) of the wide-route MSV kernel for a model
    ``Mk`` slots wide: its cells in ``"registers"`` or ``"shared"``
    memory (module docstring)."""
    nt = MSV_CTA_THREADS
    return nt, "registers" if Mk // (2 * nt) in MSV_CTA_REGS else "shared"


def msv_thread_major(a, nt: int):
    """[..., Mk] -> [..., R, W, 32, 2] with element (r, w, l, h) = slot
    (32 w + l) * SPT + r + h * R for ``nt`` = 32 W threads, SPT = Mk /
    nt = 2 R (a numpy array or a tensor)."""
    *lead, Mk = a.shape
    r = Mk // (2 * nt)
    return a.reshape(*lead, nt, 2, r).swapaxes(-1, -2).swapaxes(
        -2, -3).reshape(*lead, r, nt // 32, 32, 2)


def msv_thread_minor(t):
    """The inverse of :func:`msv_thread_major`: [..., R, W, 32, 2] ->
    [..., Mk] (``nt`` read from the shape)."""
    *lead, r, nw, _, _ = t.shape
    return t.reshape(*lead, r, 32 * nw, 2).swapaxes(-2, -3).swapaxes(
        -1, -2).reshape(*lead, 64 * nw * r)


def thread_major(a, nt: int):
    """[..., Mk] -> [..., SPT, W, 32] with element (j, w, l) = slot
    (32 w + l) * SPT + j for ``nt`` = 32 W threads, SPT = Mk / nt (a
    numpy array or a tensor; a view where possible)."""
    *lead, Mk = a.shape
    spt = Mk // nt
    return a.reshape(*lead, nt, spt).swapaxes(-1, -2).reshape(
        *lead, spt, nt // 32, 32)


def thread_minor(t):
    """The inverse of :func:`thread_major`: [..., SPT, W, 32] ->
    [..., Mk] (``nt`` read from the shape)."""
    *lead, spt, nw, _ = t.shape
    return t.reshape(*lead, spt, 32 * nw).swapaxes(-1, -2).reshape(
        *lead, 32 * nw * spt)


def striped(a):
    """[..., Mk] -> [..., S, 32] with element (j, l) = slot l*S + j (a
    numpy array or a tensor; a view where possible)."""
    *lead, Mk = a.shape
    return a.reshape(*lead, 32, Mk // 32).swapaxes(-1, -2)


def unstriped(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`striped`: [..., S, 32] -> [..., Mk]."""
    *lead, S, _ = t.shape
    return t.swapaxes(-1, -2).reshape(*lead, 32 * S)


def packed_stripes(trans: torch.Tensor) -> int:
    """The stripe width ``S`` of a packed ``fwd_trans`` or ``vit_trans``
    (either layout), 0 for the wide route's thread-major [P, SPT, 2, W,
    32, 4]."""
    if trans.dim() == 6:
        return 0
    return trans.shape[2] if trans.dim() == 4 else trans.shape[1]


def table_width(trans: torch.Tensor) -> int:
    """The model width ``Mk`` of a ``fwd_trans`` or ``vit_trans`` in any
    layout."""
    if trans.dim() == 6:
        return trans.shape[1] * trans.shape[3] * 32
    return 32 * packed_stripes(trans)


def unpacked(emis: torch.Tensor, trans: torch.Tensor):
    """The Forward or the Viterbi kernel's packed tables (``fwd_emis`` and
    ``fwd_trans``, or ``vit_emis`` and ``vit_trans``, in either layout)
    as plain [P, Kp, Mk] emission tables (M, I) and a [P, 8, Mk]
    transition table."""
    if trans.dim() == 6:                       # the wide route
        tr = thread_minor(trans.permute(0, 2, 5, 1, 3, 4))
        return (thread_minor(emis[..., 0]), thread_minor(emis[..., 1]),
                tr.reshape(trans.shape[0], 8, -1))
    if trans.dim() == 4:                       # the wide layout
        return (unstriped(emis[:, :, 0]), unstriped(emis[:, :, 1]),
                unstriped(trans))
    P, S = trans.shape[:2]
    tr = trans.swapaxes(2, 3).reshape(P, S, 32, 8)
    return (unstriped(emis[..., 0]), unstriped(emis[..., 1]),
            unstriped(tr.movedim(-1, 1)))


def packed(em: np.ndarray, ei: np.ndarray, tr: np.ndarray, wide_s: int):
    """[P, Kp, Mk] emission tables (M, I) and a [P, 8, Mk] transition
    table in the packed layouts (module docstring), the wide one from
    ``wide_s`` slots a lane on, thread-major on the wide route,
    contiguous."""
    P, _, Mk = em.shape
    if not stripe_width(Mk):
        nt, _ = cta_shape(Mk)
        emis = np.stack([thread_major(em, nt), thread_major(ei, nt)],
                        axis=-1)
        trans = thread_major(tr.reshape(P, 2, 4, Mk), nt).transpose(
            0, 3, 1, 4, 5, 2)
        return np.ascontiguousarray(emis), np.ascontiguousarray(trans)
    if Mk // 32 >= wide_s:
        emis = np.stack([striped(em), striped(ei)], axis=2)
        trans = striped(tr)
    else:
        emis = np.stack([striped(em), striped(ei)], axis=-1)
        trans = np.moveaxis(striped(tr), 1, -1).reshape(
            P, Mk // 32, 32, 2, 4).swapaxes(2, 3)
    return np.ascontiguousarray(emis), np.ascontiguousarray(trans)


def kernel_tables(f: dict) -> dict:
    """The stage kernels' tables (see the module docstring), padded to
    ``Mk = kernel_width(Mp)`` and striped (thread-major on the wide
    route), from the shared fields ``f``."""
    P, Kp, Mp = f["msc"].shape
    Mk = kernel_width(Mp)
    nonres = Kp - 2                   # Easel: '*' sits just below '~'

    cost = np.full((P, Kp, Mk), 255, dtype=np.int16)
    cost[:, :, :Mp] = f["msv_cost"]
    w16 = f["msv_bias"].astype(np.int16)[:, None, None] - cost
    scal = np.zeros((P, 4), dtype=np.float32)
    scal[:, 0] = f["msv_bias"]
    scal[:, 1] = f["msv_tec"]
    scal[:, 2] = f["msv_tbm"]
    odds = f["filter_odds"].astype(np.float32).copy()
    odds[:, nonres] = 0.0

    msc = np.full((P, Kp, Mk), NEGMASS, dtype=np.float32)
    isc = np.full((P, Kp, Mk), NEGMASS, dtype=np.float32)
    msc[:, :, :Mp] = f["msc"]
    isc[:, :, :Mp] = f["isc"]
    tr = np.full((P, 8, Mk), NEGMASS, dtype=np.float32)
    # into slot s from slot s-1 (slot 0 has no predecessor)
    tr[:, 0, 1:Mp] = f["tMM"][:, 1:Mp]
    tr[:, 1, 1:Mp] = f["tIM"][:, 1:Mp]
    tr[:, 2, 1:Mp] = f["tDM"][:, 1:Mp]
    tr[:, 3, :Mp] = f["tBM"]
    tr[:, 4, :Mp] = f["tMI"][:, 1:Mp + 1]
    tr[:, 5, :Mp] = f["tII"][:, 1:Mp + 1]
    # out of slot s into slot s+1, only where state s+2 exists
    live = f["kmask"][:, 1:Mp]
    tr[:, 6, :Mp - 1] = np.where(live, f["tMD"][:, 1:Mp], NEGMASS)
    tr[:, 7, :Mp - 1] = np.where(live, f["tDD"][:, 1:Mp], NEGMASS)
    tr = np.maximum(tr, NEGMASS)

    vit_emis, vit_trans = packed(msc, isc, tr, VIT_WIDE_S)
    fwd_emis, fwd_trans = packed(_xexp(msc), _xexp(isc), _xexp(tr),
                                 FWD_WIDE_S)
    w16 = (striped(w16) if stripe_width(Mk)
           else msv_thread_major(w16, msv_cta_shape(Mk)[0]))
    return {"msv_w16": np.ascontiguousarray(w16),
            "msv_scal": scal, "msv_odds": odds, "vit_emis": vit_emis,
            "vit_trans": vit_trans, "fwd_emis": fwd_emis,
            "fwd_trans": fwd_trans}


class ProfileBatch(nn.Module):
    """A stack of configured profiles sharing one padded model width
    ``Mp``: the shared fields (:data:`FIELDS`) as host numpy arrays, the
    kernel tables as buffers, so ``.to(device)`` moves them."""

    def __init__(self, profiles: Optional[Sequence] = None,
                 Mp: Optional[int] = None, *,
                 arrays: Optional[dict] = None):
        super().__init__()
        if arrays is None:
            arrays = pack_profiles(profiles, Mp)
        self.profiles = list(profiles) if profiles is not None else []
        self.P = int(arrays["msc"].shape[0])
        self.Kp = int(arrays["Kp"])
        self.Mp = int(arrays["Mp"])
        self.scale_b = float(arrays["scale_b"])
        self.M = arrays["kmask"].sum(axis=1).astype(np.int32)
        for name in FIELDS:
            setattr(self, name, np.ascontiguousarray(arrays[name]))
        for name, a in kernel_tables(arrays).items():
            self.register_buffer(name, torch.from_numpy(a))
        #: stripe width (0: the wide route) and kernel model width
        self.S = stripe_width(self.Mp)
        self.Mk = kernel_width(self.Mp)

    @property
    def device(self) -> torch.device:
        return self.msv_w16.device

    def arrays(self) -> dict:
        """The shared fields as numpy arrays (plus ``Mp``/``Kp``/
        ``scale_b``), the inverse of :func:`profile_batch_from_arrays`."""
        d = {n: getattr(self, n) for n in FIELDS}
        d.update(Mp=self.Mp, Kp=self.Kp, scale_b=self.scale_b)
        return d


def profile_batch_from_arrays(d: dict) -> ProfileBatch:
    """Build the port's ``ProfileBatch`` from the numpy fields of a JAX
    ``ProfileBatch`` (``{name: getattr(pb, name) for name in FIELDS}``
    plus ``Mp``, ``Kp`` and ``scale_b``), so both packages can be fed
    the same inputs."""
    arrays = {n: np.asarray(d[n]) for n in FIELDS}
    arrays["kmask"] = arrays["kmask"].astype(bool)
    for n in FIELDS:
        if n != "kmask":
            arrays[n] = arrays[n].astype(np.float32)
    P, Kp, Mp = arrays["msc"].shape
    arrays["Mp"] = int(d.get("Mp", Mp))
    arrays["Kp"] = int(d.get("Kp", Kp))
    arrays["scale_b"] = float(d["scale_b"])
    return ProfileBatch(arrays=arrays)


#: the profile-HMM fields :func:`hmm_arrays` carries besides the
#: alphabet's type code and ``M``
HMM_FIELDS = ("name", "t", "mat", "ins", "evparam", "cutoffs",
              "composition", "flags", "accession", "description",
              "consensus", "consensus_structure", "max_length")


def hmm_arrays(hmm) -> dict:
    """A profile HMM's fields (:data:`HMM_FIELDS`) as numpy arrays and
    plain values, plus ``alphabet`` (the type code) and ``M``: the
    inverse of :func:`hmm_from_arrays`."""
    d = {"alphabet": int(hmm.alphabet.type), "M": int(hmm.M)}
    for name in HMM_FIELDS:
        v = getattr(hmm, name)
        d[name] = np.array(v) if isinstance(v, np.ndarray) else v
    return d


def hmm_from_arrays(d: dict) -> HMM:
    """The port's ``HMM`` from the fields of :func:`hmm_arrays`, so the
    port and the JAX package can be fed the same model."""
    hmm = HMM(Alphabet.from_type(int(d["alphabet"])), int(d["M"]),
              name=bytes(d["name"]))
    hmm.t[...] = d["t"]
    hmm.mat[...] = d["mat"]
    hmm.ins[...] = d["ins"]
    hmm.evparam[:] = d["evparam"]
    hmm.cutoffs[:] = d["cutoffs"]
    if d["composition"] is not None:
        hmm.composition = np.array(d["composition"], dtype=np.float32)
    hmm.flags = int(d["flags"])
    for name in ("accession", "description", "consensus",
                 "consensus_structure", "max_length"):
        setattr(hmm, name, d[name])
    return hmm


def block_arrays(block) -> dict:
    """A digital sequence block as the alphabet's type code and, per
    sequence, its name, accession, description and uint8 codes: the
    inverse of :func:`block_from_arrays`."""
    return {"alphabet": int(block.alphabet.type),
            "names": [bytes(s.name) for s in block],
            "accessions": [bytes(s.accession) for s in block],
            "descriptions": [bytes(s.description) for s in block],
            "sequences": [np.array(s.sequence, np.uint8) for s in block]}


def block_from_arrays(d: dict) -> DigitalSequenceBlock:
    """The port's ``DigitalSequenceBlock`` from :func:`block_arrays`'
    fields."""
    alphabet = Alphabet.from_type(int(d["alphabet"]))
    return DigitalSequenceBlock(alphabet, [
        DigitalSequence(alphabet, name=n, accession=a, description=s,
                        sequence=q)
        for n, a, s, q in zip(d["names"], d["accessions"],
                              d["descriptions"], d["sequences"])])


def msv_nats(dx, ovf, tjbu: np.ndarray, scale_b: float) -> np.ndarray:
    """MSV scores in nats, float64 [P, B], from the MSV kernel's ``dx``
    and ``ovf`` [P, B] (host arrays), the lanes' ``tjb_units`` [B] and
    the batch's ``scale_b``: ``(dx - tjbu) / scale_b - 3``, inf where the
    uint8 DP overflowed (``pyhmmer_tpu/ops/batch.py:msv_scores``)."""
    usc = (np.asarray(dx, np.float64) - tjbu[None, :]) / scale_b - 3.0
    usc[np.asarray(ovf) > 0] = np.inf
    return usc


class SeqDevice:
    """One length bucket of target sequences on ``device``.

    ``codes`` [B, Lmax] uint8 (tails filled with the nonresidue code),
    ``lens`` [B] int32, the per-lane MSV move cost ``tjb`` [B], the bias
    filter's state-0 dwell ``p1`` [B], and the Forward/Viterbi length
    model ``lm`` [B, 4] (loop odds, move odds, their logs; pmove =
    3/(L+3)).  The host keeps the per-lane gate constants."""

    def __init__(self, codes: np.ndarray, lengths: np.ndarray,
                 nonres_code: Optional[int] = None, device="cpu"):
        self.device = torch.device(device)
        self.B, self.Lmax = codes.shape
        self.lengths = np.asarray(lengths)
        L = np.maximum(self.lengths.astype(np.float64), 1.0)
        self.codes = torch.as_tensor(np.ascontiguousarray(codes, np.uint8),
                                     device=self.device)
        self.lens = torch.as_tensor(self.lengths.astype(np.int32),
                                    device=self.device)
        scale = 3.0 / np.log(2.0)
        tjb = np.minimum(255, np.rint(-scale * np.log(3.0 / (L + 3.0))))
        self.tjb = torch.as_tensor(tjb.astype(np.float32),
                                   device=self.device)
        self.p1 = torch.as_tensor((L / (L + 1.0)).astype(np.float32),
                                  device=self.device)
        pmove = 3.0 / (L + 3.0)
        lm = np.stack([1.0 - pmove, pmove, np.log1p(-pmove),
                       np.log(pmove)], axis=1)
        self.lm = torch.as_tensor(lm.astype(np.float32), device=self.device)
        #: lanes with a nonresidue code inside the sequence: the fused
        #: device bias filter freezes on it, the exact host filter does
        #: not, so such lanes always take the host bias path
        if nonres_code is None:
            self.has_nonres = np.zeros(self.B, dtype=bool)
        else:
            mask = np.arange(self.Lmax)[None, :] < self.lengths[:, None]
            self.has_nonres = ((codes == nonres_code) & mask).any(axis=1)
        self.nullsc_host = (L * np.log(L / (L + 1.0))
                            + np.log(1.0 / (L + 1.0)))
        self.tjbu_host = tjb_units(np.maximum(self.lengths, 1))
