"""Faithful executable specification of the paper's Algorithms 1-6
(PyTorch port of ``core/simulator.py``).

Every process's program (lookup / insert / delete, in both the LL/SC and the
CAS variant) is hand-compiled into a *memory-operation-site* state machine:
each site performs exactly one shared-memory primitive (the paper's model —
"each step consists of some local computation, followed by a single primitive
operation on the shared memory"), and the post-logic of the site folds all
local computation up to the next primitive.  The site map, the memop kinds
and the 26 post-transitions are the reference's, site for site.

Where the state lives.  The shared memory (``table``, the CAS ``owner``
words, the LL/SC ``ver`` counters), every process's registers and the
results are tensors on ``device`` (the card unless ``"cpu"``).  The
reference runs ``lax.switch(pc, posts)`` under ``jit`` + ``lax.scan``;
eager PyTorch dispatches on the site from the host instead: each event
reads the scheduled process's register row once (``device.host_numpy``,
one counted host sync) and runs only that site's post.  Every condition on
the registers is then a host branch; every condition on what the memory
primitive returned (the value and owner read, SC/CAS success) stays on the
device as a ``torch.where`` between whole register rows.  A process at
``HALT`` stays there, so once its row has read ``HALT`` its later events
cost no sync: they only advance the event counter, as in the reference.

Integer state equals the reference's bit for bit (``tests/
test_torch_simulator.py``): the table holds the reference's uint32 cell
words as int32 (every word is below 2^30, ``core/encoding``), and ``v``,
``val`` and ``cur`` likewise.

Site map (pseudocode line numbers refer to the paper):

  FS_READ        Alg.1 l.2/11    Read(table[i])        forward scan
  BS_READ        Alg.1 l.16      Read(table[i])        backward scan
  VC_MOD         Alg.4 l.93      Modify(i, val -> <v,revalidate>)
  VC_READ        Alg.4 l.94      plain read table[i]
  TD_MOD_TOMB    Alg.4 l.86      Modify(i, <v,final> -> TOMBSTONE)
  TD_MOD_DEL     Alg.4 l.88      Modify(i, val -> DELETED)
  TD_READ        Alg.4 l.89      Read(table[i])
  I_READ_CLAIM   Alg.3 l.41/46   Read(table[j])        claim loop
  I_MOD_CLAIM    Alg.3 l.43      Modify(j, val -> <v,tentative>)
  I_READ_SCAN    Alg.3 l.48/65   Read(table[i])        duplicate scan
  I_READ_OWN     Alg.3 l.66      Read(table[j])
  I_MOD_FINAL    Alg.3 l.67      Modify(j, cur -> <v,final>)
  I_MOD_RESTART  Alg.3 l.58/69   Modify(j, cur -> <v,tentative>)
  I_READ_OWN2    Alg.3 l.57      Read(table[j])
  DC_READ        Alg.4 l.76      Read(table[j])        del_copy
  DC_MOD_REVAL   Alg.4 l.78      Modify(j, <v,reval> -> <v,tentative>)
  DC_READ2       Alg.4 l.79      Read(table[j])
  DC_MOD_TOMB    Alg.4 l.80      Modify(j, val -> TOMBSTONE)
  -- LL/SC del_other_copy (Alg.5):
  DOC_READ_OWN   l.102           plain read table[j]
  DOC_SC         l.104           SC(table[i], COLLIDED)
  DOC_READ_I     l.105           plain read table[i]
  -- CAS del_other_copy (Alg.6):
  DOC_CAS_MARK   l.116           CAS(table[i], val -> <<v,j>,marked>)
  DOC_READ_I2    l.117           plain read table[i]
  DOC_READ_OWN_C l.120           plain read table[j]
  DOC_CAS_COLL   l.122           CAS(table[i], marked -> COLLIDED)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import encoding as E
from repro_torch.core import hashing as H
from repro_torch.core.spec import (OP_DELETE, OP_INSERT, OP_LOOKUP, OP_NONE,
                                   RET_ABORT, RET_FALSE, RET_PENDING,
                                   RET_TRUE)
from repro_torch.device import host_numpy, resolve_device

# ---------------------------------------------------------------------------
# Sites.
FS_READ = 0
BS_READ = 1
VC_MOD = 2
VC_READ = 3
TD_MOD_TOMB = 4
TD_MOD_DEL = 5
TD_READ = 6
I_READ_CLAIM = 7
I_MOD_CLAIM = 8
I_READ_SCAN = 9
I_READ_OWN = 10
I_MOD_FINAL = 11
I_MOD_RESTART = 12
I_READ_OWN2 = 13
DC_READ = 14
DC_MOD_REVAL = 15
DC_READ2 = 16
DC_MOD_TOMB = 17
DOC_READ_OWN = 18
DOC_SC = 19
DOC_READ_I = 20
DOC_CAS_MARK = 21
DOC_READ_I2 = 22
DOC_READ_OWN_C = 23
DOC_CAS_COLL = 24
HALT = 25
NUM_SITES = 26

CONT_FS = 0
CONT_BS = 1

# memop kinds
MEM_NONE = 0
MEM_READ_KW = 1    # the paper's Read keyword: LL (llsc) / plain read (cas)
MEM_MODIFY = 2     # the paper's Modify keyword: SC (llsc) / CAS (cas)
MEM_PLAIN_READ = 3
MEM_SC = 4         # explicit SC (Alg.5 l.104)
MEM_CAS = 5        # explicit CAS (Alg.6)

MODE_LLSC = "llsc"
MODE_CAS = "cas"


class Regs(NamedTuple):
    """Every process's registers, one int32[P] tensor per field (``v``,
    ``val`` and ``cur`` hold the reference's uint32 values)."""
    pc: torch.Tensor
    opidx: torch.Tensor
    v: torch.Tensor
    hv: torch.Tensor
    i: torch.Tensor
    j: torch.Tensor
    val: torch.Tensor
    val_o: torch.Tensor
    cur: torch.Tensor
    cur_o: torch.Tensor
    cont: torch.Tensor
    ll_cell: torch.Tensor
    ll_ver: torch.Tensor
    fresh: torch.Tensor
    op: torch.Tensor


class SimState(NamedTuple):
    table: torch.Tensor    # int32[m]  cell words
    owner: torch.Tensor    # int32[m]  (CAS marked owner; NO_OWNER otherwise)
    ver: torch.Tensor      # int32[m]  (write counter: LL/SC validity)
    regs: Regs
    results: torch.Tensor  # int32[P,K]
    t_inv: torch.Tensor    # int32[P,K]
    t_rsp: torch.Tensor    # int32[P,K]
    steps: torch.Tensor    # int32[P,K] memops consumed per op
    t: torch.Tensor        # int32 global event counter
    pair_ok: torch.Tensor  # bool — LL/SC proper-pairing assertion
    inv_ok: torch.Tensor   # bool — Lemma 4 + Prop 3 monitors (if enabled)


class PRegs(NamedTuple):
    """One process's registers as read on the host, and the two transition
    outputs; the field order is the register row's on the device."""
    pc: int
    opidx: int
    v: int
    hv: int
    i: int
    j: int
    val: int
    val_o: int
    cur: int
    cur_o: int
    cont: int
    ll_cell: int
    ll_ver: int
    fresh: int
    op: int
    # transition outputs:
    complete: int
    retval: int


F = {name: k for k, name in enumerate(PRegs._fields)}
N_REGS = len(Regs._fields)


class _Event:
    """One scheduled event of one process, inside a post-transition.

    ``h`` is the process's register row as read on the host at the event's
    start (with the memop's LL/SC bookkeeping applied), ``d`` the same row
    on the device; ``rval``/``ro`` are what the memory primitive read
    (device scalars) and ``success`` whether its SC/CAS wrote (a device
    bool, or the host's ``False`` where it cannot).  A post returns the
    next register row as a device tensor; ``mk`` builds one from ``d``,
    ``sel`` picks between two on a device condition."""

    def __init__(self, h: PRegs, d: torch.Tensor, rval, ro, success,
                 next_op: dict):
        self.h, self.d = h, d
        self.rval, self.ro, self.success = rval, ro, success
        self.next_op = next_op
        self.completes = False

    def mk(self, **kw) -> torch.Tensor:
        out = self.d.clone()
        for k, x in kw.items():
            out[F[k]] = x
        return out

    def complete(self, ret) -> torch.Tensor:
        """The reference's ``_complete`` followed by its ``_setup_op`` of
        the next op, which ``make_step`` applies to every completing row."""
        self.completes = True
        return self.mk(**{"complete": 1, "retval": ret, "pc": HALT,
                          **self.next_op})

    @staticmethod
    def sel(c, a, b):
        if isinstance(c, bool):
            return a if c else b
        return torch.where(c, a, b)

    def haskey(self):
        return E.dec_key(self.rval) == self.h.v


# --- scan-resumption helpers -------------------------------------------------

def _enter_bs(ev: _Event, idx: int):
    return ev.mk(cont=CONT_BS, i=idx, pc=BS_READ)


def _after_bs(ev: _Event):
    """backward_scan returned ⊥ (back at h(v)) — dispatch per op type."""
    if ev.h.op == OP_INSERT:
        return ev.mk(j=ev.h.hv, pc=I_READ_CLAIM)
    return ev.complete(RET_FALSE)


def _resume_scan(ev: _Event, m: int):
    """Helper (validate_copy/try_delete) said "not found, keep scanning"."""
    h = ev.h
    if h.cont == CONT_FS:
        # forward: i+=1; if i==hv: break -> bs starts at i-1 (mod m)
        i2 = (h.i + 1) % m
        if i2 == h.hv:
            return _enter_bs(ev, (h.hv - 1 + m) % m)
        return ev.mk(i=i2, pc=FS_READ)
    # backward: if i==hv: return ⊥; else i-=1
    if h.i == h.hv:
        return _after_bs(ev)
    return ev.mk(i=(h.i - 1 + m) % m, pc=BS_READ)


def _scan_found_true(ev: _Event):
    """forward/backward scan "found the key" (validate_copy true):
    lookup returns true, insert returns false."""
    return ev.complete(RET_TRUE if ev.h.op == OP_LOOKUP else RET_FALSE)


def _vc_entry(ev: _Event):
    """validate_copy(v, val, i) local prefix (Alg.4 l.92): called with the
    freshly read val; caller is insert/lookup during a scan."""
    hit = (ev.rval == E.enc_final(ev.h.v)) | \
        (ev.rval == E.enc_revalidate(ev.h.v))
    go_mod = ev.mk(val=ev.rval, val_o=ev.ro, pc=VC_MOD)
    return ev.sel(hit, _scan_found_true(ev), go_mod)


def _td_entry(ev: _Event):
    """try_delete local prefix (Alg.4 l.84-88), val freshly read,
    contains v."""
    fin = ev.rval == E.enc_final(ev.h.v)
    tomb = ev.mk(val=ev.rval, val_o=ev.ro, pc=TD_MOD_TOMB)
    dele = ev.mk(val=ev.rval, val_o=ev.ro, pc=TD_MOD_DEL)
    return ev.sel(fin, tomb, dele)


def _helper(ev: _Event):
    """The scan found a cell containing v: try_delete for a delete,
    validate_copy otherwise."""
    return _td_entry(ev) if ev.h.op == OP_DELETE else _vc_entry(ev)


def _advance_dedup(ev: _Event, m: int):
    """dedup scan: i+=1; full cycle -> finalize own copy (l.63-66)."""
    i2 = (ev.h.i + 1) % m
    if i2 == ev.h.hv:
        return ev.mk(pc=I_READ_OWN)
    return ev.mk(i=i2, pc=I_READ_SCAN)


def _claim_next(ev: _Event, m: int):
    """Claim loop: next cell, or ABORT after a full cycle (Alg.3 l.46)."""
    j2 = (ev.h.j + 1) % m
    if j2 == ev.h.hv:
        return ev.complete(RET_ABORT)
    return ev.mk(j=j2, pc=I_READ_CLAIM)


# ---------------------------------------------------------------------------
# The per-site memop specification.

_KINDS = (
    MEM_READ_KW,   # FS_READ
    MEM_READ_KW,   # BS_READ
    MEM_MODIFY,    # VC_MOD
    MEM_PLAIN_READ,  # VC_READ
    MEM_MODIFY,    # TD_MOD_TOMB
    MEM_MODIFY,    # TD_MOD_DEL
    MEM_READ_KW,   # TD_READ
    MEM_READ_KW,   # I_READ_CLAIM
    MEM_MODIFY,    # I_MOD_CLAIM
    MEM_READ_KW,   # I_READ_SCAN
    MEM_READ_KW,   # I_READ_OWN
    MEM_MODIFY,    # I_MOD_FINAL
    MEM_MODIFY,    # I_MOD_RESTART
    MEM_READ_KW,   # I_READ_OWN2
    MEM_READ_KW,   # DC_READ
    MEM_MODIFY,    # DC_MOD_REVAL
    MEM_READ_KW,   # DC_READ2
    MEM_MODIFY,    # DC_MOD_TOMB
    MEM_PLAIN_READ,  # DOC_READ_OWN
    MEM_SC,        # DOC_SC
    MEM_PLAIN_READ,  # DOC_READ_I
    MEM_CAS,       # DOC_CAS_MARK
    MEM_PLAIN_READ,  # DOC_READ_I2
    MEM_PLAIN_READ,  # DOC_READ_OWN_C
    MEM_CAS,       # DOC_CAS_COLL
    MEM_NONE,      # HALT
)
# sites on table[j] (the rest act on table[i])
_ON_J = frozenset({I_READ_CLAIM, I_MOD_CLAIM, I_READ_OWN, I_MOD_FINAL,
                   I_MOD_RESTART, I_READ_OWN2, DC_READ, DC_MOD_REVAL,
                   DC_READ2, DC_MOD_TOMB, DOC_READ_OWN, DOC_READ_OWN_C})


def memop_spec(r: PRegs, mode: str):
    """Return (kind, cell, oldv, oldo, newv, newo) for the process's pc, as
    host ints (``mode`` does not enter: the kind says which primitive the
    mode runs)."""
    pc = r.pc
    kind = _KINDS[pc]
    cell = r.j if pc in _ON_J else r.i
    # old value for Modify/CAS sites: val-based or cur-based
    if pc in (I_MOD_FINAL, I_MOD_RESTART):
        oldv, oldo = r.cur, r.cur_o
    else:
        oldv, oldo = r.val, r.val_o
    if pc == DOC_CAS_COLL:    # old = <<v,j>,marked>
        oldv, oldo = E.enc_marked(r.v), r.j
    newv = {VC_MOD: E.enc_revalidate(r.v), TD_MOD_TOMB: E.TOMBSTONE,
            TD_MOD_DEL: E.DELETED, I_MOD_CLAIM: E.enc_tentative(r.v),
            I_MOD_FINAL: E.enc_final(r.v),
            I_MOD_RESTART: E.enc_tentative(r.v),
            DC_MOD_REVAL: E.enc_tentative(r.v), DC_MOD_TOMB: E.TOMBSTONE,
            DOC_SC: E.COLLIDED, DOC_CAS_MARK: E.enc_marked(r.v),
            DOC_CAS_COLL: E.COLLIDED}.get(pc, E.EMPTY)
    newo = r.j if pc == DOC_CAS_MARK else E.NO_OWNER
    return kind, cell, oldv, oldo, newv, newo


def exec_memop(mem: torch.Tensor, r: PRegs, kind, cell, oldv, oldo, newv,
               newo, mode: str):
    """Execute the memory primitive on ``mem`` (int32[3, m]: the table, the
    owner words and the version counters), in place.  Returns (rval, ro,
    success, ll_cell, ll_ver, pair_ok, did_mem): what was read (device
    scalars), whether an SC/CAS wrote (a device bool, or ``False`` where
    the host knows it cannot), the LL reservation after the primitive
    (``ll_ver`` a device scalar right after an LL), the proper-pairing
    assertion and whether the event touched memory."""
    cur = mem[:, cell].clone()           # value, owner, version
    cur_v, cur_o, cur_ver = cur[0], cur[1], cur[2]

    if mode == MODE_LLSC:
        # Read keyword = LL; Modify keyword = SC; explicit SC site too.
        do_ll = kind == MEM_READ_KW
        do_sc = kind in (MEM_MODIFY, MEM_SC)
        do_cas = kind == MEM_CAS   # never true in llsc programs
    else:
        do_ll = False
        do_sc = kind == MEM_SC     # never true in cas programs
        do_cas = kind in (MEM_MODIFY, MEM_CAS)

    # LL: record reservation
    ll_cell, ll_ver = (cell, cur_ver) if do_ll else (r.ll_cell, r.ll_ver)

    # SC: succeeds iff reservation matches this cell and version unchanged
    sc_paired = r.ll_cell == cell
    pair_ok = not (do_sc and not sc_paired)   # proper-pairing assertion
    success = False
    if do_sc and sc_paired:
        success = cur_ver == r.ll_ver
    if do_cas:
        # value (and owner for marked words) comparison
        success = cur_v == oldv
        if E.is_marked(oldv):
            success = success & (cur_o == oldo)

    if not isinstance(success, bool):
        mem[0, cell] = torch.where(success, newv, cur_v)
        mem[1, cell] = torch.where(success, newo, cur_o)
        mem[2, cell] = cur_ver + success

    # SC consumes the reservation (success or failure)
    if do_sc:
        ll_cell = -1
    return cur_v, cur_o, success, ll_cell, ll_ver, pair_ok, kind != MEM_NONE


# ---------------------------------------------------------------------------
# Per-site post-transitions.

def make_post(mode: str, m: int):
    """Build the list of post-transition functions, one per site.

    Each takes the event (``_Event``: the registers, what the primitive
    read, whether it wrote) and returns the next register row."""

    def fs_read(ev):
        h = ev.h
        empty = ev.rval == E.EMPTY
        # empty: exit forward scan (Alg.1 l.12-13)
        exit_fs = _enter_bs(ev, h.i if h.i == h.hv else (h.i - 1 + m) % m)
        # else advance (l.9-11); wrap -> break -> bs starts at i-1 == hv-1
        i2 = (h.i + 1) % m
        adv = (_enter_bs(ev, (h.hv - 1 + m) % m) if i2 == h.hv
               else ev.mk(i=i2, pc=FS_READ))
        # found key: dispatch helper
        return ev.sel(empty, exit_fs, ev.sel(ev.haskey(), _helper(ev), adv))

    def bs_read(ev):
        h = ev.h
        adv = (_after_bs(ev) if h.i == h.hv
               else ev.mk(i=(h.i - 1 + m) % m, pc=BS_READ))
        return ev.sel(ev.haskey(), _helper(ev), adv)

    def vc_mod(ev):
        # Alg.4 l.93: success -> validate_copy true
        return ev.sel(ev.success, _scan_found_true(ev), ev.mk(pc=VC_READ))

    def vc_read(ev):
        # Alg.4 l.94-96
        return ev.sel(ev.haskey(), _scan_found_true(ev), _resume_scan(ev, m))

    def td_mod_tomb(ev):
        # Alg.4 l.86: try_delete returns Modify(...) result; delete returns it
        return ev.complete(ev.sel(ev.success, RET_TRUE, RET_FALSE))

    def td_mod_del(ev):
        return ev.sel(ev.success, ev.complete(RET_TRUE), ev.mk(pc=TD_READ))

    def td_read(ev):
        return ev.sel(ev.haskey(), _td_entry(ev), _resume_scan(ev, m))

    def i_read_claim(ev):
        claim = ev.mk(val=ev.rval, val_o=ev.ro, pc=I_MOD_CLAIM)
        return ev.sel(E.is_available(ev.rval), claim, _claim_next(ev, m))

    def i_mod_claim(ev):
        scan = ev.mk(i=ev.h.hv, pc=I_READ_SCAN)
        return ev.sel(ev.success, scan, _claim_next(ev, m))

    def i_read_scan(ev):
        h = ev.h
        rval, ro = ev.rval, ev.ro
        empty = rval == E.EMPTY
        # relevant: another cell containing v
        relevant = False if h.i == h.j else ev.haskey()
        to_own = ev.mk(pc=I_READ_OWN)
        advance = _advance_dedup(ev, m)

        closer = H.probe_distance(h.i, h.hv, m) < \
            H.probe_distance(h.j, h.hv, m)
        # l.51-53: other copy earlier or final -> del_copy(v, j)
        give_up = ev.mk(pc=DC_READ)
        closer_or_final = True if closer else rval == E.enc_final(h.v)
        is_reval = rval == E.enc_revalidate(h.v)
        # l.55: val != revalidate -> del_other_copy
        if mode == MODE_LLSC:
            doc = ev.mk(val=rval, val_o=ro, pc=DOC_READ_OWN)
        else:
            marked_v = E.is_marked(rval) & (E.dec_key(rval) == h.v)
            other_mark = marked_v & (ro != h.j)   # l.114: return true
            own_mark = marked_v & (ro == h.j)
            go_own = ev.mk(val=rval, val_o=ro, pc=DOC_READ_OWN_C)
            go_cas = ev.mk(val=rval, val_o=ro, pc=DOC_CAS_MARK)
            doc = ev.sel(other_mark, advance, ev.sel(own_mark, go_own, go_cas))
        dup = ev.sel(closer_or_final, give_up, ev.sel(~is_reval, doc, advance))
        return ev.sel(empty, to_own, ev.sel(relevant, dup, advance))

    def i_read_own(ev):
        # Alg.3 l.66
        tent = ev.rval == E.enc_tentative(ev.h.v)
        rst = E.restart(ev.rval) & ev.haskey()
        fin = ev.mk(cur=ev.rval, cur_o=ev.ro, pc=I_MOD_FINAL)
        restart_ = ev.mk(cur=ev.rval, cur_o=ev.ro, pc=I_MOD_RESTART)
        return ev.sel(tent, fin, ev.sel(rst, restart_, ev.mk(pc=DC_READ)))

    def i_mod_final(ev):
        # l.67-68; on failure fall to l.69 with stale cur (tentative) ->
        # restart(cur) false -> del_copy (l.71)
        return ev.sel(ev.success, ev.complete(RET_TRUE), ev.mk(pc=DC_READ))

    def i_mod_restart(ev):
        rescan = ev.mk(i=ev.h.hv, pc=I_READ_SCAN)
        return ev.sel(ev.success, rescan, ev.mk(pc=DC_READ))

    def i_read_own2(ev):
        # Alg.3 l.57-58
        rst = E.restart(ev.rval) & ev.haskey()
        return ev.sel(rst, ev.mk(cur=ev.rval, cur_o=ev.ro, pc=I_MOD_RESTART),
                      ev.mk(pc=DC_READ))

    def dc_read(ev):
        rev = ev.rval == E.enc_revalidate(ev.h.v)
        return ev.sel(rev, ev.mk(val=ev.rval, val_o=ev.ro, pc=DC_MOD_REVAL),
                      ev.mk(val=ev.rval, val_o=ev.ro, pc=DC_MOD_TOMB))

    def dc_mod_reval(ev):
        rescan = ev.mk(i=ev.h.hv, pc=I_READ_SCAN)  # del_copy returned ⊥
        return ev.sel(ev.success, rescan, ev.mk(pc=DC_READ2))

    def dc_read2(ev):
        return ev.mk(val=ev.rval, val_o=ev.ro, pc=DC_MOD_TOMB)

    def dc_mod_tomb(ev):
        was_deleted = ev.h.val == E.DELETED
        done = ev.complete(RET_TRUE if was_deleted else RET_FALSE)
        return ev.sel(ev.success, done, ev.mk(pc=DC_READ))

    # ---- LL/SC del_other_copy ----
    def doc_read_own(ev):
        tent = ev.rval == E.enc_tentative(ev.h.v)
        return ev.sel(tent, ev.mk(cur=ev.rval, cur_o=ev.ro, pc=DOC_SC),
                      ev.mk(pc=I_READ_OWN2))  # return false -> l.56-57

    def doc_sc(ev):
        return ev.sel(ev.success, _advance_dedup(ev, m),
                      ev.mk(pc=DOC_READ_I))

    def doc_read_i(ev):
        fin = ev.rval == E.enc_final(ev.h.v)
        return ev.sel(fin, ev.mk(pc=I_READ_OWN2), _advance_dedup(ev, m))

    # ---- CAS del_other_copy ----
    def doc_cas_mark(ev):
        return ev.sel(ev.success, ev.mk(pc=DOC_READ_OWN_C),
                      ev.mk(pc=DOC_READ_I2))

    def doc_read_i2(ev):
        fin = ev.rval == E.enc_final(ev.h.v)
        return ev.sel(fin, ev.mk(pc=I_READ_OWN2), _advance_dedup(ev, m))

    def doc_read_own_c(ev):
        tent = ev.rval == E.enc_tentative(ev.h.v)
        return ev.sel(tent, ev.mk(cur=ev.rval, cur_o=ev.ro, pc=DOC_CAS_COLL),
                      ev.mk(pc=I_READ_OWN2))

    def doc_cas_coll(ev):
        # l.122-123: CAS result ignored; return true
        return _advance_dedup(ev, m)

    def halt(ev):
        return ev.d.clone()

    return [fs_read, bs_read, vc_mod, vc_read, td_mod_tomb, td_mod_del,
            td_read, i_read_claim, i_mod_claim, i_read_scan, i_read_own,
            i_mod_final, i_mod_restart, i_read_own2, dc_read, dc_mod_reval,
            dc_read2, dc_mod_tomb, doc_read_own, doc_sc, doc_read_i,
            doc_cas_mark, doc_read_i2, doc_read_own_c, doc_cas_coll, halt]


# ---------------------------------------------------------------------------
# Invariant monitors (Lemma 4 / Proposition 3), O(m^2) — for small-m tests.

def check_invariants(table: torch.Tensor, m: int, hash_seed: int):
    keys = E.dec_key(table)
    is_key = keys != E.RESERVED_KEY
    is_final = is_key & (E.dec_tag(table) == E.TAG_FINAL)
    # Lemma 4: at most one <v, final> per key
    eq = keys[:, None] == keys[None, :]
    both_final = is_final[:, None] & is_final[None, :]
    off_diag = ~torch.eye(m, dtype=torch.bool, device=table.device)
    lemma4 = ~torch.any(eq & both_final & off_diag)
    # Proposition 3: cells between h(v) and a cell containing v are non-empty
    hv = H.hash_keys(keys, m, hash_seed)
    idx = torch.arange(m, dtype=torch.int32, device=table.device)
    dist_cell = H.probe_distance(idx, hv, m)   # dist of cell c from h(key_c)
    # for cell c with key: no EMPTY cell e with
    # dist(e, h(key_c)) < dist(c, h(key_c))
    dist_e = H.probe_distance(idx[None, :], hv[:, None], m)  # [c, e]
    empty = (table == E.EMPTY)[None, :]
    hole = empty & (dist_e < dist_cell[:, None])
    prop3 = ~torch.any(is_key[:, None] & hole)
    return lemma4 & prop3


# ---------------------------------------------------------------------------
# Top-level simulation.

class Workload(NamedTuple):
    op: np.ndarray   # int32[P,K]  (OP_* or OP_NONE)
    key: np.ndarray  # uint32[P,K]


class Simulation:
    """One simulated run: the shared memory, the registers and the
    bookkeeping of ``SimState``, updated in place by ``step``.

    ``Simulation(...).state()`` is the reference's ``init_state``, and
    ``step(p)`` is one application of the step function its
    ``make_step`` builds: one scheduled event of process ``p``."""

    def __init__(self, mode: str, m: int, hash_seed: int, wl_op, wl_key,
                 check_inv: bool = False, device=None):
        if mode not in (MODE_LLSC, MODE_CAS):
            raise ValueError(f"unknown mode {mode!r}")
        dev = resolve_device(device)
        self.mode, self.m, self.hash_seed = mode, m, hash_seed
        self.check_inv = check_inv
        self.posts = make_post(mode, m)
        self.wl_op = np.asarray(wl_op, dtype=np.int64)
        self.wl_key = np.asarray(wl_key).astype(np.int64)
        P, K = self.wl_op.shape
        self.P, self.K = P, K
        self.hv = H.hash_keys(torch.from_numpy(self.wl_key), m,
                              hash_seed).numpy()
        i32 = dict(dtype=torch.int32, device=dev)
        # mem rows: the table, the CAS owner words, the LL/SC versions
        self.mem = torch.stack([
            torch.full((m,), E.EMPTY, **i32),
            torch.full((m,), E.NO_OWNER, **i32),
            torch.zeros((m,), **i32)])
        # register rows [P, 17]; the two transition outputs rest at
        # (0, RET_PENDING), the values a post starts from
        rows = []
        for p in range(P):
            r = dict.fromkeys(PRegs._fields, 0)
            r.update(ll_cell=-1, retval=RET_PENDING)
            r.update(self._setup_op(p, 0))
            rows.append([r[f] for f in PRegs._fields])
        self.regs = torch.tensor(rows, **i32)
        self.results = torch.full((P, K), RET_PENDING, **i32)
        self.t_inv = torch.full((P, K), -1, **i32)
        self.t_rsp = torch.full((P, K), -1, **i32)
        self.steps = torch.zeros((P, K), **i32)
        self.t = 0
        self.pair_ok = True
        self.inv_ok = torch.ones((), dtype=torch.bool, device=dev)
        self.halted = set()
        self.active_events = 0

    def _setup_op(self, p: int, opidx: int) -> dict:
        """Register fields for the op at ``opidx`` (or HALT)."""
        if opidx < self.K and self.wl_op[p, opidx] != OP_NONE:
            hv = int(self.hv[p, opidx])
            return dict(opidx=opidx, op=int(self.wl_op[p, opidx]),
                        v=int(self.wl_key[p, opidx]), hv=hv, i=hv,
                        cont=CONT_FS, pc=FS_READ, fresh=1, ll_cell=-1,
                        ll_ver=0)
        return dict(opidx=opidx, pc=HALT, op=OP_NONE)

    def step(self, p: int) -> None:
        t = self.t
        self.t += 1
        if p in self.halted:
            return
        h = PRegs(*host_numpy(self.regs[p]).tolist())
        if h.pc == HALT:       # no primitive, no post; HALT is final
            self.halted.add(p)
            return
        self.active_events += 1
        row = self.regs[p]
        opi = min(max(h.opidx, 0), self.K - 1)

        # record invocation time lazily
        if h.fresh == 1:
            self.t_inv[p, opi] = t
            row[F["fresh"]] = 0
            h = h._replace(fresh=0)

        kind, cell, oldv, oldo, newv, newo = memop_spec(h, self.mode)
        cell = min(max(cell, 0), self.m - 1)
        rval, ro, success, ll_cell, ll_ver, pair_ok, did_mem = exec_memop(
            self.mem, h, kind, cell, oldv, oldo, newv, newo, self.mode)
        if ll_cell != h.ll_cell:
            row[F["ll_cell"]] = ll_cell
        if isinstance(ll_ver, torch.Tensor):
            row[F["ll_ver"]] = ll_ver
        h = h._replace(ll_cell=ll_cell)   # posts never read ll_ver
        self.pair_ok = self.pair_ok and pair_ok

        # step accounting
        if did_mem:
            self.steps[p, opi] += 1

        ev = _Event(h, row, rval, ro, success, self._setup_op(p, h.opidx + 1))
        new = self.posts[h.pc](ev)

        # completion: results[p, opi] and t_rsp[p, opi] are still at their
        # initial values here (an op completes once, then its process
        # moves on), so a row that did not complete writes those back
        if ev.completes:
            self.results[p, opi] = new[F["retval"]]
            self.t_rsp[p, opi] = torch.where(new[F["complete"]] == 1, t, -1)
        self.regs[p, :N_REGS] = new[:N_REGS]
        # the table changes only under an SC/CAS; an unchanged table keeps
        # the monitors' last verdict
        if self.check_inv and not isinstance(success, bool):
            self.inv_ok &= check_invariants(self.mem[0], self.m,
                                            self.hash_seed)

    def run(self, schedule) -> None:
        schedule = np.asarray(schedule, dtype=np.int64)
        for n, p in enumerate(schedule.tolist()):
            if len(self.halted) == self.P:   # every event left is a no-op
                self.t += len(schedule) - n
                return
            self.step(p)

    def state(self) -> SimState:
        dev = self.mem.device
        return SimState(
            table=self.mem[0].clone(), owner=self.mem[1].clone(),
            ver=self.mem[2].clone(),
            regs=Regs(*(self.regs[:, k].clone() for k in range(N_REGS))),
            results=self.results.clone(), t_inv=self.t_inv.clone(),
            t_rsp=self.t_rsp.clone(), steps=self.steps.clone(),
            t=torch.tensor(self.t, dtype=torch.int32, device=dev),
            pair_ok=torch.tensor(self.pair_ok, device=dev),
            inv_ok=self.inv_ok.clone())


def init_state(mode: str, m: int, hash_seed: int, wl_op, wl_key,
               device=None) -> SimState:
    return Simulation(mode, m, hash_seed, wl_op, wl_key,
                      device=device).state()


def simulate(wl: Workload, m: int, schedule, mode: str = MODE_LLSC,
             hash_seed: int = 0, check_inv: bool = False,
             device=None) -> SimState:
    """Run a full simulation: ``schedule`` is an int32[T] array of process
    ids (one shared-memory event each).  ``device=None`` is the card."""
    sim = Simulation(mode, m, hash_seed, wl.op, wl.key, check_inv, device)
    sim.run(schedule)
    return sim.state()


def history_arrays(state: SimState, wl: Workload):
    """Extract (proc, opidx, op, key, ret, t_inv, t_rsp) rows of all
    invoked operations, for the linearizability checker."""
    op = np.asarray(wl.op)
    key = np.asarray(wl.key)
    res = state.results.cpu().numpy()
    t_inv = state.t_inv.cpu().numpy()
    t_rsp = state.t_rsp.cpu().numpy()
    P, K = op.shape
    rows = []
    for p in range(P):
        for k in range(K):
            if op[p, k] == OP_NONE or t_inv[p, k] < 0:
                continue
            rows.append((p, k, int(op[p, k]), int(key[p, k]), int(res[p, k]),
                         int(t_inv[p, k]), int(t_rsp[p, k])))
    return rows
