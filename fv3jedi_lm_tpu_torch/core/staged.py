"""Checkpointed split-linearization tangent-linear and adjoint sweeps.

Counterpart of fv3jedi_lm_tpu/core/staged.py (the reference's TLM/ADM
architecture, fv3jedi_lm_dynamics_mod.F90:347-633), in its per-stage
"split" form, run eagerly:

* `forward` — the nonlinear step, keeping every stage input: the k_split
  interface states and each acoustic substep's input carry, pruned to what
  the substep reads (the Tapenade "push").
* `record` — the MIXED (trajectory-value / perturbation-derivative) stages
  run once at the stored checkpoints under `freeze.recording`; their branch
  decisions (upwind masks, limiter switches, remap indices) become the
  tapes (the reference's PUSHCONTROL bits, stored as data).
* `tl` — `torch.func.jvp` of each mixed stage at its stored checkpoint,
  with the decisions replayed from the tapes.
* `ad` — the vjp of each stage, by `torch.autograd.grad` on the stage
  recomputed from its stored input with the tapes replayed: per acoustic
  substep stages a and b are recomputed, then c, b and a are transposed in
  turn, so only one stage's autograd graph is alive at a time (the
  reference's POP-per-iteration discipline, fv3jedi_lm_dynamics_mod.F90:
  588-633).

Because TL and AD linearize at the same stored values with the same branch
decisions, <M dx, dy> == <dx, M^T dy> holds to the rounding of the sweeps.
`.detach()` plays the part of the JAX package's `lax.stop_gradient`.

The JAX package's fused, substep and mixed executable forms (FV3LM_TL /
FV3LM_AD) exist for its remote-TPU dispatch costs and are not ported.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

from .. import NG
from ..constants import KAPPA
from ..timing import scope
from . import freeze
from .dyn_core import acoustic_carry, make_acoustic_substep
from .fv_dynamics import (post_acoustic_stage, pre_acoustic_stage,
                          prep_stage, reference_pressure,
                          reference_thickness)


# ---- pytrees of tensors (dicts, lists, tuples) ---------------------------

def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in tree:
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _leaves(x, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, it) for x in tree)
    if isinstance(tree, torch.Tensor):
        return next(it)
    return tree


def _pairs(out, ct, acc):
    """(output, cotangent) leaf pairs of matching dict keys and positions;
    a missing or None cotangent is zero."""
    if ct is None:
        return acc
    if isinstance(out, dict):
        for k in out:
            _pairs(out[k], ct.get(k), acc)
    elif isinstance(out, (list, tuple)):
        for o, c in zip(out, ct):
            _pairs(o, c, acc)
    elif isinstance(out, torch.Tensor):
        acc.append((out, ct))
    return acc


def vjp(fn, primals, cotangent, tape=None):
    """Cotangent of `fn`'s inputs: fn(*primals) recomputed with autograd
    from detached copies of the primals (a tape, if given, replayed), then
    one `torch.autograd.grad`.  Returns the input cotangents with the
    structure of `primals` (zeros where an input does not reach an output
    with a cotangent)."""
    leaves = _leaves(primals, [])
    ins = [x.detach().requires_grad_(x.is_floating_point()) for x in leaves]
    args = _rebuild(primals, iter(ins))
    with torch.enable_grad(), (freeze.replaying(tape) if tape is not None
                               else nullcontext()):
        out = fn(*args)
    pairs = [(o, c) for o, c in _pairs(out, cotangent, [])
             if o.requires_grad]
    want = [x for x in ins if x.requires_grad]
    grads = iter(torch.autograd.grad(
        [o for o, _ in pairs], want, [c for _, c in pairs],
        allow_unused=True) if pairs else [None] * len(want))
    res = []
    for x in ins:
        g = next(grads) if x.requires_grad else None
        res.append(torch.zeros_like(x) if g is None else g)
    return _rebuild(primals, iter(res))


def _like(tree, ref):
    """`tree` with its dicts' keys in the order of `ref`'s."""
    if isinstance(ref, dict):
        return {k: _like(tree[k], v) for k, v in ref.items()}
    if isinstance(ref, (list, tuple)):
        return type(ref)(_like(t, r) for t, r in zip(tree, ref))
    return tree


def jvp(fn, primals, tangents, tape=None):
    """(outputs, output tangents) of `fn` by `torch.func.jvp`, a tape, if
    given, replayed."""
    with freeze.replaying(tape) if tape is not None else nullcontext():
        return torch.func.jvp(fn, primals, _like(tangents, primals))


class StagedStepper:
    """The forward/record/tl/ad sweeps of one LinearModel: its
    configuration, grid, ak/bk (numpy, working precision), ptop and
    `lm.Marshal`.  It keeps no reference to the model, so that dropping
    the model frees it and its cache without a cyclic collection."""

    def __init__(self, cfg, grid, topo, ak_np, bk_np, ptop, marshal):
        dyn = cfg.dyn
        self.k_split = dyn.k_split
        self.n_split = dyn.n_split
        self.npz = dyn.npz
        self._ny, self._nx = ny, nx = marshal.tile.ny, marshal.tile.nx
        self._zeros = zeros = marshal.zeros
        self._nf = nf = marshal.nf
        dtype, device = marshal.dtype, marshal.device
        mdt = cfg.dt / dyn.k_split
        ak = torch.as_tensor(ak_np, dtype=dtype, device=device)
        bk = torch.as_tensor(bk_np, dtype=dtype, device=device)
        dp_ref = reference_thickness(ak_np, bk_np)
        pm = reference_pressure(ak_np, bk_np)
        npz = dyn.npz
        pad, pad_phis, tracers = marshal.pad, marshal.pad_phis, marshal.tracers

        # ---- the stage functions ----
        def prep(prog, phis):
            st, q = pad(prog)
            st["phis"] = pad_phis(phis)
            return prep_stage(st, q, grid, topo, dyn, ptop)

        def pre(st):
            st2, dp1 = pre_acoustic_stage(st, topo, dyn)
            return st2, dp1, acoustic_carry(st2, dyn, npz)

        def post(st2, carry, q, dp1, last, mode):
            return post_acoustic_stage(st2, carry, q, dp1, grid, topo, dyn,
                                       ak, bk, pm, ptop, mdt, last,
                                       mode=mode)

        def unpad_T(pb):
            """Transpose of `marshal.unpad`: the compute-domain cotangent in
            zero-padded internal state (the keys _unpad reads; every
            other key of the state, consv_te's te0_2d included, has a zero
            cotangent, which `vjp` supplies for a missing key)."""
            def z3(x, sy=0, sx=0):
                out = zeros(npz, nf, ny + sy + 2 * NG, nx + sx + 2 * NG)
                out[:, :, NG:NG + ny + sy, NG:NG + nx + sx] = x
                return out

            st = dict(u=z3(pb["u"], sy=1), v=z3(pb["v"], sx=1),
                      pt=z3(pb["t"]), delp=z3(pb["delp"]))
            if not dyn.hydrostatic:
                st["w"] = z3(pb["w"])
                st["delz"] = z3(pb["delz"])
            q = [z3(pb[name]) for name in tracers]
            return st, q

        self._stages = dict(prep=prep, pre=pre, post=post,
                            unpad=marshal.unpad, unpad_T=unpad_T)
        self._sub_traj = make_acoustic_substep(
            grid, topo, dyn, mdt, KAPPA, ptop, npz, dtype, mode="traj",
            dp_ref=dp_ref, pm=pm)
        self._sub_mix = make_acoustic_substep(
            grid, topo, dyn, mdt, KAPPA, ptop, npz, dtype, mode="mixed",
            dp_ref=dp_ref, pm=pm)

        # Checkpoint pruning (core/staged.py of the JAX package): carry
        # fields the substep overwrites before reading them (pe/peln/pk/pkz
        # from geopk or the Riemann solver, uc/vc/divgd from c_sw) and the
        # purely linear flux/courant accumulators carry no linearization
        # information, so zeros stand in for them; hydrostatic, w is inert.
        # With beta > 0 the previous substep's gradient du/dv is read
        # nonlinearly (beta_d*du, and beta_d from the counter itc) and is
        # kept.
        self._prune = ("pe", "peln", "pk", "pkz", "uc", "vc", "divgd",
                       "mfx", "mfy", "cx", "cy", "heat_source")
        if dyn.hydrostatic:
            self._prune = self._prune + ("w",)

    def _prune_carry(self, c):
        return {k: v for k, v in c.items() if k not in self._prune}

    def _expand_carry(self, c):
        """The full carry from a pruned checkpoint, zeros for the pruned
        fields (a valid and exact linearization point for them)."""
        ny, nx = self._ny, self._nx
        jcy, jcx = ny + 2 * NG, nx + 2 * NG
        npz = self.npz
        nf = self._nf
        shapes = dict(
            pe=(npz + 1, nf, jcy, jcx), peln=(npz + 1, nf, jcy, jcx),
            pk=(npz + 1, nf, jcy, jcx), pkz=(npz, nf, jcy, jcx),
            uc=(npz, nf, jcy, jcx + 1), vc=(npz, nf, jcy + 1, jcx),
            divgd=(npz, nf, jcy + 1, jcx + 1), w=(npz, nf, jcy, jcx),
            mfx=(npz, nf, ny, nx + 1), mfy=(npz, nf, ny + 1, nx),
            cx=(npz, nf, jcy, nx + 1), cy=(npz, nf, ny + 1, jcx),
            heat_source=(npz, nf, ny, nx),
        )
        full = dict(c)
        for k in self._prune:
            full[k] = self._zeros(*shapes[k])
        return full

    # -- forward: the nonlinear step and its checkpoints ---------------------

    @torch.no_grad()
    def forward(self, prog, phis):
        s = self._stages
        st, q = s["prep"](prog, phis)
        pre_in, carries, carry_fin = [], [], []
        for k in range(self.k_split):
            pre_in.append((st, q))
            st2, dp1, carry = s["pre"](st)
            consts = dict(phis=st2["phis"])
            ck = []
            for _ in range(self.n_split):
                ck.append(self._prune_carry(carry))
                carry = self._sub_traj(carry, consts)
            carries.append(ck)
            carry_fin.append(carry)
            st, q = s["post"](st2, carry, q, dp1, k == self.k_split - 1,
                              "traj")
        return (s["unpad"](st, q),
                dict(pre_in=pre_in, carries=carries, carry_fin=carry_fin))

    @torch.no_grad()
    def _pre_fwd(self, st):
        st2, dp1, _ = self._stages["pre"](st)
        return st2, dp1

    # -- record: the branch-decision tapes -----------------------------------

    @torch.no_grad()
    def record_substep(self, carry, phis_p):
        """The (a, b, c) tapes of one mixed substep at checkpoint `carry`."""
        sa, sb, sc = self._sub_mix.stages
        consts = dict(phis=phis_p)
        with freeze.recording() as ta:
            ab = sa(self._expand_carry(carry), consts)
        with freeze.recording() as tb:
            bc = sb(ab, consts)
        with freeze.recording() as tc:
            sc(bc, consts)
        return ta, tb, tc

    @torch.no_grad()
    def record_post(self, cks, k):
        """The tape of the k-th mixed post stage."""
        st, q = cks["pre_in"][k]
        st2, dp1 = self._pre_fwd(st)
        with freeze.recording() as tape:
            self._stages["post"](st2, cks["carry_fin"][k], q, dp1,
                                 k == self.k_split - 1, "mixed")
        return tape

    def record(self, cks):
        sub, post = [], []
        for k in range(self.k_split):
            st2, _ = self._pre_fwd(cks["pre_in"][k][0])
            sub.append([self.record_substep(c, st2["phis"])
                        for c in cks["carries"][k]])
            post.append(self.record_post(cks, k))
        return dict(sub=sub, post=post)

    def _sub_mix_rep(self, c, consts, tape3):
        """The mixed substep with its three stages' tapes replayed."""
        sa, sb, sc = self._sub_mix.stages
        ta, tb, tc = tape3
        with freeze.replaying(ta):
            ab = sa(c, consts)
        with freeze.replaying(tb):
            bc = sb(ab, consts)
        with freeze.replaying(tc):
            return sc(bc, consts)

    # -- tangent linear -------------------------------------------------------

    def tl(self, prog, phis, p, cks, tapes):
        s = self._stages
        with scope("tl.prep"):
            t_st, t_q = jvp(s["prep"], (prog, phis),
                            (p, torch.zeros_like(phis)))[1]
        for k in range(self.k_split):
            st, q = cks["pre_in"][k]
            with scope("tl.pre"):
                (st2, dp1, _), (t_st2, t_dp1, t_carry) = jvp(
                    s["pre"], (st,), (t_st,))
            consts = dict(phis=st2["phis"])
            t_consts = dict(phis=t_st2["phis"])
            for c_j, tape3 in zip(cks["carries"][k], tapes["sub"][k]):
                with scope("tl.substep"):
                    t_carry = jvp(
                        lambda c, cn, t3=tape3: self._sub_mix_rep(c, cn, t3),
                        (self._expand_carry(c_j), consts),
                        (t_carry, t_consts))[1]
            last = k == self.k_split - 1
            with scope("tl.post"):
                t_st, t_q = jvp(
                    lambda a, b, c, d: s["post"](a, b, c, d, last, "mixed"),
                    (st2, cks["carry_fin"][k], q, dp1),
                    (t_st2, t_carry, t_q, t_dp1), tape=tapes["post"][k])[1]
        return s["unpad"](t_st, t_q)

    # -- adjoint --------------------------------------------------------------

    def _sub_vjp(self, c_j, tape3, phis_p, ct_c):
        """Transpose of one mixed substep: stages a and b recomputed (no
        graph), then the vjps of c, b and a in turn."""
        sa, sb, sc = self._sub_mix.stages
        ta, tb, tc = tape3
        consts = dict(phis=phis_p)
        cfull = self._expand_carry(c_j)
        with torch.no_grad():
            with freeze.replaying(ta):
                ab = sa(cfull, consts)
            with freeze.replaying(tb):
                bc = sb(ab, consts)
        with scope("ad.stage_c"):
            ct_bc, ph_c = vjp(sc, (bc, consts), ct_c, tape=tc)
        del bc
        with scope("ad.stage_b"):
            ct_ab, ph_b = vjp(sb, (ab, consts), ct_bc, tape=tb)
        del ab, ct_bc
        with scope("ad.stage_a"):
            ct_c, ph_a = vjp(sa, (cfull, consts), ct_ab, tape=ta)
        return ct_c, ph_a["phis"] + ph_b["phis"] + ph_c["phis"]

    def ad(self, prog, phis, pb, cks, tapes):
        s = self._stages
        ct_st, ct_q = s["unpad_T"](pb)
        for k in reversed(range(self.k_split)):
            st, q = cks["pre_in"][k]
            last = k == self.k_split - 1
            st2, dp1 = self._pre_fwd(st)
            with scope("ad.post"):
                ct_st2, ct_carry, ct_q, ct_dp1 = vjp(
                    lambda a, b, c, d: s["post"](a, b, c, d, last, "mixed"),
                    (st2, cks["carry_fin"][k], q, dp1), (ct_st, ct_q),
                    tape=tapes["post"][k])
            phis_p = st2["phis"]
            del st2, dp1
            ct_ph = None
            for j in reversed(range(self.n_split)):
                ct_carry, d_ph = self._sub_vjp(
                    cks["carries"][k][j], tapes["sub"][k][j], phis_p,
                    ct_carry)
                ct_ph = d_ph if ct_ph is None else ct_ph + d_ph
            ct_st2 = dict(ct_st2, phis=ct_st2["phis"] + ct_ph)
            with scope("ad.pre"):
                ct_st = vjp(s["pre"], (st,), (ct_st2, ct_dp1, ct_carry))[0]
        with scope("ad.prep"):
            return vjp(s["prep"], (prog, phis), (ct_st, ct_q))[0]
