"""The cross-face halo updates of a face decomposition, point to point.

On one process `parallel/halo.py` fills every halo by a gather over the
whole cube's flattened (6, J, I) fields, driven by the NumPy maps of
`CubeTopology`.  With one face per rank (`parallel/faces.py`) the same
maps are read once per rank and split by the face each value comes from:
for each halo position of this face that the map changes it gives the
source face, the source component (of a vector pair) and index, and the
sign.  A position whose source lies on this face is gathered locally, as
on one process; for each other face the rank owning it gathers exactly
the values this face needs and sends them, all in one exchange.  Only
copies and sign flips happen, each value is read from the input as the
gather reads it, so the result is bitwise the single process's.

The maps: the scalar `halo_map_center` and `halo_map_corner`; the vector
pairs `halo_map_dgrid` and `halo_map_cgrid`, with their all-positive
SCALAR_PAIR variants (`halo._abs_sign_maps`); and `edge_fix_maps_dgrid`.

`_Exchange` is a `torch.autograd.Function`: its tangent is the same
exchange of the tangent (`torch.func.jvp`, the TL's stages), and its
cotangent the transpose (`torch.autograd.grad`, the AD's stages): the
overwritten positions' cotangents are zeroed, sent back to the rank that
owns their sources and added there, sign applied.  Every rank issues
every exchange in the same order, an empty plan included, since the
stages run the same code on every face.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import NG


def _components(maps):
    """The per-output-component maps of a scalar index array (one
    component) or of a vector pair (mx, my): each a dict of idx_same,
    idx_other, from_other, sign over (6, J, I)."""
    if isinstance(maps, np.ndarray):
        return [dict(idx_same=maps, idx_other=np.zeros_like(maps),
                     from_other=np.zeros(maps.shape, bool),
                     sign=np.ones(maps.shape))]
    return list(maps)


def _needs(comps, faces, n, rank, shared=False):
    """What `rank`'s window takes from where, per component c: (its
    local flat positions that change, the rank each value comes from,
    the value's index in that rank's pool, the sign), positions in flat
    order.  A point keeps its value if the map leaves it and it lies in
    the rank's own tile or in the face's halo; a point of the face the
    map leaves comes from the tile that owns it; a point the map moves
    comes from the owner of its source (the rank itself first).  With
    `shared` "fix" (the shared-edge fix) the tile's north line of a field
    staggered in y and its east line of one staggered in x come from the
    tile across it within the face, as the face's come from the face
    across the cube edge; with "lines" only those lines are taken."""
    f, y, x = faces.layout
    nf = faces.nf
    fb = rank // (y * x)
    tile = faces.tile(n, rank)
    dims = [m["idx_same"].shape[-2:] for m in comps]
    # every rank's window of a component has the same shape
    wins = [(tile.ny + J - n, tile.nx + I - n) for J, I in dims]
    sizes = [nf * jt * it for jt, it in wins]
    offset = np.cumsum([0] + sizes[:-1])
    out = []
    for c, m in enumerate(comps):
        J, I = dims[c]
        jt, it = wins[c]
        lf, jj, ii = np.meshgrid(np.arange(nf), np.arange(jt), np.arange(it),
                                 indexing="ij")
        F, Jg, Ig = fb * nf + lf, tile.j0 + jj, tile.i0 + ii
        flat = ((F * J + Jg) * I + Ig).reshape(-1)
        idx = np.asarray(m["idx_same"], np.int64).reshape(-1)[flat]
        fo = np.asarray(m["from_other"], bool).reshape(-1)[flat]
        sign = np.asarray(m["sign"], np.float64).reshape(-1)[flat]
        moved = (idx != flat) | fo | (sign != 1)
        sj = J - (n + 2 * NG)
        si = I - (n + 2 * NG)
        rj, ri = (Jg - NG).reshape(-1), (Ig - NG).reshape(-1)
        own = ((rj >= tile.j0) & (rj < tile.j0 + tile.ny + sj)
               & (ri >= tile.i0) & (ri < tile.i0 + tile.nx + si))
        in_face = (rj >= 0) & (rj < n + sj) & (ri >= 0) & (ri < n + si)
        line = np.zeros_like(own)
        if shared:
            if sj and not tile.north:
                line |= own & (rj == tile.j0 + tile.ny)
            if si and not tile.east:
                line |= own & (ri == tile.i0 + tile.nx)
        take = line if shared == "lines" else (
            moved | (in_face & ~own) | line)
        src = np.where(fo, np.asarray(m["idx_other"], np.int64
                                      ).reshape(-1)[flat], idx)
        sc = np.where(fo, len(comps) - 1 - c, c)
        pos = np.flatnonzero(take)
        src, sc, sign = src[pos], sc[pos], sign[pos]
        Js = np.array([d[0] for d in dims])[sc]
        Is = np.array([d[1] for d in dims])[sc]
        sf, r = np.divmod(src, Js * Is)
        sjj, sii = np.divmod(r, Is)
        sjj, sii = sjj - NG, sii - NG
        # the owner: this rank if its tile holds the source, else the
        # tile whose cells (or staggered line) contain it
        sfb = sf // nf
        mine = ((sfb == fb) & (sjj >= tile.j0)
                & (sjj < tile.j0 + tile.ny + Js - (n + 2 * NG))
                & (sii >= tile.i0)
                & (sii < tile.i0 + tile.nx + Is - (n + 2 * NG))
                & ~line[pos])
        ty = np.where(mine, tile.j0 // tile.ny,
                      np.minimum(sjj // tile.ny, y - 1))
        tx = np.where(mine, tile.i0 // tile.nx,
                      np.minimum(sii // tile.nx, x - 1))
        owner = (sfb * y + ty) * x + tx
        wj = np.array([w[0] for w in wins])[sc]
        wi = np.array([w[1] for w in wins])[sc]
        lj = sjj + NG - ty * tile.ny
        li = sii + NG - tx * tile.nx
        pool = offset[sc] + ((sf - sfb * nf) * wj + lj) * wi + li
        out.append((pos, owner, pool, sign))
    return out, sizes


class Plan:
    """One rank's side of one cross-face map on its FaceGroup `faces`
    and its tile of faces of `n` cells: what it gathers locally, sends to
    and receives from each other rank (see the module's docstring).  The
    components of a vector pair are read from one pool, the flattened x
    component followed by the flattened y component, so each message to
    a rank carries both."""

    def __init__(self, maps, faces, n, device, dtype, shared=False):
        self.faces = faces
        me = faces.rank
        comps = _components(maps)
        signed = any((np.asarray(m["sign"]) != 1).any() for m in comps)
        mine, sizes = _needs(comps, faces, n, me, shared)
        send = {}       # destination rank -> [pool indices]
        for d in range(faces.world):
            if d == me:
                continue
            for pos, owner, pool, _ in _needs(comps, faces, n, d, shared)[0]:
                sel = owner == me
                if sel.any():
                    send.setdefault(d, []).append(pool[sel])
        recv = {}       # source rank -> [(component, count)]
        local_src, pos_all, sign_all = [], [], []
        self.local_n = []
        for c, (pos, owner, pool, sign) in enumerate(mine):
            loc = owner == me
            local_src.append(pool[loc])
            ps, sg = [pos[loc]], [sign[loc]]
            for g in np.unique(owner[~loc]):
                sel = owner == g
                recv.setdefault(int(g), []).append((c, int(sel.sum())))
                ps.append(pos[sel])
                sg.append(sign[sel])
            self.local_n.append(int(loc.sum()))
            pos_all.append(np.concatenate(ps))
            sign_all.append(np.concatenate(sg))

        def lt(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        self.send = {d: lt(np.concatenate(v)) for d, v in sorted(send.items())}
        # received message from rank g: per component c its count
        self.recv = {g: dict(v) for g, v in sorted(recv.items())}
        self.local_src = [lt(a) for a in local_src]
        self.pos = [lt(a) for a in pos_all]
        self.sign = ([torch.as_tensor(s, dtype=dtype, device=device)
                      for s in sign_all] if signed else None)
        self.sizes = sizes

    # -- the exchange and its transpose --------------------------------

    def _pool(self, flats):
        return flats[0] if len(flats) == 1 else torch.cat(flats, -1)

    def apply(self, xs):
        """The exchanged components of xs, each (..., nf, J, I)."""
        lead = xs[0].shape[:-3]
        flats = [x.reshape(lead + (n,)) for x, n in zip(xs, self.sizes)]
        pool = self._pool(flats)
        got = self.faces.exchange(
            {d: pool.index_select(-1, i) for d, i in self.send.items()},
            {g: lead + (sum(cn.values()),) for g, cn in self.recv.items()},
            pool.dtype)
        outs = []
        for c, (x, f) in enumerate(zip(xs, flats)):
            vals = [pool.index_select(-1, self.local_src[c])]
            for g, cn in self.recv.items():
                if c in cn:
                    start = sum(n for cc, n in cn.items() if cc < c)
                    vals.append(got[g].narrow(-1, start, cn[c]))
            v = torch.cat(vals, -1)
            if self.sign is not None:
                v = v * self.sign[c]
            outs.append(f.index_copy(-1, self.pos[c], v).reshape(x.shape))
        return tuple(outs)

    def transpose(self, gs):
        """The cotangents of the inputs from those of the outputs."""
        lead = gs[0].shape[:-3]
        flats = [g.reshape(lead + (n,)) for g, n in zip(gs, self.sizes)]
        vals, kept = [], []
        for c, f in enumerate(flats):
            v = f.index_select(-1, self.pos[c])
            if self.sign is not None:
                v = v * self.sign[c]
            vals.append(v)
            kept.append(f.index_fill(-1, self.pos[c], 0.0))
        pool = self._pool(kept)
        back = {}
        for g, cn in self.recv.items():
            parts = []
            for c in sorted(cn):
                start = self.local_n[c] + sum(
                    h[c] for gg, h in self.recv.items() if gg < g and c in h)
                parts.append(vals[c].narrow(-1, start, cn[c]))
            back[g] = torch.cat(parts, -1)
        got = self.faces.exchange(back, {d: lead + (i.numel(),)
                                         for d, i in self.send.items()},
                                  pool.dtype)
        for c in range(len(flats)):
            pool.index_add_(-1, self.local_src[c],
                            vals[c].narrow(-1, 0, self.local_n[c]))
        for d, i in self.send.items():
            pool.index_add_(-1, i, got[d])
        outs = pool.split(self.sizes, -1)
        return tuple(o.reshape(g.shape) for o, g in zip(outs, gs))


class _Exchange(torch.autograd.Function):
    """The exchange of one plan as a linear map of its inputs."""

    @staticmethod
    def forward(plan, *xs):
        return plan.apply(xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[0]
        ctx.like = [(x.shape, x.dtype, x.device) for x in inputs[1:]]

    @staticmethod
    def jvp(ctx, _plan, *dxs):
        dxs = [torch.zeros(s, dtype=t, device=d) if dx is None else dx
               for dx, (s, t, d) in zip(dxs, ctx.like)]
        return ctx.plan.apply(dxs)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + ctx.plan.transpose(gs)


def _plan(topo, maps, key, x, shared=False):
    hit = topo.plans.get((key, shared, x.device, x.dtype))
    if hit is None:
        hit = Plan(maps, topo.faces, topo.n, x.device, x.dtype, shared)
        topo.plans[(key, shared, x.device, x.dtype)] = hit
    return hit


def exchange_scalar(q, topo, idx):
    """The scalar halo update of map `idx` on this rank's face: q is
    (..., 1, J, I)."""
    return _Exchange.apply(_plan(topo, idx, id(idx), q), q)[0]


def exchange_pair(x, y, topo, mx, my, shared=False):
    """The vector-pair halo update of maps (mx, my) on this rank's tile;
    `shared`: the shared-edge fix (see `_needs`)."""
    key = (id(mx["idx_same"]), id(mx["sign"]), id(my["idx_same"]),
           id(my["sign"]))
    return _Exchange.apply(_plan(topo, (mx, my), key, x, shared), x, y)
