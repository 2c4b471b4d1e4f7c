"""Neighbour halo exchange of the center scalar over a face decomposition.

Counterpart of fv3jedi_lm_tpu/parallel/ppermute.py.  With one cube face
per rank (parallel/faces.py, the reference's minimal "1 rank per tile x
6" configuration, tools/fv_mp_nlm_mod.F90) each face sends its
neighbours the edge values their halos need, and each receiver scatters
them into its halo with the cube-edge rotation applied.

`fill_halo_center_ppermute` is `halo.fill_halo_center` on the rank's
`FaceTopology`: the point-to-point exchange of parallel/exchange.py over
the center map, one `batch_isend_irecv` a call, bitwise the gather's.
The JAX package groups its 24 directed edge transfers into rounds
because `lax.ppermute` takes permutations; a send and receive per
neighbour needs none.

`_center_plan` is the JAX package's static plan, copied as NumPy and
held equal to it (tests/test_torch_standalone.py): for each rank the
ng-deep side strip it sends each neighbour and where the receiver puts
each value.  exchange.Plan sends, of each such strip, the values the
receiver's halo reads.
"""

from __future__ import annotations

import numpy as np

from . import halo
from .faces import FaceTopology


def _center_plan(topo):
    """Static exchange plan from the topology's center-scalar gather map.

    Returns dict with:
      nrounds
      send_side[6, nrounds]  int, side strip to send this round (-1 = none)
      perms[nrounds]         list of (src, dst) pairs
      pos[6, nrounds, H]     local flat halo positions to fill (-1 pad)
      src[6, nrounds, H]     flat index into the received (ng, jc) strip
      strip_flat[4, ng*jc]   flat positions of each side strip
      loc_pos, loc_src[6, HL] intra-face copies (-1 pad)
    """
    idx = np.asarray(topo.halo_map_center())
    ng = topo.ng
    jc = idx.shape[-1]
    n = jc - 2 * ng
    fsz = jc * jc
    ident = np.arange(6 * fsz).reshape(6, jc, jc)
    nonid = idx != ident
    src_face = idx // fsz

    # the side strips of a face's interior, each (ng, jc): rows indexed
    # by the distance from the edge 0..ng-1, columns the full width; side
    # 0 south (low y), 1 north, 2 west, 3 east.  Which side feeds which
    # neighbour is read from the map below.
    def strip_coords(side):
        d = np.arange(ng)
        t = np.arange(jc)
        dd, tt = np.meshgrid(d, t, indexing="ij")
        if side == 0:      # south: rows ng+dd
            r, c = ng + dd, tt
        elif side == 1:    # north: rows ng+n-1-dd
            r, c = ng + n - 1 - dd, tt
        elif side == 2:    # west: cols ng+dd
            r, c = tt, ng + dd
        else:              # east: cols ng+n-1-dd
            r, c = tt, ng + n - 1 - dd
        return r, c

    strip_flat = [np.ravel_multi_index(strip_coords(s), (jc, jc))
                  for s in range(4)]
    in_strip = []
    for s in range(4):
        m = np.full(fsz, -1, np.int64)
        m[strip_flat[s].ravel()] = np.arange(ng * jc)
        in_strip.append(m)

    # intra-face non-identity copies (corner-wedge replication): purely
    # local, no communication
    HL = 1
    loc_pos_l, loc_src_l = [], []
    for f in range(6):
        mask = nonid[f] & (src_face[f] == f)
        pos = np.flatnonzero(mask.reshape(fsz))
        srcs = idx[f].reshape(fsz)[pos] - f * fsz
        loc_pos_l.append(pos)
        loc_src_l.append(srcs)
        HL = max(HL, len(pos))
    loc_pos = np.full((6, HL), -1, np.int64)
    loc_src = np.zeros((6, HL), np.int64)
    for f in range(6):
        loc_pos[f, :len(loc_pos_l[f])] = loc_pos_l[f]
        loc_src[f, :len(loc_src_l[f])] = loc_src_l[f]

    # directed transfers (f2 -> f): positions on f sourcing from face f2
    transfers = []  # (src_face, dst_face, side_of_src, pos_list, src_list)
    for f in range(6):
        for f2 in range(6):
            if f2 == f:
                continue
            mask = nonid[f] & (src_face[f] == f2)
            if not mask.any():
                continue
            pos = np.flatnonzero(mask.reshape(fsz))
            srcs = idx[f].reshape(fsz)[pos] - f2 * fsz  # flat within f2
            # which canonical strip of f2 covers ALL sources?
            side = None
            for s in range(4):
                loc = in_strip[s][srcs]
                if (loc >= 0).all():
                    side = s
                    src_in_strip = loc
                    break
            if side is None:
                raise ValueError(
                    f"halo sources of face {f} from {f2} not within one "
                    f"ng-deep side strip")
            transfers.append((f2, f, side, pos, src_in_strip))

    # greedy round grouping: distinct src and dst per round
    rounds = []
    remaining = list(transfers)
    while remaining:
        used_s, used_d, this, rest = set(), set(), [], []
        for tr in remaining:
            if tr[0] not in used_s and tr[1] not in used_d:
                used_s.add(tr[0])
                used_d.add(tr[1])
                this.append(tr)
            else:
                rest.append(tr)
        rounds.append(this)
        remaining = rest

    nrounds = len(rounds)
    H = max(len(tr[3]) for tr in transfers)
    send_side = np.full((6, nrounds), -1, np.int32)
    pos_tab = np.full((6, nrounds, H), -1, np.int64)
    src_tab = np.zeros((6, nrounds, H), np.int64)
    perms = []
    for r, this in enumerate(rounds):
        perms.append([(tr[0], tr[1]) for tr in this])
        for (f2, f, side, pos, sis) in this:
            send_side[f2, r] = side
            pos_tab[f, r, :len(pos)] = pos
            src_tab[f, r, :len(sis)] = sis

    plan = dict(nrounds=nrounds, send_side=send_side, perms=perms,
                pos=pos_tab, src=src_tab, ng=ng, jc=jc,
                loc_pos=loc_pos, loc_src=loc_src,
                strip_flat=np.stack(strip_flat).reshape(4, -1))
    return plan


def fill_halo_center_ppermute(q, topo, faces):
    """Center-scalar halo exchange of this rank's face.

    q: (..., 1, jc, jc), this rank's face (`faces`, a FaceGroup); `topo`
    the CubeTopology or the rank's FaceTopology.  Bitwise equal to
    halo.fill_halo_center on the joined faces."""
    if getattr(topo, "faces", None) is not faces:
        topo = FaceTopology(topo, faces)
    return halo.fill_halo_center(q, topo)
