"""The part of a face one rank computes.

On one process a model computes whole faces; on a decomposition
(parallel/faces.py) each rank computes a tile of each of its faces.  The
operators index their fields in the tile's own padded coordinates, and
act at a face edge or a cube corner only where the tile owns it: the
`Tile` on the model's grid (`grid["tile"]`) says which.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Tile:
    """The part of a face one rank computes: `ny` x `nx` cells at offset
    (`j0`, `i0`) of a face of `n` x `n` cells.  A staggered field holds
    one line more along its staggered axis, and the line two tiles share
    is held by both (the Fortran D grid's u(is:ie, js:je+1)).  The face
    edges the tile owns are where the edge and corner treatments act;
    the whole face is the tile (n, 0, 0, n, n), which owns all four."""

    n: int
    j0: int
    i0: int
    ny: int
    nx: int

    @property
    def south(self) -> bool:
        return self.j0 == 0

    @property
    def north(self) -> bool:
        return self.j0 + self.ny == self.n

    @property
    def west(self) -> bool:
        return self.i0 == 0

    @property
    def east(self) -> bool:
        return self.i0 + self.nx == self.n

    @property
    def whole(self) -> bool:
        return self.ny == self.n and self.nx == self.n
