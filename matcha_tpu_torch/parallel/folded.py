"""The folded plan: each matching split by how many cards its edges cross.

Port of the numpy half of ``matcha_tpu/parallel/gossip.py`` (:319-410):
``_OffsetPart``, ``FoldedPlan`` and ``build_folded_plan``.  Workers fold
card-major onto ``C`` cards (worker ``g = c·L + l`` lives on card ``c``
as row ``l``); for each matching and each distinct card offset
``d = (card(π(g)) − card(g)) mod C`` the plan holds a selection table.
The executor that would move the blocks between cards is multi-card work
(``ROADMAP.md``); the planner's cost model reads only the plan's hop
accounting, which is why the plan object lives here on its own.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = ["FoldedPlan", "build_folded_plan"]


@dataclasses.dataclass(frozen=True)
class _OffsetPart:
    """Edges of one matching whose partner sits ``offset`` cards away."""

    offset: int
    src_local: np.ndarray  # int32[C, L] — partner's row within its card's block
    mask: np.ndarray  # f32[C, L] — 1 where this offset applies


@dataclasses.dataclass(frozen=True)
class FoldedPlan:
    """Per-matching card-offset decomposition of a schedule's involutions."""

    num_chips: int
    rows_per_chip: int
    matchings: Tuple[Tuple[_OffsetPart, ...], ...]

    @property
    def num_matchings(self) -> int:
        return len(self.matchings)

    @property
    def offsets_used(self) -> List[List[int]]:
        return [[p.offset for p in m] for m in self.matchings]

    def hop_accounting(self) -> List[List[Tuple[int, int, int]]]:
        """Per-matching ``(offset, slots, ring_hops)`` cost ledger.

        One entry per offset part: ``slots`` is how many of the N worker
        slots the part serves (fixed points land in the offset-0 part), and
        ``ring_hops`` is what moving the part's whole ``[L, ...]`` block
        costs on a bidirectional ring of cards: ``min(d, C − d)`` hops, 0
        for the part that stays on its card.
        """
        C = self.num_chips
        out: List[List[Tuple[int, int, int]]] = []
        for parts in self.matchings:
            out.append([
                (p.offset, int(p.mask.sum()), min(p.offset, C - p.offset))
                for p in parts
            ])
        return out

    def matching_hop_units(self) -> np.ndarray:
        """f64[M] — ring hops each matching costs per activation: one block
        move per nonzero offset, however many edges share it.  Matchings
        that stay on their cards (and every plan at C = 1) cost 0."""
        return np.asarray(
            [sum(h for (_, _, h) in m) for m in self.hop_accounting()],
            dtype=np.float64,
        )


def build_folded_plan(perms: np.ndarray, num_chips: int) -> FoldedPlan:
    """Split each matching permutation into its on-card and cross-card parts.

    Receiver card ``c`` of offset part ``d`` picks row ``π(g) mod L`` out of
    the block that card ``(c + d) mod C`` holds.  π is an involution (fixed
    points map to themselves at offset 0), so the parts' masks partition
    every slot and the combined selection is exactly ``x[π]``.
    """
    perms = np.asarray(perms, dtype=np.int64)
    M, N = perms.shape
    C = int(num_chips)
    if N % C:
        raise ValueError(f"N={N} not divisible by num_chips={C}")
    L = N // C
    g = np.arange(N)
    matchings = []
    for j in range(M):
        p = perms[j]
        d_all = ((p // L) - (g // L)) % C  # [N]
        parts = []
        for d in sorted(set(int(v) for v in d_all)):
            sel = d_all == d
            src = np.where(sel, p % L, 0).reshape(C, L).astype(np.int32)
            mask = sel.astype(np.float32).reshape(C, L)
            parts.append(_OffsetPart(int(d), src, mask))
        matchings.append(tuple(parts))
    return FoldedPlan(C, L, tuple(matchings))
