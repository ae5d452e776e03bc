"""2PC geometric predicates (reference C19-C22, ``src/aby/*``).

Reproduces the four ABY example computations — circle (squared-distance <
r^2) and point-in-convex-polygon (half-plane orientation tests + OR-fold), in
both arithmetic-sharing and boolean-boundary variants — together with the
clear-computation verification oracle the reference prints
("Circuit Result" vs "Local Verify Result", circ_y/pplp.cpp:97-101).

Two execution models:

* In-process batched simulation (``sharing``/``circuits``): shares are device
  arrays, gates vectorize on device lanes, the dealer is trusted — the fast path
  for batched predicate evaluation.
* Two real parties over TCP (``ot``/``networked``): Chou–Orlandi base OT +
  IKNP extension + Gilboa Beaver triples (the protocol stack the reference
  gets from the ABY library), interactive Beaver openings per multiply.

The A2Y comparison runs either by opening the blinded value (fast, leaks the
blinded distance like an opened A2Y) or fully garbled (``yao.py``: free-XOR +
point-and-permute garbled circuits, evaluator labels by OT — no party sees
the distance, exactly ABY's Yao sharing).
"""

from .sharing import ArithShare, BeaverDealer, share, reconstruct
from .circuits import (
    circle_predicate_2pc,
    circle_predicate_clear,
    polygon_predicate_2pc,
    polygon_predicate_clear,
    polygon_edge_coeffs,
)
from .ot import SchnorrGroup, ot_triples
from .networked import (
    PartyArith,
    circle_predicate_2pc_networked,
    polygon_predicate_2pc_networked,
)

__all__ = [
    "ArithShare",
    "BeaverDealer",
    "share",
    "reconstruct",
    "circle_predicate_2pc",
    "circle_predicate_clear",
    "polygon_predicate_2pc",
    "polygon_predicate_clear",
    "polygon_edge_coeffs",
    "SchnorrGroup",
    "ot_triples",
    "PartyArith",
    "circle_predicate_2pc_networked",
    "polygon_predicate_2pc_networked",
]
