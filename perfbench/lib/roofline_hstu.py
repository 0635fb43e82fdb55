"""The model FLOPs of one HSTU training row (models/hstu.py in the port;
arXiv:2402.17152), counted as lib/roofline.py counts SASRec's."""

from __future__ import annotations


def hstu_flops_per_example(d: int, length: int, blocks: int, heads: int) -> float:
    """A positive and a negative scored against one history encoding,
    forward x 3 for the backward. Per block over L positions, with dqk =
    dv = d / h: the u, v, q, k projection (2 L d (2 h dv + 2 h dqk) =
    8 L d^2), the scores and their weighted sum over the full L x L
    products (2 L^2 h dqk + 2 L^2 h dv = 4 L^2 d) and the output projection
    (2 L h dv d = 2 L d^2); then two item scores (4 d). The norms, the
    SiLUs and the recompute are not counted."""
    dqk = dv = d // heads
    per_block = (2.0 * length * d * (2 * heads * dv + 2 * heads * dqk) + 2.0 * length * heads * dv * d
                 + 2.0 * length * length * heads * (dqk + dv))
    return 3.0 * (blocks * per_block + 4.0 * d)
