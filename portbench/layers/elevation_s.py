"""Seconds per mesh in the ``elevation`` span: LoFTR over the four nearby
views of view 0 and the pose sweep (``elevation/loftr.py``,
``elevation/solver.py``)."""

from portbench.harness import span_mean


def read(readings):
    return span_mean(readings, ("elevation",))
