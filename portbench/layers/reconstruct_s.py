"""Seconds per mesh in the ``reconstruct`` span: features, cost volume,
field, marching tets on the host, vertex colours (``recon/pipeline.py``,
``native/marching_tets.cpp``)."""

from portbench.harness import span_mean


def read(readings):
    return span_mean(readings, ("reconstruct",))
