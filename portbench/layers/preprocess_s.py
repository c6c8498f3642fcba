"""Seconds per mesh in the ``preprocess`` span: thumbnail, safety gate,
SAM's encode and box prompt, recentre (``utils/image.py``,
``segmentation/sam.py``)."""

from portbench.harness import span_mean


def read(readings):
    return span_mean(readings, ("preprocess",))
