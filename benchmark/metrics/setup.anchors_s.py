"""Seconds of set-up spent on the class anchors (the text tower over every
class's prompts, ``prompts.compute_frozen_anchors``): the program's counter
``setup.anchors_s``."""
from benchmark.metrics._program import registry


def read(ctx):
    c = registry(ctx)
    return None if not c or "setup.anchors_s" not in c else c["setup.anchors_s"]
