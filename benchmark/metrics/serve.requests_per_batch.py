"""Requests answered per device batch: the window's requests answered over
the detector's graph replays in it (``AnomalyDetector.graph_stats``)."""


def read(ctx):
    c = ctx.counters
    return c["answered"] / c["replays"] if c.get("replays") else None
