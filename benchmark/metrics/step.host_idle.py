"""Percent of the window with the device idle while the graphed training
step (the program's span ``aaclip/step``) is open on the host. It reads the
trace's ``program_spans``, which ``benchmark/tools/spans.py`` gives it."""
from benchmark.metrics._program import idle_share


def read(ctx):
    return idle_share(ctx, "step")
