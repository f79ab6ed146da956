"""Percent of the window with the device idle while the detector's call
(the program's span ``aaclip/predict``) is open on the host. It reads the
trace's ``program_spans``, which ``benchmark/tools/spans.py`` gives it."""
from benchmark.metrics._program import idle_share


def read(ctx):
    return idle_share(ctx, "predict")
