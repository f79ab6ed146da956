"""Device selection for the CLIs, the counterpart of
``aa_clip_iqm_tpu/platform.py``.

``AACLIP_PLATFORM=cpu`` is the caller asking for the CPU: it becomes the
default of the CLIs' ``--device``. Unset, ``gpu`` or ``cuda`` keep the card,
the default. Any other value raises, as would JAX's platform override for a
platform it does not know. ``AACLIP_MULTIHOST=1`` (JAX's pod runtime) joins
the process group of a ``torchrun`` launch first
(``parallel.multihost.maybe_initialize``: NCCL on the cards, gloo with
``AACLIP_PLATFORM=cpu``), and the default device is then the rank's card,
``cuda:LOCAL_RANK``.
"""
from __future__ import annotations

import os

PLATFORMS = {"": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def platform_name() -> str:
    """``AACLIP_PLATFORM``, normalised; raises for a value not in PLATFORMS."""
    plat = os.environ.get("AACLIP_PLATFORM", "").strip().lower()
    if plat not in PLATFORMS:
        raise ValueError(
            f"AACLIP_PLATFORM={plat!r}: expected one of "
            f"{sorted(p for p in PLATFORMS if p)} or unset")
    return plat


def default_device() -> str:
    """The device a CLI runs on when no ``--device`` is given."""
    device = PLATFORMS[platform_name()]
    if os.environ.get("AACLIP_MULTIHOST") == "1":
        from .parallel.multihost import local_rank, maybe_initialize

        maybe_initialize()
        if device == "cuda":
            return f"cuda:{local_rank()}"
    return device
