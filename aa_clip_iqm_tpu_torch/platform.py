"""Device selection for the CLIs, the counterpart of
``aa_clip_iqm_tpu/platform.py``.

``AACLIP_PLATFORM=cpu`` is the caller asking for the CPU: it becomes the
default of the CLIs' ``--device``. Unset, ``gpu`` or ``cuda`` keep the card,
the default. Any other value raises, as would JAX's platform override for a
platform it does not know. ``AACLIP_MULTIHOST=1`` (JAX's pod runtime) raises:
multi-GPU runs are not ported (ROADMAP A14).
"""
from __future__ import annotations

import os

PLATFORMS = {"": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def default_device() -> str:
    """The device a CLI runs on when no ``--device`` is given."""
    if os.environ.get("AACLIP_MULTIHOST") == "1":
        raise NotImplementedError(
            "AACLIP_MULTIHOST=1: multi-host and multi-GPU runs are not ported "
            "yet (ROADMAP A14)")
    plat = os.environ.get("AACLIP_PLATFORM", "").strip().lower()
    if plat not in PLATFORMS:
        raise ValueError(
            f"AACLIP_PLATFORM={plat!r}: expected one of "
            f"{sorted(p for p in PLATFORMS if p)} or unset")
    return PLATFORMS[plat]
