"""``ops._build``'s one seam to the hand-written kernels, on the CPU.

Every C entry of ``csrc/`` is declared once as an ``_build.Entry``. Each
declaration is held to its C signature: the parameters of ``extern "C" int
aaclip_<name>(...)``, in order, against the declared ctypes, the stream
last. On the card a wrong arity or width would corrupt memory without a
word. The seam itself is held against a fake library: it types an entry
once, passes the stream, raises on a nonzero code naming the entry, and
counts ``launches.<name>`` once a call. A CPU forward reaches none of it."""
import ctypes
import os
import re

import pytest
import torch

from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch.loader import random_backbone
from aa_clip_iqm_tpu_torch.models import clip as tclip
from aa_clip_iqm_tpu_torch.ops import (  # noqa: F401  (each declares its entries)
    _build,
    attn_block,
    flash_attention,
    fused_mlp,
    gemm,
    packed_attention,
    postnorm,
    rope,
    swiglu,
)
from aa_clip_iqm_tpu_torch.utils import profiling

_SIGNATURE = re.compile(r'extern "C" int aaclip_(\w+)\s*\(([^)]*)\)')
_CTYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long": ctypes.c_long,
           "float": ctypes.c_float}


def _c_entries():
    """{name: (source, [(C type, parameter name)])} of every ``extern "C"
    int aaclip_<name>(...)`` in ``csrc/*.cu``."""
    found = {}
    for f in sorted(os.listdir(_build.CSRC_DIR)):
        if not f.endswith(".cu"):
            continue
        with open(os.path.join(_build.CSRC_DIR, f)) as src:
            for name, params in _SIGNATURE.findall(src.read()):
                parsed = []
                for p in params.split(","):
                    *ty, pname = p.replace("*", "* ").split()
                    parsed.append(("".join(t for t in ty if t != "const"), pname))
                found[name] = (f[:-len(".cu")], parsed)
    return found


C_ENTRIES = _c_entries()


def test_every_c_entry_is_declared_once():
    assert sorted(_build.ENTRIES) == sorted(C_ENTRIES)
    assert len(_build.ENTRIES) == 22


@pytest.mark.parametrize("name", sorted(C_ENTRIES))
def test_declared_argtypes_match_the_c_signature(name):
    """``void*`` / ``const void*`` -> c_void_p, ``int`` -> c_int, ``long``
    -> c_long, ``float`` -> c_float, in order, with the stream last."""
    lib, params = C_ENTRIES[name]
    entry = _build.ENTRIES[name]
    assert entry.lib == lib
    assert params[-1] == ("void*", "stream")
    assert [_CTYPES[ty] for ty, _ in params] == entry.argtypes, params


class _FakeFn:
    """A C entry of the fake library: records its calls, returns ``code``."""

    def __init__(self, code=0):
        self.code, self.calls, self.typed = code, [], 0
        self.argtypes = self.restype = None

    def __setattr__(self, key, value):
        if key == "argtypes" and value is not None:
            self.__dict__["typed"] += 1
        super().__setattr__(key, value)

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


class _FakeLib:
    def __init__(self, code=0):
        self.aaclip_fake = _FakeFn(code)
        self.aaclip_fakelib_error_string = lambda err: b"an illegal memory access"


class _Fake:
    """The fake library's state: the code its entry returns, the libraries
    loaded by name."""

    def __init__(self):
        self.code, self.libs = 0, {}

    def load(self, lib):
        return self.libs.setdefault(lib, _FakeLib(self.code))


@pytest.fixture
def fake(monkeypatch):
    """An entry ``aaclip_fake`` of a fake library ``fakelib``; ``load`` and
    the stream handle are stubbed, and the registry is left as it was."""
    state = _Fake()
    monkeypatch.setattr(_build, "load", state.load)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 4242)
    monkeypatch.setattr(_build, "ENTRIES", dict(_build.ENTRIES))
    return state


def test_an_entry_is_typed_once_and_gets_the_stream_last(fake):
    entry = _build.Entry("fakelib", "fake", [ctypes.c_void_p, ctypes.c_int])
    assert _build.ENTRIES["fake"] is entry
    assert entry.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    assert fake.libs == {}                                 # loaded at the first call
    entry(torch.device("cpu"), 16, 3)
    entry(torch.device("cpu"), 32, 4)
    fn = fake.libs["fakelib"].aaclip_fake
    assert fn.typed == 1 and fn.argtypes == entry.argtypes and fn.restype is ctypes.c_int
    assert fn.calls == [(16, 3, 4242), (32, 4, 4242)]


def test_a_nonzero_code_raises_naming_the_entry(fake):
    fake.code = 700
    entry = _build.Entry("fakelib", "fake", [ctypes.c_int])
    before = profiling.counters()
    with pytest.raises(RuntimeError, match=r"aaclip_fake launch failed: CUDA error 700 "
                                           r"\(an illegal memory access\)"):
        entry(torch.device("cpu"), 1)
    assert _build.launches(before) == {}                   # a failed launch is not counted


def test_a_call_counts_its_launch_once(fake):
    entry = _build.Entry("fakelib", "fake", [ctypes.c_int])
    before = profiling.counters()
    entry(torch.device("cpu"), 1)
    assert _build.launches(before) == {"fake": 1}
    assert profiling.counters()["launches.fake"] - before.get("launches.fake", 0) == 1
    entry(torch.device("cpu"), 1, counter="fake_variant")
    assert _build.launches(before) == {"fake": 1, "fake_variant": 1}


def test_a_cpu_forward_launches_nothing(monkeypatch):
    """The tiny tower's forward on the CPU runs the plain versions: no
    library is loaded and no launch counted."""
    def refuse(lib):
        raise AssertionError(f"a CPU forward loaded {lib}")

    monkeypatch.setattr(_build, "load", refuse)
    cfg = tconfigs.tiny_test_config(56)
    frozen = random_backbone(cfg, device="cpu", dtype=torch.float32)
    before = profiling.counters()
    with torch.no_grad():
        out = tclip.encode_image(frozen, cfg.clip, torch.zeros(2, 3, 56, 56))
    assert out.shape[0] == 2
    assert _build.launches(before) == {}
