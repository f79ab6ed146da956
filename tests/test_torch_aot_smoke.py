"""aa_clip_iqm_tpu_torch/tools/aot_smoke.py at ViT-L/14-336's full width and
depth: each flagship predict program exported on fake CUDA tensors (no
weight made, no card), with its output shapes and the aaclip:: nodes of
each kind in its graph asserted by the tool. About 30 s on one core."""
import pytest

from aa_clip_iqm_tpu_torch.ops import custom_ops
from aa_clip_iqm_tpu_torch.tools import aot_smoke


@pytest.mark.parametrize("program", aot_smoke.PROGRAMS, ids=[p[0] for p in aot_smoke.PROGRAMS])
def test_flagship_program_exports_on_meta(program):
    """Built as shapes on the meta device, traced on fake CUDA tensors."""
    lines = []
    aot_smoke.run((program,), log=lines.append)
    assert len(lines) == 1 and "aaclip::" in lines[0]


def test_a_wrong_count_fails():
    """The tool's check bites: a program held to other node counts fails."""
    name, img, batch, quantize, want = aot_smoke.PROGRAMS[0]
    with pytest.raises(AssertionError):
        aot_smoke.run(((name, img, batch, quantize, {**want, "ln_attn_front": 23}),),
                      log=lambda _: None)


def test_the_trace_applies_the_card_limits(monkeypatch):
    """The trace is the card's: a kernel that took only heads of 128 would
    refuse ViT-L's heads of 64 in the trace, as the card would."""
    monkeypatch.setattr(custom_ops, "HEAD_DIM", 128)
    with pytest.raises(ValueError, match="head width"):
        aot_smoke.trace(518, 1)


@pytest.mark.parametrize("program", aot_smoke.MESH_PROGRAMS,
                         ids=[p[0] for p in aot_smoke.MESH_PROGRAMS])
def test_mesh_program_runs_as_rank_0(program):
    """JAX's data-, tensor-parallel and multislice programs as rank 0's, at
    ViT-L/518 on fake CUDA tensors and torch's fake process group: the
    rank's rows and shards, B1 at its share of the heads, two all-reduces a
    tensor-parallel block, the gathers of the predict program."""
    lines = []
    aot_smoke.run_mesh((program,), log=lines.append)
    assert len(lines) == 1 and "all-reduces" in lines[0]


def test_a_wrong_mesh_count_fails():
    """One all-reduce a block (the out-projection's sum dropped) would fail."""
    name, program, shape, rows, shards, b1, reduces, *rest = aot_smoke.MESH_PROGRAMS[0]
    with pytest.raises(AssertionError):
        aot_smoke.run_mesh(((name, program, shape, rows, shards, b1, reduces // 2, *rest),),
                           log=lambda _: None)
