"""The port's load-time positional-embedding resize (bicubic operator,
``resize_pos_embed_np``, ``load_frozen_backbone`` of a cache saved at another
grid) vs the JAX package's, to 1e-6."""
import jax
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu import configs as jconfigs
from aa_clip_iqm_tpu import loader as jloader
from aa_clip_iqm_tpu.models import clip as jclip
from aa_clip_iqm_tpu.ops import interp as jinterp
from aa_clip_iqm_tpu_torch import configs as tconfigs
from aa_clip_iqm_tpu_torch import loader as tloader
from aa_clip_iqm_tpu_torch.models import clip as tclip
from aa_clip_iqm_tpu_torch.models import convert as tconvert
from aa_clip_iqm_tpu_torch.models.convert import init_clip_params_np, params_from_jax
from aa_clip_iqm_tpu_torch.ops import interp as tinterp

TOL = 1e-6


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("src,dst", [(24, 37), (37, 24), (24, 91), (5, 5), (1, 3)])
def test_bicubic_matrix_matches_jax(src, dst, antialias):
    np.testing.assert_array_equal(tinterp.bicubic_matrix(src, dst, antialias),
                                  jinterp.bicubic_matrix(src, dst, antialias))


@pytest.mark.parametrize("src,dst", [(24, 37), (24, 91), (37, 24)])
def test_resize_grid_bicubic_matches_jax(src, dst):
    grid = np.random.default_rng(src * dst).standard_normal((src, src, 8)).astype(np.float32)
    out = tinterp.resize_grid_bicubic(grid, (dst, dst))
    ref = jinterp.resize_grid_bicubic(grid, (dst, dst))
    assert out.shape == (dst, dst, 8) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("new_grid", [24, 37, 91])
def test_resize_pos_embed_matches_jax(new_grid):
    """ViT-L/14-336's native 24 x 24 grid to 518 px (37) and 1274 px (91)."""
    pos = np.random.default_rng(new_grid).standard_normal((24 * 24 + 1, 16)).astype(np.float32)
    out = tclip.resize_pos_embed_np(pos, new_grid)
    ref = jclip.resize_pos_embed_np(pos, new_grid)
    assert out.shape == (new_grid ** 2 + 1, 16)
    np.testing.assert_array_equal(out[0], pos[0])
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="not square"):
        tclip.resize_pos_embed_np(pos[:-1], new_grid)


@pytest.mark.parametrize("saved,wanted", [(56, 84), (84, 56)])
def test_load_frozen_backbone_resizes_like_jax(tmp_path, saved, wanted):
    """An .npz cached at one image size, loaded for another, equals the JAX
    package's load_frozen_backbone of the same file, leaf for leaf."""
    path = str(tmp_path / "backbone.npz")
    tconvert.save_params_npz(init_clip_params_np(tconfigs.tiny_test_config(saved), seed=3), path)
    tcfg = tconfigs.tiny_test_config(wanted)
    got = tloader.load_frozen_backbone(tcfg, path, device="cpu", dtype=torch.float32)
    jparams = jloader.load_frozen_backbone(jconfigs.tiny_test_config(wanted), path)
    want, _ = params_from_jax(jax.tree.map(np.asarray, jparams), None, tcfg, device="cpu",
                              dtype=torch.float32)
    assert got["visual"]["positional_embedding"].shape == (tcfg.clip.vision.grid ** 2 + 1, 64)
    flat_got, flat_want = dict(tconvert._flatten(got)), dict(tconvert._flatten(want))
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_allclose(np.asarray(flat_got[k]), np.asarray(flat_want[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
