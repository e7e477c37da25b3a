"""The level-batched kernel wrappers on the CPU (their plain versions)
against the JAX package, level by level, on a 3-level pyramid of a 96x128
rendered frame.

Kernel A's maps equal the Pallas kernel's (interpret mode) and the jnp
path's exactly. Kernel B's angles agree with the Pallas kernel's within
1e-3 rad and its bits on > 99.5% (the Pallas kernel rotates by the
normalised moments, the plain version by cos/sin of the angle); given the
same angles, its words equal the jnp path's exactly, and its ±1 rows equal
``unpack_to_pm1`` of its words exactly. The kernels themselves are checked
against these plain versions on the card in ``test_torch_cuda.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import rendered_frame, wrapped_angle_error

from orbslam_in_practice_tpu.frontend.orb import ORBExtractor as JaxExtractor
from orbslam_in_practice_tpu.ops import fast as jfast
from orbslam_in_practice_tpu.ops import hamming as jham
from orbslam_in_practice_tpu.ops import image as jimage
from orbslam_in_practice_tpu.ops import orb as jorb
from orbslam_in_practice_tpu.ops.pallas_fast import fast_score_nms as pallas_fast_score_nms
from orbslam_in_practice_tpu.ops.pallas_patch import orb_patch_features as pallas_patch
from orbslam_in_practice_tpu_torch.bench_kernels import fast_arcs
from orbslam_in_practice_tpu_torch.frontend.orb import ORBExtractor
from orbslam_in_practice_tpu_torch.ops import cuda_patch
from orbslam_in_practice_tpu_torch.ops.cuda_fast import fast_score_nms, fast_score_nms_levels
from orbslam_in_practice_tpu_torch.ops.cuda_patch import (
    orb_patch_features,
    orb_patch_features_levels,
    orb_patch_features_levels_plain,
)
from orbslam_in_practice_tpu_torch.ops.hamming import unpack_bits, unpack_to_pm1
from orbslam_in_practice_tpu_torch.ops.image import _gauss_kernel7, build_pyramid
from orbslam_in_practice_tpu_torch.ops.orb import level_budgets, orb_pattern, select_keypoints

torch.set_num_threads(2)

ANGLE_TOL = 1e-3
BIT_TOL = 0.005
N_LEVELS = 3


def _pyramid():
    img = torch.from_numpy(rendered_frame(128, 96, seed=5))
    return build_pyramid(img, N_LEVELS, 1.2)


def _keypoints(levels, n_features=48):
    """select_keypoints per level at the budgets of ``n_features``:
    (yx (N, 2) int32, level_start, valid (N,))."""
    picks = [
        select_keypoints(fast_score_nms_levels([img])[0], budget)
        for img, budget in zip(levels, level_budgets(n_features, len(levels), 1.2))
    ]
    start = np.concatenate([[0], np.cumsum([len(p[0]) for p in picks])]).tolist()
    return torch.cat([p[0] for p in picks]), start, torch.cat([p[2] for p in picks])


def test_fast_levels_match_jax_per_level():
    levels = _pyramid()
    before = fast_score_nms.launches
    got = fast_score_nms_levels(levels)
    assert fast_score_nms.launches == before  # the plain version on the CPU
    assert len(got) == N_LEVELS
    for img, score in zip(levels, got):
        x = jnp.asarray(img.numpy())
        assert score.shape == img.shape
        assert np.array_equal(score.numpy(), np.asarray(pallas_fast_score_nms(x, interpret=True)))
        assert np.array_equal(score.numpy(), np.asarray(jfast.nms3x3(jfast.fast_score(x))))
        assert (score > 0).sum() > 20


def test_compass_test_passes_every_scoring_pixel():
    """Kernel A scores only the arcs that pass its compass test; every pixel
    with a FAST score above 0 in the JAX package passes it."""
    for img in _pyramid():
        bright, dark = fast_arcs(img)
        score = np.asarray(jfast.fast_score(jnp.asarray(img.numpy())))
        assert (score > 0).sum() > 100
        assert not ((score > 0) & ~(bright | dark).numpy()).any()
        assert (bright | dark).sum() < bright.numel()


def test_patch_levels_match_jax_per_level():
    levels = _pyramid()
    yx, start, valid = _keypoints(levels)
    assert valid.sum() > 30
    pattern = orb_pattern()
    before = orb_patch_features.launches
    angle, desc, pm1 = orb_patch_features_levels(levels, yx, start, pattern)
    assert orb_patch_features.launches == before
    assert angle.shape == (yx.shape[0],) and desc.shape == (yx.shape[0], 8) and pm1.shape == (yx.shape[0], 256)
    assert desc.dtype == torch.int32 and pm1.dtype == torch.int8
    for lvl, img in enumerate(levels):
        a, b = start[lvl], start[lvl + 1]
        v = valid[a:b].numpy()
        x = jnp.asarray(img.numpy())
        yx_l = jnp.asarray(yx[a:b].numpy())
        ang_p, bits_p = pallas_patch(x, yx_l, interpret=True)
        bits = unpack_bits(desc[a:b]).numpy()
        assert wrapped_angle_error(angle[a:b].numpy(), np.asarray(ang_p))[v].max() < ANGLE_TOL
        assert (bits[v] != np.asarray(bits_p)[v]).mean() < BIT_TOL
        # the same angles: the jnp path's words, exactly
        want = jorb.brief_descriptors(jimage.gaussian_blur7(x), yx_l, jnp.asarray(angle[a:b].numpy()))
        assert np.array_equal(desc[a:b].numpy().view(np.uint32), np.asarray(want))


def test_patch_levels_pm1_is_unpacked_words():
    levels = _pyramid()
    yx, start, _ = _keypoints(levels)
    _, desc, pm1 = orb_patch_features_levels(levels, yx, start, orb_pattern())
    assert torch.equal(pm1, unpack_to_pm1(desc))
    want = np.asarray(jham.unpack_to_pm1(jnp.asarray(desc.numpy().view(np.uint32))))
    assert np.array_equal(pm1.numpy(), want)


def test_patch_levels_with_an_empty_level():
    levels = _pyramid()
    yx, start, _ = _keypoints(levels)
    keep = torch.cat([yx[start[0] : start[1]], yx[start[2] : start[3]]])
    n0 = start[1] - start[0]
    angle, desc, pm1 = orb_patch_features_levels(levels, keep, [0, n0, n0, keep.shape[0]], orb_pattern())
    for (a, b), img, rows in ((start[0:2], levels[0], slice(0, n0)), (start[2:4], levels[2], slice(n0, None))):
        ang_l, desc_l = orb_patch_features(img, yx[a:b], orb_pattern())
        assert torch.equal(angle[rows], ang_l) and torch.equal(desc[rows], desc_l)
    assert torch.equal(pm1, unpack_to_pm1(desc))


def test_patch_levels_reject_bad_level_start():
    levels = _pyramid()
    yx, start, _ = _keypoints(levels)
    for bad in (start[:-1], [1, *start[1:]], [*start[:-1], start[-1] + 1], [0, start[2], start[1], start[3]]):
        with pytest.raises(ValueError):
            orb_patch_features_levels_plain(levels, yx, bad, orb_pattern())


def test_extractor_with_an_empty_budget_level_matches_jax():
    """4 features over 8 levels give budgets (1, 1, 1, 1, 0, 0, 0, 1): the
    empty levels are skipped by both extractors."""
    img = rendered_frame(320, 240, seed=6)
    ex = ORBExtractor(4, 1.2, 8)
    assert 0 in ex.budgets and ex.level_start == [0, 1, 2, 3, 4, 5]
    with torch.no_grad():
        ft = ex(torch.from_numpy(img))
    fj = JaxExtractor(4, 1.2, 8, use_pallas=False)(jnp.asarray(img))
    assert np.array_equal(ft.octave.numpy(), np.asarray(fj.octave))
    lvl0 = np.asarray(fj.octave) == 0
    for name in ("xy_raw", "response", "valid"):
        assert np.array_equal(getattr(ft, name).numpy()[lvl0], np.asarray(getattr(fj, name))[lvl0]), name
    assert torch.equal(ft.desc_pm1, unpack_to_pm1(ft.desc_packed))


def test_kernel_gaussian_weights_equal_the_plain_ones():
    """csrc/orb_patch.cu writes the blur's weights as float32 literals."""
    src = (Path(cuda_patch.__file__).parent.parent / "csrc" / "orb_patch.cu").read_text()
    g = dict(re.findall(r"constexpr float (G\d) = (0x[0-9a-fp.+-]+)f;", src))
    weights = [float.fromhex(g[f"G{min(t, 6 - t)}"]) for t in range(7)]
    assert np.array_equal(np.float32(weights), _gauss_kernel7(2.0))
