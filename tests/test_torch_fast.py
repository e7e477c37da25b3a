"""Kernel A parity: the port's FAST score + 3x3 NMS against the JAX package
(jnp path and the Pallas kernel in interpret mode). The CUDA kernel is
checked against its plain version on the card in ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam_in_practice_tpu.ops import fast as jfast
from orbslam_in_practice_tpu.ops.pallas_fast import fast_score_nms as pallas_fast_score_nms
from orbslam_in_practice_tpu_torch.ops import fast as tfast
from orbslam_in_practice_tpu_torch.ops.cuda_fast import fast_score_nms, fast_score_nms_plain

torch.set_num_threads(2)

SHAPES = [(120, 161), (96, 128)]


def _image(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_exactly(shape):
    img = _image(shape)
    want = np.asarray(jfast.nms3x3(jfast.fast_score(jnp.asarray(img))))
    got = tfast.nms3x3(tfast.fast_score(torch.from_numpy(img))).numpy()
    assert np.array_equal(got, want)
    assert (want > 0).sum() > 100


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    img = _image(shape, seed=1)
    want = np.asarray(pallas_fast_score_nms(jnp.asarray(img), interpret=True))
    got = fast_score_nms_plain(torch.from_numpy(img)).numpy()
    assert np.array_equal(got[3:-3, 3:-3], want[3:-3, 3:-3])
    assert not got[:3].any() and not got[-3:].any() and not got[:, :3].any() and not got[:, -3:].any()


def test_wrapper_runs_plain_version_on_cpu():
    img = torch.from_numpy(_image((64, 80), seed=2))
    before = fast_score_nms.launches
    assert torch.equal(fast_score_nms(img), fast_score_nms_plain(img))
    assert fast_score_nms.launches == before


def test_fast_corners_np_matches_jax_and_the_score():
    """The numpy golden models agree exactly, and a pixel is a corner at a
    threshold iff its FAST score is above it."""
    img = _image((24, 30), seed=3)
    got = tfast.fast_corners_np(img, 20.0)
    assert np.array_equal(got, jfast.fast_corners_np(img, 20.0)) and got.sum() > 10
    score = tfast.fast_score(torch.from_numpy(img)).numpy()
    assert np.array_equal(got, score > 20.0)


def test_hamming_np_matches_jax():
    from orbslam_in_practice_tpu.ops.hamming import hamming_np as jax_hamming_np
    from orbslam_in_practice_tpu_torch.ops.hamming import hamming_matrix, hamming_np, pack_bits, unpack_to_pm1

    bits = np.random.default_rng(4).integers(0, 2, (13, 256))
    words = pack_bits(torch.from_numpy(bits)).numpy()  # int32
    want = jax_hamming_np(words.view(np.uint32)[:5], words.view(np.uint32))
    got = hamming_np(words[:5], words)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    pm1 = unpack_to_pm1(torch.from_numpy(words))
    assert np.array_equal(got, hamming_matrix(pm1[:5], pm1).numpy())
