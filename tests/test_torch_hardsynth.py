"""The port's copy of the hard synthetic pair generator against the JAX
package's: the same ``RandomState`` gives bit-equal arrays, for both scene
families, every sensor knob (overlap, noise, density mismatch, clutter) and
the scene samplers themselves. Tolerance: none (``np.array_equal``)."""

import numpy as np
import pytest

from bufferx_tpu.data import hardsynth as jhs
from bufferx_tpu_torch.data import hardsynth as ths


@pytest.mark.parametrize("family", ["eval", "train"])
@pytest.mark.parametrize("knobs", [
    dict(overlap_ratio=0.3),
    dict(overlap_ratio=0.5, noise=0.0125, density_ratio=4.0),
    dict(overlap_ratio=0.75, noise=0.025, density_ratio=10.0,
         outlier_frac=0.2),
    dict(overlap_ratio=0.5, outlier_frac=0.1, extent=1.5, max_trans=0.2),
])
def test_hard_pair_bit_equal(family, knobs):
    for seed in (0, 7):
        want = jhs.hard_pair(np.random.RandomState(seed), family=family,
                             num_points=3000, **knobs)
        got = ths.hard_pair(np.random.RandomState(seed), family=family,
                            num_points=3000, **knobs)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w)


@pytest.mark.parametrize("scene", ["train_scene", "eval_scene"])
def test_scene_samples_bit_equal(scene):
    """The scene families and the area-weighted sampler, draw for draw."""
    rs_j, rs_t = np.random.RandomState(3), np.random.RandomState(3)
    pj = jhs.sample_scene(getattr(jhs, scene)(rs_j), rs_j, 2500)
    pt = ths.sample_scene(getattr(ths, scene)(rs_t), rs_t, 2500)
    assert np.array_equal(pt, pj)
    # the streams stay in step after the scene
    assert rs_j.randint(1 << 30) == rs_t.randint(1 << 30)


def test_training_stream_is_left_out():
    """The training stream belongs to the training slice (it builds jax
    batches); the port's copy has the four evaluation functions only."""
    assert sorted(ths.__all__) == ["eval_scene", "hard_pair", "sample_scene",
                                   "train_scene"]
    assert not hasattr(ths, "hard_training_stream")
