"""Port parity of ``bufferx_tpu_torch/core/se3.py:random_rotation`` against
``bufferx_tpu.core.se3.random_rotation``: the port takes the three uniform
draws that the JAX function makes from its key (``uniform(key, (3,))``)
as a tensor, and both give the same rotation within 1e-6 (``cos``/``sin``
round differently in XLA and in PyTorch by an ulp)."""

import jax
import numpy as np
import pytest
import torch

from bufferx_tpu.core import se3 as jse3
from bufferx_tpu_torch.core import se3 as tse3


@pytest.mark.parametrize("num_axis,magnitude",
                         [(0, 1.0), (1, 1.0), (1, 0.25), (3, 1.0), (3, 0.25)])
def test_random_rotation_matches_jax(num_axis, magnitude):
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (3,))))
        want = np.asarray(jse3.random_rotation(key, num_axis, magnitude))
        got = tse3.random_rotation(u, num_axis, magnitude)
        assert got.dtype == torch.float32 and got.shape == (3, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.numpy() @ got.numpy().T, np.eye(3),
                                   atol=1e-6)
        if num_axis == 1:     # about z, by the third draw
            assert float(got[2, 2]) == 1.0
            angle = float(torch.atan2(got[1, 0], got[0, 0])) % (2 * np.pi)
            want_angle = (float(u[2]) * 2 * np.pi * magnitude) % (2 * np.pi)
            assert min(abs(angle - want_angle),
                       2 * np.pi - abs(angle - want_angle)) < 1e-5


def test_random_rotation_follows_the_draws_device_and_dtype():
    u = torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)
    assert tse3.random_rotation(u).dtype == torch.float64
    eye = tse3.random_rotation(u, num_axis=0)
    assert torch.equal(eye, torch.eye(3, dtype=torch.float64))
    assert tse3.random_rotation(u[:3].float(), 3).device == u.device
