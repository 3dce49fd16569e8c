"""The valley/ridge reference's rotation and convolution against scipy.

``reference.valley_ridge.rotated`` of a stack's ``spline_coefficients``
against ``scipy.ndimage.rotate(order=2, reshape=True, mode="constant",
cval=-9999)`` itself: the same shape, the same -9999 pixels, and the
values within 1e-12 of the stack's largest. The stacks: the valley kernels
of the reference script's flats, the ridge kernels (negated) of its
ridge flats, and a stack drawn from a fixed seed, whose planes vary along
x as well (the kernels are constant along x before they turn). Kernels
exist at odd sizes only, so the even size takes the drawn stack alone.
153 px at 34, 56, 124 and 146 degrees is where float32 coordinates put
support pixels on the other side of scipy's edge test.

``stack_convolution`` against ``scipy.signal.convolve(..., mode="same")``
of the 3-D stack, with kernels smaller and larger than the field (the
crop to the taps that reach a grid pixel) and 1 to 4 flats.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy import ndimage, signal

from portbench.reference import valley_ridge as vr

ANGLES = (0, 1, 34, 45, 56, 89, 90, 124, 146, 179)
SIZES = (5, 8, 39, 77, 153, 155, 219, 229, 383)
TOL = 1e-12


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _stack(kind: str, size: int) -> np.ndarray:
    if kind == "valley":
        return vr.valley_kernels(size, (0, 0.2, 0.4))
    if kind == "ridge":
        return -vr.valley_kernels(size, (0, 0.15, 0.3))
    return np.random.default_rng(size).standard_normal((3, size, size))


CASES = [(size, kind) for size in SIZES
         for kind in (("valley", "ridge", "drawn") if size % 2 else ("drawn",))]


@pytest.mark.parametrize("size, kind", CASES)
def test_rotation_is_scipys(size, kind):
    stack = _stack(kind, size)
    coefficients = vr.spline_coefficients(torch.from_numpy(stack))
    scale = np.abs(stack).max()
    for angle in ANGLES:
        want = ndimage.rotate(stack, float(angle), axes=(1, 2), reshape=True, order=2,
                              mode="constant", cval=vr.CVAL)
        got = vr.rotated(coefficients, float(angle)).numpy()
        assert got.shape == want.shape, angle
        outside = want == vr.CVAL
        np.testing.assert_array_equal(got == vr.CVAL, outside, err_msg=f"angle {angle}")
        np.testing.assert_allclose(got[~outside], want[~outside], rtol=0, atol=TOL * scale,
                                   err_msg=f"angle {angle}")


@pytest.mark.parametrize("flats", [1, 2, 3, 4])
@pytest.mark.parametrize("ky, kx", [(5, 7), (17, 11), (29, 40)])
def test_stack_convolution_is_scipys_3d_same(flats, ky, kx):
    rng = np.random.default_rng(100 * flats + ky)
    field = rng.standard_normal((12, 16))
    kernels = rng.standard_normal((flats, ky, kx))
    shape = vr.transform_shape(field.shape, max(ky, kx))
    spectrum = torch.fft.rfft2(torch.from_numpy(field), s=shape)
    got = vr.stack_convolution(spectrum, torch.from_numpy(kernels), shape, field.shape)
    want = signal.convolve(np.broadcast_to(field, (flats, *field.shape)), kernels, mode="same",
                           method="direct")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())
