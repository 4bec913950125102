"""Port resize / normalize / host decode against the TF goldens and the JAX
package: TF half-pixel bilinear at 2e-6 of the golden (the JAX suite's
bound) and 1e-6 of JAX. The host resize is held at 1e-6 of the TF-grid
resize and at 2e-4 of the JAX package's cv2 resize: cv2 INTER_LINEAR
interpolates with fixed-point coefficients and lands up to 5.8e-5 (480x640
input) and 1.4e-4 (1080x1920) from the exact TF grid, on [0,1] images where
one 8-bit step is 3.9e-3."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pldepth_torch.data import io as tio
from pldepth_torch.data.preprocess import normalize_images
from pldepth_torch.ops.fused_tail import fused_upsample2x_conv
from pldepth_torch.ops.resize import resize_bilinear, upsample2x_bilinear
from pldepth_tpu.data import io as jio
from pldepth_tpu.data.preprocess import normalize_images as j_normalize
from pldepth_tpu.ops import fused_tail as j_fused_tail
from pldepth_tpu.ops.resize import resize_bilinear as j_resize
from pldepth_tpu.ops.resize import upsample2x_bilinear as j_upsample

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tf_resize.npz")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_upsample2x_matches_keras_golden(golden):
    got = upsample2x_bilinear(torch.from_numpy(golden["src"])).numpy()
    np.testing.assert_allclose(got, golden["upsample2x"], atol=2e-6)


@pytest.mark.parametrize("key,size", [("bilinear_up_64x96", (64, 96)),
                                      ("bilinear_down_16x24", (16, 24))])
def test_resize_bilinear_matches_tf_golden(golden, key, size):
    got = resize_bilinear(torch.from_numpy(golden["src"][0]), size).numpy()
    np.testing.assert_allclose(got, golden[key][0], atol=2e-6)


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 16, 12, 8)])
def test_upsample2x_matches_jax(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = upsample2x_bilinear(torch.from_numpy(x)).numpy()
    want = np.asarray(j_upsample(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("size", [(448, 448), (33, 21)])
def test_resize_matches_jax(size):
    x = np.random.default_rng(2).uniform(size=(2, 48, 64, 3)).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(x), size).numpy()
    want = np.asarray(j_resize(jnp.asarray(x), size))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("mode", ["effnet", "caffe", "none"])
def test_normalize_images_matches_jax(mode):
    x = np.random.default_rng(3).uniform(size=(2, 8, 8, 3)).astype(np.float32)
    got = normalize_images(torch.from_numpy(x), mode).numpy()
    want = np.asarray(j_normalize(jnp.asarray(x), mode))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_normalize_unknown_mode_raises():
    with pytest.raises(ValueError):
        normalize_images(torch.zeros(1, 2, 2, 3), "nope")


def test_host_resize_matches_jax_cv2():
    """The port resizes on the host with torch, the JAX package with cv2
    INTER_LINEAR (same half-pixel grid): a 480x640 photo-sized input."""
    img = np.random.default_rng(4).uniform(size=(480, 640, 3)).astype(np.float32)
    got = tio.resize_bilinear(img, (448, 448))
    want = jio.resize_bilinear(img, (448, 448))
    exact = np.asarray(j_resize(jnp.asarray(img), (448, 448)))
    assert got.shape == want.shape == (448, 448, 3)
    assert np.abs(got - exact).max() < 1e-6
    assert np.abs(got - want).max() < 2e-4
    gray = tio.resize_bilinear(img[..., 0], (40, 30))
    assert gray.shape == jio.resize_bilinear(img[..., 0], (40, 30)).shape


def test_read_image_matches_jax(tmp_path):
    from PIL import Image

    arr = np.random.default_rng(5).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(tio.read_image(path), jio.read_image(path))


@pytest.mark.parametrize("f", [1, 4])
def test_fused_tail_matches_jax_and_exact(f):
    """The fused upsample+conv tail: equal to the JAX one and to the
    two-step tail it replaces (f32)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 7, 5)).astype(np.float32)
    w_hwio = rng.normal(size=(3, 3, 5, f)).astype(np.float32)
    b = rng.normal(size=(f,)).astype(np.float32)
    w = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    got = fused_upsample2x_conv(torch.from_numpy(x), w, torch.from_numpy(b)).numpy()
    want = np.asarray(j_fused_tail.fused_upsample2x_conv(
        jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(b)))
    exact = np.asarray(j_fused_tail._exact_tail(jnp.asarray(x), jnp.asarray(w_hwio))) + b
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, exact, atol=1e-5)
