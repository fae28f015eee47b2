"""The port's copy of the host JPEG runtime (``serve/framepump``): the cases
of tests/test_framepump.py, byte equality with the JAX package's build of
the same source, and the Pillow fallback where the library cannot be built."""

import io
import threading
import time

import numpy as np
import pytest
from PIL import Image

from live2diff_tpu_torch.serve import framepump

pytestmark = pytest.mark.skipif(
    not framepump.available(), reason="g++ or the libjpeg headers unavailable")


def _gradient(size=64):
    x = np.linspace(0, 255, size, dtype=np.uint8)
    img = np.stack(np.broadcast_arrays(x[None, :], x[:, None], x[None, :]), axis=-1)
    return np.ascontiguousarray(img.astype(np.uint8))


def test_jpeg_roundtrip():
    img = _gradient()  # smooth, so the JPEG loss is small
    data = framepump.encode_jpeg(img, quality=95)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    back = framepump.decode_jpeg(data)
    assert back.shape == img.shape
    assert np.abs(back.astype(int) - img.astype(int)).mean() < 5


def test_jpeg_interop_with_pil():
    img = np.zeros((32, 48, 3), np.uint8)
    img[:, :, 2] = 200
    data = framepump.encode_jpeg(img)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    assert pil.shape == (32, 48, 3)
    assert abs(int(pil[:, :, 2].mean()) - 200) < 6


def test_frame_ring_drop_oldest_and_blocking():
    ring = framepump.FrameRing(capacity=2)
    assert ring.pop(timeout_ms=30) is None  # empty -> timeout
    ring.push(b"a")
    ring.push(b"b")
    ring.push(b"c")  # drops "a"
    assert ring.dropped == 1
    assert ring.pop() == b"b"
    assert ring.pop() == b"c"
    assert len(ring) == 0

    result = []  # a blocking pop woken by a producer thread

    def consumer():
        result.append(ring.pop(timeout_ms=2000))

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.05)
    ring.push(b"late")
    t.join(timeout=3)
    assert result == [b"late"]


def test_encodes_and_decodes_as_the_jax_packages_build():
    from live2diff_tpu.serve import framepump as jax_framepump

    if not jax_framepump.available():
        pytest.skip("the JAX package's framepump could not be built")
    rs = np.random.RandomState(0)
    for img in (_gradient(), rs.randint(0, 256, (48, 80, 3)).astype(np.uint8)):
        ours = framepump.encode_jpeg(img, quality=85)
        assert ours == jax_framepump.encode_jpeg(img, quality=85)
        np.testing.assert_array_equal(framepump.decode_jpeg(ours),
                                      jax_framepump.decode_jpeg(ours))


def test_library_is_built_under_build_by_source_hash():
    path = framepump._lib_path()
    assert path.startswith(framepump.BUILD_DIR)
    assert path.endswith(".so") and "libframepump-" in path


def test_unavailable_library_returns_none(monkeypatch):
    monkeypatch.setattr(framepump, "_lib", None)
    monkeypatch.setattr(framepump, "_failed", True)
    assert not framepump.available()
    assert framepump.encode_jpeg(_gradient()) is None
    assert framepump.decode_jpeg(b"\xff\xd8\xff\xd9") is None
    with pytest.raises(RuntimeError, match="unavailable"):
        framepump.FrameRing()
