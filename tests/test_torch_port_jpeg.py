"""The port's baseline JPEG encoder (`data/codec.py::encode_jpeg`, in
`native/image_codec.cpp`) against Pillow, on the CPU.

At quality 75 (Pillow's default, which the JAX package's `.sens` export
uses), 50 and 90, on seeded images of even, odd and full ScanNet sizes:
Pillow's decoder and the port's read the encoder's file to the same
pixels, which are the pixels of Pillow's own file at that quality, so
its PSNR against the source is Pillow's (held within PSNR_TOL dB, as
asked of it; measured 0). The encoder copies libjpeg-turbo's colour
conversion, chroma filter, edge padding, islow forward DCT and
quantisation, so its scan data (from the SOS marker on) are the bytes
Pillow writes; that is held too. `SensorData.export_color_images` over a
`.sens` file of `testing.write_sens` writes the files the JAX method
writes, byte for byte, at the frames' size and resized (the
`.sens` reader's other exports are held in
`test_torch_port_datasets.py`).
"""

import io

import numpy as np
import pytest
from PIL import Image

from simplerecon_tpu_torch.data import codec

PSNR_TOL = 0.1


def seeded_image(h, w, seed=0):
    """Smooth colour waves with noise: flat and busy blocks both."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / (5.0 + 3 * c) + c)
                    * np.cos(yy / 7.0) for c in range(3)], -1)
    return np.clip(img + rng.randn(h, w, 3) * 12, 0, 255).astype(np.uint8)


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def pillow_jpeg(img, quality=None):
    buf = io.BytesIO()
    kw = {} if quality is None else {"quality": quality}
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def scan_data(jpeg: bytes) -> bytes:
    return jpeg[jpeg.index(b"\xff\xda"):]


@pytest.mark.parametrize("shape", [(48, 64), (37, 53), (480, 640)],
                         ids=["48x64", "37x53", "480x640"])
def test_encoder_reads_as_pillows_file(shape):
    img = seeded_image(*shape)
    ours = codec.encode_jpeg(img)
    pillows = pillow_jpeg(img)
    by_pillow = np.asarray(Image.open(io.BytesIO(ours)))
    assert by_pillow.shape == img.shape
    np.testing.assert_array_equal(codec.decode_image(ours), by_pillow)
    reference = np.asarray(Image.open(io.BytesIO(pillows)))
    assert abs(psnr(by_pillow, img) - psnr(reference, img)) <= PSNR_TOL
    np.testing.assert_array_equal(by_pillow, reference)
    assert scan_data(ours) == scan_data(pillows)


@pytest.mark.parametrize("quality", [50, 90])
def test_quality_scales_the_tables(quality):
    img = seeded_image(40, 72, seed=quality)
    ours = codec.encode_jpeg(img, quality=quality)
    pillows = pillow_jpeg(img, quality)
    assert scan_data(ours) == scan_data(pillows)
    assert len(ours) != len(codec.encode_jpeg(img))
    np.testing.assert_array_equal(codec.decode_image(ours),
                                  np.asarray(Image.open(io.BytesIO(ours))))


def test_encoder_takes_rgb_bytes_only():
    with pytest.raises(ValueError, match="RGB"):
        codec.encode_jpeg(np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match="RGB"):
        codec.encode_jpeg(np.zeros((8, 8, 3), np.float32))


@pytest.mark.parametrize("size", [None, (30, 52)], ids=["as_is", "resized"])
def test_sens_colour_export_is_the_jax_export(tmp_path, size):
    import os
    from simplerecon_tpu.data.sens_reader import SensorData as JaxSensorData
    from simplerecon_tpu_torch.data.sens_reader import SensorData
    from simplerecon_tpu_torch.testing import write_sens
    path = str(tmp_path / "scan.sens")
    frames = [seeded_image(45, 61, seed=i) for i in range(3)]
    write_sens(path, [codec.encode_jpeg(f) for f in frames],
               [np.full((12, 16), 1000 + i) for i in range(3)],
               (45, 61), (12, 16))
    out = {}
    for tag, reader in (("port", SensorData), ("jax", JaxSensorData)):
        out[tag] = str(tmp_path / tag)
        reader(path).export_color_images(out[tag], frame_skip=2,
                                         image_size=size)
    names = sorted(os.listdir(out["jax"]))
    assert names == ["frame-000000.color.jpg", "frame-000002.color.jpg"]
    assert sorted(os.listdir(out["port"])) == names
    for name in names:
        with open(os.path.join(out["port"], name), "rb") as g, \
                open(os.path.join(out["jax"], name), "rb") as w:
            got, want = g.read(), w.read()
        assert codec.decode_image(got).shape == (size or (45, 61)) + (3,)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(got))),
                                      np.asarray(Image.open(io.BytesIO(want))))
        assert got == want, name
