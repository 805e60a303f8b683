"""The port's image codec (`data/codec.py` over `native/image_codec.cpp`)
against Pillow, on the CPU.

- PNG: Pillow's exact pixels and dtype (grey, RGB and RGBA at 8 bits;
  grey at 16 bits as uint16; 16-bit RGB as its high bytes), over images
  that Pillow writes with its adaptive row filters at several compression
  levels.
- JPEG: equal is the target, and the test accepts at most 1 level on at
  most 0.1% of the pixels (measured: 0 pixels off over every image here,
  on Pillow 12.1 with libjpeg-turbo), over random and smooth images of
  odd sizes, at qualities 1-100, 4:4:4, 4:2:2, 4:2:0 and grey, with
  restart markers and optimised Huffman tables.
- The committed fixtures under `tests/data_torch/` decode to the SHA-256
  digests of Pillow's decode that `digests.json` records (which
  `chip_smoke.py` checks on the card's machine, where there is no
  Pillow).
- Resize: Pillow's BILINEAR and NEAREST, bit for bit.
- Progressive, arithmetic-coded, palette and interlaced files raise
  `ValueError` naming the file.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from simplerecon_tpu_torch.data import codec
from simplerecon_tpu_torch.utils.visualization import encode_png
from test_torch_port_ops import few_torch_threads  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "data_torch")
# the JPEG tolerance: levels, and the share of pixels off
JPEG_LEVELS, JPEG_SHARE = 1, 1e-3


def pillow(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def saved(image: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, **kw)
    return buf.getvalue()


def random_images(rng, count: int, channels: int, dtype=np.uint8):
    """Odd sizes; every other image smooth (the case row filters and the
    DCT are made for), the others noise."""
    top = 65535 if dtype == np.uint16 else 255
    for i in range(count):
        h, w = rng.randint(1, 120), rng.randint(1, 120)
        if i % 2:
            yy, xx = np.mgrid[0:h, 0:w]
            img = (np.sin(yy[..., None] * 0.2 + xx[..., None] * 0.13
                          + np.arange(channels)) + 1) * (top // 2)
        else:
            img = rng.rand(h, w, channels) * top
        img = img.astype(dtype)
        yield img[..., 0] if channels == 1 else img


def png_16bit_colour(image: np.ndarray) -> bytes:
    """A 16-bit RGB or RGBA PNG (Pillow writes none)."""
    h, w, c = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.astype(">u2").view(np.uint8).reshape(h, -1)],
                          axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    return (codec.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 16, {3: 2, 4: 6}[c], 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["grey", "rgb", "rgba"])
def test_png_decodes_to_pillows_pixels(kind):
    rng = np.random.RandomState({"grey": 0, "rgb": 1, "rgba": 2}[kind])
    channels = {"grey": 1, "rgb": 3, "rgba": 4}[kind]
    cases = [saved(img, format="PNG", compress_level=int(rng.randint(0, 10)))
             for img in random_images(rng, 8, channels)]
    if kind == "grey":
        cases += [saved(img, format="PNG")
                  for img in random_images(rng, 8, 1, np.uint16)]
    else:
        cases += [png_16bit_colour(img)
                  for img in random_images(rng, 4, channels, np.uint16)]
    for data in cases:
        got, want = codec.decode_png(data), pillow(data)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "grey"])
def test_jpeg_decodes_to_pillows_pixels(sampling):
    rng = np.random.RandomState(len(sampling) + ord(sampling[-1]))
    channels = 1 if sampling == "grey" else 3
    off, pixels = 0, 0
    for i, img in enumerate(random_images(rng, 24, channels)):
        kw = dict(format="JPEG", quality=int(rng.randint(1, 101)))
        if channels == 3:
            kw["subsampling"] = sampling
        if i % 3 == 0:
            kw["restart_marker_blocks"] = int(rng.randint(1, 5))
        if i % 4 == 1:
            kw["optimize"] = True
        data = saved(img, **kw)
        got, want = codec.decode_jpeg(data), pillow(data)
        assert got.dtype == want.dtype and got.shape == want.shape
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= JPEG_LEVELS
        off += int((diff > 0).sum())
        pixels += diff.size
    assert off <= JPEG_SHARE * pixels, (off, pixels)


def test_committed_fixtures_decode_to_pillows_digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    assert sum(os.path.getsize(os.path.join(FIXTURES, name))
               for name in digests) < 512 * 1024
    assert {"jpeg_444.jpg", "jpeg_422_restart.jpg", "jpeg_420.jpg",
            "jpeg_968x1296.jpg", "png_rgb8_480x640.png",
            "png_depth16_480x640.png"} <= set(digests)
    for name, want in digests.items():
        path = os.path.join(FIXTURES, name)
        got = codec.read_image(path)
        assert (list(got.shape), str(got.dtype)) == (want["shape"],
                                                     want["dtype"]), name
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
        np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    with open(os.path.join(FIXTURES, "jpeg_422_restart.jpg"), "rb") as f:
        data = f.read()
    assert any(bytes([0xFF, 0xD0 + i]) in data for i in range(8))


def test_resize_is_pillows():
    rng = np.random.RandomState(3)
    sizes = [(968, 1296, 384, 512), (480, 640, 192, 256), (480, 640, 384,
                                                           512)]
    sizes += [(int(rng.randint(2, 150)), int(rng.randint(2, 150)),
               int(rng.randint(1, 150)), int(rng.randint(1, 150)))
              for _ in range(40)]
    for i, (h, w, oh, ow) in enumerate(sizes):
        if (oh, ow) == (h, w):
            ow += 1
        for channels in (1, 3):
            img = rng.randint(0, 256, (h, w, channels)).astype(np.uint8)
            img = img[..., 0] if channels == 1 else img
            for mode, flag in (("bilinear", Image.BILINEAR),
                               ("nearest", Image.NEAREST)):
                np.testing.assert_array_equal(
                    codec.resize(img, oh, ow, mode),
                    np.asarray(Image.fromarray(img).resize((ow, oh), flag)))
        depth = rng.randint(0, 65536, (h, w)).astype(np.uint16)
        got = codec.resize(depth, oh, ow, "nearest")
        want = np.asarray(Image.fromarray(depth).resize((ow, oh),
                                                        Image.NEAREST))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_refused_jpegs_raise_naming_the_file():
    img = np.random.RandomState(4).randint(0, 256, (24, 32, 3)).astype(
        np.uint8)
    progressive = saved(img, format="JPEG", progressive=True)
    with pytest.raises(ValueError, match="prog.jpg: a progressive JPEG"):
        codec.decode_jpeg(progressive, "prog.jpg")
    # the same file with its frame marker turned into SOF9 (arithmetic)
    baseline = saved(img, format="JPEG")
    sof = baseline.index(b"\xff\xc0")
    arithmetic = baseline[:sof + 1] + b"\xc9" + baseline[sof + 2:]
    with pytest.raises(ValueError, match="arith.jpg: an arithmetic-coded"):
        codec.decode_jpeg(arithmetic, "arith.jpg")
    with pytest.raises(ValueError, match="x.bin: neither a PNG nor a JPEG"):
        codec.decode_image(b"GIF89a", "x.bin")


def test_refused_pngs_raise_naming_the_file():
    img = np.random.RandomState(5).randint(0, 256, (8, 8, 3)).astype(
        np.uint8)
    palette = io.BytesIO()
    Image.fromarray(img).convert("P").save(palette, format="PNG")
    with pytest.raises(ValueError, match="p.png: a palette PNG"):
        codec.decode_png(palette.getvalue(), "p.png")
    # Adam7: the interlace byte of IHDR set (the header's CRC redone)
    data = bytearray(encode_png(img))
    data[28] = 1
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29]))
                              & 0xFFFFFFFF)
    with pytest.raises(ValueError, match="i.png: an interlaced"):
        codec.decode_png(bytes(data), "i.png")


def test_encode_png_writes_what_pillow_reads():
    rng = np.random.RandomState(6)
    for img in (rng.randint(0, 65536, (17, 23)).astype(np.uint16),
                rng.randint(0, 256, (17, 23, 3)).astype(np.uint8),
                rng.randint(0, 256, (17, 23)).astype(np.uint8)):
        data = encode_png(img)
        want = pillow(data)
        assert want.dtype == img.dtype
        np.testing.assert_array_equal(want, img)
        np.testing.assert_array_equal(codec.decode_png(data), img)
