"""Image decoding and resampling without Pillow, for the file-backed
dataset readers: the native library `native/image_codec.cpp` (built with
g++ at first use, bound with ctypes, which releases the GIL) behind
numpy functions that give what `np.asarray(PIL.Image.open(path))` and
`Image.resize` give.

- PNG: bit depths 8 and 16, colour types 0 (grey), 2 (RGB) and 6 (RGBA),
  not interlaced. 16-bit grey comes back as uint16 (Pillow's "I;16");
  16-bit RGB and RGBA as their samples' high bytes in uint8, as Pillow
  reads them. Python's zlib inflates; the native side undoes the row
  filters.
- JPEG: 8-bit baseline or extended sequential Huffman, grey or 3
  components at 4:4:4, 4:2:2 or 4:2:0, with restart intervals; decoded
  as libjpeg-turbo's defaults decode it (islow IDCT, fancy upsampling),
  Pillow's bits.
- Refused with `ValueError` naming the file: palette, interlaced, 1-, 2-
  and 4-bit and grey-alpha PNGs; progressive, arithmetic-coded, lossless,
  12-bit, CMYK and other subsampled JPEGs.
- `resize`: Pillow's BILINEAR for 8-bit images (antialiased when it
  shrinks) and NEAREST for any.
- `encode_jpeg`: RGB as a baseline JPEG, 4:2:0, the IJG tables scaled to
  a quality (75 by default, as Pillow saves), the standard Huffman
  tables, a JFIF header; libjpeg-turbo's colour conversion, chroma
  filter, edge padding and islow forward DCT, so the coefficients are
  the ones Pillow writes.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from simplerecon_tpu_torch import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"

# the native decoder's error codes
JPEG_ERRORS = {
    1: "not a JPEG file",
    2: "a progressive JPEG: only baseline and sequential JPEGs are decoded",
    3: "an arithmetic-coded JPEG: only Huffman coding is decoded",
    4: "a lossless or hierarchical JPEG: only baseline and sequential "
       "JPEGs are decoded",
    5: "a JPEG of a precision other than 8 bits",
    6: "a JPEG subsampling other than 4:4:4, 4:2:2 or 4:2:0",
    7: "a JPEG with other than 1 or 3 components (CMYK?)",
    8: "a corrupt JPEG",
    9: "a JPEG larger than its header says",
}

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _lib():
    lib = native.load_library("image_codec")
    if not getattr(lib, "_typed", False):
        lib.png_unfilter.argtypes = [_U8P, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, _U8P]
        lib.png_unfilter.restype = ctypes.c_int
        lib.jpeg_info.argtypes = [_U8P, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int)]
        lib.jpeg_info.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [_U8P, ctypes.c_int64, _U8P,
                                    ctypes.c_int64]
        lib.jpeg_decode.restype = ctypes.c_int
        lib.resize_bilinear_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, _U8P, ctypes.c_int,
                                           ctypes.c_int]
        lib.resize_bilinear_u8.restype = None
        lib.resize_nearest.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, _U8P, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int]
        lib.resize_nearest.restype = None
        lib.jpeg_encode.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, _U8P, ctypes.c_int64]
        lib.jpeg_encode.restype = ctypes.c_int64
        lib._typed = True
    return lib


def _ptr(a) -> ctypes.POINTER(ctypes.c_uint8):
    if isinstance(a, (bytes, bytearray)):
        a = np.frombuffer(a, np.uint8)
    return a.ctypes.data_as(_U8P)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The pixels of a PNG file's bytes: (h, w) or (h, w, c)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{name}: broken PNG chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{name}: a PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if color == 3:
        raise ValueError(f"{name}: a palette PNG is not decoded")
    if interlace:
        raise ValueError(f"{name}: an interlaced (Adam7) PNG is not decoded")
    if color not in (0, 2, 6):
        raise ValueError(f"{name}: PNG colour type {color} is not decoded "
                         "(grey, RGB and RGBA are)")
    if depth not in (8, 16):
        raise ValueError(f"{name}: a {depth}-bit PNG is not decoded "
                         "(8- and 16-bit ones are)")
    channels = {0: 1, 2: 3, 6: 4}[color]
    bpp = channels * depth // 8
    raw = zlib.decompress(b"".join(idat))
    out = np.empty((h, w * bpp), np.uint8)
    err = _lib().png_unfilter(_ptr(raw), len(raw), h, w * bpp, bpp,
                              _ptr(out))
    if err:
        raise ValueError(f"{name}: corrupt PNG data (row {err})")
    if depth == 16:
        samples = out.view(">u2").reshape(h, w, channels)
        if channels == 1:
            return samples[..., 0].astype(np.uint16)
        # Pillow reads 16-bit colour as 8-bit: the high bytes
        return (samples >> 8).astype(np.uint8)
    return out.reshape(h, w) if channels == 1 else out.reshape(h, w,
                                                                channels)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The pixels of a JPEG file's bytes: (h, w) grey or (h, w, 3) RGB,
    uint8."""
    lib = _lib()
    whc = (ctypes.c_int * 3)()
    err = lib.jpeg_info(_ptr(data), len(data), whc)
    if err:
        raise ValueError(f"{name}: {JPEG_ERRORS.get(err, err)}")
    w, h, c = whc
    out = np.empty((h, w, c), np.uint8)
    err = lib.jpeg_decode(_ptr(data), len(data), _ptr(out), out.size)
    if err:
        raise ValueError(f"{name}: {JPEG_ERRORS.get(err, err)}")
    return out[..., 0] if c == 1 else out


def encode_jpeg(image: np.ndarray, quality: int = 75) -> bytes:
    """An (h, w, 3) uint8 RGB image as the bytes of a baseline JPEG
    file."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("encode_jpeg takes (h, w, 3) uint8 RGB images, not "
                         f"{image.dtype} {image.shape}")
    h, w = image.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a JPEG cannot hold {h}x{w} pixels")
    # six blocks an MCU, each at most 64 codes of 27 bits, every byte
    # stuffed: far more than any image needs
    capacity = ((h + 15) // 16) * ((w + 15) // 16) * 6 * 432 + 1024
    out = np.empty(capacity, np.uint8)
    n = _lib().jpeg_encode(_ptr(image), h, w, int(quality), _ptr(out),
                           capacity)
    if n < 0:
        raise RuntimeError("the JPEG encoder overran its buffer")
    return out[:n].tobytes()


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG's or a JPEG's pixels, by the file's signature."""
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data, name)
    if data[:2] == JPEG_SIGNATURE:
        return decode_jpeg(data, name)
    raise ValueError(f"{name}: neither a PNG nor a JPEG file")


def read_image(path: str) -> np.ndarray:
    """The pixels of the PNG or JPEG file at `path`, as
    `np.asarray(PIL.Image.open(path))` gives them."""
    with open(path, "rb") as f:
        return decode_image(f.read(), path)


def resize(image: np.ndarray, height: int, width: int,
           mode: str = "bilinear") -> np.ndarray:
    """`Image.resize((width, height), BILINEAR or NEAREST)` of an (h, w) or
    (h, w, c) image. Bilinear takes 8-bit grey or RGB only."""
    image = np.ascontiguousarray(image)
    h, w = image.shape[:2]
    out = np.empty((height, width) + image.shape[2:], image.dtype)
    if mode == "bilinear":
        channels = 1 if image.ndim == 2 else image.shape[2]
        if image.dtype != np.uint8 or channels not in (1, 3):
            raise ValueError("bilinear resize takes 8-bit grey or RGB "
                             f"images, not {image.dtype} x{channels}")
        _lib().resize_bilinear_u8(_ptr(image), h, w, channels, _ptr(out),
                                  height, width)
    elif mode == "nearest":
        pixel = image.itemsize * (1 if image.ndim == 2 else image.shape[2])
        # Pillow steps the position for 8-bit images and computes it for
        # 16-bit ones
        _lib().resize_nearest(_ptr(image.view(np.uint8)), h, w, pixel,
                              _ptr(out.view(np.uint8)), height, width,
                              int(image.dtype == np.uint8))
    else:
        raise ValueError(f"unknown resize mode {mode!r}")
    return out
