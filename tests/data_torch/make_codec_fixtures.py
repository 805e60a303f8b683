"""Writes the image codec's fixtures beside this file, with Pillow, and
the SHA-256 digest of Pillow's decode of each (`digests.json`), which
`chip_smoke.py` and `tests/test_torch_port_codec.py` hold the port's
decoder to:

- JPEGs of a smooth 61x83 image at 4:4:4, 4:2:2 (with restart markers
  every 3 MCUs) and 4:2:0, and in grey;
- a 968x1296 JPEG (ScanNet's colour size, 4:2:0) of the synthetic room;
- 480x640 PNGs: a smooth 8-bit RGB image with 2 levels of noise, and
  the synthetic room's 16-bit grey depth in millimetres;
- `jpeg_encode.json`: the SHA-256 of the JPEG file Pillow's default save
  writes for the 968x1296 JPEG's pixels resized by BILINEAR to 480x640
  (what a `.sens` colour export writes), which `chip_smoke.py` holds the
  port's encoder to.

    python tests/data_torch/make_codec_fixtures.py
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def smooth_image(h: int, w: int, noise: int = 30, scale: float = 1.0,
                 seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] * scale
    base = np.sin(yy[..., None] * 0.21 + xx[..., None] * 0.13
                  + np.arange(3) * 1.7)
    img = (base + 1) * 110 + rng.randint(0, noise, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def room(h: int, w: int):
    """The synthetic room from the first camera of its trajectory."""
    from simplerecon_tpu_torch.data.synthetic import (camera_trajectory,
                                                      make_room_mesh)
    from simplerecon_tpu_torch.render.renderer import Renderer
    v, f, c = make_room_mesh(seed=0)
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 0.9 * w
    K[0, 2], K[1, 2] = w / 2, h / 2
    rgb, depth = Renderer(h, w).render_mesh(
        v, f, camera_trajectory(8)[5], K, vert_colors=c,
        background=(0.0, 0.0, 0.0))
    return rgb, np.clip(np.round(depth * 1000.0), 0, 65535).astype(np.uint16)


def digest(path: str) -> dict:
    arr = np.asarray(Image.open(path))
    return {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "shape": list(arr.shape), "dtype": str(arr.dtype)}


def main():
    small = smooth_image(61, 83)
    files = {}

    def save(name, image, **kw):
        path = os.path.join(HERE, name)
        Image.fromarray(image).save(path, **kw)
        files[name] = digest(path)

    save("jpeg_444.jpg", small, quality=90, subsampling=0)
    save("jpeg_422_restart.jpg", small, quality=90, subsampling=1,
         restart_marker_blocks=3)
    save("jpeg_420.jpg", small, quality=90, subsampling=2)
    save("jpeg_grey.jpg", small[..., 1], quality=90)
    big_rgb, _ = room(968, 1296)
    save("jpeg_968x1296.jpg", big_rgb, quality=75, subsampling=2)
    _, depth_mm = room(480, 640)
    save("png_rgb8_480x640.png", smooth_image(480, 640, noise=2, scale=0.1),
         optimize=True)
    save("png_depth16_480x640.png", depth_mm, optimize=True)
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(files, f, indent=1, sort_keys=True)
    write_encode_digest()
    sizes = {n: os.path.getsize(os.path.join(HERE, n)) for n in files}
    print(json.dumps(sizes), "total", sum(sizes.values()))


def write_encode_digest(source: str = "jpeg_968x1296.jpg",
                        size=(480, 640)):
    image = Image.open(os.path.join(HERE, source)).convert("RGB")
    image = image.resize((size[1], size[0]), Image.BILINEAR)
    buf = io.BytesIO()
    image.save(buf, format="JPEG")
    with open(os.path.join(HERE, "jpeg_encode.json"), "w") as f:
        json.dump({"source": source, "size": list(size), "quality": 75,
                   "sha256": hashlib.sha256(buf.getvalue()).hexdigest()},
                  f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
