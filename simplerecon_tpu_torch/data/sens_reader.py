"""ScanNet `.sens` binary decoder and exporter (counterpart of
`simplerecon_tpu/data/sens_reader.py`): parses the ScanNet sensor stream
format (version 4): calibration matrices, per-frame camera-to-world
poses, zlib-compressed uint16 depth ("occi" = zlib) and JPEG color, and
exports
`frame-XXXXXX.{color.jpg,depth.png,pose.txt}` + `intrinsic/` files in
the layout `ScannetDataset` expects. Colour is decoded, resized and
re-encoded as JPEG, and depth PNGs written, without Pillow
(`data/codec.py`, `utils/visualization.py`): the JPEGs are the bytes
Pillow's default save writes.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

from simplerecon_tpu_torch.data import codec
from simplerecon_tpu_torch.utils.visualization import encode_png

COMPRESSION_TYPE_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_TYPE_DEPTH = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort",
                          2: "occi_ushort"}


class RGBDFrame:
    def load(self, fh):
        self.camera_to_world = np.asarray(
            struct.unpack("f" * 16, fh.read(16 * 4)), np.float32
        ).reshape(4, 4)
        self.timestamp_color = struct.unpack("Q", fh.read(8))[0]
        self.timestamp_depth = struct.unpack("Q", fh.read(8))[0]
        color_size = struct.unpack("Q", fh.read(8))[0]
        depth_size = struct.unpack("Q", fh.read(8))[0]
        self.color_data = fh.read(color_size)
        self.depth_data = fh.read(depth_size)
        return self

    def decompress_depth(self, compression: str) -> bytes:
        if compression in ("zlib_ushort", "occi_ushort"):
            return zlib.decompress(self.depth_data)
        if compression == "raw_ushort":
            return self.depth_data
        raise ValueError(f"unsupported depth compression {compression}")

    def decompress_color(self, compression: str) -> np.ndarray:
        if compression in ("jpeg", "png"):
            return codec.decode_image(self.color_data, "a .sens colour frame")
        raise ValueError(f"unsupported color compression {compression}")


class SensorData:
    """Streaming reader of the version 4 format. Loads all frame records
    into memory on construction (decode stays lazy)."""

    def __init__(self, filename: str):
        self.version = 4
        with open(filename, "rb") as fh:
            version = struct.unpack("I", fh.read(4))[0]
            assert version == self.version, f"unsupported version {version}"
            strlen = struct.unpack("Q", fh.read(8))[0]
            self.sensor_name = fh.read(strlen).decode("utf-8",
                                                      errors="replace")
            self.intrinsic_color = np.asarray(
                struct.unpack("f" * 16, fh.read(16 * 4)), np.float32
            ).reshape(4, 4)
            self.extrinsic_color = np.asarray(
                struct.unpack("f" * 16, fh.read(16 * 4)), np.float32
            ).reshape(4, 4)
            self.intrinsic_depth = np.asarray(
                struct.unpack("f" * 16, fh.read(16 * 4)), np.float32
            ).reshape(4, 4)
            self.extrinsic_depth = np.asarray(
                struct.unpack("f" * 16, fh.read(16 * 4)), np.float32
            ).reshape(4, 4)
            self.color_compression_type = COMPRESSION_TYPE_COLOR[
                struct.unpack("i", fh.read(4))[0]]
            self.depth_compression_type = COMPRESSION_TYPE_DEPTH[
                struct.unpack("i", fh.read(4))[0]]
            self.color_width = struct.unpack("I", fh.read(4))[0]
            self.color_height = struct.unpack("I", fh.read(4))[0]
            self.depth_width = struct.unpack("I", fh.read(4))[0]
            self.depth_height = struct.unpack("I", fh.read(4))[0]
            self.depth_shift = struct.unpack("f", fh.read(4))[0]
            num_frames = struct.unpack("Q", fh.read(8))[0]
            self.frames = [RGBDFrame().load(fh) for _ in range(num_frames)]

    # ---------------------------- exports ----------------------------
    def export_depth_images(self, output_path: str,
                            frame_skip: int = 1,
                            image_size: Optional[tuple] = None):
        os.makedirs(output_path, exist_ok=True)
        for i in range(0, len(self.frames), frame_skip):
            raw = self.frames[i].decompress_depth(
                self.depth_compression_type)
            depth = np.frombuffer(raw, np.uint16).reshape(
                self.depth_height, self.depth_width)
            if image_size is not None:
                depth = codec.resize(depth, image_size[0], image_size[1],
                                     "nearest")
            with open(os.path.join(output_path,
                                   f"frame-{i:06d}.depth.png"), "wb") as f:
                f.write(encode_png(depth))

    def export_color_images(self, output_path: str, frame_skip: int = 1,
                            image_size: Optional[tuple] = None):
        """Writes every `frame_skip`-th frame's colour as
        `frame-XXXXXX.color.jpg` (quality 75), resized bilinearly to
        `image_size` = (height, width) when given."""
        os.makedirs(output_path, exist_ok=True)
        for i in range(0, len(self.frames), frame_skip):
            color = self.frames[i].decompress_color(
                self.color_compression_type)
            if image_size is not None:
                color = codec.resize(color, image_size[0], image_size[1],
                                     "bilinear")
            with open(os.path.join(output_path,
                                   f"frame-{i:06d}.color.jpg"), "wb") as f:
                f.write(codec.encode_jpeg(color))

    def export_poses(self, output_path: str, frame_skip: int = 1):
        os.makedirs(output_path, exist_ok=True)
        for i in range(0, len(self.frames), frame_skip):
            np.savetxt(os.path.join(output_path,
                                    f"frame-{i:06d}.pose.txt"),
                       self.frames[i].camera_to_world)

    def export_intrinsics(self, output_path: str):
        os.makedirs(output_path, exist_ok=True)
        np.savetxt(os.path.join(output_path, "intrinsic_color.txt"),
                   self.intrinsic_color)
        np.savetxt(os.path.join(output_path, "extrinsic_color.txt"),
                   self.extrinsic_color)
        np.savetxt(os.path.join(output_path, "intrinsic_depth.txt"),
                   self.intrinsic_depth)
        np.savetxt(os.path.join(output_path, "extrinsic_depth.txt"),
                   self.extrinsic_depth)
