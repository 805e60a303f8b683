"""TSDF fusion on the device, marching cubes and PLY I/O."""
