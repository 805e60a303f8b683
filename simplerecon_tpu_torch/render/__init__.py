"""Headless mesh rendering on the native rasterizer."""
