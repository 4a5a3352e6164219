"""Image primitives: bilinear remap."""
