"""Batched stereo-stream processing."""
