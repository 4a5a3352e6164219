"""PyTorch + CUDA port of stereo_vision_tpu for NVIDIA Hopper (H100).

The JAX package ``stereo_vision_tpu`` is the reference; this package
mirrors its layout (``stereo/``, ``ops/``, ``parallel/``, ``calib/``,
``sync/``, ``detect/``, ``track/``, ``synth/``) with plain functions on
tensors. Every kernel the JAX package wrote in Pallas
for the TPU is a hand-written CUDA kernel here (``csrc/``), built with
``nvcc`` on first use (``_build.py``) and bound with ``ctypes``; each
kernel keeps a plain PyTorch form beside it, which runs for CPU tensors.

Entry points resolve ``device=None`` to CUDA and raise when no card is
present (:func:`stereo_vision_tpu_torch.device.resolve_device`).
"""
