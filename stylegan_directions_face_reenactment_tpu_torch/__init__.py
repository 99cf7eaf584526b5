"""PyTorch + CUDA port of the face-reenactment system for an NVIDIA H100.

It sits beside the JAX package ``stylegan_directions_face_reenactment_tpu``
with the same subpackage layout (``ops/``, ``models/``, ``geometry/``,
``pipeline/``, ``train/``, ``weights/``, ``configs/``) and imports nothing
of it. Its
public functions take and return the JAX package's layouts (NHWC images,
(T, n_latent, 512) latents); inside they compute in NCHW. Entry points run
on the CUDA card unless the caller passes ``device="cpu"``.

The Pallas TPU kernels on the serving path are hand-written CUDA kernels in
``csrc/`` (built with ``nvcc`` at first use into ``build/kernels/``).
"""
