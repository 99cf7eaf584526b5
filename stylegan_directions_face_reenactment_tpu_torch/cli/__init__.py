"""Command-line entry points: ``python -m
stylegan_directions_face_reenactment_tpu_torch.cli.run_inference``."""
