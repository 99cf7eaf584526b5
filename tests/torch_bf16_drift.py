"""Readings of how far the port's bf16 DECA coefficients and angles drift
from the JAX package's float32 ones, against the JAX package's own bf16
drift, by group and frame pair (the DECA of ``tests/test_torch_reenact.py``'s
world: ``init_deca(2)`` through ``convert_resnet_encoder``; N uniform 64²
targets from numpy seed 0, resized to 224 as the resize alignment does;
at N = 64 the frames of ``test_deca_bf16_no_further_from_f32_than_jax``). Not a test: run it from the repo's root on the CPU,

    PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/torch_bf16_drift.py [N]

It prints, at one torch thread and at every core, each group's ratio of
mean relative drifts (port bf16 / JAX bf16, both from JAX float32) over
all N frames and over each pair of frames. XLA keeps excess precision
between fused bf16 operations by default; the port, eager, rounds after
every operation. Prefix ``XLA_FLAGS=--xla_allow_excess_precision=false``
to have XLA round as the port does.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stylegan_directions_face_reenactment_tpu.models.deca.deca import (
    calculate_shapemodel as j_calculate_shapemodel)
from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_resnet_encoder)

from stylegan_directions_face_reenactment_tpu_torch.models.deca.deca import (
    calculate_shapemodel)
from stylegan_directions_face_reenactment_tpu_torch.weights import deca_from_jax, init_deca

from torch_face_zoo import to_np


def mean_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).mean() / np.abs(want).mean())


def main(n):
    jax.config.update("jax_platforms", "cpu")
    deca = {"e_flame": to_np(convert_resnet_encoder(init_deca(2, device="cpu")
                                                    .E_flame.state_dict()))}
    port = deca_from_jax(deca, device="cpu")
    targets = np.random.RandomState(0).uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32)

    def jax_run(dtype):
        pt, at = jax.jit(lambda im: j_calculate_shapemodel(deca, im, compute_dtype=dtype))(
            targets)
        return dict({k: np.asarray(v) for k, v in pt.items()}, angles=np.asarray(at))

    f32, bf16 = jax_run(None), jax_run(jnp.bfloat16)
    for threads in (1, os.cpu_count() or 1):
        torch.set_num_threads(threads)
        with torch.no_grad():
            pt, at = calculate_shapemodel(port, torch.from_numpy(targets),
                                          compute_dtype=torch.bfloat16)
        got = dict({k: v.numpy() for k, v in pt.items()}, angles=at.numpy())
        print(f"torch threads {threads}, {n} frames:")
        for k in got:
            pairs = [mean_rel(got[k][i:i + 2], f32[k][i:i + 2])
                     / mean_rel(bf16[k][i:i + 2], f32[k][i:i + 2]) for i in range(0, n - 1, 2)]
            print(f"  {k:10s} all {mean_rel(got[k], f32[k]) / mean_rel(bf16[k], f32[k]):.3f}; "
                  f"pairs {min(pairs):.2f}-{max(pairs):.2f}: "
                  + " ".join(f"{r:.2f}" for r in pairs))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
