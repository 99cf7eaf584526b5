"""Readings of how far float32 rounding moves the paired step's gradient of
A on the batch that ``tests/test_torch_parallel.py``'s world took before it
moved to ``tests/test_torch_train_steps.py``'s paired batch (numpy seed 11,
drawn in the order src_w, src_img, tgt_w, tgt_img, 4 rows, the first 2 used;
the coefficients recomputed in the step). Not a test: run it from the repo's
root on the CPU,

    PYTHONPATH=.:tests JAX_PLATFORMS=cpu python tests/torch_paired_rounding.py

It prints, for A's weight and bias gradients, each float32 reading's
largest gap as a share of the float64 gradient's max, with the count of
entries past the world test's limit (rtol 1e-3, atol 1e-3·max): the port's
one-process step at every torch thread and at one, the world's step (the
mean of the two one-row steps, as two ranks compute it) at both thread
counts, the port's step at A·(1 + 1e-6) (the tests' witness) and the JAX
package's step. The float64 gradient is the port's step with the nets, A
and the inputs in float64 (the port's float32 casts are made float64 here).
"""

import copy
import dataclasses

import jax
import numpy as np
import torch
import torch.nn.functional as F

from stylegan_directions_face_reenactment_tpu.configs.arguments import (
    TrainingArguments as JArgs)
from stylegan_directions_face_reenactment_tpu.geometry import initialize_directions as j_dirs
from stylegan_directions_face_reenactment_tpu.train import steps as jsteps

from stylegan_directions_face_reenactment_tpu_torch.train import make_paired_step
from stylegan_directions_face_reenactment_tpu_torch.weights import init_direction_matrix

import torch_parallel_world as pw
from torch_train_world import N_LAT, SIZE, build_train_world, t

KEYS = ("src_w", "src_img", "tgt_w", "tgt_img")


def batch():
    rs = np.random.RandomState(11)
    x = {"src_w": (0.5 * rs.randn(4, N_LAT, 512)).astype(np.float32),
         "src_img": rs.uniform(-1, 1, (4, SIZE, SIZE, 3)).astype(np.float32),
         "tgt_w": (0.5 * rs.randn(4, N_LAT, 512)).astype(np.float32),
         "tgt_img": rs.uniform(-1, 1, (4, SIZE, SIZE, 3)).astype(np.float32)}
    return {k: v[:2] for k, v in x.items()}


def grads(models, a, inputs, rows=slice(0, 2)):
    step = make_paired_step(models, pw.SPEC, pw.case_args("paired"), grads_only=True)
    return {k: v.detach().double().numpy()
            for k, v in step(a, None, *[t(inputs[k][rows]) for k in KEYS])[1].items()}


def float64_everywhere():
    """Make the port's float32 casts and its mixed-dtype calls float64 in
    this process (after the float32 readings)."""
    def up(fn):
        def call(*args, **kw):
            def f64(x):
                return x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x
            return fn(*[f64(x) for x in args], **{k: f64(v) for k, v in kw.items()})
        return call
    for name in ("conv2d", "conv_transpose2d", "linear", "grid_sample", "interpolate"):
        setattr(F, name, up(getattr(F, name)))
    for name in ("einsum", "matmul", "bmm", "stack", "cat"):
        setattr(torch, name, up(getattr(torch, name)))
    to_float, matmul = torch.Tensor.float, torch.Tensor.__matmul__
    torch.Tensor.float = lambda x, *a, **k: (x.double() if x.is_floating_point()
                                             else to_float(x, *a, **k))
    torch.Tensor.__matmul__ = lambda x, y: matmul(x.double(), y.double())
    torch.set_default_dtype(torch.float64)


def main():
    world = build_train_world()
    inputs = batch()
    a = init_direction_matrix(8, device="cpu")
    threads = torch.get_num_threads()
    readings = {}
    for n in (threads, 1):
        torch.set_num_threads(n)
        readings[f"port, one process, {n} torch threads"] = grads(world["port"], a, inputs)
        rows = [grads(world["port"], a, inputs, slice(i, i + 1)) for i in range(2)]
        readings[f"world of 2 (rows at B = 1), {n} torch threads"] = {
            k: (rows[0][k] + rows[1][k]) / 2 for k in rows[0]}
    torch.set_num_threads(threads)
    moved = copy.deepcopy(a)
    with torch.no_grad():
        moved.linear.weight.mul_(1 + 1e-6)
    readings["port at A·(1 + 1e-6) (witness)"] = grads(world["port"], moved, inputs)
    jargs = JArgs(**{**pw.COMMON, "batch_size": 2, "training_method": "paired"})
    a_jax = {"weight": a.linear.weight.detach().numpy().copy(),
             "bias": a.linear.bias.detach().numpy().copy(),
             "meta": {"shift_dim": 512, "input_dim": 15, "w_plus": True, "num_layers": 8}}
    jstep = jsteps.make_paired_step(world["jax"], j_dirs("voxceleb", 15, 6.0), jargs,
                                    jsteps.make_optimizer(jargs), grads_only=True)
    readings["JAX package, one device"] = {
        k: np.asarray(v, np.float64) for k, v in
        jstep(a_jax, jax.random.PRNGKey(0), *(inputs[k] for k in KEYS))[1].items()}

    float64_everywhere()
    m64 = copy.deepcopy(world["port"])
    for f in dataclasses.fields(m64):
        v = getattr(m64, f.name)
        if isinstance(v, torch.nn.Module):
            v.double()
        elif isinstance(v, torch.Tensor):
            setattr(m64, f.name, v.double())
    ref = grads(m64, copy.deepcopy(a).double(), {k: v.astype(np.float64)
                                                  for k, v in inputs.items()})
    base = readings[f"port, one process, {threads} torch threads"]
    for name, g in readings.items():
        line = []
        for k in ("weight", "bias"):
            d = np.abs(g[k] - ref[k])
            lim = 1e-3 * np.abs(ref[k]).max() + 1e-3 * np.abs(ref[k])
            line.append(f"{k} {d.max() / np.abs(ref[k]).max():.3g} of max "
                        f"({int((d > lim).sum())} past the limit)")
        gap = {k: np.abs(g[k] - base[k]).max() / np.abs(base[k]).max()
               for k in ("weight", "bias")}
        print(f"{name}: against float64 " + ", ".join(line) + "; against the port's "
              "one-process step " + ", ".join(f"{k} {v:.3g}" for k, v in gap.items()))


if __name__ == "__main__":
    main()
