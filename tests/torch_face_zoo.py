"""Seeded S3FD, FAN and e4e weights for the port's tests, in both packages:
the port's seeded init goes through the JAX package's own checkpoint
converters (``convert_s3fd``, ``convert_fan``, ``convert_e4e_encoder``), so
the state-dict keys round-trip, and back into the port with
``weights/from_jax.py``. Batch-norm statistics are randomized first, so
the folded normalization is exercised."""

import jax
import numpy as np
import torch

from stylegan_directions_face_reenactment_tpu.weights.torch_convert import (
    convert_fan, convert_s3fd)

from stylegan_directions_face_reenactment_tpu_torch.weights import (
    fan_from_jax, init_e4e, init_fan, init_id_backbone, init_s3fd, s3fd_from_jax)


def to_np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def randomize_bn(module, seed):
    """Random BN statistics and affine terms (scale 1 ± 0.1, var 0.5-1.5)."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy((1 + 0.1 * rs.randn(c)).astype(np.float32)))
                m.bias.copy_(torch.from_numpy((0.1 * rs.randn(c)).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy((0.1 * rs.randn(c)).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy((0.5 + rs.rand(c)).astype(np.float32)))
    return module


def fan_pair(seed=0, num_modules=2):
    """(JAX FAN pytree with numpy leaves, port FAN on the CPU)."""
    sd = randomize_bn(init_fan(seed, num_modules, device="cpu"), seed + 1).state_dict()
    j = to_np(convert_fan(sd, num_modules=num_modules))
    return j, fan_from_jax(j, device="cpu")


def s3fd_pair(seed=0, boost_head=None):
    """(JAX S3FD pytree, port S3FD on the CPU). ``boost_head`` (a conf head
    name) biases that head to the face class by ±10, so every one of its
    anchors scores exactly 1.0: detections pass the 0.99 gate, and their
    ties are ordered by the stable sort alone."""
    m = init_s3fd(seed, device="cpu")
    if boost_head is not None:
        with torch.no_grad():
            b = getattr(m, boost_head).bias
            b.fill_(-10.0)
            b[-1] = 10.0
    j = to_np(convert_s3fd(m.state_dict()))
    return j, s3fd_from_jax(j, device="cpu")


def damped_e4e(seed, image_resolution):
    """A seeded port e4e with random batch-norm statistics and its residual
    branches damped (each IR-SE block's last batch-norm scale × 0.3): at the
    random init the 24 blocks grow the activations some 30,000-fold, which
    turns last-digit differences into percent differences of the code."""
    e = randomize_bn(init_e4e(seed, image_resolution, device="cpu"), seed + 1)
    with torch.no_grad():
        for blk in e.body:
            blk.res_layer[4].weight.mul_(0.3)
    return e


def damped_backbone(seed):
    """A seeded port ArcFace backbone with random batch-norm statistics
    (the head's non-affine BN1d's too) and its residual branches damped as
    :func:`damped_e4e`'s: undamped, the random body grows the activations
    about 18,000-fold, and the embeddings of the two packages read 6.2e-4
    apart instead of 2.4e-7."""
    m = randomize_bn(init_id_backbone(seed, device="cpu"), seed + 1)
    rs = np.random.RandomState(seed + 2)
    with torch.no_grad():
        for blk in m.body:
            blk.res_layer[4].weight.mul_(0.3)
        head = m.output_layer[4]
        head.running_mean.copy_(torch.from_numpy((0.1 * rs.randn(512)).astype(np.float32)))
        head.running_var.copy_(torch.from_numpy((0.5 + rs.rand(512)).astype(np.float32)))
    return m


def statics_jit(fn, *trees):
    """jit ``fn(*trees, *args)`` with the trees' arrays as arguments (their
    ints and dict metadata closed over), so XLA does not fold the weights
    as constants."""
    from stylegan_directions_face_reenactment_tpu.train.steps import (
        merge_statics, strip_statics)
    weights, statics = strip_statics(trees)
    jitted = jax.jit(lambda w, *args: fn(*merge_statics(w, statics), *args))
    return lambda *args: jitted(weights, *args)
